"""chip_smoke.py's helpers and control flow on the CPU.

The script's device numbers come only from the card; here its pure
helpers, its refusal without a GPU and its phases (at tiny sizes, on the
CPU and on 4 virtual CPU devices) are checked.  The GPU-vs-CPU comparison
itself is a ``gpu`` test.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fargocpt_tpu import compile_cache, gpu  # noqa: E402


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def test_refuses_without_gpu():
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert res.returncode == 2
    assert "no GPU found" in res.stderr
    assert res.stdout == ""


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _env()
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_require_gpu_rejects_cpu_device():
    with pytest.raises(gpu.NoGPUError, match="no GPU found"):
        gpu.require_gpu(jax.devices("cpu")[0])


def test_result_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"][
        "count"] == 4


def _state(**fields):
    return SimpleNamespace(fields=SimpleNamespace(**fields))


def test_rel_l2_errors_and_bounds():
    a = _state(sigma=np.ones((4, 4)), vrad=np.zeros((5, 4)),
               vaz=np.full((4, 4), 2.0), energy=np.ones((4, 4)))
    b = _state(sigma=np.ones((4, 4)) * (1 + 1e-6), vrad=np.full((5, 4), 1e-6),
               vaz=np.full((4, 4), 2.0), energy=np.ones((4, 4)))
    err = chip_smoke.rel_l2_errors(a, b)
    assert err["sigma"] == pytest.approx(1e-6 / (1 + 1e-6), rel=1e-9)
    assert err["vaz"] == 0.0 and err["energy"] == 0.0
    # vrad crosses zero: scaled by the norm of vaz
    assert err["vrad"] == pytest.approx(np.sqrt(20) * 1e-6 / 8.0, rel=1e-9)
    line = chip_smoke.check_within(err, 1e-5, "x")
    assert line.startswith("x: rel L2") and "bound 1e-05" in line
    with pytest.raises(AssertionError, match="above 1e-07"):
        chip_smoke.check_within(err, 1e-7, "x")
    with pytest.raises(AssertionError):
        chip_smoke.check_within({"sigma": float("nan")}, 1.0, "x")


def test_bounds_are_ordered():
    assert chip_smoke.SHARDED_BOUND <= chip_smoke.PDS70_GPU_CPU_BOUND
    assert chip_smoke.F64_GPU_CPU_BOUND < chip_smoke.PDS70_GPU_CPU_BOUND \
        < chip_smoke.F32_BUDGET == 1e-3


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    # set nothing in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_dir_fixed_repo_path(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    expect = str(REPO / ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_phases_rehearse_on_cpu():
    """Phases a-c end to end at tiny sizes (control flow only: on the CPU
    the 'GPU' side and the reference are the same device)."""
    a = chip_smoke.phase_flagship(32, 64, steps=4, repeats=2)
    assert a["steps"] > 8 and a["s_per_step"] > 0
    b = chip_smoke.phase_f32_vs_f64(32, 64, steps=3)
    assert 0 < max(b.values()) < chip_smoke.F32_BUDGET
    c = chip_smoke.phase_gpu_vs_cpu_f64(32, 64, steps=3)
    assert max(c.values()) <= chip_smoke.F64_GPU_CPU_BOUND


def test_multi_phase_on_four_virtual_devices():
    res = chip_smoke.phase_multi(4, nrad=96, naz=32, steps=2, n_particles=32,
                                 devices=jax.devices("cpu")[:4])
    assert set(res) == {"gspmd", "shard_map", "full_physics"}
    for errs in res.values():
        assert max(errs.values()) < chip_smoke.SHARDED_BOUND


@pytest.mark.gpu
def test_gpu_matches_cpu_f64(gpu_device):
    """Flagship f64 on the card vs the CPU at a small grid (phase c)."""
    with jax.default_device(gpu_device):
        errs = chip_smoke.phase_gpu_vs_cpu_f64(64, 192, steps=5)
    assert max(errs.values()) <= chip_smoke.F64_GPU_CPU_BOUND
