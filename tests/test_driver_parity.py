"""Fresh-subprocess gates that mimic the driver's exact invocations.

Two consecutive rounds ended with a red driver gate the in-process suite
never saw (round 1: multichip platform forcing; round 2: the x64
init-ordering dtype crash in ``python bench.py``): conftest.py enables x64
and forces CPU for every test process, so bugs that only appear in a
pristine interpreter are structurally invisible to in-process tests.
These tests launch ``python bench.py`` and ``python __graft_entry__.py``
in clean subprocesses exactly as the driver does.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _clean_env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)
    env.update(extra)
    return env


def test_bench_refuses_without_gpu():
    """``python bench.py`` on the CPU exits non-zero, says no GPU was
    found and prints no result line (a CPU number must never stand under
    a device metric)."""
    res = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        env=_clean_env(BENCH_NRAD="16", BENCH_NAZ="32", BENCH_STEPS="1"),
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.gpu
@pytest.mark.slow
def test_bench_kill_resilience(gpu_device):
    """A kill mid-run must never leave an optional bench line as the last
    complete JSON line: SIGKILL the orchestrator right after the first
    optional child's line appears, then the last complete stdout JSON line
    must be the flagship float32 one (runs on the card)."""
    import json
    import signal

    env = dict(os.environ, BENCH_NRAD="64", BENCH_NAZ="128",
               BENCH_STEPS="2", BENCH_F64_STEPS="2", BENCH_PDS70_STEPS="2",
               BENCH_WALL_BUDGET="1700")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "bench.py")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(REPO), start_new_session=True)
    collected = []
    try:
        while True:
            line = proc.stdout.readline()
            if not line:  # orchestrator finished before we could kill it
                break
            collected.append(line)
            if line.startswith("{") and "SG + FLD" in line:
                break
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass
        # drain via read(), not communicate(): communicate discards what
        # readline() already pulled into the TextIOWrapper buffer
        rest = proc.stdout.read()
        proc.wait(timeout=60)
        collected.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    stdout = "".join(collected)
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert any("SG + FLD" in ln for ln in lines), stdout
    last = json.loads(lines[-1])
    assert "float32" in last["metric"], lines[-1]
    assert last == json.loads(lines[0])
    assert last["platform"] == "gpu"


@pytest.mark.slow  # 128 s; the driver compile-checks the graft entry
# itself every round — keep only the kill-resilience gates fast
def test_graft_entry_fresh_subprocess():
    """``python __graft_entry__.py`` (the driver's compile check) must run
    in a pristine interpreter."""
    res = subprocess.run(
        [sys.executable, str(REPO / "__graft_entry__.py")],
        env=_clean_env(), capture_output=True, text=True, timeout=900,
        cwd=str(REPO))
    assert res.returncode == 0, \
        f"__graft_entry__ crashed:\n{res.stdout}\n{res.stderr}"
    assert "single-device step compiled and ran" in res.stdout


@pytest.mark.slow
def test_dryrun_multichip_fresh_subprocess():
    """The driver's multichip gate: dryrun_multichip(8) with the forced
    8-virtual-CPU backend, from a clean interpreter."""
    code = ("import __graft_entry__ as g; g.dryrun_multichip(8); "
            "print('MULTICHIP_OK')")
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=_clean_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True, timeout=900, cwd=str(REPO))
    assert res.returncode == 0, \
        f"dryrun_multichip crashed:\n{res.stdout}\n{res.stderr}"
    assert "MULTICHIP_OK" in res.stdout


def test_f64_then_f32_simulation_fresh_subprocess():
    """Regression for the round-2 x64 init-ordering bug: in a fresh
    process (no conftest x64), the FIRST float64 Simulation must get true
    f64 fields, and a following float32 Simulation must be uniformly f32.
    Before the fix the first f64 Simulation's ICs were silently truncated
    to f32 while later-derived fields came out f64."""
    code = """
import numpy as np
from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation

def cfg():
    return Config.from_dict({
        "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
        "AspectRatio": "0.05", "FlaringIndex": "0.25",
        "ViscousAlpha": "0.001", "Sigma0": "200 g/cm2",
        "SigmaSlope": "0.5", "ArtificialViscosity": "SN",
        "Nrad": "32", "Naz": "64", "Rmin": "0.4", "Rmax": "2.5",
        "RadialSpacing": "Log", "InnerBoundary": "outflow",
        "OuterBoundary": "outflow", "Transport": "FARGO",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "1.0",
    })

s64 = Simulation(cfg(), dtype="float64")
for name in ("sigma", "vrad", "vaz", "energy"):
    a = getattr(s64.state.fields, name)
    assert a.dtype == np.float64, f"{name}: {a.dtype}"
s32 = Simulation(cfg(), dtype="float32")
for name in ("sigma", "vrad", "vaz", "energy"):
    a = getattr(s32.state.fields, name)
    assert a.dtype == np.float32, f"{name}: {a.dtype}"
print("DTYPE_OK")
"""
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=_clean_env(), capture_output=True, text=True, timeout=600,
        cwd=str(REPO))
    assert res.returncode == 0, \
        f"dtype regression:\n{res.stdout}\n{res.stderr}"
    assert "DTYPE_OK" in res.stdout
