#!/usr/bin/env python3
"""GPU smoke run: the disk simulation end to end on one GPU.

    python chip_smoke.py                 # one GPU, every phase below
    python chip_smoke.py --devices 4     # only the 4-GPU sharded path

Everything runs in this one process: the CPU references run on
``jax.devices("cpu")[0]``, so no second process opens the card.  Phases
(one line each; any failure ends the run with a non-zero exit):

  a  flagship f32 at 1024x3072 through Simulation/advance_to: compile
     time, steady seconds per step, peak device memory
  b  flagship f32 vs f64 on the GPU, same state and fixed dt sequence
  c  flagship f64 on the GPU vs f64 on the CPU at 256x768
  d  PDS70-style full physics (SG + FLD + PVTE + dust) f32 at 1024x3072,
     and f64 GPU vs CPU at 128x384
  e  the CLI on setups/PDS70.yml (2 planets, accretion, damping, dust)
  f  restart of that run from its last snapshot

With ``--devices 4`` only the sharded path runs: the GSPMD radial mesh
and the explicit shard_map stepper (flagship and PDS70-style full
physics) at 1024x3072 f64, each against the same steps on one GPU, plus
the distributed snapshot write/read.

The script refuses to run (exit 2, no result line) when JAX finds no GPU.
Its last line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import jax  # noqa: E402

from fargocpt_tpu import compile_cache, gpu  # noqa: E402

# --- bounds, each with its reason ---------------------------------------
# float32 vs float64 after 20 steps: the documented dtype budget
# (README, tests/test_dtype_budget.py: 1e-3 relative L2 per field).
F32_BUDGET = 1e-3
# float64 GPU vs float64 CPU, flagship: the same graph differs only in
# reduction order, FMA contraction and the libm of exp/log/pow/trig, i.e.
# ~1e-16 per operation.  Perturbing the initial state by 1e-15 (relative,
# random) moves the 20-step result at 256x768 by at most 9e-15 on the CPU,
# so 1e-10 leaves four orders of magnitude of margin while still catching
# any real miscompile (1e-3 and up).
F64_GPU_CPU_BOUND = 1e-10
# float64 GPU vs CPU, PDS70-style full physics: the FLD SOR stops at a
# relative tolerance (1e-5 in this configuration), so rounding-level
# differences can change the iteration count and move the temperature by
# up to that tolerance; cuFFT vs pocketfft (complex128) adds ~1e-15.  (A
# 1e-15 perturbation of the initial state moves the 10-step result at
# 128x384 by at most 8e-15 on the CPU.)
PDS70_GPU_CPU_BOUND = 1e-6
# sharded vs one-GPU, f64: the same arithmetic with collective halo
# exchange; reductions (CFL min, psum) are order-insensitive or
# round-off-level, so only round-off accumulates over the steps.
SHARDED_BOUND = 1e-9

FIELDS = ("sigma", "vrad", "vaz", "energy")


def log(msg: str):
    print(msg, flush=True)


# --- pure helpers (unit-tested on the CPU) -------------------------------
def rel_l2_errors(state_a, state_b) -> dict:
    """Relative L2 distance per prognostic field; vrad crosses zero, so it
    is scaled by the norm of vaz (as in tests/test_dtype_budget.py)."""
    out = {}
    for name in FIELDS:
        a = np.asarray(getattr(state_a.fields, name), np.float64)
        b = np.asarray(getattr(state_b.fields, name), np.float64)
        ref = b if name != "vrad" else np.asarray(state_b.fields.vaz,
                                                  np.float64)
        out[name] = float(np.linalg.norm(a - b) / np.linalg.norm(ref))
    return out


def check_within(errors: dict, bound: float, label: str) -> str:
    """One result line; raises AssertionError when any error is
    non-finite or above ``bound``."""
    text = ", ".join(f"{k} {v:.3e}" for k, v in errors.items())
    bad = {k: v for k, v in errors.items()
           if not np.isfinite(v) or v > bound}
    if bad:
        raise AssertionError(f"{label}: rel L2 above {bound:g}: {text}")
    return f"{label}: rel L2 {text} (bound {bound:g})"


def result_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": gpu.device_record(devices)})


def check_fields_finite(state, label: str):
    for name in FIELDS:
        a = np.asarray(getattr(state.fields, name))
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"{label}: non-finite {name}")
    if not np.all(np.asarray(state.fields.sigma) > 0):
        raise AssertionError(f"{label}: non-positive sigma")


def _mib(n) -> str:
    return f"{n / 2 ** 20:.1f} MiB"


# --- phases ----------------------------------------------------------------
def _primed(sim):
    """Fresh-start dt priming, as ``Simulation.run`` and the CLI do."""
    sim.calculate_time_step()
    sim.calculate_time_step()
    return sim


def fixed_dt_run(sim, steps: int, dt: float):
    """``steps`` steps of ``sim`` at a fixed dt (same sequence on every
    device and dtype)."""
    state, t = sim.state, 0.0
    for _ in range(steps):
        state = sim.stepper.step(state, t, dt)
        t += dt
    jax.block_until_ready(state.fields.sigma)
    return state


def phase_flagship(nrad=1024, naz=3072, steps=100, repeats=3) -> dict:
    """Build, compile, warm up until dt reaches its CFL level, then time
    ``repeats`` advances of about ``steps`` steps each (each lands
    exactly on its target time)."""
    from __graft_entry__ import _flagship

    f32 = jax.numpy.float32
    t0 = time.perf_counter()
    sim = _primed(_flagship(nrad, naz, "float32"))
    build_s = time.perf_counter() - t0
    st = sim.stepper
    state, t, last_dt = sim.state, sim.time, sim.last_dt
    # the same executable advance_to runs: one chunk of the interval loop
    args = (state, f32(t), f32(last_dt), f32(sim.settings.monitor_timestep),
            jax.numpy.int32(st.max_steps_per_call))
    t0 = time.perf_counter()
    compiled = st._advance.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    log(f"a. flagship f32 {nrad}x{naz}: build {build_s:.2f} s, compile "
        f"{compile_s:.2f} s; memory_analysis: arguments "
        f"{_mib(mem.argument_size_in_bytes)}, outputs "
        f"{_mib(mem.output_size_in_bytes)}, temporaries "
        f"{_mib(mem.temp_size_in_bytes)}")

    def advance(state, t, last_dt, target):
        out = st.advance_to(state, t, last_dt, target)
        jax.block_until_ready(out[0].fields.sigma)
        if float(out[1]) != float(np.float32(target)):
            raise AssertionError(f"time {float(out[1])!r} missed the "
                                 f"target {float(np.float32(target))!r}")
        return out[0], float(out[1]), float(out[2]), int(out[3])

    # warm-up: dt grows from FirstDT by CFLmaxVar per step to its CFL level
    state, t, last_dt, n_total = advance(
        state, t, last_dt, 0.5 * sim.settings.monitor_timestep)
    per_step = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, t, last_dt, n = advance(state, t, last_dt,
                                       t + steps * last_dt)
        per_step.append((time.perf_counter() - t0) / n)
        n_total += n
    s_per_step = statistics.median(per_step)
    check_fields_finite(state, "a. flagship f32")
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", -1)
    log(f"a. flagship f32 {nrad}x{naz}: {n_total} steps, steady "
        f"{s_per_step * 1e3:.4f} ms/step (median of {repeats} advances of "
        f"~{steps} steps; {nrad * naz / s_per_step / 1e6:.1f} Mcell/s), "
        f"every advance landed on its target time, peak_bytes_in_use "
        f"{peak} ({_mib(peak)}), card: {gpu.card_name_and_power_limit()}")
    return {"compile_s": compile_s, "s_per_step": s_per_step,
            "peak_bytes": peak, "steps": n_total}


def _fixed_dt(sim) -> float:
    """Half the CFL step of the initial state (a stable fixed dt)."""
    return 0.5 * float(sim.stepper.cfl_dt(sim.state, 0.0))


def phase_f32_vs_f64(nrad=1024, naz=3072, steps=20) -> dict:
    from __graft_entry__ import _flagship

    sim64 = _flagship(nrad, naz, "float64")
    sim32 = _flagship(nrad, naz, "float32")
    dt = _fixed_dt(sim64)
    s64 = fixed_dt_run(sim64, steps, dt)
    s32 = fixed_dt_run(sim32, steps, dt)
    errs = rel_l2_errors(s32, s64)
    log("b. " + check_within(errs, F32_BUDGET,
                             f"flagship f32 vs f64 on the GPU, {nrad}x{naz}, "
                             f"{steps} steps at dt {dt:.4e}"))
    return errs


def gpu_vs_cpu(make, steps: int, bound: float, label: str) -> dict:
    """``make()`` builds a float64 Simulation; run it ``steps`` fixed-dt
    steps on the default device and on the CPU and compare."""
    cpu = jax.devices("cpu")[0]
    sim_g = make()
    dt = _fixed_dt(sim_g)
    s_g = fixed_dt_run(sim_g, steps, dt)
    with jax.default_device(cpu):
        sim_c = make()
        s_c = fixed_dt_run(sim_c, steps, dt)
    dev = {d.platform for d in s_c.fields.sigma.devices()}
    if dev != {"cpu"}:
        raise AssertionError(f"{label}: CPU reference ran on {dev}")
    errs = rel_l2_errors(s_g, s_c)
    log(check_within(errs, bound, f"{label}, {steps} steps at dt {dt:.4e}"))
    return errs


def phase_gpu_vs_cpu_f64(nrad=256, naz=768, steps=20) -> dict:
    from __graft_entry__ import _flagship
    return gpu_vs_cpu(lambda: _flagship(nrad, naz, "float64"), steps,
                      F64_GPU_CPU_BOUND,
                      f"c. flagship f64 GPU vs CPU, {nrad}x{naz}")


def phase_full_physics(nrad=1024, naz=3072, n_particles=16384, steps=10,
                       ref_nrad=128, ref_naz=384, ref_particles=256,
                       ref_steps=10) -> dict:
    from __graft_entry__ import _pds70

    t0 = time.perf_counter()
    sim = _primed(_pds70(nrad, naz, "float32", n_particles))
    # dt grows by at most CFLmaxVar (1.1) per step, so a target 2 * steps
    # last-dts ahead takes at least ``steps`` steps
    out = sim.stepper.advance_to(sim.state, sim.time, sim.last_dt,
                                 sim.time + 2 * steps * sim.last_dt)
    jax.block_until_ready(out[0].fields.sigma)
    first_s = time.perf_counter() - t0
    if int(out[3]) < steps:
        raise AssertionError(f"d. full physics ran {int(out[3])} steps")
    check_fields_finite(out[0], "d. full physics f32")
    if not np.all(np.isfinite(np.asarray(out[0].particles.r))):
        raise AssertionError("d. full physics f32: non-finite particles")
    log(f"d. full physics (SG + FLD + PVTE + {n_particles} dust) f32 "
        f"{nrad}x{naz}: {int(out[3])} steps finite, build + compile + run "
        f"{first_s:.2f} s")
    return gpu_vs_cpu(
        lambda: _pds70(ref_nrad, ref_naz, "float64", ref_particles),
        ref_steps, PDS70_GPU_CPU_BOUND,
        f"d. full physics f64 GPU vs CPU, {ref_nrad}x{ref_naz}, "
        f"{ref_particles} particles")


def _run_cli(argv: list) -> int:
    import fargocpt_tpu
    return fargocpt_tpu.run(argv)


def phase_cli(setup: Path, outdir: Path, n_iter=200) -> dict:
    from fargocpt_tpu.analysis import Loader

    t0 = time.perf_counter()
    rc = _run_cli(["start", str(setup), "-o", str(outdir), "--dtype",
                   "float32", "-N", str(n_iter)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"e. CLI start exited {rc}")
    quantities = outdir / "monitor" / "Quantities.dat"
    if not quantities.exists() or len(np.loadtxt(quantities, ndmin=2)) < 2:
        raise AssertionError("e. CLI: monitor/Quantities.dat missing/short")
    loader = Loader(outdir)
    last = loader.snapshots[-1]
    if last == loader.snapshots[0]:
        raise AssertionError("e. CLI: no snapshot after the initial one")
    for name in ("Sigma", "vrad", "vazi", "energy"):
        a = loader.gas.get(name, last, grid=False)
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"e. CLI: non-finite {name}")
    b0 = loader.nbody_state(loader.snapshots[0])
    b1 = loader.nbody_state(last)
    moved = [float(m) for m in np.hypot(b1["x"] - b0["x"],
                                         b1["y"] - b0["y"])[1:]]
    if not all(m > 0 for m in moved):
        raise AssertionError(f"e. CLI: planets did not move ({moved})")
    log(f"e. CLI start {setup.name} f32 -N {n_iter}: rc 0 in {wall:.2f} s, "
        f"snapshots {loader.snapshots}, Quantities.dat written, planet "
        f"displacement {moved[0]:.4e}, {moved[1]:.4e} (code units), fields "
        "finite")
    return {"snapshots": loader.snapshots, "moved": moved}


def phase_restart(setup: Path, outdir: Path, n_iter=200) -> dict:
    t0 = time.perf_counter()
    rc = _run_cli(["restart", "last", str(setup), "-o", str(outdir),
                   "--dtype", "float32", "-N", str(n_iter)])
    if rc != 0:
        raise AssertionError(f"f. CLI restart exited {rc}")
    log(f"f. CLI restart last: rc 0 in {time.perf_counter() - t0:.2f} s")
    return {"rc": rc}


# --- several devices -----------------------------------------------------
def _assert_spread(tree, n: int, label: str):
    """Every array spans all ``n`` devices and the grid fields are truly
    sharded: nothing lands whole on one device."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array) and \
                len(leaf.sharding.device_set) != n:
            raise AssertionError(
                f"{label}: a {leaf.shape} array sits on "
                f"{len(leaf.sharding.device_set)} of {n} devices")


def _sharded_fields(state, n: int, label: str):
    for name in ("sigma", "vaz", "energy"):
        a = getattr(state.fields, name)
        if a.sharding.is_fully_replicated or \
                len(a.sharding.device_set) != n:
            raise AssertionError(f"{label}: {name} is not sharded {n} ways")


def phase_multi(n=4, nrad=1024, naz=3072, steps=10, n_particles=16384,
                devices=None) -> dict:
    from __graft_entry__ import _flagship, _pds70
    from fargocpt_tpu import output as fout
    from fargocpt_tpu.parallel import mesh as pmesh
    from fargocpt_tpu.parallel.shard_step import ShardedHydroStep

    devices = list(devices or jax.devices()[:n])
    mesh = pmesh.make_mesh(devices=devices)
    results = {}

    sim = _flagship(nrad, naz, "float64")
    dt = _fixed_dt(sim)
    t0 = time.perf_counter()
    ref = fixed_dt_run(sim, steps, dt)
    ref_s = time.perf_counter() - t0

    # GSPMD radial mesh: the unchanged step on sharded inputs
    st = pmesh.shard_state(sim.state, mesh)
    _assert_spread(st, n, "GSPMD input")
    t0 = time.perf_counter()
    for k in range(steps):
        st = sim.stepper.step(st, k * dt, dt)
    jax.block_until_ready(st.fields.sigma)
    gspmd_s = time.perf_counter() - t0
    _sharded_fields(st, n, "GSPMD")
    _assert_spread(st, n, "GSPMD output")
    results["gspmd"] = rel_l2_errors(st, ref)
    log(check_within(results["gspmd"], SHARDED_BOUND,
                     f"{n} devices GSPMD flagship f64 {nrad}x{naz} vs one "
                     f"device, {steps} steps (first run {gspmd_s:.2f} s, "
                     f"one device {ref_s:.2f} s)"))

    # explicit shard_map/ppermute stepper
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)
    t0 = time.perf_counter()
    for k in range(steps):
        pair = ss.step(pair, k * dt, dt)
    jax.block_until_ready(pair[0].fields.sigma)
    sm_s = time.perf_counter() - t0
    _sharded_fields(pair[0], n, "shard_map")
    _assert_spread(pair, n, "shard_map output")
    results["shard_map"] = rel_l2_errors(ss.gather(pair), ref)
    log(check_within(results["shard_map"], SHARDED_BOUND,
                     f"{n} devices shard_map flagship f64 {nrad}x{naz} vs "
                     f"one device, {steps} steps (first run {sm_s:.2f} s)"))

    # distributed snapshot write + read, no full-grid gather
    with tempfile.TemporaryDirectory() as td:
        sigma = st.fields.sigma
        fout.write_sharded_array(sigma, Path(td), "Sigma")
        n_files = len(list(Path(td).glob("Sigma.r*-*.dat")))
        back = fout.read_sharded_array(Path(td), "Sigma", sigma.shape,
                                       sigma.sharding, sigma.dtype)
        if n_files != n or len(back.sharding.device_set) != n:
            raise AssertionError(f"sharded snapshot: {n_files} files")
        np.testing.assert_array_equal(np.asarray(back), np.asarray(sigma))
    log(f"{n} devices: distributed snapshot write + read of Sigma "
        f"round-trips exactly ({n_files} shard files)")

    # PDS70-style full physics through the explicit stepper
    sim3 = _pds70(nrad, naz, "float64", n_particles)
    dt3 = _fixed_dt(sim3)
    ref3 = fixed_dt_run(sim3, steps, dt3)
    ss3 = ShardedHydroStep(sim3.stepper, mesh)
    pair3 = ss3.shard_state(sim3.state)
    t0 = time.perf_counter()
    for k in range(steps):
        pair3 = ss3.step(pair3, k * dt3, dt3)
    jax.block_until_ready(pair3[0].fields.sigma)
    fp_s = time.perf_counter() - t0
    _sharded_fields(pair3[0], n, "full physics")
    _assert_spread(pair3, n, "full physics output")
    if int(np.sum(np.asarray(pair3[0].particles.overflow))) != 0:
        raise AssertionError("full physics: particle buckets overflowed")
    results["full_physics"] = rel_l2_errors(ss3.gather(pair3), ref3)
    log(check_within(results["full_physics"], PDS70_GPU_CPU_BOUND,
                     f"{n} devices shard_map full physics (SG all-gather + "
                     f"FLD + PVTE + {n_particles} slab-owned dust) f64 "
                     f"{nrad}x{naz} vs one device, {steps} steps (first "
                     f"run {fp_s:.2f} s)"))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", -1)
             for d in devices]
    log(f"{n} devices: peak_bytes_in_use per device "
        f"{[_mib(p) for p in peaks]}")
    return results


# --- entry point -----------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4 runs only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    cache = compile_cache.enable()
    try:
        gpu.require_gpu()
    except gpu.NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < args.devices:
        print(f"chip_smoke: --devices {args.devices} needs {args.devices} "
              f"GPUs, JAX has {len(devices)}", file=sys.stderr)
        return 2
    devices = devices[:args.devices]
    log(f"card: {gpu.card_name_and_power_limit()}; jax {jax.__version__}; "
        f"device_kind {devices[0].device_kind}; devices {len(jax.devices())}"
        f"; compile cache {cache}")

    if args.devices > 1:
        phase_multi(args.devices, devices=devices)
    else:
        phase_flagship()
        phase_f32_vs_f64()
        phase_gpu_vs_cpu_f64()
        phase_full_physics()
        setup = HERE / "setups" / "PDS70.yml"
        with tempfile.TemporaryDirectory() as td:
            outdir = Path(td) / "pds70"
            phase_cli(setup, outdir)
            phase_restart(setup, outdir)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
