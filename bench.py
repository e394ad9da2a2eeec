"""Benchmark: Mcell-updates/s on the 1024x3072 polar grid, on one GPU.

Runs the flagship hydro step (adiabatic + alpha viscosity + SN artificial
viscosity + viscous heating + beta cooling + CFL + FARGO transport) in a
jitted scan and reports sustained cell-update throughput.  Prints JSON
lines
  {"metric": ..., "value": N, "unit": ..., "platform": ..., "device_kind":
   ..., "device_count": N, "card": "<nvidia-smi name, power.limit>"}
with the flagship float32 line LAST.  With no GPU present the benchmark
fails: a CPU number is never printed under a device metric.

Process layout: the parent never imports jax; every line runs in its own
timeout-bounded subprocess (``BENCH_ONLY=...``), one after another, so one
process owns the card at a time and a crash or hang in one configuration
cannot take the flagship line down.

Optional lines after the flagship one:
  pds70 — full-physics SG + FLD + PVTE + dust step
  f64   — flagship in float64

Wall budget: a child is skipped when the remaining budget
(``BENCH_WALL_BUDGET`` seconds) cannot cover its warm cost, and its
timeout is capped so the children after it keep their warm costs.  After
every optional child its line and the flagship line go out in one write,
so a kill at any moment leaves the flagship line last.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

NRAD = int(os.environ.get("BENCH_NRAD", 1024))
NAZ = int(os.environ.get("BENCH_NAZ", 3072))
BENCH_STEPS = int(os.environ.get("BENCH_STEPS", 100))


def _build_advance(sim):
    """Jitted scan of (CFL + full step) with a static length."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    stepper = sim.stepper

    def one(carry, _):
        state, time_, last_dt = carry
        cfl_dt = stepper._cfl_impl(state)
        dt = jnp.minimum(stepper.phys.cfl_max_var * last_dt, cfl_dt)
        state = stepper._step_impl(state, time_, dt)
        return (state, time_ + dt, dt), None

    @partial(jax.jit, static_argnums=1)
    def advance(carry, n):
        return jax.lax.scan(one, carry, None, length=n)[0]

    fdtype = sim.state.fields.sigma.dtype
    carry = (sim.state, jnp.asarray(0.0, fdtype), jnp.asarray(1e-6, fdtype))
    return advance, carry


def _deadline_check(label: str):
    """Between-device-call deadline checkpoint: exit rc=3 if the parent's
    budget for this child has run out."""
    dl = float(os.environ.get("BENCH_CHILD_DEADLINE", "0") or 0)
    if dl and time.time() > dl:
        print(f"bench child: deadline exceeded {label}, exiting",
              file=sys.stderr)
        sys.exit(3)


def run_bench(dtype: str, steps: int, config: str = "flagship"):
    """Measure one configuration in-process (child mode)."""
    sys.path.insert(0, HERE)
    from fargocpt_tpu import compile_cache, gpu
    compile_cache.enable()
    import jax
    try:
        gpu.require_gpu()
    except gpu.NoGPUError as e:
        print(f"bench: {e}", file=sys.stderr)
        sys.exit(2)
    from __graft_entry__ import _flagship, _pds70

    if config == "pds70":
        sim = _pds70(NRAD, NAZ, dtype)
    else:
        sim = _flagship(NRAD, NAZ, dtype)
    advance, carry = _build_advance(sim)

    # warmup + compile (same static length as the timed run so the timed
    # region never compiles)
    _deadline_check("before warmup")
    carry = advance(carry, steps)
    jax.block_until_ready(carry[0].fields.sigma)

    _deadline_check("after warmup")
    t0 = time.perf_counter()
    carry = advance(carry, steps)
    jax.block_until_ready(carry[0].fields.sigma)
    elapsed = time.perf_counter() - t0

    mcups = NRAD * NAZ * steps / elapsed / 1e6
    desc = "full-physics step incl. CFL" if config == "flagship" else \
        "SG + FLD + PVTE + dust step incl. CFL"
    dev = gpu.device_record(jax.devices())
    result = {
        "metric": f"Mcell-updates/s at {NRAD}x{NAZ} polar grid "
                  f"({desc}, {dtype})",
        "value": mcups,
        "unit": "Mcell/s",
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "card": gpu.card_name_and_power_limit(),
    }
    print(json.dumps(result))
    return result


_CHILD_CONFIGS = {
    # name -> (dtype, steps-env-var, default steps, config, timeout s,
    #          warm cost s)
    "flagship_f32": ("float32", "BENCH_STEPS", 100, "flagship", 2400, 60),
    # SG FFT + FLD + PVTE + dust: fewer steps (each step carries an FFT
    # convolution pair + an SOR solve)
    "pds70": ("float32", "BENCH_PDS70_STEPS", 20, "pds70", 2400, 80),
    "f64": ("float64", "BENCH_F64_STEPS", 10, "flagship", 2400, 70),
}


def _run_child(name, timeout_cap=None):
    """Run one bench line in a fresh subprocess; return its raw JSON
    line (str), or None if it crashed or timed out (failure is
    contained).  Does NOT print to stdout — the orchestrator controls
    all stdout writes so the flagship line can be kept last atomically."""
    timeout = _CHILD_CONFIGS[name][4]
    if timeout_cap is not None:
        timeout = min(timeout, timeout_cap)
    env = dict(os.environ)
    env["BENCH_ONLY"] = name
    # the child exits at its next checkpoint 30 s before the kill lands
    env["BENCH_CHILD_DEADLINE"] = str(time.time() + max(timeout - 30, 30))
    try:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env,
            capture_output=True, text=True, timeout=timeout, cwd=HERE)
    except subprocess.TimeoutExpired:
        print(f"bench[{name}]: timed out after {timeout}s (contained)",
              file=sys.stderr)
        return None
    if res.stderr:
        sys.stderr.write(res.stderr)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode != 0 or not lines:
        print(f"bench[{name}]: rc={res.returncode} (contained)\n"
              f"{res.stdout}", file=sys.stderr)
        return None
    return lines[-1]


def main():
    only = os.environ.get("BENCH_ONLY", "")
    if only:
        dtype, steps_env, default, config, _, _ = _CHILD_CONFIGS[only]
        steps = int(os.environ.get(steps_env, default))
        return run_bench(dtype, steps, config=config)

    t_start = time.monotonic()
    wall_budget = float(os.environ.get("BENCH_WALL_BUDGET", 480))

    def emit(text):
        # one raw os.write: atomic on a pipe below PIPE_BUF (4096 B)
        sys.stdout.flush()
        os.write(sys.stdout.fileno(), text.encode())

    official_line = _run_child("flagship_f32")
    if official_line is None:
        sys.exit(1)
    official = json.loads(official_line)
    emit(official_line + "\n")

    optional = [name for name in ("pds70", "f64")
                if os.environ.get(f"BENCH_SKIP_{name.upper()}", "") != "1"]
    for i, name in enumerate(optional):
        remaining = wall_budget - (time.monotonic() - t_start)
        warm_cost = _CHILD_CONFIGS[name][5]
        if remaining < warm_cost:
            print(f"bench[{name}]: skipped — remaining wall budget "
                  f"{remaining:.0f}s below warm cost {warm_cost}s "
                  f"(of {wall_budget:.0f}s total)", file=sys.stderr)
            continue
        # reserve the later children's warm costs
        reserve = sum(_CHILD_CONFIGS[m][5] for m in optional[i + 1:])
        cap = max(remaining - reserve, warm_cost)
        line = _run_child(name, timeout_cap=cap)
        if line is not None:
            emit(line + "\n" + official_line + "\n")
    return official


if __name__ == "__main__":
    main()
