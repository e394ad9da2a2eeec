#!/usr/bin/env python3
"""Strong-scaling harness (analog of reference test/scaling/test_scaling.py).

Sweeps device counts over a radial jax.sharding.Mesh and reports wall time
per hydro step. On GPUs the collectives ride NVLink; with --cpu the same
sweep runs on virtual CPU devices to validate the sharded program (CPU
times are not device numbers).

Usage:
    python tools/scaling.py [--nrad 256] [--naz 768] [--steps 20]
        [--devices 1,2,4,8] [--dtype float64|float32] [--cpu]

Writes scaling.txt rows: n_devices  ms_per_step  speedup.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nrad", type=int, default=256)
    ap.add_argument("--naz", type=int, default=768)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU with virtual devices")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--out", default="scaling.txt")
    args = ap.parse_args()
    counts = [int(x) for x in args.devices.split(",")]

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(counts))
    from __graft_entry__ import _flagship
    from fargocpt_tpu.parallel.shard_step import ShardedHydroStep
    from fargocpt_tpu.parallel.mesh import make_mesh

    rows = []
    base_ms = None
    for n in counts:
        if n > len(jax.devices()):
            print(f"skipping n={n}: only {len(jax.devices())} devices")
            continue
        sim = _flagship(args.nrad, args.naz, args.dtype)
        dt0 = float(sim.stepper.cfl_dt(sim.state)) * 0.5
        t_target = args.steps * dt0
        if n == 1:
            # unsharded single-device baseline
            def advance(_):
                return sim.stepper.advance_to(sim.state, 0.0, dt0, t_target)
            sharded = None
        else:
            mesh = make_mesh(n)
            # explicit shard_map/ppermute execution (one stacked
            # bidirectional halo exchange per step, pmin for dt) — the
            # analog of the reference's test/scaling MPI sweep
            ss = ShardedHydroStep(sim.stepper, mesh)
            sharded = ss.shard_state(sim.state)

            def advance(sh):
                return ss.advance_to(sh, 0.0, dt0, t_target)

        out = advance(sharded)          # compile + warmup
        n_steps = int(out[3])
        jax.block_until_ready(jax.tree_util.tree_leaves(out[0])[0])
        t0 = time.perf_counter()
        out = advance(sharded)
        jax.block_until_ready(jax.tree_util.tree_leaves(out[0])[0])
        ms = (time.perf_counter() - t0) / max(n_steps, 1) * 1e3
        if base_ms is None:
            base_ms = ms
        rows.append((n, ms, base_ms / ms))
        print(f"n_devices={n:3d}  {ms:9.3f} ms/step  ({n_steps} steps)  "
              f"speedup={base_ms / ms:6.2f}  "
              f"({args.nrad * args.naz / ms / 1e3:.1f} Mcell/s)")

    with open(args.out, "w") as f:
        f.write("# n_devices  ms_per_step  speedup\n")
        for n, ms, sp in rows:
            f.write(f"{n}\t{ms:.6g}\t{sp:.6g}\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
