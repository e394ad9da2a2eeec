"""Command-line interface.

Mirrors the reference launcher semantics
(python_module/fargocpt/_command_line_.py + src/options.cpp):

  python -m fargocpt_tpu start setup.yml
  python -m fargocpt_tpu restart <N> setup.yml
  python -m fargocpt_tpu auto setup.yml
  python -m fargocpt_tpu bench [--nrad N --naz N]

No mpirun/NUMA logic is needed: one process drives all local GPUs through
the jit/mesh machinery.
"""

from __future__ import annotations

import argparse
import contextlib
import signal
import sys


def _add_log_flags(p):
    """Reference log-level options (src/options.cpp:46-69,:130-136)."""
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print errors and warnings")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode")
    p.add_argument("-d", "--debug", action="store_true",
                   help="print debug information at each monitor step")


def main(argv=None):
    # info subcommands dispatch before the jax-heavy launcher path
    # (reference python_module/fargocpt/_command_line_.py:30-39)
    argv_eff = sys.argv[1:] if argv is None else argv
    if argv_eff and argv_eff[0] == "data":
        from .analysis import data_main
        return data_main(argv_eff[1:])
    if argv_eff and argv_eff[0] == "config":
        from .usercfg import main as config_main
        return config_main(argv_eff[1:])

    parser = argparse.ArgumentParser(prog="fargocpt_tpu")
    sub = parser.add_subparsers(dest="mode", required=True)
    sub.add_parser("data", help="inspect an output directory "
                   "(fargocpt_tpu data OUTDIR [path [N]])")
    sub.add_parser("config", help="user tool preferences "
                   "(show/get/set/remove)")

    for mode in ("start", "auto"):
        p = sub.add_parser(mode)
        p.add_argument("setup", help="YAML setup file")
        p.add_argument("-o", "--outdir", default=None)
        p.add_argument("--dtype", default=None,
                       choices=["float64", "float32"])
        p.add_argument("-N", "--max-iterations", type=int, default=None)
        p.add_argument("--profile", metavar="DIR", default=None,
                       help="write a jax.profiler trace of the run")
        p.add_argument("--debug-nans", action="store_true",
                       help="enable jax_debug_nans (FPE-trap analog)")
        _add_log_flags(p)

    p = sub.add_parser("restart")
    p.add_argument("snapshot", help="snapshot number (or 'last')")
    p.add_argument("setup", help="YAML setup file")
    p.add_argument("-o", "--outdir", default=None)
    p.add_argument("--dtype", default=None,
                   choices=["float64", "float32"])
    p.add_argument("-N", "--max-iterations", type=int, default=None)
    p.add_argument("--profile", metavar="DIR", default=None)
    p.add_argument("--debug-nans", action="store_true")
    _add_log_flags(p)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--nrad", type=int, default=1024)
    p.add_argument("--naz", type=int, default=3072)
    p.add_argument("--steps", type=int, default=100)

    args = parser.parse_args(argv)

    if getattr(args, "dtype", "x") is None:
        # launcher defaults from the user config store
        # (``fargocpt_tpu config set default_dtype float32``)
        from .usercfg import UserConfig
        args.dtype = UserConfig().get("default_dtype", "float64")
    if getattr(args, "outdir", "x") is None and args.mode != "bench":
        from .usercfg import UserConfig
        base = UserConfig().get("default_outdir")
        if base:
            import pathlib
            import os as _os
            name = pathlib.Path(args.setup).stem
            args.outdir = _os.path.join(base, name)

    if args.mode == "bench":
        import runpy
        import os as _os
        _os.environ.setdefault("BENCH_NRAD", str(args.nrad))
        _os.environ.setdefault("BENCH_NAZ", str(args.naz))
        _os.environ.setdefault("BENCH_STEPS", str(args.steps))
        from pathlib import Path
        bench = Path(__file__).resolve().parent.parent / "bench.py"
        runpy.run_path(str(bench), run_name="__main__")
        return 0

    # benign placeholders so signals arriving during the (slow) jax import
    # and first compile don't kill the process before the real handlers
    # are registered below
    signal.signal(signal.SIGUSR1, lambda *_: None)
    import faulthandler
    faulthandler.register(signal.SIGUSR2, all_threads=True)

    import jax
    from .compile_cache import enable as _enable_cache
    _enable_cache()
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    if args.debug_nans:
        # NaN trap (analog of the reference's FPE trapping stub,
        # src/main.cpp:64-66, actually usable here)
        jax.config.update("jax_debug_nans", True)

    from .config import Config
    from .sim import Simulation
    from . import output as out
    from . import log

    # leveled logging (reference src/logging.cpp print_level semantics)
    if args.quiet:
        log.set_print_level(log.WARNING)
    elif args.debug:
        log.set_print_level(log.DEBUG)
    elif args.verbose:
        log.set_print_level(log.VERBOSE)

    # build-time info at startup (reference src/buildtime_info.cpp)
    from . import build_info
    log.notice(build_info())

    cfg = Config.from_file(args.setup)
    sim = Simulation(cfg, outdir=args.outdir, dtype=args.dtype)
    writer = out.OutputWriter(sim)

    # pidfile for external supervision (reference src/parallel.cpp:44-50)
    import os
    (writer.outdir / "fargocpt.pid").write_text(f"{os.getpid()}\n")

    # mirror the progress log into the output dir (reference
    # src/logging.cpp:43-60 per-run log files)
    (writer.outdir / "logs").mkdir(exist_ok=True)
    log_fh = open(writer.outdir / "logs" / "fargocpt.log", "a")
    # leveled per-run files log_0.txt/err_0.txt + pre-init buffer flush
    log.init_logfiles(writer.outdir)
    # -v: tell everything about the parameters file (reference
    # src/options.cpp:68 + the reference's verbose parameter echo)
    for key, val in sorted(cfg._consulted.items()):
        log.verbose(f"param {cfg._orig_case.get(key, key)} = {val!r}")

    class _Tee:
        def __init__(self, *streams):
            self.streams = streams

        def write(self, s):
            for st in self.streams:
                st.write(s)

        def flush(self):
            for st in self.streams:
                st.flush()

    # the tee ends with the run, so a caller in the same process (e.g.
    # ``fargocpt_tpu.run``) gets its stdout back
    with log_fh, contextlib.redirect_stdout(_Tee(sys.__stdout__, log_fh)):
        if args.profile:
            # tracing (reference has no tracer; callgrind scripts instead —
            # here a real jax.profiler trace, viewable in tensorboard/xprof)
            jax.profiler.start_trace(args.profile)

        if args.mode == "restart":
            sid = args.snapshot
            if sid == "last":
                sid = out.last_snapshot_id(writer.outdir)
            out.restore_simulation(sim, writer.outdir, sid)
            log.notice(f"restarted from snapshot {sid} at t = {sim.time:.6g}")
        elif args.mode == "auto":
            list_file = writer.outdir / "snapshots" / "list.txt"
            if list_file.exists() and list_file.read_text().strip():
                sid = out.last_snapshot_id(writer.outdir)
                out.restore_simulation(sim, writer.outdir, sid)
                log.notice(f"auto: resuming from snapshot {sid} at t = {sim.time:.6g}")
            else:
                log.notice("auto: no snapshots found, starting fresh")

        # SIGTERM -> autosave + clean exit (reference src/simulation.cpp:497-531)
        stop_requested = {"flag": False}

        def _sigterm(_signum, _frame):
            stop_requested["flag"] = True

        signal.signal(signal.SIGTERM, _sigterm)

        # SIGUSR1 -> CFL/timestep debug report (reference src/cfl.cpp:358-372
        # PRINT_SIG_INFO); SIGUSR2 -> python stack backtrace (reference
        # src/backtrace.cpp via execinfo)
        def _sigusr1(_signum, _frame):
            import jax.numpy as _jnp
            cfl_dt = float(sim.stepper.cfl_dt(sim.state))
            log.notice(f"[SIGUSR1] t = {sim.time:.8g}  monitor {sim.n_monitor}  "
                       f"hydro steps {sim.n_hydro_iter}  last_dt = "
                       f"{sim.last_dt:.6g}  CFL dt = {cfl_dt:.6g}")

        signal.signal(signal.SIGUSR1, _sigusr1)

        # copy the setup file into the output dir for provenance
        import shutil
        shutil.copyfile(args.setup, writer.outdir / "parameters" / "setup.yml")

        s = sim.settings
        total_monitors = s.n_snapshots * s.n_monitor
        # fresh starts grow last_dt twice before the loop (reference
        # main.cpp:117 + simulation.cpp:467); restarts were primed by
        # restore_simulation
        if not sim._dt_primed:
            sim.calculate_time_step()
            sim.calculate_time_step()
            sim._dt_primed = True
        import time
        _log_state = {"steps": 0, "wall": time.time()}
        if not getattr(sim, "_restored", False):
            # restarts must not re-register the restored snapshot (reference
            # run() writes no initial output, src/simulation.cpp:505-560)
            sim._handle_outputs(initial=True)
        while sim.n_monitor < total_monitors:
            if args.max_iterations is not None \
                    and sim.n_hydro_iter >= args.max_iterations:
                break
            if stop_requested["flag"]:
                writer.write_snapshot("autosave", register=False)
                log.notice("SIGTERM received: autosave written, exiting")
                return 0
            t_target = (sim.n_monitor + 1) * s.monitor_timestep
            import time as _t
            w0 = _t.time()
            (sim.state, time_arr, last_dt_arr, n_steps, dt_min, dt_max,
             dt_sum, dt_sq) = sim.stepper.advance_to(
                sim.state, sim.time, sim.last_dt, t_target)
            sim.time = float(time_arr)
            sim.last_dt = float(last_dt_arr)
            n = int(n_steps)
            sim.n_hydro_iter += n
            sim.monitor_stats = {
                "n_steps": n, "walltime": _t.time() - w0,
                "dt_min": float(dt_min), "dt_max": float(dt_max),
                "dt_sum": float(dt_sum), "dt_sq": float(dt_sq)}
            sim.n_monitor += 1
            sim._handle_outputs()
            # autosave dirs are cleaned after the next real snapshot
            # (reference src/output.cpp:225-248)
            autosave = writer.outdir / "snapshots" / "autosave"
            if autosave.exists() and sim.n_monitor % s.n_monitor == 0:
                shutil.rmtree(autosave, ignore_errors=True)
            rate = n / max(sim.monitor_stats["walltime"], 1e-9)
            # runtime-log throttle (reference src/logging.cpp:214-235
            # LogAfterSteps / LogAfterRealSeconds); this rebuild can only log
            # at monitor boundaries, so the keys set minimum gaps between lines
            log_now = True
            if sim.phys.log_after_steps > 0:
                log_now = (sim.n_hydro_iter - _log_state["steps"]
                           >= sim.phys.log_after_steps)
            elif sim.phys.log_after_real_seconds > 0.0:
                log_now = (time.time() - _log_state["wall"]
                           >= sim.phys.log_after_real_seconds)
            if log_now or sim.n_monitor == total_monitors:
                _log_state["steps"] = sim.n_hydro_iter
                _log_state["wall"] = time.time()
                log.info(f"monitor {sim.n_monitor}/{total_monitors}  "
                         f"t={sim.time:.6g}  steps={sim.n_hydro_iter}  "
                         f"{rate:.1f} steps/s")
                log.debug(f"  dt range [{sim.monitor_stats['dt_min']:.4g}, "
                          f"{sim.monitor_stats['dt_max']:.4g}]  walltime "
                          f"{sim.monitor_stats['walltime']:.3f} s")
        if args.profile:
            jax.profiler.stop_trace()
            log.notice(f"profiler trace written to {args.profile}")
        log.notice("done")
        return 0


if __name__ == "__main__":
    sys.exit(main())
