"""fargocpt_tpu — JAX protoplanetary-disk simulation framework.

A JAX/XLA implementation of the capabilities of FargoCPT (2-D polar-grid
disk hydrodynamics with FARGO orbital advection, N-body coupling,
viscosity, energy equation, self-gravity, FLD radiative transfer,
Lagrangian dust): state is a pytree of arrays, a time step is one jitted
function, and multi-GPU scaling uses a radial `jax.sharding.Mesh` with
collective halo exchange instead of MPI.

Physics fidelity is gated by ports of the reference's analytic test suite
(see tests/).
"""

__version__ = "0.2.0"

def build_info() -> str:
    """Version + git commit/dirty stamp of the installed tree (reference
    src/buildtime_info.cpp prints the compile-time git state; here it is
    read live from the package's repository when available)."""
    import subprocess as _sp
    from pathlib import Path as _Path
    root = _Path(__file__).resolve().parent.parent
    commit, dirty = "unknown", ""
    try:
        commit = _sp.run(
            ["git", "-C", str(root), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5).stdout.strip() \
            or "unknown"
        changed = _sp.run(
            ["git", "-C", str(root), "diff-index", "--name-only", "HEAD"],
            capture_output=True, text=True, timeout=5).stdout.strip()
        if changed:
            dirty = f" (dirty: {len(changed.splitlines())} files)"
    except Exception:
        pass
    return f"fargocpt_tpu {__version__} git {commit}{dirty}"

# x64 must be live BEFORE any array is built anywhere in the package: the
# N-body system always integrates in f64 (IAS15's controller works below
# the f32 noise floor), and float64 Simulations must get true-f64 initial
# fields.  Enabling it lazily (e.g. in HydroStep.__init__) once truncated
# the first Simulation's ICs to f32 — see tests/test_driver_parity.py.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from . import config, constants, grid, params, state, units  # noqa: F401


def enable_x64():
    """Enable float64 (required for physics-fidelity tests; production
    runs often use float32)."""
    import jax
    jax.config.update("jax_enable_x64", True)


def run(args, np=None, nt=None, stdout=None, exe=None, detach=False):
    """Single-call launcher, API-compatible with the reference's
    ``fargocpt.run(fargo_args, np=..., nt=...)``
    (python_module/fargocpt/run.py:199).  ``args`` is the CLI argv, e.g.
    ``["start", "setup.yml", "-o", "out"]``.  The MPI/OpenMP process
    allocation knobs (np/nt) are accepted for drop-in compatibility but
    unused: one process drives all local GPUs through jit/mesh, so there
    is nothing to allocate.  Returns the CLI exit code."""
    del np, nt, exe, detach  # no mpirun/NUMA layer in a JAX process
    import contextlib

    from . import __main__ as cli
    if stdout is not None:
        with contextlib.redirect_stdout(stdout):
            return cli.main(list(args))
    return cli.main(list(args))


def Loader(outdir):
    """Reference-API convenience re-export (``fargocpt.Loader``,
    python_module/fargocpt/data.py)."""
    from .analysis import Loader as _Loader
    return _Loader(outdir)
