"""Construction places every array on the default device.

A Simulation built under ``jax.default_device(d)`` must hold no array on
any other device — neither in its state nor in what its stepper closes
over (geometry columns, kernels, reference values, tables).  An array left
on another device would be copied in again by every compiled call.  Runs
on the 8 virtual CPU devices of the test configuration, building on
device 1 so that a stray array on device 0 shows.
"""

import dataclasses
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _arrays(root):
    """Every jax.Array reachable from ``root`` through attributes,
    dataclass fields, containers and pytrees (with the path to it)."""
    seen, out = set(), []

    def walk(obj, path):
        if id(obj) in seen or obj is None:
            return
        seen.add(id(obj))
        if isinstance(obj, jax.Array):
            out.append((path, obj))
            return
        if isinstance(obj, (str, bytes, int, float, bool, complex,
                            np.ndarray, np.generic, type,
                            types.ModuleType, types.FunctionType,
                            types.BuiltinFunctionType)):
            return
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}[{k!r}]")
            return
        if isinstance(obj, (list, tuple, set, frozenset)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
            return
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name, None), f"{path}.{f.name}")
        for k, v in getattr(obj, "__dict__", {}).items():
            walk(v, f"{path}.{k}")

    walk(root, "sim")
    return out


def _flagship():
    from __graft_entry__ import _flagship
    return _flagship(32, 64, "float32")


def _pds70_style():
    from __graft_entry__ import _pds70
    return _pds70(32, 64, "float32", n_particles=32)


def _planets():
    """The shipped PDS70 setup (2 planets, accretion, damping, dust),
    shrunk."""
    from fargocpt_tpu.config import Config
    from fargocpt_tpu.sim import Simulation
    cfg = Config.from_file(str(REPO / "setups" / "PDS70.yml"))
    cfg._raw.update({"nrad": 32, "naz": 64, "numberofparticles": 16})
    return Simulation(cfg, dtype="float64")


@pytest.mark.parametrize("build", [_flagship, _pds70_style, _planets],
                         ids=["flagship", "pds70_style", "planets"])
def test_construction_stays_on_default_device(build):
    target = jax.devices()[1]
    with jax.default_device(target):
        sim = build()
        arrays = _arrays(sim)
        assert len(arrays) > 20
        stray = [(p, a.devices()) for p, a in arrays
                 if a.devices() != {target}]
        assert not stray, stray[:10]
        # and the compiled step keeps the state there
        state = sim.stepper.step(sim.state, 0.0, 1e-6)
        assert state.fields.sigma.devices() == {target}
        assert np.all(np.isfinite(np.asarray(state.fields.sigma)))
