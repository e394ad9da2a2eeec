"""Chunked advance_to: splitting a monitor interval across several
while_loop device calls (HydroStep.max_steps_per_call) must reproduce the
single-call run exactly — every step depends only on the carried
(state, time, last_dt), so the dt sequence is identical.

Chunking bounds the length of each device call and gives the host a
point between calls to react. Default cap is 256 steps per call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation


def _cfg(extra=None):
    d = {
        "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
        "AspectRatio": "0.05", "ViscousAlpha": "1e-3",
        "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
        "Nrad": "32", "Naz": "16", "Rmin": "0.4", "Rmax": "2.5",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.5",
        "nbody": [
            {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
            {"name": "jup", "semi-major axis": "1.0", "mass": "1e-3"},
        ],
    }
    if extra:
        d.update(extra)
    return Config.from_dict(d)


def _compare(out_a, out_b):
    assert int(out_a[3]) == int(out_b[3])
    for fld in ("sigma", "energy", "vrad", "vaz"):
        a = np.asarray(getattr(out_a[0].fields, fld))
        b = np.asarray(getattr(out_b[0].fields, fld))
        assert np.array_equal(a, b), fld
    # time, last_dt, dt_min, dt_max are exact; the dt_sum / dt_sum_sq
    # accumulators differ only by summation order (1 ulp)
    for i in (1, 2, 4, 5):
        assert float(out_a[i]) == float(out_b[i]), i
    for i in (6, 7):
        ref = abs(float(out_a[i])) or 1.0
        assert abs(float(out_a[i]) - float(out_b[i])) / ref < 1e-12, i


def test_chunked_advance_bitwise_identical():
    sim = Simulation(_cfg())
    st = sim.stepper
    st.max_steps_per_call = 0
    out_a = st.advance_to(sim.state, 0.0, 1e-5, 0.5)
    assert int(out_a[3]) > 20  # several chunks' worth of steps
    st.max_steps_per_call = 7
    out_b = st.advance_to(sim.state, 0.0, 1e-5, 0.5)
    _compare(out_a, out_b)
    # cap larger than the run: single chunk, still identical
    st.max_steps_per_call = 10_000
    out_c = st.advance_to(sim.state, 0.0, 1e-5, 0.5)
    _compare(out_a, out_c)


@pytest.mark.slow  # 36 s; test_chunked_advance_bitwise_identical keeps
# the chunked-advance gate fast, test_sharding the sharded-equivalence one
def test_chunked_advance_sharded():
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    from jax.sharding import Mesh
    from fargocpt_tpu.parallel.shard_step import ShardedHydroStep

    cfg = _cfg({"Nrad": "88", "Naz": "16"})
    sim = Simulation(cfg)
    mesh = Mesh(np.array(jax.devices()[:4]), ("r",))
    ss = ShardedHydroStep(sim.stepper, mesh, halo=10)
    pair = ss.shard_state(sim.state)

    sim.stepper.max_steps_per_call = 0
    out_a = ss.advance_to(pair, 0.0, 1e-5, 0.2)
    sim.stepper.max_steps_per_call = 5
    out_b = ss.advance_to(pair, 0.0, 1e-5, 0.2)
    assert int(out_a[3]) == int(out_b[3])
    ga = np.asarray(ss.gather(out_a[0]).fields.sigma)
    gb = np.asarray(ss.gather(out_b[0]).fields.sigma)
    assert np.array_equal(ga, gb)
    for i in (1, 2, 4, 5):
        assert float(out_a[i]) == float(out_b[i]), i
