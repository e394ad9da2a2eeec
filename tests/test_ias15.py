"""IAS15 adaptive Gauss-Radau N-body integrator gates.

The reference integrates its planetary system with REBOUND IAS15
(src/nbody/planetary_system.cpp:35-64, :878); these tests hold the JAX
implementation (fargocpt_tpu/nbody/ias15.py) to that standard: machine-
level energy conservation on highly eccentric orbits, exact-finish-time
semantics, and analytic Kepler-orbit accuracy far beyond the old RK4
substepper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fargocpt_tpu.nbody.ias15 import integrate_ias15
from fargocpt_tpu.nbody import system as ns


def _two_body(e, a=1.0, m2=1e-3):
    """Two-body system at apocenter, COM frame."""
    m = jnp.array([1.0, m2])
    M = float(m.sum())
    r_apo = a * (1 + e)
    v_apo = np.sqrt(M * (1 - e) / (a * (1 + e)))
    x = jnp.array([-(m2 / M) * r_apo, (1.0 / M) * r_apo])
    y = jnp.zeros(2)
    vx = jnp.zeros(2)
    vy = jnp.array([-(m2 / M) * v_apo, (1.0 / M) * v_apo])
    T = 2 * np.pi * np.sqrt(a ** 3 / M)
    return x, y, vx, vy, m, T


def _energy(x, y, vx, vy, m):
    ke = 0.5 * (m * (vx ** 2 + vy ** 2)).sum()
    dx, dy = x[1] - x[0], y[1] - y[0]
    return float(ke - m[0] * m[1] / jnp.sqrt(dx * dx + dy * dy))


def test_eccentric_orbit_energy_and_return():
    """e=0.9 orbit, 100 periods in hydro-step-sized calls: energy drift
    < 1e-11, apocenter return position error < 1e-8 (RK4x16 at the same
    call size is ~1e-3 here)."""
    x, y, vx, vy, m, T = _two_body(0.9)
    E0 = _energy(x, y, vx, vy, m)
    step = jax.jit(
        lambda x, y, vx, vy, dt: integrate_ias15(x, y, vx, vy, m, 1.0, dt))
    for _ in range(1000):
        x, y, vx, vy = step(x, y, vx, vy, T / 10)
    E1 = _energy(x, y, vx, vy, m)
    assert abs((E1 - E0) / E0) < 1e-11
    r_apo_1 = (1.0 / float(m.sum())) * (1 + 0.9)
    err = np.hypot(float(x[1]) - r_apo_1, float(y[1]))
    assert err < 1e-8


@pytest.mark.slow
def test_long_term_energy_drift():
    """1000 eccentric orbits in one exact-finish call per orbit:
    energy drift < 1e-10."""
    x, y, vx, vy, m, T = _two_body(0.9)
    E0 = _energy(x, y, vx, vy, m)
    step = jax.jit(
        lambda x, y, vx, vy: integrate_ias15(x, y, vx, vy, m, 1.0, T))
    for _ in range(1000):
        x, y, vx, vy = step(x, y, vx, vy)
    E1 = _energy(x, y, vx, vy, m)
    assert abs((E1 - E0) / E0) < 1e-10


def test_exact_finish_time_and_circular_precision():
    """Circular orbit integrated over an odd fraction of a period lands
    on the analytic phase to near machine precision."""
    x, y, vx, vy, m, T = _two_body(0.0)
    dt = 0.37 * T
    x1, y1, vx1, vy1 = integrate_ias15(x, y, vx, vy, m, 1.0, dt)
    M = float(m.sum())
    r1 = 1.0 / M                 # body-1 COM-frame radius (a=1)
    phi = 2 * np.pi * 0.37
    assert abs(float(x1[1]) - r1 * np.cos(phi)) < 1e-11
    assert abs(float(y1[1]) - r1 * np.sin(phi)) < 1e-11


def test_system_integrate_dispatch():
    """nbody.system.integrate defaults to IAS15 and matches a direct
    call; the rk4 path stays available."""
    x, y, vx, vy, m, T = _two_body(0.5)
    st = ns.NBodyState(x=x, y=y, vx=vx, vy=vy, mass=m)
    out = ns.integrate(st, 1.0, T / 7)
    xd, yd, vxd, vyd = integrate_ias15(x, y, vx, vy, m, 1.0, T / 7)
    np.testing.assert_array_equal(np.asarray(out.x), np.asarray(xd))
    out_rk4 = ns.integrate(st, 1.0, T / 7, method="rk4")
    # both agree on a mildly eccentric short arc
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(out_rk4.x),
                               rtol=0, atol=5e-8)
