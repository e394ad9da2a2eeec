"""The plain FARGO transport (ops/transport.py) on its own.

Two exact properties over the configuration matrix (adiabatic x
fast_transport x flux limiter): mass is conserved to round-off on a
closed grid, and a uniform rotation by an integer number of cells per
ring reproduces ``np.roll`` exactly.  Plus the integer FARGO shift
(``advect_shift``) against a per-ring ``np.roll``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fargocpt_tpu.grid import Geometry
from fargocpt_tpu.ops import transport
from fargocpt_tpu.ops.common import prepare_geom
from fargocpt_tpu.params import Physics

NR, NAZ = 32, 64


@pytest.fixture(scope="module")
def geom():
    return prepare_geom(Geometry.build(NR, NAZ, 0.4, 2.5, "Log"),
                        jnp.float64)


def _phys(adiabatic, fast, limiter):
    return Physics(eos="adiabatic" if adiabatic else "isothermal",
                   adiabatic_index=1.4, aspectratio_ref=0.05,
                   fast_transport=fast, flux_limiter_type=limiter)


MATRIX = [(a, f, lim) for a in (True, False) for f in (True, False)
          for lim in (0, 1)]
IDS = [f"{'adiabatic' if a else 'isothermal'}-"
       f"{'fast' if f else 'standard'}-limiter{lim}" for a, f, lim in MATRIX]


@pytest.mark.parametrize("adiabatic,fast,limiter", MATRIX, ids=IDS)
def test_transport_conserves_mass(geom, adiabatic, fast, limiter):
    """Face fluxes telescope (the domain-edge faces carry none) and the
    azimuthal sweeps and the integer shift are periodic, so total mass
    changes only by round-off."""
    g = geom
    rng = np.random.default_rng(5)
    sigma = jnp.asarray(rng.random((NR, NAZ)) + 0.5)
    energy = jnp.asarray(rng.random((NR, NAZ)) * 1e-3 + 1e-3)
    vaz = jnp.asarray((rng.random((NR, NAZ)) - 0.5) * 0.2
                      + 1.0 / np.sqrt(np.asarray(g.rb)))
    vrad = jnp.asarray((rng.random((NR + 1, NAZ)) - 0.5) * 0.05)
    phys = _phys(adiabatic, fast, limiter)
    s1, vr1, va1, e1, mflux = transport.transport(
        phys, g, sigma, vrad, vaz, energy, 0.3, 0.01)
    surf = np.asarray(g.surf)
    m0 = float(np.sum(np.asarray(sigma) * surf))
    m1 = float(np.sum(np.asarray(s1) * surf))
    assert abs(m1 - m0) <= 1e-13 * m0
    for a in (s1, vr1, va1, e1, mflux):
        assert np.all(np.isfinite(np.asarray(a)))
    assert not np.allclose(np.asarray(s1), np.asarray(sigma))


def _integer_rotation(g, dt, rng):
    """(per-ring shifts, uniform per-ring vaz) whose FARGO residual is
    exactly zero.  For each ring try shifts n in random order, and speeds
    a few thousand ulps around ``n r dphi / dt``; keep one whose azimuthal
    mean is exact and whose cells moved per step, ``vmean / r / dphi *
    dt`` in the transport's own arithmetic, is exactly n."""
    inv_rb = np.asarray(g.inv_rb)[:, 0]
    shifts, rows = [], []
    for i in range(NR):
        for n in rng.permutation([k for k in range(-7, 8) if k]):
            x0 = float(n * g.dphi * np.asarray(g.rb)[i, 0] / dt)
            cand = x0 + np.spacing(x0) * np.arange(-512, 513)
            vmean = jnp.mean(
                jnp.asarray(np.repeat(cand[:, None], NAZ, axis=1)), axis=-1)
            cells = vmean * inv_rb[i] * dt * g.invdphi
            ok = (np.asarray(vmean) == cand) & (np.asarray(cells) == n)
            if ok.any():
                shifts.append(int(n))
                rows.append(cand[np.argmax(ok)])
                break
        else:
            shifts.append(0)
            rows.append(0.0)
    return (np.asarray(shifts),
            np.repeat(np.asarray(rows)[:, None], NAZ, axis=1))


@pytest.mark.parametrize("adiabatic,fast,limiter", MATRIX, ids=IDS)
def test_transport_integer_rotation_is_exact_roll(geom, adiabatic, fast,
                                                  limiter):
    """With no radial motion and a rotation of exactly n_i cells per step
    on ring i, transport moves the scalars by a pure per-ring roll (rings
    where no float64 speed gives exactly n_i stand still, n_i = 0)."""
    g = geom
    dt = 0.01
    rng = np.random.default_rng(9)
    shifts, vaz = _integer_rotation(g, dt, rng)
    assert np.count_nonzero(shifts) >= NR // 3
    vaz = jnp.asarray(vaz)
    vmean = jnp.mean(vaz, axis=-1, keepdims=True)
    np.testing.assert_array_equal(np.asarray(vmean), np.asarray(vaz)[:, :1])
    np.testing.assert_array_equal(
        np.asarray(vmean * g.inv_rb * dt * g.invdphi)[:, 0], shifts)
    sigma = rng.random((NR, NAZ)) + 0.5
    energy = rng.random((NR, NAZ)) * 1e-3 + 1e-3
    vrad = jnp.zeros((NR + 1, NAZ))
    phys = _phys(adiabatic, fast, limiter)
    s1, vr1, va1, e1, _ = transport.transport(
        phys, g, jnp.asarray(sigma), vrad, vaz, jnp.asarray(energy), 0.0,
        dt)
    rolled_s = np.stack([np.roll(sigma[i], shifts[i]) for i in range(NR)])
    rolled_e = np.stack([np.roll(energy[i], shifts[i]) for i in range(NR)])
    np.testing.assert_array_equal(np.asarray(s1), rolled_s)
    np.testing.assert_array_equal(
        np.asarray(e1), rolled_e if adiabatic else energy)
    np.testing.assert_array_equal(np.asarray(vr1)[:NR], 0.0)
    np.testing.assert_allclose(np.asarray(va1), np.asarray(vaz), rtol=1e-14)


@pytest.mark.parametrize("naz", [64, 100, 96])
def test_advect_shift_matches_numpy_roll(naz):
    """Random per-ring shifts, negative ones and ones beyond NAZ included,
    on power-of-two and other azimuth counts."""
    rng = np.random.default_rng(naz)
    q = rng.random((3, 16, naz))
    nshift = rng.integers(-3 * naz, 3 * naz, 16)
    nshift[:4] = [0, -1, naz, naz + 5]
    out = np.asarray(transport.advect_shift(jnp.asarray(q),
                                            jnp.asarray(nshift, jnp.int32)))
    ref = np.stack([np.roll(q[:, i], nshift[i], axis=-1) for i in range(16)],
                   axis=1)
    np.testing.assert_array_equal(out, ref)
