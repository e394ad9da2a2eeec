"""PVTE variable-gamma equation of state.

Validates the hydrogen micro-physics against known limits (reference
src/pvte_law.cpp / Vaidya et al. 2015):
  * cold molecular gas: rotation frozen out, gamma -> 5/3
  * warm molecular gas (rotation active): gamma ~ 7/5
  * fully ionized gas: gamma -> 5/3, mu -> ~0.6
and runs the PVTE Sod shock tube (reference test/shockTube_PVTE) end to
end: with the variable gamma the shock is slower and denser than the
gamma = 1.4 ideal-gas run (the dissociation/ionization energy sinks soften
the EoS), matching the qualitative PLUTO comparison the reference ships.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fargocpt_tpu.ops import pvte
from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation

XMF = 0.75


def tabs():
    lo, w, coeffs = pvte.funcdum_poly()
    return (lo, w, jnp.asarray(coeffs))


def gamma_at(rho, T):
    _x, _y, mu, _eps, gam = pvte._gamma_mu_at(
        jnp.asarray(rho), jnp.asarray(T), XMF, tabs())
    return float(gam), float(mu)


def test_funcdum_fit_matches_reference_table():
    """The gather-free piecewise-Chebyshev funcdum (production path)
    must agree with the reference's 5000-entry table (src/pvte_law.cpp
    :305-369 + :77-101 interpolation) to the table's own interpolation
    error (~5e-6 rel), across the full ln T range and at off-node
    points."""
    lnT_t, fd_t = pvte.zeta_table()
    # on-node: fit error only
    T_nodes = np.exp(lnT_t[: pvte.N_ZETA - 2 : 17])
    fit = np.asarray(pvte.func_dum(tabs(), jnp.asarray(T_nodes)))
    ref = fd_t[: pvte.N_ZETA - 2 : 17]
    np.testing.assert_allclose(fit, ref, rtol=2e-6)
    # off-node midpoints: fit-vs-linear-interp, bounded by interp error
    lnT_m = 0.5 * (lnT_t[:-1] + lnT_t[1:])[: pvte.N_ZETA - 2 : 17]
    fd_m = 0.5 * (fd_t[:-1] + fd_t[1:])[: pvte.N_ZETA - 2 : 17]
    fit_m = np.asarray(pvte.func_dum(tabs(), jnp.asarray(np.exp(lnT_m))))
    np.testing.assert_allclose(fit_m, fd_m, rtol=2e-5)
    # clipping beyond the table range matches the reference's clamp
    hi = float(np.asarray(pvte.func_dum(tabs(), jnp.asarray([1e14])))[0])
    hi_edge = float(np.asarray(pvte.func_dum(
        tabs(), jnp.asarray([np.exp(lnT_t[pvte.N_ZETA - 2])])))[0])
    assert abs(hi - hi_edge) < 1e-12


def test_gamma_limits():
    # cold molecular hydrogen (rotation frozen): monatomic-like 5/3
    gam, mu = gamma_at(1e-12, 30.0)
    assert 1.6 < gam < 1.7
    assert 2.2 < mu < 2.4   # H2 + He

    # warm molecular hydrogen (rotation active): diatomic 7/5
    gam, mu = gamma_at(1e-12, 1000.0)
    assert 1.35 < gam < 1.45

    # fully ionized: monatomic with mu ~ 0.6
    gam, mu = gamma_at(1e-18, 1e6)
    assert 1.6 < gam < 1.7
    assert 0.5 < mu < 0.7

    # dissociation region: gamma dips well below 7/5
    gam, mu = gamma_at(1e-9, 2500.0)
    assert gam < 1.3


def test_temperature_energy_roundtrip():
    rng = np.random.default_rng(3)
    rho = jnp.asarray(10.0 ** rng.uniform(-20, -5, 64))
    T = jnp.asarray(10.0 ** rng.uniform(0.5, 6.5, 64))
    R = pvte.CGS_KB / pvte.CGS_MP
    x, y, mu, eps, gam = pvte._gamma_mu_at(rho, T, XMF, tabs())
    # specific internal energy consistent with gamma_eff definition:
    # e = R T / (mu (gamma - 1))
    e = R * T / (mu * (gam - 1.0))
    T_back = pvte.temperature_from_energy(e, rho, XMF, tabs())
    np.testing.assert_allclose(np.asarray(T_back), np.asarray(T), rtol=1e-6)


def test_temperature_energy_roundtrip_f32():
    """Pin the f32 production solver path (the 13+4 bisection+Illinois
    hybrid — f64 inputs take the bisection branch and would leave the
    hybrid untested). Advisor-measured worst case over the full table
    domain is ~1e-5 relative; gate the round-trip at 5e-5."""
    rng = np.random.default_rng(7)
    rho = jnp.asarray(10.0 ** rng.uniform(-20, -5, 512), jnp.float32)
    T = jnp.asarray(10.0 ** rng.uniform(0.5, 6.5, 512), jnp.float32)
    R = pvte.CGS_KB / pvte.CGS_MP
    tb = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tabs())
    x, y, mu, eps, gam = pvte._gamma_mu_at(rho, T, XMF, tb)
    e = jnp.asarray(R * T / (mu * (gam - 1.0)), jnp.float32)
    T_back = pvte.temperature_from_energy(e, rho, XMF, tb)
    assert T_back.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(T_back), np.asarray(T), rtol=5e-5)


def test_temperature_hybrid_zero_energy_no_nan():
    """An underflowed cell (e <= 0) must not poison the grid with NaN:
    ln(0) = -inf used to make the Illinois secant compute inf - inf. The
    clamped solver degrades to the 1 K bracket edge like the bisection."""
    rho = jnp.asarray([1e-12, 1e-12, 1e-12], jnp.float32)
    e = jnp.asarray([0.0, -1.0, 1e10], jnp.float32)
    tb = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tabs())
    T = pvte.temperature_from_energy(e, rho, XMF, tb)
    T = np.asarray(T)
    assert np.all(np.isfinite(T)), T
    # degenerate cells land at (or within bracket-clip of) the 1 K edge
    assert T[0] < 2.0 and T[1] < 2.0
    assert T[2] > 1e2  # the healthy cell still solves normally


def _f64_reference(rho64, e64):
    """(T, geff, mu, g1) from the f64 48-bisection pipeline the goldens
    pinned."""
    lo, w, coeffs = pvte.funcdum_poly()
    tb = (lo, w, jnp.asarray(coeffs, jnp.float64))
    T = pvte.temperature_from_energy(jnp.asarray(e64), jnp.asarray(rho64),
                                     XMF, tb)
    _x, _y, mu, _e, geff = pvte._gamma_mu_at(jnp.asarray(rho64), T, XMF, tb)
    g1 = pvte.gamma1_at(jnp.asarray(rho64), T, XMF, tb)
    return (np.asarray(T), np.asarray(geff), np.asarray(mu), np.asarray(g1))


def _max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_gamma_mu_fast_cold_matches_f64():
    """The fused elementwise f32 production path (unrolled hybrid solve +
    analytic gamma1) against the f64 bisection pipeline over the table
    domain.  T/geff/mu at the solver tolerance; g1 at the finite
    difference's own cliff truncation (~1e-4 — the analytic form is the
    more accurate of the two)."""
    rng = np.random.default_rng(11)
    n = 4096
    rho64 = 10.0 ** rng.uniform(-23, 0, n)
    e64 = 10.0 ** rng.uniform(8, 15, n)
    _T, geff_r, mu_r, g1_r = _f64_reference(rho64, e64)
    rho = jnp.asarray(rho64, jnp.float32)
    e = jnp.asarray(e64, jnp.float32)
    geff, mu, g1 = pvte.gamma_mu_fast(rho, e, XMF)
    assert _max_rel(geff, geff_r) < 2e-5
    assert _max_rel(mu, mu_r) < 5e-5
    assert _max_rel(g1, g1_r) < 5e-4


def test_gamma_mu_fast_warm_start():
    """The warm Newton polish must reproduce the cold result when the
    guess is a recent refresh: exact for an up-to-date guess, at the
    solver tolerance for the ~1% energy moves substeps actually make,
    and finite (bracket-guarded) for nonsense guesses."""
    rng = np.random.default_rng(12)
    n = 4096
    rho64 = 10.0 ** rng.uniform(-23, 0, n)
    e64 = 10.0 ** rng.uniform(8, 15, n)
    rho = jnp.asarray(rho64, jnp.float32)
    e = jnp.asarray(e64, jnp.float32)
    geff_c, mu_c, _g1 = pvte.gamma_mu_fast(rho, e, XMF)

    # perfect guess: Newton confirms in place
    geff_w, mu_w, _ = pvte.gamma_mu_fast(rho, e, XMF, guess=(geff_c, mu_c))
    assert _max_rel(geff_w, geff_c) < 5e-6
    assert _max_rel(mu_w, mu_c) < 2e-5

    # 1% energy move (a large substep): still at the f64 reference
    e2_64 = e64 * (1.0 + 0.01 * (2.0 * rng.random(n) - 1.0))
    _T, geff_r, mu_r, _g = _f64_reference(rho64, e2_64)
    e2 = jnp.asarray(e2_64, jnp.float32)
    geff2, mu2, _ = pvte.gamma_mu_fast(rho, e2, XMF, guess=(geff_c, mu_c))
    assert _max_rel(geff2, geff_r) < 2e-5
    assert _max_rel(mu2, mu_r) < 1e-4

    # nonsense guess (zero-padded halo analog): finite, bracket-bounded
    bad = (jnp.zeros_like(geff_c), jnp.zeros_like(mu_c))
    geff3, mu3, g13 = pvte.gamma_mu_fast(rho, e, XMF, guess=bad)
    assert np.all(np.isfinite(np.asarray(geff3)))
    assert np.all(np.isfinite(np.asarray(mu3)))
    assert np.all(np.isfinite(np.asarray(g13)))


def pvte_shock_config(eos):
    return Config.from_dict({
        "Integrator": "Euler", "ShockTube": "2",
        "Sigma0": "1.0", "SigmaFloor": "1.e-100",
        "AspectRatio": "1.0", "FlaringIndex": "0.5",
        "ConstantViscosity": "0.0",
        "ArtificialViscosity": "SN",
        "ArtificialViscosityDissipation": "Yes",
        "EquationOfState": eos, "AdiabaticIndex": "1.4",
        "HydrogenMassFraction": "0.75",
        "HeatingViscous": "No",
        "MinimumTemperature": "1e-9 K", "MaximumTemperature": "1e100 K",
        "CFL": "0.5", "ThicknessSmoothing": "0.6",
        "Transport": "FARGO",
        "InnerBoundary": "Reflecting", "OuterBoundary": "Reflecting",
        "Nrad": "500", "Naz": "2",
        "Rmin": "1000.0", "Rmax": "1001.0",
        "RadialSpacing": "Arithmetic",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.228",
    })


@pytest.mark.slow
def test_pvte_shock_tube():
    sim = Simulation(pvte_shock_config("PVTE"))
    assert sim.phys.variable_gamma
    sig0 = np.asarray(sim.fields.sigma).mean(1)
    mass0 = float((sig0[1:-1] * sim.geometry.surf[1:-1]).sum())
    sim.run()
    sig = np.asarray(sim.fields.sigma).mean(1)
    geom = sim.geometry
    r1 = geom.rmed - geom.radii[0]

    assert np.all(np.isfinite(sig)) and np.all(sig > 0)
    # left state still intact near the wall, right state still 0.125
    assert abs(sig[5] - 1.0) < 0.02
    assert abs(sig[-5] - 0.125) < 0.01
    # a shock has formed and sits inside the domain: post-shock plateau
    # between the contact (~0.38) and the undisturbed right state
    mid = sig[(r1 > 0.65) & (r1 < 0.8)]
    assert mid.size and np.all(mid > 0.2) and np.all(mid < 0.6)
    # reflecting walls: mass conserved
    mass1 = float((sig[1:-1] * geom.surf[1:-1]).sum())
    assert abs(mass1 / mass0 - 1.0) < 1e-10


def _pvte_disk_cfg():
    return Config.from_dict({
        "EquationOfState": "PVTE", "HydrogenMassFraction": "0.75",
        "AspectRatio": "0.05", "FlaringIndex": "0.25",
        "ViscousAlpha": "0.002",
        "Sigma0": "2000 g/cm2", "SigmaSlope": "0.5",
        "HeatingViscous": "Yes", "SurfaceCooling": "thermal",
        "RadiativeDiffusion": "Yes",
        "RadiativeDiffusionTolerance": "1e-7",
        "ArtificialViscosity": "SN",
        "Nrad": "64", "Naz": "128",
        "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Transport": "FARGO",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "3.0",
    })


@pytest.mark.slow
def test_pvte_f32_budget_vs_f64(monkeypatch):
    """Trajectory budget of the f32 fast PVTE path (fused elementwise
    solve + analytic gamma1 + warm-start chaining) on a PDS70-style
    PVTE + FLD disk: ~200 steps against the f64 bisection reference, and
    warm chaining against cold per-refresh solves (the chain must be a
    pure solver cache, not a physics change).  Calibration 2026-08-19:
    f32-warm vs f64 3.4e-5/5.3e-5 (sigma/energy), warm vs cold
    7e-6/1.2e-5."""
    runs = {}
    for name, dtype, warm in (("f64", "float64", "1"),
                              ("f32w", "float32", "1"),
                              ("f32c", "float32", "0")):
        monkeypatch.setenv("FARGOCPT_TPU_PVTE_WARM", warm)
        sim = Simulation(_pvte_disk_cfg(), dtype=dtype)
        sim.run()
        runs[name] = sim
    assert runs["f32w"].n_hydro_iter > 100

    def rel(a_s, b_s, name):
        a = np.asarray(getattr(runs[a_s].fields, name), np.float64)
        b = np.asarray(getattr(runs[b_s].fields, name), np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for f in ("sigma", "energy", "vaz"):
        assert rel("f32w", "f64", f) < 1e-3, f
        assert rel("f32w", "f32c", f) < 1e-4, f
    assert rel("f32w", "f64", "sigma") > 0.0


@pytest.mark.slow
def test_lookup_table_mode_matches_bisection():
    """PVTELookupTable mode (reference-exact 1000x1000 table quantization,
    src/pvte_law.cpp:370-440) must agree with the in-graph bisection to
    the table's own interpolation error, and the lookup conventions must
    be the reference's: log-space cell index, LINEAR unclamped weights."""
    tables = tuple(jnp.asarray(t) for t in pvte.lookup_tables(XMF))
    rng = np.random.default_rng(7)
    rho = jnp.asarray(10.0 ** rng.uniform(-18, -5, 512))
    e = jnp.asarray(10.0 ** rng.uniform(9, 14, 512))
    geff_l, mu_l, g1_l = pvte.lookup_gamma_mu(rho, e, tables)

    T = pvte.temperature_from_energy(e, rho, XMF, tabs())
    _x, _y, mu_b, _eps, geff_b = pvte._gamma_mu_at(rho, T, XMF, tabs())
    g1_b = pvte.gamma1_at(rho, T, XMF, tabs())

    def rel(a, b):
        return float(jnp.max(jnp.abs(a - b) / jnp.abs(b)))

    assert rel(geff_l, geff_b) < 2e-3
    assert rel(mu_l, mu_b) < 2e-3
    assert rel(g1_l, g1_b) < 1e-1    # g1 is steep across ionization edges

    # exactly on table nodes the lookup must reproduce the node values
    rho_t, e_t, mu_t, geff_t, g1_t = tables
    ii = jnp.asarray([5, 100, 500, 900])
    jj = jnp.asarray([7, 200, 600, 950])
    geff_n, mu_n, g1_n = pvte.lookup_gamma_mu(rho_t[ii], e_t[jj], tables)
    np.testing.assert_allclose(np.asarray(geff_n),
                               np.asarray(geff_t[ii, jj]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(mu_n),
                               np.asarray(mu_t[ii, jj]), rtol=1e-12)

    # out-of-table points clamp the cell index and extrapolate linearly
    # (reference src/pvte_law.cpp:411-422 clamps i/j, not x/y)
    g_lo, _, _ = pvte.lookup_gamma_mu(jnp.asarray([1e-30]),
                                      jnp.asarray([1e7]), tables)
    assert np.isfinite(float(g_lo[0]))
