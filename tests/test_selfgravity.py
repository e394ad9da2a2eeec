"""Self-gravity FFT solver vs direct N^2 summation.

Port of reference test/self_gravity: the azimuthally-averaged radial SG
acceleration of a Sigma ~ 1/r disk on a 128x256 log grid must match direct
summation with the Moldenhauer (symmetric) smoothing to max relative error
< 0.0014 for r > 2 (reference test/self_gravity/testconfig.yml).
"""

import numpy as np
import pytest

from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation


def sg_config():
    return Config.from_dict({
        "EquationOfState": "isothermal", "AspectRatio": "0.05",
        "FlaringIndex": "0.0",
        "Sigma0": "200 g/cm2", "SigmaSlope": "1", "SigmaFloor": "1e-9",
        "SelfGravity": "yes", "SelfGravityMode": "symmetric",
        "ThicknessSmoothing": "0.6", "ThicknessSmoothingSG": "0.6",
        "Nrad": "128", "Naz": "256", "Rmin": "1", "Rmax": "12.5",
        "RadialSpacing": "Logarithmic",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.1",
    })


def direct_sum_gr(geom, sigma, h0, G):
    """Direct smoothed summation (reference
    test/self_gravity/check_results.py:9-94) at azimuth column 1."""
    lam = 0.4571 * h0 + 0.6737 * np.sqrt(h0)
    chi = 0.6472 * h0 - 0.7543 * h0 ** 2
    phi = geom.phi
    R = geom.rmed[:, None] * np.ones((1, geom.naz))
    X = R * np.cos(phi)[None, :]
    Y = R * np.sin(phi)[None, :]
    A = geom.surf[:, None] * np.ones((1, geom.naz))
    k = 1
    gr = np.zeros(geom.nrad)
    for n in range(geom.nrad):
        r1 = geom.rmed[n]
        x1, y1 = X[n, k], Y[n, k]
        eps_sq = lam ** 2 * (r1 - R) ** 2 + chi ** 2 * r1 * R
        dx = x1 - X
        dy = y1 - Y
        dsq = dx ** 2 + dy ** 2
        accx = -G * A * sigma * dx / (dsq + eps_sq) ** 1.5
        accy = -G * A * sigma * dy / (dsq + eps_sq) ** 1.5
        gr[n] = accx.sum() * np.cos(phi[k]) + accy.sum() * np.sin(phi[k])
    return gr


@pytest.mark.slow
def test_sg_fft_vs_direct_sum():
    sim = Simulation(sg_config())
    sigma = np.asarray(sim.fields.sigma)

    import jax.numpy as jnp
    g_r, g_t = sim.stepper.selfgravity.accelerations(jnp.asarray(sigma))
    gr_code = np.asarray(g_r).mean(axis=1)

    gr_direct = direct_sum_gr(sim.geometry, sigma, 0.05, sim.constants.G)

    mask = sim.geometry.rmed > 2.0
    rel = np.abs(gr_code[mask] / gr_direct[mask] - 1.0)
    assert rel.max() < 0.0014, f"max rel diff {rel.max():.3e}"
    # axisymmetric disk: azimuthal acceleration ~ 0
    assert np.abs(np.asarray(g_t)).max() < np.abs(gr_code).max() * 1e-10


def two_blob_sigma(geom):
    """Non-axisymmetric Sigma: two Gaussian blobs at (R0=4, phi=pi) and
    (R0=4, phi=pi/2) — reference test/self_gravity_azi/custom_init.py:83-95."""
    R = geom.rmed[:, None]
    PHI = geom.phi[None, :]
    R0, phi1, phi2 = 4.0, np.pi, np.pi / 2
    dr, dphi = 1.0, 0.3
    g1 = np.exp(-0.5 * (R - R0) ** 2 / dr ** 2) \
        * np.exp(-0.5 * (PHI - phi1) ** 2 / dphi ** 2)
    g2 = np.exp(-0.5 * (R - R0) ** 2 / dr ** 2) \
        * np.exp(-0.5 * (PHI - phi2) ** 2 / dphi ** 2)
    return g1 + g2


def direct_sum_components(geom, sigma, h0, G, mode, rows):
    """Smoothed direct N^2 summation of BOTH acceleration components at
    the given rings, with the mode-matched smoothing (reference
    test/self_gravity_azi/check_results.py:10-50 for the symmetric /
    Moldenhauer form; the 'basic' Baruteau 2008 smoothing additionally
    shifts the radial numerator by eps^2 r_i, cf. the kernel numerator
    1 + eps^2 - cos(th) e^-u in src/selfgravity.cpp:437-447)."""
    lam = 0.4571 * h0 + 0.6737 * np.sqrt(h0)
    chi = 0.6472 * h0 - 0.7543 * h0 ** 2
    eps_b = 0.6 * h0
    phi = geom.phi
    R = geom.rmed[:, None] * np.ones((1, geom.naz))
    A = geom.surf[:, None] * np.ones((1, geom.naz))
    gr = np.zeros((len(rows), geom.naz))
    gt = np.zeros((len(rows), geom.naz))
    for i, n in enumerate(rows):
        r1 = geom.rmed[n]
        if mode == "symmetric":
            eps_sq = lam ** 2 * (r1 - R) ** 2 + chi ** 2 * r1 * R
            num_extra = 0.0
        else:
            eps_sq = eps_b ** 2 * r1 ** 2
            num_extra = eps_b ** 2 * r1
        for k in range(geom.naz):
            th = phi[k] - phi[None, :]
            d2 = r1 * r1 + R ** 2 - 2.0 * r1 * R * np.cos(th)
            w = A * sigma / (d2 + eps_sq) ** 1.5
            gr[i, k] = -G * np.sum(w * (r1 - R * np.cos(th) + num_extra))
            gt[i, k] = -G * np.sum(w * R * np.sin(th))
    return gr, gt


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["symmetric", "basic"])
def test_sg_azimuthal_vs_direct_sum(mode):
    """Port of reference test/self_gravity_azi: on a non-axisymmetric
    two-blob Sigma, BOTH the radial and azimuthal FFT accelerations must
    match direct N^2 summation (observed 1.0e-4 normalized for both
    components and modes; the reference gates at 0.0256 cm/s^2 absolute
    on a 2.5 cm/s^2 scale = 1e-2 normalized)."""
    cfg = sg_config()
    cfg._raw["selfgravitymode"] = mode
    sim = Simulation(cfg)
    geom = sim.geometry
    sigma = two_blob_sigma(geom)

    import jax.numpy as jnp
    g_r, g_t = sim.stepper.selfgravity.accelerations(jnp.asarray(sigma))
    g_r = np.asarray(g_r)
    g_t = np.asarray(g_t)

    rows = [n for n in range(geom.nrad) if geom.rmed[n] > 2.0][::16]
    gr_d, gt_d = direct_sum_components(geom, sigma, 0.05, sim.constants.G,
                                       mode, rows)
    err_r = np.max(np.abs(g_r[rows] - gr_d)) / np.max(np.abs(gr_d))
    err_t = np.max(np.abs(g_t[rows] - gt_d)) / np.max(np.abs(gt_d))
    assert err_r < 5e-4, f"{mode} g_r dev {err_r:.3e}"
    assert err_t < 5e-4, f"{mode} g_t dev {err_t:.3e}"


def test_sg_bessel_azimuthal_symmetry():
    """The razor-thin Bessel kernel has no simple smoothed direct-sum
    analog; validate its azimuthal component via the mirror symmetry of
    the two-blob Sigma about phi = 3pi/4: g_t must be antisymmetric and
    g_r symmetric under j -> 3 naz/4 - j (observed 4e-7 / 2e-7)."""
    cfg = sg_config()
    cfg._raw["selfgravitymode"] = "besselkernel"
    sim = Simulation(cfg)
    geom = sim.geometry
    sigma = two_blob_sigma(geom)

    import jax.numpy as jnp
    g_r, g_t = sim.stepper.selfgravity.accelerations(jnp.asarray(sigma))
    g_r = np.asarray(g_r)
    g_t = np.asarray(g_t)
    naz = geom.naz
    jm = (3 * naz // 4 - np.arange(naz)) % naz   # phi_j = j*dphi
    asym_t = np.max(np.abs(g_t + g_t[:, jm])) / np.max(np.abs(g_t))
    sym_r = np.max(np.abs(g_r - g_r[:, jm])) / np.max(np.abs(g_r))
    assert np.max(np.abs(g_t)) > 0.1   # nontrivial azimuthal field
    assert asym_t < 1e-5, f"g_t antisymmetry dev {asym_t:.3e}"
    assert sym_r < 1e-5, f"g_r symmetry dev {sym_r:.3e}"


def test_sg_vaz_correction_applied():
    """With SG on, the initial v_az exceeds the non-SG equilibrium (the
    disk pulls inward)."""
    sim_sg = Simulation(sg_config())
    cfg = sg_config()
    cfg._raw["selfgravity"] = "no"
    sim_no = Simulation(cfg)
    vaz_sg = np.asarray(sim_sg.fields.vaz)[64, 0]
    vaz_no = np.asarray(sim_no.fields.vaz)[64, 0]
    assert vaz_sg > vaz_no
