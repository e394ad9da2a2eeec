"""Accretion of gas onto planets.

Re-derivation of reference src/accretion.cpp: Kley-type two-zone
Hill-sphere accretion (:84-222) — a fraction f_acc of the mass inside
frac * R_Hill is removed per orbital period (log-2 normalized), with an
inner zone accreting twice as hard; removed mass and momentum are added to
the planet when disk feedback is on.

Vectorized: the reference's index-window double loop becomes full-grid
masks (the Hill disk covers a tiny fraction of cells; the masked update is
one fused pass per accreting body, and the momentum sums become
cross-shard reduces under the mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import Physics
from .common import Geom, azim_next


def orbital_periods(constants, nb, n_hydroframe: int = 1):
    """Osculating orbital periods of every body, matching the reference's
    stored orbital elements exactly (src/nbody/planetary_system.cpp:773-800
    ``calculate_orbital_elements`` + src/nbody/planet.cpp:488-566): body k
    is referred to the center of mass of bodies 0..k-1 with
    mu = G (sum of inner masses + own mass), and the semi-major axis comes
    from the Laplace-Runge-Lenz eccentricity, a = h^2 / (mu (1 - e^2)).
    Body 0 gets period 0 when it alone defines the hydro frame
    (planetary_system.cpp:778-781), and in a 2-body system the primary
    copies the secondary's elements (:796-800).

    The reference samples these ONCE per nbody drift
    (move_to_hydro_center_and_update_orbital_parameters) and reuses the
    stored values for both leapfrog accretion calls — callers must do the
    same (compute after the drift, pass to both accretion halves)."""
    m = nb.mass
    n = m.shape[0]
    # exclusive prefix sums: mass/position/velocity COM of bodies < k
    mass_in = jnp.cumsum(m) - m
    mx = jnp.cumsum(m * nb.x) - m * nb.x
    my = jnp.cumsum(m * nb.y) - m * nb.y
    mvx = jnp.cumsum(m * nb.vx) - m * nb.vx
    mvy = jnp.cumsum(m * nb.vy) - m * nb.vy
    denom = jnp.where(mass_in > 0.0, mass_in, 1.0)
    com_x = jnp.where(mass_in > 0.0, mx / denom, 0.0)
    com_y = jnp.where(mass_in > 0.0, my / denom, 0.0)
    com_vx = jnp.where(mass_in > 0.0, mvx / denom, 0.0)
    com_vy = jnp.where(mass_in > 0.0, mvy / denom, 0.0)

    x = nb.x - com_x
    y = nb.y - com_y
    vx = nb.vx - com_vx
    vy = nb.vy - com_vy
    mu = constants.G * (mass_in + m)

    h = x * vy - y * vx
    d = jnp.sqrt(x * x + y * y)
    d_safe = jnp.where(d > 0.0, d, 1.0)
    ax_lrl = x * vy * vy - y * vx * vy - mu * x / d_safe
    ay_lrl = y * vx * vx - x * vx * vy - mu * y / d_safe
    e = jnp.sqrt(ax_lrl * ax_lrl + ay_lrl * ay_lrl) / mu
    one_m_e2 = 1.0 - e * e
    a = h * h / mu / jnp.where(one_m_e2 != 0.0, one_m_e2, 1.0)
    valid = (d > 0.0) & (h != 0.0) & (e <= 1.0) & (a > 0.0)
    period = jnp.where(
        valid, 2.0 * jnp.pi * jnp.sqrt(jnp.abs(a) ** 3 / mu), 0.0)
    if n_hydroframe == 1:
        period = period.at[0].set(0.0)
    if n == 2:
        # binary: both stars share the same orbital elements
        period = period.at[0].set(period[1])
    return period


def accrete_onto_planets(phys: Physics, constants, g: Geom, nb, bodies,
                         accretion_efficiency, accretion_types: list,
                         cell_x, cell_y, sigma, energy, vrad, vaz,
                         omega_frame, dt, nu_grid=None,
                         row_w=None, axis_name=None, periods=None):
    """Accretion for every accreting body: two-zone Kley (reference :84),
    single-zone sinkhole (:223), or viscous-rate (:336 — needs ``nu_grid``).

    Returns (sigma, energy, nb) with the bodies' mass/velocity updated when
    disk feedback is enabled (reference :200-219).

    ``row_w``/``axis_name``: under the explicit shard_map path, the
    ownership-and-active row weight replaces the local ``active`` mask for
    the mass/momentum bookkeeping and the sums are psum'ed over the mesh
    axis (the reference's MPI_Allreduce, src/accretion.cpp:200-219).

    ``periods``: orbital periods per body sampled at the last nbody drift
    (see ``orbital_periods``); computed fresh from ``nb`` when None. The
    leapfrog caller MUST pass the mid-step-sampled values to both halves —
    the reference reuses the stored elements (the masses and velocities
    change between the two accretion calls but the stored period does not).
    """
    nr = g.nrad
    floor = phys.sigma_floor * phys.sigma0
    # cell-centered cartesian gas velocities (reference :155-161)
    vt_cell = 0.5 * (vaz + azim_next(vaz)) + g.rb * omega_frame
    vr_cell = 0.5 * (vrad[:-1] + vrad[1:])
    vx_cell = (vr_cell * cell_x - vt_cell * cell_y) * g.inv_rb
    vy_cell = (vr_cell * cell_y + vt_cell * cell_x) * g.inv_rb

    # active rows for the momentum bookkeeping (reference :172-176:
    # radial_first_active < i < radial_active_size; serial values
    # GHOSTCELLS_B=1 -> rows 2..NR-2 inclusive, src/split.cpp:73-78)
    row = jnp.arange(nr)[:, None]
    active = (row > 1) & (row < nr - 1)

    if periods is None:
        periods = orbital_periods(constants, nb)

    from ..nbody import system as nbody_sys
    dist_prim = nbody_sys.dist_to_primary(nb)
    roche = nbody_sys.dimensionless_roche_radius(nb)

    new_mass = nb.mass
    new_vx, new_vy = nb.vx, nb.vy

    for k, acc_type in enumerate(accretion_types):
        if acc_type not in ("kley", "sinkhole", "viscous"):
            continue
        r_hill = roche[k] * dist_prim[k]
        dx = nb.x[k] - cell_x
        dy = nb.y[k] - cell_y
        dist = jnp.sqrt(dx * dx + dy * dy)
        facc_max = 1.0 - floor / sigma

        if acc_type == "kley":
            facc = dt * accretion_efficiency[k] / periods[k] * jnp.log(2.0)
            facc1 = facc / 3.0
            facc2 = 2.0 * facc / 3.0
            frac1 = phys.accretion_radius_fraction
            frac2 = 0.5 * phys.accretion_radius_fraction
            zone1 = dist < frac1 * r_hill
            zone2 = dist < frac2 * r_hill

            # zone 1 (outer)
            f1 = jnp.where(zone1, jnp.minimum(facc1, facc_max), 0.0)
            dm1 = f1 * sigma * g.surf
            sigma = sigma * (1.0 - f1)
            if phys.is_adiabatic:
                energy = energy * (1.0 - f1)
            # zone 2 (inner) acts on the already reduced density; the
            # reference caps with the pre-zone-1 facc_max and scales energy
            # by the uncapped facc2 (reference :183-198)
            f2 = jnp.where(zone2, jnp.minimum(facc2, facc_max), 0.0)
            dm2 = f2 * sigma * g.surf
            sigma = sigma * (1.0 - f2)
            if phys.is_adiabatic:
                energy = energy * jnp.where(zone2, 1.0 - facc2, 1.0)
            dm = dm1 + dm2
        elif acc_type == "sinkhole":
            # single-zone variant (reference :223-335 SinkHoleSinglePlanet)
            facc = dt * accretion_efficiency[k] / periods[k] * jnp.log(2.0)
            zone = dist < phys.accretion_radius_fraction * r_hill
            f1 = jnp.where(zone, jnp.minimum(facc, facc_max), 0.0)
            dm = f1 * sigma * g.surf
            sigma = sigma * (1.0 - f1)
            if phys.is_adiabatic:
                energy = energy * (1.0 - f1)
        else:
            # viscous-rate variant (reference :336-481
            # AccreteOntoSinglePlanetViscous): Mdot = 3 pi nu Sigma spread
            # over the accretion zone with weight f = 1 - d/d_max
            if nu_grid is None:
                continue
            facc = dt * 3.0 * jnp.pi * accretion_efficiency[k]
            dist_max = phys.accretion_radius_fraction * r_hill
            if phys.visc_accret_massflow_test:
                # ViscAccretMassflowTest normalization (reference
                # src/accretion.cpp:360-371, replicated verbatim incl. the
                # d^2/6 first term); RMIN = Ra[1] by grid convention
                rmin = g.ra[1, 0]
                area = 2.0 * jnp.pi * (
                    (0.5 * dist_max ** 2 - dist_max ** 2 / 3.0)
                    - (0.5 * rmin ** 2 - rmin ** 3 / (3.0 * dist_max)))
                f_const = 1.0 / area
            else:
                f_const = 3.0 / jnp.pi / dist_max ** 2
            spread = f_const * (1.0 - dist / dist_max)
            zone = dist < dist_max
            f1 = jnp.where(zone,
                           jnp.minimum(facc * nu_grid * spread, facc_max),
                           0.0)
            dm = f1 * sigma * g.surf
            sigma = sigma * (1.0 - f1)
            if phys.is_adiabatic:
                energy = energy * (1.0 - f1)

        if row_w is None:
            dm = jnp.where(active, dm, 0.0)
        else:
            dm = dm * row_w
        d_m = jnp.sum(dm)
        d_px = jnp.sum(dm * vx_cell)
        d_py = jnp.sum(dm * vy_cell)
        if axis_name is not None:
            d_m = jax.lax.psum(d_m, axis_name)
            d_px = jax.lax.psum(d_px, axis_name)
            d_py = jax.lax.psum(d_py, axis_name)

        if phys.disk_feedback or phys.accrete_without_disk_feedback:
            # reference accretion.cpp:207,319,466
            m_old = new_mass[k]
            m_new = m_old + d_m
            new_vx = new_vx.at[k].set((m_old * new_vx[k] + d_px) / m_new)
            new_vy = new_vy.at[k].set((m_old * new_vy[k] + d_py) / m_new)
            new_mass = new_mass.at[k].set(m_new)

    nb = nb.replace(mass=new_mass, vx=new_vx, vy=new_vy)
    return sigma, energy, nb
