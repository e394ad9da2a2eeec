"""Radial boundary conditions and wave-damping zones.

Re-derivation of the reference BC framework
(src/boundary_conditions/boundary_conditions.cpp:65-110 with per-variable
function dispatch from src/boundary_conditions/config.cpp) as pure row
updates. Ghost rows:
  * scalar fields: row 0 (inner), row NR-1 (outer)
  * v_rad: rows 0,1 (inner) and NR-1, NR (outer) — row 1 / NR-1 sit ON the
    active boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..params import Physics
from .common import Geom, accurate_cos


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RefValues:
    """Initial-value snapshots used by reference BCs and damping
    (reference src/boundary_conditions/boundary_conditions.cpp:32-43 and
    the SIGMA0/ENERGY0/... grids)."""
    sigma0: jax.Array
    energy0: jax.Array
    vrad0: jax.Array
    vaz0: jax.Array


# ----- scalar BCs ------------------------------------------------------------

def _diskmodel_value(phys: Physics, var: str, r: float):
    """Analytic-profile ghost values (reference
    src/boundary_conditions/diskmodel.cpp:18-31 calc_sig/calc_eng; note the
    reference omits the G*M factor of Theo.cpp initial_energy here)."""
    if var == "sigma":
        return phys.sigma0 * r ** (-phys.sigma_slope)
    return (1.0 / (phys.adiabatic_index - 1.0) * phys.sigma0
            * phys.aspectratio_ref ** 2
            * r ** (-phys.sigma_slope - 1.0 + 2.0 * phys.flaring_index))


def _scalar_inner(name: str, x, x0, g: Geom, phys: Physics = None,
                  var: str = "sigma"):
    if name in ("zerogradient", "outflow", "reflecting"):
        return x.at[0].set(x[1])
    if name == "reference":
        return x.at[0].set(x0[0])
    if name == "diskmodel":
        return x.at[0].set(_diskmodel_value(phys, var, g.rb[0, 0]))
    if name == "none":
        return x
    raise NotImplementedError(f"scalar inner BC {name!r}")


def _scalar_outer(name: str, x, x0, g: Geom, phys: Physics = None,
                  var: str = "sigma"):
    nr = x.shape[0]
    if name in ("zerogradient", "outflow", "reflecting"):
        return x.at[nr - 1].set(x[nr - 2])
    if name == "reference":
        return x.at[nr - 1].set(x0[nr - 1])
    if name == "diskmodel":
        return x.at[nr - 1].set(_diskmodel_value(phys, var, g.rb[nr - 1, 0]))
    if name == "none":
        return x
    raise NotImplementedError(f"scalar outer BC {name!r}")


# ----- v_rad BCs -------------------------------------------------------------

def _vrad_inner(name: str, vr, vr0, g: Geom, nu=None,
                phys_vos: float = 1.0, gm: float = 1.0,
                kep_factor: float = 1.0):
    if name == "zerogradient":
        return vr.at[0:2].set(vr[2])
    if name == "outflow":
        # reference src/boundary_conditions/outflow.cpp:16-35
        val = jnp.where(vr[2] > 0.0, 0.0, vr[2])
        return vr.at[0:2].set(val)
    if name == "reflecting":
        vr = vr.at[0].set(-vr[2])
        return vr.at[1].set(0.0)
    if name == "reference":
        return vr.at[0:2].set(vr0[0:2])
    if name == "keplerian":
        # v_rad ghost rows pinned to factor * vKep(Rmed) (reference
        # src/boundary_conditions/keplerian_radial.cpp:18-39)
        vk0 = kep_factor * jnp.sqrt(gm / g.rmed_ext[0, 0])
        vk1 = kep_factor * jnp.sqrt(gm / g.rmed_ext[1, 0])
        vr = vr.at[0].set(vk0)
        return vr.at[1].set(vk1)
    if name == "viscous":
        # steady viscous drift speed at the inner edge (reference
        # src/boundary_conditions/viscous.cpp:12-29)
        if nu is None:
            raise ValueError("viscous BC needs the viscosity grid")
        nu_edge = 0.5 * (nu[0] + nu[1])
        vr = vr.at[1].set(-1.5 * phys_vos / g.ra[1, 0] * nu_edge)
        return vr.at[0].set(-1.5 * phys_vos / g.ra[0, 0] * nu_edge)
    if name == "none":
        return vr
    raise NotImplementedError(f"vrad inner BC {name!r}")


def _vrad_outer(name: str, vr, vr0, g: Geom, nu=None,
                phys_vos: float = 1.0, gm: float = 1.0,
                kep_factor: float = 1.0):
    nv = vr.shape[0]          # NR+1
    irad = nv - 1             # reference get_max_radial() for vectors
    if name == "zerogradient":
        return vr.at[irad - 1:].set(vr[irad - 2])
    if name == "outflow":
        val = jnp.where(vr[irad - 2] < 0.0, 0.0, vr[irad - 2])
        return vr.at[irad - 1:].set(val)
    if name == "reflecting":
        vr = vr.at[irad].set(-vr[irad - 2])
        return vr.at[irad - 1].set(0.0)
    if name == "reference":
        return vr.at[irad - 1:].set(vr0[irad - 1:])
    if name == "keplerian":
        # (reference src/boundary_conditions/keplerian_radial.cpp:41-63)
        vk_hi = kep_factor * jnp.sqrt(gm / g.rmed_ext[irad, 0])
        vk_lo = kep_factor * jnp.sqrt(gm / g.rmed_ext[irad - 1, 0])
        vr = vr.at[irad].set(vk_hi)
        return vr.at[irad - 1].set(vk_lo)
    if name == "viscous":
        # (reference src/boundary_conditions/viscous.cpp:31-48)
        if nu is None:
            raise ValueError("viscous BC needs the viscosity grid")
        nu_edge = 0.5 * (nu[-1] + nu[-2])
        vr = vr.at[irad].set(-1.5 * phys_vos / g.ra[irad, 0] * nu_edge)
        return vr.at[irad - 1].set(
            -1.5 * phys_vos / g.ra[irad - 1, 0] * nu_edge)
    if name == "none":
        return vr
    raise NotImplementedError(f"vrad outer BC {name!r}")


def _balanced_value(phys: Physics, constants, g: Geom, nr_row: int,
                    omega_frame):
    """Pressure-gradient/smoothing-balanced equilibrium v_az at a ghost ring
    (reference src/boundary_conditions/balanced.cpp:23-75, Baruteau 2008)."""
    R = g.rb[nr_row, 0]
    vk2 = constants.G * phys.hydro_center_mass / R
    support = jnp.zeros_like(R)
    if not phys.profile_cutoff_outer:
        h = phys.aspectratio_ref * R ** phys.flaring_index
        support = support + (2.0 * phys.flaring_index - 1.0
                             - phys.sigma_slope) * h ** 2
        he2 = (h * phys.thickness_smoothing) ** 2
        support = support + (1.0 + (phys.flaring_index + 1.0) * he2) \
            / jnp.sqrt(1.0 + he2) ** 3
    return jnp.sqrt(vk2 * support) - R * omega_frame


# ----- v_az BCs --------------------------------------------------------------

def _vaz_inner(phys: Physics, constants, name: str, vaz, vaz0, g: Geom,
               omega_frame):
    if name == "keplerian":
        # reference src/boundary_conditions/keplerian_azimuthal.cpp:19-38
        r = g.rb[0, 0]
        vkep = jnp.sqrt(constants.G * phys.hydro_center_mass / r)
        val = phys.keplerian_azimuthal_inner_factor * vkep - r * omega_frame
        return vaz.at[0].set(val)
    if name == "zerogradient":
        return vaz.at[0].set(vaz[1])
    if name == "reference":
        return vaz.at[0].set(vaz0[0])
    if name == "zeroshear":
        # d(omega)/dr = 0: vaz[0] = vaz[1] * Rb[0]/Rb[1]
        return vaz.at[0].set(vaz[1] * g.rb[0, 0] / g.rb[1, 0])
    if name == "balanced":
        return vaz.at[0].set(_balanced_value(phys, constants, g, 0,
                                             omega_frame))
    if name == "none":
        return vaz
    raise NotImplementedError(f"vaz inner BC {name!r}")


def _vaz_outer(phys: Physics, constants, name: str, vaz, vaz0, g: Geom,
               omega_frame):
    nr = vaz.shape[0]
    if name == "keplerian":
        r = g.rb[nr - 1, 0]
        vkep = jnp.sqrt(constants.G * phys.hydro_center_mass / r)
        val = phys.keplerian_azimuthal_outer_factor * vkep - r * omega_frame
        return vaz.at[nr - 1].set(val)
    if name == "zerogradient":
        return vaz.at[nr - 1].set(vaz[nr - 2])
    if name == "reference":
        return vaz.at[nr - 1].set(vaz0[nr - 1])
    if name == "zeroshear":
        return vaz.at[nr - 1].set(vaz[nr - 2] * g.rb[nr - 1, 0] / g.rb[nr - 2, 0])
    if name == "balanced":
        return vaz.at[nr - 1].set(_balanced_value(phys, constants, g, nr - 1,
                                                  omega_frame))
    if name == "none":
        return vaz
    raise NotImplementedError(f"vaz outer BC {name!r}")


def apply_boundary_conditions(phys: Physics, constants, g: Geom,
                              sigma, vrad, vaz, energy,
                              ref: RefValues, omega_frame, nu=None,
                              rof_ctx=None, com_ctx=None):
    """Per-variable x per-edge dispatch (reference
    src/boundary_conditions/boundary_conditions.cpp:65-110). Damping is a
    separate call (``apply_damping``) made only on the final BC application
    of a step."""
    sigma = _scalar_inner(phys.bc_sigma_inner, sigma, ref.sigma0, g, phys,
                          "sigma")
    sigma = _scalar_outer(phys.bc_sigma_outer, sigma, ref.sigma0, g, phys,
                          "sigma")
    energy = _scalar_inner(phys.bc_energy_inner, energy, ref.energy0, g,
                           phys, "energy")
    energy = _scalar_outer(phys.bc_energy_outer, energy, ref.energy0, g,
                           phys, "energy")
    gm = constants.G * phys.hydro_center_mass
    vrad = _vrad_inner(phys.bc_vrad_inner, vrad, ref.vrad0, g, nu,
                       phys.viscous_outflow_speed, gm,
                       phys.keplerian_radial_inner_factor)
    vrad = _vrad_outer(phys.bc_vrad_outer, vrad, ref.vrad0, g, nu,
                       phys.viscous_outflow_speed, gm,
                       phys.keplerian_radial_outer_factor)
    vaz = _vaz_inner(phys, constants, phys.bc_vaz_inner, vaz, ref.vaz0, g,
                     omega_frame)
    vaz = _vaz_outer(phys, constants, phys.bc_vaz_outer, vaz, ref.vaz0, g,
                     omega_frame)
    if phys.rochelobe_overflow and rof_ctx is not None:
        sigma, vrad, vaz, energy = rochelobe_overflow(
            phys, constants, g, sigma, vrad, vaz, energy, omega_frame,
            *rof_ctx)
    if com_ctx is not None and "centerofmass" in (phys.composite_inner,
                                                  phys.composite_outer):
        nb, n_hydroframe, quad = com_ctx
        if phys.composite_inner == "centerofmass":
            sigma, vrad, vaz, energy = center_of_mass_boundary(
                phys, constants, g, sigma, vrad, vaz, energy, nb,
                n_hydroframe, quad, omega_frame, outer=False)
        if phys.composite_outer == "centerofmass":
            sigma, vrad, vaz, energy = center_of_mass_boundary(
                phys, constants, g, sigma, vrad, vaz, energy, nb,
                n_hydroframe, quad, omega_frame, outer=True)
    return sigma, vrad, vaz, energy


def center_of_mass_boundary(phys: Physics, constants, g: Geom, sigma, vrad,
                            vaz, energy, nb, n_hydroframe: int,
                            quad_moment: float, omega_frame,
                            outer: bool = True):
    """Circumbinary ghost-ring BC: the analytic disk-model profile evaluated
    in a center-of-mass frame, then shifted back to the primary-centered
    frame (reference src/boundary_conditions/center_of_mass.cpp:37-425
    ``diskmodel_center_of_mass_boundary_{outer,inner}``).

    The two sides use DIFFERENT conventions (center_of_mass.cpp:44-47 vs
    :231-236): the OUTER boundary takes the COM/mass of ALL bodies, the
    quadrupole-supported v_az, and the grid-corrected radial drift (the
    init-built outer vr table caches vr*correction); the INNER boundary
    takes the COM/mass of the first ``n_bodies_for_hydroframe_center``
    bodies, the plain smoothed v_az, and the uncorrected drift."""
    from . import diskmodel as dm

    n_com = None if outer else n_hydroframe
    m = nb.mass[:n_com]
    com_m = jnp.sum(m)
    com_x = jnp.sum(m * nb.x[:n_com]) / com_m
    com_y = jnp.sum(m * nb.y[:n_com]) / com_m
    com_vx = jnp.sum(m * nb.vx[:n_com]) / com_m
    com_vy = jnp.sum(m * nb.vy[:n_com]) / com_m

    nr = g.nrad
    row = nr - 1 if outer else 0
    phi_c = jnp.arange(g.naz) * g.dphi          # cell-center azimuths

    def profile_velocities(r_pos, phi):
        """(vx, vy) of the model flow at radius r_pos, azimuth phi (lab
        frame), from the COM-frame profile."""
        x = r_pos * accurate_cos(phi)
        y = r_pos * jnp.sin(phi)
        x_com = x - com_x
        y_com = y - com_y
        r_com = jnp.sqrt(x_com ** 2 + y_com ** 2)
        if phys.initialize_pure_keplerian:
            vazi0 = dm.v_kepler(constants, r_com, com_m)
            vr0 = dm.viscous_radial_speed_analytic(phys, constants, r_com,
                                                   com_m)
        else:
            # quadrupole-supported v_az on the outer side only
            # (center_of_mass.cpp:79-85 vs :42); get_w inside the vr
            # model keeps the quadrupole on BOTH sides when enabled
            # (viscous_radial_speed.cpp:141-147)
            vazi0 = dm.v_az_smoothed(phys, constants, r_com, com_m,
                                     quad_moment if outer else 0.0)
            vr0 = dm.vr_numerical_viscous(phys, constants, r_com, com_m,
                                          quad_moment)
            if outer:
                vr0 = vr0 * dm.vr_outer_grid_correction(
                    phys, constants, g, r_com, com_m, quad_moment)
        vx = (vr0 * x_com - vazi0 * y_com) / r_com + com_vx
        vy = (vr0 * y_com + vazi0 * x_com) / r_com + com_vy
        return x, y, vx, vy

    # v_az at the azimuthal interfaces (phi - dphi/2)
    x, y, vx, vy = profile_velocities(g.rb[row, 0], phi_c - 0.5 * g.dphi)
    vaz = vaz.at[row].set((x * vy - vx * y) / g.rb[row, 0]
                          - omega_frame * g.rb[row, 0])
    # v_rad at the two radial faces bounding the ghost ring
    faces = (row, row + 1) if outer else (1, 0)
    for f in faces:
        x, y, vx, vy = profile_velocities(g.ra[f, 0], phi_c)
        vrad = vrad.at[f].set((x * vx + y * vy) / g.ra[f, 0])
    # Sigma and energy from the COM-frame profile (with the temperature
    # floor, reference :196-225)
    x = g.rb[row, 0] * accurate_cos(phi_c)
    y = g.rb[row, 0] * jnp.sin(phi_c)
    r_com = jnp.sqrt((x - com_x) ** 2 + (y - com_y) ** 2)
    sig_row = phys.sigma0 * r_com ** (-phys.sigma_slope)
    sigma = sigma.at[row].set(sig_row)
    if phys.is_adiabatic:
        e_row = dm.initial_energy(phys, constants, r_com, com_m)
        e_floor = phys.minimum_temperature * sig_row / phys.mu \
            * constants.R / (phys.adiabatic_index - 1.0)
        energy = energy.at[row].set(jnp.maximum(e_row, e_floor))
    return sigma, vrad, vaz, energy


def rochelobe_overflow(phys: Physics, constants, g: Geom, sigma, vrad, vaz,
                       energy, omega_frame, nb, current_time,
                       temp0_factor, time_to_hours, length_to_cm,
                       mdot=None):
    """Roche-lobe mass-overflow stream injected at the outer ghost ring
    around the donor's azimuth (reference
    src/boundary_conditions/mass_overflow.cpp:22-140): a Gaussian stream
    whose width follows the donor temperature and orbital period, ramped
    in over ``ROFrampingtime`` donor orbits."""
    import jax
    k = phys.rof_planet
    x, y = nb.x[k], nb.y[k]
    vx, vy = nb.vx[k], nb.vy[k]
    r2 = x * x + y * y
    omega_planet = (x * vy - y * vx) / r2 + omega_frame
    angle = jnp.arctan2(y, x) / (2.0 * jnp.pi)
    angle = jnp.where(angle < 0.0, angle + 1.0, angle)

    nr, naz = g.nrad, g.naz
    r_cell = g.rb[nr - 1, 0]
    vr_fraction = 0.002
    vr_stream = -omega_planet * r_cell * vr_fraction
    vazi_stream = (omega_planet - omega_frame) * r_cell
    if mdot is None:
        mdot = phys.rof_mdot
    sigma_stream = jnp.abs(mdot / (g.dphi * g.ra[nr - 1, 0] * vr_stream))

    nearest = jnp.mod((naz * angle + 0.5).astype(jnp.int32), naz)
    porb_hours = 2.0 * jnp.pi / omega_planet * time_to_hours
    q_w = 2.4e13 * (phys.rof_temperature * temp0_factor) * porb_hours ** 2
    w = jnp.sqrt(q_w / jnp.pi)
    circ = 2.0 * jnp.pi * r_cell * length_to_cm
    sig_frac = 2.0 * w / circ
    sigmabar = naz * sig_frac

    period = 2.0 * jnp.pi / omega_planet
    t_ramp = phys.rof_rampingtime * period
    ramp = jnp.where(current_time < t_ramp,
                     jnp.sin(current_time * (jnp.pi / 2.0)
                             / jnp.maximum(t_ramp, 1e-300)) ** 6, 1.0)

    j = jnp.arange(naz)
    # signed azimuthal cell offset to the stream center
    di = jnp.mod(j - nearest + naz // 2, naz) - naz // 2
    window = jnp.abs(di) <= jnp.maximum(3.0 * sigmabar, 0.0)
    weight = jnp.where(
        sigmabar > 0.0,
        jnp.exp(-0.5 * (di / jnp.maximum(sigmabar, 1e-30)) ** 2)
        / (jnp.maximum(sigmabar, 1e-30) * jnp.sqrt(2.0 * jnp.pi)),
        jnp.where(di == 0, 1.0, 0.0))
    dens = jnp.maximum(ramp * weight * sigma_stream,
                       phys.sigma_floor * phys.sigma0)

    row = nr - 1
    sigma = sigma.at[row].set(jnp.where(window, dens, sigma[row]))
    if phys.is_adiabatic:
        e_stream = phys.rof_temperature * dens / phys.mu * constants.R \
            / (phys.adiabatic_index - 1.0)
        energy = energy.at[row].set(jnp.where(window, e_stream, energy[row]))
    vrad = vrad.at[row].set(jnp.where(window, vr_stream, vrad[row]))
    vrad = vrad.at[row + 1].set(jnp.where(window, vr_stream, vrad[row + 1]))
    window_vaz = window | jnp.roll(window, 1)
    vaz = vaz.at[row].set(jnp.where(window_vaz, vazi_stream, vaz[row]))
    return sigma, vrad, vaz, energy
