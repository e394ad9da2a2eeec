"""Gravitational potential / acceleration of the N-body system on the gas.

Re-derivation of reference src/Pframeforce.cpp:21-211
(``CalculateNbodyPotential`` / ``CalculateAccelOnGas``) and the smoothing
rules of src/Force.cpp:124-159. Bodies are given as small per-planet arrays
(positions/masses), the loop over bodies is unrolled (N is tiny), and the
per-cell work is pure elementwise math that XLA fuses.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..params import Physics
from .common import Geom


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BodiesOnGrid:
    """Per-body state needed by the gas-side gravity ops.

    All fields are 1-D arrays of length N_bodies.
    """
    x: jax.Array
    y: jax.Array
    mass: jax.Array                 # ramped-up mass
    cubic_smoothing_radius: jax.Array  # dimensionless_roche * dist * cubic_factor


def single_star(dtype=jnp.float64, mass: float = 1.0) -> BodiesOnGrid:
    z = jnp.zeros((1,), dtype)
    return BodiesOnGrid(x=z, y=z, mass=jnp.full((1,), mass, dtype),
                        cubic_smoothing_radius=z)


def smoothing_length(phys: Physics, scale_height: jax.Array,
                     body_index: int, body_r=None) -> jax.Array:
    """epsilon * H, either per cell (reference src/Force.cpp:124-131) or at
    the planet location (compatibility mode, :133-143: eps*h0*a^(1+F))."""
    if phys.compatibility_no_star_smoothing and body_index == 0:
        return jnp.zeros_like(scale_height)
    if phys.compatibility_smoothing_planetloc and body_r is not None:
        h_loc = phys.aspectratio_ref * body_r ** (1.0 + phys.flaring_index)
        return jnp.broadcast_to(phys.thickness_smoothing * h_loc,
                                scale_height.shape)
    return phys.thickness_smoothing * scale_height


def disk_on_body_accel(phys: Physics, constants, g: Geom,
                       bodies: BodiesOnGrid, n_bodies: int,
                       cell_x: jax.Array, cell_y: jax.Array,
                       scale_height: jax.Array, sigma: jax.Array,
                       row_w=None, axis_name=None):
    """Acceleration of each body due to the gas disk
    (reference src/Force.cpp:23-122 ``ComputeDiskOnPlanetAccel``): smoothed
    sum of cell-mass attractions over the active rings; the MPI_Allreduce
    becomes the jnp.sum (a cross-shard reduce under the mesh).

    Under the explicit shard_map path, ``row_w`` is the
    ownership-and-active row-weight column of the local slab and
    ``axis_name`` the mesh axis to ``psum`` over.

    Returns (ax, ay) arrays of length n_bodies.
    """
    nr = g.nrad
    sig = sigma
    if phys.correct_disk_selfgravity:
        # remove the axisymmetric background so the planet only feels the
        # non-axisymmetric disk response (reference src/Force.cpp:64-66,
        # default on when self-gravity is off, parameters.cpp:732)
        sig = sigma - jnp.mean(sigma, axis=-1, keepdims=True)
    cellmass = g.surf * sig                        # (NR, NAZ)
    # active rings only (radial_first_active..radial_active_size-1)
    axs, ays = [], []
    for k in range(n_bodies):
        body_r = jnp.sqrt(bodies.x[k] ** 2 + bodies.y[k] ** 2)
        smooth = smoothing_length(phys, scale_height, k, body_r)
        dx = cell_x - bodies.x[k]
        dy = cell_y - bodies.y[k]
        d_sm2 = dx * dx + dy * dy + smooth * smooth
        inv_d3 = d_sm2 ** -1.5
        r_sm = bodies.cubic_smoothing_radius[k]
        d_sm = jnp.sqrt(d_sm2)
        q = d_sm / jnp.where(r_sm > 0.0, r_sm, 1.0)
        # derivative form of the Klahr & Kley cubic smoothing
        # (reference src/Force.cpp:79-96)
        klahr = jnp.where((r_sm > 0.0) & (d_sm < r_sm),
                          -(3.0 * q ** 4 - 4.0 * q ** 3), 1.0)
        w = constants.G * cellmass * inv_d3 * klahr
        if row_w is None:
            axs.append(jnp.sum((w * dx)[1:nr - 1]))
            ays.append(jnp.sum((w * dy)[1:nr - 1]))
        else:
            axs.append(jnp.sum(w * dx * row_w))
            ays.append(jnp.sum(w * dy * row_w))
    ax, ay = jnp.stack(axs), jnp.stack(ays)
    if axis_name is not None:
        ax = jax.lax.psum(ax, axis_name)
        ay = jax.lax.psum(ay, axis_name)
    if phys.planet_orbit_disk_test and n_bodies > 0:
        # test mode: body 0 orbits in a fixed potential, feeling no disk
        # (reference src/Pframeforce.cpp:218-221)
        ax = ax.at[0].set(0.0)
        ay = ay.at[0].set(0.0)
    return ax, ay


def indirect_term_disk(phys: Physics, bodies: BodiesOnGrid, n_center: int,
                       disk_ax, disk_ay):
    """-(sum of m_k a_k)/(sum m_k) over the hydro-frame-center bodies
    (reference src/frame_of_reference.cpp:69-93)."""
    m = bodies.mass[:n_center]
    mc = jnp.sum(m)
    itx = -jnp.sum(m * disk_ax[:n_center]) / mc
    ity = -jnp.sum(m * disk_ay[:n_center]) / mc
    return itx, ity


def indirect_term_nbody(constants, bodies: BodiesOnGrid, n_center: int,
                        n_bodies: int):
    """Euler-mode N-body indirect term
    (reference src/frame_of_reference.cpp:114-133): acceleration of the
    frame-center COM from the mutual N-body forces. Zero when all bodies
    define the frame center."""
    if n_center >= n_bodies or n_bodies == 1:
        z = jnp.zeros((), bodies.x.dtype)
        return z, z
    from ..nbody.system import mutual_accelerations
    ax, ay = mutual_accelerations(bodies.x, bodies.y, bodies.mass,
                                  constants.G)
    m = bodies.mass[:n_center]
    mc = jnp.sum(m)
    itx = -jnp.sum(m * ax[:n_center]) / mc
    ity = -jnp.sum(m * ay[:n_center]) / mc
    return itx, ity


def indirect_term_nbody_predictor(constants, nb, n_center: int,
                                  n_bodies: int, dt):
    """Predictor-mode N-body indirect term (reference
    src/frame_of_reference.cpp:135-165, INDIRECT_TERM_REBOUND): integrate
    the bodies forward by dt with the high-order integrator and read the
    effective frame-center acceleration from the COM velocity change. The
    reference uses its REBOUND/IAS15 copy for the prediction; here the
    same adaptive IAS15 integrator that advances the bodies serves as
    the predictor."""
    from ..nbody.system import integrate
    if n_center >= n_bodies or n_bodies == 1:
        z = jnp.zeros((), nb.x.dtype)
        return z, z
    pred = integrate(nb, constants.G, dt)
    m = nb.mass[:n_center]
    mc = jnp.sum(m)
    dvx = jnp.sum(m * (pred.vx[:n_center] - nb.vx[:n_center])) / mc
    dvy = jnp.sum(m * (pred.vy[:n_center] - nb.vy[:n_center])) / mc
    safe_dt = jnp.where(dt != 0.0, dt, 1.0)
    itx = jnp.where(dt != 0.0, -dvx / safe_dt, 0.0)
    ity = jnp.where(dt != 0.0, -dvy / safe_dt, 0.0)
    return itx, ity


def nbody_potential(phys: Physics, constants, g: Geom,
                    bodies: BodiesOnGrid, n_bodies: int,
                    cell_x: jax.Array, cell_y: jax.Array,
                    scale_height: jax.Array,
                    indirect_x, indirect_y) -> jax.Array:
    """POTENTIAL grid (reference src/Pframeforce.cpp:21-95).

    Phi = sum_k [ -G m_k / sqrt(d^2 + (eps H)^2) * klahr_factor ]
          - IndirectTerm . x_cell
    """
    pot = jnp.zeros_like(cell_x)
    for k in range(n_bodies):
        body_r = jnp.sqrt(bodies.x[k] ** 2 + bodies.y[k] ** 2)
        smooth = smoothing_length(phys, scale_height, k, body_r)
        dx = cell_x - bodies.x[k]
        dy = cell_y - bodies.y[k]
        d_sm = jnp.sqrt(dx * dx + dy * dy + smooth * smooth)
        r_sm = bodies.cubic_smoothing_radius[k]
        # Klahr & Kley 2005 cubic inner smoothing (src/Pframeforce.cpp:61-76)
        q = d_sm / jnp.where(r_sm > 0.0, r_sm, 1.0)
        klahr = jnp.where((r_sm > 0.0) & (d_sm < r_sm),
                          q ** 4 - 2.0 * q ** 3 + 2.0 * q, 1.0)
        pot = pot - constants.G * bodies.mass[k] / d_sm * klahr
    pot = pot - indirect_x * cell_x - indirect_y * cell_y
    return pot
