"""Lagrangian dust particles: drag, semi-implicit integration, stochastic
diffusion.

Re-derivation of reference src/particles/particles.cpp and
src/particles/dust_diffusion.cpp, built for XLA: particle state is a
struct-of-arrays pytree integrated in lockstep inside the jitted step; the
per-particle OpenMP loops become vectorized gathers from the gas grids,
and the per-rank MPI migration (reference :2016-2160) disappears —
particles are replicated (they are small) while the gas stays sharded.

Physics:
  * stopping time: Woitke & Helling 2002 / Picogna, Stoll & Kley 2018
    blended Epstein + Stokes drag law (reference :1130-1215 calc_tstop)
  * integrator: semi-implicit exponential midpoint in polar coordinates
    (Zhu et al. 2014 A4-A12 with the Mignone et al. 2019 exponential
    propagator; reference :1579-1674) — handles arbitrarily stiff drag
  * diffusion: Charnoz et al. 2011 Brownian kicks with the
    Youdin & Lithwick 2007 Schmidt number (reference dust_diffusion.cpp)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..params import Physics
from ..units import CGS_KB, CGS_AMU
from ..ops.common import Geom, accurate_cos


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ParticleState:
    """Struct-of-arrays particle state (polar coordinates, length N)."""
    r: jax.Array
    phi: jax.Array
    r_dot: jax.Array
    phi_dot: jax.Array
    size: jax.Array       # physical particle radius (code length units)
    stokes: jax.Array     # diagnostic: tstop * Omega_K
    alive: jax.Array      # escape mask (dead particles are frozen)
    rng_key: jax.Array    # for diffusion kicks
    # adaptive-integrator memory (reference src/particles/particle.h:5-40
    # carries per-particle timestep/facold across hydro steps); 0 = unset
    timestep: jax.Array = None
    facold: jax.Array = None

    def replace(self, **kw) -> "ParticleState":
        from dataclasses import replace as _replace
        return _replace(self, **kw)

    @property
    def n(self) -> int:
        return self.r.shape[0]


@dataclass(frozen=True)
class ParticleParams:
    """Static particle configuration (reference src/parameters.cpp dust
    section)."""
    density: float = 0.0          # internal particle density (code units)
    gas_drag: bool = True
    disk_gravity: bool = False
    diffusion: bool = False
    integrator: str = "midpoint"  # midpoint | explicit
    # integrate the adaptive RK45 in cartesian coordinates (reference
    # parameters.cpp:854-932 CartesianParticles; forced off for the
    # exponential-midpoint integrator, which is polar-only)
    cartesian: bool = False
    min_escape_radius: float = 0.0
    max_escape_radius: float = 1e300


# ---------------------------------------------------------------------------
# gas-field interpolation at particle positions
# ---------------------------------------------------------------------------

def _geometric_ladder(pos) -> tuple[float, float] | None:
    """(ln pos[0], 1/ln g) when ``pos`` is a host-side geometric ladder
    pos[i] = pos[0] * g^i (log radial grids and their slab windows),
    else None.  Traced arrays always return None (searchsorted path)."""
    if isinstance(pos, jax.core.Tracer) or not isinstance(
            pos, (np.ndarray, list, tuple)):
        return None
    p = np.asarray(pos, np.float64)
    if p.ndim != 1 or p.size < 2 or not np.all(p > 0.0):
        return None
    ratios = p[1:] / p[:-1]
    if np.ptp(ratios) > 1e-10 * ratios.mean():
        return None
    return float(np.log(p[0])), float(1.0 / np.log(ratios.mean()))


def _lin_weights(positions, x):
    """Index pair + weights for linear interpolation on a sorted 1-D grid.

    The radial cell lookup is ANALYTIC on geometric ladders (log grids):
    i = floor((ln x - ln pos0) / ln g), where jnp.searchsorted would run
    a binary search as a chain of gathers (and compiles slowly); the
    analytic form is ~free.  A boundary-adjacent query
    can land one cell off the searchsorted answer through f32 log
    rounding — the clamped weight then sits at 0/1, so the interpolated
    VALUE stays continuous (identical up to ~1e-6 cell fractions).
    Non-geometric grids (arithmetic spacing, traced window arrays) keep
    the searchsorted path."""
    ladder = _geometric_ladder(positions)
    pos = jnp.asarray(positions, x.dtype)
    n = pos.shape[0]
    if ladder is not None:
        lr0, inv_lg = ladder
        xs = jnp.maximum(x, jnp.finfo(x.dtype).tiny)
        i = jnp.clip(jnp.floor((jnp.log(xs) - lr0) * inv_lg)
                     .astype(jnp.int32), 0, n - 2)
    else:
        i = jnp.clip(jnp.searchsorted(pos, x) - 1, 0, n - 2)
    x0 = pos[i]
    x1 = pos[i + 1]
    w = jnp.clip((x - x0) / (x1 - x0), 0.0, 1.0)
    return i, w


def interpolate_many(fields, radial_pos, r, phi, naz, az_offset=0.0,
                     rw=None):
    """Bilinear interpolation of K same-layout grid fields at particle
    positions via flattened 1-D element takes.

    Gathers are the dust integrator's main cost; the corners are read
    as flattened 1-D single-element takes, which also compile quickly
    (2-D advanced indexing and (1,1,K) corner ``lax.gather`` forms
    compiled far more slowly on an earlier backend; their GPU times are
    not measured).

    ``radial_pos`` are the radial sample points of the fields' rows
    (cell centers or faces); azimuthal samples sit at
    (j + az_offset) dphi, periodic.  ``rw`` optionally supplies the
    radial (index, weight) pair so callers sampling several field groups
    at the same rows compute it once.  Returns a tuple of K arrays."""
    dphi = 2.0 * math.pi / naz
    i, wr = rw if rw is not None else _lin_weights(radial_pos, r)
    i = i.astype(jnp.int32)
    t = phi / dphi - az_offset
    j0 = jnp.floor(t).astype(jnp.int32)
    wa = t - j0
    j0 = jnp.mod(j0, naz).astype(jnp.int32)
    j1 = jnp.mod(j0 + 1, naz)
    naz32 = jnp.int32(naz)
    row0 = i * naz32
    row1 = row0 + naz32
    outs = []
    for f in fields:
        ff = f.reshape(-1)
        f00 = jnp.take(ff, row0 + j0)
        f01 = jnp.take(ff, row0 + j1)
        f10 = jnp.take(ff, row1 + j0)
        f11 = jnp.take(ff, row1 + j1)
        outs.append((1 - wr) * ((1 - wa) * f00 + wa * f01)
                    + wr * ((1 - wa) * f10 + wa * f11))
    return tuple(outs)


def interpolate(field, radial_pos, r, phi, naz, az_offset=0.0, rw=None):
    """Bilinear interpolation of one grid field at particle positions
    (patch-gather path, see interpolate_many)."""
    return interpolate_many((field,), radial_pos, r, phi, naz,
                            az_offset=az_offset, rw=rw)[0]


@dataclass(frozen=True)
class GasAtParticles:
    rho: jax.Array
    temperature: jax.Array
    vg_r: jax.Array
    vg_phi: jax.Array     # inertial-frame azimuthal gas velocity


def sample_gas(geom_np, g: Geom, rho, temperature, vrad, vaz, omega_frame,
               r, phi):
    """Gas state at the particle positions (reference :1441-1470).

    The cell-centered radial weights (rho/T/vaz rows) are computed once
    and shared; the host rmed/radii arrays go to ``_lin_weights``
    unconverted so log grids take its analytic-index path."""
    naz = g.naz
    rw_cell = _lin_weights(geom_np.rmed, r)
    rw_face = _lin_weights(geom_np.radii, r)
    # rho and T share layout (cell centers, offset 0): one index set
    rho_p, T_p = interpolate_many((rho, temperature), None, r, phi, naz,
                                  az_offset=0.0, rw=rw_cell)
    vg_r = interpolate(vrad, None, r, phi, naz, az_offset=0.0, rw=rw_face)
    # v_az rows sample at azimuth (j-1/2) dphi (reference src/init.cpp:1552)
    vg_phi = interpolate(vaz, None, r, phi, naz, az_offset=-0.5, rw=rw_cell)
    vg_phi = vg_phi + omega_frame * r
    return GasAtParticles(rho=rho_p, temperature=T_p, vg_r=vg_r,
                          vg_phi=vg_phi)


# ---------------------------------------------------------------------------
# drag law
# ---------------------------------------------------------------------------

def calc_tstop(phys: Physics, constants, units, size, rho, vrel, temperature,
               particle_density):
    """Stopping time (reference src/particles/particles.cpp:1130-1215)."""
    m0 = phys.mu * (CGS_AMU / units.mass)
    k_B_code = CGS_KB / (units.energy / units.temperature)
    vthermal = jnp.sqrt(8.0 * k_B_code * temperature / (jnp.pi * m0))
    a0 = 1.5e-8 / units.length                       # H2 radius in code units
    cross_section = jnp.pi * a0 ** 2
    nu_mol = (1.0 / 3.0) * m0 * vthermal / cross_section
    l_mfp = m0 / jnp.pi / a0 ** 2 / rho
    c_s = vthermal * math.sqrt(math.pi / 8.0)
    Kn = 0.5 * l_mfp / size
    vrel = jnp.maximum(vrel, 1e-15 * c_s)
    Ma = vrel / c_s
    Re = 2.0 * size * rho * vrel / nu_mol
    CdE = 2.0 * jnp.sqrt(Ma * Ma + 128.0 / (9.0 * jnp.pi))
    # Stokes drag coefficient branches (reference :1185-1195)
    cds_low = 24.0 * nu_mol / (2.0 * size * rho * c_s) \
        + 3.6 / c_s * vrel ** 0.687 * (2.0 * size * rho / nu_mol) ** -0.313
    cds_mid = 24.0 * Ma / Re + 3.6 * Ma * Re ** -0.313
    cds_high = Ma * 9.5e-5 * Re ** 1.397
    cds_max = Ma * 2.61
    CdS = jnp.where(Re <= 1e-3, cds_low,
                    jnp.where(Re <= 500.0, cds_mid,
                              jnp.where(Re <= 1500.0, cds_high, cds_max)))
    Cd = (9.0 * Kn * Kn * CdE + CdS) / (3.0 * Kn + 1.0) ** 2
    return 4.0 * l_mfp * particle_density / (3.0 * rho * Cd * c_s * Kn)


# ---------------------------------------------------------------------------
# gravity on particles
# ---------------------------------------------------------------------------

def gravity_derivatives(constants, bodies, n_bodies, r, phi):
    """(d(r_dot)/dt, d(l)/dt) from the N-body potential in polar
    coordinates about the grid origin (reference
    ``calculate_derivitives_from_star_and_planets``)."""
    r_ddot = jnp.zeros_like(r)
    l_dot = jnp.zeros_like(r)
    G = constants.G
    for k in range(n_bodies):
        xk, yk, mk = bodies.x[k], bodies.y[k], bodies.mass[k]
        rk = jnp.sqrt(xk * xk + yk * yk)
        phik = jnp.arctan2(yk, xk)
        cosd = accurate_cos(phi - phik)
        sind = jnp.sin(phi - phik)
        d2 = r * r + rk * rk - 2.0 * r * rk * cosd
        d3 = jnp.maximum(d2, 1e-300) ** 1.5
        r_ddot = r_ddot - G * mk * (r - rk * cosd) / d3
        l_dot = l_dot - G * mk * r * rk * sind / d3
    return r_ddot, l_dot


# ---------------------------------------------------------------------------
# semi-implicit exponential midpoint integrator
# ---------------------------------------------------------------------------

def sample_sg_accel(geom_np, sg_accel, r, phi):
    """Bilinear interpolation of the self-gravity acceleration fields at
    the particle positions (reference src/particles/particles.cpp:1506-1524
    ``update_velocity_from_disk_gravity``)."""
    g_r, g_t = sg_accel
    naz = g_r.shape[1]
    rpos = jnp.asarray(geom_np.rmed)
    r_c = jnp.clip(r, rpos[0], rpos[-1])
    ar, at = interpolate_many((g_r, g_t), geom_np.rmed, r_c, phi, naz)
    return ar, at


def integrate_expmid(phys: Physics, pp: ParticleParams, constants, units,
                     geom_np, g: Geom, state: ParticleState,
                     rho, temperature, vrad, vaz, bodies, n_bodies,
                     omega_frame, dt, sg_accel=None):
    """One dt of particle motion (reference :1579-1674, Zhu et al. 2014).
    ``sg_accel`` = (g_r, g_phi) disk self-gravity grids enables disk
    gravity on the particles."""
    r0, phi0 = state.r, state.phi
    r_dot0, phi_dot0 = state.r_dot, state.phi_dot
    l0 = r0 * r0 * phi_dot0
    hfdt = 0.5 * dt

    # half-drift
    r1 = r0 + r_dot0 * hfdt
    phi1 = phi0 + 0.5 * (l0 / r0 ** 2 + l0 / r1 ** 2) * hfdt

    # kick — the stopping time is computed even with drag disabled: the
    # Stokes number feeds the diffusion Schmidt number (reference
    # ``check_tstop``, src/particles/particles.cpp:1548-1551)
    gas = sample_gas(geom_np, g, rho, temperature, vrad, vaz,
                     omega_frame, r1, phi1)
    vrel_r = gas.vg_r - r_dot0
    l_gas = r1 * gas.vg_phi
    vrel_phi = (l_gas - l0) / r1
    vrel = jnp.sqrt(vrel_r ** 2 + vrel_phi ** 2)
    ts_physical = calc_tstop(phys, constants, units, state.size, gas.rho,
                             vrel, gas.temperature, pp.density)
    if pp.gas_drag:
        ts = ts_physical
    else:
        ts = jnp.full_like(r0, 1e100)
        vrel_r = jnp.zeros_like(r0)
        l_gas = l0

    r_ddot_grav, l_dot_grav = gravity_derivatives(constants, bodies,
                                                  n_bodies, r1, phi1)
    if pp.disk_gravity and sg_accel is not None:
        sg_r, sg_t = sample_sg_accel(geom_np, sg_accel, r1, phi1)
        r_ddot_grav = r_ddot_grav + sg_r
        l_dot_grav = l_dot_grav + r1 * sg_t

    # exponential propagator (Mignone et al. 2019 eq. 33)
    x = dt / ts
    exp_ts = jnp.exp(-x)
    h1 = ts * -jnp.expm1(-x)

    l2 = exp_ts * l0 + h1 * l_dot_grav
    if pp.gas_drag:
        l2 = l2 + h1 * l_gas / ts

    r_dot2 = exp_ts * r_dot0
    r_dot2 = r_dot2 + h1 * 0.5 * (l0 * l0 + l2 * l2) / r1 ** 3
    r_dot2 = r_dot2 + h1 * r_ddot_grav
    if pp.gas_drag:
        v_r_g = vrel_r + r_dot0
        r_dot2 = r_dot2 + h1 * v_r_g / ts

    # half-drift
    r3 = r1 + r_dot2 * hfdt
    phi3 = phi1 + 0.5 * (l2 / r1 ** 2 + l2 / r3 ** 2) * hfdt
    phi3 = jnp.mod(phi3, 2.0 * jnp.pi)

    omega_k = jnp.sqrt(constants.G * phys.hydro_center_mass / r3 ** 3)
    alive = state.alive & (r3 > pp.min_escape_radius) \
        & (r3 < pp.max_escape_radius)

    def keep(new, old):
        return jnp.where(alive, new, old)

    return state.replace(
        r=keep(r3, state.r), phi=keep(phi3, state.phi),
        r_dot=keep(r_dot2, state.r_dot),
        phi_dot=keep(l2 / r3 ** 2, state.phi_dot),
        stokes=keep(ts_physical * omega_k, state.stokes), alive=alive)


# ---------------------------------------------------------------------------
# explicit adaptive Cash-Karp RK45 integrator
# ---------------------------------------------------------------------------

def integrate_rk45(phys: Physics, pp: ParticleParams, constants, units,
                   geom_np, g: Geom, state: ParticleState,
                   rho, temperature, vrad, vaz, bodies, n_bodies,
                   omega_frame, dt, sg_accel=None):
    """Explicit drag kick + adaptive Cash-Karp RK45 gravity integration
    (reference src/particles/particles.cpp:1428-1524
    ``update_velocities_from_gas_drag`` + :1677-2015
    ``integrate_explicit_adaptive``).

    Batched form: ONE ``lax.while_loop`` advances all particles
    together, each carrying its own adaptive sub-step, error estimate and
    Lund-stabilized step-size controller; particles that finish their dt
    freeze until the last one converges. The step size and error-history
    factor persist per particle across hydro steps (reference
    src/particles/particle.h timestep/facold)."""
    r0 = state.r
    # --- explicit drag kick over the full dt (reference :1428-1505) ---
    gas = sample_gas(geom_np, g, rho, temperature, vrad, vaz,
                     omega_frame, r0, state.phi)
    vrel_r = state.r_dot - gas.vg_r
    vrel_phi = r0 * state.phi_dot - gas.vg_phi
    vrel = jnp.sqrt(vrel_r ** 2 + vrel_phi ** 2)
    ts_physical = calc_tstop(phys, constants, units, state.size, gas.rho,
                             vrel, gas.temperature, pp.density)
    r_dot = state.r_dot
    phi_dot = state.phi_dot
    if pp.gas_drag:
        r_dot = r_dot - dt * vrel_r / ts_physical
        phi_dot = phi_dot - dt * vrel_phi / (r0 * ts_physical)
    if pp.disk_gravity and sg_accel is not None:
        # disk gravity applied with the drag kick for the explicit
        # integrator (reference :1497-1504)
        sg_r, sg_t = sample_sg_accel(geom_np, sg_accel, r0, state.phi)
        r_dot = r_dot + dt * sg_r
        phi_dot = phi_dot + dt * sg_t / r0

    # --- adaptive RK45 on the gravity-only equations of motion ---
    # polar state (r, phi, rdot, phidot) or, with CartesianParticles,
    # (x, y, vx, vy) (reference particles.cpp:1680-1790: the same
    # Cash-Karp machinery over cartesian coordinates, which has no
    # coordinate singularity for plunging/eccentric particles)
    def f_polar(r, phi, rd, pd):
        r_safe = jnp.maximum(r, 1e-300)
        ag_r, l_dot = gravity_derivatives(constants, bodies, n_bodies,
                                          r_safe, phi)
        return (rd, pd, r_safe * pd * pd + ag_r,
                (-2.0 * rd * pd + l_dot / r_safe) / r_safe)

    def f_cart(x, y, vx, vy):
        r = jnp.maximum(jnp.hypot(x, y), 1e-300)
        phi = jnp.arctan2(y, x)
        ag_r, l_dot = gravity_derivatives(constants, bodies, n_bodies,
                                          r, phi)
        a_phi = l_dot / r
        cphi, sphi = x / r, y / r
        return (vx, vy, ag_r * cphi - a_phi * sphi,
                ag_r * sphi + a_phi * cphi)

    f = f_cart if pp.cartesian else f_polar

    # Cash-Karp tableau (reference :1838-1910)
    B = ((0.2,),
         (0.075, 0.225),
         (0.3, -0.9, 1.2),
         (-11.0 / 54.0, 2.5, -70.0 / 27.0, 35.0 / 27.0),
         (1631.0 / 55296.0, 175.0 / 512.0, 575.0 / 13824.0,
          44275.0 / 110592.0, 253.0 / 4096.0))
    C5 = (37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0,
          512.0 / 1771.0)
    E = (37.0 / 378.0 - 2825.0 / 27648.0, 0.0,
         250.0 / 621.0 - 18575.0 / 48384.0, 125.0 / 594.0 - 13525.0 / 55296.0,
         -277.0 / 14336.0, 512.0 / 1771.0 - 0.25)
    beta, fac1, fac2, safe = 0.04, 0.2, 10.0, 0.9
    expo1 = 0.2 - beta * 0.75
    facc1, facc2 = 1.0 / fac1, 1.0 / fac2
    atol, rtol = 1e-14, 1e-12

    def cond(c):
        return jnp.any(~c[-1])

    def body(c):
        (r, phi, rd, pd, t_acc, h, facold, reject, done) = c
        clamp = t_acc + h * 1.01 > dt
        ts = jnp.where(clamp, dt - t_acc, h)

        ks = [f(r, phi, rd, pd)]
        for row in B:
            rr = r + ts * sum(b * k[0] for b, k in zip(row, ks))
            pp_ = phi + ts * sum(b * k[1] for b, k in zip(row, ks))
            rdd = rd + ts * sum(b * k[2] for b, k in zip(row, ks))
            pdd = pd + ts * sum(b * k[3] for b, k in zip(row, ks))
            ks.append(f(rr, pp_, rdd, pdd))

        def comb(idx, coeffs):
            return sum(cc * k[idx] for cc, k in zip(coeffs, ks) if cc != 0.0)

        r_new = r + ts * comb(0, C5)
        phi_new = phi + ts * comb(1, C5)
        if not pp.cartesian:
            phi_new = jnp.mod(phi_new, 2.0 * jnp.pi)
        rd_new = rd + ts * comb(2, C5)
        pd_new = pd + ts * comb(3, C5)

        err = jnp.zeros_like(r)
        for idx, (old, new) in enumerate(((r, r_new), (phi, phi_new),
                                          (rd, rd_new), (pd, pd_new))):
            sk = atol + rtol * jnp.maximum(jnp.abs(old), jnp.abs(new))
            err = err + (ts * comb(idx, E) / sk) ** 2
        err = jnp.sqrt(err / 4.0)

        fac11 = err ** expo1
        fac = fac11 / facold ** beta
        fac = jnp.maximum(facc2, jnp.minimum(facc1, fac / safe))
        fac = jnp.where(clamp, jnp.maximum(fac, 1.0), fac)
        h_acc = h / fac
        accept = err <= 1.0
        # on a previous rejection don't let the accepted step grow
        h_acc = jnp.where(reject, jnp.minimum(jnp.abs(h_acc), jnp.abs(h)),
                          h_acc)
        h_rej = h / jnp.minimum(facc1, fac11 / safe)

        upd = accept & ~done
        r = jnp.where(upd, r_new, r)
        phi = jnp.where(upd, phi_new, phi)
        rd = jnp.where(upd, rd_new, rd)
        pd = jnp.where(upd, pd_new, pd)
        t_acc = jnp.where(upd, t_acc + ts, t_acc)
        facold = jnp.where(upd, jnp.maximum(err, 1e-4), facold)
        h = jnp.where(done, h, jnp.where(accept, h_acc, h_rej))
        done = done | (accept & clamp)
        reject = jnp.where(done, False, ~accept)
        return (r, phi, rd, pd, t_acc, h, facold, reject, done)

    if pp.cartesian:
        cphi, sphi = accurate_cos(state.phi), jnp.sin(state.phi)
        q0 = r0 * cphi
        q1 = r0 * sphi
        q2 = r_dot * cphi - r0 * phi_dot * sphi
        q3 = r_dot * sphi + r0 * phi_dot * cphi
    else:
        q0, q1, q2, q3 = r0, state.phi, r_dot, phi_dot
    zero = jnp.zeros_like(r0)
    # the step-size controller resumes from the persisted per-particle
    # step (reference particle.h timestep/facold); 0 = first step ever
    h0 = jnp.where((state.timestep > 0.0) & (state.timestep <= dt),
                   state.timestep, dt) if state.timestep is not None \
        else jnp.full_like(r0, dt)
    fac0 = state.facold if state.facold is not None \
        else jnp.full_like(r0, 1e-4)
    init = (q0, q1, q2, q3, zero, h0, fac0,
            jnp.zeros_like(state.alive), ~state.alive)
    q0, q1, q2, q3, _t, h3, fac3, *_ = jax.lax.while_loop(cond, body, init)

    if pp.cartesian:
        r3 = jnp.hypot(q0, q1)
        phi3 = jnp.mod(jnp.arctan2(q1, q0), 2.0 * jnp.pi)
        r_safe = jnp.maximum(r3, 1e-300)
        rd3 = (q0 * q2 + q1 * q3) / r_safe
        pd3 = (q0 * q3 - q1 * q2) / (r_safe * r_safe)
    else:
        r3, phi3, rd3, pd3 = q0, q1, q2, q3

    omega_k = jnp.sqrt(constants.G * phys.hydro_center_mass / r3 ** 3)
    alive = state.alive & (r3 > pp.min_escape_radius) \
        & (r3 < pp.max_escape_radius)

    def keep(new, old):
        return jnp.where(alive, new, old)

    return state.replace(
        r=keep(r3, state.r), phi=keep(phi3, state.phi),
        r_dot=keep(rd3, state.r_dot), phi_dot=keep(pd3, state.phi_dot),
        stokes=keep(ts_physical * omega_k, state.stokes), alive=alive,
        timestep=keep(h3, state.timestep) if state.timestep is not None
        else state.timestep,
        facold=keep(fac3, state.facold) if state.facold is not None
        else state.facold)


# ---------------------------------------------------------------------------
# stochastic dust diffusion
# ---------------------------------------------------------------------------

def schmidt_number(St):
    """Youdin & Lithwick 2007 eq. 37."""
    st2 = St * St
    return (1.0 + st2) ** 2 / (1.0 + 4.0 * st2)


def diffuse_dust(phys: Physics, constants, geom_np, g: Geom,
                 state: ParticleState, rho, cs, scale_height, dt):
    """Brownian radial kicks (reference dust_diffusion.cpp:30-76,
    Charnoz et al. 2011 eq. 17/21). Uses counter-based jax.random in place
    of the reference's per-thread JSF64 generators — same distributions,
    reproducible under jit."""
    key, sub = jax.random.split(state.rng_key)
    rmed = jnp.asarray(geom_np.rmed, state.r.dtype)
    naz = g.naz
    r, phi = state.r, state.phi
    # gas diffusion coefficient Dg = alpha cs H (cell values, no interp)
    h_grid = scale_height * g.inv_rb
    dg_grid = phys.viscous_alpha * cs * h_grid * g.rb
    # radial density derivative (cell-centered finite differences);
    # jnp.gradient so the rmed spacing also traces when it is a sharded
    # window array (constant-folded to the numpy result otherwise)
    drho_dr_grid = jnp.gradient(rho, axis=0) \
        / jnp.gradient(jnp.asarray(geom_np.rmed, rho.dtype))[:, None]
    # all three fields share layout: one patch gather
    Dg, rho_p, drho_dr = interpolate_many(
        (dg_grid, rho, drho_dr_grid), geom_np.rmed, r, phi, naz)

    Sc = schmidt_number(state.stokes)
    Dd = Dg / Sc
    omega_k = jnp.sqrt(constants.G * phys.hydro_center_mass / r ** 3)
    mean = Dd / rho_p * drho_dr * dt * dt * omega_k
    sigma = jnp.sqrt(2.0 * Dd * dt)
    snv = jax.random.normal(sub, r.shape, r.dtype)
    corr_2d = r * (jnp.sqrt(1.0 + (sigma * snv / r) ** 2) - 1.0)
    deltar = mean + snv * sigma + corr_2d
    rnew = r + deltar
    phi_dot = state.phi_dot * (r / rnew) ** 1.5
    return state.replace(r=rnew, phi_dot=phi_dot, rng_key=key)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_particles(n: int, rmin: float, rmax: float, slope: float,
                   sizes, GM: float, eccentricity: float = 0.0,
                   seed: int = 1337, dtype=jnp.float64,
                   radii_explicit=None) -> ParticleState:
    """Particles on near-Keplerian orbits with a power-law radial
    distribution (reference src/particles/particles.cpp:516-723)."""
    rng = np.random.default_rng(seed)
    if radii_explicit is not None:
        r = np.asarray(radii_explicit, np.float64)
    else:
        # inverse-CDF sampling of dN/dr ~ r^-slope on [rmin, rmax]
        u_ = rng.random(n)
        if abs(slope - 1.0) < 1e-12:
            r = rmin * (rmax / rmin) ** u_
        else:
            p = 1.0 - slope
            r = (rmin ** p + u_ * (rmax ** p - rmin ** p)) ** (1.0 / p)
    phi = rng.random(n) * 2.0 * np.pi
    ecc = rng.random(n) * eccentricity
    v_k = np.sqrt(GM / r)
    # start at apocenter of the eccentric orbit
    vphi = v_k * np.sqrt(np.maximum(1.0 - ecc, 0.0) / (1.0 + ecc))
    sizes = np.broadcast_to(np.asarray(sizes, np.float64), (n,))
    return ParticleState(
        r=jnp.asarray(r, dtype), phi=jnp.asarray(phi, dtype),
        r_dot=jnp.zeros(n, dtype),
        phi_dot=jnp.asarray(vphi / r, dtype),
        size=jnp.asarray(sizes, dtype),
        stokes=jnp.zeros(n, dtype),
        alive=jnp.ones(n, bool),
        rng_key=jax.random.PRNGKey(seed),
        timestep=jnp.zeros(n, dtype),
        facold=jnp.full(n, 1e-4, dtype))
