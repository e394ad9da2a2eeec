"""FARGO transport: operator-split van Leer upwind advection with the
fast-orbital-advection azimuthal splitting (Masset 2000).

Re-derivation of reference src/TransportEuler.cpp:112-685, restructured
for XLA:

  * All advected quantities (radial/angular momenta, energy, density) are
    stacked into one (K, NR, NAZ) tensor so each sweep is a single fused
    kernel chain instead of K separate passes over device memory.
  * The per-ring integer-cell azimuthal roll (``AdvectSHIFT``) is
    decomposed into O(log NAZ) static rolls + selects on the shift's
    binary digits (no gather).
  * The reference's "density MUST be advected last" aliasing constraint
    (src/TransportEuler.cpp:161,303) disappears: all quantities divide by
    the same pre-sweep density snapshot by construction.

All helpers are pure and operate on trailing (NR, NAZ) axes so they work
batched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import Physics
from .common import Geom, flux_limiter


def _next(x):
    return jnp.roll(x, -1, axis=-1)


def _prev(x):
    return jnp.roll(x, 1, axis=-1)


def star_radial(phys: Physics, g: Geom, q: jax.Array, vrad: jax.Array,
                dt) -> jax.Array:
    """Upwind face values of cell-centered q (reference
    src/TransportEuler.cpp:349-406 ``compute_star_radial``).

    q: (..., NR, NAZ); vrad: (NR+1, NAZ). Returns (..., NR+1, NAZ); face
    rows 0 and NR are zero (no flux through the domain-edge faces).
    """
    nr = g.nrad
    kind = phys.flux_limiter_type
    dqm = (q[..., 1:-1, :] - q[..., :-2, :]) * g.inv_diff_rmed[1:nr - 1]
    dqp = (q[..., 2:, :] - q[..., 1:-1, :]) * g.inv_diff_rmed[2:nr]
    dq_mid = flux_limiter(dqp, dqm, kind)
    zrow = jnp.zeros_like(q[..., :1, :])
    dq = jnp.concatenate([zrow, dq_mid, zrow], axis=-2)      # (..., NR, NAZ)

    rme = g.rmed_ext                                          # (NR+1,1)
    dr_minus = rme[1:nr] - rme[:nr - 1]                       # face f: Rmed[f]-Rmed[f-1]
    dr_plus = rme[2:nr + 1] - rme[1:nr]                       # face f: Rmed[f+1]-Rmed[f]
    vf = vrad[1:nr]                                           # faces 1..NR-1
    up = q[..., :-1, :] + (dr_minus - vf * dt) * 0.5 * dq[..., :-1, :]
    dn = q[..., 1:, :] - (dr_plus + vf * dt) * 0.5 * dq[..., 1:, :]
    qs_mid = jnp.where(vf > 0.0, up, dn)
    zface = jnp.zeros_like(qs_mid[..., :1, :])
    return jnp.concatenate([zface, qs_mid, zface], axis=-2)


def star_theta(phys: Physics, g: Geom, q: jax.Array, v: jax.Array,
               dt) -> jax.Array:
    """Azimuthal upwind interface values (reference
    src/TransportEuler.cpp:416-466 ``ComputeStarTheta``). Interface j sits
    between cells j-1 and j. Batched over leading axes."""
    kind = phys.flux_limiter_type
    dxtheta = g.dphi * g.rb
    dqm = q - _prev(q)
    dqp = _next(q) - q
    dq = 0.5 * flux_limiter(dqp, dqm, kind) / dxtheta
    ksi = v * dt
    up = _prev(q) + (dxtheta - ksi) * _prev(dq)
    dn = q - (dxtheta + ksi) * dq
    return jnp.where(ksi > 0.0, up, dn)


def van_leer_radial_batch(phys: Physics, g: Geom, qs, sig_int, density_star,
                          vrad, dt):
    """Advect a stack of quantities radially in specific form (reference
    src/TransportEuler.cpp:545-620). qs: (K, NR, NAZ).
    Returns (qs_new, face_flux) with face_flux: (K, NR+1, NAZ)."""
    work = qs / sig_int
    qrstar = star_radial(phys, g, work, vrad, dt)
    flux = dt * g.dphi * g.ra * qrstar * density_star * vrad
    qs_new = qs + (flux[..., :-1, :] - flux[..., 1:, :]) * g.inv_surf
    return qs_new, flux


def van_leer_theta_batch(phys: Physics, g: Geom, qs, sig_int, density_star,
                         v, dt):
    """Advect a stack azimuthally in specific form (reference
    src/TransportEuler.cpp:630-664)."""
    work = qs / sig_int
    qrstar = star_theta(phys, g, work, v, dt)
    f = (g.rsup - g.rinf) * dt * qrstar * density_star * v
    return qs + (f - _next(f)) * g.inv_surf


def advect_shift(q: jax.Array, nshift: jax.Array) -> jax.Array:
    """Exact integer-cell azimuthal roll per ring — the FARGO trick
    (reference src/TransportEuler.cpp:238-268 ``AdvectSHIFT``).

    Formulation: decompose the per-ring shift into its binary digits and
    apply O(log NAZ) static full-array rolls with per-ring selects (no
    gather).

    q: (..., NR, NAZ); nshift: (NR,) int32. out[.., i, j] = q[.., i, (j - s_i) mod NAZ].
    """
    naz = q.shape[-1]
    s = jnp.mod(nshift, naz).astype(jnp.int32)               # (NR,)
    sel = s[:, None]                                         # (NR,1)
    nbits = max(1, (naz - 1).bit_length())
    out = q
    for b in range(nbits):
        amount = 1 << b
        rolled = jnp.roll(out, amount, axis=-1)
        take = (sel >> b) & 1
        out = jnp.where(take == 1, rolled, out)
    return out


def compute_momenta(g: Geom, sigma, vrad, vaz, omega_frame):
    """reference src/TransportEuler.cpp:471-493."""
    rp = sigma * vrad[1:]
    rm = sigma * vrad[:-1]
    corot = g.rb * omega_frame
    ap = sigma * (_next(vaz) + corot) * g.rb
    am = sigma * (vaz + corot) * g.rb
    return rp, rm, ap, am


def velocities_from_momenta(g: Geom, sigma, rp, rm, ap, am, vrad_old,
                            omega_frame):
    """reference src/TransportEuler.cpp:498-535. v_rad row 0 is zeroed,
    row NR keeps its previous value (the reference loop stops at NR-1)."""
    nr = g.nrad
    vr_mid = (rp[:-1] + rm[1:]) / (sigma[:-1] + sigma[1:])   # faces 1..NR-1
    vrad = jnp.concatenate(
        [jnp.zeros_like(vr_mid[:1]), vr_mid, vrad_old[nr:]], axis=0)
    vaz = (_prev(ap) + am) / (_prev(sigma) + sigma) * g.inv_rb \
        - g.rb * omega_frame
    return vrad, vaz


def transport(phys: Physics, g: Geom, sigma, vrad, vaz, energy,
              omega_frame, dt):
    """Full FARGO transport substep (reference src/TransportEuler.cpp:112-136
    ``Transport`` + OneWindRad + OneWindTheta).

    Returns (sigma, vrad, vaz, energy, mass_flux) where mass_flux is the
    radial mass flux through faces (monitoring)."""
    adiabatic = phys.is_adiabatic
    k_quant = 6 if adiabatic else 5
    k_sigma = k_quant - 1

    # ---- radial sweep (OneWindRad, reference :138-167) ----
    density_star = star_radial(phys, g, sigma, vrad, dt)
    rp, rm, ap, am = compute_momenta(g, sigma, vrad, vaz, omega_frame)
    names = [rp, rm, ap, am] + ([energy] if adiabatic else []) + [sigma]
    qs = jnp.stack(names, axis=0)                            # (K, NR, NAZ)
    # compile-time guard (see step.py): keep the simplifier from relating
    # the momenta construction to the post-sweep velocity reconstruction
    qs = jax.lax.optimization_barrier(qs)
    qs, flux = van_leer_radial_batch(phys, g, qs, sigma, density_star,
                                     vrad, dt)
    mass_flux = flux[k_sigma]

    # ---- azimuthal sweep (OneWindTheta, reference :270-288) ----
    vmean = jnp.mean(vaz, axis=-1, keepdims=True)            # (NR,1)
    vres = vaz - vmean
    ntilde = vmean * g.inv_rb * dt * g.invdphi               # (NR,1)
    nround = jnp.floor(ntilde + 0.5)
    nshift = nround.astype(jnp.int32)[:, 0]                  # (NR,)
    vconst_row = (ntilde - nround) * g.rb * g.dphi / dt      # (NR,1)

    if not phys.fast_transport:
        # standard advection: fold the constant residual into vres and skip
        # the uniform pass (reference :225-235 NoSplitAdvection)
        vres = vres + vconst_row
        passes = [vres]
    else:
        passes = [vres, jnp.broadcast_to(vconst_row, vres.shape)]

    for v in passes:
        sig_now = qs[k_sigma]
        density_star = star_theta(phys, g, sig_now, v, dt)
        qs = van_leer_theta_batch(phys, g, qs, sig_now, density_star, v, dt)
    # integer shift (the FARGO roll), all quantities at once
    qs = advect_shift(qs, nshift)

    rp, rm, ap, am = qs[0], qs[1], qs[2], qs[3]
    if adiabatic:
        energy = qs[4]
    sigma = qs[k_sigma]

    vrad, vaz = velocities_from_momenta(g, sigma, rp, rm, ap, am, vrad,
                                        omega_frame)
    return sigma, vrad, vaz, energy, mass_flux
