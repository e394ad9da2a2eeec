"""Shared building blocks for the hydro kernels.

The kernels operate on global (NR, NAZ) arrays in pure jnp; under jit XLA
fuses the chains. Azimuthal neighbor access is periodic (``jnp.roll``);
radial neighbor access uses static slices, so every op lowers to
shift+elementwise chains that XLA fuses into a handful of HBM passes.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Geometry


def azim_prev(x: jax.Array) -> jax.Array:
    """x[i, j-1] with periodic wrap."""
    return jnp.roll(x, 1, axis=-1)


def azim_next(x: jax.Array) -> jax.Array:
    """x[i, j+1] with periodic wrap."""
    return jnp.roll(x, -1, axis=-1)


def accurate_cos(angle):
    """cos via the half-angle identity 1 - 2 sin^2(x/2).

    Equal to ``jnp.cos`` to rounding on every backend.  It stays on the
    trajectory-coupled paths (frame rotation, boundary and dust geometry)
    because swapping it for ``jnp.cos`` would move float64 results in the
    last bits."""
    s = jnp.sin(0.5 * angle)
    return 1.0 - 2.0 * s * s


def van_leer_lim(a: jax.Array, b: jax.Array) -> jax.Array:
    """Harmonic-mean (van Leer) slope limiter
    (reference src/TransportEuler.cpp:306-312)."""
    prod = a * b
    denom = a + b
    safe = jnp.where(prod > 0.0, denom, 1.0)
    return jnp.where(prod > 0.0, 2.0 * prod / safe, 0.0)


def minmod(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.where(a * b > 0.0,
                     jnp.where(jnp.abs(a) < jnp.abs(b), a, b), 0.0)


def mc_lim(a: jax.Array, b: jax.Array) -> jax.Array:
    """Monotonized-central limiter (reference src/TransportEuler.cpp:321-323)."""
    return minmod(0.5 * (a + b), 2.0 * minmod(a, b))


def flux_limiter(a: jax.Array, b: jax.Array, kind: int) -> jax.Array:
    if kind == 1:
        return mc_lim(a, b)
    return van_leer_lim(a, b)


@dataclass(frozen=True)
class Geom:
    """Device-ready geometry: column vectors (NR,1)/(NR+1,1) of the run dtype
    so they broadcast directly against (NR, NAZ) fields and are baked into
    the jitted step as constants."""

    rb: jax.Array               # (NR,1)  cell-center radii (Rmed)
    inv_rb: jax.Array           # (NR,1)
    ra: jax.Array               # (NR+1,1) face radii
    inv_ra: jax.Array           # (NR+1,1)
    rinf: jax.Array             # (NR,1)
    rsup: jax.Array             # (NR,1)
    rmed_ext: jax.Array         # (NR+1,1)
    inv_diff_rmed: jax.Array    # (NR+1,1)
    inv_diff_rsup: jax.Array    # (NR,1)
    inv_diff_rsup_rb: jax.Array # (NR,1)
    two_diff_ra_sq: jax.Array   # (NR,1)
    four_third_inv_rb_invdphi_sq: jax.Array  # (NR,1)
    surf: jax.Array             # (NR,1)
    inv_surf: jax.Array         # (NR,1)
    dphi: float
    invdphi: float
    nrad: int
    naz: int


def prepare_geom(geometry: Geometry, dtype) -> Geom:
    def col(a: np.ndarray) -> jnp.ndarray:
        return jnp.asarray(a, dtype=dtype)[:, None]

    return Geom(
        rb=col(geometry.rmed),
        inv_rb=col(geometry.inv_rmed),
        ra=col(geometry.ra),
        inv_ra=col(geometry.inv_rinf),
        rinf=col(geometry.rinf),
        rsup=col(geometry.rsup),
        rmed_ext=col(geometry.rmed_ext),
        inv_diff_rmed=col(geometry.inv_diff_rmed),
        inv_diff_rsup=col(geometry.inv_diff_rsup),
        inv_diff_rsup_rb=col(geometry.inv_diff_rsup_rb),
        two_diff_ra_sq=col(geometry.two_diff_ra_sq),
        four_third_inv_rb_invdphi_sq=col(geometry.four_third_inv_rb_invdphi_sq),
        surf=col(geometry.surf),
        inv_surf=col(geometry.inv_surf),
        dphi=float(geometry.dphi),
        invdphi=float(geometry.invdphi),
        nrad=geometry.nrad,
        naz=geometry.naz,
    )


def set_rows(x: jax.Array, new: jax.Array, lo: int, hi: int) -> jax.Array:
    """Return x with rows [lo, hi) replaced by the matching rows of ``new``
    (both arrays full-size). Static slice => fuses cleanly."""
    return jnp.concatenate([x[:lo], new[lo:hi], x[hi:]], axis=0)
