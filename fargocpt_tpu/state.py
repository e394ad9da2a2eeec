"""Simulation state pytrees.

``FieldState`` replaces the mutable ``t_data`` registry of the reference
(src/data.h:12-141) with an immutable pytree of the *prognostic* fields
only; everything the reference stores as scratch grids (pressure, sound
speed, stress tensors, Q+, Q-, ...) is recomputed inside the fused jitted
step, which is both simpler and faster (XLA fuses the chains and keeps
intermediates on chip instead of round-tripping device memory).

Shapes:
  * sigma, energy, vaz: (NR, NAZ)   — cell-centered (ring 0 / NR-1 ghost)
  * vrad:               (NR+1, NAZ) — radial-face-centered
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FieldState:
    sigma: jax.Array
    vrad: jax.Array
    vaz: jax.Array
    energy: jax.Array

    def replace(self, **kw) -> "FieldState":
        from dataclasses import replace as _replace
        return _replace(self, **kw)

    @property
    def dtype(self):
        return self.sigma.dtype

    def block_until_ready(self) -> "FieldState":
        jax.block_until_ready((self.sigma, self.vrad, self.vaz, self.energy))
        return self


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RefFrame:
    """Rotating-frame bookkeeping (reference src/frame_of_reference.cpp)."""
    omega_frame: jax.Array   # scalar
    frame_angle: jax.Array   # scalar

    def replace(self, **kw) -> "RefFrame":
        from dataclasses import replace as _replace
        return _replace(self, **kw)


def make_ref_frame(omega: float = 0.0, angle: float = 0.0,
                   dtype=jnp.float64) -> RefFrame:
    return RefFrame(omega_frame=jnp.asarray(omega, dtype),
                    frame_angle=jnp.asarray(angle, dtype))


def zeros(nrad: int, naz: int, dtype=jnp.float64) -> FieldState:
    return FieldState(
        sigma=jnp.zeros((nrad, naz), dtype),
        vrad=jnp.zeros((nrad + 1, naz), dtype),
        vaz=jnp.zeros((nrad, naz), dtype),
        energy=jnp.zeros((nrad, naz), dtype),
    )
