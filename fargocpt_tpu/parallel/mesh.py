"""Multi-device distribution: radial 1-D device mesh.

Replacement for the reference's MPI radial domain decomposition
(src/split.cpp:21-397, src/commbound.cpp:45-182): every (NR, NAZ) field is
sharded along the radial axis over a ``jax.sharding.Mesh``; the stencil
shifts inside the jitted step make XLA insert neighbor collective-permutes
between devices (the halo exchange), the CFL min becomes a cross-shard reduce,
and the FARGO integer shift rides the unsharded azimuthal axis with zero
communication.

This module provides the mesh + sharding helpers; the step functions are
sharding-agnostic (they act on global-view arrays; GSPMD partitions them).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RADIAL_AXIS = "r"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the radial axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RADIAL_AXIS,))


def field_sharding(mesh: Mesh) -> NamedSharding:
    """(NR, NAZ) arrays: radial axis sharded, azimuthal replicated-local."""
    return NamedSharding(mesh, P(RADIAL_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_fields(fields, mesh: Mesh, nrad: int | None = None):
    """Place a FieldState on the mesh, radial-sharded.

    v_rad has NR+1 rows, which cannot be evenly partitioned at the jit
    boundary, so it enters replicated; GSPMD still computes on it
    shard-wise inside the step. The explicit shard_map halo-exchange path
    (parallel/shard_step.ShardedHydroStep) carries true sharded face slabs
    instead — prefer it for production multi-device runs.

    Any other grid leaf whose leading dim is not divisible by the device
    count is replicated WITH A LOUD WARNING: a replicated "sharded" run
    computes redundantly on every device and will not scale. Pass ``nrad``
    to distinguish the expected vrad case (NR+1 rows) from a genuinely
    indivisible grid."""
    import warnings
    sh = field_sharding(mesh)
    rep = replicated(mesh)
    n = mesh.devices.size

    def place(x):
        if x.ndim >= 2 and x.shape[0] % n == 0:
            return jax.device_put(x, sh)
        if x.ndim >= 2 and x.shape[0] > n and not (
                nrad is not None and x.shape[0] == nrad + 1):
            warnings.warn(
                f"shard_fields: leading dim {x.shape[0]} not divisible by "
                f"{n} devices — replicating this field (it will not "
                "scale); pick Nrad divisible by the device count or use "
                "parallel.shard_step for true slabs", stacklevel=3)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, fields)


def shard_state(state, mesh: Mesh):
    """Place a full SystemState on the mesh: grid fields radial-sharded,
    body arrays and scalars replicated."""
    nrad = None
    try:
        nrad = int(state.fields.sigma.shape[0])
    except AttributeError:
        pass
    return shard_fields(state, mesh, nrad=nrad)


# backwards-compatible alias
shard_aux = shard_state
