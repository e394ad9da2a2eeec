"""Radially sharded dust particles with ppermute boundary migration.

Rebuild of the reference's distributed particle swarm
(src/particles/particles.cpp:259-420 per-rank ownership by radial
domain, :2016-2160 ``move`` — the two-phase inward/outward MPI migration
sweep): each device of the 1-D radial mesh owns the particles whose
radius falls inside its slab, stores them in a FIXED-CAPACITY slot
bucket (XLA needs static shapes — the reference reallocates
``particles_size`` dynamically, :2062), integrates them against its own
extended-window gas fields, and after each step exchanges
boundary-crossers with its two neighbors through one stacked
bidirectional ``lax.ppermute`` pair of fixed-size migration buffers.

This replaces the round-1..4 replicated-swarm design that all_gathered
four full gas slabs per step (shard_step.py ``_gather_fields``): per-step
inter-device traffic drops from 4 slab gathers (~MB, growing with mesh size) to
two (F, E)-sized buffers (~KB, constant), and per-particle work is no
longer duplicated n ways.

Slot conventions:
  * ``valid``  — slot holds a particle (live or frozen escaper)
  * ``alive``  — particle still integrates (ParticleState semantics);
    escapers freeze in place with ``alive=False`` and never migrate
  * ``pid``    — original swarm index, preserved across migrations so
    gather() restores the canonical order (the reference tracks
    ``particle.id`` for the same reason, src/particles/particle.h)
  * empty slots carry benign physical values (r = slab center) so the
    vectorized drag/gravity math stays finite; they are masked out of
    every update by ``alive=False``.

Capacity: per-shard ``C = max_k count_k(t=0) * margin`` (margin 1.5,
``FARGOCPT_TPU_PARTICLE_SLOT_MARGIN``). Migration buffers hold
``E = max(64, C // 8)`` (``FARGOCPT_TPU_PARTICLE_XCHG``) particles per
direction per step. Overflow of either drops particles and counts them
in ``overflow`` (psum-able diagnostic) — the reference instead pays a
dynamic realloc + variable-size MPI messages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .dust import ParticleState

# per-particle payload fields exchanged on migration, in buffer order
_FIELDS = ("r", "phi", "r_dot", "phi_dot", "size", "stokes",
           "timestep", "facold")


class WindowGeom:
    """The slice of grid geometry the particle kernels sample from: cell
    centers (rmed) and interface radii (radii) of one shard's extended
    window (duck-types fargocpt_tpu.grid.Geometry for dust.py)."""

    def __init__(self, rmed, radii):
        self.rmed = rmed
        self.radii = radii


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedParticles:
    """Slot-bucket particle state over the radial mesh.

    All (n*C,) leaves are sharded P("r"); ``rng_key`` is (n, 2) so each
    shard owns an independent counter-based key chain (the analog of the
    reference's per-rank JSF64 generators, dust_diffusion.cpp:21-28);
    ``overflow`` counts particles dropped by capacity limits."""
    r: jax.Array
    phi: jax.Array
    r_dot: jax.Array
    phi_dot: jax.Array
    size: jax.Array
    stokes: jax.Array
    timestep: jax.Array
    facold: jax.Array
    alive: jax.Array        # bool (n*C,)
    valid: jax.Array        # bool (n*C,)
    pid: jax.Array          # int32 (n*C,)
    rng_key: jax.Array      # uint32 (n, 2)
    overflow: jax.Array     # int32 (n,)

    def replace(self, **kw) -> "ShardedParticles":
        from dataclasses import replace as _replace
        return _replace(self, **kw)


def slot_capacity(counts, margin=None):
    """Per-shard slot count from the initial per-slab census."""
    if margin is None:
        margin = float(os.environ.get(
            "FARGOCPT_TPU_PARTICLE_SLOT_MARGIN", 1.5))
    c = int(np.ceil(max(int(np.max(counts)), 1) * margin))
    return max(c, 16)


def exchange_capacity(C):
    e = int(os.environ.get("FARGOCPT_TPU_PARTICLE_XCHG", 0))
    return e if e > 0 else max(64, C // 8)


def shard_particles(ps: ParticleState, n: int, L: int,
                    radii: np.ndarray, margin=None):
    """Host-side bucketing of a plain swarm into per-shard slots.

    ``radii``: interface radii (NR+1,); shard k owns rings kL..(k+1)L-1,
    i.e. radius interval [radii[kL], radii[(k+1)L]) — with the domain
    edges opened to +-inf so escapers frozen outside [RMIN, RMAX] stay
    bucketed on the edge shards.

    Returns (ShardedParticles with (n*C,) numpy-backed leaves, C,
    bounds) where bounds[k] = (own_lo, own_hi)."""
    r = np.asarray(ps.r)
    N = r.shape[0]
    dtype = np.asarray(ps.r).dtype
    edges = np.asarray([radii[k * L] for k in range(n + 1)], np.float64)
    lo = edges[:-1].copy()
    hi = edges[1:].copy()
    lo[0], hi[-1] = -np.inf, np.inf
    shard_of = np.clip(np.searchsorted(edges, r, side="right") - 1, 0, n - 1)
    counts = np.bincount(shard_of, minlength=n)
    C = slot_capacity(counts, margin)
    if np.max(counts) > C:
        raise ValueError(f"particle slot capacity {C} below initial "
                         f"census {counts.max()}")

    def empty(fill, dt):
        return np.full(n * C, fill, dt)

    out = {name: empty(0.0, dtype) for name in _FIELDS}
    alive = empty(False, bool)
    valid = empty(False, bool)
    pid = empty(-1, np.int32)
    # benign placeholder radius per shard (slab center) for empty slots
    centers = 0.5 * (np.clip(lo, radii[0], radii[-1])
                     + np.clip(hi, radii[0], radii[-1]))
    for k in range(n):
        out["r"][k * C:(k + 1) * C] = centers[k]
        out["phi"][k * C:(k + 1) * C] = 0.0
        out["size"][k * C:(k + 1) * C] = 1.0
    fill = np.zeros(n, np.int64)
    order = np.argsort(shard_of, kind="stable")
    for p in order:
        k = shard_of[p]
        slot = k * C + fill[k]
        fill[k] += 1
        for name in _FIELDS:
            out[name][slot] = np.asarray(getattr(ps, name))[p] \
                if getattr(ps, name) is not None else 0.0
        alive[slot] = bool(np.asarray(ps.alive)[p])
        valid[slot] = True
        pid[slot] = p
    base = np.asarray(ps.rng_key, np.uint32)
    keys = np.stack([np.asarray(
        jax.random.fold_in(jnp.asarray(base, jnp.uint32), k), np.uint32)
        for k in range(n)])
    sp = ShardedParticles(
        **{name: jnp.asarray(out[name]) for name in _FIELDS},
        alive=jnp.asarray(alive), valid=jnp.asarray(valid),
        pid=jnp.asarray(pid), rng_key=jnp.asarray(keys),
        overflow=jnp.zeros(n, jnp.int32))
    bounds = np.stack([lo, hi], axis=1)
    return sp, C, bounds


def gather_particles(sp: ShardedParticles, n_total: int,
                     template: ParticleState) -> ParticleState:
    """Slot buckets -> plain swarm in canonical pid order (host-side;
    used for snapshots/diagnostics)."""
    pid = np.asarray(sp.pid)
    valid = np.asarray(sp.valid)
    sel = valid & (pid >= 0)
    idx = pid[sel]
    dtype = np.asarray(sp.r).dtype

    def scatter(src, fill, dt):
        out = np.full(n_total, fill, dt)
        out[idx] = np.asarray(src)[sel]
        return out

    kw = {name: jnp.asarray(scatter(getattr(sp, name), 0.0, dtype))
          for name in _FIELDS}
    alive = scatter(sp.alive, False, bool)
    # particles dropped by capacity overflow vanish from the swarm:
    # report them dead at their last-known radius default
    return template.replace(
        alive=jnp.asarray(alive),
        rng_key=jnp.asarray(np.asarray(sp.rng_key)[0], np.uint32),
        **kw)


# ---------------------------------------------------------------------
# in-step migration (runs inside shard_map, static shapes only)
# ---------------------------------------------------------------------

def _pack(mask, arrs, E):
    """Compress masked rows of each (C,) array into an (E,) buffer
    (first-fit by slot order); returns (buffers, used, n_dropped)."""
    idx = jnp.cumsum(mask.astype(jnp.int32)) - 1          # dest slot
    ok = mask & (idx < E)
    dest = jnp.where(ok, idx, E)                          # E = spill row
    bufs = []
    for a in arrs:
        pad = jnp.zeros((E + 1,), a.dtype)
        bufs.append(pad.at[dest].set(jnp.where(ok, a, pad[0]),
                                     mode="drop")[:E])
    used = jnp.zeros((E + 1,), bool).at[dest].set(ok, mode="drop")[:E]
    dropped = jnp.sum(mask) - jnp.sum(ok)
    return bufs, used, dropped


def _merge(free, arrs, bufs, used, E):
    """Scatter the used buffer rows into free slots; returns (updated
    arrays, taken mask, n_dropped)."""
    C = free.shape[0]
    # the i-th used buffer row goes to the i-th free slot
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1    # rank per slot
    buf_rank = jnp.cumsum(used.astype(jnp.int32)) - 1     # rank per row
    n_free = jnp.sum(free)
    ok = used & (buf_rank < n_free)
    # dest slot index for each buffer row: position of free slot with
    # rank == buf_rank. Build the inverse map free_slots[rank] = slot.
    slot_ids = jnp.where(free, free_rank, C)
    free_slots = jnp.zeros((C + 1,), jnp.int32).at[slot_ids].set(
        jnp.arange(C, dtype=jnp.int32), mode="drop")
    dest = jnp.where(ok, free_slots[jnp.clip(buf_rank, 0, C - 1)], C)
    out = []
    for a, b in zip(arrs, bufs):
        pad = jnp.concatenate([a, jnp.zeros((1,), a.dtype)])
        out.append(pad.at[dest].set(jnp.where(ok, b, 0), mode="drop")[:C])
    taken = jnp.zeros((C + 1,), bool).at[dest].set(ok, mode="drop")[:C]
    dropped = jnp.sum(used) - jnp.sum(ok)
    return out, taken, dropped


def migrate(sp_local: dict, own_lo, own_hi, is_top, is_bot, E: int,
            axis_name: str, n_shards: int):
    """One migration sweep for this shard's (C,)-sized slot arrays.

    ``sp_local`` maps field name -> (C,) array (including alive, valid,
    pid, overflow scalar). Particles with r outside [own_lo, own_hi)
    are packed into an up/down buffer, ppermuted to the neighbor, and
    merged into free slots (the reference's two-phase send loop,
    src/particles/particles.cpp:2016-2160, as one stacked exchange).
    Edge shards never send outward past the domain (escapers are dead
    and excluded by ``alive``)."""
    r = sp_local["r"]
    valid = sp_local["valid"]
    alive = sp_local["alive"]
    movable = valid & alive
    send_up = movable & (r >= own_hi) & (is_top < 0.5)
    send_dn = movable & (r < own_lo) & (is_bot < 0.5)

    # float payload + an int32 side channel (pid, alive, used) — pid must
    # not round-trip through the particle dtype
    payload = [sp_local[name] for name in _FIELDS]
    ichan = [sp_local["pid"],
             sp_local["alive"].astype(jnp.int32)]
    up_bufs, up_used, up_drop = _pack(send_up, payload, E)
    dn_bufs, dn_used, dn_drop = _pack(send_dn, payload, E)
    up_int, up_used_i, _ = _pack(send_up, ichan, E)
    dn_int, dn_used_i, _ = _pack(send_dn, ichan, E)
    del up_used_i, dn_used_i  # identical to up_used/dn_used

    # one stacked bidirectional exchange pair per dtype: (F, E) floats
    # and (3, E) int32 each way
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    up_stack = jnp.stack(up_bufs)
    dn_stack = jnp.stack(dn_bufs)
    up_istack = jnp.stack(up_int + [up_used.astype(jnp.int32)])
    dn_istack = jnp.stack(dn_int + [dn_used.astype(jnp.int32)])
    from_below = jax.lax.ppermute(up_stack, axis_name, fwd)
    from_above = jax.lax.ppermute(dn_stack, axis_name, bwd)
    from_below_i = jax.lax.ppermute(up_istack, axis_name, fwd)
    from_above_i = jax.lax.ppermute(dn_istack, axis_name, bwd)

    sent = send_up | send_dn
    valid = valid & ~sent
    arrs = [jnp.where(sent, jnp.zeros_like(a), a) for a in payload]
    pid = jnp.where(valid, sp_local["pid"], -1)
    alive = alive & valid

    free = ~valid
    rx1_used = from_below_i[2] > 0
    arrs_i1 = [pid, alive.astype(jnp.int32)]
    out1, taken1, drop1 = _merge(free, arrs + arrs_i1,
                                 [from_below[i] for i in range(len(payload))]
                                 + [from_below_i[0], from_below_i[1]],
                                 rx1_used, E)
    arrs, pid, alive_i = out1[:len(payload)], out1[-2], out1[-1]
    free = free & ~taken1
    rx2_used = from_above_i[2] > 0
    out2, taken2, drop2 = _merge(free, arrs + [pid, alive_i],
                                 [from_above[i] for i in range(len(payload))]
                                 + [from_above_i[0], from_above_i[1]],
                                 rx2_used, E)
    arrs, pid, alive_i = out2[:len(payload)], out2[-2], out2[-1]
    valid = valid | taken1 | taken2

    out = dict(sp_local)
    for name, a in zip(_FIELDS, arrs):
        out[name] = a
    out["alive"] = (alive_i > 0) & valid
    out["pid"] = jnp.where(valid, pid, -1)
    out["valid"] = valid
    out["overflow"] = sp_local["overflow"] + (
        up_drop + dn_drop + drop1 + drop2).astype(jnp.int32)
    return out
