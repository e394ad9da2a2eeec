"""Explicit shard_map radial domain decomposition with ppermute halo rings.

Re-derivation of the reference's MPI slab decomposition
(src/split.cpp:21-397) + halo exchange (src/commbound.cpp:45-182
``CommunicateBoundaries`` with CPUOVERLAP=7 ghost rings,
src/constants.h:17): each device of a 1-D ``("r",)`` mesh owns a
contiguous slab of ``L = NR/n`` rings and computes on an EXTENDED WINDOW
of ``Lx = L + 2*halo`` rings. One bidirectional ``lax.ppermute`` per hydro
step refreshes the halo rings of all six exchanged fields (Sigma, vrad,
vaz, energy, Q+, Q-) in a single stacked transfer; the CFL reduce is a
``lax.pmin`` (MPI_Allreduce MIN, src/cfl.cpp:379); grid-sum diagnostics
and disk-on-planet feedback become ownership-masked partial sums +
``lax.psum`` (src/Force.cpp:23-122).

Window placement is *skewed at the edges* (shard 0's window starts at
global ring 0, the last shard's window ends at ring NR-1) so the
physical-boundary rows coincide with the window edge rows: the unchanged
BC code — which writes window rows 0, 1 and -2, -1 — acts on the true
domain boundary exactly as in the global program, while on interior
shards those writes land in halo rings and are overwritten by the next
exchange. This mirrors the reference's ``radial_first_active`` /
``Zero_or_active`` edge-rank handling (src/global.h:11-60) without any
per-rank branching.

Halo-width budget: every radial stencil application between two exchanges
consumes one ring of halo freshness; the full Euler step chain (sources 1,
artificial viscosity 1, viscous stress + velocity update 2, energy 1,
FARGO radial transport ~3, plus the mid-step BC writes) stays under the
default ``halo=10`` (validated to 1e-13 against the single-device step by
tests/test_shard_map.py; the reference uses CPUOVERLAP=7 with narrower
per-substep loop bounds).

FLD radiative diffusion runs with a per-SOR-iteration ghost refresh
(one ppermute per iteration, the analog of src/fld.cpp:596-656) and a
psum'd convergence norm (:748) over globally-colored red-black masks.
Lagrangian particles are slab-owned by default (particles/sharded.py:
fixed-capacity slot buckets integrated against the local window fields,
boundary-crossers ppermuted to the neighbors — the rebuild of the
reference's per-rank domains + MPI move sweep,
src/particles/particles.cpp:259-420, :2016-2160);
``shard_particles=False`` falls back to the replicated swarm over
all-gathered gas slabs.

FFT self-gravity runs replicated on the all-gathered Sigma (the
reference parallelizes the FFT radially via FFTW-MPI,
src/selfgravity.cpp:251-320) with the kernel-refresh mass average
psum'd over ownership rows.

The Roche-lobe-overflow and center-of-mass composite boundaries need no
special handling: they write local edge rows from the replicated N-body
state, so the skewed-window contract covers them like every other BC.
The GSPMD path (parallel/mesh.py) remains available for everything.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import FieldState
from ..ops.boundary import RefValues

AXIS = "r"

# Geom fields that are per-ring arrays (the rest are static scalars)
_GEOM_ROWS = ("rb", "inv_rb", "ra", "inv_ra", "rinf", "rsup", "rmed_ext",
              "inv_diff_rmed", "inv_diff_rsup", "inv_diff_rsup_rb",
              "two_diff_ra_sq", "four_third_inv_rb_invdphi_sq",
              "surf", "inv_surf")


def _shard_map(fn, mesh, in_specs, out_specs):
    """shard_map across jax versions (replication checking off: the
    replicated outputs are psum/pmin results inside a while_loop, which
    the static rep-checker cannot prove)."""
    try:
        from jax import shard_map as _sm          # jax >= 0.6 style
        return _sm(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    except (ImportError, TypeError):
        from jax.experimental.shard_map import shard_map as _sm
        return _sm(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)


class ShardedHydroStep:
    """Wraps a HydroStep with the explicit shard_map/ppermute execution.

    Usage:
        ss = ShardedHydroStep(sim.stepper, mesh)
        sharded = ss.shard_state(sim.state)      # device_put, vrad split
        sharded, t, dt, n, *stats = ss.advance_to(sharded, t, dt, t_target)
        state = ss.gather(sharded)               # plain SystemState
    """

    def __init__(self, stepper, mesh: Mesh, halo: int = 10,
                 shard_particles: bool = True):
        phys = stepper.phys

        self.stepper = stepper
        self.mesh = mesh
        # slab-owned particle buckets with ppermute migration
        # (particles/sharded.py); False falls back to the replicated
        # swarm over all-gathered fields (rounds 1-4 design)
        self.shard_particles = bool(shard_particles
                                    and phys.integrate_particles)
        self._particle_E = None
        self._particle_C = None
        self.n = int(mesh.devices.size)
        geometry = stepper.geometry
        NR, NAZ = geometry.nrad, geometry.naz
        self.NR, self.NAZ = NR, NAZ
        n, H = self.n, int(halo)
        if NR % n != 0:
            raise ValueError(
                f"Nrad={NR} not divisible by {n} devices; pad the grid or "
                "use the GSPMD path (parallel/mesh.py)")
        L = NR // n
        Lx = L + 2 * H
        if 2 * H + 1 > L:
            raise ValueError(
                f"halo={H} needs slabs of at least {2 * H + 1} rings, have "
                f"{L}; fewer devices or a smaller halo required")
        self.L, self.Lx, self.halo = L, Lx, H
        self.S = 2 * H + 1              # rings sent to each neighbor
        dtype = stepper.dtype
        self.dtype = dtype

        # --- per-shard windows + contexts (host-side, exact row slices) ---
        wins = [min(max(k * L - H, 0), NR - Lx) for k in range(n)]
        self.windows = wins
        from ..step import HydroStep
        ctxs = []
        self._window_geom0 = geometry.window(wins[0], Lx)
        for k in range(n):
            win = wins[k]
            wgeom = geometry.window(win, Lx)
            ref = RefValues(
                sigma0=stepper.ref_values.sigma0[win:win + Lx],
                energy0=stepper.ref_values.energy0[win:win + Lx],
                vrad0=stepper.ref_values.vrad0[win:win + Lx + 1],
                vaz0=stepper.ref_values.vaz0[win:win + Lx])
            ws = HydroStep(phys, stepper.constants, wgeom, ref,
                           bodies=stepper.bodies_cfg,
                           n_hydroframe=stepper.n_hydroframe,
                           units=stepper.units,
                           particle_params=stepper.particle_params)
            ctxs.append(self._one_ctx(ws, k, win))
        # stack over shards and place each leaf sharded on the mesh axis
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *ctxs)
        sh = NamedSharding(mesh, P(AXIS))
        self._ctx = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), sh), stacked)
        self._ctx_specs = jax.tree_util.tree_map(lambda _: P(AXIS),
                                                 self._ctx)

        self._jit_advance = None
        self._jit_step = None
        self._jit_cfl = None

    # ------------------------------------------------------------------
    def _one_ctx(self, ws, k, win):
        """Per-shard context: the window stepper's row-indexed arrays plus
        ownership masks and face selectors."""
        n, L, Lx, H, NR = self.n, self.L, self.Lx, self.halo, self.NR
        dtype = self.dtype
        rows = win + np.arange(Lx)
        own = ((rows >= k * L) & (rows < (k + 1) * L)).astype(dtype)
        own_int = own * ((rows >= 1) & (rows <= NR - 2))
        # accretion bookkeeping rows: reference radial_first_active < i <
        # radial_active_size, serial values -> global rows 2..NR-2
        # (src/split.cpp:73-78 with GHOSTCELLS_B=1)
        own_act = own * ((rows >= 2) & (rows <= NR - 2))
        ctx = {
            "g": {name: getattr(ws.g, name) for name in _GEOM_ROWS},
            "cs_iso": ws.cs_iso,
            "cell_x": ws.cell_x, "cell_y": ws.cell_y,
            "ref": (ws.ref_values.sigma0, ws.ref_values.energy0,
                    ws.ref_values.vrad0, ws.ref_values.vaz0),
            "own": own[:, None], "own_int": own_int[:, None],
            "own_act": own_act[:, None],
            "own_off": np.int32(k * L - win),
            "off_avail": np.int32(win - k * L + self.S),
            "win": np.int32(win),
            "is_top": np.asarray(1.0 if k == n - 1 else 0.0, dtype),
            "inner_idx": np.int32(max(1 - win, 0)),
            "inner_w": np.asarray(1.0 if win == 0 else 0.0, dtype),
            "outer_idx": np.int32(min(max(NR - 1 - win, 0), Lx)),
            "outer_w": np.asarray(
                1.0 if win + Lx == NR else 0.0, dtype),
        }
        if ws.fld is not None:
            # FLD needs window-aligned red-black parity (colored by the
            # GLOBAL ring index) and an owned-rows-only norm mask so the
            # psum'd convergence criterion equals the single-device one
            ii = win + np.arange(Lx)[:, None]
            jj = np.arange(self.NAZ)[None, :]
            ctx["fld_red"] = np.broadcast_to(
                (ii + jj) % 2 == 0, (Lx, self.NAZ)).copy()
            act = ((ii > 1) & (ii < NR - 2)
                   & (ii >= k * L) & (ii < (k + 1) * L))
            ctx["fld_active"] = np.broadcast_to(
                act, (Lx, self.NAZ)).copy()
        if ws.damping is not None:
            d = ws.damping
            ctx["damping"] = (d.rate_b, d.in_b, d.out_b,
                              d.rate_a, d.in_a, d.out_a)
        if self.shard_particles:
            # slab ownership interval [radii[kL], radii[(k+1)L]) with the
            # domain edges opened so frozen escapers stay bucketed
            radii_g = np.asarray(self.stepper.geometry.radii, np.float64)
            ctx["p_rmed"] = np.asarray(ws.geometry.rmed, dtype)
            ctx["p_radii"] = np.asarray(ws.geometry.radii, dtype)
            ctx["p_lo"] = np.asarray(
                radii_g[k * L] if k > 0 else -np.inf, dtype)
            ctx["p_hi"] = np.asarray(
                radii_g[(k + 1) * L] if k < n - 1 else np.inf, dtype)
            ctx["p_is_bot"] = np.asarray(1.0 if k == 0 else 0.0, dtype)
        return ctx

    def _localize(self, ctx):
        """Shallow copy of the global stepper operating on this shard's
        extended window, with the sharding hooks armed."""
        st = copy.copy(self.stepper)
        st.g = dataclasses.replace(
            self.stepper.g, nrad=self.Lx,
            **{name: ctx["g"][name] for name in _GEOM_ROWS})
        st.geometry = self._window_geom0       # shapes + global rmin/rmax
        st.cs_iso = ctx["cs_iso"]
        st.cell_x, st.cell_y = ctx["cell_x"], ctx["cell_y"]
        s0, e0, vr0, va0 = ctx["ref"]
        st.ref_values = RefValues(sigma0=s0, energy0=e0, vrad0=vr0, vaz0=va0)
        if st.damping is not None:
            d = copy.copy(st.damping)
            (d.rate_b, d.in_b, d.out_b,
             d.rate_a, d.in_a, d.out_a) = ctx["damping"]
            st.damping = d
        if "fld_red" in ctx:
            st._fld_halo_fn = lambda T: self._refresh_cell_array(T, ctx)
            st._fld_shard_ctx = {
                "red": ctx["fld_red"], "active": ctx["fld_active"],
                "n_cells": self.NR * self.NAZ,
                "reduce": lambda x: jax.lax.psum(x, AXIS)}
        if self.stepper.selfgravity is not None:
            def _ag_one(x, off=None):
                own = jax.lax.dynamic_slice_in_dim(
                    x, ctx["own_off"], self.L, axis=0)
                return jax.lax.all_gather(own, AXIS, axis=0, tiled=True)
            st._sg_gather = _ag_one
            st._sg_window = lambda x: jax.lax.dynamic_slice_in_dim(
                x, ctx["win"], self.Lx, axis=0)
        if self.stepper.phys.integrate_particles:
            if self.shard_particles:
                from ..particles.sharded import WindowGeom
                st._particle_shard_ctx = {
                    "geom": WindowGeom(ctx["p_rmed"], ctx["p_radii"]),
                    "own_lo": ctx["p_lo"], "own_hi": ctx["p_hi"],
                    "is_top": ctx["is_top"], "is_bot": ctx["p_is_bot"],
                    "E": self._particle_E, "n": self.n}
            else:
                st._particle_gather = \
                    lambda sg, vr, va, e: self._gather_fields(
                        sg, vr, va, e, ctx)
                st._global_stepper = self.stepper
        st._axis_name = AXIS
        st._own_col = ctx["own"]
        st._own_int_col = ctx["own_int"]
        st._own_act_col = ctx["own_act"]
        st._inner_face = (ctx["inner_idx"], ctx["inner_w"])
        st._outer_face = (ctx["outer_idx"], ctx["outer_w"])
        st._halo_refresh = lambda s: self._refresh_state(s, ctx)
        return st

    def _refresh_cell_array(self, x, ctx):
        """Refresh the halo rings of ONE cell-centered (Lx, NAZ) array
        from the owning neighbors (one bidirectional ppermute) — the FLD
        per-SOR-iteration exchange (reference src/fld.cpp:596-656)."""
        n, L, Lx, S = self.n, self.L, self.Lx, self.S
        own = jax.lax.dynamic_slice_in_dim(x, ctx["own_off"], L, axis=0)
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
        prev_top = jax.lax.ppermute(own[L - S:], AXIS, fwd)
        next_bot = jax.lax.ppermute(own[:S], AXIS, bwd)
        avail = jnp.concatenate([prev_top, own, next_bot], axis=0)
        return jax.lax.dynamic_slice_in_dim(avail, ctx["off_avail"], Lx,
                                            axis=0)

    def _gather_fields(self, sigma, vrad, vaz, energy, ctx):
        """Window fields -> replicated GLOBAL fields (all_gather of the
        owned slabs) for the replicated particle swarm."""
        L, Lx = self.L, self.Lx
        off = ctx["own_off"]

        def ag(x):
            own = jax.lax.dynamic_slice_in_dim(x, off, L, axis=0)
            return jax.lax.all_gather(own, AXIS, axis=0, tiled=True)

        vrad_top = jax.lax.psum(vrad[Lx] * ctx["is_top"], AXIS)[None, :]
        return (ag(sigma), jnp.concatenate([ag(vrad), vrad_top], axis=0),
                ag(vaz), ag(energy))

    # --- halo exchange -------------------------------------------------
    _XNAMES = ("sigma", "vrad", "vaz", "energy", "qplus", "qminus")

    def _refresh_state(self, state, ctx):
        """Refresh every halo ring of the exchanged fields from the owning
        neighbors: ONE stacked bidirectional ppermute per call (the
        reference sends Sigma/vrad/vaz/energy in one message pair per
        neighbor, src/commbound.cpp:98-182)."""
        n, L, Lx, S = self.n, self.L, self.Lx, self.S
        f = state.fields
        ext = {"sigma": f.sigma, "vrad": f.vrad, "vaz": f.vaz,
               "energy": f.energy, "qplus": state.qplus,
               "qminus": state.qminus}
        names = self._XNAMES
        if state.pvte_guess is not None:
            # the PVTE warm-start cache rides the same stacked exchange:
            # halo-ring guesses must be live or the boundary rows' EoS
            # refresh would Newton-polish from a zero-padded start
            ext["pvte_geff"] = state.pvte_guess[0]
            ext["pvte_mu"] = state.pvte_guess[1]
            names = names + ("pvte_geff", "pvte_mu")
        own_off = ctx["own_off"]

        def own(x):
            return jax.lax.dynamic_slice_in_dim(x, own_off, L, axis=0)

        stackd = jnp.stack([own(ext[k]) for k in names])  # (F,L,NAZ)
        top_blk = stackd[:, L - S:, :]
        bot_blk = stackd[:, :S, :]
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
        prev_top = jax.lax.ppermute(top_blk, AXIS, fwd)   # from shard k-1
        next_bot = jax.lax.ppermute(bot_blk, AXIS, bwd)   # from shard k+1
        avail = jnp.concatenate([prev_top, stackd, next_bot], axis=1)
        # the global outer vrad face (row NR, avail index L+S) exists only
        # on the top shard's current extended array — preserve it there
        iv = self._XNAMES.index("vrad")
        keep = ext["vrad"][Lx] * ctx["is_top"] \
            + avail[iv, L + S] * (1.0 - ctx["is_top"])
        avail = avail.at[iv, L + S].set(keep)

        off = ctx["off_avail"]
        new = {}
        for i, k in enumerate(names):
            rows = Lx + 1 if k == "vrad" else Lx
            new[k] = jax.lax.dynamic_slice_in_dim(avail[i], off, rows,
                                                  axis=0)
        kw = {}
        if state.pvte_guess is not None:
            kw["pvte_guess"] = (new["pvte_geff"], new["pvte_mu"])
        return state.replace(
            fields=FieldState(sigma=new["sigma"], vrad=new["vrad"],
                              vaz=new["vaz"], energy=new["energy"]),
            qplus=new["qplus"], qminus=new["qminus"], **kw)

    # --- owned <-> extended --------------------------------------------
    def _is_grid_leaf(self, x):
        return hasattr(x, "ndim") and x.ndim >= 2 and x.shape[0] == self.L

    def _assemble(self, state, vrad_top, ctx):
        """Owned slabs (L rows; vrad faces kL..(k+1)L-1 + separate global
        top face) -> extended window state (halo rings still stale; the
        first _refresh_state fills them)."""
        Lx, off = self.Lx, ctx["own_off"]

        def pad(x, rows):
            z = jnp.zeros((rows,) + x.shape[1:], x.dtype)
            return jax.lax.dynamic_update_slice_in_dim(z, x, off, axis=0)

        f = state.fields
        vrad = pad(f.vrad, Lx + 1)
        vrad = vrad.at[Lx].set(vrad[Lx] * (1.0 - ctx["is_top"])
                               + vrad_top[0] * ctx["is_top"])
        fields = FieldState(sigma=pad(f.sigma, Lx), vrad=vrad,
                            vaz=pad(f.vaz, Lx), energy=pad(f.energy, Lx))
        # qplus/qminus and any enabled monitor grids are direct grid leaves
        # of SystemState: pad them generically
        rest = jax.tree_util.tree_map(
            lambda x: pad(x, Lx) if self._is_grid_leaf(x) else x,
            state.replace(fields=None))
        return self._refresh_state(rest.replace(fields=fields), ctx)

    def _extract(self, state, ctx):
        """Extended window state -> owned slabs + the replicated global
        outer vrad face row."""
        L, Lx, off = self.L, self.Lx, ctx["own_off"]

        def own(x):
            return jax.lax.dynamic_slice_in_dim(x, off, L, axis=0)

        def is_ext_grid(x):
            return hasattr(x, "ndim") and x.ndim >= 2 and x.shape[0] == Lx

        f = state.fields
        vrad_top = jax.lax.psum(f.vrad[Lx] * ctx["is_top"], AXIS)[None, :]
        fields = FieldState(sigma=own(f.sigma), vrad=own(f.vrad),
                            vaz=own(f.vaz), energy=own(f.energy))
        rest = jax.tree_util.tree_map(
            lambda x: own(x) if is_ext_grid(x) else x,
            state.replace(fields=None))
        return rest.replace(fields=fields), vrad_top

    # --- public API ------------------------------------------------------
    def shard_state(self, state):
        """Global SystemState -> (sharded owned state, replicated top vrad
        face). Every (NR[+1], NAZ) leaf is stored as true radial slabs;
        with ``shard_particles`` the swarm is bucketed into slab-owned
        slot arrays (particles/sharded.py)."""
        NR = self.NR
        sh = NamedSharding(self.mesh, P(AXIS, None))
        rep = NamedSharding(self.mesh, P())

        vrad = np.asarray(state.fields.vrad)
        vrad_top = jax.device_put(jnp.asarray(vrad[NR:NR + 1]), rep)
        fields = FieldState(
            sigma=jax.device_put(state.fields.sigma, sh),
            vrad=jax.device_put(jnp.asarray(vrad[:NR]), sh),
            vaz=jax.device_put(state.fields.vaz, sh),
            energy=jax.device_put(state.fields.energy, sh))

        def place(x):
            if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[0] == NR:
                return jax.device_put(x, sh)
            return jax.device_put(x, rep)

        particles = state.particles
        rest = state.replace(fields=None, particles=None)
        rest = jax.tree_util.tree_map(place, rest)
        if particles is not None and self.shard_particles:
            from ..particles import sharded as psh
            self._particle_template = particles
            self._n_particles = int(particles.r.shape[0])
            sp, C, _ = psh.shard_particles(
                particles, self.n, self.L,
                np.asarray(self.stepper.geometry.radii, np.float64))
            self._particle_C = C
            self._particle_E = psh.exchange_capacity(C)
            sh1 = NamedSharding(self.mesh, P(AXIS))
            sp = jax.tree_util.tree_map(
                lambda a: jax.device_put(
                    a, sh if getattr(a, "ndim", 1) == 2 else sh1), sp)
            particles = sp
        elif particles is not None:
            particles = jax.tree_util.tree_map(
                lambda a: jax.device_put(a, rep), particles)
        return rest.replace(fields=fields, particles=particles), vrad_top

    def gather(self, pair):
        """(sharded state, top face) -> plain global SystemState (the
        slot-bucketed swarm restored to canonical pid order)."""
        from ..particles.sharded import ShardedParticles, gather_particles

        state, vrad_top = pair
        vrad = jnp.concatenate([jnp.asarray(state.fields.vrad),
                                jnp.asarray(vrad_top)], axis=0)
        out = state.replace(fields=FieldState(
            sigma=state.fields.sigma, vrad=vrad,
            vaz=state.fields.vaz, energy=state.fields.energy))
        if isinstance(state.particles, ShardedParticles):
            out = out.replace(particles=gather_particles(
                state.particles, self._n_particles,
                self._particle_template))
        return out

    def _specs_for(self, state):
        from ..particles.sharded import ShardedParticles

        NR = self.NR

        def spec(x):
            if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[0] == NR:
                return P(AXIS, *([None] * (x.ndim - 1)))
            return P()

        if isinstance(state.particles, ShardedParticles):
            pspecs = jax.tree_util.tree_map(
                lambda a: P(AXIS, None) if getattr(a, "ndim", 1) == 2
                else P(AXIS), state.particles)
            rest = jax.tree_util.tree_map(
                spec, state.replace(particles=None))
            return rest.replace(particles=pspecs)
        return jax.tree_util.tree_map(spec, state)

    def _build_advance(self, state):
        state_specs = self._specs_for(state)

        def fn(owned, vrad_top, time, last_dt, t_target, step_cap, ctx_blk):
            ctx = jax.tree_util.tree_map(lambda a: a[0], ctx_blk)
            st = self._localize(ctx)
            ext = self._assemble(owned, vrad_top, ctx)
            out = st._advance_impl(ext, time, last_dt, t_target, step_cap)
            new_ext, time, last_dt, nsteps, dmin, dmax, dsum, dsq = out
            new_owned, new_top = self._extract(new_ext, ctx)
            return (new_owned, new_top, time, last_dt, nsteps,
                    dmin, dmax, dsum, dsq)

        mapped = _shard_map(
            fn, self.mesh,
            in_specs=(state_specs, P(), P(), P(), P(), P(),
                      self._ctx_specs),
            out_specs=(state_specs, P(), P(), P(), P(), P(), P(), P(), P()))
        return jax.jit(mapped)

    def advance_to(self, pair, time, last_dt, t_target):
        """Advance one monitor interval; returns ((state, top), time,
        last_dt, n_steps, dt_min, dt_max, dt_sum, dt_sum_sq) — the sharded
        analog of HydroStep.advance_to (including the chunked while_loop,
        see HydroStep.max_steps_per_call)."""
        state, vrad_top = pair
        if self._jit_advance is None:
            self._jit_advance = self._build_advance(state)
        dtype = self.dtype
        cap = getattr(self.stepper, "max_steps_per_call", 0)
        cap32 = jnp.asarray(cap if cap > 0 else 2 ** 31 - 1, jnp.int32)
        time = jnp.asarray(time, dtype)
        last_dt = jnp.asarray(last_dt, dtype)
        t_target = jnp.asarray(t_target, dtype)
        out = self._jit_advance(state, vrad_top, time, last_dt,
                                t_target, cap32, self._ctx)
        state, vrad_top, time, last_dt, n, dmin, dmax, dsum, dsq = out
        if cap > 0:
            while float(time) < float(t_target):
                out = self._jit_advance(state, vrad_top, time, last_dt,
                                        t_target, cap32, self._ctx)
                (state, vrad_top, time, last_dt, n2, dmin2, dmax2,
                 dsum2, dsq2) = out
                n = n + n2
                dmin = jnp.minimum(dmin, dmin2)
                dmax = jnp.maximum(dmax, dmax2)
                dsum = dsum + dsum2
                dsq = dsq + dsq2
        return ((state, vrad_top), time, last_dt, n, dmin, dmax, dsum, dsq)

    def step(self, pair, time, dt):
        """One sharded hydro step (for tests)."""
        state, vrad_top = pair
        if self._jit_step is None:
            state_specs = self._specs_for(state)

            def fn(owned, top, time, dt, ctx_blk):
                ctx = jax.tree_util.tree_map(lambda a: a[0], ctx_blk)
                st = self._localize(ctx)
                ext = self._assemble(owned, top, ctx)
                new_ext = st._step_impl(ext, time, dt)
                return self._extract(new_ext, ctx)

            self._jit_step = jax.jit(_shard_map(
                fn, self.mesh,
                in_specs=(state_specs, P(), P(), P(), self._ctx_specs),
                out_specs=(state_specs, P())))
        dtype = self.dtype
        return self._jit_step(state, vrad_top, jnp.asarray(time, dtype),
                              jnp.asarray(dt, dtype), self._ctx)

    def comm_model(self, fld_iters: int = 50):
        """Per-device per-hydro-step inter-device traffic model, in bytes
        SENT.

        The design choices this path makes (replicated-FFT self-gravity,
        replicated particle swarm over all-gathered slabs) trade link
        bandwidth for simplicity; this model quantifies that trade so a
        real multi-GPU run has a prediction to check against profiler
        numbers (ROADMAP: validate against a 4-GPU trace).

        Validated against the collective ops of the COMPILED step HLO on
        the 8-device CPU mesh (tests/test_shard_map.py::
        test_comm_model_matches_compiled_hlo), which pinned three counts:
        the PVTE warm-start pair rides the stacked exchange (8 fields,
        not 6); the leapfrog integrates particles twice per step (2x the
        all_gather set); and when particles are enabled XLA CSEs the
        self-gravity Sigma all_gather with the particle one (no separate
        transfer).

        all_gather cost uses the ring algorithm: each device sends its
        (L, NAZ) slab to n-1 neighbors' aggregate = (n-1)/n of the global
        array. ``fld_iters`` scales the per-SOR-iteration halo refresh
        (dynamic in production; the reference caps it at
        RadiativeDiffusionMaxIterations).
        """
        from ..params import LEAPFROG

        item = jnp.dtype(self.dtype).itemsize
        n, L, NAZ, S = self.n, self.L, self.NAZ, self.S
        phys = self.stepper.phys
        row = NAZ * item
        model = {}
        # one stacked bidirectional ppermute per step (_refresh_state):
        # 6 fields, +2 when the PVTE warm-start cache rides along
        n_fields = len(self._XNAMES) + (2 if phys.variable_gamma else 0)
        model["halo_ppermute"] = n_fields * S * row * 2
        # global outer vrad face + CFL pmin + ~35 scalar psum diagnostics
        model["faces_and_scalars"] = row + 40 * item
        leapfrog = phys.hydro_integrator == LEAPFROG
        k = 2 if leapfrog else 1
        replicated_particles = (phys.integrate_particles
                                and not self.shard_particles)
        if phys.integrate_particles:
            if self.shard_particles:
                # slab-owned buckets: per integration, two fixed
                # (8, E) float + (3, E) int32 migration buffers each way
                # (particles/sharded.py migrate) — constant in mesh size
                E = self._particle_E or 64
                model["particles_migration"] = \
                    k * 2 * E * (8 * item + 3 * 4)
            else:
                # replicated swarm: all_gather 4 gas slabs per particle
                # integration (leapfrog kicks the particles in two halves)
                model["particles_allgather"] = 4 * k * (n - 1) * L * row
        if self.stepper.selfgravity is not None \
                and not replicated_particles:
            # replicated-FFT analog: all_gather Sigma per gas kick (the
            # leapfrog kicks twice on different Sigmas — HLO-verified).
            # With REPLICATED particles this transfer is CSE'd into the
            # particle Sigma gather (HLO-verified) and costs nothing;
            # sharded particles gather no fields, so SG pays its own.
            model["selfgravity_allgather"] = k * (n - 1) * L * row
        if self.stepper.fld is not None:
            # one bidirectional single-field ppermute per SOR double
            # sweep, plus one post-loop ghost refresh (counted in the
            # per-iteration budget's noise)
            model["fld_ppermute"] = fld_iters * S * row * 2
        model["total"] = sum(model.values())
        return model

    def comm_model_summary(self, fld_iters: int = 50) -> str:
        m = self.comm_model(fld_iters)
        parts = [f"{k}={v / 1e6:.2f}MB" for k, v in m.items()
                 if k != "total"]
        return (f"shard comm model ({self.n} devices, halo={self.halo}): "
                + " ".join(parts)
                + f" total={m['total'] / 1e6:.2f}MB/step/device")

    def cfl_dt(self, pair):
        state, vrad_top = pair
        if self._jit_cfl is None:
            state_specs = self._specs_for(state)

            def fn(owned, top, ctx_blk):
                ctx = jax.tree_util.tree_map(lambda a: a[0], ctx_blk)
                st = self._localize(ctx)
                ext = self._assemble(owned, top, ctx)
                return st._cfl_impl(ext)

            self._jit_cfl = jax.jit(_shard_map(
                fn, self.mesh,
                in_specs=(state_specs, P(), self._ctx_specs),
                out_specs=P()))
        return self._jit_cfl(state, vrad_top, self._ctx)
