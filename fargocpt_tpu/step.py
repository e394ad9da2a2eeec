"""The fused hydro + N-body time step.

Re-derivation of reference src/simulation.cpp:148-274 ``step_Euler`` (and
:276-483 ``step_LeapFrog``) as one pure function over a ``SystemState``
pytree. All substeps — disk feedback on the bodies, indirect terms, gas
potential, momentum/energy sources, viscosity, FARGO transport, N-body
integration, frame centering, boundary conditions — chain inside a single
jit scope; XLA fuses the elementwise work between stencil shifts, and a
whole monitor interval runs in one ``lax.while_loop`` with zero host
round-trips.

Everything configuration-dependent (Physics, Geometry, Constants, static
body properties) is closed over as compile-time constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .constants import Constants
from .grid import Geometry
from .params import Physics, LEAPFROG
from .state import FieldState
from .nbody import system as nbody_sys
from .nbody.system import BodyConfig, NBodyState
from .ops import artvisc, boundary, cfl, energy as energy_ops, eos, gravity, \
    sources, transport
from .ops import viscosity as visc_ops
from .ops.boundary import RefValues
from .ops.common import Geom, prepare_geom


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MonitorAccum:
    """Per-step accumulated monitor grids (reference
    src/quantities.cpp:976-998 ``CalculateMonitorQuantitiesAfterHydroStep``
    and src/TransportEuler.cpp:610-616 MASSFLOW). Fields are None when the
    corresponding Write* flag is off."""
    massflow: jax.Array = None       # sum of face mass flux (mass units)
    t_adv: jax.Array = None          # sum of advection torque * dt
    t_visc: jax.Array = None         # sum of viscous torque * dt
    t_grav: jax.Array = None         # sum of gravitational torque * dt
    # time-averaged alpha grids: sum of alpha * dt, written divided by
    # monitor_timestep and cleared (reference quantities.cpp:637-720,
    # :991-996 + data.cpp:94-100 clear_after_write)
    alpha_grav_mean: jax.Array = None
    alpha_reynolds_mean: jax.Array = None
    # mass bookkeeping (reference src/types.h:30-60 BoundaryFlow), always
    # tracked; see MD_* indices below
    mass_delta: jax.Array = None
    # Roche-lobe-overflow massflow tracker (reference
    # src/massflow_tracker.cpp): exponentially averaged accretion rate
    rof_mdot: jax.Array = None
    # per-stage disk ecc/pericenter changes (reference write_ecc_peri_changes
    # columns: source, artvisc, viscosity, transport, damping)
    decc: jax.Array = None
    dperi: jax.Array = None

    def replace(self, **kw) -> "MonitorAccum":
        from dataclasses import replace as _replace
        return _replace(self, **kw)


# indices into MonitorAccum.mass_delta (reference src/types.h:30-60)
MD_INNER_IN, MD_INNER_OUT, MD_OUTER_IN, MD_OUTER_OUT = 0, 1, 2, 3
MD_DAMP_IN_CREATE, MD_DAMP_IN_REMOVE = 4, 5
MD_DAMP_OUT_CREATE, MD_DAMP_OUT_REMOVE = 6, 7
MD_FLOOR_CREATE = 8
N_MASS_DELTA = 9


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SystemState:
    """Complete per-run dynamic state carried through the jitted loop."""
    fields: FieldState
    # Q+/Q- from the last energy substep feed the next CFL evaluation
    # (the reference keeps these in the QPLUS/QMINUS grids across steps)
    qplus: jax.Array
    qminus: jax.Array
    nbody: NBodyState
    omega_frame: jax.Array   # scalar
    frame_angle: jax.Array   # scalar
    # reference-body position stored at init for the corotation measurement
    # (reference src/frame_of_reference.cpp:19-27 ``init_corotation``)
    corot_ref_x: jax.Array = None
    corot_ref_y: jax.Array = None
    particles: object = None  # ParticleState when dust is enabled
    monitor_acc: MonitorAccum = None  # when any monitor grid is enabled
    # [omega, direction, old_iterations] for the FLD SOR auto-omega walk
    # (reference src/fld.cpp:698-700 function statics); None unless
    # RadiativeDiffusionAutoOmega is enabled
    fld_sor: jax.Array = None
    # (k_r_hat, k_t_hat, last_aspect_ratio, since_last) for the adiabatic
    # self-gravity kernel refresh cadence (reference selfgravity.cpp:186-214)
    sg_kernel: tuple = None
    # (gamma_eff, mu) grids from the newest PVTE refresh — a pure solver
    # cache warm-starting the next refresh's temperature Newton solve
    # (fast f32 path only; None otherwise).  Never output, never affects
    # semantics beyond the solver's convergence tolerance: each refresh
    # re-solves to its own tolerance from the guess.
    pvte_guess: tuple = None

    def replace(self, **kw) -> "SystemState":
        from dataclasses import replace as _replace
        return _replace(self, **kw)


class HydroStep:
    """Builds jitted step/CFL callables for a fixed configuration."""

    def __init__(self, phys: Physics, constants: Constants,
                 geometry: Geometry, ref_values: RefValues,
                 bodies: list[BodyConfig] | None = None,
                 n_hydroframe: int = 1, units=None, particle_params=None):
        # x64 must be live even for float32 runs: the N-body system is
        # always integrated in f64 (nbody/system.py integrate) because
        # IAS15's controller works below the f32 noise floor.  The hydro
        # arrays keep the configured dtype; only tiny body vectors are f64.
        # The package __init__ enables x64 at import time (before ANY array
        # is built — a lazy enable here once f32-truncated the first
        # Simulation's ICs); this assert guards against a future regression.
        import jax as _jax
        assert _jax.config.jax_enable_x64, \
            "fargocpt_tpu requires x64 (enabled at package import)"
        self.particle_params = particle_params
        self.phys = phys
        if units is None:
            from . import units as u
            units = u.Units() if not phys.shock_tube else u.shock_tube_units()
        self.units = units
        self.constants = constants
        self.geometry = geometry
        dtype = jnp.dtype(phys.dtype)
        self.dtype = dtype
        self.g: Geom = prepare_geom(geometry, dtype)
        self.ref_values = ref_values
        x, y = geometry.cell_centers_xy()
        self.cell_x = jnp.asarray(x, dtype)
        self.cell_y = jnp.asarray(y, dtype)

        self.bodies_cfg = bodies if bodies is not None else \
            [BodyConfig(name="DefaultStar", mass=phys.hydro_center_mass)]
        self.n_bodies = len(self.bodies_cfg)
        self.n_hydroframe = n_hydroframe
        # static per-body properties
        self.body_radius = jnp.asarray(
            [b.radius for b in self.bodies_cfg], dtype)
        self.body_temperature = jnp.asarray(
            [b.temperature for b in self.bodies_cfg], dtype)
        self.body_rampup = jnp.asarray(
            [b.ramp_up_time for b in self.bodies_cfg], dtype)
        self.body_cubic_factor = jnp.asarray(
            [b.cubic_smoothing_factor for b in self.bodies_cfg], dtype)
        self.body_irradiation_rampup = jnp.asarray(
            [b.irradiation_rampup for b in self.bodies_cfg], dtype)
        self.body_accretion_efficiency = jnp.asarray(
            [b.accretion_efficiency for b in self.bodies_cfg], dtype)
        self.body_accretion_types = [b.accretion_type
                                     for b in self.bodies_cfg]
        self.any_accretion = any(t != "none"
                                 for t in self.body_accretion_types)
        # orbital periods for mass ramp-up (from the initial orbits)
        periods = []
        G = constants.G
        for b in self.bodies_cfg:
            if b.semi_major_axis > 0:
                periods.append(2 * np.pi * np.sqrt(
                    b.semi_major_axis ** 3 / (G * phys.hydro_center_mass)))
            else:
                periods.append(0.0)
        self.body_period = jnp.asarray(periods, dtype)
        self.body_period_host = list(periods)   # python floats for static use

        # static locally-isothermal sound-speed profile
        # (reference src/SourceEuler.cpp:1080-1088 — never updated for
        # aspectratio_mode == 0)
        self.cs_iso = eos.sound_speed_iso_profile(phys, constants, self.g.rb)

        # user boundary hook (reference src/boundary_conditions/custom.cpp)
        self.custom_bc = None

        # azimuth rows for diagnostics
        self.cos_row = jnp.asarray(geometry.cos_phi, dtype)[None, :]
        self.sin_row = jnp.asarray(geometry.sin_phi, dtype)[None, :]

        # binary quadrupole moment for the v_az support correction
        # (reference src/Theo.cpp:58-78)
        self.quad_moment = 0.0
        if phys.vaz_quadrupole_support:
            from .ops import diskmodel as _dm
            self.quad_moment = _dm.binary_quadrupole_moment(
                self.bodies_cfg, n_hydroframe)

        # wave-damping zones (reference src/boundary_conditions/damping.cpp)
        if phys.damping:
            from .ops.damping import DampingZones
            self.damping = DampingZones(phys, constants, geometry, dtype)
        else:
            self.damping = None

        # self-gravity FFT solver (reference src/selfgravity.cpp)
        if phys.self_gravity:
            from .ops.selfgravity import SelfGravity
            self.selfgravity = SelfGravity(phys, constants, geometry, dtype)
        else:
            self.selfgravity = None

        # PVTE variable-gamma EoS (reference src/pvte_law.cpp)
        if phys.variable_gamma:
            from .ops.pvte import PVTE
            self.pvte = PVTE(phys, self.units, dtype)
        else:
            self.pvte = None

        # FLD radiative diffusion (reference src/fld.cpp)
        if phys.radiative_diffusion and phys.is_adiabatic:
            from .ops.fld import FLDSolver, FLDConfig
            self.fld = FLDSolver(
                phys, constants, self.units, geometry,
                # the reference scales the relative tolerance by the
                # temperature floor (src/fld.cpp:235-237)
                FLDConfig(tolerance=phys.fld_tolerance
                          * phys.minimum_temperature,
                          max_iterations=phys.fld_max_iterations,
                          omega=phys.fld_omega,
                          auto_omega=phys.fld_auto_omega,
                          inner_boundary=phys.fld_inner_boundary,
                          outer_boundary=phys.fld_outer_boundary,
                          constant_fluxlimiter=phys.fld_constant_fluxlimiter,
                          check_interval=phys.fld_check_interval,
                          ), dtype)
        else:
            self.fld = None

        # --- sharding hooks (explicit shard_map path, parallel/shard_step)
        # All None/static on the single-device + GSPMD paths. A "localized"
        # copy of this stepper (operating on a per-shard extended radial
        # window inside shard_map) sets:
        #   _axis_name     mesh axis to psum/pmin over
        #   _own_col       (Lx,1) 1.0 where the window row is owned
        #   _own_int_col   ownership AND global rows [1, NR-2]
        #   _own_act_col   ownership AND global rows [2, NR-3] (accretion)
        #   _inner_face    (local index of global face 1, validity weight)
        #   _outer_face    (local index of global face NR-1, validity weight)
        #   _halo_refresh  callable refreshing the halo rows of a state
        self._axis_name = None
        self._own_col = None
        self._own_int_col = None
        self._own_act_col = None
        self._inner_face = (1, 1.0)
        self._outer_face = (geometry.nrad - 1, 1.0)
        self._halo_refresh = None
        #   _fld_halo_fn   per-SOR-iteration ghost refresh (FLD)
        #   _fld_shard_ctx window-aligned masks + psum for the FLD norm
        #   _particle_gather  (sigma, vrad, vaz, energy) -> global fields
        #   _global_stepper   the unlocalized stepper (particle work runs
        #                     replicated on gathered global fields)
        self._fld_halo_fn = None
        self._fld_shard_ctx = None
        self._particle_gather = None
        self._global_stepper = None
        #   _particle_shard_ctx  slab-owned particle buckets: window
        #   geometry + ownership bounds + migration sizes (the
        #   rebuild of the reference's per-rank particle domains,
        #   src/particles/particles.cpp:259-420; see particles/sharded.py)
        self._particle_shard_ctx = None
        #   _sg_gather / _sg_window  localized self-gravity: all_gather
        #   sigma to global, slice the accelerations back to the window
        self._sg_gather = None
        self._sg_window = None

        self._step = jax.jit(self._step_impl)
        self._cfl = jax.jit(self._cfl_impl)
        self._advance = jax.jit(self._advance_impl)
        # Upper bound on hydro steps per device call: ``advance_to`` splits
        # a monitor interval into several while_loop executions of at most
        # this many steps (the step cap is a traced argument — one compiled
        # graph).  Chunking bounds the length of each device call and gives
        # the host a point between calls to react (signals, wall budgets)
        # while keeping the dt sequence bitwise identical (dt depends only
        # on carried state).  <=0 disables chunking.
        import os as _os
        self.max_steps_per_call = int(
            _os.environ.get("FARGOCPT_TPU_MAX_STEPS_PER_CALL", "256"))

    # --- sharding-aware reduction helpers --------------------------------
    def _sum_cells(self, x, weight_col):
        """Grid sum with an ownership row weight + psum under the explicit
        shard_map path; plain jnp.sum otherwise (the caller then does its
        own row slicing)."""
        if weight_col is not None:
            x = x * weight_col
        s = jnp.sum(x)
        if self._axis_name is not None:
            s = jax.lax.psum(s, self._axis_name)
        return s

    def _face_row(self, flux, which: str):
        """One global face row of a (NR+1, NAZ) face array: ``which`` is
        'inner' (global face 1) or 'outer' (global face NR-1). Under the
        shard_map path the owning shard contributes, psum broadcasts."""
        idx, w = self._inner_face if which == "inner" else self._outer_face
        if self._axis_name is None:
            return flux[idx]
        row = jax.lax.dynamic_slice_in_dim(
            flux, jnp.asarray(idx, jnp.int32), 1, axis=0)[0] * w
        return jax.lax.psum(row, self._axis_name)

    # ------------------------------------------------------------------
    def pvte_vals(self, sigma, energy):
        """(gamma_eff, mu, gamma1) grids for PVTE runs; the midplane
        density uses an H estimate from the constant-gamma sound speed
        (the reference also evaluates the EoS with the stale scale
        height, src/SourceEuler.cpp:238-246).

        Memoized per (sigma, energy) tracer pair: the step evaluates the
        EoS at several staleness points that share the same fields, and
        XLA's CSE cannot merge them across optimization_barrier calls —
        the memo guarantees one evaluation per distinct state.  Keys hold
        strong references to the tracers so ids cannot be recycled
        within a trace."""
        if self.pvte is None:
            return None
        memo = getattr(self, "_pvte_memo", None)
        if memo is None:
            memo = self._pvte_memo = {}
        key = (id(sigma), id(energy))
        if key in memo:
            return memo[key][2]
        phys, constants, g = self.phys, self.constants, self.g
        gam0 = phys.adiabatic_index
        cs0 = jnp.sqrt(gam0 * (gam0 - 1.0) * energy / sigma)
        omega_k = jnp.sqrt(constants.G * phys.hydro_center_mass / g.rb ** 3)
        h0 = cs0 / jnp.sqrt(gam0) / omega_k
        out = self.pvte.gamma_mu(sigma, energy, h0,
                                 guess=getattr(self, "_pvte_chain", None))
        if self.pvte.fast:
            # chain the refresh: the next distinct (sigma, energy) this
            # trace evaluates warm-starts from this result (substeps move
            # T by far less than the solver's bracket)
            self._pvte_chain = (out[0], out[1])
        memo[key] = (sigma, energy, out)
        while len(memo) > 32:      # bound retained tracers across traces
            memo.pop(next(iter(memo)))
        return out

    def derived(self, sigma, energy, bodies=None, pv=None):
        """Sound speed, pressure, scale height from prognostic fields.
        With AspectRatioMode 1/2 and a bodies snapshot, the N-body /
        center-of-mass variants are used (reference
        src/SourceEuler.cpp:1054-1441); callers without body context fall
        back to the axisymmetric mode-0 forms.

        ``pv``: optional STALE (gamma_eff, mu, gamma1) grids.  The
        reference evaluates several staleness points with the grids of
        the LAST ``pvte::compute_gamma_mu`` instead of recomputing (e.g.
        fld.cpp:996-1000 compute_temperature/compute_sound_speed read
        ``pvte::get_*`` without a refresh); passing the carried grids
        here reproduces that and skips a full-grid solve."""
        phys, constants, g = self.phys, self.constants, self.g
        if pv is None:
            pv = self.pvte_vals(sigma, energy)
        mode = phys.aspectratio_mode
        if mode in (1, 2) and bodies is not None:
            if phys.is_adiabatic or phys.is_polytropic:
                cs = eos.sound_speed(phys, constants, g, sigma, energy,
                                     self.cs_iso, pv)
            elif mode == 1:
                cs = eos.sound_speed_iso_nbody(
                    phys, constants, g, bodies, self.n_bodies,
                    self.body_radius, self.cell_x, self.cell_y)
            else:
                m = jnp.sum(bodies.mass)
                com_x = jnp.sum(bodies.mass * bodies.x) / m
                com_y = jnp.sum(bodies.mass * bodies.y) / m
                cs = eos.sound_speed_iso_com(
                    phys, constants, g, com_x, com_y, m, self.cell_x,
                    self.cell_y)
            press = eos.pressure(phys, constants, sigma, energy, cs, pv)
            if mode == 1:
                h = eos.scale_height_nbody(
                    phys, constants, g, cs, bodies, self.n_bodies,
                    self.body_radius, self.cell_x, self.cell_y, pv)
            else:
                m = jnp.sum(bodies.mass)
                com_x = jnp.sum(bodies.mass * bodies.x) / m
                com_y = jnp.sum(bodies.mass * bodies.y) / m
                h = eos.scale_height_com(phys, constants, g, cs, com_x,
                                         com_y, m, self.cell_x, self.cell_y,
                                         pv)
        else:
            cs = eos.sound_speed(phys, constants, g, sigma, energy,
                                 self.cs_iso, pv)
            press = eos.pressure(phys, constants, sigma, energy, cs, pv)
            h = eos.scale_height(phys, constants, g, cs, pv)
        # self-gravitating vertical structure (reference
        # src/SourceEuler.cpp:1434-1439, Bessel-kernel SG mode only)
        if phys.self_gravity and phys.self_gravity_mode == "besselkernel":
            from .ops import quantities as _quant
            q = _quant.toomre_q(phys, constants, g, sigma, cs)
            h = eos.adjust_scale_height_for_sg(h, q)
        return cs, press, h

    def viscosity_grid(self, cs, h, sigma=None, energy=None, bodies=None):
        """nu grid; when a non-constant AlphaMode is configured and the
        thermodynamic fields are provided, the per-cell alpha is used
        (reference src/viscosity/viscosity.cpp:31-137)."""
        if self.phys.alpha_mode != 0 and sigma is not None \
                and energy is not None:
            pv = self.pvte_vals(sigma, energy)
            temp = eos.temperature(self.phys, self.constants, sigma, energy,
                                   None, pv)
            return visc_ops.kinematic_viscosity(
                self.phys, self.g, cs, h, temperature=temp,
                units=self.units, sigma=sigma, bodies=bodies,
                n_bodies=self.n_bodies if bodies is not None else 0,
                cell_x=self.cell_x, cell_y=self.cell_y)
        return visc_ops.kinematic_viscosity(self.phys, self.g, cs, h)

    def bodies_on_grid(self, nb: NBodyState, time) -> gravity.BodiesOnGrid:
        """Snapshot of body data the gas-side ops need, with mass ramp-up
        and the Klahr cubic smoothing radius."""
        mass = nbody_sys.rampup_masses(nb, self.body_rampup,
                                       self.body_period, time)
        dist = nbody_sys.dist_to_primary(nb)
        roche = nbody_sys.dimensionless_roche_radius(nb)
        cubic = roche * dist * self.body_cubic_factor
        return gravity.BodiesOnGrid(x=nb.x, y=nb.y, mass=mass,
                                    cubic_smoothing_radius=cubic)

    # ------------------------------------------------------------------
    def _accretion_nu(self, sigma, energy, bodies=None):
        """Viscosity grid for the viscous-rate accretion variant
        (reference src/accretion.cpp:336-481); None when no body uses it."""
        if "viscous" not in self.body_accretion_types:
            return None
        cs, _, h = self.derived(sigma, energy, bodies)
        return self.viscosity_grid(cs, h, sigma, energy, bodies)

    def _apply_bcs(self, sigma, vrad, vaz, energy, omega_frame,
                   final: bool = False, dt=None, nb=None, time=None,
                   rof_mdot=None, want_damping_delta: bool = False,
                   stale_nu=None):
        """reference src/boundary_conditions/boundary_conditions.cpp:65-110;
        damping runs first and only on the final application of a step
        (:45-63 ``handle_damping``). With ``want_damping_delta`` also
        returns the (4,) damping mass creation/removal vector.

        ``stale_nu``: the viscosity grid as the reference's
        data[VISCOSITY] holds it at BC time (last recalculate_viscosity,
        src/simulation.cpp:328/383 — post-artvisc, PRE-SubStep3 energy);
        the viscous-vrad BC and viscous damping read it verbatim
        (boundary_conditions/viscous.cpp:26)."""
        phys = self.phys
        dmp_delta = jnp.zeros((4,), self.dtype) if want_damping_delta \
            else None
        if final and phys.damping and self.damping is not None:
            dmp_nu = stale_nu
            if dmp_nu is None and phys.damping_vradial_inner == "viscous":
                cs_d, _, h_d = self.derived(sigma, energy)
                dmp_nu = self.viscosity_grid(cs_d, h_d)
            sig_before = sigma
            sigma, vrad, vaz, energy = self.damping.apply(
                phys, sigma, vrad, vaz, energy, self.ref_values, dt,
                nu=dmp_nu)
            if want_damping_delta:
                dm = (sigma - sig_before) * self.g.surf
                din = jnp.where(self.damping.in_b, dm, 0.0)
                dout = jnp.where(self.damping.out_b, dm, 0.0)
                dmp_delta = jnp.stack([
                    self._sum_cells(jnp.maximum(din, 0.0), self._own_col),
                    self._sum_cells(jnp.maximum(-din, 0.0), self._own_col),
                    self._sum_cells(jnp.maximum(dout, 0.0), self._own_col),
                    self._sum_cells(jnp.maximum(-dout, 0.0), self._own_col)])
        nu = None
        if "viscous" in (phys.bc_vrad_inner, phys.bc_vrad_outer):
            # the reference BC reads data[VISCOSITY], the per-cell grid
            # incl. non-constant AlphaMode values (viscous.cpp:26-37) —
            # a constant-alpha nu here under AlphaMode!=0 put the inner
            # drift off by alpha_hot/alpha_cold
            if stale_nu is not None:
                nu = stale_nu
            else:
                nu_bodies = None
                if nb is not None and (phys.alpha_mode != 0
                                       or phys.aspectratio_mode in (1, 2)):
                    nu_bodies = self.bodies_on_grid(
                        nb, time if time is not None else 0.0)
                cs, _, h = self.derived(sigma, energy, nu_bodies)
                nu = self.viscosity_grid(cs, h, sigma, energy, nu_bodies)
        rof_ctx = None
        if phys.rochelobe_overflow and nb is not None:
            un = self.units
            mdot = phys.rof_mdot
            if phys.rof_variable_transfer and rof_mdot is not None:
                # tracked accretion rate drives the stream (reference
                # src/boundary_conditions/mass_overflow.cpp:42)
                mdot = rof_mdot
            rof_ctx = (nb, time, un.temperature, un.time / 3600.0,
                       un.length, mdot)
        com_ctx = None
        if nb is not None and "centerofmass" in (phys.composite_inner,
                                                 phys.composite_outer):
            com_ctx = (nb, self.n_hydroframe, self.quad_moment)
        sigma, vrad, vaz, energy = boundary.apply_boundary_conditions(
            phys, self.constants, self.g, sigma, vrad, vaz, energy,
            self.ref_values, omega_frame, nu=nu, rof_ctx=rof_ctx,
            com_ctx=com_ctx)
        if want_damping_delta:
            if self.custom_bc is not None and "custom" in (
                    phys.composite_inner, phys.composite_outer):
                sigma, vrad, vaz, energy = self.custom_bc(
                    self.g, sigma, vrad, vaz, energy, omega_frame)
            return sigma, vrad, vaz, energy, dmp_delta
        # user-supplied boundary hook (reference
        # src/boundary_conditions/custom.cpp): a traceable callable set on
        # the stepper before the first step
        if self.custom_bc is not None and "custom" in (
                phys.composite_inner, phys.composite_outer):
            sigma, vrad, vaz, energy = self.custom_bc(
                self.g, sigma, vrad, vaz, energy, omega_frame)
        return sigma, vrad, vaz, energy

    def aspect_grid(self, cs, h, bodies, pvte_vals=None):
        """The reference's ASPECTRATIO grid for the given derived state
        (src/SourceEuler.cpp:1272-1341/:1380-1396): mode 0 H/r, mode 1 the
        nbody inverse-square sum, mode 2 the COM-distance form.  Consumed
        by irradiation's H/R factor and the SG smoothing."""
        phys = self.phys
        if phys.aspectratio_mode == 1 and bodies is not None:
            return eos.aspect_ratio_nbody(
                phys, self.constants, self.g, cs, bodies, self.n_bodies,
                self.body_radius, self.cell_x, self.cell_y, pvte_vals)
        if phys.aspectratio_mode == 2 and bodies is not None:
            m = jnp.sum(bodies.mass)
            com_x = jnp.sum(bodies.mass * bodies.x) / m
            com_y = jnp.sum(bodies.mass * bodies.y) / m
            return eos.aspect_ratio_com(
                phys, self.constants, self.g, cs, com_x, com_y, m,
                self.cell_x, self.cell_y, pvte_vals)
        return h * self.g.inv_rb

    def irradiation_ctx(self, bodies):
        if not self.phys.heating_star:
            return None
        return (bodies, self.n_bodies, self.body_radius,
                self.body_temperature,
                [b.irradiate for b in self.bodies_cfg],
                self.body_irradiation_rampup, self.cell_x, self.cell_y)

    def _substeps(self, sigma, vrad, vaz, energy, indirect, time, dt,
                  omega_frame, bodies, sg_kernel=None, stale_derived=None,
                  stale_h=None):
        """Source + viscosity + energy substeps (the 'kick' part).
        ``indirect`` is the (x, y) indirect-term pair entering the gas
        potential (reference src/simulation.cpp:168-176).

        ``stale_h``: optional scale-height grid for the N-body POTENTIAL's
        eps-smoothing only.  In the reference's leapfrog, kick 2's
        ``CalculateNbodyPotential`` (src/simulation.cpp:363) runs BEFORE
        any cs/H recompute, so its smoothing length is the scale height
        left over from kick 1's ``recalculate_viscosity``
        (src/simulation.cpp:328) — i.e. from the PRE-transport fields —
        while the pressure entering the source terms IS fresh
        (compute_pressure, :378).  The 9th element of the return tuple is
        the H computed at this kick's viscosity stage, which the caller
        must thread into the next kick's ``stale_h``.

        ``stale_derived``: optional (cs, press, h) computed from the
        PRE-ACCRETION state.  The reference refreshes pressure/derived
        quantities only at the END of each step
        (``recalculate_derived_disk_quantities``, src/simulation.cpp:265,
        456), but accretion removes mass at the START — so the first kick's
        source terms run on a pressure that predates the accretion sink.
        Accreting steps must pass the pre-accretion values here or the
        pressure-gradient kick around the accretion dip diverges from the
        reference (this was the planet_accretion golden's 1e-2 residual)."""
        phys, constants, g = self.phys, self.constants, self.g
        track_ecc = phys.write_ecc_changes
        ecc_deltas = []

        def ecc_mark(before):
            e1, p1 = self._disk_ecc_peri(sigma, vrad, vaz, omega_frame)
            ecc_deltas.append((e1 - before[0], p1 - before[1]))
            return e1, p1

        mark = self._disk_ecc_peri(sigma, vrad, vaz, omega_frame) \
            if track_ecc else None

        if stale_derived is not None:
            cs, press, h = stale_derived
        else:
            cs, press, h = self.derived(sigma, energy, bodies)
        pv = self.pvte_vals(sigma, energy)

        # self-gravity kick first (reference src/SourceEuler.cpp:438-441);
        # adiabatic runs refresh the kernel on the reference's cadence
        if self.selfgravity is not None:
            spectra = None
            if sg_kernel is not None:
                sg_kernel = self.selfgravity.update_kernel(
                    sg_kernel, sigma, h, g, row_w=self._own_col,
                    axis_name=self._axis_name)
                spectra = (sg_kernel[0], sg_kernel[1])
            g_r, g_t = self._sg_accels(sigma, spectra=spectra)
            vrad, vaz = self.selfgravity.kick(g, vrad, vaz, g_r, g_t, dt)

        pot = gravity.nbody_potential(
            phys, constants, g, bodies, self.n_bodies,
            self.cell_x, self.cell_y,
            h if stale_h is None else stale_h,
            indirect[0], indirect[1])
        vrad, vaz, energy = sources.update_with_sourceterms(
            phys, g, sigma, press, pot, vrad, vaz, energy, omega_frame,
            dt, pv)
        vrad, vaz, energy = jax.lax.optimization_barrier((vrad, vaz, energy))
        if track_ecc:
            mark = ecc_mark(mark)        # source-term delta

        with jax.named_scope("artvisc"):
            vrad, vaz, energy = artvisc.update_with_artificial_viscosity(
                phys, g, sigma, vrad, vaz, energy, dt)
        vrad, vaz, energy = jax.lax.optimization_barrier((vrad, vaz, energy))
        if track_ecc:
            mark = ecc_mark(mark)        # artificial-viscosity delta
        if phys.is_adiabatic and phys.artificial_viscosity_dissipation:
            # STALE grids: the reference floor reads pvte::get_* from the
            # last compute_gamma_mu (here: the step-start refresh)
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy,
                                              pv)

        # recalculate_viscosity (reference src/SourceEuler.cpp:205-223):
        # adiabatic cs/H respond to the energy updates above; under
        # AspectRatioMode>0 the H recompute sees the CURRENT body
        # positions (compute_scale_height at src/simulation.cpp:328/383)
        with jax.named_scope("viscosity"):
            cs, _, h = self.derived(sigma, energy, bodies)
            nu = self.viscosity_grid(cs, h, sigma, energy, bodies)
            tau_rr, tau_pp, tau_rp, div_v = visc_ops.viscous_stress_tensor(
                phys, g, sigma, vrad, vaz, nu)
            vrad, vaz = visc_ops.update_velocities_with_viscosity(
                phys, g, sigma, vrad, vaz, tau_rr, tau_pp, tau_rp, dt,
                nu=nu)
        vrad, vaz = jax.lax.optimization_barrier((vrad, vaz))
        if track_ecc:
            mark = ecc_mark(mark)        # viscosity delta

        qplus = jnp.zeros_like(sigma)
        qminus = jnp.zeros_like(sigma)
        pv_last = None
        if phys.is_adiabatic:
            pv3 = self.pvte_vals(sigma, energy)
            pv_last = pv3
            with jax.named_scope("energy"):
                energy, qplus, qminus = energy_ops.substep3(
                    phys, constants, g, sigma, energy, vrad, vaz, nu,
                    tau_rr, tau_pp, tau_rp, div_v, h,
                    self.ref_values.sigma0, self.ref_values.energy0,
                    jnp.zeros_like(sigma), time, dt, units=self.units,
                    irradiation_ctx=self.irradiation_ctx(bodies),
                    pvte_vals=pv3,
                    aspect_grid=self.aspect_grid(cs, h, bodies, pv3))
        return (sigma, vrad, vaz, energy, qplus, qminus,
                ecc_deltas if track_ecc else None, sg_kernel, h, nu,
                pv_last)

    def _sg_accels(self, sigma, spectra=None):
        """Self-gravity accelerations; under the explicit shard_map path
        the FFT convolution runs replicated on the all-gathered global
        Sigma (the reference parallelizes its FFT radially via FFTW-MPI,
        src/selfgravity.cpp:251-320; an all_gather + replicated transform
        is the JAX equivalent at these grid sizes)."""
        if self._sg_gather is None:
            return self.selfgravity.accelerations(sigma, spectra=spectra)
        g_r, g_t = self.selfgravity.accelerations(self._sg_gather(sigma),
                                                  spectra=spectra)
        return self._sg_window(g_r), self._sg_window(g_t)

    def _nbody_feedback_compute(self, sigma, h, nb, time, dt,
                                nb_indirect=None):
        """Disk-on-body accelerations + indirect terms WITHOUT applying
        them (the leapfrog evaluates forces before accretion and kicks
        after, reference src/simulation.cpp:295-308, :355-410)."""
        phys, constants, g = self.phys, self.constants, self.g
        zero = jnp.zeros((), self.dtype)
        bodies = self.bodies_on_grid(nb, time)
        dax = day = None
        it_disk_x = it_disk_y = zero
        if phys.disk_feedback and phys.calculate_disk:
            dax, day = gravity.disk_on_body_accel(
                phys, constants, g, bodies, self.n_bodies,
                self.cell_x, self.cell_y, h, sigma,
                row_w=self._own_int_col, axis_name=self._axis_name)
            it_disk_x, it_disk_y = gravity.indirect_term_disk(
                phys, bodies, self.n_hydroframe, dax, day)
        nb_it = nb if nb_indirect is None else nb_indirect
        if phys.indirect_term_mode == 0:
            it_nb_x, it_nb_y = gravity.indirect_term_nbody_predictor(
                constants, nb_it, self.n_hydroframe, self.n_bodies, dt)
        else:
            bodies_it = bodies if nb_indirect is None else \
                self.bodies_on_grid(nb_it, time)
            it_nb_x, it_nb_y = gravity.indirect_term_nbody(
                constants, bodies_it, self.n_hydroframe, self.n_bodies)
        return dax, day, (it_disk_x, it_disk_y), (it_nb_x, it_nb_y)

    def _nbody_apply_kicks(self, nb, dax, day, it_disk, it_nb, dt):
        if dax is not None:
            nb = nbody_sys.kick(nb, dax, day, dt)
        nb = nbody_sys.kick(nb, it_disk[0] + it_nb[0],
                            it_disk[1] + it_nb[1], dt)
        return nb

    def _nbody_feedback_kicks(self, sigma, h, nb, time, dt,
                              nb_indirect=None):
        """Disk force on the bodies + indirect terms; returns the kicked
        bodies and the indirect-term components. ``nb_indirect`` supplies
        the body state the N-body indirect term is evaluated from when it
        differs from ``nb`` (the leapfrog computes it forward-looking from
        the PRE-drift positions, reference src/simulation.cpp:287-291,
        while the feedback force uses the drifted positions)."""
        phys, constants, g = self.phys, self.constants, self.g
        zero = jnp.zeros((), self.dtype)
        bodies = self.bodies_on_grid(nb, time)
        it_disk_x = it_disk_y = zero
        if phys.disk_feedback and phys.calculate_disk:
            dax, day = gravity.disk_on_body_accel(
                phys, constants, g, bodies, self.n_bodies,
                self.cell_x, self.cell_y, h, sigma,
                row_w=self._own_int_col, axis_name=self._axis_name)
            nb = nbody_sys.kick(nb, dax, day, dt)
            it_disk_x, it_disk_y = gravity.indirect_term_disk(
                phys, bodies, self.n_hydroframe, dax, day)
        nb_it = nb if nb_indirect is None else nb_indirect
        if phys.indirect_term_mode == 0:   # REBOUND-predictor (reference
            # src/frame_of_reference.cpp:135-165, the default mode)
            it_nb_x, it_nb_y = gravity.indirect_term_nbody_predictor(
                constants, nb_it, self.n_hydroframe, self.n_bodies, dt)
        else:                              # Euler mode
            bodies_it = bodies if nb_indirect is None else \
                self.bodies_on_grid(nb_it, time)
            it_nb_x, it_nb_y = gravity.indirect_term_nbody(
                constants, bodies_it, self.n_hydroframe, self.n_bodies)
        nb = nbody_sys.kick(nb, it_disk_x + it_nb_x, it_disk_y + it_nb_y, dt)
        return nb, (it_disk_x, it_disk_y), (it_nb_x, it_nb_y)

    def _gas_kick(self, sigma, vrad, vaz, energy, nb, indirect, time, dt,
                  omega_frame, sor=None, sg_kernel=None, stale_derived=None,
                  stale_h=None):
        """Potential + source/viscosity/energy kicks over ``dt``."""
        phys, constants, g = self.phys, self.constants, self.g
        bodies = self.bodies_on_grid(nb, time)
        (sigma, vrad, vaz, energy, qplus, qminus,
         _ecc_deltas, sg_kernel, h_next, nu_next, pv_last) = self._substeps(
            sigma, vrad, vaz, energy, indirect, time, dt, omega_frame,
            bodies, sg_kernel=sg_kernel, stale_derived=stale_derived,
            stale_h=stale_h)
        sigma, vrad, vaz, energy = jax.lax.optimization_barrier(
            (sigma, vrad, vaz, energy))
        if self.fld is not None:
            # STALE pvte grids for the T/cs/H entering FLD (reference
            # fld.cpp:996-1000 reads pvte::get_* with no refresh)
            _, _, h_now = self.derived(sigma, energy, pv=pv_last)
            energy, _n_iter, sor = self.fld.radiative_diffusion(
                g, sigma, energy, h_now, dt, sor_state=sor,
                halo_fn=self._fld_halo_fn, shard_ctx=self._fld_shard_ctx)
            energy = eos.energy_floor_ceiling(phys, constants, sigma, energy,
                                              pv_last)
        return (sigma, vrad, vaz, energy, qplus, qminus, sor, sg_kernel,
                h_next, nu_next)

    def _step_leapfrog_impl(self, state: SystemState, time, dt):
        """Leapfrog step: gas kick-drift-kick, bodies drift-kick-drift
        (reference src/simulation.cpp:276-483 ``step_LeapFrog``)."""
        phys, constants, g = self.phys, self.constants, self.g
        f = state.fields
        sigma, vrad, vaz, energy = f.sigma, f.vrad, f.vaz, f.energy
        nb = state.nbody
        omega_frame = state.omega_frame
        hdt = 0.5 * dt
        mid_time = time + hdt

        # N-body drift 1/2; the indirect N-body term for kick 1 is
        # forward-looking from the PRE-drift positions (reference
        # src/simulation.cpp:287-291 computes it "while Nbody is still
        # at 'dt'")
        nb_pre_drift = nb
        nb = nbody_sys.integrate(nb, constants.G, hdt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)
        # orbital periods sampled ONCE here (the reference's
        # move_to_hydro_center_and_update_orbital_parameters after drift
        # 1/2, src/simulation.cpp:292) and reused by BOTH accretion halves
        # — the stored elements are NOT refreshed between the two calls
        # even though kicks/accretion change masses and velocities.
        acc_periods = None
        if self.any_accretion:
            from .ops import accretion as accretion_ops
            acc_periods = accretion_ops.orbital_periods(
                constants, nb, self.n_hydroframe)

        # derived quantities as the reference left them at the END of the
        # previous step (recalculate_derived_disk_quantities,
        # src/simulation.cpp:456): fields = this step's starting fields,
        # bodies = PRE-drift positions (matters for AspectRatioMode>0
        # where H depends on the body positions)
        bodies_prev = self.bodies_on_grid(nb_pre_drift, time)
        stale_cs, stale_press, h0 = self.derived(sigma, energy, bodies_prev)
        # the reference refreshes pressure only at the END of a step, so
        # kick 1's source terms see the PRE-accretion pressure; pass the
        # values captured here through to the first gas kick (see
        # _substeps docstring)
        stale_derived = (stale_cs, stale_press, h0) \
            if self.any_accretion else None
        # disk force + indirect terms are evaluated on the PRE-accretion
        # Sigma and applied AFTER accretion (reference
        # src/simulation.cpp:295-308: ComputeDiskOnNbodyAccel ->
        # AccreteOntoPlanets -> UpdatePlanetVelocitiesWithDiskForce)
        dax, day, it_disk, it_nb = self._nbody_feedback_compute(
            sigma, h0, nb, time, hdt, nb_indirect=nb_pre_drift)
        if phys.calculate_disk and self.any_accretion:
            from .ops import accretion as accretion_ops
            bodies = self.bodies_on_grid(nb, time)
            sigma, energy, nb = accretion_ops.accrete_onto_planets(
                phys, constants, g, nb, bodies,
                self.body_accretion_efficiency, self.body_accretion_types,
                self.cell_x, self.cell_y, sigma, energy, vrad, vaz,
                omega_frame, hdt,
                nu_grid=self._accretion_nu(sigma, energy, bodies_prev),
                row_w=self._own_act_col, axis_name=self._axis_name,
                periods=acc_periods)
            sigma = eos.apply_sigma_floor(phys, sigma)
        nb = self._nbody_apply_kicks(nb, dax, day, it_disk, it_nb, hdt)

        # frame rotation (half step); the swept angle is measured over
        # THIS half-drift (reference re-inits the corotation reference
        # right before the drift, src/simulation.cpp:289)
        if phys.corotating:
            kc = phys.corotation_reference_body
            omega_frame, vaz = self._corotation_update(
                state, nb, vaz, omega_frame, hdt,
                ref_xy=(nb_pre_drift.x[kc], nb_pre_drift.y[kc]))
        nb = nbody_sys.rotate(nb, omega_frame * hdt)
        frame_angle = state.frame_angle + omega_frame * hdt
        indirect = it_nb if not phys.indirect_term_disk_on_disk else \
            (it_disk[0] + it_nb[0], it_disk[1] + it_nb[1])

        particles = state.particles  # integrated in halves below
        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, hdt,
                time)

        if phys.calculate_disk:
            # gas kick 1/2 + drift 1/1
            sor = state.fld_sor
            sg_kernel = state.sg_kernel
            # kick 1's potential smoothing is the end-of-previous-step
            # scale height h0 (reference kick-1 CalculateNbodyPotential at
            # src/simulation.cpp:319 runs before any cs/H recompute; the
            # last one was :456 of the previous step, with the bodies at
            # their pre-drift positions)
            (sigma, vrad, vaz, energy, qplus, qminus, sor,
             sg_kernel, h_kick1, nu_kick1) = self._gas_kick(
                sigma, vrad, vaz, energy, nb, indirect, time, hdt,
                omega_frame, sor=sor, sg_kernel=sg_kernel,
                stale_derived=stale_derived, stale_h=h0)
            sigma, vrad, vaz, energy = self._apply_bcs(
                sigma, vrad, vaz, energy, omega_frame, nb=nb, time=time,
                stale_nu=nu_kick1)
            with jax.named_scope("transport"):
                sigma, vrad, vaz, energy, _mass_flux = transport.transport(
                    phys, g, sigma, vrad, vaz, energy, omega_frame, dt)
            sigma, vrad, vaz, energy = jax.lax.optimization_barrier(
                (sigma, vrad, vaz, energy))
            sigma = eos.apply_sigma_floor(phys, sigma)
            if phys.is_adiabatic:
                energy = eos.energy_floor_ceiling(phys, constants, sigma,
                                                  energy)

            # gas kick 2/2 (bodies still at x_{i+1/2}); the disk force
            # and indirect terms are computed here, BEFORE the gas kick
            # and the second accretion, and applied to the bodies after
            # (reference src/simulation.cpp:355-410).  The feedback
            # smoothing also uses the kick-1 scale height (the reference's
            # SCALE_HEIGHT is last written by recalculate_viscosity at
            # src/simulation.cpp:328 when ComputeDiskOnNbodyAccel runs
            # at :353)
            dax, day, it_disk, it_nb = self._nbody_feedback_compute(
                sigma, h0 if h_kick1 is None else h_kick1, nb, mid_time, hdt)
            indirect = it_nb if not phys.indirect_term_disk_on_disk else \
                (it_disk[0] + it_nb[0], it_disk[1] + it_nb[1])
            # kick 2's potential smoothing uses the scale height from
            # kick 1's viscosity recompute (reference src/simulation.cpp:363
            # runs before any cs/H refresh — see _substeps docstring)
            (sigma, vrad, vaz, energy, qplus, qminus, sor,
             sg_kernel, _h2, nu_kick2) = self._gas_kick(
                sigma, vrad, vaz, energy, nb, indirect, mid_time, hdt,
                omega_frame, sor=sor, sg_kernel=sg_kernel, stale_h=h_kick1)
        else:
            qplus, qminus = state.qplus, state.qminus
            sor = state.fld_sor
            sg_kernel = state.sg_kernel
            # pure N-body run: the second-half indirect terms still apply
            # (reference :410 apply_indirect_term_on_Nbody is ungated)
            dax, day, it_disk, it_nb = self._nbody_feedback_compute(
                sigma, h0, nb, mid_time, hdt)

        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, hdt,
                mid_time)

        # accretion (second half), then the stored disk/indirect kicks,
        # then N-body drift 2/2 (reference src/simulation.cpp:403-417)
        if phys.calculate_disk and self.any_accretion:
            from .ops import accretion as accretion_ops
            bodies = self.bodies_on_grid(nb, mid_time)
            sigma, energy, nb = accretion_ops.accrete_onto_planets(
                phys, constants, g, nb, bodies,
                self.body_accretion_efficiency, self.body_accretion_types,
                self.cell_x, self.cell_y, sigma, energy, vrad, vaz,
                omega_frame, hdt,
                nu_grid=(nu_kick2 if nu_kick2 is not None
                         else self._accretion_nu(sigma, energy, bodies)),
                row_w=self._own_act_col, axis_name=self._axis_name,
                periods=acc_periods)
            sigma = eos.apply_sigma_floor(phys, sigma)
        nb = self._nbody_apply_kicks(nb, dax, day, it_disk, it_nb, hdt)
        nb_pre_drift2 = nb
        nb = nbody_sys.integrate(nb, constants.G, hdt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)
        if phys.corotating:
            kc = phys.corotation_reference_body
            omega_frame, vaz = self._corotation_update(
                state, nb, vaz, omega_frame, hdt,
                ref_xy=(nb_pre_drift2.x[kc], nb_pre_drift2.y[kc]))
        nb = nbody_sys.rotate(nb, omega_frame * hdt)
        frame_angle = frame_angle + omega_frame * hdt
        if phys.integrate_particles and particles is not None:
            particles = particles.replace(
                phi=jnp.mod(particles.phi - omega_frame * dt, 2.0 * jnp.pi))

        monitor_acc = state.monitor_acc
        if phys.calculate_disk:
            sigma, vrad, vaz, energy, dmp = self._apply_bcs(
                sigma, vrad, vaz, energy, omega_frame, final=True, dt=dt,
                nb=nb, time=time + dt, want_damping_delta=True,
                stale_nu=nu_kick2)
            if phys.keep_mass_constant:
                sigma = self._rescale_to_initial_mass(sigma)
            f_in = self._face_row(_mass_flux, "inner")
            f_out = self._face_row(_mass_flux, "outer")
            md = monitor_acc.mass_delta
            md = md.at[MD_INNER_IN].add(jnp.sum(jnp.maximum(f_in, 0.0)))
            md = md.at[MD_INNER_OUT].add(jnp.sum(jnp.maximum(-f_in, 0.0)))
            md = md.at[MD_OUTER_OUT].add(jnp.sum(jnp.maximum(f_out, 0.0)))
            md = md.at[MD_OUTER_IN].add(jnp.sum(jnp.maximum(-f_out, 0.0)))
            for i in range(4):
                md = md.at[MD_DAMP_IN_CREATE + i].add(dmp[i])
            monitor_acc = monitor_acc.replace(mass_delta=md)
            monitor_acc = self._update_monitor_acc(
                monitor_acc, _mass_flux, sigma, vrad, vaz, energy,
                self.bodies_on_grid(nb, mid_time), indirect, dt)

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, omega_frame=omega_frame,
            frame_angle=frame_angle, particles=particles,
            monitor_acc=monitor_acc, fld_sor=sor, sg_kernel=sg_kernel)

    def _rescale_to_initial_mass(self, sigma):
        """KeepDiskMassConstant: rescale Sigma so the active-disk mass stays
        at its initial value (reference src/simulation.cpp:246-251,
        :476-481)."""
        from .ops import quantities as quant
        rmax = self.geometry.rmax
        m0 = quant.total_mass(self.phys, self.g, self.ref_values.sigma0,
                              rmax, self._own_int_col, self._axis_name)
        m_new = quant.total_mass(self.phys, self.g, sigma, rmax,
                                 self._own_int_col, self._axis_name)
        return sigma * (m0 / m_new)

    def _update_monitor_acc(self, acc, mass_flux, sigma, vrad, vaz, energy,
                            bodies, indirect, dt):
        """Accumulate the enabled monitor grids after a hydro step
        (reference src/quantities.cpp:976-998 + TransportEuler.cpp:610-616).
        Accumulates raw increments (mass; torque*dt); the writer divides by
        Nmonitor*monitor_timestep at output time."""
        phys, g = self.phys, self.g
        if acc is None or not (phys.write_massflow or phys.write_gas_torques
                               or phys.write_alpha_grav_mean
                               or phys.write_alpha_reynolds_mean):
            return acc
        from .ops import quantities as quant
        kw = {}
        cs_a = None
        if phys.write_alpha_grav_mean or phys.write_alpha_reynolds_mean:
            cs_a, _, _ = self.derived(sigma, energy)
        if phys.write_alpha_reynolds_mean and acc.alpha_reynolds_mean \
                is not None:
            t_rey = quant.reynolds_stress(g, sigma, vrad, vaz)
            kw["alpha_reynolds_mean"] = acc.alpha_reynolds_mean \
                + quant.alpha_from_stress(t_rey, sigma, cs_a) * dt
        if phys.write_alpha_grav_mean and acc.alpha_grav_mean is not None:
            if self.selfgravity is not None:
                g_r, g_t = self._sg_accels(sigma)
                t_gravs = quant.gravitational_stress(
                    phys, self.constants, g, g_r, g_t)
            else:
                t_gravs = jnp.zeros_like(sigma)
            kw["alpha_grav_mean"] = acc.alpha_grav_mean \
                + quant.alpha_from_stress(t_gravs, sigma, cs_a) * dt
        if phys.write_massflow and acc.massflow is not None:
            nr = g.nrad
            mf = acc.massflow + mass_flux[:nr]
            kw["massflow"] = mf.at[nr - 1].add(mass_flux[nr])
        if phys.write_gas_torques and acc.t_adv is not None:
            cs, _, h = self.derived(sigma, energy)
            nu = self.viscosity_grid(cs, h)
            kw["t_adv"] = acc.t_adv + quant.advection_torque_increment(
                g, sigma, vrad, vaz, dt)
            kw["t_visc"] = acc.t_visc + quant.viscous_torque_increment(
                g, sigma, nu, vrad, vaz, dt)
            pot = gravity.nbody_potential(
                phys, self.constants, g, bodies, self.n_bodies,
                self.cell_x, self.cell_y, h, indirect[0], indirect[1])
            kw["t_grav"] = acc.t_grav + quant.gravitational_torque_increment(
                g, sigma, pot, dt)
        return acc.replace(**kw)

    def initial_monitor_acc(self) -> MonitorAccum:
        phys = self.phys
        z = jnp.zeros((self.geometry.nrad, self.geometry.naz), self.dtype)
        z5 = jnp.zeros((5,), self.dtype)
        return MonitorAccum(
            massflow=z if phys.write_massflow else None,
            t_adv=z if phys.write_gas_torques else None,
            t_visc=z if phys.write_gas_torques else None,
            t_grav=z if phys.write_gas_torques else None,
            alpha_grav_mean=z if phys.write_alpha_grav_mean else None,
            alpha_reynolds_mean=z if phys.write_alpha_reynolds_mean
            else None,
            mass_delta=jnp.zeros((N_MASS_DELTA,), self.dtype),
            rof_mdot=jnp.zeros((), self.dtype)
            if phys.rochelobe_overflow else None,
            decc=z5 if phys.write_ecc_changes else None,
            dperi=z5 if phys.write_ecc_changes else None)

    def _disk_ecc_peri(self, sigma, vrad, vaz, omega_frame):
        """Mass-averaged disk eccentricity / pericenter for the
        ecc-growth monitor (reference src/quantities.cpp
        ``calculate_disk_delta_ecc_peri``; the in-step deltas are
        frame-angle invariant, so angle 0 is used)."""
        from .ops import quantities as quant
        zero = jnp.zeros((), self.dtype)
        return quant.disk_ecc_peri(
            self.phys, self.constants, self.g, sigma, vrad, vaz,
            omega_frame, zero, self.cos_row, self.sin_row,
            2.0 * self.geometry.rmax,
            row_w=self._own_int_col, axis_name=self._axis_name)

    def _corotation_update(self, state, nb, vaz, omega_frame, dt,
                           ref_xy=None):
        """Corotating frame: measure the reference body's swept angle since
        the stored reference position, update Omega and correct v_az
        (reference src/frame_of_reference.cpp:30-52 ``handle_corotation``).
        The Euler step measures against the position stored at init (the
        reference calls init_corotation only in sim::init); the leapfrog
        re-inits before each half-drift (src/simulation.cpp:289, :413) and
        passes that position via ``ref_xy``."""
        k = self.phys.corotation_reference_body
        x, y = nb.x[k], nb.y[k]
        if ref_xy is not None:
            ox, oy = ref_xy
        else:
            ox, oy = state.corot_ref_x, state.corot_ref_y
        cross = ox * y - x * oy
        # the reference computes asin(cross/(d_new*d_old)); atan2 of
        # (cross, dot) is the same swept angle (dot > 0 for any half-step)
        # and is better conditioned than arcsin near the result's extremes
        dot = ox * x + oy * y
        omega_new = jnp.arctan2(cross, dot) / dt
        domega = omega_new - omega_frame
        vaz = vaz - domega * self.g.rb
        return omega_new, vaz

    def _integrate_particles(self, sigma, vrad, vaz, energy, nb, particles,
                             omega_frame, dt, time):
        if self._particle_shard_ctx is not None:
            return self._integrate_particles_sharded(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, dt,
                time)
        if self._particle_gather is not None:
            # explicit shard_map path: the replicated swarm integrates on
            # all-gathered global fields with the global stepper (the
            # SURVEY-sanctioned replicated-particle substitution; the
            # reference migrates particles between radial MPI domains,
            # src/particles/particles.cpp:259-420)
            sigma, vrad, vaz, energy = self._particle_gather(
                sigma, vrad, vaz, energy)
            return self._global_stepper._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, dt,
                time)
        return self._particle_core(sigma, vrad, vaz, energy, nb, particles,
                                   omega_frame, dt, time, self.geometry)

    def _particle_core(self, sigma, vrad, vaz, energy, nb, particles,
                       omega_frame, dt, time, geom_np):
        """Drag + gravity integration (+ diffusion) of one swarm against
        the fields of THIS stepper's grid (global, or one shard's
        extended window with ``geom_np`` holding the window rmed/radii)."""
        from .particles import dust
        phys, constants, g = self.phys, self.constants, self.g
        pp = self.particle_params or dust.ParticleParams()
        cs0, press, h0 = self.derived(sigma, energy)
        # temperature as the reference's particles sample it
        # (data[TEMPERATURE], i.e. per-cell variable gamma/mu for PVTE —
        # compute_temperature src/SourceEuler.cpp:1475-1505); the pvte
        # grids are the memoized step-start refresh, no extra solve
        temp = eos.temperature(phys, constants, sigma, energy, press,
                               self.pvte_vals(sigma, energy))
        rho_mid = sigma / (phys.density_factor * h0)
        bodies = self.bodies_on_grid(nb, time)
        integ = dust.integrate_rk45 if pp.integrator.startswith(
            ("e", "a", "r")) else dust.integrate_expmid
        sg_accel = None
        if pp.disk_gravity and self.selfgravity is not None:
            sg_accel = self._sg_accels(sigma)
        particles = integ(
            phys, pp, constants, self.units, geom_np, g, particles,
            rho_mid, temp, vrad, vaz, bodies, self.n_bodies, omega_frame, dt,
            sg_accel=sg_accel)
        if pp.diffusion:
            particles = dust.diffuse_dust(
                phys, constants, geom_np, g, particles, rho_mid,
                cs0, h0, dt)
        return particles

    def _integrate_particles_sharded(self, sigma, vrad, vaz, energy, nb,
                                     sp, omega_frame, dt, time):
        """Slab-owned particle buckets (particles/sharded.py): integrate
        this shard's slots against the local extended-window fields, then
        migrate boundary-crossers to the neighbor shards — the
        rebuild of the reference's per-rank particle integration + MPI
        move sweep (src/particles/particles.cpp:259-420, :2016-2160)."""
        from .particles import dust
        from .particles import sharded as psh

        ctx = self._particle_shard_ctx
        local = dust.ParticleState(
            r=sp.r, phi=sp.phi, r_dot=sp.r_dot, phi_dot=sp.phi_dot,
            size=sp.size, stokes=sp.stokes,
            alive=sp.alive & sp.valid,      # empty slots stay frozen
            rng_key=sp.rng_key[0],
            timestep=sp.timestep, facold=sp.facold)
        local = self._particle_core(sigma, vrad, vaz, energy, nb, local,
                                    omega_frame, dt, time, ctx["geom"])
        spl = {name: getattr(local, name) for name in psh._FIELDS}
        spl["alive"] = local.alive          # escape deaths recorded
        spl["valid"] = sp.valid
        spl["pid"] = sp.pid
        spl["overflow"] = sp.overflow[0]
        out = psh.migrate(spl, ctx["own_lo"], ctx["own_hi"],
                          ctx["is_top"], ctx["is_bot"], ctx["E"],
                          self._axis_name, ctx["n"])
        return sp.replace(
            **{name: out[name] for name in psh._FIELDS},
            alive=out["alive"], valid=out["valid"], pid=out["pid"],
            rng_key=local.rng_key[None, :],
            overflow=out["overflow"][None])

    def _step_impl(self, state: SystemState, time, dt):
        """One hydro step.  Wraps the integrator cores with the PVTE
        warm-start chain scope: the chain starts from the state-carried
        ``pvte_guess`` (the previous step's final refresh), every
        ``pvte_vals`` miss advances it, and the final link is written back
        so the NEXT step's first refresh is warm too."""
        self._pvte_chain = state.pvte_guess
        try:
            if self.phys.hydro_integrator == LEAPFROG:
                new_state = self._step_leapfrog_impl(state, time, dt)
            else:
                new_state = self._step_euler_impl(state, time, dt)
            chain = getattr(self, "_pvte_chain", None)
            if state.pvte_guess is not None and chain is not None:
                new_state = new_state.replace(pvte_guess=chain)
            return new_state
        finally:
            self._pvte_chain = None

    def _step_euler_impl(self, state: SystemState, time, dt):
        """One Euler step (reference src/simulation.cpp:148-274)."""
        phys, constants, g = self.phys, self.constants, self.g
        f = state.fields
        sigma, vrad, vaz, energy = f.sigma, f.vrad, f.vaz, f.energy
        nb = state.nbody
        omega_frame = state.omega_frame

        zero = jnp.zeros((), self.dtype)
        bodies = self.bodies_on_grid(nb, time)
        cs0, press0, h0 = self.derived(sigma, energy, bodies)
        # pre-accretion derived values for the source kick (the reference
        # refreshes pressure only at step END, after accretion already ran
        # this step — see _substeps docstring)
        stale_derived = (cs0, press0, h0) if self.any_accretion else None

        # --- accretion onto planets (reference :150-153) ---
        if phys.calculate_disk and self.any_accretion:
            from .ops import accretion as accretion_ops
            sigma, energy, nb = accretion_ops.accrete_onto_planets(
                phys, constants, g, nb, bodies,
                self.body_accretion_efficiency, self.body_accretion_types,
                self.cell_x, self.cell_y, sigma, energy, vrad, vaz,
                omega_frame, dt,
                nu_grid=self._accretion_nu(sigma, energy, bodies),
                row_w=self._own_act_col, axis_name=self._axis_name)
            sigma = eos.apply_sigma_floor(phys, sigma)
            bodies = self.bodies_on_grid(nb, time)

        # --- disk feedback on the bodies (reference :154-158) ---
        it_disk_x = it_disk_y = zero
        if phys.disk_feedback and phys.calculate_disk:
            dax, day = gravity.disk_on_body_accel(
                phys, constants, g, bodies, self.n_bodies,
                self.cell_x, self.cell_y, h0, sigma,
                row_w=self._own_int_col, axis_name=self._axis_name)
            nb = nbody_sys.kick(nb, dax, day, dt)
            it_disk_x, it_disk_y = gravity.indirect_term_disk(
                phys, bodies, self.n_hydroframe, dax, day)

        # --- N-body indirect term (reference :160-166); mode 0 uses the
        # high-order-predictor formulation, mode 1 the Euler sum ---
        if phys.indirect_term_mode == 0:
            it_nb_x, it_nb_y = gravity.indirect_term_nbody_predictor(
                constants, nb, self.n_hydroframe, self.n_bodies, dt)
        else:
            it_nb_x, it_nb_y = gravity.indirect_term_nbody(
                constants, bodies, self.n_hydroframe, self.n_bodies)
        it_x = it_disk_x + it_nb_x
        it_y = it_disk_y + it_nb_y
        nb = nbody_sys.kick(nb, it_x, it_y, dt)

        # --- indirect term entering the gas potential (reference :168-176;
        # the potential itself is evaluated inside _substeps) ---
        if phys.indirect_term_disk_on_disk:
            pot_it = (it_x, it_y)
        else:
            pot_it = (it_nb_x, it_nb_y)

        # --- dust particles (reference :178-182 particles::integrate) ---
        sor = state.fld_sor
        particles = state.particles
        if phys.integrate_particles and particles is not None:
            particles = self._integrate_particles(
                sigma, vrad, vaz, energy, nb, particles, omega_frame, dt,
                time)

        # --- frame rotation (reference :186 handle_corotation) ---
        if phys.corotating:
            omega_frame, vaz = self._corotation_update(
                state, nb, vaz, omega_frame, dt)
        nb = nbody_sys.rotate(nb, omega_frame * dt)
        if phys.integrate_particles and particles is not None:
            # particles rotate with the frame (reference particles::rotate)
            particles = particles.replace(
                phi=jnp.mod(particles.phi - omega_frame * dt, 2.0 * jnp.pi))
        frame_angle = state.frame_angle + omega_frame * dt

        # --- gas substeps ---
        sg_kernel = state.sg_kernel
        if phys.calculate_disk:
            (sigma, vrad, vaz, energy, qplus, qminus,
             _ecc_deltas, sg_kernel, _h_next, nu_step,
             pv_last) = self._substeps(
                sigma, vrad, vaz, energy, pot_it, time, dt, omega_frame,
                bodies, sg_kernel=sg_kernel, stale_derived=stale_derived)
            # compile-time guard: stop XLA's algebraic simplifier from
            # chasing simplifications across substep boundaries — the long
            # chains of azimuthal rolls (concat-of-slices) otherwise blow
            # XLA's compile time up
            sigma, vrad, vaz, energy = jax.lax.optimization_barrier(
                (sigma, vrad, vaz, energy))
        else:
            qplus, qminus = state.qplus, state.qminus

        # FLD radiative diffusion — "can be done independent of the hydro
        # simulation": the reference's Euler step runs it OUTSIDE the
        # calculate_disk gate (src/simulation.cpp:205-208), which is what
        # makes pure-diffusion setups like test/FLD1D (Disk: no) evolve
        if self.fld is not None:
            # STALE pvte grids for the T/cs/H entering FLD (reference
            # fld.cpp:996-1000 reads pvte::get_* with no refresh)
            energy_floor_pv = pv_last if phys.calculate_disk else None
            _, _, h_now = self.derived(sigma, energy, pv=energy_floor_pv)
            energy, _n_iter, sor = self.fld.radiative_diffusion(
                g, sigma, energy, h_now, dt, sor_state=sor,
                halo_fn=self._fld_halo_fn,
                shard_ctx=self._fld_shard_ctx)
            energy = eos.energy_floor_ceiling(phys, constants, sigma,
                                              energy, energy_floor_pv)

        if phys.calculate_disk:
            # boundary conditions before transport (final=false); the
            # viscous BC reads the in-kick viscosity grid (reference
            # data[VISCOSITY] from recalculate_viscosity at
            # src/simulation.cpp:196)
            sigma, vrad, vaz, energy = self._apply_bcs(
                sigma, vrad, vaz, energy, omega_frame, nb=nb, time=time,
                stale_nu=nu_step)

            if phys.write_ecc_changes:
                _ecc_pre_t = self._disk_ecc_peri(sigma, vrad, vaz,
                                                 omega_frame)
            with jax.named_scope("transport"):
                sigma, vrad, vaz, energy, _mass_flux = transport.transport(
                    phys, g, sigma, vrad, vaz, energy, omega_frame, dt)
            sigma, vrad, vaz, energy = jax.lax.optimization_barrier(
                (sigma, vrad, vaz, energy))
            _sig_pre_floor = sigma
            sigma = eos.apply_sigma_floor(phys, sigma)
            if self._own_int_col is not None:
                _floor_created = self._sum_cells(
                    (sigma - _sig_pre_floor) * g.surf, self._own_int_col)
            else:
                _floor_created = jnp.sum(
                    ((sigma - _sig_pre_floor) * g.surf)[1:g.nrad - 1])
            if phys.is_adiabatic:
                energy = eos.energy_floor_ceiling(phys, constants, sigma,
                                                  energy)

        # --- N-body drift under mutual gravity (reference :218-221) ---
        nb = nbody_sys.integrate(nb, constants.G, dt,
                                 method=phys.nbody_integrator)
        nb = nbody_sys.move_to_hydro_frame_center(nb, self.n_hydroframe)

        monitor_acc = state.monitor_acc
        if phys.calculate_disk:
            # ROF massflow tracker (reference src/massflow_tracker.cpp):
            # exponentially averaged accretion rate through the inner face
            rof_mdot = None
            if phys.rochelobe_overflow and monitor_acc.rof_mdot is not None:
                delta = -jnp.sum(self._face_row(_mass_flux, "inner"))
                t_avg = max(self.body_period_host[phys.rof_planet]
                            * phys.rof_averaging_time, 1e-12) \
                    if self.n_bodies > 1 else 1e-12
                alpha = jnp.minimum(dt / t_avg, 1.0)
                rof_mdot = (1.0 - alpha) * monitor_acc.rof_mdot \
                    + alpha * delta / dt
                monitor_acc = monitor_acc.replace(rof_mdot=rof_mdot)

            if phys.write_ecc_changes:
                _e_t, _p_t = self._disk_ecc_peri(sigma, vrad, vaz,
                                                 omega_frame)
                _d_transport = (_e_t - _ecc_pre_t[0], _p_t - _ecc_pre_t[1])

            # final boundary conditions (+ damping, when enabled)
            sigma, vrad, vaz, energy, dmp = self._apply_bcs(
                sigma, vrad, vaz, energy, omega_frame, final=True, dt=dt,
                nb=nb, time=time, rof_mdot=rof_mdot,
                want_damping_delta=True, stale_nu=nu_step)
            if phys.keep_mass_constant:
                sigma = self._rescale_to_initial_mass(sigma)
            if phys.write_ecc_changes and monitor_acc.decc is not None:
                _e_d, _p_d = self._disk_ecc_peri(sigma, vrad, vaz,
                                                 omega_frame)
                stages = list(_ecc_deltas) + [
                    _d_transport, (_e_d - _e_t, _p_d - _p_t)]
                monitor_acc = monitor_acc.replace(
                    decc=monitor_acc.decc
                    + jnp.stack([s[0] for s in stages]),
                    dperi=monitor_acc.dperi
                    + jnp.stack([s[1] for s in stages]))

            # boundary / damping / floor mass bookkeeping (reference
            # src/TransportEuler.cpp:575-608 + src/types.h:30-60)
            f_in = self._face_row(_mass_flux, "inner")
            f_out = self._face_row(_mass_flux, "outer")
            md = monitor_acc.mass_delta
            md = md.at[MD_INNER_IN].add(jnp.sum(jnp.maximum(f_in, 0.0)))
            md = md.at[MD_INNER_OUT].add(jnp.sum(jnp.maximum(-f_in, 0.0)))
            md = md.at[MD_OUTER_OUT].add(jnp.sum(jnp.maximum(f_out, 0.0)))
            md = md.at[MD_OUTER_IN].add(jnp.sum(jnp.maximum(-f_out, 0.0)))
            md = md.at[MD_DAMP_IN_CREATE].add(dmp[0])
            md = md.at[MD_DAMP_IN_REMOVE].add(dmp[1])
            md = md.at[MD_DAMP_OUT_CREATE].add(dmp[2])
            md = md.at[MD_DAMP_OUT_REMOVE].add(dmp[3])
            md = md.at[MD_FLOOR_CREATE].add(_floor_created)
            monitor_acc = monitor_acc.replace(mass_delta=md)

            monitor_acc = self._update_monitor_acc(
                monitor_acc, _mass_flux, sigma, vrad, vaz, energy,
                self.bodies_on_grid(nb, time), pot_it, dt)

        return state.replace(
            fields=FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy),
            qplus=qplus, qminus=qminus, nbody=nb, omega_frame=omega_frame,
            frame_angle=frame_angle, particles=particles,
            monitor_acc=monitor_acc, fld_sor=sor, sg_kernel=sg_kernel)

    def _cfl_impl(self, state: SystemState, time=None):
        # PVTE: warm the CFL's EoS refresh from the state-carried cache
        # (read-only scope — CFL runs at the same state the following
        # step starts from; the step's own scope re-seeds the chain)
        self._pvte_chain = state.pvte_guess
        try:
            return self._cfl_impl_core(state, time)
        finally:
            self._pvte_chain = None

    def _cfl_impl_core(self, state: SystemState, time=None):
        phys = self.phys
        f = state.fields
        # the reference CFL consumes the SOUNDSPEED/VISCOSITY grids left by
        # the end-of-step recalculate (bodies at their end-of-step
        # positions) — under AspectRatioMode>0 the nu(H) term needs them
        cfl_bodies = None
        if phys.aspectratio_mode in (1, 2) or phys.alpha_mode != 0:
            cfl_bodies = self.bodies_on_grid(
                state.nbody, time if time is not None else 0.0)
        cs, press, h = self.derived(f.sigma, f.energy, cfl_bodies)
        nu = self.viscosity_grid(cs, h, f.sigma, f.energy, cfl_bodies)
        dt = cfl.condition_cfl(phys, self.g, f.sigma, f.vrad, f.vaz,
                               f.energy, cs, nu, state.qplus, state.qminus)
        if self._axis_name is not None:
            # the reference's MPI_Allreduce(MIN) (src/cfl.cpp:379); every
            # interior ring is covered by at least one shard's window
            dt = jax.lax.pmin(dt, self._axis_name)
        return dt

    def _advance_impl(self, state: SystemState, time, last_dt, t_target,
                      step_cap):
        """Advance to ``t_target`` (one monitor interval) entirely on-device
        with a ``lax.while_loop`` — replaces the reference's host loop
        (src/simulation.cpp:505-560) including the exact dt clamping rules:
        dt = min(CFL_max_var * last_dt, cfl_dt), stretched/clamped to land
        exactly on the monitor boundary (:541-552).  ``step_cap`` (traced
        int32) bounds the loop so ``advance_to`` can split the interval
        across several device calls.

        Returns (state, time, last_dt, n_steps, dt_min, dt_max, dt_sum,
        dt_sum_sq).
        """
        dtype = self.dtype
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)

        def cond(carry):
            return jnp.logical_not(carry[-1]) & (carry[3] < step_cap)

        def body(carry):
            (state, time, last_dt, n, dmin, dmax, dsum, dsq, _done) = carry
            if self._halo_refresh is not None:
                # explicit shard_map path: one bidirectional ppermute
                # refreshing every halo ring before CFL + step (the
                # reference's once-per-step CommunicateBoundaries,
                # src/commbound.cpp:98)
                state = self._halo_refresh(state)
            if self.phys.calculate_disk:
                cfl_dt = self._cfl_impl(state, time)
                dt = jnp.minimum(self.phys.cfl_max_var * last_dt, cfl_dt)
            else:
                # Disk: no — the reference keeps dt = last_dt without a
                # CFL evaluation (src/simulation.cpp:100-117)
                dt = last_dt
            time_left = t_target - time
            clamp = (dt > time_left) | (time_left < dt * 1.05)
            step_dt = jnp.where(clamp, time_left, dt)
            state = self._step_impl(state, time, step_dt)
            time = jnp.where(clamp, t_target, time + step_dt)
            # last_dt carries the unclamped dt (reference
            # src/simulation.cpp:100-117)
            return (state, time, dt, n + 1,
                    jnp.minimum(dmin, step_dt), jnp.maximum(dmax, step_dt),
                    dsum + step_dt, dsq + step_dt * step_dt, clamp)

        zero = jnp.zeros((), dtype)
        init = (state, jnp.asarray(time, dtype), jnp.asarray(last_dt, dtype),
                jnp.zeros((), jnp.int32), big, zero, zero, zero,
                jnp.asarray(False))
        out = jax.lax.while_loop(cond, body, init)
        return out[:-1]

    # public API ---------------------------------------------------------
    def advance_to(self, state: SystemState, time, last_dt, t_target):
        """Advance to ``t_target``, chunking the on-device while_loop into
        executions of at most ``max_steps_per_call`` steps (host loop with
        one sync per chunk; the dt sequence is identical to a single call
        because every step depends only on the carried state)."""
        time = jnp.asarray(time, self.dtype)
        last_dt = jnp.asarray(last_dt, self.dtype)
        t_target = jnp.asarray(t_target, self.dtype)
        cap = self.max_steps_per_call
        cap32 = jnp.asarray(cap if cap > 0 else 2 ** 31 - 1, jnp.int32)
        (state, time, last_dt, n, dmin, dmax, dsum,
         dsq) = self._advance(state, time, last_dt, t_target, cap32)
        if cap <= 0:
            return state, time, last_dt, n, dmin, dmax, dsum, dsq
        while float(time) < float(t_target):
            (state, time, last_dt, n2, dmin2, dmax2, dsum2,
             dsq2) = self._advance(state, time, last_dt, t_target, cap32)
            n = n + n2
            dmin = jnp.minimum(dmin, dmin2)
            dmax = jnp.maximum(dmax, dmax2)
            dsum = dsum + dsum2
            dsq = dsq + dsq2
        return state, time, last_dt, n, dmin, dmax, dsum, dsq

    def step(self, state: SystemState, time, dt):
        return self._step(state, jnp.asarray(time, self.dtype),
                          jnp.asarray(dt, self.dtype))

    def cfl_dt(self, state: SystemState, time=0.0) -> jax.Array:
        return self._cfl(state, jnp.asarray(time, self.dtype))

    def initial_system_state(self, fields: FieldState,
                             nbody: NBodyState) -> SystemState:
        """Assemble the run state; Q+/Q- seeded as at init (reference
        src/SourceEuler.cpp:1507-1547 ``compute_heating_cooling_for_CFL``)."""
        phys, constants, g = self.phys, self.constants, self.g
        z = jnp.zeros((self.geometry.nrad, self.geometry.naz), self.dtype)
        qplus, qminus = z, z
        if phys.is_adiabatic:
            sigma, energy = fields.sigma, fields.energy
            bodies = self.bodies_on_grid(nbody, 0.0)
            cs, _, h = self.derived(sigma, energy, bodies)
            nu = self.viscosity_grid(cs, h, sigma, energy, bodies)
            tau_rr, tau_pp, tau_rp, div_v = visc_ops.viscous_stress_tensor(
                phys, g, sigma, fields.vrad, fields.vaz, nu)
            _, qplus, qminus = energy_ops.substep3(
                phys, constants, g, sigma, energy, fields.vrad, fields.vaz,
                nu, tau_rr, tau_pp, tau_rp, div_v, h,
                self.ref_values.sigma0, self.ref_values.energy0,
                jnp.zeros_like(sigma), 0.0, 0.0,
                units=self.units, irradiation_ctx=self.irradiation_ctx(bodies),
                aspect_grid=self.aspect_grid(cs, h, bodies))
        k = min(phys.corotation_reference_body, self.n_bodies - 1)
        omega0 = phys.omega_frame
        if phys.corotating and self.n_bodies > 1:
            # start corotating with the reference body's angular velocity
            x, y = float(nbody.x[k]), float(nbody.y[k])
            vx, vy = float(nbody.vx[k]), float(nbody.vy[k])
            omega0 = (x * vy - y * vx) / max(x * x + y * y, 1e-300)
        fld_sor = None
        if self.fld is not None and self.fld.config.auto_omega:
            fld_sor = self.fld.initial_sor_state(self.dtype)
        sg_kernel = None
        if (self.selfgravity is not None and phys.is_adiabatic
                and self.selfgravity.supports_in_run_update()):
            sg_kernel = self.selfgravity.initial_kernel_state()
        pvte_guess = None
        if self.pvte is not None and self.pvte.fast:
            # seed the warm-start cache with a COLD solve on the ICs so
            # every in-step refresh (including step 1's) is the short
            # Newton polish — the full bisection hybrid never appears in
            # the step graph
            pv = self.pvte_vals(fields.sigma, fields.energy)
            pvte_guess = (pv[0], pv[1])
        return SystemState(
            fields=fields, qplus=qplus, qminus=qminus, nbody=nbody,
            omega_frame=jnp.asarray(omega0, self.dtype),
            frame_angle=jnp.zeros((), self.dtype),
            corot_ref_x=nbody.x[k], corot_ref_y=nbody.y[k],
            monitor_acc=self.initial_monitor_acc(), fld_sor=fld_sor,
            sg_kernel=sg_kernel, pvte_guess=pvte_guess)

    def disk_torques(self, state: SystemState, time=0.0):
        """Specific torque of the gas disk on each body,
        Gamma_k = m_k (x_k a_y - y_k a_x) (reference src/output.cpp
        ``write_torques`` path via ComputeDiskOnNbodyAccel)."""
        def impl(state, time):
            f = state.fields
            _, _, h = self.derived(f.sigma, f.energy)
            bodies = self.bodies_on_grid(state.nbody, time)
            ax, ay = gravity.disk_on_body_accel(
                self.phys, self.constants, self.g, bodies, self.n_bodies,
                self.cell_x, self.cell_y, h, f.sigma)
            return state.nbody.mass * (state.nbody.x * ay
                                       - state.nbody.y * ax)
        if not hasattr(self, "_disk_torques"):
            self._disk_torques = jax.jit(impl)
        return self._disk_torques(state, jnp.asarray(time, self.dtype))

    def apply_bcs(self, fields: FieldState, nb=None) -> FieldState:
        """Standalone BC application (used once at init, reference
        src/init.cpp:337-341); ``nb`` enables the body-dependent BCs
        (center-of-mass, Roche-lobe overflow)."""
        omega_frame = jnp.asarray(self.phys.omega_frame, self.dtype)
        sigma, vrad, vaz, energy = self._apply_bcs(
            fields.sigma, fields.vrad, fields.vaz, fields.energy,
            omega_frame, nb=nb, time=0.0)
        return FieldState(sigma=sigma, vrad=vrad, vaz=vaz, energy=energy)


def make_ref_values(fields: FieldState) -> RefValues:
    return RefValues(sigma0=fields.sigma, energy0=fields.energy,
                     vrad0=fields.vrad, vaz0=fields.vaz)
