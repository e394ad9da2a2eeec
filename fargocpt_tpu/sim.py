"""Simulation driver: setup from a YAML config and the outer time loop.

Re-derivation of reference src/simulation.cpp:505-560 ``sim::run`` and
src/main.cpp wiring. One monitor interval = one on-device
``lax.while_loop`` (zero host round-trips inside); the host only
orchestrates outputs at monitor boundaries.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import initial, units as u
from .config import Config
from .constants import Constants
from .grid import Geometry
from .nbody import system as nbody_sys
from .params import Physics, physics_from_config
from .state import FieldState
from .step import HydroStep, SystemState, make_ref_values


@dataclass
class RunSettings:
    """Output cadence & run length (reference src/Interpret.cpp:200-202)."""
    n_snapshots: int = 1000
    n_monitor: int = 10
    monitor_timestep: float = 1.0
    first_dt: float = 1e-9
    max_iterations: int = -1
    outdir: str = "output/out"
    write_at_every_timestep: bool = True

    @classmethod
    def from_config(cls, cfg: Config, outdir: str | None = None) -> "RunSettings":
        # always consult OutputDir so an explicit outdir= override doesn't
        # leave the key flagged as unknown
        cfg_outdir = cfg.get("OutputDir", "output/out", type=str)
        outdir = outdir or cfg_outdir
        return cls(
            n_snapshots=cfg.get("Nsnapshots", 1000, type=int),
            n_monitor=cfg.get("Nmonitor", 10, type=int),
            monitor_timestep=cfg.get("MonitorTimestep", 1.0, dim=u.DIM_TIME,
                                     type=float),
            first_dt=cfg.get("FirstDT", 1e-9, dim=u.DIM_TIME, type=float),
            outdir=outdir,
            write_at_every_timestep=cfg.get_flag("WriteAtEveryTimestep", True),
        )


def _load_custom_boundary(mod_path: str):
    """Load ``custom_boundary`` from a .py file path or importable module
    name (the runtime analog of the reference's compile-time
    src/boundary_conditions/custom.cpp template)."""
    import importlib
    import importlib.util
    from pathlib import Path

    if mod_path.endswith(".py") or "/" in mod_path:
        p = Path(mod_path)
        if not p.exists():
            raise FileNotFoundError(
                f"CustomBoundaryModule file not found: {mod_path}")
        spec = importlib.util.spec_from_file_location(
            "fargocpt_custom_boundary", str(p))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_path)
    fn = getattr(mod, "custom_boundary", None)
    if fn is None:
        raise AttributeError(
            f"CustomBoundaryModule {mod_path!r} must define "
            "custom_boundary(g, sigma, vrad, vaz, energy, omega_frame)")
    return fn


class Simulation:
    """End-to-end simulation: config -> grid -> ICs -> jitted stepping."""

    def __init__(self, cfg: Config, outdir: str | None = None,
                 dtype: str = "float64"):
        # construction runs eagerly on the default device (build under
        # ``jax.default_device(d)`` to place a simulation on device d)
        self.cfg = cfg
        shock_tube = cfg.get("ShockTube", 0, type=int)
        # consult the base-unit keys even on the shock-tube branch (which
        # overrides them) so they never trip the unknown-key check
        for key in ("l0", "m0", "t0", "temp0"):
            cfg.get_raw(key)
        if shock_tube == 2:
            # PVTE shock tube: special unit table (src/init.cpp:540-615)
            self.units = u.pvte_shock_tube_units()
            self.constants = Constants.shock_tube()
        elif shock_tube:
            # reference src/init.cpp:446-520: all units set to 1
            self.units = u.shock_tube_units()
            self.constants = Constants.shock_tube()
        else:
            self.units = u.Units.from_config_strings(
                str(cfg.get_raw("l0", "1.0")), str(cfg.get_raw("m0", "1.0")),
                str(cfg.get_raw("t0")) if "t0" in cfg else None,
                str(cfg.get_raw("temp0")) if "temp0" in cfg else None)
            self.constants = Constants.from_units(self.units)
        cfg.set_units(self.units)

        self.phys = physics_from_config(cfg, self.units, dtype=dtype)

        # N-body setup (reference src/nbody/planetary_system.cpp:68-134)
        self.bodies = nbody_sys.parse_bodies(cfg, self.units)
        # deprecated global Klahr & Kley smoothing radius: applied to every
        # non-central body whose per-body 'cubic smoothing factor' is unset
        # (reference src/nbody/planetary_system.cpp:94-115)
        klahr_r = cfg.get("KlahrSmoothingRadius", 0.0, type=float)
        if klahr_r > 0.0:
            import warnings
            warnings.warn("KlahrSmoothingRadius is deprecated; use the "
                          "per-body 'cubic smoothing factor'")
            import dataclasses as _dc
            self.bodies = [
                _dc.replace(b, cubic_smoothing_factor=klahr_r)
                if (b.semi_major_axis > 1e-10
                    and b.cubic_smoothing_factor == 0.0) else b
                for b in self.bodies]
        if self.phys.cic_planet:
            # CICPLANET: planets start centered in a cell — snap the
            # semi-major axis to the nearest cell-center radius (reference
            # src/nbody/planetary_system.cpp:198-204)
            import dataclasses as _dc
            geom_cic = Geometry.from_config(cfg)
            snapped = []
            for b in self.bodies:
                if b.semi_major_axis > 1e-10:
                    if b.eccentricity > 0.0:
                        raise ValueError(
                            "CICPLANET with eccentricity > 0 is not "
                            "supported (matches reference)")
                    a = geom_cic.rmed[
                        int(np.argmin(np.abs(geom_cic.rmed
                                             - b.semi_major_axis)))]
                    b = _dc.replace(b, semi_major_axis=float(a))
                snapped.append(b)
            self.bodies = snapped
        self.n_hydroframe = nbody_sys.hydroframe_center_count(
            cfg, len(self.bodies))
        nb_init = nbody_sys.initialize_system(self.bodies, self.constants.G,
                                              self.n_hydroframe)
        hydro_center_mass = float(
            nb_init["mass"][:self.n_hydroframe].sum())
        self.phys = self.phys.with_(hydro_center_mass=hydro_center_mass)
        if self.phys.corotating and len(self.bodies) > 1:
            # the frame rotates with the reference body from t=0, so the
            # initial fields must be built in the rotating frame
            # (reference src/init.cpp:259-263 sets OmegaFrame BEFORE the
            # field initialization)
            k = min(self.phys.corotation_reference_body,
                    len(self.bodies) - 1)
            x, y = float(nb_init["x"][k]), float(nb_init["y"][k])
            vx, vy = float(nb_init["vx"][k]), float(nb_init["vy"][k])
            omega0 = (x * vy - y * vx) / max(x * x + y * y, 1e-300)
            self.phys = self.phys.with_(omega_frame=omega0)
        # reference src/nbody/planetary_system.cpp:137-146 derive_config:
        # stellar heating is on iff any body irradiates
        if any(b.irradiate for b in self.bodies):
            self.phys = self.phys.with_(heating_star=True)

        self.geometry = Geometry.from_config(cfg)
        self.settings = RunSettings.from_config(cfg, outdir)

        quad_moment = 0.0
        if self.phys.vaz_quadrupole_support:
            from .ops import diskmodel as _dm
            quad_moment = _dm.binary_quadrupole_moment(
                self.bodies, self.n_hydroframe)
        fields, self.phys = initial.build_initial_state(
            self.phys, self.constants, self.geometry, quad_moment,
            nbody=nb_init)

        # self-gravity: equilibrium v_az correction from the axisymmetric
        # SG pull (reference src/init.cpp:1722-1724 + selfgravity.cpp:749)
        if self.phys.self_gravity and not cfg.get_flag("CentrifugalBalance",
                                                       False):
            from .ops.selfgravity import SelfGravity
            sg = SelfGravity(self.phys, self.constants, self.geometry,
                             jnp.dtype(dtype))
            vaz_new = sg.init_azimuthal_velocity_correction(
                self.phys, self.geometry, np.asarray(fields.sigma),
                np.asarray(fields.vaz))
            fields = fields.replace(vaz=jnp.asarray(vaz_new, jnp.dtype(dtype)))

        # reference src/init.cpp:335-341: snapshot refs, BCs, refs again
        ref0 = make_ref_values(fields)
        stepper0 = HydroStep(self.phys, self.constants, self.geometry, ref0,
                             self.bodies, self.n_hydroframe, units=self.units)
        fields = stepper0.apply_bcs(
            fields, nb=nbody_sys.make_state(nb_init, jnp.dtype(dtype)))
        self.ref_values = make_ref_values(fields)
        self.stepper = HydroStep(self.phys, self.constants, self.geometry,
                                 self.ref_values, self.bodies,
                                 self.n_hydroframe, units=self.units)

        nbody_state = nbody_sys.make_state(nb_init, jnp.dtype(dtype))
        self.state: SystemState = self.stepper.initial_system_state(
            fields, nbody_state)
        # a mixed-dtype state routed a half-f32 float64 run into the f32
        # fused transport kernel once (x64 enabled after the ICs were
        # built); fail loudly if any hydro leaf ever disagrees again
        want = jnp.dtype(dtype)
        for name in ("sigma", "vrad", "vaz", "energy"):
            got = getattr(self.state.fields, name).dtype
            assert got == want, \
                f"initial field {name} is {got}, expected {want}"

        # user custom boundary hook (reference
        # src/boundary_conditions/custom.cpp — there a source template the
        # user edits and recompiles; here a Python module loaded at
        # runtime).  CustomBoundaryModule names a .py file or importable
        # module defining ``custom_boundary(g, sigma, vrad, vaz, energy,
        # omega_frame) -> (sigma, vrad, vaz, energy)`` (jax-traceable);
        # it is applied after the named BCs whenever Inner/OuterBoundary
        # is "custom".  Library users may instead set
        # ``sim.stepper.custom_bc`` directly before the first step.
        mod_path = cfg.get("CustomBoundaryModule", "", type=str)
        if mod_path:
            self.stepper.custom_bc = _load_custom_boundary(mod_path)
        elif "custom" in (self.phys.composite_inner,
                          self.phys.composite_outer):
            import warnings
            warnings.warn(
                "Inner/OuterBoundary is 'custom' but no "
                "CustomBoundaryModule is configured and no custom_bc was "
                "registered; the custom hook will be a no-op unless "
                "sim.stepper.custom_bc is set before the first step")

        # dust particles (reference src/particles/particles.cpp:516-790);
        # the particle keys are consulted even when particles are off
        # (the reference always reads them, src/parameters.cpp:854-932)
        pp, pstate = self._setup_particles(cfg, dtype)
        if self.phys.integrate_particles:
            self.stepper.particle_params = pp
            self.state = self.state.replace(particles=pstate)

        self.time = 0.0
        self.last_dt = self.settings.first_dt
        # On a fresh start the reference grows last_dt twice before the
        # first loop step: once in main (src/main.cpp:117) and once in
        # sim::init (src/simulation.cpp:467-469). Restarts skip this
        # (restore_simulation overwrites last_dt from misc.bin).
        self._dt_primed = False
        self.n_monitor = 0
        self.n_snapshot = 0
        self.n_hydro_iter = 0
        self.monitor_hooks = []     # callables (sim) run at monitor boundaries
        self.snapshot_hooks = []    # callables (sim) run at snapshot boundaries
        self.monitor_stats: dict = {}

        # every config key has been consulted by now; a leftover key is a
        # typo — die like the reference does at startup (src/main.cpp:110)
        cfg.exit_on_unknown_key()

    def _setup_particles(self, cfg: Config, dtype: str):
        """Parse the particle configuration and build the initial swarm
        (reference src/parameters.cpp particle section + particles.cpp:516)."""
        from .particles import dust
        n = cfg.get("NumberOfParticles", 0, type=int)
        n_species = max(cfg.get("ParticleSpeciesNumber", 1, type=int), 1)
        radius0 = cfg.get("ParticleRadius", 100.0 / self.units.length,
                          dim=u.DIM_LENGTH, type=float)
        factor = cfg.get("ParticleRadiusIncreaseFactor", 10.0, type=float)
        density = cfg.get("ParticleDensity", 2.65 / self.units.density,
                          dim=u.DIM_DENSITY, type=float)
        rmin_p = cfg.get("ParticleMinimumRadius", self.geometry.rmin,
                         dim=u.DIM_LENGTH, type=float)
        rmax_p = cfg.get("ParticleMaximumRadius", self.geometry.rmax,
                         dim=u.DIM_LENGTH, type=float)
        cartesian = cfg.get_flag("CartesianParticles", False)
        integrator = cfg.get_lowercase("ParticleIntegrator", "midpoint")
        if cartesian and integrator.startswith("m"):
            # exponential midpoint is polar-only (reference
            # parameters.cpp:927-932)
            import warnings
            warnings.warn("CartesianParticles is only supported by the "
                          "adaptive integrator; disabled for midpoint")
            cartesian = False
        pp = dust.ParticleParams(
            density=density,
            cartesian=cartesian,
            gas_drag=cfg.get_flag("ParticleGasDragEnabled", True),
            disk_gravity=cfg.get_flag("ParticleDiskGravityEnabled", False),
            diffusion=cfg.get_flag("ParticleDustDiffusion", False),
            integrator=integrator,
            min_escape_radius=cfg.get("ParticleMinimumEscapeRadius", rmin_p,
                                      dim=u.DIM_LENGTH, type=float),
            max_escape_radius=cfg.get("ParticleMaximumEscapeRadius", rmax_p,
                                      dim=u.DIM_LENGTH, type=float))
        sizes = radius0 * factor ** (np.arange(n) % n_species)
        pstate = dust.init_particles(
            n, rmin_p, rmax_p,
            cfg.get("ParticleSurfaceDensitySlope",
                    self.phys.sigma_slope, type=float),
            sizes, self.constants.G * self.phys.hydro_center_mass,
            eccentricity=cfg.get("ParticleEccentricity", 0.0, type=float),
            seed=cfg.get("RandomSeed", 1337, type=int),
            dtype=jnp.dtype(dtype))
        return pp, pstate

    # convenience views -------------------------------------------------
    @property
    def fields(self) -> FieldState:
        return self.state.fields

    @fields.setter
    def fields(self, value: FieldState):
        self.state = self.state.replace(fields=value)

    # ------------------------------------------------------------------
    def calculate_time_step(self) -> float:
        """reference src/simulation.cpp:100-117."""
        if not self.phys.calculate_disk:
            return self.last_dt
        cfl_dt = float(self.stepper.cfl_dt(self.state, self.time))
        dt = min(self.phys.cfl_max_var * self.last_dt, cfl_dt)
        self.last_dt = dt
        return dt

    def step_once(self, dt: float):
        self.state = self.stepper.step(self.state, self.time, dt)
        self.time += dt
        self.n_hydro_iter += 1

    def run(self, max_steps: int | None = None):
        """Outer loop (reference src/simulation.cpp:505-560)."""
        s = self.settings
        total_monitors = s.n_snapshots * s.n_monitor
        if not self._dt_primed:
            self.calculate_time_step()   # main.cpp:117
            self.calculate_time_step()   # sim::init, simulation.cpp:467
            self._dt_primed = True
        if not getattr(self, "_restored", False):
            # the reference writes the t=0 snapshot only on a fresh start;
            # a restart resumes without re-registering the restored
            # snapshot (src/simulation.cpp:505-560)
            self._handle_outputs(initial=True)
        while self.n_monitor < total_monitors:
            if max_steps is not None and self.n_hydro_iter >= max_steps:
                break
            t_target = (self.n_monitor + 1) * s.monitor_timestep
            wall0 = _time.time()
            (self.state, time_arr, last_dt_arr, n_steps,
             dt_min, dt_max, dt_sum, dt_sq) = self.stepper.advance_to(
                self.state, self.time, self.last_dt, t_target)
            n = int(n_steps)
            self.time = float(time_arr)
            self.last_dt = float(last_dt_arr)
            self.n_hydro_iter += n
            self.monitor_stats = {
                "n_steps": n, "walltime": _time.time() - wall0,
                "dt_min": float(dt_min), "dt_max": float(dt_max),
                "dt_sum": float(dt_sum), "dt_sq": float(dt_sq),
            }
            self.n_monitor += 1
            self._handle_outputs()

    def _handle_outputs(self, initial: bool = False):
        s = self.settings
        self.n_snapshot = self.n_monitor // s.n_monitor
        write_snapshot = (s.n_monitor * self.n_snapshot == self.n_monitor)
        for hook in self.monitor_hooks:
            hook(self)
        if write_snapshot:
            for hook in self.snapshot_hooks:
                hook(self)

    # convenience -------------------------------------------------------
    @classmethod
    def from_file(cls, path: str, outdir: str | None = None,
                  dtype: str = "float64") -> "Simulation":
        return cls(Config.from_file(path), outdir=outdir, dtype=dtype)

    def np_fields(self) -> dict[str, np.ndarray]:
        f = self.fields
        return {"Sigma": np.asarray(f.sigma), "vrad": np.asarray(f.vrad),
                "vazi": np.asarray(f.vaz), "energy": np.asarray(f.energy)}

    def orbital_elements(self, k: int) -> dict:
        """Keplerian elements of body k about the accumulated inner mass
        (reference src/nbody/planetary_system.cpp:773-820)."""
        nb = self.state.nbody
        x = np.asarray(nb.x)
        y = np.asarray(nb.y)
        vx = np.asarray(nb.vx)
        vy = np.asarray(nb.vy)
        m = np.asarray(nb.mass)
        if k == 0 and self.n_hydroframe == 1:
            return nbody_sys.orbital_elements(0, 0, 0, 0, 0, 0, 1)
        # elements relative to the COM of bodies 0..k-1
        mc = m[:k].sum()
        cx = (m[:k] * x[:k]).sum() / mc
        cy = (m[:k] * y[:k]).sum() / mc
        cvx = (m[:k] * vx[:k]).sum() / mc
        cvy = (m[:k] * vy[:k]).sum() / mc
        return nbody_sys.orbital_elements(
            x[k] - cx, y[k] - cy, vx[k] - cvx, vy[k] - cvy, mc, m[k],
            self.constants.G)
