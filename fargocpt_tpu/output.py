"""Snapshot / monitor output and restart.

Re-derivation of reference src/output.cpp: the on-disk layout is kept
byte-compatible where analysis tooling depends on it —

  outdir/
    dimensions.dat            (reference src/parameters.cpp:1127-1177)
    used_rad.dat              (interface radii, src/init.cpp:232-252)
    units.yml, constants.yml
    info2D.yml                (self-describing variable list, :788-850)
    snapshots/list.txt        (snapshot registry, :183-191)
    snapshots/<N>/Sigma.dat   (raw little-endian float64, NR x NAZ)
    snapshots/<N>/vrad.dat    ((NR+1) x NAZ)
    snapshots/<N>/vazi.dat, energy.dat, Temperature.dat, ...
    snapshots/<N>/misc.bin    (binary struct, src/output.h:16-24)
    snapshots/<N>/nbody.bin   (per-body state)
    snapshots/<N>/config.yml
    monitor/Quantities.dat    (~20 scalars/monitor, :326-490)
    monitor/timestepLogging.dat (dt statistics, src/hydro_dt_logger.cpp)
    monitor/nbody{i}.dat      (per-planet orbit data)
"""

from __future__ import annotations

import math
import os
import shutil
import struct
from pathlib import Path

import jax
import numpy as np

from . import yamlio
from .ops import quantities as quant

# column layout of Quantities.dat (reference src/output.cpp:39-76, v2.5)
QUANTITIES_COLUMNS = [
    "snapshot number", "monitor number", "time", "mass", "radius",
    "angular momentum", "total energy", "internal energy",
    "kinematic energy", "potential energy", "radial kinetic energy",
    "azimuthal kinetic energy", "eccentricity", "periastron",
    "viscous dissipation", "luminosity", "pdivv",
    "inner boundary mass inflow", "inner boundary mass outflow",
    "outer boundary mass inflow", "outer boundary mass outflow",
    "wave damping inner mass creation", "wave damping inner mass removal",
    "wave damping outer mass creation", "wave damping outer mass removal",
    "density floor mass creation", "aspect ratio",
    "indirect term nbody x", "indirect term nbody y",
    "indirect term disk x", "indirect term disk y", "frame angle",
    "advection torque", "viscous torque", "gravitational torque",
]

MISC_STRUCT = "=IIddddQ"   # reference src/output.h:16-24 misc_entry


class OutputWriter:
    """Writes reference-layout output for a Simulation."""

    def __init__(self, sim, outdir: str | None = None):
        self.sim = sim
        self.outdir = Path(outdir or sim.settings.outdir)
        self.snapshot_dir = None
        self._quantities_initialized = False
        # native async writer for the large field dumps (fargocpt_tpu.native)
        from .native import AsyncFileWriter
        self._awriter = AsyncFileWriter()
        self._setup()
        # 'reference' snapshot holding the damping/reference-BC target
        # fields (reference src/output.cpp:183-248 register_output writes a
        # reference snapshot once)
        refdir = self.outdir / "snapshots" / "reference"
        if not refdir.exists():
            refdir.mkdir(parents=True)
            rv = sim.stepper.ref_values
            for name, arr in (("Sigma", rv.sigma0), ("energy", rv.energy0),
                              ("vrad", rv.vrad0), ("vazi", rv.vaz0)):
                np.asarray(arr, np.float64).tofile(refdir / f"{name}.dat")
        # WriteDefaultValues: dump every config key the run consulted,
        # including the defaults it fell back to (reference
        # src/Interpret.cpp:695-697 cfg.write_default)
        if sim.phys.write_default_values:
            defaults = getattr(getattr(sim, "cfg", None),
                               "consulted_values", lambda: {})()
            (self.outdir / "default_config.yml").write_text(
                yamlio.dumps(defaults, sort_keys=True))
        # hook into the simulation
        sim.monitor_hooks.append(self._on_monitor)
        sim.snapshot_hooks.append(self._on_snapshot)

    # ------------------------------------------------------------------
    def _setup(self):
        for sub in ("snapshots", "monitor", "parameters"):
            (self.outdir / sub).mkdir(parents=True, exist_ok=True)
        # output-format identifier: the reference's python Loader refuses
        # to open a directory without it (reference src/output.cpp:205
        # write_output_version, python_module/fargocpt/data.py
        # _check_output_dir)
        (self.outdir / "fargocpt_output_v1_4").touch()
        self._write_dimensions()
        self._write_used_rad()
        self._write_units()
        self._write_info2d()
        self._write_info1d()
        if self.sim.state.particles is not None:
            self._write_info_particles()
        # config provenance: library-constructed runs dump the raw config
        # dict; the CLI overwrites this with a copy of the actual setup
        # file (reference src/output.cpp:249-304 always saves its config)
        setup = self.outdir / "parameters" / "setup.yml"
        if not setup.exists():
            cfg = getattr(self.sim, "cfg", None)
            if cfg is not None and getattr(cfg, "_raw", None) is not None:
                setup.write_text(yamlio.dumps(
                    {cfg._orig_case[k]: v for k, v in cfg._raw.items()},
                    sort_keys=False))

    def _write_dimensions(self):
        g = self.sim.geometry
        spacing = {"logarithmic": "Logarithmic", "arithmetic": "Arithmetic",
                   "exponential": "Exponential",
                   "custom": "Custom"}[g.spacing]
        with open(self.outdir / "dimensions.dat", "w") as f:
            f.write("#RMIN\tRMAX\tPHIMIN\tPHIMAX          \tNRAD\tNAZ\t"
                    "NGHRAD\tNGHAZ\tRadial_spacing\n")
            f.write(f"{g.rmin:.16g}\t{g.rmax:.16g}\t{0.0:.16g}\t"
                    f"{2 * math.pi:.16g}\t{g.nrad}\t{g.naz}\t1\t1\t"
                    f"{spacing}\n")

    def _write_used_rad(self):
        with open(self.outdir / "used_rad.dat", "w") as f:
            for r in self.sim.geometry.radii:
                f.write(f"{r:.18g}\n")

    def _write_units(self):
        un = self.sim.units
        units = {
            "length": {"unit": "cm", "factor": un.length},
            "mass": {"unit": "g", "factor": un.mass},
            "time": {"unit": "s", "factor": un.time},
            "temperature": {"unit": "K", "factor": un.temperature},
            "velocity": {"unit": "cm s^-1", "factor": un.velocity},
            "mass surface density": {"unit": "g cm^-2",
                                     "factor": un.surface_density},
            "energy surface density": {"unit": "erg cm^-2",
                                       "factor": un.energy_density},
        }
        (self.outdir / "units.yml").write_text(yamlio.dumps(units))
        c = self.sim.constants
        (self.outdir / "constants.yml").write_text(yamlio.dumps(
            {"G": c.G, "R": c.R, "sigma_sb": c.sigma_sb, "c": c.c}))

    def _field_specs(self):
        un = self.sim.units
        g = self.sim.geometry
        return {
            "Sigma": dict(unit="g cm^-2", factor=un.surface_density,
                          nrad=g.nrad, vector=False),
            "vrad": dict(unit="cm s^-1", factor=un.velocity,
                         nrad=g.nrad + 1, vector=True),
            "vazi": dict(unit="cm s^-1", factor=un.velocity,
                         nrad=g.nrad, vector=False),
            "energy": dict(unit="erg cm^-2", factor=un.energy_density,
                           nrad=g.nrad, vector=False),
            "Temperature": dict(unit="K", factor=un.temperature,
                                nrad=g.nrad, vector=False),
        }

    def _write_info2d(self):
        g = self.sim.geometry
        lines = ["# 2D output variable descriptions", "# version 0.1", ""]
        for name, spec in self._field_specs().items():
            lines += [
                f"{name}:",
                f"  cgs symbols: {spec['unit']}",
                f"  code_to_cgs_factor: {spec['factor']:.17g}",
                f"  unit: {spec['factor']:.17g} {spec['unit']}",
                f"  Nrad: {spec['nrad']}",
                f"  Nazi: {g.naz}",
                "  bigendian: 0",
                f"  on_radial_interface: "
                f"{'true' if spec['vector'] else 'false'}",
                f"  on_azimuthal_interface: "
                f"{'true' if name == 'vazi' else 'false'}",
                f"  filename: {name}.dat",
                "",
            ]
        (self.outdir / "info2D.yml").write_text("\n".join(lines))

    def _write_info1d(self):
        """info1D.yml: self-describing 1-D profile list (reference
        src/output.cpp:717-787 ``write_1D_info``). Layout per ring:
        [radius, azimuthal average, min, max] float64."""
        lines = ["# 1D output variable descriptions", "# version 0.1", ""]
        for name, spec in self._field_specs().items():
            lines += [
                f"{name}1D:",
                f"  cgs symbols: {spec['unit']}",
                f"  code_to_cgs_factor: {spec['factor']:.17g}",
                f"  Nrad: {spec['nrad']}",
                "  layout: radius value min max",
                "  bigendian: 0",
                f"  filename: {name}1D.dat",
                "",
            ]
        (self.outdir / "info1D.yml").write_text("\n".join(lines))

    def _write_info_particles(self):
        """infoParticles.yml (reference src/output.cpp:830-850): layout of
        the per-snapshot particles.bin records."""
        un = self.sim.units
        cols = [("r", "cm", un.length), ("phi", "1", 1.0),
                ("r dot", "cm s^-1", un.velocity),
                ("phi dot", "s^-1", 1.0 / un.time),
                ("size", "cm", un.length), ("stokes", "1", 1.0),
                ("alive", "1", 1.0),
                ("timestep", "s", un.time), ("facold", "1", 1.0)]
        lines = ["# particle output description", "# version 0.1",
                 "particles:", "  filename: particles.bin",
                 f"  record: {len(cols)} float64 per particle",
                 "  columns:"]
        for name, unit, fac in cols:
            lines.append(f"    - {{name: {name}, unit: {unit}, "
                         f"factor: {fac:.17g}}}")
        (self.outdir / "infoParticles.yml").write_text("\n".join(lines)
                                                       + "\n")

    # ------------------------------------------------------------------
    def write_snapshot(self, snapshot_id: str | None = None,
                       register: bool = True):
        sim = self.sim
        sid = snapshot_id if snapshot_id is not None else str(sim.n_snapshot)
        sdir = self.outdir / "snapshots" / sid
        if sdir.exists():
            shutil.rmtree(sdir)
        sdir.mkdir(parents=True)
        self.snapshot_dir = sdir

        # free-space precheck (reference src/output.cpp:120-146): one
        # snapshot is ~5 full float64 grids plus metadata
        need = 6 * 8 * sim.geometry.nrad * sim.geometry.naz
        free = shutil.disk_usage(self.outdir).free
        if free < 2 * need:
            raise OSError(
                f"not enough disk space for a snapshot: {free} bytes free, "
                f"need ~{2 * need}")

        f = sim.fields
        w = self._awriter.write
        # distributed mode: prognostic fields go out as per-shard
        # row-range files, never gathered to one host (reference MPI-IO
        # analog, src/polargrid.cpp:135-186); derived/1-D outputs — which
        # are host reductions — are skipped
        distributed = sim.phys.distributed_output \
            and _is_multidevice(f.sigma)
        if distributed:
            gates = {"sigma": sim.phys.write_density,
                     "vrad": sim.phys.write_velocity,
                     "vaz": sim.phys.write_velocity,
                     "energy": sim.phys.write_energy}
            for attr, base in _SHARD_FIELD_NAMES:
                if gates[attr]:
                    write_sharded_array(getattr(f, attr), sdir, base)
            if sim.phys.is_adiabatic and (sim.phys.bitwise_exact_restarting
                                          or sim.phys.write_qplus):
                write_sharded_array(sim.state.qplus, sdir, "Qplus")
            if sim.phys.is_adiabatic and (sim.phys.bitwise_exact_restarting
                                          or sim.phys.write_qminus):
                write_sharded_array(sim.state.qminus, sdir, "Qminus")
            if sim.phys.bitwise_exact_restarting \
                    and sim.state.pvte_guess is not None:
                write_sharded_array(sim.state.pvte_guess[0], sdir,
                                    "PvteGeff")
                write_sharded_array(sim.state.pvte_guess[1], sdir, "PvteMu")
            self._write_misc(sdir)
            self._write_nbody_bin(sdir)
            self._awriter.flush()
            if register:
                with open(self.outdir / "snapshots" / "list.txt", "a") as fl:
                    fl.write(sid + "\n")
                self._write_time_snapshot()
            return
        # prognostic gates (reference src/parameters.cpp:243-250
        # WriteDensity/WriteVelocity/WriteEnergy, default on)
        if sim.phys.write_density:
            w(sdir / "Sigma.dat", np.asarray(f.sigma))
        if sim.phys.write_velocity:
            w(sdir / "vrad.dat", np.asarray(f.vrad))
            w(sdir / "vazi.dat", np.asarray(f.vaz))
        if sim.phys.write_energy:
            w(sdir / "energy.dat", np.asarray(f.energy))
        if sim.phys.is_adiabatic:
            from .ops import eos as _eos
            pv = sim.stepper.pvte_vals(f.sigma, f.energy)
            temp = np.asarray(_eos.temperature(
                sim.phys, sim.constants, f.sigma, f.energy, None, pv))
            w(sdir / "Temperature.dat", temp)
        # Q grids for bitwise-exact restart (reference src/restart.cpp:73-90,
        # written only when BitwiseExactRestarting is on and the run is not
        # locally isothermal, src/output.cpp:259)
        if (sim.phys.bitwise_exact_restarting or sim.phys.write_qplus) \
                and sim.phys.is_adiabatic:
            w(sdir / "Qplus.dat", np.asarray(sim.state.qplus))
        if (sim.phys.bitwise_exact_restarting or sim.phys.write_qminus) \
                and sim.phys.is_adiabatic:
            w(sdir / "Qminus.dat", np.asarray(sim.state.qminus))
        # PVTE warm-start cache: pure solver state, stored only so a
        # restart replays the uninterrupted trajectory bit-for-bit
        if sim.phys.bitwise_exact_restarting \
                and sim.state.pvte_guess is not None:
            w(sdir / "PvteGeff.dat", np.asarray(sim.state.pvte_guess[0]))
            w(sdir / "PvteMu.dat", np.asarray(sim.state.pvte_guess[1]))

        # 1-D radial profiles: interleaved [radius, azi-avg, min, max]
        # per ring (reference src/polargrid.cpp:187-260 write1D)
        if sim.phys.write_density:
            self._write_1d(sdir, "Sigma", np.asarray(f.sigma),
                           sim.geometry.rmed)
        if sim.phys.write_velocity:
            self._write_1d(sdir, "vrad", np.asarray(f.vrad),
                           sim.geometry.ra)
            self._write_1d(sdir, "vazi", np.asarray(f.vaz),
                           sim.geometry.rmed)
        if sim.phys.write_energy:
            self._write_1d(sdir, "energy", np.asarray(f.energy),
                           sim.geometry.rmed)
        if sim.phys.write_radial_luminosity or \
                sim.phys.write_radial_dissipation:
            # ring-integrated Q-/Q+ (reference src/quantities.cpp:720-770
            # calculate_radial_luminosity/dissipation: sum_phi Q Rmed dr
            # dphi), written in the common 1-D [radius, v, v, v] layout
            g2 = sim.stepper.g
            dr = np.asarray(g2.rsup - g2.rinf)[:, 0]
            dphi = sim.geometry.dphi
            rmed = sim.geometry.rmed
            if sim.phys.write_radial_luminosity:
                lum = np.asarray(sim.state.qminus).sum(axis=1) \
                    * rmed * dr * dphi
                self._write_1d(sdir, "Luminosity",
                               np.repeat(lum[:, None], 1, axis=1), rmed)
            if sim.phys.write_radial_dissipation:
                dis = np.asarray(sim.state.qplus).sum(axis=1) \
                    * rmed * dr * dphi
                self._write_1d(sdir, "Dissipation",
                               np.repeat(dis[:, None], 1, axis=1), rmed)
        if sim.phys.is_adiabatic:
            self._write_1d(sdir, "Temperature", temp, sim.geometry.rmed)
            import jax.numpy as _jnp
            _cs, _p, h = sim.stepper.derived(f.sigma, f.energy)
            aspect = np.asarray(h) / sim.geometry.rmed[:, None]
            self._write_1d(sdir, "aspectratio", aspect, sim.geometry.rmed)

        # optional Write*-flag 2-D fields (reference
        # src/parameters.cpp:243-312 set_write table)
        for name in sim.phys.snapshot_fields:
            if name == "Temperature" and sim.phys.is_adiabatic:
                continue                      # already written above
            arr = np.asarray(self._compute_field(name))
            w(sdir / f"{name}.dat", arr)
            self._write_1d(sdir, name, arr, sim.geometry.rmed)

        # accumulated monitor grids: time-averaged over the snapshot
        # interval, cleared after write (reference src/data.cpp:277
        # set_clear_after_write + src/quantities.cpp:743-781, 963-973)
        acc = sim.state.monitor_acc
        if acc is not None:
            denom = sim.settings.n_monitor * sim.settings.monitor_timestep
            # alpha means keep the reference normalization: accumulated
            # alpha*dt/monitor_timestep, written raw and cleared
            # (quantities.cpp:991-996)
            names = {"massflow": ("MassFlow", denom),
                     "t_adv": ("AdvectionTorque", denom),
                     "t_visc": ("ViscousTorque", denom),
                     "t_grav": ("GravitationalTorqueNotIntegrated", denom),
                     "alpha_grav_mean": (
                         "alpha_grav_mean",
                         sim.settings.monitor_timestep),
                     "alpha_reynolds_mean": (
                         "alpha_reynolds_mean",
                         sim.settings.monitor_timestep)}
            kw = {}
            for attr, (fname, dv) in names.items():
                grid = getattr(acc, attr)
                if grid is None:
                    continue
                arr = np.asarray(grid) / dv
                w(sdir / f"{fname}.dat", arr)
                self._write_1d(sdir, fname, arr, sim.geometry.rmed)
                kw[attr] = jax.numpy.zeros_like(grid)
            sim.state = sim.state.replace(monitor_acc=acc.replace(**kw))

        # per-planet torque radial profiles (reference
        # src/output.cpp:653-716 ``write_torques``)
        if sim.phys.write_torques and sim.phys.calculate_disk:
            self._write_planet_torque_profiles(sdir)

        self._write_misc(sdir)
        self._write_nbody_bin(sdir)
        # ROF massflow tracker state (reference src/massflow_tracker.cpp
        # write_to_file: delta_mass, averaging_time, mdot)
        acc2 = sim.state.monitor_acc
        if sim.phys.rochelobe_overflow and acc2 is not None \
                and acc2.rof_mdot is not None:
            st = sim.stepper
            t_avg = max(st.body_period_host[sim.phys.rof_planet]
                        * sim.phys.rof_averaging_time, 1e-12) \
                if st.n_bodies > 1 else 1e-12
            np.asarray([0.0, t_avg, float(acc2.rof_mdot)],
                       np.float64).tofile(sdir / "massflow_tracker.bin")
        # dust particles (reference src/particles/particles.cpp:2176
        # ``write``: one binary record per particle per snapshot)
        if sim.state.particles is not None:
            p = sim.state.particles
            arr = np.stack(
                [np.asarray(p.r), np.asarray(p.phi), np.asarray(p.r_dot),
                 np.asarray(p.phi_dot), np.asarray(p.size),
                 np.asarray(p.stokes),
                 np.asarray(p.alive, np.float64),
                 np.asarray(p.timestep), np.asarray(p.facold)], axis=1)
            w(sdir / "particles.bin", arr)

        # config provenance per snapshot (reference src/output.cpp:249-304
        # copies config.yml into every snapshot directory)
        setup_copy = self.outdir / "parameters" / "setup.yml"
        if setup_copy.exists():
            shutil.copyfile(setup_copy, sdir / "config.yml")

        # drain the async queue so the snapshot is durable before the
        # registry names it
        self._awriter.flush()
        if register:
            with open(self.outdir / "snapshots" / "list.txt", "a") as fl:
                fl.write(sid + "\n")
            self._write_time_snapshot()

    def _write_time_snapshot(self):
        """Append (snapshot number, monitor number, time) to
        snapshots/timeSnapshot.dat with the reference's exact header and
        row format (reference src/output.cpp:1010-1068
        ``write_snapshot_time``); the reference Loader reads snapshot
        times and monitor numbers from this file
        (python_module/fargocpt/data.py ``_load_snapshots``)."""
        sim = self.sim
        path = self.outdir / "snapshots" / "timeSnapshot.dat"
        if not path.exists():
            un = sim.units
            mt = sim.settings.monitor_timestep
            with open(path, "w") as f:
                f.write("# Time log for course output.\n"
                        "#version: 0.1\n"
                        "#variable: 0 | snapshot number | 1\n"
                        "#variable: 1 | monitor number | 1\n"
                        f"#variable: 2 | time | {un.time:.16e} s\n"
                        f"# One monitor_timestep is {mt:.18g} (code) and "
                        f"{mt * un.time:.18g} (cgs).\n"
                        "# Syntax: snapshot number <tab> monitor number "
                        "<tab> time (cgs)\n")
        with open(path, "a") as f:
            f.write(f"{sim.n_snapshot}\t{sim.n_monitor}\t{sim.time:#.16e}\n")

    def _write_1d(self, sdir: Path, name: str, field2d: np.ndarray,
                  radius: np.ndarray):
        # global 1-D switch (reference parameters.cpp:242 DoWrite1DFiles)
        if not self.sim.phys.do_write_1d:
            return
        out = np.empty((field2d.shape[0], 4), np.float64)
        out[:, 0] = radius[:field2d.shape[0]]
        out[:, 1] = field2d.mean(axis=1)
        out[:, 2] = field2d.min(axis=1)
        out[:, 3] = field2d.max(axis=1)
        out.tofile(sdir / f"{name}1D.dat")

    def _write_misc(self, sdir: Path):
        sim = self.sim
        blob = struct.pack(
            MISC_STRUCT, sim.n_snapshot, sim.n_monitor, sim.time,
            float(sim.state.omega_frame), float(sim.state.frame_angle),
            sim.last_dt, sim.n_hydro_iter)
        (sdir / "misc.bin").write_bytes(blob)

    def _write_nbody_bin(self, sdir: Path):
        nb = self.sim.state.nbody
        arr = np.stack([np.asarray(nb.x), np.asarray(nb.y),
                        np.asarray(nb.vx), np.asarray(nb.vy),
                        np.asarray(nb.mass)], axis=1).astype(np.float64)
        arr.tofile(sdir / "nbody.bin")

    # ------------------------------------------------------------------
    def _compute_field(self, name: str) -> np.ndarray:
        """Optional 2-D diagnostic fields, computed at write time from the
        current state (reference caches these in t_data polar grids)."""
        sim = self.sim
        st = sim.stepper
        f = sim.fields
        phys, constants, g = sim.phys, sim.constants, st.g
        import jax.numpy as jnp
        from .ops import eos, gravity, sources
        from .ops import viscosity as visc_ops

        cs, press, h = st.derived(f.sigma, f.energy)
        pv = st.pvte_vals(f.sigma, f.energy)
        if name == "Temperature":
            return eos.temperature(phys, constants, f.sigma, f.energy,
                                   press, pv)
        if name == "SoundSpeed":
            return cs
        if name == "Pressure":
            return press
        if name == "ScaleHeight":
            return h
        if name == "Toomre":
            return quant.toomre_q(phys, constants, g, f.sigma, cs)
        if name in ("EccentricityX", "EccentricityY"):
            cos_phi = jnp.asarray(sim.geometry.cos_phi, st.dtype)[None, :]
            sin_phi = jnp.asarray(sim.geometry.sin_phi, st.dtype)[None, :]
            ex, ey = quant.eccentricity_vector(
                phys, constants, g, f.sigma, f.vrad, f.vaz,
                sim.state.omega_frame, sim.state.frame_angle, cos_phi,
                sin_phi)
            return ex if name == "EccentricityX" else ey
        if name == "Potential":
            bodies = st.bodies_on_grid(sim.state.nbody, sim.time)
            zero = jnp.zeros((), st.dtype)
            return gravity.nbody_potential(
                phys, constants, g, bodies, st.n_bodies, st.cell_x,
                st.cell_y, h, zero, zero)
        if name == "Kappa":
            from .ops import opacity as opac
            temp = eos.temperature(phys, constants, f.sigma, f.energy,
                                   press, pv)
            rho_mid = f.sigma / (phys.density_factor * h)
            return opac.opacity(phys, sim.units, rho_mid, temp)
        if name == "TauCool":
            return f.energy / jnp.maximum(sim.state.qminus, 1e-300)
        if name == "Viscosity":
            return st.viscosity_grid(cs, h)
        if name == "DivV":
            return sources.divergence_v(g, f.vrad, f.vaz)
        if name == "PdivV":
            # (gamma_eff - 1) dt div(v) E per cell (reference
            # src/SourceEuler.cpp:978-998); uses the last hydro dt
            gam = pv[0] if pv is not None else phys.adiabatic_index
            return (gam - 1.0) * sim.last_dt \
                * sources.divergence_v(g, f.vrad, f.vaz) * f.energy
        if name == "TReynolds":
            return quant.reynolds_stress(g, f.sigma, f.vrad, f.vaz)
        if name == "AlphaReynolds":
            t = quant.reynolds_stress(g, f.sigma, f.vrad, f.vaz)
            return quant.alpha_from_stress(t, f.sigma, cs)
        if name in ("TGravitational", "AlphaGrav"):
            if st.selfgravity is None:
                return jnp.zeros_like(f.sigma)
            g_r, g_t = st.selfgravity.accelerations(f.sigma)
            t = quant.gravitational_stress(phys, constants, g, g_r, g_t)
            if name == "TGravitational":
                return t
            return quant.alpha_from_stress(t, f.sigma, cs)
        if name == "GammaEff":
            gam = pv[0] if pv is not None else phys.adiabatic_index
            return jnp.broadcast_to(jnp.asarray(gam), f.sigma.shape)
        if name == "Gamma1":
            g1 = pv[2] if pv is not None else phys.adiabatic_index
            return jnp.broadcast_to(jnp.asarray(g1), f.sigma.shape)
        if name == "Mu":
            mu = pv[1] if pv is not None else phys.mu
            return jnp.broadcast_to(jnp.asarray(mu), f.sigma.shape)
        if name == "Alpha":
            return jnp.full_like(f.sigma, phys.viscous_alpha)
        if name == "AspectRatio":
            return h * g.inv_rb
        if name == "Tau":
            # vertical optical depth (reference src/compute.cpp:41-87
            # midplane tau = tau_factor/density_factor * kappa * Sigma)
            from .ops.energy import kappa_tau_eff
            temp = eos.temperature(phys, constants, f.sigma, f.energy,
                                   press, pv)
            _k, tau, _te = kappa_tau_eff(phys, constants, sim.units,
                                         f.sigma, temp, h)
            return tau
        if name in ("SGAccelRad", "SGAccelAzi"):
            # self-gravity acceleration grids (reference src/data.cpp
            # SG_ACCEL_RAD/AZI, filled by selfgravity.cpp)
            if st.selfgravity is None:
                return jnp.zeros_like(f.sigma)
            g_r, g_t = st.selfgravity.accelerations(f.sigma)
            return g_r if name == "SGAccelRad" else g_t
        if name == "tau_eff":
            # WriteVerticalOpticalDepth -> the tau_eff grid SubStep3 fills
            # (reference src/SourceEuler.cpp:925, src/compute.cpp:41-87)
            from .ops.energy import kappa_tau_eff
            temp = eos.temperature(phys, constants, f.sigma, f.energy,
                                   None, pv)
            _, _, te = kappa_tau_eff(phys, constants, sim.units, f.sigma,
                                     temp, h)
            return te
        if name == "visiblity":
            # the reference registers VISIBILITY (with this spelling,
            # src/data.cpp:262-263) but never fills it — zeros, as written
            # by the reference binary
            return jnp.zeros_like(f.sigma)
        raise KeyError(f"unknown snapshot field {name!r}")

    def _write_planet_torque_profiles(self, sdir: Path):
        """torque_planet_1D_<k>: radial profile of the gas torque on each
        body (reference src/output.cpp:653-716)."""
        sim = self.sim
        st = sim.stepper
        f = sim.fields
        import jax.numpy as jnp
        from .ops import gravity
        _, _, h = st.derived(f.sigma, f.energy)
        bodies = st.bodies_on_grid(sim.state.nbody, sim.time)
        cellmass = st.g.surf * f.sigma
        for k in range(st.n_bodies):
            body_r = jnp.sqrt(bodies.x[k] ** 2 + bodies.y[k] ** 2)
            smooth = gravity.smoothing_length(sim.phys, h, k, body_r)
            dx = st.cell_x - bodies.x[k]
            dy = st.cell_y - bodies.y[k]
            inv_d3 = (dx * dx + dy * dy + smooth * smooth) ** -1.5
            w = sim.constants.G * cellmass * inv_d3 * bodies.mass[k]
            torque = bodies.x[k] * (w * dy) - bodies.y[k] * (w * dx)
            prof = np.asarray(jnp.sum(torque, axis=-1))
            out = np.stack([sim.geometry.rmed, prof], axis=1)
            out.astype(np.float64).tofile(
                sdir / f"torque_planet_1D_{k}.dat")

    def write_lightcurves(self):
        """monitor/luminosity.dat + dissipation.dat: radial luminosity /
        dissipation binned into the configured radii
        (reference src/output.cpp:852-1000 ``write_lightcurves``)."""
        sim = self.sim
        radii = sim.phys.lightcurves_radii
        if not radii:
            return
        st = sim.stepper
        lum1d = np.asarray(quant.radial_luminosity(st.g, sim.state.qminus))
        dis1d = np.asarray(quant.radial_dissipation(st.g, sim.state.qplus))
        rmed = sim.geometry.rmed
        nr = sim.geometry.nrad
        nbins = len(radii)
        lum = np.zeros(nbins)
        dis = np.zeros(nbins)
        b = 0
        for n in range(1, nr - 1):            # active rings
            while b < nbins - 1 and radii[b] < rmed[n]:
                b += 1
            lum[b] += lum1d[n]
            dis[b] += dis1d[n]
        for fname, vals in (("luminosity.dat", lum),
                            ("dissipation.dat", dis)):
            path = self.outdir / "monitor" / fname
            if not path.exists():
                with open(path, "w") as fd:
                    fd.write("# time\t" + fname.split(".")[0] + "\n")
            with open(path, "a") as fd:
                fd.write("\t".join([f"{sim.time:.18g}"]
                                   + [f"{v:.18g}" for v in vals]) + "\n")

    def write_quantities(self):
        sim = self.sim
        path = self.outdir / "monitor" / "Quantities.dat"
        if not self._quantities_initialized:
            if not path.exists():
                with open(path, "w") as f:
                    f.write("#FargoCPT quantities file\n")
                    f.write("#version: 2.4\n")
                    for i, name in enumerate(QUANTITIES_COLUMNS):
                        f.write(f"#variable: {i} | {name} | code units\n")
            self._quantities_initialized = True

        vals = self._compute_quantities()
        row = [0.0] * len(QUANTITIES_COLUMNS)
        row[0] = sim.n_snapshot
        row[1] = sim.n_monitor
        row[2] = sim.time
        for name, v in vals.items():
            row[QUANTITIES_COLUMNS.index(name)] = float(v)
        row[QUANTITIES_COLUMNS.index("frame angle")] = \
            float(sim.state.frame_angle)
        # boundary/damping/floor mass bookkeeping accumulated per step
        # (reference src/output.cpp:438-490 + src/types.h:30-60), reset
        # after each monitor write
        acc = sim.state.monitor_acc
        if acc is not None and acc.mass_delta is not None:
            import jax.numpy as jnp
            md = np.asarray(acc.mass_delta)
            names = ["inner boundary mass inflow",
                     "inner boundary mass outflow",
                     "outer boundary mass inflow",
                     "outer boundary mass outflow",
                     "wave damping inner mass creation",
                     "wave damping inner mass removal",
                     "wave damping outer mass creation",
                     "wave damping outer mass removal",
                     "density floor mass creation"]
            for i, n in enumerate(names):
                row[QUANTITIES_COLUMNS.index(n)] = md[i]
            sim.state = sim.state.replace(monitor_acc=acc.replace(
                mass_delta=jnp.zeros_like(acc.mass_delta)))
        with open(path, "a") as f:
            f.write("\t".join(f"{v:.18g}" for v in row) + "\n")

    def write_ecc_changes(self):
        """monitor/eccentricity_change.dat: per-stage disk eccentricity /
        pericenter changes (reference src/output.cpp:1275-1372
        ``write_ecc_peri_changes``), reset after each write."""
        sim = self.sim
        acc = sim.state.monitor_acc
        if acc is None or acc.decc is None:
            return
        import jax.numpy as jnp
        path = self.outdir / "monitor" / "eccentricity_change.dat"
        if not path.exists():
            with open(path, "w") as f:
                f.write("# Per-stage disk ecc/pericenter changes\n")
                cols = ["snapshot number", "monitor number", "time",
                        "ecc change source", "ecc change artvisc",
                        "ecc change viscosity", "ecc change transport",
                        "ecc change damping",
                        "peri change source", "peri change artvisc",
                        "peri change viscosity", "peri change transport",
                        "peri change damping"]
                for i, c in enumerate(cols):
                    f.write(f"#variable: {i} | {c} | code units\n")
        de = np.asarray(acc.decc)
        dp = np.asarray(acc.dperi)
        with open(path, "a") as f:
            f.write("\t".join(
                [str(sim.n_snapshot), str(sim.n_monitor),
                 f"{sim.time:.16e}"]
                + [f"{v:.16e}" for v in de] + [f"{v:.16e}" for v in dp])
                + "\n")
        sim.state = sim.state.replace(monitor_acc=acc.replace(
            decc=jnp.zeros_like(acc.decc),
            dperi=jnp.zeros_like(acc.dperi)))

    def _quantities_radius_limit(self) -> float:
        """Integration radius for the Quantities.dat scalars (reference
        src/parameters.cpp:549-556 + src/output.cpp:367-374): default
        2*RMAX; values <= RMIN reset to the default at parse time;
        negative means the primary's Roche lobe about the secondary."""
        sim = self.sim
        qrl = sim.phys.quantities_radius_limit
        if qrl == 0.0:
            return 2.0 * sim.geometry.rmax
        if 0.0 < qrl <= sim.geometry.rmin:
            return 2.0 * sim.geometry.rmax
        if qrl < 0.0:
            nb = sim.state.nbody
            if nb.x.shape[0] < 2:
                return 2.0 * sim.geometry.rmax
            from .nbody import system as _ns
            import jax.numpy as _jnp
            x = np.asarray(nb.x)
            y = np.asarray(nb.y)
            m = np.asarray(nb.mass)
            # primary's Roche fraction: run the L1 Newton with the roles
            # swapped so body 1 plays the central object
            swapped = nb.replace(
                x=_jnp.asarray([x[1], x[0]]), y=_jnp.asarray([y[1], y[0]]),
                vx=nb.vx[:2], vy=nb.vy[:2],
                mass=_jnp.asarray([m[1], m[0]]))
            frac = float(_ns.dimensionless_roche_radius(swapped)[1])
            dist = float(np.hypot(x[1] - x[0], y[1] - y[0]))
            return frac * dist
        return float(qrl)

    def _compute_quantities(self):
        sim = self.sim
        st = sim.stepper
        f = sim.fields
        cs, press, h = st.derived(f.sigma, f.energy)
        bodies = st.bodies_on_grid(sim.state.nbody, sim.time)
        import jax.numpy as jnp
        pot = None
        from .ops import gravity
        zero = jnp.zeros((), st.dtype)
        pot = gravity.nbody_potential(
            sim.phys, sim.constants, st.g, bodies, st.n_bodies,
            st.cell_x, st.cell_y, h, zero, zero)
        cos_phi = jnp.asarray(sim.geometry.cos_phi, st.dtype)[None, :]
        sin_phi = jnp.asarray(sim.geometry.sin_phi, st.dtype)[None, :]
        radius_limit = self._quantities_radius_limit()
        vals = quant.monitor_quantities(
            sim.phys, sim.constants, st.g, f.sigma, f.vrad, f.vaz, f.energy,
            pot, sim.state.qplus, sim.state.qminus, sim.state.omega_frame,
            sim.state.frame_angle, cos_phi, sin_phi, radius_limit)
        # instantaneous disk torques (reference src/quantities.cpp:1000-1017
        # CalculateMonitorQuantitiesForOutput, dt = 1)
        one = jnp.ones((), st.dtype)
        nr = st.g.nrad
        mask = (st.g.rb[1:nr - 1] <= radius_limit)

        def reduce_active(grid):
            return jnp.sum(jnp.where(mask, grid[1:nr - 1], 0.0))

        cs2, _, h2 = st.derived(f.sigma, f.energy)
        nu = st.viscosity_grid(cs2, h2)
        vals["advection torque"] = reduce_active(
            quant.advection_torque_increment(st.g, f.sigma, f.vrad, f.vaz,
                                             one))
        vals["viscous torque"] = reduce_active(
            quant.viscous_torque_increment(st.g, f.sigma, nu, f.vrad, f.vaz,
                                           one))
        vals["gravitational torque"] = reduce_active(
            quant.gravitational_torque_increment(st.g, f.sigma, pot, one))
        # pdivv of the last hydro step (reference src/SourceEuler.cpp:978
        # + output.cpp:425-466)
        if sim.phys.is_adiabatic:
            from .ops import sources
            pv = st.pvte_vals(f.sigma, f.energy)
            gam = pv[0] if pv is not None else sim.phys.adiabatic_index
            pdivv = (gam - 1.0) * sim.last_dt \
                * sources.divergence_v(st.g, f.vrad, f.vaz) * f.energy
            vals["pdivv"] = reduce_active(pdivv)
        return vals

    def write_timestep_log(self):
        sim = self.sim
        st = sim.monitor_stats
        if not st:
            return
        path = self.outdir / "monitor" / "timestepLogging.dat"
        if not path.exists():
            with open(path, "w") as f:
                f.write("# timestep logging file\n")
                f.write("#variable: 0 | snapshot number | 1\n")
                f.write("#variable: 1 | monitor number | 1\n")
                f.write("#variable: 2 | time | code\n")
                f.write("#variable: 3 | walltime | s\n")
                f.write("#variable: 4 | walltime per hydrostep | ms\n")
                f.write("#variable: 5 | mean dt | code\n")
                f.write("#variable: 6 | min dt | code\n")
                f.write("#variable: 7 | std dev dt | code\n")
        n = max(st["n_steps"], 1)
        mean = st["dt_sum"] / n
        var = max(st["dt_sq"] / n - mean ** 2, 0.0)
        with open(path, "a") as f:
            f.write(f"{sim.n_snapshot}\t{sim.n_monitor}\t{sim.time:.18g}\t"
                    f"{st['walltime']:.6g}\t"
                    f"{1e3 * st['walltime'] / n:.6g}\t"
                    f"{mean:.18g}\t{st['dt_min']:.18g}\t"
                    f"{math.sqrt(var):.18g}\n")

    def write_nbody_monitor(self):
        sim = self.sim
        nb = sim.state.nbody
        # circumplanetary (Roche-lobe) gas mass per companion (reference
        # src/circumplanetary_mass.cpp:11-50, called each monitor from
        # src/simulation.cpp:83)
        mdcp = {}
        if sim.phys.calculate_disk:
            import jax.numpy as jnp
            from .nbody import system as nbody_sys
            st = sim.stepper
            dist = nbody_sys.dist_to_primary(nb)
            roche = nbody_sys.dimensionless_roche_radius(nb) * dist
            for k in range(1, st.n_bodies):
                mdcp[k] = float(quant.circumplanetary_mass(
                    sim.constants, st.g, sim.fields.sigma, st.cell_x,
                    st.cell_y, nb.x[k], nb.y[k], roche[k]))
        for k in range(len(np.asarray(nb.mass))):
            path = self.outdir / "monitor" / f"nbody{k}.dat"
            new = not path.exists()
            el = sim.orbital_elements(k)
            torque = float(sim.stepper.disk_torques(sim.state, sim.time)[k]) \
                if sim.phys.calculate_disk else 0.0
            with open(path, "a") as f:
                if new:
                    cols = ["snapshot number", "monitor number", "x", "y",
                            "vx", "vy", "mass", "time", "omega frame",
                            "mdcp", "eccentricity", "angular momentum",
                            "semi-major axis", "omega kepler", "mean anomaly",
                            "eccentric anomaly", "true anomaly",
                            "pericenter angle", "torque", "accreted mass",
                            "indirect torque"]
                    f.write("#FargoCPT planet file\n#version: 2.1\n")
                    for i, c in enumerate(cols):
                        f.write(f"#variable: {i} | {c} | code units\n")
                x, y = float(nb.x[k]), float(nb.y[k])
                vx, vy = float(nb.vx[k]), float(nb.vy[k])
                m = float(nb.mass[k])
                L = m * (x * vy - y * vx)
                omega_k = math.sqrt(
                    sim.constants.G * sim.phys.hydro_center_mass
                    / max(el["a"], 1e-300) ** 3) if el["a"] > 0 else 0.0
                # accreted mass = growth over the configured mass (the
                # reference tracks it separately; with disk feedback on
                # the two are identical, reference accretion.cpp:205-218)
                accreted = m - float(sim.bodies[k].mass)
                f.write("\t".join(f"{v:.18g}" for v in [
                    sim.n_snapshot, sim.n_monitor, x, y, vx, vy, m, sim.time,
                    float(sim.state.omega_frame), mdcp.get(k, 0.0),
                    el["e"], L, el["a"],
                    omega_k, el["mean_anomaly"], el["eccentric_anomaly"],
                    el["true_anomaly"], el["pericenter_angle"], torque,
                    accreted, 0.0]) + "\n")

    # hooks ---------------------------------------------------------------
    def _on_monitor(self, sim):
        if sim.phys.write_disk_quantities:
            self.write_quantities()
        self.write_timestep_log()
        self.write_nbody_monitor()
        if sim.phys.write_lightcurves:
            self.write_lightcurves()
        if sim.phys.write_ecc_changes:
            self.write_ecc_changes()

    def _on_snapshot(self, sim):
        self.write_snapshot()


# ---------------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------------

def load_misc(snapshot_dir: str | Path) -> dict:
    blob = (Path(snapshot_dir) / "misc.bin").read_bytes()
    vals = struct.unpack(MISC_STRUCT, blob[:struct.calcsize(MISC_STRUCT)])
    return {"n_snapshot": vals[0], "n_monitor": vals[1], "time": vals[2],
            "omega_frame": vals[3], "frame_angle": vals[4],
            "last_dt": vals[5], "n_hydro_iter": vals[6]}


def last_snapshot_id(outdir: str | Path) -> str:
    path = Path(outdir) / "snapshots" / "list.txt"
    ids = [l.strip() for l in path.read_text().splitlines() if l.strip()]
    return ids[-1]


# ---------------------------------------------------------------------------
# Distributed (shard-local) snapshot IO — the JAX analog of the
# reference's MPI-IO slab writes (src/polargrid.cpp:135-186 write_polargrid
# with per-rank offsets): each process writes only the rows of its
# addressable JAX shards, one file per contiguous row range, named
# <Field>.r<start>-<stop>.dat.  No full-grid array is ever materialized on
# a single host.

import re as _re

_SHARD_FILE_RE = _re.compile(r"^(.+)\.r(\d+)-(\d+)\.dat$")

# FieldState attr -> snapshot file base name
_SHARD_FIELD_NAMES = (("sigma", "Sigma"), ("vrad", "vrad"),
                      ("vaz", "vazi"), ("energy", "energy"))


def write_sharded_array(arr, sdir: Path, base: str) -> None:
    """Write one sharded jax array as per-shard row-range files.  Fully
    replicated arrays are written once (by process 0 on multi-host)."""
    import jax as _jax
    nrows = arr.shape[0]
    seen = set()
    for sh in arr.addressable_shards:
        sl = sh.index[0] if sh.index else slice(None)
        r0 = sl.start if sl.start is not None else 0
        r1 = sl.stop if sl.stop is not None else nrows
        if (r0, r1) in seen:
            continue          # replicated copies on other local devices
        seen.add((r0, r1))
        if (r0, r1) == (0, nrows) and _jax.process_index() != 0:
            continue          # fully replicated: one global copy suffices
        np.asarray(sh.data, np.float64).tofile(
            sdir / f"{base}.r{r0:05d}-{r1:05d}.dat")


def read_sharded_array(sdir: Path, base: str, shape, sharding, dtype):
    """Assemble a sharded jax array from row-range shard files.  Each
    device's callback reads only the rows it needs, so no host ever holds
    the full grid; the writing and reading device counts may differ."""
    import jax as _jax
    import jax.numpy as _jnp

    pieces = []
    for p in sorted(Path(sdir).glob(f"{base}.r*-*.dat")):
        m = _SHARD_FILE_RE.match(p.name)
        if m and m.group(1) == base:
            pieces.append((int(m.group(2)), int(m.group(3)), p))
    if not pieces:
        raise FileNotFoundError(f"no shard files for {base} in {sdir}")
    tail = tuple(shape[1:])

    def cb(index):
        sl = index[0] if index else slice(None)
        r0 = sl.start if sl.start is not None else 0
        r1 = sl.stop if sl.stop is not None else shape[0]
        out = np.empty((r1 - r0,) + tail, np.float64)
        filled = 0
        for f0, f1, path in pieces:
            lo, hi = max(r0, f0), min(r1, f1)
            if lo >= hi:
                continue
            data = np.fromfile(path, np.float64).reshape((f1 - f0,) + tail)
            out[lo - r0:hi - r0] = data[lo - f0:hi - f0]
            filled += hi - lo
        if filled < r1 - r0:
            raise ValueError(
                f"shard files for {base} do not cover rows {r0}:{r1}")
        return _jnp.asarray(out, dtype)

    return _jax.make_array_from_callback(tuple(shape), sharding, cb)


def _is_multidevice(arr) -> bool:
    try:
        return len(arr.sharding.device_set) > 1
    except AttributeError:
        return False


def restore_simulation(sim, outdir: str | Path, snapshot_id: str | int):
    """Load a snapshot back into a freshly constructed Simulation
    (reference src/restart.cpp:19-131)."""
    import jax.numpy as jnp
    sdir = Path(outdir) / "snapshots" / str(snapshot_id)
    g = sim.geometry
    dt = jnp.dtype(sim.phys.dtype)

    def rd(name, nrad):
        base = name[:-4]
        if not (sdir / name).exists():
            # distributed snapshot: assemble from per-shard row files,
            # placing rows straight onto the current field's sharding
            cur = getattr(sim.fields,
                          {"Sigma": "sigma", "vrad": "vrad", "vazi": "vaz",
                           "energy": "energy", "Qplus": "qplus",
                           "Qminus": "qminus", "PvteGeff": "sigma",
                           "PvteMu": "sigma"}[base])
            return read_sharded_array(sdir, base, (nrad, g.naz),
                                      cur.sharding, dt)
        return jnp.asarray(
            np.fromfile(sdir / name, np.float64).reshape(nrad, g.naz), dt)

    fields = sim.fields.replace(
        sigma=rd("Sigma.dat", g.nrad), vrad=rd("vrad.dat", g.nrad + 1),
        vaz=rd("vazi.dat", g.nrad), energy=rd("energy.dat", g.nrad))
    misc = load_misc(sdir)
    nb_arr = np.fromfile(sdir / "nbody.bin", np.float64).reshape(-1, 5)
    nbody = sim.state.nbody.replace(
        x=jnp.asarray(nb_arr[:, 0], dt), y=jnp.asarray(nb_arr[:, 1], dt),
        vx=jnp.asarray(nb_arr[:, 2], dt), vy=jnp.asarray(nb_arr[:, 3], dt),
        mass=jnp.asarray(nb_arr[:, 4], dt))
    def _have(base):
        return (sdir / f"{base}.dat").exists() or \
            any(sdir.glob(f"{base}.r*-*.dat"))

    qplus = rd("Qplus.dat", g.nrad) if _have("Qplus") else sim.state.qplus
    qminus = rd("Qminus.dat", g.nrad) if _have("Qminus") \
        else sim.state.qminus
    # ROF massflow tracker (reference src/massflow_tracker.cpp
    # read_from_file)
    if (sdir / "massflow_tracker.bin").exists() \
            and sim.state.monitor_acc is not None \
            and sim.state.monitor_acc.rof_mdot is not None:
        vals = np.fromfile(sdir / "massflow_tracker.bin", np.float64)
        sim.state = sim.state.replace(
            monitor_acc=sim.state.monitor_acc.replace(
                rof_mdot=jnp.asarray(vals[2], dt)))
    # dust particles (reference src/particles/particles.cpp:797 restart)
    if (sdir / "particles.bin").exists() and sim.state.particles is not None:
        raw = np.fromfile(sdir / "particles.bin", np.float64)
        ncol = 9 if raw.size % 9 == 0 else 7   # 7 = pre-round-2 snapshots
        arr = raw.reshape(-1, ncol)
        p = sim.state.particles
        n = arr.shape[0]
        sim.state = sim.state.replace(particles=p.replace(
            r=jnp.asarray(arr[:, 0], dt), phi=jnp.asarray(arr[:, 1], dt),
            r_dot=jnp.asarray(arr[:, 2], dt),
            phi_dot=jnp.asarray(arr[:, 3], dt),
            size=jnp.asarray(arr[:, 4], dt),
            stokes=jnp.asarray(arr[:, 5], dt),
            alive=jnp.asarray(arr[:, 6] > 0.5),
            timestep=jnp.asarray(arr[:, 7], dt) if ncol == 9
            else jnp.zeros(n, dt),
            facold=jnp.asarray(arr[:, 8], dt) if ncol == 9
            else jnp.full(n, 1e-4, dt)))
    pvte_guess = sim.state.pvte_guess
    if pvte_guess is not None:
        if _have("PvteGeff") and _have("PvteMu"):
            # exact warm-start cache from the snapshot: the restarted
            # trajectory is bitwise the uninterrupted one
            pvte_guess = (rd("PvteGeff.dat", g.nrad),
                          rd("PvteMu.dat", g.nrad))
        else:
            # no cache in the snapshot: re-seed with a cold solve on the
            # RESTORED fields (a pure solver cache — tolerance-level
            # difference only)
            st = sim.stepper
            st._pvte_chain = None
            pv = st.pvte_vals(fields.sigma, fields.energy)
            st._pvte_chain = None
            pvte_guess = (pv[0], pv[1])
    sim.state = sim.state.replace(
        fields=fields, nbody=nbody, qplus=qplus, qminus=qminus,
        omega_frame=jnp.asarray(misc["omega_frame"], dt),
        frame_angle=jnp.asarray(misc["frame_angle"], dt),
        pvte_guess=pvte_guess)
    sim.time = misc["time"]
    sim.last_dt = misc["last_dt"]
    sim.n_monitor = misc["n_monitor"]
    sim.n_snapshot = misc["n_snapshot"]
    sim.n_hydro_iter = misc["n_hydro_iter"]
    # restarts resume with the stored last_dt; the fresh-start double
    # growth (sim.py run()) must not apply (reference src/simulation.cpp:467)
    sim._dt_primed = True
    # the reference never re-writes the restored snapshot on restart
    # (src/simulation.cpp:505-560 run() has no initial handle_outputs);
    # re-registering it would duplicate list.txt / timeSnapshot.dat rows
    sim._restored = True
    return sim
