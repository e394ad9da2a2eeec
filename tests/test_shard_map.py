"""Explicit shard_map/ppermute halo-exchange path vs the single-device
step (analog of the reference's mpi_simple + the commbound correctness
contract: a sharded run must reproduce the serial run).

Unlike the GSPMD tests (test_sharding.py), these exercise
parallel/shard_step.py: skewed extended windows, one stacked ppermute
pair per step, pmin CFL, psum feedback/diagnostics, sharded vrad faces.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation
from fargocpt_tpu.parallel.mesh import make_mesh
from fargocpt_tpu.parallel.shard_step import ShardedHydroStep, AXIS

AXIS_NAME = AXIS


def flagship_config(nrad=192, naz=64, extra=None):
    cfg = {
        "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
        "AspectRatio": "0.05", "FlaringIndex": "0.25",
        "ViscousAlpha": "0.001",
        "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
        "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
        "CoolingBeta": "10",
        "ArtificialViscosity": "SN",
        "Nrad": str(nrad), "Naz": str(naz),
        "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Transport": "FARGO",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.5",
        "FirstDT": "1e-4",
    }
    if extra:
        cfg.update(extra)
    return Config.from_dict(cfg)


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.max(np.abs(a)), 1e-300)
    return np.max(np.abs(a - b)) / scale


def _compare_states(s_single, s_sharded, tol):
    for name in ("sigma", "vrad", "vaz", "energy"):
        d = _rel(getattr(s_single.fields, name),
                 getattr(s_sharded.fields, name))
        assert d < tol, f"{name}: sharded vs single rel diff {d:.3e}"
    for name in ("qplus", "qminus"):
        d = _rel(getattr(s_single, name), getattr(s_sharded, name))
        assert d < tol, f"{name}: rel diff {d:.3e}"


def test_sharded_step_matches_single_device():
    """One full step on the flagship adiabatic config: 8-way explicit
    shard_map == single device at f64 roundoff."""
    sim = Simulation(flagship_config())
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.stepper.step(sim.state, 0.0, 2e-4)
    pair = ss.step(pair, 0.0, 2e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 1e-13)
    # owned vrad stays sharded (8 device shards)
    assert len(pair[0].fields.vrad.sharding.device_set) == 8


def test_sharded_cfl_matches_single_device():
    sim = Simulation(flagship_config())
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)
    dt1 = float(sim.stepper.cfl_dt(sim.state))
    dt2 = float(ss.cfl_dt(pair))
    assert np.isclose(dt1, dt2, rtol=1e-14), (dt1, dt2)


def test_sharded_advance_matches_single_device():
    """A whole monitor interval (many steps, dynamic dt, exact landing)
    inside the shard_map while_loop: one ppermute pair per iteration."""
    sim = Simulation(flagship_config())
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    out1 = sim.stepper.advance_to(sim.state, 0.0, 1e-4, 0.5)
    s1, t1, dt1, n1 = out1[0], out1[1], out1[2], out1[3]

    pair2, t2, dt2, n2, *_stats = ss.advance_to(pair, 0.0, 1e-4, 0.5)
    s2 = ss.gather(pair2)

    assert int(n1) == int(n2), (int(n1), int(n2))
    assert np.isclose(float(t1), float(t2), rtol=0, atol=0)
    assert np.isclose(float(dt1), float(dt2), rtol=1e-12)
    _compare_states(s1, s2, 1e-11)


def test_sharded_planet_feedback_matches_single_device():
    """Disk-on-planet force (psum), accretion bookkeeping (psum) and the
    corotating frame under the explicit path."""
    cfg = flagship_config(nrad=192, naz=64, extra={
        "EquationOfState": "Isothermal",
        "DiskFeedback": "yes",
        "Frame": "C", "CorotationReferenceBody": "1",
        "nbody": [
            {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
            {"name": "planet", "semi-major axis": "1.0", "mass": "1e-3",
             "accretion efficiency": "1.0", "accretion method": "kley"},
        ],
    })
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 1e-12)
    for name in ("x", "y", "vx", "vy", "mass"):
        d = _rel(getattr(s1.nbody, name), getattr(s2.nbody, name))
        assert d < 1e-13, f"nbody.{name}: rel diff {d:.3e}"
    assert np.isclose(float(s1.omega_frame), float(s2.omega_frame),
                      rtol=1e-13)


def test_sharded_damping_massdelta_matches():
    """Damping zones + boundary mass bookkeeping (masked psum path)."""
    cfg = flagship_config(extra={
        "Damping": "Yes", "DampingInnerLimit": "1.10",
        "DampingOuterLimit": "0.90", "DampingTimeFactor": "10",
    })
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.stepper.step(sim.state, 0.0, 2e-4)
    pair = ss.step(pair, 0.0, 2e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 1e-13)
    d = _rel(s1.monitor_acc.mass_delta, s2.monitor_acc.mass_delta)
    assert d < 1e-12, f"mass_delta rel diff {d:.3e}"


def test_sharded_fld_matches_single_device():
    """FLD radiative diffusion under the explicit path: per-SOR-iteration
    ppermute ghost refresh + psum'd convergence norm must reproduce the
    single-device solve (iteration count and fields)."""
    cfg = flagship_config(extra={
        "Sigma0": "2000 g/cm2",
        "CoolingBetaLocal": "No",
        "SurfaceCooling": "thermal",
        "RadiativeDiffusion": "Yes",
        "RadiativeDiffusionMaxIterations": "300",
        "RadiativeDiffusionAutoOmega": "Yes",
    })
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 5e-12)
    # the auto-omega walk saw the same iteration counts
    np.testing.assert_allclose(np.asarray(s1.fld_sor),
                               np.asarray(s2.fld_sor), rtol=1e-12)


def test_sharded_particles_match_single_device():
    """Replicated dust swarm under the explicit path
    (shard_particles=False fallback): drag + diffusion on all-gathered
    global fields reproduces the single-device integration
    bit-for-bit-level."""
    cfg = flagship_config(extra={
        "IntegrateParticles": "yes", "NumberOfParticles": "32",
        "ParticleRadius": "1 cm", "ParticleSpeciesNumber": "2",
        "ParticleDustDiffusion": "yes",
    })
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh, shard_particles=False)
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 1e-13)
    for name in ("r", "phi", "r_dot", "phi_dot", "timestep"):
        d = _rel(getattr(s1.particles, name), getattr(s2.particles, name))
        assert d < 1e-13, f"particles.{name}: rel diff {d:.3e}"


def test_sharded_particle_buckets_match_single_device():
    """Slab-owned dust buckets (particles/sharded.py, the default):
    per-shard integration against the local extended window + ppermute
    migration reproduces the single-device swarm at f64 roundoff, with
    every particle accounted for in canonical pid order."""
    cfg = flagship_config(extra={
        "IntegrateParticles": "yes", "NumberOfParticles": "64",
        "ParticleRadius": "1 cm", "ParticleSpeciesNumber": "2",
    })
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    assert ss.shard_particles
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 1e-13)
    sp = pair[0].particles
    assert int(np.sum(np.asarray(sp.overflow))) == 0
    pid = np.asarray(sp.pid)[np.asarray(sp.valid)]
    assert np.array_equal(np.sort(pid), np.arange(64)), pid
    for name in ("r", "phi", "r_dot", "phi_dot", "stokes"):
        d = _rel(getattr(s1.particles, name), getattr(s2.particles, name))
        assert d < 1e-12, f"particles.{name}: rel diff {d:.3e}"
    # migration traffic replaced the 4-slab all_gather in the model
    m = ss.comm_model()
    assert "particles_migration" in m
    assert "particles_allgather" not in m


def test_particle_migration_exchange():
    """The fixed-buffer ppermute migration (particles/sharded.py
    ``migrate``) moves boundary-crossers to the correct neighbor bucket,
    preserves pids/payload, frees the source slots, and counts overflow
    — exercised directly on the 8-device mesh with crafted positions."""
    from jax.sharding import PartitionSpec as P
    from fargocpt_tpu.particles import sharded as psh
    from fargocpt_tpu.parallel.shard_step import _shard_map

    n, C, E = 8, 4, 2
    mesh = make_mesh(n)
    dt = jnp.float64
    # shard k owns [k, k+1); slot layout: [stay, up-crosser, down-crosser,
    # empty] on shard 3, plain stay elsewhere
    r = np.full(n * C, 0.0)
    valid = np.zeros(n * C, bool)
    alive = np.zeros(n * C, bool)
    pid = np.full(n * C, -1, np.int32)
    for k in range(n):
        r[k * C] = k + 0.5
        valid[k * C] = alive[k * C] = True
        pid[k * C] = k
    r[3 * C + 1] = 4.2     # belongs to shard 4
    r[3 * C + 2] = 2.7     # belongs to shard 2
    valid[3 * C + 1] = valid[3 * C + 2] = True
    alive[3 * C + 1] = alive[3 * C + 2] = True
    pid[3 * C + 1], pid[3 * C + 2] = 100, 200
    lo = np.arange(n, dtype=np.float64)
    hi = lo + 1.0
    lo[0], hi[-1] = -np.inf, np.inf
    is_top = (np.arange(n) == n - 1).astype(np.float64)
    is_bot = (np.arange(n) == 0).astype(np.float64)

    leaves = {name: jnp.asarray(np.where(valid, r, 0.0)
                                if name == "r" else np.zeros(n * C))
              for name in psh._FIELDS}
    leaves["r"] = jnp.asarray(r)
    leaves["alive"] = jnp.asarray(alive)
    leaves["valid"] = jnp.asarray(valid)
    leaves["pid"] = jnp.asarray(pid)
    leaves["overflow"] = jnp.zeros(n, jnp.int32)

    def fn(lv, lo_, hi_, top_, bot_):
        spl = {k: v for k, v in lv.items() if k != "overflow"}
        spl["overflow"] = lv["overflow"][0]
        out = psh.migrate(spl, lo_[0], hi_[0], top_[0], bot_[0], E,
                          "r", n)
        out["overflow"] = out["overflow"][None]
        return out

    specs = {k: P(AXIS_NAME) for k in leaves}
    mapped = jax.jit(_shard_map(
        fn, mesh,
        in_specs=(specs, P(AXIS_NAME), P(AXIS_NAME), P(AXIS_NAME),
                  P(AXIS_NAME)),
        out_specs=specs))
    out = mapped(leaves, jnp.asarray(lo), jnp.asarray(hi),
                 jnp.asarray(is_top), jnp.asarray(is_bot))

    r2 = np.asarray(out["r"])
    valid2 = np.asarray(out["valid"])
    pid2 = np.asarray(out["pid"])
    # stayers untouched
    for k in range(n):
        assert valid2[k * C] and pid2[k * C] == k
    # crossers moved into a free slot of the right neighbor bucket
    s4 = slice(4 * C, 5 * C)
    s2_ = slice(2 * C, 3 * C)
    assert 100 in pid2[s4] and np.isclose(r2[s4][pid2[s4] == 100], 4.2)
    assert 200 in pid2[s2_] and np.isclose(r2[s2_][pid2[s2_] == 200], 2.7)
    # source slots freed
    assert not valid2[3 * C + 1] and not valid2[3 * C + 2]
    assert pid2[3 * C + 1] == -1
    assert int(np.asarray(out["overflow"]).sum()) == 0
    # total census conserved
    assert valid2.sum() == valid.sum()


def test_shard_gather_particles_roundtrip():
    """Host-side bucket/gather roundtrip is the identity on the swarm."""
    from fargocpt_tpu.particles import dust, sharded as psh

    radii = np.geomspace(0.4, 2.5, 65)
    ps = dust.init_particles(40, 0.45, 2.4, 0.5, 1e-5, 1.0, seed=7)
    sp, C, bounds = psh.shard_particles(ps, 8, 8, radii)
    back = psh.gather_particles(sp, 40, ps)
    for name in ("r", "phi", "r_dot", "phi_dot", "size", "stokes",
                 "timestep", "facold"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(ps, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(back.alive),
                                  np.asarray(ps.alive))


def test_sharded_selfgravity_matches_single_device():
    """FFT self-gravity under the explicit path: the convolution runs
    replicated on the all-gathered Sigma; the kick, the kernel-refresh
    cadence state, and the alpha-grav monitor must match."""
    cfg = flagship_config(extra={
        "Sigma0": "5000 g/cm2",
        "SelfGravity": "Yes", "SelfGravityMode": "symmetric",
        "WriteAlphaGravMean": "Yes",
    })
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 5e-12)
    # the alpha-grav accumulator is ~1e-21 here (weak SG) and its
    # g_r*g_t products amplify roundoff near zero crossings; a window
    # misalignment in the gather hook would show up at O(1)
    d = _rel(s1.monitor_acc.alpha_grav_mean, s2.monitor_acc.alpha_grav_mean)
    assert d < 1e-3, f"alpha_grav_mean rel diff {d:.3e}"
    if s1.sg_kernel is not None:
        for a, b in zip(s1.sg_kernel, s2.sg_kernel):
            assert _rel(a, b) < 1e-12


@pytest.mark.slow
def test_sharded_composite_bcs_match_single_device():
    """Roche-lobe-overflow stream + center-of-mass outer boundary under
    the explicit path: both write local edge rows from replicated N-body
    state — the skewed-window contract must reproduce them exactly."""
    cfg = flagship_config(extra={
        "RocheLobeOverflow": "Yes", "ROFValue": "1e-9 solMass/yr",
        "ROFPlanet": "1", "ROFTemperature": "4000",
        "OuterBoundary": "centerofmass",
        "nbody": [
            {"name": "star", "semi-major axis": "0.0", "mass": "1.0"},
            {"name": "donor", "semi-major axis": "1.0", "mass": "0.5"},
        ]})
    sim = Simulation(cfg)
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    _compare_states(s1, s2, 1e-12)
    d = _rel(s1.monitor_acc.rof_mdot, s2.monitor_acc.rof_mdot)
    assert d < 1e-12, f"rof_mdot rel diff {d:.3e}"


@pytest.mark.slow
def test_sharded_full_physics_pvte_matches_single_device():
    """The PDS70-style full-physics menu — PVTE EoS (fast f32 path with
    the warm-start cache riding the halo exchange), self-gravity, FLD and
    dust — under the explicit shard_map path, in the f32 production
    dtype.  Exercises the pvte_guess halo rings: a stale guess row would
    mis-polish the boundary rows' EoS refresh and show up here."""
    cfg = flagship_config(extra={
        "EquationOfState": "PVTE", "HydrogenMassFraction": "0.75",
        "Sigma0": "2000 g/cm2",
        "CoolingBetaLocal": "No",
        "SurfaceCooling": "thermal",
        "RadiativeDiffusion": "Yes",
        "RadiativeDiffusionMaxIterations": "300",
        "SelfGravity": "Yes", "SelfGravityMode": "symmetric",
        "IntegrateParticles": "yes", "NumberOfParticles": "32",
        "ParticleRadius": "1 cm", "ParticleSpeciesNumber": "2",
    })
    sim = Simulation(cfg, dtype="float32")
    assert sim.state.pvte_guess is not None
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    pair = ss.shard_state(sim.state)

    s1 = sim.state
    for i in range(3):
        s1 = sim.stepper.step(s1, i * 1e-4, 1e-4)
        pair = ss.step(pair, i * 1e-4, 1e-4)
    s2 = ss.gather(pair)
    # f32 production dtype: reduction-order roundoff only
    _compare_states(s1, s2, 5e-6)
    for i in range(2):
        d = _rel(s1.pvte_guess[i], s2.pvte_guess[i])
        assert d < 5e-6, f"pvte_guess[{i}]: rel diff {d:.3e}"


def test_sharded_rejects_indivisible():
    sim = Simulation(flagship_config(nrad=100))
    with pytest.raises(ValueError):
        ShardedHydroStep(sim.stepper, make_mesh(8))


def test_comm_model_accounting():
    """The per-step inter-device traffic model: exact bytes
    for the halo ppermute, and the all_gather categories appear only for
    the configs that pay them."""
    sim = Simulation(flagship_config(), dtype="float64")
    mesh = make_mesh(8)
    ss = ShardedHydroStep(sim.stepper, mesh)
    m = ss.comm_model()
    # 6 fields x (2*halo+1) rows x NAZ x 8 bytes x 2 directions
    assert m["halo_ppermute"] == 6 * ss.S * 64 * 8 * 2
    assert "selfgravity_allgather" not in m
    assert "particles_allgather" not in m
    assert m["total"] > 0
    assert "total=" in ss.comm_model_summary()

    sim2 = Simulation(flagship_config(extra={
        "SelfGravity": "Yes",
        "IntegrateParticles": "yes", "NumberOfParticles": "128",
        "ParticleIntegrator": "midpoint", "ParticleRadius": "1 cm",
    }), dtype="float64")
    # replicated fallback: 4-slab all_gather per integration; the SG
    # Sigma gather is CSE'd into the particle one (HLO-verified, see
    # test_comm_model_matches_compiled_hlo)
    ss2 = ShardedHydroStep(sim2.stepper, mesh, shard_particles=False)
    m2 = ss2.comm_model()
    assert "selfgravity_allgather" not in m2
    assert m2["particles_allgather"] == 4 * 7 * (192 // 8) * 64 * 8

    # default: slab-owned buckets — constant-size migration buffers and
    # SG pays its own gather
    ss2b = ShardedHydroStep(sim2.stepper, mesh)
    ss2b.shard_state(sim2.state)
    m2b = ss2b.comm_model()
    E = ss2b._particle_E
    assert m2b["particles_migration"] == 2 * E * (8 * 8 + 12)
    assert m2b["selfgravity_allgather"] == 7 * (192 // 8) * 64 * 8

    sim3 = Simulation(flagship_config(extra={"SelfGravity": "Yes"}),
                      dtype="float64")
    ss3 = ShardedHydroStep(sim3.stepper, mesh)
    assert ss3.comm_model()["selfgravity_allgather"] \
        == 7 * (192 // 8) * 64 * 8


# --- comm model vs compiled HLO ------------------------------------------

_HLO_SIZES = {"f32": 4, "f64": 8, "s32": 4, "u32": 4, "pred": 1,
              "s64": 8, "u64": 8, "bf16": 2, "f16": 2}


def _collective_bytes(hlo_text):
    """(collective-permute bytes, all-gather OUTPUT bytes, op shape lists)
    summed over every computation of an optimized HLO module. A while-loop
    body appears exactly once, so in-loop collectives count once."""
    import re

    def scan(opname):
        total, ops = 0, []
        pat = rf"=\s+(\w+)\[([\d,]*)\][^\s]*\s+{opname}\("
        for m in re.finditer(pat, hlo_text):
            dt, dims = m.group(1), m.group(2)
            count = 1
            for d in dims.split(","):
                if d:
                    count *= int(d)
            total += count * _HLO_SIZES[dt]
            ops.append((dt, dims))
        return total, ops

    perm, perm_ops = scan("collective-permute")
    ag, ag_ops = scan("all-gather")
    return perm, perm_ops, ag, ag_ops


def _lower_step_hlo(ss):
    """Compiled-HLO text of one explicit-path sharded step (the same
    program ``ShardedHydroStep.step`` jits)."""
    from jax.sharding import PartitionSpec as P
    from fargocpt_tpu.parallel.shard_step import _shard_map

    state, top = ss.shard_state(ss._hlo_state)
    state_specs = ss._specs_for(state)

    def fn(owned, topv, time, dt, ctx_blk):
        ctx = jax.tree_util.tree_map(lambda a: a[0], ctx_blk)
        st = ss._localize(ctx)
        ext = ss._assemble(owned, topv, ctx)
        new_ext = st._step_impl(ext, time, dt)
        return ss._extract(new_ext, ctx)

    mapped = jax.jit(_shard_map(
        fn, ss.mesh,
        in_specs=(state_specs, P(), P(), P(), ss._ctx_specs),
        out_specs=(state_specs, P())))
    lowered = mapped.lower(state, top, jnp.asarray(0.0, ss.dtype),
                           jnp.asarray(1e-4, ss.dtype), ss._ctx)
    return lowered.compile().as_text()


def _hlo_case(extra, dtype="float64", **kw):
    sim = Simulation(flagship_config(extra=extra), dtype=dtype)
    ss = ShardedHydroStep(sim.stepper, make_mesh(8), **kw)
    ss._hlo_state = sim.state
    return ss, _lower_step_hlo(ss)


def _close(a, b, tol=0.2):
    return abs(a - b) <= tol * max(a, b)


@pytest.mark.slow
def test_comm_model_matches_compiled_hlo():
    """The hand-built traffic model (comm_model) vs the collectives
    XLA actually compiled into the sharded step on the 8-device CPU mesh:
    every byte count must match the optimized HLO within
    20% (the stacked-exchange and all_gather entries match exactly)."""
    n = 8

    # 1. flagship: the only collective traffic is the stacked halo
    #    exchange — model matches the two collective-permutes exactly.
    ss, hlo = _hlo_case(None)
    perm, perm_ops, ag, _ = _collective_bytes(hlo)
    m = ss.comm_model()
    assert ag == 0
    assert len(perm_ops) == 2, perm_ops      # fwd + bwd stacked exchange
    assert perm == m["halo_ppermute"], (perm, m)

    # 2. PVTE f32: the warm-start (geff, mu) pair rides the stacked
    #    exchange — 8 fields, f32.
    ss, hlo = _hlo_case({"EquationOfState": "PVTE",
                         "HydrogenMassFraction": "0.75",
                         "Sigma0": "2000 g/cm2"}, dtype="float32")
    perm, perm_ops, ag, _ = _collective_bytes(hlo)
    m = ss.comm_model()
    assert perm == m["halo_ppermute"], (perm, perm_ops, m)
    assert ("f32", f"8,{ss.S},64") in perm_ops

    # 3. SG alone: one Sigma all_gather (ring cost (n-1)/n of output).
    ss, hlo = _hlo_case({"SelfGravity": "Yes"})
    perm, _, ag, ag_ops = _collective_bytes(hlo)
    m = ss.comm_model()
    sent = ag * (n - 1) // n
    assert sent == m["selfgravity_allgather"], (ag_ops, m)

    # 4. SG + slab-owned particle buckets (the default): one SG Sigma
    #    all_gather, and the migration buffers ride 4 extra ppermutes
    #    (float + int32 payload, both directions).
    particle_cfg = {"SelfGravity": "Yes",
                    "IntegrateParticles": "yes",
                    "NumberOfParticles": "128",
                    "ParticleIntegrator": "midpoint",
                    "ParticleRadius": "1 cm"}
    ss, hlo = _hlo_case(particle_cfg)
    perm, perm_ops, ag, ag_ops = _collective_bytes(hlo)
    m = ss.comm_model()
    assert len(ag_ops) == 1, ag_ops
    assert ag * (n - 1) // n == m["selfgravity_allgather"], (ag_ops, m)
    assert len(perm_ops) == 6, perm_ops
    assert perm == m["halo_ppermute"] + m["particles_migration"], \
        (perm_ops, m)

    # 4b. replicated-particle fallback: 4 field gathers for the swarm;
    #     the SG Sigma gather is CSE'd into the particle one — the model
    #     charges only particles_allgather.
    ss, hlo = _hlo_case(particle_cfg, shard_particles=False)
    perm, _, ag, ag_ops = _collective_bytes(hlo)
    m = ss.comm_model()
    sent = ag * (n - 1) // n
    assert len(ag_ops) == 4, ag_ops
    assert sent == m["particles_allgather"], (ag_ops, m)
    assert _close(sent + perm,
                  m["total"] - m["faces_and_scalars"]), (sent, perm, m)

    # 5. leapfrog doubles both the migration sweeps and the SG gathers
    #    (two half-dt kicks on different Sigmas).
    ss, hlo = _hlo_case(dict(particle_cfg, Integrator="Leapfrog"))
    perm, perm_ops, ag, ag_ops = _collective_bytes(hlo)
    m = ss.comm_model()
    assert len(ag_ops) == 2, ag_ops
    assert ag * (n - 1) // n == m["selfgravity_allgather"], (ag_ops, m)
    assert len(perm_ops) == 10, perm_ops
    assert perm == m["halo_ppermute"] + m["particles_migration"], \
        (perm_ops, m)

    # 6. FLD: the SOR loop body holds ONE bidirectional single-field
    #    exchange (= the model's per-iteration cost); the post-loop ghost
    #    refresh adds one more pair in the module text.
    ss, hlo = _hlo_case({"Sigma0": "2000 g/cm2", "CoolingBetaLocal": "No",
                         "SurfaceCooling": "thermal",
                         "RadiativeDiffusion": "Yes",
                         "RadiativeDiffusionMaxIterations": "300"})
    perm, perm_ops, _, _ = _collective_bytes(hlo)
    m = ss.comm_model(fld_iters=1)
    fld_ops = [o for o in perm_ops if not o[1].startswith("6,")]
    assert len(fld_ops) == 4, perm_ops       # loop body pair + final pair
    per_iter = sum(_HLO_SIZES[dt] * np.prod([int(d) for d in dims.split(",")])
                   for dt, dims in fld_ops) // 2
    assert per_iter == m["fld_ppermute"], (fld_ops, m)
