"""N-body planetary system: configuration, Jacobi initialization, mutual
gravity integration, frame centering, indirect terms, Roche radii.

Re-derivation of reference src/nbody/planetary_system.cpp,
src/nbody/planet.cpp, src/frame_of_reference.cpp and src/Theo.cpp:251-313.

The reference integrates with the vendored REBOUND IAS15; here the
integrator is an on-device fixed-substep RK4 over the (tiny) body arrays,
which keeps the whole hydro+N-body step inside one jit with zero host
round-trips. (N is a handful; the integration cost is negligible, the
substep count is chosen so the truncation error is at float64 roundoff
for typical hydro dt. An IAS15-class Gauss-Radau integrator is a planned
upgrade for long-horizon N-body-dominated runs.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .. import units as u
from ..config import Config
from ..ops.common import accurate_cos


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NBodyState:
    """Dynamic per-body state (length-N arrays). Masses are dynamic because
    accretion grows planets (reference src/accretion.cpp)."""
    x: jax.Array
    y: jax.Array
    vx: jax.Array
    vy: jax.Array
    mass: jax.Array

    def replace(self, **kw) -> "NBodyState":
        from dataclasses import replace as _replace
        return _replace(self, **kw)

    @property
    def n(self) -> int:
        return self.x.shape[0]


@dataclass(frozen=True)
class BodyConfig:
    """Static per-body configuration (reference
    src/nbody/planetary_system.cpp:161-258 ``init_planet``)."""
    name: str = "body"
    mass: float = 1.0
    semi_major_axis: float = 0.0
    eccentricity: float = 0.0
    argument_of_pericenter: float = 0.0
    true_anomaly: float = 0.0
    radius: float = 0.009304813          # in l0 (solar radius in au)
    temperature: float = 0.0             # code units
    irradiate: bool = False
    irradiation_rampup: float = 0.0
    ramp_up_time: float = 0.0            # in orbital periods
    cubic_smoothing_factor: float = 0.0
    accretion_efficiency: float = 0.0
    accretion_type: str = "none"         # none | kley | sinkhole | viscous


def parse_bodies(cfg: Config, units: u.Units) -> list[BodyConfig]:
    bodies = []
    for i, sub in enumerate(cfg.get_subconfigs("nbody")):
        if not (sub.contains("semi-major axis") and sub.contains("mass")):
            raise ValueError(
                "every nbody entry needs 'semi-major axis' and 'mass'")
        temperature = sub.get("temperature", 0.0, dim=u.DIM_TEMPERATURE,
                              type=float)
        acc_eff = sub.get("accretion efficiency", 0.0, type=float)
        acc_type = sub.get_lowercase("accretion method", "kley")
        if acc_type in ("no", "none") or acc_eff <= 0.0:
            acc_type = "none"
        bodies.append(BodyConfig(
            name=sub.get("name", f"planet{i}", type=str),
            mass=sub.get("mass", 1.0, dim=u.DIM_MASS, type=float),
            semi_major_axis=sub.get("semi-major axis", 0.0,
                                    dim=u.DIM_LENGTH, type=float),
            eccentricity=sub.get("eccentricity", 0.0, type=float),
            argument_of_pericenter=sub.get("argument of pericenter", 0.0,
                                           type=float),
            true_anomaly=sub.get("trueanomaly", 0.0, type=float),
            radius=sub.get("radius", 0.009304813, dim=u.DIM_LENGTH,
                           type=float),
            temperature=temperature,
            irradiate=temperature > 0.0,
            irradiation_rampup=sub.get("irradiation ramp-up time", 0.0,
                                       dim=u.DIM_TIME, type=float),
            ramp_up_time=sub.get("ramp-up time", 0.0, type=float),
            cubic_smoothing_factor=sub.get("cubic smoothing factor", 0.0,
                                           type=float),
            accretion_efficiency=acc_eff,
            accretion_type=acc_type,
        ))
    if not bodies:
        bodies.append(BodyConfig(name="DefaultStar", mass=1.0))
    return bodies


def hydroframe_center_count(cfg: Config, n_bodies: int) -> int:
    """reference src/Interpret.cpp:326-346."""
    mode = cfg.get_lowercase("HydroFrameCenter", "primary")[:1]
    n = {"p": 1, "b": 2, "t": 3, "q": 4, "a": 0}.get(mode)
    if n is None:
        raise ValueError(f"invalid HydroFrameCenter {mode!r}")
    if n == 0 or n > n_bodies:
        n = n_bodies
    return n


# ---------------------------------------------------------------------------
# initialization (host-side, float64 numpy)
# ---------------------------------------------------------------------------

def _kepler_cartesian(G, com_mass, mass, a, e, omega, nu):
    """Position/velocity on a Kepler orbit around the running center of
    mass (reference src/nbody/planetary_system.cpp:539-575)."""
    r = a * (1 - e * e) / (1 + e * math.cos(nu))
    x = r * math.cos(omega + nu)
    y = r * math.sin(omega + nu)
    v = math.sqrt(G * (com_mass + mass) / (a * (1 - e * e))) if a > 0 else 0.0
    vx = v * (-math.cos(omega) * math.sin(nu)
              - math.sin(omega) * (e + math.cos(nu)))
    vy = v * (-math.sin(omega) * math.sin(nu)
              + math.cos(omega) * (e + math.cos(nu)))
    return x, y, vx, vy


def initialize_system(bodies: list[BodyConfig], G: float,
                      n_hydroframe: int) -> dict[str, np.ndarray]:
    """Jacobi-coordinate initialization + hydro-frame centering
    (reference src/nbody/planetary_system.cpp:483-575, :750-767).
    Returns float64 numpy arrays {x, y, vx, vy, mass}."""
    n = len(bodies)
    x = np.zeros(n)
    y = np.zeros(n)
    vx = np.zeros(n)
    vy = np.zeros(n)
    m = np.array([b.mass for b in bodies], dtype=np.float64)

    for k, b in enumerate(bodies):
        if k == 0:
            continue  # first body starts at origin
        omega = b.argument_of_pericenter
        if k == 1 and n >= 2 and b.mass > bodies[0].mass:
            # heavier secondary: phase-shift so the more massive body sits
            # nearer the origin (reference :495-502)
            omega = omega + math.pi
        com_m = m[:k].sum()
        com_x = (m[:k] * x[:k]).sum() / com_m
        com_y = (m[:k] * y[:k]).sum() / com_m
        px, py, pvx, pvy = _kepler_cartesian(G, com_m, b.mass,
                                             b.semi_major_axis,
                                             b.eccentricity, omega,
                                             b.true_anomaly)
        if k == 1:
            # binary: split the separation about the two-body barycenter
            # (reference :483-533 initialize_planet_jacobi_adjust_first_two
            # for the 2nd body of a fresh system)
            k1 = b.mass / (m[0] + b.mass)
            k2 = m[0] / (m[0] + b.mass)
            x[0], y[0], vx[0], vy[0] = -k1 * px, -k1 * py, -k1 * pvx, -k1 * pvy
            x[1], y[1], vx[1], vy[1] = k2 * px, k2 * py, k2 * pvx, k2 * pvy
        else:
            x[k] = com_x + px
            y[k] = com_y + py
            vx[k] = pvx
            vy[k] = pvy

    # move to the hydro frame center (COM of the first n_hydroframe bodies)
    mc = m[:n_hydroframe].sum()
    cx = (m[:n_hydroframe] * x[:n_hydroframe]).sum() / mc
    cy = (m[:n_hydroframe] * y[:n_hydroframe]).sum() / mc
    cvx = (m[:n_hydroframe] * vx[:n_hydroframe]).sum() / mc
    cvy = (m[:n_hydroframe] * vy[:n_hydroframe]).sum() / mc
    return {"x": x - cx, "y": y - cy, "vx": vx - cvx, "vy": vy - cvy,
            "mass": m}


def make_state(init: dict[str, np.ndarray], dtype) -> NBodyState:
    return NBodyState(**{k: jnp.asarray(v, dtype) for k, v in init.items()})


# ---------------------------------------------------------------------------
# device-side dynamics
# ---------------------------------------------------------------------------

def mutual_accelerations(x, y, mass, G):
    """Pairwise gravitational accelerations, O(N^2), N tiny."""
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    d2 = dx * dx + dy * dy
    eye = jnp.eye(x.shape[0], dtype=x.dtype)
    inv_d3 = jnp.where(d2 > 0.0, (d2 + eye) ** -1.5, 0.0)
    ax = G * jnp.sum(mass[None, :] * dx * inv_d3, axis=1)
    ay = G * jnp.sum(mass[None, :] * dy * inv_d3, axis=1)
    return ax, ay


def integrate(state: NBodyState, G: float, dt, n_substeps: int = 16,
              method: str = "ias15") -> NBodyState:
    """Advance the bodies under mutual gravity by exactly dt.

    Default is the adaptive 15th-order Gauss-Radau integrator (IAS15,
    nbody/ias15.py) — the same integrator class the reference uses via
    REBOUND (src/nbody/planetary_system.cpp:878 with exact_finish_time).
    ``method='rk4'`` selects the fixed-substep RK4 used in round 1;
    ``method='rk5'`` the legacy Cash-Karp RK5 analog of
    src/RungeKutta.cpp:12-92 (the reference version is dead code — never
    called, and its final combination line even drops the ``q0 + dt*``
    terms — so this is the *corrected* Cash-Karp tableau it intended)."""
    if method not in ("ias15", "rk4", "rk5"):
        raise ValueError(f"unknown NbodyIntegrator '{method}' "
                         "(expected ias15, rk4 or rk5)")
    if state.n == 1:
        return state
    if method == "ias15":
        from .ias15 import integrate_ias15
        # ALWAYS integrate in float64 (requires jax x64, enabled at
        # HydroStep construction): IAS15's adaptive controller compares
        # the b6 series term against epsilon=1e-9, far below the float32
        # noise floor (~1e-7) — in f32 the trial step collapses to the
        # 1e-12*dt floor and every call burns the full 4096-substep
        # backstop while barely moving the bodies.  The body arrays are
        # tiny, so the f64 upcast costs nothing.
        f64 = jnp.float64
        x, y, vx, vy = integrate_ias15(
            state.x.astype(f64), state.y.astype(f64),
            state.vx.astype(f64), state.vy.astype(f64),
            state.mass.astype(f64), G, dt)
        d = state.x.dtype
        return state.replace(x=x.astype(d), y=y.astype(d),
                             vx=vx.astype(d), vy=vy.astype(d))
    h = dt / n_substeps
    m = state.mass

    def deriv(q):
        x, y, vx, vy = q
        ax, ay = mutual_accelerations(x, y, m, G)
        return (vx, vy, ax, ay)

    def rk4(q, _):
        k1 = deriv(q)
        k2 = deriv(tuple(a + 0.5 * h * b for a, b in zip(q, k1)))
        k3 = deriv(tuple(a + 0.5 * h * b for a, b in zip(q, k2)))
        k4 = deriv(tuple(a + h * b for a, b in zip(q, k3)))
        q = tuple(a + h / 6.0 * (b1 + 2 * b2 + 2 * b3 + b4)
                  for a, b1, b2, b3, b4 in zip(q, k1, k2, k3, k4))
        return q, None

    def rk5(q, _):
        # Cash-Karp stage coefficients (reference src/RungeKutta.cpp:73-86)
        # and 5th-order weights (:88-91, corrected to y0 + h*sum(b_i k_i)).
        a_tab = (
            (0.2,),
            (0.075, 0.225),
            (0.3, -0.9, 1.2),
            (-11.0 / 54.0, 2.5, -70.0 / 27.0, 35.0 / 27.0),
            (1631.0 / 55296.0, 175.0 / 512.0, 575.0 / 13824.0,
             44275.0 / 110592.0, 253.0 / 4096.0),
        )
        b_tab = (37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0,
                 512.0 / 1771.0)
        ks = [deriv(q)]
        for row in a_tab:
            trial = tuple(a + h * sum(c * k[i] for c, k in zip(row, ks))
                          for i, a in enumerate(q))
            ks.append(deriv(trial))
        q = tuple(a + h * sum(b * k[i] for b, k in zip(b_tab, ks))
                  for i, a in enumerate(q))
        return q, None

    body = {"rk4": rk4, "rk5": rk5}[method]
    q0 = (state.x, state.y, state.vx, state.vy)
    q, _ = jax.lax.scan(body, q0, None, length=n_substeps)
    return state.replace(x=q[0], y=q[1], vx=q[2], vy=q[3])


def move_to_hydro_frame_center(state: NBodyState, n_center: int) -> NBodyState:
    """Subtract the COM (position & velocity) of the first n_center bodies
    (reference src/nbody/planetary_system.cpp:750-767)."""
    m = state.mass[:n_center]
    mc = jnp.sum(m)
    cx = jnp.sum(m * state.x[:n_center]) / mc
    cy = jnp.sum(m * state.y[:n_center]) / mc
    cvx = jnp.sum(m * state.vx[:n_center]) / mc
    cvy = jnp.sum(m * state.vy[:n_center]) / mc
    return state.replace(x=state.x - cx, y=state.y - cy,
                         vx=state.vx - cvx, vy=state.vy - cvy)


def rotate(state: NBodyState, angle) -> NBodyState:
    """Rotate all bodies by -angle (corotating frame bookkeeping,
    reference src/nbody/planetary_system.cpp:412-437)."""
    c = accurate_cos(angle)
    s = jnp.sin(angle)
    return state.replace(
        x=state.x * c + state.y * s, y=-state.x * s + state.y * c,
        vx=state.vx * c + state.vy * s, vy=-state.vx * s + state.vy * c)


def kick(state: NBodyState, ax, ay, dt) -> NBodyState:
    """Velocity kick (indirect term / disk feedback application,
    reference src/nbody/planetary_system.cpp:730-744)."""
    return state.replace(vx=state.vx + dt * ax, vy=state.vy + dt * ay)


def rampup_masses(state: NBodyState, rampup_periods, orbital_periods,
                  current_time):
    """Mass ramping for the gravity felt by the gas
    (reference src/nbody/planet.cpp:166-179)."""
    t_ramp = rampup_periods * orbital_periods
    active = t_ramp > 0.0
    frac = jnp.where(active & (current_time < t_ramp),
                     1.0 - jnp.cos(current_time * (jnp.pi / 2.0)
                                   / jnp.where(t_ramp > 0, t_ramp, 1.0)) ** 2,
                     1.0)
    return state.mass * frac


def dist_to_primary(state: NBodyState):
    dx = state.x - state.x[0]
    dy = state.y - state.y[0]
    return jnp.sqrt(dx * dx + dy * dy)


def dimensionless_roche_radius(state: NBodyState, n_iter: int = 12):
    """L1 distance fraction x for each body orbiting the primary
    (reference src/Theo.cpp:251-277 init_l1, Newton iteration)."""
    mc = state.mass[0]
    mo = state.mass
    q = mc / (mc + mo)
    x = jnp.cbrt(mo / jnp.maximum(3.0 * mc, 1e-300))
    x = jnp.clip(x, 1e-8, 0.9)

    def newton(x, _):
        f = q / (1.0 - x) ** 2 - (1.0 - q) / x ** 2 - q + x
        df = 2.0 * q / (1.0 - x) ** 3 + 2.0 * (1.0 - q) / x ** 3 + 1.0
        return x - f / df, None

    x, _ = jax.lax.scan(newton, x, None, length=n_iter)
    # primary itself has no Roche lobe about itself
    return x.at[0].set(0.0)


def orbital_elements(x, y, vx, vy, m_central, m_body, G):
    """Keplerian elements from state vectors
    (reference src/nbody/planet.cpp:488-570). numpy, host-side."""
    m = m_central + m_body
    h = x * vy - y * vx
    d = np.sqrt(x * x + y * y)
    if d == 0.0 or h == 0.0:
        return dict(a=0.0, e=0.0, period=0.0, mean_anomaly=0.0,
                    true_anomaly=0.0, eccentric_anomaly=0.0,
                    pericenter_angle=0.0)
    Ax = x * vy * vy - y * vx * vy - G * m * x / d
    Ay = y * vx * vx - x * vx * vy - G * m * y / d
    e = math.sqrt(Ax * Ax + Ay * Ay) / (G * m)
    a = h * h / (G * m) / (1.0 - e * e)
    if e >= 1.0 or a <= 0.0:
        return dict(a=0.0, e=0.0, period=0.0, mean_anomaly=0.0,
                    true_anomaly=0.0, eccentric_anomaly=0.0,
                    pericenter_angle=0.0)
    period = 2.0 * math.pi * math.sqrt(a ** 3 / (G * m))
    if e != 0.0:
        E = math.acos(np.clip((1.0 - d / a) / e, -1.0, 1.0))
    else:
        E = 0.0
    if (x * y * (vy * vy - vx * vx) + vx * vy * (x * x - y * y)) < 0:
        E = -E
    M = E - e * math.sin(E)
    if e != 0.0:
        V = math.acos(np.clip((a * (1.0 - e * e) / d - 1.0) / e, -1.0, 1.0))
    else:
        V = 0.0
    if x * vx + y * vy < 0:
        V = -V
    peri = math.atan2(Ay, Ax) if e != 0.0 else 0.0
    return dict(a=float(a), e=float(e), period=float(period),
                mean_anomaly=float(M), true_anomaly=float(V),
                eccentric_anomaly=float(E), pericenter_angle=float(peri))
