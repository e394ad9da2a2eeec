"""PVTE equation of state: variable effective adiabatic index from
hydrogen ionization/dissociation (Vaidya et al. 2015; D'Angelo et al. 2013).

Re-derivation of reference src/pvte_law.cpp, built for XLA: instead of the
reference's 1000x1000 (rho, e) lookup tables (GSL + per-cell bilinear
gathers), the temperature is solved per cell by a fixed-iteration
bisection directly in-graph — every ingredient (ionization fraction x,
dissociation fraction y, the molecular-hydrogen zeta function, the energy
contributions) is closed-form elementwise math, so the whole EoS is one
fused vectorized pass with only a tiny 1-D interp for the H2 internal
energy (the 5000-entry zeta table, built host-side once).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

# cgs constants (reference src/constants.cpp:39-45)
CGS_M_E = 9.1093826e-28
CGS_EV = 1.602176463158e-12
CGS_M_H = 1.6733e-24
CGS_KB = 1.380649e-16
CGS_H = 6.62607015e-27
CGS_HBAR = CGS_H / (2.0 * math.pi)
CGS_MP = 1.67262192369e-24

# zeta-table parameters (reference src/pvte_law.cpp:44-52)
THETA_V = 6140.0
THETA_R = 85.5
N_ZETA = 5000
T0_ZETA = 1.0
TMAX_ZETA = 1.0e12
ORTHO_PARA_MODE = 1


def _funcdum_exact_np(T: np.ndarray) -> np.ndarray:
    """Exact funcdum(T) for the H2 internal energy (reference :305-369,
    after PLUTO's zeta_tables.c / D'Angelo et al. 2013). Host-side
    numpy, vectorized, chunked to bound the (T, 10001-level) broadcast."""
    alpha, beta, gamma = 1.0, 0.0, 1.0   # ORTHO_PARA_MODE == 1
    T = np.asarray(T, np.float64)
    b1 = 2.0 * THETA_R
    i = np.arange(0, 10001)
    a = 2 * i + 1.0
    b = i * (i + 1.0) * THETA_R
    even = (i % 2) == 0
    zetaP = np.zeros_like(T)
    dzetaP = np.zeros_like(T)
    sum1 = np.zeros_like(T)
    sum2 = np.zeros_like(T)
    chunk = 512
    for lo in range(0, T.size, chunk):
        Ts = T[lo:lo + chunk, None]
        with np.errstate(over="ignore", under="ignore"):
            scrh_e = np.where(even, a * np.exp(-b / Ts), 0.0)
            db = b - b1
            scrh_o = np.where(~even, a * np.exp(-db / Ts), 0.0)
        zetaP[lo:lo + chunk] = scrh_e.sum(1)
        dzetaP[lo:lo + chunk] = (scrh_e * b).sum(1)
        sum1[lo:lo + chunk] = scrh_o.sum(1)
        sum2[lo:lo + chunk] = (scrh_o * db).sum(1)
    inv_T2 = 1.0 / T ** 2
    dzetaP *= inv_T2
    zetaO = np.exp(-b1 / T) * sum1
    dzetaO = np.exp(-b1 / T) * (b1 * sum1 + sum2) * inv_T2
    dzO_zO_m = sum2 / sum1 * inv_T2
    scrh = zetaO * np.exp(2.0 * THETA_R / T)
    zetaR = zetaP ** alpha * scrh ** beta + 3.0 * gamma * zetaO
    dzetaR = (zetaR - 3.0 * gamma * zetaO) * (alpha * dzetaP / zetaP
                                              + beta * dzO_zO_m) \
        + 3.0 * gamma * dzetaO
    dum1 = THETA_V / T
    dum2 = dum1 * np.exp(-dum1) / (1.0 - np.exp(-dum1))
    dum3 = (T / zetaR) * dzetaR
    return 1.5 + dum2 + dum3


@functools.lru_cache(maxsize=1)
def zeta_table() -> tuple[np.ndarray, np.ndarray]:
    """The reference's 5000-entry funcdum table on the uniform ln T grid
    (reference :305-369). Used to BUILD the reference-exact 1000x1000
    lookup tables; the runtime bisection path uses the gather-free
    piecewise-Chebyshev fit instead (funcdum_poly_tabs)."""
    dy = math.log(TMAX_ZETA / T0_ZETA) / N_ZETA
    T = T0_ZETA * np.exp(np.arange(N_ZETA) * dy)     # (Nz,)
    return np.log(T), _funcdum_exact_np(T)


# piecewise-Chebyshev fit of funcdum(ln T): it replaces the reference's
# per-cell table interpolation (:77-101), a per-cell gather, with pure
# arithmetic — a (cells, K) one-hot matmul selects the segment
# coefficients, then a Horner pass — and its
# max relative error (8.4e-8) is ~60x BELOW the 5000-entry table's own
# linear-interpolation error (5.4e-6 vs the exact function).
FUNCDUM_SEGMENTS = 32
FUNCDUM_DEGREE = 10


@functools.lru_cache(maxsize=1)
def funcdum_poly() -> tuple[float, float, np.ndarray]:
    """(lnT_lo, seg_width, coeffs (K, deg+1) monomial-in-x) with
    x = 2 (lnT - lo - s w)/w - 1 per segment, fitted at Chebyshev nodes
    of the exact funcdum over the table's ln T range."""
    K, deg = FUNCDUM_SEGMENTS, FUNCDUM_DEGREE
    dy = math.log(TMAX_ZETA / T0_ZETA) / N_ZETA
    lo = math.log(T0_ZETA)
    hi = lo + (N_ZETA - 2) * dy       # func_dum clips at index N_ZETA-2
    w = (hi - lo) / K
    nodes = np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1))
    coeffs = np.zeros((K, deg + 1))
    for s in range(K):
        a = lo + s * w
        y = 0.5 * (nodes + 1.0) * w + a
        f = _funcdum_exact_np(np.exp(y))
        c_cheb = np.polynomial.chebyshev.chebfit(nodes, f, deg)
        coeffs[s] = np.polynomial.chebyshev.cheb2poly(c_cheb)
    return lo, w, coeffs


def func_dum(tabs, T):
    """Gather-free funcdum(T): segment one-hot matmul + Horner.
    ``tabs`` is the device-side (lo, w, coeffs) triple from
    ``PVTE``/``funcdum_poly``; replaces the reference's per-cell 1-D
    table interpolation (:77-101) with elementwise math."""
    return func_dum_ln(tabs, jnp.log(T))


def func_dum_ln(tabs, lnT):
    """func_dum with ln T already in hand (the lean temperature solver
    carries t = ln T as its iteration variable — saves a log per eval)."""
    lo, w, coeffs = tabs
    K, D = coeffs.shape
    y = jnp.clip(lnT, lo, lo + K * w)
    s = jnp.clip(((y - lo) / w).astype(jnp.int32), 0, K - 1)
    x = 2.0 * (y - lo - s.astype(y.dtype) * w) / w - 1.0
    onehot = (s[..., None] == jnp.arange(K, dtype=jnp.int32)) \
        .astype(y.dtype)                                   # (..., K)
    c = onehot @ coeffs                                    # (..., D)
    out = c[..., D - 1]
    for d in range(D - 2, -1, -1):
        out = out * x + c[..., d]
    return out


def ionization_fraction(rho, T, x_mf):
    """Saha H ionization fraction (reference :443-468, Vaidya+15 eq. 24).

    The reference evaluates the quadratic root as
    0.5 (-A + sqrt(A^2 + 4A)), which catastrophically cancels for large
    A (the mostly-ionized zone A in [1e5, 1e8] loses ~A/2 ulps — in f32
    that is O(0.05) ABSOLUTE error in x and a ~3x-wrong temperature on
    the ionization cliff).  The conjugate form 2 / (1 + sqrt(1 + 4/A))
    is algebraically identical and stable for every A (including
    A -> 0+ and the A=0 exp-underflow limit, where 4/A = inf gives
    x = 0 exactly); in f64 the two differ below 1e-12, far under the
    PVTE golden gates."""
    rhs_const = CGS_M_H / x_mf * (CGS_M_E * CGS_KB
                                  / (2 * math.pi * CGS_HBAR ** 2)) ** 1.5
    Ax = rhs_const * T ** 1.5 * jnp.exp(-13.60 * CGS_EV / (CGS_KB * T)) / rho
    x = 2.0 / (1.0 + jnp.sqrt(1.0 + 4.0 / Ax))
    return jnp.where(Ax < 1e8, x, 1.0)


def dissociation_fraction(rho, T, x_mf):
    """H2 dissociation fraction (reference :470-495, Vaidya+15 eq. 25);
    stable conjugate root form, see ionization_fraction."""
    rhs_const = CGS_M_H / (2.0 * x_mf) * (CGS_M_H * CGS_KB
                                          / (4 * math.pi * CGS_HBAR ** 2)) ** 1.5
    Ay = rhs_const * T ** 1.5 * jnp.exp(-4.48 * CGS_EV / (CGS_KB * T)) / rho
    y = 2.0 / (1.0 + jnp.sqrt(1.0 + 4.0 / Ay))
    return jnp.where(Ay < 1e8, y, 1.0)


def mean_molecular_weight(x, y, x_mf):
    """reference :65-74."""
    return 4.0 / (2.0 * x_mf * (1.0 + y + 2.0 * y * x) + 1.0 - x_mf)


def gas_energy_eps(x, y, T, x_mf, tabs):
    """Dimensionless internal-energy contributions (reference :103-131,
    Vaidya+15 table 1): e_specific = eps * R_gas * T / ... (via mu)."""
    eps_hi = 1.5 * x_mf * (1.0 + x) * y
    eps_he = 0.375 * (1.0 - x_mf)
    eps_hh = 4.48 * CGS_EV * x_mf * y / (2.0 * CGS_KB * T)
    eps_hii = 13.60 * CGS_EV * x_mf * x * y / (CGS_KB * T)
    eps_h2 = 0.5 * x_mf * (1.0 - y) * func_dum(tabs, T)
    return eps_h2 + eps_hii + eps_hh + eps_he + eps_hi


def _gamma_mu_at(rho, T, x_mf, tabs):
    x = ionization_fraction(rho, T, x_mf)
    y = dissociation_fraction(rho, T, x_mf)
    mu = mean_molecular_weight(x, y, x_mf)
    eps = gas_energy_eps(x, y, T, x_mf, tabs)
    gamma_eff = 1.0 + 1.0 / (mu * eps)
    return x, y, mu, eps, gamma_eff


def _eps_lean(rho, t, x_mf, tabs):
    """eps(rho, T) with t = ln T carried by the solver: three exp calls
    total (exp(t) and the two Saha Boltzmann factors; T^1.5 is T*sqrt(T),
    funcdum reuses t) — the solver's per-iteration cost is dominated by
    transcendentals, so every exp/log shaved counts."""
    T = jnp.exp(t)
    T32 = T * jnp.sqrt(T)
    cx = CGS_M_H / x_mf * (CGS_M_E * CGS_KB
                           / (2 * math.pi * CGS_HBAR ** 2)) ** 1.5
    cy = CGS_M_H / (2.0 * x_mf) * (CGS_M_H * CGS_KB
                                   / (4 * math.pi * CGS_HBAR ** 2)) ** 1.5
    Ax = cx * T32 * jnp.exp(-13.60 * CGS_EV / (CGS_KB * T)) / rho
    Ay = cy * T32 * jnp.exp(-4.48 * CGS_EV / (CGS_KB * T)) / rho
    x = jnp.where(Ax < 1e8, 2.0 / (1.0 + jnp.sqrt(1.0 + 4.0 / Ax)), 1.0)
    y = jnp.where(Ay < 1e8, 2.0 / (1.0 + jnp.sqrt(1.0 + 4.0 / Ay)), 1.0)
    eps_hi = 1.5 * x_mf * (1.0 + x) * y
    eps_he = 0.375 * (1.0 - x_mf)
    eps_hh = 4.48 * CGS_EV * x_mf * y / (2.0 * CGS_KB * T)
    eps_hii = 13.60 * CGS_EV * x_mf * x * y / (CGS_KB * T)
    eps_h2 = 0.5 * x_mf * (1.0 - y) * func_dum_ln(tabs, t)
    return T, eps_h2 + eps_hii + eps_hh + eps_he + eps_hi


def _temperature_hybrid(e_specific_cgs, rho_cgs, x_mf, tabs,
                        n_bisect: int, n_illinois: int):
    """Bracketing hybrid solve of e = R T eps(T, rho) in t = ln T on
    [1, 1e7] K: ``n_bisect`` sign-only halvings localize past the
    ionization/dissociation cliffs (where the residual is near-vertical
    and secant methods stall), then ``n_illinois`` Illinois
    (modified-regula-falsi) steps on the log residual
    g(t) = t + ln eps - ln(e/R) polish superlinearly.  The root is
    unique — T eps(T) is strictly increasing (thermodynamic stability) —
    so bisection and Illinois converge to the same temperature the
    reference's Brent finds.  Sweep-validated vs the 60-iteration f64
    bisection over the full table domain (rho 1e-23..1, e 1e8..1e15):
    13+4 reaches ~1e-5 max relative in f32 (p99 ~2e-6; the old
    26-iteration f32 bisection it replaced measured 3.2e-6 max)."""
    lo = jnp.zeros_like(rho_cgs)                      # ln T = 0
    hi = jnp.full_like(rho_cgs, 7.0 * math.log(10.0))
    e_over_R = e_specific_cgs * (CGS_MP / CGS_KB)
    # one underflowed cell (e <= 0) would make ln_target = -inf, turning
    # the secant into inf - inf = NaN and poisoning the grid; clamp to
    # the dtype's tiny so such cells degrade to the 1 K bracket edge,
    # matching the bisection-only solver's behavior
    e_over_R = jnp.maximum(e_over_R, jnp.finfo(e_over_R.dtype).tiny)
    ln_target = jnp.log(e_over_R)

    def bis_body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        T, eps = _eps_lean(rho_cgs, mid, x_mf, tabs)
        # root below mid  <=>  T eps > e/R  (sign only: no log needed)
        take_low = T * eps > e_over_R
        return (jnp.where(take_low, lo, mid),
                jnp.where(take_low, mid, hi))

    lo, hi = jax.lax.fori_loop(0, n_bisect, bis_body, (lo, hi))

    def g(t):
        T, eps = _eps_lean(rho_cgs, t, x_mf, tabs)
        return t + jnp.log(eps) - ln_target

    glo, ghi = g(lo), g(hi)

    def secant(lo, glo, hi, ghi):
        """Regula-falsi point, midpoint when the bracket is flat in this
        dtype (g(lo) == g(hi) rounds the secant to 0/0)."""
        d = ghi - glo
        mid = 0.5 * (lo + hi)
        return jnp.where(d != 0.0, (lo * ghi - hi * glo)
                         / jnp.where(d != 0.0, d, 1.0), mid)

    def ill_body(_, carry):
        lo, glo, hi, ghi = carry
        w = hi - lo
        s = jnp.clip(secant(lo, glo, hi, ghi), lo + 1e-4 * w, hi - 1e-4 * w)
        gs = g(s)
        low = gs < 0.0
        return (jnp.where(low, s, lo), jnp.where(low, gs, 0.5 * glo),
                jnp.where(low, hi, s), jnp.where(low, 0.5 * ghi, gs))

    lo, glo, hi, ghi = jax.lax.fori_loop(0, n_illinois, ill_body,
                                         (lo, glo, hi, ghi))
    s = jnp.clip(secant(lo, glo, hi, ghi), lo, hi)
    return jnp.exp(s)


def temperature_from_energy(e_specific_cgs, rho_cgs, x_mf, tabs,
                            n_iter: int | None = None):
    """Invert e(T, rho) = e_specific on [1, 1e7] K (replaces the
    reference's Brent + 2-D lookup tables, :243-395).

    float32 (the production dtype) takes the lean bisection+Illinois
    hybrid (19 cheap evaluations, max rel T error ~1e-5 worst-case /
    ~2e-6 at p99 — at the f32 state's own noise floor).  float64 keeps
    the original 48-halving
    bisection: it is the solver every reference-binary golden was
    validated against, and CPU f64 throughput is not a constraint."""
    if n_iter is None:
        if jnp.result_type(e_specific_cgs) == jnp.float32:
            return _temperature_hybrid(e_specific_cgs, rho_cgs, x_mf, tabs,
                                       n_bisect=13, n_illinois=4)
        n_iter = 48
    R = CGS_KB / CGS_MP

    def resid(T):
        _x, _y, mu, eps, gam = _gamma_mu_at(rho_cgs, T, x_mf, tabs)
        return mu * e_specific_cgs * (gam - 1.0) / R - T

    lo = jnp.zeros_like(rho_cgs)           # log10 T = 0
    hi = jnp.full_like(rho_cgs, 7.0)       # log10 T = 7

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        f = resid(10.0 ** mid)
        # resid is decreasing in T around the root (T grows faster than rhs)
        take_low = f < 0.0
        hi = jnp.where(take_low, mid, hi)
        lo = jnp.where(take_low, lo, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    return 10.0 ** (0.5 * (lo + hi))


# ---------------------------------------------------------------------------
# Fast fully-elementwise PVTE path (float32 production).
#
# The one-hot funcdum matmul above materializes a (cells, 32) selector per
# evaluation and the fori_loop solver round-trips its bracket carries
# through device memory every iteration.  The path below removes every
# non-elementwise op so XLA fuses the
# whole refresh into a handful of kernels:
#   * funcdum = 1.5 + dum2 + dum3 with dum2 ANALYTIC (one expm1; the
#     vibrational term in reference src/pvte_law.cpp:305-369 is closed
#     form) and dum3 (the rotational part) as a piecewise Chebyshev fit
#     with STATIC scalar coefficients evaluated by Clenshaw — no gather,
#     no one-hot, max abs fit error 5.1e-8 (better than the one-hot fit's
#     8.4e-8 relative).
#   * the bisection+Illinois temperature solve fully unrolled.
#   * gamma1 analytic (exact derivatives of the Saha fractions and the
#     fit) instead of the 5-point finite difference — in f32 the FD with
#     epsn = 1e-4 sits at the rounding floor; the analytic form is both
#     cheaper (1 evaluation instead of 5) and more accurate.

_FD_ELEM_BOUNDS = (8.0, 40.0, 130.0, 500.0, 2000.0)   # K, feature window
_FD_ELEM_DEG = 14
_FD_TAIL_DEG = 6


def _dum2_np(T):
    """Analytic vibrational contribution (reference :357-360)."""
    d1 = THETA_V / np.asarray(T, np.float64)
    return d1 * np.exp(-d1) / (1.0 - np.exp(-d1))


@functools.lru_cache(maxsize=1)
def funcdum_elem_tables():
    """Chebyshev-basis coefficients (python-float tuples — static trace
    constants) for the elementwise dum3 = funcdum - 1.5 - dum2:
      T < 8 K          : 0 (exact to 1.1e-7 — rotation frozen out)
      8 K .. 2000 K    : 4 Chebyshev segments of degree 14 in ln T
      T > 2000 K       : degree-6 Chebyshev in u = THETA_R/T (the
                         classical-rotor asymptote is polynomial in 1/T;
                         fit error 4e-15)
    Each entry also carries the d/dlnT derivative coefficients."""
    import numpy.polynomial.chebyshev as cheb
    n = 512
    xn = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    segs = []
    b = _FD_ELEM_BOUNDS
    for i in range(len(b) - 1):
        lo, hi = math.log(b[i]), math.log(b[i + 1])
        ln = 0.5 * (xn + 1.0) * (hi - lo) + lo
        T = np.exp(ln)
        d3 = _funcdum_exact_np(T) - 1.5 - _dum2_np(T)
        c = cheb.chebfit(xn, d3, _FD_ELEM_DEG)
        dc = cheb.chebder(c) * (2.0 / (hi - lo))          # d/dlnT
        segs.append((lo, hi, tuple(c.tolist()), tuple(dc.tolist())))
    # tail: u = THETA_R/T on T in [2000 K, inf), x = 2 u/umax - 1
    umax = THETA_R / b[-1]
    u = np.maximum(0.5 * (xn + 1.0) * umax, 1e-12)
    T = THETA_R / u
    d3 = _funcdum_exact_np(T) - 1.5 - _dum2_np(T)
    ct = cheb.chebfit(xn, d3, _FD_TAIL_DEG)
    dct = cheb.chebder(ct) * (2.0 / umax)                 # d/du
    tail = (math.log(b[-1]), umax, tuple(ct.tolist()), tuple(dct.tolist()))
    return tuple(segs), tail


def _clenshaw(x, c):
    """Chebyshev-basis Clenshaw with static scalar coefficients."""
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    two_x = 2.0 * x
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = c[k] + two_x * b1 - b2, b1
    return c[0] + x * b1 - b2


def _funcdum_fast(t, invT, want_deriv=False):
    """funcdum(ln T) and optionally d funcdum/d lnT, pure elementwise."""
    segs, (t_tail, umax, ct, dct) = funcdum_elem_tables()
    d1 = THETA_V * invT
    m = jnp.expm1(-d1)                     # exp(-d1) - 1, in [-1, 0)
    dum2 = -d1 * (1.0 + m) / m             # d1 e^-d1 / (1 - e^-d1)
    val = jnp.zeros_like(t)
    der = jnp.zeros_like(t) if want_deriv else None
    for lo, hi, c, dc in segs:
        x = jnp.clip((t - lo) * (2.0 / (hi - lo)) - 1.0, -1.0, 1.0)
        sel = (t >= lo) & (t < hi)
        val = jnp.where(sel, _clenshaw(x, c), val)
        if want_deriv:
            der = jnp.where(sel, _clenshaw(x, dc), der)
    u = THETA_R * invT
    xt = jnp.clip(2.0 * u / umax - 1.0, -1.0, 1.0)
    sel = t >= t_tail
    val = jnp.where(sel, _clenshaw(xt, ct), val)
    F = 1.5 + dum2 + val
    if not want_deriv:
        return F, None
    der = jnp.where(sel, _clenshaw(xt, dct) * (-u), der)
    dd2 = dum2 * (-d1 / m - 1.0)           # d dum2/d lnT
    return F, dd2 + der


_THX = 13.60 * CGS_EV / CGS_KB             # ionization theta [K]
_THY = 4.48 * CGS_EV / CGS_KB              # dissociation theta [K]
_CSAHA_X = CGS_M_H * (CGS_M_E * CGS_KB / (2 * math.pi * CGS_HBAR ** 2)) ** 1.5
_CSAHA_Y = CGS_M_H / 2.0 \
    * (CGS_M_H * CGS_KB / (4 * math.pi * CGS_HBAR ** 2)) ** 1.5


def _pvte_terms(rho, t, x_mf, want_deriv=False):
    """One elementwise PVTE evaluation at t = ln T.

    Returns (T, eps) and, with ``want_deriv``, also
    (deps/dlnT, mu, dmu/dlnT, dmu/dlnrho) — everything gamma_eff, the
    Newton/Illinois residual derivative, and the ANALYTIC gamma1
    (reference :151-213 semantics) need, from a single evaluation."""
    T = jnp.exp(t)
    invT = 1.0 / T
    T32 = T * jnp.sqrt(T)
    Ax = (_CSAHA_X / x_mf) * T32 * jnp.exp(-_THX * invT) / rho
    Ay = (_CSAHA_Y / x_mf) * T32 * jnp.exp(-_THY * invT) / rho
    sx = jnp.sqrt(1.0 + 4.0 / Ax)
    sy = jnp.sqrt(1.0 + 4.0 / Ay)
    satx = Ax >= 1e8
    saty = Ay >= 1e8
    x = jnp.where(satx, 1.0, 2.0 / (1.0 + sx))
    y = jnp.where(saty, 1.0, 2.0 / (1.0 + sy))
    F, Fp = _funcdum_fast(t, invT, want_deriv)
    chh = 4.48 * CGS_EV * x_mf / (2.0 * CGS_KB)
    chii = 13.60 * CGS_EV * x_mf / CGS_KB
    eps = (0.5 * x_mf * (1.0 - y) * F
           + chii * x * y * invT
           + chh * y * invT
           + 0.375 * (1.0 - x_mf)
           + 1.5 * x_mf * (1.0 + x) * y)
    if not want_deriv:
        return T, eps, None
    # d x/d lnA = x^2 u/(4 s) = (s-1)/(s (1+s)) with u = 4/A (conjugate
    # form: no 0*inf when A underflows to 0 and s = inf)
    dfx = jnp.where(satx | (Ax <= 0.0), 0.0, (sx - 1.0) / (sx * (1.0 + sx)))
    dfy = jnp.where(saty | (Ay <= 0.0), 0.0, (sy - 1.0) / (sy * (1.0 + sy)))
    dx_t = dfx * (1.5 + _THX * invT)       # d lnAx/d lnT = 1.5 + thx/T
    dy_t = dfy * (1.5 + _THY * invT)
    dx_r = -dfx                            # d lnAx/d lnrho = -1
    dy_r = -dfy
    deps_t = (1.5 * x_mf * ((1.0 + x) * dy_t + y * dx_t)
              + chh * (dy_t - y) * invT
              + chii * (x * dy_t + y * dx_t - x * y) * invT
              + 0.5 * x_mf * ((1.0 - y) * Fp - F * dy_t))
    mu_den = 2.0 * x_mf * (1.0 + y + 2.0 * y * x) + 1.0 - x_mf
    mu = 4.0 / mu_den
    dden_t = 2.0 * x_mf * ((1.0 + 2.0 * x) * dy_t + 2.0 * y * dx_t)
    dden_r = 2.0 * x_mf * ((1.0 + 2.0 * x) * dy_r + 2.0 * y * dx_r)
    dmu_t = -(mu * mu / 4.0) * dden_t
    dmu_r = -(mu * mu / 4.0) * dden_r
    return T, eps, (deps_t, mu, dmu_t, dmu_r)


_LNT_HI = 7.0 * math.log(10.0)             # solve bracket [1 K, 1e7 K]


def _temperature_fast(e_specific_cgs, rho_cgs, x_mf,
                      n_bisect: int = 13, n_illinois: int = 4):
    """The 13+4 bisection+Illinois hybrid of ``_temperature_hybrid`` with
    fully UNROLLED iterations and the elementwise funcdum — one XLA
    fusion instead of a fori_loop of one-hot matmuls.  Same bracket, same
    iteration structure, same worst-case accuracy (~1e-5 rel in f32);
    only the funcdum fit differs (5.1e-8 vs 8.4e-8 — both below the
    solver's own error).  Returns t = ln T."""
    lo = jnp.zeros_like(rho_cgs)
    hi = jnp.full_like(rho_cgs, _LNT_HI)
    e_over_R = e_specific_cgs * (CGS_MP / CGS_KB)
    e_over_R = jnp.maximum(e_over_R, jnp.finfo(e_over_R.dtype).tiny)
    ln_target = jnp.log(e_over_R)

    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        T, eps, _ = _pvte_terms(rho_cgs, mid, x_mf)
        take_low = T * eps > e_over_R
        lo = jnp.where(take_low, lo, mid)
        hi = jnp.where(take_low, mid, hi)

    def g(t):
        T, eps, _ = _pvte_terms(rho_cgs, t, x_mf)
        return t + jnp.log(eps) - ln_target

    def secant(lo, glo, hi, ghi):
        d = ghi - glo
        mid = 0.5 * (lo + hi)
        return jnp.where(d != 0.0, (lo * ghi - hi * glo)
                         / jnp.where(d != 0.0, d, 1.0), mid)

    glo, ghi = g(lo), g(hi)
    for _ in range(n_illinois):
        w = hi - lo
        s = jnp.clip(secant(lo, glo, hi, ghi), lo + 1e-4 * w, hi - 1e-4 * w)
        gs = g(s)
        low = gs < 0.0
        lo, glo, hi, ghi = (jnp.where(low, s, lo),
                            jnp.where(low, gs, 0.5 * glo),
                            jnp.where(low, hi, s),
                            jnp.where(low, 0.5 * ghi, gs))
    return jnp.clip(secant(lo, glo, hi, ghi), lo, hi)


def _temperature_warm(ln_target, rho_cgs, x_mf, t0, n_newton: int = 5):
    """Bracket-safeguarded Newton polish in t = ln T from a warm guess.

    ``t0`` comes from the previous refresh's (gamma_eff, mu) applied to
    the CURRENT energy — between substeps that is within ~1e-2 of the
    root, so ``n_newton`` damped-Newton iterations converge far below the
    cold hybrid's 1e-5 tolerance.  Each iteration updates a sign bracket
    and falls back to its midpoint when the Newton step leaves it, so a
    poor guess degrades gracefully instead of diverging.  g' = d ln(T
    eps)/d ln T = cv T/e > 0 (thermodynamic stability) keeps the Newton
    direction well-defined; the 0.05 floor guards fit-rounding only."""
    t = jnp.clip(t0, 0.0, _LNT_HI)
    lo = jnp.zeros_like(t)
    hi = jnp.full_like(t, _LNT_HI)
    for _ in range(n_newton):
        _T, eps, (deps_t, _mu, _dt, _dr) = _pvte_terms(
            rho_cgs, t, x_mf, want_deriv=True)
        gg = t + jnp.log(eps) - ln_target
        gp = jnp.maximum(1.0 + deps_t / eps, 0.05)
        lo = jnp.where(gg < 0.0, t, lo)
        hi = jnp.where(gg >= 0.0, t, hi)
        tn = t - gg / gp
        # non-strict bounds: at convergence the bracket edge IS the
        # iterate (hi = t, tn == t) — a strict test would bounce the
        # converged cell to the bracket midpoint
        t = jnp.where((tn >= lo) & (tn <= hi), tn, 0.5 * (lo + hi))
    return t


def gamma_mu_fast(rho_cgs, e_specific_cgs, x_mf, guess=None, n_newton=5):
    """(gamma_eff, mu, gamma1) via the fused elementwise path: the
    T-solve (unrolled cold hybrid, or the warm Newton polish when
    ``guess`` carries the previous refresh's (gamma_eff, mu)), then ONE
    derivative evaluation supplies gamma_eff and the analytic gamma1
    (reference :151-213: cv, chi_T, chi_rho from the same Saha/funcdum
    derivatives the finite difference probes)."""
    if guess is None:
        t = _temperature_fast(e_specific_cgs, rho_cgs, x_mf)
    else:
        e_over_R = e_specific_cgs * (CGS_MP / CGS_KB)
        e_over_R = jnp.maximum(e_over_R, jnp.finfo(e_over_R.dtype).tiny)
        ln_target = jnp.log(e_over_R)
        # T = e/R / eps with eps = 1/(mu (gamma_eff - 1)) from the guess;
        # clamp the argument so an unseeded cell (e.g. a zero-padded halo
        # row) degrades to a bracket-edge start instead of log(<=0) = NaN
        gm = jnp.maximum(guess[1] * (guess[0] - 1.0),
                         jnp.finfo(e_over_R.dtype).tiny)
        t0 = ln_target + jnp.log(gm)
        t = _temperature_warm(ln_target, rho_cgs, x_mf, t0, n_newton)
    _T, eps, (deps_t, mu, dmu_t, dmu_r) = _pvte_terms(
        rho_cgs, t, x_mf, want_deriv=True)
    gamma_eff = 1.0 + 1.0 / (mu * eps)
    chi_t = 1.0 - dmu_t / mu
    chi_r = 1.0 - dmu_r / mu
    g1 = (gamma_eff - 1.0) * eps * chi_t ** 2 / (eps + deps_t) + chi_r
    return gamma_eff, mu, g1


# lookup-table parameters (reference src/pvte_law.cpp:25-41)
N_RHO = 1000
N_E = 1000
RHO_MIN = 1.0e-23
RHO_MAX = 1.0
E_MIN = 1.0e8
E_MAX = 1.0e15
DLOG_RHO = math.log10(RHO_MAX / RHO_MIN) / N_RHO
DLOG_E = math.log10(E_MAX / E_MIN) / N_E


def _ref_brent_temperature(e_cgs, rho_cgs, x_mf, tabs, delta=1.0e-3):
    """Vectorized replica of the reference's Brent solver for the table
    build (src/pvte_law.cpp:243-301), including its exact quirks: the
    |b - a| > delta termination is ABSOLUTE Kelvin (delta = 1e-3), the
    returned root is ``b``, and ``fc`` is initialized once from ``fa``
    and never updated inside the loop.  The table values inherit this
    ~1e-3 K fuzz, so matching the reference binary requires matching the
    solver, not solving better."""
    def f(T):
        _x, _y, mu, eps, gam = _gamma_mu_at(rho_cgs, T, x_mf, tabs)
        return mu * e_cgs * (gam - 1.0) / (CGS_KB / CGS_MP) - T

    a = jnp.ones_like(e_cgs)
    b = jnp.full_like(e_cgs, 1.0e7)
    fa = f(a)
    fb = f(b)
    sw = jnp.abs(fa) < jnp.abs(fb)
    a, b = jnp.where(sw, b, a), jnp.where(sw, a, b)
    fa, fb = jnp.where(sw, fb, fa), jnp.where(sw, fa, fb)
    c = a
    fc = fa                     # stale forever, as in the reference
    d = jnp.zeros_like(e_cgs)   # unused while mflag (first iteration)
    mflag = jnp.ones(e_cgs.shape, bool)
    for _ in range(200):        # scalar worst case ~ log2(1e10) = 34
        active = jnp.abs(b - a) > delta
        if not bool(jnp.any(active)):
            break
        use_iq = (fa != fc) & (fb != fc)
        s_iq = (a * fb * fc / jnp.where(use_iq, (fa - fb) * (fa - fc), 1.0)
                + b * fa * fc / jnp.where(use_iq, (fb - fa) * (fb - fc), 1.0)
                + c * fa * fb / jnp.where(use_iq, (fc - fa) * (fc - fb), 1.0))
        s_sec = b - fb * (b - a) / (fb - fa)
        s = jnp.where(use_iq, s_iq, s_sec)
        cond = (((s < jnp.minimum((3.0 * a + b) / 4.0, b))
                 & (s > jnp.maximum((3.0 * a + b) / 4.0, b)))
                | (mflag & (jnp.abs(s - b) >= jnp.abs(b - c) / 2.0))
                | (~mflag & (jnp.abs(s - b) >= jnp.abs(c - d) / 2.0))
                | (mflag & (jnp.abs(b - c) < delta))
                | (~mflag & (jnp.abs(c - d) < delta)))
        s = jnp.where(cond, (a + b) / 2.0, s)
        new_mflag = cond
        fs = f(s)
        new_d, new_c = c, b
        lo = fa * fs < 0.0
        nb = jnp.where(lo, s, b)
        nfb = jnp.where(lo, fs, fb)
        na = jnp.where(lo, a, s)
        nfa = jnp.where(lo, fa, fs)
        sw = jnp.abs(nfa) < jnp.abs(nfb)
        na, nb = jnp.where(sw, nb, na), jnp.where(sw, na, nb)
        nfa, nfb = jnp.where(sw, nfb, nfa), jnp.where(sw, nfa, nfb)
        a = jnp.where(active, na, a)
        b = jnp.where(active, nb, b)
        fa = jnp.where(active, nfa, fa)
        fb = jnp.where(active, nfb, fb)
        c = jnp.where(active, new_c, c)
        d = jnp.where(active, new_d, d)
        mflag = jnp.where(active, new_mflag, mflag)
    return b


@functools.lru_cache(maxsize=2)
def lookup_tables(x_mf: float):
    """Reference-exact (mu, gamma_eff, gamma1) lookup tables on the
    1000x1000 log-spaced (rho, e) grid (reference src/pvte_law.cpp:370-393
    ``initializeLookupTables``). Built host-side once on the CPU backend
    (f64 quantization must match the all-double reference; the table
    build is a one-time 1e6-point vectorized solve)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        lo, w, coeffs = funcdum_poly()
        tabs = (lo, w, jnp.asarray(coeffs, jnp.float64))
        rho_t = 10.0 ** (DLOG_RHO * np.arange(N_RHO)) * RHO_MIN
        e_t = 10.0 ** (DLOG_E * np.arange(N_E)) * E_MIN
        rho = jnp.asarray(rho_t)[:, None]            # (Ni, 1)
        e = jnp.asarray(e_t)[None, :]                # (1, Nj)
        rho2, e2 = jnp.broadcast_arrays(rho, e)
        T = _ref_brent_temperature(e2, rho2, x_mf, tabs)
        _x, _y, mu, _eps, geff = _gamma_mu_at(rho2, T, x_mf, tabs)
        g1 = gamma1_at(rho2, T, x_mf, tabs)
    return (np.asarray(rho_t), np.asarray(e_t), np.asarray(mu),
            np.asarray(geff), np.asarray(g1))


def lookup_gamma_mu(rho_cgs, e_cgs, tables):
    """Bilinear lookup with the reference's exact index/extrapolation
    convention (src/pvte_law.cpp:395-440): cell indices found in log
    space, clamped to [0, N-2]; interpolation weights LINEAR in (rho, e)
    and deliberately unclamped (out-of-table points extrapolate)."""
    rho_t, e_t, mu_t, geff_t, g1_t = tables
    dtype = rho_cgs.dtype
    i = jnp.floor(jnp.log10(rho_cgs / RHO_MIN) / DLOG_RHO).astype(jnp.int32)
    j = jnp.floor(jnp.log10(e_cgs / E_MIN) / DLOG_E).astype(jnp.int32)
    i = jnp.clip(i, 0, N_RHO - 2)
    j = jnp.clip(j, 0, N_E - 2)
    x = (rho_cgs - rho_t[i]) / (rho_t[i + 1] - rho_t[i])
    y = (e_cgs - e_t[j]) / (e_t[j + 1] - e_t[j])

    def interp(tab):
        s_ij = tab[i + 1, j] * x + tab[i, j] * (1.0 - x)
        s_ijp1 = tab[i + 1, j + 1] * x + tab[i, j + 1] * (1.0 - x)
        return (s_ij * (1.0 - y) + s_ijp1 * y).astype(dtype)

    return interp(geff_t), interp(mu_t), interp(g1_t)


def gamma1_at(rho, T, x_mf, tabs):
    """First adiabatic index via finite differences (reference :151-213)."""
    epsn = 1e-4
    TL, TR = T * (1 - epsn), T * (1 + epsn)
    dT = TL - TR
    xL, yL, muL, eL_eps, _ = _gamma_mu_at(rho, TL, x_mf, tabs)
    xR, yR, muR, eR_eps, _ = _gamma_mu_at(rho, TR, x_mf, tabs)
    xc, yc, muc, eps, gamma_eff = _gamma_mu_at(rho, T, x_mf, tabs)
    eL = eL_eps * TL
    eR = eR_eps * TR
    e = eps * T
    cv = (eL - eR) / dT
    p = (gamma_eff - 1.0) * e
    chiT = 1.0 - T / muc * (muL - muR) / dT
    rhoL, rhoR = rho * (1 - epsn), rho * (1 + epsn)
    dRho = rhoL - rhoR
    xL2, yL2, muL2, _, _ = _gamma_mu_at(rhoL, T, x_mf, tabs)
    xR2, yR2, muR2, _, _ = _gamma_mu_at(rhoR, T, x_mf, tabs)
    chiRho = 1.0 - rho / muc * (muL2 - muR2) / dRho
    return p * chiT ** 2 / (cv * T) + chiRho


class PVTE:
    """Per-run PVTE evaluator (closes over the funcdum fit and units)."""

    def __init__(self, phys, units, dtype):
        self.x_mf = phys.hydrogen_mass_fraction
        lo, w, coeffs = funcdum_poly()
        self.tabs = (lo, w, jnp.asarray(coeffs, dtype))
        self.units = units
        self.density_factor = phys.density_factor
        self.shock_tube = phys.shock_tube
        self.lookup = bool(getattr(phys, "pvte_lookup_table", False))
        # the fused elementwise path serves f32 production; f64 keeps the
        # original one-hot/fori_loop pipeline every reference-binary
        # golden was validated against.  FARGOCPT_TPU_PVTE_FAST=0 opts
        # f32 back into the legacy pipeline (A/B escape hatch).
        import os as _os
        self.fast = (jnp.dtype(dtype) == jnp.float32 and not self.lookup
                     and _os.environ.get("FARGOCPT_TPU_PVTE_FAST", "1")
                     != "0")
        # warm-start chaining (FARGOCPT_TPU_PVTE_WARM=0 forces every
        # refresh through the cold hybrid for A/B comparison).  Newton
        # count: chained refreshes see <~0.3% energy moves, where ONE
        # bracket-safeguarded iteration already reaches the solver
        # tolerance — the 200-step PVTE+FLD budget run measures warm vs
        # cold at 6.5e-6/1.1e-5 (sigma/energy) with n=1, statistically
        # identical to n=3's 6.9e-6/1.2e-5 (CPU sweep 2026-08-21); each
        # dropped iteration removes one full-grid derivative evaluation
        # from every refresh.  The end-to-end gates
        # are the PVTE budget test (warm vs cold < 1e-4 over ~200 steps)
        # and the dtype budget.  FARGOCPT_TPU_PVTE_NEWTON overrides for
        # A/B.
        self.warm = self.fast and _os.environ.get(
            "FARGOCPT_TPU_PVTE_WARM", "1") != "0"
        self.n_newton = int(_os.environ.get("FARGOCPT_TPU_PVTE_NEWTON", "1"))
        if self.lookup:
            # reference-exact table mode: quantizes (geff, mu, g1) onto
            # the reference's 1000x1000 grid; the default in-graph
            # bisection is smoother and needs no gathers
            self.tables = tuple(jnp.asarray(t, dtype)
                                for t in lookup_tables(self.x_mf))

    def gamma_mu(self, sigma, energy, scale_height, guess=None):
        """(gamma_eff, mu, gamma1) grids from the state
        (reference :497-541 ``compute_gamma_mu``). Shock-tube runs use
        the surface density directly as the volume density — no
        midplane scale-height conversion (reference :521-524).

        ``guess``: optional (gamma_eff, mu) from a recent refresh —
        warm-starts the fast path's temperature solve (pure solver
        cache, tolerance-equivalent)."""
        un = self.units
        if self.shock_tube > 0:
            rho_cgs = sigma * un.density
        else:
            rho_cgs = sigma / (self.density_factor * scale_height) \
                * un.density
        e_spec_cgs = energy / sigma * (un.energy_density / un.surface_density)
        if self.lookup:
            return lookup_gamma_mu(rho_cgs, e_spec_cgs, self.tables)
        if self.fast:
            return gamma_mu_fast(rho_cgs, e_spec_cgs, self.x_mf,
                                 guess=guess if self.warm else None,
                                 n_newton=self.n_newton)
        T = temperature_from_energy(e_spec_cgs, rho_cgs, self.x_mf, self.tabs)
        _x, _y, mu, eps, gamma_eff = _gamma_mu_at(rho_cgs, T, self.x_mf,
                                                  self.tabs)
        g1 = gamma1_at(rho_cgs, T, self.x_mf, self.tabs)
        return gamma_eff, mu, g1
