"""Disk self-gravity via FFT convolution on the logarithmic polar grid
(Baruteau & Masset 2008 method).

Re-derivation of reference src/selfgravity.cpp: with u = ln(r/r0) the
smoothed self-gravity acceleration is a 2-D circular convolution of scaled
surface densities S_r = Sigma e^{u/2}, S_t = Sigma e^{3u/2} with kernels
K_r, K_t on a radially doubled (2 NR x NAZ) grid (doubling kills the
periodic wrap in u). Three smoothing modes:

  * ``basic`` (sg_B, Baruteau 2008):      eps = eps_sg * h, eps^2 e^u term
  * ``symmetric`` (sg_S, Moldenhauer 2018): symmetric two-length smoothing
  * ``besselkernel`` (sg_BK, Rendon Restrepo 2023): razor-thin exact kernel

The whole solve is two rfft2 + complex multiply + two irfft2 (``jnp.fft``,
cuFFT on the GPU) — the reference's FFTW-MPI slab decomposition,
friend-CPU resharding and transpose all-to-alls (src/selfgravity.cpp:321-520,
src/split.cpp:91-280) collapse into XLA's FFT.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..grid import Geometry, LOGARITHMIC
from ..params import Physics
from .common import Geom


def _doubled_grid_uth(geometry: Geometry):
    """(u, theta) columns of the radially doubled kernel grid."""
    nr, naz = geometry.nrad, geometry.naz
    radii = geometry.radii_ext
    # u on the doubled grid: mirrored negative branch for i >= NR
    i = np.arange(2 * nr)
    u = np.where(i < nr,
                 np.log(radii[np.minimum(i, nr)] / radii[0]),
                 -np.log(radii[np.minimum(2 * nr - i, nr)] / radii[0]))
    theta = geometry.dphi * np.arange(naz)
    return u[:, None], theta[None, :]


def _kernel_bs(phys: Physics, U, TH, aspect_ratio, xp):
    """K_r, K_t for the 'basic' / 'symmetric' smoothing modes; ``xp`` is
    numpy (host build) or jax.numpy (traced in-run rebuild with a traced
    aspect ratio, reference src/selfgravity.cpp:186-214 update_kernel)."""
    mode = phys.self_gravity_mode
    if mode in ("basic", "b"):
        eps = phys.thickness_smoothing_sg * aspect_ratio
        denom = (eps * eps * xp.exp(U)
                 + 2.0 * (xp.cosh(U) - xp.cos(TH))) ** -1.5
        k_r = (1.0 + eps * eps - xp.cos(TH) * xp.exp(-U)) * denom
        k_t = xp.sin(TH) * denom
    else:
        # Moldenhauer 2018 fits (reference :171-179)
        lam_sq = (0.4571 * aspect_ratio
                  + 0.6737 * xp.sqrt(aspect_ratio)) ** 2
        chi_sq = ((-0.7543 * aspect_ratio + 0.6472) * aspect_ratio) ** 2
        denom = (2.0 * (xp.cosh(U) - xp.cos(TH))
                 + lam_sq * (xp.exp(U) + xp.exp(-U) - 2.0) + chi_sq) ** -1.5
        k_r = (1.0 - xp.cos(TH) * xp.exp(-U)) * denom
        k_t = xp.sin(TH) * denom
    return k_r, k_t


def kernel_host(phys: Physics, geometry: Geometry, aspect_ratio: float
                ) -> tuple[np.ndarray, np.ndarray]:
    """K_r, K_t on the doubled grid (host numpy; reference
    src/selfgravity.cpp:418-519 ``compute_FFT_kernel``)."""
    U, TH = _doubled_grid_uth(geometry)
    mode = phys.self_gravity_mode
    if mode in ("basic", "b", "symmetric", "s"):
        k_r, k_t = _kernel_bs(phys, U, TH, aspect_ratio, np)
    elif mode in ("besselkernel", "bk"):
        from scipy.special import kv
        h = aspect_ratio
        d2 = 2.0 / h ** 2 * (np.cosh(U) - np.cos(TH)) / np.cosh(U)
        x = d2 / 8.0
        # x = 0 at the (0, 0) singularity cell: the large branch's x**-1.5
        # divides by zero there — selected away by ``small`` and the cell
        # is zeroed below
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            small = x < 60.0
            l_sg = np.where(
                small,
                np.sqrt(np.pi) * x * np.exp(np.minimum(x, 60.0))
                * (kv(1.0, np.maximum(x, 1e-300))
                   - kv(0.0, np.maximum(x, 1e-300))),
                np.sqrt(np.pi) * x * 0.5 * np.sqrt(np.pi / 2.0)
                * (x ** -1.5 - 3.0 / 8.0 * x ** -2.5
                   + 45.0 / 128.0 * x ** -3.5))
        # (u, theta) = (0, 0) divides by cosh(0) - cos(0) = 0; that cell
        # is the kernel singularity the reference also special-cases — it
        # is zeroed just below, so the 0/0 never escapes
        with np.errstate(invalid="ignore", divide="ignore"):
            pref = l_sg / (2.0 * np.pi * h) / np.sqrt(np.cosh(U)) \
                / (np.cosh(U) - np.cos(TH))
            k_r = pref * (1.0 - np.cos(TH) * np.exp(-U))
            k_t = pref * np.sin(TH)
        # singularity at u=0, theta=0 (reference :452-460)
        k_r[0, 0] = 0.0
        k_t[0, 0] = 0.0
        k_r = np.nan_to_num(k_r)
        k_t = np.nan_to_num(k_t)
    else:
        raise ValueError(f"unknown SelfGravityMode {mode!r}")
    return k_r, k_t


class SelfGravity:
    """Precompiled FFT-convolution solver for one configuration."""

    def __init__(self, phys: Physics, constants, geometry: Geometry, dtype):
        if geometry.spacing != LOGARITHMIC:
            raise ValueError(
                "self-gravity requires a logarithmic radial grid "
                "(reference src/selfgravity.cpp:219-227)")
        self.phys = phys
        self.constants = constants
        self.geometry = geometry
        self.dtype = dtype
        nr = geometry.nrad
        # reference :246: r_step = ln(Radii[NR]/Radii[0]) / NR
        self.r_step = float(np.log(geometry.radii[nr] / geometry.radii[0])
                            / nr)
        self.t_step = geometry.dphi
        # scaling columns exp(u/2) = sqrt(Rmed/Rmed[0]) etc.
        s = np.sqrt(geometry.rmed / geometry.rmed[0])
        self.scale_half = jnp.asarray(s[:, None], dtype)
        self.scale_3half = jnp.asarray(
            (s * geometry.rmed / geometry.rmed[0])[:, None], dtype)
        # FFT compute dtype follows the run's precision: complex128 for
        # float64, complex64 for float32 (the host-side kernel build is
        # always float64)
        if jnp.dtype(dtype) == jnp.float64:
            self._cdtype = jnp.complex128
            self._fdtype = jnp.float64
        else:
            self._cdtype = jnp.complex64
            self._fdtype = jnp.float32
        self.set_aspect_ratio(phys.aspectratio_ref)

    def set_aspect_ratio(self, aspect_ratio: float):
        """(Re)build the kernel spectra (reference ``update_kernel``
        cadence: every N steps on aspect-ratio change; fixed for locally
        isothermal runs)."""
        k_r, k_t = kernel_host(self.phys, self.geometry, aspect_ratio)
        # host FFT in float64 for accuracy; spectra cast to the compute
        # complex dtype
        cnp = np.complex64 if self._cdtype == jnp.complex64 \
            else np.complex128
        self.k_r_hat = jnp.asarray(np.fft.rfft2(k_r).astype(cnp))
        self.k_t_hat = jnp.asarray(np.fft.rfft2(k_t).astype(cnp))

    # ------- in-run kernel update (reference selfgravity.cpp:186-214) -----
    def supports_in_run_update(self) -> bool:
        """The razor-thin besselkernel is the only mode whose kernel needs
        scipy special functions (and it is rebuilt rarely in practice --
        the reference rebuilds it from the same aspect-ratio trigger, but
        its shape dependence enters only through d^2 ~ 1/h^2)."""
        return self.phys.self_gravity_mode in ("basic", "b",
                                               "symmetric", "s")

    def initial_kernel_state(self):
        """Carried [k_r_hat, k_t_hat, last_aspect_ratio, since_last]
        mirroring the reference's function statics (:192-210: counter
        starts at N so the first compute refreshes, last aspect ratio 0
        so the threshold test passes)."""
        n = self.phys.sg_kernel_update_interval
        return (self.k_r_hat, self.k_t_hat,
                jnp.zeros((), self.dtype),
                jnp.asarray(n, jnp.int32))

    def update_kernel(self, kstate, sigma, scale_height, g: Geom,
                      row_w=None, axis_name=None):
        """Every Nth call, if the mass-averaged aspect ratio moved by more
        than the threshold, rebuild the kernel spectra in-graph
        (reference :186-214 update_kernel + quantities.cpp:107-140
        gas_allreduce_mass_average)."""
        k_r_hat, k_t_hat, last_ar, since = kstate
        phys = self.phys
        n_every = phys.sg_kernel_update_interval

        inside = g.rb <= self.geometry.rmax            # (NR,1)
        w = sigma * g.surf
        if row_w is not None:
            w = w * row_w
        w = jnp.where(inside, w, 0.0)
        ar = scale_height * g.inv_rb
        mass = jnp.sum(w)
        q = jnp.sum(ar * w)
        if axis_name is not None:
            mass = jax.lax.psum(mass, axis_name)
            q = jax.lax.psum(q, axis_name)
        ar_avg = q / mass
        # safety net (reference :158-161)
        ar_avg = jnp.where(ar_avg == 0.0, phys.aspectratio_ref, ar_avg)

        due = since >= n_every - 1
        since = jnp.where(due, 0, since + 1)
        changed = jnp.abs(last_ar - ar_avg)             >= phys.sg_kernel_aspectratio_threshold
        rebuild = due & changed

        U, TH = _doubled_grid_uth(self.geometry)
        U = jnp.asarray(U, self.dtype)
        TH = jnp.asarray(TH, self.dtype)

        def do_rebuild(_):
            k_r, k_t = _kernel_bs(phys, U, TH, ar_avg, jnp)
            return (jnp.fft.rfft2(k_r.astype(self._fdtype))
                    .astype(self._cdtype),
                    jnp.fft.rfft2(k_t.astype(self._fdtype))
                    .astype(self._cdtype), ar_avg)

        def keep(_):
            return (k_r_hat, k_t_hat, last_ar)

        k_r_new, k_t_new, last_ar = jax.lax.cond(rebuild, do_rebuild, keep,
                                                 None)
        return (k_r_new, k_t_new, last_ar, since)

    def accelerations(self, sigma: jax.Array, spectra=None):
        """g_r, g_phi on cell centers (reference :321-700). ``spectra``
        optionally overrides the precomputed kernel spectra with carried
        in-run-updated ones."""
        nr, naz = self.geometry.nrad, self.geometry.naz
        G = self.constants.G
        k_r_hat, k_t_hat = spectra if spectra is not None \
            else (self.k_r_hat, self.k_t_hat)
        s_r = (sigma * self.scale_half).astype(self._fdtype)
        s_t = (sigma * self.scale_3half).astype(self._fdtype)
        pad = jnp.zeros_like(s_r)
        s_r = jnp.concatenate([s_r, pad], axis=0)           # (2NR, NAZ)
        s_t = jnp.concatenate([s_t, pad], axis=0)
        acc_r = jnp.fft.irfft2(k_r_hat * jnp.fft.rfft2(s_r),
                               s=(2 * nr, naz))[:nr]
        acc_t = jnp.fft.irfft2(k_t_hat * jnp.fft.rfft2(s_t),
                               s=(2 * nr, naz))[:nr]
        norm = -G * self.r_step * self.t_step
        g_r = (norm * acc_r).astype(sigma.dtype) / self.scale_half
        g_t = (norm * acc_t).astype(sigma.dtype) / self.scale_3half
        return g_r, g_t

    def kick(self, g: Geom, vrad, vaz, g_r, g_t, dt):
        """Velocity update from the SG accelerations (reference
        :712-747 ``update_velocities``): g_r interpolated to faces,
        g_phi averaged to azimuthal interfaces."""
        nr = g.nrad
        # faces 1..NR-1: linear interpolation in radius
        w_hi = (g.ra[1:nr] - g.rb[:-1]) * g.inv_diff_rmed[1:nr]
        w_lo = (g.rb[1:] - g.ra[1:nr]) * g.inv_diff_rmed[1:nr]
        dvr = dt * (w_hi * g_r[1:] + w_lo * g_r[:-1])
        vrad = vrad.at[1:nr].add(dvr)
        vaz = vaz + 0.5 * dt * (g_t + jnp.roll(g_t, 1, axis=-1))
        return vrad, vaz

    def axisymmetric_gr(self, sigma):
        g_r, _ = self.accelerations(sigma)
        return jnp.mean(g_r, axis=-1)

    def init_azimuthal_velocity_correction(self, phys: Physics, geometry,
                                           sigma: np.ndarray,
                                           vaz: np.ndarray) -> np.ndarray:
        """Equilibrium v_az including the axisymmetric SG pull
        (reference :749-781, Baruteau 2008 eq. 3.42)."""
        g_r_axi = np.asarray(self.axisymmetric_gr(jnp.asarray(sigma)))
        from .. import theo
        rb = geometry.rmed
        omega_cell = theo.initial_locally_isothermal_smoothed_v_az(
            phys, self.constants.G, rb, phys.hydro_center_mass) / rb
        temp = omega_cell ** 2 - g_r_axi / rb
        omega = np.sqrt(np.maximum(temp, 0.0))
        new_row = rb * omega
        out = vaz.copy()
        out[:geometry.nrad - 1] = new_row[:geometry.nrad - 1, None]
        return out
