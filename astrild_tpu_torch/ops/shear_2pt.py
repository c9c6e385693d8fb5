"""Real-space weak-lensing two-point statistics: xi_pm(theta), tangential
shear, Delta Sigma, COSEBIs E/B modes and their covariances.

Port of astrild_tpu/ops/shear_2pt.py:

  * theory curves through the port's cylindrical FFTLog
    (`fftlog.bessel_transform`): xi_pm from C_EE/BB (J0/J4, differentiable
    in the C_ell values through autograd), gamma_t (J2), w(theta) (J0),
    Delta Sigma(r_p) from P_gm (J2); the exact curved-sky sums over Wigner
    d rows stay host float64 numpy, as in the JAX package;
  * the map estimator of xi_pm on flat-sky shear maps (FFT
    autocorrelations, the e^{-4 i phi} rotation for xi_minus, azimuthal
    bins on exact integer offset squares from a host table), and stacked
    tangential / cross shear around positions (one batched gather);
  * linear COSEBIs: the host float64 filter tables (bit for bit), and the
    filter integrals as an elementwise product and a sum, so that no TF32
    matrix product can touch the B-mode cancellation;
  * the exact discrete Gaussian covariance (host float64, bit for bit)
    and the Monte-Carlo covariances (single and tomographic); random
    entry points take a `torch.Generator` where the JAX package takes a
    PRNG key, and each has a `*_from_white` twin that takes the draws;
  * catalog pair estimators (xi_pm, gamma_t) in plain torch tiles, with
    the JAX package's float32 pair arithmetic and Kahan-compensated bins
    (the JAX package has no TPU kernel for them).

Numpy input goes to `device`, by default the CUDA card (it raises without
one: pass device="cpu"); tensors keep their device.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor, as_theory_tensor, default_device
from .angular_power import (_f32, cl_to_flat_map_from_white,
                            kappa_to_shear_maps)
from .binred import masked_bin_reduce
from .fftlog import _interp, bessel_transform
from .power import _mode_numbers
from .sht_spin import _wigner_d_l_rows

__all__ = [
    "xi_pm_from_cl", "xi_pm_from_cl_grid", "gamma_t_from_cl",
    "xi_pm_from_cl_curved", "gamma_t_from_cl_curved",
    "w_theta_from_cl", "w_theta_from_cl_curved",
    "delta_sigma_from_pk",
    "xi_pm_flat_sky", "tangential_shear_stack",
    "xi_pm_catalog", "gamma_t_catalog",
    "xi_pm_gaussian_covariance", "xi_pm_sample_covariance",
    "xi_pm_sample_covariance_from_white",
    "tomographic_xi_pm_sample_covariance",
    "tomographic_xi_pm_sample_covariance_from_white",
    "cosebis_covariance",
    "linear_cosebis_filters", "cosebis_from_xipm", "cosebis_from_cl",
]

DEG2RAD = np.pi / 180.0
ARCMIN2RAD = DEG2RAD / 60.0
# comoving matter density today: Omega_m * rho_crit0 in h^2 Msun / Mpc^3
RHO_CRIT0_H2 = 2.77536627e11


def _host(x, dtype=np.float64):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# ------------------------------------------------------------------- theory

def _log_ell_table(ells, cl, n: int, pad: float):
    """Interpolate a (possibly linearly sampled) C_ell table onto the
    log-uniform grid FFTLog needs, zero-padded `pad` decades each side so
    the implicit log-periodicity doesn't alias into the band. Host numpy:
    (grid float64, values float32)."""
    ells = _host(ells)
    lo = max(float(ells[0]), 1e-2)
    hi = float(ells[-1])
    grid = np.geomspace(lo / 10 ** pad, hi * 10 ** pad, n)
    vals = np.interp(grid, ells, _host(cl), left=0.0, right=0.0)
    return grid, vals.astype(np.float32)


def _log_ell_values(ells, cl, n: int, pad: float, device):
    """_log_ell_table with the values as a tensor: on cl's device if cl is
    a tensor and no `device` is given, else on `device` (by default the
    card)."""
    if isinstance(cl, torch.Tensor) and device is None:
        device = cl.device
    grid, vals = _log_ell_table(ells, cl, n, pad)
    return grid, torch.as_tensor(vals, device=default_device(device))


def xi_pm_from_cl_grid(ell_grid, cl_e, cl_b=None, q: float = 1.0,
                       device=None):
    """Differentiable xi_pm theory: C_EE (and optionally C_BB) VALUES on a
    log-uniform ell grid -> (theta_rad, xi_plus, xi_minus).

    No host-side interpolation of the values, so cl_e may be a tensor that
    requires grad: autograd flows through the FFTLog transform (the host
    Mellin kernels are constants). The grid itself must be a concrete
    log-uniform array. A float64 tensor is transformed in float64."""
    cl_e = as_theory_tensor(cl_e, device)
    tot_p = cl_e if cl_b is None else cl_e + as_tensor(cl_b, cl_e.device)
    tot_m = cl_e if cl_b is None else cl_e - as_tensor(cl_b, cl_e.device)
    th, xp = bessel_transform(ell_grid, tot_p, 0, q=q)
    _, xm = bessel_transform(ell_grid, tot_m, 4, q=q)
    return th, xp / (2.0 * math.pi), xm / (2.0 * math.pi)


def xi_pm_from_cl(ells, cl_e, cl_b=None, n: int = 2048, pad: float = 2.0,
                  q: float = 1.0, device=None):
    """Theory shear correlation functions from E/B power spectra:

        xi_+(theta) = (1/2pi) Int dl l [C_EE + C_BB](l) J_0(l theta),
        xi_-(theta) = (1/2pi) Int dl l [C_EE - C_BB](l) J_4(l theta).

    ells, cl_e: C_EE table (any monotone sampling; interpolated on the
    host onto a padded log grid); cl_b: optional C_BB on the same ells.
    The transform runs on cl_e's device if it is a tensor, else on
    `device` (default the card). Returns (theta_rad, xi_plus, xi_minus)
    on FFTLog's log-spaced theta grid.
    """
    grid, ce = _log_ell_values(ells, cl_e, n, pad, device)
    cb = (_log_ell_values(ells, cl_b, n, pad, ce.device)[1]
          if cl_b is not None else torch.zeros_like(ce))
    th, xp = bessel_transform(grid, ce + cb, 0, q=q)
    _, xm = bessel_transform(grid, ce - cb, 4, q=q)
    return th, xp / (2.0 * math.pi), xm / (2.0 * math.pi)


def gamma_t_from_cl(ells, cl_cross, n: int = 2048, pad: float = 2.0,
                    q: float = 1.0, device=None):
    """Mean tangential shear around tracers from the cross spectrum
    C_{g kappa}: gamma_t(theta) = (1/2pi) Int dl l C_{g kappa}(l)
    J_2(l theta). Placed as xi_pm_from_cl. Returns (theta_rad, gamma_t)."""
    grid, cx = _log_ell_values(ells, cl_cross, n, pad, device)
    th, gt = bessel_transform(grid, cx, 2, q=q)
    return th, gt / (2.0 * math.pi)


def w_theta_from_cl(ells, cl_gg, n: int = 2048, pad: float = 2.0,
                    q: float = 1.0, device=None):
    """Angular clustering correlation w(theta) = (1/2pi) Int dl l C_gg
    J0(l theta) (flat sky). Placed as xi_pm_from_cl. Returns
    (theta_rad, w)."""
    grid, cg = _log_ell_values(ells, cl_gg, n, pad, device)
    th, w = bessel_transform(grid, cg, 0, q=q)
    return th, w / (2.0 * math.pi)


def w_theta_from_cl_curved(cl_gg, theta_rad):
    """Exact curved-sky w(theta) = sum_l (2l+1)/(4pi) C_gg P_l(cos theta),
    P_l = d^l_{00} from the Wigner recursion (sht_spin._wigner_d_l_rows).
    Host float64 numpy; cl indexed l = 0..lmax."""
    cl = _host(cl_gg)
    lmax = cl.shape[0] - 1
    th = np.atleast_1d(_host(theta_rad))
    P = _wigner_d_l_rows(lmax, np.cos(th.ravel()), 0, 0)
    fac = (2.0 * np.arange(lmax + 1) + 1.0) / (4.0 * np.pi)
    return ((fac * cl) @ P).reshape(th.shape)


def xi_pm_from_cl_curved(cl_e, theta_rad, cl_b=None):
    """Exact curved-sky shear correlation functions via Wigner d sums:

        xi_+(theta) = sum_l (2l+1)/(4pi) [C_EE + C_BB] d^l_{2, 2},
        xi_-(theta) = sum_l (2l+1)/(4pi) [C_EE - C_BB] d^l_{2,-2},

    the full-sky completion of xi_pm_from_cl. Host float64 numpy; cl
    arrays indexed by l = 0..lmax. Returns (xi_plus, xi_minus) at
    theta_rad (any shape)."""
    cl_e = _host(cl_e)
    lmax = cl_e.shape[0] - 1
    cb = np.zeros_like(cl_e) if cl_b is None else _host(cl_b)
    th = np.atleast_1d(_host(theta_rad))
    x = np.cos(th.ravel())
    d22 = _wigner_d_l_rows(lmax, x, 2, 2)     # (lmax+1, nth)
    d2m2 = _wigner_d_l_rows(lmax, x, -2, 2)
    fac = (2.0 * np.arange(lmax + 1) + 1.0) / (4.0 * np.pi)
    xip = (fac * (cl_e + cb)) @ d22
    xim = (fac * (cl_e - cb)) @ d2m2
    return xip.reshape(th.shape), xim.reshape(th.shape)


def gamma_t_from_cl_curved(cl_cross, theta_rad, cross_with: str = "E"):
    """Curved-sky mean tangential shear around tracers,

        gamma_t(theta) = sum_l (2l+1)/(4pi) C_l^{gE} d^l_{2,0}(theta);

    cross_with="kappa" takes C_l^{g kappa} and applies the spin-raising
    factor sqrt((l+2)(l-1)/(l(l+1))). Host float64 numpy. Returns gamma_t
    at theta_rad."""
    cl = _host(cl_cross).copy()
    lmax = cl.shape[0] - 1
    ell = np.arange(lmax + 1, dtype=np.float64)
    if cross_with == "kappa":
        with np.errstate(divide="ignore", invalid="ignore"):
            f = np.sqrt((ell + 2.0) * (ell - 1.0)
                        / np.maximum(ell * (ell + 1.0), 1.0))
        f[:2] = 0.0
        cl = cl * f
    elif cross_with != "E":
        raise ValueError("cross_with must be 'E' or 'kappa'")
    th = np.atleast_1d(_host(theta_rad))
    d20 = _wigner_d_l_rows(lmax, np.cos(th.ravel()), 0, 2)
    fac = (2.0 * ell + 1.0) / (4.0 * np.pi)
    return ((fac * cl) @ d20).reshape(th.shape)


def delta_sigma_from_pk(k, p_gm, rp, omega_m: float, q: float = 1.0,
                        device=None):
    """Theory excess surface density for galaxy-galaxy lensing,

        Delta Sigma(r_p) = rho_m Int dk k P_gm(k) J_2(k r_p) / (2 pi),

    rho_m the comoving mean matter density (Omega_m rho_crit0).

    Args:
      k, p_gm: log-spaced galaxy-matter power table [h/Mpc, (Mpc/h)^3];
        p_gm placed as fk in `bessel_transform`.
      rp: (m,) projected radii [Mpc/h] (follows p_gm's device).
      omega_m: matter density parameter.
    Returns (m,) Delta Sigma in h Msun / pc^2 (comoving).
    """
    p_gm = as_theory_tensor(p_gm, device)
    r, ds = bessel_transform(_host(k), p_gm, 2, q=q)
    rho_m = omega_m * RHO_CRIT0_H2  # h^2 Msun / Mpc^3
    ds = ds * (rho_m / (2.0 * math.pi)) * 1e-12  # Mpc^-2 -> pc^-2
    lnr = torch.log(r)
    rp = as_theory_tensor(rp, ds.device).reshape(-1).to(ds.dtype)
    return _interp(torch.log(rp), lnr, ds)


# ------------------------------------------------------------ map estimator

@lru_cache(maxsize=32)
def _xi_pm_bins(n: int, nbins: int, theta_min_pix: float,
                theta_max_pix: float):
    """Host-precomputed azimuthal binning of the (n, n) offset grid (the
    JAX package's numpy, bit for bit).

    Offsets are fftfreq-signed integers; selection compares the exact
    integer r^2 = dx^2 + dy^2 against host float64 squared log-edges, so
    no device sqrt takes part. Returns (binidx flat int32, inside flat
    float32, counts (nbins,), theta_pix (nbins,) mean |r| per bin); host
    arrays only.
    """
    f = (np.fft.fftfreq(n) * n).astype(np.float64)
    r2 = f[:, None] ** 2 + f[None, :] ** 2  # exact integers
    edges2 = np.geomspace(theta_min_pix, theta_max_pix, nbins + 1) ** 2
    idx = np.clip(np.searchsorted(edges2, r2.ravel(), side="right") - 1,
                  0, nbins - 1)
    inside = ((r2.ravel() >= edges2[0]) & (r2.ravel() <= edges2[-1]))
    cnt = np.bincount(idx, weights=inside, minlength=nbins)
    rsum = np.bincount(idx, weights=inside * np.sqrt(r2.ravel()),
                       minlength=nbins)
    # empty annuli (narrow log bins between integer radii) report the
    # geometric bin center instead of a misleading 0
    centers = np.sqrt(edges2[:-1] * edges2[1:]) ** 0.5
    theta_pix = np.where(cnt > 0, rsum / np.maximum(cnt, 1.0), centers)
    return (idx.astype(np.int32), inside.astype(np.float32),
            cnt.astype(np.float32), theta_pix.astype(np.float32))


def _rotation4(n: int, device):
    """(cos 4 phi_r, sin 4 phi_r) of the signed integer offsets, from
    (dx + i dy)^4 / r^4 in float32 (the JAX package's formula: safe * safe
    reaches ~n^4 / 4, well inside float32's range)."""
    f = _mode_numbers(n, device)
    dx = f[:, None].expand(n, n)
    dy = f[None, :].expand(n, n)
    r2 = dx * dx + dy * dy
    safe = torch.where(r2 == 0.0, torch.ones_like(r2), r2)
    z2x = dx * dx - dy * dy
    z2y = 2.0 * dx * dy
    cos4 = (z2x * z2x - z2y * z2y) / (safe * safe)
    sin4 = (2.0 * z2x * z2y) / (safe * safe)
    return cos4, sin4


def _xi_pm_grids(g1, g2, nbins: int, theta_min_pix: float,
                 theta_max_pix: float):
    """(theta_pix, xi_plus, xi_minus, counts) of two (n, n) tensors, on
    their device; empty annuli NaN."""
    n = g1.shape[-1]
    dev = g1.device
    gam = torch.complex(g1.to(torch.float32), g2.to(torch.float32))
    F = torch.fft.fft2(gam)
    Fc = torch.fft.fft2(torch.conj(gam))
    npix = _f32(float(n) ** 2, dev)
    # c_plus(r) = <gamma(x+r) conj(gamma(x))>_x : IFFT of |F|^2
    c_plus = torch.fft.ifft2(torch.complex(F.abs() ** 2,
                                           torch.zeros_like(F.real))) / npix
    # c_minus(r) = <gamma(x+r) gamma(x)>_x : gamma_hat(-l) = conj(Fc(l))
    c_minus = torch.fft.ifft2(F * torch.conj(Fc)) / npix
    cos4, sin4 = _rotation4(n, dev)
    xim_grid = c_minus.real * cos4 + c_minus.imag * sin4
    xip_grid = c_plus.real
    binidx_h, inside_h, cnt_h, theta_pix_h = _xi_pm_bins(
        n, nbins, theta_min_pix, theta_max_pix)
    # dropped offsets go to the nbins bucket of masked_bin_reduce
    binidx = torch.as_tensor(
        np.where(inside_h > 0, binidx_h, nbins).astype(np.int64), device=dev)
    inside = torch.as_tensor(inside_h, device=dev)
    cnt = torch.as_tensor(cnt_h, device=dev)
    theta_pix = torch.as_tensor(theta_pix_h, device=dev)
    denom = torch.clamp_min(cnt, 1.0)
    sums = masked_bin_reduce(
        torch.stack([inside * xip_grid.reshape(-1),
                     inside * xim_grid.reshape(-1)]), binidx, nbins)
    # empty annuli are NaN, not a silent 0 (npairs == 0 says why)
    empty = cnt == 0
    nan = torch.full_like(cnt, float("nan"))
    xip = torch.where(empty, nan, sums[0] / denom)
    xim = torch.where(empty, nan, sums[1] / denom)
    return theta_pix, xip, xim, cnt


def _theta_range_pix(npix: int, opening_angle_deg: float, theta_min_arcmin,
                     theta_max_arcmin):
    pixscale = opening_angle_deg * 60.0 / npix
    tmin = (1.0 if theta_min_arcmin is None
            else float(theta_min_arcmin) / pixscale)
    tmax = (npix / 2.0 if theta_max_arcmin is None
            else float(theta_max_arcmin) / pixscale)
    return pixscale, float(tmin), float(tmax)


def xi_pm_flat_sky(gamma1, gamma2, opening_angle_deg: float,
                   nbins: int = 20, theta_min_arcmin=None,
                   theta_max_arcmin=None, device=None):
    """Shear correlation functions measured on flat-sky maps,

        xi_+(theta) = < gamma gamma* >(theta),
        xi_-(theta) = Re[ < gamma gamma >(r) e^{-4 i phi_r} ](theta),

    by FFT autocorrelations of gamma = g1 + i g2 (periodic). Log-spaced
    angular bins over exact integer offset squares. Maps are placed as in
    `angular_power.cl_flat_sky`.

    Returns (theta_arcmin, xi_plus, xi_minus, npairs), npairs the
    offset-vector count per bin (each carrying npix pair samples).
    """
    gamma1 = as_tensor(gamma1, device)
    gamma2 = as_tensor(gamma2, gamma1.device)
    n = gamma1.shape[-1]
    pixscale, tmin, tmax = _theta_range_pix(n, opening_angle_deg,
                                            theta_min_arcmin,
                                            theta_max_arcmin)
    if not tmax > tmin:
        raise ValueError("xi_pm_flat_sky: need theta_max > theta_min "
                         f"(got {tmin}..{tmax} pixels)")
    theta_pix, xip, xim, cnt = _xi_pm_grids(gamma1, gamma2, nbins, tmin,
                                            tmax)
    return theta_pix * pixscale, xip, xim, cnt


def tangential_shear_stack(gamma1, gamma2, centers_pix, r_edges_pix,
                           patch_half: int, nbins: int, device=None):
    """Stacked tangential / cross shear around catalog positions (the
    galaxy-galaxy-lensing map estimator),

        gamma_t(x; c) = -[g1 cos 2phi + g2 sin 2phi],
        gamma_x(x; c) = -[-g1 sin 2phi + g2 cos 2phi],

    phi the position angle of x - c measured from axis 0 toward axis 1.
    Periodic patches: one batched gather of (nobj, p, p) with floor-mod
    indices (the JAX package's vmap of `jnp.mod` gathers).

    Args:
      gamma1, gamma2: (n, n) shear maps (placed as in xi_pm_flat_sky).
      centers_pix: (nobj, 2) integer (row, col) stack centers.
      r_edges_pix: (nbins+1,) ascending radial edges in pixels (float32;
        r_edges_pix[-1] <= patch_half).
      patch_half: patch half-size.
    Returns (r_mid_pix, gt, gx, npix): profile radii, stacked tangential
    and cross shear (nbins,), and pixels per annulus across the stack.
    """
    g1 = as_tensor(gamma1, device).to(torch.float32)
    dev = g1.device
    g2 = as_tensor(gamma2, dev).to(torch.float32)
    n = g1.shape[-1]
    p = 2 * patch_half + 1
    off = (torch.arange(p, device=dev) - patch_half).to(torch.float32)
    drow = off[:, None].expand(p, p)
    dcol = off[None, :].expand(p, p)
    r2 = drow ** 2 + dcol ** 2
    safe = torch.where(r2 == 0.0, torch.ones_like(r2), r2)
    # the same frame as shear_eb_maps' Kaiser-Squires rotation
    cos2 = (drow ** 2 - dcol ** 2) / safe
    sin2 = 2.0 * drow * dcol / safe
    r = torch.sqrt(r2).reshape(-1)
    edges = as_tensor(r_edges_pix, dev).to(torch.float32).reshape(-1)
    binidx = torch.clamp(torch.searchsorted(edges, r, right=True) - 1, 0,
                         nbins - 1)
    inside = ((r >= edges[0]) & (r < edges[-1]) & (r > 0.0)).to(
        torch.float32)
    bdrop = torch.where(inside > 0, binidx, nbins)

    centers = as_tensor(centers_pix, dev).to(torch.int64).reshape(-1, 2)
    nobj = centers.shape[0]
    rows = torch.arange(p, device=dev) - patch_half
    ri = torch.remainder(centers[:, 0:1] + rows[None, :], n)   # (nobj, p)
    ci = torch.remainder(centers[:, 1:2] + rows[None, :], n)
    p1 = g1[ri[:, :, None], ci[:, None, :]]                    # (nobj, p, p)
    p2 = g2[ri[:, :, None], ci[:, None, :]]
    gt = -(p1 * cos2 + p2 * sin2)
    gx = -(p2 * cos2 - p1 * sin2)
    sums = masked_bin_reduce(
        torch.cat([inside * gt.reshape(nobj, -1),
                   inside * gx.reshape(nobj, -1)]), bdrop, nbins)
    ts, xs = sums[:nobj], sums[nobj:]
    csums = masked_bin_reduce(torch.stack([inside, inside * r]), bdrop,
                              nbins)
    cnt = csums[0]
    rsum = csums[1]
    nobj_t = _f32(nobj, dev)
    tot = torch.clamp_min(cnt, 1.0) * nobj_t
    return (rsum / torch.clamp_min(cnt, 1.0), ts.sum(0) / tot,
            xs.sum(0) / tot, cnt * nobj_t)


# ------------------------------------------------------ xi_pm covariances

def _annulus_weights(npix: int, nbins: int, tmin_pix: float,
                     tmax_pix: float):
    """Host-precomputed spectral annulus weights of the map estimator (the
    JAX package's numpy, bit for bit).

    xi_hat_+(b) = sum_l A_b(l) |kappa_hat(l)|^2 and
    xi_hat_-(b) = sum_l [B_b(l) Re Z(l) - Bt_b(l) Im Z(l)] with
    Z = e^{4 i phi_l} gamma_hat(l) gamma_hat(-l): A_b is the plain annulus
    Fourier weight, (B_b, Bt_b) carry the e^{-4 i phi_r} rotation. All
    returned (nbins, npix^2) float32 on the host; the binning is
    _xi_pm_bins'.
    """
    idx, inside_f, cnt, _ = _xi_pm_bins(npix, nbins, tmin_pix, tmax_pix)
    inside = inside_f > 0
    f = (np.fft.fftfreq(npix) * npix).astype(np.float64)
    dx, dy = np.meshgrid(f, f, indexing="ij")
    r2 = dx ** 2 + dy ** 2
    safe = np.where(r2 == 0.0, 1.0, r2)
    z2x, z2y = dx * dx - dy * dy, 2 * dx * dy
    cos4r = (z2x * z2x - z2y * z2y) / (safe * safe)
    sin4r = 2 * z2x * z2y / (safe * safe)
    # mode-side 4phi_l phase (same functional form on the fft grid)
    cos4l, sin4l = cos4r, sin4r
    A = np.empty((nbins, npix * npix), np.float64)
    B = np.empty_like(A)
    Bt = np.empty_like(A)
    n2 = float(npix * npix)
    norm = n2 * n2  # the estimator's ifft2 carries 1/N^2 and the grid
    # average another 1/N^2: A_b = (1/(N_b N^4)) sum_{r in b} e^{i l r}
    for b in range(nbins):
        ind = ((idx == b) & inside).astype(np.float64).reshape(npix, npix)
        nb = max(cnt[b], 1.0)
        fa = np.fft.fft2(ind)
        A[b] = fa.real.ravel() / (nb * norm)  # symmetric annulus -> real
        fc = np.fft.fft2(ind * cos4r)
        fs = np.fft.fft2(ind * sin4r)
        # sum_{r in b} e^{i l r} e^{-4 i phi_r} = fa_c - i fa_s; times
        # e^{4 i phi_l}
        re = fc.real.ravel() + fs.imag.ravel()
        im = fc.imag.ravel() - fs.real.ravel()
        B[b] = (cos4l.ravel() * re - sin4l.ravel() * im) / (nb * norm)
        Bt[b] = -(cos4l.ravel() * im + sin4l.ravel() * re) / (nb * norm)
    return (A.astype(np.float32), B.astype(np.float32),
            Bt.astype(np.float32), cnt)


def xi_pm_gaussian_covariance(npix: int, opening_angle_deg: float,
                              cl_tab_ell, cl_tab_val, nbins: int,
                              theta_min_arcmin=None, theta_max_arcmin=None,
                              cl_b_tab_val=None, noise_cl: float = 0.0):
    """Exact discrete Gaussian covariance of xi_pm_flat_sky on this
    estimator's own mode set (host float64 numpy, the JAX package's
    arithmetic bit for bit).

    With P(l) = S_E(l) + S_n and Q(l) = S_B(l) + S_n the per-channel
    grid-unit powers (S = C * npix^4 / theta_box^2; S_n from noise_cl, the
    white noise power per shear component):

      Cov(xi+_b, xi+_b') = 2 sum_l A_b A_b' (P^2 + Q^2)
      Cov(xi+_b, xi-_b') = 2 sum_l A_b B_b' (P^2 - Q^2)
      Cov(xi-_b, xi-_b') = sum_l [(B_b B_b' + B_b Bf_b')(P^2 + Q^2)
                                 + (Bt_b Bt_b' + Bt_b Btf_b') 2 P Q]

    with Xf(l) = X(-l): the pm-weights are not even in l on small annuli,
    and dropping the flipped product under-covers the smallest xi_- bin by
    ~14% (the JAX package's measurement). The C_ell table is interpolated
    endpoint-clamped, as cl_to_flat_map does (pass an explicitly zero-tailed
    table to band-limit). Returns (theta_arcmin, cov), cov the
    (2 nbins, 2 nbins) [xi+; xi-] block matrix.
    """
    pixscale, tmin, tmax = _theta_range_pix(npix, opening_angle_deg,
                                            theta_min_arcmin,
                                            theta_max_arcmin)
    A, B, Bt, cnt = _annulus_weights(npix, nbins, tmin, tmax)
    _, _, _, theta_pix = _xi_pm_bins(npix, nbins, tmin, tmax)
    f = np.fft.fftfreq(npix) * npix
    lf = 2.0 * np.pi / (opening_angle_deg * DEG2RAD)
    lmag = lf * np.sqrt(f[:, None] ** 2 + f[None, :] ** 2).ravel()
    box = opening_angle_deg * DEG2RAD
    unit = float(npix) ** 4 / box ** 2
    s_e = np.interp(lmag, _host(cl_tab_ell), _host(cl_tab_val)) * unit
    s_e[lmag == 0.0] = 0.0
    s_b = (np.zeros_like(s_e) if cl_b_tab_val is None else
           np.interp(lmag, _host(cl_tab_ell), _host(cl_b_tab_val)) * unit)
    s_n = noise_cl * unit
    P = s_e + s_n
    Q = s_b + s_n
    pq_plus = P ** 2 + Q ** 2
    pq_minus = P ** 2 - Q ** 2
    pq_cross = 2.0 * P * Q
    A64 = A.astype(np.float64)
    B64 = B.astype(np.float64)
    Bt64 = Bt.astype(np.float64)

    def lflip(W):
        # W(l) -> W(-l) on the fft index grid
        g = W.reshape(-1, npix, npix)[:, ::-1, ::-1]
        return np.roll(g, 1, axis=(1, 2)).reshape(W.shape[0], -1)

    Bf = lflip(B64)
    Btf = lflip(Bt64)
    cpp = 2.0 * (A64 * pq_plus) @ A64.T
    cpm = 2.0 * (A64 * pq_minus) @ B64.T
    cmm = ((B64 * pq_plus) @ (B64 + Bf).T
           + (Bt64 * pq_cross) @ (Bt64 + Btf).T)
    cov = np.block([[cpp, cpm], [cpm.T, cmm]])
    return np.asarray(theta_pix) * pixscale, cov


def _sample_cov(samples):
    """(mean, cov) of (n_real, m) samples, cov = d^T d / (n_real - 1) as an
    elementwise product and a sum (no matrix product for TF32 to touch)."""
    mean = samples.mean(0)
    d = samples - mean
    cov = (d[:, :, None] * d[:, None, :]).sum(0) / _f32(
        samples.shape[0] - 1, samples.device)
    return mean, cov


def _xi_pm_samples(fields, cl_tab_ell, cl_tab_val, npix: int,
                   opening_angle_deg: float, nbins: int, theta_min_arcmin,
                   theta_max_arcmin, noise_std: float, device):
    """(theta_arcmin, mean, cov, samples) of the realizations made from
    each (2 or 4, npix, npix) entry of `fields`: re and im of the kappa
    modes (cl_to_flat_map_from_white), then with noise_std > 0 the noise of
    gamma1 and gamma2."""
    pixscale, tmin, tmax = _theta_range_pix(npix, opening_angle_deg,
                                            theta_min_arcmin,
                                            theta_max_arcmin)
    ell_tab = as_tensor(cl_tab_ell, device)
    val_tab = as_tensor(cl_tab_val, device)
    rows = []
    th = None
    for w in fields:
        kap = cl_to_flat_map_from_white(w[0], w[1], ell_tab, val_tab, npix,
                                        opening_angle_deg)
        g1, g2 = kappa_to_shear_maps(kap)
        if noise_std > 0.0:
            g1 = g1 + noise_std * w[2]
            g2 = g2 + noise_std * w[3]
        th, xp, xm, _ = _xi_pm_grids(g1, g2, nbins, tmin, tmax)
        rows.append(torch.cat([xp, xm]))
    samples = torch.stack(rows)
    mean, cov = _sample_cov(samples)
    return th * pixscale, mean, cov, samples


def xi_pm_sample_covariance_from_white(white, cl_tab_ell, cl_tab_val,
                                       npix: int, opening_angle_deg: float,
                                       nbins: int, theta_min_arcmin=None,
                                       theta_max_arcmin=None,
                                       noise_std: float = 0.0, device=None):
    """xi_pm_sample_covariance of given draws: `white` (n_real, 4, npix,
    npix), per realization the two fields of cl_to_flat_map_from_white
    and the noise fields of gamma1 and gamma2 (the JAX package's normal(a),
    normal(b) with a, b = split(k1), then normal(k2), normal(k3), where
    k1, k2, k3 = split(key_r, 3)); the noise rows are read only when
    noise_std > 0, and may be absent (shape (n_real, 2, npix, npix)).
    Returns (theta_arcmin, mean, cov, samples)."""
    white = as_tensor(white, device)
    return _xi_pm_samples(white, cl_tab_ell, cl_tab_val, npix,
                          opening_angle_deg, nbins, theta_min_arcmin,
                          theta_max_arcmin, noise_std, white.device)


def xi_pm_sample_covariance(generator: torch.Generator, cl_tab_ell,
                            cl_tab_val, npix: int, opening_angle_deg: float,
                            nbins: int, n_real: int = 200,
                            theta_min_arcmin=None, theta_max_arcmin=None,
                            noise_std: float = 0.0, device=None):
    """Monte-Carlo covariance of xi_pm_flat_sky: n_real Gaussian pure-E
    realizations (cl_to_flat_map -> kappa_to_shear_maps -> estimator,
    optional white shape noise of std noise_std per shear component per
    pixel), each drawn from `generator` in turn (re, im, then the two noise
    fields when noise_std > 0), on `device` (default: the generator's).

    Returns (theta_arcmin, mean (2 nbins,), cov (2 nbins, 2 nbins),
    samples (n_real, 2 nbins)).
    """
    dev = generator.device if device is None else torch.device(device)
    nfield = 4 if noise_std > 0.0 else 2
    fields = (torch.randn((nfield, npix, npix), generator=generator,
                          device=dev, dtype=torch.float32)
              for _ in range(n_real))
    return _xi_pm_samples(fields, cl_tab_ell, cl_tab_val, npix,
                          opening_angle_deg, nbins, theta_min_arcmin,
                          theta_max_arcmin, noise_std, dev)


def _tomographic_cholesky(ells, cls_stack, npix: int,
                          opening_angle_deg: float):
    """Per-mode Cholesky factor of C^{ij}(|l|) on the fft grid times the
    mode amplitude npix^2 / theta (host float64, then float32): the JAX
    package's numpy."""
    cls_stack = _host(cls_stack)
    nb = cls_stack.shape[0]
    ells = _host(ells)
    theta_box = opening_angle_deg * np.pi / 180.0
    lf = 2.0 * np.pi / theta_box
    f = np.fft.fftfreq(npix) * npix
    lmag = lf * np.hypot(f[:, None], f[None, :])
    cmat = np.empty((npix, npix, nb, nb))
    for i in range(nb):
        for j in range(nb):
            cmat[..., i, j] = np.interp(lmag, ells, cls_stack[i, j])
    cmat[lmag == 0.0] = 0.0
    # relative jitter so cholesky exists everywhere: zero modes need an
    # absolute floor, perfectly-correlated bins one scaled to the matrix
    scale = cmat.diagonal(axis1=-2, axis2=-1).max(axis=-1)
    cmat += np.eye(nb) * (1e-10 * scale + 1e-300)[..., None, None]
    chol = np.linalg.cholesky(cmat)  # (npix, npix, nb, nb)
    amp = float(npix) ** 2 / theta_box  # cl_to_flat_map's normalization
    return (chol * amp).astype(np.float32)


def _tomographic_samples(draws, ells, cls_stack, npix: int,
                         opening_angle_deg: float, nbins: int,
                         theta_min_arcmin, theta_max_arcmin,
                         noise_std: float, device):
    """(theta_arcmin, pairs, mean, cov, samples) of the realizations made
    from each (zr, zi, noise) of `draws`: zr, zi (npix, npix, nb), noise
    (2 nb, npix, npix) or None."""
    nb = _host(cls_stack).shape[0]
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    pixscale, tmin, tmax = _theta_range_pix(npix, opening_angle_deg,
                                            theta_min_arcmin,
                                            theta_max_arcmin)
    chol = torch.as_tensor(_tomographic_cholesky(ells, cls_stack, npix,
                                                 opening_angle_deg),
                           device=device)
    sqrt2 = torch.sqrt(_f32(2.0, device))
    rows = []
    th = None
    for zr, zi, noise in draws:
        # einsum('xyij,xyj->xyi') as a product and a sum (no TF32 matmul)
        m_re = (chol * zr[..., None, :]).sum(-1) / sqrt2
        m_im = (chol * zi[..., None, :]).sum(-1) / sqrt2
        # hermitianize each bin's mode grid (the cl_to_flat_map recipe)
        f_re = torch.roll(torch.flip(m_re, (0, 1)), (1, 1), (0, 1))
        f_im = torch.roll(torch.flip(m_im, (0, 1)), (1, 1), (0, 1))
        sym = torch.complex(0.5 * (m_re + f_re), 0.5 * (m_im - f_im))
        kap = torch.fft.ifft2(sym * sqrt2, dim=(0, 1)).real
        shear = [kappa_to_shear_maps(kap[..., b]) for b in range(nb)]
        if noise_std > 0.0:
            shear = [(g1 + noise_std * noise[2 * b],
                      g2 + noise_std * noise[2 * b + 1])
                     for b, (g1, g2) in enumerate(shear)]
        row = []
        for (i, j) in pairs:
            g1i, g2i = shear[i]
            g1j, g2j = shear[j]
            # cross-correlation by the polarization identity through the
            # auto estimator (the same binning)
            _, xp_s, xm_s, _ = _xi_pm_grids(g1i + g1j, g2i + g2j, nbins,
                                            tmin, tmax)
            th, xp_d, xm_d, _ = _xi_pm_grids(g1i - g1j, g2i - g2j, nbins,
                                             tmin, tmax)
            row.append(0.25 * (xp_s - xp_d))
            row.append(0.25 * (xm_s - xm_d))
        rows.append(torch.cat(row))
    samples = torch.stack(rows)
    mean, cov = _sample_cov(samples)
    return th * pixscale, pairs, mean, cov, samples


def tomographic_xi_pm_sample_covariance_from_white(
        zr, zi, ells, cls_stack, npix: int, opening_angle_deg: float,
        nbins: int, theta_min_arcmin=None, theta_max_arcmin=None,
        noise_std: float = 0.0, noise=None, device=None):
    """tomographic_xi_pm_sample_covariance of given draws: zr, zi (n_real,
    npix, npix, nb) (the JAX package's normal(km), normal(kn) with km, kn
    = split(key_r)), and with noise_std > 0 `noise` (n_real, 2 nb, npix,
    npix), the gamma1 / gamma2 noise of bin b in rows 2b, 2b + 1 (the JAX
    package's normal(kk[2b]), normal(kk[2b + 1]), kk = split(key_r,
    2 nb + 2)). Returns (theta_arcmin, pair_list, mean, cov, samples)."""
    zr = as_tensor(zr, device)
    dev = zr.device
    zi = as_tensor(zi, dev)
    noise = (as_tensor(noise, dev) if noise_std > 0.0
             else [None] * zr.shape[0])
    return _tomographic_samples(zip(zr, zi, noise), ells, cls_stack, npix,
                                opening_angle_deg, nbins, theta_min_arcmin,
                                theta_max_arcmin, noise_std, dev)


def tomographic_xi_pm_sample_covariance(generator: torch.Generator, ells,
                                         cls_stack, npix: int,
                                         opening_angle_deg: float,
                                         nbins: int, n_real: int = 200,
                                         theta_min_arcmin=None,
                                         theta_max_arcmin=None,
                                         noise_std: float = 0.0,
                                         device=None):
    """Monte-Carlo covariance of the tomographic real-space shear data
    vector: for nb source bins the packed vector is

        [xi_+^{ij}(theta); xi_-^{ij}(theta)]  over unique pairs i <= j,

    measured by the map estimator on correlated Gaussian realizations:
    per 2D mode kappa_i = L_ij z_j with L the Cholesky factor of the
    C^{ij}(l) stack. Optional white shape noise per shear component and
    bin. Draws come from `generator` per realization (zr, zi, then the
    noise fields), on `device` (default: the generator's).

    Returns (theta_arcmin, pair_list, mean, cov, samples), mean a
    (npair * 2 * nbins,) vector ordered pair-major [(0,0)+, (0,0)-,
    (0,1)+, ...].
    """
    dev = generator.device if device is None else torch.device(device)
    nb = _host(cls_stack).shape[0]

    def draws():
        for _ in range(n_real):
            z = torch.randn((2, npix, npix, nb), generator=generator,
                            device=dev, dtype=torch.float32)
            noise = (torch.randn((2 * nb, npix, npix), generator=generator,
                                 device=dev, dtype=torch.float32)
                     if noise_std > 0.0 else None)
            yield z[0], z[1], noise

    return _tomographic_samples(draws(), ells, cls_stack, npix,
                                opening_angle_deg, nbins, theta_min_arcmin,
                                theta_max_arcmin, noise_std, dev)


def cosebis_covariance(theta_arcmin, cov_xipm, nmax: int,
                       theta_min: float, theta_max: float,
                       ntheta: int = 4096):
    """Propagate a (2 nbins, 2 nbins) [xi+; xi-] covariance through the
    linear map cosebis_from_xipm: the transform matrix from the estimator
    applied to unit vectors (on the CPU), then L C L^T in float64 numpy.
    Returns (cov_E (nmax, nmax), cov_B (nmax, nmax))."""
    theta_arcmin = _host(theta_arcmin)
    nb = theta_arcmin.shape[0]
    L_E = np.zeros((int(nmax), 2 * nb))
    L_B = np.zeros((int(nmax), 2 * nb))
    zero = np.zeros(nb)
    for i in range(2 * nb):
        xp = zero.copy()
        xm = zero.copy()
        (xp if i < nb else xm)[i % nb] = 1.0
        e, b = cosebis_from_xipm(theta_arcmin, xp, xm, nmax, theta_min,
                                 theta_max, ntheta=ntheta, device="cpu")
        L_E[:, i] = e.numpy()
        L_B[:, i] = b.numpy()
    cov = _host(cov_xipm)
    return L_E @ cov @ L_E.T, L_B @ cov @ L_B.T


# ------------------------------------------------- catalog pair estimators

def _pad_to_block(a, block: int, fill=0.0):
    n = a.shape[0]
    m = (-n) % block
    if m:
        a = torch.cat([a, torch.full((m,), fill, dtype=a.dtype,
                                     device=a.device)])
    return a


def _min_image_1d(d, box):
    """d - box * round(d / box) (round half to even, as jnp.round), `box`
    a tensor (a true division on the card too), or no wrap if None."""
    if box is None:
        return d
    return d - box * torch.round(d / box)


def _shear_pair_tiles(xi_, yi_, e1i, e2i, wi, xj_, yj_, e1j, e2j, wj,
                      edges, nbins: int, boxsize, block: int, dedup: bool,
                      triangular: bool = False, ia0: int = 0, jb0: int = 0):
    """Blocked O(N_i N_j) accumulation of the spin-2 pair channels.

    Per theta bin returns (sum w w' Re[e conj(e')],
    sum w w' Re[e e' exp(-4 i phi)], sum w w' e_t', sum w w' e_x',
    sum w w', npairs); phi is the separation angle from axis x toward y,
    and the t / x channels rotate only the j-side ellipticity. dedup masks
    global i < global j, ia0 / jb0 being the chunks' global row offsets
    (the ring schedule of parallel/tpcf.py); triangular skips a > b tiles
    (for i and j the same catalog). The tile pairs run in the JAX
    package's scan order, with its float32 pair arithmetic and its
    Kahan-compensated bins.
    """
    ni = xi_.shape[0]
    nj = xj_.shape[0]
    if ni % block or nj % block or ni < block or nj < block:
        raise ValueError(
            f"_shear_pair_tiles: chunk sizes ({ni}, {nj}) must be "
            f"nonzero multiples of block={block} (pad with zero-weight "
            "rows)")
    dev = xi_.device
    nbi = ni // block
    nbj = nj // block
    edges = edges.to(torch.float32)
    lo = edges[0]
    hi = edges[-1]
    box = None if boxsize is None else _f32(boxsize, dev)
    two = _f32(2.0, dev)
    ar = torch.arange(block, device=dev)
    sums = torch.zeros((6, nbins), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(sums)
    pairs = [(a, b) for a in range(nbi) for b in range(nbj)
             if not triangular or a <= b]
    for a, b in pairs:
        sa = slice(a * block, (a + 1) * block)
        sb = slice(b * block, (b + 1) * block)
        dx = _min_image_1d(xi_[sa][:, None] - xj_[sb][None, :], box)
        dy = _min_image_1d(yi_[sa][:, None] - yj_[sb][None, :], box)
        r2 = dx * dx + dy * dy
        r = torch.sqrt(r2)
        binidx = torch.clamp(torch.searchsorted(edges, r, right=True) - 1,
                             0, nbins - 1)
        mask = (r >= lo) & (r < hi)
        if dedup:
            ia = ia0 + a * block + ar
            jb = jb0 + b * block + ar
            mask = mask & (ia[:, None] < jb[None, :])
        ww = wi[sa][:, None] * wj[sb][None, :]
        mask = mask & (ww != 0.0)
        wwm = torch.where(mask, ww, torch.zeros_like(ww))
        safe = torch.where(r2 == 0.0, torch.ones_like(r2), r2)
        cos2 = (dx * dx - dy * dy) / safe
        sin2 = two * dx * dy / safe
        cos4 = cos2 * cos2 - sin2 * sin2
        sin4 = two * cos2 * sin2
        a1, a2 = e1i[sa][:, None], e2i[sa][:, None]
        b1, b2 = e1j[sb][None, :], e2j[sb][None, :]
        # xi_plus: Re[e_i conj(e_j)]; xi_minus: Re[e_i e_j e^{-4 i phi}]
        pp = a1 * b1 + a2 * b2
        re_ab = a1 * b1 - a2 * b2
        im_ab = a1 * b2 + a2 * b1
        mm = re_ab * cos4 + im_ab * sin4
        # j-side tangential / cross in the pair frame (gamma_t stacking)
        et = -(b1 * cos2 + b2 * sin2)
        ex = -(b2 * cos2 - b1 * sin2)
        flat = torch.where(mask, binidx, nbins).reshape(-1)
        chans = torch.stack([
            (wwm * pp).reshape(-1), (wwm * mm).reshape(-1),
            (wwm * et).reshape(-1), (wwm * ex).reshape(-1),
            wwm.reshape(-1), mask.reshape(-1).to(torch.float32)])
        inc = masked_bin_reduce(chans, flat, nbins, chunk=1 << 22)
        y = inc - comp
        t = sums + y
        comp = (t - sums) - y
        sums = t
    return sums


def _catalog_column(v, dev, block: int):
    return _pad_to_block(as_tensor(v, dev).to(torch.float32).reshape(-1),
                         block)


def xi_pm_catalog(x, y, e1, e2, theta_edges, weights=None, boxsize=None,
                  block: int = 512, device=None):
    """Shear-shear correlation functions of an ellipticity catalog (the
    treecorr GG estimator, O(N^2) blocked tiles):

        xi_+(theta) = sum w w' Re[e conj(e')] / sum w w',
        xi_-(theta) = sum w w' Re[e e' e^{-4 i phi}] / sum w w'.

    Positions and theta_edges share one flat-sky unit; boxsize enables the
    periodic minimum image. Pairs are counted once (i < j). Padding rows
    carry zero weight and drop out. The tiles run where x lies (a tensor's
    device, numpy input on `device`, by default the card); on the card a
    larger `block` than the JAX signature's 512 runs far fewer tile
    launches.

    Returns (xip, xim, npairs), (nbins,) tensors.
    """
    nbins = len(_host(theta_edges)) - 1
    x = as_tensor(x, device)
    dev = x.device
    n = x.shape[0]
    x = _catalog_column(x, dev, block)
    y = _catalog_column(y, dev, block)
    e1 = _catalog_column(e1, dev, block)
    e2 = _catalog_column(e2, dev, block)
    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if weights is None else weights)
    w = _catalog_column(w, dev, block)  # zero fill: padding drops out
    edges = as_tensor(theta_edges, dev).to(torch.float32)
    sums = _shear_pair_tiles(x, y, e1, e2, w, x, y, e1, e2, w, edges,
                             nbins, boxsize, block, True, triangular=True)
    ww = torch.clamp_min(sums[4], 1e-30)
    return sums[0] / ww, sums[1] / ww, sums[5]


def gamma_t_catalog(lens_x, lens_y, src_x, src_y, e1, e2, theta_edges,
                    lens_weights=None, src_weights=None, boxsize=None,
                    block: int = 512, device=None):
    """Stacked tangential shear of a source catalog around a lens catalog
    (the treecorr NG estimator):

        gamma_t(theta) = sum w_l w_s e_t / sum w_l w_s,

    e_t = -Re[e exp(-2 i phi)], phi the lens -> source position angle;
    gamma_x likewise (parity null). Placed as xi_pm_catalog (by lens_x).
    Returns (gamma_t, gamma_x, npairs) per theta bin.
    """
    nbins = len(_host(theta_edges)) - 1
    lens_x = as_tensor(lens_x, device)
    dev = lens_x.device
    nl = lens_x.shape[0]
    ns = as_tensor(src_x, dev).reshape(-1).shape[0]
    lx = _catalog_column(lens_x, dev, block)
    ly = _catalog_column(lens_y, dev, block)
    wl = (torch.ones((nl,), dtype=torch.float32, device=dev)
          if lens_weights is None else lens_weights)
    wl = _catalog_column(wl, dev, block)  # zero fill
    sx = _catalog_column(src_x, dev, block)
    sy = _catalog_column(src_y, dev, block)
    se1 = _catalog_column(e1, dev, block)
    se2 = _catalog_column(e2, dev, block)
    ws = (torch.ones((ns,), dtype=torch.float32, device=dev)
          if src_weights is None else src_weights)
    ws = _catalog_column(ws, dev, block)  # zero fill
    zl = torch.zeros_like(lx)
    edges = as_tensor(theta_edges, dev).to(torch.float32)
    sums = _shear_pair_tiles(lx, ly, zl, zl, wl, sx, sy, se1, se2, ws,
                             edges, nbins, boxsize, block, False)
    ww = torch.clamp_min(sums[4], 1e-30)
    return sums[2] / ww, sums[3] / ww, sums[5]


# ----------------------------------------------------------------- COSEBIs

@lru_cache(maxsize=16)
def _linear_cosebis_tables(nmax: int, theta_min: float, theta_max: float,
                           ntheta: int):
    """Host float64 construction of the linear-COSEBIs filter pair (the
    JAX package's numpy, bit for bit).

    T_+n are polynomials of degree n+1 on x in [-1, 1] (theta mapped
    linearly), orthonormal under Int dx, subject to the two E/B
    separability constraints of Schneider, Eifler & Krause 2010 (A&A 520
    A116, eqs. 9-10): Int dtheta theta T_+ = 0 and Int dtheta theta^3 T_+
    = 0. Built by constrained Gram-Schmidt in the Legendre basis with
    exact Gauss-Legendre integrals. T_-n follows from the finite-interval
    relation (loc. cit. eq. 12)

        T_-(t) = T_+(t) + Int_{tmin}^{t} ds s T_+(s) [4/t^2 - 12 s^2/t^4],

    by cumulative Gauss-Legendre panels on a dense theta grid. Returns
    (theta (ntheta,), Tp (nmax, ntheta), Tm (nmax, ntheta)), float64
    numpy, theta in the unit of theta_min / theta_max.
    """
    if nmax < 1:
        raise ValueError("nmax >= 1")
    if nmax > 12:
        raise ValueError(
            "linear COSEBIs are constructed in float64; beyond n ~ 12 "
            "the Gram-Schmidt loses orthogonality — raise only with a "
            "higher-precision construction")
    from numpy.polynomial import legendre as L

    tbar = 0.5 * (theta_max + theta_min)
    dt = 0.5 * (theta_max - theta_min)

    deg_max = nmax + 1
    # Gauss-Legendre nodes exact for polynomials up to degree 2*deg_max+6
    nn = 2 * deg_max + 8
    xg, wg = np.polynomial.legendre.leggauss(nn)
    theta_g = tbar + dt * xg

    def poly_vals(c):
        return L.legval(xg, c)

    def inner(c1, c2, weight=None):
        v = poly_vals(c1) * poly_vals(c2)
        if weight is not None:
            v = v * weight
        return float(np.sum(wg * v))

    w1 = theta_g            # constraint weights (Jacobian dt absorbed
    w3 = theta_g ** 3       # into the normalization-free constraints)

    basis = []
    for m in range(deg_max + 1):
        c = np.zeros(deg_max + 1)
        c[m] = 1.0
        basis.append(c)

    filters = []
    for nid in range(1, nmax + 1):
        deg = nid + 1
        nc = deg + 1
        rows = []
        rhs = []
        # two separability constraints
        for wgt in (w1, w3):
            rows.append([float(np.sum(wg * L.legval(xg, basis[m]) * wgt))
                         for m in range(nc)])
            rhs.append(0.0)
        # orthogonality to previous filters
        for prev in filters:
            rows.append([inner(basis[m], prev[0]) for m in range(nc)])
            rhs.append(0.0)
        # fix the leading coefficient, normalize afterwards
        lead = np.zeros(nc)
        lead[deg] = 1.0
        rows.append(list(lead))
        rhs.append(1.0)
        A = np.asarray(rows, np.float64)
        b = np.asarray(rhs, np.float64)
        coef, *_ = np.linalg.lstsq(A, b, rcond=None)
        cfull = np.zeros(deg_max + 1)
        cfull[:nc] = coef
        nrm = np.sqrt(inner(cfull, cfull))
        cfull /= nrm
        filters.append((cfull,))

    # dense theta grid for the T_- integral and the returned tables
    theta = np.linspace(theta_min, theta_max, ntheta)
    x = (theta - tbar) / dt
    Tp = np.stack([L.legval(x, f[0]) for f in filters])

    # I1(t) = Int s T_+ ds and I3(t) = Int s^3 T_+ ds by per-interval
    # Gauss-Legendre (exact: the integrands are polynomials)
    xg2, wg2 = np.polynomial.legendre.leggauss(deg_max + 4)
    Tm = np.empty_like(Tp)
    for i, f in enumerate(filters):
        I1 = np.zeros(ntheta)
        I3 = np.zeros(ntheta)
        acc1 = 0.0
        acc3 = 0.0
        for j in range(1, ntheta):
            a, b2 = theta[j - 1], theta[j]
            mid, half = 0.5 * (a + b2), 0.5 * (b2 - a)
            sg = mid + half * xg2
            tv = L.legval((sg - tbar) / dt, f[0])
            acc1 += half * np.sum(wg2 * sg * tv)
            acc3 += half * np.sum(wg2 * sg ** 3 * tv)
            I1[j] = acc1
            I3[j] = acc3
        Tm[i] = Tp[i] + 4.0 * I1 / theta ** 2 - 12.0 * I3 / theta ** 4
    return theta, Tp, Tm


def linear_cosebis_filters(nmax: int, theta_min: float, theta_max: float,
                           ntheta: int = 4096):
    """The (theta, T_+n, T_-n) linear-COSEBIs filter tables (float64 host
    arrays; see _linear_cosebis_tables)."""
    return _linear_cosebis_tables(int(nmax), float(theta_min),
                                  float(theta_max), int(ntheta))


def cosebis_from_xipm(theta, xip, xim, nmax: int, theta_min: float,
                      theta_max: float, ntheta: int = 4096, device=None):
    """COSEBIs E/B modes from measured correlation functions:

        E_n = 1/2 Int dtheta theta [ T_+n xi_+ + T_-n xi_- ],
        B_n = 1/2 Int dtheta theta [ T_+n xi_+ - T_-n xi_- ].

    xi_pm are linearly interpolated in log theta onto the filter grid
    (theta must cover [theta_min, theta_max]). The two filter integrals
    are float32 elementwise products and sums, never a matrix product, so
    a caller's TF32 setting cannot swamp the B-mode cancellation (the JAX
    package contracts at Precision.HIGHEST for the same reason). Runs on
    xip's device (numpy input: `device`, by default the card). Returns
    (E (nmax,), B (nmax,)) tensors.
    """
    tg, Tp, Tm = _linear_cosebis_tables(int(nmax), float(theta_min),
                                        float(theta_max), int(ntheta))
    theta = _host(theta)
    if theta[0] > theta_min * (1 + 1e-9) or theta[-1] < theta_max * (1 - 1e-9):
        raise ValueError(
            f"xi_pm tables cover [{theta[0]:.4g}, {theta[-1]:.4g}] but the "
            f"COSEBIs interval is [{theta_min}, {theta_max}]")
    xip = as_tensor(xip, device).to(torch.float32).reshape(-1)
    dev = xip.device
    xim = as_tensor(xim, dev).to(torch.float32).reshape(-1)

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    lt = dev32(np.log(theta))
    ltg = dev32(np.log(tg))
    xp = _interp(ltg, lt, xip)
    xm = _interp(ltg, lt, xim)
    w = dev32(_trap_weights(tg) * tg)
    tp_int = (dev32(Tp) * (w * xp)).sum(-1)
    tm_int = (dev32(Tm) * (w * xm)).sum(-1)
    e_n = 0.5 * (tp_int + tm_int)
    b_n = 0.5 * (tp_int - tm_int)
    return e_n, b_n


def _trap_weights(x):
    w = np.empty_like(x)
    w[1:-1] = 0.5 * (x[2:] - x[:-2])
    w[0] = 0.5 * (x[1] - x[0])
    w[-1] = 0.5 * (x[-1] - x[-2])
    return w


def cosebis_from_cl(ells, cl_e, nmax: int, theta_min: float,
                    theta_max: float, cl_b=None, ntheta: int = 4096,
                    n_fftlog: int = 2048):
    """Theory COSEBIs from power spectra through the harmonic filters
    W_n(l) = Int dtheta theta T_+n(theta) J_0(l theta):

        E_n = (1/2pi) Int dl l C_EE(l) W_n(l)   (B_n likewise from C_BB).

    Host float64 numpy (trapezoids over the filter table with scipy's J0),
    as in the JAX package. Returns (E (nmax,), B (nmax,)) numpy arrays.
    """
    from scipy.special import jv

    tg, Tp, _ = _linear_cosebis_tables(int(nmax), float(theta_min),
                                       float(theta_max), int(ntheta))
    ells = _host(ells)
    wtheta = _trap_weights(tg) * tg
    # W (nmax, nell): sum_theta wtheta T_+n J0(l theta)
    j0 = jv(0, ells[None, :] * tg[:, None])  # (ntheta, nell)
    W = Tp @ (wtheta[:, None] * j0)
    wl = _trap_weights(ells) * ells
    e_n = (W * (wl * _host(cl_e))[None, :]).sum(1) / (2.0 * np.pi)
    if cl_b is None:
        b_n = np.zeros(int(nmax))
    else:
        b_n = (W * (wl * _host(cl_b))[None, :]).sum(1) / (2.0 * np.pi)
    return e_n, b_n
