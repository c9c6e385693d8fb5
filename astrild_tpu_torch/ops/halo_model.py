"""Halo-model nonlinear matter power: P(k) = P_1h + P_2h.

Port of astrild_tpu/ops/halo_model.py. The halo model composes the mass
function (ops/halo_stats.theory_hmf), Sheth-Tormen bias, the Duffy+08
c(M) and the NFW Fourier profile into a nonlinear P(k):

  P_1h(k) = Int dlnM  n(lnM) (M/rho_m)^2 |u(k|M)|^2
  P_2h(k) = [Int dlnM n(lnM) (M/rho_m) b(M) u(k|M) + A]^2 P_lin(k)

with A = 1 - Int n b M/rho_m dlnM, the large-scale consistency term
(unresolved low-mass halos are point sources, so P_2h -> P_lin as
k -> 0). All integrals are fixed log-grid quadratures; u(k|M) is a
log-radius midpoint quadrature normalized by the same quadrature of the
profile. Halo definition: 200 x the comoving mean matter density.

The spectra compute in float64 on k's device (a tensor's own; numpy k
goes to `device`, by default the CUDA card, raising without one; a traced
cosmology's device wins, and takes numpy k too), and the cosmology and
the HOD parameters may be tensors: a Fisher Jacobian (ops/forecast.py)
runs through them. `nfw_delta_sigma` is float32, as the JAX package's.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor, as_theory_tensor, default_device
from ..utils.constants import RHO_CRIT0
from ..utils.cosmology import Cosmology
from .halo_stats import DELTA_C  # same threshold as the mass function

__all__ = ["nfw_u", "sheth_tormen_bias", "duffy_concentration",
           "halo_model_power", "hod_galaxy_power",
           "hod_galaxy_matter_power", "delta_sigma_hod", "nfw_delta_sigma"]


def duffy_concentration(m200m, z: float = 0.0):
    """Duffy et al. 2008 (arxiv:0804.2486, Table 1, full sample, 200-mean):
    c = 10.14 (M / 2e12 Msun/h)^-0.081 (1+z)^-1.01."""
    return 10.14 * (m200m / 2.0e12) ** -0.081 * (1.0 + z) ** -1.01


def sheth_tormen_bias(nu, a: float = 0.707, p: float = 0.3):
    """Sheth-Tormen 1999 peak-background-split bias b(nu), nu =
    delta_c/sigma."""
    anu2 = a * nu ** 2
    return (1.0 + (anu2 - 1.0) / DELTA_C
            + 2.0 * p / (DELTA_C * (1.0 + anu2 ** p)))


def nfw_u(k, c, r_vir, nr: int = 256, device=None):
    """Normalized NFW Fourier profile u(k|M) (-> 1 as k -> 0).

    u(k) = Int_0^c dx x/(1+x)^2 sinc(k r_s x) / [ln(1+c) - c/(1+c)],
    by a midpoint quadrature in ln x (x = r/r_s), normalized by the same
    quadrature of the profile, so that u(k -> 0) == 1 exactly.

    Args:
      k: (nk,) wavenumbers [h/Mpc].
      c, r_vir: (nm,) concentrations and halo radii [Mpc/h].
    Returns (nm, nk), in the dtype the three promote to, on k's device.
    """
    k = as_theory_tensor(k, device)
    c = as_theory_tensor(c, k.device).reshape(-1)
    r_vir = as_theory_tensor(r_vir, k.device).reshape(-1)
    dt = torch.promote_types(torch.promote_types(k.dtype, c.dtype),
                             r_vir.dtype)
    edges = np.linspace(np.log(1e-4), 0.0, nr + 1)  # x/c in e^lx
    lx = torch.as_tensor(0.5 * (edges[:-1] + edges[1:]), dtype=dt,
                         device=k.device)
    dlx = float(edges[1] - edges[0])
    rs = (r_vir / c)[:, None, None]
    x = torch.exp(lx)[None, None, :] * c[:, None, None]   # (nm, 1, nr)
    arg = k[None, :, None] * rs * x                       # (nm, nk, nr)
    # both branches see a safe argument: a NaN in the branch not taken
    # would still turn a derivative to NaN
    sinc = torch.where(arg < 1e-4, 1.0 - arg ** 2 / 6.0,
                       torch.sin(arg) / torch.clamp_min(arg, 1e-12))
    profile = x ** 2 / (1.0 + x) ** 2  # (dx x/(1+x)^2) in dlnx
    integral = torch.sum(profile * sinc, dim=-1) * dlx
    mass_norm = torch.sum(profile, dim=-1) * dlx
    return integral / mass_norm


def _k_of(k_hmpc, cosmo: Cosmology, device):
    """k as a float64 tensor where the halo model computes: a traced
    cosmology's device, else k's own (numpy k to `device`, by default the
    CUDA card)."""
    if isinstance(k_hmpc, torch.Tensor):
        k = k_hmpc.to(torch.float64)
    else:
        k = torch.as_tensor(np.asarray(k_hmpc, np.float64),
                            device=cosmo.device if cosmo.traced
                            else default_device(device))
    return k.to(cosmo.device) if cosmo.traced else k


def _halo_ingredients(k, cosmo: Cosmology, z: float, mmin: float,
                      mmax: float, nm: int, model: str, amplitude):
    """The shared halo-model ingredients: mass grid, dn/dlnM,
    Sheth-Tormen bias and NFW u(k|M). Their one home, so P_mm, P_gg and
    P_gm keep one mass function, bias and concentration, all on the SAME
    amplitude (the a_corr consistency term depends on it). Returns (m,
    dlnm, n_lnm, bias, u, rho_m)."""
    from .halo_stats import theory_hmf
    from .linear_power import _scalar, sigma_r

    rho_m = cosmo.Om0 * RHO_CRIT0  # comoving (Msun/h)/(Mpc/h)^3
    lnm = torch.linspace(math.log(mmin), math.log(mmax), nm,
                         dtype=torch.float64, device=k.device)
    m = torch.exp(lnm)
    dlnm = lnm[1] - lnm[0]
    n_lnm = theory_hmf(m, cosmo, z=z, model=model,
                       amplitude=amplitude)  # dn/dlnM
    r_lag = (3.0 * m / (4.0 * math.pi * rho_m)) ** (1.0 / 3.0)
    growth = _scalar(cosmo.growth_factor(z))
    sig = sigma_r(r_lag, cosmo, amplitude=amplitude) * growth
    bias = sheth_tormen_bias(DELTA_C / sig)
    r_vir = (3.0 * m / (4.0 * math.pi * 200.0 * rho_m)) ** (1.0 / 3.0)
    u = nfw_u(k, duffy_concentration(m, z=z), r_vir)  # (nm, nk)
    return m, dlnm, n_lnm, bias, u, rho_m


def halo_model_power(k_hmpc, cosmo: Cosmology, z: float = 0.0,
                     mmin: float = 1e8, mmax: float = 1e16, nm: int = 64,
                     model: str = "st", amplitude=None, device=None):
    """Halo-model P(k) [(Mpc/h)^3]; returns (p_1h, p_2h, p_total), float64.

    model: multiplicity function of the mass integrals ('st' | 'tinker08'
    | 'ps', see halo_stats.theory_hmf). Bias is Sheth-Tormen (the
    consistency term A absorbs the mismatch at large scales).
    """
    from .linear_power import linear_power, normalization

    k = _k_of(k_hmpc, cosmo, device)
    if amplitude is None:
        amplitude = normalization(cosmo)
    m, dlnm, n_lnm, bias, u, rho_m = _halo_ingredients(
        k, cosmo, z, mmin, mmax, nm, model, amplitude)
    w = n_lnm * m / rho_m * dlnm  # mass-fraction weights per lnM node
    p_1h = torch.sum((w * m / rho_m)[:, None] * u ** 2, dim=0)
    i_2h = torch.sum((w * bias)[:, None] * u, dim=0)
    a_corr = 1.0 - torch.sum(w * bias)  # unresolved halos, u -> 1
    p_2h = (i_2h + a_corr) ** 2 * linear_power(k, cosmo, z=z,
                                               amplitude=amplitude)
    return p_1h, p_2h, p_1h + p_2h


def _hod_terms(k_hmpc, cosmo, hod_params, z, mmin, mmax, nm, model,
               amplitude, device):
    """What the HOD spectra share: (k, ingredients, n_cen, n_sat, the
    number weights n dlnM, n_g, the k-dependent galaxy bias b_gal(k), the
    k -> 0 bias b_g, P_lin)."""
    from .hod import HODParams, zheng07_mean_occupation
    from .linear_power import linear_power, normalization

    if hod_params is None:
        hod_params = HODParams()
    k = _k_of(k_hmpc, cosmo, device)
    if amplitude is None:
        amplitude = normalization(cosmo)
    ing = _halo_ingredients(k, cosmo, z, mmin, mmax, nm, model, amplitude)
    m, dlnm, n_lnm, bias, u, _ = ing
    n_cen, n_sat = zheng07_mean_occupation(m, hod_params)
    wg = n_lnm * dlnm
    n_g = torch.sum(wg * (n_cen + n_sat))
    b_gal = torch.sum((wg * bias)[:, None]
                      * (n_cen[:, None] + n_sat[:, None] * u), dim=0) / n_g
    b_g = torch.sum(wg * bias * (n_cen + n_sat)) / n_g
    p_lin = linear_power(k, cosmo, z=z, amplitude=amplitude)
    return k, ing, n_cen, n_sat, wg, n_g, b_gal, b_g, p_lin


def hod_galaxy_power(k_hmpc, cosmo: Cosmology, hod_params=None,
                     z: float = 0.0, mmin: float = 1e10,
                     mmax: float = 1e16, nm: int = 64, model: str = "st",
                     amplitude=None, device=None):
    """Halo-model GALAXY power spectrum for a Zheng+07 HOD:

      n_g      = Int dlnM n (N_cen + N_sat)
      P_1h(k)  = (1/n_g^2) Int dlnM n [2 N_cen N_sat u + N_sat^2 u^2]
      P_2h(k)  = b_eff(k)^2 P_lin,
      b_eff(k) = (1/n_g) Int dlnM n b(M) (N_cen + N_sat u(k|M))

    (Poisson satellites; centrals at the halo centre, u_cen = 1).
    Returns (p_1h, p_2h, p_total, n_g, b_g), b_g the k -> 0 bias.
    """
    _, (_, _, _, _, u, _), n_cen, n_sat, wg, n_g, b_eff, b_g, p_lin = \
        _hod_terms(k_hmpc, cosmo, hod_params, z, mmin, mmax, nm, model,
                   amplitude, device)
    p_1h = torch.sum(wg[:, None] * (2.0 * (n_cen * n_sat)[:, None] * u
                                    + (n_sat ** 2)[:, None] * u ** 2),
                     dim=0) / n_g ** 2
    p_2h = b_eff ** 2 * p_lin
    return p_1h, p_2h, p_1h + p_2h, n_g, b_g


def hod_galaxy_matter_power(k_hmpc, cosmo: Cosmology, hod_params=None,
                            z: float = 0.0, mmin: float = 1e10,
                            mmax: float = 1e16, nm: int = 64,
                            model: str = "st", amplitude=None, device=None):
    """Halo-model GALAXY-MATTER cross power P_gm(k) for a Zheng+07 HOD,
    the 3D ingredient of galaxy-galaxy lensing:

      P_1h(k) = (1/(n_g rho_m)) Int dlnM n M [N_cen u + N_sat u^2]
      P_2h(k) = b_g(k) [i_2h(k) + a_corr] P_lin,

    with b_g(k) the occupation-weighted bias of `hod_galaxy_power` and
    (i_2h + a_corr) the consistency-corrected matter factor of
    `halo_model_power`. Returns (p_1h, p_2h, p_total, n_g, b_g).
    """
    _, (m, dlnm, n_lnm, bias, u, rho_m), n_cen, n_sat, _, n_g, b_gal, b_g, \
        p_lin = _hod_terms(k_hmpc, cosmo, hod_params, z, mmin, mmax, nm,
                           model, amplitude, device)
    wm = n_lnm * m / rho_m * dlnm  # matter mass-fraction weights
    p_1h = torch.sum(wm[:, None] * (n_cen[:, None] * u
                                    + n_sat[:, None] * u ** 2),
                     dim=0) / n_g
    i_2h = torch.sum((wm * bias)[:, None] * u, dim=0)
    a_corr = 1.0 - torch.sum(wm * bias)
    p_2h = b_gal * (i_2h + a_corr) * p_lin
    return p_1h, p_2h, p_1h + p_2h, n_g, b_g


def delta_sigma_hod(rp, cosmo: Cosmology, hod_params=None, z: float = 0.0,
                    nk: int = 512, kmin: float = 1e-3, kmax: float = 1e3,
                    device=None, **hm_kwargs):
    """Theory galaxy-galaxy-lensing excess surface density of an HOD:
    halo-model P_gm on a host log-k grid -> J2 FFTLog
    (shear_2pt.delta_sigma_from_pk), in float64. Differentiable in the
    cosmology and HOD parameters. Returns Delta Sigma(rp) in h Msun/pc^2
    (comoving)."""
    from .shear_2pt import delta_sigma_from_pk

    k = np.geomspace(kmin, kmax, nk)
    _, _, p_gm, _, _ = hod_galaxy_matter_power(
        k, cosmo, hod_params, z=z, device=device, **hm_kwargs)
    rp = rp if isinstance(rp, torch.Tensor) else torch.as_tensor(
        np.asarray(rp, np.float64), device=p_gm.device)
    return delta_sigma_from_pk(k, p_gm, rp, cosmo.Om0)


def nfw_delta_sigma(r_hmpc, m200m, c, z: float = 0.0,
                    omega_m: float = 0.3089, device=None):
    """Closed-form NFW excess surface density Delta Sigma(R) (Wright &
    Brainerd 2000, ApJ 534, 34, eqs. 13-16), float32.

    m200m is M_200 w.r.t. 200x the COMOVING mean matter density, c =
    r200/r_s; untruncated NFW. z enters only through the comoving mean
    density, i.e. not at all in comoving units (kept for API symmetry).
    r_hmpc: (n,) projected radii [Mpc/h, comoving]; a tensor keeps its
    device, numpy goes to `device` (default the CUDA card). Returns
    Delta Sigma(R) in h Msun / pc^2 (comoving).
    """
    r = as_tensor(r_hmpc, device).to(torch.float32)
    dev = r.device
    rho_m = omega_m * RHO_CRIT0  # (Msun/h)/(Mpc/h)^3 comoving
    m200m = torch.as_tensor(m200m, dtype=torch.float32, device=dev)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    r200 = (3.0 * m200m / (4.0 * math.pi * 200.0 * rho_m)) ** (1.0 / 3.0)
    r_s = r200 / c
    delta_c = (200.0 / 3.0) * c ** 3 / (torch.log1p(c) - c / (1.0 + c))
    x = r / r_s
    # branch-safe arguments: the closed forms cancel in float32 within ~1%
    # of x = 1, where a host float64 polynomial fit serves |x - 1| < 0.02;
    # every branch is clamped, so none of them NaNs a derivative
    xlt = torch.clamp(x, 1e-6, 1.0 - 1e-2)
    xgt = torch.clamp_min(x, 1.0 + 1e-2)
    ath = torch.atanh(torch.sqrt((1.0 - xlt) / (1.0 + xlt)))
    atn = torch.atan(torch.sqrt((xgt - 1.0) / (1.0 + xgt)))
    s_lt = torch.sqrt(1.0 - xlt ** 2)
    s_gt = torch.sqrt(xgt ** 2 - 1.0)
    g_lt = (8.0 * ath / (xlt ** 2 * s_lt)
            + 4.0 / xlt ** 2 * torch.log(xlt / 2.0)
            - 2.0 / (xlt ** 2 - 1.0)
            + 4.0 * ath / ((xlt ** 2 - 1.0) * s_lt))
    g_gt = (8.0 * atn / (xgt ** 2 * s_gt)
            + 4.0 / xgt ** 2 * torch.log(xgt / 2.0)
            - 2.0 / (xgt ** 2 - 1.0)
            + 4.0 * atn / (xgt ** 2 - 1.0) ** 1.5)
    t = torch.clamp(x - 1.0, -0.02, 0.02)
    g_near = torch.zeros_like(t)  # jnp.polyval: Horner from zero
    for coef in _wb_near1_coeffs().astype(np.float32):
        g_near = g_near * t + float(coef)
    g = torch.where(x < 1.0 - 0.02, g_lt,
                    torch.where(x > 1.0 + 0.02, g_gt, g_near))
    sigma_fac = r_s * delta_c * rho_m * 1e-12  # -> h Msun / pc^2
    return sigma_fac * g


@lru_cache(maxsize=4)
def _wb_near1_coeffs(deg: int = 6, half: float = 0.06):
    """Host-f64 polynomial fit of the WB00 g(x) around x = 1 (the f32
    closed forms cancel catastrophically there), the JAX package's numpy
    bit for bit. Fit nodes exclude the f64-noisy core |x-1| < 1e-5;
    interpolation error over |x-1| <= 0.02 is < 1e-9. Cached as numpy."""
    t = np.concatenate([np.linspace(-half, -1e-5, 400),
                        np.linspace(1e-5, half, 400)])
    xx = 1.0 + t
    lt = xx < 1.0
    g = np.empty_like(xx)
    xl = xx[lt]
    athl = np.arctanh(np.sqrt((1 - xl) / (1 + xl)))
    sl = np.sqrt(1 - xl ** 2)
    g[lt] = (8 * athl / (xl ** 2 * sl) + 4 / xl ** 2 * np.log(xl / 2)
             - 2 / (xl ** 2 - 1) + 4 * athl / ((xl ** 2 - 1) * sl))
    xg = xx[~lt]
    atng = np.arctan(np.sqrt((xg - 1) / (1 + xg)))
    sg = np.sqrt(xg ** 2 - 1)
    g[~lt] = (8 * atng / (xg ** 2 * sg) + 4 / xg ** 2 * np.log(xg / 2)
              - 2 / (xg ** 2 - 1) + 4 * atng / (xg ** 2 - 1) ** 1.5)
    return np.polyfit(t, g, deg)
