"""Sunyaev-Zel'dovich observables from halos on torch tensors: NFW optical
depth, kSZ temperature patches, GNFW (Arnaud+10) Compton-y, stacked
aperture photometry, and the halo-model tSZ angular power.

Port of astrild_tpu/ops/sz.py, whole. Each patch function takes scalar
halo parameters, as the JAX package's jitted functions do, and runs them
in float32; the `_*_stack` helpers compute the same patches for (nh,)
parameter tensors at once, element for element as the scalar call, which
is how `SkyArray.from_halo_dataframe` builds a canvas. The JAX package's
jitted linspace of the patch edges is `profiles._linspace_jit_f32`, and
the line-of-sight sum of `compton_y_patch` runs in its scan's order.
Scalars and numpy input run on the device of a tensor among them, else on
`device`, by default the CUDA card (it raises without one); tensors keep
their device.

Conventions: masses Msun and lengths Mpc PHYSICAL (divide h-unit catalog
columns by h first), velocities km/s, temperatures Kelvin.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .._device import as_tensor
from ..utils.constants import (C_LIGHT_KMS, M_PROTON_MSUN, SIGMA_T_MPC2,
                               T_CMB)
from .lensing import _halo_tensors
from .profiles import _linspace_jit_f32

__all__ = ["nfw_sigma_map", "nfw_tau_map", "ksz_patch", "ksz_patch_from_halo",
           "gnfw_pressure", "compton_y_patch", "GNFW_ARNAUD10",
           "stacked_aperture_photometry", "m500c_from_m200m", "y_ell",
           "cl_yy"]

# Arnaud et al. 2010 (arXiv:0910.1234) universal pressure profile,
# Eq. 12 best-fit parameters (h70 = 1): [P0, c500, gamma, alpha, beta]
GNFW_ARNAUD10 = (8.403, 1.177, 0.3081, 1.0510, 5.4905)

# sigma_T/(m_e c^2) with P_e in keV/cm^3 and path length in Mpc:
# 6.6524587e-25 cm^2 / 511 keV * 3.0857e24 cm/Mpc, in one place (y_ell and
# compton_y_patch use the same number)
_Y_PREFAC = 6.6524587158e-25 / 511.0 * 3.0856775814913673e24


def _nfw_sigma_f(x):
    """Wright & Brainerd 2000 projected-NFW shape, Sigma = 2 rho_s r_s f(x):

    f(x<1) = (1 - 2 artanh(sqrt((1-x)/(1+x)))/sqrt(1-x^2)) / (x^2-1)
    f(1)   = 1/3
    f(x>1) = (1 - 2 arctan(sqrt((x-1)/(x+1)))/sqrt(x^2-1)) / (x^2-1)

    Branches are clipped before evaluation, so no NaN leaks through the
    selection; the divisions by the square roots are products by rsqrt, as
    XLA compiles the JAX package's form."""
    x = torch.abs(x)
    xs = torch.clamp_min(x, 1e-8)
    lo = x < 0.999
    hi = x > 1.001
    x_lo = torch.clamp(x, 1e-8, 0.999)
    f_lo = ((1.0 - 2.0 * torch.atanh(torch.sqrt((1.0 - x_lo) / (x_lo + 1.0)))
             * torch.rsqrt((1.0 - x_lo) * (x_lo + 1.0)))
            / (x_lo * x_lo - 1.0))
    x_hi = torch.clamp_min(xs, 1.001)
    f_hi = ((1.0 - 2.0 * torch.atan(torch.sqrt((x_hi - 1.0) / (x_hi + 1.0)))
             * torch.rsqrt((x_hi - 1.0) * (x_hi + 1.0)))
            / (x_hi * x_hi - 1.0))
    third = torch.full_like(x, float(np.float32(1.0 / 3.0)))
    return torch.where(lo, f_lo, torch.where(hi, f_hi, third))


def _centered_offsets(half, npix: int):
    """linspace(-half, half, npix) per row of `half` (jitted float32 form),
    and r = |(t_x, t_y)| on the (nh, npix, npix) grid."""
    t = _linspace_jit_f32(-half, half, npix, half.device)
    t2 = t * t
    return torch.sqrt(t2[:, None, :] + t2[:, :, None])


def _nfw_sigma_stack(m, c, r200, npix: int, extent):
    """`nfw_sigma_map` of (nh,) float32 halos: (nh, npix, npix)."""
    r_s = r200 / c
    c3 = c * c * c
    rho_s = m * c3 / (4.0 * math.pi * (r200 * r200 * r200)
                      * (torch.log(c + 1.0) - c / (c + 1.0)))
    r = _centered_offsets(extent * r200, npix)
    pix = 2.0 * extent * r200 / npix
    x = (torch.maximum(r, (0.1 * pix)[:, None, None])
         / r_s[:, None, None])
    return (2.0 * rho_s * r_s)[:, None, None] * _nfw_sigma_f(x)


def nfw_sigma_map(m200c, c200c, r200c, npix: int = 128, extent: float = 1.0,
                  device=None):
    """Projected NFW surface mass density patch [Msun/Mpc^2].

    The patch spans +-extent*r200c; the central pixel's log divergence is
    clipped to the value one tenth of a pixel off center.

    Args:
      m200c: mass [Msun, physical].
      c200c: concentration; r200c: radius [Mpc, physical].
    """
    m, c, r, ext = _halo_tensors(m200c, c200c, r200c, extent, device=device)
    return _nfw_sigma_stack(m, c, r, npix, ext)[0]


def _tau_factor(f_gas: float, mu_e: float) -> float:
    # sigma_T and m_p each underflow float32 (1e-74 / 1e-58 in Mpc^2 /
    # Msun); their ratio (~8.3e-17) does not: combine in Python float64
    # before any tensor math
    sigma_t_over_mp = SIGMA_T_MPC2 / M_PROTON_MSUN
    return (sigma_t_over_mp / mu_e) * f_gas


def nfw_tau_map(m200c, c200c, r200c, npix: int = 128, extent: float = 1.0,
                f_gas: float = 0.156, mu_e: float = 1.14, device=None):
    """Thomson optical depth patch tau(theta) of an NFW gas halo:
    tau = sigma_T * f_gas * Sigma / (mu_e m_p), the gas following the NFW
    mass profile with baryon fraction f_gas and mu_e m_p mass per
    electron. Inputs PHYSICAL (Msun, Mpc), as in `nfw_sigma_map`."""
    return _tau_factor(f_gas, mu_e) * nfw_sigma_map(
        m200c, c200c, r200c, npix=npix, extent=extent, device=device)


def ksz_patch(tau_map, v_los):
    """Kinetic SZ temperature patch [K]: dT = -T_cmb tau v_los/c.

    Positive v_los = receding (away from the observer) gives a CMB
    decrement, the standard kSZ sign (e.g. Hand+12)."""
    return -T_CMB * tau_map * v_los / C_LIGHT_KMS


def _ksz_stack(m, c, r200, v_los, npix: int, extent, f_gas: float = 0.156,
               mu_e: float = 1.14):
    """`ksz_patch_from_halo` of (nh,) float32 halos: (nh, npix, npix)."""
    tau = _tau_factor(f_gas, mu_e) * _nfw_sigma_stack(m, c, r200, npix,
                                                      extent)
    return ksz_patch(tau, v_los[:, None, None])


def ksz_patch_from_halo(m200c, c200c, r200c, v_los, npix: int = 128,
                        extent: float = 1.0, f_gas: float = 0.156,
                        mu_e: float = 1.14, device=None):
    """kSZ patch directly from halo parameters (tau from nfw_tau_map);
    physical units (Msun, Mpc) as in nfw_tau_map."""
    m, c, r, v, ext = _halo_tensors(m200c, c200c, r200c, v_los, extent,
                                    device=device)
    return _ksz_stack(m, c, r, v, npix, ext, f_gas, mu_e)[0]


def gnfw_pressure(x, params: Tuple[float, ...] = GNFW_ARNAUD10):
    """Dimensionless GNFW pressure shape P(x), x = r/R500 (Arnaud+10
    Eq. 11)."""
    p0, c500, gamma, alpha, beta = params
    cx = torch.clamp_min(c500 * x, 1e-8)
    return p0 / (cx ** gamma * (1.0 + cx ** alpha) ** ((beta - gamma)
                                                       / alpha))


def _compton_y_stack(m500, r500, e_z, npix: int, extent, n_los: int = 128,
                     los_extent=5.0, h70: float = 0.968,
                     params: Tuple[float, ...] = GNFW_ARNAUD10):
    """`compton_y_patch` of (nh,) float32 halos: (nh, npix, npix)."""
    p500_amp = (1.65e-3 * e_z ** (8.0 / 3.0)
                * (m500 / (3.0e14 / h70)) ** (2.0 / 3.0) * h70 ** 2)
    rperp2 = _centered_offsets(extent * r500, npix) ** 2
    l = _linspace_jit_f32(-los_extent * r500, los_extent * r500, n_los,
                          r500.device)                     # (nh, n_los)
    dl = l[:, 1] - l[:, 0]
    r5 = r500[:, None, None]
    acc = torch.zeros_like(rperp2)
    # the JAX package's scan over the line of sight, in its order
    for j in range(n_los):
        li = l[:, j, None, None]
        acc = acc + gnfw_pressure(torch.sqrt(rperp2 + li * li) / r5, params)
    return (_Y_PREFAC * p500_amp)[:, None, None] * acc * dl[:, None, None]


def compton_y_patch(m500, r500, e_z, npix: int = 128, extent: float = 2.0,
                    n_los: int = 128, los_extent: float = 5.0,
                    h70: float = 0.968,
                    params: Tuple[float, ...] = GNFW_ARNAUD10, device=None):
    """Thermal SZ Compton-y patch from the Arnaud+10 universal profile.

    P_e(r) = 1.65e-3 E(z)^(8/3) [M500/(3e14/h70 Msun)]^(2/3) P(x) h70^2
             keV cm^-3                                  (Arnaud+10 Eq. 13)
    y(R)   = sigma_T/(m_e c^2) * integral P_e dl  (a Riemann sum over
             +-los_extent*R500 on n_los points, summed in order).

    Args:
      m500: mass [Msun] (PHYSICAL, no h).
      r500: radius [Mpc] (physical).
      e_z: E(z) = H(z)/H0.
      extent: patch half-width in units of R500.
    Returns (npix, npix) dimensionless y.
    """
    m, r, ez, ext, los = _halo_tensors(m500, r500, e_z, extent, los_extent,
                                       device=device)
    return _compton_y_stack(m, r, ez, npix, ext, n_los, los, h70,
                            params)[0]


def stacked_aperture_photometry(img, centers_pix, opening_angle_deg,
                                alpha_arcmin, patch_half: int,
                                weights=None, device=None):
    """Stacked disk-minus-ring aperture photometry at object positions
    (Hand+12 Sec. 2; Schaan+16): for each object, AP = mean(disk r <=
    alpha) - mean(ring alpha < r <= sqrt(2) alpha), which nulls any
    constant background.

    Args:
      img: (n, n) temperature / y map.
      centers_pix: (nobj, 2) integer pixel centers (row, col); patches are
        clamped at map borders.
      opening_angle_deg: map field of view [deg].
      alpha_arcmin: aperture radius [arcmin].
      patch_half: half-size of the cutout in pixels (must exceed
        sqrt(2) alpha in pixels).
      weights: optional per-object stack weights.

    Returns (ap_values (nobj,), stacked 0-d tensor).
    """
    from .map_transform import object_cutouts

    img = as_tensor(img, device)
    dev = img.device
    n = img.shape[-1]
    pix_per_deg = n / opening_angle_deg
    alpha_pix = torch.tensor(alpha_arcmin / 60.0 * pix_per_deg,
                             dtype=torch.float32, device=dev)
    p = 2 * patch_half + 1
    e = torch.arange(p, device=dev).to(torch.float32) - patch_half
    dist = torch.sqrt(e[:, None] ** 2 + e[None, :] ** 2)
    disk = dist <= alpha_pix
    ring = (dist > alpha_pix) & (dist <= alpha_pix * torch.sqrt(
        torch.tensor(2.0, device=dev)))
    patches = object_cutouts(img, as_tensor(centers_pix, dev).to(
        torch.int32), patch_half)
    zero = torch.zeros((), dtype=img.dtype, device=dev)
    dmean = (torch.where(disk, patches, zero).sum(dim=(-2, -1))
             / torch.clamp_min(disk.sum(), 1).to(img.dtype))
    rmean = (torch.where(ring, patches, zero).sum(dim=(-2, -1))
             / torch.clamp_min(ring.sum(), 1).to(img.dtype))
    ap = dmean - rmean
    if weights is None:
        stack = ap.mean()
    else:
        w = as_tensor(weights, dev)
        stack = (ap * w).sum() / torch.clamp_min(w.sum(), 1e-30)
    return ap, stack


# -------------------------------------------------------- tSZ angular power
def m500c_from_m200m(m200m, z, cosmo, conc=None, n_iter: int = 60,
                     device=None):
    """NFW rescaling M200m -> (M500c, r500c_physical).

    m200m in Msun/h (the theory_hmf convention, 200 x mean COMOVING
    density); returns m500c [Msun/h] and the PHYSICAL r500c [Mpc/h], both
    float32. Solves mu(r/rs)/mu(c) M200m = (4/3) pi 500 rho_crit(z) r^3 by
    a float32 bisection (mu(x) = ln(1+x) - x/(1+x)); z is a scalar or
    broadcasts against m200m (one redshift a halo).
    """
    from ..utils.constants import RHO_CRIT0
    from .halo_model import duffy_concentration
    from .hod import _nfw_mu as mu

    m200m = as_tensor(m200m, device).to(torch.float32)
    dev = m200m.device
    z_host = (z.detach().cpu().numpy() if isinstance(z, torch.Tensor)
              else np.asarray(z, np.float64))
    z32 = torch.as_tensor(z_host.astype(np.float32), device=dev)
    c = duffy_concentration(m200m, z=z32) if conc is None else as_tensor(
        conc, dev)
    rho_m0 = float(cosmo.Om0) * RHO_CRIT0
    r200m_phys = ((3.0 * m200m / (4.0 * math.pi * 200.0 * rho_m0))
                  ** (1.0 / 3.0)) / (1.0 + z32)
    rs = r200m_phys / c
    rho_c = torch.as_tensor(np.asarray(cosmo.rho_crit(z_host), np.float32),
                            device=dev)
    # (4/3) pi 500 rho_c in float32, the constant the loop compares with
    k500 = 4.0 / 3.0 * math.pi * 500.0 * rho_c
    mu_c = mu(c)

    def excess(r):
        # M(<r) - (4/3) pi 500 rho_c r^3 : positive while NFW wins
        return m200m * mu(r / rs) / mu_c - k500 * (r * r * r)

    lo = 0.01 * r200m_phys
    hi = 3.0 * r200m_phys
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        pos = excess(mid) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    r500 = 0.5 * (lo + hi)
    m500 = m200m * mu(r500 / rs) / mu_c
    return m500, r500


def y_ell(ells, m500_phys, r500_phys_mpc, e_z, d_a_mpc,
          params: Tuple[float, ...] = GNFW_ARNAUD10, h70: float = 0.968,
          x_max: float = 5.0, n_x: int = 256, device=None):
    """2D Fourier (Limber) profile y_ell of one cluster or of (nm,)
    clusters (Komatsu-Seljak 2002 Eq. 2 form, scaled by R500):

        y_ell = (sigma_T/m_e c^2) P500 (4 pi r500 / l500^2)
                Int dx x^2 P(x) sinc(ell x / l500),   l500 = d_A/r500.

    m500_phys [Msun], r500/d_A [Mpc] PHYSICAL (no h). Returns (nell,) for
    one cluster, else (nell, nm).
    """
    from .profiles3d import _linspace_f32

    ells = as_tensor(ells, device).reshape(-1)
    dev = ells.device
    m500_phys = as_tensor(m500_phys, dev).to(torch.float32).reshape(-1)
    r500 = as_tensor(r500_phys_mpc, dev).to(torch.float32).reshape(-1)
    scalar_halo = m500_phys.shape[0] == 1
    p500_amp = (1.65e-3 * e_z ** (8.0 / 3.0)
                * (m500_phys / (3.0e14 / h70)) ** (2.0 / 3.0) * h70 ** 2)
    l500 = d_a_mpc / r500                                # (nm,)
    x = _linspace_f32(1e-3, x_max, n_x, dev)
    px = gnfw_pressure(x, params)
    arg = ((ells[:, None, None] + 0.5) * x[None, None, :]
           / l500[None, :, None])                        # (nl, nm, nx)
    sinc = torch.where(arg < 1e-4, 1.0 - arg ** 2 / 6.0,
                       torch.sin(arg) / torch.clamp_min(arg, 1e-12))
    integ = torch.trapezoid(x[None, None, :] ** 2 * px[None, None, :] * sinc,
                            x, dim=-1)
    out = (_Y_PREFAC * p500_amp[None, :]
           * (4.0 * math.pi * r500 / l500 ** 2)[None, :] * integ)
    return out[:, 0] if scalar_halo else out


def cl_yy(ells, cosmo, z_min: float = 0.01, z_max: float = 3.0,
          nz: int = 24, mmin: float = 1e13, mmax: float = 5e15,
          nm: int = 40, model: str = "st", h70=None,
          params: Tuple[float, ...] = GNFW_ARNAUD10, device=None):
    """Halo-model (1-halo) tSZ angular power spectrum Cl_yy:

        Cl = Int dz dV/dz/dOmega Int dlnM n(M, z) |y_ell(M, z)|^2

    with the Arnaud+10 pressure profile, the theory_hmf mass function
    (M200m) and the NFW M200m -> M500c rescaling. The 2-halo term is
    omitted. Each redshift node is the JAX package's float32 z value
    (its jnp.linspace), fed as such to the mass function, the
    concentration and the distances. Returns (nell,) float32 Cl in y^2.
    """
    from .halo_stats import theory_hmf
    from .profiles3d import _linspace_f32

    if h70 is None:
        h70 = float(cosmo.h) / 0.7
    ells = as_tensor(ells, device).reshape(-1)
    dev = ells.device
    z_grid = _linspace_f32(z_min, z_max, nz, dev)
    lnm = _linspace_f32(math.log(mmin), math.log(mmax), nm, dev)
    m = torch.exp(lnm)
    dlnm = lnm[1] - lnm[0]
    dz = z_grid[1] - z_grid[0]
    h = float(cosmo.h)
    cls = []
    for zf in z_grid.cpu().numpy().tolist():
        chi = float(np.float32(cosmo.comoving_distance(zf)))  # Mpc/h
        d_a = chi / (1.0 + zf) / h                           # Mpc physical
        ez = float(np.float32(cosmo.efunc(zf)))
        dvol = (C_LIGHT_KMS / (100.0 * ez)) * chi ** 2
        n_lnm = theory_hmf(m, cosmo, z=zf, model=model).to(torch.float32)
        m500, r500 = m500c_from_m200m(m, zf, cosmo)
        yl = y_ell(ells, m500 / h, r500 / h, ez, d_a, params=params,
                   h70=h70)                                  # (nl, nm)
        cls.append(dvol * torch.sum(n_lnm[None, :] * yl ** 2, dim=1)
                   * dlnm)
    return torch.sum(torch.stack(cls), dim=0) * dz
