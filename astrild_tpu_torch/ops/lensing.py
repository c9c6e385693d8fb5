"""Weak-lensing map operations on torch tensors: kappa -> alpha / gamma by
padded spectral solution, NFW analytic maps, halo-patch painting, and Born
integration over lens planes.

Port of astrild_tpu/ops/lensing.py, whole: `born_convergence`,
`kappa_to_gamma`, `kappa_to_alpha`, `kappa_to_phi`, `alpha_to_gamma` with
its roll-based `_grad_axis`, `code_to_phy_units_factor`, the NFW
deflection and moving-lens temperature patches (Baxter+15 Eqs. 6-8;
Yasini+18), `nfw_dipole_patch`, and the patch painting
`add_patch_to_map` / `paint_halo_patches`.

The NFW patches follow the arithmetic XLA compiles from the JAX package's
jitted functions: halo parameters in float32, its folded constants
(pi/180, 16 pi G/c^2 / (4 pi), 1/c as float32 products), the jitted
linspace of the patch edges (`profiles._linspace_jit_f32`) and its fused
divisions. The transcendental functions are torch's, which differ from
XLA's in the last ulp. Angles are in the unit of `opening_angle`;
distances in Mpc/h, or Mpc where the NFW functions say so.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .._device import default_device
from ..utils.constants import C_LIGHT_KMS
from .power import _mode_numbers
from .profiles import _linspace_jit_f32

__all__ = ["kappa_to_alpha", "kappa_to_gamma", "kappa_to_phi",
           "alpha_to_gamma", "nfw_deflection_angle_map",
           "nfw_temperature_perturbation_map", "nfw_dipole_patch",
           "add_patch_to_map", "paint_halo_patches", "born_convergence",
           "code_to_phy_units_factor"]

# G/c^2 in Mpc/Msun (the constant the reference bakes in)
G_OVER_C2 = 4.785e-20

_F32 = np.float32
# the constants XLA folds in the JAX package's jitted NFW maps: pi/180 as
# f32(pi) * f32(1/180); 16 pi (G/c^2) A with A = X / (4 pi) as
# X * (f32(16 pi G/c^2) * f32(1 / f32(4 pi))); the division by c as a
# product by f32(1/c)
_DEG2RAD_F32 = float(_F32(_F32(math.pi) * _F32(1.0 / 180.0)))
_CC_F32 = float(_F32(16.0 * math.pi * G_OVER_C2)
                * _F32(1.0 / _F32(4.0 * math.pi)))
_INV_C_F32 = float(_F32(1.0 / C_LIGHT_KMS))
_LN2_F32 = float(_F32(math.log(2.0)))
_G_ONE_F32 = float(_F32(1.0) + _F32(math.log(0.5)))


def _pad_size(n: int, padding_factor: int) -> int:
    """Round n*padding_factor up to a power of two (FFT-friendly)."""
    target = n * padding_factor
    p = 1
    while p < target:
        p *= 2
    return p


def _padded_wavenumbers(n: int, npad: int, opening_angle, device):
    """(k1 column, k2 row, |k|^2, |k|^2 with the zero mode set to 1) on the
    rfft2 grid of the zero-padded map."""
    lpad = opening_angle * npad / n
    kf = 2.0 * math.pi / lpad
    kx = torch.fft.fftfreq(npad, device=device) * npad * kf
    kzr = torch.fft.rfftfreq(npad, device=device) * npad * kf
    k1 = kx[:, None]
    k2 = kzr[None, :]
    k2mag = k1 ** 2 + k2 ** 2
    k2safe = torch.where(k2mag == 0.0, torch.ones_like(k2mag), k2mag)
    return k1, k2, k2mag, k2safe


def kappa_to_alpha(kappa, opening_angle, padding_factor: int = 4):
    """Deflection-angle maps (alpha1, alpha2) from a convergence map.

    Spectral solution of alpha = grad psi, lap psi = 2 kappa on the flat
    sky with zero-padding.

    Args:
      kappa: (npix, npix) convergence.
      opening_angle: field-of-view edge length (any angle unit; alpha is
        returned in the same unit).
      padding_factor: zero-pad factor before FFT (>=2 avoids periodic wrap).

    Returns:
      (alpha1, alpha2): deflection along axis-0 and axis-1 of the map.
    """
    n = kappa.shape[-1]
    npad = _pad_size(n, padding_factor)
    k1, k2, k2mag, k2safe = _padded_wavenumbers(n, npad, opening_angle,
                                                kappa.device)
    kap_ft = torch.fft.rfft2(kappa, s=(npad, npad))
    zero = torch.zeros_like(k2mag)
    fac1 = torch.where(k2mag == 0.0, zero, 2.0 * k1 / k2safe)
    fac2 = torch.where(k2mag == 0.0, zero, 2.0 * k2 / k2safe)
    # an odd transfer function must vanish on its own Nyquist plane
    # (j = n/2 is its own negative); leaving it breaks Hermitian symmetry
    ny = npad // 2
    fac1[ny, :] = 0.0
    fac2[:, -1] = 0.0  # rfft last column IS the Nyquist
    a1 = torch.fft.irfft2(1j * fac1 * kap_ft, s=(npad, npad))[:n, :n]
    a2 = torch.fft.irfft2(1j * fac2 * kap_ft, s=(npad, npad))[:n, :n]
    return -a1, -a2


def kappa_to_gamma(kappa, opening_angle, padding_factor: int = 2):
    """Shear (gamma1, gamma2) directly from kappa: one padded spectral
    spin-2 rotation, gamma_k = ((k1^2-k2^2) + 2i k1 k2)/k^2 kappa_k.
    """
    n = kappa.shape[-1]
    npad = _pad_size(n, padding_factor)
    k1, k2, k2mag, k2safe = _padded_wavenumbers(n, npad, opening_angle,
                                                kappa.device)
    kap_ft = torch.fft.rfft2(kappa, s=(npad, npad))
    zero = torch.zeros_like(k2mag)
    t1 = torch.where(k2mag == 0.0, zero, (k1 ** 2 - k2 ** 2) / k2safe)
    t2 = torch.where(k2mag == 0.0, zero, 2.0 * k1 * k2 / k2safe)
    # the cross term k1*k2 is odd in BOTH axes: it must vanish on each
    # Nyquist plane (same Hermitian-symmetry rule as kappa_to_alpha)
    ny = npad // 2
    t2[ny, :] = 0.0
    t2[:, -1] = 0.0
    g1 = torch.fft.irfft2(t1 * kap_ft, s=(npad, npad))[:n, :n]
    g2 = torch.fft.irfft2(t2 * kap_ft, s=(npad, npad))[:n, :n]
    return g1, g2


def kappa_to_phi(kappa, opening_angle, padding_factor: int = 4):
    """Lensing potential phi from kappa, lap phi = 2 kappa, solved on the
    zero-padded full FFT grid (fft2 with s=(npad, npad), as the JAX
    package)."""
    n = kappa.shape[-1]
    npad = _pad_size(n, padding_factor)
    lpad = opening_angle * npad / n
    kf = 2.0 * math.pi / lpad
    kx = _mode_numbers(npad, kappa.device) * kf
    k2mag = kx[:, None] ** 2 + kx[None, :] ** 2
    zero = k2mag == 0.0
    k2safe = torch.where(zero, torch.ones_like(k2mag), k2mag)
    kap_ft = torch.fft.fft2(kappa, s=(npad, npad))
    phi_ft = torch.where(zero, torch.zeros_like(k2mag), -2.0 / k2safe) * kap_ft
    return torch.fft.ifft2(phi_ft).real[:n, :n]


def _grad_axis(a, ds, axis: int):
    """The JAX package's roll form of central differences with one-sided
    edges: (roll(a, -1) - roll(a, 1)) * (0.5 / ds) inside, (a[1] - a[0]) /
    ds and (a[-1] - a[-2]) / ds on the two edge rows; `ds` a float32
    tensor, so the factors round as in float32. (Not torch.gradient: the
    (0.5 / ds) factor associates differently, in the last ulp.)"""
    half = torch.tensor(0.5, dtype=torch.float32, device=a.device) / ds
    c = (torch.roll(a, -1, axis) - torch.roll(a, 1, axis)) * half
    a_m = torch.movedim(a, axis, 0)
    c_m = torch.movedim(c, axis, 0).clone()
    c_m[0] = (a_m[1] - a_m[0]) / ds
    c_m[-1] = (a_m[-1] - a_m[-2]) / ds
    return torch.movedim(c_m, 0, axis)


def alpha_to_gamma(alpha1, alpha2, opening_angle):
    """Shear (gamma1, gamma2) from deflection maps by finite differences:
      gamma1 = (d1 alpha1 - d2 alpha2) / 2
      gamma2 = (d1 alpha2 + d2 alpha1) / 2
    with second-order central differences on pixel coordinates (pixel
    size opening_angle / n in float32)."""
    n = alpha1.shape[-1]
    dev = alpha1.device
    ds = (torch.tensor(float(opening_angle), dtype=torch.float32, device=dev)
          / torch.tensor(float(n), dtype=torch.float32, device=dev))
    d1a1 = _grad_axis(alpha1, ds, 0)
    d2a1 = _grad_axis(alpha1, ds, 1)
    d1a2 = _grad_axis(alpha2, ds, 0)
    d2a2 = _grad_axis(alpha2, ds, 1)
    gamma1 = 0.5 * (d1a1 - d2a2)
    gamma2 = 0.5 * (d1a2 + d2a1)
    return gamma1, gamma2


# ------------------------------------------------------------- NFW analytics
def _nfw_f(x):
    """Baxter+15 Eq. 7, f(x) = (1/x)[ln(x/2) + arccosh(1/x)/sqrt(1-x^2)],
    in the JAX package's stable rearrangement, as XLA compiles it:

      x < 0.999:  g = ln(x) (-x^2 / ((1 + s) s)) - ln 2 + log1p(s)/s,
                  s = sqrt((1 - x)(1 + x));
      x > 1.001:  g = ln(x / 2) + arccos(1/x) rsqrt((x - 1)(x + 1));
      else:       g = 1 + ln(1/2);
    f = g / max(x, 1e-8), and f = 0 below x = 1e-8 (float32). Below x ~
    1e-4 the true g (~ x^2 ln x / 2) is smaller than the rounding of
    -ln 2 + log1p(s)/s: there f, in both packages, is float32 noise."""
    x = torch.abs(x)
    xs = torch.clamp_min(x, 1e-8)
    lo = x < 0.999
    hi = x > 1.001
    x_lo = torch.clamp(x, 1e-8, 0.999)
    s = torch.sqrt((1.0 - x_lo) * (x_lo + 1.0))
    g_lo = (torch.log(x_lo) * (-(x_lo * x_lo) / ((s + 1.0) * s)) - _LN2_F32
            + torch.log1p(s) / s)
    x_hi = torch.clamp_min(xs, 1.001)
    g_hi = (torch.log(x_hi * 0.5) + torch.acos(1.0 / x_hi)
            * torch.rsqrt((x_hi - 1.0) * (x_hi + 1.0)))
    g = torch.where(lo, g_lo, torch.where(hi, g_hi,
                                          torch.full_like(x, _G_ONE_F32)))
    f = g / xs
    return torch.where(x < 1e-8, torch.zeros_like(f), f)


def _halo_tensors(*vals, device=None):
    """Halo parameters as float32 tensors of one flat shape (the JAX
    package's jit turns each into a float32 scalar), on the device of the
    first tensor among them, else on `device` (by default the CUDA card;
    it raises without one)."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               None)
    if dev is None:
        dev = default_device(device)
    out = [v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
           else torch.as_tensor(np.asarray(v, np.float64), device=dev).to(
               torch.float32) for v in vals]
    return [t.reshape(-1) for t in torch.broadcast_tensors(*out)]


def _nfw_geometry(theta_deg, c, dist, npix: int, extent):
    """Per halo (rows of the (nh,) inputs): R200 = tan(theta pi/180) D, the
    patch offsets t = linspace(0, 2 R200 extent, npix) - R200 extent and
    r = |(t_x, t_y)| on the (nh, npix, npix) grid (xy indexing: t_x along
    columns)."""
    # XLA's float32 tan is correctly rounded but for ~1e-5 of arguments;
    # torch's float32 tan is not (~6e-5): take it in float64 and round, so
    # that R200, and the patch edges that decide the r = 0 pixel, agree
    r200 = torch.tan((theta_deg * _DEG2RAD_F32).double()).float() * dist
    if npix > 1:
        edges = _linspace_jit_f32(0.0, r200 * 2.0 * extent, npix,
                                  r200.device)
    else:
        edges = torch.zeros_like(r200)[:, None]
    t = edges - (r200 * extent)[:, None]
    t2 = t * t
    r = torch.sqrt(t2[:, None, :] + t2[:, :, None])
    return r200, t, r


def _nfw_deflection_stack(theta_deg, m, c, dist, npix: int, extent,
                          directions: Tuple[int, ...], suppress: bool,
                          suppression_r):
    """`nfw_deflection_angle_map` of nh halos at once: float32 (nh,)
    parameters, (nh, npix, npix) maps, each element computed as the
    scalar call computes it."""
    r200, t, r = _nfw_geometry(theta_deg, c, dist, npix, extent)
    # Eq. 8 and Eq. 6: C = 16 pi (G/c^2) M c^2 / (ln(1+c) - c/(1+c))
    # / (4 pi) / c / R200
    a = m * (c * c) / (torch.log(c + 1.0) - c / (c + 1.0))
    cc = (a * _CC_F32 / (c * r200))[:, None, None]
    r_s = r200 / c
    f = _nfw_f(r / r_s[:, None, None])
    zero = r == 0.0
    rsafe = torch.where(zero, torch.ones_like(r), r)
    amap = None
    for direc in directions:
        that = (t[:, None, :] if direc == 0 else t[:, :, None]) / rsafe
        term = cc * torch.where(zero, torch.zeros_like(r), that * f)
        amap = term if amap is None else amap + term
    if amap is None:
        amap = torch.zeros_like(r)
    amap = torch.where(torch.isfinite(amap), amap, torch.zeros_like(amap))
    if suppress:
        q = r / (suppression_r * r200)[:, None, None]
        amap = amap * torch.exp(-(q * q * q))
    # clip unphysical central-pixel values as the reference does
    return torch.where(torch.abs(amap) > 100.0, torch.zeros_like(amap),
                       amap)


def _nfw_temperature_stack(theta_deg, m, c, vel, dist, npix: int, extent,
                           directions: Tuple[int, ...], suppress: bool,
                           suppression_r):
    """`nfw_temperature_perturbation_map` of nh halos at once; vel is
    (nh, 2) float32."""
    dt = None
    for direc in directions:
        amap = _nfw_deflection_stack(theta_deg, m, c, dist, npix, extent,
                                     (direc,), suppress, suppression_r)
        term = (amap * vel[:, direc, None, None]) * _INV_C_F32
        dt = -term if dt is None else dt - term
    return dt if dt is not None else torch.zeros(
        (theta_deg.shape[0], npix, npix), device=theta_deg.device)


def nfw_deflection_angle_map(
        theta_200c_deg, m_200c, c_200c, angu_diam_dist, npix: int = 100,
        extent: float = 1.0, directions: Tuple[int, ...] = (0,),
        suppress: bool = False, suppression_r: float = 1.0, device=None):
    """Deflection-angle patch of an NFW halo (Baxter+15 Sec. 3.2, Eqs. 6-8):
    the patch spans +-extent*R200c around the halo; `directions` selects the
    vector components summed into the returned scalar map (0 -> theta_x-hat
    projection along columns, 1 -> theta_y-hat along rows).

    Args:
      theta_200c_deg: halo angular radius [deg].
      m_200c: mass [Msun].
      c_200c: NFW concentration.
      angu_diam_dist: angular-diameter distance [Mpc].
    The scalars run in float32 on the device of a tensor among them, else
    on `device` (by default the CUDA card; it raises without one).
    Returns (npix, npix) float32.
    """
    th, m, c, d, ext, sup = _halo_tensors(
        theta_200c_deg, m_200c, c_200c, angu_diam_dist, extent,
        suppression_r, device=device)
    return _nfw_deflection_stack(th, m, c, d, npix, ext, tuple(directions),
                                 suppress, sup)[0]


def nfw_temperature_perturbation_map(
        theta_200c_deg, m_200c, c_200c, vel, angu_diam_dist, npix: int = 100,
        extent: float = 1.0, directions: Tuple[int, ...] = (0, 1),
        suppress: bool = False, suppression_r: float = 1.0, device=None):
    """Moving-lens (Birkinshaw-Gull / Rees-Sciama) dT/T_cmb patch:
    dT/T = -alpha . v_t / c summed over transverse directions (Yasini+18).
    vel: transverse velocity components [km/s], indexable by direction.
    Placed as `nfw_deflection_angle_map`."""
    th, m, c, d, ext, sup = _halo_tensors(
        theta_200c_deg, m_200c, c_200c, angu_diam_dist, extent,
        suppression_r, device=device)
    v = (vel.to(th.device, torch.float32) if isinstance(vel, torch.Tensor)
         else torch.as_tensor(np.asarray(vel, np.float64),
                              device=th.device).to(torch.float32))
    return _nfw_temperature_stack(th, m, c, v.reshape(1, -1), d, npix, ext,
                                  tuple(directions), suppress, sup)[0]


def nfw_dipole_patch(m200c, vel_t, z_lens, extent_deg: float = 0.5,
                     npix: int = 128, cosmo=None, device=None):
    """Analytic NFW moving-lens temperature patch of fixed angular size:
    R200c from 200 rho_crit(z_lens), the Duffy et al. 2008 full-sample
    c200c relation, and the patch fixed at +-extent_deg/2 on the sky.

    Args:
      m200c: halo mass [Msun/h].
      vel_t: transverse velocity components (2,) [km/s].
      z_lens: lens redshift.
    The geometry is host float64 (the JAX package's Python floats from its
    float32 tables); the patch runs as `nfw_temperature_perturbation_map`.
    Returns (npix, npix) Delta-T in Kelvin.
    """
    from ..utils.constants import T_CMB
    from ..utils.cosmology import Cosmology

    cosmo = cosmo if cosmo is not None else Cosmology()
    m200c = float(m200c)
    rho_c = float(cosmo.rho_crit(z_lens))  # (Msun/h)/(Mpc/h)^3
    r200 = (3.0 * m200c / (4.0 * math.pi * 200.0 * rho_c)) ** (1.0 / 3.0)
    d_a = float(cosmo.angular_diameter_distance(z_lens))  # Mpc/h
    theta200_deg = math.degrees(math.atan(r200 / d_a))
    c200 = 5.71 * (m200c / 2.0e12) ** -0.084 * (1.0 + z_lens) ** -0.47
    extent = (extent_deg / 2.0) / theta200_deg
    dt_over_t = nfw_temperature_perturbation_map(
        theta200_deg, m200c, c200, vel_t, d_a, npix=npix,
        extent=float(extent), directions=(0, 1), device=device)
    return dt_over_t * T_CMB


# ----------------------------------------------------------- patch painting
def _patch_indices(npatch: int, nbig: int, centers):
    """Flat canvas indices of (nh, p, p) patches centred at (col, row)
    `centers` (nh, 2), clipped to the canvas, and the mask of the pixels
    that fall inside it."""
    rad = npatch // 2
    ar = torch.arange(npatch, device=centers.device) - rad
    rows = ar[None, :] + centers[:, 1:2]
    cols = ar[None, :] + centers[:, 0:1]
    rr = rows[:, :, None].expand(-1, npatch, npatch)
    cc = cols[:, None, :].expand(-1, npatch, npatch)
    valid = (rr >= 0) & (rr < nbig) & (cc >= 0) & (cc < nbig)
    flat = (rr.clamp(0, nbig - 1) * nbig + cc.clamp(0, nbig - 1))
    return flat, valid


def add_patch_to_map(limg, simg, cen_pix):
    """Add a small (odd-sized) patch onto a large map, clipped at borders;
    returns a new map. The patch centre lands at pixel (cen_pix[0],
    cen_pix[1]) = (column, row)."""
    cen = torch.as_tensor([int(cen_pix[0]), int(cen_pix[1])],
                          device=limg.device).reshape(1, 2)
    return paint_halo_patches(limg, simg[None], cen)


def paint_halo_patches(base_map, patches, centers_pix):
    """Add a batch of equal-size patches onto one map (a new map is
    returned): one `index_add_` over the flattened (halo, row, col)
    indices, clipped and masked as `add_patch_to_map` does.

    On the CPU the sum runs in the JAX package's scan order (halo by
    halo), so the result is the same; on the card atomics reorder where
    patches overlap (float32 rounding of the overlapping sums).

    Args:
      base_map: (npix, npix).
      patches: (nhalo, p, p) patch stack (odd p).
      centers_pix: (nhalo, 2) int (x=col, y=row) patch centers.
    """
    out = base_map.reshape(-1).clone()
    _add_patches_(out, base_map.shape[-1], patches, centers_pix)
    return out.reshape(base_map.shape)


def _add_patches_(flat_map, nbig: int, patches, centers_pix):
    """Add (nh, p, p) patches into a flattened (nbig * nbig) map in place,
    as `paint_halo_patches` does."""
    dev = flat_map.device
    centers = (centers_pix.to(dev) if isinstance(centers_pix, torch.Tensor)
               else torch.as_tensor(np.asarray(centers_pix), device=dev)
               ).to(torch.int64)
    patches = patches.to(dev)
    flat, valid = _patch_indices(patches.shape[-1], nbig, centers)
    vals = torch.where(valid, patches, torch.zeros_like(patches))
    flat_map.index_add_(0, flat.reshape(-1),
                        vals.reshape(-1).to(flat_map.dtype))


def code_to_phy_units_factor(quantity: str) -> float:
    """RayRamses code -> physical unit factor: kappa, shear and deflection
    1/c^2; ISW-RS (dT/T) 1/c^3 (c in km/s)."""
    if quantity in ("shear_x", "shear_y", "deflt_x", "deflt_y", "kappa_1",
                    "kappa_2"):
        return 1.0 / C_LIGHT_KMS ** 2
    if quantity in ("isw_rs",):
        return 1.0 / C_LIGHT_KMS ** 3
    return 1.0


def born_convergence(density_planes, chis, dchis, chi_s, omega_m,
                     scale_factors=None):
    """Born-approximation convergence from stacked density-contrast planes.

    kappa(theta) = (3 H0^2 Om / 2 c^2) sum_i dchi_i g(chi_i) delta_i / a_i
    with g = (chi_s - chi) chi / chi_s (comoving, flat; h-units in, so H0 =
    100 km/s/Mpc).

    Args:
      density_planes: (nplane, npix, npix) delta on each lens plane.
      chis: (nplane,) comoving distances [Mpc/h].
      dchis: (nplane,) plane thicknesses [Mpc/h].
      chi_s: source comoving distance [Mpc/h].
      omega_m: matter density parameter.
      scale_factors: (nplane,) a(chi_i); defaults to 1.
    """
    h0_over_c = 100.0 / C_LIGHT_KMS  # [h/Mpc]
    pref = 1.5 * omega_m * h0_over_c ** 2
    if scale_factors is None:
        scale_factors = torch.ones_like(chis)
    g = torch.clamp(chi_s - chis, min=0.0) * chis / chi_s
    kappa = torch.zeros_like(density_planes[0])
    for i in range(density_planes.shape[0]):
        kappa = kappa + pref * g[i] * dchis[i] * density_planes[i] \
            / scale_factors[i]
    return kappa
