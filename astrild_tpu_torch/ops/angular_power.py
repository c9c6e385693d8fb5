"""Angular power spectra on the flat sky and the Limber convergence power.

Port of `_flat_sky_binning`, `cl_flat_sky`, `flat_sky_mode_counts`,
`cl_flat_sky_cross`, `cl_kappa_cross_limber` and `cl_kappa_limber` of
astrild_tpu/ops/angular_power.py.

Not ported yet: `cl_to_flat_map`, the shear E/B maps, the n(z) Limber
kernels, the ISW spectrum and the masked (MASTER) estimators.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..utils.constants import DEG2RAD, H0_OVER_C_HMPC
from ..utils.cosmology import Cosmology
from .linear_power import (_halofit_power, _unnormalized_power,
                           halofit_parameters, normalization)
from .power import _mode_numbers

__all__ = ["cl_flat_sky", "cl_flat_sky_cross", "flat_sky_mode_counts",
           "cl_kappa_cross_limber", "cl_kappa_limber"]


def _segment_sum(values, binidx, nbins: int):
    out = torch.zeros(nbins, dtype=values.dtype, device=values.device)
    return out.index_add_(0, binidx, values)


def _flat_sky_binning(n: int, opening_angle_deg, nbins: int, ell_min,
                      ell_max, device=None):
    """The flat-sky ell binning (its one home). Returns (binidx, inside,
    nm, lsum).

    Mode-to-bin assignment compares EXACT integers: the squared mode
    number m2 = fi^2 + fj^2 (exact in float32 up to n=2048, the mode
    numbers built from integers) against host-precomputed squared edges
    in units of the fundamental (numpy float64, squared, cast float32: the
    JAX package's own edges). No sqrt takes part in the selection; it is
    only used for the reported lsum values.
    """
    f = _mode_numbers(n, device)
    m2 = (f[:, None] ** 2 + f[None, :] ** 2).reshape(-1)  # exact ints
    lf_host = 2.0 * np.pi / (float(opening_angle_deg) * float(DEG2RAD))
    lo = 1.0 if ell_min is None else float(ell_min) / lf_host
    hi = n / 2.0 if ell_max is None else float(ell_max) / lf_host
    edges_sq = torch.as_tensor(
        (np.linspace(lo, hi, nbins + 1) ** 2).astype(np.float32),
        device=device)
    lo2 = float(np.float32(lo * lo))
    hi2 = float(np.float32(hi * hi))
    theta = opening_angle_deg * DEG2RAD
    lf = 2.0 * math.pi / theta  # fundamental multipole (for lsum values)
    binidx = torch.clamp(
        torch.searchsorted(edges_sq, m2, right=True) - 1, 0, nbins - 1)
    inside = ((m2 >= lo2) & (m2 <= hi2)).to(torch.float32)
    lm = lf * torch.sqrt(m2)
    nm = _segment_sum(inside, binidx, nbins)
    lsum = _segment_sum(inside * lm, binidx, nbins)
    return binidx, inside, nm, lsum


def _map(img, device=None):
    """A map as it is if a tensor, else through `_device.as_tensor`."""
    return img if isinstance(img, torch.Tensor) else as_tensor(img, device)


def cl_flat_sky(img, opening_angle_deg, nbins: int = 50,
                ell_min=None, ell_max=None, device=None):
    """Cl of a flat-sky map by azimuthal averaging of |FFT|^2.

    Returns (ell_centers, cl), on the map's device: a tensor's own; numpy
    input goes to `device`, by default the CUDA card (it raises without
    one: pass device="cpu").
    """
    img = _map(img, device)
    n = img.shape[-1]
    theta = opening_angle_deg * DEG2RAD
    # Cl = theta^2 / npix^4 * |FFT|^2
    p2d = (torch.fft.fft2(img).abs() ** 2) * theta ** 2 / float(n) ** 4
    binidx, inside, nm, lsum = _flat_sky_binning(
        n, opening_angle_deg, nbins, ell_min, ell_max, device=img.device)
    psum = _segment_sum(inside * p2d.reshape(-1), binidx, nbins)
    denom = torch.clamp_min(nm, 1.0)
    return lsum / denom, psum / denom


def flat_sky_mode_counts(npix: int, opening_angle_deg, nbins: int = 50,
                         ell_min=None, ell_max=None, device=None):
    """(ell, nmodes) for cl_flat_sky's binning: the discrete grid-point
    count per ell bin, for Gaussian error bars
    Var[C_b] = 2 (C_b + N_b)^2 / nmodes_b. Shares `_flat_sky_binning` with
    cl_flat_sky, so the mode -> bin assignment is identical. The tables
    are made on `device`, by default the CUDA card (it raises without one:
    pass device="cpu")."""
    _, _, nm, lsum = _flat_sky_binning(npix, opening_angle_deg, nbins,
                                       ell_min, ell_max,
                                       device=default_device(device))
    return lsum / torch.clamp_min(nm, 1.0), nm


def cl_flat_sky_cross(img1, img2, opening_angle_deg, nbins: int = 50,
                      ell_min=None, ell_max=None, device=None):
    """Cross-Cl of two flat-sky maps (tomographic kappa_i x kappa_j,
    map x tracer, ...).

    Computed by the polarization identity Re[F1 conj(F2)] =
    (|F1+F2|^2 - |F1-F2|^2)/4 THROUGH cl_flat_sky, so the mode -> bin
    assignment is that of the auto estimator and
    cl_flat_sky_cross(x, x) == cl_flat_sky(x) exactly. Maps are placed as
    in cl_flat_sky.
    """
    img1, img2 = _map(img1, device), _map(img2, device)
    ell, cp = cl_flat_sky(img1 + img2, opening_angle_deg, nbins=nbins,
                          ell_min=ell_min, ell_max=ell_max)
    _, cm = cl_flat_sky(img1 - img2, opening_angle_deg, nbins=nbins,
                        ell_min=ell_min, ell_max=ell_max)
    return ell, 0.25 * (cp - cm)


def cl_kappa_limber(ells, cosmo: Cosmology, z_source: float = 1.0,
                    nchi: int = 256, amplitude=None,
                    nonlinear: bool = False, device=None):
    """Convergence power C_ell^kappakappa via Limber.

    C_ell = int dchi W(chi)^2 / chi^2 P(k = (ell + 1/2)/chi, z(chi)),
    W(chi) = 1.5 Om0 (H0/c)^2 (1+z) chi (chi_s - chi)/chi_s.

    The theory anchor for the Born-integrated kappa maps
    (ops/lensing.born_convergence). Linear P(k) (EH98) by default;
    nonlinear=True switches to the halofit (Takahashi+12) P(k, z). The
    auto spectrum is the equal-bin case of `cl_kappa_cross_limber`.
    """
    return cl_kappa_cross_limber(ells, cosmo, z_source, z_source,
                                 nchi=nchi, amplitude=amplitude,
                                 nonlinear=nonlinear, device=device)


def cl_kappa_cross_limber(ells, cosmo: Cosmology, z_source_i: float,
                          z_source_j: float, nchi: int = 256,
                          amplitude=None, nonlinear: bool = False,
                          device=None):
    """Tomographic convergence cross-power C_ell^{kappa_i kappa_j}.

    Same Limber integral as cl_kappa_limber with the kernel product
    W_i(chi) W_j(chi), integrated to min(chi_i, chi_j).

    ells: tensor (it keeps its device) or array-like (to `device`, by
    default the CUDA card). The distances, redshifts, growth and the
    halofit numbers of the nchi quadrature nodes are host tables (they
    depend on chi only, not on ell); P(k) and the integral are float32
    tensor ops on the ells' device.
    """
    if amplitude is None:
        amplitude = normalization(cosmo)
    ells = as_tensor(ells, device).reshape(-1)
    dev = ells.device
    chi_i = float(cosmo.comoving_distance(z_source_i))
    chi_j = float(cosmo.comoving_distance(z_source_j))
    chi_lo = min(chi_i, chi_j)
    chi_h = np.linspace(1e-3 * chi_lo, chi_lo, nchi)
    z_h = np.asarray(cosmo.redshift_at_comoving_distance(chi_h))

    def kern(chi_s):
        return (1.5 * cosmo.Om0 * H0_OVER_C_HMPC ** 2 * (1.0 + z_h) * chi_h
                * np.clip(chi_s - chi_h, 0.0, None) / chi_s)

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    chi = dev32(chi_h)
    k = (ells[:, None] + 0.5) / chi                      # (nell, nchi)
    if nonlinear:
        par = {name: dev32(v) for name, v in halofit_parameters(
            cosmo, z_h, amplitude).items()}
        pk = _halofit_power(k, cosmo, amplitude, par)
    else:
        pk = (float(amplitude) * _unnormalized_power(k, cosmo)
              * dev32(cosmo.growth_factor(z_h) ** 2))
    weight = dev32(kern(chi_i) * kern(chi_j) / chi_h ** 2)
    return torch.trapezoid(weight * pk, chi, dim=-1)
