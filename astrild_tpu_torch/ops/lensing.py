"""Weak-lensing map operations on torch tensors: kappa -> alpha / gamma by
padded spectral solution, and Born integration over lens planes.

Port of astrild_tpu/ops/lensing.py (`born_convergence`, `kappa_to_gamma`,
`kappa_to_alpha`). Angles are in the unit of `opening_angle`; distances in
Mpc/h.
"""
from __future__ import annotations

import math

import torch

from ..utils.constants import C_LIGHT_KMS

__all__ = ["kappa_to_alpha", "kappa_to_gamma", "born_convergence"]


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
