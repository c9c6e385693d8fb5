"""Aperture-mass statistics on flat-sky convergence/shear maps.

Port of astrild_tpu/ops/aperture_mass.py. Map(theta0) = int U(|theta -
theta0|) kappa(theta) d^2theta with the Schneider et al. 1998 compensated
polynomial filter, whose Hankel transform is U_hat(eta) = 24 J4(eta)/eta^2
(eta = ell theta_ap). Maps are filtered by FFT with the continuum U_hat,
tabulated on the host in float64 and cached as numpy (`_u_transfer`); the
theory `map2_theory` and J4 are host float64 copies of the JAX package's.
Numpy input goes to `device`, by default the CUDA card (it raises without
one); tensors keep their device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .._device import as_tensor

__all__ = ["aperture_mass_map", "aperture_mass_from_shear",
           "aperture_mass_moments", "map2_theory", "u_hat"]


@lru_cache(maxsize=64)
def _u_transfer(npix: int, theta_deg: float, theta_ap_arcmin: float
                ) -> np.ndarray:
    """Exact continuum transfer U_hat(|ell| theta_ap) on the rfft2 grid
    (host float64 table + interpolation, float32 out), so that poorly
    pixel-resolved apertures stay unbiased."""
    pix = np.deg2rad(theta_deg) / npix
    th = np.deg2rad(theta_ap_arcmin / 60.0)
    lx = 2.0 * np.pi * np.fft.fftfreq(npix, d=pix)
    ly = 2.0 * np.pi * np.fft.rfftfreq(npix, d=pix)
    eta = np.sqrt(lx[:, None] ** 2 + ly[None, :] ** 2) * th
    tab = np.linspace(0.0, float(eta.max()) + 1e-6, 4096)
    return np.interp(eta, tab, u_hat(tab)).astype(np.float32)


def _filter_map(img, transfer):
    n = img.shape[-1]
    return torch.fft.irfft2(torch.fft.rfft2(img) * transfer, s=(n, n))


def aperture_mass_map(kappa, opening_angle_deg: float,
                      theta_ap_arcmin: float, device=None):
    """Map(theta0) field from a convergence map (periodic convolution)."""
    kappa = as_tensor(kappa, device).to(torch.float32)
    tr = _u_transfer(kappa.shape[-1], float(opening_angle_deg),
                     float(theta_ap_arcmin))
    return _filter_map(kappa, torch.from_numpy(tr).to(kappa.device))


def aperture_mass_from_shear(gamma1, gamma2, opening_angle_deg: float,
                             theta_ap_arcmin: float, device=None):
    """Map from shear: Kaiser-Squires E-mode map then U filtering
    (spectrally the tangential-shear Q-filter estimator on the periodic
    grid)."""
    from .angular_power import shear_eb_maps

    e, _ = shear_eb_maps(gamma1, gamma2, device=device)
    return aperture_mass_map(e, opening_angle_deg, theta_ap_arcmin)


def aperture_mass_moments(kappa, opening_angle_deg: float,
                          scales_arcmin: Sequence[float], device=None):
    """<Map^2>, <Map^3> and skewness over aperture scales.

    Returns dict of numpy arrays keyed 'theta_ap_arcmin', 'map2', 'map3',
    'skewness' (= map3 / map2^{3/2}).
    """
    kappa = as_tensor(kappa, device).to(torch.float32)
    m2, m3 = [], []
    for s in scales_arcmin:
        m = aperture_mass_map(kappa, opening_angle_deg, float(s))
        m = m - torch.mean(m)
        m2.append(float(torch.mean(m * m)))
        m3.append(float(torch.mean(m * m * m)))
    m2 = np.asarray(m2)
    m3 = np.asarray(m3)
    return {"theta_ap_arcmin": np.asarray(list(scales_arcmin), float),
            "map2": m2, "map3": m3,
            "skewness": m3 / np.maximum(m2, 1e-30) ** 1.5}


def _j4(x):
    """J_4(x) on host, float64: the power series for x < 10, the integral
    representation (1/pi) int_0^pi cos(4t - x sin t) dt beyond."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    out = np.empty_like(x)
    small = x < 10.0
    if np.any(small):
        xs = x[small]
        h = (0.5 * xs) ** 2
        term = (0.5 * xs) ** 4 / 24.0  # k=0: (x/2)^4 / 4!
        acc = term.copy()
        for k in range(1, 30):
            term = term * (-h) / (k * (k + 4.0))
            acc += term
        out[small] = acc
    if np.any(~small):
        xl = x[~small]
        nt = int(max(512, 16 * np.max(xl) / (2 * np.pi) + 64))
        t = np.linspace(0.0, np.pi, nt)
        integrand = np.cos(4.0 * t[None, :]
                           - xl[:, None] * np.sin(t)[None, :])
        out[~small] = np.trapezoid(integrand, t, axis=1) / np.pi
    return out


def u_hat(eta):
    """Continuum Hankel transform of the Schneider+98 U filter:
    U_hat(eta) = 24 J4(eta)/eta^2 (host float64)."""
    eta = np.atleast_1d(np.asarray(eta, np.float64))
    out = np.zeros_like(eta)
    nz = eta > 1e-8
    out[nz] = 24.0 * _j4(eta[nz]) / eta[nz] ** 2
    return out


def map2_theory(ells, cl, theta_ap_arcmin: float):
    """<Map^2>(theta_ap) = int dl l/(2pi) C_l U_hat(l theta_ap)^2 (host
    float64 trapezoid over the supplied (ells, cl) table)."""
    ells = np.asarray(ells, np.float64)
    cl = np.asarray(cl, np.float64)
    th = np.deg2rad(theta_ap_arcmin / 60.0)
    w = u_hat(ells * th) ** 2
    return float(np.trapezoid(ells * cl * w, ells) / (2.0 * np.pi))
