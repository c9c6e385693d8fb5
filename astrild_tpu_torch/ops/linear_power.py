"""Linear matter power spectrum (Eisenstein & Hu 1998), sigma8-normalized.

Port of astrild_tpu/ops/linear_power.py (`eh98_transfer`,
`_unnormalized_power`, `sigma_r`, `normalization`, `linear_power`). The
k-dependent terms are torch ops in the dtype of `k`; the k-independent
fit coefficients are host float64 scalars.

Units: k in h/Mpc, P in (Mpc/h)^3.
"""
from __future__ import annotations

import math

import torch

from ..utils.cosmology import Cosmology

__all__ = ["eh98_transfer", "linear_power", "sigma_r", "normalization"]


def _as_tensor(k):
    return k if isinstance(k, torch.Tensor) else torch.as_tensor(
        k, dtype=torch.float32)


def eh98_transfer(k_hmpc, cosmo: Cosmology):
    """EH98 matter transfer function T(k) with baryon features.

    k in h/Mpc; internally converted to 1/Mpc as the fit requires.
    """
    h = cosmo.h
    k = _as_tensor(k_hmpc) * h  # [1/Mpc]
    om = cosmo.Om0 * h ** 2
    ob = cosmo.Ob0 * h ** 2
    oc = om - ob
    fb = ob / om
    fc = oc / om
    theta = cosmo.Tcmb / 2.7

    z_eq = 2.50e4 * om * theta ** -4
    k_eq = 7.46e-2 * om * theta ** -2  # [1/Mpc]

    b1d = 0.313 * om ** -0.419 * (1.0 + 0.607 * om ** 0.674)
    b2d = 0.238 * om ** 0.223
    z_d = (1291.0 * om ** 0.251 / (1.0 + 0.659 * om ** 0.828)
           * (1.0 + b1d * ob ** b2d))

    def r_of(z):
        return 31.5 * ob * theta ** -4 * (1.0e3 / z)

    r_d = r_of(z_d)
    r_eq = r_of(z_eq)
    s = (2.0 / (3.0 * k_eq) * math.sqrt(6.0 / r_eq)
         * math.log((math.sqrt(1.0 + r_d) + math.sqrt(r_d + r_eq))
                    / (1.0 + math.sqrt(r_eq))))
    k_silk = (1.6 * ob ** 0.52 * om ** 0.73
              * (1.0 + (10.4 * om) ** -0.95))

    q = k / (13.41 * k_eq)

    # ---- CDM piece ----
    a1 = (46.9 * om) ** 0.670 * (1.0 + (32.1 * om) ** -0.532)
    a2 = (12.0 * om) ** 0.424 * (1.0 + (45.0 * om) ** -0.582)
    alpha_c = a1 ** (-fb) * a2 ** (-fb ** 3)
    bb1 = 0.944 / (1.0 + (458.0 * om) ** -0.708)
    bb2 = (0.395 * om) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * (fc ** bb2 - 1.0))

    def t0(q, alpha, beta):
        c = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q ** 1.08)
        lnarg = torch.log(math.e + 1.8 * beta * q)
        return lnarg / (lnarg + c * q ** 2)

    f = 1.0 / (1.0 + (k * s / 5.4) ** 4)
    t_c = f * t0(q, 1.0, beta_c) + (1.0 - f) * t0(q, alpha_c, beta_c)

    # ---- baryon piece ----
    def g_of(y):
        sq = math.sqrt(1.0 + y)
        return y * (-6.0 * sq + (2.0 + 3.0 * y)
                    * math.log((sq + 1.0) / (sq - 1.0)))

    alpha_b = (2.07 * k_eq * s * (1.0 + r_d) ** -0.75
               * g_of((1.0 + z_eq) / (1.0 + z_d)))
    beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * math.sqrt((17.2 * om) ** 2 + 1.0)
    beta_node = 8.41 * om ** 0.435
    ks = torch.clamp_min(k * s, 1e-12)
    s_tilde = s / (1.0 + (beta_node / ks) ** 3) ** (1.0 / 3.0)
    x = torch.clamp_min(k * s_tilde, 1e-12)
    j0 = torch.sin(x) / x
    t_b = (t0(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
           + alpha_b / (1.0 + (beta_b / ks) ** 3)
           * torch.exp(-((k / k_silk) ** 1.4))) * j0

    return fb * t_b + fc * t_c


def _unnormalized_power(k, cosmo: Cosmology):
    k = _as_tensor(k)
    return k ** cosmo.ns * eh98_transfer(k, cosmo) ** 2


def sigma_r(r_hmpc, cosmo: Cosmology, amplitude=1.0, nk: int = 1024):
    """sigma(R) of the (amplitude-scaled) linear power at z=0, as a 0-d
    float64 tensor (trapezoid in ln k over [1e-4, 50] h/Mpc)."""
    lnk = torch.linspace(math.log(1e-4), math.log(50.0), nk,
                         dtype=torch.float64)
    k = torch.exp(lnk)
    p = amplitude * _unnormalized_power(k, cosmo)
    x = k * r_hmpc
    xs = torch.clamp_min(x, 0.1)
    w_formula = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    w_series = 1.0 - x ** 2 / 10.0 + x ** 4 / 280.0
    w = torch.where(x < 0.1, w_series, w_formula)
    integrand = k ** 3 * p * w ** 2 / (2.0 * math.pi ** 2)  # d(ln k)
    dlnk = lnk[1] - lnk[0]
    var = torch.sum(0.5 * (integrand[1:] + integrand[:-1]) * dlnk)
    return torch.sqrt(var)


def normalization(cosmo: Cosmology) -> float:
    """Amplitude A such that sigma(8 Mpc/h) = cosmo.sigma8."""
    return float((cosmo.sigma8 / sigma_r(8.0, cosmo, amplitude=1.0)) ** 2)


def linear_power(k_hmpc, cosmo: Cosmology, z=0.0, amplitude=None):
    """Linear matter P(k, z) [(Mpc/h)^3], sigma8-normalized at z=0 (z a
    scalar)."""
    if amplitude is None:
        amplitude = normalization(cosmo)
    d = float(cosmo.growth_factor(z))
    return float(amplitude) * _unnormalized_power(k_hmpc, cosmo) * d ** 2
