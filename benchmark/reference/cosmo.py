"""Flat LambdaCDM background, linear growth and the EH98 linear power
spectrum, in float64 numpy: the benchmark's own frozen copy, used by the
traffic generator and by the plain references. Imports nothing of the
program.

Conventions: comoving lengths in Mpc/h, wavenumbers in h/Mpc, time in
units of 1/H0, so E(a) = H(a)/H0.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["efunc", "growth", "eh98_transfer", "sigma8_amplitude",
           "linear_power", "kdk_factors"]


def efunc(a, om0: float):
    """E(a) = sqrt(Om0 a^-3 + 1 - Om0) (flat, w = -1, no radiation)."""
    a = np.asarray(a, np.float64)
    return np.sqrt(om0 * a ** -3 + (1.0 - om0))


def _growth_integral(a, om0: float, n: int = 20001):
    """I(a) = int_0^a da' / (a' E(a'))^3 by Simpson's rule in a' (the
    integrand goes as a'^(3/2) / Om0^(3/2) near 0, so it is smooth)."""
    x = np.linspace(0.0, a, n)
    xs = np.maximum(x, 1e-12)
    f = np.where(x > 0, 1.0 / (xs * efunc(xs, om0)) ** 3, 0.0)
    h = a / (n - 1)
    return h / 3.0 * (f[0] + f[-1] + 4.0 * f[1:-1:2].sum()
                      + 2.0 * f[2:-1:2].sum())


def growth(z: float, om0: float):
    """(D1, f1, D2, f2) at redshift z: the growing mode D1 normalised to 1
    at z = 0 (D ~ E(a) I(a)), f1 = dlnD1/dlna, and the 2LPT pair
    D2 = -(3/7) D1^2 Om(z)^(-1/143), f2 = 2 Om(z)^(6/11)."""
    a = 1.0 / (1.0 + z)

    def d_unnorm(aa):
        return efunc(aa, om0) * _growth_integral(aa, om0)

    d1 = float(d_unnorm(a) / d_unnorm(1.0))
    e = float(efunc(a, om0))
    dlne = -1.5 * om0 * a ** -3 / e ** 2
    f1 = dlne + 1.0 / (a ** 2 * e ** 3 * _growth_integral(a, om0))
    om_z = om0 * a ** -3 / e ** 2
    d2 = -(3.0 / 7.0) * d1 ** 2 * om_z ** (-1.0 / 143.0)
    f2 = 2.0 * om_z ** (6.0 / 11.0)
    return d1, float(f1), d2, f2


def eh98_transfer(k_hmpc, om0: float, ob0: float, h: float, tcmb: float):
    """Eisenstein & Hu 1998 (ApJ 496, 605) transfer function with baryon
    oscillations, k in h/Mpc."""
    k = np.asarray(k_hmpc, np.float64) * h  # 1/Mpc
    om = om0 * h * h
    ob = ob0 * h * h
    oc = om - ob
    fb, fc = ob / om, oc / om
    theta = tcmb / 2.7
    z_eq = 2.50e4 * om * theta ** -4
    k_eq = 7.46e-2 * om * theta ** -2
    b1d = 0.313 * om ** -0.419 * (1.0 + 0.607 * om ** 0.674)
    b2d = 0.238 * om ** 0.223
    z_d = (1291.0 * om ** 0.251 / (1.0 + 0.659 * om ** 0.828)
           * (1.0 + b1d * ob ** b2d))

    def r_of(z):
        return 31.5 * ob * theta ** -4 * (1.0e3 / z)

    r_d, r_eq = r_of(z_d), r_of(z_eq)
    s = (2.0 / (3.0 * k_eq) * math.sqrt(6.0 / r_eq)
         * math.log((math.sqrt(1.0 + r_d) + math.sqrt(r_d + r_eq))
                    / (1.0 + math.sqrt(r_eq))))
    k_silk = 1.6 * ob ** 0.52 * om ** 0.73 * (1.0 + (10.4 * om) ** -0.95)
    q = k / (13.41 * k_eq)
    a1 = (46.9 * om) ** 0.670 * (1.0 + (32.1 * om) ** -0.532)
    a2 = (12.0 * om) ** 0.424 * (1.0 + (45.0 * om) ** -0.582)
    alpha_c = a1 ** (-fb) * a2 ** (-fb ** 3)
    bb1 = 0.944 / (1.0 + (458.0 * om) ** -0.708)
    bb2 = (0.395 * om) ** -0.0266
    beta_c = 1.0 / (1.0 + bb1 * (fc ** bb2 - 1.0))

    def t0(q, alpha, beta):
        c = 14.2 / alpha + 386.0 / (1.0 + 69.9 * q ** 1.08)
        lnarg = np.log(math.e + 1.8 * beta * q)
        return lnarg / (lnarg + c * q * q)

    f = 1.0 / (1.0 + (k * s / 5.4) ** 4)
    t_c = f * t0(q, 1.0, beta_c) + (1.0 - f) * t0(q, alpha_c, beta_c)

    def g_of(y):
        sq = math.sqrt(1.0 + y)
        return y * (-6.0 * sq + (2.0 + 3.0 * y)
                    * math.log((sq + 1.0) / (sq - 1.0)))

    alpha_b = (2.07 * k_eq * s * (1.0 + r_d) ** -0.75
               * g_of((1.0 + z_eq) / (1.0 + z_d)))
    beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * math.sqrt((17.2 * om) ** 2 + 1.0)
    beta_node = 8.41 * om ** 0.435
    ks = np.maximum(k * s, 1e-12)
    s_tilde = s / (1.0 + (beta_node / ks) ** 3) ** (1.0 / 3.0)
    x = np.maximum(k * s_tilde, 1e-12)
    t_b = (t0(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
           + alpha_b / (1.0 + (beta_b / ks) ** 3)
           * np.exp(-((k / k_silk) ** 1.4))) * (np.sin(x) / x)
    return fb * t_b + fc * t_c


def _unnormalized(k, cosmo: dict):
    t = eh98_transfer(k, cosmo["Om0"], cosmo["Ob0"], cosmo["h"],
                      cosmo["Tcmb"])
    return np.asarray(k, np.float64) ** cosmo["ns"] * t * t


def sigma8_amplitude(cosmo: dict, nk: int = 4096) -> float:
    """A such that A k^ns T(k)^2 has sigma(8 Mpc/h) = sigma8 (top hat,
    trapezoid in ln k over [1e-5, 100] h/Mpc)."""
    lnk = np.linspace(math.log(1e-5), math.log(100.0), nk)
    k = np.exp(lnk)
    x = 8.0 * k
    w = np.where(x < 1e-3, 1.0 - x * x / 10.0,
                 3.0 * (np.sin(x) - x * np.cos(x)) / np.maximum(x, 1e-3) ** 3)
    integrand = k ** 3 * _unnormalized(k, cosmo) * w * w / (2.0 * math.pi ** 2)
    var = np.sum(0.5 * (integrand[1:] + integrand[:-1]) * np.diff(lnk))
    return cosmo["sigma8"] ** 2 / var


def linear_power(k_hmpc, cosmo: dict):
    """Linear P(k) at z = 0 [(Mpc/h)^3], sigma8-normalised."""
    return sigma8_amplitude(cosmo) * _unnormalized(k_hmpc, cosmo)


def kdk_factors(om0: float, a_init: float, a_final: float, nsteps: int,
                n: int = 4097):
    """Kick-drift-kick factors of each step of a log-a grid (Quinn et al.
    1997): rows [int_{a0}^{ah} da/(a^2 E), int_{a0}^{a1} da/(a^3 E),
    int_{ah}^{a1} da/(a^2 E)] with ah = sqrt(a0 a1), by Simpson's rule."""
    edges = np.exp(np.linspace(math.log(a_init), math.log(a_final),
                               nsteps + 1))

    def integral(lo, hi, p):
        a = np.linspace(lo, hi, n)
        f = 1.0 / (a ** p * efunc(a, om0))
        hh = (hi - lo) / (n - 1)
        return hh / 3.0 * (f[0] + f[-1] + 4.0 * f[1:-1:2].sum()
                           + 2.0 * f[2:-1:2].sum())

    rows = []
    for a0, a1 in zip(edges[:-1], edges[1:]):
        ah = math.sqrt(a0 * a1)
        rows.append((integral(a0, ah, 2), integral(a0, a1, 3),
                     integral(ah, a1, 2)))
    return np.asarray(rows, np.float64)
