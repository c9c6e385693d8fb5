"""Linear matter power spectrum (Eisenstein & Hu 1998), sigma8-normalized.

Port of astrild_tpu/ops/linear_power.py (`eh98_transfer`, the no-wiggle
`eh98_transfer_nowiggle`, `_unnormalized_power`, `sigma_r`,
`normalization`, `linear_power`, `linear_power_nowiggle`,
`kaiser_multipoles`, the linear ISW source power `p_dpdp`, and the
halofit `_sigma2_gauss`, `nonlinear_power`).
The k-dependent terms are torch ops in the dtype of `k`. For a cosmology
with float fields the k-independent fit coefficients are host float64
scalars and the halofit numbers host numpy; for a traced one
(`Cosmology.traced`, tensor fields) they are float64 tensor ops that
autograd and torch.func follow, as the JAX package's are jnp ops.

Units: k in h/Mpc, P in (Mpc/h)^3.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from ..utils.cosmology import Cosmology

__all__ = ["eh98_transfer", "eh98_transfer_nowiggle", "linear_power",
           "linear_power_nowiggle", "sigma_r", "sigma_r_slope",
           "normalization",
           "kaiser_multipoles", "p_dpdp", "nonlinear_power",
           "halofit_parameters"]


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _scalar(x):
    """x as a Python float, unless it is a tensor (a traced value keeps
    its graph)."""
    return x if isinstance(x, torch.Tensor) else float(x)


def _as_tensor(k, device=None):
    """k as it is if a tensor (device and dtype kept; moved if `device` is
    given), else a float32 tensor on `device`, by default the CUDA card
    (`_device.as_tensor`: it raises without one)."""
    if isinstance(k, torch.Tensor):
        return k if device is None else k.to(device)
    return as_tensor(k, device)


def eh98_transfer(k_hmpc, cosmo: Cosmology, device=None):
    """EH98 matter transfer function T(k) with baryon features.

    k in h/Mpc; internally converted to 1/Mpc as the fit requires. A
    tensor keeps its device; other input goes to `device`, by default the
    CUDA card (it raises without one: pass device="cpu").
    """
    h = cosmo.h
    k = _as_tensor(k_hmpc, device) * h  # [1/Mpc]
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
    s = (2.0 / (3.0 * k_eq) * _sqrt(6.0 / r_eq)
         * _log((_sqrt(1.0 + r_d) + _sqrt(r_d + r_eq))
                / (1.0 + _sqrt(r_eq))))
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
        sq = _sqrt(1.0 + y)
        return y * (-6.0 * sq + (2.0 + 3.0 * y)
                    * _log((sq + 1.0) / (sq - 1.0)))

    alpha_b = (2.07 * k_eq * s * (1.0 + r_d) ** -0.75
               * g_of((1.0 + z_eq) / (1.0 + z_d)))
    beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * _sqrt((17.2 * om) ** 2 + 1.0)
    beta_node = 8.41 * om ** 0.435
    ks = torch.clamp_min(k * s, 1e-12)
    s_tilde = s / (1.0 + (beta_node / ks) ** 3) ** (1.0 / 3.0)
    x = torch.clamp_min(k * s_tilde, 1e-12)
    j0 = torch.sin(x) / x
    t_b = (t0(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
           + alpha_b / (1.0 + (beta_b / ks) ** 3)
           * torch.exp(-((k / k_silk) ** 1.4))) * j0

    return fb * t_b + fc * t_c


def eh98_transfer_nowiggle(k_hmpc, cosmo: Cosmology, device=None):
    """EH98 zero-baryon ("no-wiggle") transfer function (EH98 sec. 4.2).

    The same broadband as `eh98_transfer` (baryon suppression through the
    effective shape parameter Gamma_eff, eqs. 30-31) without the acoustic
    oscillations: the denominator of the BAO wiggle ratio O(k) of ops.bao.
    k is placed as in `eh98_transfer`.
    """
    h = cosmo.h
    k_hmpc = _as_tensor(k_hmpc, device)
    om = cosmo.Om0 * h ** 2
    ob = cosmo.Ob0 * h ** 2
    fb = ob / om
    theta = cosmo.Tcmb / 2.7
    # sound horizon, EH98 eq. 26 approximation [Mpc]
    s = 44.5 * _log(9.83 / om) / _sqrt(1.0 + 10.0 * ob ** 0.75)
    # effective shape parameter, eq. 30-31
    a_gamma = (1.0 - 0.328 * _log(431.0 * om) * fb
               + 0.38 * _log(22.3 * om) * fb ** 2)
    ks = k_hmpc * h * s  # k [1/Mpc] * s [Mpc]
    gamma_eff = cosmo.Om0 * h * (a_gamma + (1.0 - a_gamma)
                                 / (1.0 + (0.43 * ks) ** 4))
    q = k_hmpc * theta ** 2 / gamma_eff  # eq. 28
    l0 = torch.log(2.0 * math.e + 1.8 * q)
    c0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
    return l0 / (l0 + c0 * q ** 2)


def _unnormalized_power(k, cosmo: Cosmology):
    return k ** cosmo.ns * eh98_transfer(k, cosmo) ** 2


def _tophat_terms(r_hmpc, cosmo: Cosmology, amplitude, nk: int):
    """The pieces of sigma(R)'s trapezoid in ln k over [1e-4, 50] h/Mpc:
    (k^3 P, x = kR, x clamped at 0.1, x < 0.1, the top-hat W(x), dlnk).
    W takes its series below x = 0.1, where the closed form cancels; the
    closed form sees a clamped argument, so the branch not taken is NaN-free
    under autodiff."""
    if isinstance(r_hmpc, torch.Tensor):
        r = r_hmpc.to(torch.float64)
    else:
        r = torch.tensor(r_hmpc, dtype=torch.float64, device=cosmo.device)
    lnk = torch.linspace(math.log(1e-4), math.log(50.0), nk,
                         dtype=torch.float64, device=r.device)
    k = torch.exp(lnk)
    p = amplitude * _unnormalized_power(k, cosmo)
    x = k * r[..., None]
    xs = torch.clamp_min(x, 0.1)
    w_formula = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    w_series = 1.0 - x ** 2 / 10.0 + x ** 4 / 280.0
    small = x < 0.1
    w = torch.where(small, w_series, w_formula)
    return k ** 3 * p, x, xs, small, w, lnk[1] - lnk[0]


def _trapz_lnk(integrand, dlnk):
    return torch.sum(0.5 * (integrand[..., 1:] + integrand[..., :-1]) * dlnk,
                     dim=-1)


def sigma_r(r_hmpc, cosmo: Cosmology, amplitude=1.0, nk: int = 1024):
    """sigma(R) of the (amplitude-scaled) linear power at z=0 (trapezoid in
    ln k over [1e-4, 50] h/Mpc), in float64 and of r's shape (0-d for a
    scalar). A tensor r keeps its device and its autograd graph, so one
    backward through a vector of radii gives every dsigma/dR; other r goes
    to the cosmology's device (the CPU for float fields)."""
    k3p, _, _, _, w, dlnk = _tophat_terms(r_hmpc, cosmo, amplitude, nk)
    integrand = k3p * w ** 2 / (2.0 * math.pi ** 2)  # d(ln k)
    return torch.sqrt(_trapz_lnk(integrand, dlnk))


def sigma_r_slope(r_hmpc, cosmo: Cosmology, amplitude=1.0, nk: int = 1024):
    """(sigma(R), d ln sigma / d ln R): `sigma_r` and its derivative in
    closed form, with W'(x) = 3 (sin x (x^2 - 3) + 3 x cos x) / x^4 (series
    -x/5 + x^3/70 below x = 0.1, where W takes its series), so
    d sigma^2 / d ln R = Int dlnk k^3 P 2 W W'(x) x / (2 pi^2). No nested
    autograd call: it composes with torch.func transforms of the
    cosmology (a Fisher Jacobian through `theory_hmf`)."""
    k3p, x, xs, small, w, dlnk = _tophat_terms(r_hmpc, cosmo, amplitude, nk)
    dw_formula = (3.0 * (torch.sin(xs) * (xs ** 2 - 3.0)
                         + 3.0 * xs * torch.cos(xs)) / xs ** 4)
    dw = torch.where(small, -x / 5.0 + x ** 3 / 70.0, dw_formula)
    var = _trapz_lnk(k3p * w ** 2 / (2.0 * math.pi ** 2), dlnk)
    dvar = _trapz_lnk(k3p * (2.0 * w * dw * x) / (2.0 * math.pi ** 2), dlnk)
    return torch.sqrt(var), 0.5 * dvar / var


def normalization(cosmo: Cosmology):
    """Amplitude A such that sigma(8 Mpc/h) = cosmo.sigma8: a float, or a
    0-d float64 tensor for a traced cosmology."""
    amp = (cosmo.sigma8 / sigma_r(8.0, cosmo, amplitude=1.0)) ** 2
    return amp if cosmo.traced else float(amp)


def linear_power(k_hmpc, cosmo: Cosmology, z=0.0, amplitude=None,
                 device=None):
    """Linear matter P(k, z) [(Mpc/h)^3], sigma8-normalized at z=0 (z a
    scalar). k is placed as in `eh98_transfer`."""
    if amplitude is None:
        amplitude = normalization(cosmo)
    d = _scalar(cosmo.growth_factor(z))
    k = _as_tensor(k_hmpc, device)
    return _scalar(amplitude) * _unnormalized_power(k, cosmo) * d ** 2


def linear_power_nowiggle(k_hmpc, cosmo: Cosmology, z=0.0, amplitude=None,
                          device=None):
    """Smooth (no-wiggle) linear P(k, z) [(Mpc/h)^3].

    Normalized with the same sigma8 amplitude as `linear_power` (from the
    full wiggly spectrum), so linear_power / linear_power_nowiggle is the
    acoustic pattern O(k) on a broadband ratio ~= 1. k is placed as in
    `eh98_transfer`.
    """
    if amplitude is None:
        amplitude = normalization(cosmo)
    d = _scalar(cosmo.growth_factor(z))
    k = _as_tensor(k_hmpc, device)
    t = eh98_transfer_nowiggle(k, cosmo)
    return _scalar(amplitude) * k ** cosmo.ns * t ** 2 * d ** 2


def kaiser_multipoles(k_hmpc, cosmo: Cosmology, z=0.0, bias: float = 1.0,
                      amplitude=None, device=None):
    """Linear Kaiser redshift-space multipoles (P0, P2, P4) [(Mpc/h)^3].

    P(k, mu) = b^2 (1 + beta mu^2)^2 P_lin(k), beta = f(z)/b:
      P0 = (1 + 2 beta/3 + beta^2/5) b^2 P_lin
      P2 = (4 beta/3 + 4 beta^2/7)   b^2 P_lin
      P4 = (8 beta^2 / 35)           b^2 P_lin
    k is placed as in `eh98_transfer`.
    """
    p = linear_power(k_hmpc, cosmo, z=z, amplitude=amplitude, device=device)
    f = _scalar(cosmo.growth_rate(z))
    beta = f / bias
    b2p = bias ** 2 * p
    p0 = (1.0 + 2.0 * beta / 3.0 + beta ** 2 / 5.0) * b2p
    p2 = (4.0 * beta / 3.0 + 4.0 * beta ** 2 / 7.0) * b2p
    p4 = (8.0 * beta ** 2 / 35.0) * b2p
    return p0, p2, p4


def _background(values, like):
    """Cosmology values as tensors beside `like`: a traced cosmology's
    float64 tensors as they are, the host route's float64 numpy cast to
    `like`'s dtype and device (the JAX package's tables are float32)."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.as_tensor(np.asarray(values, np.float64), device=like.device
                           ).to(like.dtype)


def _host_z(z):
    """z as the host route takes it (numpy for a tensor)."""
    return z.detach().cpu().numpy() if isinstance(z, torch.Tensor) else z


def p_dpdp(k_hmpc, z, cosmo: Cosmology, amplitude=None, device=None):
    """Linear ISW source power (arxiv:0809.4488 Eq. 6):
      P = (9/4) (H0/k)^4 Om^2 * H(z) * [D(z)(1-f(z))]^2 * P_dd(k, z=0)
    with H0 = 100 (h-units). z is a scalar or broadcasts against k's last
    axis. k is placed as in `eh98_transfer`; a traced cosmology gives its
    background in float64 tensors, in the graph."""
    k = _as_tensor(k_hmpc, device)
    p_dd = linear_power(k, cosmo, z=0.0, amplitude=amplitude)
    zq = z if cosmo.traced else _host_z(z)
    d = _background(cosmo.growth_factor(zq), k)
    f = _background(cosmo.growth_rate(zq), k)
    hz = 100.0 * _background(cosmo.efunc(zq), k)
    pref_static = 9.0 / 4.0 * (100.0 / k) ** 4 * cosmo.Om0 ** 2
    pref_dyn = hz * (d * (1.0 - f)) ** 2
    return pref_static * pref_dyn * p_dd


# ----------------------------------------------------- halofit (nonlinear)
def _sigma2_gauss(lnR, cosmo: Cosmology, amplitude, growth2, nk: int = 512):
    """sigma^2(R) with a GAUSSIAN window (halofit convention) and its first
    and second derivatives in ln R, on the host in float64.

    lnR and growth2 are scalars or arrays of one shape (one entry per
    redshift). The JAX package differentiates the trapezoid sum over
    ln k in [1e-4, 1e3] twice by autodiff; the derivative of that sum is
    the same sum over the differentiated integrand, which has a closed
    form: with y = k^2 R^2, d/dlnR exp(-y) = -2y exp(-y) and
    d2/dlnR2 exp(-y) = (4y^2 - 4y) exp(-y).
    """
    lnR = np.asarray(lnR, np.float64)[..., None]
    growth2 = np.asarray(growth2, np.float64)[..., None]
    lnk = torch.linspace(math.log(1e-4), math.log(1e3), nk,
                         dtype=torch.float64)
    k = torch.exp(lnk)
    pk = (k ** 3 * _unnormalized_power(k, cosmo)).numpy()
    d2l = float(amplitude) * growth2 * pk / (2.0 * math.pi ** 2)
    y = k.numpy() ** 2 * np.exp(2.0 * lnR)
    base = d2l * np.exp(-y)
    dlnk = float(lnk[1] - lnk[0])

    def trapz(f):
        return np.sum(0.5 * (f[..., 1:] + f[..., :-1]), axis=-1) * dlnk

    return (trapz(base), trapz(-2.0 * y * base),
            trapz((4.0 * y * y - 4.0 * y) * base))


def _takahashi(n, C, om_z, w, absolute):
    """The Takahashi+12 fit coefficients (flat wCDM; w = w0 in the DE
    correction) from n_eff, C and Omega_m(z): numpy arrays or tensors,
    with `absolute` the matching np.abs or torch.abs."""
    ode_z = 1.0 - om_z
    n2, n3, n4 = n ** 2, n ** 3, n ** 4
    return {
        "a_n": 10.0 ** (1.5222 + 2.8553 * n + 2.3706 * n2 + 0.9903 * n3
                        + 0.2250 * n4 - 0.6038 * C
                        + 0.1749 * ode_z * (1.0 + w)),
        "b_n": 10.0 ** (-0.5642 + 0.5864 * n + 0.5716 * n2 - 1.5474 * C
                        + 0.2279 * ode_z * (1.0 + w)),
        "c_n": 10.0 ** (0.3698 + 2.0404 * n + 0.8161 * n2 + 0.5869 * C),
        "gam": 0.1971 - 0.0843 * n + 0.8460 * C,
        "alp": absolute(6.0835 + 1.3373 * n - 0.1959 * n2 - 5.5274 * C),
        "bet": (2.0379 - 0.7354 * n + 0.3157 * n2 + 1.2490 * n3
                + 0.3980 * n4 - 0.1682 * C),
        "nu_n": 10.0 ** (5.2105 + 3.6902 * n),
        "f1": om_z ** -0.0307, "f2": om_z ** -0.0585, "f3": om_z ** 0.0743,
    }


def halofit_parameters(cosmo: Cosmology, z=0.0, amplitude=None) -> dict:
    """The redshift-dependent halofit numbers (Takahashi+2012, arXiv
    1208.2701 eqs. A1-A14), one per entry of `z`: the nonlinear scale
    `k_sigma` (sigma_G(1/k_sigma, z) = 1, by bisection), the effective
    index `n_eff`, the curvature `C` and the fit coefficients derived from
    them. They do not depend on k. Host float64 values for a cosmology
    with float fields; float64 tensors, in the graph, for a traced one
    (`_halofit_parameters_traced`)."""
    if amplitude is None:
        amplitude = normalization(cosmo)
    if cosmo.traced:
        return _halofit_parameters_traced(cosmo, z, amplitude)
    z = np.asarray(z, np.float64)
    g2 = np.asarray(cosmo.growth_factor(z), np.float64) ** 2

    # bisection for sigma^2(R) = 1 on lnR in [ln 1e-3, ln 1e2]
    lo = np.full(z.shape, math.log(1e-3))
    hi = np.full(z.shape, math.log(1e2))
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        high = _sigma2_gauss(mid, cosmo, amplitude, g2)[0] > 1.0
        lo, hi = np.where(high, mid, lo), np.where(high, hi, mid)
    lnR_s = 0.5 * (lo + hi)
    s2, ds2, d2s2 = _sigma2_gauss(lnR_s, cosmo, amplitude, g2)
    dln = ds2 / s2                      # d ln sigma^2 / d ln R
    n = -3.0 - dln
    C = -(d2s2 / s2 - dln ** 2)
    om_z = cosmo.Om0 * (1.0 + z) ** 3 / cosmo.efunc_a(1.0 / (1.0 + z)) ** 2
    return {"k_sigma": np.exp(-lnR_s), "n_eff": n, "C": C, "growth2": g2,
            **_takahashi(n, C, om_z, cosmo.w0, np.abs)}


def _halofit_parameters_traced(cosmo: Cosmology, z, amplitude,
                               nk: int = 512) -> dict:
    """`halofit_parameters` of a traced cosmology, as float64 tensors on
    its device. As in the JAX package, the bisection for ln R_s runs on
    detached values, so ln R_s (and k_sigma) carry no derivative: n_eff
    and C move with the parameters only through sigma^2 and its closed-
    form ln R derivatives (`_sigma2_gauss`) at that fixed ln R_s."""
    dev = cosmo.device
    z = cosmo._ops.asarray(z)
    g2 = cosmo.growth_factor(z) ** 2
    lnk = torch.linspace(math.log(1e-4), math.log(1e3), nk,
                         dtype=torch.float64, device=dev)
    k2 = torch.exp(2.0 * lnk)
    pk = torch.exp(3.0 * lnk) * _unnormalized_power(torch.exp(lnk), cosmo)
    d2l = amplitude * g2[..., None] * pk / (2.0 * math.pi ** 2)
    dlnk = lnk[1] - lnk[0]

    def trapz(f):
        return torch.sum(0.5 * (f[..., 1:] + f[..., :-1]), dim=-1) * dlnk

    lnR_s = _halofit_root(d2l.detach(), k2, dlnk)
    y = k2 * torch.exp(2.0 * lnR_s)[..., None]
    base = d2l * torch.exp(-y)
    s2 = trapz(base)
    dln = trapz(-2.0 * y * base) / s2
    n = -3.0 - dln
    C = -(trapz((4.0 * y * y - 4.0 * y) * base) / s2 - dln ** 2)
    om_z = cosmo.Om0 * (1.0 + z) ** 3 / cosmo.efunc_a(1.0 / (1.0 + z)) ** 2
    return {"k_sigma": torch.exp(-lnR_s), "n_eff": n, "C": C, "growth2": g2,
            **_takahashi(n, C, om_z, cosmo.w0, torch.abs)}


def _halofit_root(d2l, k2, dlnk):
    """ln R_s with sigma_G^2(R_s) = 1, by 48 bisection steps on lnR in
    [ln 1e-3, ln 1e2], of the Delta^2_lin(k) rows `d2l` (..., nk) on the
    ln k grid whose k^2 is `k2`: plain values, no graph."""
    lo = torch.full(d2l.shape[:-1], math.log(1e-3), dtype=d2l.dtype,
                    device=d2l.device)
    hi = torch.full_like(lo, math.log(1e2))
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        f = d2l * torch.exp(-k2 * torch.exp(2.0 * mid)[..., None])
        high = torch.sum(0.5 * (f[..., 1:] + f[..., :-1]), dim=-1) \
            * dlnk > 1.0
        lo, hi = torch.where(high, mid, lo), torch.where(high, hi, mid)
    return 0.5 * (lo + hi)


def _halofit_power(k, cosmo: Cosmology, amplitude, par):
    """Halofit P(k) from `halofit_parameters`: `par` holds Python floats
    (one redshift) or tensors that broadcast against k (one redshift per
    row)."""
    d2l = (k ** 3 * _scalar(amplitude) * par["growth2"]
           * _unnormalized_power(k, cosmo) / (2.0 * math.pi ** 2))
    y = k / par["k_sigma"]
    d2q = d2l * ((1.0 + d2l) ** par["bet"] / (1.0 + par["alp"] * d2l)) \
        * torch.exp(-y / 4.0 - y ** 2 / 8.0)
    d2hp = par["a_n"] * y ** (3.0 * par["f1"]) / (
        1.0 + par["b_n"] * y ** par["f2"]
        + (par["c_n"] * par["f3"] * y) ** (3.0 - par["gam"]))
    d2h = d2hp / (1.0 + par["nu_n"] / y ** 2)
    return (d2q + d2h) * 2.0 * math.pi ** 2 / k ** 3


def nonlinear_power(k_hmpc, cosmo: Cosmology, z=0.0, amplitude=None,
                    device=None):
    """Nonlinear matter P(k, z) via halofit (Takahashi+2012) on the EH98
    linear spectrum, z a scalar. A tensor k keeps its device and dtype;
    other input becomes float32 on `device`, by default the CUDA card (it
    raises without one: pass device="cpu"). The halofit numbers are
    Python floats for float fields and 0-d tensors for a traced
    cosmology."""
    if amplitude is None:
        amplitude = normalization(cosmo)
    if cosmo.traced:
        par = halofit_parameters(cosmo, z, amplitude)
    else:
        par = {name: float(v) for name, v in halofit_parameters(
            cosmo, float(z), amplitude).items()}
    return _halofit_power(_as_tensor(k_hmpc, device), cosmo, amplitude,
                          par)
