"""FFTLog spherical- and cylindrical-Bessel (Hankel) transforms: P(k) <->
xi(r), and the projected wp(rp) of a tabulated P(k).

Port of astrild_tpu/ops/fftlog.py (Hamilton 2000,
arxiv:astro-ph/9905191): a log-spaced FFT, an analytic Mellin kernel, and
a second log-spaced FFT. The Mellin kernels and the taper are host numpy
precomputes, copied from the JAX package unchanged so that they are
bit-identical (cached per (N, dlnk, ell, bias) as numpy arrays); the FFTs
run in torch on the device of the integrand. The k grid is a host grid
(numpy, or a tensor that is read back).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .._device import as_theory_tensor
from ..utils.tables import interp as _interp

__all__ = ["sph_bessel_transform", "xi_multipoles_from_pk", "wp_from_pk",
           "correlation_from_power", "bessel_transform"]


@lru_cache(maxsize=64)
def _fftlog_kernel(n: int, dlnk: float, ell: int, q: float):
    """Host-precomputed FFTLog frequency kernel M_ell(q + i eta_m) with
    the s-grid alignment phase baked in.

    M_ell(z) = Int_0^inf j_ell(x) x^{z-1} dx
             = 2^{z-2} sqrt(pi) Gamma((ell+z)/2) / Gamma((ell+3-z)/2).
    """
    from scipy.special import loggamma

    eta = 2.0 * np.pi * np.fft.fftfreq(n) / dlnk  # eta_m = 2 pi m/(N dlnk)
    z = q + 1j * eta
    logm = ((z - 2.0) * np.log(2.0) + 0.5 * np.log(np.pi)
            + loggamma((ell + z) / 2.0) - loggamma((ell + 3.0 - z) / 2.0))
    m = np.exp(logm)
    # s_j = e^{j dlnk}/k_max  ->  ln(k0 s_j) = (j - n + 1) dlnk; absorb the
    # (n-1) offset into the kernel phase
    phase = np.exp(1j * eta * (n - 1) * dlnk)
    mp = m * phase
    return (np.real(mp).astype(np.float32),
            np.imag(mp).astype(np.float32))


@lru_cache(maxsize=64)
def _fftlog_kernel_cyl(n: int, dlnk: float, mu: int, q: float):
    """Cylindrical-Bessel Mellin kernel with the r-grid phase baked in.

    M_mu(z) = Int_0^inf J_mu(x) x^{z-1} dx
            = 2^{z-1} Gamma((mu+z)/2) / Gamma((mu+2-z)/2),
    convergent for -mu < Re z < 3/2.
    """
    from scipy.special import loggamma

    if not (-mu < q < 1.5):
        raise ValueError(
            f"bessel_transform bias q={q} outside the Mellin strip "
            f"(-{mu}, 1.5) of J_{mu}")
    eta = 2.0 * np.pi * np.fft.fftfreq(n) / dlnk
    z = q + 1j * eta
    logm = ((z - 1.0) * np.log(2.0)
            + loggamma((mu + z) / 2.0) - loggamma((mu + 2.0 - z) / 2.0))
    m = np.exp(logm)
    phase = np.exp(1j * eta * (n - 1) * dlnk)
    mp = m * phase
    return (np.real(mp).astype(np.float32),
            np.imag(mp).astype(np.float32))


def _taper(n: int, frac: float = 0.1):
    """Cosine end-taper reducing log-periodic ringing from the implicit
    periodicity of the FFT decomposition (float32, as the JAX package
    hands it to the device)."""
    m = max(int(n * frac), 1)
    w = np.ones(n)
    x = 0.5 * (1.0 - np.cos(np.pi * np.arange(m) / m))
    w[:m] = x
    w[n - m:] = x[::-1]
    return w.astype(np.float32)


def _bias(k, k0: float, power: float, w):
    """(k/k0)^power * w in float32: the host power cast to float32, then
    the float32 product, as the JAX package forms it."""
    return ((k / k0) ** power).astype(np.float32) * w


def _host_grid(k, name: str):
    k = (k.detach().cpu().numpy() if isinstance(k, torch.Tensor)
         else np.asarray(k))
    k = k.astype(np.float64)
    n = k.shape[0]
    dln = float(np.log(k[-1] / k[0]) / (n - 1))
    if not np.allclose(np.diff(np.log(k)), dln, rtol=1e-4):
        raise ValueError(f"{name} needs log-uniform k")
    return k, n, dln


def _fftlog(fk, bias, kern, scale):
    """Re FFT(FFT(f bias) M) * scale along the last axis, in float32, or
    in float64 for a float64 integrand (the host tables cast up)."""
    dev = fk.device
    dt = torch.float64 if fk.dtype == torch.float64 else torch.float32
    bias, scale = (torch.as_tensor(a, dtype=dt, device=dev)
                   for a in (bias, scale))
    kern_re, kern_im = (torch.as_tensor(a, dtype=dt, device=dev)
                        for a in kern)
    am = torch.fft.fft(fk.to(dt) * bias, dim=-1)
    ar, ai = am.real, am.imag
    b = torch.complex(ar * kern_re - ai * kern_im,
                      ar * kern_im + ai * kern_re)
    return torch.fft.fft(b, dim=-1).real * scale


def bessel_transform(k, fk, mu: int, q: float = 1.0,
                     taper_frac: float = 0.1, device=None):
    """2D Hankel transform I(r) = Int_0^inf f(k) J_mu(k r) k dk on a
    log-spaced grid (FFTLog with the cylindrical-Bessel Mellin kernel).

    Args:
      k: (n,) log-uniform grid (ascending) — wavenumbers or multipoles.
      fk: (n,) or (..., n) integrand f(k); a tensor keeps its device,
        numpy input goes to `device`, by default the CUDA card (it raises
        without one). A float64 tensor is transformed in float64 (r and I
        float64 too); everything else in float32.
      mu: Bessel order J_mu.
      q: FFTLog bias, must lie in the Mellin strip (-mu, 1.5).
    Returns:
      (r, I): r (n,) log-spaced in [1/k_max, 1/k_min]; I same shape as fk.
    """
    k, n, dln = _host_grid(k, "bessel_transform")
    k0 = float(k[0])
    kern = _fftlog_kernel_cyl(n, dln, mu, q)
    w = _taper(n, taper_frac)
    j = np.arange(n)
    r = np.exp(j * dln) / (k0 * np.exp((n - 1) * dln))
    # k dk = k^2 dlnk: biased series a = f(k) (k/k0)^{2-q},
    # I_j = k0^2 (k0 r_j)^{-q} Re FFT(A_m M_m)[j] / N
    fk = as_theory_tensor(fk, device)
    out = _fftlog(fk, _bias(k, k0, 2.0 - q, w), kern,
                  k0 ** 2 * (k0 * r) ** (-q) / n)
    return torch.as_tensor(r, dtype=out.dtype, device=fk.device), out


def sph_bessel_transform(k, fk, ell: int, q: float = 1.5,
                         taper_frac: float = 0.1, device=None):
    """I(s) = Int_0^inf f(k) j_ell(k s) k^2 dk on a log-spaced k grid.

    Args:
      k: (n,) log-uniformly spaced wavenumbers (ascending), a host grid.
      fk: (n,) or (..., n) integrand values f(k), placed as in
        `bessel_transform`.
      ell: spherical-Bessel order.
      q: FFTLog bias exponent (1.5 balances the k->0 and k->inf tails of
        P(k)-like integrands).
    Returns:
      (s, I): s (n,) log-spaced in [1/k_max, 1/k_min]; I same shape as fk.
    """
    k, n, dln = _host_grid(k, "sph_bessel_transform")
    k0 = float(k[0])
    kern = _fftlog_kernel(n, dln, ell, q)
    w = _taper(n, taper_frac)
    j = np.arange(n)
    s = np.exp(j * dln) / (k0 * np.exp((n - 1) * dln))  # 1/kmax .. 1/kmin
    # biased series a = f(k) (k/k0)^{3-q}; I_j = k0^3 (k0 s_j)^{-q} *
    #   Re FFT(A_m M_m)[j] / N
    fk = as_theory_tensor(fk, device)
    out = _fftlog(fk, _bias(k, k0, 3.0 - q, w), kern,
                  k0 ** 3 * (k0 * s) ** (-q) / n)
    return torch.as_tensor(s, dtype=out.dtype, device=fk.device), out


def xi_multipoles_from_pk(k, p_ells, ells=(0, 2, 4), q: float = 1.5,
                          device=None):
    """Correlation multipoles xi_ell(s) from power multipoles P_ell(k).

    xi_ell(s) = i^ell/(2 pi^2) Int k^2 P_ell(k) j_ell(ks) dk; for the even
    ells of an auto-spectrum i^ell = (-1)^{ell/2}.

    p_ells: (nell, n) stacked multipoles in the order of `ells`, placed as
    fk in `bessel_transform`. Returns (s, xi) with xi (nell, n).
    """
    p_ells = as_theory_tensor(p_ells, device)
    rows = []
    s = None
    for i, ell in enumerate(ells):
        if ell % 2:
            raise ValueError(
                f"xi_multipoles_from_pk handles even ell only (got {ell}):"
                " odd multipoles carry an imaginary i^ell prefactor")
        sign = (-1.0) ** (ell // 2)
        s, ir = sph_bessel_transform(k, p_ells[i], ell, q=q)
        rows.append(sign / (2.0 * math.pi ** 2) * ir)
    return s, torch.stack(rows)


def correlation_from_power(k, pk, q: float = 1.5, device=None):
    """Real-space xi(r) from P(k): the ell=0 case."""
    pk = as_theory_tensor(pk, device)
    s, xi = xi_multipoles_from_pk(k, pk[None, :], ells=(0,), q=q)
    return s, xi[0]


def wp_from_pk(k, pk, rp, pi_max, q: float = 1.5, n_pi: int = 256,
               device=None):
    """Theory projected correlation wp(rp) = 2 int_0^pi_max
    xi(sqrt(rp^2 + pi^2)) dpi from a tabulated P(k).

    The theory counterpart of ops.tpcf.projected_tpcf (same finite pi_max
    convention). xi comes from the FFTLog transform above; the pi integral
    is a trapezoid over the interpolated xi.

    Args:
      k, pk: log-spaced P(k) table (h/Mpc, (Mpc/h)^3); pk placed as fk in
        `bessel_transform`.
      rp: (nrp,) projected radii (follows pk's device).
      pi_max: LOS integration bound [Mpc/h].
    Returns (nrp,) wp.
    """
    s, xi = correlation_from_power(k, pk, q=q, device=device)
    dev = xi.device
    lns = torch.log(s)
    step = torch.arange(n_pi, dtype=xi.dtype, device=dev) / float(n_pi)
    # jnp.linspace(0, pi_max, n_pi + 1) in xi's dtype
    pi_grid = torch.cat([0.0 * (1 - step) + pi_max * step,
                         torch.tensor([float(pi_max)], dtype=xi.dtype,
                                      device=dev)])
    rp = as_theory_tensor(rp, dev).reshape(-1).to(xi.dtype)
    r = torch.sqrt(rp[:, None] ** 2 + pi_grid[None, :] ** 2)
    xi_r = _interp(torch.log(torch.clamp_min(r, s[0])), lns, xi)
    return 2.0 * torch.trapezoid(xi_r, pi_grid, dim=-1)
