"""Analytic Gaussian covariances for the spectrum estimators, and the
spatial jackknife.

Port of astrild_tpu/ops/covariance.py: disconnected (Gaussian)
covariances of P(k), C_ell and the RSD multipoles on the exact discrete
mode set of this package's estimators (the same shell binning, Hermitian
weights, mu convention and mode numbers as `power.auto_power_multipoles`;
Grieb et al. 2016, arxiv:1509.04293, Eq. 16, summed over the FFT grid's
modes), and the delete-one spatial jackknife of a catalog statistic
(host numpy labels and resampling, the estimator on tensors).

Tensors keep their device; numpy input goes to `device`, by default the
CUDA card (it raises without one).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor, default_device

__all__ = ["gaussian_pk_covariance", "gaussian_cl_covariance",
           "gaussian_multipole_covariance", "spatial_jackknife_regions",
           "spatial_jackknife"]


def gaussian_pk_covariance(pk, nmodes, shotnoise: float = 0.0,
                           device=None):
    """Diagonal Gaussian covariance of a binned auto P(k):
    Var[P_b] = 2 (P_b + P_shot)^2 / N_b, N_b the Hermitian-weighted mode
    count (power.PowerResult.nmodes)."""
    pk = as_tensor(pk, device)
    nm = torch.clamp_min(as_tensor(nmodes, pk.device), 1.0)
    return 2.0 * (pk + shotnoise) ** 2 / nm


def gaussian_cl_covariance(cl, ells, fsky: float = 1.0, noise_cl=0.0,
                           delta_ell: float = 1.0, device=None):
    """Diagonal Gaussian covariance of an angular power spectrum:
    Var[C_l] = 2 (C_l + N_l)^2 / ((2l+1) fsky delta_l)."""
    cl = as_tensor(cl, device)
    ells = as_tensor(ells, cl.device)
    return (2.0 * (cl + noise_cl) ** 2
            / ((2.0 * ells + 1.0) * fsky * delta_ell))


def gaussian_multipole_covariance(ngrid: int, boxsize: float, nbins: int,
                                  p_iso_fn, beta: float = 0.0,
                                  bias: float = 1.0,
                                  shotnoise: float = 0.0,
                                  ells=(0, 2, 4), los: int = 2,
                                  kmin=None, kmax=None, device=None):
    """Gaussian covariance of `power.auto_power_multipoles` on THIS mode
    grid:

    C_{ll'}(k_b) = (2l+1)(2l'+1)/N_b^2 * sum_{m in b} w_m L_l(mu_m)
                   L_l'(mu_m) * 2 [b^2 (1+beta mu_m^2)^2 P_iso(|k_m|)
                                   + P_shot]^2

    with the estimator's shell binning, Hermitian weights w_m, mu
    convention and integer mode numbers. p_iso_fn: a callable of a |k|
    tensor [h/Mpc] giving the isotropic P(k) [(Mpc/h)^3]. The grid is made
    on `device` (default the CUDA card). Returns (k, cov (nell, nell,
    nbins), nmodes).
    """
    from .power import (_legendre_even, _mode_numbers, _shell_reduce,
                        get_shell_binning)

    dev = default_device(device)
    binidx, wf, nm, kmean = get_shell_binning(ngrid, nbins, kmin, kmax,
                                              device=dev)
    kf = 2.0 * math.pi / boxsize
    f = _mode_numbers(ngrid, dev)
    fz = _mode_numbers(ngrid, dev, real=True)
    ax = (f[:, None, None], f[None, :, None], fz[None, None, :])
    m2 = ax[0] ** 2 + ax[1] ** 2 + ax[2] ** 2
    mu2 = torch.where(m2 == 0.0, torch.zeros_like(m2),
                      ax[los] ** 2 / torch.clamp_min(m2, 1e-12))
    kmag = torch.sqrt(m2) * kf
    pkmu = (bias ** 2 * (1.0 + beta * mu2) ** 2
            * p_iso_fn(torch.clamp_min(kmag, 1e-6)) + shotnoise)
    var2 = 2.0 * pkmu ** 2

    nell = len(ells)
    legs = [_legendre_even(ell, mu2) for ell in ells]
    out = torch.zeros((nell, nell, nbins), dtype=torch.float32, device=dev)
    for i in range(nell):
        for j in range(i, nell):
            pref = (2 * ells[i] + 1) * (2 * ells[j] + 1)
            vals = (pref * legs[i] * legs[j] * var2).reshape(-1)
            # _shell_reduce divides by nm once; once more for the 1/N_b^2
            # of the estimator's covariance
            c = (_shell_reduce(vals, binidx, wf, nm)
                 / torch.clamp_min(nm, 1.0))
            out[i, j] = c
            out[j, i] = c
    return kmean * kf, out, nm


def spatial_jackknife_regions(pos, boxsize, n_side: int):
    """Cubic-subvolume jackknife region label (0..n_side^3-1) per row, host
    numpy (the labels drive host resampling loops). pos: (n, 3) array or
    flat-component tuple (tensors are read back)."""
    comps = [_host(c).reshape(-1) for c in pos] \
        if isinstance(pos, (tuple, list)) else list(_host(pos).T)
    cell = float(boxsize) / n_side
    idx = [np.clip((c / cell).astype(np.int64), 0, n_side - 1)
           for c in comps]
    return (idx[0] * n_side + idx[1]) * n_side + idx[2]


def _host(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def spatial_jackknife(est_fn, pos, boxsize, n_side: int = 3,
                      extra_cols=(), device=None):
    """Delete-one spatial jackknife covariance of a catalog statistic.

    est_fn(pos_padded, n_valid, *cols_padded) -> (nstat,) vector, called
    with tensors on `device` (default the CUDA card); it must honour
    `n_valid` (rows [n_valid:] are zero padding), the contract of this
    package's pair estimators. Every leave-one-out sample is padded to
    ONE shape.

    Returns numpy (theta_full, theta_jk (nreg, nstat), cov (nstat, nstat))
    with the delete-one factor (nreg-1)/nreg times the sum of outer
    products around the jackknife mean.
    """
    dev = default_device(device)
    labels = spatial_jackknife_regions(pos, boxsize, n_side)
    nreg = n_side ** 3
    arr = (np.stack([_host(c).reshape(-1) for c in pos], axis=-1)
           if isinstance(pos, (tuple, list)) else _host(pos))
    cols = [_host(c) for c in extra_cols]
    n = arr.shape[0]
    counts = np.bincount(labels, minlength=nreg)
    n_pad = int(n - counts.min())

    def run(a, n_valid, cs):
        return _host(est_fn(as_tensor(a, dev), n_valid,
                            *[as_tensor(c, dev) for c in cs]))

    theta_full = run(arr, n, cols)
    samples = []
    for r in range(nreg):
        keep = labels != r
        nk = int(keep.sum())
        sub = np.zeros((n_pad, arr.shape[1]), arr.dtype)
        sub[:nk] = arr[keep]
        sub_cols = []
        for c in cols:
            cc = np.zeros((n_pad,) + c.shape[1:], c.dtype)
            cc[:nk] = c[keep]
            sub_cols.append(cc)
        samples.append(run(sub, nk, sub_cols))
    theta_jk = np.stack(samples)
    d = theta_jk - theta_jk.mean(axis=0)
    cov = (nreg - 1) / nreg * np.einsum("ri,rj->ij", d, d)
    return theta_full, theta_jk, cov
