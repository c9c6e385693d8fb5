"""Minkowski functionals of flat-sky maps (area, boundary length, genus).

Port of astrild_tpu/ops/minkowski.py: the local Koenderink-invariant
estimators (Kratochvil et al. 2012, arXiv:1109.6334, eqs. 11-13), per-pixel
integrands binned over thresholds with the port's `power._shell_reduce`:

    V0(nu) = (1/A) int Theta(f - nu sigma0) dA             (area fraction)
    V1(nu) = (1/4A) int delta(f - nu sigma0) |grad f| dA   (boundary length)
    V2(nu) = (1/2piA) int delta(f - nu sigma0) K dA        (Euler char.)

with K = (2 fx fy fxy - fx^2 fyy - fy^2 fxx) / (fx^2 + fy^2). Gradients
are `jnp.gradient`'s (central inside, one-sided at the edges) in pixel
units, or per radian with `opening_angle_deg`; the spacing divides as a
device tensor. The Gaussian predictions (`gaussian_minkowski`, Tomita 1986)
use the same sigma1 convention. Numpy input goes to `device`, by default
the CUDA card (it raises without one); tensors keep their device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._device import as_tensor
from .power import _shell_reduce

__all__ = ["minkowski_functionals", "gaussian_minkowski", "map_moments"]


def _gradient(f, h, dim: int):
    """jnp.gradient(f, h, axis=dim): (f[2:] - f[:-2]) * 0.5 inside, first
    differences at the two edges, all divided by the spacing h (a 0-d
    tensor)."""
    n = f.shape[dim]
    sl = lambda a, b: f.narrow(dim, a, b - a)  # noqa: E731
    g = torch.cat([sl(1, 2) - sl(0, 1), (sl(2, n) - sl(0, n - 2)) * 0.5,
                   sl(n - 1, n) - sl(n - 2, n - 1)], dim=dim)
    return g / h


def _derivatives(img, pix):
    fx, fy = _gradient(img, pix, 0), _gradient(img, pix, 1)
    return fx, fy, _gradient(fx, pix, 0), _gradient(fx, pix, 1), \
        _gradient(fy, pix, 1)


def _mf_core(img, edges, pix):
    dev = img.device
    nbins = edges.shape[0] - 1
    n = img.numel()
    flat = img.reshape(-1).contiguous()
    fx, fy, fxx, fxy, fyy = _derivatives(img, pix)
    g2 = fx * fx + fy * fy
    grad = torch.sqrt(g2)
    pos = g2 > 0
    curv = torch.where(
        pos, (2.0 * fx * fy * fxy - fx * fx * fyy - fy * fy * fxx)
        / torch.where(pos, g2, torch.ones_like(g2)), torch.zeros_like(g2))
    # bin index over threshold edges; out of range -> padding bin nbins
    bi = torch.searchsorted(edges, flat, right=True) - 1
    bi = torch.where((flat < edges[0]) | (flat >= edges[-1]), nbins,
                     torch.clamp(bi, 0, nbins - 1))
    nm = torch.full((nbins,), float(n), dtype=torch.float32, device=dev)
    dnu = edges[1:] - edges[:-1]
    v1 = _shell_reduce(grad.reshape(-1), bi, 1.0, nm) / (4.0 * dnu)
    v2 = (_shell_reduce(curv.reshape(-1), bi, 1.0, nm)
          / (torch.tensor(2.0 * math.pi, device=dev) * dnu))
    # V0 at bin midpoints: exceedance fraction via one histogram + cumsum
    mids = 0.5 * (edges[1:] + edges[:-1])
    c = torch.searchsorted(mids, flat, right=True)
    hist = _shell_reduce(torch.ones(n, device=dev), c, 1.0,
                         torch.full((nbins + 1,), float(n), device=dev))
    v0 = 1.0 - torch.cumsum(hist, dim=0)[:nbins]
    return mids, v0, v1, v2


def minkowski_functionals(img, nbins: int = 32,
                          limits: Optional[tuple] = None,
                          opening_angle_deg: Optional[float] = None,
                          device=None):
    """Minkowski functionals V0, V1, V2 over a threshold ladder.

    Args:
      img: (n, n) map.
      nbins: number of threshold bins.
      limits: (lo, hi) threshold range in map units; default +-3.5 std
        around the mean.
      opening_angle_deg: if given, derivatives are per radian (V1 in
        1/rad, V2 in 1/rad^2); otherwise per pixel.

    Returns dict with `nu` (bin-midpoint thresholds, map units), `V0`,
    `V1`, `V2` (numpy arrays).
    """
    img = as_tensor(img, device).to(torch.float32)
    dev = img.device
    if limits is None:
        mu = float(torch.mean(img))
        sd = float(torch.std(img, correction=0))
        limits = (mu - 3.5 * sd, mu + 3.5 * sd)
    edges = torch.from_numpy(
        np.linspace(float(limits[0]), float(limits[1]), nbins + 1,
                    dtype=np.float32)).to(dev)
    pix = (float(np.deg2rad(opening_angle_deg)) / img.shape[0]
           if opening_angle_deg is not None else 1.0)
    mids, v0, v1, v2 = _mf_core(img, edges, torch.tensor(
        pix, dtype=torch.float32, device=dev))
    return {k: v.cpu().numpy() for k, v in
            (("nu", mids), ("V0", v0), ("V1", v1), ("V2", v2))}


def gaussian_minkowski(nu, sigma0: float, sigma1: float, device=None):
    """Analytic Minkowski functionals of a 2D Gaussian random field
    (Tomita 1986; Kratochvil et al. 2012 eqs. 16-18).

    Args:
      nu: thresholds in units of sigma0 (standardized).
      sigma0: field std; sigma1 = sqrt(<|grad f|^2>) in the SAME length
        convention as the measurement (per-pixel or per-radian).

    Returns (V0, V1, V2) tensors.
    """
    nu = as_tensor(nu, device)
    sqrt2 = torch.sqrt(torch.tensor(2.0, device=nu.device))
    a = sigma1 / (sqrt2 * sigma0)
    v0 = 0.5 * torch.special.erfc(nu / sqrt2)
    v1 = (a / 8.0) * torch.exp(-0.5 * nu * nu)
    v2 = (a * a) / (2.0 * math.pi) ** 1.5 * nu * torch.exp(-0.5 * nu * nu)
    return v0, v1, v2


def map_moments(img, device=None):
    """One-point and gradient moments: sigma0, sigma1 (per pixel),
    skewness and excess kurtosis (0-d tensors)."""
    img = as_tensor(img, device).to(torch.float32)
    mu = torch.mean(img)
    d = img - mu
    s0 = torch.sqrt(torch.mean(d * d))
    one = torch.ones((), device=img.device)
    fx, fy = _gradient(img, one, 0), _gradient(img, one, 1)
    s1 = torch.sqrt(torch.mean(fx * fx + fy * fy))
    skew = torch.mean(d ** 3) / s0 ** 3
    kurt = torch.mean(d ** 4) / s0 ** 4 - 3.0
    return {"mean": mu, "sigma0": s0, "sigma1": s1,
            "skewness": skew, "kurtosis": kurt}
