"""3D bispectrum B(k1,k2,k3) on torch tensors (FFT shell estimator).

Port of astrild_tpu/ops/bispectrum.py (`bispectrum_3d`):

  I_i(x) = irfftn(mask_i(k) * rfftn(delta)),  n_i(x) = ifftn(mask_i(k))
  B(b1,b2,b3) = V^2 * sum_x I_1 I_2 I_3 / sum_x n_1 n_2 n_3

The mask-only denominators are input-independent and built once on the
host in float64 numpy (copied from the JAX package); shells are selected on
exact integer squared mode numbers, so membership is identical on host and
device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils.tables import tables_from_numpy
from .power import _mode_numbers

__all__ = ["BispectrumResult", "bispectrum_3d", "get_bispectrum_tables",
           "shell_edges_sq", "band_limited_size"]


class BispectrumResult(NamedTuple):
    k1: torch.Tensor     # (ntri,) mean |k| of shell 1 [h/Mpc]
    k2: torch.Tensor
    k3: torch.Tensor
    b: torch.Tensor      # (ntri,) bispectrum [(Mpc/h)^6]
    ntri: torch.Tensor   # (ntri,) triangle counts (mode-space)


def shell_edges_sq(m_min, m_max, nbins: int):
    """Squared shell edges for exact mode selection: comparisons run on
    the integer m2 = fi^2+fj^2+fk^2 (exact in f32), so shell membership
    is identical across host and device."""
    e = np.linspace(float(m_min), float(m_max), nbins + 1)
    return (e * e).astype(np.float32)


@lru_cache(maxsize=16)
def bispectrum_tables_host(n: int, nbins: int, m_min: float, m_max: float):
    """Input-independent shell tables in numpy: triangle-count
    normalizations den[t] = sum_x n_a n_b n_c (float64), mean shell radii
    (float64), the squared edges (float32) and the triple indices.

    Returns (edges_sq, den, mmean, ta, tb, tc).
    """
    edges_sq = shell_edges_sq(m_min, m_max, nbins)
    f = (np.fft.fftfreq(n) * n).astype(np.float32)
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[None, None, :] ** 2).astype(np.float32)  # exact integers
    m = np.sqrt(m2.astype(np.float64))
    n_fs, mmean = [], []
    for b in range(nbins):
        mask = ((m2 >= edges_sq[b]) & (m2 < edges_sq[b + 1]))
        n_fs.append(np.fft.ifftn(mask.astype(np.float64)).real)
        cnt = mask.sum()
        mmean.append(float((m * mask).sum() / max(cnt, 1)))
    triples = [(a, b, c) for a in range(nbins) for b in range(a, nbins)
               for c in range(b, nbins)]
    den = np.array([float((n_fs[a] * n_fs[b] * n_fs[c]).sum())
                    for (a, b, c) in triples])
    ta = np.array([t[0] for t in triples])
    tb = np.array([t[1] for t in triples])
    tc = np.array([t[2] for t in triples])
    return edges_sq, den, np.asarray(mmean), ta, tb, tc


_DEVICE_TABLES = {}


def get_bispectrum_tables(n: int, nbins: int, m_min: float, m_max: float,
                          device=None):
    """`bispectrum_tables_host` as tensors on `device` (cached): float32
    (edges_sq, den, mmean) and int64 (ta, tb, tc)."""
    key = (n, nbins, float(m_min), float(m_max),
           str(torch.device(device or "cpu")))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = tables_from_numpy(
            bispectrum_tables_host(n, nbins, float(m_min), float(m_max)),
            device)
    return _DEVICE_TABLES[key]


def _bispectrum_core(delta, boxsize, nbins: int, edges_sq, den, mmean,
                     ta, tb, tc, n_c: int | None = None):
    n = delta.shape[-1]
    kf = 2.0 * np.pi / boxsize
    # real shell fields and hermitian-symmetric masks: every transform
    # runs on the rfft half-spectrum
    dk = torch.fft.rfftn(delta)

    # Band-limit truncation: every shell mask vanishes beyond m_max, so the
    # inverse shell transforms can run on a coarse n_c grid. Exact when
    # m_max < n_c/2 and n_c > 3*m_max (no triple-sum aliasing); the caller
    # guarantees both when it passes n_c. den is precomputed at the same
    # n_c, so B keeps the /n^9 normalization.
    if n_c is not None and n_c < n:
        h = n_c // 2
        dk = torch.cat([dk[:h], dk[n - h:]], dim=0)
        dk = torch.cat([dk[:, :h], dk[:, n - h:]], dim=1)
        dk = dk[:, :, : h + 1]
        nt = n_c
    else:
        nt = n
    fx = _mode_numbers(nt, delta.device)
    fz = _mode_numbers(nt, delta.device, real=True)
    m2 = (fx[:, None, None] ** 2 + fx[None, :, None] ** 2
          + fz[None, None, :] ** 2)

    i_fs = []
    for b in range(nbins):
        mask = ((m2 >= edges_sq[b]) & (m2 < edges_sq[b + 1])).to(
            torch.float32)
        i_fs.append(torch.fft.irfftn(mask * dk, s=(nt, nt, nt)))
    i_fs = torch.stack(i_fs)

    num = (i_fs[ta] * i_fs[tb] * i_fs[tc]).sum(dim=(1, 2, 3))
    ntris = den * float(nt) ** 6  # total closed triangles in mode space
    bvals = torch.where(den > 1e-10,
                        boxsize ** 6 * num / torch.clamp(den, min=1e-30)
                        / float(n) ** 9,
                        torch.full_like(num, float("nan")))
    return BispectrumResult(k1=mmean[ta] * kf, k2=mmean[tb] * kf,
                            k3=mmean[tc] * kf, b=bvals, ntri=ntris)


def band_limited_size(n: int, m_max) -> int:
    """Grid side the shell transforms run on: the smallest power of two
    (>= 16) above 3*m_max, so the triple products cannot alias, capped at
    the input grid side n."""
    n_c = 16
    while n_c <= 3.0 * float(m_max):
        n_c *= 2
    return min(n_c, n)


def bispectrum_3d(grid, boxsize, nbins: int = 8, m_min: float = 1.0,
                  m_max=None):
    """3D bispectrum of a density grid over all unique shell triples.

    Args:
      grid: (n, n, n) density (contrast taken internally).
      boxsize: box side [Mpc/h].
      nbins: number of |k| shells between m_min and m_max (mode units,
        i.e. |k|/kf).
    Returns BispectrumResult over i<=j<=k shell triples (open triangles
    have ntri=0 and B=NaN).
    """
    n = grid.shape[-1]
    mean = grid.mean()
    delta = grid / torch.where(mean == 0, torch.ones_like(mean), mean) - 1.0
    if m_max is None:
        m_max = n / 2.0 - 1.0
    n_c = band_limited_size(n, m_max)
    tables = get_bispectrum_tables(n_c, nbins, float(m_min), float(m_max),
                                   device=grid.device)
    return _bispectrum_core(delta, boxsize, nbins, *tables, n_c=n_c)
