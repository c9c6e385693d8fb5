"""Distributed 3D bispectrum over the mesh (pencil-FFT shells).

Port of astrild_tpu/parallel/bispectrum.py, the mesh version of
ops.bispectrum.bispectrum_3d: the density grid arrives pencil-sharded
P('x','y',None); one forward pencil FFT, then either one inverse pencil
FFT per |k| shell (the full body) or, when 3 * m_max < n, a single psum of
the coarse spectrum corner and local shell transforms at n_c (the
truncated body); the triple products reduce with psum.

  B(b1,b2,b3) = V^2 * sum_x Re[I_1 I_2 I_3] / sum_x Re[n_1 n_2 n_3]

Identical normalization & shell edges to the single-device estimator
(selection on the exact integer m2), so results agree up to float
reassociation.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.bispectrum import (BispectrumResult, get_bispectrum_tables,
                              shell_edges_sq)
from ..ops.power import _mode_numbers
from .mesh import axis_index, axis_size, psum, to_mesh
from .pfft import pfft3d_local, pifft3d_local
from .power import _contrast, _global_mean, local_mode_numbers

__all__ = ["make_distributed_bispectrum", "bispectrum_shard_body"]


def _coarse_size(ngrid: int, m_max: float) -> int:
    """Smallest power-of-two shell-transform grid with no triple aliasing
    (same rule as ops.bispectrum.bispectrum_3d): n_c > 3*m_max."""
    n_c = 16
    while n_c <= 3.0 * float(m_max):
        n_c *= 2
    return min(n_c, ngrid)


def _triples(nbins: int):
    return [(a, b, c) for a in range(nbins) for b in range(a, nbins)
            for c in range(b, nbins)]


def bispectrum_shard_body(block, *, mesh, ngrid: int, boxsize: float,
                          nbins: int, m_min: float, m_max: float):
    """Per-rank bispectrum body on this rank's pencil block.

    Module-level so composed pipelines (parallel/suite.py) reuse the exact
    estimator; see make_distributed_bispectrum for the algorithm.
    """
    triples = _triples(nbins)
    n_c = _coarse_size(ngrid, m_max)
    if n_c < ngrid:
        return _bispectrum_body_truncated(block, mesh, ngrid, boxsize,
                                          nbins, m_min, m_max, triples, n_c)
    return _bispectrum_body(block, mesh, ngrid, boxsize, nbins, m_min,
                            m_max, triples)


def make_distributed_bispectrum(mesh, ngrid: int, boxsize: float,
                                nbins: int = 4, m_min: float = 1.0,
                                m_max: Optional[float] = None):
    """Distributed B(k1,k2,k3) estimator over `mesh`.

    Returns fn(block) -> BispectrumResult where block is this rank's
    P('x','y',None) block of a global (n,n,n) density; the result is
    replicated. Shells are |k|/kf in [m_min, m_max] (default m_max =
    n/2 - 1).
    """
    mmax = (ngrid / 2.0 - 1.0) if m_max is None else m_max

    def fn(block):
        return bispectrum_shard_body(to_mesh(block, mesh), mesh=mesh,
                                     ngrid=ngrid,
                                     boxsize=boxsize, nbins=nbins,
                                     m_min=m_min, m_max=mmax)

    return fn


def _delta(block, mesh, ngrid):
    return _contrast(block, _global_mean(block, mesh, ngrid))


def _result(k_units, bvals, ntris, triples, boxsize):
    kf = 2.0 * math.pi / boxsize
    return BispectrumResult(
        k1=torch.stack([k_units[a] for a, _, _ in triples]) * kf,
        k2=torch.stack([k_units[b] for _, b, _ in triples]) * kf,
        k3=torch.stack([k_units[c] for _, _, c in triples]) * kf,
        b=torch.stack(bvals), ntri=torch.stack(ntris))


def _bvalue(num, den, boxsize, ngrid):
    return torch.where(den > 1e-10,
                       boxsize ** 6 * num / torch.clamp(den, min=1e-30)
                       / float(ngrid) ** 9,
                       torch.full_like(num, float("nan")))


def _bispectrum_body_truncated(block, mesh, ngrid, boxsize, nbins, m_min,
                               mmax, triples, n_c):
    """Band-limited distributed estimator: ONE forward pencil FFT, then
    the coarse spectrum corner (every mode any shell can select lives at
    |f| <= m_max < n_c/2) is assembled REPLICATED with a single psum of
    n_c^3 complex values and the nbins shell inverse transforms run
    locally at n_c (see ops.bispectrum._bispectrum_core for the exactness
    argument and the normalization)."""
    dev = block.device
    dk = pfft3d_local(_delta(block, mesh, ngrid), mesh)  # (n, n/PX, n/PY)
    # each rank gathers the coarse modes it owns; the psum assembles and
    # replicates the corner. Pencil layout after pfft3d_local: axis 0
    # carries the full kx in fftfreq order (mode f at row f mod n), axes
    # 1/2 carry contiguous fftfreq-order slices of ky/kz
    h = n_c // 2
    nj = ngrid // axis_size(mesh, "x")
    nk = ngrid // axis_size(mesh, "y")
    xi = axis_index(mesh, "x")
    yi = axis_index(mesh, "y")
    c = torch.arange(n_c ** 3, dtype=torch.int64, device=dev)
    cz = c % n_c
    cy = (c // n_c) % n_c
    cx = c // (n_c * n_c)

    def signed_and_global(ci):
        f = ci - n_c * (ci >= h).to(torch.int64)
        return f, torch.remainder(f, ngrid)

    fx, gx = signed_and_global(cx)
    fy, gy = signed_and_global(cy)
    fz, gz = signed_and_global(cz)
    ly = gy - xi * nj
    lz = gz - yi * nk
    # coarse-Nyquist planes (f = -h) hold only modes the shells mask out
    own = ((fx.abs() < h) & (fy.abs() < h) & (fz.abs() < h)
           & (ly >= 0) & (ly < nj) & (lz >= 0) & (lz < nk))
    lidx = (gx * nj + ly.clamp(0, nj - 1)) * nk + lz.clamp(0, nk - 1)
    vals = dk.reshape(-1)[lidx]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    parts = torch.stack([torch.where(own, vals.real, zero),
                         torch.where(own, vals.imag, zero)])
    parts = psum(parts, mesh, ("x", "y"))
    coarse = torch.complex(parts[0], parts[1]).reshape(n_c, n_c, n_c)

    edges_sq, den, mmean, _, _, _ = get_bispectrum_tables(
        n_c, nbins, float(m_min), float(mmax), device=dev)
    f_c = _mode_numbers(n_c, dev)
    m2_c = (f_c[:, None, None] ** 2 + f_c[None, :, None] ** 2
            + f_c[None, None, :] ** 2)
    i_fs = []
    for b in range(nbins):
        mask = ((m2_c >= edges_sq[b]) & (m2_c < edges_sq[b + 1])).to(
            torch.complex64)
        i_fs.append(torch.fft.ifftn(mask * coarse).real)
    bvals, ntris = [], []
    for t, (a, b, cc) in enumerate(triples):
        num = (i_fs[a] * i_fs[b] * i_fs[cc]).sum()
        ntris.append(den[t] * float(n_c) ** 6)
        bvals.append(_bvalue(num, den[t], boxsize, ngrid))
    return _result(mmean, bvals, ntris, triples, boxsize)


def _bispectrum_body(block, mesh, ngrid, boxsize, nbins, m_min, mmax,
                     triples):
    # the SAME squared shell edges as ops.bispectrum: selection runs on the
    # exact integer m2, so shell membership is identical between the local
    # and distributed estimators
    dev = block.device
    edges_sq = torch.from_numpy(shell_edges_sq(m_min, mmax, nbins)).to(dev)
    dk = pfft3d_local(_delta(block, mesh, ngrid), mesh)  # (n, n/PX, n/PY)
    fi, fj, fk = local_mode_numbers(ngrid, mesh, device=dev)
    m2 = (fi ** 2 + fj ** 2 + fk ** 2).expand(dk.shape)  # exact integers
    m = torch.sqrt(m2)

    i_fs, n_fs, mmean = [], [], []
    for b in range(nbins):
        maskr = ((m2 >= edges_sq[b]) & (m2 < edges_sq[b + 1])).to(
            torch.float32)
        mask = maskr.to(torch.complex64)
        i_fs.append(pifft3d_local(mask * dk, mesh).real)
        n_fs.append(pifft3d_local(mask, mesh).real)
        s = psum(torch.stack([(maskr * m).sum(), maskr.sum()]), mesh,
                 ("x", "y"))
        mmean.append(s[0] / torch.clamp(s[1], min=1.0))

    bvals, ntris = [], []
    for (a, b, c) in triples:
        s = psum(torch.stack([(i_fs[a] * i_fs[b] * i_fs[c]).sum(),
                              (n_fs[a] * n_fs[b] * n_fs[c]).sum()]),
                 mesh, ("x", "y"))
        ntris.append(s[1] * float(ngrid) ** 6)
        bvals.append(_bvalue(s[0], s[1], boxsize, ngrid))
    return _result(mmean, bvals, ntris, triples, boxsize)
