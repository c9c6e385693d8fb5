"""Distributed spherical-harmonic transforms on the table path: rings
sharded over a mesh axis.

Port of astrild_tpu/parallel/sht.py. The table SHT of ops/sht.py splits
exactly over iso-latitude rings: synthesis is ring-local (each ring needs
only the alms, which every rank holds), and analysis is a sum of per-ring
contributions (one `psum`). Splitting the ring axis over `ax` splits both
the O(lmax^2 * nring) Legendre table and the transform's work.

Layouts (this rank's block, P the size of `ax`):
  lam      (L+1, L+1, nring_p/P)   its rings of the Legendre table
  cos/sin  (L+1, nring_p/P, pmax)  its rings of the phase tables
  map_pad  (nring_p/P, pmax)       its rows of the padded ring-major map
The ring count 4*nside-1 is padded to nring_p, a multiple of P, with
zero-weight rings. `pad_map` / `unpad_map` convert between RING pixel
order and the padded (nring, pmax) plane on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.sht import (_legendre_sum, _legendre_sum_t, _m_weights,
                       _phase_sum, _phase_sum_t, ring_geometry, sht_tables)
from .mesh import axis_index, axis_size, mesh_device, psum, to_mesh

__all__ = ["make_distributed_sht", "pad_map", "unpad_map"]


def pad_map(hpmap, nside: int):
    """RING pixel vector -> (nring, pmax) padded plane (numpy, host)."""
    geo = ring_geometry(nside)
    nring, pmax = geo.phi_pad.shape
    out = np.zeros(nring * pmax, np.float32)
    out[geo.flat_idx] = np.asarray(hpmap, np.float32)
    return out.reshape(nring, pmax)


def unpad_map(map_pad, nside: int):
    """(nring, pmax) padded plane -> RING pixel vector (numpy, host)."""
    geo = ring_geometry(nside)
    if isinstance(map_pad, torch.Tensor):
        map_pad = map_pad.detach().cpu().numpy()
    return np.asarray(map_pad).reshape(-1)[geo.flat_idx]


def _ring_block(t: torch.Tensor, dim: int, r0: int, r1: int,
                per: int) -> torch.Tensor:
    """Rings r0..r1 of a table along `dim`, zero-padded to `per` rings."""
    shape = list(t.shape)
    shape[dim] = per
    out = t.new_zeros(shape)
    out.narrow(dim, 0, r1 - r0).copy_(t.narrow(dim, r0, r1 - r0))
    return out


def make_distributed_sht(mesh, nside: int, lmax: int, ax: str = "x"):
    """Ring-sharded (synthesize, analyze) over mesh axis `ax`.

    synthesize(alm_re, alm_im) -> this rank's (nring_p/P, pmax) block of
      the padded map (the JAX P(ax) sharding; `mesh.unshard` with spec
      (ax, None) assembles the (nring_p, pmax) plane).
    analyze(map_pad, niter) -> (alm_re, alm_im), replicated: map_pad the
      whole padded plane, (nring, pmax) or (nring_p, pmax).
    """
    nproc = axis_size(mesh, ax)
    dev = mesh_device(mesh)
    tab = sht_tables(nside, lmax, dev)
    geo = ring_geometry(nside)
    nring, pmax = geo.phi_pad.shape
    npix = int(geo.flat_idx.size)
    nring_p = -(-nring // nproc) * nproc
    per = nring_p // nproc
    r0 = axis_index(mesh, ax) * per
    r1 = min(r0 + per, nring)
    r1 = max(r1, r0)
    lam = _ring_block(tab.lam, 2, r0, r1, per)
    cosm = _ring_block(tab.cosmphi, 1, r0, r1, per)
    sinm = _ring_block(tab.sinmphi, 1, r0, r1, per)
    wmode = _m_weights(lmax, dev)
    wq = 4.0 * math.pi / npix

    def synthesize(alm_re, alm_im):
        a_re = to_mesh(alm_re, mesh).to(torch.float32)
        a_im = to_mesh(alm_im, mesh).to(torch.float32)
        c_re = _legendre_sum(lam, a_re)
        c_im = _legendre_sum(lam, a_im)
        return (_phase_sum(wmode * c_re, cosm)
                - _phase_sum(wmode * c_im, sinm))

    def adjoint(block):
        d_re = _phase_sum_t(block, cosm)
        d_im = -_phase_sum_t(block, sinm)
        # re and im in one psum (XLA's combiner merges JAX's two)
        return psum(torch.stack([wq * _legendre_sum_t(lam, d_re),
                                 wq * _legendre_sum_t(lam, d_im)]),
                    mesh, ax).unbind(0)

    def analyze(map_pad, niter: int = 3):
        map_pad = to_mesh(map_pad, mesh).to(torch.float32)
        block = map_pad[r0:r0 + per]
        if block.shape[0] < per:
            block = torch.cat([block, block.new_zeros(
                (per - block.shape[0], pmax))])
        a_re, a_im = adjoint(block)
        for _ in range(niter):
            d_re, d_im = adjoint(block - synthesize(a_re, a_im))
            a_re, a_im = a_re + d_re, a_im + d_im
        return a_re, a_im

    return synthesize, analyze
