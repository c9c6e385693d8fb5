"""Composed distributed z=0 analysis suite: P(k), B(k), Born kappa/gamma
and the void catalog as one program over the (sim, x, y) mesh.

Port of astrild_tpu/parallel/suite.py:

  particles (row blocks over every axis)
    -> per-rank fine-NGP deposit (K1 on a CUDA block) + psum_scatter
       re-pencil + folded pencil FFT -> P(k)   [fast_power_shard_body]
    -> the SAME coarse pencil grid -> shell transforms and triple
       products -> B(k1,k2,k3)                 [bispectrum_shard_body]
    -> contiguous z-slabs of each pencil, embedded at the rank's offset
       and summed with psum -> replicated planes -> Born kappa -> alpha
       -> gamma
    -> peaks + tunnels void catalog (replicated map stage)

matching ops.power.auto_power_fast / ops.bispectrum.bispectrum_3d /
ops.lensing / ops.voids single-device results to float tolerance.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import lensing as lens_ops
from ..ops import peaks as peak_ops
from ..ops import voids as void_ops
from ..ops.bispectrum import BispectrumResult
from ..ops.power import PowerResult
from ..ops.profiles3d import _linspace_f32
from .bispectrum import bispectrum_shard_body
from .mesh import axis_index, axis_size, psum
from .power import (_contrast, _global_mean, _optional_weights,
                    fast_power_shard_body)

__all__ = ["Z0SuiteResult", "make_distributed_z0_suite"]


class Z0SuiteResult(NamedTuple):
    pk: PowerResult
    bk: BispectrumResult
    kappa: torch.Tensor        # (ngrid, ngrid)
    gamma1: torch.Tensor
    gamma2: torch.Tensor
    void_radius: torch.Tensor  # (max_voids,)
    n_voids: torch.Tensor
    # pre-truncation candidate count: n_void_candidates > max_voids means
    # the static top-k cut the list BEFORE overlap pruning (re-run with a
    # larger max_voids; see ops.voids.find_tunnels_auto)
    n_void_candidates: torch.Tensor


def make_distributed_z0_suite(mesh, ngrid: int, boxsize: float,
                              nbins_pk: int, nbins_bk: int = 4,
                              bk_m_min: float = 2.0,
                              bk_m_max: Optional[float] = None,
                              nplanes: int = 8,
                              opening_angle_rad: float = 0.35,
                              chi_s: float = 3000.0,
                              omega_m: float = 0.3089,
                              chi0: float = 200.0,
                              chi1: float = 2800.0,
                              max_peaks: int = 512,
                              max_voids: int = 128,
                              fine_factor: int = 2,
                              deposit: Optional[str] = None):
    """Returns fn(pos, weights=None) -> Z0SuiteResult.

    pos: this rank's row block of the snapshot's positions, split over ALL
    mesh axes (the multihost loader's layout), (n, 3) or flat (x, y, z)
    components; weights co-sharded (zero-weight padding rows are inert).
    Every output is replicated. deposit: the fast estimator's (None: K1 on
    a CUDA block, its plain version on a CPU block; 'scatter').
    """
    px = axis_size(mesh, "x")
    py = axis_size(mesh, "y")
    assert ngrid % px == 0 and ngrid % py == 0 and ngrid % nplanes == 0
    mmax = (ngrid / 2.0 - 1.0) if bk_m_max is None else bk_m_max

    def body(pos, weights):
        pk, coarse = fast_power_shard_body(
            pos, weights, mesh=mesh, ngrid=ngrid, boxsize=boxsize,
            nbins=nbins_pk, fine_factor=fine_factor, deposit=deposit,
            return_coarse=True)
        bk = bispectrum_shard_body(coarse, mesh=mesh, ngrid=ngrid,
                                   boxsize=boxsize, nbins=nbins_bk,
                                   m_min=bk_m_min, m_max=mmax)
        dev = coarse.device
        # density contrast on the pencil, contiguous z-slab lens planes
        delta = _contrast(coarse, _global_mean(coarse, mesh, ngrid))
        local = delta.reshape(delta.shape[0], delta.shape[1], nplanes,
                              ngrid // nplanes).sum(3)  # (nx, ny, npl)
        # the transverse maps are small next to the 3D grid: embed each
        # pencil block at its global offset and psum, which leaves the
        # planes replicated
        nxl = ngrid // px
        nyl = ngrid // py
        xi = axis_index(mesh, "x")
        yi = axis_index(mesh, "y")
        planes = torch.zeros((ngrid, ngrid, nplanes), dtype=local.dtype,
                             device=dev)
        planes[xi * nxl:(xi + 1) * nxl, yi * nyl:(yi + 1) * nyl] = local
        planes = psum(planes, mesh, ("x", "y"))
        planes = planes.movedim(-1, 0)      # (nplanes, n, n)
        chis = _linspace_f32(chi0, chi1, nplanes, dev)
        dchis = torch.full((nplanes,), boxsize / nplanes, device=dev)
        kappa = lens_ops.born_convergence(planes, chis, dchis, chi_s,
                                          omega_m)
        a1, a2 = lens_ops.kappa_to_alpha(kappa, opening_angle_rad,
                                         padding_factor=2)
        g1, g2 = lens_ops.alpha_to_gamma(a1, a2, opening_angle_rad)
        cat = peak_ops.find_peaks(kappa, threshold=kappa.std(correction=0),
                                  max_peaks=max_peaks, edge_pix=4)
        vcat = void_ops.find_tunnels(cat.pos.to(torch.float32),
                                     cat.values > float("-inf"), ngrid,
                                     max_voids=max_voids)
        return Z0SuiteResult(pk, bk, kappa, g1, g2, vcat.radius,
                             vcat.n.to(torch.int32),
                             vcat.n_candidates.to(torch.int32))

    return _optional_weights(body, mesh)
