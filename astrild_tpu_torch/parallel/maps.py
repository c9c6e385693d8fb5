"""Distributed flat-sky map operations: sharded 2D FFT filters.

Port of astrild_tpu/parallel/maps.py: maps shard row-wise over the 'x'
mesh axis and 2D FFT filters run with one all_to_all transpose per
direction (the 2D analogue of parallel/pfft.py).

Layout contract (each rank's block):
  input  block: (npix/PX, npix)   — rows sharded
  after fft2: transposed layout (npix, npix/PX) — cols sharded
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.filters import _pix_freqs
from .mesh import all_to_all, axis_index, axis_size, to_mesh

__all__ = ["pfft2d_local", "pifft2d_local", "make_sharded_filter",
           "make_sharded_gaussian_filter"]


def pfft2d_local(block, mesh, ax: str = "x"):
    """(n/PX, n) real/complex -> (n, n/PX) complex spectrum (transposed)."""
    b = block if block.is_complex() else block.to(torch.complex64)
    b = torch.fft.fft(b, dim=1)  # along the full axis
    if axis_size(mesh, ax) > 1:
        b = all_to_all(b, mesh, ax, split_axis=1, concat_axis=0)
    return torch.fft.fft(b, dim=0)


def pifft2d_local(block, mesh, ax: str = "x"):
    """Inverse of pfft2d_local: (n, n/PX) -> (n/PX, n) complex."""
    b = torch.fft.ifft(block, dim=0)
    if axis_size(mesh, ax) > 1:
        b = all_to_all(b, mesh, ax, split_axis=0, concat_axis=1)
    return torch.fft.ifft(b, dim=1)


def make_sharded_filter(mesh, npix: int,
                        transfer_fn: Callable[[torch.Tensor, torch.Tensor],
                                              torch.Tensor]):
    """Sharded filter: fn(this rank's P('x', None) block) -> its block of
    the filtered map.

    transfer_fn(k0, k1) -> multiplier, with k0/k1 the angular frequencies
    [2 pi / pixel] of the local spectral block (transposed layout: axis 0
    full, axis 1 the column chunk owned by this x-index).
    """
    def fn(block):
        block = to_mesh(block, mesh)
        nloc = npix // axis_size(mesh, "x")
        xi = axis_index(mesh, "x")
        spec = pfft2d_local(block, mesh)
        k = _pix_freqs(npix, block.device)[0][:, 0]
        k0 = k[:, None]
        k1 = k[xi * nloc:(xi + 1) * nloc][None, :]
        spec = spec * transfer_fn(k0, k1)
        return pifft2d_local(spec, mesh).real

    return fn


def make_sharded_gaussian_filter(mesh, npix: int, theta_deg: float,
                                 sigma_arcmin: float):
    """Distributed equivalent of ops.filters.gaussian."""
    sigma_pix = sigma_arcmin / 60.0 * npix / theta_deg

    def transfer(k0, k1):
        return torch.exp(-0.5 * sigma_pix ** 2 * (k0 ** 2 + k1 ** 2)).to(
            torch.complex64)

    return make_sharded_filter(mesh, npix, transfer)
