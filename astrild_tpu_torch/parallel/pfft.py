"""Pencil-decomposed distributed 3D FFT over the mesh.

Port of astrild_tpu/parallel/pfft.py: the grid is sharded (x-pencils) over
the mesh axes ('x', 'y'); each 1D FFT runs locally on the unsharded axis,
and all_to_all transposes re-pencil the block between passes.

Data layout contract (each rank's block):

  input  block: (n/PX, n/PY, n)   — global axes (i/X, j/Y, k)
  output block: (n,  n/PX, n/PY)  — global axes (i, j/X, k/Y)

i.e. the transform is returned *transposed* in sharding (axis 0 fully
local); `local_kvecs` accounts for this when binning spectra, so callers
never need to undo the transpose (FFTW/pfft's TRANSPOSED_OUT mode).
A mesh axis of size 1 runs no transpose, so a world of one runs three
local FFT passes and no collective.
"""
from __future__ import annotations

import math

import torch

from ..ops.power import _mode_numbers
from .mesh import all_to_all, axis_index, axis_size, to_mesh

__all__ = ["pfft3d_local", "pifft3d_local", "local_kvecs", "make_pfft3d"]


def _pfft_ops(b, mesh, ax: str, ay: str):
    """Raw forward op sequence (complex input)."""
    px = axis_size(mesh, ax)
    py = axis_size(mesh, ay)
    # pass 1: FFT along k (local)
    b = torch.fft.fft(b, dim=2)
    # transpose over 'y': axis2 (k) -> sharded, axis1 (j) -> full
    if py > 1:
        b = all_to_all(b, mesh, ay, split_axis=2, concat_axis=1)
    # pass 2: FFT along j (now local axis 1)
    b = torch.fft.fft(b, dim=1)
    # transpose over 'x': axis1 (j) -> sharded, axis0 (i) -> full
    if px > 1:
        b = all_to_all(b, mesh, ax, split_axis=1, concat_axis=0)
    # pass 3: FFT along i (now local axis 0)
    return torch.fft.fft(b, dim=0)


def _pifft_ops(b, mesh, ax: str, ay: str):
    """Raw inverse op sequence."""
    px = axis_size(mesh, ax)
    py = axis_size(mesh, ay)
    b = torch.fft.ifft(b, dim=0)
    if px > 1:
        b = all_to_all(b, mesh, ax, split_axis=0, concat_axis=1)
    b = torch.fft.ifft(b, dim=1)
    if py > 1:
        b = all_to_all(b, mesh, ay, split_axis=1, concat_axis=2)
    return torch.fft.ifft(b, dim=2)


def pfft3d_local(block, mesh, ax: str = "x", ay: str = "y"):
    """Forward complex 3D FFT of a pencil-sharded grid: this rank's block
    (n/PX, n/PY, n), complex or real, in; its (n, n/PX, n/PY) complex64
    block of the spectrum in TRANSPOSED_OUT layout out."""
    b = block if block.is_complex() else block.to(torch.complex64)
    return _pfft_ops(b, mesh, ax, ay)


def pifft3d_local(block, mesh, ax: str = "x", ay: str = "y"):
    """Inverse of pfft3d_local: (n, n/PX, n/PY) -> (n/PX, n/PY, n)."""
    return _pifft_ops(block, mesh, ax, ay)


def local_kvecs(ngrid: int, boxsize: float, mesh, ax: str = "x",
                ay: str = "y", dtype=torch.float32, device=None):
    """Wavevector components for the local block of a TRANSPOSED_OUT pfft.

    Returns (ki, kj, kk) broadcastable to the local (n, n/PX, n/PY) block:
    axis 0 holds all i modes; axis 1 the j-chunk owned by this x-index;
    axis 2 the k-chunk owned by this y-index.
    """
    kf = 2.0 * math.pi / boxsize
    nj = ngrid // axis_size(mesh, ax)
    nk = ngrid // axis_size(mesh, ay)
    xi = axis_index(mesh, ax)
    yi = axis_index(mesh, ay)
    freqs = _mode_numbers(ngrid, device).to(dtype) * kf
    ki = freqs[:, None, None]
    kj = freqs[xi * nj:(xi + 1) * nj][None, :, None]
    kk = freqs[yi * nk:(yi + 1) * nk][None, None, :]
    return ki, kj, kk


def make_pfft3d(mesh, inverse: bool = False):
    """Pencil FFT over the mesh axes ('x', 'y') on this rank's block.

    Forward: fn(block of P('x','y',None)) -> complex block of
    P(None,'x','y'). Inverse: the reverse. Ranks that differ only in 'sim'
    hold and transform the same blocks, as the JAX shard_map replicates
    over the axis its specs leave out.
    """
    body = pifft3d_local if inverse else pfft3d_local
    return lambda block: body(to_mesh(block, mesh), mesh, "x", "y")
