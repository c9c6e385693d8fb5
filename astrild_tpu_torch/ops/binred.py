"""Masked per-bin reduction of pair-tile channels.

Port of astrild_tpu/ops/binred.py. The JAX package contracts each chunk
with a one-hot (chunk, nbins) selector on the MXU at Precision.HIGHEST so
that float32 values are not truncated. The port builds the same one-hot
selection but reduces it with an elementwise product and a sum, not a
matrix product, so no TF32 or reduced-precision matmul setting can touch
it: the sums are full float32 whatever the caller's matmul precision.
"""
from __future__ import annotations

import torch

from .._device import as_tensor

__all__ = ["masked_bin_reduce"]


def masked_bin_reduce(chans, binidx, nbins: int, chunk: int = 65536,
                      device=None):
    """sum of chans[c, i] over i with binidx[i] == b, for each (c, b).

    Args:
      chans: (C, n) float32 values (masked-out entries must already be
        zero AND carry binidx == nbins).
      binidx: (n,) integer bin indices in [0, nbins]; nbins is the drop
        bucket.
      nbins: number of live bins.
      chunk: flattened-pair chunk size bounding the one-hot selection at
        C x chunk x nbins floats (at most 2^24 of them).

    Numpy input goes to `device`, by default the CUDA card (binidx follows
    chans). Returns (C, nbins) float32 sums.
    """
    chans = as_tensor(chans, device).to(torch.float32)
    binidx = as_tensor(binidx, chans.device)
    nch, n = chans.shape
    chunk = max(1024, min(chunk, (1 << 24) // max(nch * nbins, 1)))
    sel = torch.arange(nbins, dtype=binidx.dtype, device=chans.device)
    out = torch.zeros((nch, nbins), dtype=torch.float32, device=chans.device)
    for s in range(0, n, chunk):
        hot = binidx[s:s + chunk, None] == sel[None, :]        # (m, nbins)
        v = chans[:, s:s + chunk, None]                         # (C, m, 1)
        out += torch.where(hot[None], v, 0.0).sum(dim=1)
    return out
