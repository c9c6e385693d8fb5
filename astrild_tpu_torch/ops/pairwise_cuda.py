"""Pair-tile kernel of the mean pairwise velocity (K3) on the CUDA card,
with its plain version.

Port of astrild_tpu/ops/pallas_pairwise.py (`pairwise_accumulate_pallas`).
The kernel is hand-written CUDA C++ in csrc/pairwise_accumulate.cu: one
thread block per (i-tile, j-tile) pair with i-tile <= j-tile, per-warp bins
in shared memory, and a float64 reduction of the blocks' partial rows in a
fixed order, independent of the order in which blocks ran (see the source
for its design).

On a CPU tensor `pairwise_accumulate` runs the plain PyTorch version
(`pairwise_accumulate_reference`, the tiled estimator of ops/pairwise.py);
on a CUDA tensor it launches the kernel or raises. `LAUNCHES` counts kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

from collections import Counter

import torch

from .. import _ext

__all__ = ["pairwise_accumulate", "pairwise_accumulate_reference",
           "LAUNCHES"]

LAUNCHES: Counter = Counter()

MAX_BINS = 128


def _check_inputs(pos, vel, n_valid: int, nbins: int) -> None:
    if pos.dim() != 2 or pos.shape[1] != 3 or vel.shape != pos.shape:
        raise ValueError(f"pairwise_accumulate: pos and vel must be (n, 3), "
                         f"got {tuple(pos.shape)} and {tuple(vel.shape)}")
    if vel.device != pos.device:
        raise ValueError(f"pairwise_accumulate: vel on {vel.device}, pos on "
                         f"{pos.device}")
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"pairwise_accumulate: nbins={nbins} outside "
                         f"[1, {MAX_BINS}]")
    if not 0 <= n_valid <= pos.shape[0]:
        raise ValueError(f"pairwise_accumulate: n_valid={n_valid} outside "
                         f"[0, {pos.shape[0]}]")


def pairwise_accumulate_reference(pos, vel, n_valid: int, binwidth: float,
                                  nbins: int, block: int = 512):
    """Plain version of `pairwise_accumulate`: the tiled PyTorch estimator
    (`ops.pairwise._pairwise_accumulate`) with uniform bins."""
    from .pairwise import _pairwise_accumulate

    _check_inputs(pos, vel, int(n_valid), nbins)
    return _pairwise_accumulate(pos, vel, int(n_valid), nbins,
                                float(binwidth), block=block)


def pairwise_accumulate(pos, vel, n_valid: int, binwidth: float,
                        nbins: int):
    """Yasini Eq. 6 numerator and denominator per separation bin.

    Sums over all pairs i < j < n_valid with bin = int(|x_i - x_j| /
    binwidth) < nbins. pos/vel: (n, 3) float32 (rows at and beyond
    n_valid are ignored); nbins <= 128. Returns (nom, den), each (nbins,)
    float32.
    """
    if pos.device.type == "cpu":
        return pairwise_accumulate_reference(pos, vel, n_valid, binwidth,
                                             nbins)
    if pos.device.type != "cuda":
        raise ValueError(f"pairwise_accumulate: no kernel for device "
                         f"{pos.device}")
    n_valid = int(n_valid)
    _check_inputs(pos, vel, n_valid, nbins)
    pos = pos.to(torch.float32).contiguous()
    vel = vel.to(torch.float32).contiguous()
    # unit line of sight, outside the kernel (pallas_pairwise.py:117-120)
    hat = (pos / torch.linalg.vector_norm(pos, dim=1, keepdim=True)
           .clamp_min(1e-12)).contiguous()
    lib = _ext.load("pairwise_accumulate")
    rows = lib.astrild_pairwise_partials_rows(n_valid)
    partials = torch.empty(max(rows, 1) * 2 * nbins, dtype=torch.float32,
                           device=pos.device)
    out = torch.empty((2, nbins), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = lib.astrild_pairwise_accumulate(
            pos.data_ptr(), vel.data_ptr(), hat.data_ptr(), pos.shape[0],
            n_valid, float(binwidth), nbins, partials.data_ptr(),
            out.data_ptr(), stream)
    _ext.check(lib, rc, "pairwise_accumulate")
    LAUNCHES["pairwise_accumulate"] += 1
    return out[0], out[1]
