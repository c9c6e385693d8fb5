"""Sorted windowed deposit (K1) on the CUDA card, with its plain version.

Port of the sorted deposit of astrild_tpu/ops/paint_pallas.py
(`deposit_sorted`, `deposit_flat`). The kernel is hand-written CUDA C++ in
csrc/deposit_sorted.cu: one thread block per window of output cells,
accumulated in shared memory (see the source for its design). The TPU
version's window/chunk tuning table has no counterpart: the CUDA kernel
fixes its own window.

On a CPU tensor the wrappers run the plain PyTorch version
(`deposit_sorted_reference`); on a CUDA tensor they launch the kernel or
raise. `LAUNCHES` counts kernel launches per wrapper, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

from collections import Counter

import torch

from .. import _ext

__all__ = ["deposit_sorted", "deposit_flat", "deposit_sorted_reference",
           "LAUNCHES"]

LAUNCHES: Counter = Counter()

_MAX_CELLS = 1 << 31


def deposit_sorted_reference(keys_sorted: torch.Tensor,
                             vals_sorted: torch.Tensor | None,
                             n_cells: int) -> torch.Tensor:
    """Plain version of `deposit_sorted`: a scatter-add, order-free."""
    w = (torch.ones(keys_sorted.shape[0], dtype=torch.float32,
                    device=keys_sorted.device) if vals_sorted is None
         else vals_sorted.to(torch.float32))
    out = torch.zeros(n_cells, dtype=torch.float32, device=keys_sorted.device)
    return out.index_add_(0, keys_sorted.long(), w)


def _check_inputs(keys: torch.Tensor, vals: torch.Tensor | None,
                  n_cells: int) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"deposit_sorted: keys must be 1-D int32, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("deposit_sorted: keys must be contiguous")
    if not 0 <= n_cells < _MAX_CELLS:
        raise ValueError(f"deposit_sorted: n_cells={n_cells} outside "
                         f"[0, 2^31)")
    if vals is None:
        return
    if vals.dtype != torch.float32 or vals.shape != keys.shape:
        raise ValueError(f"deposit_sorted: vals must be float32 of shape "
                         f"{tuple(keys.shape)}, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if vals.device != keys.device:
        raise ValueError(f"deposit_sorted: vals on {vals.device}, keys on "
                         f"{keys.device}")
    if not vals.is_contiguous():
        raise ValueError("deposit_sorted: vals must be contiguous")


def deposit_sorted(keys_sorted: torch.Tensor,
                   vals_sorted: torch.Tensor | None,
                   n_cells: int) -> torch.Tensor:
    """Deposit pre-sorted (cell, weight) pairs into a flat grid.

    keys_sorted: (N,) int32 ascending cell indices in [0, n_cells).
    vals_sorted: (N,) float32 weights co-sorted with keys, or None for unit
      weights (counts, exact below 2^24 per cell).
    Returns (n_cells,) float32 on the keys' device.
    """
    if keys_sorted.device.type == "cpu":
        return deposit_sorted_reference(keys_sorted, vals_sorted, n_cells)
    if keys_sorted.device.type != "cuda":
        raise ValueError(f"deposit_sorted: no kernel for device "
                         f"{keys_sorted.device}")
    _check_inputs(keys_sorted, vals_sorted, n_cells)
    lib = _ext.load("deposit_sorted")
    out = torch.empty(n_cells, dtype=torch.float32, device=keys_sorted.device)
    with torch.cuda.device(keys_sorted.device):
        stream = torch.cuda.current_stream(keys_sorted.device).cuda_stream
        rc = lib.astrild_deposit_sorted(
            keys_sorted.data_ptr(),
            None if vals_sorted is None else vals_sorted.data_ptr(),
            keys_sorted.shape[0], out.data_ptr(), n_cells, stream)
    _ext.check(lib, rc, "deposit_sorted")
    LAUNCHES["deposit_sorted"] += 1
    return out


def deposit_flat(flat_idx: torch.Tensor, weights: torch.Tensor | None,
                 n_cells: int) -> torch.Tensor:
    """Sort + deposit: drop-in for `zeros(n_cells).index_add_(0, flat, w)`.

    weights=None deposits counts and sorts only the keys. The sort is
    unstable: the deposit does not depend on the order of equal keys.
    """
    flat = flat_idx.reshape(-1).to(torch.int32)
    keys, order = torch.sort(flat, stable=False)
    if weights is None:
        return deposit_sorted(keys, None, n_cells)
    vals = weights.reshape(-1).to(torch.float32)[order]
    return deposit_sorted(keys, vals, n_cells)
