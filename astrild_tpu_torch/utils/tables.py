"""Host-built numpy tables -> device tensors.

The analysis suite's only state is a set of input-independent tables built
on the host in numpy: the shell binning of ops/power.py
(binidx, wf, nm, kmean) and the bispectrum tables of ops/bispectrum.py
(edges_sq, den, mmean, ta, tb, tc). Both packages build them with the same
numpy code, so feeding the port the JAX package's own tables through this
function makes both compute from identical state.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tables_from_numpy"]


def tables_from_numpy(arrays, device=None) -> tuple:
    """Move a sequence of array-likes to `device` as torch tensors.

    Floating arrays become float32 (the JAX package computes in float32; a
    plain `torch.from_numpy` would keep float64) and integer arrays become
    int64 (torch's index dtype). Values are otherwise unchanged.
    """
    out = []
    for a in arrays:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        else:
            raise TypeError(f"tables_from_numpy: unsupported dtype {a.dtype}")
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)
