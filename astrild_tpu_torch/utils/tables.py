"""Host-built numpy tables -> device tensors.

The analysis suite's only state is a set of input-independent tables built
on the host in numpy: the shell binning of ops/power.py
(binidx, wf, nm, kmean) and the bispectrum tables of ops/bispectrum.py
(edges_sq, den, mmean, ta, tb, tc). Both packages build them with the same
numpy code, so feeding the port the JAX package's own tables through this
function makes both compute from identical state.

`interp` is the port's `jnp.interp` on tensors: the theory tables
(`utils/cosmology.py`, FFTLog, the Limber kernels) look values up with it.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tables_from_numpy", "interp"]


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


def interp(x, xp, fp, left=None, right=None):
    """jnp.interp on tensors, with its formula fp[i-1] + (x - xp[i-1]) / dx
    * df: beyond the ends fp[0] and fp[-1], or `left` / `right` where
    given. Differentiable in x, xp and fp (the interval is found on the
    values alone), so a table built from traced parameters can be looked
    up inside torch.func transforms."""
    i = torch.clamp(torch.searchsorted(xp.detach(), x.detach().contiguous(),
                                       right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, f)
