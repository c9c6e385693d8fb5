"""Trilinear periodic sampling of displacement and force grids.

Port of `_as_comps` and `sample_displacement` of astrild_tpu/ops/recon.py
(the gather the PM forces and the reconstruction share). The
reconstruction itself (`displacement_field`, `reconstruct_catalog`) is not
ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["sample_displacement"]


def _as_comps(pos):
    if isinstance(pos, (tuple, list)):
        return tuple(torch.as_tensor(c).reshape(-1) for c in pos)
    pos = torch.as_tensor(pos)
    return pos[:, 0], pos[:, 1], pos[:, 2]


def sample_displacement(psi_grids, boxsize, pos):
    """Trilinear periodic sample of the displacement at positions.

    psi_grids: (3, n, n, n); pos: (n, 3) or flat tuple. Returns (3, np).
    Gathers one component and one neighbour at a time with int32 cell
    indices (n^3 < 2^31), so the temporaries stay at a few (np,) vectors.
    """
    x, y, z = _as_comps(pos)
    ngrid = psi_grids.shape[-1]
    cell = boxsize / ngrid
    flat = psi_grids.reshape(3, -1)
    lo, hi, fr = [], [], []
    for c in (x, y, z):
        u = c / cell - 0.5
        i0 = torch.floor(u)
        fr.append(u - i0)
        i0 = i0.to(torch.int32)
        lo.append(torch.remainder(i0, ngrid))
        hi.append(torch.remainder(i0 + 1, ngrid))
    out = torch.zeros((3, x.shape[0]), dtype=psi_grids.dtype,
                      device=psi_grids.device)
    for dx in (0, 1):
        wx = fr[0] if dx else 1 - fr[0]
        ix = (hi if dx else lo)[0] * ngrid
        for dy in (0, 1):
            wxy = wx * (fr[1] if dy else 1 - fr[1])
            ixy = (ix + (hi if dy else lo)[1]) * ngrid
            for dz in (0, 1):
                w = wxy * (fr[2] if dz else 1 - fr[2])
                idx = ixy + (hi if dz else lo)[2]
                for a in range(3):
                    out[a].addcmul_(w, flat[a].index_select(0, idx))
    return out
