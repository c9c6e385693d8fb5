"""3D void finders on density grids: the spherical void finder (SVF) and a
ZOBOV-style watershed.

Port of astrild_tpu/ops/voids3d.py. SVF: for a ladder of radii R the mean
enclosed density contrast (delta * W_R)(x) is one rfftn plus one irfftn per
radius with the analytic top-hat window; each cell's void radius is the
largest (interpolated) R at which it stays below the threshold; candidates
are local maxima of the radius field, accepted greedily in decreasing
radius under a sphere-volume overlap bound. Watershed: steepest-descent
basin labels by pointer jumping over the periodic 26-neighbourhood, basin
volume by a count, catalog thresholded on the basin minimum.

The JAX package's `lax.scan` over the radius ladder is a Python loop over
its rungs; its `fori_loop` of greedy acceptance runs on the tensors' device
without a host sync per step, over the valid candidates only (one sync
for their count: the padding past them is never accepted). `top_k` is `peaks.top_k_masked` (ties and
padding as `lax.top_k`), argsorts are stable as `jnp.argsort`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import as_tensor
from .peaks import top_k_masked
from .power import mode_radius_rfft
from .profiles3d import _linspace_f32

__all__ = ["Void3DCatalog", "enclosed_density_radius", "svf_voids",
           "svf_catalog_dict", "sphere_overlap_fraction",
           "watershed_labels_3d", "watershed_voids_3d"]

_DIMS = (-3, -2, -1)


class Void3DCatalog(NamedTuple):
    """Fixed-capacity 3D void list; entries [n:] have radius 0."""

    pos: torch.Tensor           # (K, 3) void centers [Mpc/h]
    radius: torch.Tensor        # (K,) radii [Mpc/h]
    min_delta: torch.Tensor     # (K,) smoothed density contrast at center
    n: torch.Tensor             # scalar int: accepted voids
    n_candidates: torch.Tensor  # scalar int: pre-truncation candidates


def _kmag_r(ngrid: int, device=None):
    """|k|/kf on the rfftn grid (the JAX package's fftfreq(n) * n, which is
    exact in float32: integer mode numbers)."""
    return mode_radius_rfft(ngrid, device=device)


def _tophat(x):
    xs = torch.where(x < 1e-4, torch.ones_like(x), x)
    w = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / xs ** 3
    return torch.where(x < 1e-4, 1.0 - x * x / 10.0, w)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _gauss_smooth(dk, kmag, sig, ngrid: int):
    """irfftn of dk under a Gaussian of width sig (kmag and sig in the same
    units)."""
    return torch.fft.irfftn(dk * torch.exp(-0.5 * (kmag * sig) ** 2),
                            s=(ngrid,) * 3, dim=_DIMS)


def _flat_index(n: int, device):
    return torch.arange(n * n * n, dtype=torch.int32,
                        device=device).reshape(n, n, n)


def _offsets_3d():
    """The 26 neighbour offsets in the JAX package's loop order."""
    return [(di, dj, dk) for di in (-1, 0, 1) for dj in (-1, 0, 1)
            for dk in (-1, 0, 1) if not di == dj == dk == 0]


def _local_maxima_periodic(field):
    """26-neighbourhood local maxima on a periodic 3D grid with
    lexicographic (value, -flat_index) tie-breaking, so a plateau keeps one
    representative per tied neighbourhood (overlap pruning removes the
    rest)."""
    flat_idx = _flat_index(field.shape[-1], field.device)
    is_max = torch.ones(field.shape, dtype=torch.bool, device=field.device)
    for off in _offsets_3d():
        nb = torch.roll(field, off, dims=(0, 1, 2))
        nb_idx = torch.roll(flat_idx, off, dims=(0, 1, 2))
        is_max &= (field > nb) | ((field == nb) & (flat_idx < nb_idx))
    return is_max


def sphere_overlap_fraction(c1, r1, c2, r2, boxsize, device=None):
    """Volume of sphere-1 covered by sphere-2, as a fraction of sphere-1,
    with periodic minimum-image centers (two-sphere lens volume). The
    other inputs follow c1's device."""
    c1 = as_tensor(c1, device)
    dev = c1.device
    c2 = _f32(c2, dev)
    r1 = _f32(r1, dev)
    r2 = _f32(r2, dev)
    box = _f32(boxsize, dev)
    d_vec = c1 - c2
    d_vec = d_vec - box * torch.round(d_vec / box)
    d = torch.sqrt(torch.sum(d_vec ** 2, dim=-1))
    r1 = torch.clamp_min(r1, 1e-12)
    r2 = torch.clamp_min(r2, 1e-12)
    d_safe = torch.clamp_min(d, 1e-12)
    lens = (math.pi * (r1 + r2 - d_safe) ** 2
            * (d_safe ** 2 + 2.0 * d_safe * (r1 + r2)
               - 3.0 * (r1 - r2) ** 2) / (12.0 * d_safe))
    v1 = 4.0 / 3.0 * math.pi * r1 ** 3
    frac = lens / v1
    contained = torch.minimum(r1, r2) ** 3 / r1 ** 3
    frac = torch.where(d <= torch.abs(r1 - r2), contained, frac)
    frac = torch.where(d >= r1 + r2, torch.zeros_like(frac), frac)
    return torch.clamp(frac, 0.0, 1.0)


def enclosed_density_radius(delta, boxsize, r_min, r_max,
                            n_radii: int = 24, delta_threshold=-0.8,
                            dk=None, device=None):
    """Per-cell largest radius with mean enclosed density below threshold.

    Walks a geometric radius ladder upward; the crossing radius is linearly
    interpolated in delta_R between the bracketing rungs, and the last
    below -> above crossing wins. Cells still below threshold at r_max
    saturate at r_max; rstar == 0 where even the smallest sphere is above
    threshold. dk: optional precomputed rfftn(delta). Numpy input goes to
    `device`, by default the CUDA card (it raises without one); tensors
    keep their device (so in every entry point here).
    """
    delta = as_tensor(delta, device)
    ngrid = delta.shape[-1]
    dev = delta.device
    if dk is None:
        dk = torch.fft.rfftn(delta, dim=_DIMS)
    kmag = _kmag_r(ngrid, dev) * (2.0 * math.pi / boxsize)
    # the JAX package's float32 ladder exp(linspace(log r_min, log r_max))
    radii = torch.exp(_linspace_f32(torch.log(_f32(r_min, dev)),
                                    torch.log(_f32(r_max, dev)), n_radii,
                                    dev))
    thr = _f32(delta_threshold, dev)
    rstar = torch.zeros_like(delta)
    prev_d = torch.zeros_like(delta)
    prev_r = torch.zeros((), device=dev)
    for step in range(n_radii):
        r = radii[step]
        d_r = torch.fft.irfftn(dk * _tophat(kmag * r), s=(ngrid,) * 3,
                               dim=_DIMS)
        below = d_r < thr
        if step:  # the first rung has no rung below it to cross from
            diff = d_r - prev_d
            denom = torch.where(torch.abs(diff) < 1e-12,
                                torch.full_like(diff, 1e-12), diff)
            r_cross = prev_r + (thr - prev_d) / denom * (r - prev_r)
            crossed = (prev_d < thr) & ~below
            rstar = torch.where(crossed,
                                torch.minimum(torch.maximum(r_cross, prev_r),
                                              r), rstar)
        rstar = torch.where(below, torch.maximum(rstar, r), rstar)
        prev_d, prev_r = d_r, r
    return rstar


def _grid_centers(idx, ngrid: int, cell: float):
    ii = (idx // (ngrid * ngrid)).to(torch.float32)
    jj = ((idx // ngrid) % ngrid).to(torch.float32)
    kk = (idx % ngrid).to(torch.float32)
    return (torch.stack([ii, jj, kk], dim=-1) + 0.5) * cell


def _accepted_first(acc, radius):
    """Order putting accepted entries first by decreasing radius, the rest
    in candidate order (stable, as jnp.argsort)."""
    return torch.argsort(-torch.where(acc, radius,
                                      torch.full_like(radius, -1.0)),
                         stable=True)


def svf_voids(delta, boxsize, delta_threshold=-0.8, overlap: float = 0.5,
              max_voids: int = 512, r_min=None, r_max=None,
              n_radii: int = 24, smooth_cells: float = 2.0, device=None):
    """Spherical void finder on a 3D density-contrast grid.

    Args:
      delta: (n, n, n) density contrast (periodic box).
      boxsize: box side [Mpc/h].
      delta_threshold: enclosed-density criterion (SVF: -0.8).
      overlap: max volume fraction of a candidate already covered by
        accepted voids.
      max_voids: candidate/catalog capacity (`n_candidates` reports the
        pre-truncation count).
      r_min / r_max: radius ladder bounds [Mpc/h]; default 1.5 cells to
        boxsize/4.
      smooth_cells: Gaussian smoothing (in cells) of the field whose value
        at the center is reported.
    """
    delta = as_tensor(delta, device)
    ngrid = delta.shape[-1]
    dev = delta.device
    cell = boxsize / ngrid
    r_lo = 1.5 * cell if r_min is None else r_min
    r_hi = boxsize / 4.0 if r_max is None else r_max

    dk = torch.fft.rfftn(delta, dim=_DIMS)
    rstar = enclosed_density_radius(delta, boxsize, r_lo, r_hi,
                                    n_radii=n_radii,
                                    delta_threshold=delta_threshold, dk=dk)
    kmag = _kmag_r(ngrid, dev) * (2.0 * math.pi / boxsize)
    smooth = _gauss_smooth(dk, kmag, smooth_cells * cell, ngrid)
    del dk
    # candidates: local maxima of a 1-cell Gaussian smoothing of rstar
    # (flat across a deep void's core); the radius stays the raw rstar
    rstar_sm = _gauss_smooth(torch.fft.rfftn(rstar, dim=_DIMS), kmag, cell,
                             ngrid)
    cand = (_local_maxima_periodic(rstar_sm) & (rstar > 0.0)).reshape(-1)
    vals, idx = top_k_masked(rstar.reshape(-1), cand, max_voids)
    cpos = _grid_centers(idx, ngrid, cell)
    cvalid = vals > float("-inf")
    crad = torch.where(cvalid, vals, torch.zeros_like(vals))
    cmin = smooth.reshape(-1)[idx]

    accepted = torch.zeros_like(crad)
    # the padding (cvalid false, last: top_k is sorted) is never accepted
    for i in range(int(cvalid.sum())):
        ov = sphere_overlap_fraction(cpos[i], crad[i], cpos, crad,
                                     boxsize) * accepted
        ov[i] = 0.0
        accepted[i] = ((ov.amax() <= overlap) & cvalid[i]).to(crad.dtype)
    acc = accepted > 0
    radius = torch.where(acc, crad, torch.zeros_like(crad))
    order = _accepted_first(acc, radius)
    return Void3DCatalog(pos=cpos[order], radius=radius[order],
                         min_delta=cmin[order], n=acc.sum(),
                         n_candidates=cand.sum())


def svf_catalog_dict(cat: Void3DCatalog, overlap: float = 0.5) -> dict:
    """Host column dict in the schema the 'svf' void catalogs use (sigma
    column 'void_overlap')."""
    n = int(cat.n)
    pos = cat.pos.cpu().numpy()[:n]
    return {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "radius": cat.radius.cpu().numpy()[:n],
            "min_delta": cat.min_delta.cpu().numpy()[:n],
            "void_overlap": np.full(n, overlap, np.float32)}


# --------------------------------------------------------------- watershed 3D
def _neighbor_min_pointer_3d(field):
    """Flat index (int64) of the lexicographically smallest (value, index)
    26-neighbour, self included, periodic: exact value ties drain to one
    basin."""
    flat_idx = _flat_index(field.shape[-1], field.device)
    best_val = field
    best_idx = flat_idx
    for off in _offsets_3d():
        nb = torch.roll(field, off, dims=(0, 1, 2))
        nb_idx = torch.roll(flat_idx, off, dims=(0, 1, 2))
        better = (nb < best_val) | ((nb == best_val) & (nb_idx < best_idx))
        best_val = torch.where(better, nb, best_val)
        best_idx = torch.where(better, nb_idx, best_idx)
    return best_idx.reshape(-1).to(torch.int64)


def watershed_labels_3d(field, device=None):
    """Steepest-descent basin labels on a periodic 3D grid: each cell's
    label is the flat index of the minimum its descent reaches (pointer
    jumping, ceil(log2 n^3) + 1 steps)."""
    field = as_tensor(field, device)
    n = field.shape[-1]
    ptr = _neighbor_min_pointer_3d(field)
    for _ in range(int(math.ceil(math.log2(max(n ** 3, 2)))) + 1):
        ptr = ptr[ptr]
    return ptr.reshape(n, n, n)


def watershed_voids_3d(delta, boxsize, max_voids: int = 512,
                       core_delta: float = -0.8,
                       smooth_cells: float = 2.0, device=None):
    """ZOBOV-style watershed void catalog from a density grid.

    Basins of the Gaussian-smoothed density whose minimum lies below
    `core_delta` become voids: volume the basin's cell count, effective
    radius (3V/4pi)^(1/3), center the basin minimum, ranked by volume.
    """
    delta = as_tensor(delta, device)
    ngrid = delta.shape[-1]
    dev = delta.device
    cell = boxsize / ngrid
    kmag = _kmag_r(ngrid, dev) * (2.0 * math.pi / boxsize)
    smooth = _gauss_smooth(torch.fft.rfftn(delta, dim=_DIMS), kmag,
                           smooth_cells * cell, ngrid)
    labels = watershed_labels_3d(smooth).reshape(-1)
    vol = torch.bincount(labels, minlength=ngrid ** 3).to(torch.float32)
    minima = smooth.reshape(-1)
    deep = (vol > 0.0) & (minima <= core_delta)
    vals, idx = top_k_masked(vol, deep, max_voids)
    ok = vals > float("-inf")
    pos = _grid_centers(idx, ngrid, cell)
    vol_phys = torch.where(ok, vals, torch.zeros_like(vals)) * cell ** 3
    radius = (3.0 * vol_phys / _f32(4.0 * math.pi, dev)) ** (1.0 / 3.0)
    return Void3DCatalog(pos=pos, radius=radius, min_delta=minima[idx],
                         n=ok.sum(), n_candidates=deep.sum())
