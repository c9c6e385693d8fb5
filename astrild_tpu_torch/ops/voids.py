"""Void finders on flat-sky maps: tunnels (largest empty circles) and
watershed.

Port of astrild_tpu/ops/voids.py. Tunnels: a distance transform from the
tracer (peak) set, local-maximum candidate extraction, and greedy
overlap-pruned acceptance in decreasing-radius order, with
`find_tunnels_auto` escalating the candidate capacity. Watershed:
steepest-descent basin labels by pointer jumping (no flood queue), basin
areas below a percentile of the map.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._device import as_tensor
from .peaks import candidate_topk, local_maxima, top_k_masked

__all__ = ["VoidCatalog", "distance_transform", "find_tunnels",
           "find_tunnels_auto", "circle_overlap_fraction",
           "watershed_labels", "watershed_voids"]

# above this capacity find_tunnels evaluates overlaps step by step instead
# of holding the K x K float32 matrix, 1 GiB at find_tunnels_auto's limit
# of 2^14 (chip_smoke.py's phase 12 times and sizes both forms at 2^13 and
# 2^14 on the kappa map's candidates)
_OVERLAP_MATRIX_MAX = 1 << 14

# named profiler spans of the tunnels finder's parts (a few microseconds
# each when no profiler runs)
_span = torch.profiler.record_function


class VoidCatalog(NamedTuple):
    """Fixed-capacity void list; entries [n:] have radius 0.

    `n_candidates` is the number of candidates that existed before the
    `max_voids` truncation: n_candidates > capacity means the candidate list
    was cut ahead of overlap pruning.
    """

    pos: torch.Tensor     # (K, 2) pixel coords (row, col) of void centers
    radius: torch.Tensor  # (K,) radii in pixels
    n: torch.Tensor       # scalar int: number of valid voids
    n_candidates: torch.Tensor = None  # scalar int: pre-truncation count


def distance_transform(peak_pos, peak_valid, npix: int, block: int = 65536):
    """Distance from every pixel to the nearest valid peak.

    peak_pos: (P, 2) float pixel coordinates; peak_valid: (P,) bool.
    Computed as a blocked min over peaks of the direct squared difference.
    Unlike the |x|^2+|p|^2-2x.p expansion of the JAX version it takes no
    matrix product, so a TF32 matmul setting cannot change it, and it
    cannot cancel; for integer pixel coordinates (npix <= 2048) both forms
    are exact in float32.
    """
    dev = peak_pos.device
    ii = torch.arange(npix, dtype=torch.float32, device=dev)
    px = torch.stack(torch.meshgrid(ii, ii, indexing="ij"),
                     dim=-1).reshape(-1, 2)
    peaks = peak_pos.to(torch.float32)
    # invalid peaks sit at +inf distance from every pixel
    penalty = torch.where(peak_valid, 0.0, float("inf")).to(torch.float32)
    d2 = torch.empty(px.shape[0], dtype=torch.float32, device=dev)
    for start in range(0, px.shape[0], block):
        chunk = px[start:start + block]
        dx = chunk[:, 0:1] - peaks[None, :, 0]
        dy = chunk[:, 1:2] - peaks[None, :, 1]
        d2[start:start + block] = (dx * dx + dy * dy
                                   + penalty[None, :]).amin(dim=1)
    return torch.sqrt(torch.clamp(d2, min=0.0)).reshape(npix, npix)


def circle_overlap_fraction(c1, r1, c2, r2):
    """Area of circle-1 covered by circle-2, as a fraction of circle-1.

    Standard two-circle lens formula; degenerate cases handled:
    d >= r1+r2 -> 0; d <= |r1-r2| -> full containment.
    """
    d = torch.sqrt(((c1 - c2) ** 2).sum(dim=-1))
    r1 = torch.clamp(r1, min=1e-12)
    d_safe = torch.clamp(d, min=1e-12)
    x1 = torch.clamp((d_safe ** 2 + r1 ** 2 - r2 ** 2) / (2 * d_safe * r1),
                     -1, 1)
    x2 = torch.clamp((d_safe ** 2 + r2 ** 2 - r1 ** 2)
                     / (2 * d_safe * r2 + 1e-30), -1, 1)
    t = ((-d + r1 + r2) * (d + r1 - r2) * (d - r1 + r2) * (d + r1 + r2))
    lens = (r1 ** 2 * torch.arccos(x1) + r2 ** 2 * torch.arccos(x2)
            - 0.5 * torch.sqrt(torch.clamp(t, min=0.0)))
    frac = lens / (math.pi * r1 ** 2)
    contained = torch.minimum(r1, r2) ** 2 / r1 ** 2
    frac = torch.where(d <= torch.abs(r1 - r2), contained, frac)
    frac = torch.where(d >= r1 + r2, torch.zeros_like(frac), frac)
    return torch.clamp(frac, 0.0, 1.0)


def _tunnel_candidates(peak_pos, peak_valid, npix: int, max_voids: int,
                       min_radius: float):
    """find_tunnels' candidates: positions (K, 2), radii (K,) and validity
    (K,) of the max_voids largest local maxima of the distance transform,
    in top_k's order and padding, and the mask of every candidate. The
    distance transform runs in the profiler span `voids.distance`, the
    extraction in `voids.candidates`."""
    with _span("voids.distance"):
        dist = distance_transform(peak_pos, peak_valid, npix)
    with _span("voids.candidates"):
        cand_mask = local_maxima(dist) & (dist >= min_radius)
        score = torch.where(cand_mask, dist,
                            torch.full_like(dist, float("-inf")))
        vals, idx = candidate_topk(score, max_voids)
        cpos = torch.stack([(idx // npix).to(torch.float32),
                            (idx % npix).to(torch.float32)], dim=-1)
        cvalid = vals > float("-inf")
        crad = torch.where(cvalid, vals, torch.zeros_like(vals))
    return cpos, crad, cvalid, cand_mask


def _greedy_accept(cpos, crad, cvalid, overlap: float, matrix: bool):
    """Greedy acceptance in decreasing radius order (top_k is sorted), on
    the device without a host sync per step, over the valid candidates
    (the padding after them is never accepted): a candidate is accepted if
    its overlap with every accepted one stays <= overlap. With `matrix`
    the K x K overlap matrix is computed once and each step takes one
    masked row-max; without it each step evaluates its row (O(K) memory).
    Both give the same row values, elementwise. Returns (K,) float 0/1."""
    accepted = torch.zeros_like(crad)
    n_valid = int(cvalid.sum())
    if matrix:
        ov_mat = circle_overlap_fraction(cpos[:, None, :], crad[:, None],
                                         cpos[None, :, :], crad[None, :])
        ov_mat.fill_diagonal_(0.0)
        for i in range(n_valid):
            ok = ((ov_mat[i] * accepted).amax() <= overlap) & cvalid[i]
            accepted[i] = ok.to(accepted.dtype)
    else:
        for i in range(n_valid):
            ov = circle_overlap_fraction(cpos[i], crad[i], cpos,
                                         crad) * accepted
            ov[i] = 0.0
            accepted[i] = ((ov.amax() <= overlap)
                           & cvalid[i]).to(accepted.dtype)
    return accepted


def find_tunnels(peak_pos, peak_valid, npix: int, max_voids: int = 256,
                 overlap: float = 0.2, min_radius: float = 1.0):
    """Tunnels void finder (Cautun arxiv:1710.01730), grid version.

    Voids are maximal circles empty of tracers: candidates are local maxima
    of the tracer distance transform (radius = distance to nearest tracer),
    accepted greedily in decreasing-radius order if the overlap fraction
    with every already-accepted void stays below `overlap`.

    Args:
      peak_pos: (P, 2) tracer pixel coordinates.
      peak_valid: (P,) bool mask of usable tracers.
      npix: map resolution.
      max_voids: candidate/catalog capacity.

    The acceptance and the compaction run in the profiler span
    `voids.accept`, beside `_tunnel_candidates`' two spans.
    """
    cpos, crad, cvalid, cand_mask = _tunnel_candidates(
        peak_pos, peak_valid, npix, max_voids, min_radius)
    with _span("voids.accept"):
        accepted = _greedy_accept(cpos, crad, cvalid, overlap,
                                  matrix=crad.shape[0] <= _OVERLAP_MATRIX_MAX)
        acc = accepted > 0
        radius = torch.where(acc, crad, torch.zeros_like(crad))
        # compact: accepted first, by decreasing radius (rejected -> key
        # -1); stable, as jnp.argsort, so equal radii keep candidate order
        order = torch.argsort(-torch.where(acc, radius,
                                           torch.full_like(radius, -1.0)),
                              stable=True)
        return VoidCatalog(pos=cpos[order], radius=radius[order],
                           n=acc.sum(), n_candidates=cand_mask.sum())


def find_tunnels_auto(peak_pos, peak_valid, npix: int,
                      max_voids: int = 256, overlap: float = 0.2,
                      min_radius: float = 1.0,
                      capacity_limit: int = 1 << 14,
                      device=None) -> VoidCatalog:
    """`find_tunnels` with automatic capacity escalation (host loop).

    Re-runs with the capacity doubled until the pre-truncation candidate
    count fits, so a peak-dense map cannot lose candidates to the top-k
    cut. Raises if the map needs more than `capacity_limit` candidates.
    Numpy input goes to `device`, by default the CUDA card (it raises
    without one); tensors keep their device.
    """
    peak_pos = as_tensor(peak_pos, device)
    peak_valid = as_tensor(peak_valid, peak_pos.device)
    cap = int(max_voids)
    while True:
        cat = find_tunnels(peak_pos, peak_valid, npix, max_voids=cap,
                           overlap=overlap, min_radius=min_radius)
        ncand = int(cat.n_candidates)
        if ncand <= cap:
            return cat
        if cap >= capacity_limit:
            raise ValueError(
                f"find_tunnels_auto: {ncand} candidates exceed the "
                f"capacity limit {capacity_limit}; raise capacity_limit "
                "or increase min_radius")
        while cap < ncand:
            cap *= 2
        cap = min(cap, capacity_limit)


# ---------------------------------------------------------------- watershed
def _neighbor_min_pointer(img):
    """For each pixel, the flat index (int64) of the smallest 3x3
    neighbour, self included: strict `<` in the loop order (the first
    smaller neighbour wins a tie), +inf beyond the edges (no wrap)."""
    n = img.shape[-1]
    dev = img.device
    padded = F.pad(img, (1, 1, 1, 1), value=float("inf"))
    ar = torch.arange(n, device=dev)
    best_val = img
    best_idx = torch.arange(n * n, device=dev).reshape(n, n)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            nb = padded[1 + di:1 + di + n, 1 + dj:1 + dj + n]
            nb_idx = (torch.clamp(ar[:, None] + di, 0, n - 1) * n
                      + torch.clamp(ar[None, :] + dj, 0, n - 1))
            better = nb < best_val
            best_val = torch.where(better, nb, best_val)
            best_idx = torch.where(better, nb_idx, best_idx)
    return best_idx.reshape(-1)


def watershed_labels(img, device=None):
    """Steepest-descent basin labels: each pixel's label is the flat index
    of the local minimum its descent path reaches (pointer jumping,
    ceil(log2 n^2) + 1 steps). Numpy input goes to `device`, as in
    `find_tunnels_auto`."""
    img = as_tensor(img, device)
    n = img.shape[-1]
    ptr = _neighbor_min_pointer(img)
    for _ in range(int(math.ceil(math.log2(n * n))) + 1):
        ptr = ptr[ptr]
    return ptr.reshape(n, n)


def _percentile(x, q: float):
    """jnp.percentile(x, q) (linear interpolation) of a flat float32
    tensor, with its float32 position arithmetic; by a sort, so any size
    (torch.quantile refuses more than 2^24 elements)."""
    n = x.shape[0]
    # (q / 100) * (n - 1) as XLA compiles it: the division a product by
    # the float32 reciprocal 0.01f, the constants folded first, so
    # q * ((n - 1) * 0.01f) (q = 100 can land below the last value)
    pos = (torch.tensor(q, dtype=torch.float32, device=x.device)
           * (torch.tensor(float(n - 1), device=x.device)
              * torch.tensor(0.01, dtype=torch.float32, device=x.device)))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    srt = torch.sort(x).values
    lo_v = srt[low.clamp(0, n - 1).to(torch.int64)]
    hi_v = srt[high.clamp(0, n - 1).to(torch.int64)]
    return lo_v * (1.0 - w_high) + hi_v * w_high


def watershed_voids(img, max_voids: int = 256, percentile_mask: float = 80.0,
                    device=None):
    """Watershed void catalog from a (smoothed) map.

    Labels basins by steepest descent, keeps only pixels at or below the
    `percentile_mask`-th percentile of the map, and reports per-basin area,
    effective radius sqrt(area/pi) and the basin-minimum position, ranked
    by area (`n_candidates` is left None, as in the JAX package). Numpy
    input goes to `device`, as in `find_tunnels_auto`.
    """
    img = as_tensor(img, device)
    n = img.shape[-1]
    labels = watershed_labels(img).reshape(-1)
    inmask = (img <= _percentile(img.reshape(-1), percentile_mask)
              ).reshape(-1)
    area = torch.bincount(labels[inmask], minlength=n * n).to(torch.float32)
    # basins are identified by their minimum's flat index; rank by area
    vals, idx = top_k_masked(area, area > 0, max_voids, fill=0.0)
    pos = torch.stack([(idx // n).to(torch.float32),
                       (idx % n).to(torch.float32)], dim=-1)
    radius = torch.sqrt(vals / torch.tensor(math.pi, device=img.device))
    return VoidCatalog(pos=pos, radius=radius, n=(vals > 0).sum())
