"""Tunnels void finder on flat-sky maps (largest empty circles).

Port of astrild_tpu/ops/voids.py (`distance_transform`,
`circle_overlap_fraction`, `find_tunnels`): a distance transform from the
tracer (peak) set, local-maximum candidate extraction, and greedy
overlap-pruned acceptance in decreasing-radius order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .peaks import candidate_topk, local_maxima

__all__ = ["VoidCatalog", "distance_transform", "find_tunnels",
           "circle_overlap_fraction"]


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
    """
    dist = distance_transform(peak_pos, peak_valid, npix)
    cand_mask = local_maxima(dist) & (dist >= min_radius)
    score = torch.where(cand_mask, dist, torch.full_like(dist, float("-inf")))
    vals, idx = candidate_topk(score, max_voids)
    cpos = torch.stack([(idx // npix).to(torch.float32),
                        (idx % npix).to(torch.float32)], dim=-1)
    cvalid = vals > float("-inf")
    crad = torch.where(cvalid, vals, torch.zeros_like(vals))
    k = crad.shape[0]

    # greedy acceptance in decreasing radius order (top_k is sorted): the
    # K x K overlap matrix is computed once; the sequential loop then does
    # one masked row-max per step, on the device, without host syncs
    ov_mat = circle_overlap_fraction(cpos[:, None, :], crad[:, None],
                                     cpos[None, :, :], crad[None, :])
    ov_mat = ov_mat * (1.0 - torch.eye(k, dtype=ov_mat.dtype,
                                       device=ov_mat.device))
    accepted = torch.zeros_like(crad)
    for i in range(k):
        ok = ((ov_mat[i] * accepted).amax() <= overlap) & cvalid[i]
        accepted[i] = ok.to(accepted.dtype)
    acc = accepted > 0
    radius = torch.where(acc, crad, torch.zeros_like(crad))
    # compact: accepted first, by decreasing radius (rejected -> key -1);
    # stable, as jnp.argsort, so equal radii keep candidate order
    order = torch.argsort(-torch.where(acc, radius,
                                       torch.full_like(radius, -1.0)),
                          stable=True)
    return VoidCatalog(pos=cpos[order], radius=radius[order], n=acc.sum(),
                       n_candidates=cand_mask.sum())
