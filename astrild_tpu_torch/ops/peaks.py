"""Peak detection on flat-sky maps: local maxima, top-K catalogs, SNR.

Port of astrild_tpu/ops/peaks.py (`local_maxima`, `candidate_topk`,
`find_peaks`, `peak_counts`). Top-K selection is a stable descending sort, so exactly tied
values keep the lower index first, as `jax.lax.top_k` does (`torch.topk`
promises no order among ties).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["PeakCatalog", "local_maxima", "find_peaks", "peak_counts",
           "candidate_topk"]

# named profiler span of the peak catalog (a few microseconds when no
# profiler runs)
_span = torch.profiler.record_function


class PeakCatalog(NamedTuple):
    """Fixed-capacity peak list; entries [n:] are padding (value -inf)."""

    pos: torch.Tensor     # (K, 2) pixel coordinates (row, col), int64
    values: torch.Tensor  # (K,)
    snr: torch.Tensor     # (K,)
    n: torch.Tensor       # scalar int: number of valid peaks


def local_maxima(img):
    """Boolean mask of strict local maxima over the 8-neighbourhood."""
    padded = F.pad(img, (1, 1, 1, 1), value=float("-inf"))
    m = torch.ones_like(img, dtype=torch.bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            nb = padded[1 + di:1 + di + img.shape[0],
                        1 + dj:1 + dj + img.shape[1]]
            m = m & (img > nb)
    return m


def _top_k(x, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties in
    index order (the `jax.lax.top_k` contract)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def top_k_masked(values, mask, k: int, fill: float = float("-inf")):
    """`jax.lax.top_k(where(mask, values, fill), k)` of flat tensors whose
    masked values all exceed `fill`, without sorting the whole array.

    The masked entries (`nonzero` lists them by ascending index) are sorted
    stably, so ties keep the lower index first; a short list is padded, as
    top_k pads it, with the lowest-index entries outside the mask (value
    `fill`). Those lie among the first k indices, so only those are
    searched.
    """
    idx = torch.nonzero(mask).squeeze(1)
    vals, order = torch.sort(values[idx], descending=True, stable=True)
    idx = idx[order][:k]
    vals = vals[:k]
    if idx.shape[0] < k:
        pad = torch.nonzero(~mask[:k]).squeeze(1)[:k - idx.shape[0]]
        idx = torch.cat([idx, pad])
        vals = torch.cat([vals, torch.full(pad.shape, fill,
                                           dtype=vals.dtype,
                                           device=vals.device)])
    return vals, idx


def candidate_topk(score2d, k: int):
    """top_k over a strict-local-maximum candidate score map.

    score2d holds -inf everywhere except at strict 8-neighbourhood local
    maxima. Two such candidates can never be adjacent, so every 2x2 block
    holds at most one finite entry: a 2x2 max-pool is lossless and the
    top_k runs on a 4x smaller array. Winner pixel positions are recovered
    by comparing the 4 source pixels of each winning block.

    Falls back to plain top_k for odd sizes / tiny maps. The order of
    exactly-tied candidates follows their 2x2-block index.
    """
    n = score2d.shape[-1]
    if n % 2 or k > (n // 2) ** 2 or n < 512:
        return _top_k(score2d.reshape(-1), k)
    half = n // 2
    rowmax = score2d.reshape(half, 2, n).amax(dim=1)
    colmax = torch.maximum(rowmax[:, 0::2], rowmax[:, 1::2])  # (half, half)
    vals, bidx = _top_k(colmax.reshape(-1), k)
    bi = bidx // half
    bj = bidx - bi * half
    base = (2 * bi) * n + 2 * bj
    cand = torch.stack([base, base + 1, base + n, base + n + 1])  # (4, k)
    cvals = score2d.reshape(-1)[cand]
    which = torch.argmax(cvals, dim=0)  # first maximum, as jnp.argmax
    idx = torch.gather(cand, 0, which[None, :])[0]
    return vals, idx


def find_peaks(img, threshold=float("-inf"), max_peaks: int = 1024,
               edge_pix: int = 0, sigma: Optional[float] = None):
    """Find local maxima above `threshold`, sorted by value (desc).

    Args:
      img: (n, n) map.
      threshold: minimum peak value.
      max_peaks: catalog capacity.
      edge_pix: drop peaks within this many pixels of the border.
      sigma: noise level for SNR; defaults to the population std(img)
        (ddof=0, as jnp.std).

    Returns PeakCatalog with padded entries at -inf. Runs in the
    profiler span `peaks.find`.
    """
    with _span("peaks.find"):
        n = img.shape[-1]
        mask = local_maxima(img) & (img >= threshold)
        if edge_pix:
            r = torch.arange(n, device=img.device)
            inside = (r >= edge_pix) & (r < n - edge_pix)
            mask = mask & inside[:, None] & inside[None, :]
        score = torch.where(mask, img, torch.full_like(img, float("-inf")))
        vals, idx = candidate_topk(score, max_peaks)
        pos = torch.stack([idx // n, idx % n], dim=-1)
        count = (vals > float("-inf")).sum()
        std = img.std(correction=0) if sigma is None else sigma
        snr = vals / std
        return PeakCatalog(pos=pos, values=vals, snr=snr, n=count)


def peak_counts(img, vmin, vmax, nbins: int = 50, edge_pix: int = 0,
                device=None):
    """Histogram of local-maximum heights (the weak-lensing peak-count
    statistic), `nbins` float32 bins over [vmin, vmax] (the last one
    closed). Returns (bin_centers, counts), both float32. Numpy input goes
    to `device`, by default the CUDA card (it raises without one); tensors
    keep their device."""
    from .._device import as_tensor
    from .profiles3d import _linspace_f32

    img = as_tensor(img, device)
    n = img.shape[-1]
    mask = local_maxima(img)
    if edge_pix:
        r = torch.arange(n, device=img.device)
        inside = (r >= edge_pix) & (r < n - edge_pix)
        mask = mask & inside[:, None] & inside[None, :]
    vals = img.reshape(-1)
    edges = _linspace_f32(vmin, vmax, nbins + 1, img.device)
    binidx = torch.clamp(torch.searchsorted(edges, vals, right=True) - 1,
                         0, nbins - 1)
    keep = mask.reshape(-1) & (vals >= edges[0]) & (vals <= edges[-1])
    counts = torch.bincount(binidx[keep], minlength=nbins).to(torch.float32)
    return 0.5 * (edges[1:] + edges[:-1]), counts
