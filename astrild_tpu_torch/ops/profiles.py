"""Radial profiles of objects on flat-sky maps, with block bootstrap and
tangential shear.

Port of astrild_tpu/ops/profiles.py: per-object annulus binning as one
batched gather and bin sum (objects in chunks, so the (objects, patch,
patch) temporaries stay bounded), the NaN-robust mean with linear fill of
empty annuli, the spatial block bootstrap of the mean profile, and
gamma_t(r) = kappa_bar(<r) - kappa(r) by the cumulative-bin identity.

The bootstrap draws its block indices from a `torch.Generator` and hands
them to `bootstrap_profiles_from_draws`, which also takes the JAX
package's `randint` draws (one row per resample, in its key-split order).
Numpy input goes to `device`, by default the CUDA card (it raises without
one); tensors keep their device.
"""
from __future__ import annotations

import math

import torch

from .._device import as_tensor
from ..utils.tables import interp

__all__ = [
    "object_profiles", "mean_and_interpolate", "bootstrap_profiles",
    "bootstrap_profiles_from_draws", "tangential_shear",
]

# objects a chunk of object_profiles holds at most this many patch pixels
_CHUNK_PIXELS = 1 << 24


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _linspace_jit_f32(start, stop, num: int, device):
    """jnp.linspace(start, stop, num) in float32 as XLA compiles it inside
    a jitted function: the division by num - 1 a product by its float32
    reciprocal r, and stop * (i r) reassociated to i (stop r), so
    start (1 - i r) + i (stop r), then stop itself. Tensor endpoints of
    one shape give one such row each (shape (..., num))."""
    div = num - 1
    r = _f32(1.0 / div, device)
    i = torch.arange(div, device=device).to(torch.float32)
    start, stop = torch.broadcast_tensors(_f32(start, device)[..., None],
                                          _f32(stop, device)[..., None])
    out = start * (1.0 - i * r) + i * (stop * r)
    return torch.cat([out, stop], dim=-1)


def object_profiles(skymap, centers_pix, radii_pix, patch_half: int,
                    nbins: int = 10, extend: float = 1.0, device=None):
    """Annulus-binned radial profiles for a batch of objects.

    For object i the j-th annulus covers eta = r/R_i in [j, j+1) *
    extend/nbins, and the profile value is the mean of the map pixels in
    it. The patch of side 2 * patch_half + 1 (at most the map) is clamped
    inside the map at its edges, as the JAX package's dynamic_slice is;
    offsets are measured from the object's own centre.

    Args:
      skymap: (n, n) map.
      centers_pix: (nobj, 2) int (row, col) centers.
      radii_pix: (nobj,) object radii in pixels.
      patch_half: half-size of the extracted patch; must be >= ceil(max
        radius * extend).
      nbins: number of radial bins.
      extend: profile reach in units of object radii.

    Returns:
      eta: (nbins,) bin centers in units of object radius.
      values: (nobj, nbins) annulus means (NaN where an annulus is empty).
    """
    skymap = as_tensor(skymap, device)
    dev = skymap.device
    centers = as_tensor(centers_pix, dev).to(torch.int64)
    radii = as_tensor(radii_pix, dev).to(torch.float32)
    n = skymap.shape[-1]
    patch_half = min(int(patch_half), (n - 1) // 2)
    p = 2 * patch_half + 1
    ar = torch.arange(p, device=dev)
    # the bin decision as XLA compiles the JAX package's
    # (d / r) / (extend / nbins): extend times the float32 reciprocal of
    # nbins, and one division of d by r * delta_eta (by a device tensor,
    # never a Python scalar that the card would turn into a reciprocal)
    reach = _f32(extend, dev)
    delta_eta = reach * _f32(1.0 / nbins, dev)
    nobj = centers.shape[0]
    chunk = max(1, _CHUNK_PIXELS // (p * p))
    values = []
    for a in range(0, nobj, chunk):
        cen = centers[a:a + chunk]
        r0 = torch.clamp(cen[:, 0] - patch_half, 0, n - p)
        c0 = torch.clamp(cen[:, 1] - patch_half, 0, n - p)
        rows = r0[:, None] + ar                       # (m, p)
        cols = c0[:, None] + ar
        patch = skymap[rows[:, :, None], cols[:, None, :]]
        drow = (rows - cen[:, 0:1]).to(torch.float32)
        dcol = (cols - cen[:, 1:2]).to(torch.float32)
        d = torch.sqrt(drow[:, :, None] ** 2 + dcol[:, None, :] ** 2)
        r = torch.clamp_min(radii[a:a + chunk], 1e-6)[:, None, None]
        binidx = torch.clamp((d / (r * delta_eta)).to(torch.int32), 0, nbins)
        inside = d / r < reach
        b = torch.where(inside, binidx, nbins).to(torch.int64)
        m = cen.shape[0]
        seg = (b + (nbins + 1) * torch.arange(m, device=dev)[:, None, None]
               ).reshape(-1)
        w = inside.to(torch.float64).reshape(-1)
        nseg = m * (nbins + 1)
        vsum = torch.bincount(seg, weights=w * patch.reshape(-1).double(),
                              minlength=nseg).to(torch.float32)
        cnt = torch.bincount(seg, weights=w, minlength=nseg).to(
            torch.float32)
        vsum = vsum.reshape(m, nbins + 1)[:, :nbins]
        cnt = cnt.reshape(m, nbins + 1)[:, :nbins]
        values.append(torch.where(cnt > 0, vsum / torch.clamp_min(cnt, 1.0),
                                  torch.full_like(cnt, math.nan)))
    values = (torch.cat(values) if values
              else torch.empty((0, nbins), device=dev))
    edges = _linspace_jit_f32(0.0, extend, nbins + 1, dev)
    return 0.5 * (edges[1:] + edges[:-1]), values


def mean_and_interpolate(profiles, weights=None, device=None):
    """Weighted mean over objects ignoring NaNs; bins with no data are
    filled by linear interpolation over the bin index (jnp.interp over the
    good bins, the bad ones moved to 1e9 behind them, as the JAX package
    does)."""
    profiles = as_tensor(profiles, device)
    dev = profiles.device
    nbins = profiles.shape[-1]
    if weights is None:
        weights = torch.ones(profiles.shape[:-1], dtype=profiles.dtype,
                             device=dev)
    else:
        weights = as_tensor(weights, dev)
    finite = torch.isfinite(profiles)
    w = weights[..., None] * finite
    vals = torch.where(finite, profiles, torch.zeros_like(profiles))
    num = torch.sum(w * vals, dim=0)
    den = torch.sum(w, dim=0)
    nan = torch.full_like(num, math.nan)
    mean = torch.where(den > 0, num / torch.clamp_min(den, 1e-30), nan)
    x = torch.arange(nbins, dtype=mean.dtype, device=dev)
    good = torch.isfinite(mean)
    xg = torch.where(good, x, torch.full_like(x, 1e9))
    order = torch.argsort(xg, stable=True)
    xs = xg[order]
    ys = torch.where(good, mean, torch.zeros_like(mean))[order]
    filled = interp(x, xs, ys)
    return torch.where(good, mean, torch.where(good.any(), filled, nan))


def _block_index(centers, block_pix: int, npix: int):
    """Each object's spatial block (row-major over (npix // block_pix)^2
    blocks, at least 1), clamped into range as a JAX gather clamps."""
    nblk = max(npix // block_pix, 1)
    blk = (torch.div(centers[:, 0], block_pix, rounding_mode="floor") * nblk
           + torch.div(centers[:, 1], block_pix, rounding_mode="floor"))
    return torch.clamp(blk, 0, nblk * nblk - 1), nblk * nblk


def _nanpercentile(x, q: float):
    """jnp.nanpercentile(x, q, axis=0) inside a jitted function: NaNs
    sorted last, the position (q * 0.01f) * (count - 1) in float32 (XLA
    turns the division by 100 into that product), linear interpolation
    between the neighbours with the upper term's product fused into the
    sum (one rounding, as XLA's CPU code contracts it: float64 here); NaN
    where a column holds no number."""
    dev = x.device
    srt = torch.sort(x, dim=0).values        # NaN sorts last in torch
    counts = torch.sum(~torch.isnan(x), dim=0).to(torch.float32)
    pos = (_f32(q, dev) * _f32(0.01, dev)) * (counts - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    top = counts - 1.0
    low = torch.clamp_min(torch.minimum(low, top), 0.0).to(torch.int64)
    high = torch.clamp_min(torch.minimum(high, top), 0.0).to(torch.int64)
    lo_v = torch.gather(srt, 0, low[None])[0]
    hi_v = torch.gather(srt, 0, high[None])[0]
    return (hi_v.double() * w_high.double()
            + (lo_v * w_low).double()).to(torch.float32)


def bootstrap_profiles_from_draws(profiles, centers_pix, drawn,
                                  block_pix: int = 256, npix: int = 4096,
                                  lo: float = 16.0, hi: float = 84.0,
                                  device=None):
    """`bootstrap_profiles` after its draws: `drawn` (n_boot, nblocks)
    holds each resample's block indices in [0, nblocks). Objects are
    grouped into spatial blocks by their centers; a resample weighs each
    object by its block's multiplicity among the draws and averages the
    profiles. Returns the (lo, hi) percentile envelopes of the resampled
    means."""
    profiles = as_tensor(profiles, device)
    dev = profiles.device
    centers = as_tensor(centers_pix, dev).to(torch.int64)
    drawn = as_tensor(drawn, dev).to(torch.int64)
    blk, nblocks = _block_index(centers, block_pix, npix)
    finite = torch.isfinite(profiles)
    vals = torch.where(finite, profiles, torch.zeros_like(profiles))
    n_boot = drawn.shape[0]
    # multiplicity of each block in each resample
    mult = torch.zeros((n_boot, nblocks), dtype=torch.float32, device=dev)
    mult.scatter_add_(1, drawn, torch.ones_like(drawn, dtype=torch.float32))
    w_obj = mult[:, blk][:, :, None] * finite           # (n_boot, nobj, nb)
    num = torch.sum(w_obj * vals, dim=1)
    den = torch.sum(w_obj, dim=1)
    means = torch.where(den > 0, num / torch.clamp_min(den, 1e-30),
                        torch.full_like(num, math.nan))
    return _nanpercentile(means, lo), _nanpercentile(means, hi)


def bootstrap_profiles(profiles, centers_pix, generator: torch.Generator,
                       n_boot: int = 100, block_pix: int = 256,
                       npix: int = 4096, lo: float = 16.0, hi: float = 84.0,
                       device=None):
    """Spatial block bootstrap of the mean profile: each of `n_boot`
    resamples draws the (npix/block_pix)^2 blocks with replacement from
    `generator` (on the profiles' device); see
    `bootstrap_profiles_from_draws`."""
    profiles = as_tensor(profiles, device)
    nblk = max(npix // block_pix, 1)
    drawn = torch.randint(0, nblk * nblk, (n_boot, nblk * nblk),
                          generator=generator, device=profiles.device)
    return bootstrap_profiles_from_draws(profiles, centers_pix, drawn,
                                         block_pix, npix, lo, hi)


def tangential_shear(eta, kappa_profile, device=None):
    """gamma_t(r) = mean kappa inside r minus kappa(r): kappa_bar(<r_j) =
    sum_i<=j kappa_i A_i / sum A_i with the 2D annulus areas A_i = 2 pi
    eta_i d_eta of uniform bins."""
    eta = as_tensor(eta, device)
    kappa_profile = as_tensor(kappa_profile, eta.device)
    deta = eta[1] - eta[0]
    area = _f32(2.0 * math.pi, eta.device) * eta * deta
    csum_ka = torch.cumsum(kappa_profile * area, dim=0)
    csum_a = torch.cumsum(area, dim=0)
    return csum_ka / torch.clamp_min(csum_a, 1e-30) - kappa_profile
