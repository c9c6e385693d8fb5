"""Troughs (Gruen+16): random apertures keeping the lowest-mean fraction.

Port of astrild_tpu/ops/troughs.py: one batched masked mean over random
aperture centres, the lowest fraction kept by a stable sort (ties in index
order, as `lax.top_k` breaks them); trough radial profiles reuse
ops.profiles. The centres come from a `torch.Generator`;
`find_troughs_from_draws` takes them as drawn (the JAX package's `randint`
draws for parity). Numpy input goes to `device`, by default the CUDA card
(it raises without one); tensors keep their device.
"""
from __future__ import annotations

import torch

from .._device import as_tensor
from .peaks import _top_k
from .profiles import object_profiles

__all__ = ["find_troughs", "find_troughs_from_draws", "trough_profiles"]


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _trough_means(img, centers, rad_pix, rad_pix_max: int,
                  conv: bool = True):
    """Sum (conv: mean) of the pixels within rad_pix of each centre, over a
    (2 rad_pix_max + 1)^2 patch clamped inside the map."""
    dev = img.device
    n = img.shape[-1]
    p = 2 * rad_pix_max + 1
    offs = (torch.arange(p, device=dev) - rad_pix_max).to(torch.float32)
    d2 = offs[:, None] ** 2 + offs[None, :] ** 2
    mask = d2 <= _f32(rad_pix, dev) ** 2
    ar = torch.arange(p, device=dev)
    r0 = torch.clamp(centers[:, 0] - rad_pix_max, 0, n - p)
    c0 = torch.clamp(centers[:, 1] - rad_pix_max, 0, n - p)
    patch = img[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]]
    s = torch.sum(torch.where(mask, patch, torch.zeros_like(patch)),
                  dim=(1, 2))
    return s / mask.sum().to(torch.float32) if conv else s


def find_troughs_from_draws(img, centers, lowest_fraction: float,
                            rad_deg: float, map_width_deg: float,
                            conv: bool = True, device=None):
    """`find_troughs` after its draws: `centers` (n_troughs, 2) int
    aperture centres (row, col). Returns (positions_deg (N, 2) in (row,
    col) order, means (N,)) of the round(lowest_fraction * n_troughs)
    lowest apertures, lowest first."""
    img = as_tensor(img, device)
    dev = img.device
    centers = as_tensor(centers, dev).to(torch.int64)
    n = img.shape[-1]
    rad_pix = rad_deg * n / map_width_deg
    means = _trough_means(img, centers, rad_pix, int(rad_pix) + 1, conv)
    keep = int(round(lowest_fraction * centers.shape[0]))
    vals, idx = _top_k(-means, keep)
    pos_deg = (centers[idx].to(torch.float32) * _f32(map_width_deg, dev)
               / _f32(float(n), dev))
    return pos_deg, -vals


def find_troughs(img, generator: torch.Generator, n_troughs: int,
                 lowest_fraction: float, rad_deg: float,
                 map_width_deg: float, conv: bool = True,
                 border_frac: float = 0.25, device=None):
    """Place `n_troughs` random apertures (centres uniform in
    [border_frac * n, n - border_frac * n], drawn from `generator` on the
    map's device) and keep the lowest-mean fraction; see
    `find_troughs_from_draws`."""
    img = as_tensor(img, device)
    n = img.shape[-1]
    lower = int(border_frac * n)
    upper = n - lower
    centers = torch.randint(lower, upper + 1, (n_troughs, 2),
                            generator=generator, device=img.device)
    return find_troughs_from_draws(img, centers, lowest_fraction, rad_deg,
                                   map_width_deg, conv)


def trough_profiles(img, pos_deg, rad_deg: float, nbins: int,
                    map_width_deg: float, device=None):
    """Mean radial profile of the troughs at `pos_deg` ((row, col) order,
    as `find_troughs` returns them). Returns (r [deg], profile)."""
    img = as_tensor(img, device)
    dev = img.device
    pos_deg = as_tensor(pos_deg, dev)
    n = img.shape[-1]
    centers = torch.round(pos_deg * _f32(float(n), dev)
                          / _f32(map_width_deg, dev)).to(torch.int64)
    rad_pix = rad_deg * n / map_width_deg
    radii = torch.full((centers.shape[0],), rad_pix, dtype=torch.float32,
                       device=dev)
    eta, vals = object_profiles(img, centers, radii,
                                patch_half=int(rad_pix) + 2, nbins=nbins,
                                extend=1.0)
    return eta * _f32(rad_deg, dev), torch.nanmean(vals, dim=0)
