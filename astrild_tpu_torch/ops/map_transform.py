"""3D grid vector calculus, point-set gridding and per-object map cutouts
on torch tensors.

Port of astrild_tpu/ops/map_transform.py. Derivatives are `jnp.gradient`'s:
second-order central differences inside, first-order one-sided differences
at the two edges (`torch.gradient(..., edge_order=1)`). Numpy input goes
to `device`, by default the CUDA card (it raises without one); tensors keep
their device.
"""
from __future__ import annotations

import torch

from .._device import as_tensor

__all__ = ["divergence", "gradient_3d", "scatter_points_to_grid",
           "object_cutouts", "paint_objects_on_map", "slice_map"]


def gradient_3d(field, spacing=1.0, device=None):
    """Gradients of an (n, n, n) scalar field; returns (3, n, n, n)."""
    field = as_tensor(field, device)
    return torch.stack(torch.gradient(field, spacing=spacing, edge_order=1),
                       dim=0)


def divergence(vec_field, spacing=1.0):
    """div v of a (3, n, n, n) vector field."""
    return sum(torch.gradient(vec_field[i], spacing=spacing, dim=i,
                              edge_order=1)[0]
               for i in range(3))


def _cell_keys(pos, boxsize, n: int):
    """floor(pos / (boxsize / n)) mod n, the cell size a float32 device
    tensor."""
    cell = (torch.tensor(boxsize, dtype=torch.float32, device=pos.device)
            / torch.tensor(float(n), device=pos.device))
    return torch.remainder(torch.floor(pos / cell).to(torch.int64), n)


def _cell_mean(vsum, cnt):
    return torch.where(cnt > 0, vsum / torch.clamp_min(cnt, 1.0),
                       torch.zeros_like(vsum))


def scatter_points_to_grid(pos, values, ngrid: int, boxsize,
                           reduce: str = "mean", device=None):
    """Point samples -> NGP grid, mean- or sum-reduced per cell."""
    pos = as_tensor(pos, device)
    values = as_tensor(values, pos.device)
    u = _cell_keys(pos, boxsize, ngrid)
    flat = (u[:, 0] * ngrid + u[:, 1]) * ngrid + u[:, 2]
    vsum = torch.zeros(ngrid ** 3, dtype=values.dtype, device=pos.device)
    vsum.index_add_(0, flat, values)
    if reduce == "mean":
        cnt = torch.zeros_like(vsum).index_add_(0, flat,
                                                torch.ones_like(values))
        vsum = _cell_mean(vsum, cnt)
    return vsum.reshape(ngrid, ngrid, ngrid)


def slice_map(pos, values, npix: int, boxsize, axis: int = 2,
              slab_center=None, slab_width=None, device=None):
    """2D NGP mean map of a scalar sampled on the points within a slab
    (default: the central sixteenth of the box along `axis`); empty pixels
    hold 0."""
    pos = as_tensor(pos, device)
    dev = pos.device
    values = as_tensor(values, dev)
    if slab_center is None:
        slab_center = boxsize / 2.0
    if slab_width is None:
        slab_width = boxsize / 16.0
    sel = (torch.abs(pos[:, axis] - torch.tensor(
        slab_center, dtype=torch.float32, device=dev))
        <= torch.tensor(slab_width / 2.0, dtype=torch.float32, device=dev))
    axes = [a for a in range(3) if a != axis]
    u = _cell_keys(pos[:, axes], boxsize, npix)
    flat = u[:, 0] * npix + u[:, 1]
    w = sel.to(torch.float32)
    vsum = torch.zeros(npix ** 2, device=dev).index_add_(0, flat,
                                                         w * values)
    cnt = torch.zeros(npix ** 2, device=dev).index_add_(0, flat, w)
    return _cell_mean(vsum, cnt).reshape(npix, npix)


def object_cutouts(img, centers_pix, patch_half: int, device=None):
    """Fixed-size (2 patch_half + 1)^2 cutouts around object centres,
    clamped inside the map at its borders. Returns (nobj, p, p)."""
    img = as_tensor(img, device)
    centers = as_tensor(centers_pix, img.device).to(torch.int64)
    n = img.shape[-1]
    p = 2 * patch_half + 1
    ar = torch.arange(p, device=img.device)
    r0 = torch.clamp(centers[:, 0] - patch_half, 0, n - p)
    c0 = torch.clamp(centers[:, 1] - patch_half, 0, n - p)
    return img[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]]


def paint_objects_on_map(npix: int, centers_pix, radii_pix, values=None,
                         device=None):
    """Paint filled circles (value `values[i]`, default 1) onto a fresh
    map, one object after the other."""
    centers = as_tensor(centers_pix, device).to(torch.float32)
    dev = centers.device
    radii = as_tensor(radii_pix, dev).to(torch.float32)
    vals = (torch.ones(centers.shape[0], device=dev) if values is None
            else as_tensor(values, dev))
    ii = torch.arange(npix, device=dev).to(torch.float32)
    out = torch.zeros((npix, npix), device=dev)
    for i in range(centers.shape[0]):
        d2 = (ii[:, None] - centers[i, 0]) ** 2 + (ii[None, :]
                                                  - centers[i, 1]) ** 2
        out = out + torch.where(d2 <= radii[i] ** 2, vals[i],
                                torch.zeros_like(d2))
    return out
