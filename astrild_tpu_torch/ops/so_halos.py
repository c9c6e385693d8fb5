"""Spherical-overdensity (SO) halo finder on a periodic density grid.

Port of astrild_tpu/ops/so_halos.py: a snapshot's density grid becomes an
M_Delta halo catalog that feeds the mass function, HOD and profile code.

  1. mean enclosed density per cell from the top-hat radius ladder of the
     spherical void finder (`voids3d.enclosed_density_radius`) with the
     sign flipped: R_Delta is the last radius where the enclosed contrast
     crosses Delta - 1 from above;
  2. candidate centers: periodic local maxima of the lightly smoothed
     density with R_Delta > 0, ranked by R_Delta;
  3. greedy exclusivity: a candidate whose center lies inside a more
     massive accepted halo's R_Delta is absorbed.

M_Delta = (4 pi / 3) R_Delta^3 Delta rho_mean.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._device import as_tensor
from ..utils.constants import RHO_CRIT0
from .peaks import top_k_masked
from .voids3d import (_DIMS, _accepted_first, _gauss_smooth, _grid_centers,
                      _kmag_r, _local_maxima_periodic,
                      enclosed_density_radius)

__all__ = ["SOHaloCatalog", "so_halos", "so_catalog_dict"]


class SOHaloCatalog(NamedTuple):
    """Fixed-capacity SO halo list, mass-ordered; entries [n:] padded."""

    pos: torch.Tensor           # (K, 3) halo centers [Mpc/h]
    radius: torch.Tensor        # (K,) R_Delta [Mpc/h]
    mass: torch.Tensor          # (K,) M_Delta [Msun/h]
    peak_delta: torch.Tensor    # (K,) smoothed center density contrast
    n: torch.Tensor             # scalar int: accepted halos
    n_candidates: torch.Tensor  # scalar int: pre-truncation candidates


def _absorb(cpos, crad, cvalid, boxsize):
    """The greedy pass in candidate order: a candidate is accepted unless
    its center lies inside an accepted candidate's radius. One small
    kernel chain a candidate, on the tensors' device, no host sync but one
    for the count of valid candidates (the padding after them is never
    accepted)."""
    box = torch.tensor(float(boxsize), dtype=torch.float32,
                       device=cpos.device)
    accepted = torch.zeros(crad.shape, dtype=torch.bool, device=cpos.device)
    for i in range(int(cvalid.sum())):
        d_vec = cpos[i] - cpos
        d_vec = d_vec - box * torch.round(d_vec / box)
        d = torch.sqrt(torch.sum(d_vec ** 2, dim=-1))
        # the candidate itself is not accepted yet, so it never absorbs
        # itself
        inside = (d < crad) & accepted
        accepted[i] = ~inside.any() & cvalid[i]
    return accepted


def so_halos(delta, boxsize, om0, delta_mean: float = 200.0,
             max_halos: int = 512, r_min=None, r_max=None,
             n_radii: int = 32, smooth_cells: float = 1.0, device=None):
    """SO halos from a (n, n, n) periodic density-contrast grid.

    Args:
      delta: density contrast (a paint / mean - 1; R_Delta below ~1.5
        cells is not trusted and r_min defaults there).
      boxsize: box side [Mpc/h].
      om0: Omega_m, for M_Delta = (4pi/3) R^3 Delta rho_mean.
      delta_mean: overdensity relative to the mean matter density (200 ->
        M200m, the theory_hmf / Tinker convention).
      max_halos: catalog capacity; `n_candidates` reports the
        pre-truncation peak count.
      r_min / r_max: radius ladder bounds [Mpc/h]; defaults 1.5 cells and
        boxsize/8.
      smooth_cells: Gaussian smoothing (cells) for peak detection only.
      device: where numpy input goes (by default the CUDA card; it raises
        without one); a tensor keeps its device.
    """
    delta = as_tensor(delta, device)
    ngrid = delta.shape[-1]
    dev = delta.device
    cell = boxsize / ngrid
    r_lo = 1.5 * cell if r_min is None else r_min
    r_hi = boxsize / 8.0 if r_max is None else r_max
    thresh = delta_mean - 1.0

    # enclosed density falling through Delta is -delta rising through
    # -(Delta - 1): the void-side crossing scan with the signs flipped
    dk = torch.fft.rfftn(delta, dim=_DIMS)
    rstar = enclosed_density_radius(-delta, boxsize, r_lo, r_hi,
                                    n_radii=n_radii,
                                    delta_threshold=-thresh, dk=-dk)
    kmag = _kmag_r(ngrid, dev) * (2.0 * math.pi / boxsize)
    smooth = _gauss_smooth(dk, kmag, smooth_cells * cell, ngrid)
    del dk, kmag

    cand = (_local_maxima_periodic(smooth) & (rstar > 0.0)).reshape(-1)
    vals, idx = top_k_masked(rstar.reshape(-1), cand, max_halos)
    del rstar
    cpos = _grid_centers(idx, ngrid, cell)
    cvalid = vals > float("-inf")
    crad = torch.where(cvalid, vals, torch.zeros_like(vals))
    cpeak = smooth.reshape(-1)[idx]

    acc = _absorb(cpos, crad, cvalid, boxsize)
    radius = torch.where(acc, crad, torch.zeros_like(crad))
    rho_mean = om0 * RHO_CRIT0
    mass = (4.0 / 3.0) * math.pi * radius ** 3 * delta_mean * rho_mean
    order = _accepted_first(acc, radius)
    return SOHaloCatalog(pos=cpos[order], radius=radius[order],
                         mass=mass[order], peak_delta=cpeak[order],
                         n=acc.sum(), n_candidates=cand.sum())


def so_catalog_dict(cat: SOHaloCatalog, rockstar_names: bool = False
                    ) -> dict:
    """Host column dict: x, y, z [Mpc/h], mass [Msun/h], radius [Mpc/h],
    peak_delta.

    rockstar_names=True also aliases mass/radius as m200c/r200c for code
    that reads Rockstar columns; the finder measures Delta x the MEAN
    density (M200m for delta_mean=200), not 200c.
    """
    n = int(cat.n)
    pos = cat.pos.cpu().numpy()[:n]
    d = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
         "mass": cat.mass.cpu().numpy()[:n],
         "radius": cat.radius.cpu().numpy()[:n],
         "peak_delta": cat.peak_delta.cpu().numpy()[:n]}
    if rockstar_names:
        d["m200c"] = d["mass"]
        d["r200c"] = d["radius"]
    return d
