"""3D radial density and velocity profiles around centers, and NFW fits.

Port of astrild_tpu/ops/profiles3d.py. The JAX package maps one center at
a time over the particles (vmap); the port computes all centers' (nc, np)
separations at once and bins them with one `bincount` (float64 sums, cast
to float32). The log-spaced shell edges are built in float32 with the JAX
package's own formula (`_log_edges`), so that a particle on an edge lands
in the same shell in both packages.
"""
from __future__ import annotations

import math

import torch

from .._device import as_tensor

__all__ = ["radial_density_profiles", "radial_velocity_profiles",
           "stacked_profile", "nfw_profile", "fit_nfw"]


def _linspace_f32(start, stop, num: int, device=None):
    """jnp.linspace in float32: start * (1 - i/div) + stop * (i/div) for
    i < div = num - 1, then stop itself (torch.linspace rounds the
    interior points differently)."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    div = num - 1
    step = (torch.arange(div, dtype=torch.float32, device=device)
            / torch.tensor(float(div), device=device))
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _log_edges(r_min, r_max, nbins: int, device):
    """nbins + 1 float32 edges 10 ** linspace(log10 r_min, log10 r_max)."""
    lo = torch.log10(torch.as_tensor(r_min, dtype=torch.float32,
                                     device=device))
    hi = torch.log10(torch.as_tensor(r_max, dtype=torch.float32,
                                     device=device))
    return 10.0 ** _linspace_f32(lo, hi, nbins + 1, device)


def _shell_separations(pos, centers, edges, nbins: int, boxsize):
    """(d_vec, d, slot): the (nc, np, 3) separations of every particle
    from every center (minimum image with a box), their lengths, and each
    pair's bin slot c * (nbins + 1) + b, with b = nbins outside
    [edges[0], edges[-1])."""
    d_vec = pos[None, :, :] - centers[:, None, :]
    if boxsize is not None:
        box = torch.as_tensor(boxsize, dtype=pos.dtype, device=pos.device)
        d_vec = d_vec - box * torch.round(d_vec / box)
    d = torch.sqrt(torch.sum(d_vec ** 2, dim=-1))
    b = torch.clamp(torch.searchsorted(edges, d, right=True) - 1, 0, nbins)
    inside = (d >= edges[0]) & (d < edges[-1])
    b = torch.where(inside, b, nbins)
    rows = torch.arange(centers.shape[0], device=pos.device)[:, None]
    return d_vec, d, inside, (rows * (nbins + 1) + b).reshape(-1)


def _bin_sums(slot, values, nc: int, nbins: int):
    acc = torch.bincount(slot, weights=values.reshape(-1).to(torch.float64),
                         minlength=nc * (nbins + 1))
    return acc.view(nc, nbins + 1)[:, :nbins].to(torch.float32)


def radial_density_profiles(pos, mass, centers, r_min, r_max,
                            nbins: int = 20, boxsize=None, device=None):
    """rho(r) in log-spaced shells around each center.

    Args:
      pos: (np, 3) particle positions; mass: (np,) particle masses;
        centers: (nh, 3). Numpy input goes to `device`, by default the
        CUDA card (it raises without one); tensors keep their device.
      r_min, r_max: radial range (same units as pos).
      boxsize: optional periodic wrap (minimum image). Without it, shells
        that cross a box boundary lose the wrapped volume.

    Returns (r_centers (nbins,), rho (nh, nbins)). Memory: (nh, np, 3)
    floats; chunk the centers at large np (density_split_profiles does).
    """
    pos = as_tensor(pos, device)
    dev = pos.device
    mass = as_tensor(mass, dev)
    centers = as_tensor(centers, dev)
    edges = _log_edges(r_min, r_max, nbins, dev)
    vol = 4.0 / 3.0 * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    _, _, inside, slot = _shell_separations(pos, centers, edges, nbins,
                                            boxsize)
    w = torch.where(inside, mass[None, :], 0.0)
    rho = _bin_sums(slot, w, centers.shape[0], nbins) / vol
    r = torch.sqrt(edges[1:] * edges[:-1])
    return r, rho


def radial_velocity_profiles(pos, vel, centers, r_min, r_max,
                             nbins: int = 20, boxsize=None, device=None):
    """Mean radial velocity v_r(r) in log shells around each center
    (outflow around voids is v_r > 0). Placement as in
    `radial_density_profiles`.

    Returns (r_centers (nbins,), v_r (nc, nbins), counts (nc, nbins)).
    """
    pos = as_tensor(pos, device)
    dev = pos.device
    vel = as_tensor(vel, dev)
    centers = as_tensor(centers, dev)
    edges = _log_edges(r_min, r_max, nbins, dev)
    d_vec, d, inside, slot = _shell_separations(pos, centers, edges, nbins,
                                                boxsize)
    vr = torch.sum(vel[None, :, :] * d_vec, dim=-1) / d.clamp_min(1e-12)
    nc = centers.shape[0]
    vsum = _bin_sums(slot, torch.where(inside, vr, 0.0), nc, nbins)
    nsum = _bin_sums(slot, inside.to(torch.float32), nc, nbins)
    v_r = torch.where(nsum > 0, vsum / nsum.clamp_min(1.0), torch.nan)
    r = torch.sqrt(edges[1:] * edges[:-1])
    return r, v_r, nsum


def stacked_profile(profile, counts, device=None):
    """Count-weighted stack of per-object profiles (NaN bins excluded).

    profile/counts: (nc, nbins) from radial_*_profiles (numpy goes to
    `device`, by default the CUDA card; counts follow the profiles).
    Returns (nbins,).
    """
    profile = as_tensor(profile, device)
    counts = as_tensor(counts, profile.device)
    good = torch.isfinite(profile) & (counts > 0)
    w = torch.where(good, counts, 0.0)
    num = torch.sum(torch.where(good, profile, 0.0) * w, dim=0)
    den = torch.sum(w, dim=0)
    return torch.where(den > 0, num / den.clamp_min(1e-30), torch.nan)


def nfw_profile(r, rho_s, r_s):
    """rho(r) = rho_s / [(r/rs)(1 + r/rs)^2]."""
    x = r / r_s
    return rho_s / (x * (1.0 + x) ** 2)


def fit_nfw(r, rho, n_iter: int = 60, device=None):
    """Fit (rho_s, r_s) by Gauss-Newton on log rho; batched over halos.

    Args: r (nbins,), rho (nh, nbins) tensors (zeros/NaN ignored).
    The JAX package takes the residual's jacobian by autodiff; here it is
    the closed form: with x = r / r_s, d model / d ln r_s = 1 + 2x/(1+x)
    and d model / d ln rho_s = 1. The 2x2 normal equations are built from
    elementwise products and sums and solved in closed form. Numpy input
    goes to `device`, by default the CUDA card (rho follows r).
    Returns (rho_s (nh,), r_s (nh,)).
    """
    r = as_tensor(r, device)
    rho = as_tensor(rho, r.device)
    good = torch.isfinite(rho) & (rho > 0)
    logrho = torch.where(good, torch.log(torch.where(good, rho, 1.0)), 0.0)
    nh = rho.shape[0]
    lrs = torch.full((nh,), float(torch.log(r[r.shape[0] // 2])),
                     device=r.device)
    lrhos = torch.log(torch.where(good, rho, 1e-30).max(dim=1).values)
    for _ in range(n_iter):
        x = r[None, :] / torch.exp(lrs)[:, None]
        model = lrhos[:, None] - torch.log(x) - 2.0 * torch.log1p(x)
        res = torch.where(good, model - logrho, 0.0)
        j0 = torch.where(good, 1.0 + 2.0 * x / (1.0 + x), 0.0)
        j1 = torch.where(good, 1.0, 0.0)
        # the normal equations (J^T J + 1e-6 I) step = J^T res as sums of
        # elementwise products, solved in closed form: no matrix product
        # or solver a caller's TF32 setting could reach
        a = torch.sum(j0 * j0, dim=1) + 1e-6
        b = torch.sum(j0 * j1, dim=1)
        d = torch.sum(j1 * j1, dim=1) + 1e-6
        g0 = torch.sum(j0 * res, dim=1)
        g1 = torch.sum(j1 * res, dim=1)
        det = a * d - b * b
        lrs = lrs - (d * g0 - b * g1) / det
        lrhos = lrhos - (a * g1 - b * g0) / det
    return torch.exp(lrhos), torch.exp(lrs)
