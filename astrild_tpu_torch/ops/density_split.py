"""Density-split statistics, counts-in-cells and the marked power spectrum.

Port of astrild_tpu/ops/density_split.py: smooth the density field, rank
query points by their local smoothed density, split into quantiles, and
stack the tracer profiles around each quantile; counts-in-cells PDFs and
their moments; White's (2016) marked P(k). Smoothing is spectral (one
rfftn + one irfftn), profiles delegate to
`profiles3d.radial_density_profiles`, and the paints of `marked_power` go
through `paint.paint` (on a CUDA tensor the tile-binned painter K2).
"""
from __future__ import annotations

import math

import torch

from .._device import as_points, as_tensor, default_device
from .paint import paint
from .power import auto_power
from .profiles3d import _log_edges, radial_density_profiles
from .voids3d import _kmag_r, _tophat

__all__ = ["smooth_density", "lattice_query_points", "density_at_points",
           "density_quantile_labels", "density_split_profiles",
           "counts_in_cells", "counts_in_cells_moments", "marked_power"]


def smooth_density(delta, boxsize, radius, kind: str = "tophat"):
    """Spectrally smoothed density contrast (periodic).

    kind='tophat': spherical top-hat of radius R (the DSC convention);
    kind='gauss': Gaussian of width R.
    """
    ngrid = delta.shape[-1]
    dims = (-3, -2, -1)
    dk = torch.fft.rfftn(delta, dim=dims)
    kf = 2.0 * math.pi / boxsize
    kr = _kmag_r(ngrid, delta.device) * kf * radius
    w = _tophat(kr) if kind == "tophat" else torch.exp(-0.5 * kr ** 2)
    return torch.fft.irfftn(dk * w, s=(ngrid,) * 3, dim=dims)


def lattice_query_points(n_side: int, boxsize, device=None):
    """(n_side^3, 3) cell-centered query lattice, on `device` (by default
    the CUDA card; it raises without one)."""
    device = default_device(device)
    cell = boxsize / n_side
    x = (torch.arange(n_side, dtype=torch.float32, device=device)
         + 0.5) * cell
    g = torch.meshgrid(x, x, x, indexing="ij")
    return torch.stack([c.reshape(-1) for c in g], dim=-1)


def density_at_points(field, boxsize, points, device=None):
    """Trilinear (CIC) interpolation of a periodic grid at points.

    points: (n, 3) tensor or a tuple of flat (x, y, z) tensors (the tuple
    saves an (n, 3) copy at large n). Numpy input goes to `device`, by
    default the CUDA card; the points follow the field.
    """
    field = as_tensor(field, device)
    ngrid = field.shape[-1]
    cell = boxsize / ngrid
    points = as_points(points, field.device)
    if isinstance(points, (tuple, list)):
        comps = tuple(c.reshape(-1) for c in points)
    else:
        comps = (points[:, 0], points[:, 1], points[:, 2])
    u = [c / cell - 0.5 for c in comps]
    i0 = [torch.floor(c).to(torch.int32) for c in u]
    f = [u[a] - i0[a] for a in range(3)]
    flat = field.reshape(-1)
    out = torch.zeros(comps[0].shape[0], dtype=field.dtype,
                      device=field.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[0] if dx else 1 - f[0])
                     * (f[1] if dy else 1 - f[1])
                     * (f[2] if dz else 1 - f[2]))
                idx = ((torch.remainder(i0[0] + dx, ngrid) * ngrid
                        + torch.remainder(i0[1] + dy, ngrid)) * ngrid
                       + torch.remainder(i0[2] + dz, ngrid))
                out = out + w * flat.index_select(0, idx)
    return out


def density_quantile_labels(values, n_quantiles: int = 5):
    """Quantile label (0 = least dense) per point, equal-count split.

    Ties are broken by position (a stable sort, as jnp.argsort's), so
    counts per quantile differ by at most 1 even for tied inputs.
    """
    n = values.shape[0]
    order = torch.argsort(values, stable=True)
    ranks = torch.empty(n, dtype=torch.int64, device=values.device)
    ranks[order] = torch.arange(n, device=values.device)
    return (ranks * n_quantiles // n).to(torch.int32)


def density_split_profiles(delta, boxsize, tracer_pos, smooth_radius,
                           n_quantiles: int = 5, n_query: int = 16,
                           r_min=None, r_max=None, nbins: int = 12):
    """Stacked tracer overdensity profiles around density quantiles.

    Args:
      delta: (n, n, n) density contrast used for the environment split.
      tracer_pos: (nt, 3) tracer positions for the profile measurement
        (numpy input follows delta's device).
      smooth_radius: top-hat smoothing radius [Mpc/h] of the split field.
      n_query: query lattice side (n_query^3 points, equal-count split).

    The profiles around the query points are taken in chunks of at most
    2^28 / (3 nt) points, as the JAX package's lax.map does.

    Returns (r_centers (nbins,), profiles (n_quantiles, nbins)): stacked
    delta_tracer(r | quantile).
    """
    dev = delta.device
    tracer_pos = as_tensor(tracer_pos, dev)
    ngrid = delta.shape[-1]
    sm = smooth_density(delta, boxsize, smooth_radius)
    q = lattice_query_points(n_query, boxsize, device=dev)
    d_q = density_at_points(sm, boxsize, q)
    labels = density_quantile_labels(d_q, n_quantiles)

    r_lo = boxsize / ngrid if r_min is None else r_min
    r_hi = boxsize / 4.0 if r_max is None else r_max
    nt = tracer_pos.shape[0]
    nq3 = q.shape[0]
    block = max(1, min(nq3, (1 << 28) // max(3 * nt, 1)))
    ones = torch.ones(nt, device=dev)
    rho = torch.cat([
        radial_density_profiles(tracer_pos, ones, q[s:s + block], r_lo,
                                r_hi, nbins=nbins, boxsize=boxsize)[1]
        for s in range(0, nq3, block)])
    edges = _log_edges(r_lo, r_hi, nbins, dev)
    r = torch.sqrt(edges[1:] * edges[:-1])
    nbar = nt / boxsize ** 3
    prof = rho / nbar - 1.0
    lab = labels.to(torch.int64)
    sums = torch.zeros(n_quantiles, nbins, device=dev).index_add_(0, lab,
                                                                  prof)
    cnts = torch.bincount(lab, minlength=n_quantiles).to(torch.float32)
    return r, sums / cnts.clamp_min(1.0)[:, None]


def counts_in_cells(pos, boxsize, n_cells: int, max_count: int = 64,
                    device=None):
    """P(N) histogram of tracer counts in a cubic-cell partition.

    pos: (n, 3) or flat-component tuple (numpy input goes to `device`, by
    default the CUDA card; it raises without one). Returns (pdf
    (max_count+1,), counts_grid (n_cells^3,)): the normalized count PDF
    (last entry accumulates overflow) and the per-cell counts (float32).
    """
    pos = as_points(pos, device)
    if isinstance(pos, tuple):
        x, y, z = (c.reshape(-1) for c in pos)
    else:
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dev = x.device
    # a tensor divisor: true division on the card too
    cell = torch.tensor(boxsize / n_cells, dtype=torch.float32, device=dev)

    # periodic wrap: a coordinate at exactly L lands in cell 0
    def idx(c):
        return torch.remainder(torch.floor(c / cell).to(torch.int64),
                               n_cells)

    flat = (idx(x) * n_cells + idx(y)) * n_cells + idx(z)
    counts = torch.bincount(flat, minlength=n_cells ** 3).to(torch.float32)
    c = torch.clamp(counts.to(torch.int64), 0, max_count)
    total = torch.tensor(float(n_cells ** 3), device=dev)
    pdf = torch.bincount(c, minlength=max_count + 1).to(torch.float32) / total
    return pdf, counts


def counts_in_cells_moments(counts, device=None):
    """(mean, variance, skewness) of per-cell counts (float32, population
    variance as jnp.var); for a Poisson sample variance == mean and the
    reduced skewness ~ 1/sqrt(mean). Numpy counts go to `device`, by
    default the CUDA card."""
    c = as_tensor(counts, device).to(torch.float32)
    mu = torch.mean(c)
    var = torch.var(c, correction=0)
    m3 = torch.mean((c - mu) ** 3)
    skew = m3 / torch.clamp_min(var, 1e-30) ** 1.5
    return mu, var, skew


def marked_power(pos, ngrid: int, boxsize, smooth_radius,
                 mark_p: float = 1.0, mark_delta_s: float = 0.25,
                 nbins: int = 0, window: str = "cic",
                 kind: str = "tophat", device=None):
    """Marked (density-weighted) power spectrum (White 2016,
    arXiv:1609.08632 Eq. 3):

        m(x) = [(1 + delta_s) / (1 + delta_s + delta_R(x))]^p

    with delta_R the smoothed density at each tracer. p > 0 up-weights
    underdense environments; p = 0 reduces exactly to the unmarked P(k)
    with shot noise V/N. The shot noise of the marked field is the
    weighted discrete-tracer one, V sum(m^2) / (sum m)^2.

    pos: (n, 3) or flat-component tuple, placed as in `counts_in_cells`.
    Two paints (counts, then marks as weights). Returns (PowerResult,
    marks).
    """
    pos = as_points(pos, device)
    if isinstance(pos, tuple):
        comps = tuple(c.reshape(-1) for c in pos)
    else:
        comps = (pos[:, 0], pos[:, 1], pos[:, 2])
    counts = paint(comps, ngrid, boxsize, window=window)
    delta = counts / torch.mean(counts) - 1.0
    sm = smooth_density(delta, boxsize, smooth_radius, kind=kind)
    d_r = density_at_points(sm, boxsize, comps)  # flat comps: no (N, 3)
    marks = ((1.0 + mark_delta_s)
             / (1.0 + mark_delta_s + torch.clamp_min(
                 d_r, -mark_delta_s - 0.999))) ** mark_p
    grid = paint(comps, ngrid, boxsize, weights=marks, window=window)
    shot = (boxsize ** 3 * torch.sum(marks ** 2)
            / torch.clamp_min(torch.sum(marks), 1e-30) ** 2)
    res = auto_power(grid, boxsize, nbins=nbins, window=window,
                     shotnoise=shot)
    return res, marks
