"""Halo-catalog statistics: mass function, histograms, concentration-mass,
theory mass and void-size functions, virial relations, environment and
shape.

Port of astrild_tpu/ops/halo_stats.py. Segment sums are `index_add_` /
`bincount` in float32; the Prada concentration's Newton iteration takes
its derivative by forward-mode autodiff (`torch.func.jvp`), as the JAX
package's `jax.jvp`. The theory functions differentiate ln sigma by
reverse-mode autograd through `linear_power.sigma_r`, which the port
evaluates in float64 over a vector of radii (one backward for every
derivative); the JAX package's is float32, so the two agree to float32
precision, not to its rounding. `theory_hmf` of a traced cosmology takes
the slope in closed form instead (`linear_power.sigma_r_slope`), since a
nested backward does not compose with torch.func. Numpy input goes to `device`, by default
the CUDA card (it raises without one); tensors keep their device.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .._device import as_tensor
from ..utils.constants import G_NEWTON, RHO_CRIT0
from .profiles3d import _linspace_f32
from .tpcf import _flat_comps
from .voids3d import _f32

__all__ = [
    "halo_mass_function", "binned_mean", "histogram_density",
    "concentration_mass_rockstar", "concentration_prada",
    "concentration_mass_prada", "theory_hmf", "svdw_multiplicity",
    "theory_vsf", "rho_crit_200", "virial_radius", "virial_velocity",
    "halo_environment", "point_cloud_shape", "binned_halo_statistics",
]


def _logspace_f32(lo, hi, num: int, device):
    """jnp.logspace in float32: 10 ** (the float32 linspace)."""
    return torch.pow(10.0, _linspace_f32(lo, hi, num, device))


def _bin_index(edges, x, nbins: int):
    return torch.clamp(torch.searchsorted(edges, x, right=True) - 1, 0,
                       nbins - 1)


def _segment_sum(values, binidx, nbins: int):
    out = torch.zeros(nbins, dtype=values.dtype, device=values.device)
    return out.index_add_(0, binidx, values)


def halo_mass_function(mass, limits=(11.78, 16.0), nbins: int = 20,
                       device=None):
    """Cumulative halo mass function N(>M): halos histogrammed in
    log-spaced mass bins and reverse-cumulated.

    Args:
      mass: (n,) halo masses [Msun/h]; padded entries may be 0 or negative
        (the lower limit drops them).
    Returns (mass_bin_centers, cumulative_counts), float32.
    """
    m = as_tensor(mass, device)
    lo, hi = float(min(limits)), float(max(limits))
    edges = _logspace_f32(lo, hi, nbins + 1, m.device)
    valid = m > 10.0 ** lo
    binidx = _bin_index(edges, m, nbins)
    inside = valid & (m >= edges[0]) & (m < edges[-1])
    counts = _segment_sum(inside.to(torch.float32), binidx, nbins)
    cum = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
    return 0.5 * (edges[1:] + edges[:-1]), cum


def binned_mean(x, values, edges, nbins: int, valid=None, device=None):
    """scipy.stats.binned_statistic(..., statistic='mean') equivalent.

    Entries outside [edges[0], edges[-1]] (or with valid=False) are
    ignored; empty bins return NaN.
    """
    x = as_tensor(x, device)
    dev = x.device
    values = as_tensor(values, dev)
    edges = as_tensor(edges, dev)
    if valid is None:
        valid = torch.ones_like(x, dtype=torch.bool)
    else:
        valid = as_tensor(valid, dev)
    binidx = _bin_index(edges, x, nbins)
    # scipy puts x == edges[-1] in the last bin (clipped back above)
    inside = valid & (x >= edges[0]) & (x <= edges[-1])
    w = inside.to(torch.float32)
    num = _segment_sum(w * values, binidx, nbins)
    den = _segment_sum(w, binidx, nbins)
    return torch.where(den > 0, num / torch.clamp_min(den, 1),
                       torch.full_like(num, float("nan")))


def histogram_density(values, nbins: int, vrange: Tuple[float, float],
                      valid=None, device=None):
    """np.histogram(..., density=True) equivalent; float32 bins over
    [lo, hi], the last one closed. Returns (bin_centers, density)."""
    values = as_tensor(values, device)
    dev = values.device
    lo, hi = vrange
    if valid is None:
        valid = torch.ones_like(values, dtype=torch.bool)
    else:
        valid = as_tensor(valid, dev)
    edges = _linspace_f32(lo, hi, nbins + 1, dev)
    binidx = _bin_index(edges, values, nbins)
    inside = valid & (values >= lo) & (values <= hi)
    counts = _segment_sum(inside.to(torch.float32), binidx, nbins)
    width = _f32((hi - lo) / nbins, dev)
    dens = counts / torch.clamp_min(counts.sum(), 1) / width
    return 0.5 * (edges[1:] + edges[:-1]), dens


def concentration_mass_rockstar(m200c, r200c, rs, limits, nbins: int = 20,
                                valid=None, device=None):
    """c-M relation with c = R200c/Rs, binned in log mass."""
    m200c = as_tensor(m200c, device)
    dev = m200c.device
    r200c, rs = as_tensor(r200c, dev), as_tensor(rs, dev)
    lo, hi = limits
    edges = _logspace_f32(lo, hi, nbins + 1, dev)
    c_nfw = r200c / torch.clamp_min(rs, 1e-12)
    valid = (torch.ones_like(m200c, dtype=torch.bool) if valid is None
             else as_tensor(valid, dev))
    valid = valid & (m200c > 10.0 ** lo) & (m200c < 10.0 ** hi)
    c_mean = binned_mean(m200c, c_nfw, edges, nbins, valid=valid)
    return 0.5 * (edges[1:] + edges[:-1]), c_mean


def concentration_prada(vmax, v200, n_iter: int = 40, device=None):
    """Prada et al. 2012 concentration from vmax/v200 by a fixed number of
    Newton steps over the whole catalog.

    Solves sqrt(0.216 x / (ln(1+x) - x/(1+x))) = vmax/v200 for x = c.
    Returns (c, converged_mask); halos with v200 >= vmax are marked
    unconverged.
    """
    vmax = as_tensor(vmax, device)
    v200 = as_tensor(v200, vmax.device)
    ratio = vmax / torch.clamp_min(v200, 1e-12)

    def y(x):
        mu = torch.log(1.0 + x) - x / (1.0 + x)
        return torch.sqrt(0.216 * x / torch.clamp_min(mu, 1e-12)) - ratio

    x = torch.full_like(ratio, 5.0)
    ones = torch.ones_like(x)
    for _ in range(n_iter):
        fx, dfx = torch.func.jvp(y, (x,), (ones,))
        step = fx / torch.where(torch.abs(dfx) > 1e-12, dfx,
                                torch.full_like(dfx, 1e-12))
        x = torch.clamp(x - step, 0.1, 1e4)
    converged = (torch.abs(y(x)) < 1e-5) & (v200 < vmax)
    return x, converged


def concentration_mass_prada(m200c, vmax, v200, limits, nbins: int = 20,
                             valid=None, device=None):
    """c-M relation via the Prada method."""
    m200c = as_tensor(m200c, device)
    dev = m200c.device
    lo, hi = limits
    edges = _logspace_f32(lo, hi, nbins + 1, dev)
    c, conv = concentration_prada(as_tensor(vmax, dev), as_tensor(v200, dev))
    valid = (torch.ones_like(m200c, dtype=torch.bool) if valid is None
             else as_tensor(valid, dev))
    valid = valid & conv & (m200c > 10.0 ** lo) & (m200c < 10.0 ** hi)
    c_mean = binned_mean(m200c, c, edges, nbins, valid=valid)
    return 0.5 * (edges[1:] + edges[:-1]), c_mean


# ------------------------------------------------------- theory mass functions
# dn/dlnM = f(sigma) (rho_mean/M) |dln sigma / dlnM|, sigma(M, z) from the
# linear P(k) (linear_power.sigma_r), the log-derivative by autograd
# through the sigma integral.

DELTA_C = 1.686  # spherical-collapse threshold
_DELTA_C = DELTA_C


def _multiplicity(sigma, model: str, z: float = 0.0):
    nu = _DELTA_C / sigma
    if model == "ps":
        # Press-Schechter 1974
        return math.sqrt(2.0 / math.pi) * nu * torch.exp(-0.5 * nu ** 2)
    if model == "st":
        # Sheth-Tormen 1999
        a, p, A = 0.707, 0.3, 0.3222
        anu2 = a * nu ** 2
        return (A * torch.sqrt(2.0 * anu2 / math.pi)
                * (1.0 + anu2 ** -p) * torch.exp(-0.5 * anu2))
    if model == "tinker08":
        # Tinker+2008 eqs. 3 & 5-8, Delta = 200 rho_mean, with the (1+z)
        # evolution of A, a, b
        zp1 = 1.0 + z
        A = 0.186 * zp1 ** -0.14
        a = 1.47 * zp1 ** -0.06
        alpha = 10.0 ** (-((0.75 / math.log10(200.0 / 75.0)) ** 1.2))
        b = 2.57 * zp1 ** -alpha
        c = 1.19
        return A * ((sigma / b) ** -a + 1.0) * torch.exp(-c / sigma ** 2)
    raise ValueError(f"unknown hmf model {model!r}")


def _ln_sigma_and_slope(lnx, to_r, cosmo, amplitude, growth):
    """ln(D sigma(R)) at R = to_r(exp(lnx)) and its derivative in lnx, both
    float64: one backward through the vector (each entry depends on its
    own lnx only)."""
    from .linear_power import sigma_r

    lnx = lnx.detach().to(torch.float64).requires_grad_(True)
    with torch.enable_grad():
        ln_sig = torch.log(sigma_r(to_r(torch.exp(lnx)), cosmo,
                                   amplitude=amplitude) * growth)
        (slope,) = torch.autograd.grad(ln_sig.sum(), lnx)
    return ln_sig.detach(), slope


def theory_hmf(m_msun_h, cosmo, z: float = 0.0, model: str = "st",
               amplitude=None, device=None):
    """dn/dlnM [h^3/Mpc^3] at masses m [Msun/h] for PS / ST / Tinker08, as
    a float64 tensor.

    sigma(M, z) = D(z) sigma(R(M)) with R = (3M / 4 pi rho_mean)^(1/3);
    dln sigma/dlnM by autograd through the sigma_r quadrature, or, for a
    traced cosmology (tensor fields, a Fisher Jacobian), in closed form
    (`linear_power.sigma_r_slope`: R ~ M^(1/3), so dlnR/dlnM = 1/3), which
    composes with torch.func. amplitude overrides the sigma8
    normalization.
    """
    from .linear_power import _scalar, normalization, sigma_r_slope

    m = as_tensor(m_msun_h, device)
    amp = normalization(cosmo) if amplitude is None else amplitude
    rho_mean = cosmo.Om0 * RHO_CRIT0  # (Msun/h) / (Mpc/h)^3
    growth = _scalar(cosmo.growth_factor(z))

    def radius(mass):
        return (3.0 * mass / (4.0 * math.pi * rho_mean)) ** (1.0 / 3.0)

    lnm = torch.log(m.to(torch.float64))
    if cosmo.traced:
        sig, dlns_dlnr = sigma_r_slope(radius(torch.exp(lnm)), cosmo,
                                       amplitude=amp)
        ln_sig, dlns_dlnm = torch.log(sig * growth), dlns_dlnr / 3.0
    else:
        ln_sig, dlns_dlnm = _ln_sigma_and_slope(lnm, radius, cosmo, amp,
                                                growth)
    f = _multiplicity(torch.exp(ln_sig), model, z=z)
    return f * rho_mean / torch.exp(lnm) * torch.abs(dlns_dlnm)


# ----------------------------------------------------------- void abundance
_DELTA_V = -2.717  # linear underdensity of shell crossing (EdS)


def svdw_multiplicity(sigma, delta_v: float = _DELTA_V,
                      delta_c: float = 1.686, n_terms: int = 6,
                      device=None):
    """Sheth & van de Weygaert 2004 two-barrier void multiplicity f(sigma).

    Jennings+13 (arXiv:1304.6087 Eq. 8) hybrid: the series
    f = 2 sum_j (j pi x^2) sin(j pi D) exp(-(j pi x)^2 / 2),
    x = D sigma/|delta_v|, D = |delta_v|/(delta_c + |delta_v|), for
    x > 0.276; below, the single-barrier limit
    sqrt(2/pi) (|delta_v|/sigma) exp(-delta_v^2/2 sigma^2). A tensor keeps
    its dtype (float32 as the JAX package's; float64 from the theory
    functions), other input is float32.
    """
    if isinstance(sigma, torch.Tensor):
        sigma = sigma if sigma.is_floating_point() else sigma.float()
    else:
        sigma = as_tensor(sigma, device).to(torch.float32)
    av = abs(delta_v)
    D = av / (delta_c + av)
    x = D * sigma / av
    j = torch.arange(1, n_terms + 1, dtype=sigma.dtype, device=sigma.device)
    series = torch.sum(
        2.0 * (j * math.pi) * x[..., None] ** 2
        * torch.sin(j * math.pi * D)
        * torch.exp(-0.5 * (j * math.pi * x[..., None]) ** 2), dim=-1)
    small = (math.sqrt(2.0 / math.pi) * (av / sigma)
             * torch.exp(-0.5 * av ** 2 / sigma ** 2))
    return torch.where(x > 0.276, series, small)


def theory_vsf(r_void_hmpc, cosmo, z: float = 0.0, model: str = "vdn",
               delta_v: float = _DELTA_V, delta_c: float = 1.686,
               delta_v_nl: float = -0.8, amplitude=None, device=None):
    """Theory void size function dn/dlnR_v [h^3/Mpc^3], float64.

    Models (Jennings+13):
      'svdw' : dn/dlnR = f(sigma)/V(R) dln sigma^-1/dlnR at the Lagrangian
               radius (no expansion);
      'vdn'  : voids expand by a_v = (1 + delta_v_nl)^(-1/3) and the model
               conserves the volume fraction: V(r_v) dn/dlnr_v =
               V(R_L) dn/dlnR_L with r_v = a_v R_L.

    delta_v is the linear underdensity barrier matching delta_v_nl.
    """
    from .linear_power import normalization

    if model not in ("svdw", "vdn"):
        raise ValueError(f"unknown vsf model {model!r} (svdw|vdn)")
    amp = normalization(cosmo) if amplitude is None else amplitude
    growth = float(cosmo.growth_factor(z))
    a_v = (1.0 + delta_v_nl) ** (-1.0 / 3.0)
    r_v = as_tensor(r_void_hmpc, device).to(torch.float64)
    r_lag = r_v / a_v if model == "vdn" else r_v

    ln_sig, dlns_dlnr = _ln_sigma_and_slope(torch.log(r_lag), lambda r: r,
                                            cosmo, amp, growth)
    f = svdw_multiplicity(torch.exp(ln_sig), delta_v=delta_v,
                          delta_c=delta_c)
    v_lag = 4.0 / 3.0 * math.pi * r_lag ** 3
    dn_dlnr_lag = f / v_lag * torch.abs(dlns_dlnr)
    if model == "svdw":
        return dn_dlnr_lag
    # volume-conserving map to the expanded radius: number density scales
    # by V_L/V_v = a_v^-3; dlnr_v == dlnR_L
    return dn_dlnr_lag / a_v ** 3


# -------------------------------------------------- virial scaling relations
# M in Msun/h, R in Mpc/h, v in km/s (h-free combinations).

def rho_crit_200(m200, r200, device=None):
    """Mean overdensity 3M/(4 pi R^3) implied by (M200, R200), in
    Msun/h (Mpc/h)^-3; equals 200 rho_crit for a consistent catalog."""
    m200 = as_tensor(m200, device).to(torch.float32)
    r200 = as_tensor(r200, m200.device).to(torch.float32)
    return 3.0 / (4.0 * math.pi) * m200 / r200 ** 3


def virial_radius(m200, rho_delta=None, device=None):
    """R such that M = (4 pi/3) rho_delta R^3; rho_delta defaults to
    200 rho_crit,0."""
    m200 = as_tensor(m200, device).to(torch.float32)
    dev = m200.device
    if rho_delta is None:
        rho_delta = 200.0 * RHO_CRIT0
    return (m200 / _f32(rho_delta, dev) / _f32(4.0 * math.pi / 3.0, dev)
            ) ** (1.0 / 3.0)


def virial_velocity(m200, r200, device=None):
    """Circular velocity sqrt(G M / R) in km/s."""
    m200 = as_tensor(m200, device).to(torch.float32)
    r200 = as_tensor(r200, m200.device).to(torch.float32)
    return torch.sqrt(G_NEWTON * m200 / r200)


# ------------------------------------------------------- environment tagging
def halo_environment(pos, env_grid, box, outside_value: int = -1,
                     device=None):
    """Sample a cosmic-web environment grid at halo positions (NGP).

    Each halo gets the tag of the grid cell holding it; halos outside the
    grid's box get `outside_value`.

    Args:
      pos: (n, 3) positions, or a tuple of three (n,) components.
      env_grid: (nx, ny, nz) integer (or float) environment tags.
      box: 6 floats (x0, x1, y0, y1, z0, z1), the grid's bounding box.
    Returns (n,) tags with env_grid's dtype.
    """
    px, py, pz = _flat_comps(pos, device)
    dev = px.device
    env = as_tensor(env_grid, dev)
    box = np.asarray(box, np.float64)
    if box.shape != (6,):
        raise ValueError("box must be 6 values (x0,x1,y0,y1,z0,z1)")
    lo = box[::2]
    dx = (box[1::2] - box[::2]) / np.asarray(env.shape, np.float64)
    ix, iy, iz = (torch.floor((p - _f32(lo[a], dev)) / _f32(dx[a], dev))
                  .to(torch.int64) for a, p in enumerate((px, py, pz)))
    inside = ((ix >= 0) & (ix < env.shape[0]) & (iy >= 0)
              & (iy < env.shape[1]) & (iz >= 0) & (iz < env.shape[2]))
    tags = env[ix.clamp(0, env.shape[0] - 1), iy.clamp(0, env.shape[1] - 1),
               iz.clamp(0, env.shape[2] - 1)]
    return torch.where(inside, tags,
                       torch.tensor(outside_value, dtype=env.dtype,
                                    device=dev))


# ----------------------------------------------------------- halo/void shape
def point_cloud_shape(pos, weights=None, device=None):
    """Second-moment (inertia) shape of a point cloud: eigendecomposition
    of sum(w x_i x_j)/sum(w) about the origin (center the positions first
    for shapes about the centroid), by the symmetric eigensolver.

    Args:
      pos: (n, 3) positions, or tuple of three (n,) components.
    Returns:
      (axis_lengths, axis_vectors): sqrt-eigenvalues in decreasing order
      (a >= b >= c) and the matching unit eigenvectors as rows (each
      defined up to its sign).
    """
    comps = _flat_comps(pos, device)
    dev = comps[0].device
    w = (torch.ones_like(comps[0]) if weights is None
         else as_tensor(weights, dev).to(torch.float32))
    wsum = torch.clamp_min(torch.sum(w), 1e-30)
    inertia = torch.stack(
        [torch.stack([torch.sum(w * comps[i] * comps[j]) for j in range(3)])
         for i in range(3)]) / wsum
    evals, evecs = torch.linalg.eigh(inertia)  # ascending
    order = torch.flip(torch.argsort(evals), (0,))
    lengths = torch.sqrt(torch.clamp_min(evals[order], 0.0))
    return lengths, evecs[:, order].T


# ------------------------------------------------- binned property summaries
def binned_halo_statistics(mass, props, mass_edges, n_boot: int = 100,
                           seed: int = 0):
    """Per-mass-bin summary statistics of halo properties.

    For each mass bin and each property column: the median with its
    bootstrap error, the 16th/84th percentiles, and the mean with its
    bootstrap error. Host numpy (a catalog summary, not device work), the
    JAX package's function as it is.

    Args:
      mass: (n,) masses. props: (n,) or (n, p) property columns.
      mass_edges: (nbins+1,) bin edges.
    Returns a dict of (nbins, p) arrays: 'count', 'median',
    'median_err', 'p16', 'p84', 'mean', 'mean_err' (count is (nbins,)).
    """
    mass = np.asarray(mass, np.float64)
    props = np.asarray(props, np.float64)
    if props.ndim == 1:
        props = props[:, None]
    edges = np.asarray(mass_edges, np.float64)
    nbins, p = edges.size - 1, props.shape[1]
    rng = np.random.default_rng(seed)
    out = {k: np.full((nbins, p), np.nan) for k in
           ("median", "median_err", "p16", "p84", "mean", "mean_err")}
    out["count"] = np.zeros(nbins, np.int64)
    for i in range(nbins):
        sel = (mass >= edges[i]) & (mass < edges[i + 1])
        n = int(sel.sum())
        out["count"][i] = n
        if n == 0:
            continue
        vals = props[sel]
        out["median"][i] = np.median(vals, axis=0)
        out["p16"][i] = np.percentile(vals, 16.0, axis=0)
        out["p84"][i] = np.percentile(vals, 84.0, axis=0)
        out["mean"][i] = np.mean(vals, axis=0)
        idx = rng.integers(0, n, size=(n_boot, n))
        boot = vals[idx]                      # (n_boot, n, p)
        out["median_err"][i] = np.std(np.median(boot, axis=1), axis=0)
        out["mean_err"][i] = np.std(np.mean(boot, axis=1), axis=0)
    return out
