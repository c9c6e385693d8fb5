"""Statistics toolbox: histograms/PDFs, bootstrap, percentiles, least
squares, PCA.

Port of astrild_tpu/utils/analysis.py. The numpy functions
(`distribution_percentile`, `general_least_squares`,
`correlation_matrix`, `pdf_1d`, `cumulative`, `contour_value`,
`direction_correlation`, `point_density_2d`) are copies of the JAX
package's, bit for bit. The rest run in torch on the data's device (a
tensor's own; numpy input: `device`, by default the CUDA card, raising
without one):

  * `bootstrap_statistic` draws its resampling indices from a
    `torch.Generator` where the JAX package takes a PRNG key, chunk by
    chunk of resamples so that the card's memory stays bounded;
    `bootstrap_statistic_from_draws` takes the (n_boot, n) index matrix
    itself. Percentiles and medians follow jnp.percentile's float32
    position arithmetic (`voids._percentile`'s rule) along an axis.
  * The fits, the PCA and the covariance run in float64 and return
    float32, so a caller's TF32 setting cannot reach them (no float32
    matrix product).
  * `nonlinear_least_squares` takes its Jacobian from torch.func.jacfwd
    and keeps the JAX package's host float64 Levenberg-Marquardt loop.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor

__all__ = ["pdf_1d", "cumulative", "bootstrap_statistic",
           "bootstrap_statistic_from_draws", "percentiles",
           "least_squares_fit", "pca", "covariance_from_realizations",
           "nonlinear_least_squares", "contour_value",
           "direction_correlation", "point_density_2d",
           "distribution_percentile", "general_least_squares",
           "correlation_matrix"]

# resamples gathered at once by bootstrap_statistic: a chunk holds
# _BOOT_CHUNK_ENTRIES indices and values at most
_BOOT_CHUNK_ENTRIES = 1 << 26


def distribution_percentile(x, y, qs=(25.0, 75.0)):
    """X values where the normalized cumulative sum of Y crosses each
    percentile, linearly interpolated between samples
    (analysis.py:366-383 DistributionPercentile).
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    cum = np.cumsum(y)
    cum = cum / cum[-1]
    return [float(np.interp(q / 100.0, cum, x)) for q in np.atleast_1d(qs)]


def general_least_squares(Xs, y, weights=None):
    """Weighted linear least squares over an arbitrary basis
    (analysis.py:479-517 LeastSquare_general): Xs is a sequence of
    basis columns evaluated at the data points; fits y = sum a_i Xs[i].

    Returns (a, a_error, chi2_reduced, n_points) — parameter errors from
    the normal-matrix inverse scaled by the reduced chi-square.
    """
    A = np.stack([np.asarray(c, np.float64).ravel() for c in Xs], axis=-1)
    y = np.asarray(y, np.float64).ravel()
    w = (np.ones_like(y) if weights is None
         else np.broadcast_to(np.asarray(weights, np.float64), y.shape))
    M = A.T @ (w[:, None] * A)
    V = A.T @ (w * y)
    Minv = np.linalg.inv(M)
    a = Minv @ V
    resid = y - A @ a
    ndof = max(y.size - a.size, 1)
    chi2 = float((w * resid ** 2).sum() / ndof)
    a_err = np.sqrt(chi2 * np.diag(Minv))
    return a, a_err, chi2, y.size


def correlation_matrix(data, n_boot: int = 100, min_rows: int = 5,
                       seed: int = 0):
    """Column correlation matrix + bootstrap standard error
    (analysis.py:385-407 CorrelationMatrix). With fewer than min_rows
    samples the error estimate is meaningless and the correlation is
    returned for both (the reference convention).
    """
    data = np.asarray(data, np.float64)
    if data.ndim != 2:
        raise ValueError("correlation_matrix needs a 2D (samples, "
                         f"columns) array, got {data.ndim}D")
    corr = np.corrcoef(data, rowvar=False)
    if data.shape[0] < min_rows:
        return corr, corr
    rng = np.random.default_rng(seed)
    reps = np.stack([
        np.corrcoef(data[rng.integers(0, data.shape[0], data.shape[0])],
                    rowvar=False)
        for _ in range(n_boot)])
    return corr, reps.std(axis=0)


def pdf_1d(values, nbins: int, vrange=None, density: bool = True):
    """Histogram/PDF with bin centers (analysis.py histogram helpers)."""
    values = np.asarray(values)
    hist, edges = np.histogram(values, bins=nbins, range=vrange,
                               density=density)
    return 0.5 * (edges[1:] + edges[:-1]), hist


def cumulative(values, nbins: int, vrange=None, reverse: bool = True):
    """(Reverse-)cumulative counts (N(>x) if reverse)."""
    centers, hist = pdf_1d(values, nbins, vrange, density=False)
    cum = np.cumsum(hist[::-1])[::-1] if reverse else np.cumsum(hist)
    return centers, cum


def _percentile_dim(x, q, dim: int = 0, midpoint: bool = False):
    """jnp.percentile(x, q, axis=dim) with linear interpolation (or
    jnp.median's midpoint, q = 50): XLA's float32 position q * ((n - 1) *
    0.01f), the sorted values at its floor and ceiling; a slice holding a
    NaN gives NaN."""
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    dev = x.device
    pos = (torch.tensor(float(q), dtype=torch.float32, device=dev)
           * (torch.tensor(float(n - 1), device=dev)
              * torch.tensor(0.01, dtype=torch.float32, device=dev)))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    srt = torch.sort(x, dim=0).values
    lo_v = srt[low.clamp(0, n - 1).to(torch.int64)]
    hi_v = srt[high.clamp(0, n - 1).to(torch.int64)]
    out = ((lo_v + hi_v) * 0.5 if midpoint
           else lo_v * (1.0 - w_high) + hi_v * w_high)
    return torch.where(torch.isnan(x).any(0), torch.nan, out)


def _boot_stats(values, idx, statistic: str):
    """The statistic of each resample: rows of idx index values' axis 0."""
    sample = values[idx]                        # (rows, n, ...)
    if statistic == "median":
        return _percentile_dim(sample, 50.0, dim=1, midpoint=True)
    return torch.mean(sample, dim=1)


def _boot_rows(n: int, values) -> int:
    width = int(np.prod(values.shape[1:], dtype=np.int64))
    return max(1, _BOOT_CHUNK_ENTRIES // max(n * max(width, 1), 1))


def _boot_bands(stats, lo: float, hi: float):
    return (_percentile_dim(stats, lo), _percentile_dim(stats, 50.0),
            _percentile_dim(stats, hi))


def bootstrap_statistic_from_draws(values, idx, statistic: str = "mean",
                                   lo: float = 16.0, hi: float = 84.0,
                                   device=None):
    """Bootstrap confidence band (lo, 50, hi percentiles) of the mean or
    median over axis 0 from a given (n_boot, n) matrix of resampling
    indices (the JAX package's randint(k, (n,), 0, n) per k in
    split(key, n_boot)), taken in chunks of resamples: the numbers do not
    depend on the chunk size."""
    values = as_tensor(values, device)
    idx = torch.as_tensor(idx, device=values.device).to(torch.int64)
    n = values.shape[0]
    rows = _boot_rows(n, values)
    stats = torch.cat([_boot_stats(values, idx[s:s + rows], statistic)
                       for s in range(0, idx.shape[0], rows)])
    return _boot_bands(stats, lo, hi)


def bootstrap_statistic(values, generator: torch.Generator,
                        n_boot: int = 1000, statistic: str = "mean",
                        lo: float = 16.0, hi: float = 84.0, device=None):
    """Bootstrap confidence band of mean/median over axis 0: n_boot
    resamples of n indices drawn from `generator` on its device (numpy
    values go there too, unless `device` says otherwise), chunk by chunk
    (each chunk one randint call of (rows, n)), so the card never holds
    the (n_boot, n) matrix. Returns the (lo, 50, hi) percentiles."""
    dev = generator.device if device is None else torch.device(device)
    values = as_tensor(values, dev)
    n = values.shape[0]
    rows = _boot_rows(n, values)
    stats = []
    for s in range(0, n_boot, rows):
        idx = torch.randint(0, n, (min(rows, n_boot - s), n),
                            generator=generator, device=dev)
        stats.append(_boot_stats(values, idx, statistic))
    return _boot_bands(torch.cat(stats), lo, hi)


def percentiles(values, qs=(16, 50, 84), axis=0, device=None):
    """jnp.percentile(values, qs, axis=axis): one row per q."""
    values = as_tensor(values, device)
    return torch.stack([_percentile_dim(values, float(q), dim=axis)
                        for q in np.atleast_1d(qs)])


def least_squares_fit(x, y, degree: int = 1, weights=None, device=None):
    """Weighted polynomial least squares; returns coefficients (highest
    power first, np.polyfit convention), float32, solved in float64."""
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    w = torch.ones_like(x) if weights is None else as_tensor(weights,
                                                             x.device)
    x64, y64, w64 = x.double(), y.double(), w.double()
    A = torch.stack([x64 ** (degree - i) for i in range(degree + 1)],
                    dim=-1)
    coef = torch.linalg.lstsq(A * w64[:, None], (y64 * w64)[:, None],
                              driver="gels" if x.is_cuda else None)
    return coef.solution[:, 0].to(torch.float32)


def pca(data, n_components: int = None, device=None):
    """PCA of (nsamples, nfeatures): returns (components, explained_var,
    mean), float32, from a float64 SVD of the centred data (component
    signs are the SVD's)."""
    data = as_tensor(data, device)
    mean = torch.mean(data, dim=0)
    x = (data - mean).double()
    _, s, vt = torch.linalg.svd(x, full_matrices=False)
    var = s ** 2 / (data.shape[0] - 1)
    if n_components is not None:
        vt = vt[:n_components]
        var = var[:n_components]
    return vt.to(torch.float32), var.to(torch.float32), mean


def covariance_from_realizations(samples, correlation: bool = False,
                                 device=None):
    """Covariance (or correlation) matrix over realizations: samples
    (n_real, nbin), the unbiased 1/(n-1) estimator; the product in
    float64, the result float32."""
    x = as_tensor(samples, device)
    mean = torch.mean(x, dim=0)
    d = (x - mean).double()
    cov = d.T @ d / (x.shape[0] - 1)
    if correlation:
        s = torch.sqrt(torch.diagonal(cov))
        cov = cov / (s[:, None] * s[None, :])
    return cov.to(torch.float32)


def nonlinear_least_squares(fn, x, y, p0, n_steps: int = 100,
                            rel_tol: float = 1e-8, damping: float = 1e-3,
                            device=None):
    """Nonlinear least squares by Levenberg-Marquardt with AD Jacobians:
    fn(x, params) -> (n,) predictions (torch, float32 params); the
    Jacobian from torch.func.jacfwd, the damped normal equations and the
    steps on the host in float64. x is placed as a tensor (numpy:
    `device`, by default the CUDA card). Returns (params,
    sum_sq_residual, converged)."""
    x = as_tensor(x, device)
    dev = x.device
    y_np = np.asarray(y.detach().cpu().numpy() if isinstance(y, torch.Tensor)
                      else y, np.float64)
    params = np.asarray(p0, np.float64).copy()

    def model(p):
        return fn(x, p)

    jac = torch.func.jacfwd(model)

    def p32(p):
        return torch.as_tensor(np.asarray(p, np.float32), device=dev)

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def ssq(p):
        return float(np.sum((y_np - host(model(p32(p)))) ** 2))

    lam = float(damping)
    best = ssq(params)
    converged = False
    for _ in range(n_steps):
        r = y_np - host(model(p32(params)))
        J = host(jac(p32(params)))
        JtJ = J.T @ J
        g = J.T @ r
        step_ok = False
        for _try in range(8):
            A = JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-12))
            try:
                dp = np.linalg.solve(A, g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            new = ssq(params + dp)
            if new <= best:
                params = params + dp
                best = new
                lam = max(lam * 0.3, 1e-12)
                step_ok = True
                break
            lam *= 10.0
        if not step_ok:
            break
        denom = np.maximum(np.abs(params), 1e-30)
        if np.max(np.abs(dp) / denom) < rel_tol:
            converged = True
            break
    return params, best, converged


def contour_value(data, enclosed_fractions):
    """Iso-value thresholds enclosing a given fraction of the total mass.

    Counterpart of tunnels/analysis.py FindContourValue, computed
    EXACTLY (sort + cumulative sum) instead of through the reference's
    1000-bin histogram approximation: returns, for each fraction f, the
    largest value t such that sum(data[data >= t]) >= f * sum(data).
    Used to draw contours enclosing f of the probability mass of a 2D
    density map.
    """
    flat = np.asarray(data, np.float64).ravel()
    if (flat < 0).any():
        raise ValueError("contour_value needs a non-negative density map")
    order = np.argsort(flat)[::-1]
    sorted_vals = flat[order]
    cum = np.cumsum(sorted_vals)
    total = cum[-1]
    if total <= 0:
        raise ValueError("contour_value: map has zero total mass")
    fr = np.atleast_1d(np.asarray(enclosed_fractions, np.float64))
    idx = np.searchsorted(cum / total, fr, side="left")
    idx = np.minimum(idx, flat.size - 1)
    return sorted_vals[idx]


def direction_correlation(cos_theta, nbins: int = 10, n_random: int = 1000,
                          seed: int = 0):
    """Alignment statistic: |cos theta| histogram vs the isotropic MC.

    Counterpart of tunnels/analysis.py dataCorrelation_direction +
    randomCorrelation_direction: histogram the measured |cos| of the
    angle between object orientations (e.g. halo shape axis vs void
    direction) over [0, 1], and compare with the Monte-Carlo mean/std of
    the same-size isotropic sample (|cos| uniform on [0, 1] for random
    3D directions).

    Returns (hist, random_mean, random_std), each (nbins,).
    """
    c = np.abs(np.asarray(cos_theta, np.float64))
    hist, _ = np.histogram(c, bins=nbins, range=(0.0, 1.0))
    rng = np.random.default_rng(seed)
    edges = np.linspace(0.0, 1.0, nbins + 1)
    # accumulate moments per realization: O(n) peak memory instead of the
    # (n_random, n) matrix (8 GB at n=1e6, n_random=1000)
    s1 = np.zeros(nbins)
    s2 = np.zeros(nbins)
    for _ in range(n_random):
        rh = np.histogram(rng.uniform(0.0, 1.0, size=c.size),
                          bins=edges)[0].astype(np.float64)
        s1 += rh
        s2 += rh * rh
    mean = s1 / n_random
    var = np.maximum(s2 / n_random - mean * mean, 0.0)
    return hist, mean, np.sqrt(var)


def point_density_2d(x, y, nbins=(10, 10), x_range=None, y_range=None,
                     log_bins: bool = False):
    """2D point density with linear or logarithmic bins.

    Counterpart of tunnels/analysis.py PointDistribution (whose body was
    scipy.weave-dead C). Returns (x_centers, y_centers, density) with
    density = counts / (N * bin_area) so it integrates to 1.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x_range is None:
        x_range = (x.min(), x.max())
    if y_range is None:
        y_range = (y.min(), y.max())
    if log_bins:
        if min(x_range[0], y_range[0]) <= 0:
            raise ValueError("log bins need positive ranges")
        xe = np.logspace(np.log10(x_range[0]), np.log10(x_range[1]),
                         nbins[0] + 1)
        ye = np.logspace(np.log10(y_range[0]), np.log10(y_range[1]),
                         nbins[1] + 1)
    else:
        xe = np.linspace(*x_range, nbins[0] + 1)
        ye = np.linspace(*y_range, nbins[1] + 1)
    counts, _, _ = np.histogram2d(x, y, bins=(xe, ye))
    area = np.outer(np.diff(xe), np.diff(ye))
    dens = counts / max(x.size, 1) / area
    return 0.5 * (xe[1:] + xe[:-1]), 0.5 * (ye[1:] + ye[:-1]), dens
