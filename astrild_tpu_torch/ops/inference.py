"""Gradient-based posterior sampling over the differentiable theory stack.

Port of astrild_tpu/ops/inference.py. The likelihood chain (Cosmology ->
P(k) -> Limber C_ell -> Gaussian bandpower likelihood, ops/forecast.py)
is torch end to end, so Hamiltonian Monte Carlo takes its gradients by
autograd. The sampler's loop stays on the device: the acceptance test,
the state updates and the dual-averaging state are tensors, and no step
reads a value back to the host.

`hmc_sample` draws its momenta and acceptance uniforms from a
`torch.Generator` where the JAX package takes a PRNG key;
`hmc_sample_from_draws` takes them: the momenta (total, ndim) and the
uniforms (total,), one row a step, which are the JAX package's
normal(kp, (ndim,)) and uniform(ku) with keys = split(key, total) and
kp, ku = split(keys[i]), so both packages take the same steps.

Surfaces:
  hmc_sample / hmc_sample_from_draws - HMC with a diagonal mass and
                        dual-averaging step-size warm-up
  shear_log_posterior - Gaussian bandpower log-posterior over the
                        tomographic shear stack
  threex2pt_log_posterior - the joint wp + Delta Sigma + xi_pm one
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from .._device import as_tensor, as_theory_tensor, default_device

__all__ = ["hmc_sample", "hmc_sample_from_draws", "HMCResult",
           "shear_log_posterior", "threex2pt_log_posterior"]

# dual averaging (Hoffman & Gelman 2014, Alg. 5 constants)
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75


class HMCResult(NamedTuple):
    samples: torch.Tensor       # (n_samples, ndim)
    log_prob: torch.Tensor      # (n_samples,)
    accept_rate: torch.Tensor   # scalar
    step_size: torch.Tensor     # adapted scalar


def _value_and_grad(logp_fn: Callable, x):
    """(logp(x), d logp / dx) as float32, by autograd."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        lp = logp_fn(xg)
        (g,) = torch.autograd.grad(lp, xg)
    return lp.detach().to(torch.float32), g.to(torch.float32)


def _leapfrog(value_and_grad, x, p, eps, n_steps: int, inv_mass, g):
    """n_steps leapfrog steps from (x, p), g the gradient at x. Returns
    (x, p, logp, gradient) at the end: each gradient serves the second
    half-kick of one step and the first of the next."""
    lp = None
    for _ in range(n_steps):
        p = p + 0.5 * eps * g
        x = x + eps * inv_mass * p
        lp, g = value_and_grad(x)
        p = p + 0.5 * eps * g
    return x, p, lp, g


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def hmc_sample_from_draws(normals, uniforms, logp_fn: Callable, x0,
                          n_samples: int = 500, n_warmup: int = 200,
                          n_leapfrog: int = 16, step_size: float = 0.1,
                          inv_mass=None,
                          target_accept: float = 0.8) -> HMCResult:
    """Hamiltonian Monte Carlo with dual-averaging step-size warm-up, from
    given draws: `normals` (n_warmup + n_samples, ndim) N(0, 1) momenta
    before the mass scaling and `uniforms` (n_warmup + n_samples,) in
    [0, 1) for the acceptance tests.

    logp_fn: differentiable log-density R^ndim -> scalar (torch); x0:
    (ndim,) start point, on the device the chain runs on (numpy: the CUDA
    card by default); inv_mass: (ndim,) diagonal inverse mass (e.g. Fisher
    variances), identity if None. The state is float32, as in the JAX
    package. Returns HMCResult; `accept_rate` is the post-warm-up mean.
    """
    x = as_tensor(x0)
    dev = x.device
    ndim = x.shape[0]
    inv_mass = (torch.ones(ndim, dtype=torch.float32, device=dev)
                if inv_mass is None else as_tensor(inv_mass, dev))
    normals = as_tensor(normals, dev)
    uniforms = as_tensor(uniforms, dev)
    total = n_warmup + n_samples
    if normals.shape != (total, ndim) or uniforms.shape != (total,):
        raise ValueError(
            f"hmc_sample_from_draws: draws of shapes {tuple(normals.shape)} "
            f"and {tuple(uniforms.shape)}, need ({total}, {ndim}) and "
            f"({total},)")

    def value_and_grad(y):
        return _value_and_grad(logp_fn, y)

    step_size = _f32(step_size, dev)
    target_accept = _f32(target_accept, dev)
    mu = torch.log(10.0 * step_size)
    lp, g = value_and_grad(x)
    eps = step_size
    hbar = _f32(0.0, dev)
    log_eps_bar = torch.log(step_size)
    it = _f32(0.0, dev)
    neg_inf = _f32(-np.inf, dev)
    momenta = normals / torch.sqrt(inv_mass)
    xs, lps, acc = [], [], []
    for i in range(total):
        in_warmup = i < n_warmup
        p = momenta[i]
        x_new, p_new, lp_new, g_new = _leapfrog(value_and_grad, x, p, eps,
                                                n_leapfrog, inv_mass, g)
        h0 = lp - 0.5 * torch.sum(inv_mass * p * p)
        h1 = lp_new - 0.5 * torch.sum(inv_mass * p_new * p_new)
        log_alpha = torch.clamp_max(h1 - h0, 0.0)
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha,
                                neg_inf)
        accept = torch.log(uniforms[i]) < log_alpha
        x = torch.where(accept, x_new, x)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(accept, g_new, g)
        xs.append(x)
        lps.append(lp)
        acc.append(accept)
        if in_warmup:
            # dual averaging on the acceptance statistic
            it = it + 1.0
            hbar = ((1.0 - 1.0 / (it + _T0)) * hbar
                    + (target_accept - torch.exp(log_alpha)) / (it + _T0))
            log_eps = mu - torch.sqrt(it) / _GAMMA * hbar
            w = it ** (-_KAPPA)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            eps = torch.exp(log_eps)
        else:
            eps = torch.exp(log_eps_bar)
    xs, lps = torch.stack(xs), torch.stack(lps)
    acc = torch.stack(acc).to(torch.float32)
    return HMCResult(samples=xs[n_warmup:], log_prob=lps[n_warmup:],
                     accept_rate=torch.mean(acc[n_warmup:]), step_size=eps)


def hmc_sample(generator: torch.Generator, logp_fn: Callable, x0,
               n_samples: int = 500, n_warmup: int = 200,
               n_leapfrog: int = 16, step_size: float = 0.1,
               inv_mass=None, target_accept: float = 0.8) -> HMCResult:
    """`hmc_sample_from_draws` with the momenta (total, ndim) and then the
    uniforms (total,) drawn from `generator` on its device (x0 numpy goes
    there too)."""
    dev = generator.device
    x0 = as_tensor(x0, dev)
    total = n_warmup + n_samples
    normals = torch.randn((total, x0.shape[0]), generator=generator,
                          device=dev, dtype=torch.float32)
    uniforms = torch.rand((total,), generator=generator, device=dev,
                          dtype=torch.float32)
    return hmc_sample_from_draws(normals, uniforms, logp_fn, x0,
                                 n_samples=n_samples, n_warmup=n_warmup,
                                 n_leapfrog=n_leapfrog, step_size=step_size,
                                 inv_mass=inv_mass,
                                 target_accept=target_accept)


def _barriers(ll, x, names, bounds):
    """The smooth exp log-barrier box priors {name: (lo, hi)}."""
    for i, k in enumerate(names):
        if k in bounds:
            lo, hi = bounds[k]
            w = 0.005 * (hi - lo)
            ll = ll - torch.exp((lo - x[i]) / w) - torch.exp((x[i] - hi) / w)
    return ll


def _gaussian_ll(mu, data_vec, cov_chol):
    """-0.5 (mu - d)^T C^-1 (mu - d) with C = L L^T: a Cholesky solve in
    the covariance's float64 (no float32 product a caller's TF32 could
    reach), batched over the leading axes."""
    d = (mu - data_vec).to(cov_chol.dtype)
    r = torch.cholesky_solve(d[..., None], cov_chol)[..., 0]
    return -0.5 * torch.sum(d * r)


def shear_log_posterior(ells, data_stack, z_sources: Sequence[float],
                        param_names: Sequence[str], fsky: float = 0.5,
                        delta_ell=None, ngal_per_arcmin2: float = 30.0,
                        sigma_eps: float = 0.26, nchi: int = 64,
                        nonlinear: bool = False,
                        fixed: Dict[str, float] = None,
                        prior_bounds: Dict[str, tuple] = None,
                        device=None):
    """Gaussian bandpower log-posterior over tomographic shear spectra.

    The covariance is fixed at the data spectra (the Gaussian bandpower
    approximation); flat priors via `prior_bounds` {name: (lo, hi)} as
    smooth log-barriers outside the box. The model runs on the data's
    device (a tensor's own; numpy data: `device`, by default the CUDA
    card), in float64, and rebuilds `Cosmology(**{**fixed, **p})` from
    the sampled tensors at every call.

    Returns (logp, names): logp(x) with x ordered as param_names, for
    hmc_sample.
    """
    from .forecast import (_cosmology, _host, _pair_index,
                           shear_cl_data_covariance, tomographic_shear_cls)

    data_stack = as_theory_tensor(data_stack, device)
    dev = data_stack.device
    ells = as_tensor(np.asarray(_host(ells), np.float32), dev)
    if delta_ell is None:
        gaps = np.diff(_host(ells).astype(np.float64))
        delta_ell = np.concatenate([gaps[:1], 0.5 * (gaps[1:] + gaps[:-1]),
                                    gaps[-1:]]).astype(np.float32)
    nb = len(z_sources)
    nbar_sr = (ngal_per_arcmin2 / nb) / (np.deg2rad(1.0 / 60.0) ** 2)
    noise = np.full((nb,), sigma_eps ** 2 / nbar_sr, np.float32)
    fixed = dict(fixed or {})
    names = list(param_names)
    bounds = dict(prior_bounds or {})
    pairs = _pair_index(nb)

    cov = shear_cl_data_covariance(data_stack, ells, fsky=fsky,
                                   delta_ell=delta_ell, noise_cl=noise)
    cov_chol = torch.linalg.cholesky(cov.to(torch.float64))
    data_vec = torch.stack([data_stack[i, j] for (i, j) in pairs], dim=-1)

    def logp(x):
        p = {k: x[i] for i, k in enumerate(names)}
        stack = tomographic_shear_cls(ells, _cosmology(fixed, p, dev),
                                      z_sources, nchi=nchi,
                                      nonlinear=nonlinear)
        mu = torch.stack([stack[i, j] for (i, j) in pairs], dim=-1)
        return _barriers(_gaussian_ll(mu, data_vec, cov_chol), x, names,
                         bounds)

    return logp, names


def threex2pt_log_posterior(data_vec, cov, param_names: Sequence[str],
                            rp_wp, rp_ds, npix: int,
                            opening_angle_deg: float, nz,
                            pi_max: float = 60.0, nbins_xi: int = 12,
                            theta_min_arcmin: float = 2.0,
                            theta_max_arcmin=None, z_lens: float = 0.0,
                            nell: int = 256, nchi: int = 48,
                            nonlinear: bool = True,
                            fixed: Dict[str, float] = None,
                            hod_fixed: Dict[str, float] = None,
                            prior_bounds: Dict[str, tuple] = None,
                            device=None):
    """Gaussian log-posterior over the joint 3x2pt data vector
    [wp(rp); Delta Sigma(rp); xi_+(theta); xi_-(theta)], on
    forecast.threex2pt_mean_builder's mean model (Cosmology + Zheng+07
    occupation + NLA nuisance keys) on `device` (by default the CUDA
    card; a tensor data vector's device if it is one).

    data_vec: the measured joint vector at the estimator's bin centres;
    cov: its full (ndata, ndata) covariance, factorized once on the host
    in float64 (ValueError when it is not positive definite, or when the
    data, the covariance and the model's binning differ in size);
    prior_bounds: {name: (lo, hi)} smooth log-barrier box priors.
    Returns (logp, names), as shear_log_posterior.
    """
    from .forecast import _host, threex2pt_mean_builder

    dev = (data_vec.device if isinstance(data_vec, torch.Tensor)
           else default_device(device))
    fixed = dict(fixed or {})
    hod_fixed = dict(hod_fixed or {})
    if theta_max_arcmin is None:
        theta_max_arcmin = opening_angle_deg * 30.0
    mean_fn, theta_arcmin, _ = threex2pt_mean_builder(
        rp_wp, rp_ds, npix, opening_angle_deg, nz, pi_max, nbins_xi,
        theta_min_arcmin, theta_max_arcmin, z_lens, nell, nchi,
        nonlinear, fixed, hod_fixed, device=dev)
    names = list(param_names)
    bounds = dict(prior_bounds or {})
    data_vec = as_theory_tensor(data_vec, dev)
    # validate before the O(n^3) factorization, and against the model
    # length the builder determined
    n_wp = np.atleast_1d(_host(rp_wp)).shape[0]
    n_ds = np.atleast_1d(_host(rp_ds)).shape[0]
    n_model = n_wp + n_ds + 2 * np.asarray(theta_arcmin).shape[0]
    cov = np.asarray(_host(cov), np.float64)
    if not (data_vec.shape[0] == cov.shape[0] == n_model):
        raise ValueError(
            f"3x2pt sizes differ: data {data_vec.shape[0]}, covariance "
            f"{cov.shape[0]}, model {n_model} (wp {n_wp} + DS {n_ds} + xi "
            f"{2 * np.asarray(theta_arcmin).shape[0]})")
    # host Cholesky: a rank-deficient covariance raises here instead of
    # surfacing as NaNs (accept_rate == 0) in the sampler
    try:
        cov_chol = torch.from_numpy(np.linalg.cholesky(cov)).to(dev)
    except np.linalg.LinAlgError as e:
        raise ValueError(
            "3x2pt covariance is not positive definite (rank-deficient "
            "jackknife? fewer resamples than data entries?)") from e

    def logp(x):
        p = {k: x[i] for i, k in enumerate(names)}
        return _barriers(_gaussian_ll(mean_fn(p), data_vec, cov_chol), x,
                         names, bounds)

    return logp, names
