"""Differentiable field-level inference through the PM forward model.

Port of astrild_tpu/ops/field_infer.py. Autograd flows end to end through
white noise -> linear modes (mocks.modes_from_white) -> 2LPT particle ICs
(nbody.lpt_catalog_from_modes) -> KDK PM evolution (the loop of
nbody.pm_evolve) -> CIC density field: the BORG-style initial-condition
reconstruction primitive.

Conventions:
  * the optimization variable is the WHITENED field w (the N(0,1)
    amplitudes of the linear modes): the Gaussian prior is then the
    isotropic 0.5*|w|^2, and `modes_from_white(w, ...)` makes inferred
    fields share realization conventions with every mock/IC in the
    package;
  * the posterior is the standard field-level Gaussian form
    0.5*|delta_sim(w) - data|^2/sigma^2 + 0.5*|w|^2.

Every paint in the chain (the force paints of the KDK loop and the final
density paint) takes `deposit`, by default None: on the card that is the
windowed painter K2, whose backward pass is its hand-written adjoint
(ops.paint_cuda.paint_windowed_adjoint); on the CPU the scatter painter,
which autograd differentiates. The JAX package forces deposit="scatter"
here only because its Pallas painter has no transpose rule; "scatter"
stays accepted. NGP is NOT differentiable in positions (zero gradient
a.e.) and is rejected.

`infer_initial_field` runs `torch.optim.Adam` with optax.adam's constants
(betas 0.9, 0.999, eps 1e-8); `sample_initial_field` runs the port's HMC
(ops.inference.hmc_sample) from a `torch.Generator` where the JAX package
takes a PRNG key, and `sample_initial_field_from_draws` takes the draws
themselves (hmc_sample_from_draws).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._device import as_tensor
from .inference import hmc_sample, hmc_sample_from_draws
from .mocks import modes_from_white
from .nbody import (_a_edges, _am2_edges, _factors_from_edges, _pm_loop,
                    lpt_catalog_from_modes, lpt_growth)
from .paint import paint

__all__ = ["simulate_density", "field_nll", "infer_initial_field",
           "sample_initial_field", "sample_initial_field_from_draws"]


def _host_consts(cosmo, z_init: float, a_final: float, nsteps: int,
                 order: int, spacing: str = "loga"):
    """Everything the forward model needs from the cosmology, evaluated
    on the host once: growth scalars, KDK factors and the scalaron mass
    table (both rounded to float32, as the JAX package holds them)."""
    d1, f1, d2, f2 = lpt_growth(cosmo, z_init, order)
    e_init = float(cosmo.efunc(z_init))
    edges = _a_edges(1.0 / (1.0 + z_init), a_final, nsteps, spacing)
    factors = np.asarray(_factors_from_edges(cosmo, edges, spacing=spacing),
                         np.float32)
    am2 = np.asarray(_am2_edges(cosmo, edges), np.float32)
    return ((d1, f1, d2, f2, e_init), factors, am2, float(cosmo.Om0))


def _simulate_core(white, consts, pk_fn: Callable, ngrid: int, boxsize,
                   z_init: float, window: str, order: int, deposit=None):
    """The differentiable forward chain: whitened field -> linear modes
    -> 2LPT ICs -> KDK PM -> overdensity, on white's device."""
    growth, factors, am2, om0 = consts
    dk = modes_from_white(white, ngrid, boxsize, pk_fn)
    comps, mom = lpt_catalog_from_modes(dk, ngrid, boxsize, None, z_init,
                                        order=order, growth=growth)
    comps, _ = _pm_loop(comps, mom, factors.tolist(), am2.tolist(), ngrid,
                        float(boxsize), om0, window, deposit=deposit)
    grid = paint(comps, ngrid, boxsize, window=window, deposit=deposit)
    return grid / torch.mean(grid) - 1.0


def _check_window(window: str) -> None:
    if window == "ngp":
        raise ValueError("NGP has zero gradient a.e.; use cic or tsc")


def simulate_density(white, pk_fn: Callable, cosmo, *, ngrid: int,
                     boxsize, z_init: float = 9.0, nsteps: int = 3,
                     a_final: float = 1.0, window: str = "cic",
                     order: int = 2, deposit: str | None = None,
                     device=None):
    """delta(x) today from a whitened initial field (differentiable).

    white: (ngrid, ngrid, ngrid) N(0,1) parameters, a tensor (it keeps
    its device) or numpy (it goes to `device`, by default the CUDA card).
    Returns the overdensity on the same ngrid^3 mesh (1:1 mesh:particle
    ratio). deposit: the paints' route (see the module docstring). The
    cosmology is evaluated on the host per call.
    """
    _check_window(window)
    white = as_tensor(white, device)
    consts = _host_consts(cosmo, z_init, a_final, nsteps, order)
    return _simulate_core(white, consts, pk_fn, ngrid, boxsize, z_init,
                          window, order, deposit)


def _gauss_posterior(delta, data_delta, noise_var, white):
    """0.5|delta - d|^2/sigma^2 + 0.5|w|^2: the ONE home of the Gaussian
    field posterior (field_nll, the MAP loop and HMC share it)."""
    resid = delta - data_delta
    return (0.5 * torch.sum(resid * resid) / noise_var
            + 0.5 * torch.sum(white * white))


def field_nll(white, data_delta, noise_var, pk_fn: Callable, cosmo,
              *, boxsize, **sim_kwargs):
    """Negative log-posterior: 0.5|delta(w)-d|^2/sigma^2 + 0.5|w|^2.

    white as in `simulate_density`; data_delta goes to white's device.
    Re-evaluates the cosmology on the host per call; gradient loops use
    infer_initial_field (host constants computed once)."""
    white = as_tensor(white, sim_kwargs.pop("device", None))
    data_delta = as_tensor(data_delta, white.device)
    delta = simulate_density(white, pk_fn, cosmo, ngrid=data_delta.shape[-1],
                             boxsize=boxsize, **sim_kwargs)
    return _gauss_posterior(delta, data_delta, noise_var, white)


def infer_initial_field(data_delta, noise_var, pk_fn: Callable, cosmo,
                        *, boxsize, n_iter: int = 200, lr: float = 0.1,
                        white0=None, generator: torch.Generator | None = None,
                        z_init: float = 9.0, nsteps: int = 3,
                        a_final: float = 1.0, window: str = "cic",
                        order: int = 2, deposit: str | None = None,
                        device=None):
    """Adam MAP reconstruction of the whitened initial field.

    Returns {"white": the iterate with the LOWEST measured loss (not
    necessarily the final one: high-lr runs oscillate), "loss": (n_iter,)
    history}. Pass white0 to warm-start (e.g. from a coarser
    reconstruction); otherwise starts from zeros (the prior mean) or,
    given `generator` (the JAX package's `key`), from a prior draw on the
    generator's device. data_delta: a tensor (it keeps its device) or
    numpy (it goes to `device`, by default the CUDA card). The cosmology
    is evaluated on the host once; the loop reads nothing back to the host.
    """
    _check_window(window)
    data_delta = as_tensor(data_delta, device)
    dev = data_delta.device
    ngrid = data_delta.shape[-1]
    if white0 is None:
        white0 = (torch.zeros((ngrid,) * 3, dtype=torch.float32, device=dev)
                  if generator is None
                  else torch.randn((ngrid,) * 3, generator=generator,
                                   device=generator.device,
                                   dtype=torch.float32).to(dev))
    w = as_tensor(white0, dev).detach().clone().requires_grad_(True)
    consts = _host_consts(cosmo, z_init, a_final, nsteps, order)
    opt = torch.optim.Adam([w], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    best_w = w.detach().clone()
    best_loss = torch.tensor(float("inf"), device=dev)
    losses = []
    for _ in range(n_iter):
        opt.zero_grad(set_to_none=True)
        delta = _simulate_core(w, consts, pk_fn, ngrid, boxsize, z_init,
                               window, order, deposit)
        loss = _gauss_posterior(delta, data_delta, noise_var, w)
        loss.backward()
        loss = loss.detach()
        better = loss < best_loss
        best_w = torch.where(better, w.detach(), best_w)
        best_loss = torch.where(better, loss, best_loss)
        losses.append(loss)
        opt.step()
    return {"white": best_w,
            "loss": torch.stack(losses) if losses
            else torch.zeros(0, device=dev)}


def _logp(data_delta, noise_var, pk_fn, cosmo, boxsize, z_init, nsteps,
          a_final, window, order, deposit):
    """The field posterior's log-density of a flat whitened field."""
    _check_window(window)
    ngrid = data_delta.shape[-1]
    consts = _host_consts(cosmo, z_init, a_final, nsteps, order)

    def logp(wflat):
        w = wflat.reshape((ngrid,) * 3)
        delta = _simulate_core(w, consts, pk_fn, ngrid, boxsize, z_init,
                               window, order, deposit)
        return -_gauss_posterior(delta, data_delta, noise_var, w)
    return logp


def _white_start(white0, ngrid: int, dev):
    if white0 is None:
        return torch.zeros(ngrid ** 3, dtype=torch.float32, device=dev)
    return as_tensor(white0, dev).reshape(-1)


def sample_initial_field(generator: torch.Generator, data_delta, noise_var,
                         pk_fn: Callable, cosmo, *, boxsize,
                         n_samples: int = 200, n_warmup: int = 100,
                         n_leapfrog: int = 8, step_size: float = 0.02,
                         white0=None, z_init: float = 9.0, nsteps: int = 3,
                         a_final: float = 1.0, window: str = "cic",
                         order: int = 2, deposit: str | None = None):
    """Field-level posterior SAMPLING: HMC over the whitened initial
    field, gradients through the PM simulator (ops.inference.hmc_sample,
    its momenta and uniforms drawn from `generator`).

    Returns (samples, accept_rate): samples (n_samples, ngrid, ngrid,
    ngrid) whitened fields on the generator's device (numpy data_delta
    goes there too). Warm-start at the MAP (pass infer_initial_field's
    "white"): from the prior mean the chain pays a long burn-in. The
    whitened parameterization doubles as the identity-mass
    preconditioning (prior = unit Gaussian).
    """
    data_delta = as_tensor(data_delta, generator.device)
    ngrid = data_delta.shape[-1]
    logp = _logp(data_delta, noise_var, pk_fn, cosmo, boxsize, z_init,
                 nsteps, a_final, window, order, deposit)
    res = hmc_sample(generator, logp,
                     _white_start(white0, ngrid, data_delta.device),
                     n_samples=n_samples, n_warmup=n_warmup,
                     n_leapfrog=n_leapfrog, step_size=step_size)
    return (res.samples.reshape((n_samples, ngrid, ngrid, ngrid)),
            float(res.accept_rate))


def sample_initial_field_from_draws(normals, uniforms, data_delta,
                                    noise_var, pk_fn: Callable, cosmo, *,
                                    boxsize, n_samples: int = 200,
                                    n_warmup: int = 100, n_leapfrog: int = 8,
                                    step_size: float = 0.02, white0=None,
                                    z_init: float = 9.0, nsteps: int = 3,
                                    a_final: float = 1.0,
                                    window: str = "cic", order: int = 2,
                                    deposit: str | None = None,
                                    device=None):
    """`sample_initial_field` from given draws (hmc_sample_from_draws):
    normals (n_warmup + n_samples, ngrid^3) and uniforms (n_warmup +
    n_samples,), the JAX package's normal(kp, (ndim,)) and uniform(ku)
    with keys = split(key, total) and kp, ku = split(keys[i]). data_delta:
    a tensor (it keeps its device) or numpy (it goes to `device`, by
    default the CUDA card)."""
    data_delta = as_tensor(data_delta, device)
    ngrid = data_delta.shape[-1]
    logp = _logp(data_delta, noise_var, pk_fn, cosmo, boxsize, z_init,
                 nsteps, a_final, window, order, deposit)
    res = hmc_sample_from_draws(
        normals, uniforms, logp,
        _white_start(white0, ngrid, data_delta.device),
        n_samples=n_samples, n_warmup=n_warmup, n_leapfrog=n_leapfrog,
        step_size=step_size)
    return (res.samples.reshape((n_samples, ngrid, ngrid, ngrid)),
            float(res.accept_rate))
