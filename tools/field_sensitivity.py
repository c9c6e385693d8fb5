#!/usr/bin/env python3
"""How far the field-inference chain's own float32 rounding moves its
results, on the CPU: the yardsticks that chip_smoke.py's phase 20 and
tests/test_torch_field_infer.py set their bars against.

    JAX_PLATFORMS=cpu python3 tools/field_sensitivity.py [--part NAME ...]

Parts (all by default; each prints one JSON line):

  kink        the JAX package at the prior mean w = 0 (8^3, 2 steps): its
              jitted and eager gradients of the field posterior, whose
              particles sit on the CIC kinks there (needs JAX);
  hmc         a field HMC chain of the JAX package and the port's from
              the same draws (8^3, 4 leapfrog steps): the gap of each
              sample, fixed step and with a warm-up (needs JAX);
  adam        the port's Adam at the example's size (32^3 in 400 Mpc/h, 4
              steps) from a prior draw and from it moved by 1e-7 of
              itself, at lr 0.1 and 0.02: the loss histories' gap;
  gradient    the port's gradient at the full-width cell (64^3 in 125
              Mpc/h, 4 steps) from a start and from it moved by 1e-7 and
              1e-6: its gap relative to the max and to the mean;
  lr          the port's Adam at the full-width cell and steps (64^3 in
              125 Mpc/h, 10 steps), 30 iterations at lr 0.05, 0.01 and
              0.003: the loss at iterations 0, 10, 20 and 29.

About 10 minutes in all (`lr` most of it).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from astrild_tpu_torch.ops import field_infer as TF  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

KW = dict(z_init=9.0, nsteps=2, window="cic")


def _pk_red(k):
    # tests/test_field_infer.py's spectrum
    return 2.0e3 * (k / 0.1) ** -1.5


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs()).max())


def part_kink() -> dict:
    import jax
    import jax.numpy as jnp

    from astrild_tpu.ops import field_infer as JF
    from astrild_tpu.utils.cosmology import Cosmology as JC

    n = 8
    rng = np.random.default_rng(0)
    truth = rng.standard_normal((n,) * 3).astype(np.float32)
    jc = JC(Om0=0.3, h=0.7)
    data = JF.simulate_density(jnp.asarray(truth), _pk_red, jc, ngrid=n,
                               boxsize=100.0, **KW)
    consts = JF._host_consts(jc, 9.0, 1.0, 2, 2)

    def loss(w):
        delta = JF._simulate_core(w, consts, _pk_red, n, 100.0, 9.0, "cic", 2)
        return JF._gauss_posterior(delta, data, 1e-2, w)

    w0 = jnp.zeros((n,) * 3)
    eager = np.asarray(jax.grad(loss)(w0))
    jitted = np.asarray(jax.jit(jax.grad(loss))(w0))
    return {"part": "kink", "max_abs_grad": float(np.abs(eager).max()),
            "jit_vs_eager_max_diff": float(np.abs(jitted - eager).max()),
            "sign_flips": int(np.sum(np.sign(jitted) != np.sign(eager))),
            "coordinates": n ** 3}


def part_hmc() -> dict:
    import jax
    import jax.numpy as jnp

    from astrild_tpu.ops import field_infer as JF
    from astrild_tpu.utils.cosmology import Cosmology as JC

    n = 8
    rng = np.random.default_rng(42)
    truth = rng.standard_normal((n,) * 3).astype(np.float32)
    w0 = (0.8 * truth + 0.2 * rng.standard_normal((n,) * 3)).astype(
        np.float32)
    jc, tc = JC(Om0=0.3, h=0.7), Cosmology(Om0=0.3, h=0.7)
    data = np.array(JF.simulate_density(jnp.asarray(truth), _pk_red, jc,
                                        ngrid=n, boxsize=100.0, **KW))
    key = jax.random.PRNGKey(6)
    out = {"part": "hmc"}
    for n_warmup, n_samples in ((0, 5), (1, 2), (2, 1)):
        total = n_warmup + n_samples

        def one(k):
            kp, ku = jax.random.split(k)
            return (jax.random.normal(kp, (n ** 3,)),
                    jax.random.uniform(ku))

        nrm, uni = jax.jit(jax.vmap(one))(jax.random.split(key, total))
        want, want_acc = JF.sample_initial_field(
            key, jnp.asarray(data), 1e-2, _pk_red, jc, boxsize=100.0,
            n_samples=n_samples, n_warmup=n_warmup, n_leapfrog=4,
            white0=jnp.asarray(w0), **KW)
        got, acc = TF.sample_initial_field_from_draws(
            np.asarray(nrm), np.asarray(uni), torch.from_numpy(data), 1e-2,
            _pk_red, tc, boxsize=100.0, n_samples=n_samples,
            n_warmup=n_warmup, n_leapfrog=4, white0=torch.from_numpy(w0),
            **KW)
        want = np.asarray(want)
        out[f"warmup{n_warmup}_samples{n_samples}"] = {
            "accept": [float(want_acc), acc],
            "sample_max_diff": [float(np.abs(got[i].numpy() - want[i]).max())
                                for i in range(n_samples)]}
    return out


def _example():
    n, box = 32, 400.0
    kw = dict(z_init=9.0, nsteps=4, window="cic")
    cosmo = Cosmology(Om0=0.3089, h=0.6774, sigma8=0.8159)
    amp = TL.normalization(cosmo)

    def pk(k):
        return TL.linear_power(torch.clamp_min(k, 1e-4), cosmo, 0.0,
                               amplitude=amp)

    gen = torch.Generator().manual_seed(20)
    truth = torch.randn((n,) * 3, generator=gen)
    with torch.no_grad():
        delta = TF.simulate_density(truth, pk, cosmo, ngrid=n, boxsize=box,
                                    **kw)
    data = delta + 0.1 * torch.randn(delta.shape, generator=gen)
    return n, box, kw, cosmo, pk, data


def part_adam() -> dict:
    n, box, kw, cosmo, pk, data = _example()
    w0 = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(22))
    w1 = w0 * (1.0 + 1e-7 * torch.randn(
        (n,) * 3, generator=torch.Generator().manual_seed(5)))
    out = {"part": "adam", "iterations": 20}
    for lr in (0.1, 0.02):
        a, b = (TF.infer_initial_field(data, 1e-2, pk, cosmo, boxsize=box,
                                       n_iter=20, lr=lr, white0=w, **kw)
                ["loss"] for w in (w0, w1))
        out[f"lr_{lr}_loss_rel_gap"] = _rel(b, a)
    return out


def _full_cell(nsteps: int):
    n, box = 64, 125.0
    kw = dict(z_init=9.0, nsteps=nsteps, window="cic")
    gr = Cosmology(Om0=0.3, h=0.7)
    amp = TL.normalization(gr)

    def pk(k):
        return TL.linear_power(k, gr, 0.0, amplitude=amp)

    gen = torch.Generator().manual_seed(23)
    truth = torch.randn((n,) * 3, generator=gen)
    with torch.no_grad():
        delta = TF.simulate_density(truth, pk, gr, ngrid=n, boxsize=box,
                                    **kw)
    data = delta + 0.1 * torch.randn(delta.shape, generator=gen)
    w0 = 0.7 * truth + 0.3 * torch.randn((n,) * 3, generator=gen)
    return n, box, kw, gr, pk, data, w0


def part_gradient() -> dict:
    n, box, kw, gr, pk, data, w0 = _full_cell(4)

    def grad(w):
        w = w.clone().requires_grad_(True)
        loss = TF.field_nll(w, data, 1e-2, pk, gr, boxsize=box, **kw)
        return torch.autograd.grad(loss, w)[0]

    ref = grad(w0)
    out = {"part": "gradient"}
    for eps in (1e-7, 1e-6):
        g = grad(w0 * (1.0 + eps * torch.randn(
            (n,) * 3, generator=torch.Generator().manual_seed(1))))
        d = (g - ref).abs()
        out[f"nudge_{eps}"] = {
            "max": float(d.max() / ref.abs().max()),
            "mean": float(d.double().mean() / ref.abs().double().mean())}
    return out


def part_lr() -> dict:
    _, box, kw, gr, pk, data, w0 = _full_cell(10)
    out = {"part": "lr", "iterations": 30}
    for lr in (0.05, 0.01, 0.003):
        loss = TF.infer_initial_field(data, 1e-2, pk, gr, boxsize=box,
                                      n_iter=30, lr=lr, white0=w0, **kw)
        out[f"lr_{lr}"] = [float(loss["loss"][i]) for i in (0, 10, 20, 29)]
    return out


PARTS = {"kink": part_kink, "hmc": part_hmc, "adam": part_adam,
         "gradient": part_gradient, "lr": part_lr}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", action="append", choices=sorted(PARTS),
                    help="run only these parts (repeatable)")
    args = ap.parse_args()
    for name in args.part or list(PARTS):
        print(json.dumps(PARTS[name]()), flush=True)


if __name__ == "__main__":
    main()
