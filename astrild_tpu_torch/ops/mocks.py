"""Gaussian random linear modes (the initial conditions' white-noise step).

Port of `linear_modes` and `modes_from_white` of astrild_tpu/ops/mocks.py.
Randomness comes from an explicit `torch.Generator` where the JAX package
takes a PRNG key: the same seed gives a different realization than JAX's.
Handing both packages the same white-noise field (`modes_from_white`)
gives the same modes.
"""
from __future__ import annotations

from typing import Callable

import torch

from .power import _mode_numbers

__all__ = ["linear_modes", "modes_from_white"]


def modes_from_white(white, ngrid: int, boxsize, pk_fn: Callable):
    """Complex linear modes FFT(delta) (unnormalized fftn convention) from
    an N(0, 1) white-noise field `white` (n, n, n): the JAX package's
    convention, <|FFT(delta)/N^3|^2> V = P(k). `pk_fn` maps a tensor of
    |k| [h/Mpc] to P(k)."""
    white = torch.as_tensor(white)
    kf = 2.0 * torch.pi / boxsize
    f = _mode_numbers(ngrid, white.device)
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[None, None, :] ** 2)
    p = pk_fn(torch.clamp_min(torch.sqrt(m2), 1e-6) * kf)
    p = torch.where(m2 == 0.0, torch.zeros_like(p), p)
    amp = torch.sqrt(p / boxsize ** 3) * float(ngrid) ** 3
    return torch.fft.fftn(white) / float(ngrid) ** 1.5 * amp


def linear_modes(generator: torch.Generator, ngrid: int, boxsize,
                 pk_fn: Callable, device=None):
    """`modes_from_white` of a white-noise field drawn from `generator`, on
    `device` (default: the generator's device)."""
    device = generator.device if device is None else torch.device(device)
    white = torch.randn((ngrid, ngrid, ngrid), generator=generator,
                        device=device, dtype=torch.float32)
    return modes_from_white(white, ngrid, boxsize, pk_fn)
