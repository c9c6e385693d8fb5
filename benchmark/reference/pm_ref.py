"""Plain reference of the kick-drift-kick particle-mesh forward model, in
torch on any device. Imports nothing of the program and takes nothing it
made: it works out its own step factors (`cosmo.kdk_factors`), mode
tables and windows.

One force evaluation: cloud-in-cell counts (index_add_ of the eight
corner weights, cells centred at (i + 1/2) h), the contrast's FFT divided
by the CIC window sinc^2 per axis, the potential of lap phi = (3/2) Om0
delta, F = -grad phi spectrally (the gradient's transfer zero on its
axis' Nyquist plane), and a trilinear read of F at the particles with
the same cell convention. A step: kick by the first factor, drift by the
second (positions wrapped into the box), a new force, kick by the third;
one force evaluation comes before the first step.
"""
from __future__ import annotations

import math

import torch

from . import cosmo as cosmo_ref
from .precision import Precision

__all__ = ["evolve"]

_CHUNK = 1 << 24


def _modes(n: int, device, dtype, real: bool = False):
    k = torch.arange(n // 2 + 1 if real else n, device=device)
    if not real:
        k = (k + n // 2) % n - n // 2
    return k.to(dtype)


def _corners(x, ngrid: int, cell: float):
    """Per axis: lower cell, upper cell (periodic) and the upper weight."""
    out = []
    for a in range(3):
        u = x[a] / cell - 0.5
        i0 = torch.floor(u)
        f = u - i0
        i0 = i0.to(torch.int64) % ngrid
        out.append((i0, (i0 + 1) % ngrid, f))
    return out


def _cic(x, ngrid: int, cell: float, prec: Precision):
    grid = torch.zeros(ngrid ** 3, dtype=prec.dtype, device=x.device)
    for s in range(0, x.shape[1], _CHUNK):
        c = _corners(x[:, s:s + _CHUNK], ngrid, cell)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((c[0][2] if dx else 1.0 - c[0][2])
                         * (c[1][2] if dy else 1.0 - c[1][2])
                         * (c[2][2] if dz else 1.0 - c[2][2]))
                    key = ((c[0][dx] * ngrid + c[1][dy]) * ngrid + c[2][dz])
                    grid.index_add_(0, key, w)
    return prec.q(grid).view(ngrid, ngrid, ngrid)


def _gather(fields, x, ngrid: int, cell: float, prec: Precision):
    flat = fields.reshape(3, -1)
    out = torch.empty_like(x)
    for s in range(0, x.shape[1], _CHUNK):
        c = _corners(x[:, s:s + _CHUNK], ngrid, cell)
        acc = torch.zeros((3, c[0][0].shape[0]), dtype=x.dtype,
                          device=x.device)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((c[0][2] if dx else 1.0 - c[0][2])
                         * (c[1][2] if dy else 1.0 - c[1][2])
                         * (c[2][2] if dz else 1.0 - c[2][2]))
                    key = ((c[0][dx] * ngrid + c[1][dy]) * ngrid + c[2][dz])
                    acc += w * flat[:, key]
        out[:, s:s + _CHUNK] = acc
    return prec.q(out)


def _forces(x, ngrid: int, boxsize: float, om0: float, prec: Precision):
    dev = x.device
    cell = boxsize / ngrid
    grid = _cic(x, ngrid, cell, prec)
    delta = prec.q(grid / grid.mean() - 1.0)
    del grid
    m = _modes(ngrid, dev, prec.dtype)
    mz = _modes(ngrid, dev, prec.dtype, real=True)
    win = (torch.sinc(m / ngrid)[:, None, None] ** 2
           * torch.sinc(m / ngrid)[None, :, None] ** 2
           * torch.sinc(mz / ngrid)[None, None, :] ** 2)
    dk = prec.q(torch.fft.rfftn(delta) / win)
    del delta
    kf = 2.0 * math.pi / boxsize
    k = [(m * kf)[:, None, None], (m * kf)[None, :, None],
         (mz * kf)[None, None, :]]
    k2 = k[0] ** 2 + k[1] ** 2 + k[2] ** 2
    phi = prec.q(-1.5 * om0 * dk / torch.where(k2 == 0, torch.ones_like(k2),
                                                k2))
    phi[0, 0, 0] = 0.0
    del dk
    fields = torch.empty((3, ngrid, ngrid, ngrid), dtype=prec.dtype,
                         device=dev)
    ny = ngrid // 2
    for a in range(3):
        ka = torch.where((k[a] / kf).abs() == ny, torch.zeros_like(k[a]),
                         k[a])
        fields[a] = prec.q(torch.fft.irfftn(-1j * ka * phi,
                                            s=(ngrid,) * 3))
    return _gather(fields, x, ngrid, cell, prec)


def evolve(pos, mom, om0: float, ngrid: int, boxsize: float, a_init: float,
           a_final: float, nsteps: int, prec: Precision):
    """(positions, momenta) after nsteps log-a KDK steps from a_init to
    a_final, each (3, n) in the precision's working dtype."""
    x = prec.q(pos).clone()
    p = prec.q(mom).clone()
    frc = _forces(x, ngrid, boxsize, om0, prec)
    for k1, dr, k2 in cosmo_ref.kdk_factors(om0, a_init, a_final, nsteps):
        p = prec.q(p + k1 * frc)
        x = prec.q(torch.remainder(x + dr * p, boxsize))
        frc = _forces(x, ngrid, boxsize, om0, prec)
        p = prec.q(p + k2 * frc)
    return x, p
