"""Second-order Lagrangian perturbation theory (2LPT) particles from a
seeded Gaussian field, in plain torch: the benchmark's own frozen copy,
written for memory rather than speed of reading. Imports nothing of the
program.

The linear density's Fourier modes are white noise shaped by the EH98
P(k) (`cosmo.linear_power`), with <|delta_k|^2> = N^6 P(k) / V for the
unnormalised DFT. With phi the potential (lap phi = delta):

  psi1 = -grad invlap(delta),   S2 = sum_{i<j} phi_ii phi_jj - phi_ij^2,
  psi2 = +grad invlap(S2),      x = q + D1 psi1 + D2 psi2 (mod box),
  p = a^2 dx/dt = a^2 E(a) (f1 D1 psi1 + f2 D2 psi2)

(Bouchet et al. 1995). Odd (gradient) transfers vanish on their axis'
Nyquist plane. Particles are in lattice order (x-major), as initial
conditions are written.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import cosmo as cosmo_ref

__all__ = ["lpt_particles"]

_SLABS = 8


def _modes(n: int, device, real: bool = False):
    k = torch.arange(n // 2 + 1 if real else n, device=device)
    if not real:
        k = (k + n // 2) % n - n // 2
    return k


def lpt_particles(seed: int, n: int, boxsize: float, cosmo: dict,
                  z: float, order: int = 2, momenta: bool = False,
                  device="cuda"):
    """(pos, mom) for n^3 particles at redshift z: pos a (3, n^3) float32
    tensor of x, y, z rows in [0, boxsize], mom the same shape (or None
    unless `momenta`). The same seed gives the same particles."""
    if order not in (1, 2):
        raise ValueError("order must be 1 (Zel'dovich) or 2 (2LPT)")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    n3 = n ** 3
    kf = 2.0 * math.pi / boxsize
    d1, f1, d2, f2 = cosmo_ref.growth(z, cosmo["Om0"])
    if order == 1:
        d2 = f2 = 0.0
    a = 1.0 / (1.0 + z)
    e = float(cosmo_ref.efunc(a, cosmo["Om0"]))

    white = torch.randn((n, n, n), generator=gen, device=dev,
                        dtype=torch.float32)
    dk = torch.fft.rfftn(white)
    del white
    # the amplitude depends on |m|^2 only: a table over every integer m^2
    m2max = 3 * (n // 2) ** 2
    kk = np.sqrt(np.arange(m2max + 1, dtype=np.float64)) * kf
    kk[0] = 1.0
    amp = np.sqrt(cosmo_ref.linear_power(kk, cosmo) * n3 / boxsize ** 3)
    amp[0] = 0.0
    amp_t = torch.tensor(amp, dtype=torch.float32, device=dev)
    mx = _modes(n, dev)
    mz = _modes(n, dev, real=True)
    ny = n // 2
    bounds = [(i * n // _SLABS, (i + 1) * n // _SLABS) for i in range(_SLABS)]

    def m2_of(lo, hi):
        return (mx[lo:hi, None, None] ** 2 + mx[None, :, None] ** 2
                + mz[None, None, :] ** 2)

    for lo, hi in bounds:
        dk[lo:hi] *= amp_t[m2_of(lo, hi)]
    del amp_t

    tmp = torch.empty_like(dk)

    def axis_modes(i, lo, hi, odd):
        """Mode numbers along axis i on the slab, broadcastable; an odd
        transfer vanishes on the axis' Nyquist plane."""
        if i == 0:
            m = mx[lo:hi].reshape(-1, 1, 1)
        elif i == 1:
            m = mx.reshape(1, -1, 1)
        else:
            m = mz.reshape(1, 1, -1)
        m = m.to(torch.float32)
        if odd:
            m = torch.where(m.abs() == ny, torch.zeros_like(m), m)
        return m

    def transform(src, coef):
        """irfftn(src * coef(lo, hi)) with the product built slab by
        slab into one reused buffer."""
        for lo, hi in bounds:
            m2 = m2_of(lo, hi).to(torch.float32)
            inv = torch.where(m2 == 0, torch.zeros_like(m2),
                              1.0 / torch.where(m2 == 0,
                                                torch.ones_like(m2), m2))
            torch.mul(src[lo:hi], coef(lo, hi, inv), out=tmp[lo:hi])
        return torch.fft.irfftn(tmp, s=(n, n, n))

    def grad_invlap(src, i, sign):
        # sign * grad(invlap(f)): (sign) * (i k_i) * (-f_k / k^2)
        return transform(src, lambda lo, hi, inv: (-1j * sign / kf)
                         * axis_modes(i, lo, hi, True) * inv)

    def second(src, i, j):
        # phi_ij = k_i k_j delta_k / k^2 (dimensionless)
        return transform(src, lambda lo, hi, inv: axis_modes(i, lo, hi, False)
                         * axis_modes(j, lo, hi, False) * inv)

    pos = torch.empty((3, n3), dtype=torch.float32, device=dev)
    mom = torch.empty((3, n3), dtype=torch.float32, device=dev) \
        if momenta else None
    c1 = a * a * e * f1 * d1
    c2 = a * a * e * f2 * d2
    for i in range(3):
        psi = grad_invlap(dk, i, -1.0).reshape(-1)
        torch.mul(psi, d1, out=pos[i])
        if momenta:
            torch.mul(psi, c1, out=mom[i])
        del psi
    if order == 2:
        pa = second(dk, 0, 0)
        pb = second(dk, 1, 1)
        s2 = pa * pb
        pb.add_(pa)
        del pa
        pc = second(dk, 2, 2)
        s2.addcmul_(pb, pc)
        del pb, pc
        for i, j in ((0, 1), (0, 2), (1, 2)):
            pij = second(dk, i, j)
            s2.addcmul_(pij, pij, value=-1.0)
            del pij
        del dk
        s2k = torch.fft.rfftn(s2)
        del s2
        for i in range(3):
            psi = grad_invlap(s2k, i, 1.0).reshape(-1)
            pos[i].add_(psi, alpha=d2)
            if momenta:
                mom[i].add_(psi, alpha=c2)
            del psi
        del s2k
    else:
        del dk
    del tmp
    cell = boxsize / n
    q = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * cell
    for i in range(3):
        shape = [1, 1, 1]
        shape[i] = n
        pos[i].view(n, n, n).add_(q.reshape(shape))
    pos.remainder_(boxsize)
    return pos, mom
