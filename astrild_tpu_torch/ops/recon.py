"""BAO reconstruction (Eisenstein et al. 2007; Padmanabhan et al. 2012):
estimate the Zel'dovich displacement from the smoothed tracer density and
move tracers (and randoms) back.

Port of astrild_tpu/ops/recon.py: paint -> smooth -> spectral inverse
gradient -> trilinear sample -> shift. The paint is `paint.paint`, which
on a CUDA tensor runs the tile-binned painter K2 (CIC/TSC).
`sample_displacement` is also the gather of the PM forces (ops/nbody.py).

Standard estimator (plane-parallel RSD, los = z axis):

    psi(k) = +i k / k^2 * S(k) delta_g(k) / (b + f mu^2)
    data    shift: x -> x - psi(x) - f (psi . zhat) zhat   (removes RSD)
    randoms shift: x -> x - psi(x)

with S(k) = exp(-(k Sigma)^2 / 4) the usual Gaussian smoothing, b the
tracer bias and f the growth rate (f=0 for real space).
"""
from __future__ import annotations

import math

import torch

from .._device import as_points
from .paint import paint
from .power import _mode_numbers, delta_k

__all__ = ["displacement_field", "sample_displacement",
           "reconstruct_catalog"]


def _as_comps(pos):
    if isinstance(pos, (tuple, list)):
        return tuple(torch.as_tensor(c).reshape(-1) for c in pos)
    pos = torch.as_tensor(pos)
    return pos[:, 0], pos[:, 1], pos[:, 2]


def sample_displacement(psi_grids, boxsize, pos):
    """Trilinear periodic sample of the displacement at positions.

    psi_grids: (3, n, n, n); pos: (n, 3) or flat tuple. Returns (3, np).
    Gathers one component and one neighbour at a time with int32 cell
    indices (n^3 < 2^31), so the temporaries stay at a few (np,) vectors.
    """
    x, y, z = _as_comps(pos)
    ngrid = psi_grids.shape[-1]
    cell = boxsize / ngrid
    flat = psi_grids.reshape(3, -1)
    lo, hi, fr = [], [], []
    for c in (x, y, z):
        u = c / cell - 0.5
        i0 = torch.floor(u)
        fr.append(u - i0)
        i0 = i0.to(torch.int32)
        lo.append(torch.remainder(i0, ngrid))
        hi.append(torch.remainder(i0 + 1, ngrid))
    out = torch.zeros((3, x.shape[0]), dtype=psi_grids.dtype,
                      device=psi_grids.device)
    for dx in (0, 1):
        wx = fr[0] if dx else 1 - fr[0]
        ix = (hi if dx else lo)[0] * ngrid
        for dy in (0, 1):
            wxy = wx * (fr[1] if dy else 1 - fr[1])
            ixy = (ix + (hi if dy else lo)[1]) * ngrid
            for dz in (0, 1):
                w = wxy * (fr[2] if dz else 1 - fr[2])
                idx = ixy + (hi if dz else lo)[2]
                for a in range(3):
                    out[a].addcmul_(w, flat[a].index_select(0, idx))
    return out


def _nyquist_masks(ngrid: int, device):
    """1 everywhere but the Nyquist mode ngrid // 2, on the full axis and
    on the rfft axis: odd (derivative) transfers vanish there."""
    ny = ngrid // 2
    full = torch.ones(ngrid, device=device)
    full[ny] = 0.0
    half = torch.ones(ngrid // 2 + 1, device=device)
    half[ny] = 0.0
    return full, half


def displacement_field(pos, ngrid: int, boxsize, smooth=15.0,
                       bias: float = 1.0, f_growth: float = 0.0,
                       window: str = "cic", los: int = 2, device=None):
    """Estimated Zel'dovich displacement grids (3, n, n, n) [Mpc/h].

    Args:
      pos: tracer positions ((n,3) or flat-component tuple); numpy input
        goes to `device`, by default the CUDA card (it raises without one);
        tensors keep their device.
      smooth: Gaussian smoothing scale Sigma [Mpc/h] (S = exp(-(k
        Sigma)^2/4), the Eisenstein+07 convention).
      bias: linear tracer bias b.
      f_growth: growth rate f for the RSD term (0 = real space).
      los: plane-parallel line-of-sight axis for the f mu^2 term.
    """
    pos = as_points(pos, device)
    grid = paint(pos, ngrid, boxsize, window=window)
    dk = delta_k(grid, window=window)  # FFT(delta)/N^3, compensated
    dev = grid.device
    kf = 2.0 * math.pi / boxsize
    f = _mode_numbers(ngrid, dev) * kf
    # the rfft axis as the JAX package takes it: the first n//2 + 1 entries
    # of the full axis (its last, the Nyquist mode, is -n/2; only its
    # square enters, the odd transfers are masked there)
    fr = f[: ngrid // 2 + 1]
    kvec = [f.reshape(-1, 1, 1), f.reshape(1, -1, 1), fr.reshape(1, 1, -1)]
    k2 = kvec[0] ** 2 + kvec[1] ** 2 + kvec[2] ** 2
    k2safe = torch.where(k2 == 0.0, torch.ones_like(k2), k2)
    mu2 = kvec[los] ** 2 / k2safe
    s = torch.exp(-0.25 * k2 * smooth ** 2)
    phik = torch.where(k2 == 0.0, torch.zeros_like(dk),
                       dk * s / (k2safe * (bias + f_growth * mu2)))
    mask_full, mask_r = _nyquist_masks(ngrid, dev)
    masks = [mask_full.reshape(-1, 1, 1), mask_full.reshape(1, -1, 1),
             mask_r.reshape(1, 1, -1)]
    # continuity: delta = -div psi  =>  psi(k) = +i k delta(k)/k^2
    psi = [torch.fft.irfftn(1j * kvec[a] * masks[a] * phik,
                            s=(ngrid,) * 3, dim=(-3, -2, -1))
           * float(ngrid) ** 3 for a in range(3)]
    return torch.stack(psi)


def reconstruct_catalog(pos, randoms, ngrid: int, boxsize, smooth=15.0,
                        bias: float = 1.0, f_growth: float = 0.0,
                        window: str = "cic", los: int = 2, device=None):
    """Standard BAO reconstruction: returns (pos_displaced,
    randoms_displaced), both (n, 3), periodic-wrapped.

    Convention: the 'RecIso' scheme (Padmanabhan+12; Seo+16 naming):
    data get the extra -f (psi.zhat) zhat RSD-removal term, randoms only
    -psi. With f_growth=0 (real-space input) it coincides with 'RecSym'.
    pos and randoms are placed as in `displacement_field` (numpy randoms
    follow the tracers' device).
    """
    pos = as_points(pos, device)
    dev = (pos[0] if isinstance(pos, tuple) else pos).device
    randoms = as_points(randoms, dev if device is None else device)
    psi = displacement_field(pos, ngrid, boxsize, smooth=smooth, bias=bias,
                             f_growth=f_growth, window=window, los=los)

    def shift(p, with_rsd):
        x, y, z = _as_comps(p)
        s = sample_displacement(psi, boxsize, (x, y, z))
        comps = [x - s[0], y - s[1], z - s[2]]
        if with_rsd and f_growth != 0.0:
            comps[los] = comps[los] - f_growth * s[los]
        return torch.stack([c % boxsize for c in comps], dim=-1)

    return shift(pos, True), shift(randoms, False)
