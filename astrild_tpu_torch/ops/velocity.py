"""Velocity-field statistics: counts-normalized velocity grids,
divergence theta = div v, and the P_thetatheta / P_deltatheta spectra.

Port of astrild_tpu/ops/velocity.py: paint -> normalize -> spectral ik
divergence -> shell average. Each paint is `paint.paint`, which on a CUDA
tensor runs the tile-binned painter K2: `velocity_field` paints the counts
once and each velocity component once as weights (four K2 launches).

Conventions: velocities km/s, theta in km/s/(Mpc/h) (not divided by aHf);
divide by a H(a) f to get the dimensionless theta of RSD literature.
"""
from __future__ import annotations

import math

import torch

from .._device import as_points
from . import power as power_ops
from .paint import paint
from .recon import _nyquist_masks

__all__ = ["velocity_field", "velocity_divergence",
           "velocity_divergence_power", "delta_theta_cross_power"]


def velocity_field(pos, vel, ngrid: int, boxsize, window: str = "cic",
                   device=None):
    """Counts-normalized velocity grids: v_i(cell) = sum(w v_i)/sum(w).

    The mass-weighted velocity estimator (momentum/density); empty cells
    read 0. A cell that holds only a sliver of a particle (counts ~1e-7)
    turns the rounding of its sums into a large velocity: compare velocity
    grids only where the counts are well above 0.

    Args:
      pos: (n, 3) or flat-component tuple; vel: (n, 3) or tuple [km/s].
        Numpy input goes to `device`, by default the CUDA card (it raises
        without one); tensors keep their device.
    Returns (vgrids (3, ngrid^3 shape), counts grid).
    """
    pos = as_points(pos, device)
    dev = (pos[0] if isinstance(pos, tuple) else pos).device
    vel = as_points(vel, dev if device is None else device)
    if isinstance(vel, tuple):
        vcomp = tuple(c.reshape(-1) for c in vel)
    else:
        vcomp = (vel[:, 0], vel[:, 1], vel[:, 2])
    counts = paint(pos, ngrid, boxsize, window=window)
    safe = torch.clamp_min(counts, 1e-12)
    grids = []
    for c in vcomp:
        m = paint(pos, ngrid, boxsize, weights=c, window=window)
        grids.append(torch.where(counts > 0, m / safe,
                                 torch.zeros_like(m)))
    return torch.stack(grids), counts


def velocity_divergence(vgrids, boxsize):
    """theta = div v by spectral derivative (ik_i v_i(k), periodic).

    vgrids: (3, n, n, n) velocity component grids. Odd derivatives
    vanish on their Nyquist plane.
    """
    n = vgrids.shape[-1]
    dev = vgrids.device
    kf = 2.0 * math.pi / boxsize
    f = power_ops._mode_numbers(n, dev) * kf
    fr = f[: n // 2 + 1]
    mask_full, mask_r = _nyquist_masks(n, dev)
    kx = (f * mask_full).reshape(n, 1, 1)
    ky = (f * mask_full).reshape(1, n, 1)
    kz = (fr * mask_r).reshape(1, 1, n // 2 + 1)
    dims = (-3, -2, -1)
    tk = (1j * kx * torch.fft.rfftn(vgrids[0], dim=dims)
          + 1j * ky * torch.fft.rfftn(vgrids[1], dim=dims)
          + 1j * kz * torch.fft.rfftn(vgrids[2], dim=dims))
    return torch.fft.irfftn(tk, s=(n, n, n), dim=dims)


def velocity_divergence_power(pos, vel, ngrid: int, boxsize,
                              nbins: int = 0, window: str = "cic",
                              kmin=None, kmax=None, device=None):
    """P_thetatheta(k) of the velocity-divergence field [km^2/s^2 *
    (Mpc/h)^-2 * (Mpc/h)^3].

    Linear check: for a Zel'dovich flow theta = -a H f delta, so
    P_thetatheta -> (a H f)^2 P_delta at low k.
    """
    vgrids, _ = velocity_field(pos, vel, ngrid, boxsize, window=window,
                               device=device)
    theta = velocity_divergence(vgrids, boxsize)
    # theta is a zero-mean field, not a density deposit: no mean
    # normalization, window compensation or shot noise
    n = theta.shape[-1]
    nbins = nbins or (n // 2)
    tk = torch.fft.rfftn(theta, dim=(-3, -2, -1)) / float(n) ** 3
    pk3d = (tk.abs() ** 2) * (boxsize ** 3)
    k, p, nm = power_ops.shell_average(pk3d, n, boxsize, nbins, kmin, kmax)
    return power_ops.PowerResult(k, p, nm)


def delta_theta_cross_power(pos, vel, ngrid: int, boxsize, nbins: int = 0,
                            window: str = "cic", kmin=None, kmax=None,
                            device=None):
    """Cross spectrum P_deltatheta(k), the RSD cross ingredient.

    Linear check: P_deltatheta -> -a H f P_delta (theta = -aHf delta).
    The counts grid of `velocity_field` is the delta grid.
    """
    vgrids, counts = velocity_field(pos, vel, ngrid, boxsize,
                                    window=window, device=device)
    theta = velocity_divergence(vgrids, boxsize)
    n = counts.shape[-1]
    nbins = nbins or (n // 2)
    dk = power_ops.delta_k(counts, window=window)
    tk = torch.fft.rfftn(theta, dim=(-3, -2, -1)) / float(n) ** 3
    pk3d = (dk * tk.conj()).real * (boxsize ** 3)
    k, p, nm = power_ops.shell_average(pk3d, n, boxsize, nbins, kmin, kmax)
    return power_ops.PowerResult(k, p, nm)
