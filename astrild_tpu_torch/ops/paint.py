"""Mass assignment: particle -> grid painting (NGP/CIC/TSC) on torch tensors.

Port of astrild_tpu/ops/paint.py. The scatter painters deposit each
particle's separable window weights with `index_add_` over the neighbour
offsets; `deposit="kernel"` sends NGP through the windowed CUDA deposit
(`paint_cuda.deposit_flat`, kernel K1) and CIC/TSC through the windowed
CUDA painter (`paint_cuda.paint_windowed`, kernel K2).
"""
from __future__ import annotations

import torch

from .._device import as_tensor
from .._options import port_spelling

__all__ = [
    "paint", "paint_ngp", "paint_cic", "paint_tsc",
    "compensation_kernel", "WINDOW_ORDER",
]

WINDOW_ORDER = {"ngp": 1, "cic": 2, "tsc": 3}


def _ones_or(weights, n, device):
    if weights is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return weights.to(torch.float32)


def _flat_keys(i0, i1, i2, ngrid):
    return (i0 * ngrid + i1) * ngrid + i2


def _scatter(flat, w, ngrid):
    out = torch.zeros(ngrid ** 3, dtype=w.dtype, device=w.device)
    return out.index_add_(0, flat.reshape(-1).long(), w.reshape(-1))


def _ngp_cells(pos, ngrid: int, boxsize):
    i = torch.floor(pos / (boxsize / ngrid)).to(torch.int32) % ngrid
    return _flat_keys(i[:, 0], i[:, 1], i[:, 2], ngrid)


def paint_ngp(pos, ngrid: int, boxsize, weights=None):
    """Nearest-grid-point deposit."""
    w = _ones_or(weights, pos.shape[0], pos.device)
    flat = _ngp_cells(pos, ngrid, boxsize)
    return _scatter(flat, w, ngrid).reshape(ngrid, ngrid, ngrid)


def paint_cic(pos, ngrid: int, boxsize, weights=None):
    """Cloud-in-cell deposit (2nd-order window, 8 cells/particle)."""
    w0 = _ones_or(weights, pos.shape[0], pos.device)
    u = pos / (boxsize / ngrid) - 0.5
    i0 = torch.floor(u)
    f = (u - i0).to(torch.float32)  # (n, 3) in [0,1)
    i0 = i0.to(torch.int32)
    grid = torch.zeros(ngrid ** 3, dtype=torch.float32, device=pos.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx = f[:, 0] if dx else 1.0 - f[:, 0]
                wy = f[:, 1] if dy else 1.0 - f[:, 1]
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                flat = _flat_keys((i0[:, 0] + dx) % ngrid,
                                  (i0[:, 1] + dy) % ngrid,
                                  (i0[:, 2] + dz) % ngrid, ngrid)
                grid.index_add_(0, flat.long(), w0 * wx * wy * wz)
    return grid.reshape(ngrid, ngrid, ngrid)


def _tsc_axis_weights(d):
    """TSC 1D weights for offsets (-1, 0, +1) around the center cell.

    d in [-0.5, 0.5) is the distance from particle to center-cell center
    in cell units.
    """
    wm = 0.5 * (0.5 - d) ** 2
    w0 = 0.75 - d ** 2
    wp = 0.5 * (0.5 + d) ** 2
    return (wm, w0, wp)


def paint_tsc(pos, ngrid: int, boxsize, weights=None):
    """Triangular-shaped-cloud deposit (3rd-order window, 27 cells)."""
    w0 = _ones_or(weights, pos.shape[0], pos.device)
    u = pos / (boxsize / ngrid)
    ic = torch.floor(u).to(torch.int32)  # center cell
    d = (u - ic - 0.5).to(torch.float32)  # distance from cell center
    wx = _tsc_axis_weights(d[:, 0])
    wy = _tsc_axis_weights(d[:, 1])
    wz = _tsc_axis_weights(d[:, 2])
    grid = torch.zeros(ngrid ** 3, dtype=torch.float32, device=pos.device)
    for ax, dx in enumerate((-1, 0, 1)):
        for ay, dy in enumerate((-1, 0, 1)):
            for az, dz in enumerate((-1, 0, 1)):
                flat = _flat_keys((ic[:, 0] + dx) % ngrid,
                                  (ic[:, 1] + dy) % ngrid,
                                  (ic[:, 2] + dz) % ngrid, ngrid)
                grid.index_add_(0, flat.long(),
                                w0 * wx[ax] * wy[ay] * wz[az])
    return grid.reshape(ngrid, ngrid, ngrid)


_PAINTERS = {"ngp": paint_ngp, "cic": paint_cic, "tsc": paint_tsc}


def _paint_one(pos_flat, ngrid, boxsize, weights, window, deposit):
    """pos_flat: (3n,) x, y and z concatenated; the scatter painters and
    NGP read it through an (n, 3) view."""
    device = pos_flat.device
    deposit = port_spelling(deposit, {"pallas": "kernel"}, "deposit")
    if deposit is None:
        # CIC/TSC take the kernel on the card at every size (the JAX
        # package's size threshold is TPU tuning); the JAX package never
        # auto-selects a kernel for NGP
        deposit = ("kernel" if window in ("cic", "tsc")
                   and device.type == "cuda" else "scatter")
    rows = pos_flat.view(3, pos_flat.shape[0] // 3).t()
    if deposit == "kernel":
        if device.type != "cuda":
            raise ValueError("deposit='kernel' needs a CUDA tensor, got "
                             f"{device}")
        from . import paint_cuda
        w = None if weights is None else weights.to(torch.float32)
        if window == "ngp":
            dep = paint_cuda.deposit_flat(_ngp_cells(rows, ngrid, boxsize),
                                          w, ngrid ** 3)
            return dep.reshape(ngrid, ngrid, ngrid)
        return paint_cuda.paint_windowed(pos_flat, w, ngrid, boxsize,
                                         order=WINDOW_ORDER[window])
    if deposit != "scatter":
        raise ValueError(f"deposit must be None, 'scatter' or 'kernel' "
                         f"('pallas'), got {deposit!r}")
    return _PAINTERS[window](rows, ngrid, boxsize, weights)


def paint(pos, ngrid: int, boxsize, weights=None, window: str = "cic",
          interlaced: bool = False, deposit: str | None = None,
          device=None):
    """Deposit particles onto an n^3 grid.

    Args:
      pos: (n, 3) positions in [0, boxsize), or a tuple of flat (n,)
        component tensors (x, y, z).
      ngrid: grid resolution per side.
      boxsize: box side length (same units as pos).
      weights: optional per-particle weights (mass).
      window: 'ngp' | 'cic' | 'tsc'.
      interlaced: if True, returns (grid, grid_shifted) where the second
        deposit is displaced by half a cell along each axis.
      deposit: None (auto: 'kernel' for CIC/TSC on a CUDA tensor,
        'scatter' otherwise) | 'scatter' | 'kernel' (NGP through the windowed
        CUDA deposit K1, CIC/TSC through the windowed CUDA painter K2;
        CUDA tensors only; the JAX package's spelling 'pallas' means the
        same).
      device: where numpy input goes (default: the CUDA card, raising
        without one); tensors keep their device.
    """
    # numpy input goes to `device`; tensors stay as they are
    if isinstance(pos, (tuple, list)):
        first = pos[0] if isinstance(pos[0], torch.Tensor) \
            else as_tensor(pos[0], device)
        pos = tuple(c if isinstance(c, torch.Tensor)
                    else as_tensor(c, first.device) for c in pos)
    elif not isinstance(pos, torch.Tensor):
        first = pos = as_tensor(pos, device)
    else:
        first = pos
    if weights is not None and not isinstance(weights, torch.Tensor):
        weights = as_tensor(weights, first.device)
    # one layout for every route: x, y and z concatenated (one copy)
    if isinstance(pos, tuple):
        pos_flat = torch.cat([c.reshape(-1) for c in pos])
    else:
        pos_flat = pos.t().reshape(-1)
    g = _paint_one(pos_flat, ngrid, boxsize, weights, window, deposit)
    if not interlaced:
        return g
    half = 0.5 * boxsize / ngrid
    g2 = _paint_one(torch.remainder(pos_flat + half, boxsize), ngrid,
                    boxsize, weights, window, deposit)
    return g, g2


def _sinc_window(freqs, p: int):
    # freqs in cycles/cell in [-0.5, 0.5]; W = sinc(freq)^p
    x = torch.where(freqs == 0.0, torch.ones_like(freqs), torch.sinc(freqs))
    return x ** p


def compensation_kernel(ngrid: int, window: str = "cic",
                        dtype=torch.float32, device=None):
    """Fourier-space window deconvolution 1/W(k) on the rfftn grid.

    W(k) = prod_i sinc(pi k_i / (2 k_ny))^p with p = window order.
    Returns a tensor broadcastable against rfftn(delta) of shape
    (n, n, n//2+1).
    """
    p = WINDOW_ORDER[window]
    fx = torch.fft.fftfreq(ngrid, device=device).to(dtype)
    fz = torch.fft.rfftfreq(ngrid, device=device).to(dtype)
    wx = _sinc_window(fx, p)[:, None, None]
    wy = _sinc_window(fx, p)[None, :, None]
    wz = _sinc_window(fz, p)[None, None, :]
    return 1.0 / (wx * wy * wz)
