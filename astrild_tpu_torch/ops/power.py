"""3D power-spectrum estimation on torch tensors: FFT + k-shell reduction.

Port of astrild_tpu/ops/power.py. The host binning builders are the JAX
package's numpy code, copied unchanged so that the float32 shell edges and
every mode's bin are bit-identical between the two packages. The fast
estimator `auto_power_fast` deposits NGP counts on a fine_factor-finer grid
in subgrid-major layout and folds the fine_factor^3 subgrid FFTs; on a CUDA
tensor the deposit is the hand-written sorted kernel K1
(`paint_cuda.deposit_flat`), on the CPU an `index_add_` scatter.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.tables import tables_from_numpy
from .paint import compensation_kernel
from .paint_cuda import deposit_flat, deposit_sorted_reference

# last auto-selected deposit path ('kernel' | 'scatter'); diagnostics only
last_auto_deposit: Optional[str] = None

__all__ = [
    "PowerResult", "mode_radius_rfft", "hermitian_weights", "delta_k",
    "shell_average", "auto_power", "auto_power_fast", "get_shell_binning",
    "get_fast_binning",
]


class PowerResult(NamedTuple):
    k: torch.Tensor        # mean |k| per bin [h/Mpc]
    power: torch.Tensor    # P(k) [(Mpc/h)^3]
    nmodes: torch.Tensor   # hermitian-weighted mode count per bin


def _mode_numbers(n: int, device=None, real: bool = False):
    """Integer FFT mode numbers fftfreq(n) * n (rfftfreq with `real`) as
    exact float32 values; torch's fftfreq(n) * n is off by an ulp for odd
    n."""
    k = torch.arange(n // 2 + 1 if real else n, device=device)
    if not real:
        k = (k + n // 2) % n - n // 2
    return k.to(torch.float32)


def mode_radius_rfft(ngrid: int, dtype=torch.float32, device=None):
    """|k|/kf on the rfftn grid: sqrt of exact integer mode-number sums."""
    ix = _mode_numbers(ngrid, device).to(dtype)
    iz = _mode_numbers(ngrid, device, real=True).to(dtype)
    m2 = (ix[:, None, None] ** 2 + ix[None, :, None] ** 2
          + iz[None, None, :] ** 2)
    return torch.sqrt(m2)


def hermitian_weights(ngrid: int, dtype=torch.float32, device=None):
    """Mode multiplicity for rfftn storage: 2 except kz=0 and kz=nyquist planes."""
    nz = ngrid // 2 + 1
    w = torch.full((nz,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if ngrid % 2 == 0:
        w[nz - 1] = 1.0
    return w[None, None, :]


def _nonzero(total):
    """total, or 1 where it is 0 (a Python number or a tensor)."""
    if isinstance(total, torch.Tensor):
        return torch.where(total == 0, torch.ones_like(total), total)
    return total if total != 0 else 1.0


def delta_k(grid, grid_shifted=None, window: Optional[str] = None,
            interlaced: bool = False):
    """Density contrast in Fourier space, window-compensated.

    Args:
      grid: (n, n, n) painted density (counts or mass).
      grid_shifted: half-cell-shifted deposit for interlacing.
      window: 'ngp'|'cic'|'tsc' to deconvolve the assignment window.
      interlaced: combine grid and grid_shifted to cancel odd alias images.
    Returns complex (n, n, n//2+1) tensor: FFT(delta)/N^3 (dimensionless).
    """
    n = grid.shape[-1]
    dims = (-3, -2, -1)
    d = grid / _nonzero(grid.mean()) - 1.0
    dk = torch.fft.rfftn(d, dim=dims) / float(n) ** 3
    if interlaced:
        d2 = grid_shifted / _nonzero(grid_shifted.mean()) - 1.0
        dk2 = torch.fft.rfftn(d2, dim=dims) / float(n) ** 3
        # shift by +H/2 per axis: multiply by exp(+i (kx+ky+kz) H/2)
        ix = _mode_numbers(n, grid.device)
        iz = _mode_numbers(n, grid.device, real=True)
        ph = (math.pi / n) * (ix[:, None, None] + ix[None, :, None]
                              + iz[None, None, :])
        dk = 0.5 * (dk + dk2 * torch.exp(1j * ph))
    if window is not None:
        dk = dk * compensation_kernel(n, window, device=grid.device)
    return dk


_SHELL_CACHE = {}


def _shell_binning_host_from_freqs(fx, fy, fz, nbins, mmin, mmax,
                                   ngrid_for_weights: int, cache_key):
    """Generic host binning-structure builder over given mode-number axes."""
    if cache_key in _SHELL_CACHE:
        return _SHELL_CACHE[cache_key]
    m = np.sqrt(fx[:, None, None] ** 2 + fy[None, :, None] ** 2
                + fz[None, None, :] ** 2)
    # hermitian weights along the rfft axis
    w = np.full(m.shape, 2.0, np.float32)
    w[..., fz == 0] = 1.0
    if ngrid_for_weights % 2 == 0:
        w[..., np.abs(fz) == ngrid_for_weights // 2] = 1.0
    w[(fx == 0)[:, None, None] * (fy == 0)[None, :, None]
      * (fz == 0)[None, None, :]] = 0.0
    mf = m.reshape(-1)
    wf = w.reshape(-1)
    out = _per_mode_binning(mf, wf, nbins, mmin, mmax)
    _SHELL_CACHE[cache_key] = out
    return out


def _per_mode_binning(mf, wf, nbins, mmin, mmax):
    """Per-mode (binidx, weight) arrays + per-bin totals.

    binidx is nbins (a discard slot) for out-of-range or zero-weight
    modes; wf is zeroed there too.
    """
    edges = np.linspace(mmin, mmax, nbins + 1, dtype=np.float32)
    binidx = np.clip(np.searchsorted(edges, mf, side="right") - 1, 0,
                     nbins - 1)
    ok = (mf >= mmin) & (mf <= mmax) & (wf > 0)
    binidx = np.where(ok, binidx, nbins).astype(np.int32)
    wfull = np.where(ok, wf, 0.0).astype(np.float32)
    nm = np.bincount(binidx, weights=wfull,
                     minlength=nbins + 1)[:nbins].astype(np.float32)
    ksum = np.bincount(binidx, weights=wfull * mf,
                       minlength=nbins + 1)[:nbins]
    kmean = (ksum / np.maximum(nm, 1.0)).astype(np.float32)
    return binidx, wfull, nm, kmean


def _shell_binning_host(ngrid: int, nbins: int, mmin: float, mmax: float):
    """Host-precomputed shell-binning structures (cached per config).

    Returns (binidx (nmodes,) int32 with nbins = discard, wf (nmodes,)
    f32 hermitian weights, nm (nbins,) weighted mode counts, kmean_units
    (nbins,) mean |k|/kf per bin).
    """
    key = (ngrid, nbins, float(mmin), float(mmax))
    if key in _SHELL_CACHE:
        return _SHELL_CACHE[key]
    ix = (np.fft.fftfreq(ngrid) * ngrid).astype(np.float32)
    iz = (np.fft.rfftfreq(ngrid) * ngrid).astype(np.float32)
    m = np.sqrt(ix[:, None, None] ** 2 + ix[None, :, None] ** 2
                + iz[None, None, :] ** 2)
    nz = ngrid // 2 + 1
    w = np.full((1, 1, nz), 2.0, np.float32)
    w[..., 0] = 1.0
    if ngrid % 2 == 0:
        w[..., -1] = 1.0
    w = np.broadcast_to(w, m.shape).copy()
    w[0, 0, 0] = 0.0
    out = _per_mode_binning(m.reshape(-1), w.reshape(-1), nbins, mmin,
                            mmax)
    _SHELL_CACHE[key] = out
    return out


def _fast_binning_host(ngrid: int, nbins: int, fine_factor: int = 2,
                       kmin=None, kmax=None):
    """Host binning structures for auto_power_fast (folded fine spectrum)."""
    mmin = 0.5 if kmin is None else kmin
    mmax = ngrid / 2.0 if kmax is None else kmax
    nf = ngrid * fine_factor
    fxy = np.asarray(np.fft.fftfreq(ngrid) * ngrid, np.float32)
    fz = np.arange(ngrid // 2 + 1, dtype=np.float32)
    return _shell_binning_host_from_freqs(
        fxy, fxy, fz, nbins, mmin, mmax, nf,
        cache_key=("fine-host", ngrid, fine_factor, nbins, float(mmin),
                   float(mmax)))


_DEVICE_BIN_CACHE = {}


def _device_binning(cache_key, builder, device):
    """Host binning structures as tensors on `device` (cached per device)."""
    key = (cache_key, str(torch.device(device or "cpu")))
    if key not in _DEVICE_BIN_CACHE:
        _DEVICE_BIN_CACHE[key] = tables_from_numpy(builder(), device)
    return _DEVICE_BIN_CACHE[key]


def get_shell_binning(ngrid: int, nbins: int, kmin=None, kmax=None,
                      device=None):
    """Shell-binning tensors (binidx, wf, nm, kmean) for auto_power and
    shell_average, on `device`."""
    mmin = 0.5 if kmin is None else kmin
    mmax = ngrid / 2.0 if kmax is None else kmax
    return _device_binning(
        ("shell", ngrid, nbins, float(mmin), float(mmax)),
        lambda: _shell_binning_host(ngrid, nbins, mmin, mmax), device)


def get_fast_binning(ngrid: int, nbins: int, fine_factor: int = 2,
                     kmin=None, kmax=None, device=None):
    """Binning tensors for auto_power_fast (folded fine spectrum)."""
    mmin = 0.5 if kmin is None else kmin
    mmax = ngrid / 2.0 if kmax is None else kmax
    return _device_binning(
        ("fine", ngrid, fine_factor, nbins, float(mmin), float(mmax)),
        lambda: _fast_binning_host(ngrid, nbins, fine_factor, kmin, kmax),
        device)


def _shell_reduce(values_flat, binidx, wf, nm):
    """Shell reduction: p[b] = sum_m v w [binidx==b] / nm.

    Accumulates in float64 (bincount keeps a small per-block histogram in
    shared memory on the card), then divides in float32.
    """
    nbins = nm.shape[0]
    acc = torch.bincount(binidx, weights=(values_flat * wf).to(torch.float64),
                         minlength=nbins + 1)
    denom = torch.where(nm > 0, nm, torch.ones_like(nm))
    return acc[:nbins].to(torch.float32) / denom


def shell_average(values, ngrid: int, boxsize: float, nbins: int,
                  kmin=None, kmax=None, binning=None):
    """Average `values` (real, rfftn layout) over |k| shells.

    Returns (k_mean, value_mean, nmodes). Bins are linear in k with width
    the fundamental mode kf = 2 pi / boxsize by default; kmin/kmax are in
    units of kf.
    """
    kf = 2.0 * math.pi / boxsize
    if binning is None:
        binning = get_shell_binning(ngrid, nbins, kmin, kmax,
                                    device=values.device)
    binidx, wf, nm, kmean = binning
    p = _shell_reduce(values.reshape(-1), binidx, wf, nm)
    return kmean * kf, p, nm


def auto_power(grid, boxsize: float, nbins: int = 0,
               window: Optional[str] = None, grid_shifted=None,
               interlaced: bool = False, shotnoise: float = 0.0, kmin=None,
               kmax=None, binning=None) -> PowerResult:
    """Auto power spectrum P(k) of a painted grid.

    shotnoise: V/N_particles for discrete tracers (subtracted after
    binning).
    """
    n = grid.shape[-1]
    nbins = nbins or (n // 2)
    dk = delta_k(grid, grid_shifted, window=window, interlaced=interlaced)
    pk3d = (dk.abs() ** 2) * (boxsize ** 3)
    k, p, nm = shell_average(pk3d, n, boxsize, nbins, kmin, kmax,
                             binning=binning)
    return PowerResult(k, p - shotnoise, nm)


def _components(pos):
    if isinstance(pos, (tuple, list)):
        return tuple(pos)
    return pos[:, 0], pos[:, 1], pos[:, 2]


def auto_power_fast(pos, ngrid: int, boxsize: float, nbins: int = 0,
                    fine_factor: int = 2, weights=None,
                    kmin=None, kmax=None,
                    return_coarse_grid: bool = False,
                    binning=None, deposit: Optional[str] = None
                    ) -> PowerResult:
    """Fast P(k): NGP deposit on a fine_factor-finer grid + deconvolution.

    Depositing NGP on a (fine_factor*ngrid)^3 grid and deconvolving the NGP
    window keeps sub-cell positional information at the finer resolution
    and pushes aliasing beyond fine_factor times the target Nyquist; the
    shells are measured up to the coarse-grid Nyquist.

    pos: (n, 3) tensor or a tuple of flat (n,) components (x, y, z).
    deposit: None (auto: 'kernel' on a CUDA tensor, 'scatter' on the CPU;
      recorded in `last_auto_deposit`) | 'kernel' (the sorted CUDA deposit;
      CUDA tensors only) | 'scatter' (`index_add_`).

    Returns the same binning as auto_power(grid(ngrid), nbins).
    """
    global last_auto_deposit
    nbins = nbins or (ngrid // 2)
    x, y, z = _components(pos)
    if binning is None:
        binning = get_fast_binning(ngrid, nbins, fine_factor, kmin, kmax,
                                   device=x.device)
    if deposit is None:
        deposit = "kernel" if x.device.type == "cuda" else "scatter"
        last_auto_deposit = deposit
    elif deposit == "kernel" and x.device.type != "cuda":
        raise ValueError(f"deposit='kernel' needs a CUDA tensor, got "
                         f"{x.device}")
    elif deposit not in ("kernel", "scatter"):
        raise ValueError(f"deposit must be None, 'kernel' or 'scatter', "
                         f"got {deposit!r}")
    return _auto_power_fast_impl((x, y, z), boxsize, weights, binning,
                                 ngrid=ngrid, fine_factor=fine_factor,
                                 return_coarse_grid=return_coarse_grid,
                                 deposit=deposit)


def _fast_keys(pos, boxsize, *, ngrid: int, fine_factor: int):
    """Flat NGP cell keys (int32) on the fine grid, subgrid-major layout.

    Shared by `_auto_power_fast_impl` and the suite's sub-stage timings.
    """
    nf = ngrid * fine_factor
    ff = fine_factor
    x, y, z = _components(pos)
    inv_cell = float(nf) / boxsize

    def cell(c):
        return torch.floor(c * inv_cell).to(torch.int32) % nf

    ux, uy, uz = cell(x), cell(y), cell(z)
    s_id = ((ux % ff) * ff + (uy % ff)) * ff + (uz % ff)
    return ((s_id * ngrid + ux // ff) * ngrid + uy // ff) * ngrid \
        + uz // ff


def _auto_power_fast_impl(pos, boxsize, weights, binning, *, ngrid: int,
                          fine_factor: int, return_coarse_grid: bool,
                          deposit: str):
    x = pos[0]
    n_part = x.shape[0]
    flat = _fast_keys(pos, boxsize, ngrid=ngrid, fine_factor=fine_factor)
    w32 = None if weights is None else weights.to(torch.float32)
    n_cells = fine_factor ** 3 * ngrid ** 3
    if deposit == "kernel":
        dep = deposit_flat(flat, w32, n_cells)
    else:
        dep = deposit_sorted_reference(flat, w32, n_cells)
    # discrete-tracer shot noise: V * sum(w^2) / (sum w)^2, which reduces
    # to V/N for unit weights
    if weights is None:
        total = float(n_part)
        shot = boxsize ** 3 / n_part
    else:
        total = w32.sum()
        shot = boxsize ** 3 * (w32 * w32).sum() / _nonzero(total) ** 2
    return _fold_fft_bin(dep, total, shot, binning, boxsize, ngrid=ngrid,
                         fine_factor=fine_factor,
                         return_coarse_grid=return_coarse_grid)


def _fold_fft_bin(dep_flat, total, shot, binning, boxsize, *, ngrid: int,
                  fine_factor: int, return_coarse_grid: bool):
    """Fold-FFT + NGP deconvolution + shell binning of a fine deposit.

    dep_flat: (ff^3 * ngrid^3,) subgrid-major counts. FFT_fine(m) for |m|
    below the coarse Nyquist is the phase-weighted sum of the FFTs of the
    ff^3 interleaved coarse subgrids.
    """
    ff = fine_factor
    nf = ngrid * ff
    dep = dep_flat.reshape(ff ** 3, ngrid, ngrid, ngrid)
    mode = _mode_numbers(ngrid, dep.device)
    mz = _mode_numbers(ngrid, dep.device, real=True)
    F = torch.zeros((ngrid, ngrid, ngrid // 2 + 1), dtype=torch.complex64,
                    device=dep.device)
    coarse = dep.sum(0) if return_coarse_grid else None

    # the fold phase exp(-2pi i (m_x s_x + m_y s_y + m_z s_z)/nf) is
    # separable: three 1-D phase vectors per subgrid
    def ph1(m, sc):
        return torch.exp((-2.0j * math.pi / nf) * (m * sc))

    for s in itertools.product(range(ff), repeat=3):
        sid = (s[0] * ff + s[1]) * ff + s[2]
        spec = torch.fft.rfftn(dep[sid])
        F += spec * (ph1(mode, s[0])[:, None, None]
                     * ph1(mode, s[1])[None, :, None]
                     * ph1(mz, s[2])[None, None, :])
    dk = F / _nonzero(total)  # = FFT(delta)/Nf^3 (+DC)

    # NGP window deconvolution at the fine resolution
    def axis_win(m):
        x = m / nf
        return torch.where(x == 0.0, torch.ones_like(x), torch.sinc(x))

    dk = dk / (axis_win(mode)[:, None, None] * axis_win(mode)[None, :, None]
               * axis_win(mz)[None, None, :])
    pk3d = (dk.abs() ** 2) * (boxsize ** 3)
    binidx, wf, nm, kmean = binning
    kf = 2.0 * math.pi / boxsize
    p = _shell_reduce(pk3d.reshape(-1), binidx, wf, nm)
    res = PowerResult(kmean * kf, p - shot, nm)
    if return_coarse_grid:
        return res, coarse
    return res
