"""Distributed P(k): sharded paint + pencil FFT + collective shell binning.

Port of astrild_tpu/parallel/power.py. Particles arrive as row blocks, one
a rank; each rank paints its block onto a full local grid, `psum_scatter`
reduces and re-pencils the grid, the pencil FFT runs over the mesh, and
per-shell sums finish with a `psum`. On a CUDA block the painters are the
port's kernels: CIC/TSC through `ops.paint.paint` (K2) and the fast
estimator's fine NGP deposit through `paint_cuda.deposit_flat` (K1); on a
CPU block their plain versions.

Each factory returns fn(pos, weights=None) on this rank's block: pos an
(n, 3) tensor or a tuple of flat (x, y, z) components (the multihost
loader's layout), weights (n,) or None for ones; the result is replicated
(the same on every rank), as the JAX out_specs P() give.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch

from .._options import port_spelling
from ..ops import paint_cuda
from ..ops.paint import WINDOW_ORDER, paint as paint_single
from ..ops.power import (MultipoleResult, PowerResult, _legendre_even,
                         _mode_numbers)
from .mesh import axis_index, axis_size, psum, psum_scatter, to_mesh
from .pfft import local_kvecs, pfft3d_local

__all__ = ["make_distributed_auto_power", "make_distributed_auto_power_fast",
           "local_shell_average", "local_multipole_average",
           "make_distributed_multipoles", "fast_power_shard_body",
           "local_mode_numbers", "local_mode_radius"]

PART_AXES = ("sim", "x", "y")


def _local_compensation(ki, kj, kk, ngrid, boxsize, window):
    """1/W(k) for the local pencil block (full-spectrum layout)."""
    p = WINDOW_ORDER[window]
    kny = math.pi * ngrid / boxsize

    def axis_win(k):
        x = k / (2.0 * kny)  # = freq in cycles/cell
        s = torch.where(x == 0.0, torch.ones_like(x), torch.sinc(x))
        return s ** p

    return 1.0 / (axis_win(ki) * axis_win(kj) * axis_win(kk))


def local_mode_numbers(ngrid: int, mesh, ax: str = "x", ay: str = "y",
                       dtype=torch.float32, device=None):
    """Integer mode numbers (fi, fj, fk) for the local TRANSPOSED_OUT
    pencil block (see pfft.py), broadcastable to (n, n/PX, n/PY)."""
    nj = ngrid // axis_size(mesh, ax)
    nk = ngrid // axis_size(mesh, ay)
    xi = axis_index(mesh, ax)
    yi = axis_index(mesh, ay)
    freqs = _mode_numbers(ngrid, device).to(dtype)
    fi = freqs[:, None, None]
    fj = freqs[xi * nj:(xi + 1) * nj][None, :, None]
    fk = freqs[yi * nk:(yi + 1) * nk][None, None, :]
    return fi, fj, fk


def local_mode_radius(ngrid: int, mesh, ax: str = "x", ay: str = "y",
                      dtype=torch.float32, device=None):
    """|k|/kf for the local TRANSPOSED_OUT pencil block, from exact
    integer mode numbers (shell assignment bit-identical with
    ops.power.mode_radius_rfft)."""
    fi, fj, fk = local_mode_numbers(ngrid, mesh, ax, ay, dtype, device)
    return torch.sqrt(fi ** 2 + fj ** 2 + fk ** 2)


def _local_binned_reduce(value_streams, mf, ngrid, nbins, mesh,
                         axes=("x", "y"), kmin=None, kmax=None):
    """Shared core of the collective shell reductions: mask modes to the
    [mmin, mmax] shell range, sum [count, |k|, *value_streams] per shell,
    and psum across mesh `axes`.

    The shell edges are the host float64 linspace cast to float32, the
    same arithmetic as ops.power._per_mode_binning, so a |k|/kf on an edge
    falls in the same shell. The sums accumulate in float64 (a bincount
    per stream) and leave as float32.

    Returns (nm, msum, sums) with sums (nch, nbins).
    """
    mmin = 0.5 if kmin is None else kmin
    mmax = ngrid / 2.0 if kmax is None else kmax
    edges = torch.from_numpy(np.linspace(float(mmin), float(mmax), nbins + 1,
                                         dtype=np.float32)).to(mf.device)
    binidx = torch.clamp(torch.searchsorted(edges, mf, right=True) - 1, 0,
                         nbins - 1)
    inside = (mf >= mmin) & (mf <= mmax)
    binidx = torch.where(inside, binidx, torch.full_like(binidx, nbins))
    insf = inside.to(torch.float64)
    streams = [insf, insf * mf] + [insf * v for v in value_streams]
    acc = torch.stack([torch.bincount(binidx, weights=s.to(torch.float64),
                                      minlength=nbins + 1)[:nbins]
                       for s in streams])
    acc = psum(acc, mesh, axes).to(torch.float32)
    return acc[0], acc[1], acc[2:]


def local_shell_average(values, m, ngrid, boxsize, nbins, mesh,
                        axes=("x", "y"), kmin=None, kmax=None):
    """Shell-average `values` over |k| bins, reducing across mesh `axes`.

    values/m: local blocks (full complex-FFT layout, weight 1 per mode);
    m = |k|/kf mode radius. kmin/kmax are in mode units (match ops.power).
    """
    kf = 2.0 * math.pi / boxsize
    nm, msum, sums = _local_binned_reduce(
        [values.reshape(-1)], m.reshape(-1), ngrid, nbins, mesh, axes=axes,
        kmin=kmin, kmax=kmax)
    denom = torch.where(nm > 0, nm, torch.ones_like(nm))
    return msum / denom * kf, sums[0] / denom, nm


def local_multipole_average(values, m, mu2, ngrid, boxsize, nbins, mesh,
                            ells=(0, 2, 4), axes=("x", "y"),
                            kmin=None, kmax=None):
    """Shell-average Legendre-weighted `values` over |k| bins, reducing
    across mesh `axes`: the distributed counterpart of
    ops.power.auto_power_multipoles' per-ell reduction."""
    kf = 2.0 * math.pi / boxsize
    vf = values.reshape(-1)
    mu2f = mu2.reshape(-1)
    streams = [vf * ((2 * ell + 1) * _legendre_even(ell, mu2f))
               for ell in ells]
    nm, msum, sums = _local_binned_reduce(
        streams, m.reshape(-1), ngrid, nbins, mesh, axes=axes, kmin=kmin,
        kmax=kmax)
    denom = torch.where(nm > 0, nm, torch.ones_like(nm))
    return msum / denom * kf, sums / denom[None, :], nm


def _weighted_shotnoise(weights, boxsize, mesh, part_axes):
    """Weighted discrete-tracer shot noise V * Σw² / (Σw)².

    Reduces to V/N for unit weights (the count-based convention the local
    estimator subtracts), is the correct Poisson level for non-uniform
    weights, and lets zero-weight padding rows — the multihost loader pads
    ragged per-rank reads to equal block sizes — contribute nothing. The
    sums run in float64.
    """
    w = weights.to(torch.float64)
    s = psum(torch.stack([w.sum(), (w * w).sum()]), mesh, part_axes)
    return (boxsize ** 3 * s[1] / torch.clamp(s[0], min=1e-30) ** 2).to(
        torch.float32)


def _lead_shape(pos):
    return (pos[0].shape if isinstance(pos, (tuple, list))
            else pos.shape[:-1])


def _pos_device(pos):
    return (pos[0] if isinstance(pos, (tuple, list)) else pos).device


def _optional_weights(fn, mesh):
    """Honor the documented fn(pos, weights=None) contract: the block on
    the mesh's device (numpy input too, as jit places it), the weights
    defaulting to ones with the block's leading shape."""
    def call(pos, weights=None):
        pos = to_mesh(pos, mesh)
        if weights is None:
            weights = torch.ones(_lead_shape(pos), dtype=torch.float32,
                                 device=_pos_device(pos))
        return fn(pos, to_mesh(weights, mesh))

    return call


def _reduce_repencil(grid, mesh, part_axes):
    """Sum the full local grids over the particle axes outside ('x', 'y'),
    then reduce+re-pencil over 'x' and 'y': (n, n, n) -> (n/PX, n/PY, n)."""
    extra = tuple(a for a in part_axes if a not in ("x", "y"))
    if extra:
        grid = psum(grid, mesh, extra)
    if axis_size(mesh, "x") > 1:
        grid = psum_scatter(grid, mesh, "x", scatter_dimension=0)
    if axis_size(mesh, "y") > 1:
        grid = psum_scatter(grid, mesh, "y", scatter_dimension=1)
    return grid


def _global_mean(block, mesh, ngrid):
    """The mean of a pencil-sharded n^3 grid (summed in float64)."""
    total = psum(block.sum(dtype=torch.float64), mesh, ("x", "y"))
    return (total / float(ngrid) ** 3).to(torch.float32)


def _contrast(block, mean):
    return block / torch.where(mean == 0, torch.ones_like(mean), mean) - 1.0


def make_distributed_multipoles(mesh, ngrid: int, boxsize: float,
                                nbins: int, window: str = "cic",
                                ells=(0, 2, 4), los: int = 2):
    """Distributed redshift-space multipole estimator over `mesh`.

    Returns fn(pos, weights=None) -> MultipoleResult (replicated) with pos
    this rank's row block of a redshift-space point set split over ALL
    mesh axes; the line of sight is the global `los` axis. Pipeline: local
    paint (K2 on a CUDA block) -> psum_scatter re-pencil -> pencil FFT ->
    Legendre-weighted collective shell reduction (shot noise subtracted
    from P0).
    """
    def body(pos, weights):
        dev = _pos_device(pos)
        grid = paint_single(pos, ngrid, boxsize, weights=weights,
                            window=window)
        grid = _reduce_repencil(grid, mesh, PART_AXES)
        delta = _contrast(grid, _global_mean(grid, mesh, ngrid))
        dk = pfft3d_local(delta, mesh) / float(ngrid) ** 3
        ki, kj, kk = local_kvecs(ngrid, boxsize, mesh, device=dev)
        if window is not None:
            dk = dk * _local_compensation(ki, kj, kk, ngrid, boxsize,
                                          window)
        fi, fj, fk = local_mode_numbers(ngrid, mesh, device=dev)
        m2 = fi ** 2 + fj ** 2 + fk ** 2
        flos = (fi, fj, fk)[los]
        mu2 = torch.where(m2 == 0.0, torch.zeros_like(m2),
                          flos ** 2 / torch.clamp(m2, min=1e-12))
        m = torch.sqrt(m2)
        pk3d = (dk.abs() ** 2) * boxsize ** 3
        pk3d = torch.where(m == 0.0, torch.zeros_like(pk3d), pk3d)
        mu2 = mu2.expand_as(pk3d)
        m = m.expand_as(pk3d)
        kmean, p_ell, nm = local_multipole_average(
            pk3d, m, mu2, ngrid, boxsize, nbins, mesh, ells=ells)
        shot = _weighted_shotnoise(weights, boxsize, mesh, PART_AXES)
        noise = torch.stack([shot if ell == 0 else torch.zeros_like(shot)
                             for ell in ells])
        return MultipoleResult(kmean, p_ell - noise[:, None], nm)

    return _optional_weights(body, mesh)


def make_distributed_auto_power(mesh, ngrid: int, boxsize: float,
                                nbins: int, window: str = "cic",
                                batched: bool = False):
    """Distributed P(k) estimator over `mesh`.

    Returns fn(pos, weights=None) -> PowerResult, where pos is this rank's
    row block of a global (np, 3) point set split over all mesh axes (or,
    with batched=True, its (nsim/S, np/(PX*PY), 3) block of an (nsim, np,
    3) set split P('sim', ('x','y')), the result then carrying this rank's
    leading sim rows, as JAX's out_specs P('sim') give).
    """
    def body(pos, weights, part_axes):
        dev = _pos_device(pos)
        # 1. paint the local particle block on a full local grid
        grid = paint_single(pos, ngrid, boxsize, weights=weights,
                            window=window)
        # 2. reduce + re-pencil: full grid -> (n/PX, n/PY, n) block
        grid = _reduce_repencil(grid, mesh, part_axes)
        # 3. density contrast with the global mean
        delta = _contrast(grid, _global_mean(grid, mesh, ngrid))
        # 4. pencil FFT
        dk = pfft3d_local(delta, mesh) / float(ngrid) ** 3
        # 5. window compensation + shell binning
        ki, kj, kk = local_kvecs(ngrid, boxsize, mesh, device=dev)
        if window is not None:
            dk = dk * _local_compensation(ki, kj, kk, ngrid, boxsize,
                                          window)
        m = local_mode_radius(ngrid, mesh, device=dev).expand(dk.shape)
        pk3d = (dk.abs() ** 2) * boxsize ** 3
        # zero the DC mode (owned by the (0,0) rank's first entry)
        pk3d = torch.where(m == 0.0, torch.zeros_like(pk3d), pk3d)
        kmean, pmean, nm = local_shell_average(pk3d, m, ngrid, boxsize,
                                               nbins, mesh)
        shot = _weighted_shotnoise(weights, boxsize, mesh, part_axes)
        return PowerResult(kmean, pmean - shot, nm)

    if batched:
        # one simulation per 'sim' block; the result carries its sim rows
        def per_sim(pos, weights):
            res = [body(p, w, ("x", "y"))
                   for p, w in zip(pos.unbind(0), weights.unbind(0))]
            return PowerResult(*(torch.stack(f) for f in zip(*res)))

        return _optional_weights(per_sim, mesh)
    return _optional_weights(lambda p, w: body(p, w, PART_AXES), mesh)


def _deposit_route(deposit, device):
    """The fine deposit's route: None -> K1 (`deposit_flat`, its plain
    version on a CPU block); 'kernel' -> K1, CUDA blocks only; 'scatter'
    -> `index_add_`. The JAX spelling 'pallas' means 'kernel'."""
    deposit = port_spelling(deposit, {"pallas": "kernel"}, "deposit")
    if deposit not in (None, "kernel", "scatter"):
        raise ValueError(f"deposit must be None, 'kernel' ('pallas') or "
                         f"'scatter', got {deposit!r}")
    if deposit == "kernel" and device.type != "cuda":
        raise ValueError(f"deposit='kernel' needs a CUDA tensor, got "
                         f"{device}")
    return deposit


def fast_power_shard_body(pos, weights, *, mesh, ngrid: int,
                          boxsize: float, nbins: int, fine_factor: int,
                          deposit: Optional[str] = None,
                          return_coarse: bool = False):
    """Per-rank body of the distributed folded fine-NGP P(k) (see
    make_distributed_auto_power_fast for the algorithm).

    Module-level so composed pipelines (parallel/suite.py) reuse the exact
    estimator. With return_coarse the coarse (ngrid^3) NGP-count grid comes
    back as this rank's pencil block (n/PX, n/PY, n) — the P('x','y',None)
    layout the distributed bispectrum and pencil FFT consume — mirroring
    ops.power.auto_power_fast(return_coarse_grid=True).
    """
    px = axis_size(mesh, "x")
    py = axis_size(mesh, "y")
    ff = fine_factor
    nf = ngrid * ff
    n_cells = ff ** 3 * ngrid ** 3
    if isinstance(pos, (tuple, list)):
        x, y, z = pos  # flat component buffers
    else:
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dev = x.device
    route = _deposit_route(deposit, dev)
    inv_cell = nf / boxsize

    def cell(c):
        return torch.floor(c * inv_cell).to(torch.int32) % nf

    ux, uy, uz = cell(x), cell(y), cell(z)
    s_id = ((ux % ff) * ff + (uy % ff)) * ff + (uz % ff)
    flat = ((s_id * ngrid + ux // ff) * ngrid + uy // ff) * ngrid \
        + uz // ff
    w32 = weights.to(torch.float32)
    if route == "scatter":
        dep = torch.zeros(n_cells, dtype=torch.float32, device=dev)
        dep.index_add_(0, flat.long(), w32)
    else:
        dep = paint_cuda.deposit_flat(flat, w32, n_cells)
    total = psum(w32.sum(dtype=torch.float64), mesh, PART_AXES).to(
        torch.float32)
    dep = dep.reshape(ff ** 3, ngrid, ngrid, ngrid)
    # reduce the full local copies + re-pencil each subgrid
    dep = psum(dep, mesh, "sim")
    if px > 1:
        dep = psum_scatter(dep, mesh, "x", scatter_dimension=1)
    if py > 1:
        dep = psum_scatter(dep, mesh, "y", scatter_dimension=2)
    # fold: pencil FFT per subgrid, combined with decimation phases
    fi, fj, fk = local_mode_numbers(ngrid, mesh, device=dev)
    F = torch.zeros((ngrid, ngrid // px, ngrid // py), dtype=torch.complex64,
                    device=dev)
    for s in itertools.product(range(ff), repeat=3):
        sid = (s[0] * ff + s[1]) * ff + s[2]
        spec = pfft3d_local(dep[sid], mesh)
        ph = (-2.0 * math.pi / nf) * (fi * s[0] + fj * s[1] + fk * s[2])
        F += spec * torch.exp(1j * ph)
    dk = F / torch.where(total == 0, torch.ones_like(total), total)

    # NGP window deconvolution at the fine resolution
    def axis_win(m):
        u = m / nf
        return torch.where(u == 0.0, torch.ones_like(u), torch.sinc(u))

    dk = dk / (axis_win(fi) * axis_win(fj) * axis_win(fk))
    m = local_mode_radius(ngrid, mesh, device=dev).expand(dk.shape)
    pk3d = (dk.abs() ** 2) * boxsize ** 3
    pk3d = torch.where(m == 0.0, torch.zeros_like(pk3d), pk3d)
    kmean, pmean, nm = local_shell_average(pk3d, m, ngrid, boxsize, nbins,
                                           mesh)
    shot = _weighted_shotnoise(weights, boxsize, mesh, PART_AXES)
    res = PowerResult(kmean, pmean - shot, nm)
    if return_coarse:
        return res, dep.sum(0)
    return res


def make_distributed_auto_power_fast(mesh, ngrid: int, boxsize: float,
                                     nbins: int, fine_factor: int = 2,
                                     deposit: Optional[str] = None):
    """Distributed folded fine-NGP P(k): auto_power_fast over the mesh.

      1. each rank deposits its particle block into all fine_factor^3
         coarse subgrids locally (K1 on a CUDA block; `deposit="scatter"`
         asks for `index_add_`);
      2. psum over 'sim', then psum_scatter re-pencils each subgrid over
         ('x', 'y');
      3. the pencil FFT runs per subgrid and the decimation phases
         exp(-2*pi*i m.s/nf) fold them into the coarse-box fine spectrum;
      4. NGP window deconvolution at the fine resolution and the shell
         reduction (binning on |k|/kf, the local estimator's shell
         assignment) finish with a psum.

    Returns fn(pos, weights=None) -> PowerResult (replicated); pos this
    rank's (n, 3) row block or flat (x, y, z) components, weights (n,)
    co-sharded. nmodes may differ from ops.power.auto_power_fast by the
    z-Nyquist column double-count (hermitian storage counts it twice; the
    full-complex pencil once).
    """
    px = axis_size(mesh, "x")
    py = axis_size(mesh, "y")
    assert ngrid % px == 0 and ngrid % py == 0

    def body(pos, weights):
        return fast_power_shard_body(pos, weights, mesh=mesh, ngrid=ngrid,
                                     boxsize=boxsize, nbins=nbins,
                                     fine_factor=fine_factor,
                                     deposit=deposit)

    return _optional_weights(body, mesh)
