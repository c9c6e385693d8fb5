"""The z=0 analysis suite: P(k), B(k), Born kappa/gamma maps and voids.

Port of the four stages that bench.py times (`bench.py:53-119`):

  matter      folded fast P(k) of flat x/y/z positions (NGP keys on a
              2x-fine grid -> sorted CUDA deposit -> folded FFT -> shells),
              plus the coarse density grid;
  bispectrum  B(k1,k2,k3) over 4 shells of the coarse grid;
  lensing     density contrast -> interleaved slabs -> Born kappa -> linear
              resize to npix^2 -> gamma by one spectral spin-2 rotation;
  voids       peak catalog of kappa -> tunnels void finder.

`make_stages` returns a `run(pos)` callable with `run.stages`,
`run.per_stage(pos)` and `run.matter_detail(pos)`, as bench.py does.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from .ops import bispectrum, lensing, paint_cuda, peaks, power, voids

__all__ = ["make_stages", "uniform_positions", "PK_BINS", "BISPEC_BINS",
           "OPENING_ANGLE_RAD"]

PK_BINS = 64
FINE_FACTOR = 2
BISPEC_BINS = 4
BISPEC_M_MIN = 2.0
BISPEC_M_MAX = 32.0
CHI_NEAR, CHI_FAR, CHI_SOURCE = 200.0, 2800.0, 3000.0
OMEGA_M = 0.3089
OPENING_ANGLE_RAD = 0.35  # ~20 deg field of view
MAX_PEAKS = 2048
PEAK_EDGE_PIX = 8
MAX_VOIDS = 256


def uniform_positions(n_side: int, boxsize: float, device,
                      seed: int = 0) -> torch.Tensor:
    """Flat (3 * n_side^3,) float32 positions [x..., y..., z...], uniform
    in [0, boxsize), drawn on `device` from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(3 * n_side ** 3, generator=gen, device=device,
                      dtype=torch.float32) * boxsize


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_stages(n_side: int, ngrid: int, npix: int, boxsize: float,
                nplanes: int, device):
    """Build the suite's four stages for n_side^3 particles in a box of
    side `boxsize`, a ngrid^3 analysis grid, nplanes lens planes and
    npix^2 maps, on `device`."""
    if ngrid % nplanes:
        raise ValueError(f"ngrid={ngrid} must be a multiple of "
                         f"nplanes={nplanes}")
    n_part = n_side ** 3
    binning = power.get_fast_binning(ngrid, PK_BINS, FINE_FACTOR,
                                     device=device)

    def split(pos_flat):
        if pos_flat.shape != (3 * n_part,):
            raise ValueError(f"expected flat positions of shape "
                             f"({3 * n_part},), got {tuple(pos_flat.shape)}")
        return (pos_flat[:n_part], pos_flat[n_part:2 * n_part],
                pos_flat[2 * n_part:])

    def stage_matter(pos_flat):
        res, grid = power.auto_power_fast(split(pos_flat), ngrid, boxsize,
                                          nbins=PK_BINS,
                                          fine_factor=FINE_FACTOR,
                                          return_coarse_grid=True,
                                          binning=binning)
        return grid, res.power

    def stage_bispectrum(grid):
        return bispectrum.bispectrum_3d(grid, boxsize, nbins=BISPEC_BINS,
                                        m_min=BISPEC_M_MIN,
                                        m_max=BISPEC_M_MAX).b

    def stage_lensing(grid):
        delta = grid / grid.mean() - 1.0
        # interleaved slabs: plane p sums the grid planes p, p + nplanes, ...
        slabs = delta.reshape(ngrid // nplanes, nplanes, ngrid,
                              ngrid).sum(0)
        chis = torch.linspace(CHI_NEAR, CHI_FAR, nplanes, device=grid.device)
        dchis = torch.full((nplanes,), boxsize / nplanes, device=grid.device)
        # Born integration and resize are both linear, so integrating at
        # grid resolution and upsampling once equals upsampling every plane
        kappa_c = lensing.born_convergence(slabs, chis, dchis, CHI_SOURCE,
                                           OMEGA_M)
        kappa = F.interpolate(kappa_c[None, None], size=(npix, npix),
                              mode="bilinear", align_corners=False)[0, 0]
        g1, g2 = lensing.kappa_to_gamma(kappa, OPENING_ANGLE_RAD,
                                        padding_factor=2)
        return kappa, g1, g2

    def stage_voids(kappa):
        cat = peaks.find_peaks(kappa, threshold=kappa.std(correction=0),
                               max_peaks=MAX_PEAKS, edge_pix=PEAK_EDGE_PIX)
        vcat = voids.find_tunnels(cat.pos.to(torch.float32),
                                  cat.values > float("-inf"), npix,
                                  max_voids=MAX_VOIDS)
        return vcat.radius

    def run(pos_flat):
        grid, pk = stage_matter(pos_flat)
        b = stage_bispectrum(grid)
        kappa, g1, g2 = stage_lensing(grid)
        rad = stage_voids(kappa)
        return pk, b, kappa, g1, g2, rad

    def run_per_stage(pos_flat):
        """One pass with a device sync after each stage: {stage: seconds}."""
        stage_s = {}
        t0 = time.perf_counter()
        grid, pk = stage_matter(pos_flat)
        _sync(device)
        stage_s["matter"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stage_bispectrum(grid)
        _sync(device)
        stage_s["bispectrum"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kappa, _, _ = stage_lensing(grid)
        _sync(device)
        stage_s["lensing"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stage_voids(kappa)
        _sync(device)
        stage_s["voids"] = time.perf_counter() - t0
        return stage_s

    def matter_detail(pos_flat):
        """Sub-stage seconds of the matter stage {keygen, sort, deposit,
        fft_bin} through the same helpers `auto_power_fast` calls, plus
        which deposit ran. Each sub-stage is run once untimed first."""
        n_cells = FINE_FACTOR ** 3 * ngrid ** 3
        use_kernel = power.last_auto_deposit == "kernel"

        def keygen(p):
            return power._fast_keys(split(p), boxsize, ngrid=ngrid,
                                    fine_factor=FINE_FACTOR)

        def sort(k):
            return torch.sort(k, stable=False)[0]

        def deposit(k):
            if use_kernel:
                return paint_cuda.deposit_sorted(k, None, n_cells)
            return paint_cuda.deposit_sorted_reference(k, None, n_cells)

        def fft_bin(d):
            return power._fold_fft_bin(d, float(n_part),
                                       boxsize ** 3 / n_part, binning,
                                       boxsize, ngrid=ngrid,
                                       fine_factor=FINE_FACTOR,
                                       return_coarse_grid=False).power

        chain = [("keygen", keygen)]
        if use_kernel:  # the scatter path has no sort
            chain.append(("sort", sort))
        chain += [("deposit", deposit), ("fft_bin", fft_bin)]
        out = {"deposit_kind": "kernel" if use_kernel else "scatter"}
        x = pos_flat
        for name, fn in chain:
            fn(x)
            _sync(device)
            t0 = time.perf_counter()
            y = fn(x)
            _sync(device)
            out[name] = time.perf_counter() - t0
            x = y
        return out

    run.stages = {"matter": stage_matter, "bispectrum": stage_bispectrum,
                  "lensing": stage_lensing, "voids": stage_voids}
    run.per_stage = run_per_stage
    run.matter_detail = matter_detail
    run.binning = binning
    return run
