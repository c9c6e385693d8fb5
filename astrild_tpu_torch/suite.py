"""The z=0 analysis suite: P(k), B(k), Born kappa/gamma maps and voids.

Port of the four stages that bench.py times (`bench.py:53-119`):

  matter      folded fast P(k) of flat x/y/z positions (NGP keys on a
              2x-fine grid -> windowed CUDA deposit -> folded FFT -> shells),
              plus the coarse density grid;
  bispectrum  B(k1,k2,k3) over 4 shells of the coarse grid;
  lensing     density contrast -> interleaved slabs -> Born kappa -> linear
              resize to npix^2 -> gamma by one spectral spin-2 rotation;
  voids       peak catalog of kappa -> tunnels void finder.

`make_stages` returns a `run(pos)` callable with `run.stages`, as
bench.py does. A pass runs in the profiler span `suite.pass`, each stage
in `suite.<stage>`; `ops/power.py`, `ops/peaks.py` and `ops/voids.py`
open spans for the stages' parts, so a `torch.profiler` trace of passes
splits their device time by stage and part without a sync.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import bispectrum, lensing, peaks, power, voids

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


# named profiler spans (a few microseconds each when no profiler runs)
_span = torch.profiler.record_function


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
        with _span("suite.matter"):
            res, grid = power.auto_power_fast(split(pos_flat), ngrid,
                                              boxsize, nbins=PK_BINS,
                                              fine_factor=FINE_FACTOR,
                                              return_coarse_grid=True,
                                              binning=binning)
            return grid, res.power

    def stage_bispectrum(grid):
        with _span("suite.bispectrum"):
            return bispectrum.bispectrum_3d(grid, boxsize,
                                            nbins=BISPEC_BINS,
                                            m_min=BISPEC_M_MIN,
                                            m_max=BISPEC_M_MAX).b

    def stage_lensing(grid):
        with _span("suite.lensing"):
            delta = grid / grid.mean() - 1.0
            # interleaved slabs: plane p sums the grid planes p,
            # p + nplanes, ...
            slabs = delta.reshape(ngrid // nplanes, nplanes, ngrid,
                                  ngrid).sum(0)
            chis = torch.linspace(CHI_NEAR, CHI_FAR, nplanes,
                                  device=grid.device)
            dchis = torch.full((nplanes,), boxsize / nplanes,
                               device=grid.device)
            # Born integration and resize are both linear, so integrating
            # at grid resolution and upsampling once equals upsampling
            # every plane
            kappa_c = lensing.born_convergence(slabs, chis, dchis,
                                               CHI_SOURCE, OMEGA_M)
            kappa = F.interpolate(kappa_c[None, None], size=(npix, npix),
                                  mode="bilinear",
                                  align_corners=False)[0, 0]
            g1, g2 = lensing.kappa_to_gamma(kappa, OPENING_ANGLE_RAD,
                                            padding_factor=2)
            return kappa, g1, g2

    def stage_voids(kappa):
        with _span("suite.voids"):
            cat = peaks.find_peaks(kappa,
                                   threshold=kappa.std(correction=0),
                                   max_peaks=MAX_PEAKS,
                                   edge_pix=PEAK_EDGE_PIX)
            vcat = voids.find_tunnels(cat.pos.to(torch.float32),
                                      cat.values > float("-inf"), npix,
                                      max_voids=MAX_VOIDS)
            return vcat.radius

    def run(pos_flat):
        with _span("suite.pass"):
            grid, pk = stage_matter(pos_flat)
            b = stage_bispectrum(grid)
            kappa, g1, g2 = stage_lensing(grid)
            rad = stage_voids(kappa)
            return pk, b, kappa, g1, g2, rad

    run.stages = {"matter": stage_matter, "bispectrum": stage_bispectrum,
                  "lensing": stage_lensing, "voids": stage_voids}
    run.binning = binning
    return run
