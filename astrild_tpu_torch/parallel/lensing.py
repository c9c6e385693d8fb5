"""Distributed lensing: realizations over 'sim', particles and rays over
an axis.

Port of astrild_tpu/parallel/lensing.py.

* `make_distributed_lensing_suite` and `make_distributed_raytrace` run
  the per-realization pipelines (Born kappa -> shear -> peaks -> tunnel
  voids; post-Born multiplane ray tracing) on this rank's block of the
  realization array, split over 'sim'. No collective.
* `make_distributed_lens_planes` and `make_distributed_healpix_shells`
  paint this rank's particle block: the (plane, row, col) and (shell,
  pixel) keys go through the deposit K1 on a CUDA block (one launch a
  flush) and through its plain version on a CPU block; the counts `psum`
  over `axis` and are normalised by the global particle (or weight)
  total. The JAX package gates its deposit on TPU probes; the port
  chooses by the block's device. deposit="pallas" (the JAX spelling) and
  None take that route, "scatter" the scatter paths of the single-device
  functions.
* `make_distributed_multiplane_healpix` computes the shell fields
  replicated and traces this rank's block of the HEALPix ray grid, split
  over `axis`.

Sharded outputs are this rank's block (`mesh.unshard` assembles them);
replicated ones are the same on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lensing as lens_ops
from ..ops import peaks as peak_ops
from ..ops import raytrace as ray_ops
from ..ops import voids as void_ops
from ..utils import healpix as hpx
from .mesh import _axes, axis_index, axis_size, mesh_device, psum, to_mesh

__all__ = ["LensingSuiteResult", "make_distributed_lensing_suite",
           "make_distributed_multiplane_healpix",
           "make_distributed_healpix_shells", "make_distributed_raytrace",
           "make_distributed_lens_planes"]


class LensingSuiteResult(NamedTuple):
    kappa: torch.Tensor        # (nsim_local, npix, npix)
    gamma1: torch.Tensor       # (nsim_local, npix, npix)
    gamma2: torch.Tensor       # (nsim_local, npix, npix)
    void_radius: torch.Tensor  # (nsim_local, max_voids) [pixels]
    n_voids: torch.Tensor      # (nsim_local,)


def _vec(v, dev):
    return torch.as_tensor(np.asarray(v.detach().cpu() if isinstance(
        v, torch.Tensor) else v, np.float32), device=dev)


def make_distributed_lensing_suite(mesh, npix: int, opening_angle_rad: float,
                                   chi_s: float, omega_m: float,
                                   max_peaks: int = 1024,
                                   max_voids: int = 128,
                                   padding_factor: int = 2):
    """The per-realization lensing + voids pipeline over 'sim'.

    Returns fn(planes, chis, dchis): planes this rank's (nsim_local,
    nplane, npix, npix) block of density-contrast lens planes; chis /
    dchis the (nplane,) distances and thicknesses. Returns this rank's
    LensingSuiteResult block.
    """
    def one_sim(planes, chis, dchis):
        kappa = lens_ops.born_convergence(planes, chis, dchis, chi_s,
                                          omega_m)
        a1, a2 = lens_ops.kappa_to_alpha(kappa, opening_angle_rad,
                                         padding_factor=padding_factor)
        g1, g2 = lens_ops.alpha_to_gamma(a1, a2, opening_angle_rad)
        cat = peak_ops.find_peaks(kappa, threshold=kappa.std(correction=0),
                                  max_peaks=max_peaks, edge_pix=4)
        vcat = void_ops.find_tunnels(cat.pos.to(torch.float32),
                                     cat.values > float("-inf"), npix,
                                     max_voids=max_voids)
        return (kappa, g1, g2, vcat.radius, vcat.n.to(torch.int32))

    def fn(planes, chis, dchis):
        planes = to_mesh(planes, mesh)
        chis, dchis = _vec(chis, planes.device), _vec(dchis, planes.device)
        runs = [one_sim(p, chis, dchis) for p in planes]
        return LensingSuiteResult(*(torch.stack(f) for f in zip(*runs)))

    return fn


def make_distributed_raytrace(mesh, chi_s: float, omega_m: float,
                              opening_angle_rad: float, n_rays=None,
                              padding_factor: int = 1):
    """Post-Born multiplane ray tracing over 'sim': fn(planes, chis, dchis)
    with planes this rank's (nsim_local, nplane, npix, npix) block; returns
    the dict of ops.raytrace.multiplane_raytrace with a leading
    (nsim_local,) axis on each map. No collective."""
    def fn(planes, chis, dchis):
        planes = to_mesh(planes, mesh)
        chis, dchis = _vec(chis, planes.device), _vec(dchis, planes.device)
        runs = [ray_ops.multiplane_raytrace(
            p, chis, dchis, chi_s, omega_m, opening_angle_rad,
            n_rays=n_rays, padding_factor=padding_factor) for p in planes]
        return {k: torch.stack([r[k] for r in runs]) for k in runs[0]}

    return fn


def _route(deposit) -> bool:
    """True for the deposit route (K1 on a CUDA block, its plain version on
    a CPU block), False for the scatter paths."""
    if deposit not in (None, "pallas", "scatter"):
        raise ValueError(f"deposit must be 'pallas' or 'scatter', "
                         f"got {deposit!r}")
    return deposit != "scatter"


def _global_total(comps, valid, mesh, axis) -> float:
    """The particle (or weight) total over all ranks of `axis`, a host
    float as the single-device functions take it."""
    n_loc = (valid.to(torch.float64).sum() if valid is not None
             else torch.tensor(float(comps[0].shape[0]), dtype=torch.float64,
                               device=comps[0].device))
    return float(psum(n_loc, mesh, axis))


def make_distributed_lens_planes(mesh, boxsize, chi0, dchi, nplanes: int,
                                 fov, npix: int, los: int = 2,
                                 observer_xy=None, axis="sim",
                                 with_valid_mask: bool = False,
                                 deposit: str | None = None):
    """Particle-sharded lens-plane painting: fn(pos[, valid]) -> (delta
    (nplanes, npix, npix), chis), replicated.

    pos: this rank's (x, y, z) flat component blocks of the particles
    split over `axis` (a name or a tuple of names; the multihost loader's
    layout). Each rank paints raw per-plane counts from its block; the
    counts psum over `axis` and are normalised with the global particle
    (or weight) total. with_valid_mask=True: fn takes this rank's 0/1 row
    validity (multihost padding rows sit at position zero and would paint
    into whichever plane's slab wraps over z = 0).
    """
    from ..ops import lens_planes as lp

    n_rep, _, _ = lp.replica_ranges(boxsize, chi0, dchi, nplanes, fov)
    path = lp._plane_counts_deposit if _route(deposit) \
        else lp._plane_counts_scan
    axes = _axes(axis)

    def fn(pos, valid=None):
        if (valid is not None) != with_valid_mask:
            raise ValueError("valid mask mismatch: build the factory with "
                             f"with_valid_mask={valid is not None}")
        comps = lp._split_components(to_mesh(pos, mesh), los)
        if valid is not None:
            valid = to_mesh(valid, mesh).to(torch.float32)
        counts, chis = path(comps, boxsize, chi0, dchi, nplanes, fov, npix,
                            2, observer_xy, n_rep, weights=valid)
        counts = psum(counts, mesh, axes)
        n_tot = _global_total(comps, valid, mesh, axes)
        return lp._normalize_counts(counts, chis, n_tot, boxsize, dchi, fov,
                                    npix), chis

    return fn


def make_distributed_healpix_shells(mesh, chi_edges, nside: int, boxsize,
                                    observer=None, axis="sim",
                                    with_valid_mask: bool = False,
                                    deposit: str | None = None):
    """Particle-sharded full-sky lightcone shells: fn(pos[, valid]) ->
    delta (nshell, npix) HEALPix density contrast, replicated.

    The curved-sky counterpart of make_distributed_lens_planes: each rank
    deposits its block's (shell, pixel) counts
    (ops.lightcone_sphere.shell_counts_healpix: K1 on a CUDA block), the
    counts psum over `axis`, and the overdensity uses the global particle
    (or weight) total. pos: this rank's (x, y, z) flat blocks;
    with_valid_mask=True takes its 0/1 row validity (multihost padding rows
    would otherwise land in the shell holding the observer-to-origin
    distance).
    """
    from ..ops import lightcone_sphere as lcs

    route = None if _route(deposit) else "scatter"
    chi_edges = np.asarray(chi_edges, np.float64)
    axes = _axes(axis)

    def fn(pos, valid=None):
        if (valid is not None) != with_valid_mask:
            raise ValueError("valid mask mismatch: build the factory with "
                             f"with_valid_mask={valid is not None}")
        comps = lcs._components(to_mesh(pos, mesh))
        if valid is not None:
            valid = to_mesh(valid, mesh).to(torch.float32)
        counts = lcs.shell_counts_healpix(comps, chi_edges, nside, boxsize,
                                          observer=observer, weights=valid,
                                          deposit=route)
        counts = psum(counts, mesh, axes)
        n_tot = _global_total(comps, valid, mesh, axes)
        return lcs.shell_overdensity(counts, chi_edges, n_tot, boxsize)

    return fn


def make_distributed_multiplane_healpix(mesh, nside: int, omega_m: float,
                                        lmax: int | None = None,
                                        method: str = "auto",
                                        axis: str = "x"):
    """Ray-sharded curved-sky post-Born tracer: fn(delta_shells, chis,
    dchis, chi_s[, scale_factors]) -> dict of this rank's (npix / P,) ray
    blocks (P the size of `axis`; `mesh.unshard` with spec (axis,)
    assembles the (npix,) maps).

    The per-shell potential fields (the SHTs, on the table or scan backend
    as ops.lightcone_sphere.multiplane_raytrace_healpix chooses) are
    computed replicated on every rank; the ray transport, independent per
    ray, runs on this rank's block of the HEALPix ray grid. The stencil
    memory (32 B a ray a shell) divides by the axis size.
    """
    from ..ops import lightcone_sphere as lcs

    dev = mesh_device(mesh)
    L = 2 * nside if lmax is None else int(lmax)
    tabs, use_scan = lcs._multiplane_tabs(nside, L, method, dev)
    npix = hpx.nside2npix(nside)
    nproc = axis_size(mesh, axis)
    if npix % nproc:
        raise ValueError(f"{npix} rays do not split over {nproc} ranks")
    per = npix // nproc
    lo = axis_index(mesh, axis) * per
    t0, p0 = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
              for a in hpx.pix2ang_ring(nside, np.arange(lo, lo + per)))

    def run(delta_shells, chis, dchis, chi_s, scale_factors=None):
        if np.ndim(chi_s.detach().cpu() if isinstance(chi_s, torch.Tensor)
                   else chi_s) > 0:
            raise ValueError(
                "make_distributed_multiplane_healpix supports a scalar "
                "chi_s only; call once per source plane for tomography")
        delta_shells = to_mesh(delta_shells, mesh).to(torch.float32)
        chis = _vec(chis, dev)
        scale_factors = (torch.ones_like(chis) if scale_factors is None
                         else _vec(scale_factors, dev))
        return lcs._multiplane_impl(delta_shells, chis, _vec(dchis, dev),
                                    _vec(chi_s, dev), omega_m,
                                    scale_factors, t0, p0, tabs, nside, L,
                                    scan_path=use_scan)

    return run
