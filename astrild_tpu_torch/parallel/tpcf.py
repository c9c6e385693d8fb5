"""Distributed two-point correlation functions: half-ring pair counts.

Port of astrild_tpu/parallel/tpcf.py: the half-ring schedule of
parallel/pairwise.py applied to the redshift-space xi(s, mu) estimator,
the projected wp(rp) and the catalog shear-shear xi_pm (ops/tpcf.py,
ops/shear_2pt.py). Each unordered pair of blocks is binned from one side,
the last hop of an even ring with the global i < j dedup; the per-bin
partial counts `psum` at the end. The tiles are the ops modules' plain
torch tiles in the JAX package's order; pair counts are whole numbers
with Kahan-compensated float32 sums, so the distributed counts equal the
single-device ones.

Each factory returns fn on this rank's block (numpy input goes to the
mesh's device); the results are replicated.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.shear_2pt import _shear_pair_tiles
from ..ops.tpcf import (_check_halfbox, _check_halfbox_projected, _host,
                        _s_mu_accumulate_tiles, _wp_from_counts)
from .mesh import axis_index, psum, to_mesh
from .pairwise import _owner, half_ring

__all__ = ["make_distributed_tpcf_s_mu", "make_distributed_projected_tpcf",
           "make_distributed_shear_xi"]


def _components(pos, mesh):
    """Flat float32 (x, y, z) of this rank's (n, 3) block or component
    tuple."""
    pos = to_mesh(pos, mesh)
    if isinstance(pos, tuple):
        return tuple(c.reshape(-1).to(torch.float32) for c in pos)
    pos = pos.to(torch.float32)
    return pos[:, 0], pos[:, 1], pos[:, 2]


def _check_mask(valid, with_valid_mask: bool) -> None:
    if (valid is not None) != with_valid_mask:
        # silently dropping a mask would count padding rows as real
        # particles (DD spikes at the pad positions' separations)
        raise ValueError(
            "valid mask mismatch: build the factory with "
            f"with_valid_mask={valid is not None} to "
            + ("use" if valid is not None else "omit") + " a mask")


def _make_counts_fn(mesh, boxsize, s_edges, ns, nmu, los, axis, block,
                    n_valid, coords="s_mu", pi_max=None):
    """Half-ring pair counts shared by the s-mu and (rp, pi) factories:
    fn(comps, valid) -> (counts (ns * nmu,), n_real), both replicated."""
    def fn(comps, valid):
        dev = comps[0].device
        nloc = comps[0].shape[0]
        me = axis_index(mesh, axis)
        edges = s_edges.to(dev)

        def count(visit, dedup, triangular=False):
            return _s_mu_accumulate_tiles(
                comps, visit[:3], me * nloc, int(visit[3]) * nloc, edges,
                ns, nmu, los, boxsize, block=block, n_valid_global=n_valid,
                valid_i=valid, valid_j=visit[4] if valid is not None
                else None, dedup=dedup, triangular=triangular,
                coords=coords, pi_max=pi_max)

        resident = comps + (_owner(mesh, axis, dev),) + (
            (valid,) if valid is not None else ())
        counts = psum(half_ring(mesh, axis, resident, count), mesh, axis)
        if valid is not None:
            n_real = psum((valid > 0).sum(), mesh, axis)
        elif n_valid is not None:
            n_real = torch.tensor(n_valid, device=dev)
        else:
            n_real = psum(torch.tensor(nloc, device=dev), mesh, axis)
        return counts, n_real

    return fn


def make_distributed_tpcf_s_mu(mesh, boxsize, s_edges, nmu: int = 20,
                               los: int = 2, axis: str = "sim",
                               block: int = 256,
                               n_valid: int | None = None,
                               with_valid_mask: bool = False):
    """Build fn(pos[, valid]) -> (s_centers, mu_centers, xi) over all
    global pairs.

    pos: this rank's (n_local, 3) block or a tuple of its flat (x, y, z)
    components (equal blocks, multiples of `block`). xi uses the analytic
    periodic RR of ops.tpcf.tpcf_s_mu with the global real-row count.
    Padding as in make_distributed_pairwise: n_valid (all padding at the
    global tail) or with_valid_mask=True (fn takes this rank's 0/1 row
    validity: the multihost loader's per-stripe padding).
    """
    _check_halfbox(s_edges, boxsize)
    s_edges = torch.as_tensor(np.asarray(_host(s_edges)),
                              dtype=torch.float32)
    ns = int(s_edges.shape[0]) - 1
    fn = _make_counts_fn(mesh, boxsize, s_edges, ns, nmu, los, axis, block,
                         n_valid)

    def tpcf(pos, valid=None):
        _check_mask(valid, with_valid_mask)
        comps = _components(pos, mesh)
        if valid is not None:
            valid = to_mesh(valid, mesh)
        counts, n_real = fn(comps, valid)
        dd = counts.reshape(ns, nmu)
        edges = s_edges.to(dd.device)
        n = n_real.to(torch.float32)
        vshell = 4.0 / 3.0 * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
        npairs = n * (n - 1.0) / 2.0
        rr = npairs * vshell[:, None] * (1.0 / nmu) / boxsize ** 3
        xi = torch.where(rr > 0, dd / rr.clamp_min(1e-30) - 1.0, torch.nan)
        s_centers = 0.5 * (edges[1:] + edges[:-1])
        mu_centers = (torch.arange(nmu, device=dd.device) + 0.5) / nmu
        return s_centers, mu_centers, xi

    return tpcf


def make_distributed_projected_tpcf(mesh, boxsize, rp_edges, pi_max,
                                    n_pi: int = 40, los: int = 2,
                                    axis: str = "sim", block: int = 256,
                                    n_valid: int | None = None,
                                    with_valid_mask: bool = False):
    """Distributed wp(rp): the half-ring schedule in (rp, |pi|) bins.

    The contract of make_distributed_tpcf_s_mu; returns fn(pos[, valid])
    -> (rp_centers, wp, xi_rp_pi), as ops.tpcf.projected_tpcf.
    """
    _check_halfbox_projected(rp_edges, pi_max, boxsize)
    rp_edges = torch.as_tensor(np.asarray(_host(rp_edges)),
                               dtype=torch.float32)
    ns = int(rp_edges.shape[0]) - 1
    fn = _make_counts_fn(mesh, boxsize, rp_edges, ns, n_pi, los, axis,
                         block, n_valid, coords="rp_pi", pi_max=pi_max)

    def wp_fn(pos, valid=None):
        _check_mask(valid, with_valid_mask)
        comps = _components(pos, mesh)
        if valid is not None:
            valid = to_mesh(valid, mesh)
        counts, n_real = fn(comps, valid)
        return _wp_from_counts(counts.reshape(ns, n_pi),
                               n_real.to(torch.float32),
                               rp_edges.to(counts.device), pi_max, n_pi,
                               boxsize)

    return wp_fn


def make_distributed_shear_xi(mesh, theta_edges, axis: str = "sim",
                              block: int = 256, boxsize=None):
    """Distributed catalog shear-shear correlation (ops.shear_2pt
    .xi_pm_catalog) on the half-ring schedule.

    Returns fn(x, y, e1, e2, weights=None) -> (xi_plus, xi_minus, npairs)
    over all global pairs; every input is this rank's flat block (equal
    blocks, nonzero multiples of `block`). Padding rows carry w = 0
    (zero-weight pairs are left out of every channel, npairs included).
    boxsize turns on the periodic minimum image.
    """
    edges = torch.as_tensor(np.asarray(_host(theta_edges)),
                            dtype=torch.float32)
    nbins = int(edges.shape[0]) - 1

    def shear_xi(x, y, e1, e2, weights=None):
        x = to_mesh(x, mesh).to(torch.float32)
        nloc = x.shape[0]
        if nloc % block or nloc < block:
            raise ValueError(
                f"make_distributed_shear_xi: per-shard chunks of {nloc} "
                f"rows; chunks must be nonzero multiples of block={block} "
                "- pad with zero-weight rows")
        cols = [x] + [to_mesh(v, mesh).to(torch.float32) for v in (y, e1, e2)]
        w = (torch.ones_like(x) if weights is None
             else to_mesh(weights, mesh).to(torch.float32))
        mine = tuple(cols) + (w,)
        me = axis_index(mesh, axis)
        ed = edges.to(x.device)

        def count(visit, dedup, triangular=False):
            return _shear_pair_tiles(*mine, *visit[:5], ed, nbins, boxsize,
                                     block, dedup, triangular=triangular,
                                     ia0=me * nloc,
                                     jb0=int(visit[5]) * nloc)

        sums = psum(half_ring(mesh, axis, mine + (_owner(mesh, axis,
                                                         x.device),),
                              count), mesh, axis)
        ww = sums[4].clamp_min(1e-30)
        return sums[0] / ww, sums[1] / ww, sums[5]

    return shear_xi
