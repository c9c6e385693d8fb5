"""Two-point correlation functions: real-space, redshift-space s-mu,
multipoles and the projected wp(rp), by blocked pair counting with
periodic minimum image.

Port of astrild_tpu/ops/tpcf.py. Pair counts run as (B x B) tiles in a
Python loop over the upper-triangular tile pairs (the JAX package's scan
order), plain torch on every device: the JAX package has no TPU kernel for
them. A tile's counts are whole numbers below 2^24 (B <= 4095), so
`bincount` gives the JAX package's one-hot sums exactly, and the
Kahan-compensated float32 accumulation across tiles is the JAX package's
step for step: with the same `block` the counts are the same. The random
term is the analytic periodic-box expectation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_points, as_tensor
from .power import _legendre_even

__all__ = [
    "to_redshift_space", "pair_counts_s_mu", "tpcf_s_mu", "tpcf_real",
    "tpcf_multipoles", "pair_counts_rp_pi", "projected_tpcf",
]


def to_redshift_space(pos, vel, boxsize, los: int = 2, device=None):
    """Real -> redshift-space positions: s = x + v_los/(100) [Mpc/h].

    Velocity in km/s divided by 100 km/s/(Mpc/h) (aH at z=0 in h-units),
    periodic wrap. Numpy input goes to `device`, by default the CUDA card
    (it raises without one); tensors keep their device.
    """
    pos = as_tensor(pos, device)
    vel = as_tensor(vel, pos.device if device is None else device)
    # a tensor divisor: true division on the card too
    shift = vel[:, los] / torch.tensor(100.0, device=pos.device)
    pos_s = pos.clone()
    pos_s[:, los] = pos_s[:, los] + shift
    return pos_s % boxsize


def _min_image(d, box):
    return d - box * torch.round(d / box)


def _flat_comps(pos, device):
    """Flat float32 (x, y, z) of an (n, 3) array or a component tuple."""
    pos = as_points(pos, device)
    if isinstance(pos, tuple):
        return tuple(c.reshape(-1).to(torch.float32) for c in pos)
    pos = pos.to(torch.float32)
    return pos[:, 0], pos[:, 1], pos[:, 2]


def _padded(comps, block: int):
    n = comps[0].shape[0]
    pad = -(-n // block) * block - n
    return tuple(torch.cat([c, c.new_zeros(pad)]) for c in comps), n


def _check_halfbox(s_edges, boxsize):
    """The analytic periodic RR is only exact up to the half-box
    (min-image shells are cube-clipped beyond it)."""
    smax_edge = float(np.asarray(_host(s_edges))[-1])
    if smax_edge > float(boxsize) / 2.0 + 1e-9:
        raise ValueError(
            f"tpcf: s_edges[-1]={smax_edge} exceeds boxsize/2="
            f"{float(boxsize) / 2.0}; the analytic periodic RR is only "
            "exact up to the half-box (min-image shells are cube-clipped "
            "beyond it)")


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _s_mu_accumulate_tiles(pos_i, pos_j, ia0: int, jb0: int, s_edges,
                           ns: int, nmu: int, los: int, boxsize,
                           block: int = 512, n_valid_global=None,
                           valid_i=None, valid_j=None, dedup: bool = True,
                           triangular: bool = False, coords: str = "s_mu",
                           pi_max=None):
    """DD(s, mu) (or, with coords='rp_pi', DD(rp, |pi|)) over all pairs
    between two chunks of flat (x, y, z) components, each padded to a
    multiple of block. With coords='rp_pi', s_edges bin rp and the nmu
    bins split [0, pi_max) linearly.

    ia0 / jb0 are the chunks' global row offsets, as in the JAX package's
    accumulator: dedup=True counts a pair only when its global i < global
    j, dedup=False every (i, j) (a half-ring schedule's full-cross steps,
    parallel/tpcf.py); triangular=True skips the a > b tiles (a chunk
    against itself). Rows at and beyond n_valid_global form no pairs
    (padding at the global tail); valid_i / valid_j are per-row 0/1 masks
    (per-shard padding, the multihost striped loader).

    The per-bin accumulation is Kahan-compensated float32, as the JAX
    package's: plain float32 adds stop counting once a bin's total passes
    ~2^24 times the tile increments.
    """
    ni, nj = pos_i[0].shape[0], pos_j[0].shape[0]
    if ni % block or nj % block:
        raise ValueError("the components must be padded to a multiple of "
                         "block")
    dev = pos_i[0].device
    s_edges = s_edges.to(torch.float32)
    smin, smax = s_edges[0], s_edges[-1]
    box = torch.tensor(float(boxsize), dtype=torch.float32, device=dev)
    if coords == "rp_pi":
        pimax = torch.tensor(float(pi_max), dtype=torch.float32, device=dev)
    nbt = ns * nmu
    counts = torch.zeros(nbt, dtype=torch.float32, device=dev)
    comp = torch.zeros(nbt, dtype=torch.float32, device=dev)
    ar = torch.arange(block, device=dev)
    pairs = [(a, b) for a in range(ni // block) for b in range(nj // block)
             if not triangular or a <= b]
    for a, b in pairs:
        sa, sb = slice(a * block, (a + 1) * block), slice(
            b * block, (b + 1) * block)
        pi = torch.stack([c[sa] for c in pos_i], dim=-1)
        pj = torch.stack([c[sb] for c in pos_j], dim=-1)
        d = _min_image(pi[:, None, :] - pj[None, :, :], box)
        # ((dx^2 + dy^2) + dz^2) in float32, the JAX package's norm
        s = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                       + d[..., 2] * d[..., 2])
        spar = torch.abs(d[..., los])
        if coords == "rp_pi":
            rp = torch.sqrt(torch.clamp_min(s ** 2 - spar ** 2, 0.0))
            sep = rp
            # clamp before the int cast (the JAX package clips after)
            mubin = torch.clamp(spar / pimax * nmu, 0,
                                nmu - 1).to(torch.int64)
            mask = (rp >= smin) & (rp < smax) & (spar < pimax)
        else:
            sep = s
            mu = spar / torch.clamp_min(s, 1e-12)
            mubin = torch.clamp(mu * nmu, 0, nmu - 1).to(torch.int64)
            mask = (s >= smin) & (s < smax)
        sbin = torch.clamp(
            torch.searchsorted(s_edges, sep, right=True) - 1, 0, ns - 1)
        ia = ia0 + a * block + ar
        jb = jb0 + b * block + ar
        if dedup:
            mask = mask & (ia[:, None] < jb[None, :])
        if n_valid_global is not None:
            mask = (mask & (ia[:, None] < n_valid_global)
                    & (jb[None, :] < n_valid_global))
        if valid_i is not None:
            mask = mask & (valid_i[sa] > 0)[:, None] & (valid_j[sb] > 0)[None]
        flat = torch.where(mask, sbin * nmu + mubin, nbt)
        inc = torch.bincount(flat.reshape(-1),
                             minlength=nbt + 1)[:nbt].to(torch.float32)
        # Kahan step: the increment is exact (< 2^24)
        y = inc - comp
        t = counts + y
        comp = (t - counts) - y
        counts = t
    return counts


def pair_counts_s_mu(pos, boxsize, s_edges, ns: int, nmu: int = 20,
                     los: int = 2, n_valid=None, block: int = 512,
                     device=None):
    """DD(s, mu) pair counts (i<j) with periodic minimum image.

    mu = |s_parallel| / s along the `los` axis. pos is an (n, 3) array or
    a tuple of flat (x, y, z) components; numpy input goes to `device`,
    by default the CUDA card (it raises without one). Returns (ns, nmu)
    float32 counts.
    """
    comps = _flat_comps(pos, device)
    dev = comps[0].device
    comps, n = _padded(comps, block)
    n_valid = n if n_valid is None else n_valid
    counts = _s_mu_accumulate_tiles(comps, comps, 0, 0,
                                    as_tensor(s_edges, dev), ns, nmu, los,
                                    boxsize, block=block,
                                    n_valid_global=n_valid, triangular=True)
    return counts.reshape(ns, nmu)


def _n_points(pos, n_valid):
    if n_valid is not None:
        return n_valid
    return (pos[0].reshape(-1).shape[0] if isinstance(pos, (tuple, list))
            else pos.shape[0])


def tpcf_s_mu(pos, boxsize, s_edges, nmu: int = 20, los: int = 2,
              n_valid=None, block: int = 512, device=None):
    """Redshift-space xi(s, mu) with analytic periodic randoms.

    xi = DD/RR - 1, RR(s-bin, mu-bin) = Npairs * V_shell * dmu / V_box.
    Valid for s_edges[-1] <= boxsize/2 (raises beyond). Placement as in
    `pair_counts_s_mu`. Returns (s_centers, mu_centers, xi (ns, nmu)).
    """
    _check_halfbox(s_edges, boxsize)
    ns = int(np.asarray(_host(s_edges)).shape[0]) - 1
    n = _n_points(pos, n_valid)
    dd = pair_counts_s_mu(pos, boxsize, s_edges, ns, nmu=nmu, los=los,
                          n_valid=n_valid, block=block, device=device)
    s_edges = as_tensor(s_edges, dd.device)
    vshell = 4.0 / 3.0 * math.pi * (s_edges[1:] ** 3 - s_edges[:-1] ** 3)
    npairs = n * (n - 1) / 2.0
    rr = npairs * vshell[:, None] * (1.0 / nmu) / boxsize ** 3
    xi = torch.where(rr > 0, dd / rr.clamp_min(1e-30) - 1.0, torch.nan)
    s_centers = 0.5 * (s_edges[1:] + s_edges[:-1])
    mu_centers = (torch.arange(nmu, device=dd.device) + 0.5) / nmu
    return s_centers, mu_centers, xi


def tpcf_real(pos, boxsize, r_edges, n_valid=None, block: int = 512,
              device=None):
    """Real-space xi(r) (periodic natural estimator)."""
    s, _, xi = tpcf_s_mu(pos, boxsize, r_edges, nmu=1, n_valid=n_valid,
                         block=block, device=device)
    return s, xi[:, 0]


def tpcf_multipoles(xi_s_mu, ell: int, device=None):
    """xi_ell(s) = (2 ell + 1) * mean_mu [xi(s, mu) L_ell(mu)].

    mu is folded to [0, 1] (pair counts use |mu|), which is exact for even
    multipoles. Numpy input goes to `device`, by default the CUDA card.
    """
    xi_s_mu = as_tensor(xi_s_mu, device)
    nmu = xi_s_mu.shape[-1]
    mu = (torch.arange(nmu, device=xi_s_mu.device) + 0.5) / nmu
    w = _legendre_even(ell, mu ** 2)
    return (2 * ell + 1) * torch.mean(xi_s_mu * w[None, :], dim=-1)


def pair_counts_rp_pi(pos, boxsize, rp_edges, ns: int, n_pi: int,
                      pi_max, los: int = 2, n_valid=None,
                      block: int = 512, device=None):
    """DD(rp, |pi|) pair counts (i<j), periodic minimum image.

    rp is the transverse separation, pi the |LOS| separation binned
    linearly in [0, pi_max). Placement as in `pair_counts_s_mu`. Returns
    (ns, n_pi) float32 counts.
    """
    comps = _flat_comps(pos, device)
    dev = comps[0].device
    comps, n = _padded(comps, block)
    n_valid = n if n_valid is None else n_valid
    counts = _s_mu_accumulate_tiles(comps, comps, 0, 0,
                                    as_tensor(rp_edges, dev), ns, n_pi, los,
                                    boxsize, block=block,
                                    n_valid_global=n_valid, triangular=True,
                                    coords="rp_pi", pi_max=pi_max)
    return counts.reshape(ns, n_pi)


def _wp_from_counts(dd, n, rp_edges, pi_max, n_pi, boxsize):
    """Analytic cylindrical RR -> xi(rp, pi) -> wp."""
    dpi = pi_max / n_pi
    rp_edges = as_tensor(rp_edges, dd.device)
    area = math.pi * (rp_edges[1:] ** 2 - rp_edges[:-1] ** 2)
    npairs = n * (n - 1.0) / 2.0
    rr = npairs * area[:, None] * (2.0 * dpi) / boxsize ** 3
    xi = torch.where(rr > 0, dd / rr.clamp_min(1e-30) - 1.0, torch.nan)
    wp = 2.0 * torch.sum(xi * dpi, dim=1)
    rp_c = 0.5 * (rp_edges[1:] + rp_edges[:-1])
    return rp_c, wp, xi


def _check_halfbox_projected(rp_edges, pi_max, boxsize):
    rmax = float(np.sqrt(float(np.asarray(_host(rp_edges))[-1]) ** 2
                         + float(pi_max) ** 2))
    if rmax > float(boxsize) / 2.0 + 1e-9:
        raise ValueError(
            f"projected_tpcf: sqrt(rp_max^2+pi_max^2)={rmax} exceeds "
            f"boxsize/2={float(boxsize) / 2.0}")


def projected_tpcf(pos, boxsize, rp_edges, pi_max, n_pi: int = 40,
                   los: int = 2, n_valid=None, block: int = 512,
                   device=None):
    """Projected correlation function wp(rp) = 2 integral_0^pi_max
    xi(rp, pi) dpi (periodic natural estimator, analytic cylindrical RR).

    Valid while sqrt(rp_max^2 + pi_max^2) <= boxsize/2 (raises beyond).
    Placement as in `pair_counts_s_mu`.

    Returns (rp_centers, wp, xi_rp_pi (ns, n_pi)).
    """
    _check_halfbox_projected(rp_edges, pi_max, boxsize)
    ns = int(np.asarray(_host(rp_edges)).shape[0]) - 1
    n = _n_points(pos, n_valid)
    dd = pair_counts_rp_pi(pos, boxsize, rp_edges, ns, n_pi, pi_max,
                           los=los, n_valid=n_valid, block=block,
                           device=device)
    return _wp_from_counts(dd, n, rp_edges, pi_max, n_pi, boxsize)
