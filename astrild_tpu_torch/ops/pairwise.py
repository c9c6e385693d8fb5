"""Blocked O(N^2) pairwise-velocity estimators.

Port of astrild_tpu/ops/pairwise.py. The plain version processes pairs in
(B x B) tiles (a Python loop over the upper-triangular tile pairs) and
reduces each tile into distance bins with `binred.masked_bin_reduce`; on a
CUDA tensor `mean_pairwise_velocity` (and `mean_pv_from_tv` through it)
runs the pair-tile kernel K3 (`pairwise_cuda.pairwise_accumulate`)
instead. The pairwise-velocity PDF and the kSZ estimator are plain torch
tiles on every device, as they are XLA tiles in the JAX package.

Estimator (Yasini et al. 2018, arxiv:1812.04241 Eq. 6):
  v12(r) = sum_pairs (v_i - v_j) . q_ij / sum_pairs |q_ij|^2
  q_ij = [2 rhat_ij - phat_i (rhat_ij.phat_i) - phat_j (rhat_ij.phat_j)] / 2
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from .._options import port_spelling
from ..utils.geometry import angular_coordinate_in_lc, convert_vec_sph_to_cart
from . import pairwise_cuda
from .binred import masked_bin_reduce

__all__ = ["mean_pairwise_velocity", "mean_pv_from_tv", "make_rsep",
           "make_rsep_uneven_bins", "pairwise_velocity_pdf",
           "pairwise_ksz_momentum"]


def make_rsep(binnr: int, binwidth: float, device=None):
    """Histogram bin centers (reference mean_pairwise_velocity.py:176-196)."""
    return (torch.linspace(0.0, (binnr - 1) * binwidth, binnr, device=device)
            + binwidth / 2.0)


def make_rsep_uneven_bins(bin_edges, device=None):
    """Centers of arbitrary bin edges (mean_pairwise_velocity.py:198-203)."""
    bin_edges = torch.as_tensor(np.asarray(bin_edges), dtype=torch.float32,
                                device=device)
    return 0.5 * (bin_edges[1:] + bin_edges[:-1])


def _pad_blocks(arr, block: int):
    n = arr.shape[0]
    nb = (n + block - 1) // block
    pad = arr.new_zeros((nb * block - n,) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad]), nb


def _uniform_bins(dist, width, nbins: int):
    """Bin b of [b w, (b + 1) w) for each distance; distances at or beyond
    nbins * w (and NaN) go to the drop bin nbins. The float -> int cast
    only sees values below nbins."""
    t = dist / width
    keep = t < nbins
    return torch.where(keep, torch.where(keep, t, 0.0).to(torch.int64),
                       nbins)


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis of broadcastable (..., 3)
    tensors: elementwise products and sums, so a caller's TF32 setting
    cannot reach them as it reaches an einsum's matrix product."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _pairwise_accumulate(pos, vel, n_valid, binnr: int, binwidth,
                         block: int = 512, edges=None):
    """Accumulate Yasini Eq. 6 numerator/denominator over all pairs i<j.

    edges=None bins by uniform binwidth (bin b covers [b*w, (b+1)*w));
    with a (binnr+1,) edges tensor pairs bin by searchsorted into the
    half-open intervals [edges[b], edges[b+1]). Rows at and beyond n_valid
    form no pairs. The float -> int bin cast is guarded: separations at or
    beyond binnr * binwidth go to the drop bin before the cast.
    """
    posp, nb = _pad_blocks(torch.as_tensor(pos).to(torch.float32), block)
    velp, _ = _pad_blocks(torch.as_tensor(vel).to(torch.float32), block)
    dev = posp.device
    pnorm = torch.linalg.vector_norm(posp, dim=1, keepdim=True)
    phat = posp / pnorm.clamp_min(1e-12)
    # the tiles' sums accumulate in float64, as the kernel's blocks do
    nom = torch.zeros(binnr, dtype=torch.float64, device=dev)
    den = torch.zeros(binnr, dtype=torch.float64, device=dev)
    # a tensor divisor: true division, where a Python scalar divisor may be
    # turned into a multiplication by its reciprocal on the card
    width = torch.tensor(binwidth, dtype=torch.float32, device=dev)
    ar = torch.arange(block, device=dev)
    for a in range(nb):
        for b in range(a, nb):
            ia = a * block + ar
            jb = b * block + ar
            sa, sb = slice(a * block, (a + 1) * block), slice(
                b * block, (b + 1) * block)
            pi, pj = posp[sa], posp[sb]
            hi, hj = phat[sa], phat[sb]
            rij = pi[:, None, :] - pj[None, :, :]              # (B, B, 3)
            # (x^2 + y^2) + z^2 in separate ops, rounded as the kernel does
            r2 = rij[..., 0] * rij[..., 0] + rij[..., 1] * rij[..., 1]
            rnorm = torch.sqrt(r2 + rij[..., 2] * rij[..., 2])
            rhat = rij / rnorm.clamp_min(1e-12)[..., None]
            di = _dot3(rhat, hi[:, None, :])
            dj = _dot3(rhat, hj[None, :, :])
            q = (2.0 * rhat - hi[:, None, :] * di[..., None]
                 - hj[None, :, :] * dj[..., None]) * 0.5       # (B, B, 3)
            vij = velp[sa][:, None, :] - velp[sb][None, :, :]
            nom_ij = (vij * q).sum(-1)
            den_ij = (q * q).sum(-1)
            mask = ((ia[:, None] < jb[None, :])
                    & (ia[:, None] < n_valid) & (jb[None, :] < n_valid))
            if edges is None:
                binidx = _uniform_bins(rnorm, width, binnr)
            else:
                binidx = torch.searchsorted(edges, rnorm, right=True) - 1
                binidx = torch.where(
                    (rnorm >= edges[0]) & (binidx >= 0) & (binidx < binnr),
                    binidx, binnr)
            w = mask.to(torch.float32).reshape(-1)
            bflat = torch.where(mask, binidx, binnr).reshape(-1)
            inc = masked_bin_reduce(
                torch.stack([w * nom_ij.reshape(-1), w * den_ij.reshape(-1)]),
                bflat, binnr)
            nom += inc[0]
            den += inc[1]
    return nom.to(torch.float32), den.to(torch.float32)


def _resolve_backend(backend: str, device) -> bool:
    """True if the kernel runs: 'auto' takes it on a CUDA tensor and the
    plain tiles on the CPU; 'kernel' on a CPU tensor raises. The JAX
    package's 'pallas' and 'xla' mean 'kernel' and 'plain'."""
    backend = port_spelling(backend, {"pallas": "kernel", "xla": "plain"},
                            "backend")
    if backend == "auto":
        return device.type == "cuda"
    if backend == "kernel":
        if device.type != "cuda":
            raise ValueError(f"backend='kernel' needs a CUDA tensor, got "
                             f"{device}")
        return True
    if backend == "plain":
        return False
    raise ValueError(f"backend must be 'auto', 'kernel' ('pallas') or "
                     f"'plain' ('xla'), got {backend!r}")


def mean_pairwise_velocity(pos_cart, vel_cart, bins, n_valid=None,
                           block: int = 512, backend: str = "auto",
                           device=None):
    """Mean pairwise velocity estimate from cartesian velocities.

    Args:
      pos_cart: (n, 3) positions [Mpc/h] (lightcone frame, observer at 0).
        A tensor stays on its device unless `device` is given; numpy input
        goes to `device`, by default the CUDA card (it raises without one:
        pass device="cpu" to run on the CPU).
      vel_cart: (n, 3) velocities [km/s], placed as pos_cart.
      bins: (binnr,) distance bin edges starting at 0 with uniform width
        (reference make_rsep convention), OR arbitrary ascending edges —
        non-uniform spacing (or a nonzero first edge) bins pairs into the
        half-open intervals [bins[b], bins[b+1]) (len(bins)-1 bins).
      n_valid: number of valid rows (for padded catalogs).
      backend: 'auto' (the pair-tile kernel K3 on a CUDA tensor, the plain
        tiles on the CPU), 'kernel' (CUDA tensors and uniform bins only)
        or 'plain'; the JAX package's 'pallas' and 'xla' mean 'kernel' and
        'plain'. Uneven edges take the plain searchsorted path under
        'auto'; 'kernel' raises on them.

    Returns (rsep, v12): bin centers and the estimate (NaN on empty bins).
    """
    pos_cart = as_tensor(pos_cart, device)
    # numpy velocities follow the positions
    vel_cart = as_tensor(vel_cart, device if isinstance(vel_cart, torch.Tensor)
                         else pos_cart.device)
    dev = pos_cart.device
    bins_np = (bins.detach().cpu().numpy() if isinstance(bins, torch.Tensor)
               else np.asarray(bins))
    edges_np = bins_np.astype(np.float64)
    diffs = np.diff(edges_np)
    if diffs.size and np.any(diffs <= 0):
        raise ValueError("bins must be strictly ascending")
    use_kernel = _resolve_backend(backend, dev)
    n = pos_cart.shape[0] if n_valid is None else int(n_valid)
    if diffs.size and (not np.allclose(diffs, diffs[0], rtol=1e-5, atol=1e-8)
                       or edges_np[0] != 0.0):
        if backend in ("kernel", "pallas"):
            raise ValueError("backend='kernel' needs uniform bins starting "
                             "at 0; uneven edges take the plain path "
                             "(backend='auto' or 'plain')")
        binnr = edges_np.size - 1
        edges = torch.as_tensor(edges_np, dtype=torch.float32, device=dev)
        nom, den = _pairwise_accumulate(pos_cart, vel_cart, n, binnr, 0.0,
                                        block=block, edges=edges)
        v12 = torch.where(den > 0, nom / den.clamp_min(1e-30),
                          torch.nan)
        return make_rsep_uneven_bins(edges_np, device=dev), v12
    binnr = int(bins_np.shape[0])
    binwidth = float(bins_np[1] - bins_np[0])
    if use_kernel:
        nom, den = pairwise_cuda.pairwise_accumulate(pos_cart, vel_cart, n,
                                                     binwidth, binnr)
    else:
        nom, den = _pairwise_accumulate(pos_cart, vel_cart, n, binnr,
                                        binwidth, block=block)
    v12 = torch.where(den > 0, nom / den.clamp_min(1e-30), torch.nan)
    return make_rsep(binnr, binwidth, device=dev), v12


def pairwise_velocity_pdf(pos, vel, dist_bin: int, vel_bin: int,
                          mode: str = "radial", n_valid=None,
                          block: int = 512, device=None):
    """2D (separation, pairwise-velocity) histogram over all pairs i<j.

    Blocked-tile port of the Cython kernels
    (particles/utils_cython/pairwise_velocity.pyx:194-313):
      mode='z_sign' : v12 = (v2z - v1z) * sign(r2z - r1z)
      mode='radial' : v12 = (v2 - v1) . (r2 - r1) / |r12|
    Bin sizes are 1 Mpc/h in distance and 1 km/s in velocity with the
    velocity axis offset by vel_bin/2 (the reference's convention): a pair
    lands in distance bin int(|r12|) and velocity bin floor(v12 + offset),
    so v12 + offset in (-1, 0) is rejected. Both bin tests are made on the
    float values, before the int cast.

    pos, vel: (n, 3); a tensor stays on its device unless `device` is
    given, numpy input goes to `device`, by default the CUDA card (it
    raises without one: pass device="cpu"). Plain torch tiles on every
    device. Returns (dist_bin, vel_bin) float32 pair counts.
    """
    pos = as_tensor(pos, device)
    vel = as_tensor(vel, device if isinstance(vel, torch.Tensor)
                    else pos.device)
    n = pos.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    posp, nb = _pad_blocks(pos.to(torch.float32), block)
    velp, _ = _pad_blocks(vel.to(torch.float32).to(pos.device), block)
    dev = posp.device
    offset = vel_bin // 2
    nbinstot = dist_bin * vel_bin
    counts = torch.zeros(nbinstot, dtype=torch.float32, device=dev)
    ar = torch.arange(block, device=dev)
    for a in range(nb):
        for b in range(a, nb):
            ia = a * block + ar
            jb = b * block + ar
            sa, sb = slice(a * block, (a + 1) * block), slice(
                b * block, (b + 1) * block)
            rij = posp[sb][None, :, :] - posp[sa][:, None, :]
            dist = torch.sqrt(rij[..., 0] * rij[..., 0]
                              + rij[..., 1] * rij[..., 1]
                              + rij[..., 2] * rij[..., 2])
            dv = velp[sb][None, :, :] - velp[sa][:, None, :]
            if mode == "z_sign":
                v12 = dv[..., 2] * torch.sign(rij[..., 2])
            else:
                v12 = (dv[..., 0] * rij[..., 0] + dv[..., 1] * rij[..., 1]
                       + dv[..., 2] * rij[..., 2]) / dist.clamp_min(1e-12)
            vfl = torch.floor(v12 + offset)
            ok = ((ia[:, None] < jb[None, :])
                  & (ia[:, None] < n_valid) & (jb[None, :] < n_valid)
                  & (dist < dist_bin) & (vfl >= 0) & (vfl < vel_bin))
            db = torch.where(ok, dist, 0.0).to(torch.int64)
            vb = torch.where(ok, vfl, 0.0).to(torch.int64)
            flat = torch.where(ok, db * vel_bin + vb, nbinstot)
            inc = torch.bincount(flat.reshape(-1), minlength=nbinstot + 1)
            counts = counts + inc[:nbinstot].to(torch.float32)
    return counts.reshape(dist_bin, vel_bin)


def _pairwise_accumulate_tiles(pos_i, vel_i, hat_i, pos_j, vel_j, hat_j,
                               ia0: int, jb0: int, nbins: int, binwidth,
                               block: int = 256, n_valid_global=None,
                               valid_i=None, valid_j=None,
                               dedup: bool = True, triangular: bool = False,
                               kind: str = "yasini"):
    """Yasini (or kSZ) sums over all pairs between two chunks, the JAX
    package's tile accumulator: (B x B) tiles in its scan order, float32
    sums tile by tile.

    kind='yasini': the v12 numerator and denominator (Eq. 6 weights).
    kind='ksz': the Hand+12 estimator: vel_* column 0 carries dT, nom =
    (dT_i - dT_j) c_ij, den = c_ij^2, c_ij = rhat_ij.(hat_i + hat_j)/2.
    Both are i <-> j symmetric, so the half-ring schedule's full-cross
    steps (dedup=False) count each unordered pair once.

    ia0 / jb0 are the chunks' global row offsets: dedup=True counts a pair
    only when its global i < global j (a ring's self and last steps),
    dedup=False every (i, j). triangular=True skips the a > b tiles (the
    self pairs, where i < j masks them whole). Padding: rows at and beyond
    n_valid_global form no pairs (padding at the global tail only), or
    per-row 0/1 masks valid_i / valid_j (per-shard padding, the multihost
    striped loader). Chunk lengths must be multiples of `block`.
    """
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    if ni % block or nj % block:
        raise ValueError("chunk sizes must be multiples of block (pad "
                         "before sharding)")
    dev = pos_i.device
    nom = torch.zeros(nbins, dtype=torch.float32, device=dev)
    den = torch.zeros(nbins, dtype=torch.float32, device=dev)
    # a tensor divisor: true division, where a Python scalar divisor may be
    # turned into a multiplication by its reciprocal on the card
    width = torch.tensor(binwidth, dtype=torch.float32, device=dev)
    ar = torch.arange(block, device=dev)
    pairs = [(a, b) for a in range(ni // block) for b in range(nj // block)
             if not triangular or a <= b]
    for a, b in pairs:
        sa, sb = slice(a * block, (a + 1) * block), slice(
            b * block, (b + 1) * block)
        hi, hj = hat_i[sa], hat_j[sb]
        rij = pos_i[sa][:, None, :] - pos_j[sb][None, :, :]    # (B, B, 3)
        rnorm = torch.sqrt(rij[..., 0] * rij[..., 0]
                           + rij[..., 1] * rij[..., 1]
                           + rij[..., 2] * rij[..., 2])
        rhat = rij / rnorm.clamp_min(1e-12)[..., None]
        di = _dot3(rhat, hi[:, None, :])
        dj = _dot3(rhat, hj[None, :, :])
        if kind == "ksz":
            cij = 0.5 * (di + dj)
            nom_ij = (vel_i[sa][:, 0][:, None] - vel_j[sb][:, 0][None, :]) \
                * cij
            den_ij = cij * cij
        else:
            q = (2.0 * rhat - hi[:, None, :] * di[..., None]
                 - hj[None, :, :] * dj[..., None]) * 0.5
            vij = vel_i[sa][:, None, :] - vel_j[sb][None, :, :]
            nom_ij = _dot3(vij, q)
            den_ij = _dot3(q, q)
        ia = ia0 + a * block + ar
        jb = jb0 + b * block + ar
        mask = (ia[:, None] < jb[None, :]) if dedup else torch.ones(
            (block, block), dtype=torch.bool, device=dev)
        if n_valid_global is not None:
            mask = (mask & (ia[:, None] < n_valid_global)
                    & (jb[None, :] < n_valid_global))
        if valid_i is not None:
            mask = mask & (valid_i[sa] > 0)[:, None] & (valid_j[sb] > 0)[None]
        w = mask.to(torch.float32).reshape(-1)
        bflat = torch.where(mask, _uniform_bins(rnorm, width, nbins),
                            nbins).reshape(-1)
        inc = masked_bin_reduce(
            torch.stack([w * nom_ij.reshape(-1), w * den_ij.reshape(-1)]),
            bflat, nbins)
        nom = nom + inc[0]
        den = den + inc[1]
    return nom, den


def _ksz_accumulate(pos, dT, n_valid, binnr: int, binwidth,
                    block: int = 512):
    """kSZ numerator and denominator over all pairs i < j < n_valid: the
    shared tile accumulator with kind='ksz' on the catalog against itself,
    in bins of uniform width (dropped at or beyond binnr * binwidth)."""
    posp, _ = _pad_blocks(pos.to(torch.float32), block)
    dTp, _ = _pad_blocks(dT.to(torch.float32).to(posp.device), block)
    pnorm = torch.linalg.vector_norm(posp, dim=1, keepdim=True)
    phat = posp / pnorm.clamp_min(1e-12)
    velp = torch.stack([dTp, torch.zeros_like(dTp), torch.zeros_like(dTp)],
                       dim=1)
    return _pairwise_accumulate_tiles(posp, velp, phat, posp, velp, phat, 0,
                                      0, binnr, binwidth, block,
                                      n_valid_global=n_valid, dedup=True,
                                      triangular=True, kind="ksz")


def pairwise_ksz_momentum(pos_cart, dT, bins, n_valid=None,
                          block: int = 512, device=None):
    """kSZ pairwise momentum estimator (Hand et al. 2012, arXiv:1203.4219
    Eq. 2; Ferreira et al. 1999):

        p_hat(r) = sum_pairs (dT_i - dT_j) c_ij / sum_pairs c_ij^2
        c_ij     = rhat_ij . (rhat_i + rhat_j) / 2

    With kSZ temperatures dT_i = -T0 v_i.rhat_i, p_hat(r) -> -T0 v12(r):
    gravitational infall (v12 < 0) gives p_hat > 0.

    Args:
      pos_cart: (n, 3) comoving positions, observer at the origin; placed
        as in `pairwise_velocity_pdf`.
      dT: (n,) temperature offsets at the cluster positions [any unit].
      bins: distance bin edges starting at 0 with uniform width.

    Plain torch tiles on every device. Returns (rsep, p_hat): bin centers
    and the estimate (NaN on empty bins).
    """
    bins_np = (bins.detach().cpu().numpy() if isinstance(bins, torch.Tensor)
               else np.asarray(bins))
    binnr = int(bins_np.shape[0])
    binwidth = float(bins_np[1] - bins_np[0])
    pos_cart = as_tensor(pos_cart, device)
    dT = as_tensor(dT, device if isinstance(dT, torch.Tensor)
                   else pos_cart.device)
    n = pos_cart.shape[0] if n_valid is None else int(n_valid)
    nom, den = _ksz_accumulate(pos_cart, dT, n, binnr, binwidth,
                               block=block)
    p = torch.where(den > 0, nom / den.clamp_min(1e-30), torch.nan)
    return make_rsep(binnr, binwidth, device=pos_cart.device), p


def mean_pv_from_tv(pos_cart, vel_ang, bins, theta1=None, theta2=None,
                    block: int = 512, device=None):
    """Mean pairwise velocity from transverse (angular) velocities.

    Mirror of the reference entry point (mean_pairwise_velocity.py:16-118):
    angular velocities [vel_RA, vel_DEC] are embedded as a spherical
    vector [v_r=0, vel_ang0, vel_ang1] and rotated to cartesian with the
    (theta2, theta1) jacobian before the pair accumulation; with no angles
    given they derive from the lightcone positions shifted by 10 deg.
    Angles above 2 pi are taken as degrees. The estimate is
    `mean_pairwise_velocity`'s: through K3 on a CUDA tensor. Placement as
    in `mean_pairwise_velocity`.
    """
    pos_cart = as_tensor(pos_cart, device)
    dev = pos_cart.device
    vel_ang = as_tensor(vel_ang, dev)
    if theta1 is None:
        t1, t2 = angular_coordinate_in_lc(pos_cart, unit="rad")
        t1 = t1 + 10.0 * math.pi / 180.0
        t2 = t2 + 10.0 * math.pi / 180.0
    else:
        theta1 = as_tensor(theta1, dev)
        theta2 = as_tensor(theta2, dev)
        deg = theta1.max() > 2.0 * math.pi
        t1 = torch.where(deg, torch.deg2rad(theta1), theta1)
        t2 = torch.where(deg, torch.deg2rad(theta2), theta2)
    vel_sph = torch.cat([vel_ang.new_zeros((pos_cart.shape[0], 1)),
                         vel_ang], dim=1)
    vel_cart = convert_vec_sph_to_cart(t2, t1, vel_sph)
    return mean_pairwise_velocity(pos_cart, vel_cart, bins, block=block)
