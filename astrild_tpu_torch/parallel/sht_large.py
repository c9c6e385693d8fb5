"""Distributed large-lmax SHT: the Legendre recursion's m rows sharded over
a mesh axis.

Port of astrild_tpu/parallel/sht_large.py. The production-scale
transforms (ops/sht_large.py, ops/sht_spin_large.py: ring FFTs and an
on-device recursion over l, lmax <= 4*nside-1) spend most of their time
in the recursion, whose m rows are independent. Each rank runs the
recursion for its m rows; one `psum` then assembles the ring
coefficients (synthesis) or the alm columns (analysis) from the ranks'
disjoint rows. The ring-FFT / cap tail and the quadrature head are cheap
next to the recursion and run replicated.

The rows are the JAX package's m-blocks of 128, interleaved: rank idx of
P owns blocks idx, idx + P, idx + 2P, ... (`_interleave_helpers` there),
so every rank's first block starts low and the triangular work is
balanced. The JAX package scans each block from its own m0; the port runs
one recursion over all of its rank's rows from the first of them
(`ms` of ops.sht_large._legendre_steps), each row's values bit for bit
the unsharded recursion's. The blocks past lmax (the block count padded
to a multiple of P) hold no rows.

Complements parallel/sht.py, which ring-shards the table path.
"""
from __future__ import annotations

import math

import torch

from ..ops import sht_large as sl
from ..ops import sht_spin_large as ssl
from .mesh import axis_index, axis_size, mesh_device, psum, to_mesh

__all__ = ["make_distributed_sht_large", "make_distributed_sht_spin2_large",
           "make_distributed_sht_spin1_large"]

# the JAX package's m-block (ops/sht_large._MBLOCK)
_MBLOCK = 128


def _local_rows(lmax: int, nproc: int, idx: int) -> list:
    """The m rows of rank idx: its interleaved blocks, cut at lmax."""
    L1 = lmax + 1
    nb = -(-L1 // _MBLOCK)
    nbl = -(-nb // nproc)
    return [m for i in range(nbl)
            for m in range((i * nproc + idx) * _MBLOCK,
                           min((i * nproc + idx + 1) * _MBLOCK, L1))]


def _embed(parts, ms, shape, dim: int, mesh, ax: str):
    """The ranks' rows `ms` of `parts` (stacked) set into zeros of `shape`
    along `dim`, then one psum over `ax`: every rank gets the whole."""
    full = torch.zeros(shape, device=parts.device)
    if ms:
        full.index_copy_(dim, torch.as_tensor(ms, device=parts.device),
                         parts)
    return psum(full, mesh, ax)


def make_distributed_sht_large(mesh, nside: int, lmax: int, ax: str = "x"):
    """m-sharded (synthesize, analyze) over mesh axis `ax`.

    synthesize(alm_re, alm_im) -> (npix,) RING map, replicated.
    analyze(hpmap, niter, method) -> (alm_re, alm_im), replicated, with
      the jacobi / cg semantics of ops.sht_large.analyze_large (the
      matvecs are the distributed transforms).
    alm layout as ops/sht_large: (lmax+1, lmax+1) [l, m] real pairs.
    """
    sl._check_lmax(nside, lmax)
    dev = mesh_device(mesh)
    L1 = lmax + 1
    tab = sl.sht_large_tables(nside, lmax, dev)
    ms = _local_rows(lmax, axis_size(mesh, ax), axis_index(mesh, ax))
    sub = sl.recursion_rows(tab, ms) if ms else None
    nring = int(tab.x.shape[0])
    npix = int(tab.flat_idx.shape[0])
    wq = 4.0 * math.pi / npix

    def synth(a_re, a_im):
        c = (sl._legendre_loop(sub, lmax, alm=(a_re, a_im), ms=ms) if ms
             else torch.zeros((2, 0, nring), device=dev))
        c = _embed(c, ms, (2, L1, nring), 1, mesh, ax)
        return sl._synth_from_c(c[0], c[1], tab, nside, lmax)

    def adjoint(hpmap):
        d_re, d_im = sl._quadrature_sums(hpmap, tab, nside, lmax)
        a = (sl._legendre_loop(sub, lmax, q=(d_re, d_im), ms=ms) if ms
             else torch.zeros((2, L1, 0), device=dev))
        a = _embed(a, ms, (2, L1, L1), 2, mesh, ax)
        return wq * a[0], wq * a[1]

    def synthesize(alm_re, alm_im):
        return synth(to_mesh(alm_re, mesh).to(torch.float32),
                     to_mesh(alm_im, mesh).to(torch.float32))

    def analyze(hpmap, niter: int = 3, method: str = "auto"):
        sl._check_method(method)
        return sl.analyze_with(to_mesh(hpmap, mesh).to(torch.float32), nside,
                               lmax, niter, method, synth, adjoint)

    return synthesize, analyze


def make_distributed_sht_spin2_large(mesh, nside: int, lmax: int,
                                     ax: str = "x"):
    """m-sharded spin-2 scan-path SHT: full-sky shear E/B.

    synthesize(e_re, e_im, b_re, b_im) -> (Q, U) RING maps, replicated.
    analyze(q, u, niter, method) -> (e_re, e_im, b_re, b_im), replicated
      (the jacobi / cg semantics of ops.sht_spin_large
      .analyze_spin2_large).

    Each rank runs both spin columns' recursions for its rows; one psum
    assembles the 4 ring-coefficient planes (synthesis) or the 4 alm
    channels (analysis).
    """
    sl._check_lmax(nside, lmax)
    return _make_distributed_spin_large(
        mesh, nside, lmax, ax, ssl.spin2_large_tables(
            nside, lmax, mesh_device(mesh)),
        ssl._fold_coeffs, ssl._synth_from_g, ssl._finish_adjoint_spin2)


def make_distributed_sht_spin1_large(mesh, nside: int, lmax: int,
                                     ax: str = "x"):
    """m-sharded spin-1 scan-path SHT: deflection (gradient / curl)
    fields.

    synthesize(e_re, e_im, b_re, b_im) -> (alpha_theta, alpha_phi);
    analyze(a_t, a_p, niter, method) -> the spin-1 E/B alms (conventions
    of ops.sht_spin.synthesize_spin1; E = sqrt(l(l+1)) psi for a pure
    gradient)."""
    sl._check_lmax(nside, lmax)
    return _make_distributed_spin_large(
        mesh, nside, lmax, ax, ssl.spin1_large_tables(
            nside, lmax, mesh_device(mesh)),
        ssl._fold_coeffs_spin1, ssl._synth_spin1_from_g,
        ssl._finish_adjoint_spin1)


def _make_distributed_spin_large(mesh, nside: int, lmax: int, ax: str, tab,
                                 fold, tail, finish):
    """The spin-generic factory: the spin-2 and spin-1 ones differ in their
    tables, their fold (the coefficient half of synthesis), their tail and
    the finish of their adjoint."""
    dev = mesh_device(mesh)
    L1 = lmax + 1
    ms = _local_rows(lmax, axis_size(mesh, ax), axis_index(mesh, ax))
    sub = ssl.recursion_rows_spin(tab, ms) if ms else None
    nring = int(tab.base.x.shape[0])
    npix = int(tab.base.flat_idx.shape[0])

    def synth(e_re, e_im, b_re, b_im):
        g = (torch.stack(fold(sub, lmax, e_re, e_im, b_re, b_im, ms)) if ms
             else torch.zeros((4, 0, nring), device=dev))
        g = _embed(g, ms, (4, L1, nring), 1, mesh, ax)
        return tail(*g.unbind(0), tab, nside, lmax)

    def adjoint(q, u):
        dgs = ssl._spin_quadrature_sums(q, u, tab, nside, lmax)
        parts = (torch.stack(ssl._branch_loops_t(dgs, sub, lmax, ms)) if ms
                 else torch.zeros((4, L1, 0), device=dev))
        parts = _embed(parts, ms, (4, L1, L1), 2, mesh, ax)
        return finish(*parts.unbind(0), lmax, npix)

    def as_mesh(*xs):
        return [to_mesh(x, mesh).to(torch.float32) for x in xs]

    def synthesize(e_re, e_im, b_re, b_im):
        return synth(*as_mesh(e_re, e_im, b_re, b_im))

    def analyze(q, u, niter: int = 3, method: str = "auto"):
        sl._check_method(method)
        q, u = as_mesh(q, u)
        return ssl._analyze_spin_generic(
            q, u, nside, lmax, niter, method, None,
            lambda er, ei, br, bi, *_: synth(er, ei, br, bi),
            lambda qq, uu, *_: adjoint(qq, uu))

    return synthesize, analyze
