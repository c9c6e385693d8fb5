"""Large-lmax spin-weighted transforms: full-sky shear E/B and lensing
deflections at production scale.

Port of astrild_tpu/ops/sht_spin_large.py, the counterpart of the table
path (ops/sht_spin.py) on the ops/sht_large architecture: the
d^l_{m1,m}(theta) functions are never stored; one Wigner-d three-term
upward recursion over l runs for all m at once (the rows whose seed l0 =
max(m, s) <= l active at step l, s = |m1|), with the same 2^60 underflow
rescaling, accumulating the contraction with the (E, B) alms (synthesis)
or the ring quadrature sums (the analysis adjoint). The one recursion
serves both spins, s = 2 (shear) and s = 1 (deflections): it starts at l
= s with the seed rows 0..s. Both columns (m1 = -s and +s) run on the
northern rings and the equator: a southern ring's d^l_{-s,m} is
(-1)^(l+m) its mirror's d^l_{s,m} and vice versa, so each recursion also
sums the other branch for the south (graphed on the card as in
sht_large).

Against the scalar recursion:
  * the recursion multiplies by (alpha*x + beta) instead of a*x (the
    d-recursion has an m1*m shift term);
  * seeds sit at l0 = max(m, s): closed forms of d^s_{+-s, m} for m < s,
    and the log2-scaled cos/sin(theta/2)-power seeds for m >= s (host
    float64 log2 half-angle tables);
  * the belt synthesis is one complex inverse FFT per ring (the spin field
    has independent +-m coefficients; bins taken mod n are the exact
    aliasing of equally spaced pixels);
  * the adjoint is written out: one complex FFT of the field per belt
    ring and the analysis-mode recursions, transposed against the
    synthesis fold.

The cap trig sums and belt phase rotations are ops/sht_large's. The
recursions accumulate the alm combinations the fold needs (two a branch,
not four). Conventions are ops/sht_spin.py's: Q + iU = -sum (E+iB) 2Y_lm
for spin 2; for spin 1 the plus branch s_m d_{-1,m} (s_0 = -1) and the
fold -d_{+1,m}. As in sht_large, the recursions take an optional sorted
subset `ms` of the m rows (the JAX package's `l_start` and per-block m0):
the m-sharded transforms of parallel/sht_large.py run each rank's rows
through the coefficient and adjoint-loop halves below, with the
quadrature head and the FFT tail replicated.
"""
from __future__ import annotations

from functools import lru_cache
from math import lgamma
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import healpix as hpx
from .sht import _device_key, _span, _upload, ring_geometry
from .sht_large import (LargeSHTTables, _accumulate, _belt, _cap_core_apply,
                        _cg, _check_lmax, _check_method, _graphed,
                        _map_to_plane, _mirror_signed, _north,
                        _parity_inputs, _plane_to_map, _rescale_step,
                        _rotate_phase, _row_schedule, _sub_rows,
                        _unfold_south, sht_large_tables)
from .sht_spin import (_alm_masks, _alms4, _branch_transpose, _eb_spectra,
                       _fold_transpose, _m_positive, _maps2)

__all__ = ["Spin2LargeTables", "spin2_large_tables", "synthesize_spin2_large",
           "analyze_spin2_large", "anafast_spin2_large",
           "Spin1LargeTables", "spin1_large_tables",
           "synthesize_spin1_large", "analyze_spin1_large",
           "deflection_from_kappa_alm_large"]


class SpinRecursion(NamedTuple):
    """One spin column m1's seeds and recursion coefficients."""
    spin: int                  # s = |m1|: the first l and the seed rows 0..s
    seed_frac: torch.Tensor    # (lmax+1, nring) scaled d^{l0}_{m1, m}
    seed_scale: torch.Tensor   # (lmax+1, nring) its scale s
    alpha: torch.Tensor        # (lmax+1, lmax+1) [l, m] x-coefficient
    beta: torch.Tensor         # (lmax+1, lmax+1) shift
    gamma: torch.Tensor        # (lmax+1, lmax+1) two-back coefficient


class Spin2LargeTables(NamedTuple):
    base: LargeSHTTables
    log2_ch: torch.Tensor    # (nring,) log2 cos(theta/2), host float64
    log2_sh: torch.Tensor    # (nring,) log2 sin(theta/2)
    seed2_p: torch.Tensor    # (s, nring) d^s_{+s, m} for m < s (s = 2
                             # here, 1 in Spin1LargeTables)
    seed2_m: torch.Tensor    # (s, nring) d^s_{-s, m} for m < s
    lnc: torch.Tensor        # (lmax+1,) log2 seed amplitude (the same for
                             # m1 = +-s)
    norm: torch.Tensor       # (lmax+1,) sqrt((2l+1)/4pi), float32
    rec_m: SpinRecursion     # m1 = -s: the plus branch
    rec_p: SpinRecursion     # m1 = +s: the folded branch


def _spin_seed_state(m1: int, lnc, log2_ch, log2_sh, seeds):
    """Scaled d^{l0}_{m1, m} seeds (frac, scale) for every (m, ring):
    |seed| = C ch^(m+m1) sh^(m-m1), sign (-1)^(m-m1); the closed-form
    rows of `seeds` for m < s = |m1| (no underflow there; `seeds` holds
    one row for each of them)."""
    s_spin = abs(m1)
    m = torch.arange(lnc.shape[0], dtype=torch.float32,
                     device=lnc.device)[:, None]
    log2_mag = (lnc[:, None] + (m + m1) * log2_ch[None, :]
                + (m - m1) * log2_sh[None, :])
    s0 = torch.clamp_min(torch.ceil((-log2_mag - 29.0) / 60.0), 0.0)
    sign = torch.where(torch.remainder(m, 2.0) == 0.0, 1.0, -1.0)
    if s_spin % 2:
        sign = -sign            # (-1)^(m-m1) = (-1)^m (-1)^m1
    frac = sign * torch.exp2(log2_mag + 60.0 * s0)
    row_lo = seeds[0][None, :].expand_as(frac)
    for k in range(1, seeds.shape[0]):
        row_lo = torch.where(m == float(k), seeds[k][None, :], row_lo)
    frac = torch.where(m < s_spin, row_lo, frac)
    s0 = torch.where(m < s_spin, 0.0, s0)
    return frac, s0


def _spin_coeffs(lmax: int, m1: int, dev):
    """alpha (x-coefficient), beta, gamma of the d-recursion for every
    (l, m), float32 in the JAX package's operation order, masked so no
    denominator is zero for l <= l0."""
    lf = torch.arange(lmax + 1, dtype=torch.float32, device=dev)[:, None]
    m = torch.arange(lmax + 1, dtype=torch.float32, device=dev)[None, :]
    one = torch.ones((), device=dev)
    m1sq = float(m1 * m1)
    d1 = lf * lf - m1sq
    d2 = lf * lf - m * m
    den = (lf - 1.0) * torch.sqrt(torch.where(d1 > 0, d1, one)
                                  * torch.where(d2 > 0, d2, one))
    den = torch.where((d1 > 0) & (d2 > 0) & (lf > 1), den, one)
    alpha = (2.0 * lf - 1.0) * lf * (lf - 1.0) / den
    beta = -(2.0 * lf - 1.0) * m1 * m / den
    g1 = (lf - 1.0) ** 2 - m1sq
    g2 = (lf - 1.0) ** 2 - m * m
    gamma = -lf * torch.sqrt(torch.clamp_min(g1, 0.0)
                             * torch.clamp_min(g2, 0.0)) / den
    return alpha.contiguous(), beta.contiguous(), gamma.contiguous()


def _spin_large_tables(cls, spin: int, nside: int, lmax: int, dev):
    """The scan path's arrays of spin s = 1 or 2: the closed-form seed rows
    d^s_{+-s, m} for m < s at l0 = s, the log2 seed amplitude
    sqrt((2m)! / ((m+s)! (m-s)!)) for m >= s (the same for both signs of
    m1), and the recursions of m1 = -s (the plus branch) and +s (the
    folded one)."""
    base = sht_large_tables(nside, lmax, dev)
    geo = ring_geometry(nside)
    th = np.asarray(geo.theta, np.float64)
    x = np.cos(th)
    ch = np.cos(th / 2.0)
    sh = np.sin(th / 2.0)
    s = np.sin(th)
    if spin == 2:
        # d^2_{2,0} = d^2_{-2,0} = sqrt(6)/4 sin^2, d^2_{2,1} = -(1+x)/2
        # sin, d^2_{-2,1} = (1-x)/2 sin
        seed_p = np.stack([np.sqrt(6.0) / 4.0 * s * s,
                           -(1.0 + x) / 2.0 * s])
        seed_m = np.stack([np.sqrt(6.0) / 4.0 * s * s,
                           (1.0 - x) / 2.0 * s])
    else:
        # d^1_{1,0} = -sin/sqrt(2), d^1_{-1,0} = +sin/sqrt(2)
        seed_p = (-s / np.sqrt(2.0))[None, :]
        seed_m = (+s / np.sqrt(2.0))[None, :]
    ms = np.arange(lmax + 1)
    ln2 = np.log(2.0)
    lnc = np.array([0.5 * (lgamma(2 * m + 1) - lgamma(m + spin + 1)
                           - lgamma(m - spin + 1)) / ln2 if m >= spin
                    else 0.0 for m in ms])
    log2_ch = _upload(np.log2(np.maximum(ch, 1e-300)), dev)
    log2_sh = _upload(np.log2(np.maximum(sh, 1e-300)), dev)
    sp, sm = _upload(seed_p, dev), _upload(seed_m, dev)
    lnc_t = _upload(lnc, dev)
    lf = torch.arange(lmax + 1, dtype=torch.float32, device=dev)
    norm = torch.sqrt((2.0 * lf + 1.0) / (4.0 * np.pi))

    def recursion(m1, seeds):
        frac, s0 = _spin_seed_state(m1, lnc_t, log2_ch, log2_sh, seeds)
        return SpinRecursion(spin, frac, s0, *_spin_coeffs(lmax, m1, dev))

    return cls(base, log2_ch, log2_sh, sp, sm, lnc_t, norm,
               recursion(-spin, sm), recursion(spin, sp))


@lru_cache(maxsize=4)
def _spin2_large_tables(nside: int, lmax: int, dev) -> Spin2LargeTables:
    return _spin_large_tables(Spin2LargeTables, 2, nside, lmax, dev)


def spin2_large_tables(nside: int, lmax: int, device=None
                       ) -> Spin2LargeTables:
    """The spin-2 scan path's device arrays, cached per device; raises
    ValueError for lmax > 4*nside - 1."""
    _check_lmax(nside, lmax)
    return _spin2_large_tables(nside, lmax, _device_key(device))


def recursion_rows_spin(tab, ms):
    """`tab` with both spin columns' per-m tables cut to the sorted m rows
    `ms` (the input of the recursions' `ms` argument)."""
    def cut(rec: SpinRecursion) -> SpinRecursion:
        return rec._replace(seed_frac=_sub_rows(rec.seed_frac, ms, 0),
                            seed_scale=_sub_rows(rec.seed_scale, ms, 0),
                            alpha=_sub_rows(rec.alpha, ms, 1),
                            beta=_sub_rows(rec.beta, ms, 1),
                            gamma=_sub_rows(rec.gamma, ms, 1))

    return tab._replace(rec_m=cut(tab.rec_m), rec_p=cut(tab.rec_p))


def _spin_steps(tab, rec: SpinRecursion, lmax: int, inp, synth: bool,
                ms=None):
    """The Wigner-d recursion over l for all m at once (or the rows `ms`,
    `rec` cut to them), one spin column, on the north rings and the
    equator (sht_large._accumulate gives the shapes); norm_l =
    sqrt((2l+1)/4pi) included. It starts at l = s = rec.spin, where the
    rows 0..s take their seeds (or at the first row's m, if later)."""
    nh = _north(tab.base.x.shape[0])
    x = tab.base.x[:nh]
    L1 = lmax + 1
    nm = rec.seed_frac.shape[0]
    prev, curr, nxt = (torch.zeros((nm, nh), device=x.device)
                       for _ in range(3))
    s = rec.seed_scale[:, :nh].clone()
    nch = inp.shape[0] if synth else inp.shape[1]
    out = torch.zeros((2, nch, nm, nh) if synth else (nch, L1, nm),
                      device=x.device)
    first, active, seed = _row_schedule(lmax, ms, rec.spin)
    for l in range(first, L1):
        k = active[l]
        nk, ck, sk = nxt[:k], curr[:k], s[:k]
        # p_next = (alpha x + beta) p_curr + gamma p_prev; the rows whose
        # l0 = l take their seeds (rows 0..s at l = s)
        coef = torch.addcmul(rec.beta[l, :k, None], rec.alpha[l, :k, None],
                             x)
        torch.mul(coef, ck, out=nk)
        nk.addcmul_(rec.gamma[l, :k, None], prev[:k])
        if l == rec.spin:
            nk.copy_(rec.seed_frac[:k, :nh])
        elif seed[l] >= 0:
            nk[seed[l]] = rec.seed_frac[seed[l], :nh]
        lam = _rescale_step(nk, ck, sk) * tab.norm[l]
        _accumulate(out, inp, l, k, lam, synth)
        prev, curr, nxt = curr, nxt, prev
    return out


def _spin_loop(tab, rec: SpinRecursion, lmax: int, inp, synth: bool,
               ms=None):
    """`_spin_steps` of one spin column, graphed on the card."""
    rows = None if ms is None else tuple(int(m) for m in ms)
    with _span("sht.legendre"):
        return _graphed(("spin", synth, id(rec), rows), (tab, rec),
                        lambda z: _spin_steps(tab, rec, lmax, z, synth,
                                              rows), inp)


def _branch_sums(tab, lmax: int, rows_p, rows_m, ms=None):
    """The two branches' ring sums, each (2, lmax+1, nring): sum_l rows_p
    [., l, m] d^l_{-s,m}(theta_r) and sum_l rows_m[., l, m] d^l_{s,m}. A
    ring's d_{-s,m} is (-1)^(l+m) its mirror ring's d_{s,m}: each north
    recursion sums its own branch's alm combinations for the north rings
    and the other branch's for the south. With the rows `ms` (`tab` cut by
    `recursion_rows_spin`) only those m come out."""
    nring = tab.base.x.shape[0]
    rows_p, rows_m = _sub_rows(rows_p, ms, 2), _sub_rows(rows_m, ms, 2)
    north_m, south_m = _unfold_south(_spin_loop(
        tab, tab.rec_m, lmax, torch.cat([rows_p, rows_m]), True, ms), nring,
        ms)
    north_p, south_p = _unfold_south(_spin_loop(
        tab, tab.rec_p, lmax, torch.cat([rows_m, rows_p]), True, ms), nring,
        ms)
    return (torch.cat([north_m[:2], south_p[2:]], dim=-1),
            torch.cat([north_p[:2], south_m[2:]], dim=-1))


def _fold_coeffs(tab: Spin2LargeTables, lmax: int, e_re, e_im, b_re,
                 b_im, ms=None):
    """(gp_re, gp_im, gm_re, gm_im) ring coefficients, (lmax+1, nring):
    gp_m multiplies e^{+im phi}, gm_m e^{-im phi} (m > 0). gp = -A(E + iB)
    through d_{-2,m}, gm = the fold through d_{2,m}. With `ms`, the rows
    ms of each."""
    gp, gm = _branch_sums(tab, lmax,
                          torch.stack([b_im - e_re, -(e_im + b_re)]),
                          torch.stack([-(e_re + b_im), e_im - b_re]), ms)
    return gp[0], gp[1], gm[0], gm[1]


def _synth_from_g(gp_re, gp_im, gm_re, gm_im, tab: Spin2LargeTables,
                  nside: int, lmax: int):
    """Ring-coefficient tail of spin-2 synthesis -> (Q, U) RING maps."""
    base = tab.base
    nring = base.x.shape[0]
    n = 4 * nside
    dev = gp_re.device
    p = _m_positive(lmax, dev)
    belt = _belt(nside, nring)
    q_plane = torch.zeros((nring, n), device=dev)
    u_plane = torch.zeros((nring, n), device=dev)
    with _span("sht.belt_fft"):
        # one complex inverse FFT per ring; bins taken mod n are the exact
        # aliasing of n equally spaced pixels
        bp_re, bp_im = _rotate_phase(gp_re[:, belt], gp_im[:, belt],
                                     base.phi0[belt])
        bm_re, bm_im = _rotate_phase(gm_re[:, belt], gm_im[:, belt],
                                     base.phi0[belt], sign=-1.0)
        ms = torch.arange(lmax + 1, device=dev)
        S = torch.zeros((bp_re.shape[1], n), dtype=torch.complex64,
                        device=dev)
        S.index_add_(1, ms % n, torch.complex(bp_re, bp_im).T)
        S.index_add_(1, (-ms[1:]) % n, torch.complex(bm_re[1:],
                                                     bm_im[1:]).T)
        G = torch.fft.ifft(S, dim=1) * float(n)
        q_plane[belt] = G.real
        u_plane[belt] = G.imag
    # caps: trig sums of the folded real channels
    gmr, gmi = gm_re * p, gm_im * p
    _cap_core_apply(gp_re + gmr, -gp_im + gmi, base.caps, lmax,
                    out=q_plane)
    _cap_core_apply(gp_im + gmi, gp_re - gmr, base.caps, lmax,
                    out=u_plane)
    return _plane_to_map(q_plane, base), _plane_to_map(u_plane, base)


def _spin_quadrature_sums(q, u, tab: Spin2LargeTables, nside: int,
                          lmax: int):
    """Quadrature-sum head of spin-2 analysis: (Q, U) maps ->
    (dgp_re, dgp_im, dgm_re, dgm_im), each (lmax+1, nring)."""
    base = tab.base
    nring = base.x.shape[0]
    n = 4 * nside
    qp = _map_to_plane(q, base, nring, n)
    up = _map_to_plane(u, base, nring, n)
    p = _m_positive(lmax, q.device)
    # caps: trig quadrature sums against Q and U (zero on the belt)
    dqc, dqs = _cap_core_apply(None, None, base.caps, lmax, plane=qp)
    duc, dus = _cap_core_apply(None, None, base.caps, lmax, plane=up)
    dgp_re, dgp_im, dgm_re, dgm_im = _fold_transpose(dqc, dqs, duc, dus, p)
    belt = _belt(nside, nring)
    with _span("sht.belt_fft"):
        # one complex FFT of H = Q + iU per belt ring
        F = torch.fft.fft(torch.complex(qp[belt], up[belt]), dim=1)
        ms = torch.arange(lmax + 1, device=q.device)
        Fp = F[:, ms % n].T                 # dgp_m = F at +m
        Fm = F[:, (-ms) % n].T              # dgm_m = F at -m
        dgp_re[:, belt], dgp_im[:, belt] = _rotate_phase(
            Fp.real, Fp.imag, base.phi0[belt], sign=-1.0)
        m_re, m_im = _rotate_phase(Fm.real, Fm.imag, base.phi0[belt],
                                   sign=1.0)
        # the belt dgm for m = 0 duplicates dgp (bin 0); the fold defines
        # gm only for m > 0
        dgm_re[:, belt] = m_re * p
        dgm_im[:, belt] = m_im * p
    return dgp_re, dgp_im, dgm_re, dgm_im


def _synth_spin2_large_impl(e_re, e_im, b_re, b_im, tab, nside: int,
                            lmax: int):
    g = _fold_coeffs(tab, lmax, e_re, e_im, b_re, b_im)
    return _synth_from_g(*g, tab, nside, lmax)


def _branch_loops_t(dgs, tab, lmax: int, ms=None):
    """The branches' recursions of the adjoint on the quadrature sums dgs =
    (dgp_re, dgp_im, dgm_re, dgm_im), each (lmax+1, nring): (Ar, Ai, Mr,
    Mi), each (lmax+1, lmax+1) [l, m] (or (lmax+1, len(ms)) for the rows
    ms), the plus branch's (d_{-s,m}) and the folded branch's (d_{s,m})
    Legendre sums."""
    nh = _north(tab.base.x.shape[0])
    # each north recursion sums its own branch over the north rings and the
    # other branch over the south ones (see _branch_sums)
    qp = _sub_rows(torch.stack(dgs[:2]), ms, 1)
    qm = _sub_rows(torch.stack(dgs[2:]), ms, 1)
    out_m = _spin_loop(tab, tab.rec_m, lmax, _parity_inputs(
        qp[..., :nh], _mirror_signed(qm[..., nh:], nh, ms)), False, ms)
    out_p = _spin_loop(tab, tab.rec_p, lmax, _parity_inputs(
        qm[..., :nh], _mirror_signed(qp[..., nh:], nh, ms)), False, ms)
    a = out_m[:2] + out_p[2:]
    m = out_p[:2] + out_m[2:]
    return a[0], a[1], m[0], m[1]


def _branch_sums_t(q, u, tab, nside: int, lmax: int):
    """Transpose of the quadrature head and the branches' recursions: (Q,
    U) maps -> (Ar, Ai, Mr, Mi) (`_branch_loops_t`)."""
    return _branch_loops_t(_spin_quadrature_sums(q, u, tab, nside, lmax),
                           tab, lmax)


def _finish_adjoint_spin2(ar, ai, mr, mi, lmax: int, npix: int):
    """The spin-2 adjoint from the branches' sums: the transpose of the
    fold, with 4pi/npix and the m > 0 halves folded in
    (sht_spin._adjoint_spin2's normalization)."""
    der, dei, dbr, dbi = _branch_transpose(ar, ai, mr, mi)
    vre, vim = _alm_masks(lmax, npix, ar.device)
    return der * vre, dei * vim, dbr * vre, dbi * vim


def _adjoint_spin2_large_impl(q, u, tab: Spin2LargeTables, nside: int,
                              lmax: int):
    """Quadrature adjoint: the exact transpose with 4pi/npix and the m > 0
    halves folded in (sht_spin._adjoint_spin2's normalization)."""
    return _finish_adjoint_spin2(*_branch_sums_t(q, u, tab, nside, lmax),
                                 lmax, q.shape[0])


def synthesize_spin2_large(e_re, e_im, b_re, b_im, nside: int, lmax: int,
                           tables: Optional[Spin2LargeTables] = None,
                           device=None):
    """(E, B) alms -> (Q, U)/(gamma1, gamma2) maps at large lmax
    (alm2map_spin parity; lmax <= 4*nside - 1)."""
    _check_lmax(nside, lmax)
    alms = _alms4((e_re, e_im, b_re, b_im), device,
                  None if tables is None else tables.base)
    tab = tables if tables is not None else spin2_large_tables(
        nside, lmax, alms[0].device)
    return _synth_spin2_large_impl(*alms, tab, nside, lmax)


def _analyze_spin_generic(q, u, nside: int, lmax: int, niter: int,
                          method: str, tab, synth_impl, adjoint_impl):
    """The jacobi / cg analysis driver of the spin scan path.

    method as in sht_large.analyze_large: 'jacobi' residual iterations,
    'cg' the normal-equations solve (the adjoint's m > 0 half-weight makes
    the raw A∘S non-symmetric; undoing it restores S^T S); 'auto' picks cg
    in the lmax > 2*nside band, where the aliased +-m pairs make Jacobi
    useless.
    """
    if method == "auto":
        method = "cg" if lmax > 2 * nside else "jacobi"
    b = adjoint_impl(q, u, tab, nside, lmax)
    if method == "cg" and niter > 0:
        unhalf = torch.where(torch.arange(lmax + 1, device=q.device) == 0,
                             1.0, 2.0)[None, :]

        def mul(t):
            return tuple(a * unhalf for a in t)

        def matvec(a):
            return mul(adjoint_impl(
                *synth_impl(*a, tab, nside, lmax), tab, nside, lmax))

        return _cg(matvec, mul(b), b, niter)
    alm = b
    for _ in range(niter):
        sq, su = synth_impl(*alm, tab, nside, lmax)
        d = adjoint_impl(q - sq, u - su, tab, nside, lmax)
        alm = tuple(a + da for a, da in zip(alm, d))
    return alm


def analyze_spin2_large(q, u, nside: int, lmax: int, niter: int = 3,
                        tables: Optional[Spin2LargeTables] = None,
                        method: str = "auto", device=None):
    """(Q, U) maps -> (E_re, E_im, B_re, B_im) at large lmax
    (see _analyze_spin_generic for the method semantics)."""
    _check_method(method)
    _check_lmax(nside, lmax)
    q, u = _maps2(q, u, device, None if tables is None else tables.base)
    tab = tables if tables is not None else spin2_large_tables(
        nside, lmax, q.device)
    return _analyze_spin_generic(q, u, nside, lmax, niter, method, tab,
                                 _synth_spin2_large_impl,
                                 _adjoint_spin2_large_impl)


def anafast_spin2_large(q, u, lmax: int, niter: int = 3,
                        tables: Optional[Spin2LargeTables] = None,
                        method: str = "auto", device=None):
    """(Cl_EE, Cl_BB, Cl_EB) of a spin-2 map pair at large lmax; method
    passes through to analyze_spin2_large (healpy-parity comparisons pin
    method='jacobi')."""
    q, u = _maps2(q, u, device, None if tables is None else tables.base)
    nside = hpx.npix2nside(q.shape[0])
    return _eb_spectra(*analyze_spin2_large(q, u, nside, lmax, niter=niter,
                                           tables=tables, method=method))


# --------------------------------------------------------------------
# spin-1: large-lmax gradient / curl (deflection) transforms
# --------------------------------------------------------------------

class Spin1LargeTables(Spin2LargeTables):
    """Spin2LargeTables' layout for spin 1: seed2_* hold the one m = 0
    closed-form row d^1_{+-1, 0} at l0 = 1, rec_m / rec_p run m1 = -1 /
    +1."""
    __slots__ = ()


@lru_cache(maxsize=4)
def _spin1_large_tables(nside: int, lmax: int, dev) -> Spin1LargeTables:
    return _spin_large_tables(Spin1LargeTables, 1, nside, lmax, dev)


def spin1_large_tables(nside: int, lmax: int, device=None
                       ) -> Spin1LargeTables:
    """The spin-1 scan path's device arrays, cached per device; raises
    ValueError for lmax > 4*nside - 1."""
    _check_lmax(nside, lmax)
    return _spin1_large_tables(nside, lmax, _device_key(device))


def _m_sign_spin1(lmax: int, device) -> torch.Tensor:
    """(lmax+1, 1): s_m of the plus branch, -1 at m = 0 and +1 above."""
    return 2.0 * _m_positive(lmax, device) - 1.0


def _fold_coeffs_spin1(tab, lmax: int, e_re, e_im, b_re, b_im, ms=None):
    """The spin-1 branches' ring sums (gp_re, gp_im, gm_re, gm_im) before
    the plus branch's s_m: A(E + iB) through d_{-1,m} and the fold
    -(conj(E) + i conj(B)) through d_{1,m}; the rows ms with `ms`."""
    gp, gm = _branch_sums(tab, lmax,
                          torch.stack([e_re - b_im, e_im + b_re]),
                          torch.stack([-(e_re + b_im), e_im - b_re]), ms)
    return gp[0], gp[1], gm[0], gm[1]


def _synth_spin1_from_g(gp_re, gp_im, gm_re, gm_im, tab, nside: int,
                        lmax: int):
    """The spin-1 tail: s_m on the plus branch, then the spin-2 complex-FFT
    and cap tail (F = alpha_theta + i alpha_phi)."""
    sm = _m_sign_spin1(lmax, gp_re.device)
    return _synth_from_g(sm * gp_re, sm * gp_im, gm_re, gm_im, tab, nside,
                         lmax)


def _synth_spin1_large_impl(e_re, e_im, b_re, b_im, tab, nside: int,
                            lmax: int):
    """(E, B) -> (alpha_theta, alpha_phi): the plus branch s_m A(E + iB)
    through d_{-1,m}, the fold -(conj(E) + i conj(B)) through d_{1,m}."""
    return _synth_spin1_from_g(*_fold_coeffs_spin1(
        tab, lmax, e_re, e_im, b_re, b_im), tab, nside, lmax)


def _finish_adjoint_spin1(ar, ai, mr, mi, lmax: int, npix: int):
    """The spin-1 adjoint from the branches' sums (the transpose of its
    fold), with 4pi/npix and the m > 0 halves; valid for l >= 1."""
    sm = _m_sign_spin1(lmax, ar.device).T
    vre, vim = _alm_masks(lmax, npix, ar.device, lmin=1)
    return ((sm * ar - mr) * vre, (sm * ai + mi) * vim,
            (sm * ai - mi) * vre, (-sm * ar - mr) * vim)


def _adjoint_spin1_large_impl(a_t, a_p, tab, nside: int, lmax: int):
    """Quadrature adjoint of the spin-1 synthesis (the transpose of its
    fold), with 4pi/npix and the m > 0 halves; valid for l >= 1."""
    return _finish_adjoint_spin1(*_branch_sums_t(a_t, a_p, tab, nside,
                                                 lmax), lmax, a_t.shape[0])


def synthesize_spin1_large(e_re, e_im, b_re, b_im, nside: int, lmax: int,
                           tables: Optional[Spin1LargeTables] = None,
                           device=None):
    """Spin-1 (E = gradient, B = curl) alms -> (alpha_theta, alpha_phi) at
    large lmax (the convention of ops.sht_spin.synthesize_spin1; lmax <=
    4*nside - 1)."""
    _check_lmax(nside, lmax)
    alms = _alms4((e_re, e_im, b_re, b_im), device,
                  None if tables is None else tables.base)
    tab = tables if tables is not None else spin1_large_tables(
        nside, lmax, alms[0].device)
    return _synth_spin1_large_impl(*alms, tab, nside, lmax)


def analyze_spin1_large(a_t, a_p, nside: int, lmax: int, niter: int = 3,
                        tables: Optional[Spin1LargeTables] = None,
                        method: str = "auto", device=None):
    """(alpha_theta, alpha_phi) maps -> (E_re, E_im, B_re, B_im) at large
    lmax (method semantics as analyze_spin2_large)."""
    _check_method(method)
    _check_lmax(nside, lmax)
    a_t, a_p = _maps2(a_t, a_p, device,
                      None if tables is None else tables.base)
    tab = tables if tables is not None else spin1_large_tables(
        nside, lmax, a_t.device)
    return _analyze_spin_generic(a_t, a_p, nside, lmax, niter, method, tab,
                                 _synth_spin1_large_impl,
                                 _adjoint_spin1_large_impl)


def deflection_from_kappa_alm_large(k_re, k_im, nside: int, lmax: int,
                                    tables: Optional[Spin1LargeTables]
                                    = None, device=None):
    """kappa alms -> deflection maps at large lmax (the counterpart of
    ops.sht_spin.deflection_from_kappa_alm, whose deflection_E_factor is
    the one convention home)."""
    from .sht_spin import deflection_E_factor

    k_re, k_im = _alms4((k_re, k_im), device,
                        None if tables is None else tables.base)
    inv = deflection_E_factor(lmax, k_re.device)
    z = torch.zeros_like(k_re)
    return synthesize_spin1_large(k_re * inv, k_im * inv, z, z, nside,
                                  lmax, tables=tables)
