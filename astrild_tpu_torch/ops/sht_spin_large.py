"""Large-lmax spin-2 transforms: full-sky shear E/B at production scale.

Port of the spin-2 half of astrild_tpu/ops/sht_spin_large.py, the
counterpart of the spin-2 table path (ops/sht_spin.py) on the
ops/sht_large architecture: the d^l_{+-2,m}(theta) functions are never
stored; one Wigner-d three-term upward recursion over l runs for all m at
once (the rows whose seed l0 = max(m, 2) <= l active at step l), with the
same 2^60 underflow rescaling, accumulating the contraction with the
(E, B) alms (synthesis) or the ring quadrature sums (the analysis
adjoint). Both recursions (m1 = -2 and +2) run on the northern rings and
the equator: a southern ring's d^l_{-2,m} is (-1)^(l+m) its mirror's
d^l_{2,m} and vice versa, so each recursion also sums the other branch
for the south (graphed on the card as in sht_large).

Spin-2 specifics against the scalar recursion:
  * the recursion multiplies by (alpha*x + beta) instead of a*x (the
    d-recursion has an m1*m shift term);
  * seeds sit at l0 = max(m, 2): closed forms of d^2_{+-2, m} for m < 2,
    and the log2-scaled cos/sin(theta/2)-power seeds for m >= 2 (host
    float64 log2 half-angle tables);
  * the belt synthesis is one complex inverse FFT per ring (Q+iU has
    independent +-m coefficients; bins taken mod n are the exact aliasing
    of equally spaced pixels);
  * the adjoint is written out: one complex FFT of Q+iU per belt ring and
    the analysis-mode recursions, transposed against the synthesis fold.

The cap trig sums and belt phase rotations are ops/sht_large's. The
recursions accumulate the alm combinations the fold needs (two a
branch, not four). Conventions are ops/sht_spin.py's (Q + iU = -sum
(E+iB) 2Y_lm). The spin-1 half (`Spin1LargeTables` ..
`deflection_from_kappa_alm_large`) waits for ROADMAP queue 1 item 6b.
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
                        _rotate_phase, _unfold_south, sht_large_tables)
from .sht_spin import (_alm_masks, _alms4, _branch_transpose, _eb_spectra,
                       _fold_transpose, _m_positive, _maps2)

__all__ = ["Spin2LargeTables", "spin2_large_tables", "synthesize_spin2_large",
           "analyze_spin2_large", "anafast_spin2_large"]


class SpinRecursion(NamedTuple):
    """One spin column m1's seeds and recursion coefficients."""
    seed_frac: torch.Tensor    # (lmax+1, nring) scaled d^{l0}_{m1, m}
    seed_scale: torch.Tensor   # (lmax+1, nring) its scale s
    alpha: torch.Tensor        # (lmax+1, lmax+1) [l, m] x-coefficient
    beta: torch.Tensor         # (lmax+1, lmax+1) shift
    gamma: torch.Tensor        # (lmax+1, lmax+1) two-back coefficient


class Spin2LargeTables(NamedTuple):
    base: LargeSHTTables
    log2_ch: torch.Tensor    # (nring,) log2 cos(theta/2), host float64
    log2_sh: torch.Tensor    # (nring,) log2 sin(theta/2)
    seed2_p: torch.Tensor    # (2, nring) d^2_{+2, m} for m = 0, 1
    seed2_m: torch.Tensor    # (2, nring) d^2_{-2, m} for m = 0, 1
    lnc: torch.Tensor        # (lmax+1,) log2 seed amplitude (the same for
                             # m1 = +-2)
    norm: torch.Tensor       # (lmax+1,) sqrt((2l+1)/4pi), float32
    rec_m: SpinRecursion     # m1 = -2: the plus branch
    rec_p: SpinRecursion     # m1 = +2: the folded branch


def _spin_seed_state(m1: int, lnc, log2_ch, log2_sh, seeds):
    """Scaled d^{l0}_{m1, m} seeds (frac, scale) for every (m, ring):
    |seed| = C ch^(m+m1) sh^(m-m1), sign (-1)^(m-m1); the closed-form
    rows of `seeds` for m < 2 (no underflow there)."""
    m = torch.arange(lnc.shape[0], dtype=torch.float32,
                     device=lnc.device)[:, None]
    log2_mag = (lnc[:, None] + (m + m1) * log2_ch[None, :]
                + (m - m1) * log2_sh[None, :])
    s0 = torch.clamp_min(torch.ceil((-log2_mag - 29.0) / 60.0), 0.0)
    sign = torch.where(torch.remainder(m, 2.0) == 0.0, 1.0, -1.0)
    frac = sign * torch.exp2(log2_mag + 60.0 * s0)
    row_lo = torch.where(m == 0.0, seeds[0][None, :], seeds[1][None, :])
    frac = torch.where(m < 2, row_lo, frac)
    s0 = torch.where(m < 2, 0.0, s0)
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


@lru_cache(maxsize=4)
def _spin2_large_tables(nside: int, lmax: int, dev) -> Spin2LargeTables:
    base = sht_large_tables(nside, lmax, dev)
    geo = ring_geometry(nside)
    th = np.asarray(geo.theta, np.float64)
    x = np.cos(th)
    ch = np.cos(th / 2.0)
    sh = np.sin(th / 2.0)
    s = np.sin(th)
    # closed-form l0=2 seeds for m = 0, 1: d^2_{2,0} = d^2_{-2,0} =
    # sqrt(6)/4 sin^2, d^2_{2,1} = -(1+x)/2 sin, d^2_{-2,1} = (1-x)/2 sin
    seed2_p = np.stack([np.sqrt(6.0) / 4.0 * s * s,
                        -(1.0 + x) / 2.0 * s])
    seed2_m = np.stack([np.sqrt(6.0) / 4.0 * s * s,
                        (1.0 - x) / 2.0 * s])
    # seed amplitude log2 for m >= 2: sqrt((2m)!/((m+m1)!(m-m1)!))
    ms = np.arange(lmax + 1)
    ln2 = np.log(2.0)
    lnc = np.array([0.5 * (lgamma(2 * m + 1) - lgamma(m + 3)
                           - lgamma(m - 1)) / ln2 if m >= 2 else 0.0
                    for m in ms])
    log2_ch = _upload(np.log2(np.maximum(ch, 1e-300)), dev)
    log2_sh = _upload(np.log2(np.maximum(sh, 1e-300)), dev)
    sp, sm = _upload(seed2_p, dev), _upload(seed2_m, dev)
    lnc_t = _upload(lnc, dev)
    lf = torch.arange(lmax + 1, dtype=torch.float32, device=dev)
    norm = torch.sqrt((2.0 * lf + 1.0) / (4.0 * np.pi))

    def recursion(m1, seeds):
        frac, s0 = _spin_seed_state(m1, lnc_t, log2_ch, log2_sh, seeds)
        return SpinRecursion(frac, s0, *_spin_coeffs(lmax, m1, dev))

    return Spin2LargeTables(base, log2_ch, log2_sh, sp, sm, lnc_t, norm,
                            recursion(-2, sm), recursion(2, sp))


def spin2_large_tables(nside: int, lmax: int, device=None
                       ) -> Spin2LargeTables:
    """The spin-2 scan path's device arrays, cached per device; raises
    ValueError for lmax > 4*nside - 1."""
    _check_lmax(nside, lmax)
    return _spin2_large_tables(nside, lmax, _device_key(device))


def _spin_steps(tab: Spin2LargeTables, rec: SpinRecursion, lmax: int,
                inp, synth: bool):
    """The Wigner-d recursion over l for all m at once, one spin column, on
    the north rings and the equator (sht_large._accumulate gives the
    shapes); norm_l = sqrt((2l+1)/4pi) included."""
    nh = _north(tab.base.x.shape[0])
    x = tab.base.x[:nh]
    L1 = lmax + 1
    prev, curr, nxt = (torch.zeros((L1, nh), device=x.device)
                       for _ in range(3))
    s = rec.seed_scale[:, :nh].clone()
    nch = inp.shape[0] if synth else inp.shape[1]
    out = torch.zeros((2, nch, L1, nh) if synth else (nch, L1, L1),
                      device=x.device)
    for l in range(2, L1):
        k = l + 1
        nk, ck, sk = nxt[:k], curr[:k], s[:k]
        # p_next = (alpha x + beta) p_curr + gamma p_prev; the rows whose
        # l0 = l take their seeds (rows 0, 1 and 2 at l = 2)
        coef = torch.addcmul(rec.beta[l, :k, None], rec.alpha[l, :k, None],
                             x)
        torch.mul(coef, ck, out=nk)
        nk.addcmul_(rec.gamma[l, :k, None], prev[:k])
        if l == 2:
            nk.copy_(rec.seed_frac[:3, :nh])
        else:
            nk[l] = rec.seed_frac[l, :nh]
        lam = _rescale_step(nk, ck, sk) * tab.norm[l]
        _accumulate(out, inp, l, k, lam, synth)
        prev, curr, nxt = curr, nxt, prev
    return out


def _spin_loop(tab: Spin2LargeTables, rec: SpinRecursion, lmax: int, inp,
               synth: bool):
    """`_spin_steps` of one spin column, graphed on the card."""
    with _span("sht.legendre"):
        return _graphed(("spin", synth, id(rec)), (tab, rec),
                        lambda z: _spin_steps(tab, rec, lmax, z, synth),
                        inp)


def _fold_coeffs(tab: Spin2LargeTables, lmax: int, e_re, e_im, b_re,
                 b_im):
    """(gp_re, gp_im, gm_re, gm_im) ring coefficients, (lmax+1, nring):
    gp_m multiplies e^{+im phi}, gm_m e^{-im phi} (m > 0). gp = -A(E + iB)
    through d_{-2,m}, gm = the fold through d_{2,m}. A ring's d_{-2,m} is
    (-1)^(l+m) its mirror ring's d_{2,m}: each north recursion sums its own
    branch's alm combinations for the north rings and the other branch's
    for the south."""
    nring = tab.base.x.shape[0]
    rows_p = torch.stack([b_im - e_re, -(e_im + b_re)])
    rows_m = torch.stack([-(e_re + b_im), e_im - b_re])
    north_m, south_m = _unfold_south(_spin_loop(
        tab, tab.rec_m, lmax, torch.cat([rows_p, rows_m]), True), nring)
    north_p, south_p = _unfold_south(_spin_loop(
        tab, tab.rec_p, lmax, torch.cat([rows_m, rows_p]), True), nring)
    gp = torch.cat([north_m[:2], south_p[2:]], dim=-1)
    gm = torch.cat([north_p[:2], south_m[2:]], dim=-1)
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


def _adjoint_spin2_large_impl(q, u, tab: Spin2LargeTables, nside: int,
                              lmax: int):
    """Quadrature adjoint: the exact transpose with 4pi/npix and the m > 0
    halves folded in (sht_spin._adjoint_spin2's normalization)."""
    npix = q.shape[0]
    nh = _north(tab.base.x.shape[0])
    dgp_re, dgp_im, dgm_re, dgm_im = _spin_quadrature_sums(q, u, tab,
                                                           nside, lmax)
    # each north recursion sums its own branch over the north rings and the
    # other branch over the south ones (see _fold_coeffs)
    qp = torch.stack([dgp_re, dgp_im])
    qm = torch.stack([dgm_re, dgm_im])
    out_m = _spin_loop(tab, tab.rec_m, lmax, _parity_inputs(
        qp[..., :nh], _mirror_signed(qm[..., nh:], nh)), False)
    out_p = _spin_loop(tab, tab.rec_p, lmax, _parity_inputs(
        qm[..., :nh], _mirror_signed(qp[..., nh:], nh)), False)
    a = out_m[:2] + out_p[2:]
    m = out_p[:2] + out_m[2:]
    der, dei, dbr, dbi = _branch_transpose(a[0], a[1], m[0], m[1])
    vre, vim = _alm_masks(lmax, npix, q.device)
    return der * vre, dei * vim, dbr * vre, dbi * vim


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
