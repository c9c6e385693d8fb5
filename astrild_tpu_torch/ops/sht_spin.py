"""Spin-2 spherical-harmonic transforms on the table path: full-sky shear
E/B synthesis and analysis (healpy alm2map_spin / map2alm_spin parity),
the full-sky spin-2 MASTER estimator, and the Wigner d-function rows of
the curved-sky two-point sums.

Port of the spin-2 half of astrild_tpu/ops/sht_spin.py. Spin-weighted
harmonics come from Wigner small-d functions, with the convention pinned
to the scalar transforms of ops/sht.py:

    lambda_lm(theta) = sqrt((2l+1)/4pi) d^l_{0,m}(theta),
    sY_lm(theta,phi) = sqrt((2l+1)/4pi) d^l_{-s,m}(theta) e^{im phi},

and the healpy sign convention Q + iU = -sum_lm (E_lm + i B_lm) 2Y_lm (for
shear read gamma1 = Q, gamma2 = U). The d^l_{+-2,m} tables are built on
the host in float64 (the JAX package's numpy, bit for bit) and uploaded as
float32; the contractions are elementwise products and sums (no matrix
product, so a caller's TF32 setting cannot reach them). The analysis
adjoint is the exact transpose of the synthesis, written out (the JAX
package takes it from jax.vjp), with 4pi/npix weights and Jacobi
refinement.

The spin-1 half (deflection fields: `Spin1Tables` ..
`kappa_omega_alm_from_deflection`) waits for ROADMAP queue 1 item 6b.
"""
from __future__ import annotations

from functools import lru_cache
from math import lgamma
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import as_tensor
from ..utils import healpix as hpx
from .sht import (_TABLE_LMAX, _analysis_cl, _binned_shape_ops,
                  _device_key, _gaussian_alms, _host64, _legendre_sum,
                  _legendre_sum_t, _map, _phase_sum, _phase_sum_t, _spectrum,
                  _upload, _white_device, alm2cl, ring_geometry,
                  sht_tables)

__all__ = ["Spin2Tables", "spin2_tables", "wigner_d_column",
           "synthesize_spin2", "analyze_spin2", "anafast_spin2",
           "synfast_spin2", "synfast_spin2_from_white",
           "kappa_alm_to_shear_alm", "spin2_coupling_matrices_from_mask_cl",
           "anafast_spin2_master", "_wigner_d_l_rows"]


def wigner_d_column(lmax: int, costheta: np.ndarray, m1: int) -> np.ndarray:
    """Wigner d^l_{m1, m}(beta) for all l <= lmax, 0 <= m <= l.

    Standard convention (d^l_{0,m} reproduces the normalized Legendre
    table; d^2_{2,m} matches the closed forms). Stable upward three-term
    recursion in l, float64; shape (lmax+1, lmax+1, ntheta).
    """
    x = np.asarray(costheta, np.float64)
    nt = x.size
    ch = np.sqrt((1.0 + x) / 2.0)
    sh = np.sqrt((1.0 - x) / 2.0)
    L = lmax
    out = np.zeros((L + 1, L + 1, nt))
    for m in range(0, L + 1):
        l0 = max(abs(m1), m)
        if l0 > L:
            break
        if l0 == 0:
            d0 = np.ones(nt)
        elif m >= abs(m1):      # seed at j = m
            lnC = 0.5 * (lgamma(2 * m + 1) - lgamma(m + m1 + 1)
                         - lgamma(m - m1 + 1))
            d0 = ((-1.0) ** (m - m1) * np.exp(lnC)
                  * ch ** (m + m1) * sh ** (m - m1))
        elif m1 > 0:            # seed at j = m1 > m
            j = m1
            lnC = 0.5 * (lgamma(2 * j + 1) - lgamma(j + m + 1)
                         - lgamma(j - m + 1))
            d0 = np.exp(lnC) * ch ** (j + m) * (-sh) ** (j - m)
        else:                   # seed at j = -m1 > m
            j = -m1
            lnC = 0.5 * (lgamma(2 * j + 1) - lgamma(j + m + 1)
                         - lgamma(j - m + 1))
            d0 = np.exp(lnC) * ch ** (j - m) * sh ** (j + m)
        out[l0, m] = d0
        dm1, dm2 = d0, np.zeros(nt)
        for l in range(l0 + 1, L + 1):
            if l == 1 and l0 == 0:
                d = x.copy()    # d^1_{0,0}; recursion 0/0 at l-1 = 0
            else:
                den = (l - 1.0) * np.sqrt(
                    (l * l - m1 * m1) * (l * l - m * m))
                a = (2.0 * l - 1.0) * (l * (l - 1.0) * x - m1 * m) / den
                b = (l * np.sqrt(((l - 1.0) ** 2 - m1 * m1)
                                 * ((l - 1.0) ** 2 - m * m)) / den)
                d = a * dm1 - b * dm2
            out[l, m] = d
            dm2, dm1 = dm1, d
    return out


class Spin2Tables(NamedTuple):
    """Device tables for the spin-2 channel (the scalar ring phases)."""
    lam_p: torch.Tensor     # (L+1, L+1, nring)  2lambda_lm
    lam_m2: torch.Tensor    # (L+1, L+1, nring)  the folded m < 0 branch
    cosmphi: torch.Tensor
    sinmphi: torch.Tensor
    flat_idx: torch.Tensor
    pad_idx: torch.Tensor
    pad_valid: torch.Tensor


@lru_cache(maxsize=4)
def _spin2_tables(nside: int, lmax: int, dev) -> Spin2Tables:
    geo = ring_geometry(nside)
    x = np.cos(geo.theta)
    norm = np.sqrt((2.0 * np.arange(lmax + 1) + 1.0)
                   / (4.0 * np.pi))[:, None, None]
    # 2Y_{l,m>=0}: d_{-2,m}; the negative-m fold 2Y_{l,-mu} = (-1)^mu
    # d_{2,mu} e^{-i mu phi} norm meets the reality factor (-1)^mu of
    # a_{l,-mu}, so the folded table is the unsigned d_{2,m} column. Each
    # float64 cube is freed after its upload.
    lam_p = _upload(norm * wigner_d_column(lmax, x, -2), dev)
    lam_m = _upload(norm * wigner_d_column(lmax, x, 2), dev)
    scal = sht_tables(nside, lmax, dev)
    return Spin2Tables(lam_p, lam_m, scal.cosmphi, scal.sinmphi,
                       scal.flat_idx, scal.pad_idx, scal.pad_valid)


def spin2_tables(nside: int, lmax: int, device=None) -> Spin2Tables:
    """The spin-2 table path's device tables, cached per device."""
    return _spin2_tables(nside, lmax, _device_key(device))


def _m_positive(lmax: int, device) -> torch.Tensor:
    """(lmax+1, 1): 1 for m > 0, 0 for m = 0."""
    p = torch.ones((lmax + 1, 1), device=device)
    p[0] = 0.0
    return p


def _synth_spin2_impl(e_re, e_im, b_re, b_im, tab: Spin2Tables):
    """(E, B) alms -> (Q, U) RING maps; Q+iU = -sum (E+iB) 2Y_lm."""
    def A(a):   # m >= 0 branch: contraction with 2lambda
        return _legendre_sum(tab.lam_p, a)

    def M(a):   # m < 0 branch folded to m > 0 via reality + symmetry
        return _legendre_sum(tab.lam_m2, a)

    gp_re = -(A(e_re) - A(b_im))
    gp_im = -(A(e_im) + A(b_re))
    gm_re = -(M(e_re) + M(b_im))
    gm_im = M(e_im) - M(b_re)
    p = _m_positive(e_re.shape[1] - 1, e_re.device)
    qc = gp_re + p * gm_re
    qs = -gp_im + p * gm_im
    uc = gp_im + p * gm_im
    us = gp_re - p * gm_re
    q_pad = _phase_sum(qc, tab.cosmphi) + _phase_sum(qs, tab.sinmphi)
    u_pad = _phase_sum(uc, tab.cosmphi) + _phase_sum(us, tab.sinmphi)
    return (q_pad.reshape(-1)[tab.flat_idx],
            u_pad.reshape(-1)[tab.flat_idx])


def _alms4(alms, device, tables):
    """Four alm arrays placed as `sht._map` places the first."""
    first = _map(alms[0], device, tables)
    return (first,) + tuple(as_tensor(a, first.device) for a in alms[1:])


def _maps2(q, u, device, tables):
    q = _map(q, device, tables)
    return q, as_tensor(u, q.device)


def synthesize_spin2(e_re, e_im, b_re, b_im, nside: int, lmax: int,
                     tables: Optional[Spin2Tables] = None, device=None):
    """(E, B) [l, m] real/imag alms -> (Q, U) maps (alm2map_spin, spin=2).

    For lensing shear read (gamma1, gamma2) = (Q, U). m > l entries and
    alm_im[:, 0] must be zero (real-field conventions as the scalar path).
    """
    alms = _alms4((e_re, e_im, b_re, b_im), device, tables)
    tab = tables if tables is not None else spin2_tables(nside, lmax,
                                                         alms[0].device)
    return _synth_spin2_impl(*alms, tab)


def _alm_masks(lmax: int, npix: int, device, lmin: int = 2):
    """(vre, vim): 4pi/npix quadrature weight, the triangle l >= lmin and
    the m > 0 half. The m > 0 rows of the exact transpose count both fold
    branches (the e^{+im phi} and e^{-im phi} pieces of a real pair each
    see the mode), so the quadrature inverse needs a 1/2 there: without
    it S^T S ~ 2I for m > 0 and the Jacobi refinement diverges."""
    wq = 4.0 * np.pi / npix
    lg = torch.arange(lmax + 1, device=device)[:, None]
    mg = torch.arange(lmax + 1, device=device)[None, :]
    valid = (mg <= lg) & (lg >= lmin)
    half = torch.where(mg == 0, 1.0, 0.5)
    vre = valid.to(torch.float32) * half * wq
    vim = (valid & (mg > 0)).to(torch.float32) * half * wq
    return vre, vim


def _fold_transpose(dqc, dqs, duc, dus, p):
    """Transpose of the (gp, gm) -> (q, u) phase channels: the quadrature
    sums of Q and U against cos / sin -> (dgp_re, dgp_im, dgm_re,
    dgm_im), the m = 0 row of the folded branch zero."""
    return (dqc + dus, -dqs + duc, p * (dqc - dus), p * (dqs + duc))


def _branch_transpose(Ar, Ai, Mr, Mi):
    """Transpose of the alm -> (gp, gm) fold: the plus branch's (Ar, Ai)
    and the folded branch's (Mr, Mi) Legendre sums -> (der, dei, dbr,
    dbi)."""
    return -(Ar + Mr), -Ai + Mi, -(Ai + Mi), Ar - Mr


def _adjoint_spin2(q, u, tab: Spin2Tables):
    """Exact transpose of the synthesis with 4pi/npix weights."""
    npix = q.shape[0]
    L = tab.lam_p.shape[0] - 1
    shape = tab.cosmphi.shape[1:]
    qp = (q[tab.pad_idx] * tab.pad_valid).reshape(shape)
    up = (u[tab.pad_idx] * tab.pad_valid).reshape(shape)
    p = _m_positive(L, q.device)
    dgp_re, dgp_im, dgm_re, dgm_im = _fold_transpose(
        _phase_sum_t(qp, tab.cosmphi), _phase_sum_t(qp, tab.sinmphi),
        _phase_sum_t(up, tab.cosmphi), _phase_sum_t(up, tab.sinmphi), p)
    der, dei, dbr, dbi = _branch_transpose(
        _legendre_sum_t(tab.lam_p, dgp_re), _legendre_sum_t(tab.lam_p, dgp_im),
        _legendre_sum_t(tab.lam_m2, dgm_re),
        _legendre_sum_t(tab.lam_m2, dgm_im))
    vre, vim = _alm_masks(L, npix, q.device)
    return der * vre, dei * vim, dbr * vre, dbi * vim


def analyze_spin2(q, u, nside: int, lmax: int, niter: int = 3,
                  tables: Optional[Spin2Tables] = None, device=None):
    """(Q, U) maps -> (E_re, E_im, B_re, B_im) (map2alm_spin, spin=2)."""
    q, u = _maps2(q, u, device, tables)
    tab = tables if tables is not None else spin2_tables(nside, lmax,
                                                         q.device)
    alm = _adjoint_spin2(q, u, tab)
    for _ in range(niter):
        sq, su = _synth_spin2_impl(*alm, tab)
        d = _adjoint_spin2(q - sq, u - su, tab)
        alm = tuple(a + da for a, da in zip(alm, d))
    return alm


def _eb_spectra(er, ei, br, bi):
    """(Cl_EE, Cl_BB, Cl_EB) of E/B alms; EB by the polarization identity
    through alm2cl (one home of the (l, m) weighting)."""
    ee = alm2cl(er, ei)
    bb = alm2cl(br, bi)
    pp = alm2cl(er + br, ei + bi)
    mm = alm2cl(er - br, ei - bi)
    return ee, bb, 0.25 * (pp - mm)


def anafast_spin2(q, u, lmax: int, niter: int = 3,
                  tables: Optional[Spin2Tables] = None, device=None):
    """(Cl_EE, Cl_BB, Cl_EB) of a spin-2 (shear/polarization) map pair."""
    q, u = _maps2(q, u, device, tables)
    nside = hpx.npix2nside(q.shape[0])
    return _eb_spectra(*analyze_spin2(q, u, nside, lmax, niter=niter,
                                     tables=tables))


def _spin2_alms_from_white(white, cl_ee, cl_bb, L: int):
    """E and B alms of spectra cl_ee, cl_bb from four N(0, 1) draws
    (ee_re, ee_im, bb_re, bb_im), zero below l = 2."""
    er, ei = _gaussian_alms(white[0], white[1], cl_ee, L, lmin=2)
    br, bi = _gaussian_alms(white[2], white[3], cl_bb, L, lmin=2)
    return er, ei, br, bi


def synfast_spin2_from_white(white, cl_ee, cl_bb, nside: int,
                             lmax: Optional[int] = None,
                             tables: Optional[Spin2Tables] = None,
                             device=None):
    """`synfast_spin2` of four given N(0, 1) draws, each (lmax+1, lmax+1):
    the JAX package's normal(k1), normal(k2) of `k1, k2 = split(ka)` for
    EE and then of `split(kb)` for BB, where `ka, kb = split(key)`."""
    if not isinstance(cl_ee, torch.Tensor):
        device = _white_device(white[0], device, tables)
    cl_ee, L = _spectrum(cl_ee, lmax, device)
    cl_bb = as_tensor(cl_bb, cl_ee.device)
    alms = _spin2_alms_from_white(white, cl_ee, cl_bb, L)
    return synthesize_spin2(*alms, nside, L, tables=tables)


def _white4(generator: torch.Generator, L: int):
    return tuple(torch.randn((L + 1, L + 1), generator=generator,
                             device=generator.device) for _ in range(4))


def synfast_spin2(generator: torch.Generator, cl_ee, cl_bb, nside: int,
                  lmax: Optional[int] = None,
                  tables: Optional[Spin2Tables] = None):
    """Gaussian (Q, U) realization from EE/BB spectra on the generator's
    device (another realization than the JAX package's key)."""
    cl_ee, L = _spectrum(cl_ee, lmax, generator.device)
    return synfast_spin2_from_white(_white4(generator, L), cl_ee, cl_bb,
                                    nside, L, tables=tables)


def kappa_alm_to_shear_alm(k_re, k_im):
    """E_lm = sqrt((l+2)(l-1) / (l(l+1))) kappa_lm (B = 0): the full-sky
    kappa -> gamma relation (the spherical Kaiser-Squires forward)."""
    L = k_re.shape[0] - 1
    ell = torch.arange(L + 1, dtype=torch.float32, device=k_re.device)
    fac = torch.sqrt(torch.where(
        ell >= 2, (ell + 2.0) * (ell - 1.0)
        / torch.clamp_min(ell * (ell + 1.0), 1.0), 0.0))
    return k_re * fac[:, None], k_im * fac[:, None]


def _wigner_d_l_rows(lmax: int, x: np.ndarray, m1: int, m: int):
    """d^l_{m1, m}(x) for all l <= lmax at the nodes x — one (m1, m)
    column of the Wigner d cube without materializing the (L+1)^2 cube.
    Host float64; (lmax+1, nx). Requires m >= |m1| (the seed branch the
    couplings use: m=2, m1=+-2)."""
    assert m >= abs(m1)
    x = np.asarray(x, np.float64)
    out = np.zeros((lmax + 1, x.size))
    l0 = m
    if l0 > lmax:
        return out
    ch = np.sqrt((1.0 + x) / 2.0)
    sh = np.sqrt((1.0 - x) / 2.0)
    lnC = 0.5 * (lgamma(2 * m + 1) - lgamma(m + m1 + 1)
                 - lgamma(m - m1 + 1))
    d0 = ((-1.0) ** (m - m1) * np.exp(lnC)
          * ch ** (m + m1) * sh ** (m - m1))
    out[l0] = d0
    dm1, dm2 = d0, np.zeros_like(d0)
    for l in range(l0 + 1, lmax + 1):
        den = (l - 1.0) * np.sqrt((l * l - m1 * m1) * (l * l - m * m))
        if den == 0.0:
            # only the (m1=0, m=0, l=1) step degenerates (0/0); its
            # limit is the Legendre relation d^1_{00} = x d^0_{00}
            d = x * dm1
        else:
            a = (2.0 * l - 1.0) * (l * (l - 1.0) * x - m1 * m) / den
            b = (l * np.sqrt(((l - 1.0) ** 2 - m1 * m1)
                             * ((l - 1.0) ** 2 - m * m)) / den)
            d = a * dm1 - b * dm2
        out[l] = d
        dm2, dm1 = dm1, d
    return out


def spin2_coupling_matrices_from_mask_cl(mask_cl, lmax: int):
    """(M_pp, M_pm): full-sky spin-2 MASTER couplings, Wigner-free.

    Hivon-style spin-2 mode coupling (Brown et al. 2005 / NaMaster):

        M_pp/pm[l1,l2] = (2 l2 + 1)/(8 pi) sum_l3 (2 l3 + 1) W_l3
                         wigner3j(l1,l2,l3; 2,-2,0)^2 (1 +- (-1)^L)

    with <pEE> = M_pp C_EE + M_pm C_BB and EE<->BB swapped for <pBB>,
    evaluated through the d-function product identities

        int d^l1_{22} d^l2_{22} P_l3 dx = 2 * 3j(2,-2,0)^2
        int d^l1_{2,-2} d^l2_{2,-2} P_l3 dx = 2 * 3j(2,-2,0)^2 (-1)^L

    so M_pp/pm = (2 l2 + 1)/4 int xi_W(x) [d22 d22 +- d2m2 d2m2] dx on
    an exact Gauss-Legendre grid. A unit mask gives M_pp = 1 (l >= 2
    diagonal), M_pm = 0. Host float64 numpy (the JAX package's, bit for
    bit).
    """
    wl = np.asarray(mask_cl, np.float64)
    lmax_w = wl.shape[0] - 1
    deg = 2 * lmax + lmax_w
    ngl = deg // 2 + 2
    mu, gw = np.polynomial.legendre.leggauss(ngl)
    P = np.zeros((lmax_w + 1, ngl))
    P[0] = 1.0
    if lmax_w >= 1:
        P[1] = mu
    for ell in range(2, lmax_w + 1):
        P[ell] = ((2 * ell - 1) * mu * P[ell - 1]
                  - (ell - 1) * P[ell - 2]) / ell
    l3 = np.arange(lmax_w + 1)
    xi = ((2 * l3 + 1) / (4 * np.pi) * wl) @ P          # (ngl,)
    d22 = _wigner_d_l_rows(lmax, mu, 2, 2)              # (lmax+1, ngl)
    d2m2 = _wigner_d_l_rows(lmax, mu, -2, 2)
    w = gw * xi
    A = (d22 * w[None, :]) @ d22.T
    Bm = (d2m2 * w[None, :]) @ d2m2.T
    fac = (2.0 * np.arange(lmax + 1, dtype=np.float64) + 1.0)[None, :] / 4.0
    return (A + Bm) * fac, (A - Bm) * fac


def _analysis_spin2_cl(q, u, lmax: int, niter: int):
    """anafast_spin2 on the table path up to lmax 512, on the scan path
    above."""
    if lmax <= _TABLE_LMAX:
        return anafast_spin2(q, u, lmax, niter=niter)
    from .sht_spin_large import anafast_spin2_large

    return anafast_spin2_large(q, u, lmax, niter=niter)


def anafast_spin2_master(q, u, mask, lmax: int, nbins: int = 16,
                         niter: int = 3, lmin: int = 2,
                         lmax_mask: Optional[int] = None,
                         coupling=None, device=None):
    """Mask-decoupled full-sky shear/polarization band powers.

    The spin-2 MASTER estimator: pseudo EE/BB of the masked (Q, U) maps,
    the (M_pp, M_pm) couplings from the mask spectrum (host float64),
    binned 2x2-block solve, undoing both the mask's power suppression and
    its E->B leakage (the flat-sky counterpart is
    angular_power.cl_flat_sky_shear_master). Returns (ell_eff, cl_ee_hat,
    cl_bb_hat), float32 tensors on the maps' device. Analyses take the
    scan path beyond lmax 512, like anafast_master.
    """
    q, u = _maps2(q, u, device, None)
    mask = as_tensor(mask, q.device)
    nside = hpx.npix2nside(q.shape[0])
    if lmax_mask is None:
        lmax_mask = min(2 * lmax, 2 * nside)
    p_ee, p_bb, _ = _analysis_spin2_cl(q * mask, u * mask, lmax, niter)
    if coupling is None:
        wl = _analysis_cl(mask, lmax_mask, niter)
        M_pp, M_pm = spin2_coupling_matrices_from_mask_cl(_host64(wl), lmax)
    else:
        M_pp, M_pm = (_host64(c) for c in coupling)
    B, Q, ell_eff = _binned_shape_ops(lmax, nbins, lmin)
    Mb_pp = B @ M_pp @ Q
    Mb_pm = B @ M_pm @ Q
    big = np.block([[Mb_pp, Mb_pm], [Mb_pm, Mb_pp]])
    rhs = np.concatenate([B @ _host64(p_ee), B @ _host64(p_bb)])
    sol = np.linalg.solve(big, rhs).astype(np.float32)
    dev = q.device
    return (torch.from_numpy(ell_eff).to(dev),
            torch.from_numpy(sol[:nbins]).to(dev),
            torch.from_numpy(sol[nbins:]).to(dev))
