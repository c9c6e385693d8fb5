"""BAO acoustic-scale fitting: damped wiggle template + profile
likelihood over the dilation parameter alpha.

Port of astrild_tpu/ops/bao.py. The fits run on the host in float64 numpy
(a few dozen binned numbers; the broadband design matrix's column scales
span ~1e4, too wide for float32 normal equations); the template's spectra
come from the port's ops.linear_power once, on `device` (by default the
CUDA card, as for any numpy input; it raises without one: pass
device="cpu"), and are read back. The numpy code is the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..utils.cosmology import Cosmology
from .linear_power import (eh98_transfer, eh98_transfer_nowiggle,
                           linear_power_nowiggle)


def _host64(t):
    """A torch spectrum as host float64 numpy."""
    return t.detach().cpu().numpy().astype(np.float64)

__all__ = ["wiggle_ratio", "bao_template_power", "fit_bao_scale",
           "fit_bao_scale_aniso", "BAOFit", "BAOFitAniso"]


def wiggle_ratio(k_hmpc, cosmo: Cosmology, device=None):
    """O(k) = P_lin / P_nowiggle = (T / T_nw)^2 (host float64).

    Pure acoustic oscillation pattern: amplitude, growth and the k^ns
    tilt cancel exactly in the ratio; the broadband is ~1 by
    construction of the EH98 zero-baryon shape fit.
    """
    k = np.asarray(k_hmpc, np.float64)
    num = _host64(eh98_transfer(k, cosmo, device=device))
    den = _host64(eh98_transfer_nowiggle(k, cosmo, device=device))
    return (num / den) ** 2


def bao_template_power(k_hmpc, cosmo: Cosmology, alpha: float = 1.0,
                       sigma_nl: float = 8.0, device=None):
    """Damped, dilated BAO template (host float64, (Mpc/h)^3 at z=0):

        t(k; alpha) = P_nw(k) * [1 + (O(k/alpha) - 1) e^{-k^2 Snl^2/2}]

    Only the wiggle pattern dilates — the broadband stays at the
    observed k, as in standard fits (broadband errors are absorbed by
    the marginalized polynomials, not by alpha). alpha > 1 moves the
    model's wiggle nodes to HIGHER observed k; operationally, data
    carrying the pattern O(k / a_true) is recovered at alpha = a_true
    (pinned by tests/test_bao.py).
    """
    k = np.asarray(k_hmpc, np.float64)
    p_nw = _host64(linear_power_nowiggle(k, cosmo, device=device))
    o = wiggle_ratio(k / float(alpha), cosmo, device=device)
    damp = np.exp(-0.5 * (k * float(sigma_nl)) ** 2)
    return p_nw * (1.0 + (o - 1.0) * damp)


class BAOFit(NamedTuple):
    alpha: float          # best-fit dilation
    alpha_err: float      # 1-sigma from the delta-chi2 = 1 curvature
    chi2: float           # at the best fit
    dof: int              # n_bins - (1 alpha + 1 amplitude + n_poly)
    alphas: np.ndarray    # profile grid
    chi2_curve: np.ndarray
    bias2: float          # template amplitude B^2
    broadband: np.ndarray  # polynomial coefficients, one per poly power
    kfit: np.ndarray      # k bins used
    model: np.ndarray     # best-fit model at kfit


def _whiten(k, pk, sigma, cov):
    """Return (W, y) with W the whitening operator applied to model
    columns and y = W @ data, so chi2 = ||y - W m||^2."""
    n = len(k)
    if cov is not None:
        cov = np.asarray(cov, np.float64)
        if cov.shape != (n, n):
            raise ValueError(f"cov shape {cov.shape} != ({n}, {n})")
        ell = np.linalg.cholesky(cov)
        w = np.linalg.inv(ell)  # chi2 = ||L^-1 (d - m)||^2
        return w, w @ pk
    if sigma is None:
        sigma = np.ones(n)
    sigma = np.broadcast_to(np.asarray(sigma, np.float64), (n,))
    if np.any(sigma <= 0):
        raise ValueError("sigma must be positive")
    w = np.diag(1.0 / sigma)
    return w, pk / sigma


def fit_bao_scale(k_hmpc, pk, cosmo: Cosmology, *,
                  sigma=None, cov=None, sigma_nl: float = 8.0,
                  kmin: float = 0.02, kmax: float = 0.30,
                  alphas=None,
                  poly_powers: Sequence[int] = (-2, -1, 0, 1, 2),
                  device=None) -> BAOFit:
    """Profile-likelihood fit of the acoustic dilation alpha to a
    measured P(k).

    Model: P(k) = B^2 t(k; alpha, Sigma_nl) + sum_i a_i k^{p_i} with
    t = bao_template_power. At each alpha on the grid the linear
    parameters (B^2, a_i) are solved exactly by weighted least squares;
    chi2(alpha) is the resulting profile, minimized by quadratic
    interpolation around the grid minimum, with the 1-sigma error from
    the local delta-chi2 = 1 curvature.

    sigma: per-bin 1-sigma errors (scalar or (n,)); cov: full (n, n)
    covariance (mutually exclusive with sigma). Unit weights if neither.
    Raises if the profile minimum lands on the alpha-grid edge (widen
    `alphas` — an edge minimum means the quoted error would be wrong).

    sigma_nl: nonlinear damping scale in Mpc/h (~8-10 pre-recon, ~4-5
    post-recon at z~0.5; the reconstruction module's purpose is to
    shrink it).

    device: where the template's spectra are evaluated (see the module
    docstring); the fit itself is host float64.
    """
    if sigma is not None and cov is not None:
        raise ValueError("pass sigma or cov, not both")
    k = np.asarray(k_hmpc, np.float64).ravel()
    p = np.asarray(pk, np.float64).ravel()
    if k.shape != p.shape:
        raise ValueError("k and pk disagree on shape")
    mask = (k >= kmin) & (k <= kmax) & np.isfinite(p)
    nfit = int(mask.sum())
    npar = 1 + 1 + len(poly_powers)
    if nfit < npar + 2:
        raise ValueError(f"only {nfit} bins in [{kmin}, {kmax}] for "
                         f"{npar} parameters")
    kf, pf = k[mask], p[mask]
    if sigma is not None and np.ndim(sigma) > 0:
        sigma = np.asarray(sigma, np.float64).ravel()[mask]
    if cov is not None:
        cov = np.asarray(cov, np.float64)[np.ix_(mask, mask)]
    w, y = _whiten(kf, pf, sigma, cov)

    if alphas is None:
        alphas = np.linspace(0.8, 1.2, 401)
    alphas = np.asarray(alphas, np.float64)

    # broadband columns are alpha-independent: whiten + scale once
    polys = np.stack([kf ** float(pw) for pw in poly_powers], axis=1) \
        if len(poly_powers) else np.zeros((len(kf), 0))
    wpolys = w @ polys
    pscale = np.maximum(np.abs(wpolys).max(axis=0), 1e-300)
    wpolys = wpolys / pscale

    # alpha-independent template pieces, evaluated ONCE (each call into
    # linear_power re-runs the sigma8 normalization quadrature on
    # device — 400 grid points of that dominated the whole fit):
    # P_nw(kf), the damping, and a dense O(k) table covering every
    # kf/alpha the profile can request.
    p_nw = _host64(linear_power_nowiggle(kf, cosmo, device=device))
    damp = np.exp(-0.5 * (kf * float(sigma_nl)) ** 2)
    ktab = np.linspace(kf[0] / max(alphas.max(), 1.0) * 0.99,
                       kf[-1] / min(alphas.min(), 1.0) * 1.01, 8192)
    otab = wiggle_ratio(ktab, cosmo, device=device)

    def solve(alpha):
        o = np.interp(kf / alpha, ktab, otab)
        t = p_nw * (1.0 + (o - 1.0) * damp)
        wt = w @ t
        tscale = max(np.abs(wt).max(), 1e-300)
        x = np.concatenate([(wt / tscale)[:, None], wpolys], axis=1)
        coef, _, _, _ = np.linalg.lstsq(x, y, rcond=None)
        resid = y - x @ coef
        chi2 = float(resid @ resid)
        b2 = coef[0] / tscale
        bb = coef[1:] / pscale
        return chi2, b2, bb

    chi2s = np.array([solve(a)[0] for a in alphas])
    i = int(np.argmin(chi2s))
    if i == 0 or i == len(alphas) - 1:
        raise ValueError(
            f"chi2(alpha) minimum at the grid edge (alpha = "
            f"{alphas[i]:.4f}); widen `alphas` — no interior minimum in "
            f"[{alphas[0]}, {alphas[-1]}]")
    # quadratic refinement through (i-1, i, i+1)
    a3, c3 = alphas[i - 1:i + 2], chi2s[i - 1:i + 2]
    denom = (c3[0] - 2.0 * c3[1] + c3[2])
    if denom <= 0:  # numerically flat profile: stay on the grid point
        a_best = float(alphas[i])
        curv = np.inf
    else:
        h = a3[1] - a3[0]
        a_best = float(a3[1] + 0.5 * h * (c3[0] - c3[2]) / denom)
        curv = denom / h ** 2  # d2chi2/dalpha2
    err = float(np.sqrt(2.0 / curv)) if np.isfinite(curv) else np.inf
    chi2_b, b2, bb = solve(a_best)
    model = (b2 * bao_template_power(kf, cosmo, alpha=a_best,
                                     sigma_nl=sigma_nl, device=device)
             + (polys @ bb if len(poly_powers) else 0.0))
    return BAOFit(alpha=a_best, alpha_err=err, chi2=chi2_b,
                  dof=nfit - npar, alphas=alphas, chi2_curve=chi2s,
                  bias2=float(b2), broadband=np.asarray(bb), kfit=kf,
                  model=np.asarray(model))


class BAOFitAniso(NamedTuple):
    alpha_par: float
    alpha_perp: float
    err_par: float        # 1-sigma from the delta-chi2 = 1 paraboloid
    err_perp: float
    corr: float           # correlation coefficient of (apar, aperp)
    chi2: float
    dof: int
    apars: np.ndarray     # profile grids
    aperps: np.ndarray
    chi2_surface: np.ndarray  # (n_apar, n_aperp)
    bias2: float
    broadband: np.ndarray  # (n_ell, n_poly)
    kfit: np.ndarray
    model: np.ndarray      # (n_ell, n_kfit) best-fit multipoles


def _gauss_legendre_mu(n):
    x, w = np.polynomial.legendre.leggauss(2 * n)
    keep = x > 0  # even integrands: fold to mu in (0, 1)
    return x[keep], 2.0 * w[keep]


def _legendre_np(ell, mu):
    if ell == 0:
        return np.ones_like(mu)
    if ell == 2:
        return 0.5 * (3.0 * mu ** 2 - 1.0)
    if ell == 4:
        return 0.125 * ((35.0 * mu ** 2 - 30.0) * mu ** 2 + 3.0)
    raise ValueError(f"even ell <= 4 only (got {ell})")


def fit_bao_scale_aniso(k_hmpc, p_ells, cosmo: Cosmology, *,
                        ells: Sequence[int] = (0, 2),
                        beta: float = 0.4,
                        sigma=None, cov=None,
                        sigma_par: float = 10.0, sigma_perp: float = 6.0,
                        kmin: float = 0.02, kmax: float = 0.30,
                        apars=None, aperps=None,
                        poly_powers: Sequence[int] = (-2, -1, 0, 1),
                        n_mu: int = 20, device=None) -> BAOFitAniso:
    """Anisotropic BAO fit: (alpha_par, alpha_perp) from redshift-space
    power multipoles (the BOSS/eBOSS-style template measurement).

    Model in observed (k, mu): the Alcock-Paczynski mapping
        k' = (k / a_perp) sqrt(1 + mu^2 (1/F^2 - 1)),   F = a_par/a_perp
        mu' = (mu / F) / sqrt(1 + mu^2 (1/F^2 - 1))
    applied to the Kaiser-damped template
        P(k', mu') = B^2 (1 + beta mu'^2)^2 P_nw(k')
                     * [1 + (O(k') - 1) e^{-k'^2 (mu'^2 Spar^2
                                            + (1-mu'^2) Sperp^2)/2}]
    projected onto L_ell by Gauss-Legendre quadrature over mu, plus
    per-multipole broadband polynomials. (B^2, broadband) are solved
    analytically at each (a_par, a_perp) grid point; beta is held fixed
    (the wiggle shift, not the RSD amplitude, carries the signal — pass
    the fiducial f/b).

    p_ells: (n_ell, nk) measured multipoles in the order of `ells`
    (ops.power.auto_power_multipoles layout). sigma: per-bin errors,
    same shape; cov: full (n_ell*nk_fit,)^2 covariance over the MASKED,
    ell-stacked data vector. Returns errors from the delta-chi2 = 1
    paraboloid at the refined minimum.
    """
    if sigma is not None and cov is not None:
        raise ValueError("pass sigma or cov, not both")
    k = np.asarray(k_hmpc, np.float64).ravel()
    p_ells = np.asarray(p_ells, np.float64)
    if p_ells.shape != (len(ells), k.size):
        raise ValueError(f"p_ells shape {p_ells.shape} != "
                         f"({len(ells)}, {k.size})")
    mask = (k >= kmin) & (k <= kmax) & np.all(np.isfinite(p_ells),
                                              axis=0)
    kf = k[mask]
    nk = kf.size
    nell = len(ells)
    npar = 2 + 1 + nell * len(poly_powers)
    if nell * nk < npar + 2:
        raise ValueError(f"only {nell * nk} points for {npar} params")
    y_raw = p_ells[:, mask].ravel()  # ell-major stacking

    if sigma is not None:
        sigma = np.asarray(sigma, np.float64)
        if sigma.shape != p_ells.shape:
            raise ValueError("sigma must match p_ells shape")
        sigma = sigma[:, mask].ravel()
    w, y = _whiten(np.tile(kf, nell), y_raw, sigma, cov)

    if apars is None:
        apars = np.linspace(0.85, 1.15, 61)
    if aperps is None:
        aperps = np.linspace(0.85, 1.15, 61)
    apars = np.asarray(apars, np.float64)
    aperps = np.asarray(aperps, np.float64)

    # mu quadrature and template tables (alpha-independent)
    mu, wmu = _gauss_legendre_mu(n_mu)
    legs = np.stack([_legendre_np(l, mu) * (2 * l + 1) / 2.0
                     for l in ells])  # (nell, nmu) projection weights
    lo = kf[0] / max(apars.max(), aperps.max(), 1.0) * 0.9
    hi = kf[-1] / min(apars.min(), aperps.min(), 1.0) * 1.1
    ktab = np.linspace(lo, hi, 8192)
    otab = wiggle_ratio(ktab, cosmo, device=device)
    pnwtab = _host64(linear_power_nowiggle(ktab, cosmo, device=device))

    # broadband columns: per-ell blocks, whitened + scaled once
    polys1 = np.stack([kf ** float(pw) for pw in poly_powers], axis=1) \
        if len(poly_powers) else np.zeros((nk, 0))
    blocks = []
    for i in range(nell):
        col = np.zeros((nell * nk, polys1.shape[1]))
        col[i * nk:(i + 1) * nk] = polys1
        blocks.append(col)
    polys = np.concatenate(blocks, axis=1) if blocks else \
        np.zeros((nell * nk, 0))
    wpolys = w @ polys
    pscale = np.maximum(np.abs(wpolys).max(axis=0), 1e-300) \
        if wpolys.shape[1] else np.ones(0)
    wpolys = wpolys / pscale if wpolys.shape[1] else wpolys

    kmu = kf[:, None] * np.ones_like(mu)[None, :]  # (nk, nmu)

    def template_ells(apar, aperp):
        f2 = (apar / aperp) ** 2
        fac = np.sqrt(1.0 + mu ** 2 * (1.0 / f2 - 1.0))  # (nmu,)
        kp = kmu / aperp * fac[None, :]
        mup2 = (mu ** 2 / f2) / (1.0 + mu ** 2 * (1.0 / f2 - 1.0))
        o = np.interp(kp, ktab, otab)
        pnw = np.interp(kp, ktab, pnwtab)
        damp = np.exp(-0.5 * kp ** 2
                      * (mup2 * sigma_par ** 2
                         + (1.0 - mup2) * sigma_perp ** 2)[None, :])
        pkmu = ((1.0 + beta * mup2[None, :]) ** 2 * pnw
                * (1.0 + (o - 1.0) * damp))  # (nk, nmu)
        return np.concatenate(
            [pkmu @ (wmu * legs[i]) for i in range(nell)])  # (nell*nk,)

    def solve(apar, aperp):
        t = template_ells(apar, aperp)
        wt = w @ t
        tscale = max(np.abs(wt).max(), 1e-300)
        x = np.concatenate([(wt / tscale)[:, None], wpolys], axis=1)
        coef, _, _, _ = np.linalg.lstsq(x, y, rcond=None)
        resid = y - x @ coef
        b2 = coef[0] / tscale
        bb = (coef[1:] / pscale) if len(pscale) else coef[1:]
        return float(resid @ resid), b2, bb, t

    chi2s = np.empty((apars.size, aperps.size))
    for i, ap in enumerate(apars):
        for j, at in enumerate(aperps):
            chi2s[i, j] = solve(ap, at)[0]
    i, j = np.unravel_index(np.argmin(chi2s), chi2s.shape)
    if i in (0, apars.size - 1) or j in (0, aperps.size - 1):
        raise ValueError(
            f"chi2 minimum at the grid edge (a_par = {apars[i]:.4f}, "
            f"a_perp = {aperps[j]:.4f}); widen apars/aperps")
    # paraboloid through the 3x3 neighborhood: chi2 ~ c + g.d + d.H.d/2
    dp, dt = apars[i + 1] - apars[i], aperps[j + 1] - aperps[j]
    c = chi2s[i - 1:i + 2, j - 1:j + 2]
    gp = (c[2, 1] - c[0, 1]) / (2 * dp)
    gt = (c[1, 2] - c[1, 0]) / (2 * dt)
    hpp = (c[2, 1] - 2 * c[1, 1] + c[0, 1]) / dp ** 2
    htt = (c[1, 2] - 2 * c[1, 1] + c[1, 0]) / dt ** 2
    hpt = (c[2, 2] - c[2, 0] - c[0, 2] + c[0, 0]) / (4 * dp * dt)
    hess = np.array([[hpp, hpt], [hpt, htt]])
    evals = np.linalg.eigvalsh(hess)
    if evals.min() <= 0:
        a_par, a_perp = float(apars[i]), float(aperps[j])
        cov_a = np.full((2, 2), np.inf)
    else:
        step = np.linalg.solve(hess, -np.array([gp, gt]))
        step = np.clip(step, [-dp, -dt], [dp, dt])
        a_par = float(apars[i] + step[0])
        a_perp = float(aperps[j] + step[1])
        cov_a = 2.0 * np.linalg.inv(hess)  # delta-chi2 = 1 ellipse
    chi2_b, b2, bb, t = solve(a_par, a_perp)
    model = (b2 * t + (polys @ bb if polys.shape[1] else 0.0)
             ).reshape(nell, nk)
    err_par = float(np.sqrt(cov_a[0, 0]))
    err_perp = float(np.sqrt(cov_a[1, 1]))
    corr = (float(cov_a[0, 1] / np.sqrt(cov_a[0, 0] * cov_a[1, 1]))
            if np.isfinite(cov_a).all() else 0.0)
    return BAOFitAniso(
        alpha_par=a_par, alpha_perp=a_perp, err_par=err_par,
        err_perp=err_perp, corr=corr, chi2=chi2_b,
        dof=nell * nk - npar, apars=apars, aperps=aperps,
        chi2_surface=chi2s, bias2=float(b2),
        broadband=np.asarray(bb).reshape(nell, -1) if len(poly_powers)
        else np.zeros((nell, 0)), kfit=kf, model=model)
