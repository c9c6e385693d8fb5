"""Fisher forecasts through the differentiable theory chain.

Port of astrild_tpu/ops/forecast.py. The chain Cosmology -> EH98 /
halofit P(k, z) -> Limber kernels -> C_ell (and the halo model -> FFTLog
for the galaxy probes) is torch end to end: `Cosmology(**params)` built
from 0-d tensors is a traced cosmology (`utils/cosmology.py`), so
`fisher_matrix` takes the parameter derivatives with ONE forward-mode
`torch.func.jacfwd` through the whole mean model, as the JAX package
takes `jax.jacfwd`: exact derivatives, no finite-difference steps.

The mean models compute in float64 on `device` (default the CUDA card; it
raises without one), and the Fisher contraction and its solve are float64,
so a caller's TF32 setting cannot reach them. Fisher matrices and their
inverses come back as float64 numpy, as the JAX package returns numpy.

Surfaces:
  tomographic_shear_cls  - C_ell^{kappa_i kappa_j} for all bin pairs
  shear_cl_data_covariance - Gaussian multi-bin bandpower covariance
  fisher_matrix          - generic F = J^T C^-1 J via jacfwd
  shear_fisher           - the tomographic weak-lensing survey forecast
  hod_wp_theory / hod_wp_fisher - wp(rp) of a Zheng+07 HOD, its Fisher
  xipm_survey_fisher     - the real-space [xi+; xi-] survey forecast
  threex2pt_fisher / threex2pt_mean_builder - wp + Delta Sigma + xi_pm
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .._device import as_tensor, as_theory_tensor, default_device
from ..utils.cosmology import Cosmology
from ..utils.tables import interp
from .angular_power import (_cl_kappa_traced, _traced,
                            cl_kappa_cross_limber, cl_kappa_limber,
                            cl_kappa_limber_nz)
from .linear_power import normalization

__all__ = ["tomographic_shear_cls", "shear_cl_data_covariance",
           "fisher_matrix", "shear_fisher", "hod_wp_theory", "hod_wp_fisher",
           "xipm_survey_fisher", "threex2pt_fisher", "threex2pt_mean_builder",
           "ell_grid_of", "HOD_KEYS", "IA_KEYS"]

HOD_KEYS = ("log_mmin", "sigma_logm", "log_m0", "log_m1", "alpha")
IA_KEYS = ("A_IA", "eta_IA")


def _cosmology(fixed: dict, p: dict, device) -> Cosmology:
    """Cosmology(**{**fixed, **p}) on the tensor route on `device`."""
    return _traced(Cosmology(**{**fixed, **p}), device)


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def tomographic_shear_cls(ells, cosmo: Cosmology, z_sources: Sequence[float],
                          nchi: int = 256, nonlinear: bool = False,
                          device=None):
    """Full (nbin, nbin, nell) stack of convergence auto/cross spectra.

    Each unique pair runs through `cl_kappa_cross_limber` (the one home of
    the Limber integrand) with the sigma8 amplitude computed once for all
    of them; a traced cosmology takes all pairs in one batched pass of its
    tensor route. The stack is symmetrized. ells are placed as in
    `cl_kappa_cross_limber`.
    """
    zs = [float(z) for z in z_sources]
    nb = len(zs)
    amplitude = normalization(cosmo)
    pairs = _pair_index(nb)
    if cosmo.traced:
        cls = _cl_kappa_traced(ells, cosmo, [zs[i] for i, _ in pairs],
                               [zs[j] for _, j in pairs], nchi, nonlinear,
                               amplitude, device)
    else:
        cls = [cl_kappa_cross_limber(ells, cosmo, zs[i], zs[j], nchi=nchi,
                                     amplitude=amplitude,
                                     nonlinear=nonlinear, device=device)
               for i, j in pairs]
    out = [[None] * nb for _ in range(nb)]
    for (i, j), cl in zip(pairs, cls):
        out[i][j] = cl
        out[j][i] = cl
    return torch.stack([torch.stack(row) for row in out])


def _pair_index(nb: int):
    """Unique (i <= j) pair list packing the symmetric C_ell stack."""
    return [(i, j) for i in range(nb) for j in range(i, nb)]


def shear_cl_data_covariance(cls_stack, ells, fsky: float = 1.0,
                             delta_ell=1.0, noise_cl=None, device=None):
    """Gaussian covariance of the packed tomographic data vector:

    Cov[C^{ij}_l, C^{mn}_l] = (Ct^{im} Ct^{jn} + Ct^{in} Ct^{jm})
                              / ((2l+1) fsky delta_l),

    Ct = C + noise (noise_cl: (nbin,) shape noise N_l per bin, added to
    the autos). Block-diagonal in ell; returns (nell, npair, npair) on the
    stack's device, in its dtype.
    """
    ct = as_theory_tensor(cls_stack, device)
    dev, dt = ct.device, ct.dtype
    nb = ct.shape[0]
    ells = as_theory_tensor(ells, dev).to(dt)
    if noise_cl is not None:
        noise = as_theory_tensor(noise_cl, dev).to(dt)
        ct = ct + (torch.eye(nb, dtype=dt, device=dev)[:, :, None]
                   * noise[:, None, None])
    pairs = _pair_index(nb)
    cov = torch.stack([
        torch.stack([ct[i, m] * ct[j, n] + ct[i, n] * ct[j, m]
                     for (m, n) in pairs])
        for (i, j) in pairs])                     # (npair, npair, nell)
    delta_ell = as_theory_tensor(delta_ell, dev).to(dt)
    norm = (2.0 * ells + 1.0) * fsky * delta_ell
    return torch.movedim(cov / norm, -1, 0)


def _jacobian(mean_fn, params: Dict[str, float], device):
    """(d mean / d params, mean) at the fiducial params: one
    torch.func.jacfwd, the params float64 0-d tensors on `device`; the
    Jacobian has the mean's shape + (npar,)."""
    names = list(params)
    x0 = torch.tensor([float(params[k]) for k in names],
                      dtype=torch.float64, device=device)

    def fn(x):
        mu = mean_fn({k: x[i] for i, k in enumerate(names)})
        return mu, mu

    return torch.func.jacfwd(fn, has_aux=True)(x0)


def fisher_matrix(mean_fn, params: Dict[str, float], cov, device=None):
    """F_ab = sum_l dmu/dp_a C_l^-1 dmu/dp_b for a Gaussian likelihood with
    a parameter-independent covariance.

    Args:
      mean_fn: dict of 0-d tensors -> model vector tensor, shape (nell,
        ndata) or (ndata,). Differentiated with torch.func.jacfwd (forward
        mode, exact derivatives) at the fiducial parameters, which are
        float64 tensors on `device` (default the CUDA card).
      params: fiducial parameter dict (its order is the matrix's).
      cov: (nell, ndata, ndata) block covariance, or (ndata, ndata), or
        (ndata,) diagonal, matching mean_fn's output.

    Returns (F, names): the float64 numpy (npar, npar) Fisher matrix (the
    contraction and solve in float64 on the device) and the parameter
    order.
    """
    dev = default_device(device)
    jac, mu0 = _jacobian(mean_fn, params, dev)
    jac = jac.to(torch.float64)                   # mean shape + (npar,)
    cov = torch.as_tensor(np.array(_host(cov), np.float64), device=dev)
    if mu0.dim() == 1:
        w = (jac / cov[:, None] if cov.dim() == 1
             else torch.linalg.solve(cov, jac))
        fisher = torch.einsum("da,db->ab", jac, w)
    else:
        if cov.dim() == 2:
            cov = cov[None].expand(mu0.shape[0], -1, -1)
        w = torch.linalg.solve(cov, jac)          # (nell, ndata, npar)
        fisher = torch.einsum("lda,ldb->ab", jac, w)
    return fisher.cpu().numpy(), list(params)


def held_root_differences(mean_fn, params: Dict[str, float],
                          step: float = 1e-4, hold: bool = True):
    """Central differences of mean_fn at params, step `step` of each
    parameter (absolute where it is 0): (mean shape..., npar) float64
    numpy. The check of `fisher_matrix`'s Jacobian; no forecast uses it.

    With `hold`, halofit's nonlinear scale ln R_s stays at the fiducial
    call's roots (replayed in call order in every shifted call), as the
    Jacobian holds it: the bisection carries no derivative, in the port
    as in the JAX package.
    """
    from . import linear_power

    real, roots = linear_power._halofit_root, []

    def record(*args):
        roots.append(real(*args))
        return roots[-1]

    cols = []
    try:
        linear_power._halofit_root = record
        mean_fn(params)
        for name, v in params.items():
            h = step * abs(v) if v else step
            shifted = []
            for x in (v + h, v - h):
                replay = iter(roots)
                linear_power._halofit_root = (
                    (lambda *args: next(replay)) if hold else real)
                shifted.append(mean_fn({**params, name: x}))
            cols.append(((shifted[0] - shifted[1]) / (2.0 * h))
                        .double().cpu().numpy())
    finally:
        linear_power._halofit_root = real
    return np.stack(cols, axis=-1)


def _forecast(mean_fn, params, cov, dev, **extra) -> dict:
    """The forecast dict of `mean_fn` at `params` with data covariance
    `cov`; it carries the mean model it differentiated as 'mean_fn'."""
    fisher, names = fisher_matrix(mean_fn, params, cov, device=dev)
    pcov = np.linalg.inv(fisher)
    return {"fisher": fisher, "names": names, "covariance": pcov,
            "marginalized": np.sqrt(np.abs(np.diag(pcov))),
            "mean_fn": mean_fn, **extra}


def shear_fisher(ells, params: Dict[str, float],
                 z_sources: Sequence[float], fsky: float = 0.5,
                 delta_ell=None, ngal_per_arcmin2: float = 30.0,
                 sigma_eps: float = 0.26, nchi: int = 128,
                 nonlinear: bool = False,
                 fixed: Dict[str, float] = None, device=None) -> dict:
    """Weak-lensing tomographic survey Fisher forecast.

    Args:
      ells: bandpower centres (float32, as the JAX package takes them).
      params: fiducial values of the VARIED Cosmology parameters
        (e.g. {"Om0": 0.3089, "sigma8": 0.8159}).
      z_sources: tomographic source redshifts.
      fsky, delta_ell: survey area and bandwidths (default: the gaps
        between the supplied ells).
      ngal_per_arcmin2, sigma_eps: per-bin shape noise
        N_l = sigma_eps^2 / nbar (nbar split evenly across bins).
      fixed: extra Cosmology kwargs held fixed (not varied).

    Returns a dict of float64 numpy 'fisher', 'covariance' (F^-1) and
    'marginalized' (1-sigma), 'names', and 'mean_fn', the mean model
    (packed C_ell pairs, (nell, npair)) that F differentiates.
    """
    dev = default_device(device)
    ells = as_tensor(np.asarray(_host(ells), np.float32), dev)
    if delta_ell is None:
        e = _host(ells).astype(np.float64)
        gaps = np.diff(e)
        delta_ell = np.concatenate([gaps[:1], 0.5 * (gaps[1:] + gaps[:-1]),
                                    gaps[-1:]]).astype(np.float32)
    nb = len(z_sources)
    nbar_sr = (ngal_per_arcmin2 / nb) / (np.deg2rad(1.0 / 60.0) ** 2)
    noise = np.full((nb,), sigma_eps ** 2 / nbar_sr, np.float32)
    fixed = dict(fixed or {})
    pairs = _pair_index(nb)

    def cls_of(p):
        return tomographic_shear_cls(ells, _cosmology(fixed, p, dev),
                                     z_sources, nchi=nchi,
                                     nonlinear=nonlinear)

    def mean_fn(p):
        stack = cls_of(p)
        return torch.stack([stack[i, j] for (i, j) in pairs], dim=-1)

    cov = shear_cl_data_covariance(cls_of(params), ells, fsky=fsky,
                                   delta_ell=delta_ell, noise_cl=noise)
    return _forecast(mean_fn, params, cov, dev)


def hod_wp_theory(rp, cosmo: Cosmology, hod_param_dict: Dict[str, float],
                  pi_max, nk: int = 192, kmin: float = 1e-3,
                  kmax: float = 20.0, z: float = 0.0, device=None):
    """Theory wp(rp) of a Zheng+07 HOD: halo-model P_gg -> FFTLog wp, in
    float64.

    hod_param_dict keys are HODParams field names (log_mmin, sigma_logm,
    log_m0, log_m1, alpha); values may be 0-d tensors, and so may the
    cosmology's fields, so the chain is differentiable end to end. The k
    grid stays a host grid (FFTLog's Mellin kernel is a host precompute).
    Computes on a traced cosmology's device, else on `device` (default the
    CUDA card).
    """
    from .fftlog import wp_from_pk
    from .halo_model import hod_galaxy_power
    from .hod import HODParams

    cosmo = _traced(cosmo, device)
    k_host = np.geomspace(kmin, kmax, nk)
    _, _, ptot, _, _ = hod_galaxy_power(
        torch.as_tensor(k_host, device=cosmo.device), cosmo,
        HODParams(**hod_param_dict), z=z)
    rp = rp if isinstance(rp, torch.Tensor) else torch.as_tensor(
        np.asarray(rp, np.float64), device=cosmo.device)
    return wp_from_pk(k_host, ptot, rp, pi_max)


def hod_wp_fisher(rp, cosmo: Cosmology, hod_param_dict: Dict[str, float],
                  cov, pi_max, device=None):
    """Fisher matrix of wp(rp) over the HOD parameters: exact derivatives
    through occupation -> mass integrals -> NFW u(k) -> FFTLog -> the LOS
    quadrature. Returns (F, names) as `fisher_matrix`."""
    dev = default_device(device)
    cosmo = _traced(cosmo, dev)
    return fisher_matrix(lambda p: hod_wp_theory(rp, cosmo, p, pi_max),
                         hod_param_dict, cov, device=dev)


def _xi_block_covariance(npix, opening_angle_deg, nbins,
                         theta_min_arcmin, theta_max_arcmin, ell_grid,
                         cl0, sigma_eps, ngal_per_arcmin2, n_fields):
    """The one home of the xi_pm data-covariance plumbing shared by
    xipm_survey_fisher and threex2pt_fisher: the zero-tailed C_ell table
    (the covariance band-limits like the model), per-component shape
    noise C_n = sigma_eps^2/(2 nbar), the empty-annulus selection and the
    1/n_fields scaling, on the host in float64. Returns (cov (2 nkeep,
    2 nkeep), keep mask)."""
    from .shear_2pt import _xi_pm_bins, xi_pm_gaussian_covariance

    pixscale = opening_angle_deg * 60.0 / npix
    ell_tab = np.concatenate([ell_grid, [ell_grid[-1] * 1.01,
                                         ell_grid[-1] * 100.0]])
    cl_tab = np.concatenate([np.asarray(cl0, np.float64), [0.0, 0.0]])
    nbar_sr = ngal_per_arcmin2 / (np.deg2rad(1.0 / 60.0) ** 2)
    noise_cl = sigma_eps ** 2 / (2.0 * nbar_sr)
    _, cov = xi_pm_gaussian_covariance(
        npix, opening_angle_deg, ell_tab, cl_tab, nbins,
        theta_min_arcmin=theta_min_arcmin,
        theta_max_arcmin=theta_max_arcmin, noise_cl=noise_cl)
    _, _, cnt, _ = _xi_pm_bins(npix, nbins,
                               float(theta_min_arcmin / pixscale),
                               float(theta_max_arcmin / pixscale))
    keep = cnt > 0
    sel = np.concatenate([keep, keep])
    return cov[np.ix_(sel, sel)] / float(n_fields), keep


def ell_grid_of(npix: int, opening_angle_deg: float, nell: int):
    """THE log ell grid of the xi_pm forecast chain (shared by the mean
    model and the covariance table)."""
    lf = 2.0 * np.pi / np.deg2rad(opening_angle_deg)
    return np.geomspace(2.0, 1.45 * lf * (npix / 2.0), nell)


def _xi_theta(npix, opening_angle_deg, nbins, theta_min_arcmin,
              theta_max_arcmin):
    """The estimator's non-empty bins: (theta_arcmin, ln theta_rad)."""
    from .shear_2pt import _xi_pm_bins

    pixscale = opening_angle_deg * 60.0 / npix
    _, _, cnt, theta_pix = _xi_pm_bins(
        npix, nbins, float(theta_min_arcmin / pixscale),
        float(theta_max_arcmin / pixscale))
    theta_arcmin = theta_pix[cnt > 0] * pixscale
    return theta_arcmin, np.log(theta_arcmin * np.pi / 180.0 / 60.0)


def _xi_of_cl(ell_grid, cl, ltheta):
    """[xi+; xi-] of C_ell on the log ell grid at ln theta: the
    cylindrical FFTLog, interpolated in ln theta."""
    from .shear_2pt import xi_pm_from_cl_grid

    th, xp, xm = xi_pm_from_cl_grid(ell_grid, cl)
    lth = torch.log(th)
    return torch.cat([interp(ltheta, lth, xp), interp(ltheta, lth, xm)])


def xipm_survey_fisher(params: Dict[str, float], npix: int,
                       opening_angle_deg: float, nbins: int = 12,
                       theta_min_arcmin: float = 1.0,
                       theta_max_arcmin=None, z_source: float = 1.0,
                       sigma_eps: float = 0.26,
                       ngal_per_arcmin2: float = 30.0, nell: int = 512,
                       nchi: int = 96, nonlinear: bool = True,
                       fixed: Dict[str, float] = None,
                       n_fields: int = 1, nz=None, device=None) -> dict:
    """Cosmology Fisher forecast from the REAL-SPACE shear data vector
    [xi_+(theta); xi_-(theta)] of a flat-sky survey field.

    The mean model is the differentiable chain Cosmology -> Limber C_EE
    (`cl_kappa_limber`, or `cl_kappa_limber_nz` with nz=(z_tab, nz_tab))
    -> the cylindrical FFTLog (`shear_2pt.xi_pm_from_cl_grid`) -> the
    estimator's own bin centres; the data covariance is the exact discrete
    Gaussian covariance of the map estimator on an (npix, npix) field of
    opening_angle_deg (`shear_2pt.xi_pm_gaussian_covariance`, host
    float64), with per-component shape noise, scaled by 1/n_fields.
    "A_IA" / "eta_IA" in params are NLA nuisance parameters (they need
    nz). Returns a dict of float64 numpy 'fisher', 'covariance',
    'marginalized', 'theta_arcmin', 'names' and the 'mean_fn' that F
    differentiates.
    """
    if ("A_IA" in params or "eta_IA" in params) and nz is None:
        raise ValueError("IA nuisance parameters need nz=(z_tab, nz_tab)")
    dev = default_device(device)
    fixed = dict(fixed or {})
    if theta_max_arcmin is None:
        theta_max_arcmin = opening_angle_deg * 60.0 / 2.0
    ell_grid = ell_grid_of(npix, opening_angle_deg, nell)
    theta_arcmin, lt = _xi_theta(npix, opening_angle_deg, nbins,
                                 theta_min_arcmin, theta_max_arcmin)
    ltheta = torch.as_tensor(lt, device=dev)
    ells = torch.as_tensor(ell_grid, device=dev)

    def cl_of(p):
        p = dict(p)
        a_ia = p.pop("A_IA", 0.0)
        eta_ia = p.pop("eta_IA", 0.0)
        cosmo = _cosmology(fixed, p, dev)
        if nz is not None:
            return cl_kappa_limber_nz(ells, cosmo, nz[0], nz[1], nchi=nchi,
                                      nonlinear=nonlinear, a_ia=a_ia,
                                      eta_ia=eta_ia)
        return cl_kappa_limber(ells, cosmo, z_source=z_source, nchi=nchi,
                               nonlinear=nonlinear)

    cov, _ = _xi_block_covariance(
        npix, opening_angle_deg, nbins, theta_min_arcmin,
        theta_max_arcmin, ell_grid, _host(cl_of(params)), sigma_eps,
        ngal_per_arcmin2, n_fields)
    return _forecast(lambda p: _xi_of_cl(ell_grid, cl_of(p), ltheta),
                     params, cov, dev, theta_arcmin=theta_arcmin)


def threex2pt_fisher(params: Dict[str, float], rp_wp, rp_ds,
                     cov_wp, cov_ds, npix: int, opening_angle_deg: float,
                     nz, pi_max: float = 60.0, nbins_xi: int = 12,
                     theta_min_arcmin: float = 2.0,
                     theta_max_arcmin=None, z_lens: float = 0.0,
                     sigma_eps: float = 0.26,
                     ngal_per_arcmin2: float = 30.0, nell: int = 384,
                     nchi: int = 64, nonlinear: bool = True,
                     fixed: Dict[str, float] = None,
                     hod_fixed: Dict[str, float] = None,
                     n_fields: int = 1, device=None) -> dict:
    """Joint 3x2pt Fisher forecast: galaxy clustering wp(rp) +
    galaxy-galaxy lensing Delta Sigma(rp) + cosmic shear [xi+; xi-], with
    ONE parameter vector across the three probes: Cosmology keys, the
    Zheng+07 HOD keys (`HOD_KEYS`) and the NLA keys (`IA_KEYS`). wp and
    Delta Sigma share the halo-model ingredients and the same z_lens, so
    occupation parameters move both coherently; xi_pm responds to
    cosmology and IA only.

    Covariance: block-diagonal across the probes. cov_wp / cov_ds are
    supplied (e.g. `covariance.spatial_jackknife` on mocks); the xi_pm
    block is the exact discrete Gaussian covariance of the map estimator
    (+ shape noise), scaled by 1/n_fields. Cross-probe covariance is
    neglected: pair `threex2pt_mean_builder` with `fisher_matrix` and a
    full covariance where that matters.

    Returns a dict of float64 numpy 'fisher', 'covariance',
    'marginalized', 'theta_arcmin' and the fiducial 'mean', 'names' and
    the 'mean_fn' that F differentiates.
    """
    dev = default_device(device)
    if theta_max_arcmin is None:
        theta_max_arcmin = opening_angle_deg * 60.0 / 2.0
    mean_fn, theta_arcmin, cl0_fn = threex2pt_mean_builder(
        rp_wp, rp_ds, npix, opening_angle_deg, nz, pi_max, nbins_xi,
        theta_min_arcmin, theta_max_arcmin, z_lens, nell, nchi,
        nonlinear, dict(fixed or {}), dict(hod_fixed or {}), device=dev)
    # the fiducial C_ell for the xi block (cl0_fn zero-tails the table;
    # the covariance home takes the grid values)
    _, cl_tab_full = cl0_fn(params)
    cov_xi, _ = _xi_block_covariance(
        npix, opening_angle_deg, nbins_xi, theta_min_arcmin,
        theta_max_arcmin, ell_grid_of(npix, opening_angle_deg, nell),
        cl_tab_full[:-2], sigma_eps, ngal_per_arcmin2, n_fields)
    cov_wp = np.atleast_2d(np.asarray(cov_wp, np.float64))
    cov_ds = np.atleast_2d(np.asarray(cov_ds, np.float64))
    nw, nd, nx = cov_wp.shape[0], cov_ds.shape[0], cov_xi.shape[0]
    cov = np.zeros((nw + nd + nx, nw + nd + nx))
    cov[:nw, :nw] = cov_wp
    cov[nw:nw + nd, nw:nw + nd] = cov_ds
    cov[nw + nd:, nw + nd:] = cov_xi
    mu0 = _host(mean_fn(params))
    if mu0.shape[0] != cov.shape[0]:
        raise ValueError(
            f"3x2pt data vector has {mu0.shape[0]} entries "
            f"(wp {len(np.atleast_1d(rp_wp))} + ds "
            f"{len(np.atleast_1d(rp_ds))} + xi {nx}) but the block "
            f"covariance is {cov.shape[0]}x{cov.shape[0]}")
    return _forecast(mean_fn, params, cov, dev, theta_arcmin=theta_arcmin,
                     mean=mu0)


def threex2pt_mean_builder(rp_wp, rp_ds, npix, opening_angle_deg, nz,
                           pi_max, nbins_xi, theta_min_arcmin,
                           theta_max_arcmin, z_lens, nell, nchi,
                           nonlinear, fixed, hod_fixed, device=None):
    """The 3x2pt mean-model closure: returns (mean_fn, theta_arcmin,
    cl0_fn). mean_fn(params) is the float64 [wp; Delta Sigma; xi+; xi-]
    vector on `device` (default the CUDA card); pair it with
    `fisher_matrix` and a full cross-probe covariance (e.g. a joint
    jackknife) where the block-diagonal approximation of
    `threex2pt_fisher` is not enough. cl0_fn(params) gives the host
    zero-tailed (ell, C_ell) table of the shear block."""
    from .halo_model import delta_sigma_hod
    from .hod import HODParams

    dev = default_device(device)
    ell_grid = ell_grid_of(npix, opening_angle_deg, nell)
    theta_arcmin, lt = _xi_theta(npix, opening_angle_deg, nbins_xi,
                                 theta_min_arcmin, theta_max_arcmin)
    ltheta = torch.as_tensor(lt, device=dev)
    ells = torch.as_tensor(ell_grid, device=dev)
    rp_wp = torch.as_tensor(np.asarray(_host(rp_wp), np.float64), device=dev)
    rp_ds = torch.as_tensor(np.asarray(_host(rp_ds), np.float64), device=dev)

    def split(p):
        p = dict(p)
        a_ia = p.pop("A_IA", 0.0)
        eta_ia = p.pop("eta_IA", 0.0)
        hod = {k: p.pop(k) for k in HOD_KEYS if k in p}
        return _cosmology(fixed, p, dev), {**hod_fixed, **hod}, a_ia, eta_ia

    def cl_of(cosmo, a_ia, eta_ia):
        return cl_kappa_limber_nz(ells, cosmo, nz[0], nz[1], nchi=nchi,
                                  nonlinear=nonlinear, a_ia=a_ia,
                                  eta_ia=eta_ia)

    def mean_fn(p):
        cosmo, hod_all, a_ia, eta_ia = split(p)
        # the SAME z_lens reaches clustering and GGL: different-z halo
        # ingredients would break the coherent-HOD claim
        wp = hod_wp_theory(rp_wp, cosmo, hod_all, pi_max, z=z_lens)
        ds = delta_sigma_hod(rp_ds, cosmo, hod_params=HODParams(**hod_all),
                             z=z_lens)
        xi = _xi_of_cl(ell_grid, cl_of(cosmo, a_ia, eta_ia), ltheta)
        return torch.cat([wp, ds, xi])

    def cl0_fn(p):
        cosmo, _, a_ia, eta_ia = split(p)
        cl0 = _host(cl_of(cosmo, a_ia, eta_ia)).astype(np.float64)
        ell_tab = np.concatenate([ell_grid, [ell_grid[-1] * 1.01,
                                             ell_grid[-1] * 100.0]])
        return ell_tab, np.concatenate([cl0, [0.0, 0.0]])

    return mean_fn, theta_arcmin, cl0_fn
