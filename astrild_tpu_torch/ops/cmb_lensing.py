"""CMB lensing: the flat-sky forward remap, the TT and EB quadratic
estimators (Hu & Okamoto 2002) with their discrete-exact normalization, and
the curved-sky (HEALPix) TT estimator.

Port of astrild_tpu/ops/cmb_lensing.py. Flat sky, continuum conventions
T(l) = int d^2x T e^{-ilx}:

    phi_hat_un(L) = i L . FFT[ W0(x) G(x) ](L)
      W0 = IFFT[F_l T(l)],  G_i = IFFT[i l_i C_l F_l T(l)],
      F_l = 1/(C_l + N_l) on [lmin, lmax_filter],

normalized by the response R(L) = 1/N0_phi evaluated on the same discrete
mode sums. Every convolution (the estimator's T-products and the
response's filter products) is a zero-padded linear convolution through 2n
FFTs: the same-grid product is the circular convolution, whose wrapped
mode pairs carry no lensing response. kappa_hat = (L^2 / 2) phi_hat.

The curved-sky estimator runs the same chain through the spherical
harmonic transforms: the filtered map, the Wiener-filtered gradient by the
spin-1 synthesis, the divergence of their product by the spin-1 analysis,
normalized by the isotropic flat-sky response (host float64 quadrature).
Its 'auto' backend takes the table-free scan path once the scalar and two
spin-1 tables would pass 256 MB.

Numpy input goes to `device`, by default the CUDA card (it raises without
one: pass device="cpu"); tensors keep their device. Spectra given as
numpy are float64 host tables, cast to float32 where they meet the maps as
`jnp.asarray` casts them. No contraction is a matrix product, so a
caller's TF32 setting cannot reach them.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..utils.tables import interp
from .power import _mode_numbers
from .raytrace import _interp_periodic

__all__ = ["lens_cmb_map_flat", "qe_tt_kappa", "qe_tt_n0_kappa",
           "qe_tt_response", "qe_eb_kappa", "qe_tt_kappa_healpix"]


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _spectrum(cl, device) -> torch.Tensor:
    """A spectrum table as a float32 tensor on `device`."""
    if isinstance(cl, torch.Tensor):
        return cl.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(cl, np.float32)).to(device)


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _l_grids(n: int, oa: torch.Tensor):
    """Full-FFT angular frequency grids (lx, ly, |l|) [rad^-1] of an n^2
    patch of side `oa` (a float32 0-d tensor)."""
    kf = _f32(2.0 * math.pi, oa.device) / oa
    f = _mode_numbers(n, oa.device)
    lx = (f * kf)[:, None]
    ly = (f * kf)[None, :]
    return lx, ly, torch.sqrt(lx * lx + ly * ly)


def lens_cmb_map_flat(t_map, kappa, opening_angle, device=None):
    """Lens a flat-sky T patch by the deflection of a kappa patch:
    T_lensed(x) = T(x + grad phi), periodic bilinear resampling. The
    kappa -> deflection inversion is ops.lensing.kappa_to_alpha with
    padding_factor=1 (the periodic case)."""
    from .lensing import kappa_to_alpha

    t_map = as_tensor(t_map, device)
    dev = t_map.device
    kappa = as_tensor(kappa, dev)
    n = t_map.shape[-1]
    pix = _f32(opening_angle, dev) / _f32(n, dev)
    d1, d2 = kappa_to_alpha(kappa, float(opening_angle), padding_factor=1)
    i0 = torch.arange(n, dtype=torch.float32, device=dev)
    c1 = i0[:, None] + d1 / pix
    c2 = i0[None, :] + d2 / pix
    return _interp_periodic(t_map, c1, c2)


def _interp_cl(cl, lm):
    ells = torch.arange(cl.shape[0], dtype=torch.float32, device=cl.device)
    return interp(lm, ells, cl, left=0.0, right=0.0)


def _embed2(A, n: int):
    """An n-grid fftfreq-ordered spectrum at the same integer frequencies
    of a 2n grid (zero elsewhere)."""
    As = torch.fft.fftshift(A)
    h = n // 2
    out = torch.zeros((2 * n, 2 * n), dtype=As.dtype, device=As.device)
    out[n - h:2 * n - h, n - h:2 * n - h] = As
    return torch.fft.ifftshift(out)


def _extract2(B, n: int):
    """The inverse of _embed2: the n-grid frequencies of a 2n grid."""
    Bs = torch.fft.fftshift(B)
    h = n // 2
    return torch.fft.ifftshift(Bs[n - h:2 * n - h, n - h:2 * n - h])


def _conv2(A, B, n: int):
    """The linear discrete convolution sum_l1 A(l1) B(L - l1) on the n-grid
    mode set, through zero-padded 2n FFTs (the n-grid product is the
    circular convolution, whose wrapped pairs carry no lensing
    response)."""
    a = torch.fft.ifft2(_embed2(A, n))
    b = torch.fft.ifft2(_embed2(B, n))
    return _extract2(torch.fft.fft2(a * b), n) * (4.0 * n * n)


def _filters(n: int, oa, cl_tt, nl_tt, lmin, lmax_filter):
    lx, ly, lm = _l_grids(n, oa)
    C = _interp_cl(cl_tt, lm)
    N = _interp_cl(nl_tt, lm)
    band = (lm >= lmin) & (lm <= lmax_filter)
    F = torch.where(band & (C + N > 0),
                    1.0 / torch.where(C + N > 0, C + N, 1.0), 0.0)
    return lx, ly, lm, C, F


def _qe_response_impl(oa, cl_tt, nl_tt, n: int, lmin: int,
                      lmax_filter: int):
    """R(L) = 1/N0: independent of the data, ~3/4 of the estimator's FFT
    work; compute it once per filter configuration and pass it back."""
    lbox2 = oa ** 2
    lx, ly, lm, C, F = _filters(n, oa, cl_tt, nl_tt, lmin, lmax_filter)
    return (lx * lx * (_conv2(lx * lx * C * C * F, F, n)
                       + _conv2(lx * C * F, lx * C * F, n))
            + 2.0 * lx * ly * (_conv2(lx * ly * C * C * F, F, n)
                               + _conv2(lx * C * F, ly * C * F, n))
            + ly * ly * (_conv2(ly * ly * C * C * F, F, n)
                         + _conv2(ly * C * F, ly * C * F, n))).real / lbox2


def _l4(lm):
    l2 = lm * lm
    return l2 * l2


def _qe_tt_impl(t_map, oa, cl_tt, nl_tt, R, lmin: int, lmax_filter: int):
    n = t_map.shape[-1]
    pix2 = (oa / _f32(n, oa.device)) ** 2
    lbox2 = oa ** 2
    lx, ly, lm, C, F = _filters(n, oa, cl_tt, nl_tt, lmin, lmax_filter)

    tl = pix2 * torch.fft.fft2(t_map)          # physical T(l)
    tb = F * tl
    # the estimator and the response take the same linear-convolution
    # sums, so phi_hat = phi_un / R is unbiased on the grid
    gl1 = _conv2(tb, 1j * lx * C * tb, n)
    gl2 = _conv2(tb, 1j * ly * C * tb, n)
    phi_un = 1j * (lx * gl1 + ly * gl2) / lbox2

    ok = R > (torch.max(R) * 1e-8)
    Rs = torch.where(ok, R, 1.0)
    phi_hat = torch.where(ok, phi_un / Rs, 0.0)
    kap_l = 0.5 * lm * lm * phi_hat
    kap_map = torch.fft.ifft2(kap_l).real / pix2
    n0_kappa = torch.where(ok, 0.25 * _l4(lm) / Rs, 0.0)
    return kap_map, n0_kappa


def _tables(cl_tt, nl_tt, dev):
    cl_tt = _spectrum(cl_tt, dev)
    nl_tt = (torch.zeros_like(cl_tt) if nl_tt is None
             else _spectrum(nl_tt, dev))
    return cl_tt, nl_tt


def qe_tt_response(n: int, opening_angle, cl_tt, nl_tt=None,
                   lmin: int = 2, lmax_filter: Optional[int] = None,
                   device=None):
    """The QE response grid R(L) = 1/N0_phi (no data needed), on `device`
    (default: a tensor cl_tt's device, else the CUDA card). Compute it once
    and pass it to qe_tt_kappa(response=...) in Monte-Carlo loops."""
    if device is None and isinstance(cl_tt, torch.Tensor):
        device = cl_tt.device
    dev = default_device(device)
    cl_tt, nl_tt = _tables(cl_tt, nl_tt, dev)
    L = int(cl_tt.shape[0] - 1) if lmax_filter is None else lmax_filter
    return _qe_response_impl(_f32(opening_angle, dev), cl_tt, nl_tt,
                             int(n), int(lmin), L)


def qe_tt_kappa(t_map, opening_angle, cl_tt, nl_tt=None, lmin: int = 2,
                lmax_filter: Optional[int] = None, response=None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """TT quadratic-estimator convergence reconstruction.

    Args:
      t_map: (n, n) observed (lensed [+ noise]) temperature patch.
      opening_angle: patch side [rad].
      cl_tt: (lmax+1,) fiducial unlensed TT spectrum by integer ell (the
        gradient weight).
      nl_tt: optional noise spectrum (same layout); None = noiseless.
      lmin, lmax_filter: multipole band of the inverse-variance filter
        (default lmax_filter: the end of cl_tt).
      response: optional qe_tt_response grid of the same filter
        configuration.

    Returns (kappa_hat map (n, n), N0_kappa grid (n, n): the Gaussian
    reconstruction-noise power of kappa_hat at each FFT mode, exact on the
    discrete grid), on the map's device."""
    t_map = as_tensor(t_map, device)
    dev = t_map.device
    cl_tt, nl_tt = _tables(cl_tt, nl_tt, dev)
    L = int(cl_tt.shape[0] - 1) if lmax_filter is None else lmax_filter
    oa = _f32(opening_angle, dev)
    if response is None:
        response = _qe_response_impl(oa, cl_tt, nl_tt,
                                     int(t_map.shape[-1]), int(lmin), L)
    else:
        response = as_tensor(response, dev)
    return _qe_tt_impl(t_map, oa, cl_tt, nl_tt, response, int(lmin), L)


def qe_tt_n0_kappa(n: int, opening_angle, cl_tt, nl_tt=None,
                   lmin: int = 2, lmax_filter: Optional[int] = None,
                   device=None):
    """The N0 reconstruction-noise grid alone (no data needed)."""
    R = qe_tt_response(n, opening_angle, cl_tt, nl_tt=nl_tt, lmin=lmin,
                       lmax_filter=lmax_filter, device=device)
    lm = _l_grids(n, _f32(opening_angle, R.device))[2]
    ok = R > (torch.max(R) * 1e-8)
    return torch.where(ok, 0.25 * _l4(lm) / torch.where(ok, R, 1.0), 0.0)


# --------------------------------------------------------------------
# EB polarization estimator
# --------------------------------------------------------------------

def _trig2(n: int, device):
    """(cos 2phi_l, sin 2phi_l) grids (the rotation of
    ops.angular_power.shear_eb_maps)."""
    f = _mode_numbers(n, device)
    l1 = f[:, None]
    l2 = f[None, :]
    l2mag = l1 ** 2 + l2 ** 2
    safe = torch.where(l2mag == 0.0, 1.0, l2mag)
    cos2 = torch.where(l2mag == 0.0, 1.0, (l1 ** 2 - l2 ** 2) / safe)
    sin2 = torch.where(l2mag == 0.0, 0.0, 2.0 * l1 * l2 / safe)
    return cos2, sin2


def _eb_quad_sum(n, lx, ly, C, wE, wB, cos2, sin2):
    """sum_l1 (L.l1)^2 C_l1^2 sin^2(2 dphi) wE(l1) wB(l2) through linear
    convolutions: sin^2 = 1/2 - (cos4 cos4 + sin4 sin4)/2 with cos4 = 2
    cos2^2 - 1, sin4 = 2 sin2 cos2."""
    cos4 = 2.0 * cos2 * cos2 - 1.0
    sin4 = 2.0 * sin2 * cos2
    out = 0.0
    for Li, Lj, wij in ((lx, lx, lx * lx), (lx, ly, 2.0 * lx * ly),
                        (ly, ly, ly * ly)):
        base = Li * Lj * C * C * wE
        out = out + wij * (0.5 * _conv2(base, wB, n)
                           - 0.5 * _conv2(base * cos4, wB * cos4, n)
                           - 0.5 * _conv2(base * sin4, wB * sin4, n)).real
    return out


def _qe_eb_impl(q_map, u_map, oa, cl_ee, nl_ee, nl_bb, lmin: int,
                lmax_filter: int):
    n = q_map.shape[-1]
    dev = q_map.device
    pix2 = (oa / _f32(n, dev)) ** 2
    lbox2 = oa ** 2
    lx, ly, lm = _l_grids(n, oa)
    cos2, sin2 = _trig2(n, dev)
    C = _interp_cl(cl_ee, lm)
    NE = _interp_cl(nl_ee, lm)
    NB = _interp_cl(nl_bb, lm)
    band = (lm >= lmin) & (lm <= lmax_filter)
    FE = torch.where(band & (C + NE > 0),
                     1.0 / torch.where(C + NE > 0, C + NE, 1.0), 0.0)
    # fiducial C_BB = 0: the B filter is 1/N_BB; a zero noise spectrum
    # degrades to a white band filter (unbiased, not minimum-variance, and
    # N0 below is that of the actual filters)
    FB = torch.where(band, torch.where(NB > 0, 1.0 / torch.where(
        NB > 0, NB, 1.0), 1.0), 0.0)

    ql = pix2 * torch.fft.fft2(q_map)
    ul = pix2 * torch.fft.fft2(u_map)
    El = cos2 * ql + sin2 * ul
    Bl = -sin2 * ql + cos2 * ul
    Eb = FE * El
    Bb = FB * Bl

    # phi_un(L) = (1/Lbox^2) sum_l1 (L.l1) C_l1 sin(2(phi1-phi2))
    #             Ebar(l1) Bbar(l2)
    phi_un = 0.0
    for Li, wi in ((lx, lx), (ly, ly)):
        phi_un = phi_un + wi * (
            _conv2(Li * C * sin2 * Eb, cos2 * Bb, n)
            - _conv2(Li * C * cos2 * Eb, sin2 * Bb, n))
    phi_un = -phi_un / lbox2   # the sign of the JAX package's MC check

    R = _eb_quad_sum(n, lx, ly, C, FE, FB, cos2, sin2) / lbox2
    # Gaussian noise of the normalized estimator for the actual filters,
    # N0 = sum f^2 FE^2 FB^2 C^tot_E C^tot_B / R^2 (>= 0; the float32
    # convolutions' negative roundoff at unsupported modes is clamped)
    var_un = torch.clamp_min(_eb_quad_sum(n, lx, ly, C, FE * FE * (C + NE),
                                          FB * FB * NB, cos2, sin2),
                             0.0) / lbox2
    ok = R > (torch.max(R) * 1e-8)
    Rsafe = torch.where(ok, R, 1.0)
    phi_hat = torch.where(ok, phi_un / Rsafe, 0.0)
    kap_l = 0.5 * lm * lm * phi_hat
    kap_map = torch.fft.ifft2(kap_l).real / pix2
    n0_kappa = torch.where(ok, 0.25 * _l4(lm) * var_un / (Rsafe * Rsafe),
                           0.0)
    return kap_map, n0_kappa


def qe_eb_kappa(q_map, u_map, opening_angle, cl_ee, nl_ee=None,
                nl_bb=None, lmin: int = 2,
                lmax_filter: Optional[int] = None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EB quadratic-estimator convergence reconstruction (fiducial C_BB =
    0; the discrete-exact linear-convolution normalization of
    qe_tt_kappa).

    Args:
      q_map, u_map: (n, n) observed Stokes patches (the gamma1 / gamma2
        layout of ops.angular_power.shear_eb_maps).
      cl_ee: fiducial EE spectrum by integer ell (the gradient weight).
      nl_ee, nl_bb: noise spectra; the B filter is 1/nl_bb. nl_bb=None
        degrades to a white band filter (unbiased, not minimum-variance;
        N0 then holds only the noise term).

    Returns (kappa_hat map, N0_kappa grid) on the maps' device."""
    q_map = as_tensor(q_map, device)
    dev = q_map.device
    u_map = as_tensor(u_map, dev)
    cl_ee = _spectrum(cl_ee, dev)
    zero = torch.zeros_like(cl_ee)
    nl_ee = zero if nl_ee is None else _spectrum(nl_ee, dev)
    nl_bb = zero if nl_bb is None else _spectrum(nl_bb, dev)
    L = int(cl_ee.shape[0] - 1) if lmax_filter is None else lmax_filter
    return _qe_eb_impl(q_map, u_map, _f32(opening_angle, dev), cl_ee, nl_ee,
                       nl_bb, int(lmin), L)


# --------------------------------------------------------------------
# curved-sky (HEALPix) TT estimator
# --------------------------------------------------------------------

def _trapezoid(y, x):
    trap = getattr(np, "trapezoid", None) or np.trapz
    return trap(y, x)


def _flat_response_radial(L_values, cl_tt, nl_tt, lmin, lmax_filter,
                          n_l1: int = 512, n_th: int = 256):
    """Isotropic flat-sky TT response R(L) = (1/2) int d^2 l1/(2pi)^2 f^2
    F1 F2 by polar quadrature (host float64): the flat-sky N0
    approximation of the curved-sky normalization (percent-level for
    L >> 10)."""
    cl = np.asarray(cl_tt, np.float64)
    nl = np.asarray(nl_tt, np.float64)
    ells = np.arange(cl.size)

    def CF(l):
        C = np.interp(l, ells, cl, left=0, right=0)
        Nn = np.interp(l, ells, nl, left=0, right=0)
        band = (l >= lmin) & (l <= lmax_filter)
        F = np.where(band & (C + Nn > 0), 1.0 /
                     np.where(C + Nn > 0, C + Nn, 1.0), 0.0)
        return C, F

    l1 = np.linspace(max(lmin, 1), lmax_filter, n_l1)
    th = np.linspace(0, 2 * np.pi, n_th, endpoint=False)
    ct = np.cos(th)[None, :]
    C1, F1 = CF(l1)
    out = np.zeros(len(L_values))
    for i, L in enumerate(np.asarray(L_values, np.float64)):
        l1g = l1[:, None]
        l2x = L - l1g * ct
        l2y = -l1g * np.sin(th)[None, :]
        l2 = np.hypot(l2x, l2y)
        C2, F2 = CF(l2)
        f = (L * l1g * ct) * C1[:, None] + (L * l2x) * C2
        integ = f * f * F1[:, None] * F2
        out[i] = 0.5 * _trapezoid(
            np.sum(integ, axis=1) * (2 * np.pi / n_th) * l1,
            l1) / (2 * np.pi) ** 2
    return out


@lru_cache(maxsize=8)
def _radial_response_cached(cl_bytes: bytes, nl_bytes: bytes, lmin: int,
                            Lf: int, Lo: int) -> np.ndarray:
    """`_flat_response_radial` at L = max(l, 1), l <= Lo, of float64
    spectra given as bytes: the response of a filter configuration is the
    same for every map (its host quadrature takes seconds at Lo ~ 1000),
    so each configuration is computed once."""
    ells_out = np.arange(Lo + 1, dtype=np.float64)
    return _flat_response_radial(np.maximum(ells_out, 1.0),
                                 np.frombuffer(cl_bytes, np.float64),
                                 np.frombuffer(nl_bytes, np.float64), lmin,
                                 Lf)


def _qe_filter_weights(cl_tt, nl_tt, lmin: int, Lf: int):
    """Inverse-variance (F) and Wiener (W = C*F) band filters, host
    float64."""
    ell = np.arange(Lf + 1, dtype=np.float64)
    C = np.interp(ell, np.arange(cl_tt.size), cl_tt, left=0, right=0)
    Nn = np.interp(ell, np.arange(cl_tt.size), np.asarray(nl_tt),
                   left=0, right=0)
    band = (ell >= lmin) & (ell <= Lf)
    F = np.where(band & (C + Nn > 0),
                 1.0 / np.where(C + Nn > 0, C + Nn, 1.0), 0.0)
    return F, C * F


def _column(x: np.ndarray, dev) -> torch.Tensor:
    """A host float64 vector as a float32 (len, 1) column on `dev`."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(dev)[:, None]


def _qe_divergence_to_kappa(er, ei, Lo: int, cl_tt, nl_tt, lmin: int,
                            Lf: int):
    """The QE's shared tail: the (div V) E-alms -> normalized kappa alms
    and N0. (div V)_lm = -g_l E_lm; flat phi_un(L) = FT[div(W0 G)](L)."""
    from .sht_spin import _g_ell

    dev = er.device
    gout = _g_ell(Lo, dev)[:, None]
    phi_re = -gout * er
    phi_im = -gout * ei
    ells_out = np.arange(Lo + 1, dtype=np.float64)
    R = _radial_response_cached(
        np.ascontiguousarray(cl_tt, np.float64).tobytes(),
        np.ascontiguousarray(nl_tt, np.float64).tobytes(), int(lmin),
        int(Lf), int(Lo))
    ok = R > (R.max() * 1e-8)
    Rj = _column(np.where(ok, R, 1.0), dev)
    okj = _column(ok, dev)
    kfac = 0.5 * _column(ells_out * (ells_out + 1.0), dev)
    k_re = okj * kfac * phi_re / Rj
    k_im = okj * kfac * phi_im / Rj
    n0_kappa = np.where(ok, 0.25 * (ells_out * (ells_out + 1.0)) ** 2
                        / np.where(ok, R, 1.0), 0.0)
    return k_re, k_im, torch.from_numpy(n0_kappa.astype(np.float32)).to(dev)


def qe_tt_kappa_healpix(t_map, cl_tt, nl_tt=None, lmin: int = 2,
                        lmax_filter: Optional[int] = None,
                        lmax_out: Optional[int] = None,
                        method: str = "auto", device=None):
    """Curved-sky TT quadratic estimator: kappa_hat alms from a lensed
    HEALPix temperature map.

    The inverse-variance filtered map, the Wiener-filtered gradient by the
    spin-1 synthesis, the divergence of their product by the spin-1
    analysis ((div V)_lm = -g_l E^V_lm), normalized by the isotropic
    flat-sky response: the one approximation in the chain (+13% response
    at L = 20 in a narrow toy band with lmax_filter = 120, in the JAX
    package's measurement, shrinking toward the percent level for L >> 10
    and production bands).

    method selects the SHT backend: 'tables' (ops.sht / ops.sht_spin,
    O(lmax^2 nring) host tables), 'scan' (ops.sht_large /
    ops.sht_spin_large, O(lmax nring) memory), 'auto' ('scan' once the
    scalar and two spin-1 tables would pass 256 MB). The map analysis is
    the plain adjoint at lmax_filter <= 2 nside and 3 Jacobi iterations
    above.

    Returns (k_re, k_im, n0_kappa): kappa alms [l, m] and the 1D
    N0_kappa(L) of the normalization, on the map's device."""
    from ..utils import healpix as hpx
    from . import sht as _sht
    from . import sht_spin as _ss

    if method not in ("auto", "tables", "scan"):
        raise ValueError(f"method must be auto/tables/scan, got {method!r}")
    t_map = as_tensor(t_map, device)
    dev = t_map.device
    nside = hpx.npix2nside(t_map.shape[0])
    cl_tt = _host64(cl_tt)
    nl_tt = np.zeros_like(cl_tt) if nl_tt is None else _host64(nl_tt)
    Lf = int(cl_tt.size - 1) if lmax_filter is None else int(lmax_filter)
    Lo = Lf if lmax_out is None else int(lmax_out)
    if method == "auto":
        nring = 4 * nside - 1
        L = max(Lf, Lo)
        nlm = (L + 1) * (L + 2) // 2
        # scalar + two spin-1 tables, 4 bytes each
        use_scan = 3 * nlm * nring * 4 > (1 << 28)
    else:
        use_scan = method == "scan"
    niter = 0 if Lf <= 2 * nside else 3
    if use_scan:
        return _qe_tt_kappa_healpix_scan(t_map, cl_tt, nl_tt, lmin, Lf, Lo,
                                         nside, niter)
    tlm_re, tlm_im = _sht.analyze(t_map, nside, Lf, niter=niter)
    F, W = _qe_filter_weights(cl_tt, nl_tt, lmin, Lf)
    Fj, Wj = _column(F, dev), _column(W, dev)
    g = _ss._g_ell(Lf, dev)[:, None]
    tbar = _sht.synthesize(tlm_re * Fj, tlm_im * Fj, nside, Lf)
    z = torch.zeros_like(tlm_re)
    g_t, g_p = _ss.synthesize_spin1(tlm_re * Wj * g, tlm_im * Wj * g, z, z,
                                    nside, Lf)
    er, ei, _, _ = _ss.analyze_spin1(tbar * g_t, tbar * g_p, nside, Lo,
                                     niter=3)
    return _qe_divergence_to_kappa(er, ei, Lo, cl_tt, nl_tt, lmin, Lf)


def _qe_tt_kappa_healpix_scan(t_map, cl_tt, nl_tt, lmin: int, Lf: int,
                              Lo: int, nside: int, niter: int):
    """qe_tt_kappa_healpix on the table-free recursions (ops.sht_large,
    ops.sht_spin_large): O(lmax * nring) memory, so nside 1024 / lmax 2048
    runs without the tables' tens of GB."""
    from . import sht_large as _sl
    from . import sht_spin as _ss
    from . import sht_spin_large as _ssl

    dev = t_map.device
    tlm_re, tlm_im = _sl.analyze_large(t_map, nside, Lf, niter=niter,
                                       method="jacobi")
    F, W = _qe_filter_weights(cl_tt, nl_tt, lmin, Lf)
    Fj, Wj = _column(F, dev), _column(W, dev)
    g = _ss._g_ell(Lf, dev)[:, None]
    stab = _sl.sht_large_tables(nside, Lf, dev)
    s1tab = _ssl.spin1_large_tables(nside, max(Lf, Lo), dev)
    tbar = _sl.synthesize_large(tlm_re * Fj, tlm_im * Fj, nside, Lf,
                                tables=stab)
    z = torch.zeros_like(tlm_re)
    g_t, g_p = _ssl.synthesize_spin1_large(
        tlm_re * Wj * g, tlm_im * Wj * g, z, z, nside, Lf,
        tables=(s1tab if Lf == max(Lf, Lo) else None))
    er, ei, _, _ = _ssl.analyze_spin1_large(
        tbar * g_t, tbar * g_p, nside, Lo, niter=3, method="jacobi",
        tables=(s1tab if Lo == max(Lf, Lo) else None))
    return _qe_divergence_to_kappa(er, ei, Lo, cl_tt, nl_tt, lmin, Lf)
