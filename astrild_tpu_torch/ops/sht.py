"""Spherical harmonic transforms on HEALPix RING maps: the table path, the
full-sky MASTER estimators and the band-power shape model.

Port of astrild_tpu/ops/sht.py. The normalized associated Legendre table
lambda_lm(theta) and the ring phases cos / sin(m phi) are built on the
host in float64 (the JAX package's numpy, bit for bit) and uploaded once
per (nside, lmax, device) as float32. The transforms are

  synthesis:  c[m,r]   = sum_l  a[l,m] * lambda[l,m](theta_r)
              map[r,p] = c0 + sum_{m>0} 2 Re(c[m,r] e^{im phi_rp})
  analysis:   the adjoint with 4pi/npix quadrature weights, optionally
              Jacobi-iterated (healpy's `iter`),

each contraction written as an elementwise product and a sum over the
contracted axis, in chunks that bound the temporaries: no matrix product,
so a caller's TF32 setting cannot reach them. The table is O(lmax^2 *
nring) floats (5.4 GB with its phases at nside 256, lmax 512); beyond
lmax 512 the callers route through the scan path of ops/sht_large.py.

alm layout: separate real and imaginary (lmax+1, lmax+1) [l, m] arrays,
zero for m > l; a real field has alm_im[:, 0] == 0. Numpy input goes to
`device`, by default the CUDA card (it raises without one); tensors keep
their device. Random maps draw from a `torch.Generator`; the
`_from_white` twins take the normal draws themselves (the JAX package's,
in its split order, in the tests).

The MASTER band machinery (`shape_binned_interp`, `_bin_operator`,
`_binned_shape_ops`) and the coupling matrices are host float64 numpy,
shared with the flat-sky estimators of ops/angular_power.py.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..utils import healpix as hpx

__all__ = ["RingGeometry", "ring_geometry", "legendre_table", "SHTTables",
           "sht_tables", "synthesize", "analyze", "alm2cl", "cl_to_lmax",
           "synfast", "synfast_from_white", "anafast", "smoothing",
           "anafast_masked", "coupling_matrix_from_mask_cl",
           "anafast_master", "shape_binned_interp"]

# elements of one chunk's product temporary (256 MB of float32)
_CHUNK_ELEMS = 1 << 26
# above this lmax the callers take the table-free scan path (sht_large)
_TABLE_LMAX = 512


def _span(name: str):
    return torch.profiler.record_function(name)


def _device_key(device) -> torch.device:
    """A device as a cache key: a CUDA device without an index is the
    current one."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _chunks(n: int, per: int):
    """[start, stop) slices of range(n) in steps of max(1, per)."""
    step = max(1, int(per))
    return [(i, min(n, i + step)) for i in range(0, n, step)]


class RingGeometry(NamedTuple):
    theta: np.ndarray      # (nring,) colatitude of each iso-latitude ring
    phi_pad: np.ndarray    # (nring, pmax) pixel longitudes, zero-padded
    mask: np.ndarray       # (nring, pmax) 1.0 where a real pixel exists
    flat_idx: np.ndarray   # (npix,) RING pixel -> index into padded plane


@lru_cache(maxsize=8)
def ring_geometry(nside: int) -> RingGeometry:
    """Ring structure of the RING scheme, derived from exact ring sizes
    ([4i]_{i<nside} + [4 nside]*(2 nside + 1) + mirrored caps) and the
    package's own pix2ang (utils/healpix.py)."""
    sizes = ([4 * i for i in range(1, nside)]
             + [4 * nside] * (2 * nside + 1)
             + [4 * i for i in range(nside - 1, 0, -1)])
    npix = hpx.nside2npix(nside)
    if sum(sizes) != npix:
        raise ValueError(f"ring sizes of nside {nside} do not sum to npix")
    theta_all, phi_all = (np.asarray(a, np.float64) for a in
                          hpx.pix2ang_ring(nside, np.arange(npix)))
    nring = len(sizes)
    pmax = 4 * nside
    theta = np.zeros(nring)
    phi_pad = np.zeros((nring, pmax))
    mask = np.zeros((nring, pmax))
    flat_idx = np.zeros(npix, np.int64)
    start = 0
    for r, n in enumerate(sizes):
        theta[r] = theta_all[start]
        phi_pad[r, :n] = phi_all[start:start + n]
        mask[r, :n] = 1.0
        flat_idx[start:start + n] = r * pmax + np.arange(n)
        start += n
    return RingGeometry(theta, phi_pad, mask, flat_idx)


def legendre_table(lmax: int, costheta: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre lambda_lm(theta) with the
    spherical-harmonic norm (Y_lm = lambda_lm e^{im phi}, Condon-Shortley),
    shape (lmax+1, lmax+1, ntheta) indexed [l, m, theta]; zero for m > l.

    Exact float64 recursion (the one healpy/libsharp use):
      lambda_00 = 1/sqrt(4 pi)
      lambda_mm = -sqrt((2m+1)/(2m)) sin(theta) lambda_{m-1,m-1}
      lambda_{m+1,m} = sqrt(2m+3) cos(theta) lambda_mm
      lambda_lm = a_lm (x lambda_{l-1,m} - b_lm lambda_{l-2,m})
        a_lm = sqrt((4l^2-1)/(l^2-m^2)), b_lm = sqrt(((l-1)^2-m^2)/(4(l-1)^2-1))
    """
    x = np.asarray(costheta, np.float64)
    s = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    L = lmax
    lam = np.zeros((L + 1, L + 1, x.size))
    lam[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
    for l in range(1, L + 1):
        lam[l, l] = -np.sqrt((2.0 * l + 1.0) / (2.0 * l)) * s * lam[l - 1, l - 1]
        lam[l, l - 1] = np.sqrt(2.0 * l + 1.0) * x * lam[l - 1, l - 1]
        if l >= 2:
            m = np.arange(0, l - 1, dtype=np.float64)
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m)
                        / (4.0 * (l - 1.0) ** 2 - 1.0))
            lam[l, : l - 1] = a[:, None] * (
                x[None, :] * lam[l - 1, : l - 1] - b[:, None] * lam[l - 2, : l - 1])
    return lam


class SHTTables(NamedTuple):
    """Device-resident transform tables (float32 but the index arrays)."""
    lam: torch.Tensor       # (L+1, L+1, nring)
    cosmphi: torch.Tensor   # (L+1, nring, pmax) cos(m phi), mask folded in
    sinmphi: torch.Tensor   # (L+1, nring, pmax)
    flat_idx: torch.Tensor  # (npix,)
    pad_idx: torch.Tensor   # (nring*pmax,) inverse gather, 0 where padding
    pad_valid: torch.Tensor  # (nring*pmax,) 1.0 at real pixels


def _pad_gather(geo: RingGeometry):
    """(pad_idx, pad_valid): the padded plane's gather from a RING map."""
    nring, pmax = geo.phi_pad.shape
    pad_idx = np.zeros(nring * pmax, np.int64)
    pad_valid = np.zeros(nring * pmax, np.float32)
    pad_idx[geo.flat_idx] = np.arange(geo.flat_idx.size)
    pad_valid[geo.flat_idx] = 1.0
    return pad_idx, pad_valid


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`, float arrays as float32."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(dev)


def _phase_slab(geo: RingGeometry, m0: int, m1: int):
    """cos / sin(m phi) * mask of m in [m0, m1), float64 on the host as the
    JAX package builds them, returned as float32."""
    m = np.arange(m0, m1, dtype=np.float64)
    ang = m[:, None, None] * geo.phi_pad[None, :, :]
    return ((np.cos(ang) * geo.mask[None]).astype(np.float32),
            (np.sin(ang) * geo.mask[None]).astype(np.float32))


@lru_cache(maxsize=8)
def _sht_tables(nside: int, lmax: int, dev: torch.device) -> SHTTables:
    geo = ring_geometry(nside)
    lam = _upload(legendre_table(lmax, np.cos(geo.theta)), dev)
    nring, pmax = geo.phi_pad.shape
    cosm = torch.empty((lmax + 1, nring, pmax), dtype=torch.float32,
                       device=dev)
    sinm = torch.empty_like(cosm)
    # the phases a slab of m at a time (the same elementwise values as the
    # whole (L+1, nring, pmax) product), the slabs on the host's cores
    # (numpy's ufuncs release the interpreter lock)
    slabs = _chunks(lmax + 1, _CHUNK_ELEMS // (4 * nring * pmax))
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for (m0, m1), (c, s) in zip(slabs, pool.map(
                lambda mm: _phase_slab(geo, *mm), slabs)):
            cosm[m0:m1] = torch.from_numpy(c).to(dev)
            sinm[m0:m1] = torch.from_numpy(s).to(dev)
    pad_idx, pad_valid = _pad_gather(geo)
    return SHTTables(lam, cosm, sinm, _upload(geo.flat_idx, dev),
                     _upload(pad_idx, dev), _upload(pad_valid, dev))


def sht_tables(nside: int, lmax: int, device=None) -> SHTTables:
    """The table path's device tables for (nside, lmax), cached per device
    (`device` as the port places numpy input: by default the CUDA card)."""
    return _sht_tables(nside, lmax, _device_key(device))


# ----------------------------------------------------------- contractions
def _legendre_sum(lam, a):
    """c[m, r] = sum_l lam[l, m, r] a[l, m], one slab of m at a time."""
    L1, M1, R = lam.shape
    out = torch.empty((M1, R), dtype=lam.dtype, device=lam.device)
    for m0, m1 in _chunks(M1, _CHUNK_ELEMS // (L1 * R)):
        out[m0:m1] = (lam[:, m0:m1] * a[:, m0:m1, None]).sum(0)
    return out


def _legendre_sum_t(lam, d):
    """a[l, m] = sum_r lam[l, m, r] d[m, r], one slab of l at a time."""
    L1, M1, R = lam.shape
    out = torch.empty((L1, M1), dtype=lam.dtype, device=lam.device)
    for l0, l1 in _chunks(L1, _CHUNK_ELEMS // (M1 * R)):
        out[l0:l1] = (lam[l0:l1] * d[None]).sum(-1)
    return out


def _phase_sum(c, trig):
    """plane[r, p] = sum_m c[m, r] trig[m, r, p], one slab of m at a time."""
    M1, R, P = trig.shape
    out = torch.zeros((R, P), dtype=trig.dtype, device=trig.device)
    for m0, m1 in _chunks(M1, _CHUNK_ELEMS // (R * P)):
        out += (c[m0:m1, :, None] * trig[m0:m1]).sum(0)
    return out


def _phase_sum_t(plane, trig):
    """d[m, r] = sum_p plane[r, p] trig[m, r, p], one slab of m at a time."""
    M1, R, P = trig.shape
    out = torch.empty((M1, R), dtype=trig.dtype, device=trig.device)
    for m0, m1 in _chunks(M1, _CHUNK_ELEMS // (R * P)):
        out[m0:m1] = (trig[m0:m1] * plane[None]).sum(-1)
    return out


def _m_weights(lmax: int, device) -> torch.Tensor:
    """(lmax+1, 1): 1 for m = 0, 2 for m > 0 (the real field's pair)."""
    w = torch.full((lmax + 1, 1), 2.0, device=device)
    w[0] = 1.0
    return w


def _synth_impl(alm_re, alm_im, tab: SHTTables):
    c_re = _legendre_sum(tab.lam, alm_re)
    c_im = _legendre_sum(tab.lam, alm_im)
    w = _m_weights(alm_re.shape[1] - 1, alm_re.device)
    map_pad = (_phase_sum(w * c_re, tab.cosmphi)
               - _phase_sum(w * c_im, tab.sinmphi))
    return map_pad.reshape(-1)[tab.flat_idx]


def _adjoint_impl(hpmap, tab: SHTTables):
    npix = hpmap.shape[0]
    pad = (hpmap[tab.pad_idx] * tab.pad_valid).reshape(
        tab.cosmphi.shape[1:])
    d_re = _phase_sum_t(pad, tab.cosmphi)
    d_im = -_phase_sum_t(pad, tab.sinmphi)
    wq = 4.0 * np.pi / npix
    return (wq * _legendre_sum_t(tab.lam, d_re),
            wq * _legendre_sum_t(tab.lam, d_im))


def _map(x, device, tables=None) -> torch.Tensor:
    """x as a float32 tensor: numpy on `device`, else on the tables'
    device, else where `as_tensor` puts it; a tensor where it lies."""
    if device is None and tables is not None \
            and not isinstance(x, torch.Tensor):
        device = tables[0].device
    return as_tensor(x, device)


def _alm_pair(alm_re, alm_im, device, tables):
    """Two alm arrays placed as `_map` places the first."""
    a_re = _map(alm_re, device, tables)
    return a_re, as_tensor(alm_im, a_re.device)


def _white_device(white, device, tables):
    """Where a `_from_white` twin computes: `device`, else the draws'
    device, else the tables' (numpy everywhere: the default device)."""
    if device is not None:
        return device
    if isinstance(white, torch.Tensor):
        return white.device
    return None if tables is None else tables[0].device


def synthesize(alm_re, alm_im, nside: int, lmax: int,
               tables: Optional[SHTTables] = None, device=None):
    """Real-field SH synthesis: (lmax+1, lmax+1) [l, m] alm -> RING map.

    alm for m>0 represent a_lm with a_{l,-m} = (-1)^m conj(a_lm) implied
    (real field); a_{l0} must have alm_im[:, 0] == 0.
    """
    a_re, a_im = _alm_pair(alm_re, alm_im, device, tables)
    tab = tables if tables is not None else sht_tables(nside, lmax,
                                                       a_re.device)
    return _synth_impl(a_re, a_im, tab)


def analyze(hpmap, nside: int, lmax: int, niter: int = 3,
            tables: Optional[SHTTables] = None, device=None):
    """Real-field SH analysis: RING map -> (alm_re, alm_im), [l, m] layout.

    niter Jacobi iterations refine the approximate HEALPix quadrature
    (healpy's map2alm `iter`): alm += A(map - S(alm)).
    """
    hpmap = _map(hpmap, device, tables)
    tab = tables if tables is not None else sht_tables(nside, lmax,
                                                       hpmap.device)
    a_re, a_im = _adjoint_impl(hpmap, tab)
    for _ in range(niter):
        resid = hpmap - _synth_impl(a_re, a_im, tab)
        d_re, d_im = _adjoint_impl(resid, tab)
        a_re, a_im = a_re + d_re, a_im + d_im
    return a_re, a_im


def alm2cl(alm_re, alm_im):
    """Cl = (|a_l0|^2 + 2 sum_{m>0} |a_lm|^2) / (2l+1)."""
    L = alm_re.shape[0] - 1
    p = alm_re ** 2 + alm_im ** 2
    w = _m_weights(L, p.device)[:, 0]
    # zero the (structurally absent) m > l entries
    p = torch.tril(p)
    ell = torch.arange(L + 1, dtype=p.dtype, device=p.device)
    return torch.sum(p * w[None, :], dim=1) / (2.0 * ell + 1.0)


def cl_to_lmax(cl, lmax: int):
    """Truncate or zero-pad a Cl table to length lmax+1 (healpy synfast
    semantics: an explicit lmax beyond the table means zero power
    there)."""
    if cl.shape[0] >= lmax + 1:
        return cl[: lmax + 1]
    return torch.nn.functional.pad(cl, (0, lmax + 1 - cl.shape[0]))


def _gaussian_alms(white_re, white_im, cl, L: int, lmin: int = 0):
    """Gaussian alms of spectrum cl from N(0, 1) draws (lmax+1, lmax+1):
    the m = 0 row real with variance Cl, m > 0 split Cl/2 per part; zero
    above the triangle and below lmin."""
    dev = cl.device
    lgrid = torch.arange(L + 1, device=dev)[:, None]
    mgrid = torch.arange(L + 1, device=dev)[None, :]
    valid = ((mgrid <= lgrid) & (lgrid >= lmin)).to(torch.float32)
    sig = torch.sqrt(torch.clamp_min(cl_to_lmax(cl, L), 0.0))[:, None]
    half = float(np.float32(np.sqrt(np.float32(0.5))))
    a_re = as_tensor(white_re, dev) * sig * valid
    a_im = as_tensor(white_im, dev) * sig * valid
    a_re = torch.where(mgrid == 0, a_re, a_re * half)
    a_im = torch.where(mgrid == 0, torch.zeros_like(a_im), a_im * half)
    return a_re, a_im


def _spectrum(cl, lmax, device):
    cl = as_tensor(cl, device)
    return cl, (cl.shape[0] - 1) if lmax is None else int(lmax)


def synfast_from_white(white_re, white_im, cl, nside: int,
                       lmax: Optional[int] = None,
                       tables: Optional[SHTTables] = None, device=None):
    """`synfast` of given N(0, 1) draws (each (lmax+1, lmax+1)): white_re
    and white_im take the JAX package's normal(k1) and normal(k2) of
    `k1, k2 = split(key)`."""
    if not isinstance(cl, torch.Tensor):
        device = _white_device(white_re, device, tables)
    cl, L = _spectrum(cl, lmax, device)
    a_re, a_im = _gaussian_alms(white_re, white_im, cl, L)
    return synthesize(a_re, a_im, nside, L, tables=tables)


def _white_pair(generator: torch.Generator, L: int):
    return tuple(torch.randn((L + 1, L + 1), generator=generator,
                             device=generator.device) for _ in range(2))


def synfast(generator: torch.Generator, cl, nside: int,
            lmax: Optional[int] = None,
            tables: Optional[SHTTables] = None):
    """Gaussian random RING map with angular spectrum cl[l] on the
    generator's device (hp.sphtfunc.synfast parity; another realization
    than the JAX package's key of the same seed)."""
    cl, L = _spectrum(cl, lmax, generator.device)
    white_re, white_im = _white_pair(generator, L)
    return synfast_from_white(white_re, white_im, cl, nside, L,
                              tables=tables)


def anafast(hpmap, lmax: int, niter: int = 3,
            tables: Optional[SHTTables] = None, device=None):
    """Cl of a RING map (hp.sphtfunc.anafast parity)."""
    hpmap = _map(hpmap, device, tables)
    nside = hpx.npix2nside(hpmap.shape[0])
    a_re, a_im = analyze(hpmap, nside, lmax, niter=niter, tables=tables)
    return alm2cl(a_re, a_im)


def _beam_window(fwhm_rad: float, lmax: int, device) -> torch.Tensor:
    """(lmax+1, 1) Gaussian beam b_l = exp(-l(l+1) sigma^2 / 2), sigma =
    fwhm / sqrt(8 ln 2), float32 as the JAX package forms it."""
    sigma = fwhm_rad / np.sqrt(8.0 * np.log(2.0))
    ell = torch.arange(lmax + 1, dtype=torch.float32, device=device)
    return torch.exp(-0.5 * ell * (ell + 1.0) * sigma ** 2)[:, None]


def smoothing(hpmap, fwhm_rad: float, lmax: int, niter: int = 3,
              tables: Optional[SHTTables] = None, device=None):
    """Gaussian-beam smoothing in harmonic space (healpy
    sphtfunc.smoothing parity): a_lm -> a_lm b_l."""
    hpmap = _map(hpmap, device, tables)
    nside = hpx.npix2nside(hpmap.shape[0])
    tab = tables if tables is not None else sht_tables(nside, lmax,
                                                       hpmap.device)
    a_re, a_im = analyze(hpmap, nside, lmax, niter=niter, tables=tab)
    bl = _beam_window(fwhm_rad, lmax, hpmap.device)
    return synthesize(a_re * bl, a_im * bl, nside, lmax, tables=tab)


def anafast_masked(hpmap, mask, lmax: int, niter: int = 3,
                   tables: Optional[SHTTables] = None, device=None):
    """f_sky-corrected pseudo-Cl of a masked map: Cl(map*mask)/<mask^2>.

    Exact mode decoupling is not attempted: the <w^2> normalization is
    unbiased for spectra smooth on the mask's coupling scale (the
    flat-sky twin is ops/angular_power.cl_flat_sky_masked). Beyond lmax
    512 the analysis takes the scan path, as anafast_master's does, where
    the JAX package builds the table: the result then differs from its
    by the gap of the float32 scan recursion to the table, which grows
    with lmax (ROADMAP.md section 3)."""
    hpmap = _map(hpmap, device, tables)
    mask = as_tensor(mask, hpmap.device)
    w2 = torch.mean(mask ** 2)
    cl = _analysis_cl(hpmap * mask, lmax, niter, tables)
    return cl / torch.clamp_min(w2, 1e-12)


def coupling_matrix_from_mask_cl(mask_cl, lmax: int):
    """Full-sky MASTER mode-coupling matrix M_ll' from the mask spectrum.

    Hivon et al. (2002) eq. A31:

        M_l1l2 = (2 l2 + 1)/(4 pi) sum_l3 (2 l3 + 1) W_l3 wigner3j(l1,
                 l2, l3; 0,0,0)^2

    evaluated without Wigner symbols through the Legendre-product
    identity int P_l1 P_l2 P_l3 dmu = 2 * 3j(000)^2:

        M_l1l2 = (2 l2 + 1)/2 * int dmu P_l1(mu) P_l2(mu) xi_W(mu),
        xi_W(mu) = sum_l3 (2 l3 + 1)/(4 pi) W_l3 P_l3(mu)

    with Gauss-Legendre quadrature of enough nodes to be exact for the
    polynomial integrand (degree 2*lmax + len(mask_cl)). mask_cl should
    extend to 2*lmax when possible; shorter tables truncate the sum like
    every MASTER code.

    Host float64 numpy (the JAX package's, bit for bit): float32 noise in
    M couples a steep spectrum's low-ell power into high ells.
    """
    wl = np.asarray(mask_cl, np.float64)
    lmax_w = wl.shape[0] - 1
    deg = 2 * lmax + lmax_w
    ngl = deg // 2 + 2
    mu, gw = np.polynomial.legendre.leggauss(ngl)
    # P_l(mu) rows by recurrence, float64 on host (values in [-1, 1])
    lmax_tab = max(lmax, lmax_w)
    P = np.zeros((lmax_tab + 1, ngl))
    P[0] = 1.0
    if lmax_tab >= 1:
        P[1] = mu
    for ell in range(2, lmax_tab + 1):
        P[ell] = ((2 * ell - 1) * mu * P[ell - 1]
                  - (ell - 1) * P[ell - 2]) / ell
    l3 = np.arange(lmax_w + 1)
    xi = ((2 * l3 + 1) / (4 * np.pi) * wl) @ P[: lmax_w + 1]   # (ngl,)
    Pl = P[: lmax + 1]
    core = (Pl * (gw * xi)[None, :]) @ Pl.T
    l2 = np.arange(lmax + 1, dtype=np.float64)
    return core * (2.0 * l2 + 1.0)[None, :] / 2.0


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _analysis_cl(hpmap, lmax: int, niter: int, tables=None):
    """anafast on the table path up to lmax 512, on the scan path above."""
    if lmax <= _TABLE_LMAX:
        return anafast(hpmap, lmax, niter=niter, tables=tables)
    from . import sht_large

    return sht_large.anafast_large(hpmap, lmax, niter=niter)


def anafast_master(hpmap, mask, lmax: int, nbins: int = 16,
                   niter: int = 3, lmin: int = 2,
                   lmax_mask: Optional[int] = None,
                   tables: Optional[SHTTables] = None,
                   mask_tables: Optional[SHTTables] = None,
                   coupling=None, device=None):
    """Mask-decoupled full-sky spectrum: binned MASTER estimator.

    The pseudo-Cl of map*mask, M_ll' from the mask's own spectrum (host
    float64), both binned into band powers, and the binned system solved.
    Unlike anafast_masked's <w^2> division this is unbiased for steep
    spectra under aggressive masks. For many maps under one mask pass
    `coupling = coupling_matrix_from_mask_cl(mask_cl, lmax)` once.
    Beyond lmax 512 the analyses take the scan path (ops/sht_large).

    Returns (ell_eff, cl_hat): the band centers and band powers (float32
    tensors on the map's device).
    """
    hpmap = _map(hpmap, device, tables)
    mask = as_tensor(mask, hpmap.device)
    nside = hpx.npix2nside(hpmap.shape[0])
    if lmax_mask is None:
        lmax_mask = min(2 * lmax, 2 * nside)
    pcl = _analysis_cl(hpmap * mask, lmax, niter, tables)
    if coupling is None:
        wl = _analysis_cl(mask, lmax_mask, niter, mask_tables)
        M = coupling_matrix_from_mask_cl(_host64(wl), lmax)
    else:
        M = _host64(coupling)
    B, Q, ell_eff = _binned_shape_ops(lmax, nbins, lmin)
    Mb = B @ M @ Q
    pb = B @ _host64(pcl)
    cl_hat = np.linalg.solve(Mb, pb)
    return (torch.from_numpy(ell_eff).to(hpmap.device),
            torch.from_numpy(cl_hat.astype(np.float32)).to(hpmap.device))


# ------------------------------------------------------ MASTER band model
def _check_bands(counts, what: str) -> None:
    """Raise on an empty band: a singular banded system otherwise surfaces
    as an opaque LinAlgError from the downstream solve."""
    empty = np.nonzero(counts <= 0)[0]
    if empty.size:
        raise ValueError(
            f"MASTER binning: band(s) {empty.tolist()} contain no "
            f"{what} — reduce nbins (each of the {counts.shape[0]} "
            "bands must contain at least one) or widen the range")


def shape_binned_interp(ell_values, member, counts,
                        what: str = "multipoles") -> np.ndarray:
    """(nbins, N) in-band l(l+1) shape-model interpolation operator q.

    The single home of the MASTER band-power shape model: within band b
    the spectrum is modeled as C = c_b * s * N_b / sum_b(s) with
    s = 1/(l(l+1)), so the band power c_b stays the plain band average of
    C while steep in-band variation does not bias the decoupling solve
    (NaMaster's convention). Host float64 throughout.

    ell_values: (N,) per-element multipole values; member: (nbins, N)
    0/1 band membership; counts: (nbins,) members per band. Raises
    ValueError on an empty band.
    """
    member = np.asarray(member, np.float64)
    counts = np.asarray(counts, np.float64)
    _check_bands(counts, what)
    s = _shape(np.asarray(ell_values, np.float64))
    ssum = member @ s
    return member * s[None, :] * _band_scale(counts, ssum)[:, None]


def _shape(ell_values):
    """s = 1/max(l(l+1), 1) of a float64 numpy array or torch tensor: the
    model's in-band shape, shared with the flat-sky coupling built on the
    card (`angular_power._card_couplings`)."""
    return 1.0 / (ell_values * (ell_values + 1.0)).clip(min=1.0)


def _band_scale(counts, shape_sums):
    """N_b / sum_{l in b} s per band, numpy or torch: the factor that keeps
    the band power c_b the plain band average."""
    return counts / shape_sums.clip(min=1e-300)


def _bin_operator(lmax: int, nbins: int, lmin: int = 2) -> np.ndarray:
    """(nbins, lmax+1) flat band-power binning matrix over [lmin, lmax]."""
    edges = np.linspace(lmin, lmax + 1, nbins + 1)
    B = np.zeros((nbins, lmax + 1))
    ells = np.arange(lmax + 1)
    for b in range(nbins):
        sel = (ells >= edges[b]) & (ells < edges[b + 1])
        if sel.sum():
            B[b, sel] = 1.0 / sel.sum()
    return B


def _binned_shape_ops(lmax: int, nbins: int, lmin: int):
    """(B, Q, ell_eff): the binning operator, the l(l+1) in-band
    shape-model columns and the band centers (float32), shared by the
    scalar (anafast_master) and spin-2 (sht_spin.anafast_spin2_master)
    full-sky estimators; an empty band raises (shape_binned_interp)."""
    B = _bin_operator(lmax, nbins, lmin=lmin)
    ells_f = np.arange(lmax + 1, dtype=np.float64)
    sel = (B > 0).astype(np.float64)                      # (nbins, lmax+1)
    Q = shape_binned_interp(ells_f, sel, sel.sum(1),
                            what=f"multipoles in [{lmin}, {lmax}]").T
    ell_eff = (B @ np.arange(lmax + 1)).astype(np.float32)
    return B, Q, ell_eff
