"""Minimal HEALPix (RING scheme) on the host: pixel counts, ang2pix and
pix2ang.

Numpy copy of astrild_tpu/utils/healpix.py (Gorski et al. 2005): pixel
counts, `ang2pix_ring` / `pix2ang_ring`, unit vectors, the 4-neighbour
bilinear interpolation stencil and map rotation, kept bit-identical with
the original (the tests hold it to that). `SkyHealpix` gathers on the
device with the stencil these host functions build.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nside2npix", "npix2nside", "ang2pix_ring", "pix2ang_ring",
           "ang2vec", "vec2ang", "rotate_map", "get_interp_val_nearest",
           "get_interp_weights", "get_interp_val", "euler_matrix_zyx",
           "UNSEEN"]

UNSEEN = -1.6375e30


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12.0)))
    if nside2npix(nside) != npix:
        raise ValueError(f"bad npix {npix}: not 12 * nside^2")
    return nside


def ang2pix_ring(nside: int, theta, phi):
    """(theta, phi) [rad] -> RING pixel index; vectorized."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)  # in [0, 4)
    pix = np.empty(np.broadcast(z, tt).shape, np.int64)
    z, tt, za = np.broadcast_arrays(z, tt, za)

    eq = za <= 2.0 / 3.0
    # --- equatorial belt ---
    temp1 = nside * (0.5 + tt[eq])
    temp2 = nside * 0.75 * z[eq]
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ir = nside + 1 + jp - jm          # ring counted within the belt
    kshift = 1 - (ir & 1)
    ip = ((jp + jm - nside + kshift + 1) // 2) % (4 * nside)
    ncap = 2 * nside * (nside - 1)
    pix[eq] = ncap + (ir - 1) * 4 * nside + ip

    # --- polar caps ---
    po = ~eq
    tp = tt[po] - np.floor(tt[po])
    tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
    jp = np.floor(tp * tmp).astype(np.int64)
    jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir = jp + jm + 1
    ip = np.floor(tt[po] * ir).astype(np.int64) % (4 * ir)
    north = z[po] > 0
    pp = np.empty(ir.shape, np.int64)
    pp[north] = 2 * ir[north] * (ir[north] - 1) + ip[north]
    pp[~north] = (nside2npix(nside) - 2 * ir[~north] * (ir[~north] + 1)
                  + ip[~north])
    pix[po] = pp
    return pix


def pix2ang_ring(nside: int, ipix):
    """RING pixel index -> (theta, phi) [rad] of pixel centers."""
    ipix = np.asarray(ipix, np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    theta = np.empty(ipix.shape, np.float64)
    phi = np.empty(ipix.shape, np.float64)

    # north polar cap
    north = ipix < ncap
    ip = ipix[north]
    iring = (1 + np.sqrt(1.0 + 2.0 * ip).astype(np.int64)) // 2
    # refine (integer sqrt edge cases)
    iring = np.where(2 * iring * (iring - 1) > ip, iring - 1, iring)
    iring = np.where(2 * iring * (iring + 1) <= ip, iring + 1, iring)
    iphi = ip - 2 * iring * (iring - 1)
    theta[north] = np.arccos(1.0 - iring ** 2 / (3.0 * nside ** 2))
    phi[north] = (iphi + 0.5) * np.pi / (2.0 * iring)

    # equatorial belt
    eq = (ipix >= ncap) & (ipix < npix - ncap)
    ip = ipix[eq] - ncap
    iring = ip // (4 * nside) + nside
    iphi = ip % (4 * nside)
    fodd = 0.5 * (1 + (iring + nside) % 2)
    theta[eq] = np.arccos((2 * nside - iring) * 2.0 / (3.0 * nside))
    # iphi is 0-based here; the standard formula uses 1-based indices
    phi[eq] = (iphi + 1 - fodd) * np.pi / (2.0 * nside)

    # south polar cap
    south = ipix >= npix - ncap
    ip = npix - ipix[south] - 1
    iring = (1 + np.sqrt(2.0 * ip + 1.0).astype(np.int64)) // 2
    iring = np.where(2 * iring * (iring - 1) > ip, iring - 1, iring)
    iring = np.where(2 * iring * (iring + 1) <= ip, iring + 1, iring)
    iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1) + 1)
    theta[south] = np.arccos(-1.0 + iring ** 2 / (3.0 * nside ** 2))
    phi[south] = (iphi - 0.5) * np.pi / (2.0 * iring)
    return theta, phi


def ang2vec(theta, phi):
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], -1)


def vec2ang(vec):
    vec = np.asarray(vec)
    theta = np.arccos(np.clip(vec[..., 2]
                              / np.linalg.norm(vec, axis=-1), -1, 1))
    phi = np.mod(np.arctan2(vec[..., 1], vec[..., 0]), 2 * np.pi)
    return theta, phi


def get_interp_val_nearest(hpmap, theta, phi):
    """Nearest-pixel sampling (healpy.get_interp_val's 0th-order cousin)."""
    nside = npix2nside(len(hpmap))
    return np.asarray(hpmap)[ang2pix_ring(nside, theta, phi)]


def _ring_info(nside: int, iring):
    """Per-ring geometry for RING scheme (iring in [1, 4*nside-1]).

    Returns (nr ring length, startpix, z of ring, phi shift in units of
    the pixel spacing 2*pi/nr).
    """
    iring = np.asarray(iring, np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    north = iring < nside
    south = iring > 3 * nside
    i_s = 4 * nside - iring
    nr = np.where(north, 4 * iring, np.where(south, 4 * i_s, 4 * nside))
    startpix = np.where(
        north, 2 * iring * (iring - 1),
        np.where(south, npix - 2 * i_s * (i_s + 1),
                 ncap + (iring - nside) * 4 * nside))
    z = np.where(
        north, 1.0 - iring ** 2 / (3.0 * nside ** 2),
        np.where(south, -1.0 + i_s ** 2 / (3.0 * nside ** 2),
                 (2.0 * nside - iring) * 2.0 / (3.0 * nside)))
    # cap rings are always half-pixel shifted; equatorial rings alternate
    shift = np.where(north | south, 0.5,
                     np.where((iring + nside) % 2 == 0, 0.5, 0.0))
    return nr, startpix, z, shift


def _ring_above(nside: int, z):
    """Largest ring index whose z_ring > z (0 => point above first ring)."""
    az = np.abs(z)
    ir_cap = np.floor(nside * np.sqrt(3.0 * (1.0 - az))).astype(np.int64)
    ir_eq = np.floor(nside * (2.0 - 1.5 * z)).astype(np.int64)
    return np.where(az > 2.0 / 3.0,
                    np.where(z > 0, ir_cap, 4 * nside - ir_cap - 1),
                    ir_eq)


def get_interp_weights(nside: int, theta, phi):
    """4-neighbor bilinear interpolation stencil (healpy.get_interp_weights).

    Standard HEALPix ring interpolation (Gorski et al. 2005): linear in phi
    along the two rings bracketing theta, linear in theta between them,
    with the polar-cap average fallback beyond the first/last ring
    (healpy.get_interp_val's stencil).

    Returns (pix (4, N) int64, wgt (4, N) float64).
    """
    # broadcast first: healpy accepts scalar theta with array phi (and
    # vice versa) — reshaping separately left a (1,) theta against an
    # (N,) phi, and the polar-cap boolean indexing below then fails
    theta, phi = np.broadcast_arrays(np.asarray(theta, np.float64),
                                     np.asarray(phi, np.float64))
    theta = np.ascontiguousarray(theta).reshape(-1)
    phi = np.mod(np.ascontiguousarray(phi).reshape(-1), 2.0 * np.pi)
    npix = nside2npix(nside)
    z = np.cos(theta)
    ir1 = _ring_above(nside, z)
    ir2 = ir1 + 1
    # clip ring ids into the valid range for geometry lookup; the pole
    # branches below overwrite the out-of-range entries
    nr1, sp1, z1, sh1 = _ring_info(nside, np.clip(ir1, 1, 4 * nside - 1))
    nr2, sp2, z2, sh2 = _ring_info(nside, np.clip(ir2, 1, 4 * nside - 1))
    theta1 = np.arccos(np.clip(z1, -1.0, 1.0))
    theta2 = np.arccos(np.clip(z2, -1.0, 1.0))

    def ring_phi_interp(nr, sp, shift):
        tmp = phi * nr / (2.0 * np.pi) - shift
        i1 = np.floor(tmp).astype(np.int64)
        w = tmp - i1
        pa = sp + np.mod(i1, nr)
        pb = sp + np.mod(i1 + 1, nr)
        return pa, pb, 1.0 - w, w

    p0, p1, w0, w1 = ring_phi_interp(nr1, sp1, sh1)
    p2, p3, w2, w3 = ring_phi_interp(nr2, sp2, sh2)

    # general case: blend linearly in theta between the rings
    denom = np.where(theta2 > theta1, theta2 - theta1, 1.0)
    wt = np.clip((theta - theta1) / denom, 0.0, 1.0)
    wgt = np.stack([w0 * (1 - wt), w1 * (1 - wt), w2 * wt, w3 * wt])
    pix = np.stack([p0, p1, p2, p3])

    # north of the first ring: upper pair -> opposite side of ring 1
    north = ir1 == 0
    if np.any(north):
        wtn = theta[north] / theta2[north]
        fac = (1.0 - wtn) * 0.25
        wgt[0, north] = fac
        wgt[1, north] = fac
        wgt[2, north] = w2[north] * wtn + fac
        wgt[3, north] = w3[north] * wtn + fac
        # first ring has nr=4, startpix=0
        pix[0, north] = (pix[2, north] + 2) % 4
        pix[1, north] = (pix[3, north] + 2) % 4

    # south of the last ring: lower pair -> opposite side of last ring
    south = ir2 == 4 * nside
    if np.any(south):
        wts = ((theta[south] - theta1[south])
               / np.where(np.pi > theta1[south],
                          np.pi - theta1[south], 1.0))
        fac = wts * 0.25
        wgt[0, south] = w0[south] * (1 - wts) + fac
        wgt[1, south] = w1[south] * (1 - wts) + fac
        wgt[2, south] = fac
        wgt[3, south] = fac
        # last ring has nr=4, startpix=npix-4 (npix-4 is a multiple of 4)
        pix[2, south] = (pix[0, south] + 2) % 4 + npix - 4
        pix[3, south] = (pix[1, south] + 2) % 4 + npix - 4
    return pix, wgt


def get_interp_val(hpmap, theta, phi):
    """Bilinear 4-neighbor interpolation (healpy.get_interp_val parity)."""
    hpmap = np.asarray(hpmap)
    nside = npix2nside(hpmap.shape[-1])
    pix, wgt = get_interp_weights(nside, theta, phi)
    shape = np.broadcast(np.asarray(theta), np.asarray(phi)).shape
    return np.sum(hpmap[pix] * wgt, axis=0).reshape(shape)


def euler_matrix_zyx(a1_deg, a2_deg, a3_deg):
    """Rotation matrix from Euler angles (degrees), Z-Y-X order:
    R = Rz(a1) @ Ry(a2) @ Rx(a3). The healpy-Rotator-style entry point for
    SkyHealpix.rotate, which takes a healpy-Rotator `rot` tuple."""
    a, b, c = np.deg2rad([a1_deg, a2_deg, a3_deg])
    rz = np.array([[np.cos(a), -np.sin(a), 0.0],
                   [np.sin(a), np.cos(a), 0.0],
                   [0.0, 0.0, 1.0]])
    ry = np.array([[np.cos(b), 0.0, np.sin(b)],
                   [0.0, 1.0, 0.0],
                   [-np.sin(b), 0.0, np.cos(b)]])
    rx = np.array([[1.0, 0.0, 0.0],
                   [0.0, np.cos(c), -np.sin(c)],
                   [0.0, np.sin(c), np.cos(c)]])
    return rz @ ry @ rx


def rotate_map(hpmap, rot_matrix, interp: str = "bilinear"):
    """Rotate a RING map by a 3x3 rotation matrix (an hp.Rotator
    equivalent) with bilinear (default, healpy parity) or nearest-pixel
    resampling."""
    nside = npix2nside(len(hpmap))
    ipix = np.arange(nside2npix(nside))
    theta, phi = pix2ang_ring(nside, ipix)
    vec = ang2vec(theta, phi)
    # sample the ORIGINAL map at the inversely-rotated positions
    vec_src = vec @ np.asarray(rot_matrix)  # == R^T applied to rows
    ts, ps = vec2ang(vec_src)
    if interp == "nearest":
        return np.asarray(hpmap)[ang2pix_ring(nside, ts, ps)]
    return get_interp_val(hpmap, ts, ps)
