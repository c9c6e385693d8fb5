"""Minimal HEALPix (RING scheme) on the host: pixel counts, ang2pix and
pix2ang.

Numpy copy of `nside2npix`, `npix2nside`, `ang2pix_ring` and
`pix2ang_ring` of astrild_tpu/utils/healpix.py (Gorski et al. 2005), kept
bit-identical with the original (the tests hold it to that). The vector,
rotation and interpolation helpers of that file are not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nside2npix", "npix2nside", "ang2pix_ring", "pix2ang_ring"]


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
