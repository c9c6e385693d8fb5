"""HEALPix (RING scheme) on tensors: ang2pix, pix2ang and the 4-neighbour
bilinear stencil.

Port of astrild_tpu/utils/healpix_jax.py: the formulas of utils/healpix.py
(Gorski et al. 2005), branch-free with `where`, in float32 and int32, so
that shell painting (ops/lightcone_sphere.py), the deflection remap of a
CMB map and the spherical ray trace stay on their tensors' device. Points
within ~1e-6 of a pixel or stencil boundary can land in the neighbouring
pixel of the float64 host routine (and of the JAX function, whose `cos`,
`arccos` and `atan2` differ by an ulp); the tests hold the share of equal
pixels. A division by a constant is a product by its float32 reciprocal,
as XLA compiles the JAX function. int32 arithmetic: nside <= 4096
(largest intermediate 2 (4 nside - 1)^2 < 2^31).

Numpy input goes to `device`, by default the CUDA card (it raises without
one: pass device="cpu"); tensors keep their device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from . import healpix as hpx

__all__ = ["ang2pix_ring", "pix2ang_ring", "get_interp_weights",
           "get_interp_val", "remap_by_deflection"]

_TWO_PI = 6.283185307179586
_MAX_NSIDE = 4096


def _check_nside(nside: int, what: str) -> None:
    if not 1 <= nside <= _MAX_NSIDE:
        raise ValueError(f"{what}: nside={nside} outside "
                         f"[1, {_MAX_NSIDE}] (int32 pixel arithmetic)")


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant, as XLA folds x / c."""
    return float(np.float32(1.0) / np.float32(c))


def _cos64(x):
    """cos in float64, rounded to float32: a bin decision that hangs on it
    follows XLA's float32 cos more often than torch's float32 cos does."""
    return torch.cos(x.double()).to(torch.float32)


def _sin64(x):
    return torch.sin(x.double()).to(torch.float32)


def _arccos(z):
    """arccos as XLA lowers it: atan2(sqrt((1 - z)(1 + z)), z)."""
    return torch.atan2(torch.sqrt((1.0 - z) * (1.0 + z)), z)


def _angles(theta, phi, device):
    """(theta, phi) as float32 tensors: numpy on `device`, phi following
    theta's device."""
    theta = as_tensor(theta, device).to(torch.float32)
    return theta, as_tensor(phi, theta.device).to(torch.float32)


def ang2pix_ring(nside: int, theta, phi, device=None) -> torch.Tensor:
    """(theta, phi) [rad] -> RING pixel index (int32), on the tensors'
    device."""
    _check_nside(nside, "ang2pix_ring")
    theta, phi = _angles(theta, phi, device)
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi, _TWO_PI) * (2.0 / math.pi)  # in [0, 4)
    npix = hpx.nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    # --- equatorial belt (|z| <= 2/3) ---
    temp1 = nside * (0.5 + tt)
    temp2 = nside * 0.75 * z
    jp_e = torch.floor(temp1 - temp2).to(torch.int32)
    jm_e = torch.floor(temp1 + temp2).to(torch.int32)
    ir_e = nside + 1 + jp_e - jm_e
    kshift = 1 - (ir_e & 1)
    ip_e = ((jp_e + jm_e - nside + kshift + 1) // 2) % (4 * nside)
    pix_eq = ncap + (ir_e - 1) * 4 * nside + ip_e

    # --- polar caps ---
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(3.0 * torch.clamp_min(1.0 - za, 0.0))
    jp_p = torch.floor(tp * tmp).to(torch.int32)
    jm_p = torch.floor((1.0 - tp) * tmp).to(torch.int32)
    ir_p = jp_p + jm_p + 1
    ip_p = torch.floor(tt * ir_p.to(torch.float32)).to(torch.int32) \
        % (4 * ir_p)
    pix_n = 2 * ir_p * (ir_p - 1) + ip_p
    pix_s = npix - 2 * ir_p * (ir_p + 1) + ip_p
    pix_po = torch.where(z > 0, pix_n, pix_s)

    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_po)


def _ring_info(nside: int, iring):
    """Per-ring (size, first pixel, z, phi shift) of int32 ring indices in
    [1, 4 nside - 1]."""
    npix = hpx.nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    north = iring < nside
    south = iring > 3 * nside
    i_s = 4 * nside - iring
    nr = torch.where(north, 4 * iring,
                     torch.where(south, 4 * i_s, 4 * nside))
    startpix = torch.where(
        north, 2 * iring * (iring - 1),
        torch.where(south, npix - 2 * i_s * (i_s + 1),
                    ncap + (iring - nside) * 4 * nside))
    fring = iring.to(torch.float32)
    fi_s = i_s.to(torch.float32)
    inv3n2 = _recip(3.0 * nside ** 2)
    z = torch.where(
        north, 1.0 - fring ** 2 * inv3n2,
        torch.where(south, -1.0 + fi_s ** 2 * inv3n2,
                    (2.0 * nside - fring) * (2.0 / (3.0 * nside))))
    shift = torch.where(north | south, 0.5,
                        torch.where((iring + nside) % 2 == 0, 0.5, 0.0))
    return nr, startpix, z, shift


def _ring_above(nside: int, z):
    """Largest ring index with z_ring > z."""
    az = torch.abs(z)
    ir_cap = torch.floor(nside * torch.sqrt(
        3.0 * torch.clamp_min(1.0 - az, 0.0))).to(torch.int32)
    ir_eq = torch.floor(nside * (2.0 - 1.5 * z)).to(torch.int32)
    return torch.where(az > 2.0 / 3.0,
                       torch.where(z > 0, ir_cap, 4 * nside - ir_cap - 1),
                       ir_eq)


def _cap_ring(p):
    """Exact ring index within a polar cap: the largest r with
    2r(r-1) <= p; a float32 seed (off by at most one) and two int32
    fix-ups, so no boundary pixel is misassigned at any nside <= 8192."""
    pf = p.to(torch.float32)
    r = torch.floor((1.0 + torch.sqrt(1.0 + 2.0 * pf)) * 0.5).to(
        torch.int32)
    r = torch.clamp_min(r, 1)
    r = torch.where(2 * r * (r - 1) > p, r - 1, r)
    return torch.where(2 * r * (r + 1) <= p, r + 1, r)


def pix2ang_ring(nside: int, ipix, device=None):
    """RING pixel index -> centre (theta, phi) [rad], float32 tensors on
    the indices' device: the closed-form ring of each pixel (exact integer
    arithmetic on the belt, the fixed-up float32 seed in the caps)."""
    _check_nside(nside, "pix2ang_ring")
    ipix = as_tensor(ipix, device).to(torch.int32)
    npix = hpx.nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    north = ipix < ncap
    south = ipix >= npix - ncap
    r_n = _cap_ring(ipix)
    r_s = _cap_ring(npix - 1 - ipix)  # the mirror index in the south cap
    iring = torch.where(
        north, r_n,
        torch.where(south, 4 * nside - r_s,
                    nside + torch.div(ipix - ncap, 4 * nside,
                                      rounding_mode="floor")))
    nr, sp, z, shift = _ring_info(nside, iring)
    theta = _arccos(torch.clamp(z, -1.0, 1.0))
    j = (ipix - sp).to(torch.float32)
    # a tensor divided by a tensor: torch takes c / t as c * (1 / t)
    phi = (j + shift) * (z.new_tensor(_TWO_PI) / nr.to(torch.float32))
    return theta, phi


def _ring_phi_interp(phi, nr, sp, shift):
    """The two pixels of a ring around phi and their weights."""
    tmp = phi * (nr.to(torch.float32) * _recip(_TWO_PI)) - shift
    i1 = torch.floor(tmp).to(torch.int32)
    w = tmp - i1.to(torch.float32)
    pa = sp + torch.remainder(i1, nr)
    pb = sp + torch.remainder(i1 + 1, nr)
    return pa, pb, 1.0 - w, w


def get_interp_weights(nside: int, theta, phi, device=None):
    """4-neighbour bilinear stencil: (pix (4, N) int32, wgt (4, N)
    float32), the ring blend with the north and south polar fallbacks
    (healpy's `get_interp_weights`)."""
    _check_nside(nside, "get_interp_weights")
    theta, phi = _angles(theta, phi, device)
    theta = theta.reshape(-1)
    phi = torch.remainder(phi.reshape(-1), _TWO_PI)
    npix = hpx.nside2npix(nside)
    z = _cos64(theta)
    ir1 = _ring_above(nside, z)
    ir2 = ir1 + 1
    nr1, sp1, z1, sh1 = _ring_info(nside, torch.clamp(ir1, 1, 4 * nside - 1))
    nr2, sp2, z2, sh2 = _ring_info(nside, torch.clamp(ir2, 1, 4 * nside - 1))
    theta1 = _arccos(torch.clamp(z1, -1.0, 1.0))
    theta2 = _arccos(torch.clamp(z2, -1.0, 1.0))
    p0, p1, w0, w1 = _ring_phi_interp(phi, nr1, sp1, sh1)
    p2, p3, w2, w3 = _ring_phi_interp(phi, nr2, sp2, sh2)

    # general case: a linear blend in theta between the two rings
    denom = torch.where(theta2 > theta1, theta2 - theta1, 1.0)
    wt = torch.clamp((theta - theta1) / denom, 0.0, 1.0)
    wgt = torch.stack([w0 * (1 - wt), w1 * (1 - wt), w2 * wt, w3 * wt])
    pix = torch.stack([p0, p1, p2, p3])

    # north of ring 1: the upper pair goes to the opposite side of ring 1
    north = ir1 == 0
    wtn = theta / torch.where(theta2 > 0, theta2, 1.0)
    facn = (1.0 - wtn) * 0.25
    wgt = torch.where(north, torch.stack([facn, facn, w2 * wtn + facn,
                                          w3 * wtn + facn]), wgt)
    pix = torch.where(north, torch.stack([(pix[2] + 2) % 4,
                                          (pix[3] + 2) % 4, pix[2], pix[3]]),
                      pix)

    # south of the last ring: the lower pair to the opposite side of it
    south = ir2 == 4 * nside
    wts = ((theta - theta1)
           / torch.where(math.pi > theta1, math.pi - theta1, 1.0))
    facs = wts * 0.25
    wgt = torch.where(south, torch.stack([w0 * (1 - wts) + facs,
                                          w1 * (1 - wts) + facs, facs,
                                          facs]), wgt)
    pix = torch.where(south, torch.stack(
        [pix[0], pix[1], (pix[0] + 2) % 4 + npix - 4,
         (pix[1] + 2) % 4 + npix - 4]), pix)
    return pix, wgt


def _interp_apply(hpmap, pix, wgt):
    """sum_k hpmap[pix[k]] wgt[k] over the stencil's four rows."""
    vals = hpmap[pix.reshape(-1).long()].reshape(pix.shape)
    return (vals * wgt).sum(0)


def get_interp_val(hpmap, theta, phi, device=None):
    """Bilinear interpolation of a RING map at (theta, phi), on the map's
    device (healpy's `get_interp_val`)."""
    hpmap = as_tensor(hpmap, device).to(torch.float32)
    nside = hpx.npix2nside(hpmap.shape[-1])
    pix, wgt = get_interp_weights(nside, theta, phi, device=hpmap.device)
    return _interp_apply(hpmap, pix, wgt)


def remap_by_deflection(hpmap, alpha_theta, alpha_phi, nside: int,
                        device=None):
    """Sample `hpmap` at the deflected positions of every pixel centre:
    theta_s = theta + alpha_theta, phi_s = phi + alpha_phi / sin(theta)
    (with sin(theta) floored at 1e-6), on the map's device.

    Every source position carries a 1e-3-pixel nudge (+0.5 nudge in theta,
    +nudge in phi, nudge = 1e-3 * 2 pi / (4 nside)), as in the JAX
    package: a zero deflection puts the sample points exactly on pixel
    centres, half of which sit on a phi-stencil boundary. It moves a
    sampled value by about 1e-3 of the local pixel-to-pixel difference.
    """
    hpmap = as_tensor(hpmap, device).to(torch.float32)
    dev = hpmap.device
    npix = hpx.nside2npix(nside)
    theta, phi = pix2ang_ring(
        nside, torch.arange(npix, dtype=torch.int32, device=dev))
    a_t = as_tensor(alpha_theta, dev).to(torch.float32)
    a_p = as_tensor(alpha_phi, dev).to(torch.float32)
    nudge = 1.0e-3 * (_TWO_PI / (4.0 * nside))
    ts = torch.clamp(theta + a_t + 0.5 * nudge, 0.0, math.pi)
    ps = phi + a_p / torch.clamp_min(_sin64(theta), 1e-6) + nudge
    pix, wgt = get_interp_weights(nside, ts, ps)
    return _interp_apply(hpmap, pix, wgt)
