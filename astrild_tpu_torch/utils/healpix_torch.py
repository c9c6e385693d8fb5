"""HEALPix (RING scheme) on tensors: ang2pix.

Port of `ang2pix_ring` of astrild_tpu/utils/healpix_jax.py: the formulas of
utils/healpix.py (Gorski et al. 2005), branch-free with `where`, in
float32 and int32, so that shell painting (ops/lightcone_sphere.py) stays
on the positions' device. Points within ~1e-6 of a pixel boundary can land
in the neighbouring pixel of the float64 host routine (and of the JAX
function, whose `cos` and `atan2` differ by an ulp); the tests hold the
share of equal pixels. int32 arithmetic: nside <= 4096 (largest
intermediate 2 (4 nside - 1)^2 < 2^31).

Not ported yet: `pix2ang_ring`, `get_interp_weights`, `get_interp_val`,
`remap_by_deflection` (with the SHT stack).
"""
from __future__ import annotations

import math

import torch

from . import healpix as hpx

__all__ = ["ang2pix_ring"]

_TWO_PI = 6.283185307179586
_MAX_NSIDE = 4096


def ang2pix_ring(nside: int, theta, phi) -> torch.Tensor:
    """(theta, phi) [rad] -> RING pixel index (int32), on the tensors'
    device."""
    if not 1 <= nside <= _MAX_NSIDE:
        raise ValueError(f"ang2pix_ring: nside={nside} outside "
                         f"[1, {_MAX_NSIDE}] (int32 pixel arithmetic)")
    theta = torch.as_tensor(theta).to(torch.float32)
    phi = torch.as_tensor(phi).to(torch.float32)
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
