"""Geometrical transforms (spherical/flat-sky/lightcone) on tensors.

Port of astrild_tpu/utils/geometry.py. The unit conversions are plain
arithmetic and take numbers, numpy arrays or tensors alike. The jacobians
and vector rotations compute in torch: a tensor keeps its device, other
input goes to `device`, by default the CUDA card (`_device.as_tensor`: it
raises without one; pass device="cpu"). The three lightcone transforms
keep the array namespace of their input, as the JAX package's `_xp` does:
numpy in, numpy out at the input dtype (the box -> lightcone transform runs
on the host in float64), a tensor in, a tensor out on its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from .constants import ARCMIN2RAD, RAD2ARCMIN

__all__ = [
    "ell_to_arcmin", "arcmin_to_ell", "arcmin_to_deg", "deg_to_arcmin",
    "rad_to_arcmin", "arcmin_to_rad", "Dc_to_Da", "radius_to_angsize",
    "cart_to_sph_jacobian", "sph_to_cart_jacobian",
    "convert_vec_sph_to_cart", "convert_vec_cart_to_sph",
    "transform_box_to_lc_cart_coords", "radial_coordinate_in_lc",
    "angular_coordinate_in_lc", "ra_dec_dist_coordinates",
]


# ------------------------------------------------------------- angular units
def ell_to_arcmin(ell):
    """Multipole -> angular scale [arcmin]: theta = pi/ell."""
    return math.pi / ell * 180.0 / math.pi * 60.0


def arcmin_to_ell(arcmin):
    """Angular scale [arcmin] -> multipole."""
    return math.pi / arcmin * 180.0 / math.pi * 60.0


def arcmin_to_deg(arcmin):
    return arcmin / 60.0


def deg_to_arcmin(deg):
    return deg * 60.0


def rad_to_arcmin(angle):
    return angle * RAD2ARCMIN


def arcmin_to_rad(angle):
    return angle * ARCMIN2RAD


# ---------------------------------------------------------------- distances
def Dc_to_Da(Dc, redshift):
    """Comoving -> angular-diameter distance."""
    return Dc / (1.0 + redshift)


def radius_to_angsize(radius, Da, arcmin: bool = True):
    """Angular size of an object of physical `radius` at distance `Da`.

    radius and Da must share units; returns arcmin if `arcmin` else rad.
    """
    ang = radius / Da
    return ang * RAD2ARCMIN if arcmin else ang


# ---------------------------------------------------- spherical <-> cartesian
def _angles(th, ph, device):
    th = th if isinstance(th, torch.Tensor) else as_tensor(th, device)
    ph = ph if isinstance(ph, torch.Tensor) else as_tensor(ph, th.device)
    return th, ph


def cart_to_sph_jacobian(th, ph, device=None):
    """J such that v_sph = einsum('ij...,i...->j...', J, v_cart).

    th: polar angle from z-axis, ph: azimuth from x-axis (radians).
    Matches reference get_cart_to_sph_jacobian row layout.
    """
    th, ph = _angles(th, ph, device)
    zero = torch.zeros_like(th)
    row1 = torch.stack((torch.sin(th) * torch.cos(ph),
                        torch.cos(th) * torch.cos(ph), -torch.sin(ph)))
    row2 = torch.stack((torch.sin(th) * torch.sin(ph),
                        torch.cos(th) * torch.sin(ph), torch.cos(ph)))
    row3 = torch.stack((torch.cos(th), -torch.sin(th), zero))
    return torch.squeeze(torch.stack((row1, row2, row3)))


def sph_to_cart_jacobian(th, ph, device=None):
    """J such that v_cart = einsum('ij...,i...->j...', J, v_sph)."""
    th, ph = _angles(th, ph, device)
    zero = torch.zeros_like(th)
    row1 = torch.stack((torch.sin(th) * torch.cos(ph),
                        torch.sin(th) * torch.sin(ph), torch.cos(th)))
    row2 = torch.stack((torch.cos(th) * torch.cos(ph),
                        torch.cos(th) * torch.sin(ph), -torch.sin(th)))
    row3 = torch.stack((-torch.sin(ph), torch.cos(ph), zero))
    return torch.squeeze(torch.stack((row1, row2, row3)))


def _rotate(jac, vij):
    vij = vij if isinstance(vij, torch.Tensor) else as_tensor(vij,
                                                              jac.device)
    return torch.einsum("ij...,i...->j...", jac, vij.T).T


def convert_vec_sph_to_cart(th, ph, vij_sph, device=None):
    """[v_r, v_th, v_ph] -> [v_x, v_y, v_z], batched over trailing axes."""
    return _rotate(sph_to_cart_jacobian(th, ph, device), vij_sph)


def convert_vec_cart_to_sph(th, ph, vij_cart, device=None):
    """[v_x, v_y, v_z] -> [v_r, v_th, v_ph], batched over trailing axes."""
    return _rotate(cart_to_sph_jacobian(th, ph, device), vij_cart)


# ------------------------------------------------------------------ lightcone
def transform_box_to_lc_cart_coords(pos, boxsize, boxdist):
    """Box coords -> lightcone cartesian coords (observer at origin)."""
    shift = [-boxsize / 2.0, -boxsize / 2.0, boxdist]
    if isinstance(pos, torch.Tensor):
        return pos + torch.tensor(shift, dtype=pos.dtype, device=pos.device)
    pos = np.asarray(pos)
    return pos + np.asarray(shift, dtype=pos.dtype)


def radial_coordinate_in_lc(pos):
    if isinstance(pos, torch.Tensor):
        return torch.sqrt(torch.sum(pos ** 2, dim=-1))
    return np.sqrt(np.sum(np.asarray(pos) ** 2, axis=-1))


def angular_coordinate_in_lc(pos, unit: str = "deg"):
    """Flat-sky angles w.r.t. the z-axis."""
    xp = torch if isinstance(pos, torch.Tensor) else np
    pos = pos if xp is torch else np.asarray(pos)
    theta1 = xp.arctan(pos[:, 0] / pos[:, 2])
    theta2 = xp.arctan(pos[:, 1] / pos[:, 2])
    if unit == "deg":
        theta1 = theta1 * 180.0 / math.pi
        theta2 = theta2 * 180.0 / math.pi
    return theta1, theta2


def ra_dec_dist_coordinates(pos, unit: str = "deg"):
    """(ra, dec, dist) spherical coordinates of cartesian positions.

    The reference's conventions (return_raDecDist_coordinates,
    rays/voids/tunnels/miscellaneous.py:158-175): dec = 90 deg - polar
    angle, ra = atan2 shifted into [0, 2pi) by a +pi offset. unit is
    'deg'/'degree' or 'rad'/'radian' for the returned angles.

    Returns (ra, dec, dist).
    """
    xp = torch if isinstance(pos, torch.Tensor) else np
    pos = pos if xp is torch else np.asarray(pos)
    dist = xp.sqrt(xp.sum(pos ** 2, -1))
    costh = pos[..., 2] / dist
    dec = math.pi / 2.0 - xp.arccos(costh)
    ra = math.pi + xp.arctan2(pos[..., 1], pos[..., 0])
    if unit in ("deg", "degree"):
        ra = ra * 180.0 / math.pi
        dec = dec * 180.0 / math.pi
    elif unit not in ("rad", "radian"):
        raise ValueError(f"unit must be 'deg'/'degree' or 'rad'/'radian', "
                         f"got {unit!r}")
    return ra, dec, dist
