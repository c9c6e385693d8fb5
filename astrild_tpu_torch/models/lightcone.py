"""Halo lightcone catalogs: box -> lightcone with LOS/transverse velocity
decomposition.

Port of astrild_tpu/models/lightcone.py (host numpy float64, on the port's
`utils/geometry`): halos are translated into lightcone coordinates,
selected by the snapshot's comoving shell and the field of view, and their
velocities split into LOS and transverse components (the transverse part
feeds the moving-lens dipole pipeline).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.geometry import (angular_coordinate_in_lc,
                              radial_coordinate_in_lc,
                              transform_box_to_lc_cart_coords)

__all__ = ["halo_lightcone_catalog", "merge_lightcone_catalogs",
           "degree_to_pixel"]


def degree_to_pixel(deg, opening_angle: float, npix: int):
    return np.rint(np.asarray(deg) * npix / opening_angle).astype(int)


def halo_lightcone_catalog(
    pos_box: np.ndarray, vel: np.ndarray, m200: np.ndarray,
    r200: np.ndarray, boxsize: float, boxdist: float,
    snaplimit: Tuple[float, float], opening_angle: float, npix: int,
    box_nr: int = 0, snap_nr: int = 0, ray_nr: int = 0,
    extra_columns: Optional[Dict[str, np.ndarray]] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """One snapshot's halos -> lightcone catalog columns.

    Args:
      pos_box: (n, 3) halo positions in box coordinates [Mpc/h].
      vel: (n, 3) velocities [km/s].
      m200, r200: masses [Msun/h] and radii [Mpc/h].
      boxdist: comoving distance of the box's near face [Mpc/h].
      snaplimit: (chi_near, chi_far) shell owned by this snapshot.
      opening_angle: FOV [deg]; npix: map resolution.

    Returns the catalog columns, or None when no halo lands in the shell.
    """
    # host numpy float64 throughout: at chi ~ 2000-3000 Mpc/h float32
    # positions carry ~0.1 Mpc/h quantization
    pos = np.asarray(transform_box_to_lc_cart_coords(
        np.asarray(pos_box, np.float64), boxsize, boxdist))
    rad = np.asarray(radial_coordinate_in_lc(pos))
    t1, t2 = angular_coordinate_in_lc(pos, unit="deg")
    t1 = np.asarray(t1)
    t2 = np.asarray(t2)
    sel = ((rad >= min(snaplimit)) & (rad <= max(snaplimit))
           & (np.abs(t1) <= opening_angle / 2)
           & (np.abs(t2) <= opening_angle / 2))
    idx = np.where(sel)[0]
    if len(idx) == 0:
        return None
    pos = pos[idx]
    vel = np.asarray(vel)[idx]
    rad_i = rad[idx]
    # LOS / transverse velocity split (small-angle)
    pos_norm2 = np.sum(pos ** 2, axis=1)
    vr = (np.sum(vel * pos, axis=1) / pos_norm2)[:, None] * pos
    vt = vel - vr
    r200_deg = np.arctan(np.asarray(r200)[idx] / rad_i) * 180.0 / np.pi
    out = {
        "id": np.array([int(f"{box_nr}{snap_nr}{i}") for i in idx]),
        "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
        "rad_dist": rad_i,
        "theta1_deg": t1[idx] + opening_angle / 2,
        "theta1_pix": degree_to_pixel(t1[idx] + opening_angle / 2,
                                      opening_angle, npix),
        "theta2_deg": t2[idx] + opening_angle / 2,
        "theta2_pix": degree_to_pixel(t2[idx] + opening_angle / 2,
                                      opening_angle, npix),
        "x_vel": vel[:, 0], "y_vel": vel[:, 1], "z_vel": vel[:, 2],
        "theta1_tv": vt[:, 0], "theta2_tv": vt[:, 1],
        "m200": np.asarray(m200)[idx],
        "r200_deg": r200_deg,
        "r200_pix": degree_to_pixel(r200_deg, opening_angle, npix),
        "ray_nr": np.full(len(idx), ray_nr + 1),
        "snap_nr": np.full(len(idx), snap_nr),
    }
    for k, v in (extra_columns or {}).items():
        out[k] = np.asarray(v)[idx]
    return out


def merge_lightcone_catalogs(parts: Sequence[Optional[Dict[str, np.ndarray]]]
                             ) -> Dict[str, np.ndarray]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return {}
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
