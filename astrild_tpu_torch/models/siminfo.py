"""Snapshot-info table generation (z, a, H(z), lookback time, chi).

Port of astrild_tpu/models/siminfo.py: the per-box / per-snapshot
background tables consumed by a simulation collection
(configs/*_snapshot_info.h5), from any `utils.cosmology.Cosmology`
(float fields: the host float64 tables), including (w0, wa) backgrounds
and modified-gravity growth.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..io import columnar_h5
from ..utils.cosmology import Cosmology

__all__ = ["snapshot_info_table", "write_snapshot_info"]


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def snapshot_info_table(redshifts_per_box: Dict[int, Sequence[float]],
                        cosmo: Optional[Cosmology] = None
                        ) -> Dict[str, np.ndarray]:
    """Build the flat (box, snapshot) -> background-quantities table.

    Returns numpy columns: _index_0 (box), _index_1 (snapshot nr),
    redshift, a, Hz [km/s/(Mpc/h)], lookback_time [Gyr], Dc [Mpc/h].
    """
    cosmo = cosmo or Cosmology()
    box_col, snap_col, z_col = [], [], []
    for box, zs in sorted(redshifts_per_box.items()):
        for snap_nr, z in enumerate(zs, start=1):
            box_col.append(box)
            snap_col.append(snap_nr)
            z_col.append(float(z))
    z = np.asarray(z_col)
    return {
        "_index_0": np.asarray(box_col, np.int64),
        "_index_1": np.asarray(snap_col, np.int64),
        "redshift": z,
        "a": 1.0 / (1.0 + z),
        "Hz": _np(cosmo.H(z)),
        "lookback_time": _np(cosmo.lookback_time(z)),
        "Dc": _np(cosmo.comoving_distance(z)),
    }


def write_snapshot_info(path: str,
                        redshifts_per_box: Dict[int, Sequence[float]],
                        cosmo: Optional[Cosmology] = None,
                        key: str = "df") -> str:
    """Write `snapshot_info_table` as a columnar HDF5 table at `path`."""
    table = snapshot_info_table(redshifts_per_box, cosmo)
    columnar_h5.write_table(path, table, key=key)
    return path
