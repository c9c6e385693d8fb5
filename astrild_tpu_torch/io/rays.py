"""Ray-Ramses lightcone output: map assembly from ray columns.

numpy copy of `rays_to_map` and `SHEAR_CORRECTIONS` of
astrild_tpu/io/rays.py (what `SkyArray.from_columns` needs): ray samples
sorted by ray id, unit-corrected, and reshaped row-major to the (npix,
npix) sky map. The per-CPU ASCII merge (`merge_ray_outputs`) is not ported
yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.lensing import code_to_phy_units_factor

__all__ = ["rays_to_map", "SHEAR_CORRECTIONS"]

# Ray-Ramses wrote shear with swapped/negated components in some versions;
# the reference fixes them at compress time.
SHEAR_CORRECTIONS = {"shear_x": -1.0, "shear_y": -1.0}


def rays_to_map(values: np.ndarray, ray_ids: Optional[np.ndarray] = None,
                quantity: Optional[str] = None,
                convert_units: bool = True) -> np.ndarray:
    """Ray samples -> (npix, npix) map, sorted by ray id, row-major fill.

    values length must be a perfect square. With `quantity` given, the
    RayRamses code->physical factor (1/c^2, 1/c^3) is applied.
    """
    values = np.asarray(values, np.float64)
    if ray_ids is not None:
        values = values[np.argsort(np.asarray(ray_ids))]
    npix = int(round(np.sqrt(values.size)))
    if npix * npix != values.size:
        raise ValueError(f"ray count {values.size} is not a square")
    out = values.reshape(npix, npix)
    if convert_units and quantity is not None:
        out = out * code_to_phy_units_factor(quantity)
        out = out * SHEAR_CORRECTIONS.get(quantity, 1.0)
    return out
