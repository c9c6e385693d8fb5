"""Ray-Ramses lightcone output handling: per-CPU merge and map assembly.

numpy copy of astrild_tpu/io/rays.py: per-CPU ASCII ray outputs are
concatenated (`merge_ray_outputs`, what `RayRamses.compress_snapshot`
reads), and ray samples are sorted by ray id, unit-corrected and reshaped
row-major to the (npix, npix) sky map (`rays_to_map`, what
`SkyArray.from_columns` needs).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..ops.lensing import code_to_phy_units_factor

__all__ = ["merge_ray_outputs", "rays_to_map", "SHEAR_CORRECTIONS"]

# Ray-Ramses wrote shear with swapped/negated components in some versions;
# the reference fixes them at compress time.
SHEAR_CORRECTIONS = {"shear_x": -1.0, "shear_y": -1.0}


def merge_ray_outputs(paths: Sequence[str], column_names: Sequence[str],
                      skiprows: int = 1) -> Dict[str, np.ndarray]:
    """Concatenate per-CPU ascii ray files into one column dict."""
    chunks = [np.loadtxt(p, skiprows=skiprows, ndmin=2) for p in paths]
    data = np.concatenate([c for c in chunks if c.size], axis=0)
    return {n: data[:, i] for i, n in enumerate(column_names)}


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
