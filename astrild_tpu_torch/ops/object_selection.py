"""Object selection utilities: size categories, minimal voids, edge trims.

numpy copy of astrild_tpu/ops/object_selection.py (column dicts in and
out, on the host; scipy's cKDTree counts the tracers of `minimal_voids`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["categorize_sizes", "minimal_voids",
           "trim_objects_crossing_edge"]


def categorize_sizes(objects: Dict[str, np.ndarray], binning_method: str,
                     nr_size_cats: int, min_obj_nr: int
                     ) -> Dict[str, np.ndarray]:
    """Group objects by angular size; drop undersized categories
    (object_selection.py:7-34)."""
    sizes = np.asarray(objects["rad_deg"])
    obj_size = np.log10(sizes) if binning_method == "log" else sizes
    cats = np.linspace(obj_size.min(), obj_size.max(), nr_size_cats)
    size_cat = np.digitize(obj_size, cats, right=True)
    cat_idx, count = np.unique(size_cat, return_counts=True)
    valid_cats = set(cat_idx[count >= min_obj_nr])
    keep = np.array([c in valid_cats for c in size_cat])
    out = {k: np.asarray(v)[keep] for k, v in objects.items()}
    out["size_cat"] = size_cat[keep]
    return out


def minimal_voids(voids: Dict[str, np.ndarray],
                  tracer_pos_pix: np.ndarray, field_width_pix: float
                  ) -> Dict[str, np.ndarray]:
    """Flag voids whose interior tracer density is below the mean
    (DOI 10.1093/mnras/stv1994; object_selection.py:37-78)."""
    from scipy.spatial import cKDTree

    density_tot = len(tracer_pos_pix) / field_width_pix ** 2
    tree = cKDTree(tracer_pos_pix)
    pos = np.stack([voids["x_pix"], voids["y_pix"]], axis=-1)
    rad = np.asarray(voids["rad_pix"])
    counts = np.array([len(tree.query_ball_point(pos[i], rad[i]))
                       for i in range(len(rad))])
    density_voids = counts / (np.pi * rad ** 2)
    out = dict(voids)
    out["minimal"] = density_voids / density_tot < 1
    return out


def trim_objects_crossing_edge(data: Dict[str, np.ndarray], extend: float,
                               npix: int, key_size: str = "rad_pix",
                               pos_keys=("theta1_pix", "theta2_pix"),
                               rtn: str = "dict"):
    """Drop objects whose extend*radius reach crosses the map edge
    (object_selection.py:80-141)."""
    x = np.asarray(data[pos_keys[0]])
    y = np.asarray(data[pos_keys[1]])
    r = extend * np.asarray(data[key_size])
    keep = (x + r < npix) & (x - r > 0) & (y + r < npix) & (y - r > 0)
    if rtn == "bool":
        return keep
    if rtn == "index":
        return np.where(keep)[0]
    return {k: np.asarray(v)[keep] for k, v in data.items()}
