"""Reader for pandas 'fixed'-format HDF5 files using h5py only.

numpy copy of astrild_tpu/io/pandas_hdf5.py. The reference astrild's
test data and config tables (rockstar_in_lc.h5,
particle/ray_snapshot_info.h5) are pandas fixed-format stores, which need
pytables to read through pandas. This decodes the block layout
(axis0/axis1 + blockN_items / blockN_values) directly; h5py and pandas are
imported inside the functions that need them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["read_pandas_fixed_hdf", "read_pandas_fixed_hdf_as_dict"]


def _decode(arr):
    return [x.decode() if isinstance(x, bytes) else str(x) for x in arr]


def read_pandas_fixed_hdf_as_dict(path, key: str = "df") -> Dict[str, np.ndarray]:
    """Return {column -> values} plus '_index' from a fixed-format store."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        g = f[key]
        if "axis1" in g:
            out["_index"] = np.asarray(g["axis1"][:])
        else:
            # MultiIndex rows: axis1_levelN[axis1_labelN]
            lev = 0
            while f"axis1_level{lev}" in g:
                levels = np.asarray(g[f"axis1_level{lev}"][:])
                labels = np.asarray(g[f"axis1_label{lev}"][:]).astype(np.int64)
                out[f"_index_{lev}"] = levels[labels]
                lev += 1
        nblocks = 0
        while f"block{nblocks}_items" in g:
            nblocks += 1
        for b in range(nblocks):
            items = _decode(g[f"block{b}_items"][:])
            vals = np.asarray(g[f"block{b}_values"][:])
            for i, name in enumerate(items):
                out[name] = vals[:, i] if vals.ndim > 1 else vals
    return out


def read_pandas_fixed_hdf(path, key: str = "df"):
    """Reconstruct the DataFrame (requires pandas, not pytables)."""
    import pandas as pd

    d = read_pandas_fixed_hdf_as_dict(path, key)
    if "_index" in d:
        idx = d.pop("_index")
    else:
        levels = []
        lev = 0
        while f"_index_{lev}" in d:
            levels.append(d.pop(f"_index_{lev}"))
            lev += 1
        idx = pd.MultiIndex.from_arrays(levels) if levels else None
    return pd.DataFrame(d, index=idx)
