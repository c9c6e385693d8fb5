"""Simple columnar HDF5 tables (pandas.to_hdf stand-in on h5py).

numpy copy of astrild_tpu/io/columnar_h5.py; the two packages read each
other's tables. h5py is imported inside the functions that need it.

The reference moves DataFrames between pipeline stages via pd.to_hdf /
read_hdf, which need pytables; this package does not. Artifacts are written as a
flat 'columns/<name>' layout; `read_table` transparently reads BOTH this
layout and pandas fixed-format stores (via io.pandas_hdf5), so archived
reference artifacts remain readable.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .pandas_hdf5 import read_pandas_fixed_hdf_as_dict

__all__ = ["write_table", "read_table"]


def write_table(path, columns: Dict[str, np.ndarray], key: str = "df",
                mode: str = "w", attrs=None):
    import h5py

    with h5py.File(path, mode) as f:
        if key in f:
            del f[key]
        g = f.create_group(key)
        gc = g.create_group("columns")
        for name, vals in columns.items():
            vals = np.asarray(vals)
            if vals.dtype.kind in "UO":
                vals = vals.astype("S")
            gc[name] = vals
        for k, v in (attrs or {}).items():
            g.attrs[k] = v


def read_table(path, key: str = "df") -> Dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        g = f[key]
        if "columns" in g:
            out = {}
            for name, d in g["columns"].items():
                vals = np.asarray(d)
                if vals.dtype.kind == "S":
                    vals = vals.astype(str)
                out[name] = vals
            return out
    # fall back to pandas fixed format
    return read_pandas_fixed_hdf_as_dict(path, key)
