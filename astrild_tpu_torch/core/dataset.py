"""Minimal labeled N-d dataset (xarray.Dataset stand-in) with HDF5 persistence.

numpy copy of astrild_tpu/core/dataset.py (the JAX package's `core`
imports JAX); the two packages read each other's files. h5py is imported
inside the functions that need it.

The original astrild writes its cross-simulation results as xarray
Datasets to netCDF; this container keeps the same mental model without
xarray or netCDF4 — named data variables over named dimensions with
coordinate arrays — persisted via h5py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["Dataset"]


@dataclasses.dataclass
class Dataset:
    """data_vars: name -> (dims, values); coords: name -> values (1D) or
    (dims, values) for multi-dim coordinates."""

    data_vars: Dict[str, Tuple[Tuple[str, ...], np.ndarray]]
    coords: Dict[str, object] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name):
        if name in self.data_vars:
            return self.data_vars[name][1]
        c = self.coords[name]
        return c[1] if isinstance(c, tuple) else c

    def dims_of(self, name) -> Tuple[str, ...]:
        return self.data_vars[name][0]

    def to_hdf5(self, path, mode: str = "w"):
        import h5py

        with h5py.File(path, mode) as f:
            gv = f.create_group("data_vars")
            for name, (dims, vals) in self.data_vars.items():
                d = gv.create_dataset(name, data=np.asarray(vals))
                d.attrs["dims"] = ",".join(dims)
            gc = f.create_group("coords")
            for name, c in self.coords.items():
                if isinstance(c, tuple):
                    dims, vals = c
                else:
                    dims, vals = (name,), c
                vals = np.asarray(vals)
                if vals.dtype.kind in "UO":
                    vals = vals.astype("S")
                d = gc.create_dataset(name, data=vals)
                d.attrs["dims"] = ",".join(dims)
            for k, v in self.attrs.items():
                f.attrs[k] = v

    @classmethod
    def from_hdf5(cls, path) -> "Dataset":
        import h5py

        data_vars, coords, attrs = {}, {}, {}
        with h5py.File(path, "r") as f:
            for name, d in f["data_vars"].items():
                dims = tuple(d.attrs["dims"].split(","))
                data_vars[name] = (dims, np.asarray(d))
            for name, d in f["coords"].items():
                dims = tuple(d.attrs["dims"].split(","))
                vals = np.asarray(d)
                if vals.dtype.kind == "S":
                    vals = vals.astype(str)
                coords[name] = vals if dims == (name,) else (dims, vals)
            attrs = dict(f.attrs.items())
        return cls(data_vars, coords, attrs)
