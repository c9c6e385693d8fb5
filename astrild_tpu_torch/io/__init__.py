"""Snapshot and table I/O of the port: numpy copies of the backend-neutral
readers and writers of astrild_tpu/io (which cannot be imported without
JAX). h5py is imported only inside the functions that read or write HDF5,
so this package imports without it."""
from . import (columnar_h5, gadget_binary, gadget_hdf5, pandas_hdf5, rays,
               rockstar)
from .gadget_hdf5 import GadgetSnapshot
from .pandas_hdf5 import read_pandas_fixed_hdf, read_pandas_fixed_hdf_as_dict

__all__ = [
    "columnar_h5", "gadget_binary", "gadget_hdf5", "pandas_hdf5", "rays",
    "rockstar",
    "GadgetSnapshot", "read_pandas_fixed_hdf",
    "read_pandas_fixed_hdf_as_dict",
]
