"""Snapshot and table I/O of the port: numpy copies of the backend-neutral
readers and writers of astrild_tpu/io (which cannot be imported without
JAX). h5py is imported only inside the functions that read or write HDF5,
so this package imports without it."""
from . import (binary_formats, columnar_h5, gadget_binary, gadget_hdf5,
               mmf, pandas_hdf5, ramses, rays, rockstar, save)
from .binary_formats import (read_density, read_halo_catalog, read_text_table,
                             write_density, write_halo_catalog,
                             write_text_table, write_text_table_gnuplot3d)
from .gadget_hdf5 import GadgetSnapshot
from .pandas_hdf5 import read_pandas_fixed_hdf, read_pandas_fixed_hdf_as_dict

__all__ = [
    "binary_formats", "columnar_h5", "gadget_binary", "gadget_hdf5", "mmf",
    "pandas_hdf5", "ramses", "rays", "rockstar", "save", "read_density",
    "write_density", "read_halo_catalog", "write_halo_catalog",
    "read_text_table", "write_text_table",
    "write_text_table_gnuplot3d", "GadgetSnapshot",
    "read_pandas_fixed_hdf", "read_pandas_fixed_hdf_as_dict",
]
