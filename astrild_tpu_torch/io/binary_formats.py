"""Binary wire formats of the reference toolchain: DTFE density grids,
Cautun halo catalogs, and plain text tables.

numpy copy of astrild_tpu/io/binary_formats.py: a 1024-byte header and a
uint64-buffered data block for density grids; a 1024-byte header, 16-char
column names and int32 / float32 blocks for halo catalogs. The header
dtypes and the buffering are the JAX package's, so each package reads the
other's files byte for byte. Tensors are taken to the host first.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .._device import as_host

__all__ = [
    "DENSITY_FILE_TYPES", "density_header_dtype", "read_density",
    "write_density", "halo_header_dtype", "read_halo_catalog",
    "write_halo_catalog", "read_text_table", "write_text_table",
    "write_text_table_gnuplot3d",
]

_BUF = np.uint64

# file-type registry (density.py:10-97)
DENSITY_FILE_TYPES = {
    "density": 1, "velocity": 11, "velocity_gradient": 12,
    "velocity_divergence": 13, "velocity_shear": 14,
    "velocity_vorticity": 15, "velocity_std": 16, "scalar_field": 20,
    "scalar_field_gradient": 21, "gravitational_potential": 50,
    "watershed": 101,
}
_COMPONENTS = {1: 1, 11: 3, 12: 9, 13: 1, 14: 5, 15: 3, 16: 1, 20: 6,
               21: 18, 50: 1, 101: 1, -1: 1, 10001: 1, 10002: 2, 10003: 3}
_DTYPES = {101: np.int32}


def density_header_dtype():
    fill = 1024 - 13 * 8 - 18 * 8 - 2 * 8
    return np.dtype([
        ("gridSize", np.uint64, 3),
        ("totalGrid", np.uint64),
        ("fileType", np.int32),
        ("noDensityFiles", np.uint32),
        ("densityFileGrid", np.uint32, 3),
        ("indexDensityFile", np.uint32),
        ("box", np.float64, 6),
        ("npartTotal", np.uint64, 6),
        ("mass", np.float64, 6),
        ("time", np.float64),
        ("redshift", np.float64),
        ("BoxSize", np.float64),
        ("Omega0", np.float64),
        ("OmegaLambda", np.float64),
        ("HubbleParam", np.float64),
        ("method", np.uint64),
        ("fill", "c", fill),
        ("FILE_ID", np.int64),
    ])


def _read_buffered(f, dtype, count):
    b1 = np.fromfile(f, _BUF, 1)[0]
    data = np.fromfile(f, dtype, count)
    b2 = np.fromfile(f, _BUF, 1)[0]
    if b1 != b2:
        raise IOError(f"buffer mismatch: {b1} != {b2}")
    return data


def _write_buffered(f, arr):
    np.array([arr.nbytes], dtype=_BUF).tofile(f)
    arr.tofile(f)
    np.array([arr.nbytes], dtype=_BUF).tofile(f)


def read_density(path):
    """Read a DTFE-format grid file -> (header_record, data).

    data is reshaped to gridSize (+ trailing component axis if the file
    type is multi-component).
    """
    with open(path, "rb") as f:
        header = _read_buffered(f, density_header_dtype(), 1)[0]
        ncomp = _COMPONENTS.get(int(header["fileType"]), 1)
        dt = _DTYPES.get(int(header["fileType"]), np.float32)
        total = int(header["totalGrid"]) * ncomp
        data = _read_buffered(f, dt, total)
    shape = tuple(int(x) for x in header["gridSize"])
    if ncomp > 1:
        shape = shape + (ncomp,)
    return header, data.reshape(shape)


def write_density(path, data, file_type: int = 1, boxsize: float = 0.0,
                  redshift: float = 0.0, omega_m: float = 0.0,
                  omega_l: float = 0.0, hubble: float = 0.0):
    """Write a grid in DTFE binary format (single file)."""
    data = as_host(data)
    ncomp = _COMPONENTS.get(file_type, 1)
    if ncomp > 1:
        grid_shape = data.shape[:-1]
        assert data.shape[-1] == ncomp
    else:
        grid_shape = data.shape
    hdr = np.zeros((), density_header_dtype())
    hdr["gridSize"] = np.array(grid_shape + (1,) * (3 - len(grid_shape)),
                               np.uint64)
    hdr["totalGrid"] = int(np.prod(grid_shape))
    hdr["fileType"] = file_type
    hdr["noDensityFiles"] = 1
    hdr["box"] = np.array([0, boxsize, 0, boxsize, 0, boxsize], np.float64)
    hdr["redshift"] = redshift
    hdr["BoxSize"] = boxsize
    hdr["Omega0"] = omega_m
    hdr["OmegaLambda"] = omega_l
    hdr["HubbleParam"] = hubble
    hdr["FILE_ID"] = 1
    dt = _DTYPES.get(file_type, np.float32)
    with open(path, "wb") as f:
        _write_buffered(f, hdr.reshape(1))
        _write_buffered(f, data.astype(dt).reshape(-1))


# ---------------------------------------------------------------- halo file
_COLUMN_NAME_LEN = 16


def halo_header_dtype():
    fill = 1024 - 4 * 8 - 10 * 8 - 4 * 8 - 2 * 8
    return np.dtype([
        ("noHalos", np.int64),
        ("noColumnsIntegers", np.int64),
        ("noColumnsFloats", np.int64),
        ("noColumns", np.int64),
        ("mpcUnit", np.float64),
        ("box", np.float64, 6),
        ("positionColumns", np.int64, 3),
        ("massUnit", np.float64),
        ("massRange", np.float64, 2),
        ("massColumn", np.int64),
        ("noFiles", np.int64),
        ("fill", "c", fill),
        ("FILE_ID", np.int64),
    ])


def read_halo_catalog(path):
    """Cautun halo binary -> (header, int_names, float_names, ints, floats)."""
    with open(path, "rb") as f:
        header = _read_buffered(f, halo_header_dtype(), 1)[0]
        ncol = int(header["noColumns"])
        ni = int(header["noColumnsIntegers"])
        nf = int(header["noColumnsFloats"])
        nh = int(header["noHalos"])
        names = _read_buffered(f, "c", ncol * _COLUMN_NAME_LEN)
        names = names.reshape(ncol, _COLUMN_NAME_LEN)
        names = [b"".join(row).decode(errors="ignore").strip("\x00").strip()
                 for row in names]
        ints = _read_buffered(f, np.int32, nh * ni).reshape(nh, ni)
        floats = _read_buffered(f, np.float32, nh * nf).reshape(nh, nf)
    return header, names[:ni], names[ni:], ints, floats


def write_halo_catalog(path, ints, floats, int_names: Sequence[str],
                       float_names: Sequence[str], boxsize: float,
                       mass_column: int = 0, mpc_unit: float = 1.0,
                       mass_unit: float = 1.0,
                       position_columns=(0, 1, 2)):
    """Write a catalog in the Cautun halo binary format
    (the wire format consumed by the original tunnels void finder)."""
    ints = np.asarray(as_host(ints), np.int32)
    floats = np.asarray(as_host(floats), np.float32)
    nh = floats.shape[0]
    ni = ints.shape[1] if ints.size else 0
    nf = floats.shape[1]
    hdr = np.zeros((), halo_header_dtype())
    hdr["noHalos"] = nh
    hdr["noColumnsIntegers"] = ni
    hdr["noColumnsFloats"] = nf
    hdr["noColumns"] = ni + nf
    hdr["mpcUnit"] = mpc_unit
    hdr["box"] = np.array([0, boxsize, 0, boxsize, 0, boxsize], np.float64)
    hdr["positionColumns"] = np.array(position_columns, np.int64)
    hdr["massUnit"] = mass_unit
    hdr["massColumn"] = mass_column
    if nh:
        hdr["massRange"] = np.array([floats[:, mass_column].min(),
                                     floats[:, mass_column].max()])
    hdr["noFiles"] = 1
    hdr["FILE_ID"] = 100
    names = list(int_names) + list(float_names)
    assert len(names) == ni + nf
    namearr = np.zeros((len(names), _COLUMN_NAME_LEN), "c")
    for i, nm in enumerate(names):
        b = nm.encode()[:_COLUMN_NAME_LEN]
        namearr[i, :len(b)] = np.frombuffer(b, "c")
    with open(path, "wb") as f:
        _write_buffered(f, hdr.reshape(1))
        _write_buffered(f, namearr.reshape(-1))
        _write_buffered(f, ints.reshape(-1))
        _write_buffered(f, floats.reshape(-1))


# -------------------------------------------------------------- info header
def write_info_header(binary_path, description: str, columns=None):
    """Write the companion '<file>.info' text header the reference's
    toolchain leaves beside binary files
    (rays/voids/tunnels/infoHeader.py:1-28)."""
    path = str(binary_path) + ".info"
    with open(path, "w") as f:
        f.write(description.rstrip() + "\n")
        for i, c in enumerate(columns or []):
            f.write(f"  column {i}: {c}\n")
    return path


# --------------------------------------------------------------- text table
def read_text_table(path, no_comment_lines: int = 0):
    """Plain whitespace table -> (n, ncol) float array
    (reference rays/voids/tunnels/textFile.py:6-41)."""
    return np.loadtxt(path, skiprows=no_comment_lines, ndmin=2)


def write_text_table(path, data, header: str = ""):
    """(reference textFile.py:43-55)"""
    np.savetxt(path, as_host(data), header=header)


def write_text_table_gnuplot3d(path, data, description: str = ""):
    """3D array -> gnuplot splot blocks: one whitespace row per (i, j)
    slice vector, rows grouped per i with a blank separator line
    (reference textFile.py:92-123).
    """
    data = as_host(data)
    if data.ndim != 3:
        raise ValueError(f"need a 3D array, got {data.ndim}D")
    with open(path, "w") as f:
        if description:
            f.write(description if description.endswith("\n")
                    else description + "\n")
        for block in data:
            for row in block:
                f.write("  ".join("%12.7g" % v for v in row) + "\n")
            f.write("\n")
