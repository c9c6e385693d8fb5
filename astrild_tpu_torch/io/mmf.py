"""MMF/NEXUS cosmic-web environment grid format + environment combination.

numpy copy of astrild_tpu/io/mmf.py: a 1024-byte header and a
uint64-buffered data block (the density format's buffering), the NEXUS
environment combination masks (node > filament > wall > field) and the
per-environment property summaries. Each package reads the other's files
byte for byte; tensors are taken to the host first.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .._device import as_host
from .binary_formats import _BUF, _read_buffered, _write_buffered

__all__ = ["mmf_header_dtype", "read_mmf", "write_mmf",
           "nexus_combine_environments", "nexus_environment_properties"]

# environment codes (MMF.py NEXUS conventions)
FIELD, WALL, FILAMENT, NODE = 0, 1, 2, 3


def mmf_header_dtype():
    # non-fill fields total 272 bytes; header is padded to 1024
    fill = 1024 - 272
    return np.dtype([
        ("gridSize", np.uint64, 3),
        ("totalGrid", np.uint64),
        ("fileType", np.int32),
        ("noMMFFiles", np.uint32),
        ("MMFFileGrid", np.uint32, 3),
        ("indexMMFFile", np.uint32),
        ("box", np.float64, 6),
        ("radius", np.float64),
        ("scale", np.int32),
        ("bias", np.float32),
        ("npartTotal", np.uint64, 6),
        ("mass", np.float64, 6),
        ("time", np.float64),
        ("redshift", np.float64),
        ("BoxSize", np.float64),
        ("Omega0", np.float64),
        ("OmegaLambda", np.float64),
        ("HubbleParam", np.float64),
        ("fill", "c", fill),
        ("FILE_ID", np.int64),
    ])


# fileType -> stored dtype (reference MMF.py:100-115 MMFDataType): the
# item SIZE alone cannot disambiguate i4 environment/object grids from
# f4 responses — reading tags as floats turns env code 3 into 4.2e-45
_MMF_DTYPE = {1: "f4", 5: "f4", 6: "f4", 10: "f4", 11: "f4", 15: "f4",
              16: "f4", 20: "i2", 21: "i2", 30: "i4", 40: "f4", 41: "f4",
              50: "f4", 51: "f4"}


def read_mmf(path):
    """-> (header, grid) with dtype from the fileType registry
    (response: f4; clean env tags: i2; object/env grids: i4), falling
    back to item-size inference for unknown fileType codes."""
    with open(path, "rb") as f:
        header = _read_buffered(f, mmf_header_dtype(), 1)[0]
        total = int(header["totalGrid"])
        b1 = np.fromfile(f, _BUF, 1)[0]
        itemsize = int(b1) // total
        dt = np.dtype(_MMF_DTYPE.get(int(header["fileType"]), "f4"))
        if dt.itemsize != itemsize:  # unknown writer: size fallback
            dt = np.dtype({4: np.float32, 2: np.int16, 1: np.int8,
                           8: np.float64}[itemsize])
        data = np.fromfile(f, dt, total)
        b2 = np.fromfile(f, _BUF, 1)[0]
        if b1 != b2:
            raise IOError("buffer mismatch in MMF file")
    shape = tuple(int(x) for x in header["gridSize"])
    return header, data.reshape(shape)


def write_mmf(path, data, file_type: int = 0, boxsize: float = 0.0,
              redshift: float = 0.0):
    data = as_host(data)
    hdr = np.zeros((), mmf_header_dtype())
    hdr["gridSize"] = np.array(data.shape, np.uint64)
    hdr["totalGrid"] = data.size
    hdr["fileType"] = file_type
    hdr["noMMFFiles"] = 1
    hdr["box"] = np.array([0, boxsize] * 3, np.float64)
    hdr["BoxSize"] = boxsize
    hdr["redshift"] = redshift
    hdr["FILE_ID"] = 10
    with open(path, "wb") as f:
        _write_buffered(f, hdr.reshape(1))
        _write_buffered(f, data.reshape(-1))


def nexus_combine_environments(node_mask, filament_mask, wall_mask
                               ) -> np.ndarray:
    """Combine clean environment masks with node > filament > wall
    priority (MMF.py:962-974). Returns int grid of environment codes."""
    node_mask, filament_mask, wall_mask = (
        as_host(m) for m in (node_mask, filament_mask, wall_mask))
    env = np.zeros(node_mask.shape, np.int16)
    env[wall_mask > 0] = WALL
    env[filament_mask > 0] = FILAMENT
    env[node_mask > 0] = NODE
    return env


def nexus_environment_properties(env, density, boxsize: float
                                 ) -> Dict[str, Dict[str, float]]:
    """Volume/mass fractions and mean density per environment
    (MMF.py:975-1017)."""
    env = as_host(env)
    density = as_host(density)
    total_mass = density.sum()
    out = {}
    for name, code in (("field", FIELD), ("wall", WALL),
                       ("filament", FILAMENT), ("node", NODE)):
        sel = env == code
        out[name] = {
            "volume_fraction": float(sel.mean()),
            "mass_fraction": float(density[sel].sum() / max(total_mass, 1e-30)),
            "mean_density": float(density[sel].mean()) if sel.any() else 0.0,
        }
    return out
