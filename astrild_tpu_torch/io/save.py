"""Artifact save helpers.

numpy copy of astrild_tpu/io/save.py: maps to .npy (or .fits when astropy
is installed), column dicts and two-point results to columnar h5. Tensors
are taken to the host first; `save_skymap` also takes a `SkyArray`, whose
"orig" layer it writes.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np

from .._device import as_host
from . import columnar_h5

__all__ = ["save_skymap", "save_columns", "save_tpcf"]


def save_skymap(skymap, path: str) -> str:
    """Map (array, tensor or SkyArray) -> .npy, or .fits when astropy is
    installed."""
    Path(os.path.dirname(path) or ".").mkdir(parents=True, exist_ok=True)
    data = getattr(skymap, "data", None)
    arr = as_host(data["orig"] if isinstance(data, dict) else skymap)
    if path.endswith(".fits"):
        try:
            from astropy.io import fits
        except ImportError as e:
            raise ImportError("FITS output needs astropy; save as .npy") from e
        fits.PrimaryHDU(arr).writeto(path, overwrite=True)
    else:
        np.save(path, arr)
    return path


def save_columns(dir_out: str, filename: str,
                 columns: Dict[str, np.ndarray]) -> str:
    """Column dict -> columnar h5 (tensors taken to the host)."""
    Path(dir_out).mkdir(parents=True, exist_ok=True)
    path = os.path.join(dir_out, filename)
    columnar_h5.write_table(path, {k: as_host(v) for k, v in columns.items()})
    return path


# DataFrame-compatible alias
save_dataFrame = save_columns


def save_tpcf(dir_out: str, filename: str, r, xi, xi_multipoles=None) -> str:
    """Two-point results -> h5: columns r, xi and xi_<ell> per multipole."""
    cols = {"r": as_host(r), "xi": as_host(xi)}
    for ell, vals in (xi_multipoles or {}).items():
        cols[f"xi_{ell}"] = as_host(vals)
    return save_columns(dir_out, filename, cols)
