"""RAMSES/ECOSMOG gravity-output (Fortran-record) transcription.

numpy copy of astrild_tpu/io/ramses.py: the `grav_XXXXX.outYYYYY` files
written by ECOSMOG's output_poisson.f90 are sequences of Fortran-77
records; for a non-AMR run each (level, cpu) block holds `2^ndim`
sub-grids of `ncache` float64 values per field. This reader returns the
concatenated per-field arrays; deduplication of the cells that CPU
boundaries repeat (ghost rows) is optional and keeps `np.unique`'s
lexicographic row order, so both packages return the same rows in the same
order.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["read_grav_file", "read_grav_snapshot"]


def read_grav_file(path, n_fields: int, levelmin: int, levelmax: int,
                   ndim: int = 3) -> List[np.ndarray]:
    """Read one grav_*.out????? file -> list of n_fields float64 arrays."""
    with open(path, "rb") as f:
        content = f.read()
    dimfac = 2 ** ndim
    # header: 4 F77 records of one int32 each: ncpu, ndim, nlevelmax,
    # nboundary (each wrapped in 4-byte record markers)
    info = struct.unpack("i" * 12, content[:48])
    ncpu, ndim_file, nlevelmax, nboundary = info[1], info[4], info[7], info[10]
    fields: List[List[np.ndarray]] = [[] for _ in range(n_fields)]
    pmax = 48
    for _level in range(levelmin, levelmax + 1):
        for _ib in range(1, nboundary + ncpu + 1):
            pmin0 = pmax
            pmax0 = pmin0 + 4 * 3 * 2
            info = struct.unpack("i" * 6, content[pmin0:pmax0])
            ncache = info[4]
            if ncache == 0:
                pmax = pmax0
                continue
            for _dim in range(dimfac):
                for n in range(1, n_fields + 1):
                    pmin = pmax0 + (8 * n - 4) + (n - 1) * 8 * ncache
                    pmax = pmin + ncache * 8
                    vals = np.frombuffer(content[pmin:pmax], "<f8")
                    fields[n - 1].append(vals)
                pmax0 = pmax + 4
            pmax = pmax0
    return [np.concatenate(c) if c else np.empty(0) for c in fields]


def read_grav_snapshot(paths: Sequence[str], field_names: Sequence[str],
                       levelmin: int, levelmax: int, ndim: int = 3,
                       deduplicate: bool = True) -> Dict[str, np.ndarray]:
    """Read all per-CPU files of one snapshot and merge.

    deduplicate: drop rows duplicated across CPU-boundary ghost zones
    (the rows come back in lexicographic order).
    """
    cols = [[] for _ in field_names]
    for p in sorted(paths, key=lambda s: int(s.split(".")[-1][-5:])):
        out = read_grav_file(p, len(field_names), levelmin, levelmax, ndim)
        for i, arr in enumerate(out):
            cols[i].append(arr)
    data = np.stack([np.concatenate(c) for c in cols], axis=1)
    if deduplicate and data.size:
        data = np.unique(data, axis=0)
    return {name: data[:, i] for i, name in enumerate(field_names)}
