"""Rockstar halo-finder ASCII output reader.

numpy copy of astrild_tpu/io/rockstar.py: header line 0 gives column names
(leading '#'), lines 1-19 are comments, whitespace-separated data follows.
Returns a column dict.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["read_rockstar_ascii", "read_rockstar_files"]


def read_rockstar_ascii(path) -> Dict[str, np.ndarray]:
    with open(path) as f:
        header = f.readline().strip()
    names = header.lstrip("#").split()
    data = np.loadtxt(path, skiprows=20, ndmin=2)
    if data.size == 0:
        return {n: np.empty((0,)) for n in names}
    return {n: data[:, i] for i, n in enumerate(names[:data.shape[1]])}


def read_rockstar_files(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """Concatenate several per-writer rockstar ascii files."""
    parts: List[Dict[str, np.ndarray]] = [read_rockstar_ascii(p) for p in paths]
    parts = [p for p in parts if next(iter(p.values())).size]
    if not parts:
        return {}
    names = parts[0].keys()
    return {n: np.concatenate([p[n] for p in parts]) for n in names}
