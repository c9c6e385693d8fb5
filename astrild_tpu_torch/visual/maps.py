"""Simulation-handle-driven field -> map -> save facade.

numpy copy of astrild_tpu/visual/maps.py, the twin of the reference
astrild's ``Maps(Simulation)`` visualization facade: walk a simulation's
ray-map point-set files, cut a slab through the box, grid each requested
quantity onto an npix^2 map and save it as .npy. `Maps` subclasses the
port's `models.simulation.Simulation`.

Differences from the reference, by design:
- selection honors ``snap_nrs`` (the reference hardcodes file 12);
- gridding is an NGP mean on the host (np.bincount) instead of scipy
  griddata; empty pixels are filled with the slab mean (the reference's
  ``fill_value=np.mean(values)`` convention).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..io import columnar_h5
from ..models.simulation import Simulation

__all__ = ["Maps"]


class Maps(Simulation):
    def __init__(self, boxsize: float = 500.0, domain_level: int = 512,
                 dir_sim: str = ".", dir_out: Optional[str] = None,
                 snap_nrs: Optional[Sequence[int]] = None,
                 file_root: str = "Ray_maps_output",
                 extension: str = "h5",
                 dir_root: Optional[str] = None):
        super().__init__(dir_sim, dir_out,
                         {"root": file_root, "extension": extension},
                         dir_root)
        self.boxsize = boxsize
        self.npix = int(domain_level)
        self.file_root = file_root
        if not self.files.get(file_root):
            # the reference writes Ray_maps_output%05d.h5 (no underscore
            # before the number) while Simulation's
            # default discovery globs root_*ext — retry the base
            # discovery with an empty separator (same number-column
            # logic, no duplicated machinery)
            dsc = {"root": file_root, "extension": extension, "sep": ""}
            self.file_dsc = dsc
            self.file_nrs = self.get_file_nrs(dsc, self.dirs["sim"],
                                              "max", True)
            self.files[file_root] = self.get_file_paths(dsc,
                                                        self.dirs["sim"],
                                                        "max")
        if snap_nrs is not None:
            snap_nrs = np.asarray(snap_nrs)
            keep = np.isin(self.file_nrs, snap_nrs)
            if not keep.any():
                raise ValueError(
                    f"snap_nrs {list(snap_nrs)} select no files out of "
                    f"{list(np.asarray(self.file_nrs))}")
            self.file_nrs = np.asarray(self.file_nrs)[keep]
            self.files[file_root] = [
                f for f, k in zip(self.files[file_root], keep) if k]

    # ------------------------------------------------------------------ io
    def _read_fields(self, file_map: str) -> Dict[str, np.ndarray]:
        return columnar_h5.read_table(file_map)

    def _save_map(self, filename: str, map_out: np.ndarray) -> str:
        path = os.path.join(self.dirs["out"], filename)
        if os.path.exists(path):
            os.remove(path)
        np.save(path, map_out)
        return path

    # ---------------------------------------------------------------- maps
    def to_array(self, centre: float = 0.5, depth: float = 0.1,
                 quantities: Sequence[str] = ("kappa_2",),
                 save: bool = True) -> Dict[int, Dict[str, np.ndarray]]:
        """Slab maps of point-set quantities, one per (snapshot, quantity).

        centre/depth select the z-slab in box units (slab half-width =
        (1 + depth)/(2*npix)); x/y are box-unit
        coordinates gridded onto npix^2 pixels. Returns
        {file_nr: {quantity: (npix, npix) array}}; save=True also writes
        ``{quantity}_map_{sim_name}_out{file_nr:05d}.npy``.
        """
        npix = self.npix
        half = (1.0 + depth) / (2.0 * npix)
        out: Dict[int, Dict[str, np.ndarray]] = {}
        for file_nr, file_path in zip(self.file_nrs,
                                      self.files[self.file_root]):
            fields = self._read_fields(file_path)
            sel = (np.asarray(fields["z"]) > centre - half) & \
                  (np.asarray(fields["z"]) < centre + half)
            x = np.asarray(fields["x"])[sel]
            y = np.asarray(fields["y"])[sel]
            ix = np.clip((x * npix).astype(np.int64), 0, npix - 1)
            iy = np.clip((y * npix).astype(np.int64), 0, npix - 1)
            flat = ix * npix + iy
            cnt = np.bincount(flat, minlength=npix * npix)
            maps: Dict[str, np.ndarray] = {}
            for quantity in quantities:
                vals = np.asarray(fields[quantity])[sel].astype(np.float64)
                vsum = np.bincount(flat, weights=vals,
                                   minlength=npix * npix)
                fill = vals.mean() if vals.size else 0.0
                m = np.where(cnt > 0, vsum / np.maximum(cnt, 1), fill)
                m = m.reshape(npix, npix).T  # rows = y, cols = x
                maps[quantity] = m
                if save:
                    self._save_map(
                        f"{quantity}_map_{self.name}_out{file_nr:05d}.npy", m)
            out[int(file_nr)] = maps
        return out
