"""Peaks: kappa-peak catalog manager with the same profile machinery as
Voids.

Port of astrild_tpu/models/peaks.py. Catalogs and profiles are host numpy
column dicts; maps are tensors (numpy maps go to `device`, by default the
CUDA card, and raise without one; tensors keep their device). The
bootstrap of `get_profile_stats` draws from a `torch.Generator` seeded
with 0, where the JAX package seeds a PRNG key with 0.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import as_tensor
from ..core.dataset import Dataset
from ..io import columnar_h5
from ..ops import profiles as prof_ops
from .voids import _bootstrap, _centers, _host, _profiles_of

__all__ = ["Peaks"]


class Peaks:
    def __init__(self, data: Dict[str, np.ndarray],
                 skymap_dsc: Optional[dict] = None, device=None):
        self.data = data
        self.skymap_dsc = skymap_dsc or {}
        self.device = device
        self.profiles = None
        self.field_conversion = None

    @classmethod
    def from_file(cls, ffile: str, skymap_dsc: Optional[dict] = None,
                  device=None) -> "Peaks":
        return cls(columnar_h5.read_table(ffile), skymap_dsc, device=device)

    @classmethod
    def from_tunnels_finder(cls, finder, with_radii: bool = True) -> "Peaks":
        """The finder's per-sigma filtered peaks (with their 'sigma' column
        and per-cut radii) where find_voids ran, else its peaks with radii
        to the nearest void (with_radii) or without; maps given later go
        where the finder's map lies."""
        data = getattr(finder, "filtered_peaks", None)
        if data is None:
            data = (finder.set_peak_radii() if with_radii
                    else dict(finder.peaks))
        return cls(dict(data), {"npix": finder.skymap.npix,
                                "opening_angle": finder.skymap.opening_angle},
                   device=finder.skymap.device)

    @classmethod
    def from_txt(cls, fname: str, npix: int, field_width_deg: float,
                 skymap_dsc: Optional[dict] = None, device=None) -> "Peaks":
        """Whitespace table (x_deg, y_deg, nu) + derived pixel coords."""
        tab = np.loadtxt(fname, ndmin=2)
        scale = npix / field_width_deg
        data = {"x_deg": tab[:, 0], "y_deg": tab[:, 1], "nu": tab[:, 2],
                "x_pix": np.rint(tab[:, 0] * scale).astype(int),
                "y_pix": np.rint(tab[:, 1] * scale).astype(int)}
        return cls(data, skymap_dsc, device=device)

    def categorize_sizes(self, bins: int, min_obj_nr: int) -> None:
        from ..ops import object_selection

        self.data = object_selection.categorize_sizes(
            self.data, "log", bins, min_obj_nr)

    def filter_size(self, size_bin: int) -> Dict[str, np.ndarray]:
        keep = np.asarray(self.data["size_cat"]) == size_bin
        return {k: np.asarray(v)[keep] for k, v in self.data.items()}

    def filter_sigma(self, sigma: float) -> Dict[str, np.ndarray]:
        keep = np.asarray(self.data["sigma"]) == sigma
        return {k: np.asarray(v)[keep] for k, v in self.data.items()}

    def set_radii(self, voids_data: Dict[str, np.ndarray]) -> None:
        """Peak radius = distance to the nearest void center."""
        from scipy.spatial import cKDTree

        vp = np.stack([voids_data["x_deg"], voids_data["y_deg"]], axis=-1)
        pp = np.stack([self.data["x_deg"], self.data["y_deg"]], axis=-1)
        dist, _ = cKDTree(vp).query(pp, k=1)
        self.data["rad_deg"] = dist
        npix = self.skymap_dsc.get("npix")
        oa = self.skymap_dsc.get("opening_angle")
        if npix and oa:
            self.data["rad_pix"] = np.rint(dist * npix / oa).astype(int)

    def get_profiles(self, radii_max: float, nr_rad_bins: int, skymap=None,
                     field_conversion=None) -> dict:
        """Radial profiles of all peaks on the map; the statistics of
        `get_profile_stats` run where the map lies."""
        img = as_tensor(skymap, self.device)
        self.device = img.device
        if field_conversion == "normalize":
            img = img - torch.mean(img)
        self.field_conversion = field_conversion
        self.profiles = _profiles_of(self.data, img, radii_max, nr_rad_bins)
        return self.profiles

    def get_profile_stats(self, n_boot: int = 100) -> Dataset:
        if self.profiles is None:
            raise RuntimeError("run get_profiles first")
        profs = as_tensor(self.profiles["values"], self.device)
        m = prof_ops.mean_and_interpolate(profs)
        npix = self.skymap_dsc.get("npix", 4096)
        lo, hi = _bootstrap(profs, _centers(self.data), 0, n_boot, npix)
        return Dataset(
            data_vars={"mean": (("radius",), _host(m)),
                       "lowerr": (("radius",), _host(lo)),
                       "higherr": (("radius",), _host(hi))},
            coords={"radius": self.profiles["radii"]},
        )
