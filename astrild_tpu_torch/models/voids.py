"""Void finding and void-catalog analysis on flat-sky maps and 3D grids.

Port of astrild_tpu/models/voids.py: `TunnelsFinder` (peaks of a kappa map
-> `ops.voids.find_tunnels_auto` per SNR cut), `WatershedFinder`,
`SphericalVoidFinder3D` (its `from_particles` paints through
`ops.paint.paint`, K2 on the card), `WatershedFinder3D`, and the `Voids`
catalog manager (size function, radial profiles, bootstrap statistics,
tangential shear). Catalogs and profiles are host numpy column dicts, as in
the JAX package; maps and grids are tensors. Numpy maps and grids go to
`device`, by default the CUDA card (it raises without one); tensors keep
their device, and a finder's catalog is computed where its map lies.

The bootstrap of `get_profile_stats` draws from a `torch.Generator` seeded
with the category's index, where the JAX package seeds a PRNG key with it:
the envelopes are another realization of the same resampling
(`ops.profiles.bootstrap_profiles_from_draws` takes the JAX draws).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import as_points, as_tensor
from ..core.dataset import Dataset
from ..io import columnar_h5
from ..ops import filters as filter_ops
from ..ops import object_selection
from ..ops import peaks as peak_ops
from ..ops import profiles as prof_ops
from ..ops import voids as void_ops

__all__ = ["TunnelsFinder", "WatershedFinder", "SphericalVoidFinder3D",
           "WatershedFinder3D", "Voids", "load_void_config"]

_CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def load_void_config(name_or_path) -> dict:
    """Load a void-profiling parameter file (extend, nr_profile_bins,
    nr_radius_bins, obj_num_in_radbin, ...).

    Accepts a path, or a shipped template name ("tunnels_isw", "svf_isw",
    "zobov_isw", with or without the .json suffix) resolved against this
    package's configs directory. A path with directories that does not
    exist raises rather than fall back to a template of the same name.
    """
    p = Path(name_or_path)
    if not p.exists():
        if len(p.parts) > 1:
            raise FileNotFoundError(f"void config {name_or_path!r} not "
                                    "found")
        name = p.name if p.name.endswith(".json") else p.name + ".json"
        p = _CONFIG_DIR / name
    if not p.exists():
        raise FileNotFoundError(
            f"void config {name_or_path!r} not found (looked in cwd and "
            f"{p.parent})")
    with open(p) as fh:
        return json.load(fh)


def _pix_catalog(cat, n: int, pix2deg: float) -> dict:
    """x/y columns in pixels and degrees of a catalog's first n entries
    (pos holds (row, col); integer positions as int32, the JAX package's
    dtype)."""
    pos = _host(cat.pos)[:n]
    if pos.dtype.kind == "i":
        pos = pos.astype(np.int32)
    return {"x_pix": pos[:, 1], "y_pix": pos[:, 0],
            "x_deg": pos[:, 1] * pix2deg, "y_deg": pos[:, 0] * pix2deg}


class TunnelsFinder:
    """Tunnels void finder (Cautun arxiv:1710.01730) on kappa maps:
    find_peaks on the convergence map (threshold ladder bottom, SNR, edge
    trim), then find_voids per SNR cut by the largest-empty-circle grid
    algorithm; results are column dicts in pixel and degree units."""

    def __init__(self, skymap):
        self.skymap = skymap
        self.peaks: Optional[dict] = None
        self.voids: Optional[dict] = None

    def find_peaks(self, on: str = "orig", field_conversion: str = None,
                   thresholds_dsc: dict = None, snr_sigma=None,
                   max_peaks: int = 4096, edge_pix: int = 0) -> dict:
        img = self.skymap._layer(on)
        if field_conversion == "normalize":
            img = img - torch.mean(img)
        nbins = (thresholds_dsc or {}).get("nbins", 100)
        thr_img = self.skymap._layer((thresholds_dsc or {}).get("on", on))
        vmin = float(torch.min(thr_img))
        vmax = float(torch.max(thr_img))
        threshold = vmin + (vmax - vmin) / nbins  # ladder bottom
        cat = peak_ops.find_peaks(img, threshold=threshold,
                                  max_peaks=max_peaks, edge_pix=edge_pix,
                                  sigma=snr_sigma)
        n = int(cat.n)
        self.on = on
        self.peaks = _pix_catalog(
            cat, n, self.skymap.opening_angle / self.skymap.npix)
        self.peaks["kappa"] = _host(cat.values)[:n]
        self.peaks["snr"] = _host(cat.snr)[:n]
        return self.peaks

    def find_voids(self, sigmas: Sequence[float] = (0.0,),
                   overlap: float = 0.2, max_voids: int = 1024) -> dict:
        """Per-SNR-cut void catalogs; each cut's surviving peaks, with a
        'sigma' column and radii measured against that cut's voids, go to
        `filtered_peaks`."""
        if self.peaks is None:
            raise RuntimeError("run find_peaks first")
        npix = self.skymap.npix
        pix2deg = self.skymap.opening_angle / npix
        all_cols: Dict[str, list] = {k: [] for k in
                                     ("x_pix", "y_pix", "x_deg", "y_deg",
                                      "rad_pix", "rad_deg", "sigma")}
        peaks_pos = np.stack([self.peaks["y_pix"], self.peaks["x_pix"]],
                             axis=-1).astype(np.float32)
        peaks_pos = as_tensor(peaks_pos, self.skymap.device)
        snr = np.asarray(self.peaks["snr"])
        peak_cols: Dict[str, list] = {
            k: [] for k in ("x_pix", "y_pix", "x_deg", "y_deg", "kappa",
                            "snr", "sigma", "rad_pix", "rad_deg")}
        for sigma in sigmas:
            sel = snr > sigma
            if int(sel.sum()) == 0:
                continue
            # the escalating variant, so that a peak-dense map cannot
            # silently truncate its candidate list
            cat = void_ops.find_tunnels_auto(
                peaks_pos, torch.from_numpy(sel).to(peaks_pos.device), npix,
                max_voids=max_voids, overlap=overlap)
            n = int(cat.n)
            cols = _pix_catalog(cat, n, pix2deg)
            rad = _host(cat.radius)[:n]
            cols.update(rad_pix=rad, rad_deg=rad * pix2deg,
                        sigma=np.full(n, sigma))
            for k, v in cols.items():
                all_cols[k].append(v)
            void_xy_deg = np.stack([cols["x_deg"], cols["y_deg"]], axis=-1)
            cut = {k: np.asarray(v)[sel] for k, v in self.peaks.items()}
            cut["sigma"] = np.full(sel.sum(), sigma)
            cut_radii = self._peak_radii_deg(
                np.stack([cut["x_deg"], cut["y_deg"]], axis=-1), void_xy_deg)
            cut["rad_deg"] = cut_radii
            cut["rad_pix"] = np.rint(cut_radii / pix2deg).astype(int)
            for k, v in cut.items():
                peak_cols[k].append(v)
        self.voids = {k: (np.concatenate(v) if v else np.empty(0))
                      for k, v in all_cols.items()}
        self.filtered_peaks = {k: (np.concatenate(v) if v else np.empty(0))
                               for k, v in peak_cols.items()}
        return self.voids

    @staticmethod
    def _peak_radii_deg(peak_xy_deg: np.ndarray,
                        void_xy_deg: np.ndarray) -> np.ndarray:
        """Peak radius = distance to the nearest void center."""
        if len(void_xy_deg) == 0:
            return np.zeros(len(peak_xy_deg))
        from scipy.spatial import cKDTree

        dist, _ = cKDTree(void_xy_deg).query(peak_xy_deg, k=1)
        return dist

    def set_peak_radii(self, peaks: Optional[dict] = None,
                       voids: Optional[dict] = None) -> dict:
        """Peak radius = distance to the nearest void center."""
        from scipy.spatial import cKDTree

        peaks = peaks or self.peaks
        voids = voids or self.voids
        vp = np.stack([voids["x_deg"], voids["y_deg"]], axis=-1)
        pp = np.stack([peaks["x_deg"], peaks["y_deg"]], axis=-1)
        dist, _ = cKDTree(vp).query(pp, k=1)
        peaks = dict(peaks)
        peaks["rad_deg"] = dist
        peaks["rad_pix"] = np.rint(
            dist * self.skymap.npix / self.skymap.opening_angle).astype(int)
        return peaks

    def to_file(self, dir_out: str) -> None:
        """Persist peaks and voids as columnar h5 tables."""
        os.makedirs(dir_out, exist_ok=True)
        if self.peaks is not None:
            columnar_h5.write_table(
                os.path.join(dir_out, "peaks_in_kappa2.h5"),
                {k: np.asarray(v) for k, v in self.peaks.items()})
        if self.voids is not None:
            columnar_h5.write_table(
                os.path.join(dir_out, "voids_in_kappa2.h5"),
                {k: np.asarray(v) for k, v in self.voids.items()})


class WatershedFinder:
    """Watershed void finder on a Gaussian-smoothed map."""

    def __init__(self, skymap):
        self.skymap = skymap
        self.voids: Optional[dict] = None

    def find_voids(self, on: str = "orig", smooth_arcmin: float = 5.0,
                   percentile_mask: float = 80.0, max_voids: int = 1024
                   ) -> dict:
        img = filter_ops.gaussian(self.skymap._layer(on),
                                  self.skymap.opening_angle,
                                  sigma_arcmin=smooth_arcmin)
        cat = void_ops.watershed_voids(img, max_voids=max_voids,
                                       percentile_mask=percentile_mask)
        n = int(cat.n)
        pix2deg = self.skymap.opening_angle / self.skymap.npix
        self.voids = _pix_catalog(cat, n, pix2deg)
        rad = _host(cat.radius)[:n]
        self.voids.update(rad_pix=rad, rad_deg=rad * pix2deg,
                          sigma=np.zeros(n))
        return self.voids


class SphericalVoidFinder3D:
    """3D spherical void finder (SVF) on a density grid: construct,
    find_voids, feed Voids.from_finder."""

    def __init__(self, delta, boxsize, device=None):
        self.delta = as_tensor(delta, device)
        self.boxsize = float(boxsize)
        self.voids: Optional[dict] = None

    @classmethod
    def from_particles(cls, pos, ngrid: int, boxsize, window: str = "cic",
                       device=None) -> "SphericalVoidFinder3D":
        """The finder of the particles' density contrast: `pos` ((n, 3) or
        a tuple of flat components) painted onto ngrid^3 (K2 on the
        card)."""
        from ..ops import paint as paint_ops

        grid = paint_ops.paint(as_points(pos, device), ngrid, boxsize,
                               window=window)
        return cls(grid / torch.mean(grid) - 1.0, boxsize)

    def find_voids(self, delta_threshold: float = -0.8,
                   overlap: float = 0.5, max_voids: int = 512,
                   n_radii: int = 24, r_min=None, r_max=None) -> dict:
        from ..ops import voids3d

        cat = voids3d.svf_voids(self.delta, self.boxsize,
                                delta_threshold=delta_threshold,
                                overlap=overlap, max_voids=max_voids,
                                n_radii=n_radii, r_min=r_min, r_max=r_max)
        self.voids = voids3d.svf_catalog_dict(cat, overlap=overlap)
        self.catalog = cat
        return self.voids


class WatershedFinder3D:
    """ZOBOV-style 3D watershed finder on a density grid."""

    def __init__(self, delta, boxsize, device=None):
        self.delta = as_tensor(delta, device)
        self.boxsize = float(boxsize)
        self.voids: Optional[dict] = None

    def find_voids(self, core_delta: float = -0.5,
                   smooth_cells: float = 2.0, max_voids: int = 512
                   ) -> dict:
        from ..ops import voids3d

        cat = voids3d.watershed_voids_3d(self.delta, self.boxsize,
                                         max_voids=max_voids,
                                         core_delta=core_delta,
                                         smooth_cells=smooth_cells)
        n = int(cat.n)
        pos = _host(cat.pos)[:n]
        min_delta = _host(cat.min_delta)[:n]
        self.voids = {
            "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
            "radius": _host(cat.radius)[:n],
            "min_delta": min_delta,
            # zobov catalogs threshold on this column
            "halo_den": min_delta,
        }
        self.catalog = cat
        return self.voids


def _centers(data, sel=slice(None)) -> np.ndarray:
    """(row, col) int32 centres of catalog rows (pixel columns truncated,
    as the JAX package's int32 cast)."""
    return np.stack([np.asarray(data["y_pix"]).astype(np.int32)[sel],
                     np.asarray(data["x_pix"]).astype(np.int32)[sel]],
                    axis=-1)


def _profiles_of(data, img, radii_max: float, nr_rad_bins: int) -> dict:
    """Annulus profiles of a catalog's objects on img (the shared body of
    Voids / Peaks.get_profiles)."""
    radii = np.asarray(data["rad_pix"]).astype(np.float32)
    patch_half = int(np.ceil(float(radii.max()) * radii_max)) + 1
    eta, values = prof_ops.object_profiles(
        img, as_tensor(_centers(data), img.device),
        as_tensor(radii, img.device), patch_half=patch_half,
        nbins=nr_rad_bins, extend=radii_max)
    return {"radii": _host(eta), "values": _host(values)}


def _bootstrap(profs, centers, seed: int, n_boot: int, npix: int):
    gen = torch.Generator(device=profs.device).manual_seed(seed)
    return prof_ops.bootstrap_profiles(
        profs, as_tensor(centers, profs.device), gen, n_boot=n_boot,
        block_pix=max(npix // 16, 1), npix=npix)


class Voids:
    """Void-catalog manager for finders {tunnels, svf, zobov, wvf}."""

    # zobov catalogs threshold on 'halo_den'
    FINDER_SIGMA_NAMES = {"tunnels": "sigma", "svf": "void_overlap",
                          "zobov": "halo_den", "wvf": "sigma"}

    def __init__(self, data: Dict[str, np.ndarray], finder: str = "tunnels",
                 skymap_dsc: Optional[dict] = None, file_in=None,
                 device=None):
        self.data = data
        self.finder = finder
        self.skymap_dsc = skymap_dsc or {}
        self.file_in = file_in
        self.device = device
        self.profiles: Optional[dict] = None
        self.field_conversion = None

    @classmethod
    def from_file(cls, finder: str, skymap_dsc: dict, ffile: str,
                  device=None) -> "Voids":
        return cls(columnar_h5.read_table(ffile), finder, skymap_dsc, ffile,
                   device=device)

    @classmethod
    def from_finder(cls, finder_obj, skymap_dsc: Optional[dict] = None,
                    device=None) -> "Voids":
        """The finder's catalog; numpy maps given to it later go to
        `device`, by default where the finder's map or grid lies."""
        if isinstance(finder_obj, TunnelsFinder):
            name = "tunnels"
        elif isinstance(finder_obj, SphericalVoidFinder3D):
            name = "svf"
        elif isinstance(finder_obj, WatershedFinder3D):
            name = "zobov"
        else:
            name = "wvf"
        if device is None:
            device = (finder_obj.delta.device if hasattr(finder_obj, "delta")
                      else finder_obj.skymap.device)
        return cls(dict(finder_obj.voids), name, skymap_dsc, device=device)

    # -------------------------------------------------------------- selection
    def categorize_sizes(self, bins: int, min_obj_nr: int) -> None:
        """Log-binned size categories, undersized bins dropped."""
        self.data = object_selection.categorize_sizes(
            self.data, "log", bins, min_obj_nr)

    def filter_size(self, size_bin: int) -> Dict[str, np.ndarray]:
        """Rows of one size category."""
        keep = np.asarray(self.data["size_cat"]) == size_bin
        return {k: np.asarray(v)[keep] for k, v in self.data.items()}

    def filter_sigma(self, sigma: float) -> Dict[str, np.ndarray]:
        """Rows at one detection threshold; the key depends on the
        finder."""
        key = self.FINDER_SIGMA_NAMES[self.finder]
        keep = np.asarray(self.data[key]) == sigma
        return {k: np.asarray(v)[keep] for k, v in self.data.items()}

    def filter_snapshot(self, ray_nr: int) -> Dict[str, np.ndarray]:
        """Rows of one ray snapshot, for catalogs spanning a lightcone."""
        keep = np.asarray(self.data["ray_nr"]) == ray_nr
        return {k: np.asarray(v)[keep] for k, v in self.data.items()}

    def select_type(self, void_type: str, tracers, args: dict) -> None:
        """'minimal' voids: interiors below the mean tracer density.

        tracers must be an (N, 2) array of tracer pixel positions; args
        must carry the map width in pixels under 'field_width' (or
        'field_width_pix').
        """
        if void_type == "minimal":
            width = args.get("field_width_pix", args.get("field_width"))
            if width is None:
                raise KeyError(
                    "select_type('minimal', ...) needs args['field_width'] "
                    "(map width in pixels)")
            if isinstance(tracers, torch.Tensor):
                tracers = _host(tracers)
            self.data = object_selection.minimal_voids(
                self.data, np.asarray(tracers), float(width))

    # ------------------------------------------------------------ statistics
    def get_void_size_fct(self, nbins: int, limits=None) -> Dict[str, dict]:
        """Cumulative void size function per sigma."""
        out = {}
        sigmas = np.unique(self.data["sigma"])
        for idx, nu in enumerate(sigmas):
            sel = self.data["sigma"] == nu
            rad = np.asarray(self.data["rad_deg"])[sel]
            if limits is None:
                lo, hi = np.percentile(rad, 5), np.percentile(rad, 95)
            else:
                lo, hi = min(limits[idx]), max(limits[idx])
            bins = np.linspace(lo, hi, nbins + 1)
            hist, edges = np.histogram(rad, bins=bins, density=False)
            hist = np.cumsum(hist[::-1])[::-1]
            out[float(nu)] = {"rad": 0.5 * (edges[1:] + edges[:-1]),
                              "counts": hist}
        return out

    # -------------------------------------------------------------- config
    def apply_profile_config(self, config, skymap=None) -> dict:
        """Run the ISW profiling recipe of a parameter file (a dict, or a
        name or path for `load_void_config`): nr_radius_bins /
        obj_num_in_radbin drive the size categories, extend /
        nr_profile_bins the radial profiles. Returns the profiles dict (and
        leaves it on self for get_profile_stats)."""
        if not isinstance(config, dict):
            config = load_void_config(config)
        if skymap is None:
            raise ValueError("apply_profile_config needs skymap= (the "
                             "field map the profiles are measured on)")
        nbins = int(config.get("nr_radius_bins", 0))
        if nbins and nbins < len(np.asarray(self.data["rad_pix"])):
            self.categorize_sizes(
                bins=nbins, min_obj_nr=int(config.get("obj_num_in_radbin", 1)))
        return self.get_profiles(
            radii_max=float(config.get("extend", 3.0)),
            nr_rad_bins=int(config.get("nr_profile_bins", 20)),
            skymap=skymap,
            field_conversion=config.get("field_conversion"))

    # -------------------------------------------------------------- profiles
    def get_profiles(self, radii_max: float, nr_rad_bins: int,
                     skymap=None, field_conversion=None) -> dict:
        """Radial profiles of all voids on the map (numpy, as the JAX
        package keeps them); the statistics of `get_profile_stats` run
        where the map lies."""
        img = as_tensor(skymap, self.device)
        self.device = img.device
        if field_conversion == "normalize":
            img = img - torch.mean(img)
        self.field_conversion = field_conversion
        self.profiles = _profiles_of(self.data, img, radii_max, nr_rad_bins)
        return self.profiles

    def get_profile_stats(self, cats: Sequence[str] = ("sigma",),
                          field_conversion=None, n_boot: int = 100,
                          dir_out=None, save: bool = False) -> Dataset:
        """Mean and bootstrap 16/84 envelopes per category."""
        if field_conversion:
            self.field_conversion = field_conversion
        if self.profiles is None:
            raise RuntimeError("run get_profiles first")
        cat_key = cats[0] if cats else "sigma"
        sigmas = np.unique(self.data[cat_key])
        nr = len(self.profiles["radii"])
        mean = np.zeros((len(sigmas), nr))
        lo = np.zeros_like(mean)
        hi = np.zeros_like(mean)
        smin = np.zeros(len(sigmas))
        smax = np.zeros(len(sigmas))
        nobj = np.zeros(len(sigmas))
        npix = self.skymap_dsc.get("npix", 4096)
        for ss, sigma in enumerate(sigmas):
            sel = np.where(self.data[cat_key] == sigma)[0]
            profs = as_tensor(self.profiles["values"][sel], self.device)
            m = prof_ops.mean_and_interpolate(profs)
            if self.field_conversion == "tangential_shear":
                m = prof_ops.tangential_shear(
                    as_tensor(self.profiles["radii"], profs.device), m)
            mean[ss] = _host(m)
            l, h = _bootstrap(profs, _centers(self.data, sel), ss, n_boot,
                              npix)
            lo[ss] = _host(l)
            hi[ss] = _host(h)
            rads = np.asarray(self.data["rad_deg"])[sel]
            smin[ss], smax[ss] = rads.min(), rads.max()
            nobj[ss] = len(sel)
        ds = Dataset(
            data_vars={"mean": ((cat_key, "radius"), mean),
                       "lowerr": ((cat_key, "radius"), lo),
                       "higherr": ((cat_key, "radius"), hi)},
            coords={cat_key: sigmas, "radius": self.profiles["radii"],
                    "size_min": ((cat_key,), smin),
                    "size_max": ((cat_key,), smax),
                    "nr_of_obj": ((cat_key,), nobj)},
        )
        if save and dir_out:
            Path(dir_out).mkdir(parents=True, exist_ok=True)
            ds.to_hdf5(os.path.join(dir_out,
                                    f"{self.finder}_profiles.stats.h5"))
        return ds

    def trim_edges(self, npix: Optional[int] = None,
                   extend: float = 1.0) -> None:
        """Drop voids whose extend*radius profile patch crosses the map
        edge (callers profiling out to radii_max * rad trim with
        extend=radii_max)."""
        npix = npix or self.skymap_dsc.get("npix")
        self.data = object_selection.trim_objects_crossing_edge(
            self.data, extend, npix, key_size="rad_pix",
            pos_keys=("x_pix", "y_pix"))
