"""Halos: catalog manager with config-driven statistics dispatch.

Port of astrild_tpu/models/halos.py: catalogs are host numpy column dicts;
the halo_stats.yaml registry drives the dispatch in resolution order; the
statistics run as the port's ops: the mass function and c-M relations of
`ops.halo_stats`, xi(r) through `ops.tpcf`, v12 through
`ops.pairwise.mean_pairwise_velocity` (the pair-tile kernel K3 on the
card), the SubFind halo P(k) as a TSC mass paint (K2 on the card) and
`ops.power.auto_power`, and HOD galaxies through `ops.hod`. A statistic's
columns go to `device`, by default the CUDA card (it raises without one);
its results come back as numpy. PyYAML is imported by `load_stats_config`
only.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .._device import as_points, as_tensor
from ..io import columnar_h5
from ..io.rockstar import read_rockstar_files
from ..ops import halo_stats as hs_ops
from ..ops import pairwise as pw_ops
from ..ops import tpcf as tpcf_ops
from ..utils.constants import G_NEWTON

__all__ = ["Halos", "Rockstar", "SubFind", "load_stats_config"]

# default DM particle mass for resolution cuts [Msun/h]
DM_PARTICLE_MASS = 8.233e10


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _column(a, device) -> torch.Tensor:
    """A host column as a float32 tensor on `device` (as jnp.asarray of a
    float64 column rounds it)."""
    return as_tensor(np.asarray(a, np.float32), device)


def _tuple_constructor(loader, node):
    return tuple(loader.construct_sequence(node))


def load_stats_config(path) -> dict:
    """YAML stat registry, accepting !!python/tuple tags."""
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor("tag:yaml.org,2002:python/tuple",
                            _tuple_constructor)
    with open(path) as f:
        return yaml.load(f, Loader=_Loader)


class Rockstar:
    """Stat namespace over Rockstar column dicts."""

    @staticmethod
    def halo_mass_fct(snapshot, limits=(11.78, 16.0), nbins: int = 20,
                      device=None):
        bins, cum = hs_ops.halo_mass_function(
            _column(snapshot["m200c"], device), limits=tuple(limits),
            nbins=nbins)
        return _host(bins), _host(cum)

    @staticmethod
    def concentration_mass_rel(snapshot, limits=None, nbins: int = 20,
                               method: str = "nfw", device=None):
        m = np.asarray(snapshot["m200c"], np.float64)
        if limits is None:
            limits = (np.log10(max(m.min(), 1.0)), np.log10(m.max()))
        limits = tuple(float(x) for x in limits)
        m = _column(m, device)
        bins, cm = hs_ops.concentration_mass_rockstar(
            m, _column(snapshot["r200c"], m.device),
            _column(snapshot["Rs"], m.device), limits, nbins=nbins)
        return _host(bins), _host(cm)

    @staticmethod
    def histograms(snapshot, nbins: int, dimesions: int = 1,
                   properties: Optional[dict] = None, base=None,
                   device=None):
        out = {}
        for prop, limits in (properties or {}).items():
            limits = tuple(float(x) for x in limits)
            _, dens = hs_ops.histogram_density(
                _column(snapshot[prop], device), nbins, limits)
            out[prop] = _host(dens)
        return out

    @staticmethod
    def two_point_corr_fct(snapshot, limits=None, nbins=None,
                           boxsize: float = 500.0, device=None):
        """xi(r) of the halo positions (periodic natural estimator)."""
        if limits is None:
            limits = (0.3, boxsize / 5.0)
        if nbins is None:
            nbins = int(2 / 3 * max(limits))
        pos = np.stack([snapshot["x"], snapshot["y"], snapshot["z"]], axis=-1)
        pos = _column(pos, device)
        r_edges = _column(np.geomspace(min(limits), max(limits), nbins + 1),
                          pos.device)
        r, xi = tpcf_ops.tpcf_real(pos, boxsize, r_edges)
        return _host(r), _host(xi)

    @staticmethod
    def mean_pairwise_velocity(snapshot, limits=None, nbins=None,
                               boxsize: float = 500.0, seperate=None,
                               device=None):
        """v12(r) from 3D velocities, in nbins - 1 uniform bins over
        `limits` (through the pair-tile kernel K3 on the card)."""
        if limits is None:
            limits = (0.0, 50.0)
        if nbins is None:
            nbins = 25
        pos = np.stack([snapshot["x"], snapshot["y"], snapshot["z"]], axis=-1)
        vel = np.stack([snapshot["vx"], snapshot["vy"], snapshot["vz"]],
                       axis=-1)
        pos = _column(pos, device)
        bins = _column(np.linspace(min(limits), max(limits), nbins),
                       pos.device)
        r, v12 = pw_ops.mean_pairwise_velocity(pos, _column(vel, pos.device),
                                               bins)
        return _host(r), _host(v12)


class SubFind:
    """Stat namespace over SubFind catalogs."""

    @staticmethod
    def halo_mass_fct(snapshot, limits=(11.78, 16.0), nbins: int = 20,
                      device=None):
        bins, cum = hs_ops.halo_mass_function(
            _column(snapshot["Group_M_Crit200"], device),
            limits=tuple(limits), nbins=nbins)
        return _host(bins), _host(cum)

    @staticmethod
    def concentration_mass_rel(snapshot, limits=(11.78, 16.0),
                               nbins: int = 20, method: str = "prada",
                               device=None):
        m200 = np.asarray(snapshot["Group_M_Crit200"], np.float64)
        r200 = np.asarray(snapshot["Group_R_Crit200"], np.float64)
        vmax = np.asarray(snapshot["SubhaloVmax"], np.float64)
        # v200 = sqrt(G M200 / R200) [km/s]
        v200 = np.sqrt(G_NEWTON * m200 / np.maximum(r200, 1e-12))
        limits = tuple(float(x) for x in limits)
        m = _column(m200, device)
        bins, cm = hs_ops.concentration_mass_prada(
            m, _column(vmax, m.device), _column(v200, m.device), limits,
            nbins=nbins)
        return _host(bins), _host(cm)

    @staticmethod
    def power_spectrum(snapshot, boxsize: float = 500.0, ngrid: int = 256,
                       nbins: int = 0, device=None):
        """Halo P(k): TSC mass paint (K2 on the card) and FFT, with the
        mass-weighted shot noise V sum(m^2) / (sum m)^2."""
        from ..ops import paint as paint_ops
        from ..ops import power as power_ops

        pos = as_points(np.asarray(snapshot["GroupPos"], np.float32), device)
        mass = np.asarray(snapshot["Group_M_Crit200"], np.float64)
        grid = paint_ops.paint(pos, ngrid, boxsize,
                               weights=_column(mass, pos.device),
                               window="tsc")
        shot = boxsize ** 3 * float(np.sum(mass ** 2)) \
            / max(float(np.sum(mass)) ** 2, 1e-300)
        res = power_ops.auto_power(grid, boxsize, nbins=nbins or ngrid // 2,
                                   window="tsc", shotnoise=shot)
        return _host(res.k), _host(res.power)


_NAMESPACES = {"rockstar": Rockstar, "subfind": SubFind}


class Halos:
    """Halo-catalog manager. `device` is where the statistics and the HOD
    run (by default the CUDA card)."""

    def __init__(self, snapshot, simulation=None, device=None):
        self.data = snapshot  # column dict (or None)
        self.sim = simulation
        self.device = device
        self.statistics = None

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_rockstar(cls, snap_nr: int, simulation=None,
                      device=None) -> "Halos":
        files = simulation.files["halos"][str(snap_nr)]
        return cls(read_rockstar_files(files), simulation, device)

    @classmethod
    def from_subfind(cls, snap_nr: int, simulation=None, blocks=(
            "GroupPos", "Group_M_Crit200", "Group_R_Crit200", "GroupFirstSub",
            "SubhaloVmax"), device=None) -> "Halos":
        from ..io.gadget_hdf5 import GadgetSnapshot

        snap = GadgetSnapshot(snap_nr, simulation.dirs["sim"])
        cat = snap.group_catalog(blocks)
        if cat.get("n_groups", 0) and "SubhaloVmax" in cat and \
                "GroupFirstSub" in cat:
            first = np.asarray(cat["GroupFirstSub"], np.int64)
            # GroupFirstSub == -1 marks a group with no subhalos: NaN, not
            # the last subhalo's Vmax a negative index would wrap to
            vmax = cat["SubhaloVmax"][np.where(first >= 0, first, 0)]
            cat["SubhaloVmax"] = np.where(
                first >= 0, vmax, np.nan).astype(vmax.dtype)
        return cls(cat, simulation, device)

    @classmethod
    def from_file(cls, filename: str, simulation=None,
                  device=None) -> "Halos":
        return cls(columnar_h5.read_table(filename), simulation, device)

    @classmethod
    def from_dataframe(cls, df, simulation=None, device=None) -> "Halos":
        return cls({str(c): np.asarray(df[c]) for c in df.columns},
                   simulation, device)

    # ------------------------------------------------------------ statistics
    def get_rockstar_stats(self, config_file, snap_nrs=None,
                           save: bool = True,
                           dm_particle_mass: float = DM_PARTICLE_MASS):
        return self._get_stats("rockstar", config_file, snap_nrs, save,
                               dm_particle_mass)

    def get_subfind_stats(self, config_file, snap_nrs=None,
                          save: bool = True,
                          dm_particle_mass: float = DM_PARTICLE_MASS):
        return self._get_stats("subfind", config_file, snap_nrs, save,
                               dm_particle_mass)

    def _get_stats(self, halofinder: str, config_file, snap_nrs, save,
                   dm_particle_mass):
        """Registry-driven dispatch in resolution order."""
        statistics = load_stats_config(config_file)
        for name in statistics:
            statistics[name]["results"] = {"bins": {}, "values": {}}
        order = self._sort_statistics(statistics)
        ns = _NAMESPACES[halofinder]
        if snap_nrs is None:
            snap_nrs = (list(self.sim.dir_nrs) if self.sim is not None
                        else [0])
        for snap_nr in snap_nrs:
            snapshot = self._load_snapshot(halofinder, snap_nr)
            # emptiness from the first array column (subfind catalogs also
            # carry scalars like n_groups / h)
            arrs = ([v for v in snapshot.values() if np.ndim(v) >= 1]
                    if snapshot is not None else [])
            if not arrs or not len(arrs[0]):
                continue
            resolution = 0
            for stat_name in order:
                if int(statistics[stat_name]["resolution"]) != resolution:
                    resolution = int(statistics[stat_name]["resolution"])
                    snapshot = self._filter_resolved(
                        halofinder, snapshot, resolution, dm_particle_mass)
                fct = getattr(ns, stat_name, None)
                if fct is None:
                    continue
                out = fct(snapshot, **statistics[stat_name].get("args", {}),
                          device=self.device)
                if stat_name == "histograms":
                    statistics[stat_name]["results"]["values"][
                        f"snap_{snap_nr}"] = out
                elif out[0] is not None:
                    statistics[stat_name]["results"]["bins"][
                        f"snap_{snap_nr}"] = out[0]
                    statistics[stat_name]["results"]["values"][
                        f"snap_{snap_nr}"] = out[1]
        if save:
            self._save_results(halofinder, statistics)
        self.statistics = statistics
        return statistics

    def _load_snapshot(self, halofinder, snap_nr):
        if self.data is not None:
            return dict(self.data)
        if halofinder == "rockstar":
            return read_rockstar_files(
                self.sim.files["halos"][str(snap_nr)])
        return Halos.from_subfind(snap_nr, self.sim).data

    @staticmethod
    def _filter_resolved(halofinder, snapshot, nr_particles,
                         dm_particle_mass):
        """Resolution cut m200 > N * m_dm."""
        min_mass = dm_particle_mass * nr_particles
        key = "m200c" if halofinder == "rockstar" else "Group_M_Crit200"
        if key not in snapshot:
            return snapshot
        mask = np.asarray(snapshot[key]) > min_mass
        n = mask.shape[0]
        return {k: (np.asarray(v)[mask] if np.ndim(v) >= 1
                    and len(v) == n else v)
                for k, v in snapshot.items()}

    @staticmethod
    def filter_nonzero_subfind_halos_size(snapshot):
        """Drop groups / subhalos with zero radius."""
        if "Group_R_Crit200" not in snapshot:
            return snapshot
        mask = np.asarray(snapshot["Group_R_Crit200"]) > 0
        n = mask.shape[0]
        return {k: (np.asarray(v)[mask] if np.ndim(v) >= 1
                    and len(v) == n else v)
                for k, v in snapshot.items()}

    @staticmethod
    def _sort_statistics(statistics) -> List[str]:
        res = [int(s["resolution"]) for s in statistics.values()]
        order = np.argsort(res)
        names = list(statistics.keys())
        return [names[i] for i in order]

    def _save_results(self, halofinder: str, statistics: dict):
        """Stats -> one columnar h5 table per statistic."""
        out_dir = (self.sim.dirs["sim"] if self.sim is not None else ".")
        for stat_name, stg in statistics.items():
            vals = stg["results"]["values"]
            if not vals:
                continue
            if stat_name == "histograms":
                for snap, hists in vals.items():
                    cols = {p: np.asarray(h) for p, h in hists.items()}
                    columnar_h5.write_table(
                        os.path.join(out_dir,
                                     f"rockstar_histograms_{snap}.h5"), cols)
                continue
            cols = {}
            for snap, b in stg["results"]["bins"].items():
                cols.setdefault("bin", np.asarray(b))
                cols[snap] = np.asarray(vals[snap])
            columnar_h5.write_table(
                os.path.join(out_dir, f"{halofinder}_{stat_name}.h5"), cols)

    # ------------------------------------------------------------- HOD mocks
    def _hod_columns(self, rvir_unit: float):
        """The HOD's halo columns as float32 tensors on the catalog's
        device: m200c, x, y, z, vx, vy, vz, r200c (kpc/h -> Mpc/h by
        rvir_unit) and the concentration r200c / rs."""
        d = self.data
        rs_col = d["rs"] if "rs" in d else d["Rs"]
        r200 = np.asarray(d["r200c"], np.float32) * rvir_unit
        conc = r200 / np.maximum(
            np.asarray(rs_col, np.float32) * rvir_unit, 1e-12)
        m = _column(d["m200c"], self.device)
        return [m] + [_column(a, m.device) for a in (
            d["x"], d["y"], d["z"], d["vx"], d["vy"], d["vz"], r200, conc)]

    def populate_hod(self, boxsize, params=None, key=0, max_sat: int = 16,
                     rvir_unit: float = 1e-3):
        """HOD galaxy mock from this (Rockstar-schema) catalog. Columns
        used: m200c [Msun/h], x/y/z [Mpc/h], vx/vy/vz [km/s], r200c
        (Rockstar kpc/h -> Mpc/h via rvir_unit), rs (concentration =
        r200c/rs). `key` is an int seed or a `torch.Generator` (on the
        catalog's device). Returns the compacted host catalog dict
        (ops.hod.compact_catalog)."""
        from ..ops import hod as hod_ops

        cols = self._hod_columns(rvir_unit)
        if isinstance(key, torch.Generator):
            gen = key
        else:
            gen = torch.Generator(device=cols[0].device).manual_seed(
                int(key))
        cat = hod_ops.hod_populate(
            gen, *cols, float(boxsize),
            params=hod_ops.HODParams() if params is None else params,
            max_sat=max_sat)
        return hod_ops.compact_catalog(cat)

    def populate_hod_from_draws(self, boxsize, has_cen, n_sat_raw, u, dirs,
                                gv_unit, max_sat: int = 16,
                                rvir_unit: float = 1e-3):
        """`populate_hod` after its random draws (as
        `ops.hod.hod_populate_from_draws` takes them: the JAX package's
        draws for parity)."""
        from ..ops import hod as hod_ops

        cols = self._hod_columns(rvir_unit)
        cat = hod_ops.hod_populate_from_draws(
            has_cen, n_sat_raw, u, dirs, gv_unit, *cols, float(boxsize),
            max_sat=max_sat, device=cols[0].device)
        return hod_ops.compact_catalog(cat)

    # --------------------------------------------------------------- queries
    def in_mass_range(self, min_mass: float, max_mass: float,
                      mass_key: str = "m200c") -> "Halos":
        """Catalog restricted to min_mass <= M <= max_mass (closed)."""
        m = np.asarray(self.data[mass_key])
        sel = (m >= min_mass) & (m <= max_mass)
        return Halos({k: np.asarray(v)[sel] for k, v in self.data.items()},
                     self.sim, self.device)

    def select_in_box(self, region, boxsize: float,
                      pos_keys=("x", "y", "z"),
                      periodic: bool = True) -> "Halos":
        """Catalog restricted to a sub-box, with periodic wrap when the
        region extends past [0, boxsize); positions in the result are in
        the region's frame."""
        pos = {p: np.asarray(self.data[p], np.float64).copy()
               for p in pos_keys}
        keep = np.ones(next(iter(pos.values())).size, bool)
        for ax, p in enumerate(pos_keys):
            lo, hi = region[2 * ax], region[2 * ax + 1]
            x = pos[p]
            if periodic and (lo < 0 or hi > boxsize):
                x = (x - lo) % boxsize + lo
                pos[p] = x
            keep &= (x >= lo) & (x < hi)
        out = {}
        for k, v in self.data.items():
            v = np.asarray(v)
            out[k] = (pos[k][keep] if k in pos else v[keep])
        return Halos(out, self.sim, self.device)

    def environment(self, env_grid, box, pos_keys=("x", "y", "z"),
                    outside_value: int = -1):
        """Cosmic-web environment tag per halo, sampled from an
        environment grid (numpy out)."""
        pos = tuple(np.asarray(self.data[p], np.float32) for p in pos_keys)
        return _host(hs_ops.halo_environment(
            pos, env_grid, box, outside_value=outside_value,
            device=self.device))

    def nearest_neighbours(self, pos_keys=("x", "y", "z"), k: int = 2):
        """k-NN distances within the catalog."""
        from scipy.spatial import cKDTree

        pos = np.stack([np.asarray(self.data[p]) for p in pos_keys], axis=-1)
        dist, idx = cKDTree(pos).query(pos, k=k)
        return dist[:, 1:], idx[:, 1:]

    def sort_by(self, column: str, order: str = "descending",
                relabel: bool = False):
        """Reorder the catalog by one column's values (stable; ties keep
        catalog order). relabel=True assigns new sequential ids in the
        sorted order. Entries whose length differs from the sort column
        are left untouched. Returns self for chaining."""
        if order not in ("ascending", "descending"):
            raise ValueError(f"order must be ascending/descending, "
                             f"got {order!r}")
        key = np.asarray(self.data[column])
        if order == "descending":
            # negate the dense rank: -key wraps unsigned ints and raises
            # on bools
            rank = np.unique(key, return_inverse=True)[1].astype(np.int64)
            perm = np.argsort(-rank, kind="stable")
        else:
            perm = np.argsort(key, kind="stable")
        n = key.shape[0]
        out = {}
        for k, v in self.data.items():
            arr = np.asarray(v)
            out[k] = arr[perm] if arr.ndim >= 1 and arr.shape[0] == n \
                else v
        if relabel and "id" in out:
            out["id"] = np.arange(n, dtype=np.asarray(out["id"]).dtype)
        self.data = out
        return self

    def neighbours_within(self, target_id: int, dmax=None,
                          extent=None, pos_keys=("theta1_deg", "theta2_deg"),
                          radius_key: str = "r200_deg"):
        """All catalog members within dmax of the row with id ==
        target_id (dmax defaults to its radius column, optionally scaled
        by extent). Returns (indices, distances) sorted by distance."""
        from scipy.spatial import cKDTree

        ids = np.asarray(self.data["id"])
        sel = np.nonzero(ids == target_id)[0]
        if sel.size == 0:
            raise KeyError(f"no catalog row with id == {target_id}")
        pos = np.stack([np.asarray(self.data[p]) for p in pos_keys],
                       axis=-1)
        if dmax is None:
            dmax = float(np.asarray(self.data[radius_key])[sel[0]])
        if extent is not None:
            dmax = dmax * extent
        idx = np.asarray(cKDTree(pos).query_ball_point(pos[sel[0]], dmax),
                         np.int64)
        dist = np.linalg.norm(pos[idx] - pos[sel[0]], axis=-1)
        order = np.argsort(dist)
        return idx[order], dist[order]
