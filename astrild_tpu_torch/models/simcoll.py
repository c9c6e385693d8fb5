"""SimulationCollection: the array-of-simulations layer.

Port of astrild_tpu/models/simcoll.py. Per-simulation stat files are
combined into labeled Datasets (core.dataset); lightcone ray maps are
summed with optional source-plane redshift shifting via the lensing-kernel
ratio. The file paths are numpy on the host, as in the JAX package; PyYAML
is imported inside `from_file`, h5py inside the table readers.

`stack_for_devices` stacks per-simulation tensors into one batch along a
leading axis, on the tensors' device (numpy leaves go to the card unless
`device` says otherwise).
"""
from __future__ import annotations

import glob
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import as_x32
from ..core.dataset import Dataset
from ..io import columnar_h5
from ..utils.cosmology import Cosmology
from .simulation import Ecosmog, RayRamses

__all__ = ["SimulationCollection"]


class SimulationCollection:
    """A dict of Ecosmog/RayRamses simulations + their snapshot-info table."""

    def __init__(self, config: Dict[str, np.ndarray], sims: Dict[str, object],
                 cosmo: Optional[Cosmology] = None):
        self.config = config  # columns incl. _index_0 (sim nr), _index_1 (snap)
        self.sim = sims
        self.sim_nrs = np.arange(1, len(sims) + 1)
        self.cosmo = cosmo or Cosmology()

    # ------------------------------------------------------------- creation
    @classmethod
    def from_file(cls, config_file: str, config_file_df: str
                  ) -> "SimulationCollection":
        """Build from the YAML sim registry + snapshot-info h5."""
        import yaml

        with open(config_file) as f:
            sims_args = yaml.safe_load(f)
        # reads both this engine's columnar layout and pandas fixed stores
        config = columnar_h5.read_table(config_file_df, key="df")
        sims = {}
        for idx, (name, args) in enumerate(sims_args.items()):
            sub = cls._config_rows(config, idx + 1)
            init = dict(args.get("init", {}))
            init.pop("config", None)
            if args["type"] == "particles":
                sims[name] = Ecosmog(config=sub, **init)
            elif args["type"] == "rays":
                sims[name] = RayRamses(config=sub, **init)
            else:
                raise ValueError(f"unknown simulation type {args['type']}")
        return cls(config, sims)

    @staticmethod
    def _config_rows(config: Dict[str, np.ndarray], sim_nr: int
                     ) -> Dict[str, np.ndarray]:
        """Rows of the snapshot-info table belonging to one simulation."""
        if "_index_0" not in config:
            return config
        sel = np.asarray(config["_index_0"]) == sim_nr
        return {k: np.asarray(v)[sel] for k, v in config.items()
                if not k.startswith("_index") or k == "_index_1"}

    # ------------------------------------------------------------ redshifts
    def _find_common_z(self) -> np.ndarray:
        z = None
        for nr in self.sim_nrs:
            zi = self._config_rows(self.config, nr)["redshift"]
            z = zi if z is None else np.intersect1d(z, zi)
        return z[z < 2.3]

    @staticmethod
    def _find_nearest(array, value):
        array = np.asarray(array)
        return array[np.abs(array - value).argmin()]

    # -------------------------------------------------------------- compress
    def compress_stats(self, file_dsc, dir_out, snap_nrs=None, z_nrs=None,
                       a_nrs=None, zmatch: bool = False,
                       labels={"x": "bin", "y": "value"}) -> Dataset:
        """Combine per-sim stat tables into a (box, redshift, bin)
        Dataset."""
        if zmatch:
            z_nrs = self._find_common_z()
        elif z_nrs is not None:
            za = self.config["redshift"]
            z_nrs = [self._find_nearest(za, z) for z in z_nrs]
        elif a_nrs is not None:
            za = self.config["redshift"]
            z_nrs = [self._find_nearest(za, 1 / a - 1) for a in a_nrs]
        first_sim = self.sim[list(self.sim)[0]]
        first_tab = columnar_h5.read_table(
            os.path.join(first_sim.dirs["sim"], f"{file_dsc['root']}.h5"))
        bins = first_tab["bin"] if "bin" in first_tab else np.arange(
            len(next(iter(first_tab.values()))))
        y = np.zeros((len(self.sim_nrs), len(z_nrs), len(bins)))
        snaps = np.zeros((len(self.sim_nrs), len(z_nrs)))
        for si, name in enumerate(self.sim):
            rows = self._config_rows(self.config, si + 1)
            tab = columnar_h5.read_table(
                os.path.join(self.sim[name].dirs["sim"],
                             f"{file_dsc['root']}.{file_dsc['extension']}"))
            for zi, z in enumerate(z_nrs):
                order = np.argsort(np.abs(rows["redshift"] - z))
                snap_nr = int(np.asarray(rows["_index_1"])[order[0]])
                snaps[si, zi] = snap_nr
                y[si, zi, :] = tab[f"snap_{snap_nr}"]
        ds = Dataset(
            data_vars={labels["y"]: (("box", "redshift", labels["x"]), y)},
            coords={"box": self.sim_nrs, "redshift": np.asarray(z_nrs),
                    labels["x"]: np.asarray(bins),
                    "snapshot": (("box", "redshift"), snaps)},
        )
        self._stats_to_file(ds, file_dsc, dir_out)
        return ds

    def compress_histograms(self, file_dsc, dir_out) -> Dataset:
        """Combine per-sim histogram tables into a (box, property, bin)
        Dataset of counts."""
        first_sim = self.sim[list(self.sim)[0]]
        tab0 = columnar_h5.read_table(
            os.path.join(first_sim.dirs["sim"], f"{file_dsc['root']}.h5"))
        props = [k for k in tab0 if k != "bin"]
        nbin = len(tab0[props[0]])
        y = np.zeros((len(self.sim_nrs), len(props), nbin))
        for si, name in enumerate(self.sim):
            tab = columnar_h5.read_table(
                os.path.join(self.sim[name].dirs["sim"],
                             f"{file_dsc['root']}.{file_dsc['extension']}"))
            for pi, p in enumerate(props):
                y[si, pi, :] = tab[p]
        ds = Dataset(
            data_vars={"count": (("box", "property", "bin"), y)},
            coords={"box": self.sim_nrs, "property": np.asarray(props),
                    "bin": tab0.get("bin", np.arange(nbin))},
        )
        self._stats_to_file(ds, file_dsc, dir_out)
        return ds

    def _stats_to_file(self, ds: Dataset, file_dsc, dir_out):
        Path(dir_out).mkdir(parents=True, exist_ok=True)
        ds.to_hdf5(os.path.join(dir_out, f"{file_dsc['root']}.stats.h5"))

    # ----------------------------------------------------------- ray maps
    def _kernel_function(self, x, x_s):
        """Lensing efficiency g = (x_s - x) x / x_s."""
        return (x_s - x) * x / x_s

    def _translate_redshift(self, quantity, z_near, z_far, z_src,
                            z_src_shift):
        """Source-plane shift by lensing-kernel ratio. `quantity` is numpy
        or a tensor; a tensor stays on its device and is divided by a
        tensor."""
        chi = self.cosmo.comoving_distance
        x_far = float(chi(z_far))
        x_near = float(chi(z_near))
        x_src = float(chi(z_src))
        x_src_shift = float(chi(max(z_far, z_src_shift))) if z_far > \
            z_src_shift else float(chi(z_src_shift))
        x_mid = 0.5 * (x_far + x_near)
        den = self._kernel_function(x_mid, x_src)
        if isinstance(quantity, torch.Tensor):
            den = torch.tensor(den, dtype=quantity.dtype,
                               device=quantity.device)
        return quantity * self._kernel_function(x_mid, x_src_shift) / den

    def sum_raytracing_snapshots(self, dir_out=None, columns=("kappa_2",),
                                 columns_z_shift=("kappa_2",),
                                 integration_range={"box": [0], "ray": [],
                                                    "z": None},
                                 z_src=None, z_src_shift=None, rm_ray=None,
                                 save: bool = False):
        """Sum ray maps over the lightcone: `integration_range` picks boxes,
        rays or a redshift range (box [0] is the whole lightcone); with
        `z_src_shift` each ray map is moved to that source plane by the
        lensing-kernel ratio."""
        box_ray = self._box_and_ray_nrs(integration_range, rm_ray)
        total = None
        for si, name in enumerate(self.sim):
            box_nr = self._boxnr_from_simname(name)
            if box_nr not in box_ray:
                continue
            sim = self.sim[name]
            rows = self._config_rows(self.config, box_nr)
            root = sim.file_dsc["root"]
            for ray_nr in box_ray[box_nr]:
                # glob loosely, then match the file's trailing numeric id
                # EXACTLY: a suffix pattern like f"*{ray_nr}.h5" also
                # matches 00015/00025 for ray 5 and glob order is
                # filesystem-dependent — the wrong shell would be summed
                # silently (and double-counted at ray 15)
                ext = sim.file_dsc["extension"]
                matches = []
                for pat in (f"{root}_*.{ext}", f"{root}*.{ext}"):
                    cands = sorted(glob.glob(
                        os.path.join(sim.dirs["sim"], pat)))
                    matches = [
                        p for p in cands
                        if (lambda nums: nums
                            and int(nums[-1]) == int(ray_nr))(
                            re.findall(r"\d+",
                                       os.path.basename(p).rsplit(".", 1)[0]))
                    ]
                    if matches:
                        break
                if not matches:
                    continue
                data = columnar_h5.read_table(matches[0])
                if z_src_shift is not None:
                    sel = np.asarray(rows["_index_1"]) == ray_nr
                    z_here = float(np.asarray(rows["redshift"])[sel][0])
                    znext_sel = np.asarray(rows["_index_1"]) == ray_nr + 1
                    z_next = (float(np.asarray(rows["redshift"])[znext_sel][0])
                              if znext_sel.any() else z_here)
                    for col in columns_z_shift:
                        data[col] = self._translate_redshift(
                            np.asarray(data[col]), z_here, z_next, z_src,
                            z_src_shift)
                if total is None:
                    total = {c: np.array(data[c]) for c in columns}
                else:
                    for c in columns:
                        total[c] = total[c] + np.asarray(data[c])
        if save and dir_out is not None:
            Path(dir_out).mkdir(parents=True, exist_ok=True)
            zmin = float(np.min(self.config["redshift"]))
            zmax = float(np.max(self.config["redshift"]))
            columnar_h5.write_table(
                os.path.join(dir_out, f"Ray_maps_zrange_{zmin:.2f}_{zmax:.2f}.h5"),
                total)
        return total

    def _box_and_ray_nrs(self, integration_range, rm_ray=None):
        """{box_nr: [ray_nr, ...]} of an integration range, less rm_ray."""
        out: Dict[int, List[int]] = {}
        if integration_range.get("z"):
            zlo, zhi = integration_range["z"]
            idx0 = np.asarray(self.config["_index_0"])
            idx1 = np.asarray(self.config["_index_1"])
            zz = np.asarray(self.config["redshift"])
            sel = (zlo <= zz) & (zz <= zhi)
            for b, r in zip(idx0[sel], idx1[sel]):
                out.setdefault(int(b), []).append(int(r))
        elif integration_range.get("ray"):
            for b in range(1, len(self.sim) + 1):
                out[b] = list(integration_range["ray"])
        else:
            boxes = integration_range.get("box")
            # reference convention: box [0] means
            # "integrate over the whole light-cone" — box ids start at 1,
            # so treating 0 literally matched nothing and returned None
            if not boxes or list(boxes) == [0]:
                boxes = range(1, len(self.sim) + 1)
            for b in boxes:
                rows = self._config_rows(self.config, b)
                out[int(b)] = [int(x) for x in np.asarray(rows["_index_1"])]
        if rm_ray:
            for b, rays in rm_ray.items():
                for r in rays:
                    if int(b) in out and int(r) in out[int(b)]:
                        out[int(b)].remove(int(r))
        return out

    @staticmethod
    def _boxnr_from_simname(simname) -> int:
        if isinstance(simname, int):
            return simname
        return int(re.findall(r"\d+", simname)[0])

    # -------------------------------------------------- device-batch bridge
    def stack_for_devices(self, loader, sim_names=None, device=None):
        """Stack per-sim tensors into one leading-axis batch.

        loader: callable(sim) -> tensor (or array, or number) or a nested
        dict / tuple / list of them. Each leaf position is stacked with
        torch.stack on the leaves' device; numpy and number leaves go to
        `device`, by default the CUDA card, with the JAX package's device
        dtypes (float64 as float32, int64 as int32; `_device.as_x32`).
        """
        names = sim_names or list(self.sim)
        return _stack([loader(self.sim[n]) for n in names], device)


def _stack(parts, device):
    """torch.stack of each leaf position of the same-shaped trees
    `parts` (dicts, tuples, lists and namedtuples; None stays None)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in parts], device) for k in first}
    if isinstance(first, (tuple, list)):
        items = [_stack([p[i] for p in parts], device)
                 for i in range(len(first))]
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return type(first)(*items)
        return type(first)(items)
    return torch.stack([as_x32(p, device) for p in parts])
