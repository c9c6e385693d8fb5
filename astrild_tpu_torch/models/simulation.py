"""Simulation file model: discovery of numbered simulation outputs.

Port of astrild_tpu/models/simulation.py: the `Simulation` handle
(directory/file discovery by glob + regex id extraction) and the `Ecosmog`
particle-simulation handle, whose `density_fields` paints density and
velocity grids on the tensors' device (the native stand-in for the
reference astrild's DTFE shell-out), whose `to_gadget` writes a Gadget
binary snapshot and whose `compress_snapshot` transcribes RAMSES grav
files to columnar tables; and the `RayRamses` lightcone handle, which
merges per-CPU ray dumps, sums ray snapshots and builds halo lightcone
catalogs. The file paths are numpy on the host, as in the JAX package.
"""
from __future__ import annotations

import glob
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import as_host, default_device
from ..utils.cosmology import Cosmology

__all__ = ["Simulation", "Ecosmog", "RayRamses"]


class Simulation:
    """Base simulation handle; discovers numbered dirs/files on disk.

    `dirs` maps role -> path(s); `files[root]` is a sorted path list (or a
    {dir_nr: paths} dict when files live in numbered subdirectories);
    `file_nrs`/`dir_nrs` hold the extracted integer ids.
    """

    def __init__(self, dir_sim: str, dir_out: Optional[str] = None,
                 file_dsc: Dict[str, Optional[str]] = None,
                 dir_root: Optional[str] = None):
        file_dsc = file_dsc or {"root": None, "extension": None}
        if dir_out is None:
            dir_out = dir_sim
        self.dirs = {"sim": dir_sim, "out": dir_out}
        self.name = [e for e in dir_sim.split("/") if e][-1]
        self.file_dsc = file_dsc
        if dir_root is None:
            self.dir_root = "sim"
        else:
            self.dir_root = dir_root
            self.dir_nrs = self.get_dir_nrs(sort=True)
            self.dirs[dir_root] = self.get_dir_paths(None, dir_root)
        if file_dsc.get("root") is None:
            self.file_nrs = None
            self.files = {}
        else:
            self.file_nrs = self.get_file_nrs(file_dsc, self.dirs["sim"],
                                              "max", True)
            self.files = {
                file_dsc["root"]: self.get_file_paths(file_dsc,
                                                      self.dirs["sim"], "max")
            }
        self.dimensions = 3

    # ------------------------------------------------------------ discovery
    def _get_all_files(self, file_dsc, directory=None) -> List[str]:
        if directory is None:
            directory = self.dirs["sim"]
        # optional 'sep' overrides the root/number separator (sep='' for
        # names like root%05d.h5)
        sep = file_dsc.get("sep", "_")
        template = f"{directory}/{file_dsc['root']}{sep}*" \
                   f"{file_dsc['extension']}"
        return glob.glob(template)

    def get_file_nrs(self, file_dsc, directory=None, uniques="max",
                     sort: bool = False) -> np.ndarray:
        """Integer ids from filenames: when names carry several numbers,
        keep the column with the most (or fewest) unique values."""
        if directory is None:
            directory = self.dirs["sim"]
        files = self._get_all_files(file_dsc, directory)
        if len(files) == 0 and self.dir_root in self.dirs and isinstance(
                self.dirs[self.dir_root], list) and self.dirs[self.dir_root]:
            files = self._get_all_files(file_dsc, self.dirs[self.dir_root][0])
        if not files:
            return np.array([], int)
        ids = np.array(
            [re.findall(r"\d+", f.split("/")[-1]) for f in files]).astype(int)
        if ids.ndim == 2 and ids.shape[1] > 1:
            var = np.array([len(np.unique(c)) for c in ids.T])
            col = np.argmax(var) if uniques == "max" else np.argmin(var)
            ids = ids[:, col]
        else:
            ids = ids.reshape(-1)
        return np.sort(ids) if sort else ids

    def get_file_paths(self, file_dsc=None, directory=None, uniques="max"):
        """File paths sorted by id; falls back to a per-numbered-dir
        dict."""
        if file_dsc is None:
            file_dsc = self.file_dsc
        if directory is None:
            directory = self.dirs["sim"]
        files = self._get_all_files(file_dsc, directory)
        if len(files) == 0 and hasattr(self, "dir_nrs"):
            out = {}
            for dnr, d in zip(self.dir_nrs, self.dirs[self.dir_root]):
                fps = self._get_all_files(file_dsc, d)
                fids = self.get_file_nrs(file_dsc, d, uniques, sort=False)
                order = np.argsort(fids)
                out[str(dnr)] = [fps[i] for i in order]
            return out
        if len(files) > 1:
            fids = self.get_file_nrs(file_dsc, directory, uniques, sort=False)
            order = np.argsort(fids)
            files = [files[i] for i in order]
        return files

    def _get_all_paths(self, dir_root=None) -> List[str]:
        if dir_root is None:
            dir_root = self.dir_root
        dirs = glob.glob(os.path.join(self.dirs["sim"], dir_root + "_*"))
        return [p for p in dirs if "." not in os.path.basename(p)]

    def get_dir_nrs(self, dir_root=None, sort: bool = True) -> np.ndarray:
        if dir_root is None:
            dir_root = self.dir_root
        dirs = self._get_all_paths(dir_root)
        ids = np.array([int(re.findall(r"\d+", d.split("/")[-1])[0])
                        for d in dirs]) if dirs else np.array([], int)
        return np.sort(ids) if sort else ids

    def get_dir_paths(self, dir_ids, dir_root) -> List[str]:
        if dir_root is None:
            dir_root = self.dir_root
        if dir_ids is None:
            dirs = self._get_all_paths(dir_root)
            ids = self.get_dir_nrs(dir_root, sort=False)
            order = np.argsort(ids)
            return [dirs[i] for i in order]
        out = []
        root = dir_root if "_" in dir_root else dir_root + "_%03d"
        for di in dir_ids:
            d = os.path.join(self.dirs["sim"], root % di) + "/"
            if not os.path.isdir(d):
                raise FileNotFoundError(d)
            out.append(d)
        return out

    @staticmethod
    def remove_files(files: List[str]) -> None:
        for f in files:
            Path(f).unlink()


def _components(arr, device):
    """Flat (n,) float32 components (x, y, z) of an (n, 3) array or tensor
    or of a tuple of components; numpy input goes to `device` (the CUDA
    card by default, see `_device.default_device`), a tensor stays
    where it is unless `device` is given."""
    parts = arr if isinstance(arr, (tuple, list)) else [arr]
    if not all(isinstance(p, torch.Tensor) for p in parts):
        device = default_device(device)
    if isinstance(arr, (tuple, list)):
        comps = [torch.as_tensor(c) for c in arr]
    else:
        t = torch.as_tensor(arr)
        comps = [t[:, i] for i in range(t.shape[1])]
    return tuple(c.to(device=device, dtype=torch.float32) for c in comps)


class Ecosmog(Simulation):
    """ECOSMOG / Gadget particle-simulation handle.

    The reference astrild's external DTFE shell-out becomes native
    painting: `density_fields` estimates density (and optionally velocity)
    grids with CIC/TSC windows via ops.paint, on the device of the input
    tensors or, for numpy input, on the card (through the CUDA painter K2).
    """

    def __init__(self, config=None, dir_sim: str = ".", dir_out=None,
                 file_dsc=None, dir_root: Optional[str] = None,
                 boxsize: float = 500.0, domain_level: int = 512,
                 cosmo: Optional[Cosmology] = None):
        super().__init__(dir_sim, dir_out,
                         file_dsc or {"root": None, "extension": None},
                         dir_root)
        self.config = config
        self.boxsize = boxsize
        self.domain_level = domain_level
        self.npar = domain_level
        self.cosmo = cosmo or Cosmology()

    # ------------------------------------------------- native DTFE stand-in
    def density_fields(self, pos, vel=None, ngrid: Optional[int] = None,
                       window: str = "tsc", fields=("density",),
                       device=None):
        """Grid fields from particles.

        pos, vel: (n, 3) arrays or tensors, or tuples of flat (x, y, z)
        components. device: where numpy input is painted, by default the
        CUDA card (raises without one); tensors stay on their own device
        unless it is given.
        Returns {field: (ngrid,)*3 tensor (+component axis for velocity)}.
        """
        from ..ops import paint as paint_ops

        ngrid = ngrid or self.domain_level
        comps = _components(pos, device)
        out = {}
        rho = paint_ops.paint(comps, ngrid, self.boxsize, window=window)
        if "density" in fields:
            cell_vol = (self.boxsize / ngrid) ** 3
            out["density"] = rho / cell_vol
        if "velocity" in fields or "divergence" in fields:
            if vel is None:
                raise ValueError("the velocity and divergence fields need "
                                 "`vel`")
            denom = torch.clamp(rho, min=1e-12)
            vgrid = torch.stack(
                [paint_ops.paint(comps, ngrid, self.boxsize, weights=v,
                                 window=window) / denom
                 for v in _components(vel, comps[0].device)], dim=-1)
            if "velocity" in fields:
                out["velocity"] = vgrid
            if "divergence" in fields:
                # theta = div v (the DTFE 'divergence_a' quantity)
                from ..ops.map_transform import divergence

                out["divergence"] = divergence(
                    torch.movedim(vgrid, -1, 0), self.boxsize / ngrid)
        return out

    def to_gadget(self, path, pos, vel, ids=None, masses=None,
                  redshift: float = 0.0, snap_format: int = 2):
        """Write particles as a Gadget binary snapshot (io.gadget_binary);
        tensors are copied to the host first."""
        from ..io.gadget_binary import write_gadget

        def host(a):
            return a.detach().cpu().numpy() if isinstance(
                a, torch.Tensor) else a

        pos, vel, ids, masses = (host(a) for a in (pos, vel, ids, masses))
        if ids is None:
            ids = np.arange(len(pos), dtype=np.uint32)
        write_gadget(path, pos, vel, ids, self.boxsize, masses=masses,
                     redshift=redshift, omega_m=self.cosmo.Om0,
                     omega_l=self.cosmo.Ode0, hubble=self.cosmo.h,
                     snap_format=snap_format)
        return path

    def compress_snapshot(self, amr_levels, domain_level, fields,
                          snap_nrs=None, file_root: str = "grav",
                          dir_out=None, save: bool = True):
        """Transcribe grav_*.out????? F77 files of the numbered snapshot
        directories -> {snap_nr: {field: column}} (ghost rows dropped,
        lexicographic row order), each also written as a columnar h5
        `<root>_out<snap_nr:05d>.h5` unless `save` is False."""
        from ..io import columnar_h5, ramses

        levelmin, levelmax = min(amr_levels), max(amr_levels)
        results = {}
        for snap_nr, snap_dir in zip(self.dir_nrs, self.dirs[self.dir_root]):
            if snap_nrs is not None and snap_nr not in snap_nrs:
                continue
            files = glob.glob(
                os.path.join(snap_dir, f"{file_root}_{snap_nr:05d}.out?????"))
            if not files:
                continue
            data = ramses.read_grav_snapshot(files, fields, levelmin,
                                             levelmax, self.dimensions)
            if save:
                fname = file_root.split("_")[0] + "_out%05d.h5" % snap_nr
                columnar_h5.write_table(
                    os.path.join(dir_out or self.dirs["sim"], fname), data)
            results[int(snap_nr)] = data
        return results


class RayRamses(Simulation):
    """Ray-Ramses lightcone handle: per-CPU ray dumps, their sums over
    snapshots, and the halos inside the ray-tracing box."""

    def __init__(self, config=None, dir_sim: str = ".", dir_out=None,
                 file_dsc=None, dir_root: Optional[str] = None,
                 opening_angle: float = 20.0, npix: int = 8192,
                 cosmo: Optional[Cosmology] = None):
        super().__init__(dir_sim, dir_out,
                         file_dsc or {"root": None, "extension": None},
                         dir_root)
        self.config = config
        self.opening_angle = opening_angle
        self.npix = npix
        self.cosmo = cosmo or Cosmology()

    def compress_snapshot(self, columns, dir_out=None, save: bool = True):
        """Merge per-CPU ray ascii outputs into one column dict per ray
        snapshot, applying the shear sign corrections at compress time;
        each is also written as a columnar h5 unless `save` is False.
        Returns {snap_nr: {column: array}}."""
        from ..io import columnar_h5
        from ..io.rays import SHEAR_CORRECTIONS, merge_ray_outputs

        results = {}
        root = self.file_dsc["root"]
        # group by the SNAPSHOT id = first number group in the name.
        # self.file_nrs cannot be used here: __init__ extracts it with
        # uniques='max', which on per-CPU outputs like
        # Ray_maps_output00001.out00064 picks the CPU column (the
        # reference re-extracts with uniques='min' before compressing)
        snap_ids = sorted({int(re.findall(r"\d+", os.path.basename(p))[0])
                           for p in self.files[root]})
        for snap_nr in snap_ids:
            paths = [p for p in self.files[root]
                     if int(re.findall(r"\d+", os.path.basename(p))[0])
                     == snap_nr]
            data = merge_ray_outputs(paths, columns)
            for col, fac in SHEAR_CORRECTIONS.items():
                if col in data:
                    data[col] = data[col] * fac
            if save:
                fname = f"Ray_maps_output{snap_nr:05d}.h5"
                columnar_h5.write_table(
                    os.path.join(dir_out or self.dirs["sim"], fname), data)
            results[int(snap_nr)] = data
        return results

    def sum_snapshots(self, columns, snap_nrs=None, z_range=None,
                      redshifts=None):
        """Sum ray maps over selected snapshots.

        Selection mirrors the reference's `_get_box_and_ray_nrs`:
        `snap_nrs` restricts to specific ray
        snapshot numbers; `z_range=(zmin, zmax)` keeps snapshots with
        zmin < z < zmax (open interval, as the reference), where z comes
        from `redshifts`, a {snap_nr: z} mapping (the reference read it
        from ray_snapshot_info.h5). With neither, all snapshots sum
        (complete lightcone). Box-spanning multi-dir sums live in
        `SimulationCollection.sum_raytracing_snapshots`.
        """
        from ..io import columnar_h5

        root = self.file_dsc["root"]
        paths = list(self.files[root])
        nrs = [int(n) for n in self.file_nrs] if self.file_nrs is not None \
            else list(range(len(paths)))
        if snap_nrs is not None:
            keep = set(int(s) for s in as_host(snap_nrs).reshape(-1))
            paths = [p for p, n in zip(paths, nrs) if n in keep]
            nrs = [n for n in nrs if n in keep]
        if z_range is not None:
            if redshifts is None:
                raise ValueError(
                    "z_range selection needs `redshifts` ({snap_nr: z})")
            zlo, zhi = min(z_range), max(z_range)
            sel = [zlo < float(redshifts[n]) < zhi for n in nrs]
            paths = [p for p, s in zip(paths, sel) if s]
        if not paths:
            raise ValueError("sum_snapshots: selection matched no "
                             f"snapshots (snap_nrs={snap_nrs}, "
                             f"z_range={z_range})")
        total = None
        for path in paths:
            data = columnar_h5.read_table(path)
            if total is None:
                total = {c: np.array(data[c]) for c in columns}
            else:
                for c in columns:
                    total[c] = total[c] + data[c]
        return total

    def Dc_to_redshift(self, dc):
        """Comoving distance -> redshift (the handle's Cosmology)."""
        return self.cosmo.redshift_at_comoving_distance(dc)

    def find_halos_in_raytracing_box(self, ecosmog, snapdist, box_nr: int,
                                     boxsize: float, halofinder: str =
                                     "rockstar"):
        """Halo lightcone catalog across this box's ray snapshots, via
        models.lightcone (numpy columns)."""
        from .halos import Halos
        from .lightcone import (halo_lightcone_catalog,
                                merge_lightcone_catalogs)

        boxdist = snapdist[-1]
        parts = []
        ray_nrs = np.unique(self.file_nrs)[:-1]
        for ray_nr in ray_nrs:
            snap_nr = int(ray_nr)
            if halofinder == "rockstar":
                halos = Halos.from_rockstar(snap_nr, ecosmog)
                cat = halos.data
                if cat is None or not len(next(iter(cat.values()))):
                    continue
                pos = np.stack([cat["x"], cat["y"], cat["z"]], -1)
                vel = np.stack([cat["vx"], cat["vy"], cat["vz"]], -1)
                m200 = np.asarray(cat["m200c"])
                r200 = np.asarray(cat["r200c"])
                extra = {k: cat[k] for k in ("Rs",) if k in cat}
            else:
                halos = Halos.from_subfind(snap_nr, ecosmog)
                cat = halos.data
                if not cat.get("n_groups", 0):
                    continue
                pos = np.asarray(cat["GroupPos"])
                vel = np.asarray(cat.get("GroupVel",
                                         np.zeros_like(pos)))
                m200 = np.asarray(cat["Group_M_Crit200"])
                r200 = np.asarray(cat["Group_R_Crit200"])
                extra = None
            parts.append(halo_lightcone_catalog(
                pos, vel, m200, r200, boxsize, boxdist,
                (snapdist[ray_nr - 1], snapdist[ray_nr]),
                self.opening_angle, self.npix, box_nr=box_nr,
                snap_nr=snap_nr, ray_nr=int(ray_nr),
                extra_columns=extra))
        return merge_lightcone_catalogs(parts)
