"""Simulation file model: discovery of numbered simulation outputs.

Port of astrild_tpu/models/simulation.py: the `Simulation` handle
(directory/file discovery by glob + regex id extraction) and the `Ecosmog`
particle-simulation handle, whose `density_fields` paints density and
velocity grids on the tensors' device (the native stand-in for the
reference astrild's DTFE shell-out) and whose `to_gadget` writes a Gadget
binary snapshot. `Ecosmog.compress_snapshot` and `RayRamses` need the
RAMSES and ray readers, which are not ported yet: they raise
`NotImplementedError`.
"""
from __future__ import annotations

import glob
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import default_device
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

    def compress_snapshot(self, *args, **kwargs):
        """Transcribes grav_*.out????? RAMSES files to columnar h5 in the
        JAX package; needs io/ramses, which is not ported yet."""
        raise NotImplementedError(
            "Ecosmog.compress_snapshot needs the RAMSES reader (io/ramses), "
            "which astrild_tpu_torch does not port yet")


class RayRamses(Simulation):
    """Ray-Ramses lightcone handle: needs the ray readers (io/rays), which
    are not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "RayRamses needs the ray readers (io/rays), which "
            "astrild_tpu_torch does not port yet")
