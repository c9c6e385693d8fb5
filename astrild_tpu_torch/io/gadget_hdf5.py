"""Gadget/Arepo HDF5 snapshot + SubFind group-catalog reader.

numpy copy of astrild_tpu/io/gadget_hdf5.py (the JAX package cannot be
imported without JAX), the equivalent of the reference astrild's
utils/read_hdf5.py: multi-file snapshots, h-unit conversion (lengths /h,
masses *1e10/h, with its length/mass block lists, including
modified-gravity blocks), SubFind group catalogs, and MPI-style file
striding (`partition=[nfiles, rank]`) for per-process sharded reads.
h5py is imported inside the functions that need it.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["GadgetSnapshot", "LENGTH_BLOCKS", "MASS_BLOCKS", "unit_factor",
           "list_snapshot_contents", "list_group_catalog_contents"]

LENGTH_BLOCKS = {
    "GroupCM", "Coordinates", "GroupPos", "Group_R_Crit200",
    "Group_R_Vir_Eff", "Group_R_Crit500", "Group_R_Mean200",
    "Group_R_TopHat200", "SubhaloCM", "SubhaloHalfmassRad",
    "SubhaloHalfmassRadType", "SubhaloPos", "SubhaloVmaxRad",
}
MASS_BLOCKS = {
    "Masses", "ModifiedGravityEffectiveMass", "SubhaloMass",
    "SubhaloMassInHalfRad", "SubhaloMassInHalfRadType",
    "SubhaloMassInMaxRad", "SubhaloMassInMaxRadType", "SubhaloMassInRad",
    "SubhaloMassInRadType", "SubhaloMassType", "Group_M_Crit200",
    "Group_M_Vir_Eff", "Group_M_In_R_Vir_Eff", "Group_M_Eff_In_R_Crit200",
    "Group_M_Eff_In_R_Crit500", "Group_M_Crit500", "Group_M_Mean200",
    "Group_M_TopHat200", "Group_MassType_Crit200",
    "Group_MassType_Crit500", "Group_MassType_Mean200",
    "Group_MassType_TopHat200", "GroupMass", "GroupMassType",
}


def unit_factor(block: str, h: float) -> float:
    """Code units -> (Mpc/h-free) units: lengths /h [Mpc], masses 1e10/h
    [Msun] (read_hdf5.py:263-313)."""
    if block in LENGTH_BLOCKS:
        return 1.0 / h
    if block in MASS_BLOCKS:
        return 1.0e10 / h
    return 1.0


class GadgetSnapshot:
    """One (possibly multi-file) Gadget/Arepo HDF5 snapshot.

    Usage mirrors the reference's read_hdf5.snapshot:
      snap = GadgetSnapshot(snapnum, directory)
      snap.read(["Coordinates", "Velocities"], parttype=[1])
      snap.group_catalog(["Group_M_Crit200", "GroupPos"])
      snap.data["Coordinates"], snap.cat["GroupPos"], snap.header["redshift"]
    """

    def __init__(self, snapnum: int, directory: str,
                 snapbase: str = "snap_", dirbase: str = "snapdir_",
                 check_total_particle_number: bool = False):
        import h5py

        self.snapnum = int(snapnum)
        self.directory = str(directory)
        s3 = str(self.snapnum).zfill(3)
        candidates = [
            os.path.join(directory, f"{dirbase}{s3}", f"{snapbase}{s3}"),
            os.path.join(directory, f"{snapbase}{s3}"),
        ]
        self.snapname = None
        self._candidates = candidates  # for error messages
        for cand in candidates:
            if os.path.isfile(cand + ".hdf5") or os.path.isfile(cand + ".0.hdf5"):
                self.snapname = cand
                break
        self.data: Dict[str, np.ndarray] = {}
        self.cat: Dict[str, np.ndarray] = {}
        self.header: Dict[str, object] = {}
        if self.snapname is not None:
            first = (self.snapname + ".hdf5"
                     if os.path.isfile(self.snapname + ".hdf5")
                     else self.snapname + ".0.hdf5")
            with h5py.File(first, "r") as f:
                for k, v in f["Header"].attrs.items():
                    self.header[k] = v
            self.header["hubble"] = float(self.header.get("HubbleParam", 1.0))
            self.header["redshift"] = float(self.header.get("Redshift", 0.0))
            self.header["boxsize"] = float(self.header.get("BoxSize", 0.0))
            self.header["time"] = float(self.header.get("Time", 1.0))

    # ------------------------------------------------------------ file list
    def _files(self, base: str, partition=(1, 0)) -> List[str]:
        if os.path.isfile(base + ".hdf5"):
            files = [base + ".hdf5"]
        else:
            files = sorted(glob.glob(base + ".*.hdf5"),
                           key=lambda p: int(p.split(".")[-2]))
        nstripe, rank = partition
        return files[rank::nstripe]

    # -------------------------------------------------------------- blocks
    def read(self, blocklist: Sequence[str], parttype=(1,),
             partition=(1, 0)) -> Dict[str, np.ndarray]:
        """Read particle blocks with unit conversion; returns self.data."""
        import h5py

        if self.snapname is None:
            # __init__ stays lenient (catalog-only directories construct a
            # snapshot handle for group_catalog alone), but a read without
            # files must name the paths it tried, not die later on a
            # KeyError('hubble') / TypeError(None + str)
            raise FileNotFoundError(
                "no snapshot files found; tried "
                + ", ".join(c + "(.0).hdf5" for c in self._candidates))
        if isinstance(blocklist, str):
            blocklist = [blocklist]
        if isinstance(parttype, int):
            parttype = [parttype] if parttype != -1 else None
        h = self.header["hubble"]
        chunks: Dict[str, List[np.ndarray]] = {b: [] for b in blocklist}
        for fname in self._files(self.snapname, partition):
            with h5py.File(fname, "r") as f:
                pts = (parttype if parttype is not None else
                       [int(k[8:]) for k in f.keys()
                        if k.startswith("PartType")])
                for block in blocklist:
                    fac = unit_factor(block, h)
                    for pt in pts:
                        g = f.get(f"PartType{pt}")
                        if g is None:
                            continue
                        if block in g:
                            arr = np.asarray(g[block])
                            # fac == 1.0 blocks (IDs, counts, velocities)
                            # keep their native dtype: an unconditional
                            # multiply promoted uint64 ParticleIDs to
                            # float64 (exactness lost above 2^53)
                            chunks[block].append(arr if fac == 1.0
                                                 else arr * fac)
                        elif block == "Masses":
                            # constant-mass species from the MassTable
                            n = f["Header"].attrs["NumPart_ThisFile"][pt]
                            m = f["Header"].attrs["MassTable"][pt]
                            chunks[block].append(
                                np.full(int(n), m * fac, np.float64))
        for block in blocklist:
            if chunks[block]:
                self.data[block] = np.concatenate(chunks[block], axis=0)
        return self.data

    # ------------------------------------------------------- group catalog
    def group_catalog(self, hdf5_names=("GroupPos", "Group_M_Crit200",
                                        "Group_R_Crit200"),
                      dirname: str = "groups_",
                      filename: str = "fof_subhalo_tab_",
                      path: str = "", partition=(1, 0)) -> Dict[str, np.ndarray]:
        """Read SubFind group/subhalo blocks ('G*' from Group/, 'S*' from
        Subhalo/), unit converted; returns self.cat
        (read_hdf5.py:553-744)."""
        import h5py

        s3 = str(self.snapnum).zfill(3)
        if not path:
            path = os.path.join(self.directory, f"{dirname}{s3}",
                                f"{filename}{s3}")
        h = self.header.get("hubble")
        chunks: Dict[str, List[np.ndarray]] = {n: [] for n in hdf5_names}
        files = self._files(path, partition)
        if not files:
            raise FileNotFoundError(f"no group catalog at {path}*")
        for fname in files:
            with h5py.File(fname, "r") as f:
                if h is None:
                    # catalog-only directories (no snapshot files): take h
                    # from the catalog's own header rather than silently
                    # assuming 1.0 (a 1/h ~ 1.5x unit error on masses)
                    attrs = f["Header"].attrs
                    if "HubbleParam" not in attrs:
                        raise KeyError(
                            f"{fname}: no snapshot header was read and the "
                            "catalog header lacks HubbleParam — cannot "
                            "determine h for unit conversion")
                    h = float(attrs["HubbleParam"])
                if not self.cat:
                    for k, v in f["Header"].attrs.items():
                        self.cat[k] = v
                    self.cat["n_groups"] = f["Header"].attrs.get(
                        "Ngroups_Total", 0)
                    self.cat["n_subgroups"] = f["Header"].attrs.get(
                        "Nsubgroups_Total", 0)
                for name in hdf5_names:
                    grp = "Group" if name[0] == "G" else "Subhalo"
                    g = f.get(grp)
                    if g is None or name not in g:
                        continue
                    arr = np.asarray(g[name])
                    fac = unit_factor(name, h)
                    # keep native dtypes for fac == 1.0 blocks (GroupLen,
                    # GroupFirstSub, ... are ints used for indexing)
                    chunks[name].append(arr if fac == 1.0 else arr * fac)
        for name in hdf5_names:
            if chunks[name]:
                self.cat[name] = np.concatenate(chunks[name], axis=0)
        return self.cat

    def fast_group_catalog(self, hdf5_names=("GroupPos", "Group_M_Crit200",
                                             "Group_R_Crit200"),
                           dirname: str = "groups_",
                           filename: str = "fof_subhalo_tab_",
                           path: str = "",
                           partition=(1, 0)) -> Dict[str, np.ndarray]:
        """Name-parity alias for the reference's single-pass preallocated
        reader (read_hdf5.py:650-744). group_catalog already reads each
        block once per file and concatenates — the separate fast path is
        unnecessary here, so this delegates.
        """
        return self.group_catalog(hdf5_names=hdf5_names, dirname=dirname,
                                  filename=filename, path=path,
                                  partition=partition)


def _hdf5_contents(files) -> Dict[str, tuple]:
    """{group/dataset: (total_shape, dtype)} across a striped file set,
    concatenating the first axis over files."""
    import h5py

    out: Dict[str, tuple] = {}

    def visit(name, obj):
        if not hasattr(obj, "shape"):
            return
        if name in out:
            shape, dt = out[name]
            if len(shape) == 0 or len(obj.shape) == 0:
                # scalar datasets don't concatenate; keep the first
                return
            out[name] = ((shape[0] + obj.shape[0],) + tuple(obj.shape[1:]),
                         dt)
        else:
            out[name] = (tuple(obj.shape), obj.dtype)

    for fname in files:
        with h5py.File(fname, "r") as f:
            f.visititems(visit)
    return out


def list_snapshot_contents(snapnum: int, directory: str, **kw) -> Dict[str, tuple]:
    """Inventory of a snapshot's HDF5 datasets: {path: (shape, dtype)}.

    Counterpart of read_hdf5.py show_snapshot_contents — but returns the
    inventory (aggregated over all snapshot files) instead of printing.
    """
    snap = GadgetSnapshot(snapnum, directory, **kw)
    if snap.snapname is None:
        raise FileNotFoundError(
            f"no snapshot files at {snap._candidates}")
    return _hdf5_contents(snap._files(snap.snapname))


def list_group_catalog_contents(snapnum: int, directory: str,
                                dirname: str = "groups_",
                                filename: str = "fof_subhalo_tab_",
                                ) -> Dict[str, tuple]:
    """Inventory of a SubFind group catalog's datasets
    (read_hdf5.py show_group_catalog_contents, returning not printing)."""
    snap = GadgetSnapshot(snapnum, directory)
    s3 = str(snapnum).zfill(3)
    path = os.path.join(directory, f"{dirname}{s3}", f"{filename}{s3}")
    files = snap._files(path)
    if not files:
        raise FileNotFoundError(f"no group catalog at {path}*")
    return _hdf5_contents(files)
