"""Spectra pipeline classes: PowerSpectrum3D, Bispectrum3D, Bispectrum2D,
PowMes, AngularPowerSpectrum, and the theory facades LinearPowerSpectrum
and LinearAngularPowerSpectrum.

Port of astrild_tpu/models/power.py. The facades take numpy arrays or
tensors and return numpy arrays, as the JAX facades do. Tensors stay on
their own device unless `device=` is given; numpy input goes to `device=`,
by default the CUDA card (as the JAX facades put it on the default
device). With no card and no `device=` numpy input raises: pass
`device="cpu"` to run on the CPU. `AngularPowerSpectrum.from_healpix` and
`to_skyhealpix` go through SkyHealpix.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..io import columnar_h5
from ..ops import bispectrum as bs_ops
from ..ops import linear_power as lp_ops
from ..ops import paint as paint_ops
from ..ops import power as power_ops
from ..utils.cosmology import Cosmology

__all__ = ["PowerSpectrum3D", "Bispectrum3D", "Bispectrum2D", "PowMes",
           "AngularPowerSpectrum", "LinearPowerSpectrum",
           "LinearAngularPowerSpectrum"]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class PowerSpectrum3D:
    """Auto & cross P(k) of gridded or point-set quantities."""

    def __init__(self, sim_type: str = "particles", simulation=None,
                 window: str = "cic", device=None):
        self.sim = simulation
        self.sim_type = sim_type
        self.window = window
        self.device = device
        self._dist_cache = {}

    def _t(self, arr) -> torch.Tensor:
        return as_tensor(arr, self.device)

    # ------------------------------------------------------- low-level API
    def power_from_grid(self, grid, boxsize: float, nbins: int = 0,
                        shotnoise: float = 0.0, window=None):
        res = power_ops.auto_power(self._t(grid), boxsize, nbins=nbins,
                                   window=window, shotnoise=shotnoise)
        return _host(res.k), _host(res.power)

    def multipoles_from_grid(self, grid, boxsize: float, nbins: int = 0,
                             ells=(0, 2, 4), los: int = 2,
                             shotnoise: float = 0.0, window=None):
        """Redshift-space multipoles P_ell(k). Returns (k, {ell: P})."""
        res = power_ops.auto_power_multipoles(
            self._t(grid), boxsize, nbins=nbins, ells=tuple(ells), los=los,
            shotnoise=shotnoise, window=window)
        return (_host(res.k),
                {ell: _host(res.p_ell[i]) for i, ell in enumerate(ells)})

    def power_from_points(self, pos, boxsize: float, ngrid: int,
                          weights=None, nbins: int = 0,
                          interlaced: bool = False, method: str = "window",
                          mesh=None):
        """Point set -> paint -> P(k).

        method='fast' uses the folded fine-grid NGP estimator
        (ops.power.auto_power_fast, through the windowed deposit K1 on a
        card); 'window' paints with self.window (cic/tsc) and deconvolves.

        mesh: a mesh of parallel.make_mesh runs the distributed estimator
        (parallel.power.make_distributed_auto_power_fast, K1 in the shard
        body on a card) over this rank's block of the particles: (n, 3) or
        a flat (x, y, z) component tuple, numpy input and tensors alike
        put on the mesh's device. Only method='fast' distributes (the
        factory is cached per (mesh, ngrid, boxsize, nbins)).
        """
        if mesh is not None:
            return self._power_on_mesh(pos, boxsize, ngrid, weights, nbins,
                                       method, mesh)
        pos = self._t(pos)
        w = None if weights is None else self._t(weights).to(pos.device)
        if method == "fast":
            res = power_ops.auto_power_fast(pos, ngrid, boxsize,
                                            nbins=nbins, weights=w)
            return _host(res.k), _host(res.power)
        painted = paint_ops.paint(pos, ngrid, boxsize, weights=w,
                                  window=self.window, interlaced=interlaced)
        if interlaced:
            g, g2 = painted
        else:
            g, g2 = painted, None
        if weights is None:
            shot = boxsize ** 3 / pos.shape[0]
        else:
            # weighted tracers: V sum(w^2)/(sum w)^2
            wh = np.asarray(_host(w), np.float64)
            shot = boxsize ** 3 * float(np.sum(wh * wh)) \
                / max(float(np.sum(wh)) ** 2, 1e-300)
        res = power_ops.auto_power(g, boxsize, nbins=nbins,
                                   window=self.window, grid_shifted=g2,
                                   interlaced=interlaced, shotnoise=shot)
        return _host(res.k), _host(res.power)

    def _power_on_mesh(self, pos, boxsize, ngrid, weights, nbins, method,
                       mesh):
        if method != "fast":
            raise ValueError("mesh= requires method='fast' (the "
                             "distributed estimator is the folded "
                             "fine-NGP path)")
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        missing = {"sim", "x", "y"} - set(names)
        if missing:
            raise ValueError(
                "the distributed P(k) factory shards over the "
                "('sim', 'x', 'y') axes; this mesh lacks "
                f"{sorted(missing)} (axes: {names}) — "
                "build it with parallel.make_mesh")
        from ..parallel.power import make_distributed_auto_power_fast

        key = (mesh, ngrid, float(boxsize), nbins or ngrid // 2)
        fn = self._dist_cache.get(key)
        if fn is None:
            fn = make_distributed_auto_power_fast(mesh, ngrid, boxsize,
                                                  nbins or ngrid // 2)
            self._dist_cache[key] = fn
        res = fn(pos, weights)  # the factory puts both on the mesh
        return _host(res.k), _host(res.power)

    def _as_grid(self, arr, boxsize: float, ngrid: int):
        """(grid, painted): paint a point set with self.window, pass a
        pre-gridded field through."""
        if arr.ndim == 2 and arr.shape[1] == 3:
            g = paint_ops.paint(self._t(arr), ngrid, boxsize,
                                window=self.window)
            return g, True
        return self._t(arr), False

    def cross_power_from_grids(self, grid1, grid2, boxsize: float,
                               nbins: int = 0, window=None):
        """Window-compensated cross spectrum of two grids."""
        g1 = self._t(grid1)
        res = power_ops.cross_power(g1, self._t(grid2).to(g1.device),
                                    boxsize, nbins=nbins, window=window)
        return _host(res.k), _host(res.power)

    # ---------------------------------------------------------- file-driven
    def compute(self, quantities: Sequence[str], file_dsc: Sequence[dict],
                snap_nrs=None, dir_out=None, save: bool = True,
                boxsize: Optional[float] = None, ngrid: int = 256):
        """File-driven pipeline: reads h5 point sets or npy grids per
        snapshot; auto (1 file_dsc) or cross (2 file_dscs)."""
        boxsize = boxsize or getattr(self.sim, "boxsize", 500.0)
        fd = dict(file_dsc[0])
        path = fd.pop("path", None)
        snap_ids = self.sim.get_file_nrs(fd, path, "max")
        paths1 = self.sim.get_file_paths(fd, path, "max")
        paths2 = None
        if len(file_dsc) > 1:
            fd2 = dict(file_dsc[1])
            path2 = fd2.pop("path", None)
            paths2 = self.sim.get_file_paths(fd2, path2, "max")
        if snap_nrs is not None:
            keep = [i for i, s in enumerate(np.sort(snap_ids))
                    if s in set(snap_nrs)]
            paths1 = [paths1[i] for i in keep]
            if paths2 is not None:
                paths2 = [paths2[i] for i in keep]
            snap_ids = [np.sort(snap_ids)[i] for i in keep]
        pk = {"k": {}, "P": {}}
        for i, (snap_nr, p1) in enumerate(
                zip(np.sort(np.asarray(snap_ids)), paths1)):
            arr = self._read_data(p1, quantities)
            if paths2 is not None:
                # point sets are painted with self.window, whose aliasing
                # is then deconvolved; pre-gridded fields carry no
                # assignment window
                g1, painted1 = self._as_grid(arr, boxsize, ngrid)
                g2, painted2 = self._as_grid(
                    self._read_data(paths2[i], quantities), boxsize, ngrid)
                win = self.window if (painted1 and painted2) else None
                k, P = self.cross_power_from_grids(g1, g2, boxsize,
                                                   window=win)
            elif arr.ndim == 2 and arr.shape[1] == 3:
                k, P = self.power_from_points(arr, boxsize, ngrid)
            else:
                k, P = self.power_from_grid(arr, boxsize)
            pk["k"][f"snap_{snap_nr}"] = k
            pk["P"][f"snap_{snap_nr}"] = P
        if save and dir_out and pk["k"]:
            os.makedirs(dir_out, exist_ok=True)
            cols = {"k": next(iter(pk["k"].values()))}
            cols.update(pk["P"])
            columnar_h5.write_table(
                os.path.join(dir_out, f"pk_{'_'.join(quantities)}.h5"), cols)
        return pk

    def _read_data(self, path: str, quantities) -> np.ndarray:
        """h5 point set (x,y,z columns) -> positions; npy -> grid."""
        if path.endswith(".npy"):
            return np.load(path)
        cols = columnar_h5.read_table(path)
        return np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)


class Bispectrum3D:
    """B(k1,k2,k3) estimator over all shell triples (ops.bispectrum)."""

    @staticmethod
    def compute(grid, boxsize: float, nbins: int = 8, m_min: float = 1.0,
                m_max=None, device=None):
        res = bs_ops.bispectrum_3d(as_tensor(grid, device), boxsize,
                                   nbins=nbins, m_min=m_min, m_max=m_max)
        return {k: _host(v) for k, v in res._asdict().items()}

    @staticmethod
    def from_points(pos, boxsize: float, ngrid: int, nbins: int = 8,
                    window: str = "cic", device=None):
        grid = paint_ops.paint(as_tensor(pos, device), ngrid, boxsize,
                               window=window)
        return Bispectrum3D.compute(grid, boxsize, nbins=nbins)


class PowMes:
    """Reader for POWMES output files. The estimator itself is replaced by
    PowerSpectrum3D."""

    @staticmethod
    def read_pk_file(path, boxsize: float):
        """POWMES .ascii table: columns (i, P(i), ...) with k = i * 2pi/L;
        returns (k, P)."""
        tab = np.loadtxt(path, comments="#", ndmin=2)
        k = tab[:, 0] * 2.0 * np.pi / boxsize
        return k, tab[:, 1]

    @staticmethod
    def to_table(paths: Dict[int, str], boxsize: float, dir_out=None):
        cols = {}
        for snap, p in paths.items():
            k, P = PowMes.read_pk_file(p, boxsize)
            cols.setdefault("k", k)
            cols[f"snap_{snap}"] = P
        if dir_out:
            columnar_h5.write_table(os.path.join(dir_out, "powmes_pk.h5"),
                                    cols)
        return cols

    @staticmethod
    def align_lin_nonlin(lin, nonlin, k, band=(1e-2, 1e-1)):
        """Additive offset aligning a nonlinear P(k) to the linear one at
        large scales: the linear spectrum's first (largest-scale) value
        minus the nonlinear band average over k in `band` [h/Mpc]. Add the
        returned offset to `nonlin`."""
        lin = np.asarray(lin)
        nonlin = np.asarray(nonlin)
        k = np.asarray(k)
        sel = (band[0] < k) & (k < band[1])
        if not sel.any():
            raise ValueError(f"no modes inside the k band {band}")
        return lin[0] - np.mean(nonlin[sel])


class AngularPowerSpectrum:
    """Cl estimators on flat-sky maps (numpy out); maps are placed as
    `ops.angular_power.cl_flat_sky` places them."""

    @staticmethod
    def from_array(img, opening_angle_deg: float, nbins: int = 50,
                   device=None):
        from ..ops import angular_power as ap_ops

        ell, cl = ap_ops.cl_flat_sky(img, opening_angle_deg, nbins=nbins,
                                     device=device)
        return _host(ell), _host(cl)

    @staticmethod
    def from_skymap(skymap, on: str = "orig", nbins: int = 50):
        return AngularPowerSpectrum.from_array(
            skymap._layer(on), skymap.opening_angle, nbins=nbins)

    @staticmethod
    def from_shear(gamma1, gamma2, opening_angle_deg: float,
                   nbins: int = 50, device=None):
        """(ell, Cl_EE, Cl_BB) from flat-sky shear maps (Kaiser-Squires
        E/B rotation; B is the post-Born / systematics null channel)."""
        from ..ops import angular_power as ap_ops

        ell, ee, bb = ap_ops.cl_shear_eb(gamma1, gamma2, opening_angle_deg,
                                         nbins=nbins, device=device)
        return _host(ell), _host(ee), _host(bb)

    @staticmethod
    def to_flat_map(ells, cls_vals, npix: int, opening_angle_deg: float,
                    rnd_seed: int = 0, device=None):
        """Gaussian realization of a Cl table on an (npix, npix) map, from
        a `torch.Generator` seeded with rnd_seed on `device` (by default
        the CUDA card): another realization than the JAX package's PRNG
        key of the same seed. Returns numpy."""
        from ..ops import angular_power as ap_ops

        gen = torch.Generator(device=default_device(device)).manual_seed(
            int(rnd_seed))
        return _host(ap_ops.cl_to_flat_map(gen, ells, cls_vals, npix,
                                           opening_angle_deg))

    @staticmethod
    def from_healpix(skyhealpix, lmax: int, of: str = "orig",
                     niter: int = 3):
        """(ell, Cl) of a full-sky SkyHealpix layer (native SHT
        analysis)."""
        cl = skyhealpix.anafast(lmax, of=of, niter=niter)
        return np.arange(cl.shape[0]), cl

    @staticmethod
    def to_skyhealpix(cls_vals, nside: int, quantity: str = "kappa_2",
                      lmax=None, rnd_seed: int = 0, device=None):
        """Gaussian full-sky realization of a Cl table as a SkyHealpix
        (SkyHealpix.from_Cl_array: a `torch.Generator` seeded with
        rnd_seed on `device`, by default the CUDA card)."""
        from .skyhealpix import SkyHealpix

        return SkyHealpix.from_Cl_array(cls_vals, quantity, nside,
                                        lmax=lmax, rnd_seed=rnd_seed,
                                        device=device)


class LinearPowerSpectrum:
    """Theory P(k) (EH98), its Kaiser multipoles, halofit / halo-model
    P(k) and the linear ISW source power; numpy out. k given as numpy goes
    to `device`, by default the CUDA card (it raises without one); a
    tensor keeps its device."""

    def __init__(self, cosmo=None, device=None):
        self.cosmo = cosmo or Cosmology()
        self.device = device
        self._amp = lp_ops.normalization(self.cosmo)

    def _k(self, k):
        return k if isinstance(k, torch.Tensor) else as_tensor(k,
                                                              self.device)

    def P_dd(self, k, z=0.0):
        return _host(lp_ops.linear_power(self._k(k), self.cosmo, z=z,
                                         amplitude=self._amp))

    def P_dpdp(self, z, k):
        return _host(lp_ops.p_dpdp(self._k(k), z, self.cosmo,
                                   amplitude=self._amp))

    def growth_functions(self, z):
        return (float(self.cosmo.growth_factor(z)),
                float(self.cosmo.growth_rate(z)))

    def kaiser_multipoles(self, k, z=0.0, bias: float = 1.0):
        """Linear Kaiser (P0, P2, P4) theory anchor for RSD clustering."""
        return tuple(_host(p) for p in lp_ops.kaiser_multipoles(
            self._k(k), self.cosmo, z=z, bias=bias, amplitude=self._amp))

    def P_nl(self, k, z=0.0, method: str = "halofit"):
        """Nonlinear P(k): 'halofit' (Takahashi+12) or 'halomodel'
        (1h+2h, ops/halo_model.py)."""
        if method == "halofit":
            return _host(lp_ops.nonlinear_power(
                self._k(k), self.cosmo, z=z, amplitude=self._amp))
        if method == "halomodel":
            from ..ops.halo_model import halo_model_power

            _, _, pt = halo_model_power(self._k(k), self.cosmo, z=z,
                                        amplitude=self._amp)
            return _host(pt)
        raise ValueError(f"unknown nonlinear method {method!r}")


class LinearAngularPowerSpectrum:
    """Linear ISW Cl_TT via Limber (`ops.angular_power.cl_isw_limber`),
    and the linear convergence Cl; numpy out, computed on `device`, by
    default the CUDA card (it raises without one)."""

    def __init__(self, ell_range, z_range, cosmo=None, device=None):
        self._ell_range = np.asarray(ell_range, float)
        self._z_range = np.asarray(z_range, float)
        self.cosmo = cosmo or Cosmology()
        self.device = device
        self._C_tt = None
        self._outdated = True

    @property
    def ells(self):
        return self._ell_range

    @property
    def Cl(self):
        if self._outdated:
            self.compute_C_tt()
        return self._C_tt

    def compute_C_tt(self):
        from ..ops import angular_power as ap_ops

        self._C_tt = _host(ap_ops.cl_isw_limber(
            self._ell_range, self.cosmo,
            z_min=float(self._z_range.min()),
            z_max=float(self._z_range.max()), device=self.device))
        self._outdated = False
        return self._C_tt

    def compute_C_kappa(self, z_source: float = 1.0):
        """Linear convergence Cl via Limber (the theory anchor for measured
        kappa spectra)."""
        from ..ops import angular_power as ap_ops

        return _host(ap_ops.cl_kappa_limber(
            self._ell_range, self.cosmo, z_source=z_source,
            device=self.device))


class Bispectrum2D:
    """Equilateral B(ell) of flat-sky maps (numpy out); a numpy map goes to
    `device`, by default the CUDA card (it raises without one)."""

    @staticmethod
    def compute(skymap_or_img, opening_angle_deg: Optional[float] = None,
                nbins: int = 16, on: str = "orig", device=None):
        if hasattr(skymap_or_img, "_layer"):  # a SkyArray
            img = skymap_or_img._layer(on)
            opening_angle_deg = skymap_or_img.opening_angle
        else:
            img = as_tensor(skymap_or_img, device)
        ell, b, ntri = bs_ops.bispectrum_2d_equilateral(
            img, opening_angle_deg, nbins=nbins)
        return _host(ell), _host(b), _host(ntri)
