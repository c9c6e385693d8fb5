"""SkyHealpix: full-sky map container on the native RING pixelization.

Port of astrild_tpu/models/skyhealpix.py: ray columns binned into maps,
a flat projection to SkyArray, rotation, masks, and the spherical-harmonic
statistics: synthesis and analysis through ops/sht.py up to lmax 512 and
through the table-free ops/sht_large.py above (that threshold picks the
estimator as well as the speed: the scan path's analysis switches to CG
above lmax 2*nside), spin-2 shear from convergence, its E/B spectra and
curved-sky xi_pm; the spherical multiplane ray trace of density shells and
the lensing of a CMB map by the deflection of a convergence map.

Layers are tensors on one device: numpy input goes to `device`, by
default the CUDA card (it raises without one: pass device="cpu"); a tensor
keeps its device. Methods return numpy, as the JAX facade does. The
interpolation stencil of `to_skyarray` and `rotate` is the host float64
numpy of utils/healpix.py; the gather runs on the layer's device. Random
skies draw from a `torch.Generator` seeded with `rnd_seed` (another
realization than the JAX package's key of the same seed).

Not ported yet: the m-sharded transforms (`mesh=`) wait for the
distributed layer, ROADMAP queue 1 item 9.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..utils import healpix as hp

__all__ = ["SkyHealpix"]

# Above this lmax the O(lmax^2 * nring) Legendre table of ops/sht.py is
# impractical; dispatch to the table-free ops/sht_large.py path instead.
_TABLE_LMAX_LIMIT = 512

_ITEM_9 = ("SkyHealpix: mesh= (the m-sharded transforms) is not ported "
           "yet: it waits for the distributed layer, ROADMAP.md queue 1 "
           "item 9")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _sht_backend(nside: int, lmax: int):
    """(synfast, anafast, smoothing) picked by scale: the table path up to
    lmax 512, the scan path (ring FFTs + on-device Legendre recursion) up
    to lmax = 4*nside - 1 above (the belt alias fold covers healpy's
    routine lmax = 3*nside - 1)."""
    from ..ops import sht, sht_large

    if lmax <= _TABLE_LMAX_LIMIT:
        return sht.synfast, sht.anafast, sht.smoothing
    if lmax > 4 * nside - 1:
        raise ValueError(f"lmax={lmax} > 4*nside-1={4 * nside - 1} is not "
                         "supported by the large-lmax SHT path")
    return (sht_large.synfast_large, sht_large.anafast_large,
            sht_large.smoothing_large)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(_ITEM_9)


class SkyHealpix:
    """Named full-sky layers at a fixed nside (RING)."""

    def __init__(self, hpmap, quantity: str = "kappa_2", device=None):
        self.data: Dict[str, torch.Tensor] = {
            "orig": as_tensor(hpmap, device)}
        self.quantity = quantity
        self.nside = hp.npix2nside(self.data["orig"].shape[-1])

    @property
    def device(self) -> torch.device:
        return self.data["orig"].device

    def _layer(self, name: str) -> torch.Tensor:
        """A layer as a tensor (a numpy layer set by the caller goes to the
        map's device)."""
        v = self.data[name]
        return v if isinstance(v, torch.Tensor) else as_tensor(v, self.device)

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_columns(cls, cols, quantity: str, nside: int,
                     theta1_key: str = "the_co", theta2_key: str = "phi_co",
                     device=None) -> "SkyHealpix":
        """Bin (theta, phi) samples into a map: ang2pix + per-pixel mean on
        the host (float64); pixels without a sample are UNSEEN. Angles in
        radians."""
        theta = _host(cols[theta1_key])
        phi = _host(cols[theta2_key])
        vals = _host(cols[quantity])
        pix = hp.ang2pix_ring(nside, theta, phi)
        npix = hp.nside2npix(nside)
        ssum = np.bincount(pix, weights=vals, minlength=npix)
        cnt = np.bincount(pix, minlength=npix)
        out = np.full(npix, hp.UNSEEN)
        good = cnt > 0
        out[good] = ssum[good] / cnt[good]
        return cls(out, quantity, device)

    from_dataframe = from_columns

    @classmethod
    def from_array(cls, hpmap, quantity: str = "kappa_2",
                   device=None) -> "SkyHealpix":
        return cls(hpmap, quantity, device)

    @classmethod
    def from_file(cls, map_file: str, quantity: str = "kappa_2",
                  nside: Optional[int] = None, convert_unit: bool = True,
                  device=None) -> "SkyHealpix":
        """Load a full-sky map from .h5 (ray-sample columns, binned to
        nside) or .npy (pixel array); the fits branch is healpy-only and
        not supported."""
        ext = map_file.rsplit(".", 1)[-1]
        if ext == "h5":
            from ..io import columnar_h5
            from ..utils.constants import C_LIGHT_KMS

            cols = dict(columnar_h5.read_table(map_file))
            if nside is None:
                raise ValueError("nside is required for .h5 ray samples")
            if convert_unit and quantity in cols:
                cols[quantity] = np.asarray(cols[quantity]) / C_LIGHT_KMS ** 2
            return cls.from_columns(cols, quantity, nside, device=device)
        if ext == "npy":
            return cls.from_array(np.load(map_file), quantity, device)
        raise ValueError(f"unsupported map file format: {ext}")

    @classmethod
    def from_Cl_array(cls, cl_array, quantity: str, nside: int,
                      lmax: Optional[int] = None, rnd_seed: int = 0,
                      device=None) -> "SkyHealpix":
        """Gaussian random sky from an angular power spectrum (healpy
        synfast's role) on `device`, drawn from a `torch.Generator` seeded
        with rnd_seed: the table path up to lmax 512, the scan path
        above."""
        cl = _host(cl_array).astype(np.float64)
        if lmax is not None:
            cl = cl[: lmax + 1]
        synfast, _, _ = _sht_backend(nside, cl.shape[0] - 1)
        gen = torch.Generator(device=default_device(device)).manual_seed(
            int(rnd_seed))
        return cls(synfast(gen, cl, nside), quantity)

    @classmethod
    def from_Cl_file(cls, cl_file: str, quantity: str, nside: int,
                     lmax: Optional[int] = None, key: Optional[str] = None,
                     rnd_seed: int = 0, device=None) -> "SkyHealpix":
        """A Gaussian sky of a .npy or .npz[key] Cl table."""
        ext = cl_file.rsplit(".", 1)[-1]
        if ext == "npy":
            cl = np.load(cl_file)
        elif ext == "npz":
            cl = np.load(cl_file)[key]
        else:
            raise ValueError(f"unsupported Cl file format: {ext}")
        return cls.from_Cl_array(cl, quantity, nside, lmax=lmax,
                                 rnd_seed=rnd_seed, device=device)

    create_cmb = from_Cl_array

    @classmethod
    def from_density_shells(cls, shells, chis, dchis, chi_s, omega_m,
                            scale_factors=None, quantity: str = "kappa_2",
                            device=None) -> "SkyHealpix":
        """Full-sky Born convergence from HEALPix density-contrast shells
        (nshell, npix): ops.lensing.born_convergence's plane sum, which is
        shape-agnostic, on the shells' device."""
        from ..ops import lensing

        shells = as_tensor(shells, device)
        dev = shells.device
        a = None if scale_factors is None else as_tensor(scale_factors, dev)
        kappa = lensing.born_convergence(
            shells, as_tensor(chis, dev), as_tensor(dchis, dev), chi_s,
            omega_m, scale_factors=a)
        return cls(kappa, quantity)

    @classmethod
    def from_multiplane_shells(cls, shells, chis, dchis, chi_s, omega_m,
                               lmax: Optional[int] = None,
                               scale_factors=None,
                               quantity: str = "kappa_2",
                               device=None) -> "SkyHealpix":
        """Full-sky post-Born ray tracing through HEALPix density shells
        (ops.lightcone_sphere.multiplane_raytrace_healpix) on the shells'
        device: the traced kappa is the map, gamma1 / gamma2 / omega (the
        image rotation) land in .data. Takes one scalar chi_s; for
        tomography call the function with the chi_s array."""
        from ..ops import lightcone_sphere as lcs

        if np.ndim(_host(chi_s)) != 0:
            raise ValueError(
                "from_multiplane_shells builds ONE SkyHealpix and takes "
                "a scalar chi_s; for tomography call "
                "ops.lightcone_sphere.multiplane_raytrace_healpix with "
                "the chi_s array (leading nsrc axis on its outputs) and "
                "wrap each source's maps yourself")
        out = lcs.multiplane_raytrace_healpix(
            shells, chis, dchis, chi_s, omega_m, lmax=lmax,
            scale_factors=scale_factors, device=device)
        sky = cls(out["kappa"], quantity)
        for k in ("gamma1", "gamma2", "omega"):
            sky.data[k] = out[k]
        return sky

    # ------------------------------------------------------------- geometry
    def _interp(self, layer: torch.Tensor, theta, phi) -> torch.Tensor:
        """Bilinear 4-neighbour values of a layer at (theta, phi): the host
        stencil, gathered on the layer's device."""
        pix, wgt = hp.get_interp_weights(self.nside, theta, phi)
        pix = torch.from_numpy(pix).to(layer.device)
        wgt = torch.from_numpy(wgt).to(device=layer.device,
                                       dtype=layer.dtype)
        return (layer[pix] * wgt).sum(0)

    def to_skyarray(self, opening_angle_deg: float, npix: int,
                    center_theta_phi=(np.pi / 2, 0.0), of: str = "orig"):
        """Gnomonic-like projection onto a flat npix^2 grid around a
        center; the SkyArray's layer stays on this map's device."""
        from .skymap import SkyArray

        t0, p0 = center_theta_phi
        half = np.deg2rad(opening_angle_deg) / 2.0
        d = np.linspace(-half, half, npix)
        dt, dp = np.meshgrid(d, d, indexing="ij")
        theta = t0 + dt
        phi = p0 + dp / np.maximum(np.sin(np.clip(theta, 1e-6, np.pi - 1e-6)),
                                   1e-6)
        vals = self._interp(self._layer(of), theta, phi).reshape(npix, npix)
        return SkyArray.from_array(vals, opening_angle_deg, self.quantity)

    def rotate(self, rot, of: str = "orig") -> np.ndarray:
        """Rotate a layer: `rot` is a 3x3 rotation matrix or a
        healpy-Rotator-style (a1, a2, a3) Euler-angle tuple in degrees
        (Z-Y-X order); bilinear resampling (utils/healpix.rotate_map's
        source positions); stores '<of>_rot'."""
        rot = np.asarray(rot, float)
        if rot.shape == (3,):
            rot = hp.euler_matrix_zyx(*rot)
        ipix = np.arange(hp.nside2npix(self.nside))
        theta, phi = hp.pix2ang_ring(self.nside, ipix)
        # sample the original map at the inversely-rotated positions
        ts, ps = hp.vec2ang(hp.ang2vec(theta, phi) @ rot)
        out = self._interp(self._layer(of), ts, ps)
        self.data[of + "_rot"] = out
        return _host(out)

    def create_mask(self, theta_range=None, phi_range=None,
                    of: str = "orig") -> np.ndarray:
        """Boolean mask of pixels inside the given angular ranges (stored
        as the 'mask' layer)."""
        ipix = np.arange(hp.nside2npix(self.nside))
        theta, phi = hp.pix2ang_ring(self.nside, ipix)
        mask = np.ones(len(ipix), bool)
        if theta_range is not None:
            mask &= (theta >= theta_range[0]) & (theta <= theta_range[1])
        if phi_range is not None:
            mask &= (phi >= phi_range[0]) & (phi <= phi_range[1])
        self.data["mask"] = torch.from_numpy(mask).to(self.device)
        return mask

    def add_mask(self, on: str = "orig", theta_range=None,
                 phi_range=None) -> np.ndarray:
        """Store '<on>_mask': the layer with masked pixels set to UNSEEN
        (healpy's hp.ma as an explicit sentinel)."""
        if "mask" not in self.data or theta_range is not None \
                or phi_range is not None:
            self.create_mask(theta_range=theta_range, phi_range=phi_range)
        mask = self._layer("mask").to(torch.bool)
        out = torch.where(mask, self._layer(on), hp.UNSEEN)
        self.data[on + "_mask"] = out
        return _host(out)

    # ------------------------------------------------------------ harmonics
    def smoothing(self, fwhm_rad: float, lmax: Optional[int] = None,
                  of: str = "orig") -> np.ndarray:
        """Harmonic-space Gaussian smoothing (hp.smoothing parity); stores
        '<of>_smooth'. lmax defaults to healpy's 3*nside - 1 on the table
        path, else 2*nside."""
        if lmax is not None:
            L = lmax
        elif 3 * self.nside - 1 <= _TABLE_LMAX_LIMIT:
            L = 3 * self.nside - 1
        else:
            L = 2 * self.nside
        _, _, smoothing = _sht_backend(self.nside, L)
        out = smoothing(self._layer(of), fwhm_rad, L)
        self.data[of + "_smooth"] = out
        return _host(out)

    def anafast(self, lmax: int, of: str = "orig", niter: int = 3,
                mesh=None, ax: str = "x",
                method: Optional[str] = None) -> np.ndarray:
        """Angular power spectrum of a layer (native SHT analysis; `method`
        applies to the m-sharded path only, which is not ported)."""
        _no_mesh(mesh)
        _, anafast, _ = _sht_backend(self.nside, lmax)
        return _host(anafast(self._layer(of), lmax, niter=niter))

    def shear_from_kappa(self, lmax: Optional[int] = None,
                         of: str = "orig", niter: int = 3, mesh=None,
                         ax: str = "x"):
        """Full-sky spherical Kaiser-Squires forward: store 'gamma1' /
        'gamma2' layers from a convergence layer by spin-2 synthesis of
        E_lm = sqrt((l+2)(l-1)/(l(l+1))) kappa_lm; the table paths up to
        lmax 512, the scan paths above. Returns them as numpy."""
        from ..ops import sht, sht_large, sht_spin, sht_spin_large

        _no_mesh(mesh)
        L = lmax if lmax is not None else min(2 * self.nside, 512)
        kappa = self._layer(of)
        if L <= _TABLE_LMAX_LIMIT:
            k_re, k_im = sht.analyze(kappa, self.nside, L, niter=niter)
        else:
            k_re, k_im = sht_large.analyze_large(kappa, self.nside, L,
                                                 niter=niter)
        e_re, e_im = sht_spin.kappa_alm_to_shear_alm(k_re, k_im)
        z = torch.zeros_like(e_re)
        if L <= _TABLE_LMAX_LIMIT:
            g1, g2 = sht_spin.synthesize_spin2(e_re, e_im, z, z,
                                               self.nside, L)
        else:
            g1, g2 = sht_spin_large.synthesize_spin2_large(
                e_re, e_im, z, z, self.nside, L)
        self.data["gamma1"] = g1
        self.data["gamma2"] = g2
        return _host(g1), _host(g2)

    def shear_eb_spectra(self, lmax: Optional[int] = None,
                         g1: str = "gamma1", g2: str = "gamma2",
                         niter: int = 3):
        """(Cl_EE, Cl_BB, Cl_EB) of stored shear layers by spin-2 analysis
        (B is the post-Born / systematics null channel)."""
        from ..ops import sht_spin, sht_spin_large

        L = lmax if lmax is not None else min(2 * self.nside, 512)
        fn = (sht_spin.anafast_spin2 if L <= _TABLE_LMAX_LIMIT
              else sht_spin_large.anafast_spin2_large)
        return tuple(_host(c) for c in fn(
            self._layer(g1), self._layer(g2), L, niter=niter))

    def shear_xi_pm(self, theta_arcmin, lmax: Optional[int] = None,
                    niter: int = 3, g1: str = "gamma1",
                    g2: str = "gamma2"):
        """Curved-sky (xi_plus, xi_minus)(theta) of stored shear layers:
        spin-2 analysis to (C_EE, C_BB), then the exact Wigner-d transform
        (ops.shear_2pt.xi_pm_from_cl_curved, host float64)."""
        from ..ops.shear_2pt import xi_pm_from_cl_curved

        ce, cb, _ = self.shear_eb_spectra(lmax=lmax, g1=g1, g2=g2,
                                          niter=niter)
        th = np.asarray(theta_arcmin, np.float64) * np.pi / 180.0 / 60.0
        return xi_pm_from_cl_curved(ce, th, cl_b=cb)

    # ----------------------------------------------------------- arithmetic
    def sum_of_maps(self, map1: str, map2: str) -> None:
        self.data[f"{map1}_{map2}"] = self._layer(map1) + self._layer(map2)

    def arithmetic_operation_with(self, other_map, on: str = "orig",
                                  operation: str = "add") -> np.ndarray:
        ops = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
               "div": torch.div}
        out = ops[operation](self._layer(on),
                             as_tensor(other_map, self.device))
        self.data[f"{on}_{operation}"] = out
        return _host(out)

    # ---------------------------------------------------------- CMB lensing
    def lens_cmb_from_kappa(self, cmb_map, kappa_map,
                            lmax: Optional[int] = None) -> np.ndarray:
        """Lens a CMB map by the deflection field of a convergence map:
        kappa -> alm -> the spin-1 gradient synthesis of psi -> the
        bilinear remap (`lens_cmb_by_deflection`), on the map's device.

        lmax defaults to 2*nside. The kappa analysis is the plain adjoint
        (niter 0, unbiased at L <= 2*nside) on the table path up to lmax
        512 and on the scan path above; beyond 2*nside it is the scan
        path's CG solve (Jacobi overshoots there, and the plain adjoint
        leaves the deflection biased at ell > 2*nside). The deflection
        synthesis takes the table path up to lmax 512, the scan path
        above."""
        from ..ops import sht, sht_large, sht_spin, sht_spin_large

        L = 2 * self.nside if lmax is None else lmax
        kappa_map = as_tensor(kappa_map, self.device)
        if L <= 2 * self.nside:
            if L <= _TABLE_LMAX_LIMIT:
                kr, ki = sht.analyze(kappa_map, self.nside, L, niter=0)
            else:
                kr, ki = sht_large.analyze_large(kappa_map, self.nside, L,
                                                 niter=0)
        else:
            kr, ki = sht_large.analyze_large(kappa_map, self.nside, L,
                                             niter=3, method="auto")
        if L <= _TABLE_LMAX_LIMIT:
            a_t, a_p = sht_spin.deflection_from_kappa_alm(kr, ki,
                                                          self.nside, L)
        else:
            a_t, a_p = sht_spin_large.deflection_from_kappa_alm_large(
                kr, ki, self.nside, L)
        return self.lens_cmb_by_deflection(cmb_map, a_t, a_p)

    def lens_cmb_by_deflection(self, cmb_map, alpha_theta, alpha_phi
                               ) -> np.ndarray:
        """Lens a CMB map by remapping with a deflection field: the
        unlensed map sampled at the source-plane positions of every pixel
        centre (utils.healpix_torch.remap_by_deflection), stored as
        'cmb_lensed' and returned as numpy.

        The remap is float32: the monopole is split off in float64 first,
        so an absolute-units map (T ~ 2.7 K plus uK fluctuations) keeps its
        fluctuations' precision. Every source position carries the JAX
        package's 1e-3-pixel tie nudge (+0.5 nudge in theta, +nudge in
        phi, nudge = 1e-3 * 2 pi / (4 nside)), which shifts each sampled
        value by ~1e-3 of its pixel-to-pixel difference. Its bias on the
        lensed spectrum against an un-nudged remap, at nside 1024 / lmax
        2048 by an N-body kappa, is 1.0e-4 at most in 8 log bands over 10
        <= l <= 1536 (chip_smoke.py phase 19 (c) on an NVIDIA H100 80GB
        HBM3 at 700 W)."""
        from ..utils import healpix_torch as hpt

        if isinstance(cmb_map, torch.Tensor):
            cmb = cmb_map.to(torch.float64)
        else:
            cmb = torch.from_numpy(np.asarray(cmb_map, np.float64)).to(
                self.device)
        mono = cmb.mean()
        lensed = mono + hpt.remap_by_deflection(
            (cmb - mono).to(torch.float32), alpha_theta, alpha_phi,
            self.nside).to(torch.float64)
        self.data["cmb_lensed"] = lensed
        return _host(lensed)
