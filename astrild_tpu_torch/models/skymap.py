"""SkyMap / SkyArray: flat-sky map containers with named layers.

Port of astrild_tpu/models/skymap.py: named map layers in `data{}` (torch
tensors on one device), made from arrays, lens planes, files or ray
columns; operations (noise, peak counts, kappa -> alpha -> gamma, CMB
realizations, xi_pm, COSEBIs) are the port's ops. Numpy input goes to
`device`, by default the CUDA card (it raises without one: pass
device="cpu"); a tensor keeps its device. Random layers draw from a
`torch.Generator` seeded with `rnd_seed` (the same seed gives another
realization than the JAX package's PRNG key).

The analytic NFW halo constructors (`from_halo_series`,
`from_halo_dataframe` and its reference-named alias) paint the moving-lens
dT/T, deflection, kSZ and Compton-y patches of `ops/lensing.py` and
`ops/sz.py`; a catalog's patches are built as one broadcast over halos.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor, default_device
from ..ops import filters as filter_ops

__all__ = ["SkyArray", "SkyMap"]

# halo-patch pixels one chunk of from_halo_dataframe holds at most
_HALO_CHUNK_PIXELS = 1 << 23


class SkyArray:
    """Flat-sky square map with named layers.

    data: {layer_name: (npix, npix) tensor}; "orig" is the primary.
    opening_angle in degrees.
    """

    def __init__(self, skymap, opening_angle: float, quantity: str = "kappa_2",
                 dirs=None, map_file=None, device=None):
        self.data: Dict[str, torch.Tensor] = {
            "orig": as_tensor(skymap, device)}
        self._opening_angle = float(opening_angle)
        self.quantity = quantity
        self.dirs = dirs
        self.map_file = map_file

    # ------------------------------------------------------------ properties
    @property
    def npix(self) -> int:
        return self.data["orig"].shape[-1]

    @property
    def _npix(self) -> int:
        return self.npix

    @property
    def opening_angle(self) -> float:
        return self._opening_angle

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
    def from_array(cls, map_array, opening_angle: float,
                   quantity: str = "kappa_2", dirs=None, map_file=None,
                   device=None) -> "SkyArray":
        return cls(map_array, opening_angle, quantity, dirs, map_file,
                   device=device)

    @classmethod
    def from_density_planes(cls, planes, chis, dchis, chi_s, omega_m,
                            opening_angle: float, scale_factors=None,
                            method: str = "born", device=None):
        """Map-maker from stacked lens planes.

        method='born' integrates the planes at Born level ('orig' =
        kappa); method='raytrace' runs the multi-plane ray tracer
        (ops/raytrace.py) and adds gamma1/gamma2/omega layers.
        opening_angle in degrees. Returns one SkyArray for scalar chi_s, a
        list (one per source plane) for a (nsrc,) chi_s.
        """
        from ..ops import lensing as _lens
        from ..ops import raytrace as _rt

        planes = as_tensor(planes, device)
        dev = planes.device
        chi_s_h = np.asarray(chi_s.detach().cpu() if isinstance(
            chi_s, torch.Tensor) else chi_s, np.float32)
        if method == "born":
            chis_t, dchis_t = as_tensor(chis, dev), as_tensor(dchis, dev)
            sf = (None if scale_factors is None
                  else as_tensor(scale_factors, dev))

            def born(cs):
                return cls(_lens.born_convergence(
                    planes, chis_t, dchis_t, float(cs), omega_m,
                    scale_factors=sf), opening_angle, "kappa_2")

            if chi_s_h.ndim > 0:
                return [born(cs) for cs in chi_s_h]
            return born(chi_s_h)
        if method == "raytrace":
            out = _rt.multiplane_raytrace(
                planes, chis, dchis, chi_s, omega_m,
                np.radians(opening_angle), scale_factors=scale_factors)

            def traced(i):
                sky = cls(out["kappa"] if i is None else out["kappa"][i],
                          opening_angle, "kappa_2")
                for name in ("gamma1", "gamma2", "omega"):
                    sky.data[name] = out[name] if i is None else out[name][i]
                return sky

            if chi_s_h.ndim > 0:
                return [traced(i) for i in range(out["kappa"].shape[0])]
            return traced(None)
        raise ValueError(f"unknown map-maker method {method!r}")

    @classmethod
    def from_file(cls, map_file: str, opening_angle: float,
                  quantity: str = "kappa_2", convert_unit: bool = True,
                  device=None) -> "SkyArray":
        """npy or columnar / pandas h5."""
        ext = map_file.split(".")[-1]
        if ext == "npy":
            arr = np.load(map_file)
        elif ext in ("h5", "hdf5"):
            from ..io import columnar_h5

            cols = columnar_h5.read_table(map_file)
            return cls.from_columns(cols, opening_angle, quantity,
                                    convert_unit=convert_unit,
                                    map_file=map_file, device=device)
        else:
            raise ValueError(f"unsupported extension {ext}")
        return cls(arr, opening_angle, quantity, map_file=map_file,
                   device=device)

    @classmethod
    def from_columns(cls, cols, opening_angle: float,
                     quantity: str = "kappa_2", convert_unit: bool = True,
                     map_file=None, device=None) -> "SkyArray":
        """Ray-output columns -> map (io.rays.rays_to_map, host numpy)."""
        from ..io.rays import rays_to_map

        ids = cols.get("id")
        arr = rays_to_map(np.asarray(cols[quantity]),
                          None if ids is None else np.asarray(ids),
                          quantity=quantity if convert_unit else None)
        return cls(arr, opening_angle, quantity, map_file=map_file,
                   device=device)

    # legacy alias
    from_dataframe = from_columns

    @classmethod
    def from_halo_series(cls, halo, npix: int, extent: float,
                         direction: Sequence[int], suppress: bool,
                         suppression_R: float, to: str = "dT",
                         device=None) -> "SkyArray":
        """Analytic NFW halo signal patch: to="dT" (moving-lens dT/T),
        "alpha" (deflection) or "ksz".

        `halo` (a dict or an object with these attributes) gives r200_deg,
        m200, c_NFW, Dc (angular-diameter distance [Mpc]), and
        theta1_tv / theta2_tv for dT, v_los for kSZ. The patch runs on
        `device`, by default the CUDA card (it raises without one).
        """
        from ..ops import lensing
        from ..ops import sz as sz_ops

        get = lambda k: float(halo[k] if isinstance(halo, dict) else  # noqa
                              getattr(halo, k))
        if to == "dT":
            arr = lensing.nfw_temperature_perturbation_map(
                get("r200_deg"), get("m200"), get("c_NFW"),
                [get("theta1_tv"), get("theta2_tv")], get("Dc"), npix=npix,
                extent=extent, directions=tuple(direction),
                suppress=suppress, suppression_r=suppression_R,
                device=device)
            quantity = "rs"
        elif to == "alpha":
            arr = lensing.nfw_deflection_angle_map(
                get("r200_deg"), get("m200"), get("c_NFW"), get("Dc"),
                npix=npix, extent=extent, directions=tuple(direction),
                suppress=suppress, suppression_r=suppression_R,
                device=device)
            quantity = "alpha"
        elif to == "ksz":
            r200_mpc = float(np.tan(np.deg2rad(get("r200_deg")))
                             * get("Dc"))
            arr = sz_ops.ksz_patch_from_halo(
                get("m200"), get("c_NFW"), r200_mpc, get("v_los"),
                npix=npix, extent=extent, device=device)
            return cls(arr, 2 * get("r200_deg") * extent, "ksz")
        else:
            raise ValueError(f"unknown signal {to}")
        if 0 in direction and 1 not in direction:
            quantity += "_x"
        elif 1 in direction and 0 not in direction:
            quantity += "_y"
        return cls(arr, 2 * get("r200_deg") * extent, quantity)

    @classmethod
    def from_halo_dataframe(cls, halo_cat, npix: int, extent: float,
                            direction: Sequence[int], suppress: bool,
                            suppression_R: float, to: str = "dT",
                            opening_angle: Optional[float] = None,
                            patch_npix: int = 101,
                            device=None) -> "SkyArray":
        """Paint many halos onto one (npix, npix) canvas: to="dT", "ksz",
        "y" (Compton-y) or anything else for the deflection.

        halo_cat: dict of columns: r200_deg, m200, c_NFW, Dc, theta1_pix,
        theta2_pix, with theta1_tv / theta2_tv for dT, v_los for kSZ, and
        m500 [Msun, physical], r500 [Mpc], e_z for y. The patches of all
        halos are one broadcast over halos (in chunks of halos), each
        element computed as the scalar patch function computes it, then
        painted in halo order (`ops.lensing.paint_halo_patches`). Runs on
        `device`, by default the CUDA card (it raises without one).
        """
        from ..ops import lensing
        from ..ops import sz as sz_ops

        get = lambda k: np.asarray(halo_cat[k], np.float64)  # noqa: E731
        nh = len(get("m200"))
        dirs = tuple(direction)

        def patches(sl):
            if to == "dT":
                th, m, c, d, ext, sup, v1, v2 = lensing._halo_tensors(
                    get("r200_deg")[sl], get("m200")[sl], get("c_NFW")[sl],
                    get("Dc")[sl], extent, suppression_R,
                    get("theta1_tv")[sl], get("theta2_tv")[sl],
                    device=device)
                return lensing._nfw_temperature_stack(
                    th, m, c, torch.stack([v1, v2], dim=-1), d, patch_npix,
                    ext, dirs, suppress, sup)
            if to == "ksz":
                r200_mpc = np.tan(np.deg2rad(get("r200_deg")[sl])) \
                    * get("Dc")[sl]
                m, c, r, v, ext = lensing._halo_tensors(
                    get("m200")[sl], get("c_NFW")[sl], r200_mpc,
                    get("v_los")[sl], extent, device=device)
                return sz_ops._ksz_stack(m, c, r, v, patch_npix, ext)
            if to == "y":
                m5, r5, ez, ext = lensing._halo_tensors(
                    get("m500")[sl], get("r500")[sl], get("e_z")[sl],
                    extent, device=device)
                return sz_ops._compton_y_stack(m5, r5, ez, patch_npix, ext)
            th, m, c, d, ext, sup = lensing._halo_tensors(
                get("r200_deg")[sl], get("m200")[sl], get("c_NFW")[sl],
                get("Dc")[sl], extent, suppression_R, device=device)
            return lensing._nfw_deflection_stack(th, m, c, d, patch_npix,
                                                 ext, dirs, suppress, sup)

        centers = np.stack([get("theta1_pix").astype(np.int32),
                            get("theta2_pix").astype(np.int32)], axis=-1)
        out = None
        chunk = max(1, _HALO_CHUNK_PIXELS // patch_npix ** 2)
        for a in range(0, nh, chunk):
            sl = slice(a, a + chunk)
            stack = patches(sl)
            if out is None:
                out = torch.zeros(npix * npix, device=stack.device)
            lensing._add_patches_(out, npix, stack, centers[sl])
        if out is None:
            out = torch.zeros(npix * npix, device=default_device(device))
        if opening_angle is None:
            # the FOV from the pixel scale implied by the first halo
            oa = float(get("r200_deg")[0] * npix
                       / max(float(np.asarray(halo_cat["r200_pix"])[0]), 1))
        else:
            oa = opening_angle
        quantity = {"dT": "rs", "ksz": "ksz", "y": "y"}.get(to, "alpha")
        return cls(out.reshape(npix, npix), oa, quantity)

    @classmethod
    def from_halo_catalogue_to_temperature_perturbation_map(
            cls, halo_cat, extent: float = 1.0, direction=(0, 1),
            suppress: bool = False, suppression_R: float = 1.0,
            npix: int = 8192, opening_angle: float = 20.0, **kw
    ) -> "SkyArray":
        """Reference-named alias (the moving-cluster dT map) for
        from_halo_dataframe(to='dT')."""
        return cls.from_halo_dataframe(
            halo_cat, npix, extent, list(direction), suppress,
            suppression_R, to="dT", opening_angle=opening_angle, **kw)

    # -------------------------------------------------------------- analysis
    def pdf(self, nbins: int, of: str = "orig") -> dict:
        vals, bins = np.histogram(self._layer(of).cpu().numpy(), bins=nbins,
                                  density=True)
        return {"values": vals, "bins": bins}

    def wl_peak_counts(self, nbins: int, field_conversion: str = None,
                       of: str = "orig", limits: Optional[tuple] = None):
        """Peak-height histogram -> dict with kappa bin centers and counts
        (numpy); limits default to the 5th / 95th percentiles (jnp
        .percentile's arithmetic)."""
        from ..ops import peaks as peak_ops
        from ..ops.voids import _percentile

        img = self._layer(of)
        if field_conversion == "normalize":
            img = img - img.mean()
        if limits is None:
            flat = img.reshape(-1).to(torch.float32)
            lo = float(_percentile(flat, 5.0))
            hi = float(_percentile(flat, 95.0))
        else:
            lo, hi = min(limits), max(limits)
        centers, counts = peak_ops.peak_counts(img, lo, hi, nbins=nbins)
        return {"kappa": centers.cpu().numpy(),
                "counts": counts.cpu().numpy()}

    def minkowski_functionals(self, nbins: int = 32, of: str = "orig",
                              limits: Optional[tuple] = None) -> dict:
        """Morphology of excursion sets (area, boundary, genus); thresholds
        in map units, derivatives per radian (ops/minkowski.py)."""
        from ..ops import minkowski as mf_ops

        return mf_ops.minkowski_functionals(
            self._layer(of), nbins=nbins, limits=limits,
            opening_angle_deg=self._opening_angle)

    def aperture_mass(self, theta_ap_arcmin: float, of: str = "orig",
                      rtn: bool = True):
        """Map(theta0) field with the Schneider+98 compensated filter
        (ops/aperture_mass.py); rtn=False stores it as a layer
        '<of>_map<scale>'."""
        from ..ops import aperture_mass as map_ops

        out = map_ops.aperture_mass_map(self._layer(of), self._opening_angle,
                                        theta_ap_arcmin)
        if rtn:
            return out
        self.data[f"{of}_map{theta_ap_arcmin:g}"] = out

    def aperture_mass_moments(self, scales_arcmin, of: str = "orig") -> dict:
        """<Map^2>, <Map^3> and skewness over aperture scales."""
        from ..ops import aperture_mass as map_ops

        return map_ops.aperture_mass_moments(self._layer(of),
                                             self._opening_angle,
                                             scales_arcmin)

    # ------------------------------------------------------------ transforms
    def resize(self, npix: int, of: str = "orig", rtn: bool = False):
        """Linear resize to (npix, npix): half-pixel centres, and a
        triangle kernel widened by the scale when shrinking (the
        antialiased linear resize of jax.image.resize)."""
        img = self._layer(of)
        out = F.interpolate(img[None, None].to(torch.float32),
                            size=(npix, npix), mode="bilinear",
                            align_corners=False, antialias=True)[0, 0]
        if rtn:
            return out
        self.data[of] = out

    def crop(self, xlimit, ylimit, of: str = "orig", rtn: bool = False):
        """Float limits are percentages."""
        xlimit = np.asarray(xlimit)
        ylimit = np.asarray(ylimit)
        if isinstance(xlimit[0], (float, np.floating)):
            xlimit = (self.npix * xlimit / 100).astype(int)
            ylimit = (self.npix * ylimit / 100).astype(int)
        zoom = self._layer(of)[xlimit[0]:xlimit[1], ylimit[0]:ylimit[1]]
        if rtn:
            return zoom
        self._opening_angle = (self._opening_angle
                               * abs(int(np.diff(xlimit)[0])) / self.npix)
        self.data[of] = zoom

    def division(self, ntiles: int, of: str = "orig"):
        """Split into ntiles x ntiles sub-maps."""
        img = self._layer(of)
        t = img.shape[0] // ntiles
        tiles = [img[i * t:(i + 1) * t, j * t:(j + 1) * t]
                 for i in range(ntiles) for j in range(ntiles)]
        return torch.stack(tiles)

    @staticmethod
    def merge(tiles, rtn: bool = True):
        """Inverse of division."""
        ntiles = int(np.sqrt(tiles.shape[0]))
        rows = [torch.hstack([tiles[i * ntiles + j] for j in range(ntiles)])
                for i in range(ntiles)]
        return torch.vstack(rows)

    def substract_mean(self, of: str = "orig", rtn: bool = False):
        img = self._layer(of)
        out = img - img.mean()
        if rtn:
            return out
        self.data[of] = out

    # --------------------------------------------------------------- filters
    _FILTERS = {
        "gaussian": lambda img, oa, **kw: filter_ops.gaussian(img, oa, **kw),
        "gaussian_high_pass": lambda img, oa, **kw:
            filter_ops.gaussian_high_pass(img, oa, **kw),
        "gaussian_third_derivative": lambda img, oa, **kw:
            filter_ops.dgd3(img, oa, **kw),
        "gaussian_compensated": lambda img, oa, **kw:
            filter_ops.gaussian_compensated(img, oa, **kw),
        "apodization": lambda img, oa, **kw: filter_ops.apodization(img),
        "aperture_photometry": lambda img, oa, **kw:
            filter_ops.aperture_photometry(img, oa, **kw),
    }

    def filter(self, filter_dsc: dict, on: str = "orig", rtn: bool = False):
        """Chain filters by name. Each entry: {filter_name: {abbrev: str,
        **kwargs}}; the result is returned (rtn) or stored as the layer
        '<on>_<abbrev>_...'."""
        img = self._layer(on)
        names = [on]
        for fname, args in filter_dsc.items():
            args = dict(args)
            names.append(args.pop("abbrev", fname[:3]))
            img = self._FILTERS[fname](img, self._opening_angle, **args)
        if rtn:
            return img
        self.data["_".join(names)] = img
        return None

    def smoothing(self, sigma_arcmin: float, on: str = "orig"):
        """Gaussian smooth; adds the layer '<on>_smooth'."""
        self.data[on + "_smooth"] = filter_ops.gaussian(
            self._layer(on), self._opening_angle, sigma_arcmin=sigma_arcmin)
        return self.data[on + "_smooth"]

    # ----------------------------------------------------------------- noise
    def _generator(self, rnd_seed: Optional[int]) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            0 if rnd_seed is None else int(rnd_seed))

    def create_galaxy_shape_noise(self, std: float, ngal: float,
                                  rnd_seed: Optional[int] = None,
                                  std_pix: Optional[float] = None):
        """Galaxy shape noise layer 'gsn'. std_pix defaults to
        sigma_e / sqrt(2 n_gal A_pix)."""
        theta_pix = 60.0 * self._opening_angle / self.npix  # arcmin
        if std_pix is None:
            std_pix = float(np.sqrt(std ** 2 / (2.0 * theta_pix ** 2 * ngal)))
        self.data["gsn"] = std_pix * torch.randn(
            (self.npix, self.npix), generator=self._generator(rnd_seed),
            device=self.device, dtype=torch.float32)
        return self.data["gsn"]

    def add_galaxy_shape_noise(self, on: str = "orig"):
        if "kappa" not in self.quantity:
            raise ValueError(f"GSN should not be added to {self.quantity}")
        self.data["orig_gsn"] = self._layer(on) + self._layer("gsn")
        return self.data["orig_gsn"]

    def create_cmb(self, cl_ell, cl_val, rnd_seed: int = 0):
        """Flat-sky CMB realization layer 'cmb' from a C_ell table
        (angular_power.cl_to_flat_map)."""
        from ..ops import angular_power

        self.data["cmb"] = angular_power.cl_to_flat_map(
            self._generator(rnd_seed), cl_ell, cl_val, self.npix,
            self._opening_angle)
        return self.data["cmb"]

    def add_cmb(self, filepath_cl: Optional[str] = None,
                filepath_cmb: Optional[str] = None, on: str = "orig",
                lmax: Optional[int] = None, rnd_seed: int = 0,
                overwrite: bool = True) -> torch.Tensor:
        """Add a CMB layer to the map. filepath_cl: .npy with rows [ell,
        Cl_TT]; filepath_cmb: a precomputed map .npy."""
        if "cmb" not in self.data:
            if filepath_cl is not None:
                tab = np.load(filepath_cl)
                ell, cl = np.asarray(tab[0]), np.asarray(tab[1])
                if lmax is not None:
                    keep = ell <= lmax
                    ell, cl = ell[keep], cl[keep]
                self.create_cmb(ell, cl, rnd_seed=rnd_seed)
            elif filepath_cmb is not None:
                self.data["cmb"] = as_tensor(np.load(filepath_cmb),
                                             self.device)
            else:
                raise ValueError("need filepath_cl or filepath_cmb")
        out = self._layer(on) + self._layer("cmb")
        if overwrite:
            self.data[on] = out
        else:
            self.data[f"{on}_cmb"] = out
        return out

    # --------------------------------------------------------------- lensing
    def convert_convergence_to_deflection(self, on: str = "orig",
                                          padding_factor: int = 4):
        """kappa -> (alpha1, alpha2) in radians (layers defltx, deflty)."""
        from ..ops import lensing

        oa_rad = np.deg2rad(self._opening_angle)
        a1, a2 = lensing.kappa_to_alpha(self._layer(on), oa_rad,
                                        padding_factor=padding_factor)
        self.data["defltx"] = a1
        self.data["deflty"] = a2
        return a1, a2

    def convert_deflection_to_shear(self, on: Tuple[str, str] =
                                    ("defltx", "deflty")):
        """(gamma1, gamma2) from deflection by finite differences (layers
        shearx, sheary)."""
        from ..ops import lensing

        oa_rad = np.deg2rad(self._opening_angle)
        g1, g2 = lensing.alpha_to_gamma(self._layer(on[0]),
                                        self._layer(on[1]), oa_rad)
        self.data["shearx"] = g1
        self.data["sheary"] = g2
        return g1, g2

    def convert_convergence_to_shear(self, on: str = "orig",
                                     padding_factor: int = 2):
        """(gamma1, gamma2) straight from kappa by one padded spectral
        spin-2 rotation (ops.lensing.kappa_to_gamma; layers shearx,
        sheary)."""
        from ..ops import lensing

        oa_rad = np.deg2rad(self._opening_angle)
        g1, g2 = lensing.kappa_to_gamma(self._layer(on), oa_rad,
                                        padding_factor=padding_factor)
        self.data["shearx"] = g1
        self.data["sheary"] = g2
        return g1, g2

    def shear_xi_pm(self, nbins: int = 20, theta_min_arcmin=None,
                    theta_max_arcmin=None,
                    on: Tuple[str, str] = ("shearx", "sheary")):
        """xi_pm(theta) of the stored shear layers
        (ops.shear_2pt.xi_pm_flat_sky). Returns (theta_arcmin, xi_plus,
        xi_minus, npairs)."""
        from ..ops import shear_2pt

        return shear_2pt.xi_pm_flat_sky(
            self._layer(on[0]), self._layer(on[1]), self._opening_angle,
            nbins=nbins, theta_min_arcmin=theta_min_arcmin,
            theta_max_arcmin=theta_max_arcmin)

    def cosebis(self, nmax: int, theta_min_arcmin: float,
                theta_max_arcmin: float, nbins: int = 64,
                on: Tuple[str, str] = ("shearx", "sheary")):
        """COSEBIs E/B modes of the stored shear layers: xi_pm measured on
        [0.7 theta_min, min(1.3 theta_max, half box)] in log bins, empty
        annuli dropped, then the linear-COSEBIs filter integrals. Raises
        ValueError naming the largest measurable bin centre when the
        interval cannot be covered. Returns (E (nmax,), B (nmax,))."""
        from ..ops import shear_2pt

        half_box = self._opening_angle * 30.0
        th, xp, xm, cnt = self.shear_xi_pm(
            nbins=nbins, theta_min_arcmin=theta_min_arcmin * 0.7,
            theta_max_arcmin=min(theta_max_arcmin * 1.3, half_box),
            on=on)
        keep = cnt > 0
        th_k = th[keep].cpu().numpy()
        if th_k.size == 0 or th_k[-1] < theta_max_arcmin:
            hi = f"{th_k[-1]:.1f}" if th_k.size else "none (no bin has pairs)"
            raise ValueError(
                f"cosebis: theta interval [{theta_min_arcmin}, "
                f"{theta_max_arcmin}] arcmin is not coverable on this "
                f"{self._opening_angle} deg field — the largest "
                f"measurable bin center is {hi}")
        return shear_2pt.cosebis_from_xipm(
            th_k, xp[keep], xm[keep], nmax, theta_min_arcmin,
            theta_max_arcmin)

    def to_file(self, dir_out: str, on: str = "orig",
                extension: str = "npy") -> str:
        os.makedirs(dir_out, exist_ok=True)
        fname = os.path.join(
            dir_out, f"{self.quantity}_{on}_{self.npix}.{extension}")
        np.save(fname, self._layer(on).cpu().numpy())
        return fname


class SkyMap:
    """Facade dispatching to SkyArray (full-sky maps: SkyHealpix)."""

    @staticmethod
    def from_file(npix: int, theta: float, quantity: str, dir_in: str,
                  map_file: str, convert_unit: bool = True,
                  device=None) -> SkyArray:
        return SkyArray.from_file(map_file, theta, quantity,
                                  convert_unit=convert_unit, device=device)

    @staticmethod
    def from_array(map_array, opening_angle: float, quantity: str,
                   dirs=None, device=None) -> SkyArray:
        return SkyArray.from_array(map_array, opening_angle, quantity, dirs,
                                   device=device)

    @staticmethod
    def from_dataframe(cols, opening_angle: float, quantity: str,
                       convert_unit: bool = True, device=None) -> SkyArray:
        return SkyArray.from_columns(cols, opening_angle, quantity,
                                     convert_unit=convert_unit,
                                     device=device)
