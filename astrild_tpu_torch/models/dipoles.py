"""Dipoles: moving-lens dipole detection and transverse-velocity
measurement.

Port of astrild_tpu/models/dipoles.py (Yasini et al. 2018,
arxiv:1812.04241): peak detection on filtered dT maps, halo <-> dipole
matching, and the per-dipole crop -> aperture photometry -> DGD3 filter ->
vt = -c Sum(dT)/Sum(alpha) estimators. The JAX package vmaps the
estimators over dipoles; here they run on (dipoles, p, p) stacks of crops
with one scale per dipole, in chunks, with no Python loop of launches per
dipole. Each per-dipole scale (R200 in arcmin, the ring radius, the Hann
half-width) is float32 arithmetic on the dipole's float32 R200, as the
vmapped JAX code traces it (ops/filters.py's tensor-scale paths), and the
estimators' inner products are elementwise products and sums.

The catalog is a dict of numpy columns. Maps given as numpy go to
`device`, by default the CUDA card (it raises without one); tensors keep
their device. scipy (`find_nearest`) and h5py (the file methods) are
imported where they are used, and raise ImportError there without them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import as_tensor
from ..ops import filters as filter_ops
from ..ops import peaks as peak_ops
from ..ops.filters import _f32
from ..utils.constants import C_LIGHT_KMS

__all__ = ["Dipoles"]

# crop pixels one chunk of an estimator holds at most
_CHUNK_PIXELS = 1 << 22


def _crops(maps, c1, c2, patch_pix: int):
    """(nd, p, p) crops of each map, p = 2 patch_pix, whose corner is
    (row c2 - patch_pix, column c1 - patch_pix): the JAX package's
    dynamic_slice, for crops inside the map."""
    p = 2 * patch_pix
    ar = torch.arange(p, device=c1.device)
    rows = (c2 - patch_pix)[:, None] + ar
    cols = (c1 - patch_pix)[:, None] + ar
    return [m[rows[:, :, None], cols[:, None, :]] for m in maps]


def _estimate(one, t1, t2, scales, maps, patch_pix: int, dev):
    """Run the batched estimator `one` over the dipoles in chunks; returns
    host float64 (vx, vy)."""
    c1 = torch.as_tensor(t1, device=dev)
    c2 = torch.as_tensor(t2, device=dev)
    scales = [torch.as_tensor(np.asarray(s, np.float64), device=dev).to(
        torch.float32) for s in scales]
    chunk = max(1, _CHUNK_PIXELS // (2 * patch_pix) ** 2)
    vx, vy = [], []
    for a in range(0, len(t1), chunk):
        sl = slice(a, a + chunk)
        crops = _crops(maps, c1[sl], c2[sl], patch_pix)
        x, y = one(*crops, *[s[sl] for s in scales])
        vx.append(x)
        vy.append(y)
    return (torch.cat(vx).cpu().numpy().astype(np.float64),
            torch.cat(vy).cpu().numpy().astype(np.float64))


def _inner(w, img):
    """<w, img> over each crop: an elementwise product and sum."""
    return torch.sum(w * img, dim=(-2, -1))


class Dipoles:
    """Dipole catalog (column dict)."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data

    # ----------------------------------------------------------- persistence
    @classmethod
    def from_dataframe(cls, df) -> "Dipoles":
        """From a pandas DataFrame or a dict of columns."""
        cols = df.columns if hasattr(df, "columns") else df.keys()
        return cls({k: np.asarray(df[k]) for k in cols})

    @classmethod
    def from_file(cls, path: str) -> "Dipoles":
        """Load a saved dipole catalog (.h5 columnar table)."""
        from ..io import columnar_h5

        return cls(dict(columnar_h5.read_table(path)))

    def to_file(self, path: str) -> None:
        from ..io import columnar_h5

        columnar_h5.write_table(path, {k: np.asarray(v)
                                       for k, v in self.data.items()})

    # ------------------------------------------------------------- detection
    @classmethod
    def from_sky(cls, skymap, on: str = "orig", snr_threshold: float = 0.0,
                 max_peaks: int = 4096, edge_pix: int = 0) -> "Dipoles":
        """Detect dipoles as |dT| local maxima on a (filtered) map, on the
        map's device."""
        img = torch.abs(skymap._layer(on))
        cat = peak_ops.find_peaks(img, threshold=0.0, max_peaks=max_peaks,
                                  edge_pix=edge_pix)
        n = int(cat.n)
        snr = cat.snr[:n].cpu().numpy()
        keep = snr > snr_threshold
        pix2deg = skymap.opening_angle / skymap.npix
        pos = cat.pos[:n].cpu().numpy()[keep]
        return cls({
            "theta1_pix": pos[:, 1],
            "theta2_pix": pos[:, 0],
            "theta1_deg": pos[:, 1] * pix2deg,
            "theta2_deg": pos[:, 0] * pix2deg,
            "dT": cat.values[:n].cpu().numpy()[keep],
            "snr": snr[keep],
        })

    # -------------------------------------------------------------- matching
    def find_nearest(self, halos: Dict[str, np.ndarray],
                     keys=("theta1_deg", "theta2_deg"),
                     halo_keys=("theta1_deg", "theta2_deg"),
                     max_distance: Optional[float] = None) -> None:
        """Match each dipole to its nearest halo with duplicate resolution:
        if several dipoles claim one halo, the closest pair (in the order
        of np.argsort of the distances) wins and the rest are unmatched
        (-1)."""
        from scipy.spatial import cKDTree

        hp = np.stack([np.asarray(halos[k]) for k in halo_keys], axis=-1)
        dp = np.stack([np.asarray(self.data[k]) for k in keys], axis=-1)
        dist, idx = cKDTree(hp).query(dp, k=1)
        match = idx.astype(int)
        if max_distance is not None:
            match[dist > max_distance] = -1
        order = np.argsort(dist)
        seen = set()
        for i in order:
            if match[i] == -1:
                continue
            if match[i] in seen:
                match[i] = -1
            else:
                seen.add(match[i])
        self.data["halo_idx"] = match
        self.data["halo_dist"] = dist
        # copy the matched halo properties used downstream; halo centres
        # keep a halo_ prefix (the dipole position is a lobe peak, offset
        # from the halo centre: the velocity measurement centres on the
        # halo); theta{1,2}_tv are the lightcone catalogs' truth columns
        ok = match >= 0
        for col in ("r200_deg", "r200_pix", "m200", "c_NFW",
                    "theta1_vel", "theta2_vel", "theta1_tv", "theta2_tv"):
            if col in halos:
                vals = np.full(len(match), np.nan)
                vals[ok] = np.asarray(halos[col])[match[ok]]
                self.data[col] = vals
        for col in ("theta1_pix", "theta2_pix"):
            if col in halos:
                vals = np.full(len(match), -1.0)
                vals[ok] = np.asarray(halos[col])[match[ok]]
                self.data["halo_" + col] = vals

    # --------------------------------------------- transverse velocities
    @staticmethod
    def get_single_transverse_velocity_from_sky(
            deltaTx, deltaTy, alphax, alphay,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """vt = -c Sum(dT)/Sum(alpha) per component (Yasini+18 Eq. 9);
        0-d tensors."""
        dtx = as_tensor(deltaTx, device)
        dev = dtx.device
        dty, ax, ay = (as_tensor(a, dev) for a in (deltaTy, alphax, alphay))
        vx = -C_LIGHT_KMS * torch.sum(dtx) / torch.sum(ax)
        vy = -C_LIGHT_KMS * torch.sum(dty) / torch.sum(ay)
        return vx, vy

    def _centres(self):
        """Crop centres: the matched halo's pixel where known (the dipole
        peak is a lobe, offset from the halo centre by ~R200)."""
        t1_key = ("halo_theta1_pix" if "halo_theta1_pix" in self.data
                  else "theta1_pix")
        t2_key = ("halo_theta2_pix" if "halo_theta2_pix" in self.data
                  else "theta2_pix")
        return (np.asarray(self.data[t1_key], int),
                np.asarray(self.data[t2_key], int))

    def get_transverse_velocities_from_sky(self, isw_map, alpha_x_map,
                                           alpha_y_map, opening_angle: float,
                                           extend: float = 1.0,
                                           patch_pix: int = 64,
                                           device=None) -> None:
        """Measure vt for every matched dipole with the DGD3 matched filter,
        v_j = -c <W_j, dT> / <W_j, alpha_j>, on crops of side 2 patch_pix
        around the matched halos (dipoles whose crop leaves the map, or with
        no R200, get -99999). Results go to theta{1,2}_mtvel.

        Args:
          isw_map, alpha_x_map, alpha_y_map: (npix, npix) maps
            (unfiltered dT/T and deflection components).
          opening_angle: map FOV [deg].
          patch_pix: half-size of the crop around each dipole.
        """
        isw = as_tensor(isw_map, device)
        dev = isw.device
        ax_map, ay_map = (as_tensor(a, dev) for a in (alpha_x_map,
                                                      alpha_y_map))
        npix = isw.shape[-1]
        n = len(self.data["theta1_pix"])
        ok = np.isfinite(np.asarray(self.data.get(
            "r200_deg", np.full(n, np.nan))))
        t1, t2 = self._centres()
        ok &= ((t1 - patch_pix >= 0) & (t1 + patch_pix < npix)
               & (t2 - patch_pix >= 0) & (t2 + patch_pix < npix))
        p = 2 * patch_pix
        patch_oa = opening_angle * p / npix  # [deg]
        neg_c = _f32(-C_LIGHT_KMS, dev)

        def one(dT, ax, ay, r200_deg):
            # centre dT on the mean within the ring at R200 (aperture
            # photometry), then the matched-filter inner products (theta1
            # / x varies along array axis 1)
            ti = r200_deg * _f32(60.0, dev)  # arcmin, float32
            dT = filter_ops.aperture_photometry(dT, patch_oa, ti)
            w_x = filter_ops.dgd3_window(p, patch_oa, ti, axis=1)
            w_y = filter_ops.dgd3_window(p, patch_oa, ti, axis=0)
            return (neg_c * _inner(w_x, dT) / _inner(w_x, ax),
                    neg_c * _inner(w_y, dT) / _inner(w_y, ay))

        fail = -99999.0
        vx = np.full(n, fail)
        vy = np.full(n, fail)
        idx = np.where(ok)[0]
        if len(idx):
            vx[idx], vy[idx] = _estimate(
                one, t1[idx], t2[idx],
                [np.asarray(self.data["r200_deg"])[idx]],
                [isw, ax_map, ay_map], patch_pix, dev)
        self.data["theta1_mtvel"] = vx
        self.data["theta2_mtvel"] = vy

    def get_transverse_velocities_reference_mode(
            self, isw_map, alpha_x_map, alpha_y_map, opening_angle: float,
            extend: float = 2.0, hp_fwhm_arcmin: float = 5.0,
            patch_pix: Optional[int] = None, device=None) -> None:
        """The reference's vt estimator, batched (parity mode): per dipole,
        crop dT / alpha_x / alpha_y around the DIPOLE position, centre dT by
        aperture photometry (alpha = R200), filter each crop with [Gaussian
        high-pass (fwhm 5') -> DGD3 with theta_i = R200 along the velocity
        component -> separable Hann window of half-width extend * R200 in
        pixels], then vt_j = -c Sum(dT_j)/Sum(alpha_j). Results go to
        theta{1,2}_mtvel_ref.
        """
        isw = as_tensor(isw_map, device)
        dev = isw.device
        ax_map, ay_map = (as_tensor(a, dev) for a in (alpha_x_map,
                                                      alpha_y_map))
        npix = isw.shape[-1]
        n = len(self.data["theta1_pix"])
        r200_deg = np.asarray(self.data.get("r200_deg",
                                            np.full(n, np.nan)), float)
        r200_pix = np.asarray(self.data.get(
            "r200_pix", r200_deg * npix / opening_angle), float)
        ok = np.isfinite(r200_deg) & np.isfinite(r200_pix)
        t1 = np.asarray(self.data["theta1_pix"], int)
        t2 = np.asarray(self.data["theta2_pix"], int)
        if patch_pix is None:
            hmax = extend * np.nanmax(np.where(ok, r200_pix, 0.0))
            patch_pix = max(int(np.ceil(hmax)) + 1, 8)
        ok &= ((t1 - patch_pix >= 0) & (t1 + patch_pix < npix)
               & (t2 - patch_pix >= 0) & (t2 + patch_pix < npix))
        p = 2 * patch_pix
        patch_oa = opening_angle * p / npix  # [deg]
        neg_c = _f32(-C_LIGHT_KMS, dev)
        i = (torch.arange(p, device=dev).to(torch.float32)
             - _f32(patch_pix - 0.5, dev))

        def hann_window(half_pix):
            # separable Hann lobe of half-width extend * r200 (pixels), zero
            # outside: |i| <= half is a decision on a float32 value
            half = half_pix[:, None]
            w = torch.cos(_f32(math.pi, dev) * i / (_f32(2.0, dev) * half))
            w = w * w
            w = torch.where(torch.abs(i) <= half, w, torch.zeros_like(w))
            return w[:, :, None] * w[:, None, :]

        def one(dT, ax, ay, r_deg, r_pix):
            ti = r_deg * _f32(60.0, dev)
            dT = filter_ops.aperture_photometry(dT, patch_oa, ti)
            win = hann_window(_f32(extend, dev) * r_pix)

            def chain(img, axis):
                f = filter_ops.gaussian_high_pass(
                    img, patch_oa, fwhm_arcmin=hp_fwhm_arcmin)
                f = filter_ops.dgd3(f, patch_oa, ti, axis=axis)
                return torch.sum(f * win, dim=(-2, -1))

            # direction 1 (x / theta1) varies along array axis 1
            return (neg_c * chain(dT, 1) / chain(ax, 1),
                    neg_c * chain(dT, 0) / chain(ay, 0))

        fail = -99999.0
        vx = np.full(n, fail)
        vy = np.full(n, fail)
        idx = np.where(ok)[0]
        if len(idx):
            vx[idx], vy[idx] = _estimate(
                one, t1[idx], t2[idx], [r200_deg[idx], r200_pix[idx]],
                [isw, ax_map, ay_map], patch_pix, dev)
        self.data["theta1_mtvel_ref"] = vx
        self.data["theta2_mtvel_ref"] = vy
