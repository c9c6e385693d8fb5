"""SkyNamaster: mask-decoupled angular power spectra, the flat-sky half.

Port of astrild_tpu/models/skynamaster.py. Flat-sky patches go through the
MASTER estimators of ops.angular_power (the exact discrete DFT coupling
matrix, cached per stored mask and binning, so many maps under one mask
pay the build once). The full-sky HEALPix branches (anafast_master and
its spin-2 twin) and the `.h5` branch of `from_file` (it needs
SkyHealpix) raise NotImplementedError: they wait for the SHT stack,
ROADMAP.md queue 1 item 6.

Maps are stored as numpy, as in the JAX package; `compute_cl` and
`compute_cl_spin2` run on `device` (by default the CUDA card; it raises
without one, pass device="cpu" there) and return tensors there. On the
card the coupling matrices are built on the card, on the CPU with the
JAX package's numpy code.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..utils import healpix as hp

__all__ = ["SkyNamaster"]

_FULL_SKY = ("SkyNamaster: full-sky HEALPix spectra are not ported yet: "
             "they wait for the SHT stack, ROADMAP.md queue 1 item 6")


class SkyNamaster:
    """Masked-spectrum analysis of one sky layer (flat-sky; full-sky maps
    are stored but their spectra raise)."""

    def __init__(self, skyfield: np.ndarray, opening_angle: float = 0.0,
                 quantity: str = "kappa_2",
                 dirs: Optional[Dict[str, str]] = None,
                 map_file: Optional[str] = None, device=None):
        self.data: Dict[str, np.ndarray] = {"orig": np.asarray(skyfield)}
        self.flat = self.data["orig"].ndim == 2
        if not self.flat:
            self.nside = hp.npix2nside(self.data["orig"].shape[0])
        self.opening_angle = opening_angle  # deg; flat-sky patches only
        self.quantity = quantity
        self.dirs = dirs or {}
        self.map_file = map_file
        self.device = device
        self._workspace = {}

    # ---------------------------------------------------------- construction
    @classmethod
    def from_array(cls, map_array, opening_angle: float = 0.0,
                   quantity: str = "kappa_2", dir_in: str = "",
                   map_file: Optional[str] = None,
                   device=None) -> "SkyNamaster":
        """A layer from an array; NaN pixels become an explicit
        finite-pixel mask layer."""
        arr = np.asarray(map_array, np.float64)
        finite = np.isfinite(arr)
        obj = cls(np.where(finite, arr, 0.0), opening_angle, quantity,
                  {"sim": dir_in}, map_file, device)
        if not finite.all():
            obj.data["mask"] = finite.astype(np.float64)
        return obj

    @classmethod
    def from_file(cls, map_file: str, opening_angle: float = 0.0,
                  quantity: str = "kappa_2", dir_in: str = "",
                  nside: Optional[int] = None, convert_unit: bool = True,
                  device=None) -> "SkyNamaster":
        """A layer from a `.npy` map (the `.h5` ray columns need
        SkyHealpix and raise)."""
        ext = map_file.rsplit(".", 1)[-1]
        if ext == "h5":
            raise NotImplementedError(
                "SkyNamaster.from_file(.h5) needs SkyHealpix, which is not "
                "ported yet: it waits for the SHT stack, ROADMAP.md queue 1 "
                "item 6")
        if ext == "npy":
            return cls.from_array(np.load(map_file), opening_angle,
                                  quantity, dir_in, map_file, device)
        raise ValueError(f"unsupported map file format: {ext}")

    def set_mask(self, mask) -> None:
        self.data["mask"] = np.asarray(mask, np.float64)
        self._workspace.clear()  # cached couplings belong to the old mask

    # ------------------------------------------------------ shared plumbing
    def _resolve_mask(self, mask, like):
        """(mask, mask_is_stored): per-call mask, stored mask, or a
        trivial all-ones fallback. The workspace caches per stored mask
        only: a per-call mask has no stable identity (a stale matrix would
        silently bias the decoupled spectrum); the trivial fallback also
        gets a stable identity."""
        mask_is_stored = mask is None and "mask" in self.data
        if mask is None:
            mask = self.data.get("mask")
        if mask is None:
            like = (like.detach().cpu().numpy()
                    if isinstance(like, torch.Tensor) else like)
            mask = np.ones_like(np.asarray(like))
            mask_is_stored = True
        return mask, mask_is_stored

    def _coupling(self, key, mask, mask_is_stored, build, dev):
        """The cached coupling of a stored mask, else `build` of the mask
        in float64 where the spectra run on `dev` (numpy on the CPU, a
        tensor on the card)."""
        coupling = self._workspace.get(key) if mask_is_stored else None
        if coupling is None:
            if isinstance(mask, torch.Tensor):
                mask = mask.detach().cpu().numpy()
            m64 = np.asarray(mask, np.float64)
            if dev.type != "cpu":
                m64 = torch.from_numpy(m64).to(dev)
            coupling = build(m64, self.opening_angle, key[1])
            if mask_is_stored:
                self._workspace[key] = coupling
        return coupling

    # -------------------------------------------------------------- spectra
    def compute_cl(self, mask=None, lmax: Optional[int] = None,
                   nbins: int = 16, of: str = "orig",
                   decouple: bool = True, niter: int = 3):
        """Masked spectrum of a layer (the reference's intended
        compute_master flow). decouple=True inverts the mode-coupling
        matrix (MASTER band powers, cached per stored mask and binning);
        decouple=False gives the <w^2> pseudo-Cl normalization. Returns
        (ell, cl)."""
        from ..ops import angular_power as AP

        if not self.flat:
            raise NotImplementedError(_FULL_SKY)
        mask, mask_is_stored = self._resolve_mask(mask, self.data[of])
        dev = default_device(self.device)
        m = as_tensor(self.data[of], dev)
        w = as_tensor(mask, dev)
        if not decouple:
            return AP.cl_flat_sky_masked(m, w, self.opening_angle,
                                         nbins=nbins)
        coupling = self._coupling(("flat", nbins), mask, mask_is_stored,
                                  AP.flat_sky_coupling_matrix, dev)
        return AP.cl_flat_sky_master(m, w, self.opening_angle, nbins=nbins,
                                     coupling=coupling)

    def compute_cl_spin2(self, gamma1, gamma2, mask=None,
                         nbins: int = 16, decouple: bool = True,
                         lmax: Optional[int] = None, niter: int = 3):
        """Masked shear spectra (ell, Cl_EE, Cl_BB): decouple=True solves
        the 2x2-block (EE, BB) mode-coupling system
        (cl_flat_sky_shear_master), undoing the power the mask removes and
        the E -> B leakage it makes; the couplings cache per stored mask
        like compute_cl's. decouple=False returns the <w^2>-normalized
        pseudo E/B spectra. Shear tensors keep their device; numpy goes
        where compute_cl runs."""
        from ..ops import angular_power as AP

        if not self.flat:
            raise NotImplementedError(_FULL_SKY)
        if lmax is not None:
            raise ValueError(
                "compute_cl_spin2: lmax applies to full-sky HEALPix "
                "fields; flat-sky band ranges are set by nbins (and the "
                "estimator's ell_min/ell_max)")
        mask, mask_is_stored = self._resolve_mask(mask, gamma1)
        dev = (gamma1.device if isinstance(gamma1, torch.Tensor)
               else default_device(self.device))
        g1, g2 = as_tensor(gamma1, dev), as_tensor(gamma2, dev)
        w = as_tensor(mask, dev)
        if not decouple:
            w2 = torch.clamp_min(torch.mean(w ** 2), 1e-12)
            ell, ee, bb = AP.cl_shear_eb(g1 * w, g2 * w, self.opening_angle,
                                         nbins=nbins)
            return ell, ee / w2, bb / w2
        coupling = self._coupling(("flat-spin2", nbins), mask,
                                  mask_is_stored,
                                  AP.flat_sky_spin2_coupling_matrices, dev)
        return AP.cl_flat_sky_shear_master(g1, g2, w, self.opening_angle,
                                           nbins=nbins, coupling=coupling)
