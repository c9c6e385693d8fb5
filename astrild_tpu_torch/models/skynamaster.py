"""SkyNamaster: mask-decoupled angular power spectra, flat and full sky.

Port of astrild_tpu/models/skynamaster.py. Flat-sky patches go through the
MASTER estimators of ops.angular_power (the exact discrete DFT coupling
matrix); full-sky HEALPix maps through ops.sht.anafast_master and
ops.sht_spin.anafast_spin2_master (coupling matrices from the mask's own
Cl by exact Gauss-Legendre quadrature, host float64; a unit mask takes
its exact spectrum 4 pi delta_l0). The couplings cache per stored mask and
binning, so many maps under one mask pay the build once. The `.h5` branch
of `from_file` bins ray columns through SkyHealpix.

Maps are stored as numpy, as in the JAX package; `compute_cl` and
`compute_cl_spin2` run on `device` (by default the CUDA card; it raises
without one, pass device="cpu" there) and return tensors there. On the
card the flat-sky coupling matrices are built on the card, on the CPU
with the JAX package's numpy code.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..utils import healpix as hp

__all__ = ["SkyNamaster"]

class SkyNamaster:
    """Masked-spectrum analysis of one sky layer (full- or flat-sky)."""

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
        """A layer from .h5 ray columns (unit-converted and binned to
        nside on the host by SkyHealpix) or a `.npy` map."""
        ext = map_file.rsplit(".", 1)[-1]
        if ext == "h5":
            from .skyhealpix import SkyHealpix

            sh = SkyHealpix.from_file(map_file, quantity, nside=nside,
                                      convert_unit=convert_unit,
                                      device="cpu")
            return cls.from_array(sh.data["orig"].numpy(), opening_angle,
                                  quantity, dir_in, map_file, device)
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

    def _mask_cl(self, mask, lmax_mask: int, niter: int, dev):
        """Mask pseudo-spectrum (host float64) for the full-sky coupling
        builds, through the table or scan path by lmax on `dev`; a unit
        mask returns the exact 4 pi delta_l0 (the estimated wl of a ones
        map carries niter noise and costs a transform for a matrix that is
        the identity)."""
        from ..ops import sht

        m = sht._host64(mask)
        if np.all(m == 1.0):
            wl = np.zeros(lmax_mask + 1)
            wl[0] = 4.0 * np.pi
            return wl
        return sht._host64(sht._analysis_cl(as_tensor(m, dev), lmax_mask,
                                            niter))

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

        mask, mask_is_stored = self._resolve_mask(mask, self.data[of])
        dev = default_device(self.device)
        m = as_tensor(self.data[of], dev)
        w = as_tensor(mask, dev)
        if not self.flat:
            return self._compute_cl_full(m, w, mask, mask_is_stored, lmax,
                                         nbins, decouple, niter, dev)
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
        where compute_cl runs.

        On the full sky with decouple=False and lmax above 512 the pseudo
        spectra take the scan path (sht_spin_large) where the JAX package
        builds the spin-2 table: they differ from its result by the gap of
        the float32 scan recursion to the table, which grows with lmax
        (ROADMAP.md section 3)."""
        from ..ops import angular_power as AP

        if not self.flat:
            return self._compute_cl_spin2_full(gamma1, gamma2, mask, nbins,
                                               decouple, lmax, niter)
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

    def _compute_cl_full(self, m, w, mask, mask_is_stored, lmax, nbins,
                         decouple, niter, dev):
        """compute_cl of a HEALPix map: lmax defaults to min(2 nside, 512)
        (anafast_master takes the scan path above 512)."""
        from ..ops import sht

        if lmax is None:
            lmax = min(2 * self.nside, 512)
        if not decouple:
            ell = torch.arange(lmax + 1, dtype=torch.float32, device=dev)
            return ell, sht.anafast_masked(m, w, lmax, niter=niter)
        # niter is part of the key: the coupling is built from a mask
        # pseudo-Cl estimated at that niter
        coupling = self._coupling(
            ("full", lmax, niter), mask, mask_is_stored,
            lambda m64, *_: sht.coupling_matrix_from_mask_cl(
                self._mask_cl(m64, min(2 * lmax, 2 * self.nside), niter,
                              dev), lmax), dev)
        return sht.anafast_master(m, w, lmax, nbins=nbins, niter=niter,
                                  coupling=coupling)

    def _compute_cl_spin2_full(self, gamma1, gamma2, mask, nbins, decouple,
                               lmax, niter):
        """compute_cl_spin2 of HEALPix (Q, U) maps through the spin-2
        MASTER solve; the couplings cache like compute_cl's."""
        from ..ops import sht_spin

        mask, mask_is_stored = self._resolve_mask(mask, gamma1)
        dev = (gamma1.device if isinstance(gamma1, torch.Tensor)
               else default_device(self.device))
        g1, g2 = as_tensor(gamma1, dev), as_tensor(gamma2, dev)
        w = as_tensor(mask, dev)
        if lmax is None:
            lmax = min(2 * self.nside, 512)
        if not decouple:
            w2 = torch.clamp_min(torch.mean(w ** 2), 1e-12)
            ee, bb, _ = sht_spin._analysis_spin2_cl(g1 * w, g2 * w, lmax,
                                                    niter)
            ell = torch.arange(lmax + 1, dtype=torch.float32, device=dev)
            return ell, ee / w2, bb / w2
        coupling = self._coupling(
            ("full-spin2", lmax, niter), mask, mask_is_stored,
            lambda m64, *_: sht_spin.spin2_coupling_matrices_from_mask_cl(
                self._mask_cl(m64, min(2 * lmax, 2 * self.nside), niter,
                              dev), lmax), dev)
        return sht_spin.anafast_spin2_master(g1, g2, w, lmax, nbins=nbins,
                                             niter=niter, coupling=coupling)
