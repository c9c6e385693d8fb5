"""The MASTER band-power shape model, the part of astrild_tpu/ops/sht.py
that the flat-sky estimators need.

Only `shape_binned_interp` is ported here, a host float64 numpy copy, bit
for bit. The spherical harmonic transforms themselves (synthesis,
analysis, the full-sky MASTER estimators) wait for the SHT stack (ROADMAP
queue 1 item 6), which moves them into this module.
"""
from __future__ import annotations

import numpy as np

__all__ = ["shape_binned_interp"]


def _check_bands(counts, what: str) -> None:
    """Raise on an empty band: a singular banded system otherwise surfaces
    as an opaque LinAlgError from the downstream solve."""
    empty = np.nonzero(counts <= 0)[0]
    if empty.size:
        raise ValueError(
            f"MASTER binning: band(s) {empty.tolist()} contain no "
            f"{what} — reduce nbins (each of the {counts.shape[0]} "
            "bands must contain at least one) or widen the range")


def shape_binned_interp(ell_values, member, counts,
                        what: str = "multipoles") -> np.ndarray:
    """(nbins, N) in-band l(l+1) shape-model interpolation operator q.

    The single home of the MASTER band-power shape model: within band b
    the spectrum is modeled as C = c_b * s * N_b / sum_b(s) with
    s = 1/(l(l+1)), so the band power c_b stays the plain band average of
    C while steep in-band variation does not bias the decoupling solve
    (NaMaster's convention). Host float64 throughout.

    ell_values: (N,) per-element multipole values; member: (nbins, N)
    0/1 band membership; counts: (nbins,) members per band. Raises
    ValueError on an empty band.
    """
    member = np.asarray(member, np.float64)
    counts = np.asarray(counts, np.float64)
    _check_bands(counts, what)
    s = _shape(np.asarray(ell_values, np.float64))
    ssum = member @ s
    return member * s[None, :] * _band_scale(counts, ssum)[:, None]


def _shape(ell_values):
    """s = 1/max(l(l+1), 1) of a float64 numpy array or torch tensor: the
    model's in-band shape, shared with the flat-sky coupling built on the
    card (`angular_power._card_couplings`)."""
    return 1.0 / (ell_values * (ell_values + 1.0)).clip(min=1.0)


def _band_scale(counts, shape_sums):
    """N_b / sum_{l in b} s per band, numpy or torch: the factor that keeps
    the band power c_b the plain band average."""
    return counts / shape_sums.clip(min=1e-300)
