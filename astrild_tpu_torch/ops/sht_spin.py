"""Wigner d-function rows for the curved-sky two-point sums.

Host copy of `_wigner_d_l_rows` of astrild_tpu/ops/sht_spin.py (numpy,
float64, bit for bit). The spin-weighted harmonic transforms of that module
are not ported yet.
"""
from __future__ import annotations

from math import lgamma

import numpy as np

__all__ = ["_wigner_d_l_rows"]


def _wigner_d_l_rows(lmax: int, x: np.ndarray, m1: int, m: int):
    """d^l_{m1, m}(x) for all l <= lmax at the nodes x — one (m1, m)
    column of the Wigner d cube without materializing the (L+1)^2 cube.
    Host float64; (lmax+1, nx). Requires m >= |m1| (the seed branch the
    couplings use: m=2, m1=+-2)."""
    assert m >= abs(m1)
    x = np.asarray(x, np.float64)
    out = np.zeros((lmax + 1, x.size))
    l0 = m
    if l0 > lmax:
        return out
    ch = np.sqrt((1.0 + x) / 2.0)
    sh = np.sqrt((1.0 - x) / 2.0)
    lnC = 0.5 * (lgamma(2 * m + 1) - lgamma(m + m1 + 1)
                 - lgamma(m - m1 + 1))
    d0 = ((-1.0) ** (m - m1) * np.exp(lnC)
          * ch ** (m + m1) * sh ** (m - m1))
    out[l0] = d0
    dm1, dm2 = d0, np.zeros_like(d0)
    for l in range(l0 + 1, lmax + 1):
        den = (l - 1.0) * np.sqrt((l * l - m1 * m1) * (l * l - m * m))
        if den == 0.0:
            # only the (m1=0, m=0, l=1) step degenerates (0/0); its
            # limit is the Legendre relation d^1_{00} = x d^0_{00}
            d = x * dm1
        else:
            a = (2.0 * l - 1.0) * (l * (l - 1.0) * x - m1 * m) / den
            b = (l * np.sqrt(((l - 1.0) ** 2 - m1 * m1)
                             * ((l - 1.0) ** 2 - m * m)) / den)
            d = a * dm1 - b * dm2
        out[l] = d
        dm2, dm1 = dm1, d
    return out
