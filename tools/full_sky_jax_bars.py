#!/usr/bin/env python3
"""The JAX package on the CPU against the bars of `chip_smoke.py` phase
18 (b), at nside 64 with the card run's ratios (lmax = 2 nside, the
super-Nyquist lmax = 3 nside - 1):

    JAX_PLATFORMS=cpu python3 tools/full_sky_jax_bars.py [--nside N]

(b)'s bars hold the port at nside 1024; a bar the reference itself misses
at this size with the same ratios would be set to 1.5 times what it
reaches. On examples/full_pipeline.py's C_l = 2e-9 / max(l(l+1), 1): a
synfast_large / anafast_large round trip (band pulls in 16 log bands over
2 <= l <= 1.5 nside, sigma = C_b sqrt(2 / modes)); C_EE / C_kk (l+2)(l-1)
/ (l(l+1)) by band and sum BB / sum EE through SkyHealpix on the scan path
(1e4 times the round-trip map as kappa); CG and Jacobi (niter 3) at
3 nside - 1 against one realization's own alms over 2 nside < l. Prints
one JSON object. Needs JAX; about a minute.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=64)
    nside = ap.parse_args().nside

    import jax
    import jax.numpy as jnp

    from astrild_tpu.models import skyhealpix as SH
    from astrild_tpu.ops import sht as JS
    from astrild_tpu.ops import sht_large as JL

    lmax = 2 * nside
    ell = np.arange(3 * nside, dtype=np.float64)
    cl = 2e-9 / np.maximum(ell * (ell + 1.0), 1.0)
    edges = np.unique(np.round(np.geomspace(2, 1.5 * nside, 17)).astype(int))
    m = JL.synfast_large(jax.random.PRNGKey(0),
                         cl[: lmax + 1].astype(np.float32), nside, lmax)
    c = np.asarray(JL.anafast_large(m, lmax, niter=3))
    pulls = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        w = 2 * ell[lo:hi] + 1
        cb = (w * cl[lo:hi]).sum() / w.sum()
        pulls.append(((w * c[lo:hi]).sum() / w.sum() - cb)
                     / (cb * np.sqrt(2 / w.sum())))

    sky = SH.SkyHealpix(np.asarray(m) * 1e4)
    kk = sky.anafast(lmax, niter=3)
    old = SH._TABLE_LMAX_LIMIT
    SH._TABLE_LMAX_LIMIT = 8      # the scan path, as at nside 1024
    try:
        sky.shear_from_kappa(lmax=lmax)
        ee, bb, _ = sky.shear_eb_spectra(lmax=lmax)
    finally:
        SH._TABLE_LMAX_LIMIT = old
    e = ell[: lmax + 1]
    fac = np.where(e >= 2, (e + 2) * (e - 1) / np.maximum(e * (e + 1), 1),
                   0.0)
    ee_dev = max(abs(ee[max(lo, 2):hi].sum()
                     / (kk * fac)[max(lo, 2):hi].sum() - 1)
                 for lo, hi in zip(edges[:-1], edges[1:]))

    L = 3 * nside - 1
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    lg, mg = np.arange(L + 1)[:, None], np.arange(L + 1)[None, :]
    sig = np.sqrt(cl[: L + 1].astype(np.float32))[:, None]
    a_re = np.asarray(jax.random.normal(k1, (L + 1, L + 1))) * sig * (mg <= lg)
    a_im = np.asarray(jax.random.normal(k2, (L + 1, L + 1))) * sig * (mg <= lg)
    a_re = np.where(mg == 0, a_re, a_re * np.sqrt(0.5)).astype(np.float32)
    a_im = np.where(mg == 0, 0.0, a_im * np.sqrt(0.5)).astype(np.float32)
    c_real = np.asarray(JS.alm2cl(jnp.asarray(a_re), jnp.asarray(a_im)))
    mm = JL.synthesize_large(a_re, a_im, nside, L)
    hi_band = np.arange(L + 1) > 2 * nside
    bias = {method: float(np.asarray(JL.anafast_large(
        mm, L, niter=3, method=method))[hi_band].mean()
        / c_real[hi_band].mean() - 1.0) for method in ("cg", "jacobi")}
    print(json.dumps({"nside": nside,
                      "round_trip_max_pull": float(np.abs(pulls).max()),
                      "ee_over_kk_max_dev": float(ee_dev),
                      "bb_over_ee": float(bb[2:].sum() / ee[2:].sum()),
                      "above_2nside_bias": bias}))


if __name__ == "__main__":
    main()
