#!/usr/bin/env python3
"""The JAX package on the CPU against the checks of `chip_smoke.py` phase
19 (# cmb_lensing), at the card run's ratios scaled down by 8 in nside:

    JAX_PLATFORMS=cpu python3 tools/cmb_lensing_jax_bars.py [--nside N]

The card runs nside 1024, lmax 2048 on an evolved 512^3 snapshot of a 500
Mpc/h box; here a 128^3 snapshot of the same box evolved by the JAX
package's pm_catalog (the same particles per pixel at nside 128) gives
five HEALPix shells over 150-650 Mpc/h at nside N, lmax 2 N. Measured:
(b) the traced kappa (chi_s = 700) against the band-limited Born map
(pixel correlation, C_l ratio in 8 log bands over 10 <= l <= 1.5 N),
that gap split into the tracer's 0.02-pixel nudge (the Born map read at
its nudged ray grid) and the post-Born rest, the same readings of the
port on the CPU on the same shells and its kappa against the JAX
package's, omega's power over kappa's, the traced shear's BB/EE, the near source of
the tomographic pair (450, 700) against its own scalar run, one shell
against w * kap_bl; (c) a CMB (C_l = 1e-10 / (l(l+1)) exp(-(l / l_D)^2),
l_D = 1500 N / 1024) lensed by that kappa: the zero-kappa shift, lensed -
unlensed against alpha . grad T (correlation, rms ratio), the nudge's C_l
bias against an un-nudged remap; (d) the TT QE of the lensed and unlensed
maps (lmax_filter 2 N, lmax_out N): the cross ratio of their difference
with the input kappa in 6 log bands over 30 N / 1024 <= L <= N, N0 > 0;
(e) the flat-sky QEs at the card's own configuration (8 patches of
1024^2 over 10 deg). Prints one JSON object. Needs JAX; ~6 minutes at
nside 128, longer at 256.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _log_bands(lo, hi, n):
    return np.unique(np.round(np.geomspace(lo, hi + 1, n + 1)).astype(int))


def _band_ratio(a, b, edges):
    return np.array([a[lo:hi].sum() / b[lo:hi].sum()
                     for lo, hi in zip(edges[:-1], edges[1:])])


def _cross(ar, ai, br, bi):
    """Cross C_l of two alm sets: (ab_l0 + 2 sum_{m>0} Re ab*) / (2l+1)."""
    L = ar.shape[0] - 1
    w = np.where(np.arange(L + 1) == 0, 1.0, 2.0)[None, :]
    p = np.tril(ar * br + ai * bi)
    return (p * w).sum(1) / (2 * np.arange(L + 1) + 1.0)


def _port_tracer(delta, chis, dchis, nside, lmax, bands, jax_kappa):
    """The port on the CPU on the same shells: (b)'s correlation and C_l
    ratios, and its traced kappa against the JAX package's."""
    from astrild_tpu_torch.ops import lightcone_sphere as tlcs
    from astrild_tpu_torch.ops import sht_large as tsl

    chis, dchis = np.asarray(chis), np.asarray(dchis)
    kap = tlcs.multiplane_raytrace_healpix(delta, chis, dchis, 700.0, 0.3,
                                           lmax=lmax, device="cpu")["kappa"]
    born = tlcs.born_convergence_healpix(delta, chis, dchis, 700.0, 0.3,
                                         device="cpu")
    br, bi = tsl.analyze_large(born, nside, lmax, niter=0)
    bl = tsl.synthesize_large(br, bi, nside, lmax).numpy()
    kap = kap.numpy()
    ratio = _band_ratio(tsl.anafast_large(kap, lmax, niter=0,
                                          device="cpu").numpy(),
                        tsl.anafast_large(bl, lmax, niter=0,
                                          device="cpu").numpy(), bands)
    return {"corr_traced_born_bl": float(np.corrcoef(kap, bl)[0, 1]),
            "cl_ratio_bands": ratio.tolist(),
            "kappa_vs_jax_max_abs": float(np.abs(kap - jax_kappa).max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=128)
    nside = ap.parse_args().nside

    import jax
    import jax.numpy as jnp

    from astrild_tpu.models.skyhealpix import SkyHealpix
    from astrild_tpu.ops import cmb_lensing as cml
    from astrild_tpu.ops import lightcone_sphere as lcs
    from astrild_tpu.ops import linear_power, nbody
    from astrild_tpu.ops import sht_large as sl
    from astrild_tpu.ops import sht_spin_large as ssl
    from astrild_tpu.utils import healpix as hpx
    from astrild_tpu.utils import healpix_jax as hpj
    from astrild_tpu.utils.cosmology import Cosmology

    out = {"nside": nside}
    lmax = 2 * nside
    box = 500.0
    gr = Cosmology(Om0=0.3, h=0.7)
    amp = linear_power.normalization(gr)
    comps, _ = nbody.pm_catalog(
        jax.random.PRNGKey(0), gr,
        lambda k: linear_power.linear_power(k, gr, 0.0, amplitude=amp),
        128, box, nsteps=20)
    edges = np.linspace(150.0, 650.0, 6)
    delta, chis, dchis = lcs.density_shells_healpix(
        tuple(np.asarray(c) for c in comps), edges, nside, box)
    delta = np.asarray(delta)

    # ---- (b) the tracer
    traced = lcs.multiplane_raytrace_healpix(delta, chis, dchis, 700.0, 0.3,
                                             lmax=lmax)
    born = np.asarray(lcs.born_convergence_healpix(delta, chis, dchis,
                                                   700.0, 0.3))
    br, bi = sl.analyze_large(born, nside, lmax, niter=0)
    born_bl = np.asarray(sl.synthesize_large(br, bi, nside, lmax))
    kap = np.asarray(traced["kappa"])
    bands = _log_bands(10, int(1.5 * nside), 8)
    c_k = np.asarray(sl.anafast_large(kap, lmax, niter=0))
    c_b = np.asarray(sl.anafast_large(born_bl, lmax, niter=0))
    c_w = np.asarray(sl.anafast_large(np.asarray(traced["omega"]), lmax,
                                      niter=0))
    sky = SkyHealpix(kap)
    sky.data["gamma1"] = np.asarray(traced["gamma1"])
    sky.data["gamma2"] = np.asarray(traced["gamma2"])
    ee, bb, _ = sky.shear_eb_spectra(lmax=lmax)
    tomo = lcs.multiplane_raytrace_healpix(
        delta, chis, dchis, np.array([450.0, 700.0], np.float32), 0.3,
        lmax=lmax)
    near = lcs.multiplane_raytrace_healpix(delta, chis, dchis, 450.0, 0.3,
                                           lmax=lmax)
    one = lcs.multiplane_raytrace_healpix(delta[-1:], chis[-1:], dchis[-1:],
                                          700.0, 0.3, lmax=lmax)
    from astrild_tpu.ops.raytrace import effective_plane_kappa
    ke = effective_plane_kappa(jnp.asarray(delta[-1]), chis[-1], dchis[-1],
                               1.0, 0.3)
    r, i = sl.analyze_large(ke, nside, lmax, niter=0)
    w_bl = (1 - float(chis[-1]) / 700.0) * np.asarray(
        sl.synthesize_large(r, i, nside, lmax))
    ratio = _band_ratio(c_k, c_b, bands)
    # the gap split as phase 19 splits it: the Born map read at the
    # tracer's nudged ray grid (0.02 pixel) against the rest
    nudge = 0.02 * float(np.sqrt(np.pi / 3.0)) / nside
    t0, p0 = (np.asarray(a, np.float32) for a in
              hpx.pix2ang_ring(nside, np.arange(12 * nside ** 2)))
    bl_read = np.asarray(hpj.get_interp_val(
        born_bl, np.clip(t0 + nudge, 0.0, np.pi), p0 + nudge))
    c_r = np.asarray(sl.anafast_large(bl_read, lmax, niter=0))
    out["b"] = {
        "corr_traced_born_bl": float(np.corrcoef(kap, born_bl)[0, 1]),
        "cl_ratio_bands": ratio.tolist(),
        "cl_ratio_max_dev": float(np.abs(ratio - 1).max()),
        "nudge_cl_ratio_bands": _band_ratio(c_r, c_b, bands).tolist(),
        "post_born_cl_ratio_bands": _band_ratio(c_k, c_r, bands).tolist(),
        "post_born_corr": float(np.corrcoef(kap, bl_read)[0, 1]),
        "omega_over_kappa_power": float(c_w[2:].sum() / c_k[2:].sum()),
        "bb_over_ee": float(bb[2:].sum() / ee[2:].sum()),
        "near_vs_scalar": float(np.abs(np.asarray(tomo["kappa"][0])
                                       - np.asarray(near["kappa"])).max()),
        "far_vs_scalar": float(np.abs(np.asarray(tomo["kappa"][1])
                                      - kap).max()),
        "one_shell_vs_w_kap_bl": float(
            np.abs(np.asarray(one["kappa"]) - w_bl).max()
            / np.abs(w_bl).max()),
        "kappa_rms": float(kap.std())}

    out["b_port_cpu"] = _port_tracer(delta, chis, dchis, nside, lmax, bands,
                                     kap)

    # ---- (c) the lensed CMB
    ell = np.arange(lmax + 1, dtype=np.float64)
    l_d = 1500.0 * nside / 1024
    cl_tt = np.zeros(lmax + 1)
    cl_tt[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1.0)) \
        * np.exp(-(ell[2:] / l_d) ** 2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    L = lmax
    lg, mg = np.arange(L + 1)[:, None], np.arange(L + 1)[None, :]
    sig = np.sqrt(cl_tt)[:, None]
    t_re = np.asarray(jax.random.normal(k1, (L + 1, L + 1))) * sig * (mg <= lg)
    t_im = np.asarray(jax.random.normal(k2, (L + 1, L + 1))) * sig * (mg <= lg)
    t_re = np.where(mg == 0, t_re, t_re * np.sqrt(0.5)).astype(np.float32)
    t_im = np.where(mg == 0, 0.0, t_im * np.sqrt(0.5)).astype(np.float32)
    cmb = np.asarray(sl.synthesize_large(t_re, t_im, nside, L))
    sky = SkyHealpix(np.zeros_like(cmb))
    lensed = sky.lens_cmb_from_kappa(cmb, kap, lmax=L)
    still = sky.lens_cmb_from_kappa(cmb, np.zeros_like(kap), lmax=L)
    kr, ki = sl.analyze_large(kap, nside, L, niter=0)
    a_t, a_p = (np.asarray(a) for a in
                ssl.deflection_from_kappa_alm_large(kr, ki, nside, L))
    g = np.sqrt(ell * (ell + 1.0)).astype(np.float32)[:, None]
    z = np.zeros_like(t_re)
    g_t, g_p = (np.asarray(a) for a in ssl.synthesize_spin1_large(
        t_re * g, t_im * g, z, z, nside, L))
    first = a_t * g_t + a_p * g_p
    diff = lensed - cmb
    npix = hpx.nside2npix(nside)
    th, ph = hpj.pix2ang_ring(nside, jnp.arange(npix, dtype=jnp.int32))
    ts = jnp.clip(th + a_t, 0.0, jnp.pi)
    ps = ph + a_p / jnp.maximum(jnp.sin(th), 1e-6)
    pix, wgt = hpj.get_interp_weights(nside, ts, ps)
    un = np.asarray(jnp.sum(jnp.asarray(cmb - cmb.mean(), jnp.float32)[pix]
                            * wgt, axis=0)) + cmb.mean()
    c_n = np.asarray(sl.anafast_large(lensed, L, niter=0))
    c_u = np.asarray(sl.anafast_large(un, L, niter=0))
    nb = _band_ratio(c_n, c_u, _log_bands(10, L, 8))
    out["c"] = {
        "zero_kappa_shift_over_max": float(np.abs(still - cmb).max()
                                           / np.abs(cmb).max()),
        "first_order_corr": float(np.corrcoef(diff, first)[0, 1]),
        "first_order_rms_ratio": float(diff.std() / first.std()),
        "nudge_cl_bias_max": float(np.abs(nb - 1).max()),
        "imprint_over_cmb_rms": float(diff.std() / cmb.std())}

    # ---- (d) the curved-sky QE
    Lo = nside
    q1 = cml.qe_tt_kappa_healpix(lensed.astype(np.float32), cl_tt, lmin=2,
                                 lmax_filter=L, lmax_out=Lo)
    q0 = cml.qe_tt_kappa_healpix(cmb.astype(np.float32), cl_tt, lmin=2,
                                 lmax_filter=L, lmax_out=Lo)
    kr_o, ki_o = (np.asarray(a) for a in sl.analyze_large(kap, nside, Lo,
                                                          niter=0))
    dr = np.asarray(q1[0]) - np.asarray(q0[0])
    di = np.asarray(q1[1]) - np.asarray(q0[1])
    cx = _cross(dr, di, kr_o, ki_o)
    ca = _cross(kr_o, ki_o, kr_o, ki_o)
    qb = _log_bands(max(2, round(30 * nside / 1024)), Lo, 6)
    qr = _band_ratio(cx, ca, qb)
    n0 = np.asarray(q1[2])
    out["d"] = {"cross_ratio_bands": qr.tolist(),
                "cross_ratio_max_dev": float(np.abs(qr - 1).max()),
                "n0_positive_finite": bool(np.all(np.isfinite(n0[qb[0]:]))
                                           and np.all(n0[qb[0]:] > 0))}

    # ---- (e) the flat sky at the card's own configuration: 8 patches of
    # 1024^2 over 10 deg, the TT filter over 40 <= l <= 3000, EB's over
    # 40 <= l <= 1500
    n, fov = 1024, np.deg2rad(10.0)
    lf = 2 * np.pi / fov
    lmax_flat = 9000
    ellf = np.arange(lmax_flat + 1, dtype=np.float64)
    cl_f = np.zeros(lmax_flat + 1)
    cl_f[2:] = 1e-10 / (ellf[2:] * (ellf[2:] + 1.0)) \
        * np.exp(-(ellf[2:] / 2000.0) ** 2)
    cl_kk = np.zeros(lmax_flat + 1)
    cl_kk[2:] = 3e-7 / (1 + ellf[2:] / 300.0) ** 2
    pix = fov / n
    lx = np.fft.fftfreq(n)[:, None] * n * lf
    ly = np.fft.fftfreq(n)[None, :] * n * lf
    lm = np.hypot(lx, ly)

    def grf(seed, cl):
        w = np.random.default_rng(seed).standard_normal((n, n))
        c = np.interp(lm, np.arange(len(cl)), cl, left=0, right=0)
        return (np.real(np.fft.ifft2(np.fft.fft2(w) * np.sqrt(c))) / pix
                ).astype(np.float32)

    R = cml.qe_tt_response(n, fov, cl_f, lmin=40, lmax_filter=3000)
    n0 = np.asarray(cml.qe_tt_n0_kappa(n, fov, cl_f, lmin=40,
                                       lmax_filter=3000))
    idx = np.digitize(lm.ravel(), np.linspace(100, 1000, 5)) - 1
    cx = ca = 0.0
    auto = []
    band = (lm > 4 * lf) & (lm < 18 * lf)
    for r in range(8):
        t, kf = grf(10 + r, cl_f), grf(90 + r, cl_kk)
        tl = np.asarray(cml.lens_cmb_map_flat(t, kf, fov))
        kh = np.asarray(cml.qe_tt_kappa(tl, fov, cl_f, lmin=40,
                                        lmax_filter=3000, response=R)[0])
        k0 = np.asarray(cml.qe_tt_kappa(t, fov, cl_f, lmin=40,
                                        lmax_filter=3000, response=R)[0])
        fa = np.fft.fft2(kh).ravel()
        fk = np.fft.fft2(kf).ravel()
        cr = np.real(fa * np.conj(fk))
        cx = cx + np.array([cr[idx == i].mean() for i in range(4)])
        ca = ca + np.array([(np.abs(fk) ** 2)[idx == i].mean()
                            for i in range(4)])
        auto.append(np.mean((np.abs(pix ** 2 * np.fft.fft2(k0)) ** 2
                             / fov ** 2)[band]))
    fr = cx / ca
    # EB: the unlensed null and the pure-mode response
    cl_ee = cl_f * 0.4
    x = np.arange(n) * pix

    def qu(seed):
        w = np.random.default_rng(seed).standard_normal((n, n))
        l2 = lx ** 2 + ly ** 2
        safe = np.where(l2 == 0, 1, l2)
        c2 = np.where(l2 == 0, 1, (lx ** 2 - ly ** 2) / safe)
        s2 = np.where(l2 == 0, 0, 2 * lx * ly / safe)
        c = np.interp(lm, np.arange(len(cl_ee)), cl_ee, left=0, right=0)
        ek = np.fft.fft2(w) * np.sqrt(c) / pix
        return (np.real(np.fft.ifft2(c2 * ek)).astype(np.float32),
                np.real(np.fft.ifft2(s2 * ek)).astype(np.float32))

    A, L0 = 3e-3, 6 * lf
    kap_mode = (A * np.cos(L0 * x)[:, None] * np.ones((1, n))).astype(
        np.float32)
    acc = 0.0
    nulls, lens_std = [], []
    for r in range(8):
        q, u = qu(700 + r)
        ql = np.asarray(cml.lens_cmb_map_flat(q, kap_mode, fov))
        ul = np.asarray(cml.lens_cmb_map_flat(u, kap_mode, fov))
        k1 = np.asarray(cml.qe_eb_kappa(ql, ul, fov, cl_ee, lmin=40,
                                        lmax_filter=1500)[0])
        k0 = np.asarray(cml.qe_eb_kappa(q, u, fov, cl_ee, lmin=40,
                                        lmax_filter=1500)[0])
        acc = acc + (k1 - k0)
        nulls.append(k0.std())
        lens_std.append(k1.std())
    proj = 2 * np.mean(acc / 8 * np.cos(L0 * x)[:, None]) / A
    out["e"] = {"tt_cross_ratio_bands": fr.tolist(),
                "tt_cross_ratio_max_dev": float(np.abs(fr - 1).max()),
                "tt_auto_over_n0": float(np.mean(auto)
                                         / np.mean(n0[band])),
                "eb_null_over_lensed": float(np.mean(nulls)
                                             / np.mean(lens_std)),
                "eb_pure_mode_response": float(proj)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
