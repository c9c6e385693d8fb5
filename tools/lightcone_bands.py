#!/usr/bin/env python3
"""The lightcone lane of both packages on the CPU at a small size that
keeps the card run's resolution: C_ell / halofit by band, and the
ray-traced against the Born convergence.

    JAX_PLATFORMS=cpu python3 tools/lightcone_bands.py [--seed S] [--npart N]

`chip_smoke.py` drives `pm_lightcone_planes` at 512^3 particles in a 500
Mpc/h box with a 0.2 rad field of 2048^2 pixels. This script shrinks box
and field together (N^3 particles in a box of 500 N / 512 Mpc/h, a field of
0.2 N / 512 rad with 4 N pixels a side), so the mesh cell (0.98 Mpc/h), the
particle density, the pixel (0.34 arcmin) and therefore the ell bands of
`cl_flat_sky(nbins=10)` are the card run's; only the number of modes in a
band shrinks. Thinner planes follow from the smaller box (dchi <= box).
The same numpy white noise and observer shifts go through the JAX package
(its `pm_lightcone_planes` loop from explicit modes) and through the port.
It prints one JSON object with, for each package, the band ratios, the
mean over bands 1-4 and the correlation of ray-traced and Born kappa at
the pixel scale and on 8 x 8 block means. Needs JAX; about 3 minutes.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

Z_SOURCE, Z_INIT, STEPS_INIT, STEPS_PLANE = 1.0, 9.0, 8, 2
COSMO = {"Om0": 0.3, "h": 0.7}


def corr(a, b) -> float:
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    return float((a * b).sum() / math.sqrt((a * a).sum() * (b * b).sum()))


def block_mean(img, f: int):
    n = img.shape[-1] // f
    return np.asarray(img).reshape(n, f, n, f).mean(axis=(1, 3))


def summary(cl, theory, traced, born) -> dict:
    ratio = np.asarray(cl, np.float64) / np.asarray(theory, np.float64)
    return {"cl_over_halofit": ratio.tolist(),
            "band_1_4_mean": float(ratio[1:5].mean()),
            "raytrace_born_corr": corr(traced, born),
            "raytrace_born_corr_8x8": corr(block_mean(traced, 8),
                                           block_mean(born, 8)),
            "kappa_rms": float(np.std(born))}


def run_jax(white, shifts, npart, box, fov, npix, nplanes) -> dict:
    import jax.numpy as jnp

    from astrild_tpu.ops import angular_power, lens_planes, lensing, mocks
    from astrild_tpu.ops import linear_power, nbody, raytrace
    from astrild_tpu.utils.cosmology import Cosmology

    cosmo = Cosmology(**COSMO)
    amp = float(linear_power.normalization(cosmo))

    def pk(k):
        return linear_power.linear_power(k, cosmo, 0.0, amplitude=amp)

    dk = mocks.modes_from_white(jnp.asarray(white), npart, box, pk)
    chi_s = float(cosmo.comoving_distance(Z_SOURCE))
    dchi = chi_s / nplanes
    chis = (np.arange(nplanes) + 0.5) * dchi
    z_planes = np.asarray(cosmo.redshift_at_comoving_distance(
        jnp.asarray(chis, jnp.float32)), np.float64)
    a_targets = 1.0 / (1.0 + z_planes[::-1])
    # the loop of nbody.pm_lightcone_planes, from explicit modes and shifts
    comps, mom = nbody.lpt_catalog_from_modes(dk, npart, box, cosmo, Z_INIT)
    a_now = 1.0 / (1.0 + Z_INIT)
    planes = []
    for j in range(nplanes):
        a_t, chi_c = float(a_targets[j]), float(chis[::-1][j])
        comps, mom = nbody.pm_evolve(comps, mom, cosmo, npart, box, a_now,
                                     a_t, STEPS_INIT if j == 0
                                     else STEPS_PLANE)
        a_now = a_t
        g = int(chi_c // box)
        oxy = ((0.5 * box + shifts[g, 0]) % box,
               (0.5 * box + shifts[g, 1]) % box)
        d, _ = lens_planes.density_planes_from_particles(
            comps, box, chi_c, dchi, 1, fov, npix, observer_xy=oxy)
        planes.append(d[0])
    delta = jnp.stack(planes[::-1])
    chis_j = jnp.asarray(chis, jnp.float32)
    dchis = jnp.full(nplanes, dchi)
    a_pl = jnp.asarray(1.0 / (1.0 + z_planes), jnp.float32)
    kappa = lensing.born_convergence(delta, chis_j, dchis, chi_s,
                                     cosmo.Om0, scale_factors=a_pl)
    ell, cl = angular_power.cl_flat_sky(kappa, math.degrees(fov), nbins=10)
    theory = angular_power.cl_kappa_limber(ell, cosmo, Z_SOURCE,
                                           nonlinear=True)
    traced = raytrace.multiplane_raytrace(delta, chis_j, dchis, chi_s,
                                          cosmo.Om0, fov,
                                          scale_factors=a_pl)["kappa"]
    return {"ell": np.asarray(ell).tolist(),
            **summary(cl, theory, traced, kappa)}, np.asarray(dk)


def run_torch(dk, shifts, npart, box, fov, npix, nplanes) -> dict:
    import torch

    from astrild_tpu_torch.ops import angular_power, lensing, nbody, raytrace
    from astrild_tpu_torch.utils.cosmology import Cosmology

    cosmo = Cosmology(**COSMO)
    delta, chis, dchi = nbody.pm_lightcone_planes_from_modes(
        torch.from_numpy(np.array(dk)), cosmo, npart, box, fov, npix, nplanes,
        z_source=Z_SOURCE, z_init=Z_INIT, nsteps_init=STEPS_INIT,
        steps_per_plane=STEPS_PLANE, shifts=shifts)
    chi_s = float(cosmo.comoving_distance(Z_SOURCE))
    a_pl = torch.as_tensor(1.0 / (1.0 + cosmo.redshift_at_comoving_distance(
        chis.numpy())), dtype=torch.float32)
    dchis = torch.full((nplanes,), dchi)
    kappa = lensing.born_convergence(delta, chis, dchis, chi_s, cosmo.Om0,
                                     scale_factors=a_pl)
    ell, cl = angular_power.cl_flat_sky(kappa, math.degrees(fov), nbins=10)
    theory = angular_power.cl_kappa_limber(ell, cosmo, Z_SOURCE,
                                           nonlinear=True)
    traced = raytrace.multiplane_raytrace(delta, chis, dchis, chi_s,
                                          cosmo.Om0, fov,
                                          scale_factors=a_pl)["kappa"]
    return {"ell": ell.tolist(),
            **summary(cl.numpy(), theory.numpy(), traced.numpy(),
                      kappa.numpy())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--npart", type=int, default=64,
                    help="particles per side (the card run has 512)")
    args = ap.parse_args()
    from astrild_tpu_torch.ops.nbody import _lightcone_geometry
    from astrild_tpu_torch.utils.cosmology import Cosmology

    scale = args.npart / 512.0
    box, fov, npix = 500.0 * scale, 0.2 * scale, 4 * args.npart
    cosmo = Cosmology(**COSMO)
    # planes no thicker than the box
    nplanes = int(math.ceil(float(cosmo.comoving_distance(Z_SOURCE))
                            / box)) + 3
    n_groups = _lightcone_geometry(cosmo, box, nplanes, Z_SOURCE, Z_INIT,
                                   2)[3]
    rng = np.random.default_rng(args.seed)
    white = rng.standard_normal((args.npart,) * 3).astype(np.float32)
    shifts = rng.uniform(0.0, box, (n_groups, 2))
    jax_out, dk = run_jax(white, shifts, args.npart, box, fov, npix,
                          nplanes)
    torch_out = run_torch(dk, shifts, args.npart, box, fov, npix, nplanes)
    print(json.dumps({"npart": args.npart, "box": box, "fov": fov,
                      "npix": npix, "nplanes": nplanes, "seed": args.seed,
                      "jax": jax_out, "torch": torch_out}))


if __name__ == "__main__":
    main()
