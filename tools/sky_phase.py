#!/usr/bin/env python3
"""Phase 18 (the full sky) or 19 (CMB lensing) of chip_smoke.py alone, on
a CUDA card:

    python3 tools/sky_phase.py {full_sky,cmb_lensing} [--seed S]

Builds the kernels and makes the snapshot chip_smoke.py runs both phases
on: the forward path's 512^3 particles in its 500 Mpc/h box, 2LPT at
z_init then phase 7's 20 GR steps to z=0. Runs phase 9's HEALPix shells
on it for K1's flush count and then the phase with its checks, printing
the phase's lines. On one H100: full_sky about 3.6 minutes, cmb_lensing
about 3.3.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import chip_smoke as cs
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.ops import linear_power, nbody

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=("full_sky", "cmb_lensing"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_build()
    cosmo = Cosmology(Om0=0.3, h=0.7)
    amp = float(linear_power.normalization(cosmo))

    def pk(k):
        return linear_power.linear_power(k, cosmo, 0.0, amplitude=amp)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    comps, mom = nbody.lpt_catalog(gen, cs.PM_SIDE, cs.BOX, pk, cosmo,
                                   cs.Z_INIT)
    comps, _ = nbody.pm_evolve(comps, mom, cosmo, cs.PM_SIDE, cs.BOX,
                               1.0 / (1.0 + cs.Z_INIT), 1.0, cs.PM_STEPS)
    del mom
    flushes = cs.lightcone_shells(dev, args.seed, comps)["shells_flushes"]
    if args.phase == "full_sky":
        cs.phase_full_sky(dev, args.seed, comps, flushes)
    else:
        cs.phase_cmb_lensing(dev, args.seed, [comps], flushes)
    print(f"# sky_phase {args.phase}: {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
