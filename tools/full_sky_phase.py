#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py (the full sky) alone, on a CUDA card:

    python3 tools/full_sky_phase.py [--seed S]

Builds the kernels, makes a z=0 2LPT snapshot of the forward path's
512^3 particles in its 500 Mpc/h box (EH98 P(k); no particle-mesh
evolution, so minutes shorter than phase 7), runs phase 9's HEALPix
shells on it for K1's flush count and then `phase_full_sky` with its
checks, printing the phase's lines. About 4 minutes on one H100.
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
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    t0 = time.perf_counter()
    cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_build()
    cosmo = Cosmology(Om0=0.3, h=0.7)
    amp = float(linear_power.normalization(cosmo))
    comps, _ = nbody.lpt_catalog(
        torch.Generator(device=dev).manual_seed(seed), cs.PM_SIDE, cs.BOX,
        lambda k: linear_power.linear_power(k, cosmo, 0.0, amplitude=amp),
        cosmo, 0.0)
    shells = cs.lightcone_shells(dev, seed, comps)
    cs.phase_full_sky(dev, seed, comps, shells["shells_flushes"])
    print(f"# full_sky_phase: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
