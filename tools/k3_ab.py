#!/usr/bin/env python3
"""Time K3 whole in this checkout against K3 in another source tree, in
alternating pairs on the forward path's tracers.

    python3 tools/k3_ab.py OTHER

OTHER is a directory holding another version of astrild_tpu_torch/ (for
example a `git archive` of another commit unpacked under build/). Both
packages are loaded side by side, OTHER's under a private name, and each
builds its own K3 into its own build/. The tracers are chip_smoke.py's
forward path: its GR z = 0 snapshot (PM_SIDE^3 particles, PM_STEPS steps
from Z_INIT in a BOX Mpc/h box) and random subsets of V12_N and
K3_LARGE_N of it, with the V12_BINS bins. For each size one JSON line:
`pairwise_accumulate` of each version (CUDA events, mean of 3 calls after
a warm-up) in PAIRS pairs whose first member alternates, the medians
and quartiles, the pairs this checkout won, and the largest difference
between the two versions' sums relative to the largest bin. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
PAIRS = 10
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from astrild_tpu_torch.ops import pairwise_cuda as here  # noqa: E402


def load_other(tree: Path):
    """pairwise_cuda of the astrild_tpu_torch package in `tree`."""
    pkg = tree / "astrild_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "k3_ab_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["k3_ab_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("k3_ab_other.ops.pairwise_cuda")


def snapshot(gen, dev):
    """chip_smoke.py's GR z = 0 snapshot: positions and velocities in km/s,
    (PM_SIDE^3, 3) each."""
    from astrild_tpu_torch.ops import linear_power, nbody
    from astrild_tpu_torch.utils.cosmology import Cosmology

    gr = Cosmology(Om0=0.3, h=0.7)
    amp = linear_power.normalization(gr)
    comps, mom = nbody.lpt_catalog(
        gen, cs.PM_SIDE, cs.BOX,
        lambda k: linear_power.linear_power(k, gr, 0.0, amplitude=amp),
        gr, cs.Z_INIT)
    out, mom = nbody.pm_evolve(comps, mom, gr, cs.PM_SIDE, cs.BOX,
                               1.0 / (1.0 + cs.Z_INIT), 1.0, cs.PM_STEPS)
    vel = nbody.velocities_kms(mom, 1.0)
    return torch.stack(list(out), dim=1), torch.stack(list(vel), dim=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    versions = {"here": here, "other": load_other(args.other.resolve())}
    gen = torch.Generator(device=dev).manual_seed(0)
    all_pos, all_vel = snapshot(gen, dev)
    binw, nb = float(np.linspace(*cs.V12_BINS)[1]), cs.V12_BINS[2]
    for n in (cs.V12_N, cs.K3_LARGE_N):
        sub = torch.randperm(all_pos.shape[0], generator=gen, device=dev)[:n]
        pos, vel = all_pos[sub].contiguous(), all_vel[sub].contiguous()
        outs = {}

        def call(name):
            outs[name] = versions[name].pairwise_accumulate(pos, vel, n,
                                                            binw, nb)

        ms = {k: [] for k in versions}
        for i in range(PAIRS):
            order = ("here", "other") if i % 2 == 0 else ("other", "here")
            for name in order:
                ms[name].append(cs._event_ms(lambda: call(name), 3))
        wins = sum(a < b for a, b in zip(ms["here"], ms["other"]))
        a, b = torch.stack(outs["here"]), torch.stack(outs["other"])
        rel = float(((a - b).abs().amax(dim=1)
                     / b.abs().amax(dim=1)).max())
        print(json.dumps({
            "n": n, "other": str(args.other), "k3_ms": ms,
            "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
            "quartiles_ms": {k: np.percentile(v, [25, 75]).tolist()
                             for k, v in ms.items()},
            "here_wins": f"{wins} of {PAIRS}",
            "max_rel_diff": rel}), flush=True)


if __name__ == "__main__":
    main()
