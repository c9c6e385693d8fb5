"""Readings that the check's limits are set from; not part of a run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out FILE]

For each seed, in one process: make the cell's inputs, run one unit of
the program at the cell's own size and compare it with the float64
reference, as a run's check does. For each control seed, put the
reference computed in bfloat16 (one precision below the configurations'
float32) in the program's place and compare that. Prints one JSON line a
reading: {"seed", "kind": "program" | "control", "checks": {name:
value}}. The limit of each number lies between the largest program
reading and the smallest control reading (PERF.md gives both).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402


def readings(cell, seeds, control_seeds, torch, device="cuda"):
    """Yield one reading dict a seed and kind."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    gen = cell.generator()
    drv_mod = cell.driver()
    limits = {k: float("inf") for k in cell.workload["limits"]}
    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            inputs = gen.generate(cell.traffic, seed, device)
            drv = drv_mod.Driver(cell.config, cell.traffic, cell.workload,
                                 inputs, device, seed)
            out = drv.unit() if kind == "program" else drv.control_unit()
            sync()
            drv.keep(out)
            del out
            drv.release()
            checks, _ = drv.check(limits)
            yield {"seed": seed, "kind": kind,
                   "checks": {n: v for n, v, _ in checks},
                   "seconds": time.perf_counter() - t0}
            del drv, inputs
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = run.Cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for r in readings(cell, args.seeds, args.control_seeds, torch):
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
