#!/usr/bin/env python3
"""Time variants of K1 against each other at the main paths' three shapes.

    python3 tools/k1_ab.py [VARIANT ...] [--chunks C,C,...]

A VARIANT is a name and constants of csrc/deposit_sorted.cu to replace,
`name:kPartItems=16,kPartThreads=512`; each is compiled by nvcc (the
flags of astrild_tpu_torch/_ext.py) from a copy of the source with those
`constexpr int` lines changed, into build/k1_ab/<name>/. The source as it
stands is the variant `here`. --chunks times `here` with other
accumulate chunks (paint_cuda._CHUNK). The shapes are chip_smoke.py's:
the suite's 2^27 uniform keys into 2^27 cells (counts), the farthest
lens plane's weighted entries of the forward path's GR z = 0 snapshot
(lens_planes.plane_entries), and one box image's shell keys (counts).
For each shape one JSON line: `deposit_flat` on the keys as they come and
`deposit_sorted` on them sorted, each variant's median of ROUNDS rounds
(CUDA events, mean of 5 calls after a warm-up) whose order alternates,
and the device ms of each of `deposit_flat`'s passes from one traced
call. Every variant's counts must equal `here`'s. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 6
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from astrild_tpu_torch import _ext  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda  # noqa: E402


def build_variant(name: str, consts: dict) -> ctypes.CDLL:
    """K1 compiled from the source with `consts` replaced, loaded."""
    src = (_ext._CSRC / "deposit_sorted.cu").read_text()
    for const, value in consts.items():
        src, hits = re.subn(rf"(constexpr int {const} = )[^;]+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise ValueError(f"{const}: {hits} definitions in the source")
    out = ROOT / "build" / "k1_ab" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "deposit_sorted.cu").write_text(src)
    lib = out / "libdeposit_sorted.so"
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", str(lib),
                    str(out / "deposit_sorted.cu")], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    for sym, (argtypes, restype) in _ext._SIGNATURES["deposit_sorted"].items():
        fn = getattr(dll, sym)
        fn.argtypes = argtypes
        fn.restype = restype
    return dll


def shapes(dev):
    """{shape: (keys as they come, weights or None, n_cells)}."""
    from astrild_tpu_torch import suite
    from astrild_tpu_torch.ops import (lens_planes, lightcone_sphere,
                                       linear_power, nbody, power)
    from astrild_tpu_torch.utils.cosmology import Cosmology

    n = cs.N_SIDE ** 3
    pos = suite.uniform_positions(cs.N_SIDE, cs.BOX, dev, seed=0)
    out = {"suite": (power._fast_keys((pos[:n], pos[n:2 * n], pos[2 * n:]),
                                      cs.BOX, ngrid=cs.NGRID, fine_factor=2),
                     None, 8 * cs.NGRID ** 3)}
    del pos
    gr = Cosmology(Om0=0.3, h=0.7)
    amp = linear_power.normalization(gr)
    gen = torch.Generator(device=dev).manual_seed(0)
    comps, mom = nbody.lpt_catalog(
        gen, cs.PM_SIDE, cs.BOX,
        lambda k: linear_power.linear_power(k, gr, 0.0, amplitude=amp),
        gr, cs.Z_INIT)
    snap, _ = nbody.pm_evolve(comps, mom, gr, cs.PM_SIDE, cs.BOX,
                              1.0 / (1.0 + cs.Z_INIT), 1.0, cs.PM_STEPS)
    del comps, mom
    chi_s = float(gr.comoving_distance(cs.LC_Z_SOURCE))
    dchi = chi_s / cs.LC_PLANES
    far = (cs.LC_PLANES - 0.5) * dchi
    keys, vals = lens_planes.plane_entries(snap, cs.BOX, far, dchi,
                                           cs.LC_FOV, cs.LC_NPIX)
    out["plane"] = (keys, vals, cs.LC_NPIX ** 2 + 1)
    edges = np.linspace(*cs.LC_EDGES)
    nshell = len(edges) - 1
    obs = cs.BOX / 2.0
    keys, _ = lightcone_sphere._shell_keys(
        *(c - obs for c in snap),
        torch.as_tensor(edges.astype(np.float32), device=dev), None,
        cs.LC_NSIDE, nshell)
    out["shell"] = (keys, None, nshell * 12 * cs.LC_NSIDE ** 2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--chunks", default="")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # (library, chunk) of each variant
    here = _ext.load("deposit_sorted")
    variants = {"here": (here, paint_cuda._CHUNK)}
    for spec in args.variants:
        name, _, body = spec.partition(":")
        consts = dict(kv.split("=") for kv in body.split(",") if kv)
        variants[name] = (build_variant(name, consts), paint_cuda._CHUNK)
    for c in filter(None, args.chunks.split(",")):
        variants[f"chunk{c}"] = (here, int(c))

    def run(variant, fn):
        lib, chunk = variants[variant]
        _ext._LIBS["deposit_sorted"], paint_cuda._CHUNK = lib, chunk
        try:
            return fn()
        finally:
            _ext._LIBS["deposit_sorted"] = here
            paint_cuda._CHUNK = variants["here"][1]

    for shape, (keys, vals, n_cells) in shapes(dev).items():
        keys_sorted, order = torch.sort(keys, stable=False)
        vals_sorted = None if vals is None else vals[order].contiguous()
        del order
        entries = {
            "deposit_flat": lambda: paint_cuda.deposit_flat(keys, vals,
                                                            n_cells),
            "deposit_sorted": lambda: paint_cuda.deposit_sorted(
                keys_sorted, vals_sorted, n_cells)}
        want = {e: fn() for e, fn in entries.items()}
        line = {"shape": shape, "n_keys": keys.numel(), "n_cells": n_cells,
                "weighted": vals is not None}
        for entry, fn in entries.items():
            ms = {v: [] for v in variants}
            names = list(variants)
            for r in range(ROUNDS):
                for v in (names if r % 2 == 0 else names[::-1]):
                    ms[v].append(run(v, lambda: cs._event_ms(fn, 5)))
            for v in variants:
                got = run(v, fn)
                if vals is None and not torch.equal(got, want[entry]):
                    raise AssertionError(f"{v} {entry} counts differ")
            line[entry] = {v: {"median": statistics.median(t),
                               "min": min(t), "max": max(t)}
                           for v, t in ms.items()}
        line["deposit_flat_passes_ms"] = {
            v: run(v, lambda: cs._k1_kernel_names(entries["deposit_flat"]))
            for v in variants}
        print(json.dumps(line), flush=True)
        del keys, vals, keys_sorted, vals_sorted, want, entries


if __name__ == "__main__":
    main()
