#!/usr/bin/env python3
"""Card seconds of the scan path's Legendre recursion and transforms:

    python3 tools/sht_loop_timing.py

At nside 512 / lmax 1024 and nside 1024 / lmax 2048: the recursion's
steps run eagerly once, then through `sht_large._legendre_loop` (its
first call captures the CUDA graph, the next ones replay it), then
`synthesize_large`, `analyze_large(niter=0)` and `synthesize_spin2_large`,
each on the host clock, synchronized. Needs a CUDA card; about a minute.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _seconds(fn, n: int):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round(time.perf_counter() - t0, 4))
    return out


def main() -> None:
    from astrild_tpu_torch.ops import sht_large as L
    from astrild_tpu_torch.ops import sht_spin_large as SL

    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    for nside, lmax in ((512, 1024), (1024, 2048)):
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((2, lmax + 1, lmax + 1), generator=gen,
                        device=dev).tril()
        m = torch.randn(12 * nside * nside, generator=gen, device=dev)
        tab = L.sht_large_tables(nside, lmax, dev)
        eager = _seconds(lambda: L._legendre_steps(tab, lmax, a, True), 1)
        graph = _seconds(lambda: L._legendre_loop(tab, lmax,
                                                  alm=(a[0], a[1])), 3)
        synth = _seconds(lambda: L.synthesize_large(a[0], a[1], nside,
                                                    lmax), 2)
        ana = _seconds(lambda: L.analyze_large(m, nside, lmax, niter=0), 3)
        spin = _seconds(lambda: SL.synthesize_spin2_large(
            a[0], a[1], a[0], a[1], nside, lmax), 3)
        print(f"# nside {nside} lmax {lmax}: eager steps {eager}, graph "
              f"loop {graph}, synthesize_large {synth}, analyze_large(0) "
              f"{ana}, spin-2 synthesis {spin}", flush=True)


if __name__ == "__main__":
    main()
