#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (astrild_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed S] [--runs N]

Phases, each printing its own lines; a failure in any phase raises and
exits non-zero before the final line:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the sorted-deposit kernel K1 from csrc/ (nvcc) and load it;
  3. hold K1 against its plain PyTorch version on the card: 2^24 keys into
     2^24 cells (counts and weighted) and the edge cases (empty windows,
     all keys in one cell, N not a multiple of the block size, a partly
     filled last window). Counts must be equal, weighted sums within
     2e-5 * max;
  4. drive the z=0 analysis suite at bench size (512^3 particles, a 256^3
     grid over 2^27 fine cells, 64 lens planes, 2048^2 maps): one warm-up
     and N timed runs, the per-stage split and the matter sub-stages, then
     check the outputs (finite, shapes, P(k) of the kernel deposit equal to
     the scatter deposit's to rtol 1e-5, P(k) of uniform particles at the
     shot-noise level, the deposit conserving the particle count);
  5. time K1 against the plain `index_add_` deposit at bench size.

The last two lines are a JSON object describing each kernel and the
`{"ok": true, "device": ...}` result line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

N_SIDE, NGRID, NPIX, BOX, NPLANES = 512, 256, 2048, 500.0, 64
# K1 weighted sums: max|kernel - plain| <= WEIGHTED_TOL * max|plain|
WEIGHTED_TOL = 2e-5
PK_RTOL = 1e-5       # P(k), kernel deposit vs scatter deposit
K1_SOURCE = "astrild_tpu_torch/csrc/deposit_sorted.cu"
K1_REPLACES = "astrild_tpu/ops/paint_pallas.py:163"


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from astrild_tpu_torch import _ext

    t0 = time.perf_counter()
    _ext.load("deposit_sorted")
    log(f"# phase build: deposit_sorted ready in "
        f"{time.perf_counter() - t0:.3f} s")
    for line in _ext.build_logs.get("deposit_sorted", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   {line.strip()}")


def _sorted_pair(keys, gen):
    keys_sorted, order = torch.sort(keys, stable=False)
    vals = torch.rand(keys.shape[0], generator=gen, device=keys.device) + 0.5
    return keys_sorted, vals[order].contiguous()


def compare_k1(keys_sorted, vals_sorted, n_cells) -> float:
    """Kernel vs plain version on the same sorted inputs; raises on a
    mismatch, returns max |kernel - plain| of the weighted deposit."""
    from astrild_tpu_torch.ops import paint_cuda

    got = paint_cuda.deposit_sorted(keys_sorted, None, n_cells)
    want = paint_cuda.deposit_sorted_reference(keys_sorted, None, n_cells)
    if not torch.equal(got, want):
        raise AssertionError(f"K1 counts differ from the plain deposit "
                             f"(n={keys_sorted.numel()}, n_cells={n_cells})")
    gotw = paint_cuda.deposit_sorted(keys_sorted, vals_sorted, n_cells)
    wantw = paint_cuda.deposit_sorted_reference(keys_sorted, vals_sorted,
                                                n_cells)
    err = float((gotw - wantw).abs().max()) if n_cells else 0.0
    scale = float(wantw.abs().max()) if n_cells else 0.0
    if err > WEIGHTED_TOL * scale:
        raise AssertionError(f"K1 weighted sums differ: max err {err} > "
                             f"{WEIGHTED_TOL} * {scale}")
    return err


def phase_kernel_check(dev, seed: int) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_keys(n, n_cells):
        return torch.randint(0, n_cells, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    last = 5 * 8192 + 77
    cases = {
        "2^24 keys into 2^24 cells": (rand_keys(1 << 24, 1 << 24), 1 << 24),
        "empty windows (1000 keys, 2^22 cells)": (rand_keys(1000, 1 << 22),
                                                  1 << 22),
        "no keys": (torch.zeros(0, dtype=torch.int32, device=dev), 1000),
        "all keys in one cell": (torch.full((100000,), 12345,
                                            dtype=torch.int32, device=dev),
                                 1 << 16),
        "N not a multiple of the block": (rand_keys((1 << 20) + 12345,
                                                    1 << 20), 1 << 20),
        "last window partly filled": (
            torch.cat([rand_keys(5000, last),
                       torch.arange(last - 200, last, dtype=torch.int32,
                                    device=dev).repeat(7)]), last),
    }
    for name, (keys, n_cells) in cases.items():
        err = compare_k1(*_sorted_pair(keys, gen), n_cells)
        torch.cuda.synchronize()
        log(f"# phase kernel: {name}: counts equal, weighted max err "
            f"{err:.3e}")


def phase_suite(dev, seed: int, runs: int) -> dict:
    from astrild_tpu_torch import suite
    from astrild_tpu_torch.ops import bispectrum, paint_cuda, power

    pos = suite.uniform_positions(N_SIDE, BOX, dev, seed=seed)
    run = suite.make_stages(N_SIDE, NGRID, NPIX, BOX, NPLANES, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the launch counts cover exactly the warm-up and the timed runs
    paint_cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    run(pos)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = run(pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(paint_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if power.last_auto_deposit != "kernel":
        raise AssertionError(f"auto_power_fast chose "
                             f"{power.last_auto_deposit!r}, not the kernel")
    if launches.get("deposit_sorted", 0) < 1 + runs:
        raise AssertionError(f"the suite did not launch K1 once per run: "
                             f"{launches}")

    stage_s = run.per_stage(pos)
    detail = run.matter_detail(pos)

    # outputs: shapes and finiteness
    pk, b, kappa, g1, g2, rad = out
    expect = {"P(k)": (pk, (64,)), "kappa": (kappa, (NPIX, NPIX)),
              "gamma1": (g1, (NPIX, NPIX)), "gamma2": (g2, (NPIX, NPIX)),
              "void radii": (rad, (256,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want "
                                 f"{shape}) or non-finite values")
    # B is NaN exactly for the open triangles (zero closed-triangle count)
    n_c = bispectrum.band_limited_size(NGRID, 32.0)
    den = bispectrum.get_bispectrum_tables(n_c, 4, 2.0, 32.0, device=dev)[1]
    if not torch.equal(torch.isfinite(b), den > 1e-10):
        raise AssertionError("bispectrum: finite entries do not match the "
                             "closed triangles")
    n_voids = int((rad > 0).sum())
    if n_voids == 0:
        raise AssertionError("no voids found")

    # the deposit conserves the particle count exactly
    xyz = (pos[:N_SIDE ** 3], pos[N_SIDE ** 3:2 * N_SIDE ** 3],
           pos[2 * N_SIDE ** 3:])
    _, grid = power.auto_power_fast(xyz, NGRID, BOX, nbins=64,
                                    return_coarse_grid=True,
                                    binning=run.binning, deposit="kernel")
    total = int(grid.double().sum())
    if total != N_SIDE ** 3:
        raise AssertionError(f"deposit holds {total} particles, not "
                             f"{N_SIDE ** 3}")
    # kernel deposit vs scatter deposit: same P(k)
    pk_scatter = power.auto_power_fast(xyz, NGRID, BOX, nbins=64,
                                       binning=run.binning,
                                       deposit="scatter").power
    rel = float(((pk - pk_scatter).abs()
                 / pk_scatter.abs().clamp_min(1e-30)).max())
    if not torch.allclose(pk, pk_scatter, rtol=PK_RTOL, atol=0.0):
        raise AssertionError(f"P(k) kernel vs scatter: max rel diff {rel}")
    # uniform particles: shot-noise-subtracted P(k) vanishes at low k
    # (bins 2-16 lie well below the fine grid's NGP aliasing)
    shot = BOX ** 3 / N_SIDE ** 3
    resid = float((pk[2:17] / shot).mean())
    if abs(resid) > 0.05:
        raise AssertionError(f"P(k) of uniform particles is not at the shot "
                             f"noise: mean residual {resid}")
    n_closed = int(den.gt(1e-10).sum())
    log(f"# phase suite: outputs finite; B finite on {n_closed}"
        f"/{den.numel()} closed triangles; {n_voids} voids; P(k) kernel vs "
        f"scatter max rel diff {rel:.2e}; low-k P/shot residual "
        f"{resid:+.4f}")
    result = {
        "suite_s_min": min(times), "suite_s_median": statistics.median(times),
        "suite_s_runs": times, "warmup_s": warm_s, "stages_s": stage_s,
        "matter_detail_s": detail, "deposit": power.last_auto_deposit,
        "peak_mem_gb": peak_gb, "launches": launches,
    }
    log("# suite " + json.dumps(result))
    return launches


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing(dev, seed: int) -> tuple[float, float, float]:
    """K1 vs plain at bench size, in turns (plain, kernel, kernel, plain)."""
    from astrild_tpu_torch import suite
    from astrild_tpu_torch.ops import paint_cuda, power

    n = N_SIDE ** 3
    n_cells = 8 * NGRID ** 3
    pos = suite.uniform_positions(N_SIDE, BOX, dev, seed=seed)
    keys = power._fast_keys((pos[:n], pos[n:2 * n], pos[2 * n:]), BOX,
                            ngrid=NGRID, fine_factor=2)
    del pos
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    keys_sorted, vals_sorted = _sorted_pair(keys, gen)
    err = compare_k1(keys_sorted, vals_sorted, n_cells)
    log(f"# phase timing: bench-size K1 vs plain: counts equal, weighted "
        f"max err {err:.3e}")

    reps = 10
    fns = {
        "kernel": lambda: paint_cuda.deposit_sorted(keys_sorted, None,
                                                    n_cells),
        "plain": lambda: paint_cuda.deposit_sorted_reference(keys_sorted,
                                                             None, n_cells),
        "kernel_weighted": lambda: paint_cuda.deposit_sorted(
            keys_sorted, vals_sorted, n_cells),
        "plain_weighted": lambda: paint_cuda.deposit_sorted_reference(
            keys_sorted, vals_sorted, n_cells),
        "sort": lambda: torch.sort(keys, stable=False),
        "sort_plus_kernel": lambda: paint_cuda.deposit_flat(keys, None,
                                                            n_cells),
        "scatter_unsorted": lambda: paint_cuda.deposit_sorted_reference(
            keys, None, n_cells),
    }
    order = ["plain", "kernel", "plain_weighted", "kernel_weighted",
             "scatter_unsorted", "sort", "sort_plus_kernel"]
    ms = {k: [] for k in fns}
    for turn in (order, order[::-1]):
        for name in turn:
            ms[name].append(_event_ms(fns[name], reps))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log("# k1_timing_ms " + json.dumps({"n_keys": n, "n_cells": n_cells,
                                        "reps": reps, "mean": mean,
                                        "turns": ms}))
    return err, mean["kernel"], mean["plain"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed runs of the suite after one warm-up")
    args = ap.parse_args()

    card = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_kernel_check(dev, args.seed)
    launches = phase_suite(dev, args.seed, args.runs)
    err_bench, k_ms, p_ms = phase_timing(dev, args.seed)

    # max_abs_err, ms and plain_ms are taken at the main path's shapes
    kernels = [{"name": "deposit_sorted", "route": "cuda",
                "source": K1_SOURCE, "replaces": K1_REPLACES,
                "launches": launches["deposit_sorted"],
                "max_abs_err": err_bench, "ms": k_ms, "plain_ms": p_ms}]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
