#!/usr/bin/env python3
"""Check that torch's first threaded float32 vector functions are exact in
a process that has run JAX.

    python3 tools/first_call_check.py [--procs 240] [--parallel 8]
        [--funcs exp,log,sin,cos,rsqrt,sqrt] [--n 2304]

In a process that also runs JAX, torch's first threaded float32
`torch.sqrt` now and then came back 2^-12 low on the second thread's half
of the array (x * rsqrt(x)); every later call was exact. That is why the
`_two_threads` fixtures of tests/test_torch_*.py make a small sqrt call
first. This script asks the same of the other vector functions.

Each of --procs fresh processes sets two torch threads, warms the thread
pool with a threaded add, runs one small JAX op, and then makes the first
call of each function in --funcs on --n float32 values, the functions in
an order that rotates from process to process (so each comes first in an
equal share). A first call is inexact when it differs, in any bit, from
the same call made again afterwards and from a one-thread call. --parallel
processes run at once, so the host is loaded as under `pytest -n 6`.
Prints one JSON line: processes run and, for each function, the processes
whose first call was inexact. Imports JAX; needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_CHILD = r'''
import json, sys
import numpy as np
import torch
funcs, n, seed = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(2)
torch.add(torch.ones(1 << 20), 1.0)
import jax.numpy as jnp
jnp.ones(4).sum().block_until_ready()
rng = np.random.default_rng(seed)
args = {
    "exp": rng.uniform(-10, 10, n), "sin": rng.uniform(-10, 10, n),
    "cos": rng.uniform(-10, 10, n), "log": rng.uniform(0.01, 100, n),
    "rsqrt": rng.uniform(0.01, 100, n),
    "sqrt": np.floor(rng.uniform(1, 100, n)) ** 2,
}
bad = []
for name in funcs:
    x = torch.from_numpy(args[name].astype(np.float32))
    fn = getattr(torch, name)
    first = fn(x)
    again = fn(x)
    torch.set_num_threads(1)
    single = fn(x)
    torch.set_num_threads(2)
    if not (torch.equal(first, again) and torch.equal(first, single)):
        bad.append(name)
print(json.dumps(bad))
'''


def one(i: int, funcs: list, n: int) -> list:
    order = funcs[i % len(funcs):] + funcs[:i % len(funcs)]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, ",".join(order), str(n), str(i)],
        env=env, capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=240)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--funcs", default="exp,log,sin,cos,rsqrt,sqrt")
    ap.add_argument("--n", type=int, default=2304)
    args = ap.parse_args(argv)
    funcs = args.funcs.split(",")
    with ThreadPoolExecutor(args.parallel) as pool:
        bad = list(pool.map(lambda i: one(i, funcs, args.n),
                            range(args.procs)))
    counts = {f: sum(f in b for b in bad) for f in funcs}
    print(json.dumps({"procs": args.procs, "n": args.n,
                      "inexact_first_calls": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
