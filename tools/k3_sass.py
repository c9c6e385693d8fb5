#!/usr/bin/env python3
"""Disassemble the pair-tile kernel K3 and count the instructions of its cut.

    python3 tools/k3_sass.py [--out build/k3_sass.txt]

Builds astrild_tpu_torch/csrc/pairwise_accumulate.cu as the port does
(`_ext.build`, nvcc for sm_90a), writes `cuobjdump -sass` of the library
to --out and prints, for each kernel, its instruction count and the count
of each floating-point opcode. For the pair kernel it then prints every
cut path: the straight-line run that ends in the branch taken when no pair
of a batch is in range (it holds one FSETP per pair of the batch: kBatch j
rows against the thread's two i rows), together with the block that branch
jumps to, up to the next branch (the loop's tail). Its instructions over
its FSETPs are the issued instructions per rejected pair. The cut paths
and the box-gap paths (the runs that hold a box gap's six FMNMX) must hold
no FFMA: every operation that feeds s or the box gap is a separately
rounded FADD or FMUL. Exits non-zero if one does, or if no cut path is
found. Needs the CUDA toolkit (nvcc, cuobjdump); it needs no card.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_TARGET = re.compile(r"\bBRA\b[^0-9]*0x([0-9a-f]+)")
_FLOAT_OPS = ("FFMA", "FADD", "FMUL", "FSETP", "FMNMX", "MUFU", "DADD",
              "DFMA", "F2F", "LDS", "STS", "VOTE", "BRA")
_BATCH_PAIRS = 8    # kBatch j rows against a thread's kRows = 2 i rows


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "cuobjdump")):
            return os.path.join(home, "bin", "cuobjdump")
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def functions(sass: str) -> dict:
    """Function name -> list of (address, instruction text)."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
            continue
        m = _LINE.search(line)
        if name is not None and m:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _is_branch(text: str) -> bool:
    """A branch that ends a basic block (BRA.DIV, the check for a
    diverged warp before a vote, does not: the path falls through it)."""
    return opcode(text) == "BRA" and ".DIV" not in text.split()[
        1 if text.startswith("@") else 0]


def _blocks(instrs) -> list:
    """Start indices of the basic blocks of `instrs`."""
    index = {a: k for k, (a, _) in enumerate(instrs)}
    starts = {0}
    for k, (_, text) in enumerate(instrs):
        if _is_branch(text):
            starts.add(k + 1)
            m = _TARGET.search(text)
            if (text.startswith("@") and m
                    and int(m.group(1), 16) in index):
                starts.add(index[int(m.group(1), 16)])
    return sorted(starts)


def box_gap_runs(instrs) -> list:
    """The basic blocks that hold at least one box gap (six FMNMX)."""
    starts = _blocks(instrs) + [len(instrs)]
    return [instrs[a:b] for a, b in zip(starts, starts[1:])
            if sum(opcode(t) == "FMNMX" for _, t in instrs[a:b]) >= 6]


def cut_paths(instrs) -> list:
    """(start, branch address, run, tail) of every run that ends in a
    predicated branch and holds a batch's FSETPs: the batch's cut up to the
    test that no pair is in range, and the block that test jumps to."""
    index = {a: k for k, (a, _) in enumerate(instrs)}
    starts = _blocks(instrs)
    found = []
    for k, (addr, text) in enumerate(instrs):
        if not (_is_branch(text) and text.startswith("@")):
            continue
        s = max(x for x in starts if x <= k)
        run = instrs[s:k + 1]
        if sum(opcode(t) == "FSETP" for _, t in run) < _BATCH_PAIRS:
            continue
        m = _TARGET.search(text)
        tail = []
        if m and int(m.group(1), 16) in index:
            for a, t in instrs[index[int(m.group(1), 16)]:]:
                tail.append((a, t))
                if _is_branch(t):
                    break
        found.append((instrs[s][0], addr, run, tail))
    return found


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "k3_sass.txt"))
    args = ap.parse_args()

    from astrild_tpu_torch import _ext

    lib = _ext.build(["pairwise_accumulate"])["pairwise_accumulate"]
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(sass)
    print(f"# k3_sass: {lib} -> {args.out}")
    for line in _ext.build_logs.get("pairwise_accumulate", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"# k3_sass: ptxas: {line.strip()}")
    bad, per_pair = [], []
    for name, instrs in functions(sass).items():
        hist = collections.Counter(opcode(t) for _, t in instrs)
        short = next((k for k in ("pair_tiles", "reduce") if k in name),
                     name)
        print(f"# k3_sass: {short}: {len(instrs)} instructions; "
              + ", ".join(f"{op} {hist[op]}" for op in _FLOAT_OPS))
        if short != "pair_tiles":
            continue
        gaps = box_gap_runs(instrs)
        ffma = sum(opcode(t) == "FFMA" for run in gaps for _, t in run)
        print(f"# k3_sass: box-gap paths: {len(gaps)}, FFMA {ffma}")
        if not gaps or ffma:
            bad.append(f"{len(gaps)} box-gap paths holding {ffma} FFMA")
        for start, addr, run, tail in cut_paths(instrs):
            ops = collections.Counter(opcode(t) for _, t in run + tail)
            pairs = ops["FSETP"]
            n = len(run) + len(tail)
            per_pair.append(n / pairs)
            print(f"# k3_sass: cut path {start:#x}..{addr:#x} + tail: {n} "
                  f"instructions for {pairs} pairs, {n / pairs:.2f} a "
                  "rejected pair; " + ", ".join(
                      f"{op} {c}" for op, c in ops.most_common()))
            if ops["FFMA"]:
                bad.append(f"cut path {start:#x} holds {ops['FFMA']} FFMA")
            for a, t in run + tail:
                print(f"#     {a:#06x}  {t}")
    if not per_pair:
        bad.append("no cut path found in the pair kernel")
    else:
        print(f"# k3_sass: issued instructions per rejected pair: "
              f"{min(per_pair):.2f} .. {max(per_pair):.2f} over "
              f"{len(per_pair)} cut paths")
    if bad:
        sys.exit("k3_sass: " + "; ".join(bad))


if __name__ == "__main__":
    main()
