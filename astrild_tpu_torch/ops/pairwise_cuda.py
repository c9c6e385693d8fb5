"""Pair-tile kernel of the mean pairwise velocity (K3) on the CUDA card,
with its plain version.

Port of astrild_tpu/ops/pallas_pairwise.py (`pairwise_accumulate_pallas`).
The kernel is hand-written CUDA C++ in csrc/pairwise_accumulate.cu. The
sums are invariant under a permutation of the rows, so the wrapper first
plans the work (`plan`): it sorts the rows along a Morton curve, cuts them
into tiles of `TILE` rows (chunks of `CHUNK`), takes each chunk's and each
tile's bounding box and finds `s_max`, the exact squared-separation cut of
the last bin edge. The kernel walks the triangle of tile pairs in place,
visits only those whose box gap lies below `s_max` (`tile_pairs`), and in
them only the chunk pairs in reach (`chunk_pairs`); each thread adds its
in-range pairs into its own column of bins without atomics, and a second
kernel reduces the blocks' partial rows in float64 in a fixed order: two
runs on the same input give the same bits, and the scratch is O(tiles),
however many tile pairs are in reach (see the source for the design and
the proofs).

On a CPU tensor `pairwise_accumulate` runs the plain PyTorch version
(`pairwise_accumulate_reference`, the all-pairs tiles of ops/pairwise.py,
which shares neither the cut nor the culling); on a CUDA tensor it launches
the kernel or raises. The planning functions are plain torch and run on the
CPU too; `tile_pairs`, `chunk_pairs` and `triangle_item` are the plain
versions of the kernel's walk, for tests and for `plan_stats`. `LAUNCHES`
counts kernel launches, so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import functools
import math
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from .. import _ext
from .paint_cuda import _refuse_grad

__all__ = ["pairwise_accumulate", "pairwise_accumulate_reference",
           "s_max", "spatial_order", "boxes", "tile_pairs", "chunk_pairs",
           "triangle_item", "plan", "plan_stats", "Plan", "LAUNCHES",
           "TILE", "CHUNK"]

LAUNCHES: Counter = Counter()

MAX_BINS = 128
TILE = 256          # rows per tile; kTile in csrc/pairwise_accumulate.cu
CHUNK = 32          # rows per chunk (one warp's); kChunk there
MORTON_BITS = 21    # per axis: a 63-bit key
_FLOAT_INF_BITS = 0x7F800000


def _check_inputs(pos, vel, n_valid: int, nbins: int) -> None:
    if pos.dim() != 2 or pos.shape[1] != 3 or vel.shape != pos.shape:
        raise ValueError(f"pairwise_accumulate: pos and vel must be (n, 3), "
                         f"got {tuple(pos.shape)} and {tuple(vel.shape)}")
    if vel.device != pos.device:
        raise ValueError(f"pairwise_accumulate: vel on {vel.device}, pos on "
                         f"{pos.device}")
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"pairwise_accumulate: nbins={nbins} outside "
                         f"[1, {MAX_BINS}]")
    if not 0 <= n_valid <= pos.shape[0]:
        raise ValueError(f"pairwise_accumulate: n_valid={n_valid} outside "
                         f"[0, {pos.shape[0]}]")


def pairwise_accumulate_reference(pos, vel, n_valid: int, binwidth: float,
                                  nbins: int, block: int = 512):
    """Plain version of `pairwise_accumulate`: the tiled PyTorch estimator
    (`ops.pairwise._pairwise_accumulate`) with uniform bins, over all
    pairs."""
    from .pairwise import _pairwise_accumulate

    _check_inputs(pos, vel, int(n_valid), nbins)
    return _pairwise_accumulate(pos, vel, int(n_valid), nbins,
                                float(binwidth), block=block)


# ------------------------------------------------------------- planning
@functools.lru_cache(maxsize=256)
def _s_max(bw_bits: int, nbins: int) -> np.float32:
    bw = np.array([bw_bits], np.uint32).view(np.float32)[0]
    nb = np.float32(nbins)

    def dropped(bits: int) -> bool:
        s = np.array([bits], np.uint32).view(np.float32)
        with np.errstate(all="ignore"):
            return not bool((np.sqrt(s) / bw)[0] < nb)

    if dropped(0):
        return np.float32(0.0)
    # float32 bit patterns of s >= 0 are ordered as the values; +inf is
    # always dropped, so the first dropped pattern lies in (lo, hi]
    lo, hi = 0, _FLOAT_INF_BITS
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if dropped(mid):
            hi = mid
        else:
            lo = mid
    return np.array([hi], np.uint32).view(np.float32)[0]


def s_max(binwidth: float, nbins: int) -> np.float32:
    """The smallest float32 s >= 0 for which float32 `sqrt(s) / binwidth <
    nbins` fails (+inf if only +inf fails it). numpy's float32 sqrt and
    division round correctly, as the kernel's sqrtf and __fdiv_rn do, and
    both are monotone, so for every float32 s >= 0 (and NaN):
    `s < s_max(binwidth, nbins)` exactly when the pair lands in a bin."""
    bw = np.float32(binwidth)
    if not (np.isfinite(bw) and bw > 0):
        raise ValueError(f"s_max: binwidth {binwidth} must be finite and > 0")
    return _s_max(int(np.array([bw]).view(np.uint32)[0]), int(nbins))


def _spread_bits(v):
    """The low MORTON_BITS bits of int64 `v`, two zero bits after each."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def _finite_rows(x):
    """True where every value along the last axis is finite (x - x is 0
    for a finite x, NaN for NaN and +-inf)."""
    return ((x - x) == 0).all(dim=-1)


def spatial_order(pos, n_valid: int):
    """A permutation of rows 0 .. n_valid-1 of `pos` along a Morton curve
    over the finite rows' bounding box (2^21 cells an axis, so tiles stay
    compact at every scale, down to a cluster's, and an outlier leaves the
    rest many cells); rows with a non-finite coordinate go last.
    Deterministic: a stable sort of integer keys. Written in few torch ops,
    since on the card each is a launch the host pays for."""
    n_valid = int(n_valid)
    if n_valid == 0:
        return torch.zeros(0, dtype=torch.int64, device=pos.device)
    p = pos[:n_valid]
    finite = _finite_rows(p)
    lo = torch.where(finite[:, None], p, math.inf).amin(dim=0)
    hi = torch.where(finite[:, None], p, -math.inf).amax(dim=0)
    cells = float(1 << MORTON_BITS)
    # a non-finite row gets an arbitrary cell here and the last key below
    q = ((p - lo) * (cells / (hi - lo).clamp_min(1e-30))).floor()
    q = _spread_bits(q.clamp(0.0, cells - 1.0).to(torch.int64))
    key = (q[:, 0] << 2) | (q[:, 1] << 1) | q[:, 2]
    key = torch.where(finite, key, torch.iinfo(torch.int64).max)
    return torch.sort(key, stable=True).indices


def _tile_rows(pos, vel, hat, order, n_tiles: int):
    """(n_tiles * TILE, 4) float32 rows of pos, vel and hat in `order`;
    rows past len(order) hold NaN positions (no pairs) and zeros."""
    m = order.shape[0]
    rows = n_tiles * TILE
    p4 = pos.new_full((rows, 4), math.nan)
    v4 = pos.new_zeros((rows, 4))
    h4 = pos.new_zeros((rows, 4))
    p4[:m, :3] = pos[order]
    v4[:m, :3] = vel[order]
    h4[:m, :3] = hat[order]
    return p4, v4, h4


def boxes(pos4, rows: int):
    """Per group of `rows` rows of `pos4` ((m * rows, 4)), the box of its
    rows whose three coordinates are finite: lo, hi as (m, 4) float32
    (column 3 zero). A group without such rows gets lo = +inf, hi = -inf,
    whose gap to any box is +inf."""
    t = pos4.view(-1, rows, 4)[..., :3]
    finite = _finite_rows(t)[..., None]
    lo = torch.where(finite, t, math.inf).amin(dim=1)
    hi = torch.where(finite, t, -math.inf).amax(dim=1)
    return (torch.nn.functional.pad(lo, (0, 1)),
            torch.nn.functional.pad(hi, (0, 1)))


def _box_gap(lo_a, hi_a, lo_b, hi_b):
    """Squared box gap, each step a separate float32 op rounded to nearest,
    in the kernel's order: g = max(lo_b - hi_a, lo_a - hi_b, 0) per axis,
    then (gx*gx + gy*gy) + gz*gz."""
    g = torch.maximum(lo_b - hi_a, lo_a - hi_b).clamp_min(0.0)
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    return (gx * gx + gy * gy) + gz * gz


def chunk_pairs(p, items) -> torch.Tensor:
    """Plain version of the kernel's test inside a visited tile pair: for
    each item (ti, tj) of `items`, (n_items, k, k) bool, k = TILE // CHUNK,
    true where i chunk a of ti and j chunk c of tj are walked: their box gap
    is below s_max and, on a diagonal item, c >= a."""
    k = TILE // CHUNK
    clo, chi = p.clo.view(-1, k, 4), p.chi.view(-1, k, 4)
    ti, tj = items[:, 0].long(), items[:, 1].long()
    gap = _box_gap(clo[ti][:, :, None, :3], chi[ti][:, :, None, :3],
                   clo[tj][:, None, :, :3], chi[tj][:, None, :, :3])
    upper = torch.ones((k, k), dtype=torch.bool, device=gap.device).triu()
    keep = gap < torch.tensor(float(p.s_max), device=gap.device)
    return keep & (upper | (ti != tj)[:, None, None])


def tile_pairs(lo, hi, smax):
    """Plain version of the kernel's cull: the tile pairs (ti, tj), ti <=
    tj, whose box gap is below `smax`, as (m, 2) int32 in row-major order
    (the order of the kernel's walk)."""
    n = lo.shape[0]
    gap = _box_gap(lo[:, None, :3], hi[:, None, :3], lo[None, :, :3],
                   hi[None, :, :3])
    upper = torch.ones((n, n), dtype=torch.bool, device=lo.device).triu()
    keep = upper & (gap < torch.tensor(float(smax), device=lo.device))
    return torch.nonzero(keep).to(torch.int32)


def triangle_item(k, n_tiles: int):
    """Plain version of the kernel's decode: item k (int64 array) of the
    upper triangle of n_tiles x n_tiles in row-major order, as (ti, tj)
    with ti <= tj (a float64 estimate of the row, then exact integer
    steps)."""
    k = np.asarray(k, dtype=np.int64)
    n = np.int64(n_tiles)

    def start(t):
        return t * n - t * (t - 1) // 2

    b = 2.0 * float(n) + 1.0
    t = (0.5 * (b - np.sqrt(b * b - 8.0 * k.astype(np.float64)))).astype(
        np.int64).clip(0, n - 1)
    while True:
        down = (t > 0) & (start(t) > k)
        up = (t + 1 < n) & (start(t + 1) <= k)
        if not (down.any() or up.any()):
            return t, t + (k - start(t))
        t = t - down + up


class Plan(NamedTuple):
    """The kernel's inputs: rows in tile order (float4 each), the chunk
    and tile boxes and the cut."""
    pos4: torch.Tensor
    vel4: torch.Tensor
    hat4: torch.Tensor
    clo: torch.Tensor
    chi: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    s_max: float
    n_valid: int


def plan(pos, vel, n_valid: int, binwidth: float, nbins: int) -> Plan:
    """Order, tile and box the first n_valid rows for K3 (on the device of
    `pos`)."""
    n_valid = int(n_valid)
    _check_inputs(pos, vel, n_valid, nbins)
    smax = s_max(binwidth, nbins)
    pos = pos.to(torch.float32)
    vel = vel.to(torch.float32)
    # unit line of sight from each row, before the reordering
    # (pallas_pairwise.py:117-120)
    hat = pos / torch.linalg.vector_norm(pos, dim=1,
                                         keepdim=True).clamp_min(1e-12)
    order = spatial_order(pos, n_valid)
    n_tiles = -(-n_valid // TILE)
    pos4, vel4, hat4 = _tile_rows(pos, vel, hat, order, n_tiles)
    clo, chi = boxes(pos4, CHUNK)
    # a tile's box from its chunks' (min and max are exact)
    lo = clo.view(n_tiles, TILE // CHUNK, 4).amin(dim=1)
    hi = chi.view(n_tiles, TILE // CHUNK, 4).amax(dim=1)
    return Plan(pos4, vel4, hat4, clo, chi, lo, hi, float(smax), n_valid)


def _grid(nbins: int) -> int:
    """Blocks of the pair kernel (partial rows) on the current card."""
    lib = _ext.load("pairwise_accumulate")
    grid = lib.astrild_pairwise_grid(nbins)
    if grid < 0:
        _ext.check(lib, int(-grid), "pairwise_accumulate (grid)")
    return int(grid)


def plan_stats(p: Plan, nbins: int) -> dict:
    """Tiles, tile pairs (all and visited), the pairs the visited tile
    pairs hold and the pairs of the chunk pairs the kernel walks in them,
    and the bytes of the kernel's scratch (partial rows on the card's grid,
    chunk and tile boxes), for a printed account. The visited list is
    built here, by `tile_pairs`; the kernel holds no such list."""
    n_tiles = p.lo.shape[0]
    items = tile_pairs(p.lo, p.hi, p.s_max)
    ti, tj = items[:, 0].long(), items[:, 1].long()
    diag = ti == tj
    held = (p.n_valid - torch.arange(n_tiles, device=p.lo.device) * TILE
            ).clamp(0, TILE)
    a, b = held[ti], held[tj]
    pairs = torch.where(diag, a * (a - 1) // 2, a * b).sum()
    # rows held by each chunk, and the pairs of each walked chunk pair (a
    # diagonal item's own chunk: its pairs j > i)
    k = TILE // CHUNK
    ch = (p.n_valid - torch.arange(n_tiles * k, device=p.lo.device) * CHUNK
          ).clamp(0, CHUNK).view(n_tiles, k)
    ca, cb = ch[ti], ch[tj]
    block = ca[:, :, None] * cb[:, None, :]
    own = torch.eye(k, dtype=torch.bool, device=p.lo.device) & diag[:, None,
                                                                    None]
    block = torch.where(own, (ca * (ca - 1) // 2)[:, :, None], block)
    walked = (block * chunk_pairs(p, items)).sum()
    grid = _grid(nbins) if p.lo.device.type == "cuda" else 0
    scratch = grid * 2 * nbins * 4 + 2 * (p.lo.numel() + p.clo.numel()) * 4
    return {"tiles": n_tiles, "tile_pairs": n_tiles * (n_tiles + 1) // 2,
            "tile_pairs_visited": int(items.shape[0]),
            "pairs_visited": int(pairs), "pairs_walked": int(walked),
            "grid": grid, "scratch_bytes": scratch,
            "tiled_rows_bytes": 3 * p.pos4.numel() * 4}


# --------------------------------------------------------------- kernel
def pairwise_accumulate(pos, vel, n_valid: int, binwidth: float,
                        nbins: int):
    """Yasini Eq. 6 numerator and denominator per separation bin.

    Sums over all pairs i < j < n_valid with bin = int(|x_i - x_j| /
    binwidth) < nbins. pos/vel: (n, 3) float32 (rows at and beyond
    n_valid are ignored); nbins <= 128. Returns (nom, den), each (nbins,)
    float32.
    """
    if pos.device.type == "cpu":
        return pairwise_accumulate_reference(pos, vel, n_valid, binwidth,
                                             nbins)
    if pos.device.type != "cuda":
        raise ValueError(f"pairwise_accumulate: no kernel for device "
                         f"{pos.device}")
    # like its TPU twin, the kernel has no gradient
    _refuse_grad("pairwise_accumulate", pos, vel)
    n_valid = int(n_valid)
    binwidth = float(binwidth)
    lib = _ext.load("pairwise_accumulate")
    if (lib.astrild_pairwise_tile_rows(),
            lib.astrild_pairwise_chunk_rows()) != (TILE, CHUNK):
        raise RuntimeError("pairwise_accumulate: the library's tile and "
                           f"chunk are not {TILE} and {CHUNK} rows")
    with torch.cuda.device(pos.device):
        p = plan(pos, vel, n_valid, binwidth, nbins)
        grid = _grid(nbins)
        partials = torch.empty(grid * 2 * nbins, dtype=torch.float32,
                               device=pos.device)
        out = torch.empty((2, nbins), dtype=torch.float32, device=pos.device)
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = lib.astrild_pairwise_accumulate(
            p.pos4.data_ptr(), p.vel4.data_ptr(), p.hat4.data_ptr(),
            p.clo.data_ptr(), p.chi.data_ptr(), p.lo.data_ptr(),
            p.hi.data_ptr(), p.lo.shape[0], p.s_max, binwidth, nbins, grid,
            partials.data_ptr(), out.data_ptr(), stream)
    _ext.check(lib, rc, "pairwise_accumulate")
    LAUNCHES["pairwise_accumulate"] += 1
    return out[0], out[1]
