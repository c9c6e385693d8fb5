"""The painting kernels on the CUDA card, with their plain versions.

Port of astrild_tpu/ops/paint_pallas.py:

- K1, the windowed deposit (`deposit_sorted` on sorted keys,
  `deposit_flat` on keys in any order), in csrc/deposit_sorted.cu: the
  keys reach their window of output cells by binary search (sorted) or by
  a counting partition (any order, no sort), and one block per chunk of a
  window's entries accumulates in shared memory;
- K2, the windowed CIC/TSC painter (`paint_windowed`), in
  csrc/paint_windowed.cu: particles binned by output tile with a counting
  sort, one block per tile; with its adjoint (`paint_windowed_adjoint`,
  one thread a particle gathering the gradient grid), which makes the
  painter differentiable on the card in positions and weights;
- K4, the chunk-sorted deposit (`deposit_flat_segmented`), in
  csrc/deposit_segmented.cu: one block per chunk of input keys, sorted in
  shared memory.

The kernels are hand-written CUDA C++ that accumulate in shared memory
(see the sources for their design). The TPU version's window/chunk tuning
(`_auto_deposit_params`, `_fit_seg_params`) has no counterpart: each CUDA
kernel fixes its own tiling.

On a CPU tensor the wrappers run the plain PyTorch versions
(`deposit_sorted_reference`, `paint_windowed_reference`,
`deposit_flat_segmented_reference`, `paint_windowed_adjoint_reference`);
on a CUDA tensor they launch the kernel or raise. `LAUNCHES` counts kernel
launches per wrapper, so a run can show that its main path went through
the kernel. K1 and K4 have no gradient, as their TPU twins have none: on
a CUDA tensor they raise when grad mode is on and their weights require
grad, rather than return a detached sum.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from .. import _ext

__all__ = ["deposit_sorted", "deposit_flat", "deposit_sorted_reference",
           "deposit_flat_segmented", "deposit_flat_segmented_reference",
           "paint_windowed", "paint_windowed_reference",
           "paint_windowed_adjoint", "paint_windowed_adjoint_reference",
           "LAUNCHES"]

LAUNCHES: Counter = Counter()

_MAX_CELLS = 1 << 31
# K1: entries one block of the accumulate pass takes at most (a window
# holding more is split over several blocks), and the keys of one call
# (its per-window counters are 32-bit)
_CHUNK = 1 << 15
_MAX_KEYS = (1 << 32) - 1


def _refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a gradient would detach its output:
    grad mode is on and one of `tensors` (None allowed) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no gradient, and an input "
            "requires grad; its output would be silently detached. Run it "
            "under torch.no_grad(), detach the inputs, or take the "
            "differentiable route (a CPU tensor's plain version, or "
            "paint's CIC/TSC, whose kernel K2 has an adjoint)")


def deposit_sorted_reference(keys_sorted: torch.Tensor,
                             vals_sorted: torch.Tensor | None,
                             n_cells: int) -> torch.Tensor:
    """Plain version of `deposit_sorted`: a scatter-add, order-free."""
    w = (torch.ones(keys_sorted.shape[0], dtype=torch.float32,
                    device=keys_sorted.device) if vals_sorted is None
         else vals_sorted.to(torch.float32))
    out = torch.zeros(n_cells, dtype=torch.float32, device=keys_sorted.device)
    return out.index_add_(0, keys_sorted.long(), w)


def _check_inputs(keys: torch.Tensor, vals: torch.Tensor | None,
                  n_cells: int) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"deposit_sorted: keys must be 1-D int32, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("deposit_sorted: keys must be contiguous")
    if not 0 <= n_cells < _MAX_CELLS:
        raise ValueError(f"deposit_sorted: n_cells={n_cells} outside "
                         f"[0, 2^31)")
    if keys.shape[0] > _MAX_KEYS:
        raise ValueError(f"deposit_sorted: {keys.shape[0]} keys, more than "
                         f"K1 counts in one call (2^32 - 1)")
    if vals is None:
        return
    if vals.dtype != torch.float32 or vals.shape != keys.shape:
        raise ValueError(f"deposit_sorted: vals must be float32 of shape "
                         f"{tuple(keys.shape)}, got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if vals.device != keys.device:
        raise ValueError(f"deposit_sorted: vals on {vals.device}, keys on "
                         f"{keys.device}")
    if not vals.is_contiguous():
        raise ValueError("deposit_sorted: vals must be contiguous")


def _launch_k1(entry: str, keys: torch.Tensor, vals: torch.Tensor | None,
               n_cells: int) -> torch.Tensor:
    """One K1 call on the card: `entry` "flat" (keys in any order: the
    window partition, then the accumulate pass) or "sorted" (window
    segments by binary search, then the same accumulate pass). Counts as
    one launch, whatever number of passes it runs; the scratch is
    allocated here and nothing waits on the card."""
    if keys.device.type != "cuda":
        raise ValueError(f"deposit_{entry}: no kernel for device "
                         f"{keys.device}")
    _refuse_grad(f"deposit_{entry}", vals)
    _check_inputs(keys, vals, n_cells)
    lib = _ext.load("deposit_sorted")
    n = keys.shape[0]
    dev = keys.device
    out = torch.empty(n_cells, dtype=torch.float32, device=dev)
    flat = entry == "flat"
    nbytes = lib.astrild_deposit_scratch_bytes(n, n_cells, int(flat),
                                               int(vals is not None), _CHUNK)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    launch = lib.astrild_deposit_flat if flat else lib.astrild_deposit_sorted
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(keys.data_ptr(), None if vals is None else vals.data_ptr(),
                    n, out.data_ptr(), n_cells, _CHUNK, scratch.data_ptr(),
                    nbytes, stream)
    _ext.check(lib, rc, f"deposit_{entry}")
    LAUNCHES["deposit_sorted"] += 1
    return out


def deposit_sorted(keys_sorted: torch.Tensor,
                   vals_sorted: torch.Tensor | None,
                   n_cells: int) -> torch.Tensor:
    """Deposit pre-sorted (cell, weight) pairs into a flat grid.

    keys_sorted: (N,) int32 ascending cell indices in [0, n_cells) (on
      the card, keys outside it are dropped).
    vals_sorted: (N,) float32 weights co-sorted with keys, or None for unit
      weights (counts, exact below 2^24 per cell).
    Returns (n_cells,) float32 on the keys' device.
    """
    if keys_sorted.device.type == "cpu":
        return deposit_sorted_reference(keys_sorted, vals_sorted, n_cells)
    return _launch_k1("sorted", keys_sorted, vals_sorted, n_cells)


def deposit_flat(flat_idx: torch.Tensor, weights: torch.Tensor | None,
                 n_cells: int) -> torch.Tensor:
    """Deposit of keys in any order: drop-in for
    `zeros(n_cells).index_add_(0, flat, w)`.

    weights=None deposits counts (exact below 2^24 per cell). On a CUDA
    tensor K1 partitions the keys by window of 8192 cells (a histogram, a
    scan and a scatter of 13-bit offsets, no sort) and accumulates each
    window in shared memory; keys outside [0, n_cells) are dropped there.
    On a CPU tensor it is the plain version, `deposit_sorted_reference`.
    """
    flat = flat_idx.reshape(-1).to(torch.int32)
    vals = None if weights is None else weights.reshape(-1).to(torch.float32)
    if flat.device.type == "cpu":
        return deposit_sorted_reference(flat, vals, n_cells)
    return _launch_k1("flat", flat.contiguous(),
                      None if vals is None else vals.contiguous(), n_cells)


# ---------------------------------------------------------------- K4
def _check_segmented(flat: torch.Tensor, weights: torch.Tensor | None,
                     n_cells: int, n_seg: int) -> None:
    if n_seg < 1:
        raise ValueError(f"deposit_flat_segmented: n_seg must be >= 1, got "
                         f"{n_seg}")
    if not 0 <= n_cells < _MAX_CELLS:
        raise ValueError(f"deposit_flat_segmented: n_cells={n_cells} "
                         f"outside [0, 2^31)")
    n = flat.numel()
    if weights is not None and (weights.numel() != n
                                or weights.device != flat.device):
        raise ValueError(f"deposit_flat_segmented: weights must hold {n} "
                         f"values on {flat.device}, got "
                         f"{tuple(weights.shape)} on {weights.device}")


def _segment_layout(flat_idx: torch.Tensor, weights: torch.Tensor | None,
                    n_cells: int, n_seg: int):
    """The (n_seg, seg_len) input of the plain version (and of the TPU
    kernel, paint_pallas.py:455-481): the keys padded at the tail with the
    sentinel n_cells (the weights with 0) and sorted within each row, the
    weights gathered with their keys. Returns (keys (n_seg, seg_len)
    int32, weights in the same layout or None)."""
    _check_segmented(flat_idx, weights, n_cells, n_seg)
    flat = flat_idx.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    seg_len = max(1, -(-n // n_seg))
    pad = n_seg * seg_len - n
    keys = torch.cat([flat, flat.new_full((pad,), n_cells)])
    keys_s, order = torch.sort(keys.view(n_seg, seg_len), dim=1,
                               stable=False)
    del keys
    if weights is None:
        return keys_s, None
    w = weights.reshape(-1).to(torch.float32)
    vals = torch.cat([w, w.new_zeros(pad)]).view(n_seg, seg_len)
    return keys_s, torch.gather(vals, 1, order)


def deposit_flat_segmented_reference(flat_idx: torch.Tensor,
                                     weights: torch.Tensor | None,
                                     n_cells: int,
                                     n_seg: int = 64) -> torch.Tensor:
    """Plain version of `deposit_flat_segmented`: the TPU kernel's padded,
    row-sorted layout, then one `index_add_` into n_cells + 1 slots whose
    last (the sentinel's) is dropped."""
    keys_s, vals_s = _segment_layout(flat_idx, weights, n_cells, n_seg)
    w = (torch.ones(keys_s.numel(), dtype=torch.float32,
                    device=keys_s.device) if vals_s is None
         else vals_s.reshape(-1))
    out = torch.zeros(n_cells + 1, dtype=torch.float32, device=keys_s.device)
    out.index_add_(0, keys_s.reshape(-1).long(), w)
    return out[:n_cells]


def deposit_flat_segmented(flat_idx: torch.Tensor,
                           weights: torch.Tensor | None, n_cells: int,
                           n_seg: int = 64) -> torch.Tensor:
    """Deposit of keys in any order: drop-in for
    `zeros(n_cells).index_add_(0, flat, w)` like `deposit_flat`, for keys
    whose given order is already spatially coherent.

    flat_idx: (N,) integer cell indices in [0, n_cells); weights: (N,) or
    None for unit weights (counts, exact below 2^24 per cell). Returns
    (n_cells,) float32 on the keys' device. n_seg is the JAX signature's
    segment count: the plain version (the CPU path) sorts within n_seg
    segments as the TPU kernel does; on a CUDA tensor K4 sorts each chunk
    of 4096 keys in shared memory instead, with no device-wide sort and no
    index array, and its result does not depend on n_seg.
    """
    if flat_idx.device.type == "cpu":
        return deposit_flat_segmented_reference(flat_idx, weights, n_cells,
                                                n_seg)
    if flat_idx.device.type != "cuda":
        raise ValueError(f"deposit_flat_segmented: no kernel for device "
                         f"{flat_idx.device}")
    _refuse_grad("deposit_flat_segmented", weights)
    _check_segmented(flat_idx, weights, n_cells, n_seg)
    keys = flat_idx.reshape(-1).to(torch.int32).contiguous()
    vals = (None if weights is None
            else weights.reshape(-1).to(torch.float32).contiguous())
    lib = _ext.load("deposit_segmented")
    out = torch.zeros(n_cells, dtype=torch.float32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.astrild_deposit_segmented(
            keys.data_ptr(), None if vals is None else vals.data_ptr(),
            keys.shape[0], out.data_ptr(), n_cells, stream)
    _ext.check(lib, rc, "deposit_flat_segmented")
    LAUNCHES["deposit_segmented"] += 1
    return out


# ---------------------------------------------------------------- K2
def _axis_weight(f, a: int, order: int):
    """Window weight along one axis for offset `a` (paint_pallas.py:601)."""
    if order == 2:
        return f if a else 1.0 - f
    if a == 0:
        return 0.75 - f * f
    return 0.5 * (0.5 + a * f) ** 2


def _offsets(order: int):
    axis = (0, 1) if order == 2 else (-1, 0, 1)
    return [(dx, dy, dz) for dx in axis for dy in axis for dz in axis]


def _windowed_keys(pos_flat: torch.Tensor, ngrid: int, boxsize,
                   order: int):
    """Padded base keys (n,) int32 and fractions (3, n) of
    `paint_windowed` (paint_pallas.py:672-714), in the positions' float
    type (float32 as the kernel; float64 for a gradient check).

    Positions are wrapped first, so every base cell is in range and the
    fold of the padded grid supplies the periodic wrap of the offsets. CIC
    takes base cell floor(x/h - 0.5) + 1 with f = x/h - 0.5 - floor; TSC
    takes the centre cell clipped to [0, n-1] with d = x/h - ic - 0.5 from
    the CLIPPED index, so a particle whose x/h rounds to n gets centre n-1
    with d = +0.5 (the same deposit as centre 0 with d = -0.5). h is a
    tensor on the positions' device: a Python scalar divisor becomes a
    multiplication by its reciprocal on the card, and K2 divides.
    """
    n = pos_flat.shape[0] // 3
    npd = ngrid + 2
    dtype = pos_flat.dtype
    h = torch.tensor(boxsize / ngrid, dtype=dtype, device=pos_flat.device)
    ip, frac = [], []
    for c in pos_flat.reshape(3, n):
        c = torch.remainder(c, boxsize)
        if order == 2:
            u = c / h - 0.5
            i0 = torch.floor(u)
            frac.append(u - i0)
            ip.append(i0.to(torch.int32) + 1)
        else:
            u = c / h
            ic = torch.clamp(torch.floor(u).to(torch.int32), 0, ngrid - 1)
            frac.append(u - ic.to(dtype) - 0.5)
            ip.append(ic + 1)
    key = (ip[0] * npd + ip[1]) * npd + ip[2]
    return key, torch.stack(frac)


def _fold_pad(padded: torch.Tensor, ngrid: int) -> torch.Tensor:
    """Fold the periodic pad of an (n+2)^3 grid back: padded index p ->
    cell (p - 1) mod n (paint_pallas.py:800-807). Adds into `padded`."""
    g = padded
    for ax in range(3):
        core = g.narrow(ax, 1, ngrid)
        core.select(ax, ngrid - 1).add_(g.select(ax, 0))
        core.select(ax, 0).add_(g.select(ax, ngrid + 1))
        g = core
    return g.contiguous()


def _check_windowed(pos_flat, weights, ngrid: int, order: int) -> None:
    if order not in (2, 3):
        raise ValueError(f"paint_windowed: order must be 2 (CIC) or 3 "
                         f"(TSC), got {order}")
    if pos_flat.dim() != 1 or pos_flat.shape[0] % 3:
        raise ValueError(f"paint_windowed: pos_flat must be flat (3n,), got "
                         f"{tuple(pos_flat.shape)}")
    if (ngrid + 2) ** 3 >= _MAX_CELLS:
        raise ValueError(f"paint_windowed: ngrid={ngrid} gives a padded "
                         f"grid of 2^31 cells or more")
    n = pos_flat.shape[0] // 3
    if weights is not None and (weights.shape != (n,)
                                or weights.device != pos_flat.device):
        raise ValueError(f"paint_windowed: weights must be ({n},) on "
                         f"{pos_flat.device}, got {tuple(weights.shape)} on "
                         f"{weights.device}")


def paint_windowed_reference(pos_flat: torch.Tensor,
                             weights: torch.Tensor | None, ngrid: int,
                             boxsize, order: int = 3) -> torch.Tensor:
    """Plain version of `paint_windowed`: the same keys, clip and fold,
    with one `index_add_` per offset on the padded grid (order-free).
    Differentiable in positions and weights by autograd. It computes in
    float32 as the kernel does, or in float64 for float64 positions (a
    gradient check)."""
    _check_windowed(pos_flat, weights, ngrid, order)
    npd = ngrid + 2
    dtype = (torch.float64 if pos_flat.dtype == torch.float64
             else torch.float32)
    key, frac = _windowed_keys(pos_flat.to(dtype), ngrid, boxsize, order)
    grid = torch.zeros(npd ** 3, dtype=dtype, device=pos_flat.device)
    for dx, dy, dz in _offsets(order):
        w = (_axis_weight(frac[0], dx, order) * _axis_weight(frac[1], dy, order)
             * _axis_weight(frac[2], dz, order))
        if weights is not None:
            w = w * weights.to(dtype)
        grid.index_add_(0, (key + (dx * npd + dy) * npd + dz).long(), w)
    return _fold_pad(grid.view(npd, npd, npd), ngrid)


# base cells per K2 tile along x, y, z: csrc/paint_windowed.cu's kTX, kTY,
# kTZ (the kernel refuses a tile count that does not match its own)
_TILE = (16, 16, 32)


def _tile_grid(ngrid: int) -> tuple[int, int, int]:
    """Tiles along x, y and z that cover an ngrid^3 grid of base cells."""
    return tuple(-(-ngrid // t) for t in _TILE)


def _tile_ids(key: torch.Tensor, ngrid: int, order: int) -> torch.Tensor:
    """K2's tile of each particle from the plain version's padded keys
    (`_windowed_keys`): the base cell, wrapped into [0, n), divided by the
    tile shape. Plain torch, for checking the bin pass."""
    npd = ngrid + 2
    k = key.long()
    ip = torch.stack([k // (npd * npd), (k // npd) % npd, k % npd])
    base = torch.remainder(ip - 1, ngrid)  # CIC's -1 wraps to n-1
    _, nty, ntz = _tile_grid(ngrid)
    t = [base[ax] // _TILE[ax] for ax in range(3)]
    return ((t[0] * nty + t[1]) * ntz + t[2]).to(torch.int32)


def _windowed_args(pos_flat, ngrid: int, boxsize):
    n = pos_flat.shape[0] // 3
    n_tiles = math.prod(_tile_grid(ngrid))
    # the float32 values the plain version's remainder and division see
    return n, n_tiles, float(boxsize), float(boxsize / ngrid)


def windowed_bins(pos_flat: torch.Tensor, ngrid: int, boxsize,
                  order: int = 3):
    """K2's bin pass alone, for checking it on the card: (tile of each
    particle (n,) int32, particles per tile (n_tiles,) int32, the plain
    version's padded keys (n,) int32 and fractions (3, n) float32 as the
    kernel computes them). Not a launch of the painter."""
    if pos_flat.device.type != "cuda":
        raise ValueError(f"windowed_bins: needs a CUDA tensor, got "
                         f"{pos_flat.device}")
    _check_windowed(pos_flat, None, ngrid, order)
    pos = pos_flat.to(torch.float32).contiguous()
    n, n_tiles, box, h = _windowed_args(pos, ngrid, boxsize)
    dev = pos.device
    tiles = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    frac = torch.empty(3, n, dtype=torch.float32, device=dev)
    lib = _ext.load("paint_windowed")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.astrild_paint_windowed_bins(
            pos.data_ptr(), n, ngrid, box, h, order, tiles.data_ptr(),
            counts.data_ptr(), n_tiles, keys.data_ptr(), frac.data_ptr(),
            stream)
    _ext.check(lib, rc, "windowed_bins")
    return tiles, counts, keys, frac


def _launch_k2(pos: torch.Tensor, w: torch.Tensor | None, ngrid: int,
               boxsize, order: int) -> torch.Tensor:
    """One K2 deposit on the card (four kernels on the current stream)."""
    n, n_tiles, box, h = _windowed_args(pos, ngrid, boxsize)
    dev = pos.device
    tile_of = torch.empty(n, dtype=torch.int32, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.zeros(2 * n_tiles + 1, dtype=torch.int32, device=dev)
    out = torch.zeros(ngrid, ngrid, ngrid, dtype=torch.float32, device=dev)
    lib = _ext.load("paint_windowed")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.astrild_paint_windowed(
            pos.data_ptr(), None if w is None else w.data_ptr(), n, ngrid,
            box, h, order, tile_of.data_ptr(), ids.data_ptr(),
            offsets.data_ptr(), n_tiles, out.data_ptr(), stream)
    _ext.check(lib, rc, "paint_windowed")
    LAUNCHES["paint_windowed"] += 1
    return out


class _PaintWindowed(torch.autograd.Function):
    """K2 as an autograd node: the deposit forward, its hand-written
    adjoint backward (positions (3n,) and weights (n,) float32,
    contiguous, on the card)."""

    @staticmethod
    def forward(ctx, pos, w, ngrid, boxsize, order):
        ctx.geometry = (ngrid, boxsize, order)
        ctx.save_for_backward(pos, w)
        return _launch_k2(pos, w, ngrid, boxsize, order)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_grid):
        pos, w = ctx.saved_tensors
        grad_pos, grad_w = _launch_adjoint(
            pos, w, grad_grid, *ctx.geometry, ctx.needs_input_grad[0],
            ctx.needs_input_grad[1])
        return grad_pos, grad_w, None, None, None


def paint_windowed(pos_flat: torch.Tensor, weights: torch.Tensor | None,
                   ngrid: int, boxsize, order: int = 3) -> torch.Tensor:
    """CIC (order 2) or TSC (order 3) deposit of flat positions, periodic.

    pos_flat: (3n,) float32, x, y and z concatenated; weights: (n,) or
    None. Returns (ngrid, ngrid, ngrid) float32: the deposit of
    `paint_cic` / `paint_tsc` up to the order of the float sums.

    On a CUDA tensor K2 bins the particles by 16 x 16 x 32-cell output
    tile (a counting sort of int32 ids, the keys computed in one pass) and
    paints each tile in shared memory, straight into the periodic grid.
    The result is differentiable in the positions and weights on both
    routes: the plain version through autograd, the kernel through its
    adjoint (`paint_windowed_adjoint`), launched in the backward pass.
    """
    if pos_flat.device.type == "cpu":
        return paint_windowed_reference(pos_flat, weights, ngrid, boxsize,
                                        order)
    if pos_flat.device.type != "cuda":
        raise ValueError(f"paint_windowed: no kernel for device "
                         f"{pos_flat.device}")
    _check_windowed(pos_flat, weights, ngrid, order)
    pos = pos_flat.to(torch.float32).contiguous()
    w = (None if weights is None
         else weights.to(torch.float32).contiguous())
    return _PaintWindowed.apply(pos, w, ngrid, boxsize, order)


def paint_windowed_adjoint_reference(pos_flat: torch.Tensor,
                                     weights: torch.Tensor | None,
                                     grad_grid: torch.Tensor, ngrid: int,
                                     boxsize, order: int = 3):
    """Plain version of `paint_windowed_adjoint`: autograd through
    `paint_windowed_reference` (whose `index_add_` differentiates)."""
    with torch.enable_grad():
        p = pos_flat.detach().to(torch.float32).requires_grad_(True)
        w = (None if weights is None else
             weights.detach().to(torch.float32).requires_grad_(True))
        out = paint_windowed_reference(p, w, ngrid, boxsize, order)
        grads = torch.autograd.grad(out, (p,) if w is None else (p, w),
                                    grad_grid)
    return grads[0], (None if w is None else grads[1])


def _launch_adjoint(pos, w, grad_grid, ngrid: int, boxsize, order: int,
                    need_pos: bool = True, need_weights: bool = True):
    """One adjoint launch on the card: (gradient of the positions (3n,) or
    None, of the weights (n,) or None)."""
    n = pos.shape[0] // 3
    dev = pos.device
    g = grad_grid.to(torch.float32).contiguous()
    if g.shape != (ngrid, ngrid, ngrid) or g.device != dev:
        raise ValueError(f"paint_windowed_adjoint: grad_grid must be "
                         f"({ngrid},) * 3 on {dev}, got {tuple(g.shape)} on "
                         f"{g.device}")
    grad_pos = (torch.empty(3 * n, dtype=torch.float32, device=dev)
                if need_pos else None)
    grad_w = (torch.empty(n, dtype=torch.float32, device=dev)
              if need_weights and w is not None else None)
    _, _, box, h = _windowed_args(pos, ngrid, boxsize)
    lib = _ext.load("paint_windowed")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.astrild_paint_windowed_adjoint(
            pos.data_ptr(), None if w is None else w.data_ptr(), n, ngrid,
            box, h, order, g.data_ptr(),
            None if grad_pos is None else grad_pos.data_ptr(),
            None if grad_w is None else grad_w.data_ptr(), stream)
    _ext.check(lib, rc, "paint_windowed_adjoint")
    LAUNCHES["paint_windowed_adjoint"] += 1
    return grad_pos, grad_w


def paint_windowed_adjoint(pos_flat: torch.Tensor,
                           weights: torch.Tensor | None,
                           grad_grid: torch.Tensor, ngrid: int, boxsize,
                           order: int = 3):
    """The gradient of `paint_windowed`: given grad_grid, the gradient of
    a loss with respect to the painted (ngrid, ngrid, ngrid) grid, returns
    (the gradient with respect to pos_flat (3n,), with respect to weights
    (n,), None for unit weights).

    On a CUDA tensor one thread a particle recomputes K2's base cell and
    fractions (the same wrap, division by h and TSC clip) and gathers the
    8 or 27 cells of grad_grid around it; on a CPU tensor it is the plain
    version, autograd through `paint_windowed_reference`.
    """
    if pos_flat.device.type == "cpu":
        return paint_windowed_adjoint_reference(pos_flat, weights, grad_grid,
                                                ngrid, boxsize, order)
    if pos_flat.device.type != "cuda":
        raise ValueError(f"paint_windowed_adjoint: no kernel for device "
                         f"{pos_flat.device}")
    _check_windowed(pos_flat, weights, ngrid, order)
    pos = pos_flat.detach().to(torch.float32).contiguous()
    w = (None if weights is None
         else weights.detach().to(torch.float32).contiguous())
    return _launch_adjoint(pos, w, grad_grid, ngrid, boxsize, order)
