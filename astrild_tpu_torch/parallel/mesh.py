"""The device mesh of the distributed layer, on torch.distributed.

Port of astrild_tpu/parallel/mesh.py. The mesh has the axes ('sim', 'x',
'y'): 'sim' is data-parallel over the simulation array, 'x' and 'y'
decompose 3D FFT grids into pencils. The JAX package has one controller
that holds every device's shard; the port runs one process a rank, and a
rank holds only its own block. Rank r sits at the mesh coordinates of
device r of the JAX mesh (row-major over (n_sim, n_x, n_y)), so the
leading-axis row shard P(('sim', 'x', 'y')) of rank r is block
(s * n_x + x) * n_y + y, as in JAX.

A sharding is a partition spec: a tuple with one entry a dimension, each
None (not split), an axis name, or a tuple of axis names (split over
their product, the first one major), as jax.sharding.PartitionSpec.
`shard` cuts this rank's block out of a global tensor and `unshard` puts
the blocks of all ranks back together; they stand in for
jax.device_put(x, NamedSharding(mesh, spec)) where a caller holds the
whole array.
"""
from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import as_tensor

__all__ = ["AXES", "make_mesh", "sim_axis_mesh", "auto_mesh",
           "pencil_sharding", "replicated", "shard",
           "unshard", "axis_size", "axis_index", "mesh_device", "to_mesh",
           "psum", "psum_scatter", "all_gather", "all_to_all", "ppermute",
           "recording"]

AXES = ("sim", "x", "y")


# the meshes `make_mesh` made, for the exit hook (multihost._teardown)
_MESHES: "weakref.WeakSet[DeviceMesh]" = weakref.WeakSet()


def _world(device) -> tuple[int, torch.device]:
    """(world size, device) after starting the process group if none
    exists (a world of one, see multihost.initialize)."""
    from . import multihost

    dev = multihost.initialize(device=device)
    return dist.get_world_size(), dev


def make_mesh(n_sim: int = 1, n_x: int = 1, n_y: int = 1,
              device=None) -> DeviceMesh:
    """Mesh with axes ('sim', 'x', 'y') over every rank of the world.

    device: the device type of the ranks' blocks ('cuda' or 'cpu'; default:
    the CUDA card, raising without one). With no process group this starts
    a world of one (NCCL on the card, gloo on the CPU). Raises unless the
    world has n_sim * n_x * n_y ranks.
    """
    world, dev = _world(device)
    need = n_sim * n_x * n_y
    if need != world:
        raise ValueError(f"mesh {n_sim}x{n_x}x{n_y} needs {need} devices, "
                         f"have {world}")
    mesh = init_device_mesh(dev.type, (n_sim, n_x, n_y),
                            mesh_dim_names=AXES)
    _MESHES.add(mesh)
    return mesh


def sim_axis_mesh(device=None) -> DeviceMesh:
    """All ranks on the 'sim' (data-parallel) axis."""
    world, _ = _world(device)
    return make_mesh(n_sim=world, device=device)


def auto_mesh(device=None, n_sim: int = 1) -> DeviceMesh:
    """Split the ranks left after n_sim into as-square-as-possible
    (x, y)."""
    world, _ = _world(device)
    rest = world // n_sim
    nx = 1
    for cand in range(int(math.isqrt(rest)), 0, -1):
        if rest % cand == 0:
            nx = cand
            break
    return make_mesh(n_sim=n_sim, n_x=nx, n_y=rest // nx, device=device)


def pencil_sharding(mesh: DeviceMesh, batched: bool = False) -> tuple:
    """Spec of an (n, n, n) grid: first two axes over ('x', 'y'); with
    batched=True a leading simulation axis over 'sim'."""
    if batched:
        return ("sim", "x", "y")
    return ("x", "y", None)


def replicated(mesh: DeviceMesh) -> tuple:
    """Spec of a tensor every rank holds whole."""
    return ()


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """lax.axis_size(axis): the mesh's extent along `axis`."""
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """lax.axis_index(axis): this rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def to_mesh(x, mesh: DeviceMesh):
    """`x` on the mesh's device, as jax.jit puts its arguments on the
    mesh: numpy input as tensors there (float as float32, see
    _device.as_tensor), tensors moved there; a tuple of components stays a
    tuple."""
    dev = mesh_device(mesh)
    if isinstance(x, (tuple, list)):
        return tuple(as_tensor(c, dev) for c in x)
    return as_tensor(x, dev)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _pieces(mesh: DeviceMesh, entry, coords: Optional[dict] = None):
    """(number of pieces, this rank's piece) of a dimension split over the
    axes of `entry`, the first axis major (JAX's tiled layout)."""
    n, idx = 1, 0
    for a in _entry_axes(entry):
        size = axis_size(mesh, a)
        c = axis_index(mesh, a) if coords is None else coords[a]
        n, idx = n * size, idx * size + c
    return n, idx


def shard(x: torch.Tensor, mesh: DeviceMesh, spec: tuple) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec` (a view;
    every split dimension must divide evenly)."""
    for d, entry in enumerate(spec):
        n, idx = _pieces(mesh, entry)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split into {n} blocks")
        step = x.shape[d] // n
        x = x.narrow(d, idx * step, step)
    return x


def _coords_of(mesh: DeviceMesh, rank: int) -> dict:
    ids = mesh.mesh.reshape(-1).tolist()
    flat = ids.index(rank)
    s, rem = divmod(flat, mesh.size(1) * mesh.size(2))
    xi, yi = divmod(rem, mesh.size(2))
    return {"sim": s, "x": xi, "y": yi}


def unshard(block: torch.Tensor, mesh: DeviceMesh,
            spec: tuple) -> torch.Tensor:
    """The global tensor whose blocks under `spec` the ranks hold: an
    all_gather over the world, every rank gets the whole. Ranks that hold
    the same block (an axis the spec leaves out) must agree on it."""
    parts = [torch.empty_like(block)
             for _ in range(dist.get_world_size())]
    dist.all_gather(parts, block.contiguous())
    shape = [size * _pieces(mesh, spec[d] if d < len(spec) else None)[0]
             for d, size in enumerate(block.shape)]
    out = torch.empty(shape, dtype=block.dtype, device=block.device)
    for r, part in enumerate(parts):  # all_gather's order: global rank
        coords = _coords_of(mesh, r)
        view = out
        for d in range(block.dim()):
            entry = spec[d] if d < len(spec) else None
            _, idx = _pieces(mesh, entry, coords)
            view = view.narrow(d, idx * block.shape[d], block.shape[d])
        view.copy_(part)
    return out


# ------------------------------------------------------------ collectives
# The JAX collectives inside shard_map, on the groups of the mesh's axes.
# Each takes the tensor and returns a new one (the input is not changed).
# An axis of size 1 issues nothing (XLA drops a collective over a group of
# one as well). psum, psum_scatter, all_gather and all_to_all are autograd
# nodes whose backward is the JAX transpose, written out below; ppermute
# has no gradient (the rings it serves are not differentiated).
#
# The gradient rule of psum. Its output is replicated, and each rank's own
# terms may read it (the global mean of field inference), so the ranks'
# cotangents of one psum differ and the backward all-reduces them. A loss
# that is itself a psum of per-rank terms must then not be differentiated
# through that psum with every rank seeding 1: the gradient would come out
# multiplied by the world size. Differentiate each rank's local term and
# psum its value (parallel/field_infer.value_and_grad does so).

_KINDS = ("all-reduce", "reduce-scatter", "all-gather", "all-to-all",
          "collective-permute")
_RECORD: Optional[dict] = None


@contextmanager
def recording():
    """Record the collectives this rank issues inside the block, backward
    passes included: yields {kind: {"count": N, "bytes": B}}, with XLA's
    HLO names as kinds (all-reduce, reduce-scatter, all-gather, all-to-all,
    collective-permute) and B the bytes of each collective's output on
    this rank (what parallel/inventory.hlo_collectives of the JAX package
    reads from HLO). Off outside the block: the wrappers then only test a
    global for None."""
    global _RECORD
    prev, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _record(kind: str, out: torch.Tensor) -> None:
    if _RECORD is not None:
        rec = _RECORD.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += out.numel() * out.element_size()


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# groups over several mesh axes, made on first use: (mesh, group) by
# (id(mesh), axes); the mesh is kept so that its id is not reused
_GROUPS: dict = {}


def _group(mesh: DeviceMesh, axes: tuple):
    """The process group of this rank over the mesh axes `axes` together
    (the ranks that differ only in them). Made the first time every rank
    asks for it, as a collective call is."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        dims = [AXES.index(a) for a in axes]
        rest = [d for d in range(len(AXES)) if d not in dims]
        size = math.prod(mesh.size(d) for d in dims)
        ids = mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()
        group, _ = dist.new_subgroups_by_enumeration(ids)
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def _all_reduce(v, mesh, axes):
    """One all_reduce over the axes of size > 1 together (XLA's one
    all-reduce of a psum over several axes); a copy if there are none."""
    out = v.clone()
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if axes:
        _record("all-reduce", out)
        dist.all_reduce(out, group=_group(mesh, axes))
    return out


# all_gather_into_tensor and reduce_scatter_tensor, under the names newer
# torch gives them
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _reduce_scatter(v, mesh, axis, dim):
    n = axis_size(mesh, axis)
    if n == 1:
        return v.clone()
    x = v.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _record("reduce-scatter", out)
    _SCATTER(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _all_gather(v, mesh, axis, dim):
    n = axis_size(mesh, axis)
    if n == 1:
        return v.clone()
    x = v.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _record("all-gather", out)
    _GATHER(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _all_to_all(v, mesh, axis, split_axis, concat_axis):
    n = axis_size(mesh, axis)
    if n == 1:
        return v.clone()
    x = v.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(x)
    _record("all-to-all", out)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis))
    tiles = out.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    return torch.cat([t.movedim(0, split_axis) for t in tiles.unbind(0)],
                     dim=concat_axis)


class _PSum(torch.autograd.Function):
    """all-reduce; backward: all-reduce of the cotangents."""

    @staticmethod
    def forward(ctx, v, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(v, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _PSumScatter(torch.autograd.Function):
    """reduce-scatter; backward: the tiled all-gather on the same dim."""

    @staticmethod
    def forward(ctx, v, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(v, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllGather(torch.autograd.Function):
    """tiled all-gather; backward: the reduce-scatter on the same dim."""

    @staticmethod
    def forward(ctx, v, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(v, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    """all-to-all; backward: the all-to-all with the split and concat
    axes swapped."""

    @staticmethod
    def forward(ctx, v, mesh, axis, split_axis, concat_axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split, ctx.concat = split_axis, concat_axis
        return _all_to_all(v, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.mesh, ctx.axis, ctx.concat, ctx.split),
                None, None, None, None)


def psum(v: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """lax.psum(v, axes): one all_reduce over the group of the axes
    together. Backward: the all-reduce of the cotangents (see the rule
    above)."""
    return _PSum.apply(v, mesh, _axes(axes))


def psum_scatter(v: torch.Tensor, mesh: DeviceMesh, axis: str,
                 scatter_dimension: int) -> torch.Tensor:
    """lax.psum_scatter(v, axis, scatter_dimension, tiled=True): the sum
    over the axis's group, of which this rank keeps its tile along
    `scatter_dimension` (reduce_scatter_tensor, which scatters dim 0).
    Backward: the tiled all_gather on that dimension."""
    return _PSumScatter.apply(v, mesh, axis, scatter_dimension)


def all_gather(v: torch.Tensor, mesh: DeviceMesh, axis: str,
               axis_dim: int, tiled: bool = True) -> torch.Tensor:
    """lax.all_gather(v, axis, axis=axis_dim, tiled=True): the ranks'
    blocks of the axis's group concatenated along `axis_dim` in rank order
    (all_gather_into_tensor on that dimension moved to the front).
    Backward: the psum_scatter on that dimension."""
    if not tiled:
        raise NotImplementedError("all_gather: only the tiled form (the "
                                  "one the distributed layer uses)")
    return _AllGather.apply(v, mesh, axis, axis_dim)


def all_to_all(v: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """lax.all_to_all(v, axis, split_axis, concat_axis, tiled=True): tile
    j of `split_axis` goes to rank j of the axis's group, and the tiles
    received concatenate along `concat_axis` in rank order. Backward: the
    all_to_all with the two axes swapped."""
    return _AllToAll.apply(v, mesh, axis, split_axis, concat_axis)


def ppermute(v: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm) -> torch.Tensor:
    """lax.ppermute(v, axis, perm): perm holds (source, destination)
    pairs of axis indices; this rank sends `v` to its destination and
    returns what its source sent (zeros where no pair names it as a
    destination, as in JAX). One dist.batch_isend_irecv over the axis's
    group; a P2POp's peer is the global rank of that axis index. A pair
    whose source is its destination is a copy."""
    me = axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(v)
    if axis_size(mesh, axis) == 1 or (dst == [me] and src == [me]):
        return v.clone() if src else out
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    x = v.contiguous()
    ops = [dist.P2POp(dist.isend, x, ranks[d], group=group) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group=group) for s in src]
    if src:
        _record("collective-permute", out)
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return out
