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
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import as_tensor

__all__ = ["AXES", "make_mesh", "sim_axis_mesh", "auto_mesh",
           "pencil_sharding", "replicated", "shard",
           "unshard", "axis_size", "axis_index", "mesh_device", "to_mesh",
           "psum",
           "psum_scatter", "all_to_all"]

AXES = ("sim", "x", "y")


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
    return init_device_mesh(dev.type, (n_sim, n_x, n_y),
                            mesh_dim_names=AXES)


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

def psum(v: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """lax.psum(v, axes): all_reduce over the group of each axis in
    turn."""
    out = v.clone()
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


def psum_scatter(v: torch.Tensor, mesh: DeviceMesh, axis: str,
                 scatter_dimension: int) -> torch.Tensor:
    """lax.psum_scatter(v, axis, scatter_dimension, tiled=True): the sum
    over the axis's group, of which this rank keeps its tile along
    `scatter_dimension` (reduce_scatter_tensor, which scatters dim 0)."""
    n = axis_size(mesh, axis)
    x = v.movedim(scatter_dimension, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=mesh.get_group(axis))
    return out.movedim(0, scatter_dimension)


def all_to_all(v: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """lax.all_to_all(v, axis, split_axis, concat_axis, tiled=True): tile
    j of `split_axis` goes to rank j of the axis's group, and the tiles
    received concatenate along `concat_axis` in rank order."""
    n = axis_size(mesh, axis)
    x = v.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis))
    tiles = out.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    return torch.cat([t.movedim(0, split_axis) for t in tiles.unbind(0)],
                     dim=concat_axis)
