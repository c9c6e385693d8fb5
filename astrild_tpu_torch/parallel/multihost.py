"""Multi-process execution: the process group and process-local data.

Port of astrild_tpu/parallel/multihost.py. The JAX package runs one
controller a host, each seeing the global device set; the port runs one
process a rank (torchrun's layout), each holding the blocks of its own
rank. Three layers, as in JAX:

  * `initialize()` starts the process group from the launcher's
    environment (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK;
    the JAX package's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID are read as aliases). It is idempotent; with nothing
    configured it starts a world of one, so pipelines can call it
    unconditionally. NCCL serves a CUDA device, gloo the CPU, and a
    failed NCCL start raises.
  * `host_local_array(local, mesh, spec)` places this rank's chunk of a
    row-sharded global array; ragged per-rank chunks are padded to a
    common size with a validity weight vector (zero-weight rows are inert
    in every particle estimator: paint multiplies by w, and the shot
    noise is V * sum(w^2) / (sum w)^2, see parallel/power).
  * `load_snapshot_sharded(...)` is the striped Gadget reader that feeds
    particle component buffers to the mesh.

Emulation: with `emulate_hosts=n` a rank performs all n hosts' striped
reads itself, assembles the padded global array a real n-host run would
build, and keeps its own rows of it; the stripe -> pad -> place path is
the same either way.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import default_device
from .mesh import AXES, mesh_device, shard, to_mesh

__all__ = ["initialize", "is_distributed", "process_count", "process_index",
           "host_local_array", "pad_to_shard", "load_snapshot_sharded",
           "global_array_from_striped_reads"]


def _env(*names):
    for name in names:
        if name in os.environ:
            return os.environ[name]
    return None


def _coordinator_from_env() -> Optional[str]:
    addr = _env("MASTER_ADDR")
    if addr is not None:
        port = _env("MASTER_PORT")
        return f"{addr}:{port}" if port is not None else addr
    return _env("JAX_COORDINATOR_ADDRESS")


def _cuda_index(rank: int, local_device_ids) -> int:
    if local_device_ids is not None:
        return int(list(local_device_ids)[0])
    local = _env("LOCAL_RANK")
    if local is not None:
        return int(local)
    return rank % torch.cuda.device_count()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device=None) -> torch.device:
    """Start the process group (idempotent); returns this rank's device.

    Arguments default from the launcher's environment (torchrun's
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK; JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID as aliases). With nothing configured,
    or a world size of 1 and no address, it starts a world of one. A world
    size given without a rank raises rather than run as one process (every
    process would then read the FULL snapshot).

    device: 'cuda' (NCCL, the default; raises without a card) or 'cpu'
    (gloo). On the card the rank takes `local_device_ids[0]`, else
    LOCAL_RANK, else its rank modulo the cards; if NCCL fails to start,
    the error propagates (no gloo on the card).
    """
    dev = default_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: a CUDA mesh needs a card, "
                           "and no card is available; pass device='cpu'")
    if dist.is_initialized():
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise RuntimeError(
                f"multihost.initialize: the process group runs "
                f"{dist.get_backend()}, and a {dev.type} mesh needs {want}")
        if dev.type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return dev
    coordinator_address = coordinator_address or _coordinator_from_env()
    if num_processes is None:
        n = _env("WORLD_SIZE", "JAX_NUM_PROCESSES")
        num_processes = None if n is None else int(n)
    if process_id is None:
        r = _env("RANK", "JAX_PROCESS_ID")
        process_id = None if r is None else int(r)
    single = (num_processes is None and coordinator_address is None) or (
        num_processes is not None and int(num_processes) == 1
        and coordinator_address is None)
    if not single and process_id is None:
        raise ValueError(
            f"multihost.initialize: a world of {num_processes} processes "
            "needs this process's rank (RANK or JAX_PROCESS_ID); refusing "
            "to run as a single process")
    world = 1 if single else int(num_processes or 0)
    rank = 0 if single else int(process_id)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"backend": backend}
    if dev.type == "cuda":
        idx = _cuda_index(rank, local_device_ids)
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
        kwargs["device_id"] = dev
    if single:
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    else:
        kwargs.update(
            init_method=(f"tcp://{coordinator_address}"
                         if coordinator_address is not None else "env://"),
            rank=rank, world_size=world)
    dist.init_process_group(**kwargs)
    return dev


def is_distributed() -> bool:
    return process_count() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _row_shard_count(mesh, spec: tuple) -> int:
    """Number of shards the leading dimension splits into under `spec`."""
    dim0 = spec[0] if len(spec) else None
    if dim0 is None:
        return 1
    axes = (dim0,) if isinstance(dim0, str) else tuple(dim0)
    n = 1
    for a in axes:
        n *= mesh.size(AXES.index(a))
    return n


def _rows_spec(spec: tuple) -> tuple:
    """Spec for a 1-D per-row companion array (weights)."""
    return (spec[0],) if len(spec) else ()


def pad_to_shard(arrays, nshards: int, target_rows: Optional[int] = None):
    """Pad row-count-ragged host chunks to a common per-shard size.

    arrays: list/tuple of (n, ...) numpy arrays sharing their leading
    count. Returns (padded_arrays, weights) where weights is (n_padded,)
    float32 with 1 for real rows, 0 for padding — feed it as the particle
    weight vector so padded rows are inert.
    """
    arrays = [np.asarray(a) for a in arrays]
    n = arrays[0].shape[0]
    ragged = [a.shape[0] for a in arrays if a.shape[0] != n]
    if ragged:
        # a block present in only some files would otherwise pad to a
        # different length than its companions and the validity weights
        # would mark rows that don't exist in it
        raise ValueError(f"pad_to_shard: arrays disagree on leading rows "
                         f"({[a.shape[0] for a in arrays]})")
    if target_rows is None:
        target_rows = -(-n // nshards) * nshards
    if target_rows % nshards:
        raise ValueError(f"target_rows {target_rows} not divisible by "
                         f"{nshards} shards")
    if target_rows < n:
        raise ValueError(f"target_rows {target_rows} < chunk rows {n}")
    pad = target_rows - n
    out = [np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a
        for a in arrays]
    w = np.concatenate([np.ones(n, np.float32),
                        np.zeros(pad, np.float32)])
    return out, w


def host_local_array(local, mesh, spec: tuple,
                     global_shape: Optional[tuple] = None) -> torch.Tensor:
    """This rank's chunk of a globally-sharded array, on the mesh's device.

    `local` holds the rows this rank contributes (equal-sized across the
    ranks that split the rows, see pad_to_shard). With `global_shape` the
    rows must be this rank's share of it.
    """
    if global_shape is not None:
        nshards = _row_shard_count(mesh, spec)
        if np.shape(local)[0] * nshards != global_shape[0]:
            raise ValueError(f"{np.shape(local)[0]} local rows x {nshards} "
                             f"shards != global rows {global_shape[0]}")
    return to_mesh(local, mesh)


def global_array_from_striped_reads(read_stripe, mesh, spec: tuple,
                                    emulate_hosts: Optional[int] = None):
    """This rank's blocks of a global row-sharded array assembled from
    per-host striped reads.

    read_stripe(nstripe, rank) -> list of (n_r, ...) numpy arrays: reads
    rank's stripe of the files (the gadget reader's `partition`). In a
    world of several ranks each reads its own stripe; the chunks are padded
    to the largest per-rank count (an all_reduce of the counts), so the
    blocks are equal-sized. Returns (arrays, weights), this rank's blocks,
    with weights marking real vs padded rows.

    emulate_hosts: perform ALL n hosts' reads in this process, concatenate
    them in host order (the byte-identical global array a real n-host run
    assembles) and keep this rank's rows under `spec`.
    """
    nshards = _row_shard_count(mesh, spec)
    nproc = process_count()
    if emulate_hosts is None and nproc > 1:
        rank = process_index()
        if nshards != nproc:
            raise ValueError(f"{nshards} row shards for {nproc} processes: "
                             "each rank holds one row block")
        local = read_stripe(nproc, rank)
        n_here = np.asarray(local[0]).shape[0]
        count = torch.tensor([n_here], dtype=torch.int64,
                             device=mesh_device(mesh))
        dist.all_reduce(count, op=dist.ReduceOp.MAX)
        per_host = int(count.item())
        padded, w = pad_to_shard(local, 1, per_host)
        gshape_rows = per_host * nproc
        arrs = [host_local_array(
            a, mesh, spec, (gshape_rows,) + a.shape[1:]) for a in padded]
        wg = host_local_array(w, mesh, _rows_spec(spec), (gshape_rows,))
        return arrs, wg
    # emulate the striped assembly, then keep this rank's rows
    nhosts = int(emulate_hosts or 1)
    if nshards % nhosts:
        raise ValueError(f"{nshards} row shards not divisible by "
                         f"{nhosts} emulated hosts")
    stripes = [read_stripe(nhosts, r) for r in range(nhosts)]
    counts = [np.asarray(s[0]).shape[0] for s in stripes]
    shards_here = nshards // nhosts
    per_host = -(-max(counts) // shards_here) * shards_here
    padded_all, ws = [], []
    for s in stripes:
        padded, w = pad_to_shard(list(s), shards_here, per_host)
        padded_all.append(padded)
        ws.append(w)
    arrs = [np.concatenate([p[i] for p in padded_all])
            for i in range(len(padded_all[0]))]
    w = np.concatenate(ws)
    placed = [shard(to_mesh(a, mesh), mesh, spec) for a in arrs]
    wg = shard(to_mesh(w, mesh), mesh, _rows_spec(spec))
    return placed, wg


def load_snapshot_sharded(snapnum: int, directory: str, mesh,
                          blocks: Sequence[str] = ("Coordinates",),
                          parttype=(1,), spec: tuple = (AXES,),
                          emulate_hosts: Optional[int] = None,
                          flat_components: bool = True):
    """Striped multi-file Gadget read -> this rank's particle blocks.

    Each rank reads files [rank::nproc] (io/gadget_hdf5.py `partition`)
    and the chunks assemble into a global leading-dim-sharded array of
    which this rank keeps its block, ready for the parallel/power
    factories. Returns (data, weights): data maps block -> tensor — (n, k)
    blocks become k flat (n,) component buffers ``block:i`` when
    flat_components — and weights is the (n,) validity vector to pass as
    the estimators' `weights` argument.
    """
    from ..io.gadget_hdf5 import GadgetSnapshot

    snap = GadgetSnapshot(snapnum, directory)
    # per-block trailing shapes/dtypes from hdf5 METADATA only (no data
    # read): needed both to expand (n, k) blocks into k flat components
    # and to synthesize EMPTY stripes when a rank owns no files (more
    # ranks than snapshot files)
    shapes = _block_shapes(snap, blocks, parttype)

    def read_stripe(nstripe, rank):
        data = GadgetSnapshot(snapnum, directory).read(
            list(blocks), parttype=parttype, partition=(nstripe, rank))
        out = []
        for b in blocks:
            tail, dt = shapes[b]
            a = np.asarray(data[b]) if b in data else \
                np.zeros((0,) + tail, dt)
            if flat_components and a.ndim == 2:
                out.extend(np.ascontiguousarray(a[:, i])
                           for i in range(a.shape[1]))
            else:
                out.append(a)
        return out

    placed, w = global_array_from_striped_reads(
        read_stripe, mesh, spec, emulate_hosts=emulate_hosts)
    data = {}
    i = 0
    for b in blocks:
        tail, _ = shapes[b]
        if flat_components and len(tail) == 1:
            for c in range(tail[0]):
                data[f"{b}:{c}"] = placed[i]
                i += 1
        else:
            data[b] = placed[i]
            i += 1
    data["header"] = snap.header
    return data, w


def _block_shapes(snap, blocks, parttype):
    """{block: (trailing_shape, dtype)} from the first file's hdf5
    metadata (dataset .shape/.dtype — no array data is read)."""
    import glob as _glob

    import h5py

    base = snap.snapname
    if base is None:
        # GadgetSnapshot.__init__ is lenient (catalog-only directories);
        # the loader must fail here with the paths it tried, matching
        # GadgetSnapshot.read(), not with TypeError(None + str) below
        raise FileNotFoundError(
            "no snapshot files found; tried "
            + ", ".join(c + "(.0).hdf5" for c in snap._candidates))
    first = base + ".hdf5"
    if not os.path.isfile(first):
        files = sorted(_glob.glob(base + ".*.hdf5"),
                       key=lambda p: int(p.split(".")[-2]))
        if not files:
            raise FileNotFoundError(f"no snapshot files match {base}*.hdf5")
        first = files[0]
    pts = (list(parttype) if parttype is not None else None)
    out = {}
    with h5py.File(first, "r") as f:
        if pts is None:
            pts = [int(k[8:]) for k in f.keys() if k.startswith("PartType")]
        for b in blocks:
            tail, dt = (), np.float64
            for pt in pts:
                g = f.get(f"PartType{pt}")
                if g is not None and b in g:
                    tail = tuple(g[b].shape[1:])
                    dt = g[b].dtype
                    break
            out[b] = (tail, np.dtype(dt))
    return out
