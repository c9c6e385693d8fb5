"""Distributed pairwise statistics: half-ring rotation pair counting.

Port of astrild_tpu/parallel/pairwise.py. Particles are row blocks, one a
rank of the mesh axis `axis`; each step every rank bins the pairs between
its resident block and a visiting one, then the visitors move one hop
around the ring (`mesh.ppermute`). Only floor(P/2) hops run: each
unordered pair of blocks is binned from one side (the Yasini and kSZ pair
terms are i <-> j symmetric), and for an even P the last hop is seen from
both sides, so there alone the global i < j dedup applies. The per-bin
partial sums `psum` at the end.

The tiles are the plain torch tiles of ops.pairwise (the JAX rings bin
with the plain tiles too, not with the pair kernel), with the JAX
package's float32 sums in its tile order; the ring's hop order is its
own, so the sums are the JAX ring's up to the float32 rounding of
masked_bin_reduce's in-tile sums.

Each factory returns fn on this rank's block; numpy input goes to the
mesh's device. The results are replicated (the same on every rank).
"""
from __future__ import annotations

import torch

from ..ops.pairwise import _pairwise_accumulate_tiles
from .mesh import axis_index, axis_size, ppermute, psum, to_mesh

__all__ = ["make_distributed_pairwise", "make_distributed_ksz"]


def half_ring(mesh, axis: str, resident: tuple, count):
    """The half-ring schedule over `axis`: count(visit, dedup, triangular)
    of the resident block against itself, then against the visitors of
    floor((P-1)/2) full hops, and for an even P one last hop with the
    global i < j dedup. Rank r receives from r + 1, so after k hops the
    visitor at r came from (r + k) mod P. `resident` is a tuple of
    tensors, each moved with its own ppermute (leaf by leaf, as JAX's
    tree_map). Returns the summed counts of this rank (not yet psum'd)."""
    nshards = axis_size(mesh, axis)
    perm_back = [((i + 1) % nshards, i) for i in range(nshards)]

    def hop(visit):
        return tuple(ppermute(v, mesh, axis, perm_back) for v in visit)

    acc = count(resident, dedup=True, triangular=True)
    visit = resident
    for _ in range((nshards - 1) // 2):
        visit = hop(visit)
        acc = acc + count(visit, dedup=False)
    if nshards % 2 == 0 and nshards > 1:
        visit = hop(visit)
        acc = acc + count(visit, dedup=True)
    return acc


def _owner(mesh, axis: str, device) -> torch.Tensor:
    """This rank's axis index as the int32 scalar a visiting block carries
    (its global row offset is owner * n_local)."""
    return torch.tensor(axis_index(mesh, axis), dtype=torch.int32,
                        device=device)


def make_distributed_pairwise(mesh, nbins: int, binwidth: float,
                              axis: str = "sim", block: int = 256,
                              n_valid: int | None = None,
                              with_valid_mask: bool = False,
                              kind: str = "yasini"):
    """Build fn(pos, vel[, valid]) -> (nom, den) over all global pairs.

    pos / vel: this rank's (n_local, 3) row blocks of the global catalog
    split over `axis` (equal blocks, multiples of `block`). The Yasini
    q_ij needs the positions' unit vectors, derived inside. Padding, two
    forms:

    * n_valid (the real global row count): correct only when all padding
      sits at the global tail (one catalog padded once, then split);
    * with_valid_mask=True: fn takes a third argument, this rank's 0/1
      row validity. Use it for catalogs of the multihost striped loader,
      whose padding sits at the end of each host's stripe.
    """
    def fn(pos, vel, valid=None):
        if (valid is not None) != with_valid_mask:
            raise ValueError(
                "valid mask mismatch: build the factory with "
                f"with_valid_mask={valid is not None}")
        pos = to_mesh(pos, mesh).to(torch.float32)
        vel = to_mesh(vel, mesh).to(torch.float32)
        nloc = pos.shape[0]
        norm = torch.linalg.vector_norm(pos, dim=1, keepdim=True)
        hat = pos / norm.clamp_min(1e-12)
        me = axis_index(mesh, axis)
        resident = (pos, vel, hat, _owner(mesh, axis, pos.device))
        if valid is not None:
            valid = to_mesh(valid, mesh)
            resident = resident + (valid,)

        def count(visit, dedup, triangular=False):
            vpos, vvel, vhat, vowner = visit[:4]
            nom, den = _pairwise_accumulate_tiles(
                pos, vel, hat, vpos, vvel, vhat, me * nloc,
                int(vowner) * nloc, nbins, binwidth, block,
                n_valid_global=n_valid, valid_i=valid,
                valid_j=visit[4] if valid is not None else None,
                dedup=dedup, triangular=triangular, kind=kind)
            return torch.stack([nom, den])

        sums = psum(half_ring(mesh, axis, resident, count), mesh, axis)
        return sums[0], sums[1]

    return fn


def make_distributed_ksz(mesh, nbins: int, binwidth: float,
                         axis: str = "sim", block: int = 256,
                         n_valid: int | None = None,
                         with_valid_mask: bool = False):
    """Distributed kSZ pairwise momentum estimator (Hand+12).

    Built fn(pos, dT[, valid]) -> (nom, den); p_hat = nom/den. dT is this
    rank's (n_local,) block; it rides the ring in column 0 of the velocity
    slot, so the Yasini schedule (half ring, per-shard validity) serves
    as it is (the tile kind 'ksz').
    """
    inner = make_distributed_pairwise(
        mesh, nbins, binwidth, axis=axis, block=block, n_valid=n_valid,
        with_valid_mask=with_valid_mask, kind="ksz")

    def fn(pos, dT, valid=None):
        dT = to_mesh(dT, mesh).to(torch.float32)
        vel = torch.cat([dT[:, None], dT.new_zeros((dT.shape[0], 2))],
                        dim=1)
        return inner(pos, vel, valid)

    return fn
