"""The collective inventory of the distributed layer, as issued.

Port of astrild_tpu/parallel/inventory.py. The JAX package reads the
collectives (kind, count, bytes a rank) out of a compiled module's
optimized HLO. Every collective of the port passes through the wrappers
of parallel/mesh.py, which record them when asked; `collective_inventory`
runs a factory's call under that recorder and returns the same dict shape
as the JAX package's `hlo_collectives`:
{kind: {"count": N, "bytes": B}}, kinds named as in HLO (all-reduce,
reduce-scatter, all-gather, all-to-all, collective-permute), B the bytes
of each collective's output on this rank.

The two count different things; this rule maps the port's count onto the
JAX manifest's (tests/data/collective_manifest.json, held by
tests/test_torch_collective_inventory.py):

* XLA compiles a `lax.scan` body once, so a collective inside a scan
  counts once however many steps run; the port issues it every step. The
  PM force, evaluated once before the KDK scan and once a step, counts
  twice in XLA's module and 1 + S times in the port (S steps); a
  gradient's backward follows the steps autograd runs (the last force's
  has no gradient path).
* XLA's combiner merges independent all-reduces into one (a psum over
  two axes, the re and im psums of an SHT); the port issues one
  all_reduce an axis of size > 1 and stacks what one psum can carry.

What this rule does not explain is listed in PERF.md, section 7.
"""
from __future__ import annotations

from .mesh import recording

__all__ = ["collective_inventory"]


def collective_inventory(fn, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) on this rank with the recorder on and return
    its collectives: {kind: {"count": N, "bytes": B}} (kinds with no op
    left out). Every rank of the world must make the same call."""
    with recording() as rec:
        fn(*args, **kwargs)
    return {k: dict(v) for k, v in rec.items()}
