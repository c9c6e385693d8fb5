"""Pipeline checkpointing: resumable long-running integrations.

Port of astrild_tpu/core/checkpoint.py. A state is a nested structure of
tuples, lists and dicts whose leaves are tensors (or numpy arrays and
Python numbers); `save_state` writes it as one npz, `restore_state` reads
it back onto the template's devices, and `CheckpointedAccumulator` folds
a long chunk sequence into a running state that it saves every `every`
chunks, so a rerun resumes mid-stream.

The on-disk layout is the JAX package's own when it runs without orbax
(its npz branch): `state.npz` holds the leaves as `arr_0`, `arr_1`, ... in
flatten order and the step as `__step__` (-1 for none), written to a temp
file and moved into place with `os.replace`, so (state, step) commit
together and a crash mid-save keeps the previous checkpoint; `meta.json`
and `schedule.json` are written the same way. A checkpoint written by
either package restores in the other. Checkpoints that orbax wrote (a
`state/` directory) cannot be read here and raise.

Flatten order is the JAX package's `jax.tree_util` order: the items of a
tuple or list in order, the values of a dict by sorted key, None holding
no leaf, the containers as their pytrees flatten them (a `Grid3D` its
`values`, a `SkyGrid` its layers and a `Catalog` its columns by sorted
name, their static fields kept from the template), anything else one
leaf. So a checkpoint of the containers written by either package
restores in the other.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .catalog import Catalog
from .grid import Grid3D, SkyGrid

__all__ = ["save_state", "restore_state", "bind_schedule",
           "checkpoint_exists", "CheckpointedAccumulator"]


def _as_path(path) -> Path:
    p = Path(path).absolute()
    p.mkdir(parents=True, exist_ok=True)
    return p


def _container_items(tree):
    """(names, leaves) of a container in its pytree order, or None for
    anything else."""
    if isinstance(tree, Grid3D):
        return ("values",), (tree.values,)
    if isinstance(tree, (SkyGrid, Catalog)):
        d = tree.data if isinstance(tree, SkyGrid) else tree.columns
        names = tuple(sorted(d))
        return names, tuple(d[k] for k in names)
    return None


def _rebuilt_container(template, leaves):
    """`template`'s container with `leaves` in its pytree order."""
    names, old = _container_items(template)
    new = [_unflatten(x, leaves) for x in old]
    if isinstance(template, Grid3D):
        return Grid3D(new[0], template.boxsize)
    if isinstance(template, SkyGrid):
        return SkyGrid(dict(zip(names, new)), template.opening_angle,
                       template.quantity)
    return Catalog(dict(zip(names, new)))


def _flatten(tree) -> list:
    """The leaves of `tree` in flatten order (see the module docstring)."""
    if tree is None:
        return []
    items = _container_items(tree)
    if items is not None:
        return [x for item in items[1] for x in _flatten(item)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _flatten(item)]
    return [tree]


def _unflatten(template, leaves):
    """`template` rebuilt with its leaves taken in order from the
    iterator `leaves`."""
    if template is None:
        return None
    if _container_items(template) is not None:
        return _rebuilt_container(template, leaves)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        items = [_unflatten(item, leaves) for item in template]
        if isinstance(template, tuple) and hasattr(template, "_fields"):
            return type(template)(*items)  # a namedtuple
        return type(template)(items)
    return next(leaves)


def _describe(tree) -> str:
    """The structure of `tree` with its leaves as '*' (for meta.json)."""
    if tree is None:
        return "None"
    items = _container_items(tree)
    if items is not None:
        inner = ", ".join(f"{k!r}: {_describe(x)}" for k, x in zip(*items))
        return f"{type(tree).__name__}({{{inner}}})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(x) for x in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path, state, step: Optional[int] = None) -> None:
    """Persist a nested structure of tensors as one npz.

    The leaves are copied to the host and written as `arr_i` in flatten
    order; `step` travels INSIDE the payload as `__step__`, so (state,
    step) commit atomically: the npz is written to a temp file, then
    `os.replace`d into place. A crash mid-save leaves the previous
    complete checkpoint intact. `meta.json` is still written for human
    inspection, but restore never trusts its step when the payload
    carries one.
    """
    p = _as_path(path)
    arrays = {f"arr_{i}": _to_numpy(x) for i, x in enumerate(_flatten(state))}
    arrays["__step__"] = np.int64(-1 if step is None else step)
    tmp = p / "state.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, p / "state.npz")
    meta = {"step": step, "treedef": _describe(state)}
    mtmp = p / "meta.tmp.json"
    with open(mtmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(mtmp, p / "meta.json")


def _restored_leaf(arr: np.ndarray, t):
    """A saved array as the template leaf `t` holds it: a tensor leaf
    gives its device and dtype (and must match the shape); any other leaf
    gives a CPU tensor of the array as saved."""
    x = torch.from_numpy(arr)
    if not isinstance(t, torch.Tensor):
        return x
    if tuple(x.shape) != tuple(t.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(x.shape)} does "
                         f"not fit the template's {tuple(t.shape)}")
    return x.to(device=t.device, dtype=t.dtype)


def restore_state(path, template, with_step: bool = False):
    """Restore a structure saved by `save_state` (by either package).

    template: the same nested structure, whose tensor leaves give each
    restored leaf its device, dtype and shape (their values are not
    read). Returns the state, or (state, step) with `with_step`; step is
    None where none was saved.
    """
    p = Path(path).absolute()
    meta = {}
    mp = p / "meta.json"
    if mp.exists():
        with open(mp) as fh:
            meta = json.load(fh)
    step = meta.get("step")  # legacy fallback; payload step wins below
    if (p / "state").exists() and not (p / "state.npz").exists():
        raise RuntimeError(
            f"checkpoint at {p} was written with orbax (state/ dir), "
            "which this package cannot read; restore it in the "
            "environment that wrote it (the npz reader would otherwise "
            "die in FileNotFoundError without naming the real cause)")
    flat_t = _flatten(template)
    with np.load(p / "state.npz") as z:
        if "__step__" in z.files:
            s = int(z["__step__"])
            step = None if s < 0 else s
            flat = [z[f"arr_{i}"] for i in range(len(z.files) - 1)]
        else:  # legacy layout: positional arrays only
            flat = [z[k] for k in z.files]
    if len(flat) != len(flat_t):
        raise ValueError(f"checkpoint at {p} holds {len(flat)} arrays but "
                         f"the template has {len(flat_t)} leaves")
    leaves = [_restored_leaf(arr, t) for arr, t in zip(flat, flat_t)]
    state = _unflatten(template, iter(leaves))
    if with_step:
        return state, step
    return state


def bind_schedule(path, schedule: dict) -> None:
    """Pin a run's schedule to its checkpoint directory.

    A checkpointed step count is only meaningful against the schedule
    that produced it: resuming a state evolved to edges_A[k] on
    edges_B[k] of a DIFFERENT schedule is a physically wrong trajectory
    with no error. Callers describe their schedule as a JSON-able dict;
    the first call writes it to `schedule.json`, and every later call
    raises ValueError if the stored schedule differs. Written before the
    first state save, so any resumable checkpoint carries its schedule.
    Checkpoints without a schedule.json but with a state adopt the
    caller's schedule.
    """
    p = _as_path(path)
    sp = p / "schedule.json"
    # normalize through a JSON round trip so float repr / tuple-vs-list
    # differences don't cause false mismatches
    norm = json.loads(json.dumps(schedule))
    if sp.exists():
        with open(sp) as fh:
            stored = json.load(fh)
        if stored != norm:
            diff = {k: (stored.get(k), norm.get(k))
                    for k in set(stored) | set(norm)
                    if stored.get(k) != norm.get(k)}
            raise ValueError(
                f"checkpoint at {p} was written under a different "
                f"schedule — resuming it on this one would follow a "
                f"wrong trajectory. Mismatched fields "
                f"(stored, requested): {diff}. Point ckpt_dir somewhere "
                "fresh or rerun with the original arguments.")
        return
    tmp = p / "schedule.tmp.json"
    with open(tmp, "w") as fh:
        json.dump(norm, fh)
    os.replace(tmp, sp)


def checkpoint_exists(path) -> bool:
    """Whether `path` holds a checkpoint (the state is authoritative;
    meta.json may be missing after a crash between the state's commit and
    its own)."""
    p = Path(path).absolute()
    return ((p / "state.npz").exists() or (p / "state").exists()
            or (p / "meta.json").exists())


class CheckpointedAccumulator:
    """Resumable streaming accumulation over a long chunk sequence.

    `update` folds one chunk into a running state; the state is
    checkpointed every `every` chunks, and a rerun after an interruption
    resumes from the last completed chunk.

        acc = CheckpointedAccumulator(dir, init_state, update_fn, every=8)
        for i, chunk in enumerate(chunks):
            acc.step(i, chunk)          # skips chunks already folded in
        final = acc.finish()            # state + final checkpoint

    A resumed state takes the devices and dtypes of `init_state`.
    """

    def __init__(self, dir_ckpt, init_state, update_fn: Callable,
                 every: int = 1):
        self.dir = Path(dir_ckpt).absolute()
        self.update_fn = update_fn
        self.every = max(int(every), 1)
        if checkpoint_exists(self.dir):
            self.state, step = restore_state(self.dir, init_state,
                                             with_step=True)
            self.next_index = int(step if step is not None else -1) + 1
        else:
            self.state = init_state
            self.next_index = 0
        self.resumed_at = self.next_index

    def step(self, index: int, chunk) -> bool:
        """Fold chunk `index` into the state; no-op if already folded.

        Chunks must be presented in increasing index order. Returns True
        when the chunk was applied (False = skipped on resume).
        """
        if index < self.next_index:
            return False
        if index != self.next_index:
            raise ValueError(
                f"chunk {index} out of order (expected {self.next_index})")
        self.state = self.update_fn(self.state, chunk)
        self.next_index = index + 1
        if self.next_index % self.every == 0:
            save_state(self.dir, self.state, step=index)
        return True

    def finish(self):
        save_state(self.dir, self.state, step=self.next_index - 1)
        return self.state
