"""Artifact manifest: content-hashed pipeline checkpointing.

Port of astrild_tpu/core/manifest.py. Artifacts are saved with a
manifest entry recording their content hash and the hashes of their
inputs, so `fresh()` can tell whether a stage needs recomputation and
`load()` restores them (as tensors on the card with `to_device`).

    store = ArtifactStore(dir_out)
    inputs = {"pos": pos_hash or arrays, "params": {...}}
    if not store.fresh("pk_snap12", inputs):
        result = compute(...)
        store.save("pk_snap12", {"k": k, "power": p}, inputs)
    out = store.load("pk_snap12")

The h5 layout and `manifest.json` are the JAX package's, and a tensor
hashes as its host numpy form, so the same values and dtype hash the same
in both packages: a stage that one package stored is fresh for the other.
h5py is imported inside `save` and `load`.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .._device import as_host, as_x32

__all__ = ["ArtifactStore", "content_hash"]


def content_hash(obj) -> str:
    """Stable sha256 of arrays / tensors / nested dicts / scalars /
    strings."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        elif isinstance(x, str):
            h.update(x.encode())
        elif isinstance(x, (int, float, bool)) or x is None:
            h.update(repr(x).encode())
        else:
            arr = as_host(x)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())

    feed(obj)
    return h.hexdigest()


class ArtifactStore:
    """Directory of content-hashed artifacts + a manifest.json index."""

    def __init__(self, dir_out: str):
        self.dir = Path(dir_out)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"
        self.manifest: Dict[str, dict] = {}
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())

    def _write_manifest(self):
        self.manifest_path.write_text(json.dumps(self.manifest, indent=1))

    # ---------------------------------------------------------------- api
    def fresh(self, name: str, inputs) -> bool:
        """True when `name` exists and was produced from these inputs."""
        entry = self.manifest.get(name)
        if entry is None:
            return False
        if not (self.dir / entry["file"]).exists():
            return False
        return entry["inputs_hash"] == content_hash(inputs)

    def save(self, name: str, arrays: Dict[str, np.ndarray], inputs=None,
             meta: Optional[dict] = None) -> str:
        """Write `arrays` (numpy or tensors, taken to the host) as
        `<name>.h5` and record its hashes."""
        import h5py

        fname = f"{name}.h5"
        path = self.dir / fname
        with h5py.File(path, "w") as f:
            for k, v in arrays.items():
                f[k] = as_host(v)
        self.manifest[name] = {
            "file": fname,
            "content_hash": content_hash(arrays),
            "inputs_hash": content_hash(inputs),
            "meta": meta or {},
        }
        self._write_manifest()
        return str(path)

    def load(self, name: str, to_device: bool = False, device=None):
        """The stored arrays as numpy, or with `to_device` as tensors with
        the JAX package's device dtypes (float64 as float32, int64 as
        int32) on `device`, by default the CUDA card."""
        import h5py

        entry = self.manifest[name]
        out = {}
        with h5py.File(self.dir / entry["file"], "r") as f:
            for k in f:
                out[k] = np.asarray(f[k])
        if to_device:
            out = {k: as_x32(v, device) for k, v in out.items()}
        return out

    def verify(self, name: str) -> bool:
        """Re-hash the stored artifact against its manifest entry."""
        entry = self.manifest[name]
        data = self.load(name)
        return content_hash(data) == entry["content_hash"]

    def stage(self, name: str, inputs, compute):
        """Memoized stage: compute() only when inputs changed.

        Always returns the stored (host numpy) form, whether compute() ran
        or the stored artifact was fresh, so callers see one type.
        """
        if self.fresh(name, inputs):
            return self.load(name)
        out = compute()
        self.save(name, {k: as_host(v) for k, v in out.items()}, inputs)
        return self.load(name)
