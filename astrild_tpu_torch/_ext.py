"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface (no PyTorch
headers) and is compiled at first use by ``nvcc`` into
``<checkout>/build/astrild_tpu_torch/<hash>/lib<name>.so``, where the hash
covers the source and the compiler flags, so an edited kernel rebuilds. The
library is loaded with ctypes; callers pass device pointers from
``tensor.data_ptr()`` and PyTorch's current stream. A build or launch error
raises: nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "load", "check", "build_logs"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "astrild_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of each library's exports: name -> {symbol: (argtypes, restype)}
_SIGNATURES = {
    "deposit_sorted": {
        "astrild_deposit_sorted": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int),
        "astrild_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# compiler output of each build in this process (ptxas register and
# shared-memory usage), keyed by kernel name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at "
                       "first use")


def _build(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / digest / f"lib{name}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
    build_logs[name] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for sym, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.astrild_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({msg})")
