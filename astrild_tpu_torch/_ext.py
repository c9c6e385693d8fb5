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

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "check",
           "build_logs"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "astrild_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of each library's exports: name -> {symbol: (argtypes, restype)}
_SIGNATURES = {
    "deposit_sorted": {
        # keys, vals, n, out, n_cells, chunk, scratch, scratch bytes, stream
        "astrild_deposit_sorted": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int),
        "astrild_deposit_flat": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int),
        # n, n_cells, flat, weighted, chunk
        "astrild_deposit_scratch_bytes": (
            [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int64],
            ctypes.c_int64),
        "astrild_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "deposit_segmented": {
        # keys, vals, n, out (zeroed), n_cells, stream
        "astrild_deposit_segmented": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int),
        "astrild_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "paint_windowed": {
        # pos (3, n), weights, n, ngrid, box, h, order, tile_of, ids,
        # offsets (2 n_tiles + 1), n_tiles, out (zeroed), stream
        "astrild_paint_windowed": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        # pos, n, ngrid, box, h, order, tile_of, counts, n_tiles, keys,
        # frac (3, n), stream
        # pos (3, n), weights, n, ngrid, box, h, order, grad_out (n^3),
        # grad_pos (3, n) or null, grad_w (n,) or null, stream
        "astrild_paint_windowed_adjoint": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p],
            ctypes.c_int),
        "astrild_paint_windowed_bins": (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p],
            ctypes.c_int),
        "astrild_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "pairwise_accumulate": {
        # pos4, vel4, hat4 (rows in tile order, float4 each), chunk boxes
        # lo, hi and tile boxes lo, hi (float4 each), n_tiles, s_max,
        # binwidth, nbins, grid, partials (grid * 2 * nbins), out
        # (2, nbins), stream
        "astrild_pairwise_accumulate": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p],
            ctypes.c_int),
        "astrild_pairwise_grid": ([ctypes.c_int], ctypes.c_int64),
        "astrild_pairwise_tile_rows": ([], ctypes.c_int),
        "astrild_pairwise_chunk_rows": ([], ctypes.c_int),
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


def _library_path(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / f"lib{name}.so"


def build(names) -> dict[str, Path]:
    """Build the libraries of kernels `names` that are not built yet, one
    nvcc process per source, all started together; returns their paths.
    Raises if any build fails (after every started build has ended)."""
    paths = {name: _library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {_CSRC / name}.cu:\n{stderr}")
            continue
        build_logs[name] = stderr
        # atomic: a concurrent loader never sees half a file
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
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
