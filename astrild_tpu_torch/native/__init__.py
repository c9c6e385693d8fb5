"""ctypes bridge to the native C++ oracle (libastrild_native.so).

Port of astrild_tpu/native: the same C++ source (`astrild_native.cpp`, a
byte copy of the JAX package's) and the same four functions and
`available()`. The library is a host-side oracle, on no card path: a
float64 OpenMP pair estimator and a radix-2 FFT lensing convolution,
independent of the port's torch and CUDA code, that the tests and
`chip_smoke.py` hold those against.

The library is built at first use by the `g++` on PATH with the JAX
package's Makefile flags (`-O3 -fPIC -shared -fopenmp -std=c++17 -Wall`)
into `<checkout>/build/astrild_tpu_torch/<hash>/`, the hash covering the
source and the flags; never into the source tree. A `CXX` set in the
environment is not read: a compiler wrapper it names may lack OpenMP. `available()` says
whether it built and loaded; each function raises when it did not.
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .._device import as_host
from .._ext import BUILD_DIR

__all__ = ["available", "kappa_to_alphas", "kappa_to_phi",
           "pairwise_velocity", "read_f77_doubles", "CXX_FLAGS",
           "library_path", "build_seconds", "build_log"]

_SRC = Path(__file__).resolve().parent / "astrild_native.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall")
_lib = None
_tried = False
_LOCK = threading.Lock()
# seconds the build in this process took (None: no build ran here), and
# what the compiler said (or why it could not run)
build_seconds: Optional[float] = None
build_log = ""


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / digest / "libastrild_native.so"


def _build(out: Path) -> bool:
    global build_seconds, build_log
    cxx = shutil.which(CXX)
    if cxx is None:
        build_log = f"no C++ compiler: {CXX} is not on PATH"
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        build_log = f"{' '.join(cmd)}: {e}"
        return False
    build_log = f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    build_seconds = time.perf_counter() - t0
    # atomic: a concurrent loader never sees half a file
    os.replace(tmp, out)
    return True


def _load() -> Optional[ct.CDLL]:
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ct.CDLL(str(path))
        except OSError:
            return None
        dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.kappa0_to_alphas.argtypes = [dptr, ct.c_int, ct.c_double, dptr,
                                         dptr]
        lib.kappa0_to_alphas.restype = None
        lib.kappa0_to_phi.argtypes = [dptr, ct.c_int, ct.c_double, dptr]
        lib.kappa0_to_phi.restype = None
        lib.pairwise_velocity_accumulate.argtypes = [
            dptr, dptr, ct.c_longlong, ct.c_double, ct.c_int, dptr, dptr]
        lib.pairwise_velocity_accumulate.restype = None
        lib.read_f77_doubles.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
            ct.c_longlong, dptr, ct.c_longlong]
        lib.read_f77_doubles.restype = ct.c_longlong
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ct.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {library_path()} "
                           "did not build (g++ with OpenMP is needed):\n"
                           f"{build_log}")
    return lib


def _host(x) -> np.ndarray:
    return np.ascontiguousarray(as_host(x), np.float64)


def kappa_to_alphas(kappa, opening_angle: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Native C++ kappa -> (alpha1, alpha2); opening_angle in radians."""
    lib = _lib_or_raise()
    kappa = _host(kappa)
    n = kappa.shape[0]
    a1 = np.zeros((n, n))
    a2 = np.zeros((n, n))
    lib.kappa0_to_alphas(kappa, n, float(opening_angle), a1, a2)
    return a1, a2


def kappa_to_phi(kappa, opening_angle: float) -> np.ndarray:
    """Native C++ kappa -> lensing potential phi (log kernel)."""
    lib = _lib_or_raise()
    kappa = _host(kappa)
    n = kappa.shape[0]
    phi = np.zeros((n, n))
    lib.kappa0_to_phi(kappa, n, float(opening_angle), phi)
    return phi


def pairwise_velocity(pos, vel, bins) -> Tuple[np.ndarray, np.ndarray]:
    """Native Yasini+18 pairwise estimator (float64, every pair) ->
    (rsep, v12), NaN in empty bins."""
    lib = _lib_or_raise()
    pos = _host(pos)
    vel = _host(vel)
    bins = _host(bins)
    binnr = len(bins)
    binwidth = float(bins[1] - bins[0])
    nom = np.zeros(binnr)
    den = np.zeros(binnr)
    lib.pairwise_velocity_accumulate(pos, vel, len(pos), binwidth, binnr,
                                     nom, den)
    with np.errstate(invalid="ignore", divide="ignore"):
        v12 = np.where(den > 0, nom / den, np.nan)
    rsep = np.linspace(0, (binnr - 1) * binwidth, binnr) + binwidth / 2
    return rsep, v12


def read_f77_doubles(buf: bytes, max_out: int) -> np.ndarray:
    """The float64 payloads of consecutive Fortran-77 records in `buf`."""
    lib = _lib_or_raise()
    arr = np.frombuffer(buf, np.uint8)
    out = np.zeros(max_out)
    n = lib.read_f77_doubles(np.ascontiguousarray(arr), len(arr), out,
                             max_out)
    if n < 0:
        raise IOError("F77 record marker mismatch")
    return out[:n]
