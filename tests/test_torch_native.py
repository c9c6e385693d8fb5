"""The port's native C++ oracle (astrild_tpu_torch.native) on the CPU: the
source is a byte copy of the JAX package's, its library gives the JAX
package's library's outputs bit for bit on the same inputs, and
tests/test_native.py's five checks hold against the port's torch
functions with their bars.

The JAX package's library is built here from its own source with its own
Makefile flags into the test's temporary directory and loaded through its
own bridge, so the test writes nothing into the source tree.
"""
import os
import struct
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu import native as jnative  # noqa: E402

from astrild_tpu_torch import native  # noqa: E402
from astrild_tpu_torch._ext import BUILD_DIR  # noqa: E402
from astrild_tpu_torch.ops import lensing as TL  # noqa: E402
from astrild_tpu_torch.ops import pairwise as TPW  # noqa: E402
from astrild_tpu_torch.utils.geometry import (  # noqa: E402
    angular_coordinate_in_lc, convert_vec_sph_to_cart)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(REPO, "astrild_tpu", "native", "astrild_native.cpp")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    # beside JAX in one process, torch's first threaded float32 sqrt now
    # and then comes back 2^-12 low on the second thread's half of the
    # array; a first call below the threading grain settles it
    torch.sqrt(torch.ones(16))
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def have_native():
    if not native.available():
        pytest.skip("g++ with OpenMP is needed to build the native library")


def _jax_library(tmp_path) -> str:
    """The JAX package's source built with its Makefile's flags."""
    out = str(tmp_path / "libastrild_native_jax.so")
    subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-fopenmp",
                    "-std=c++17", "-Wall", "-o", out, JAX_SRC], check=True,
                   capture_output=True, timeout=300)
    return out


@pytest.fixture
def jax_bridge(tmp_path, monkeypatch, have_native):
    """The JAX package's bridge loading the library built from its source
    under tmp_path."""
    monkeypatch.setattr(jnative, "_LIB_PATH", _jax_library(tmp_path))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()
    return jnative


def test_source_is_a_byte_copy():
    port_src = os.path.join(REPO, "astrild_tpu_torch", "native",
                            "astrild_native.cpp")
    assert open(port_src, "rb").read() == open(JAX_SRC, "rb").read()
    assert native.CXX_FLAGS == ("-O3", "-fPIC", "-shared", "-fopenmp",
                                "-std=c++17", "-Wall")


def test_library_builds_under_build_dir(have_native):
    path = native.library_path()
    assert path.exists() and path.parent.parent == BUILD_DIR
    assert not os.path.exists(os.path.join(REPO, "astrild_tpu_torch",
                                           "native", "libastrild_native.so"))


def test_functions_raise_without_a_library(tmp_path, monkeypatch):
    """No compiler: available() is False, the functions raise, and the
    message says why; a CXX in the environment is not read."""
    monkeypatch.setenv("CXX", "g++-from-the-environment")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "none" / "libastrild_native.so")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    with pytest.raises(RuntimeError, match="not on PATH"):
        native.kappa_to_phi(np.zeros((4, 4)), 1.0)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.pairwise_velocity(np.zeros((2, 3)), np.zeros((2, 3)),
                                 np.arange(3.0))


def test_lensing_outputs_equal_jax_library(jax_bridge, rng):
    kappa = rng.standard_normal((48, 48))
    for fn in ("kappa_to_alphas", "kappa_to_phi"):
        got = getattr(native, fn)(kappa, 0.01)
        want = getattr(jax_bridge, fn)(kappa, 0.01)
        for a, b in zip(np.atleast_3d(got), np.atleast_3d(want)):
            npt.assert_array_equal(a, b)
    # a float32 tensor is taken to the host in float64 as numpy would be
    a1, _ = native.kappa_to_alphas(torch.from_numpy(kappa.astype(np.float32)),
                                   0.01)
    b1, _ = jax_bridge.kappa_to_alphas(kappa.astype(np.float32), 0.01)
    npt.assert_array_equal(a1, b1)


def test_f77_and_pairwise_equal_jax_library(jax_bridge, tmp_path, rng):
    vals = rng.standard_normal(10)
    buf = b"".join(struct.pack("i", 8 * len(c)) + c.tobytes()
                   + struct.pack("i", 8 * len(c))
                   for c in (vals[:3], vals[3:]))
    npt.assert_array_equal(native.read_f77_doubles(buf, 100),
                           jax_bridge.read_f77_doubles(buf, 100))
    with pytest.raises(IOError):
        native.read_f77_doubles(buf[:-1] + b"\x07", 100)
    # the pair sums run over OpenMP's dynamic schedule, whose per-thread
    # partial sums depend on the schedule: bit for bit at one thread, in a
    # fresh process (OMP_NUM_THREADS is read when libgomp starts)
    pos = rng.uniform(0, 200, (700, 3))
    vel = rng.normal(0, 300, (700, 3))
    np.save(tmp_path / "pos.npy", pos)
    np.save(tmp_path / "vel.npy", vel)
    code = (
        "import ctypes, sys, numpy as np\n"
        "from astrild_tpu import native as J\n"
        "from astrild_tpu_torch import native as T\n"
        f"J._LIB_PATH = {jax_bridge._LIB_PATH!r}\n"
        f"pos = np.load({str(tmp_path / 'pos.npy')!r})\n"
        f"vel = np.load({str(tmp_path / 'vel.npy')!r})\n"
        "bins = np.linspace(0, 60, 13)\n"
        "a = T.pairwise_velocity(pos, vel, bins)\n"
        "b = J.pairwise_velocity(pos, vel, bins)\n"
        "ok = all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))\n"
        "print('EQUAL' if ok else f'DIFF {a} {b}')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "EQUAL" in out.stdout, out.stdout
    # in this process, with its threads: equal to float64 rounding
    bins = np.linspace(0, 60, 13)
    (ra, va), (rb, vb) = (native.pairwise_velocity(pos, vel, bins),
                          jax_bridge.pairwise_velocity(pos, vel, bins))
    npt.assert_array_equal(ra, rb)
    npt.assert_allclose(va, vb, rtol=1e-12)


# ------------------------------------------------ tests/test_native.py
def test_native_kappa_to_alpha_matches_torch(have_native):
    n = 64
    e = (np.arange(n) + 0.5) / n - 0.5
    r2 = e[:, None] ** 2 + e[None, :] ** 2
    kappa = np.exp(-r2 / (2 * 0.05 ** 2))
    oa = 1.0
    a1c, a2c = native.kappa_to_alphas(kappa, oa)
    a1t, a2t = TL.kappa_to_alpha(torch.tensor(kappa, dtype=torch.float32),
                                 oa, padding_factor=4)
    # real-space kernel convolution in C++ against the spectral torch op
    scale = np.abs(a1c).max()
    npt.assert_allclose(a1t.numpy(), a1c, atol=0.03 * scale)
    npt.assert_allclose(a2t.numpy(), a2c, atol=0.03 * scale)


def test_native_kappa_to_phi_gradient_is_alpha(have_native):
    n = 64
    e = (np.arange(n) + 0.5) / n - 0.5
    r2 = e[:, None] ** 2 + e[None, :] ** 2
    kappa = np.exp(-r2 / (2 * 0.08 ** 2))
    oa = 1.0
    ds = oa / n
    phi = native.kappa_to_phi(kappa, oa)
    a1, a2 = native.kappa_to_alphas(kappa, oa)
    g1 = np.gradient(phi, ds, axis=0)
    g2 = np.gradient(phi, ds, axis=1)
    c = n // 2
    sl = np.s_[c - 12:c + 12, c - 12:c + 12]
    scale = np.abs(a1[sl]).max()
    npt.assert_allclose(g1[sl], a1[sl], atol=0.05 * scale)
    npt.assert_allclose(g2[sl], a2[sl], atol=0.05 * scale)


def test_native_pairwise_matches_reference_golden(have_native):
    n = 2000
    pos = np.zeros((n, 3))
    pos[:, 0] = np.linspace(-10, 10, n)
    pos[:1000, 1] = -5
    pos[1000:, 1] = np.linspace(5, 50, 1000)
    pos[:, 2] = 500
    tvel = np.zeros((n, 2))
    tvel[:1000, 1] = 100
    tvel[1000:, 1] = -100
    # the same spherical -> cartesian embedding as mean_pv_from_tv, in the
    # port's float64 torch geometry
    t1, t2 = angular_coordinate_in_lc(torch.from_numpy(pos), unit="rad")
    t1 = t1 + np.deg2rad(10)
    t2 = t2 + np.deg2rad(10)
    vel_sph = torch.from_numpy(np.hstack([np.zeros((n, 1)), tvel]))
    vel_cart = convert_vec_sph_to_cart(t2, t1, vel_sph).numpy()
    bins = np.linspace(0, 50, 40)
    rsep, v12 = native.pairwise_velocity(pos, vel_cart, bins)
    npt.assert_allclose(v12[0], -9.98742453e-02, rtol=1e-6)
    npt.assert_allclose(v12[-1], -1.80198033658e+02, rtol=1e-6)


def test_native_pairwise_matches_torch_estimator(have_native, rng):
    n = 500
    pos = rng.uniform(400, 600, (n, 3))
    vel = rng.normal(0, 100, (n, 3))
    bins = np.linspace(0, 100, 20)
    r_c, v_c = native.pairwise_velocity(pos, vel, bins)
    r_t, v_t = TPW.mean_pairwise_velocity(
        torch.tensor(pos, dtype=torch.float32),
        torch.tensor(vel, dtype=torch.float32), bins)
    v_t = v_t.numpy()
    good = np.isfinite(v_c) & np.isfinite(v_t)
    assert good.sum() >= 15
    npt.assert_allclose(v_t[good], v_c[good], rtol=2e-3, atol=0.5)


def test_native_f77_reader(have_native):
    vals = np.arange(10.0)
    buf = (struct.pack("i", 40) + vals[:5].tobytes() + struct.pack("i", 40)
           + struct.pack("i", 40) + vals[5:].tobytes()
           + struct.pack("i", 40))
    out = native.read_f77_doubles(buf, 100)
    npt.assert_array_equal(out, vals)
