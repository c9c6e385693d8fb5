"""The port's whole z=0 analysis suite vs the same four stages written from
astrild_tpu ops (as bench.py composes them), on the CPU at a small size:
32^3 particles, a 64^3 grid, 64 lens planes and 256^2 maps.

bench.py itself is not imported: it sets a compilation cache directory at
import. Each tolerance is stated where it is checked.
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import bispectrum as JB  # noqa: E402
from astrild_tpu.ops import lensing as JL  # noqa: E402
from astrild_tpu.ops import peaks as JK  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu.ops import voids as JV  # noqa: E402
from astrild_tpu_torch import suite  # noqa: E402
from astrild_tpu_torch.ops import power as TPS  # noqa: E402

N_SIDE, NGRID, NPIX, BOX, NPLANES = 32, 64, 256, 500.0, 64
PORT = pathlib.Path(__file__).resolve().parents[1] / "astrild_tpu_torch"


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


def _jax_stages():
    """bench.py's four stage bodies (bench.py:53-119) at the test size,
    with the JAX deposit kernel in interpret mode."""
    binning = JPS.get_fast_binning(NGRID, 64, 2)

    def matter(pos_flat):
        n = pos_flat.shape[0] // 3
        xyz = (pos_flat[:n], pos_flat[n:2 * n], pos_flat[2 * n:])
        res, grid = JPS.auto_power_fast(xyz, NGRID, BOX, nbins=64,
                                        fine_factor=2,
                                        return_coarse_grid=True,
                                        binning=binning,
                                        deposit="pallas_interpret")
        return grid, res.power

    def bispec(grid):
        return JB.bispectrum_3d(grid, BOX, nbins=4, m_min=2.0,
                                m_max=32.0).b

    def lensing(grid):
        delta = grid / jnp.mean(grid) - 1.0
        slabs = delta.reshape(NGRID // NPLANES, NPLANES, NGRID,
                              NGRID).sum(0)
        chis = jnp.linspace(200.0, 2800.0, NPLANES)
        dchis = jnp.full((NPLANES,), BOX / NPLANES)
        kappa_c = JL.born_convergence(slabs, chis, dchis, 3000.0, 0.3089)
        kappa = jax.image.resize(kappa_c, (NPIX, NPIX), method="linear")
        g1, g2 = JL.kappa_to_gamma(kappa, 0.35, padding_factor=2)
        return kappa, g1, g2

    def voids(kappa):
        cat = JK.find_peaks(kappa, threshold=jnp.std(kappa),
                            max_peaks=2048, edge_pix=8)
        vcat = JV.find_tunnels(cat.pos.astype(jnp.float32),
                               cat.values > -jnp.inf, NPIX, max_voids=256)
        return vcat.radius

    return matter, bispec, lensing, voids


@pytest.fixture(scope="module")
def positions():
    """Flat [x..., y..., z...] float32 positions of N_SIDE^3 particles in
    Gaussian clumps, so P(k) stands well clear of its shot noise."""
    rng = np.random.default_rng(7)
    n = N_SIDE ** 3
    centers = rng.uniform(0, BOX, (64, 3))
    pts = centers[:, None, :] + rng.normal(0, 12.0, (64, n // 64, 3))
    pts = np.mod(pts.reshape(-1, 3), BOX).astype(np.float32)
    return np.concatenate([pts[:, 0], pts[:, 1], pts[:, 2]])


@pytest.fixture(scope="module")
def both(positions):
    run = suite.make_stages(N_SIDE, NGRID, NPIX, BOX, NPLANES, "cpu")
    got = [t.numpy() for t in run(torch.from_numpy(positions.copy()))]
    matter, bispec, lensing, voids = _jax_stages()
    grid, pk = matter(jnp.asarray(positions))
    kappa, g1, g2 = lensing(grid)
    want = [np.asarray(a) for a in (pk, bispec(grid), kappa, g1, g2,
                                    voids(kappa))]
    return run, got, want


def test_suite_matter_stage(both):
    _, got, want = both
    npt.assert_allclose(got[0], want[0], rtol=1e-5)


def test_suite_bispectrum_stage(both):
    """Finite B within rtol 1e-4, identical NaN pattern."""
    _, got, want = both
    npt.assert_array_equal(np.isnan(got[1]), np.isnan(want[1]))
    ok = np.isfinite(want[1])
    assert ok.sum() >= 10
    npt.assert_allclose(got[1][ok], want[1][ok], rtol=1e-4)


def test_suite_lensing_stage(both):
    """kappa within rtol 1e-5 (atol 1e-6 * max where planes cancel);
    gamma within atol 1e-5 * max."""
    _, got, want = both
    npt.assert_allclose(got[2], want[2], rtol=1e-5,
                        atol=1e-6 * np.abs(want[2]).max())
    for g, w in zip(got[3:5], want[3:5]):
        npt.assert_allclose(g, w, atol=1e-5 * np.abs(w).max())


def test_suite_voids_stage(both):
    """Equal void count; radii within rtol 1e-5."""
    _, got, want = both
    assert (got[5] > 0).sum() == (want[5] > 0).sum() > 5
    npt.assert_allclose(got[5], want[5], rtol=1e-5)


def test_suite_timings_and_deposit_choice(both, positions):
    """A pass under the profiler opens each stage span and each matter
    sub-stage span once, in its place; the CPU pass takes the scatter
    deposit."""
    from torch.profiler import ProfilerActivity, profile

    run = both[0]
    assert TPS.last_auto_deposit == "scatter"  # a CPU tensor
    pos = torch.from_numpy(positions.copy())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(pos)
    rows = {e.key: e for e in prof.key_averages()}
    stages = ("matter", "bispectrum", "lensing", "voids")
    parts = ("power.keys", "power.deposit", "power.fft_bin")
    for name in ("suite.pass", *(f"suite.{s}" for s in stages), *parts):
        assert rows[name].count == 1, name
    parent = {e.name: e.cpu_parent.name for e in prof.events()
              if e.name in parts or e.name.startswith("suite.")
              and e.name != "suite.pass"}
    assert parent == {**{f"suite.{s}": "suite.pass" for s in stages},
                      **{p: "suite.matter" for p in parts}}
    assert TPS.last_auto_deposit == "scatter"
    with pytest.raises(ValueError, match="flat positions"):
        run(pos[:-3])


def test_port_imports_no_jax():
    """The port never imports jax or the JAX package, at import or run."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|astrild_tpu)\b",
                         re.MULTILINE)
    for path in PORT.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    code = ("import sys\n"
            "import astrild_tpu_torch.suite as s\n"
            "run = s.make_stages(8, 16, 32, 100.0, 16, 'cpu')\n"
            "run(s.uniform_positions(8, 100.0, 'cpu'))\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'astrild_tpu.')) or m == 'astrild_tpu']\n"
            "assert not bad, bad\n"
            "print('NOJAX')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PORT.parent), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "NOJAX" in out.stdout


def test_port_leaves_float32_matmul_precision_alone():
    # TF32 would break distance-transform and binning cancellations
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "allow_tf32" not in text, path
        assert "set_float32_matmul_precision" not in text, path
    assert torch.get_float32_matmul_precision() == "highest"
