"""PyTorch port vs JAX package on the CPU: the statistics toolbox
(astrild_tpu_torch/utils/analysis.py, every function), the lognormal map
(`ops/mocks.lognormal_map_from_white` with the JAX package's draws, and
`lognormal_map` from a generator) and `models/siminfo`.

The numpy functions are copies of the JAX package's: equal bit for bit.
The torch ones: the bootstrap from the JAX package's index draws within
1e-6 of the band's scale (float32 means in another summation order); the
fits, PCA and covariance, which the port solves in float64 and the JAX
package in float32, within 1e-5 relative (PCA components up to their
sign); the Levenberg-Marquardt fit within 1e-5; the lognormal map within
1e-5 of its max; the snapshot table within 1e-5 (the JAX tables are
float32).
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.models import siminfo as JSI  # noqa: E402
from astrild_tpu.ops import mocks as JM  # noqa: E402
from astrild_tpu.utils import analysis as JAN  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.models import siminfo as TSI  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.utils import analysis as TAN  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology as TC  # noqa: E402


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


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ------------------------------------------------------- numpy functions
def test_numpy_functions_bit_for_bit():
    """distribution_percentile, general_least_squares (weighted too),
    correlation_matrix, pdf_1d, cumulative, contour_value,
    direction_correlation and point_density_2d: equal outputs."""
    rng = np.random.default_rng(11)
    x = np.linspace(-2, 2, 80)
    y = 1.5 - 0.7 * x + 0.3 * x ** 2 + rng.normal(0, 0.01, x.size)
    w = rng.uniform(0.5, 2.0, x.size)
    z = rng.normal(size=400)
    data = np.stack([z + rng.normal(0, 0.1, 400), rng.normal(size=400)], -1)
    vals = rng.lognormal(size=2000)
    dens = rng.uniform(0, 1, (32, 32)) ** 3
    cases = [
        ("distribution_percentile", (x, np.abs(y)), {"qs": (10, 50, 90)}),
        ("general_least_squares", ([np.ones_like(x), x, x ** 2], y), {}),
        ("general_least_squares", ([np.ones_like(x), x], y),
         {"weights": w}),
        ("correlation_matrix", (data,), {"n_boot": 20, "seed": 3}),
        ("correlation_matrix", (data[:3],), {}),
        ("pdf_1d", (vals, 20), {}),
        ("pdf_1d", (vals, 16), {"vrange": (0.0, 5.0), "density": False}),
        ("cumulative", (vals, 20), {}),
        ("cumulative", (vals, 20), {"reverse": False}),
        ("contour_value", (dens, [0.5, 0.9, 0.99]), {}),
        ("direction_correlation", (rng.uniform(-1, 1, 300),),
         {"nbins": 8, "n_random": 50, "seed": 2}),
        ("point_density_2d", (vals, vals[::-1]), {"nbins": (6, 5)}),
        ("point_density_2d", (vals, vals[::-1]),
         {"nbins": (6, 5), "log_bins": True}),
    ]
    for name, args, kw in cases:
        got, want = getattr(TAN, name)(*args, **kw), getattr(JAN, name)(
            *args, **kw)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for g, v in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(v)), name
    for mod in (TAN, JAN):
        with pytest.raises(ValueError):
            mod.correlation_matrix(z)
        with pytest.raises(ValueError, match="non-negative"):
            mod.contour_value(-dens, [0.5])
        with pytest.raises(ValueError, match="log bins"):
            mod.point_density_2d(x, x, log_bins=True)


# ------------------------------------------------------------ bootstrap
def _jax_boot_idx(key, n_boot, n):
    return np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (n,), 0, n))(jax.random.split(key, n_boot)))


@pytest.mark.parametrize("statistic", ["mean", "median"])
@pytest.mark.parametrize("shape", [(301,), (200, 3)])
def test_bootstrap_from_draws_matches_jax(statistic, shape):
    """The JAX package's index draws: the (lo, 50, hi) band within 1e-6
    of its scale (median: equal, sorts pick the same values)."""
    rng = np.random.default_rng(5)
    vals = rng.normal(5.0, 1.0, shape).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = JAN.bootstrap_statistic(jnp.asarray(vals), key, n_boot=250,
                                   statistic=statistic, lo=10.0, hi=90.0)
    idx = _jax_boot_idx(key, 250, shape[0])
    got = TAN.bootstrap_statistic_from_draws(vals, idx, statistic, lo=10.0,
                                             hi=90.0, device="cpu")
    for g, w in zip(got, want):
        assert _rel(g, w) < (1e-6 if statistic == "mean" else 1e-7)


def test_bootstrap_chunks_keep_the_numbers(monkeypatch):
    """Chunking over resamples leaves every number unchanged, from given
    draws and from a generator (whose draw order is chunk by chunk)."""
    rng = np.random.default_rng(6)
    vals = torch.from_numpy(rng.normal(size=(500, 2)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 500, (64, 500)))
    whole = TAN.bootstrap_statistic_from_draws(vals, idx, "median")
    monkeypatch.setattr(TAN, "_BOOT_CHUNK_ENTRIES", 3 * 500 * 2)
    parts = TAN.bootstrap_statistic_from_draws(vals, idx, "median")
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
    gen = TAN.bootstrap_statistic(vals, torch.Generator().manual_seed(1),
                                  n_boot=64)
    drawn = torch.cat([torch.randint(0, 500, (3, 500), generator=g)
                       for g in [torch.Generator().manual_seed(1)]
                       for _ in range(22)])[:64]
    want = TAN.bootstrap_statistic_from_draws(vals, drawn, "mean")
    assert all(torch.equal(a, b) for a, b in zip(gen, want))


def test_bootstrap_statistic_brackets():
    """tests/test_aux_components.py's check through a generator."""
    vals = np.random.default_rng(42).normal(5.0, 1.0, (200, 3)).astype(
        np.float32)
    lo, med, hi = TAN.bootstrap_statistic(vals,
                                          torch.Generator().manual_seed(0),
                                          n_boot=200)
    assert torch.all(lo < 5.2) and torch.all(hi > 4.8)
    assert torch.all(lo <= med) and torch.all(med <= hi)


def test_percentiles_match_jax():
    vals = np.random.default_rng(8).normal(size=(97, 4)).astype(np.float32)
    for axis in (0, 1):
        want = JAN.percentiles(vals, (5, 16, 50, 84, 100), axis=axis)
        got = TAN.percentiles(vals, (5, 16, 50, 84, 100), axis=axis,
                              device="cpu")
        assert _rel(got, want) < 1e-6


# ----------------------------------------------------------------- fits
def test_fits_pca_covariance_match_jax():
    """least_squares_fit (weighted and not), pca (components up to sign,
    variances, mean), covariance_from_realizations (both forms) within
    1e-5 of the JAX package's, float32 out."""
    rng = np.random.default_rng(9)
    x = np.linspace(0, 10, 50).astype(np.float32)
    y = (2.0 * x + 1.0 + 0.05 * x ** 2 + rng.normal(0, 0.1, 50)).astype(
        np.float32)
    w = rng.uniform(0.5, 1.5, 50).astype(np.float32)
    for deg, wt in ((1, None), (2, w)):
        got = TAN.least_squares_fit(x, y, degree=deg, weights=wt,
                                    device="cpu")
        assert got.dtype == torch.float32
        assert _rel(got, JAN.least_squares_fit(x, y, deg, wt)) < 1e-5
    d = (rng.normal(size=(500, 1)) * np.array([[3.0, 1.0, 0.5]])
         + rng.normal(size=(500, 3)) * 0.1).astype(np.float32)
    for nc in (None, 2):
        vt, var, mean = TAN.pca(d, nc, device="cpu")
        jvt, jvar, jmean = JAN.pca(d, nc)
        assert _rel(var, jvar) < 1e-5 and _rel(mean, jmean) < 1e-6
        # the first component is determined to its sign
        assert _rel(vt[0].abs(), np.abs(np.asarray(jvt[0]))) < 1e-5
    samples = rng.normal(size=(40, 6)).astype(np.float32)
    for corr in (False, True):
        got = TAN.covariance_from_realizations(samples, correlation=corr,
                                               device="cpu")
        assert got.dtype == torch.float32
        assert _rel(got, JAN.covariance_from_realizations(
            samples, correlation=corr)) < 1e-5


def _nfw(r, p):
    """A log-NFW surface profile log(rho_s / ((r/rs)(1 + r/rs)^2))."""
    lib = torch if isinstance(p, torch.Tensor) else jnp
    x = r / p[1]
    return lib.log(p[0]) - lib.log(x) - 2.0 * lib.log(1.0 + x)


def test_nonlinear_least_squares_matches_jax():
    """An NFW fit (rho_s, r_s) from a poor start: both converge, to
    parameters within 1e-5 of each other and of the truth within 1e-3."""
    r = np.geomspace(0.05, 3.0, 40).astype(np.float32)
    truth = np.array([2.5, 0.4])
    y = np.log(truth[0]) - np.log(r / truth[1]) - 2 * np.log(1 + r / truth[1])
    want = JAN.nonlinear_least_squares(_nfw, r, y, [1.0, 1.0])
    got = TAN.nonlinear_least_squares(_nfw, r, y, [1.0, 1.0], device="cpu")
    assert got[2] and want[2]
    npt.assert_allclose(got[0], want[0], rtol=1e-5)
    npt.assert_allclose(got[0], truth, rtol=1e-3)
    assert got[1] < 1e-8


def test_analysis_numpy_input_placement():
    """Numpy input goes to `device`, by default the CUDA card (raising
    without one); tensors keep their device."""
    v = np.ones((10, 2), np.float32)
    if not torch.cuda.is_available():
        for call in (lambda: TAN.pca(v), lambda: TAN.percentiles(v),
                     lambda: TAN.covariance_from_realizations(v)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert TAN.percentiles(torch.from_numpy(v)).device.type == "cpu"


# ------------------------------------------------------------ lognormal
@pytest.mark.parametrize("npix", [64, 128])
def test_lognormal_map_from_white_matches_jax(npix):
    """test_mocks.py's table: the JAX package's two draws of PRNGKey(3)
    give the same map within 1e-5 of its max; min >= -1 - 1e-5, |mean| <
    0.2."""
    ells = np.geomspace(30.0, 20000.0, 256).astype(np.float32)
    cl = (1e-6 * (ells / 1000.0) ** -2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JM.lognormal_map(key, npix, 10.0, jnp.asarray(ells),
                                       jnp.asarray(cl)))
    k1, k2 = jax.random.split(key)
    re = np.array(jax.random.normal(k1, (npix, npix)))
    im = np.array(jax.random.normal(k2, (npix, npix)))
    got = TM.lognormal_map_from_white(re, im, npix, 10.0, ells, cl,
                                      device="cpu")
    assert got.dtype == torch.float32 and _rel(got, want) < 1e-5
    assert float(got.min()) >= -1.0 - 1e-5 and abs(float(got.mean())) < 0.2


def test_lognormal_map_from_a_generator():
    ells = np.geomspace(30.0, 20000.0, 256)
    cl = 1e-6 * (ells / 1000.0) ** -2
    m = TM.lognormal_map(torch.Generator().manual_seed(3), 128, 10.0, ells,
                         cl)
    again = TM.lognormal_map(torch.Generator().manual_seed(3), 128, 10.0,
                             ells, cl)
    assert torch.equal(m, again) and m.shape == (128, 128)
    assert float(m.min()) >= -1.0 - 1e-5 and abs(float(m.mean())) < 0.2


# -------------------------------------------------------------- siminfo
@pytest.mark.parametrize("kw", [{}, {"fR0": 1e-5, "mu0": 1.0 / 3.0},
                                {"w0": -0.9, "wa": 0.2, "Om0": 0.28}])
def test_snapshot_info_table_matches_jax(kw):
    boxes = {1: [1.0, 0.5, 0.0], 2: [2.0, 1.0], 3: [10.0]}
    want = JSI.snapshot_info_table(boxes, JC(**kw))
    got = TSI.snapshot_info_table(boxes, TC(**kw))
    assert list(got) == list(want)
    for name in ("_index_0", "_index_1", "redshift", "a"):
        assert np.array_equal(got[name], want[name]), name
    for name in ("Hz", "lookback_time", "Dc"):
        npt.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-4,
                            err_msg=name)


def test_write_snapshot_info_round_trip(tmp_path):
    pytest.importorskip("h5py")
    from astrild_tpu_torch.io import columnar_h5

    path = TSI.write_snapshot_info(str(tmp_path / "info.h5"),
                                   {1: [1.0, 0.0]}, TC(fR0=1e-5))
    back = columnar_h5.read_table(path)
    want = TSI.snapshot_info_table({1: [1.0, 0.0]}, TC(fR0=1e-5))
    for name, col in want.items():
        assert np.array_equal(back[name], col), name
