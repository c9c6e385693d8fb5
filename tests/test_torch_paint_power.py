"""PyTorch port vs JAX package on the CPU: the sorted deposit (K1), the
painters and the P(k) estimators.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas deposit as its own tests do (interpret mode on the
CPU); the port's side runs the plain deposit, which its wrappers use for CPU
tensors. Each tolerance is stated where it is checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import paint as JP  # noqa: E402
from astrild_tpu.ops import paint_pallas as JPP  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu_torch.ops import paint as TP  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda as TPC  # noqa: E402
from astrild_tpu_torch.ops import power as TPS  # noqa: E402
from astrild_tpu_torch.utils.tables import tables_from_numpy  # noqa: E402

BOX = 100.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a))


def _positions(rng, n, box=BOX):
    """(n, 3) float32 positions in the box, with a few on and past the
    periodic edges."""
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[0] = [0.0, box - 1e-4, box]
    pos[1] = [-1e-3, -box / 3, box * 1.5]
    return pos


def _clustered(rng, n_halo, per_halo, box=BOX):
    """(n_halo * per_halo, 3) float32 positions in Gaussian clumps."""
    centers = rng.uniform(0, box, (n_halo, 3))
    pts = centers[:, None, :] + rng.normal(0, 2.0, (n_halo, per_halo, 3))
    return np.mod(pts.reshape(-1, 3), box).astype(np.float32)


# ----------------------------------------------------------------- K1
@pytest.mark.parametrize("ff", [2, 3])
def test_fast_keys_exact(rng, ff):
    pos = _positions(rng, 5000)
    xyz = [pos[:, i] for i in range(3)]
    want = np.asarray(JPS._fast_keys(tuple(jnp.asarray(c) for c in xyz), BOX,
                                     ngrid=16, fine_factor=ff))
    got = TPS._fast_keys(tuple(T(c) for c in xyz), BOX, ngrid=16,
                         fine_factor=ff)
    assert got.dtype == torch.int32
    npt.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_deposit_flat_matches_pallas(rng, weighted):
    """Counts exact; weighted sums within 2e-5 * max, the bar the JAX
    package sets for its own kernel."""
    n_cells = 4 * 8192
    flat = rng.integers(0, n_cells, 20000).astype(np.int32)
    w = rng.normal(1, 0.2, 20000).astype(np.float32) if weighted else None
    want = np.asarray(JPP.deposit_flat(
        jnp.asarray(flat), None if w is None else jnp.asarray(w), n_cells,
        window=8192, interpret=True))
    got = TPC.deposit_flat(T(flat), None if w is None else T(w),
                           n_cells).numpy()
    if weighted:
        npt.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    else:
        npt.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["empty", "one_cell", "last_cell",
                                  "ragged", "sparse"])
def test_deposit_sorted_plain_edge_cases(rng, case):
    """The plain deposit (the CPU path of both wrappers) equals numpy's
    bincount exactly on the kernel's edge cases."""
    n_cells = 3 * 8192 + 77
    keys = {
        "empty": np.zeros(0, np.int32),
        "one_cell": np.full(5000, 7, np.int32),
        "last_cell": np.full(33, n_cells - 1, np.int32),
        "ragged": rng.integers(0, n_cells, 12345).astype(np.int32),
        "sparse": rng.integers(0, n_cells, 10).astype(np.int32),
    }[case]
    keys = np.sort(keys)
    w = rng.uniform(0.5, 2.0, keys.shape[0]).astype(np.float32)
    got = TPC.deposit_sorted(T(keys), None, n_cells).numpy()
    npt.assert_array_equal(got, np.bincount(keys, minlength=n_cells))
    # weighted: float32 sums in another order, within the K1 bar
    # 2e-5 * max
    want = np.bincount(keys, weights=w, minlength=n_cells)
    atol = 2e-5 * max(np.abs(want).max(initial=0.0), 1.0)
    gotw = TPC.deposit_sorted(T(keys), T(w), n_cells).numpy()
    npt.assert_allclose(gotw, want, rtol=0, atol=atol)
    # deposit_flat sorts first and carries each weight with its key
    perm = rng.permutation(keys.shape[0])
    gotf = TPC.deposit_flat(T(keys[perm]), T(w[perm]), n_cells).numpy()
    npt.assert_allclose(gotf, want, rtol=0, atol=atol)


def test_deposit_sorted_rejects_devices_without_kernel():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TPC.deposit_sorted(keys, None, 8)


# ------------------------------------------------------------ painters
@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_paint_matches_jax(rng, window, weighted):
    """Scatter order differs between the packages: atol 1e-6 * max."""
    pos = _positions(rng, 3000)
    w = rng.uniform(0.5, 2.0, 3000).astype(np.float32) if weighted else None
    want = np.asarray(JP.paint(jnp.asarray(pos), 16, BOX,
                               weights=None if w is None else jnp.asarray(w),
                               window=window, deposit="scatter"))
    got = TP.paint(T(pos), 16, BOX, weights=None if w is None else T(w),
                   window=window).numpy()
    npt.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


def test_paint_interlaced_tuple_input_matches_jax(rng):
    pos = _positions(rng, 2000)
    a, a2 = JP.paint(tuple(jnp.asarray(pos[:, i]) for i in range(3)), 16,
                     BOX, window="tsc", interlaced=True, deposit="scatter")
    b, b2 = TP.paint(tuple(T(pos[:, i]) for i in range(3)), 16, BOX,
                     window="tsc", interlaced=True)
    for want, got in ((a, b), (a2, b2)):
        want = np.asarray(want)
        npt.assert_allclose(got.numpy(), want,
                            atol=1e-6 * np.abs(want).max())


def test_paint_kernel_deposit_rules(rng):
    pos = T(_positions(rng, 100))
    with pytest.raises(NotImplementedError, match="K2"):
        TP.paint(pos, 8, BOX, window="cic", deposit="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        TP.paint(pos, 8, BOX, window="ngp", deposit="kernel")
    with pytest.raises(ValueError, match="deposit"):
        TP.paint(pos, 8, BOX, window="ngp", deposit="pallas")


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
def test_compensation_kernel_matches_jax(window):
    want = np.asarray(JP.compensation_kernel(16, window))
    got = TP.compensation_kernel(16, window).numpy()
    npt.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- P(k)
@pytest.mark.parametrize("ngrid", [16, 15])
def test_mode_radius_and_hermitian_weights_match_jax(ngrid):
    npt.assert_array_equal(TPS.mode_radius_rfft(ngrid).numpy(),
                           np.asarray(JPS.mode_radius_rfft(ngrid)))
    npt.assert_array_equal(TPS.hermitian_weights(ngrid).numpy(),
                           np.asarray(JPS.hermitian_weights(ngrid)))


@pytest.mark.parametrize("host", ["_shell_binning_host", "_fast_binning_host"])
@pytest.mark.parametrize("cfg", [(16, 8, None, None), (32, 12, 1.0, 12.0),
                                 (15, 7, None, None)])
def test_host_binning_bit_identical(host, cfg):
    """The port's copy of the numpy binning builders reproduces the JAX
    package's tables bit for bit (dtypes included)."""
    ngrid, nbins, kmin, kmax = cfg
    if host == "_shell_binning_host":
        want = JPS.get_shell_binning(ngrid, nbins, kmin, kmax)
        mmin = 0.5 if kmin is None else kmin
        mmax = ngrid / 2.0 if kmax is None else kmax
        got = TPS._shell_binning_host(ngrid, nbins, mmin, mmax)
    else:
        want = JPS.get_fast_binning(ngrid, nbins, 2, kmin, kmax)
        got = TPS._fast_binning_host(ngrid, nbins, 2, kmin, kmax)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        npt.assert_array_equal(g, w)


def test_fast_binning_tensors_from_jax_tables():
    """tables_from_numpy of the JAX package's binning equals the port's
    own device binning exactly (int64 bin index, float32 rest)."""
    want = tables_from_numpy([np.asarray(a) for a in
                              JPS.get_fast_binning(16, 8, 2)])
    got = TPS.get_fast_binning(16, 8, 2)
    assert [t.dtype for t in got] == [torch.int64] + [torch.float32] * 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_tables_from_numpy_casts_float64():
    # torch.from_numpy alone would keep float64 where JAX computes in f32
    a, i = tables_from_numpy([np.arange(3, dtype=np.float64),
                              np.arange(3, dtype=np.int32)])
    assert a.dtype == torch.float32 and i.dtype == torch.int64


def test_shell_reduce_matches_jax(rng):
    ngrid, nbins = 16, 8
    binning = JPS.get_shell_binning(ngrid, nbins)
    vals = rng.uniform(0, 1e3, ngrid * ngrid * (ngrid // 2 + 1)).astype(
        np.float32)
    want = np.asarray(JPS._shell_reduce(jnp.asarray(vals), *binning[:3]))
    got = TPS._shell_reduce(T(vals), *TPS.get_shell_binning(ngrid,
                                                            nbins)[:3])
    npt.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("window,interlaced", [(None, False), ("cic", False),
                                               ("tsc", True)])
def test_auto_power_matches_jax(rng, window, interlaced):
    pos = _positions(rng, 5000)
    g = np.asarray(JP.paint(jnp.asarray(pos), 16, BOX, window="tsc"))
    g2 = np.asarray(JP.paint(jnp.asarray((pos + 0.5 * BOX / 16) % BOX), 16,
                             BOX, window="tsc"))
    want = JPS.auto_power(jnp.asarray(g), BOX, nbins=8, window=window,
                          grid_shifted=jnp.asarray(g2) if interlaced
                          else None, interlaced=interlaced, shotnoise=8.0)
    got = TPS.auto_power(T(g), BOX, nbins=8, window=window,
                         grid_shifted=T(g2) if interlaced else None,
                         interlaced=interlaced, shotnoise=8.0)
    npt.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=1e-5)
    npt.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-6)
    npt.assert_array_equal(got.nmodes.numpy(), np.asarray(want.nmodes))


@pytest.mark.parametrize("weighted,rtol", [(False, 1e-5), (True, 1e-4)])
def test_auto_power_fast_matches_jax(rng, weighted, rtol):
    """The port's scatter path vs the JAX Pallas deposit (interpret mode):
    rtol 1e-5 unweighted, 1e-4 weighted (the JAX package's own bars for
    its kernel against its scatter). The particles are clustered, so P(k)
    stands well clear of the shot noise it has subtracted."""
    pos = _clustered(rng, 60, 500)
    w = (rng.uniform(0.5, 2.0, pos.shape[0]).astype(np.float32)
         if weighted else None)
    want, wgrid = JPS.auto_power_fast(
        jnp.asarray(pos), 16, BOX, nbins=6,
        weights=None if w is None else jnp.asarray(w),
        return_coarse_grid=True, deposit="pallas_interpret")
    got, ggrid = TPS.auto_power_fast(
        T(pos), 16, BOX, nbins=6, weights=None if w is None else T(w),
        return_coarse_grid=True, deposit="scatter")
    npt.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=rtol)
    npt.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-6)
    npt.assert_array_equal(got.nmodes.numpy(), np.asarray(want.nmodes))
    npt.assert_allclose(ggrid.numpy(), np.asarray(wgrid),
                        atol=2e-5 * np.abs(np.asarray(wgrid)).max())


def test_auto_power_fast_deposit_selection(rng):
    pos = T(rng.uniform(0, BOX, (1000, 3)).astype(np.float32))
    TPS.last_auto_deposit = None
    TPS.auto_power_fast(pos, 8, BOX, nbins=4)
    assert TPS.last_auto_deposit == "scatter"  # CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        TPS.auto_power_fast(pos, 8, BOX, nbins=4, deposit="kernel")
    with pytest.raises(ValueError, match="deposit"):
        TPS.auto_power_fast(pos, 8, BOX, nbins=4, deposit="pallas")


# ------------------------------------------- analytic anchors (port only)
def test_fast_power_matches_tsc(rng):
    """auto_power_fast (fine NGP + deconvolution) agrees with the TSC
    estimator on clustered data over the reported k-range (5%)."""
    box = BOX
    pos = T(_clustered(rng, 50, 400))
    n_part = pos.shape[0]
    g = TP.paint(pos, 32, box, window="tsc")
    ref = TPS.auto_power(g, box, nbins=12, window="tsc",
                         shotnoise=box ** 3 / n_part)
    fast = TPS.auto_power_fast(pos, 32, box, nbins=12, fine_factor=2)
    npt.assert_allclose(fast.power.numpy()[:8], ref.power.numpy()[:8],
                        rtol=0.05)


def test_single_mode_power():
    # grid = 1 + A cos(kf x): the two +-kf modes carry |delta_k|^2 = A^2/4
    # each, so the weighted power in the first bin is A^2 V / 2
    A, ng = 0.1, 16
    x = (torch.arange(ng, dtype=torch.float32) + 0.5) * BOX / ng
    grid = (1.0 + A * torch.cos(2 * np.pi * x / BOX))[:, None, None] \
        * torch.ones((ng, ng, ng))
    res = TPS.auto_power(grid, BOX, nbins=ng // 2)
    kf = 2 * np.pi / BOX
    npt.assert_allclose(float(res.power[0] * res.nmodes[0]),
                        A ** 2 * BOX ** 3 / 2.0, rtol=1e-4)
    npt.assert_allclose(res.power[1:].numpy(), 0.0, atol=1e-6 * BOX ** 3)
    assert float(res.k[0]) < 2 * kf


def test_poisson_shot_noise(rng):
    n_part = 40000
    pos = T(rng.uniform(0, BOX, (n_part, 3)).astype(np.float32))
    g = TP.paint(pos, 16, BOX, window="cic")
    res = TPS.auto_power(g, BOX, nbins=6, window="cic")
    pk = res.power.numpy()
    # Poisson: P(k) ~ V/N up to sampling scatter; the Nyquist bin is
    # inflated by compensated CIC aliasing
    npt.assert_allclose(pk[:-1], BOX ** 3 / n_part, rtol=0.25)
    assert np.all(np.isfinite(pk))


def test_fast_power_weighted_shotnoise(rng):
    """auto_power_fast subtracts V*sum(w^2)/(sum w)^2: for weighted Poisson
    tracers the residual vanishes like the unweighted case."""
    n = 200000
    pos = T(rng.uniform(0, BOX, (n, 3)).astype(np.float32))
    w = T(rng.uniform(0.5, 2.0, n).astype(np.float32))
    res = TPS.auto_power_fast(pos, 32, BOX, nbins=12, weights=w)
    shot_w = BOX ** 3 * float((w * w).sum()) / float(w.sum()) ** 2
    resid = res.power.numpy()[2:10] / shot_w
    assert np.abs(np.mean(resid)) < 0.05, resid
    resu = TPS.auto_power_fast(pos, 32, BOX, nbins=12)
    residu = resu.power.numpy()[2:10] / (BOX ** 3 / n)
    assert np.abs(np.mean(residu)) < 0.05, residu
