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

# The JAX package's position_dependent_power is jitted and fetches its
# shell binning inside the trace, so the binning lands in the package's
# module-level cache as tracers; a later un-jitted call with the same
# (ngrid, nbins) in that process then fails with UnexpectedTracerError
# (tests/test_multihost.py's auto_power(16 grid, 6 bins) after
# tests/test_spectra.py's position_dependent_power on one xdist worker).
# Every test process collects this file, so filling the entries the suite
# calls position_dependent_power with (here and in tests/test_spectra.py)
# outside any trace keeps them concrete in every process.
for _ngrid, _nbins in ((16, 6), (8, 4), (4, 3)):
    JPS.get_shell_binning(_ngrid, _nbins)


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


def _flat_case(rng, case):
    """(keys in the order a caller gives them, n_cells, the JAX kernel's
    window, which must divide n_cells) of one K1 case."""
    if case == "random":
        n_cells = 4 * 8192
        return rng.integers(0, n_cells, 20000), n_cells, 8192
    if case == "one_cell":  # one window holds every key: a heavy window
        return np.full(60000, 5), 3 * 8192, 8192
    if case == "clustered_29":
        # 29 keys a cell over 2048 cells of one window (the lens planes'
        # density), in no order
        return rng.permutation(np.repeat(np.arange(4000, 6048), 29)), \
            3 * 8192, 8192
    if case == "junk_cell":
        # the lens planes' junk cell n_cells - 1 takes the corners outside
        # the map
        n_cells = 4 * 8192
        return rng.permutation(np.concatenate([
            rng.integers(0, n_cells, 20000), np.full(30000, n_cells - 1)])), \
            n_cells, 8192
    if case == "ragged_last_window":
        # 20480 cells: 2.5 windows of 8192 on the card; the JAX kernel's
        # window must divide n_cells, so it takes 4096
        n_cells = 5 * 4096
        return rng.permutation(np.concatenate([
            rng.integers(0, n_cells, 20000),
            np.repeat(np.arange(n_cells - 200, n_cells), 29)])), n_cells, 4096
    raise ValueError(case)


@pytest.mark.parametrize("case,weighted", [
    pytest.param("random", False, id="False"),
    pytest.param("random", True, id="True"),
    *[pytest.param(c, w, id=f"{c}-{w}")
      for c in ("one_cell", "clustered_29", "junk_cell", "ragged_last_window")
      for w in (False, True)]])
def test_deposit_flat_matches_pallas(rng, case, weighted):
    """Counts exact; weighted sums within 2e-5 * max, the bar the JAX
    package sets for its own kernel. Keys in any order, on the heavy
    windows the card splits over several blocks, the junk cell and a
    ragged last window."""
    flat, n_cells, window = _flat_case(rng, case)
    flat = np.asarray(flat, np.int32)
    n = flat.shape[0]
    w = rng.normal(1, 0.2, n).astype(np.float32) if weighted else None
    want = np.asarray(JPP.deposit_flat(
        jnp.asarray(flat), None if w is None else jnp.asarray(w), n_cells,
        window=window, interpret=True))
    got = TPC.deposit_flat(T(flat), None if w is None else T(w),
                           n_cells).numpy()
    if weighted:
        npt.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    else:
        npt.assert_array_equal(got, want)
        npt.assert_array_equal(got, np.bincount(flat, minlength=n_cells))


@pytest.mark.parametrize("case", ["empty", "one_cell", "last_cell",
                                  "ragged", "sparse", "all_in_one_cell",
                                  "clustered_29", "junk_cell",
                                  "heavy_ragged_last_window"])
def test_deposit_sorted_plain_edge_cases(rng, case):
    """The plain deposit (the CPU path of both wrappers) equals numpy's
    bincount exactly on the kernel's edge cases, the heavy windows (one
    cell, ~29 keys a cell, the junk cell at n_cells - 1, the ragged last
    window holding 29 keys a cell) among them."""
    n_cells = 3 * 8192 + 77
    keys = {
        "empty": np.zeros(0, np.int32),
        "one_cell": np.full(5000, 7, np.int32),
        "last_cell": np.full(33, n_cells - 1, np.int32),
        "ragged": rng.integers(0, n_cells, 12345).astype(np.int32),
        "sparse": rng.integers(0, n_cells, 10).astype(np.int32),
        "all_in_one_cell": np.full(1 << 17, 8191, np.int32),
        "clustered_29": np.repeat(np.arange(8192, 2 * 8192),
                                  29).astype(np.int32),
        "junk_cell": np.concatenate([
            rng.integers(0, n_cells, 20000),
            np.full(50000, n_cells - 1)]).astype(np.int32),
        "heavy_ragged_last_window": np.repeat(
            np.arange(3 * 8192, n_cells), 29 * 64).astype(np.int32),
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
    # deposit_flat takes the keys in any order with their weights
    perm = rng.permutation(keys.shape[0])
    gotf = TPC.deposit_flat(T(keys[perm]), T(w[perm]), n_cells).numpy()
    npt.assert_allclose(gotf, want, rtol=0, atol=atol)
    npt.assert_array_equal(TPC.deposit_flat(T(keys[perm]), None,
                                            n_cells).numpy(),
                           np.bincount(keys, minlength=n_cells))


def test_deposit_sorted_rejects_devices_without_kernel():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TPC.deposit_sorted(keys, None, 8)


# ----------------------------------------------------------------- K4
def _seg_orders(rng, n, n_cells):
    return {
        "random": rng.integers(0, n_cells, n),
        "coherent": np.sort(rng.integers(0, n_cells, n)),
        "clustered": np.full(n, 7, dtype=np.int64),
    }


@pytest.mark.parametrize("order", ["random", "coherent", "clustered"])
@pytest.mark.parametrize("weighted", [False, True])
def test_deposit_flat_segmented_matches_pallas(rng, order, weighted):
    """K4's plain version (the port's CPU path) vs the JAX segmented Pallas
    deposit in interpret mode, as the JAX package tests it: counts exact,
    weighted sums within 2e-5 * max."""
    n_cells, n = 128 * 256, 100000
    keys = _seg_orders(rng, n, n_cells)[order]
    w = rng.normal(1, 0.2, n).astype(np.float32) if weighted else None
    want = np.asarray(JPP.deposit_flat_segmented(
        jnp.asarray(keys, jnp.int32), None if w is None else jnp.asarray(w),
        n_cells, n_seg=8, window=4096, chunk_rows=4, interpret=True))
    got = TPC.deposit_flat_segmented(
        T(keys.astype(np.int32)), None if w is None else T(w), n_cells,
        n_seg=8).numpy()
    if weighted:
        npt.assert_allclose(got, want, rtol=0,
                            atol=2e-5 * np.abs(want).max())
    else:
        npt.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_seg", [(1003, 8), (5, 8), (1000, 1),
                                     (0, 4)])
def test_deposit_flat_segmented_padding(rng, n, n_seg):
    """The sentinel padding: n not a multiple of n_seg, n below n_seg, one
    segment, no keys. Counts equal JAX's and numpy's exactly; the padded
    layout holds every key once, each row sorted, the sentinel at the
    rows' tails."""
    n_cells = 4096 + 77
    keys = rng.integers(0, n_cells, n)
    want = np.bincount(keys, minlength=n_cells)
    got = TPC.deposit_flat_segmented(T(keys.astype(np.int32)), None,
                                     n_cells, n_seg=n_seg).numpy()
    npt.assert_array_equal(got, want)
    if n:
        npt.assert_array_equal(got, np.asarray(JPP.deposit_flat_segmented(
            jnp.asarray(keys, jnp.int32), None, 4096 * 2, n_seg=n_seg,
            window=4096, chunk_rows=1, interpret=True))[:n_cells])
    layout, _ = TPC._segment_layout(T(keys.astype(np.int32)), None, n_cells,
                                    n_seg)
    lay = layout.numpy()
    assert lay.shape == (n_seg, max(1, -(-n // n_seg)))
    assert np.all(np.diff(lay, axis=1) >= 0)
    npt.assert_array_equal(np.sort(lay[lay < n_cells]), np.sort(keys))
    assert np.sum(lay == n_cells) == lay.size - n


def test_deposit_flat_segmented_rules():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_seg"):
        TPC.deposit_flat_segmented(keys, None, 8, n_seg=0)
    with pytest.raises(ValueError, match="weights"):
        TPC.deposit_flat_segmented(keys, torch.ones(3), 8)
    with pytest.raises(ValueError, match="no kernel"):
        TPC.deposit_flat_segmented(keys.to("meta"), None, 8)


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
    for window in ("ngp", "cic", "tsc"):
        with pytest.raises(ValueError, match="CUDA"):
            TP.paint(pos, 8, BOX, window=window, deposit="kernel")
    with pytest.raises(ValueError, match="deposit must be"):
        TP.paint(pos, 8, BOX, window="ngp", deposit="sorted")


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("jax_name,port_name", [("pallas", "kernel")])
def test_paint_accepts_jax_deposit_spellings(rng, window, jax_name,
                                             port_name):
    """`paint(deposit=)` takes the JAX package's spelling as an alias: on
    a CPU tensor both kernel spellings raise the same error (the request
    is explicit, so nothing falls back), and the interpret spelling says
    that the port has no such mode."""
    pos = T(_positions(rng, 100))
    errors = []
    for name in (jax_name, port_name):
        with pytest.raises(ValueError, match="needs a CUDA tensor") as err:
            TP.paint(pos, 8, BOX, window=window, deposit=name)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="no interpret mode"):
        TP.paint(pos, 8, BOX, window=window,
                 deposit=f"{jax_name}_interpret")
    # the spellings that run on the CPU are unchanged
    assert torch.equal(TP.paint(pos, 8, BOX, window=window,
                                deposit="scatter"),
                       TP.paint(pos, 8, BOX, window=window))


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
def test_compensation_kernel_matches_jax(window):
    want = np.asarray(JP.compensation_kernel(16, window))
    got = TP.compensation_kernel(16, window).numpy()
    npt.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- P(k)
@pytest.mark.parametrize("ngrid", [16, 15])
def test_mode_radius_and_hermitian_weights_match_jax(ngrid):
    # against the correctly rounded square roots first, so a mismatch with
    # JAX says which side is off
    f = np.fft.fftfreq(ngrid, 1.0 / ngrid)
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[None, None, :ngrid // 2 + 1] ** 2)
    npt.assert_array_equal(TPS.mode_radius_rfft(ngrid).numpy(),
                           np.sqrt(m2.astype(np.float32)))
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
    for kernel in ("kernel", "kernel_seg"):
        with pytest.raises(ValueError, match="CUDA"):
            TPS.auto_power_fast(pos, 8, BOX, nbins=4, deposit=kernel)
    with pytest.raises(ValueError, match="deposit must be"):
        TPS.auto_power_fast(pos, 8, BOX, nbins=4, deposit="sorted")


@pytest.mark.parametrize("jax_name,port_name", [("pallas", "kernel"),
                                                ("pallas_seg", "kernel_seg")])
def test_auto_power_fast_accepts_jax_deposit_spellings(rng, jax_name,
                                                       port_name):
    """`auto_power_fast(deposit=)` takes the JAX package's spellings as
    aliases of the port's: on a CPU tensor each pair raises the same
    error, the interpret spellings say that the port has no such mode, and
    an explicit request leaves `last_auto_deposit` alone."""
    pos = T(rng.uniform(0, BOX, (1000, 3)).astype(np.float32))
    TPS.last_auto_deposit = None
    errors = []
    for name in (jax_name, port_name):
        with pytest.raises(ValueError, match="needs a CUDA tensor") as err:
            TPS.auto_power_fast(pos, 8, BOX, nbins=4, deposit=name)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="no interpret mode"):
        TPS.auto_power_fast(pos, 8, BOX, nbins=4,
                            deposit=f"{jax_name}_interpret")
    assert TPS.last_auto_deposit is None
    want = TPS.auto_power_fast(pos, 8, BOX, nbins=4)
    got = TPS.auto_power_fast(pos, 8, BOX, nbins=4, deposit="scatter")
    assert torch.equal(got.power, want.power)
    assert TPS.last_auto_deposit == "scatter"


def test_auto_power_fast_matches_pallas_seg(rng):
    """The port's scatter P(k) vs the JAX segmented deposit
    ('pallas_seg_interpret'): rtol 1e-5, the JAX package's own bar
    against its scatter. The particles are clustered, so P(k) stands well
    clear of the shot noise it has subtracted."""
    pos = _clustered(rng, 60, 500)
    want = JPS.auto_power_fast(jnp.asarray(pos), 16, BOX, nbins=6,
                               deposit="pallas_seg_interpret")
    got = TPS.auto_power_fast(T(pos), 16, BOX, nbins=6, deposit="scatter")
    npt.assert_allclose(got.power.numpy(), np.asarray(want.power),
                        rtol=1e-5)
    npt.assert_array_equal(got.nmodes.numpy(), np.asarray(want.nmodes))


@pytest.mark.parametrize("ngrid", [16, 15])
def test_kmag_rfft_matches_jax(ngrid):
    npt.assert_allclose(TPS.kmag_rfft(ngrid, BOX).numpy(),
                        np.asarray(JPS.kmag_rfft(ngrid, BOX)), rtol=1e-6)


def _tsc_grids(rng, n=5000, ngrid=16):
    pos = _positions(rng, n)
    g = np.asarray(JP.paint(jnp.asarray(pos), ngrid, BOX, window="tsc"))
    g2 = np.asarray(JP.paint(jnp.asarray((pos + 0.5 * BOX / ngrid) % BOX),
                             ngrid, BOX, window="tsc"))
    return g, g2


@pytest.mark.parametrize("window,interlaced", [(None, False),
                                               ("tsc", True)])
def test_delta_k_parts_matches_jax(rng, window, interlaced):
    """float32 FFTs in both packages: atol 1e-5 of the largest mode. The
    k = 0 mode is the mean of delta, zero up to the float32 rounding of a
    mean of values near 1 in either package: atol 1e-5 there."""
    g, g2 = _tsc_grids(rng)
    want = JPS.delta_k_parts(jnp.asarray(g), jnp.asarray(g2), window=window,
                             interlaced=interlaced)
    got = TPS.delta_k_parts(T(g), T(g2), window=window,
                            interlaced=interlaced)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.array(b)
        assert a.dtype == np.float32
        assert abs(a[0, 0, 0] - b[0, 0, 0]) <= 1e-5
        a[0, 0, 0] = b[0, 0, 0] = 0.0
        npt.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("window,interlaced", [(None, False), ("cic", False),
                                               ("tsc", True)])
def test_cross_power_matches_jax(rng, window, interlaced):
    g, g2 = _tsc_grids(rng)
    h, h2 = _tsc_grids(np.random.default_rng(3))
    # a correlated second field: half of g, half of an independent one
    f, f2 = 0.5 * (g + h), 0.5 * (g2 + h2)
    want = JPS.cross_power(jnp.asarray(g), jnp.asarray(f), BOX, nbins=8,
                           window=window,
                           grids_shifted=(jnp.asarray(g2), jnp.asarray(f2)),
                           interlaced=interlaced)
    got = TPS.cross_power(T(g), T(f), BOX, nbins=8, window=window,
                          grids_shifted=(T(g2), T(f2)),
                          interlaced=interlaced)
    npt.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=1e-5)
    npt.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-6)
    npt.assert_array_equal(got.nmodes.numpy(), np.asarray(want.nmodes))


@pytest.mark.parametrize("los", [0, 2])
@pytest.mark.parametrize("ells", [(0, 2, 4), (2,)])
def test_auto_power_multipoles_matches_jax(rng, los, ells):
    """Monopole rtol 1e-5; the quadrupole and hexadecapole are sums of
    terms of both signs, so they also get an atol of 1e-5 of the
    monopole's largest bin."""
    pos = _clustered(rng, 40, 300)
    g = np.asarray(JP.paint(jnp.asarray(pos), 16, BOX, window="cic"))
    want = JPS.auto_power_multipoles(jnp.asarray(g), BOX, nbins=8, ells=ells,
                                     los=los, window="cic", shotnoise=3.0)
    got = TPS.auto_power_multipoles(T(g), BOX, nbins=8, ells=ells, los=los,
                                    window="cic", shotnoise=3.0)
    w = np.asarray(want.p_ell)
    mono = np.asarray(JPS.auto_power(jnp.asarray(g), BOX, nbins=8,
                                     window="cic").power)
    assert got.p_ell.shape == w.shape
    npt.assert_allclose(got.p_ell.numpy(), w, rtol=1e-5,
                        atol=1e-5 * np.abs(mono).max())
    npt.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-6)
    npt.assert_array_equal(got.nmodes.numpy(), np.asarray(want.nmodes))


def test_auto_power_multipoles_rejects_odd_ell():
    with pytest.raises(ValueError, match="even"):
        TPS.auto_power_multipoles(torch.ones(8, 8, 8), BOX, ells=(1,))


@pytest.mark.parametrize("n_sub,nbins", [(2, 4), (4, 3)])
def test_position_dependent_power_matches_jax(rng, n_sub, nbins):
    """k, iB, the response, the mean P and delta_b against JAX: float32
    FFTs, rtol 1e-5 (iB, a mean of terms of both signs, with an atol of
    1e-5 of |P_mean| * std(delta_b))."""
    pos = _clustered(rng, 30, 400)
    g = np.asarray(JP.paint(jnp.asarray(pos), 16, BOX, window="cic"))
    delta = g / g.mean() - 1.0
    want = [np.asarray(a) for a in JPS.position_dependent_power(
        jnp.asarray(delta), BOX, n_sub=n_sub, nbins=nbins)]
    got = [a.numpy() for a in TPS.position_dependent_power(
        T(delta), BOX, n_sub=n_sub, nbins=nbins)]
    k, ib, resp, p_mean, delta_b = got
    npt.assert_allclose(k, want[0], rtol=1e-6)
    npt.assert_allclose(p_mean, want[3], rtol=1e-5)
    npt.assert_allclose(delta_b, want[4], rtol=1e-5, atol=1e-6)
    ib_atol = 1e-5 * np.abs(want[3]).max() * np.std(want[4])
    npt.assert_allclose(ib, want[1], rtol=1e-5, atol=ib_atol)
    finite = np.isfinite(want[2])
    npt.assert_array_equal(np.isfinite(resp), finite)
    npt.assert_allclose(resp[finite], want[2][finite], rtol=1e-4)


def test_position_dependent_power_rejects_uneven_split():
    with pytest.raises(ValueError, match="n_sub"):
        TPS.position_dependent_power(torch.zeros(10, 10, 10), BOX, n_sub=4)


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
