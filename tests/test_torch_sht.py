"""PyTorch port vs JAX package on the CPU: the table path of the spherical
harmonic transforms and the full-sky MASTER estimator
(astrild_tpu_torch/ops/sht.py against astrild_tpu/ops/sht.py), mirroring
tests/test_sht.py's table tests.

The host builders (`ring_geometry`, `legendre_table`,
`coupling_matrix_from_mask_cl`, `_bin_operator`, `_binned_shape_ops`) are
equal bit for bit. The transforms are float32 on both sides, their sums in
another order (the JAX package's einsums against the port's chunked
elementwise sums): maps and alms agree within 1e-6 of their max (measured
up to 2.6e-7 for synthesis and 7.4e-7 for analysis at nside 16, lmax 63).
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu.utils import healpix as JH  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402

NSIDE, LMAX = 16, 24
TOL = 1e-6


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


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=tol * np.abs(want).max())


def _alm(fill, lmax=LMAX):
    a = np.zeros((lmax + 1, lmax + 1), np.float32)
    for (l, m), v in fill.items():
        a[l, m] = v
    return a


def _random_alms(seed, lmax=LMAX):
    rng = np.random.default_rng(seed)
    valid = np.tril(np.ones((lmax + 1, lmax + 1), np.float32))
    a_re = (rng.standard_normal((lmax + 1,) * 2) * valid).astype(np.float32)
    a_im = (rng.standard_normal((lmax + 1,) * 2) * valid).astype(np.float32)
    a_im[:, 0] = 0.0
    return a_re, a_im


def _map(seed, nside=NSIDE):
    return np.random.default_rng(seed).standard_normal(
        12 * nside * nside).astype(np.float32)


# ------------------------------------------------------------ host builders
@pytest.mark.parametrize("nside", [1, 2, 8, 16])
def test_ring_geometry_bit_for_bit(nside):
    got, want = TS.ring_geometry(nside), JS.ring_geometry(nside)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        npt.assert_array_equal(g, w)


@pytest.mark.parametrize("lmax", [0, 1, 6, 40])
def test_legendre_table_bit_for_bit(lmax):
    x = np.cos(JS.ring_geometry(8).theta)
    npt.assert_array_equal(TS.legendre_table(lmax, x),
                           JS.legendre_table(lmax, x))


@pytest.mark.parametrize("lmax,lmax_w", [(20, 40), (31, 12), (1, 0)])
def test_coupling_matrix_bit_for_bit(lmax, lmax_w):
    wl = np.random.default_rng(lmax).uniform(0, 1, lmax_w + 1)
    npt.assert_array_equal(TS.coupling_matrix_from_mask_cl(wl, lmax),
                           JS.coupling_matrix_from_mask_cl(wl, lmax))


@pytest.mark.parametrize("lmax,nbins,lmin", [(31, 5, 2), (64, 16, 2),
                                             (20, 19, 2), (40, 8, 10)])
def test_binned_shape_ops_bit_for_bit(lmax, nbins, lmin):
    npt.assert_array_equal(TS._bin_operator(lmax, nbins, lmin),
                           JS._bin_operator(lmax, nbins, lmin))
    for g, w in zip(TS._binned_shape_ops(lmax, nbins, lmin),
                    JS._binned_shape_ops(lmax, nbins, lmin)):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        npt.assert_array_equal(g, w)


def test_empty_band_raises():
    """nbins beyond the multipoles in [lmin, lmax] leaves a band empty."""
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="contain no"):
            mod._binned_shape_ops(10, 12, 2)


def test_cl_to_lmax_zero_pads_and_truncates():
    cl = np.arange(1.0, 6.0, dtype=np.float32)
    for lmax in (2, 4, 9):
        _close(TS.cl_to_lmax(torch.from_numpy(cl), lmax),
               JS.cl_to_lmax(jnp.asarray(cl), lmax), tol=0.0)
    padded = TS.cl_to_lmax(torch.from_numpy(cl), 9).numpy()
    npt.assert_array_equal(padded[5:], 0.0)


# ------------------------------------------------------ analytic anchors
def test_y00_constant_map():
    m = TS.synthesize(_alm({(0, 0): 1.0}), _alm({}), NSIDE, LMAX,
                      device="cpu").numpy()
    npt.assert_allclose(m, 1.0 / np.sqrt(4 * np.pi), rtol=1e-5)


def test_y10_is_cos_theta():
    m = TS.synthesize(_alm({(1, 0): 1.0}), _alm({}), NSIDE, LMAX,
                      device="cpu").numpy()
    th, _ = JH.pix2ang_ring(NSIDE, np.arange(JH.nside2npix(NSIDE)))
    npt.assert_allclose(m, np.sqrt(3 / (4 * np.pi)) * np.cos(th), atol=1e-6)


def test_y11_azimuthal():
    # 2 Re(a_11 Y_11) = -2 sqrt(3/8pi) sin(theta) cos(phi) for a_11 = 1
    m = TS.synthesize(_alm({(1, 1): 1.0}), _alm({}), NSIDE, LMAX,
                      device="cpu").numpy()
    th, ph = JH.pix2ang_ring(NSIDE, np.arange(JH.nside2npix(NSIDE)))
    npt.assert_allclose(m, -2.0 * np.sqrt(3 / (8 * np.pi)) * np.sin(th)
                        * np.cos(ph), atol=1e-6)


# --------------------------------------------------------- the transforms
@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 24), (16, 47)])
def test_synthesize_matches_jax(nside, lmax):
    a_re, a_im = _random_alms(1, lmax)
    _close(TS.synthesize(a_re, a_im, nside, lmax, device="cpu"),
           JS.synthesize(a_re, a_im, nside, lmax))


@pytest.mark.parametrize("niter", [0, 3])
@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 47)])
def test_analyze_matches_jax(nside, lmax, niter):
    m = _map(2, nside)
    got = TS.analyze(m, nside, lmax, niter=niter, device="cpu")
    want = JS.analyze(m, nside, lmax, niter=niter)
    for g, w in zip(got, want):
        _close(g, w, 2 * TOL)


def test_alm_roundtrip():
    a_re, a_im = _random_alms(3)
    m = TS.synthesize(a_re, a_im, NSIDE, LMAX, device="cpu")
    b_re, b_im = TS.analyze(m, NSIDE, LMAX, niter=3)
    npt.assert_allclose(b_re.numpy(), a_re, atol=2e-4)
    npt.assert_allclose(b_im.numpy(), a_im, atol=2e-4)


def test_alm2cl_and_anafast_match_jax():
    a_re, a_im = _random_alms(4)
    _close(TS.alm2cl(torch.from_numpy(a_re), torch.from_numpy(a_im)),
           JS.alm2cl(jnp.asarray(a_re), jnp.asarray(a_im)))
    m = _map(5)
    for niter in (0, 3):
        _close(TS.anafast(m, LMAX, niter=niter, device="cpu"),
               JS.anafast(m, LMAX, niter=niter), 4 * TOL)


def test_smoothing_matches_jax_and_the_beam():
    """The JAX package's smoothing within 1e-6 of the map's max, and a
    pure multipole scales by exactly b_l = exp(-l(l+1) sigma^2/2)."""
    m = _map(6)
    _close(TS.smoothing(m, 0.1, LMAX, device="cpu"),
           JS.smoothing(m, 0.1, LMAX))
    pure = TS.synthesize(_alm({(8, 0): 1.0}), _alm({}), NSIDE, LMAX,
                         device="cpu")
    sm = TS.smoothing(pure, 0.1, LMAX).numpy()
    sigma = 0.1 / np.sqrt(8 * np.log(2))
    npt.assert_allclose(sm, np.exp(-0.5 * 72 * sigma ** 2) * pure.numpy(),
                        atol=5e-5)


def _belt_mask(nside=NSIDE, cut=2.2):
    th, _ = JH.pix2ang_ring(nside, np.arange(JH.nside2npix(nside)))
    return (th < cut).astype(np.float32)


def test_anafast_masked_matches_jax():
    m, mask = _map(7), _belt_mask()
    _close(TS.anafast_masked(m, mask, LMAX, device="cpu"),
           JS.anafast_masked(m, mask, LMAX), 4 * TOL)


def test_anafast_master_matches_jax():
    """Band centres equal; band powers within 1e-5 of their max (float32
    pseudo-Cl into the float64 solve), from the mask's own spectrum and
    from a given coupling."""
    nside, lmax = 16, 31
    cl = np.zeros(lmax + 1, np.float32)
    cl[2:] = 1.0 / np.arange(2, lmax + 1) ** 2
    m = np.asarray(JS.synfast(jax.random.PRNGKey(0), cl, nside, lmax))
    th, _ = JH.pix2ang_ring(nside, np.arange(JH.nside2npix(nside)))
    mask = ((th < 1.2) | (th > 1.9)).astype(np.float32)
    ell_t, cl_t = TS.anafast_master(m, mask, lmax, nbins=5, device="cpu")
    ell_j, cl_j = JS.anafast_master(m, mask, lmax, nbins=5)
    _close(ell_t, ell_j, 0.0)
    _close(cl_t, cl_j, 1e-5)
    wl = np.asarray(JS.anafast(jnp.asarray(mask), 2 * lmax))
    coup = JS.coupling_matrix_from_mask_cl(wl, lmax)
    _close(TS.anafast_master(m, mask, lmax, nbins=5, coupling=coup,
                             device="cpu")[1],
           JS.anafast_master(m, mask, lmax, nbins=5, coupling=coup)[1], 1e-5)


def test_synfast_from_white_with_jax_draws():
    """synfast's twin fed with the JAX package's two normal draws of
    `k1, k2 = split(key)` gives its map, also where lmax zero-pads."""
    ell = np.arange(LMAX + 1)
    cl_in = (1e-2 / (1.0 + ell) ** 2).astype(np.float32)
    for seed, lmax in ((7, None), (8, LMAX + 6)):
        key = jax.random.PRNGKey(seed)
        L = LMAX if lmax is None else lmax
        k1, k2 = jax.random.split(key)
        white = [np.asarray(jax.random.normal(k, (L + 1, L + 1)))
                 for k in (k1, k2)]
        _close(TS.synfast_from_white(*white, cl_in, NSIDE, lmax,
                                     device="cpu"),
               JS.synfast(key, cl_in, NSIDE, lmax))


def test_synfast_generator_cl_recovery():
    """A generator's map: per-l pulls within 4 sigma (2l+1 modes)."""
    ell = np.arange(LMAX + 1)
    cl_in = 1e-2 / (1.0 + ell) ** 2
    m = TS.synfast(torch.Generator().manual_seed(7), cl_in, NSIDE)
    cl_out = TS.anafast(m, LMAX).numpy()
    sigma = np.sqrt(2.0 / (2 * ell[2:] + 1))
    assert np.all(np.abs(cl_out[2:] / cl_in[2:] - 1.0) / sigma < 4.0)


def test_numpy_input_placement():
    """Numpy maps and alms go to `device`, by default the CUDA card
    (raising without one); tensors keep their device."""
    m = _map(9)
    a_re, a_im = _random_alms(9)
    if not torch.cuda.is_available():
        for call in (lambda: TS.anafast(m, LMAX),
                     lambda: TS.synthesize(a_re, a_im, NSIDE, LMAX),
                     lambda: TS.sht_tables(NSIDE, LMAX)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert TS.anafast(torch.from_numpy(m), LMAX).device.type == "cpu"
    assert TS.synthesize(torch.from_numpy(a_re), torch.from_numpy(a_im),
                         NSIDE, LMAX).device.type == "cpu"
