"""PyTorch port vs JAX package on the CPU: the sky-map operations. The
filter bank, object profiles with their mean, bootstrap and tangential
shear, troughs, Minkowski functionals, aperture mass, the map transforms
and the object-selection copy.

Inputs are made with numpy (or are the JAX package's own random draws:
the bootstrap's block draws, the troughs' centres) and handed to both
packages; each tolerance is stated where it is checked. Maps agree to
float32 rounding of their FFTs (1e-5 of the map's maximum); catalogs and
bin decisions agree exactly.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import ndimage  # noqa: E402

from astrild_tpu.ops import aperture_mass as JA  # noqa: E402
from astrild_tpu.ops import filters as JF  # noqa: E402
from astrild_tpu.ops import map_transform as JMT  # noqa: E402
from astrild_tpu.ops import minkowski as JM  # noqa: E402
from astrild_tpu.ops import object_selection as JOS  # noqa: E402
from astrild_tpu.ops import profiles as JP  # noqa: E402
from astrild_tpu.ops import troughs as JT  # noqa: E402
from astrild_tpu_torch.ops import aperture_mass as TA  # noqa: E402
from astrild_tpu_torch.ops import filters as TF  # noqa: E402
from astrild_tpu_torch.ops import map_transform as TMT  # noqa: E402
from astrild_tpu_torch.ops import minkowski as TM  # noqa: E402
from astrild_tpu_torch.ops import object_selection as TOS  # noqa: E402
from astrild_tpu_torch.ops import profiles as TP  # noqa: E402
from astrild_tpu_torch.ops import troughs as TT  # noqa: E402

MAP_TOL = 1e-5    # maps: max |port - JAX| / max |JAX|
STAT_RTOL = 1e-5  # reduced statistics (means, moments), relative


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


def N(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_map_close(got, want, tol=MAP_TOL):
    got, want = N(got), np.asarray(want)
    assert got.shape == want.shape
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-30)
        assert float(np.abs(got[fin] - want[fin]).max()) <= tol * scale


@pytest.fixture
def img(rng):
    return rng.standard_normal((96, 96)).astype(np.float32)


# ----------------------------------------------------------------- filters
def test_fwhm_sigma_and_freqs_match_jax():
    assert TF.sigma_to_fwhm(1.3) == JF.sigma_to_fwhm(1.3)
    assert TF.fwhm_to_sigma(2.0) == JF.fwhm_to_sigma(2.0)
    for n in (96, 97):
        # the JAX package's fftfreq(n) * 2 pi, bit for bit (not integer
        # mode numbers)
        k1, _ = TF._pix_freqs(n, "cpu")
        j1, _ = JF._pix_freqs(n)
        npt.assert_array_equal(N(k1), np.asarray(j1))


@pytest.mark.parametrize("kind", ["sigma", "fwhm", "high_pass"])
def test_gaussian_filters_match_jax(img, kind):
    kw = ({"sigma_arcmin": 5.0} if kind == "sigma"
          else {"fwhm_arcmin": 7.0})
    if kind == "high_pass":
        want = JF.gaussian_high_pass(jnp.asarray(img), 2.0, **kw)
        got = TF.gaussian_high_pass(T(img), 2.0, **kw)
    else:
        want = JF.gaussian(jnp.asarray(img), 2.0, **kw)
        got = TF.gaussian(T(img), 2.0, **kw)
    assert_map_close(got, want)
    with pytest.raises(ValueError):
        TF.gaussian(T(img), 2.0)


def test_gaussian_matches_ndimage(rng):
    """The JAX package's own check: the spectral Gaussian equals
    ndimage's wrapped real-space one to 5e-4."""
    img = rng.standard_normal((128, 128)).astype(np.float32)
    sigma_pix = 5.0 / 60.0 * 128 / 2.0
    want = ndimage.gaussian_filter(img, sigma_pix, mode="wrap")
    got = N(TF.gaussian(T(img), 2.0, sigma_arcmin=5.0))
    npt.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("orders", [(1, 0), (0, 2), (3, 0), (1, 2)])
def test_gaussian_derivative_matches_jax(img, orders):
    assert_map_close(TF.gaussian_derivative(T(img), 2.0, 8.0, orders),
                     JF.gaussian_derivative(jnp.asarray(img), 2.0, 8.0,
                                            orders))


@pytest.mark.parametrize("axis", [0, 1])
def test_dgd3_and_window_match_jax(img, axis):
    assert_map_close(TF.dgd3(T(img), 2.0, 10.0, axis=axis),
                     JF.dgd3(jnp.asarray(img), 2.0, 10.0, axis=axis))
    for npix in (64, 65):
        assert_map_close(
            TF.dgd3_window(npix, 10.0, 20.0, axis=axis, device="cpu"),
            JF.dgd3_window(npix, 10.0, 20.0, axis=axis))


def test_compensated_filters_match_jax(img):
    assert_map_close(TF.gaussian_compensated(T(img), 2.0, 5.0, 20.0),
                     JF.gaussian_compensated(jnp.asarray(img), 2.0, 5.0,
                                             20.0))
    assert_map_close(TF.aperture_photometry(T(img), 1.0, 10.0),
                     JF.aperture_photometry(jnp.asarray(img), 1.0, 10.0))
    assert_map_close(TF.apodization(T(img)),
                     JF.apodization(jnp.asarray(img)))
    for alpha in (0.65, 1.0):
        got = float(TF.tophat_compensated(T(img), 1.0, 10.0, alpha=alpha))
        want = float(JF.tophat_compensated(jnp.asarray(img), 1.0, 10.0,
                                           alpha=alpha))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3)
    # the JAX tests' closed forms: a constant map goes to 0
    npt.assert_allclose(N(TF.aperture_photometry(torch.full((64, 64), 5.0),
                                                 1.0, 10.0)), 0.0, atol=1e-6)
    assert abs(float(TF.tophat_compensated(torch.ones(64, 64), 1.0,
                                           10.0))) < 1e-6


def test_pca_foreground_separation_matches_jax(rng):
    """The reconstruction is a sum of outer products (no matmul); it
    equals the JAX package's (u * s_cut) @ vt to 1e-5 of the map's max
    (the two SVDs round differently)."""
    big = rng.standard_normal((128, 128)).astype(np.float32)
    big += np.sin(np.arange(128) / 5.0)[None, :].astype(np.float32)
    assert_map_close(TF.pca_foreground_separation(T(big), 8, 5),
                     JF.pca_foreground_separation(jnp.asarray(big), 8, 5))


def test_dictionary_learning_denoise_matches_jax(rng, monkeypatch):
    pytest.importorskip("sklearn")
    clean = rng.standard_normal((64, 64)).astype(np.float32)
    noisy = clean + 0.1 * rng.standard_normal((64, 64)).astype(np.float32)
    # sklearn draws from numpy's global generator: one seed for both
    np.random.seed(0)
    want = JF.dictionary_learning_denoise(clean, noisy, 4, 3)
    np.random.seed(0)
    got = TF.dictionary_learning_denoise(T(clean), noisy, 4, 3)
    assert got.dtype == want.dtype == np.float32
    npt.assert_array_equal(got, want)
    # without sklearn it raises, as the JAX function does
    import builtins
    real_import = builtins.__import__

    def no_sklearn(name, *a, **k):
        if name.startswith("sklearn"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(ImportError, match="sklearn"):
        TF.dictionary_learning_denoise(clean, noisy, 4, 3)


# ---------------------------------------------------------------- profiles
def _objects(rng, n, nobj=40):
    cen = rng.integers(0, n, (nobj, 2)).astype(np.int32)
    # some centres on the map's edges: the clamped patch
    cen[:4] = [[0, 0], [n - 1, 3], [5, n - 1], [n - 1, n - 1]]
    rad = rng.uniform(2.0, 12.0, nobj).astype(np.float32)
    return cen, rad


@pytest.mark.parametrize("extend,nbins,patch_half", [(2.0, 10, 30),
                                                     (1.0, 7, 13),
                                                     (3.0, 12, 80)])
def test_object_profiles_match_jax(img, rng, extend, nbins, patch_half):
    """Bins are decided identically (the division by a device tensor), so
    the NaN pattern is equal and the means agree to float32 sums."""
    cen, rad = _objects(rng, img.shape[0])
    e1, v1 = JP.object_profiles(jnp.asarray(img), jnp.asarray(cen),
                                jnp.asarray(rad), patch_half=patch_half,
                                nbins=nbins, extend=extend)
    e2, v2 = TP.object_profiles(T(img), T(cen), T(rad),
                                patch_half=patch_half, nbins=nbins,
                                extend=extend)
    npt.assert_array_equal(N(e2), np.asarray(e1))
    assert_map_close(v2, v1)


def test_object_profiles_radial_step_and_chunks(monkeypatch):
    n, R = 128, 10.0
    e = np.arange(n)
    r = np.sqrt((e[:, None] - 64.0) ** 2 + (e[None, :] - 64.0) ** 2)
    img = T((r < R).astype(np.float32))
    _, vals = TP.object_profiles(img, T([[64, 64]]), T([R]), patch_half=25,
                                 nbins=10, extend=2.0)
    v = N(vals[0])
    npt.assert_allclose(v[:4], 1.0, atol=0.05)
    npt.assert_allclose(v[6:], 0.0, atol=0.05)
    # chunks of one object give the same result as one batch
    cen = T([[30, 30], [90, 90], [64, 64]])
    rad = T(np.array([5.0, 8.0, 12.0], np.float32))
    _, whole = TP.object_profiles(img, cen, rad, patch_half=30, nbins=8,
                                  extend=2.0)
    monkeypatch.setattr(TP, "_CHUNK_PIXELS", 1)
    _, chunked = TP.object_profiles(img, cen, rad, patch_half=30, nbins=8,
                                    extend=2.0)
    assert torch.equal(torch.isnan(whole), torch.isnan(chunked))
    npt.assert_array_equal(np.nan_to_num(N(whole)), np.nan_to_num(N(chunked)))


@pytest.mark.parametrize("case", ["random", "gaps", "weights", "empty_col"])
def test_mean_and_interpolate_matches_jax(rng, case):
    p = rng.standard_normal((30, 9)).astype(np.float32)
    w = None
    if case == "gaps":
        p[:, [0, 3, 4, 8]] = np.nan
    elif case == "weights":
        p[rng.random(p.shape) < 0.3] = np.nan
        w = rng.uniform(0.5, 2.0, 30).astype(np.float32)
    elif case == "empty_col":
        p[:] = np.nan
    want = JP.mean_and_interpolate(jnp.asarray(p),
                                   None if w is None else jnp.asarray(w))
    got = TP.mean_and_interpolate(T(p), None if w is None else T(w))
    assert_map_close(got, want, tol=1e-6)


@pytest.mark.parametrize("n_boot,block_pix,npix", [(50, 128, 512),
                                                   (30, 32, 128),
                                                   (7, 100, 250)])
def test_bootstrap_profiles_from_jax_draws_match_jax(rng, n_boot, block_pix,
                                                     npix):
    """The JAX package's randint draws in its key-split order through the
    port's percentiles (jnp.nanpercentile inside jit: the folded
    (q * 0.01f) * (count - 1))."""
    profiles = rng.normal(2.0, 0.1, (64, 6)).astype(np.float32)
    profiles[rng.random(profiles.shape) < 0.2] = np.nan
    profiles[:, 5] = np.nan   # a column with no number
    centers = rng.integers(0, npix, (64, 2)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    lo1, hi1 = JP.bootstrap_profiles(jnp.asarray(profiles),
                                     jnp.asarray(centers), key,
                                     n_boot=n_boot, block_pix=block_pix,
                                     npix=npix)
    nblk = max(npix // block_pix, 1)
    drawn = jax.vmap(lambda k: jax.random.randint(
        k, (nblk * nblk,), 0, nblk * nblk))(jax.random.split(key, n_boot))
    lo2, hi2 = TP.bootstrap_profiles_from_draws(
        T(profiles), T(centers), T(drawn), block_pix=block_pix, npix=npix)
    assert_map_close(lo2, lo1, tol=1e-6)
    assert_map_close(hi2, hi1, tol=1e-6)


@pytest.mark.parametrize("q", [16.0, 84.0, 50.0, 2.5, 100.0])
def test_nanpercentile_matches_jit_nanpercentile(rng, q):
    x = rng.standard_normal((37, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:, 4] = np.nan
    want = jax.jit(lambda a, qq: jnp.nanpercentile(a, qq, axis=0))(
        jnp.asarray(x), q)
    got = TP._nanpercentile(T(x), q)
    npt.assert_array_equal(np.isnan(N(got)), np.isnan(np.asarray(want)))
    npt.assert_array_equal(np.nan_to_num(N(got)),
                           np.nan_to_num(np.asarray(want)))


def test_bootstrap_profiles_with_a_generator(rng):
    """The JAX test's bracket, on a torch generator's draws."""
    profiles = T(rng.normal(2.0, 0.1, (64, 6)).astype(np.float32))
    centers = T(rng.integers(0, 512, (64, 2)).astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    lo, hi = TP.bootstrap_profiles(profiles, centers, gen, n_boot=50,
                                   block_pix=128, npix=512)
    assert bool((lo < 2.05).all()) and bool((hi > 1.95).all())
    assert bool((lo <= hi).all())


def test_tangential_shear_matches_jax(rng):
    eta = np.linspace(0.1, 2.0, 10).astype(np.float32)
    kap = rng.standard_normal(10).astype(np.float32)
    assert_map_close(TP.tangential_shear(T(eta), T(kap)),
                     JP.tangential_shear(jnp.asarray(eta), jnp.asarray(kap)),
                     tol=1e-6)
    npt.assert_allclose(N(TP.tangential_shear(T(eta), torch.full((10,), 0.3))),
                        0.0, atol=1e-6)


# ----------------------------------------------------------------- troughs
@pytest.mark.parametrize("conv", [True, False])
def test_find_troughs_from_jax_draws_matches_jax(img, conv):
    """The JAX package's centres through the port: the same apertures in
    the same order (the stable sort breaks ties as lax.top_k)."""
    n = img.shape[0]
    key = jax.random.PRNGKey(5)
    pos1, m1 = JT.find_troughs(jnp.asarray(img), key, 100, 0.2, 0.3, 5.0,
                               conv=conv)
    lower = int(0.25 * n)
    cen = jax.random.randint(key, (100, 2), lower, n - lower + 1)
    pos2, m2 = TT.find_troughs_from_draws(T(img), T(cen), 0.2, 0.3, 5.0,
                                          conv=conv)
    npt.assert_array_equal(N(pos2), np.asarray(pos1))
    assert_map_close(m2, m1, tol=1e-6)
    r1, p1 = JT.trough_profiles(jnp.asarray(img), pos1, 0.3, 5, 5.0)
    r2, p2 = TT.trough_profiles(T(img), pos2, 0.3, 5, 5.0)
    npt.assert_array_equal(N(r2), np.asarray(r1))
    assert_map_close(p2, p1, tol=1e-6)


def test_find_troughs_ties_and_generator():
    """A constant map ties every aperture: the lowest indices come first,
    as lax.top_k gives them."""
    img = np.ones((64, 64), np.float32)
    cen = np.random.default_rng(0).integers(16, 49, (20, 2))
    key_cen = jnp.asarray(cen, jnp.int32)
    means = JT._trough_means(jnp.asarray(img), key_cen, 2.0, 20, 3)
    _, want = jax.lax.top_k(-means, 5)
    pos, _ = TT.find_troughs_from_draws(T(img), T(cen), 0.25, 2.0 * 5 / 64,
                                        5.0)
    npt.assert_array_equal(N(pos), cen[np.asarray(want)] * 5.0 / 64)
    gen = torch.Generator().manual_seed(1)
    pos, m = TT.find_troughs(T(img), gen, 40, 0.5, 0.2, 5.0)
    assert pos.shape == (20, 2) and bool(torch.isfinite(m).all())


# --------------------------------------------------------------- minkowski
def _grf(seed, n=256, smooth_px=4.0):
    rng = np.random.default_rng(seed)
    white = rng.standard_normal((n, n)).astype(np.float32)
    k2 = np.fft.fftfreq(n)[:, None] ** 2 + np.fft.rfftfreq(n)[None, :] ** 2
    w = np.exp(-0.5 * k2 * (2 * np.pi * smooth_px) ** 2)
    f = np.fft.irfft2(np.fft.rfft2(white) * w, s=(n, n))
    return ((f - f.mean()) / f.std()).astype(np.float32)


@pytest.mark.parametrize("limits,oa", [(None, None), ((-3.0, 3.0), None),
                                       ((-2.0, 2.0), 5.0)])
def test_minkowski_functionals_match_jax(limits, oa):
    """Given limits, the threshold bins are decided identically (V0
    equal); V1 / V2 to 1e-5 of their max (float32 derivative sums). The
    default limits come from the map's float32 mean and std, whose sums
    round differently in the two packages: there nu to 1e-6 and the
    functionals to 1e-3 of their max."""
    f = _grf(1)
    a = JM.minkowski_functionals(f, nbins=20, limits=limits,
                                 opening_angle_deg=oa)
    b = TM.minkowski_functionals(T(f), nbins=20, limits=limits,
                                 opening_angle_deg=oa)
    assert set(b) == set(a)
    if limits is None:
        npt.assert_allclose(b["nu"], a["nu"], rtol=1e-6, atol=1e-6)
        for k in ("V0", "V1", "V2"):
            assert_map_close(b[k], a[k], tol=1e-3)
        return
    npt.assert_array_equal(b["nu"], a["nu"])
    npt.assert_array_equal(b["V0"], a["V0"])
    for k in ("V1", "V2"):
        assert_map_close(b[k], a[k])


def test_minkowski_gaussian_field_matches_theory():
    """tests/test_minkowski.py::test_gaussian_field_matches_theory on the
    port (same field, same tolerances)."""
    f = _grf(0, n=512)
    mom = {k: float(v) for k, v in TM.map_moments(T(f)).items()}
    assert abs(mom["sigma0"] - 1.0) < 1e-3
    assert abs(mom["skewness"]) < 0.05
    res = TM.minkowski_functionals(T(f), nbins=24, limits=(-3.0, 3.0))
    nu = res["nu"] / mom["sigma0"]
    v0, v1, v2 = [N(x) for x in TM.gaussian_minkowski(
        nu, mom["sigma0"], mom["sigma1"], device="cpu")]
    core = np.abs(nu) < 2.0
    npt.assert_allclose(res["V0"][core], v0[core], rtol=0.06)
    npt.assert_allclose(res["V1"][core], v1[core], rtol=0.08)
    npt.assert_allclose(res["V2"][core], v2[core], rtol=0.2, atol=2e-5)


def test_map_moments_and_gaussian_minkowski_match_jax():
    g = np.expm1(0.5 * _grf(4))
    a = JM.map_moments(g)
    b = TM.map_moments(T(g))
    for k in a:
        npt.assert_allclose(float(b[k]), float(a[k]), rtol=STAT_RTOL,
                            atol=1e-7)
    nu = np.linspace(-3, 3, 13)
    for x, y in zip(TM.gaussian_minkowski(nu, 1.2, 0.3, device="cpu"),
                    JM.gaussian_minkowski(nu, 1.2, 0.3)):
        npt.assert_allclose(N(x), np.asarray(y), rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------- aperture mass
def _grf_with_cl(seed, n=256, oa_deg=10.0, smooth_arcmin=3.0, amp=1e-8):
    pix = np.deg2rad(oa_deg) / n
    fx = np.fft.fftfreq(n, d=pix) * 2 * np.pi
    fy = np.fft.rfftfreq(n, d=pix) * 2 * np.pi
    ell = np.sqrt(fx[:, None] ** 2 + fy[None, :] ** 2)
    s = np.deg2rad(smooth_arcmin / 60.0)
    cl = amp * np.exp(-(ell * s) ** 2)
    rng = np.random.default_rng(seed)
    wh = rng.standard_normal((n, n))
    kap = np.fft.irfft2(np.fft.rfft2(wh) * np.sqrt(cl) / pix, s=(n, n))
    return kap.astype(np.float32), (fx, fy, ell, s, amp)


def test_aperture_mass_host_tables_are_copies():
    eta = np.linspace(0.0, 40.0, 801)
    npt.assert_array_equal(TA.u_hat(eta), JA.u_hat(eta))
    npt.assert_array_equal(TA._j4(eta), JA._j4(eta))
    npt.assert_array_equal(TA._u_transfer(64, 10.0, 4.0),
                           np.asarray(JA._u_transfer(64, 10.0, 4.0)))
    ells = np.linspace(1.0, 5000.0, 2000)
    cl = 1e-8 * np.exp(-(ells / 2000.0) ** 2)
    assert TA.map2_theory(ells, cl, 4.0) == JA.map2_theory(ells, cl, 4.0)


def test_aperture_mass_maps_and_moments_match_jax():
    kap, (fx, fy, ell, _, _) = _grf_with_cl(1)
    assert_map_close(TA.aperture_mass_map(T(kap), 10.0, 4.0),
                     JA.aperture_mass_map(kap, 10.0, 4.0))
    kh = np.fft.rfft2(kap)
    l2 = np.maximum(ell ** 2, 1e-30)
    g1 = np.fft.irfft2((fx[:, None] ** 2 - fy[None, :] ** 2) / l2 * kh,
                       s=kap.shape).astype(np.float32)
    g2 = np.fft.irfft2(2 * fx[:, None] * fy[None, :] / l2 * kh,
                       s=kap.shape).astype(np.float32)
    assert_map_close(TA.aperture_mass_from_shear(T(g1), T(g2), 10.0, 4.0),
                     JA.aperture_mass_from_shear(g1, g2, 10.0, 4.0))
    a = JA.aperture_mass_moments(kap, 10.0, [2.0, 4.0, 8.0])
    b = TA.aperture_mass_moments(T(kap), 10.0, [2.0, 4.0, 8.0])
    npt.assert_array_equal(b["theta_ap_arcmin"], a["theta_ap_arcmin"])
    for k in ("map2", "map3", "skewness"):
        npt.assert_allclose(b[k], a[k], rtol=1e-4,
                            atol=1e-5 * np.abs(a[k]).max())


def test_map2_matches_theory_integral():
    """tests/test_aperture_mass.py::test_map2_matches_theory_integral on the
    port (same field, same 12% bar, skewness below 0.05)."""
    kap, (_, _, ell, s, amp) = _grf_with_cl(0, n=512)
    mom = TA.aperture_mass_moments(T(kap), 10.0, [2.0, 4.0, 8.0])
    ltab = np.linspace(1.0, float(ell.max()), 20000)
    cltab = amp * np.exp(-(ltab * s) ** 2)
    for i, th in enumerate(mom["theta_ap_arcmin"]):
        t = TA.map2_theory(ltab, cltab, th)
        assert abs(mom["map2"][i] / t - 1.0) < 0.12, (th, mom["map2"][i], t)
    assert np.all(np.abs(mom["skewness"]) < 0.05)


# ------------------------------------------------------------ map transform
def test_map_transforms_match_jax(rng):
    f3 = rng.standard_normal((8, 9, 10)).astype(np.float32)
    for h in (1.0, 2.0):
        assert_map_close(TMT.gradient_3d(T(f3), h),
                         JMT.gradient_3d(jnp.asarray(f3), h), tol=1e-6)
    pos = rng.uniform(-10, 110, (2000, 3)).astype(np.float32)
    val = rng.standard_normal(2000).astype(np.float32)
    for reduce in ("mean", "sum"):
        assert_map_close(
            TMT.scatter_points_to_grid(T(pos), T(val), 8, 100.0, reduce),
            JMT.scatter_points_to_grid(jnp.asarray(pos), jnp.asarray(val),
                                       8, 100.0, reduce), tol=1e-6)
    for axis, kw in ((2, {}), (1, {"slab_center": 30.0,
                                   "slab_width": 40.0})):
        assert_map_close(
            TMT.slice_map(T(pos), T(val), 16, 100.0, axis=axis, **kw),
            JMT.slice_map(jnp.asarray(pos), jnp.asarray(val), 16, 100.0,
                          axis=axis, **kw), tol=1e-6)
    img = rng.standard_normal((64, 64)).astype(np.float32)
    cen, rad = _objects(rng, 64, nobj=12)
    npt.assert_array_equal(N(TMT.object_cutouts(T(img), T(cen), 5)),
                           np.asarray(JMT.object_cutouts(
                               jnp.asarray(img), jnp.asarray(cen), 5)))
    vals = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    for v in (None, vals):
        npt.assert_array_equal(
            N(TMT.paint_objects_on_map(64, T(cen), T(rad),
                                       None if v is None else T(v))),
            np.asarray(JMT.paint_objects_on_map(
                64, jnp.asarray(cen), jnp.asarray(rad),
                None if v is None else jnp.asarray(v))))


# --------------------------------------------------------- object selection
def test_object_selection_is_a_copy_of_the_jax_module(rng):
    import inspect

    for name in JOS.__all__:
        assert (inspect.getsource(getattr(TOS, name))
                == inspect.getsource(getattr(JOS, name)))
    n = 60
    data = {"rad_deg": 10 ** rng.uniform(-1.5, 0.0, n),
            "rad_pix": rng.uniform(3, 20, n),
            "x_pix": rng.uniform(0, 128, n), "y_pix": rng.uniform(0, 128, n),
            "theta1_pix": rng.uniform(0, 128, n),
            "theta2_pix": rng.uniform(0, 128, n)}
    a = JOS.categorize_sizes(dict(data), "log", 4, 3)
    b = TOS.categorize_sizes(dict(data), "log", 4, 3)
    for k in a:
        npt.assert_array_equal(b[k], a[k])
    tracers = rng.uniform(0, 128, (500, 2))
    npt.assert_array_equal(TOS.minimal_voids(data, tracers, 128.0)["minimal"],
                           JOS.minimal_voids(data, tracers, 128.0)["minimal"])
    for rtn in ("dict", "bool", "index"):
        a = JOS.trim_objects_crossing_edge(data, 1.5, 128, rtn=rtn)
        b = TOS.trim_objects_crossing_edge(data, 1.5, 128, rtn=rtn)
        if rtn == "dict":
            for k in a:
                npt.assert_array_equal(b[k], a[k])
        else:
            npt.assert_array_equal(b, a)


def test_numpy_input_placement(monkeypatch, img):
    """Numpy input lands on `device=`; without a card and without `device`
    the entry points raise; a tensor keeps its device."""
    assert TF.gaussian(img, 2.0, sigma_arcmin=3.0,
                       device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: TF.gaussian(img, 2.0, sigma_arcmin=3.0),
        lambda: TF.dgd3_window(32, 2.0, 5.0),
        lambda: TP.object_profiles(img, np.zeros((1, 2), np.int32),
                                   np.ones(1, np.float32), 3),
        lambda: TT.trough_profiles(img, np.zeros((1, 2), np.float32), 0.1,
                                   3, 2.0),
        lambda: TM.minkowski_functionals(img),
        lambda: TA.aperture_mass_map(img, 10.0, 4.0),
        lambda: TMT.object_cutouts(img, np.zeros((1, 2), np.int32), 2),
    ]
    for fn in calls:
        with pytest.raises(RuntimeError, match="no card"):
            fn()
    assert TF.apodization(T(img)).device.type == "cpu"
