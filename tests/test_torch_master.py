"""PyTorch port vs JAX package on the CPU: the flat-sky MASTER estimators
(`cl_flat_sky_masked`, `flat_sky_coupling_matrix`, `cl_flat_sky_master`,
`flat_sky_spin2_coupling_matrices`, `cl_flat_sky_shear_master` of
astrild_tpu_torch/ops/angular_power.py), `ops/sht.shape_binned_interp`,
and the `SkyNamaster` facade, mirroring
tests/test_master.py's flat-sky tests.

On the CPU the couplings are the JAX package's numpy code: equal bit for
bit. The card route (float64 torch.fft, one band at a time) runs here on
a CPU tensor through `_card_couplings` and is held to 1e-12 of the
matrix's max. The spectra are float32 on both sides: within 1e-5 of
their max (measured 4e-7).
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.models import SkyNamaster as JSkyNamaster  # noqa: E402
from astrild_tpu.ops import angular_power as JA  # noqa: E402
from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu.ops import sht_spin as JSS  # noqa: E402
from astrild_tpu.utils import healpix as JH  # noqa: E402
from astrild_tpu.ops.filters import gaussian as jgaussian  # noqa: E402
from astrild_tpu_torch.models import SkyNamaster  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TA  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402

NPIX, FOV = 64, 10.0
SPEC_TOL, CARD_TOL = 1e-5, 1e-12


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


def _steep_cl_tab():
    """C = 1/(l(l+1)), test_master.py's steep spectrum."""
    ell = np.linspace(1.0, 40000.0, 2048)
    return ell.astype(np.float32), (1.0 / (ell * (ell + 1.0))).astype(
        np.float32)


def _masks(n=NPIX):
    """A binary edge-and-stripe mask, test_master.py's blob mask (12 holes
    of 1/16-9/64 of the side, an edge of 12/128 of it, apodized by the
    JAX package's Gaussian filter over 6'), and a constant."""
    rng = np.random.default_rng(7)
    edge = np.ones((n, n), np.float32)
    edge[:, : n // 3] = 0.0
    edge[25 * n // 64: 35 * n // 64] = 0.0
    blob = np.ones((n, n), np.float32)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    for _ in range(12):
        cy, cx = rng.uniform(0, n, 2)
        r = rng.uniform(n / 16, 9 * n / 64)
        blob[(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2] = 0.0
    blob[:, : 12 * n // 128] = 0.0
    blob = np.clip(np.asarray(jgaussian(jnp.asarray(blob), FOV,
                                        sigma_arcmin=6.0)), 0.0, 1.0)
    return {"edge": edge, "blob": blob.astype(np.float32),
            "const": np.full((n, n), 0.7, np.float32)}


def _img(key, n=NPIX):
    ell, cl = _steep_cl_tab()
    return np.array(JA.cl_to_flat_map(jax.random.PRNGKey(key),
                                        jnp.asarray(ell), jnp.asarray(cl),
                                        n, FOV))


def _close(got, want, tol=SPEC_TOL, scale=None):
    """max |got - want| <= tol * scale, scale max |want| by default."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


# ---------------------------------------------------------------- sht copy
def test_shape_binned_interp_bit_for_bit():
    rng = np.random.default_rng(0)
    ell = rng.uniform(0.0, 3000.0, 500)
    member = np.zeros((6, 500))
    member[rng.integers(0, 6, 500), np.arange(500)] = 1.0
    counts = member.sum(1)
    assert np.array_equal(TS.shape_binned_interp(ell, member, counts),
                          JS.shape_binned_interp(ell, member, counts))
    counts[2] = 0.0
    for mod in (TS, JS):
        with pytest.raises(ValueError, match=r"band\(s\) \[2\] contain no "
                                             r"flat-sky grid modes"):
            mod.shape_binned_interp(ell, member, counts,
                                    what="flat-sky grid modes")


# -------------------------------------------------------------- couplings
@pytest.mark.parametrize("name", ["edge", "blob", "const"])
@pytest.mark.parametrize("limits", [(None, None), (100.0, 1000.0)])
def test_couplings_equal_jax_and_card_route(name, limits):
    """Scalar and spin-2 couplings bit for bit with the JAX package's on
    the CPU (numpy and CPU-tensor masks); the card route within 1e-12 of
    the max; M_pp + M_pm = M to 1e-10."""
    mask = _masks()[name]
    lo, hi = limits
    want = JA.flat_sky_coupling_matrix(mask, FOV, 8, ell_min=lo, ell_max=hi)
    want2 = JA.flat_sky_spin2_coupling_matrices(mask, FOV, 8, ell_min=lo,
                                                ell_max=hi)
    for m in (mask, torch.from_numpy(mask)):
        got = TA.flat_sky_coupling_matrix(m, FOV, 8, ell_min=lo,
                                          ell_max=hi)
        assert got.dtype == np.float64 and np.array_equal(got, want)
        got2 = TA.flat_sky_spin2_coupling_matrices(m, FOV, 8, ell_min=lo,
                                                   ell_max=hi)
        assert all(np.array_equal(g, w) for g, w in zip(got2, want2))
    m64 = torch.from_numpy(mask.astype(np.float64))
    card = TA._card_couplings(m64, FOV, 8, lo, hi, spin2=False)
    _close(card, want, CARD_TOL)
    card2 = TA._card_couplings(m64, FOV, 8, lo, hi, spin2=True)
    for g, w in zip(card2, want2):
        _close(g, w, CARD_TOL, scale=np.abs(want2[0]).max())
    npt.assert_allclose(got2[0] + got2[1], got, rtol=1e-10, atol=1e-14)


def test_coupling_matrix_trivial_masks():
    ones = np.ones((64, 64), np.float32)
    npt.assert_allclose(TA.flat_sky_coupling_matrix(ones, FOV, 8),
                        np.eye(8), atol=1e-4)
    npt.assert_allclose(TA.flat_sky_coupling_matrix(0.5 * ones, FOV, 8),
                        0.25 * np.eye(8), atol=1e-4)


# ---------------------------------------------------------------- spectra
@pytest.mark.parametrize("name", ["edge", "blob"])
@pytest.mark.parametrize("apodize", [0.0, 20.0])
def test_masked_spectra_match_jax(name, apodize):
    """cl_flat_sky_masked, cl_flat_sky_master and cl_flat_sky_shear_master
    within 1e-5 of their max of the JAX package's on the same maps and
    mask (apodized by each package's own Gaussian filter)."""
    mask = _masks()[name]
    img, img2 = _img(1), _img(2)
    for fn, args in (("cl_flat_sky_masked", (img, mask)),
                     ("cl_flat_sky_master", (img, mask)),
                     ("cl_flat_sky_shear_master", (img, img2, mask))):
        want = getattr(JA, fn)(*[jnp.asarray(a) for a in args], FOV,
                               nbins=6, apodize_arcmin=apodize)
        got = getattr(TA, fn)(*args, FOV, nbins=6, apodize_arcmin=apodize,
                              device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            _close(g, w)


def test_master_with_coupling_and_limits_matches_jax():
    """A precomputed coupling and ell limits: the solve of the port's
    pseudo spectrum against the JAX package's result."""
    mask = _masks()["edge"]
    img = _img(3)
    lmax = 360.0 / FOV * NPIX / np.sqrt(2.0) * 1.001
    M = JA.flat_sky_coupling_matrix(mask, FOV, 8, ell_max=lmax)
    want = JA.cl_flat_sky_master(jnp.asarray(img), jnp.asarray(mask), FOV,
                                 nbins=8, ell_max=lmax, coupling=M)
    got = TA.cl_flat_sky_master(torch.from_numpy(img), mask, FOV, nbins=8,
                                ell_max=lmax, coupling=M)
    for g, w in zip(got, want):
        _close(g, w)


def test_master_equals_w2_for_constant_mask():
    img = torch.from_numpy(_img(0))
    mask = _masks()["const"]
    _, c_m = TA.cl_flat_sky_masked(img, mask, FOV, nbins=10)
    _, c_x = TA.cl_flat_sky_master(img, mask, FOV, nbins=10)
    npt.assert_allclose(c_x.numpy(), c_m.numpy(), rtol=1e-3)


def test_master_unbiased_where_w2_biased():
    """test_master.py's acceptance case on the port, from the JAX
    package's 256 maps of PRNGKey(3): under the apodized blob mask <w^2>
    is biased by more than 8% in a band, MASTER within 2% in every band."""
    ell_tab, cl_tab = _steep_cl_tab()
    n, nbins = 128, 10
    lmax_all = 360.0 / FOV * n / np.sqrt(2.0) * 1.001
    keys = jax.random.split(jax.random.PRNGKey(3), 256)
    imgs = torch.from_numpy(np.asarray(jax.vmap(
        lambda k: JA.cl_to_flat_map(k, jnp.asarray(ell_tab),
                                    jnp.asarray(cl_tab), n, FOV))(keys)))
    w = torch.from_numpy(_masks(n)["blob"])

    def mean_cl(fn):
        return np.mean([fn(m).numpy() for m in imgs], axis=0)

    true_all = mean_cl(lambda m: TA.cl_flat_sky(m, FOV, nbins,
                                                ell_max=lmax_all)[1])
    true_def = mean_cl(lambda m: TA.cl_flat_sky(m, FOV, nbins)[1])
    cl_w2 = mean_cl(lambda m: TA.cl_flat_sky_masked(m, w, FOV, nbins)[1])
    pcl = mean_cl(lambda m: TA.cl_flat_sky(m * w, FOV, nbins,
                                           ell_max=lmax_all)[1])
    M = TA.flat_sky_coupling_matrix(w, FOV, nbins, ell_max=lmax_all)
    cl_ms = np.linalg.solve(M, pcl.astype(np.float64))
    assert np.abs(cl_w2 / true_def - 1.0).max() > 0.08
    assert np.abs(cl_ms / true_all - 1.0).max() < 0.02


def test_spin2_master_unbiased_and_b_null():
    """test_master.py's spin-2 case on the port with the JAX package's 40
    kappa maps: raw E -> B leakage above 2%, MASTER's EE within 8% of the
    unmasked EE and its BB below 1.2% of it in bands 1-4."""
    n, nb = 64, 6
    ells = np.linspace(1.0, 20000.0, 2048)
    cl_in = 1.0 / (ells + 50.0) ** 2
    mask = np.ones((n, n), np.float32)
    mask[:, :20] = 0.0
    mask[25:35, :] = 0.0
    coup = TA.flat_sky_spin2_coupling_matrices(mask, FOV, nb)
    w = torch.from_numpy(mask)
    w2 = float(np.mean(mask ** 2))
    ee_t, pbb, ee_m, bb_m = [], [], [], []
    for i in range(40):
        kappa = JA.cl_to_flat_map(jax.random.PRNGKey(i),
                                  jnp.asarray(ells, jnp.float32),
                                  jnp.asarray(cl_in, jnp.float32), n, FOV)
        g1, g2 = TA.kappa_to_shear_maps(torch.from_numpy(np.asarray(kappa)))
        ee_t.append(TA.cl_shear_eb(g1, g2, FOV, nbins=nb)[1].numpy())
        pbb.append(TA.cl_shear_eb(g1 * w, g2 * w, FOV, nbins=nb)[2].numpy()
                   / w2)
        _, ee, bb = TA.cl_flat_sky_shear_master(g1, g2, mask, FOV, nbins=nb,
                                                coupling=coup)
        ee_m.append(ee.numpy())
        bb_m.append(bb.numpy())
    ee_t = np.mean(ee_t, 0)
    band = slice(1, 5)
    assert np.all(np.mean(pbb, 0)[band] / ee_t[band] > 0.02)
    npt.assert_allclose(np.mean(ee_m, 0)[band] / ee_t[band], 1.0, atol=0.08)
    assert np.all(np.abs(np.mean(bb_m, 0)[band] / ee_t[band]) < 0.012)


def test_error_paths():
    """Apodizing with a precomputed coupling raises, as does a band with
    no grid modes, on both routes, with the JAX package's messages."""
    z, one = np.zeros((32, 32), np.float32), np.ones((32, 32), np.float32)
    with pytest.raises(ValueError, match="apodize"):
        TA.cl_flat_sky_master(z, one, 10.0, nbins=4, apodize_arcmin=5.0,
                              coupling=np.eye(4), device="cpu")
    with pytest.raises(ValueError, match="apodize"):
        TA.cl_flat_sky_shear_master(z, z, one, 10.0, nbins=4,
                                    apodize_arcmin=5.0,
                                    coupling=(np.eye(4), np.zeros((4, 4))),
                                    device="cpu")
    img = np.random.default_rng(0).standard_normal((16, 16)).astype(
        np.float32)
    with pytest.raises(ValueError, match="band.*no.*modes"):
        TA.cl_flat_sky_master(img, np.ones((16, 16)), 5.0, nbins=20,
                              device="cpu")
    with pytest.raises(ValueError, match="band.*no.*modes"):
        TA._card_couplings(torch.ones(16, 16, dtype=torch.float64), 5.0, 20,
                           None, None, spin2=False)


# ---------------------------------------------------------------- facade
def test_skynamaster_flat_matches_jax_and_caches():
    """compute_cl (decoupled, cached, and <w^2>) and compute_cl_spin2 of
    the port's facade against the JAX package's on the same numpy map and
    mask, within 1e-5 of the max; the cache holds one matrix per (kind,
    nbins)."""
    img, g2 = _img(5), _img(6)
    mask = _masks()["blob"]
    jsn = JSkyNamaster.from_array(img, opening_angle=FOV)
    jsn.set_mask(mask)
    tsn = SkyNamaster.from_array(img, opening_angle=FOV, device="cpu")
    tsn.set_mask(mask)
    for decouple in (True, False):
        want = jsn.compute_cl(nbins=8, decouple=decouple)
        got = tsn.compute_cl(nbins=8, decouple=decouple)
        for g, w in zip(got, want):
            _close(g, w)
    assert set(tsn._workspace) == {("flat", 8)}
    want = jsn.compute_cl_spin2(img, g2, nbins=6)
    got = tsn.compute_cl_spin2(img, g2, nbins=6)
    for g, w in zip(got, want):
        _close(g, w)
    assert ("flat-spin2", 6) in tsn._workspace
    for g, w in zip(tsn.compute_cl_spin2(img, g2, nbins=6, decouple=False),
                    jsn.compute_cl_spin2(img, g2, nbins=6, decouple=False)):
        _close(g, w)


def test_skynamaster_cached_coupling_reused():
    """The second compute_cl reuses the cached matrix (the same numbers);
    decouple=False differs from MASTER; NaN pixels become the mask."""
    img = _img(5)
    sn = SkyNamaster.from_array(img, opening_angle=FOV, device="cpu")
    sn.set_mask(_masks()["blob"])
    _, cl = sn.compute_cl(nbins=8)
    M = sn._workspace[("flat", 8)]
    _, cl2 = sn.compute_cl(nbins=8)
    assert sn._workspace[("flat", 8)] is M and torch.equal(cl, cl2)
    _, cl_nd = sn.compute_cl(nbins=8, decouple=False)
    assert not np.allclose(cl_nd.numpy(), cl.numpy())
    nan_img = img.copy()
    nan_img[:8] = np.nan
    sn2 = SkyNamaster.from_array(nan_img, opening_angle=FOV)
    assert sn2.data["mask"].sum() == NPIX * (NPIX - 8)
    assert np.isfinite(sn2.data["orig"]).all()


def test_skynamaster_per_call_mask_not_stale():
    """A per-call mask never reuses the stored mask's coupling, and
    set_mask clears the cache (test_master.py's case)."""
    img = _img(8)
    m1 = np.ones((NPIX, NPIX), np.float32)
    m1[:, :20] = 0.0
    m2 = np.ones((NPIX, NPIX), np.float32)
    m2[:32, :] = 0.0
    sn = SkyNamaster.from_array(img, opening_angle=FOV, device="cpu")
    _, c1 = sn.compute_cl(mask=m1, nbins=6)
    _, c2 = sn.compute_cl(mask=m2, nbins=6)
    assert not np.allclose(c1.numpy(), c2.numpy())
    _, c2_ref = SkyNamaster.from_array(img, opening_angle=FOV,
                                       device="cpu").compute_cl(mask=m2,
                                                                nbins=6)
    npt.assert_allclose(c2.numpy(), c2_ref.numpy(), rtol=1e-5)
    sn.set_mask(m1)
    _, s1 = sn.compute_cl(nbins=6)
    sn.set_mask(m2)
    _, s2 = sn.compute_cl(nbins=6)
    npt.assert_allclose(s2.numpy(), c2_ref.numpy(), rtol=1e-5)
    assert not np.allclose(s1.numpy(), s2.numpy())


def test_skynamaster_full_sky_and_h5_raise(tmp_path):
    """The full-sky paths and the .h5 file branch, once raises naming
    queue 1 item 6, against the JAX package's: compute_cl decoupled and
    not, compute_cl_spin2 decoupled and not (band powers within 1e-5 of
    their max), the stored coupling's cache key, a .h5 file's map (float32
    rounding); a flat-sky spin-2 lmax and an unknown file type are
    ValueErrors, a .npy file loads."""
    nside, lmax = 16, 20
    npix = 12 * nside * nside
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl = np.zeros(lmax + 1, np.float32)
    cl[2:] = 1.0 / ell[2:] ** 2
    hmap = np.asarray(JS.synfast(jax.random.PRNGKey(6), cl, nside, lmax))
    theta, _ = JH.pix2ang_ring(nside, np.arange(npix))
    fmask = (theta < 1.9).astype(np.float64)
    full = SkyNamaster.from_array(hmap, device="cpu")
    jfull = JSkyNamaster.from_array(hmap)
    assert not full.flat and full.nside == 16
    for sn in (full, jfull):
        sn.set_mask(fmask)
    for kw in ({"lmax": lmax, "nbins": 5}, {"decouple": False}):
        (e_t, c_t), (e_j, c_j) = full.compute_cl(**kw), jfull.compute_cl(**kw)
        npt.assert_array_equal(e_t.numpy(), np.asarray(e_j))
        npt.assert_allclose(c_t.numpy(), np.asarray(c_j),
                            atol=SPEC_TOL * np.abs(np.asarray(c_j)).max())
    assert ("full", lmax, 3) in full._workspace
    q, u = (np.asarray(a) for a in JSS.synfast_spin2(
        jax.random.PRNGKey(0), cl, np.zeros_like(cl), nside, lmax))
    for kw in ({"nbins": 5, "lmax": lmax}, {"decouple": False, "lmax": lmax}):
        got = full.compute_cl_spin2(q, u, **kw)
        want = jfull.compute_cl_spin2(q, u, **kw)
        for g, w in zip(got, want):
            w = np.asarray(w)
            npt.assert_allclose(g.numpy(), w,
                                atol=SPEC_TOL * np.abs(w).max())
    assert ("full-spin2", lmax, 3) in full._workspace

    from astrild_tpu_torch.io import columnar_h5 as TH5
    from astrild_tpu_torch.utils.constants import C_LIGHT_KMS

    th, ph = JH.pix2ang_ring(nside, np.arange(npix))
    vals = np.random.default_rng(1).normal(0, 0.01, npix)
    h5 = str(tmp_path / "rays.h5")
    TH5.write_table(h5, {"the_co": th, "phi_co": ph,
                         "isw_rs": vals * C_LIGHT_KMS ** 2})
    got = SkyNamaster.from_file(h5, quantity="isw_rs", nside=nside,
                                device="cpu")
    want = JSkyNamaster.from_file(h5, quantity="isw_rs", nside=nside)
    assert not got.flat and got.map_file == h5
    npt.assert_allclose(got.data["orig"], want.data["orig"], rtol=1e-6)
    with pytest.raises(ValueError, match="unsupported"):
        SkyNamaster.from_file(str(tmp_path / "map.fits"))
    path = tmp_path / "map.npy"
    np.save(path, _img(9))
    sn = SkyNamaster.from_file(str(path), opening_angle=FOV, device="cpu")
    assert sn.flat and sn.map_file == str(path)
    with pytest.raises(ValueError, match="lmax"):
        sn.compute_cl_spin2(np.zeros((NPIX, NPIX), np.float32),
                            np.zeros((NPIX, NPIX), np.float32), lmax=100)


def test_master_numpy_input_placement():
    """Numpy maps go to `device`, by default the CUDA card (raising
    without one), and the spectra come back on the map's device."""
    img, mask = _img(4), _masks()["edge"]
    if not torch.cuda.is_available():
        for call in (lambda: TA.cl_flat_sky_masked(img, mask, FOV),
                     lambda: TA.cl_flat_sky_master(img, mask, FOV),
                     lambda: SkyNamaster.from_array(
                         img, opening_angle=FOV).compute_cl()):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    ell, cl = TA.cl_flat_sky_master(torch.from_numpy(img), mask, FOV)
    assert ell.device.type == "cpu" and cl.device.type == "cpu"
