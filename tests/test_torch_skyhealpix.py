"""PyTorch port vs JAX package on the CPU: the numpy HEALPix additions
(astrild_tpu_torch/utils/healpix.py against astrild_tpu/utils/healpix.py,
bit for bit), the `SkyHealpix` facade, `SkyNamaster`'s full-sky half and
tests/test_masked_cl_slice.py's flat-sky checks, mirroring
tests/test_healpix.py, tests/test_sht.py's facade tests and the full-sky
tests of tests/test_master.py.

The facade's layers are float32 tensors where the JAX facade keeps
float64 numpy: maps agree within float32 rounding; spectra within 1e-5 of
their max. Random skies come from a `torch.Generator` (another
realization than the JAX key): those tests hold statistics.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.models import skyhealpix as JSHM  # noqa: E402
from astrild_tpu.models.skyhealpix import SkyHealpix as JSH  # noqa: E402
from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu.utils import healpix as JH  # noqa: E402
from astrild_tpu_torch.models import SkyHealpix, SkyNamaster  # noqa: E402
from astrild_tpu_torch.models import skyhealpix as TSHM  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TA  # noqa: E402
from astrild_tpu_torch.ops import map_transform as TMT  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402
from astrild_tpu_torch.utils import healpix as TH  # noqa: E402

NSIDE, LMAX = 16, 24
SPEC_TOL = 1e-5


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


def _close(got, want, tol=SPEC_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=tol * np.abs(want).max())


def _pix_angles(nside):
    return TH.pix2ang_ring(nside, np.arange(TH.nside2npix(nside)))


def _sky_map(nside=NSIDE, seed=0):
    """A smooth polynomial in the unit vector plus noise (float32)."""
    th, ph = _pix_angles(nside)
    v = TH.ang2vec(th, ph)
    rng = np.random.default_rng(seed)
    m = v[:, 2] + 0.5 * v[:, 0] * v[:, 1] + 0.3 * v[:, 0] \
        + 0.05 * rng.standard_normal(th.size)
    return m.astype(np.float32)


# --------------------------------------------------- numpy HEALPix copy
def _points(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    theta[:4] = [0.0, 1e-5, np.pi, np.pi - 1e-5]
    return theta, rng.uniform(-1.0, 7.5, n)


@pytest.mark.parametrize("name", ["ang2vec", "vec2ang", "_ring_info",
                                  "_ring_above", "get_interp_weights",
                                  "get_interp_val", "get_interp_val_nearest",
                                  "euler_matrix_zyx", "rotate_map",
                                  "rotate_map_nearest"])
def test_healpix_copy_bit_for_bit(name):
    nside = 16
    theta, phi = _points()
    m = _sky_map(nside).astype(np.float64)
    R = JH.euler_matrix_zyx(20.0, 10.0, 5.0)
    args = {
        "ang2vec": lambda h: (h.ang2vec(theta, phi),),
        "vec2ang": lambda h: h.vec2ang(JH.ang2vec(theta, phi) * 1.7),
        "_ring_info": lambda h: h._ring_info(nside, np.arange(1, 4 * nside)),
        "_ring_above": lambda h: (h._ring_above(nside, np.cos(theta)),),
        "get_interp_weights": lambda h: h.get_interp_weights(nside, theta,
                                                             phi),
        "get_interp_val": lambda h: (h.get_interp_val(m, theta, phi),),
        "get_interp_val_nearest": lambda h: (
            h.get_interp_val_nearest(m, theta, phi),),
        "euler_matrix_zyx": lambda h: (h.euler_matrix_zyx(20.0, 10.0, 5.0),),
        "rotate_map": lambda h: (h.rotate_map(m, R),),
        "rotate_map_nearest": lambda h: (h.rotate_map(m, R,
                                                      interp="nearest"),),
    }[name]
    for g, w in zip(args(TH), args(JH)):
        assert g.dtype == w.dtype
        npt.assert_array_equal(g, w)
    assert TH.UNSEEN == JH.UNSEEN


def test_interp_weights_sum_to_one_and_in_range():
    nside = 32
    theta, phi = _points(5000)
    pix, wgt = TH.get_interp_weights(nside, theta, phi)
    assert pix.shape == (4, 5000)
    npt.assert_allclose(wgt.sum(0), 1.0, atol=1e-12)
    assert pix.min() >= 0 and pix.max() < TH.nside2npix(nside)
    assert wgt.min() >= 0


def test_interp_exact_at_centres_and_beats_nearest():
    nside = 16
    th, ph = _pix_angles(nside)
    m = np.random.default_rng(4).normal(0, 1, th.size)
    npt.assert_allclose(TH.get_interp_val(m, th, ph), m, atol=1e-10)
    nside = 64
    tc, pc = _pix_angles(nside)

    def f(t, p):
        return np.cos(t) + 0.5 * np.sin(t) * np.cos(p)

    mm = f(tc, pc)
    theta, phi = _points(20000, 5)
    exact = f(theta, phi)
    err_b = np.sqrt(np.mean((TH.get_interp_val(mm, theta, phi) - exact)
                            ** 2))
    err_n = np.sqrt(np.mean((TH.get_interp_val_nearest(mm, theta, phi)
                             - exact) ** 2))
    assert err_b < err_n / 10


def test_vec_ang_roundtrip_and_rotation():
    theta = np.array([0.3, 1.2, 2.8])
    phi = np.array([0.1, 3.0, 5.5])
    t2, p2 = TH.vec2ang(TH.ang2vec(theta, phi))
    npt.assert_allclose(t2, theta, atol=1e-12)
    npt.assert_allclose(p2, phi, atol=1e-12)
    m = np.random.default_rng(1).normal(0, 1, TH.nside2npix(16))
    npt.assert_allclose(TH.rotate_map(m, np.eye(3)), m, atol=1e-9)
    rz = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    npt.assert_allclose(sorted(TH.rotate_map(m, rz, interp="nearest")),
                        sorted(m), atol=1e-12)
    R = TH.euler_matrix_zyx(20.0, 10.0, 0.0)
    npt.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


# ------------------------------------------------------ SkyHealpix facade
def test_sht_backend_dispatch():
    from astrild_tpu_torch.ops import sht_large

    assert TSHM._sht_backend(128, 256)[0] is TS.synfast
    assert TSHM._sht_backend(512, 1024)[0] is sht_large.synfast_large
    with pytest.raises(ValueError):
        TSHM._sht_backend(256, 1024)


def test_from_columns_matches_jax(rng):
    """Per-pixel means equal to the JAX facade's to float32 rounding, empty
    pixels UNSEEN; tests/test_healpix.py's one-pixel case."""
    nside = 8
    n = 50000
    cols = {"the_co": np.arccos(rng.uniform(-1, 1, n)),
            "phi_co": rng.uniform(0, 2 * np.pi, n),
            "kappa_2": rng.normal(0, 1, n)}
    got = SkyHealpix.from_columns(cols, "kappa_2", nside, device="cpu")
    want = JSH.from_columns(cols, "kappa_2", nside)
    npt.assert_array_equal(got.data["orig"].numpy(),
                           want.data["orig"].astype(np.float32))
    one = SkyHealpix.from_dataframe(
        {"the_co": np.full(10, np.pi / 2), "phi_co": np.full(10, 0.1),
         "kappa_2": np.arange(10.0)}, "kappa_2", nside, device="cpu")
    pix = TH.ang2pix_ring(nside, np.pi / 2, 0.1)
    orig = one.data["orig"].numpy()
    npt.assert_allclose(orig[pix], 4.5)
    assert np.sum(orig != np.float32(TH.UNSEEN)) == 1


def test_from_file_h5_npy_and_raises(tmp_path, rng):
    from astrild_tpu_torch.io import columnar_h5
    from astrild_tpu_torch.utils.constants import C_LIGHT_KMS

    th, ph = _pix_angles(NSIDE)
    vals = rng.normal(0, 0.01, th.size)
    p = str(tmp_path / "rays.h5")
    columnar_h5.write_table(p, {"the_co": th, "phi_co": ph,
                                "isw_rs": vals * C_LIGHT_KMS ** 2})
    sky = SkyHealpix.from_file(p, "isw_rs", nside=NSIDE, device="cpu")
    npt.assert_allclose(sky.data["orig"].numpy(), vals, rtol=1e-5,
                        atol=1e-9)
    np.save(tmp_path / "m.npy", vals)
    sky2 = SkyHealpix.from_file(str(tmp_path / "m.npy"), "isw_rs",
                                device="cpu")
    npt.assert_allclose(sky2.data["orig"].numpy(), vals.astype(np.float32))
    with pytest.raises(ValueError):
        SkyHealpix.from_file("map.fits")
    with pytest.raises(ValueError):
        SkyHealpix.from_file(p, "isw_rs")


def test_from_cl_array_and_file(tmp_path):
    """A generator's sky on the table path: its C_ell in the right range,
    the .npz key path the same sky, unknown formats ValueErrors."""
    ell = np.arange(LMAX + 1)
    cl = 1e-2 / (1.0 + ell) ** 2
    sky = SkyHealpix.from_Cl_array(cl, "cmb", NSIDE, rnd_seed=3,
                                   device="cpu")
    assert sky.data["orig"].shape == (TH.nside2npix(NSIDE),)
    cl_m = sky.anafast(LMAX)
    assert isinstance(cl_m, np.ndarray)
    assert 0.3 < cl_m[2:10].mean() / cl[2:10].mean() < 3.0
    np.savez(tmp_path / "cl.npz", tt=cl)
    sky2 = SkyHealpix.from_Cl_file(str(tmp_path / "cl.npz"), "cmb", NSIDE,
                                   key="tt", rnd_seed=3, device="cpu")
    npt.assert_array_equal(sky2.data["orig"].numpy(),
                           sky.data["orig"].numpy())
    with pytest.raises(ValueError):
        SkyHealpix.from_Cl_file("cl.txt", "cmb", NSIDE)
    assert SkyHealpix.create_cmb == SkyHealpix.from_Cl_array


def test_arithmetic_and_mask():
    npix = TH.nside2npix(NSIDE)
    sky = SkyHealpix.from_array(np.full(npix, 2.0), "kappa_2", device="cpu")
    sky.data["b"] = np.full(npix, 3.0)
    sky.sum_of_maps("orig", "b")
    npt.assert_allclose(sky.data["orig_b"].numpy(), 5.0)
    out = sky.arithmetic_operation_with(np.full(npix, 4.0), operation="mul")
    assert isinstance(out, np.ndarray)
    npt.assert_allclose(out, 8.0)
    ones = SkyHealpix.from_array(np.ones(npix), device="cpu")
    out = ones.add_mask(theta_range=(0.0, np.pi / 2))
    th, _ = _pix_angles(NSIDE)
    inside = th <= np.pi / 2
    npt.assert_allclose(out[inside], 1.0)
    assert np.all(out[~inside] == np.float32(TH.UNSEEN))
    want = JSH.from_array(np.ones(npix)).create_mask(theta_range=(0, 1.0),
                                                     phi_range=(1.0, 4.0))
    got = ones.create_mask(theta_range=(0, 1.0), phi_range=(1.0, 4.0))
    npt.assert_array_equal(got, want)


def test_smoothing_matches_jax():
    m = _sky_map()
    got = SkyHealpix(m, device="cpu")
    out = got.smoothing(0.2, lmax=LMAX)
    want = JSH(m).smoothing(0.2, lmax=LMAX)
    assert "orig_smooth" in got.data
    _close(out, want, 1e-6)
    assert np.var(out) < np.var(m)


def test_anafast_shear_and_xi_match_jax():
    """anafast, shear_from_kappa, shear_eb_spectra and shear_xi_pm on one
    kappa map, table path, against the JAX facade."""
    nside, lmax = 32, 48
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl = np.zeros(lmax + 1, np.float32)
    cl[2:] = 1.0 / ell[2:] ** 2
    kappa = np.asarray(JS.synfast(jax.random.PRNGKey(1), cl, nside, lmax))
    got, want = SkyHealpix(kappa, device="cpu"), JSH(kappa)
    _close(got.anafast(lmax), want.anafast(lmax))
    for g, w in zip(got.shear_from_kappa(lmax=lmax),
                    want.shear_from_kappa(lmax=lmax)):
        assert isinstance(g, np.ndarray)
        _close(g, w, 2e-6)
    # BB and EB are the null channels, rounding noise in both packages:
    # each spectrum is held relative to EE's max
    spectra = got.shear_eb_spectra(lmax=lmax)
    jspectra = want.shear_eb_spectra(lmax=lmax)
    for g, w in zip(spectra, jspectra):
        npt.assert_allclose(g, w, atol=SPEC_TOL * np.abs(jspectra[0]).max())
    ee, bb, _ = spectra
    assert bb[2:40].sum() < 1e-3 * ee[2:40].sum()
    theta = np.geomspace(20.0, 600.0, 6)
    for g, w in zip(got.shear_xi_pm(theta, lmax=lmax),
                    want.shear_xi_pm(theta, lmax=lmax)):
        _close(g, w)


def test_scan_path_shear_matches_jax(monkeypatch):
    """tests/test_sht_spin_large.py's forced scan path (a table limit of
    8) on both facades."""
    nside, lmax = 16, 32
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl = np.zeros(lmax + 1, np.float32)
    cl[2:] = 1.0 / ell[2:] ** 2
    kappa = np.asarray(JS.synfast(jax.random.PRNGKey(3), cl, nside, lmax))
    got, want = SkyHealpix(kappa, device="cpu"), JSH(kappa)
    monkeypatch.setattr(TSHM, "_TABLE_LMAX_LIMIT", 8)
    monkeypatch.setattr(JSHM, "_TABLE_LMAX_LIMIT", 8)
    for g, w in zip(got.shear_from_kappa(lmax=lmax),
                    want.shear_from_kappa(lmax=lmax)):
        assert np.all(np.isfinite(g))
        _close(g, w)
    ee, bb, eb = got.shear_eb_spectra(lmax=lmax)
    jspectra = want.shear_eb_spectra(lmax=lmax)
    for g, w in zip((ee, bb, eb), jspectra):
        npt.assert_allclose(g, w, atol=4 * SPEC_TOL
                            * np.abs(jspectra[0]).max())
    assert bb[2:].sum() < 1e-3 * ee[2:].sum()


def test_to_skyarray_and_rotate_match_jax():
    nside = 32
    m = _sky_map(nside)
    got, want = SkyHealpix(m, device="cpu"), JSH(m)
    flat = got.to_skyarray(10.0, 32, center_theta_phi=(np.pi / 2, 1.0))
    jflat = want.to_skyarray(10.0, 32, center_theta_phi=(np.pi / 2, 1.0))
    arr = flat.data["orig"].numpy()
    assert arr.shape == (32, 32) and flat.opening_angle == 10.0
    _close(arr, jflat.data["orig"], 1e-6)
    for rot in ((20.0, 10.0, 0.0), JH.euler_matrix_zyx(5.0, 40.0, 3.0)):
        out = got.rotate(rot)
        _close(out, want.rotate(rot), 1e-6)
        assert "orig_rot" in got.data


def test_from_density_shells_matches_the_born_sum(rng):
    nside = 8
    npix = 12 * nside ** 2
    shells = rng.normal(0, 0.3, (3, npix)).astype(np.float32)
    chis = np.array([500.0, 1000.0, 1500.0])
    dchis = np.full(3, 500.0)
    sky = SkyHealpix.from_density_shells(shells, chis, dchis, 2000.0, 0.3,
                                         device="cpu")
    want = JSH.from_density_shells(shells, chis, dchis, 2000.0, 0.3)
    _close(sky.data["orig"], want.data["orig"], 1e-6)
    pref = 1.5 * 0.3 * (100.0 / 299792.458) ** 2
    g = (2000.0 - chis) * chis / 2000.0
    expect = (pref * g[:, None] * dchis[:, None] * shells).sum(axis=0)
    npt.assert_allclose(sky.data["orig"].numpy(), expect, rtol=1e-5,
                        atol=1e-9)
    assert np.all(np.isfinite(sky.anafast(2 * nside, niter=1)))


def test_unported_paths_raise():
    """Once the item-9 raise of mesh=, now the parity check of
    tests/test_distributed.py:478 on a world of one (gloo, this process):
    SkyHealpix.anafast(mesh=) runs the m-sharded scan path within the JAX
    test's 1e-7 of the local facade's Cl and of the JAX facade's, and
    reuses its cached factory; shear_from_kappa(mesh=) within 1e-5 of the
    shear's std of both; a missing axis raises; a size-1 axis (every axis
    of a world of one) warns; the cache is shared across maps. The
    multi-rank case is tests/test_torch_distributed_sht.py's."""
    import torch.distributed as dist

    from astrild_tpu_torch.parallel import make_mesh

    started = not dist.is_initialized()
    try:
        mesh = make_mesh(1, 1, 1, device="cpu")
        nside, lmax = 16, 31
        cl = np.zeros(lmax + 1)
        cl[2:] = 1.0 / np.arange(2, lmax + 1) ** 2
        jsky = JSH.from_Cl_array(cl, "kappa_2", nside, lmax=lmax, rnd_seed=1)
        sky = SkyHealpix(np.asarray(jsky.data["orig"]), device="cpu")
        want = jsky.anafast(lmax, niter=2)
        with pytest.warns(UserWarning, match="no speedup"):
            got = sky.anafast(lmax, niter=2, mesh=mesh)
        npt.assert_allclose(got, want, atol=1e-7)
        npt.assert_allclose(got, sky.anafast(lmax, niter=2), atol=1e-7)
        n_cached = len(SkyHealpix._dist_sht)
        with pytest.warns(UserWarning, match="no speedup"):
            sky.anafast(lmax, niter=2, mesh=mesh)
        assert len(SkyHealpix._dist_sht) == n_cached
        g1w, g2w = jsky.shear_from_kappa(lmax=lmax, niter=2)
        with pytest.warns(UserWarning, match="no speedup"):
            g1d, g2d = sky.shear_from_kappa(lmax=lmax, niter=2, mesh=mesh)
        scale = max(float(np.std(g1w)), 1e-6)
        npt.assert_allclose(g1d, g1w, atol=1e-5 * scale)
        npt.assert_allclose(g2d, g2w, atol=1e-5 * scale)
        g1l, g2l = sky.shear_from_kappa(lmax=lmax, niter=2)
        npt.assert_allclose(g1d, g1l, atol=1e-5 * scale)
        npt.assert_allclose(g2d, g2l, atol=1e-5 * scale)
        with pytest.raises(ValueError, match="no axis 'rings'"):
            sky.anafast(lmax, mesh=mesh, ax="rings")
        n_cached = len(SkyHealpix._dist_sht)
        sky_b = SkyHealpix(np.asarray(jsky.data["orig"]) * 2, device="cpu")
        with pytest.warns(UserWarning, match="no speedup"):
            sky_b.anafast(lmax, niter=2, mesh=mesh)
        assert len(SkyHealpix._dist_sht) == n_cached  # shared across maps
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_lens_cmb_by_deflection_matches_jax():
    """The remap of an absolute-units map (monopole 2.7 plus 1e-5
    fluctuations): the monopole split off in float64 keeps the
    fluctuations' precision; 99% of the JAX facade's samples within 1e-5 of
    the fluctuations' max (measured 2.4e-6: an ulp of a sample position
    moves its weights by ~4e-6 at nside 16), 'cmb_lensed' stored."""
    rng = np.random.default_rng(4)
    nside = 16
    npix = TH.nside2npix(nside)
    cmb = 2.7255 + 1e-5 * rng.standard_normal(npix)
    a_t = (1e-3 * rng.standard_normal(npix)).astype(np.float32)
    a_p = (1e-3 * rng.standard_normal(npix)).astype(np.float32)
    sky = SkyHealpix(np.zeros(npix), device="cpu")
    got = sky.lens_cmb_by_deflection(cmb, torch.from_numpy(a_t),
                                     torch.from_numpy(a_p))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert sky.data["cmb_lensed"].dtype == torch.float64
    want = JSH.from_array(np.zeros(npix)).lens_cmb_by_deflection(cmb, a_t,
                                                                 a_p)
    fluct = np.abs(cmb - cmb.mean()).max()
    # >= 99.9% of the samples: a float32 stencil decision can flip a
    # neighbour at the rest (tests/test_torch_healpix.py)
    assert np.mean(np.abs(got - want) < 2e-3 * fluct) >= 0.999
    assert np.quantile(np.abs(got - want), 0.99) < 1e-5 * fluct
    assert abs(got.mean() - cmb.mean()) < 1e-6


@pytest.mark.parametrize("lmax", [16, 40])
def test_lens_cmb_from_kappa_matches_jax(lmax):
    """kappa -> deflection -> remap at lmax 2 nside (the plain adjoint) and
    beyond it (the scan path's CG), against the JAX facade; a zero kappa
    returns the map within the remap nudge's shift."""
    rng = np.random.default_rng(8)
    nside = 16
    npix = TH.nside2npix(nside)
    theta, _ = TH.pix2ang_ring(nside, np.arange(npix))
    cmb = np.cos(3 * theta) + 0.1 * np.sin(5 * theta)
    kap = (0.01 * np.cos(theta) + 1e-3 * rng.standard_normal(npix)).astype(
        np.float32)
    sky = SkyHealpix(np.zeros(npix), device="cpu")
    got = sky.lens_cmb_from_kappa(cmb, kap, lmax=lmax)
    want = JSH.from_array(np.zeros(npix)).lens_cmb_from_kappa(cmb, kap,
                                                              lmax=lmax)
    npt.assert_allclose(got, want, atol=2e-5)
    still = sky.lens_cmb_from_kappa(cmb, np.zeros(npix, np.float32),
                                    lmax=lmax)
    npt.assert_allclose(still, cmb, atol=5e-3)


def test_from_multiplane_shells_matches_jax():
    rng = np.random.default_rng(2)
    nside = 8
    shells = rng.normal(0, 0.3, (2, TH.nside2npix(nside))).astype(
        np.float32)
    chis = np.array([300.0, 600.0], np.float32)
    dchis = np.full(2, 150.0, np.float32)
    sky = SkyHealpix.from_multiplane_shells(shells, chis, dchis, 800.0, 0.3,
                                            lmax=16, quantity="kappa_ray",
                                            device="cpu")
    want = JSH.from_multiplane_shells(shells, chis, dchis, 800.0, 0.3,
                                      lmax=16, quantity="kappa_ray")
    assert sky.quantity == want.quantity == "kappa_ray"
    for k in ("orig", "gamma1", "gamma2", "omega"):
        assert sky.data[k].device.type == "cpu"
        npt.assert_allclose(sky.data[k].numpy(), want.data[k], atol=5e-7)
    with pytest.raises(ValueError, match="scalar chi_s"):
        SkyHealpix.from_multiplane_shells(shells, chis, dchis,
                                          [500.0, 800.0], 0.3,
                                          device="cpu")


def test_numpy_input_placement():
    m = _sky_map(8)
    if not torch.cuda.is_available():
        for call in (lambda: SkyHealpix(m),
                     lambda: SkyHealpix.from_Cl_array(np.ones(9), "k", 8)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    sky = SkyHealpix(torch.from_numpy(m))
    assert sky.device.type == "cpu"
    assert sky.to_skyarray(5.0, 8).data["orig"].device.type == "cpu"


# ------------------------------------------------ SkyNamaster, full sky
def test_skynamaster_full_sky_nan_mask():
    """tests/test_master.py's full-sky facade case: NaN pixels become the
    mask, compute_cl gives finite band powers, cached on the second call;
    the JAX facade's within 1e-5 of their max."""
    nside = 16
    m = np.array(JS.synfast(jax.random.PRNGKey(6), jnp.ones(21) * 1e-3,
                            nside, 20))
    m[: m.shape[0] // 4] = np.nan
    sf = SkyNamaster.from_array(m, device="cpu")
    assert "mask" in sf.data and sf.data["mask"].sum() < m.shape[0]
    ellf, clf = sf.compute_cl(lmax=20, nbins=5)
    assert np.all(np.isfinite(clf.numpy())) and ellf.shape == (5,)
    _, clf2 = sf.compute_cl(lmax=20, nbins=5)
    npt.assert_array_equal(clf2.numpy(), clf.numpy())
    _close(clf, SkyNamaster_jax(m).compute_cl(lmax=20, nbins=5)[1])


def SkyNamaster_jax(m):
    from astrild_tpu.models import SkyNamaster as JSN

    return JSN.from_array(m)


def test_skynamaster_unit_mask_analytic_wl():
    """A maskless full-sky map takes the exact unit-mask spectrum: its
    decoupled spectrum is the binned plain anafast within 2%."""
    nside, lmax, nb = 16, 31, 5
    cl = np.zeros(lmax + 1, np.float32)
    cl[2:] = 1.0 / np.arange(2, lmax + 1) ** 2
    m = np.asarray(JS.synfast(jax.random.PRNGKey(0), cl, nside, lmax))
    sn = SkyNamaster.from_array(m, device="cpu")
    ell_b, cl_hat = sn.compute_cl(lmax=lmax, nbins=nb)
    ref = TS.anafast(m, lmax, device="cpu").numpy()
    B = TS._bin_operator(lmax, nb, lmin=2)
    npt.assert_allclose(cl_hat.numpy(), B @ ref, rtol=2e-2)
    wl = sn._mask_cl(np.ones(12 * nside ** 2), 2 * lmax, 3, "cpu")
    assert wl[0] == 4.0 * np.pi and not wl[1:].any()


def test_fullsky_coupling_identity():
    nside, lmax = 16, 20
    wl = TS.anafast(torch.ones(TH.nside2npix(nside)), 2 * lmax)
    M = TS.coupling_matrix_from_mask_cl(wl.numpy(), lmax)
    npt.assert_allclose(M, np.eye(lmax + 1), atol=2e-3)


def test_fullsky_master_unbiased_belt_mask():
    """tests/test_master.py's apodized galactic-belt case (slow there) on
    its 24 realizations (the JAX package's draws of PRNGKey(100 + r)):
    MASTER within 5% of the unmasked band powers where the <w^2>
    pseudo-Cl is over 8% biased."""
    nside, lmax, nbins = 32, 40, 8
    th, _ = _pix_angles(nside)
    c = np.abs(np.cos(th))
    w = np.clip((c - 0.15) / 0.25, 0.0, 1.0)
    w = (w * w * (3.0 - 2.0 * w)).astype(np.float32)
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_in = 1.0 / np.maximum(ell * (ell + 1.0), 1.0)
    cl_in[:2] = 0.0
    tab = TS.sht_tables(nside, lmax, device="cpu")
    wl = TS.anafast(w, 2 * lmax, device="cpu").numpy()
    coup = TS.coupling_matrix_from_mask_cl(wl, lmax)
    B = TS._bin_operator(lmax, nbins, lmin=2)
    cl_true, cl_w2, cl_ms = [], [], []
    for r in range(24):
        white = [np.asarray(jax.random.normal(k, (lmax + 1, lmax + 1)))
                 for k in jax.random.split(jax.random.PRNGKey(100 + r))]
        m = TS.synfast_from_white(*white, cl_in, nside, lmax, tables=tab)
        cl_true.append(TS.anafast(m, lmax, tables=tab).numpy())
        cl_w2.append(TS.anafast_masked(m, w, lmax, tables=tab).numpy())
        cl_ms.append(TS.anafast_master(m, w, lmax, nbins=nbins, tables=tab,
                                       coupling=coup)[1].numpy())
    tb = B @ np.mean(cl_true, 0)
    bias_w2 = np.abs(B @ np.mean(cl_w2, 0) / tb - 1.0)
    err_ms = np.abs(np.mean(cl_ms, 0) / tb - 1.0)
    assert bias_w2.max() > 0.08, bias_w2
    assert err_ms.max() < 0.05, (err_ms, bias_w2)


def test_fullsky_spin2_master_unbiased_and_b_null():
    """tests/test_master.py's belt-masked E-only case on 20 generator
    realizations: the pseudo spectra leak E -> B and bias EE, the 2x2
    MASTER solve recovers EE within 6% and nulls BB below 2.5%."""
    nside, lmax, nb = 16, 31, 5
    npix = 12 * nside * nside
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_ee = np.zeros(lmax + 1)
    cl_ee[2:] = 1.0 / ell[2:] ** 2
    th, _ = _pix_angles(nside)
    mask = ((th < 1.2) | (th > 1.9)).astype(np.float32)
    wl = TS.anafast(mask, 2 * lmax, device="cpu").numpy()
    coup = TSS.spin2_coupling_matrices_from_mask_cl(wl, lmax)
    w2 = float((mask ** 2).mean())
    gen = torch.Generator().manual_seed(0)
    tab = TSS.spin2_tables(nside, lmax, device="cpu")
    ee_t, pee, pbb, ee_m, bb_m = [], [], [], [], []
    for _ in range(20):
        q, u = TSS.synfast_spin2(gen, cl_ee, np.zeros(lmax + 1), nside,
                                 lmax, tables=tab)
        ee_t.append(TSS.anafast_spin2(q, u, lmax, tables=tab)[0].numpy())
        pe, pb, _ = TSS.anafast_spin2(q * torch.from_numpy(mask),
                                      u * torch.from_numpy(mask), lmax,
                                      tables=tab)
        pee.append(pe.numpy() / w2)
        pbb.append(pb.numpy() / w2)
        _, me, mb = TSS.anafast_spin2_master(q, u, mask, lmax, nbins=nb,
                                             coupling=coup)
        ee_m.append(me.numpy())
        bb_m.append(mb.numpy())
    assert npix == q.shape[0]
    B = TS._bin_operator(lmax, nb, lmin=2)
    ee_t_b = B @ np.mean(ee_t, 0)
    leak = (B @ np.mean(pbb, 0)) / ee_t_b
    assert np.all(leak[:3] > 0.04), leak
    assert abs((B @ np.mean(pee, 0))[0] / ee_t_b[0] - 1.0) > 0.15
    npt.assert_allclose(np.mean(ee_m, 0) / ee_t_b, 1.0, atol=0.06)
    assert np.all(np.abs(np.mean(bb_m, 0) / ee_t_b) < 0.025)


def test_skynamaster_spin2_full_sky_caches():
    nside, lmax = 16, 31
    npix = 12 * nside * nside
    ellv = np.arange(lmax + 1, dtype=np.float64)
    cl_ee = np.zeros(lmax + 1)
    cl_ee[2:] = 1.0 / ellv[2:] ** 2
    q, u = TSS.synfast_spin2(torch.Generator().manual_seed(0), cl_ee,
                             np.zeros(lmax + 1), nside, lmax)
    th, _ = _pix_angles(nside)
    snf = SkyNamaster.from_array(np.zeros(npix, np.float32), device="cpu")
    snf.set_mask((th < 1.9).astype(np.float64))
    ell_f, ee_f, bb_f = snf.compute_cl_spin2(q, u, nbins=5, lmax=lmax)
    assert ("full-spin2", lmax, 3) in snf._workspace
    assert np.all(np.isfinite(ee_f.numpy()))
    assert ee_f.shape == (5,) and bb_f.shape == (5,)


# ------------------------------------ tests/test_masked_cl_slice.py twins
def test_masked_cl_recovers_unmasked(rng):
    n = 128
    img = rng.normal(0, 1, (n, n)).astype(np.float32)
    _, cl_full = TA.cl_flat_sky(img, 5.0, nbins=8, device="cpu")
    mask = np.ones((n, n), np.float32)
    mask[:, n // 2:] = 0.0
    _, cl_masked = TA.cl_flat_sky_masked(img, mask, 5.0, nbins=8,
                                         device="cpu")
    npt.assert_allclose(cl_masked.numpy(), cl_full.numpy(), rtol=0.25)
    _, cl1 = TA.cl_flat_sky_masked(img, mask, 5.0, nbins=8,
                                   apodize_arcmin=10.0, device="cpu")
    assert np.all(np.isfinite(cl1.numpy()))
    npt.assert_allclose(cl1.numpy()[2:], cl_masked.numpy()[2:], rtol=0.5)


def test_slice_map_mean_of_slab():
    pos = np.array([[10.0, 10.0, 50.0], [10.0, 10.0, 52.0],
                    [10.0, 10.0, 5.0]], np.float32)
    vals = np.array([1.0, 3.0, 100.0], np.float32)
    m = TMT.slice_map(pos, vals, 4, 100.0, axis=2, slab_center=50.0,
                      slab_width=10.0, device="cpu")
    npt.assert_allclose(float(m[0, 0]), 2.0)
    npt.assert_allclose(float(torch.sum(m)), 2.0)
