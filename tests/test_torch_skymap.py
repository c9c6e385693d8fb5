"""PyTorch port vs JAX package on the CPU: the `SkyArray` / `SkyMap` facade
(astrild_tpu_torch/models/skymap.py), the lensing additions it needs
(`kappa_to_phi`, `_grad_axis`, `alpha_to_gamma`, `code_to_phy_units_factor`
in ops/lensing.py) and the ray-column copy io/rays.py.

Inputs are made with numpy from a seed and handed to both packages. Host
copies are held bit for bit, float32 maps within 1e-5 of the largest
value; each tolerance is stated where it is checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.io import rays as JR  # noqa: E402
from astrild_tpu.models.skymap import SkyArray as JSky  # noqa: E402
from astrild_tpu.ops import angular_power as JAP  # noqa: E402
from astrild_tpu.ops import lensing as JL  # noqa: E402
from astrild_tpu_torch.io import rays as TR  # noqa: E402
from astrild_tpu_torch.models import SkyArray, SkyMap  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TAP  # noqa: E402
from astrild_tpu_torch.ops import lensing as TL  # noqa: E402

MAP_TOL = 1e-5  # float32 maps: of the largest |value|


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


def _close(got, want, tol=MAP_TOL, scale=None):
    """|got - want| <= tol * max|want| (NaN where want is NaN)."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    s = np.abs(want[ok]).max() if scale is None else scale
    npt.assert_allclose(got[ok], want[ok], rtol=0, atol=tol * s)


def _kappa(n=128, oa=5.0, key=0, l0=500.0):
    """A band-limited Gaussian kappa map from the JAX package (the JAX
    facade test's recipe), as numpy."""
    ells = np.concatenate([np.arange(2.0, 1000.0), [1010.0, 40000.0]])
    cl = 1e-8 / (1.0 + (ells / l0) ** 2) ** 1.5
    cl[-2:] = 0.0
    kap = JAP.cl_to_flat_map(jax.random.PRNGKey(key),
                             jnp.asarray(ells, jnp.float32),
                             jnp.asarray(cl, jnp.float32), n, oa)
    return np.asarray(kap), ells, cl


# ------------------------------------------------------------ lensing ops
@pytest.mark.parametrize("n, pad", [(64, 4), (48, 2)])
def test_kappa_to_phi_matches_jax(n, pad):
    """phi within 1e-5 of max |phi| (a padded full-FFT Poisson solve)."""
    kap = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32)
    want = JL.kappa_to_phi(jnp.asarray(kap), 0.02, padding_factor=pad)
    got = TL.kappa_to_phi(torch.from_numpy(kap), 0.02, padding_factor=pad)
    assert got.shape == (n, n)
    _close(got, want)


@pytest.mark.parametrize("axis", [0, 1])
def test_grad_axis_matches_jax(axis):
    """The roll form with one-sided edge rows, ds a float32 tensor:
    within 2 ulp-scale (1e-6) of max |grad| (the JAX package's own float32
    order); the edge rows bit for bit."""
    a = np.random.default_rng(axis).normal(size=(32, 40)).astype(np.float32)
    ds = np.float32(0.01) / np.float32(40.0)
    want = np.asarray(JL._grad_axis(jnp.asarray(a), jnp.float32(ds), axis))
    got = TL._grad_axis(torch.from_numpy(a), torch.tensor(ds), axis).numpy()
    _close(got, want, tol=1e-6)
    edge = np.s_[[0, -1], :] if axis == 0 else np.s_[:, [0, -1]]
    npt.assert_array_equal(got[edge], want[edge])


def test_alpha_to_gamma_matches_jax():
    """Shear from deflection within 1e-5 of max |gamma|; the chain kappa ->
    alpha -> gamma likewise."""
    n, oa = 64, np.deg2rad(2.0)
    kap = np.random.default_rng(1).normal(size=(n, n)).astype(np.float32)
    a_j = JL.kappa_to_alpha(jnp.asarray(kap) * 0.01, oa)
    a_t = TL.kappa_to_alpha(torch.from_numpy(kap) * 0.01, oa)
    for g, w in zip(a_t, a_j):
        _close(g, w)
    want = JL.alpha_to_gamma(*a_j, oa)
    got = TL.alpha_to_gamma(*a_t, oa)
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w in zip(got, want):
        _close(g, w, scale=scale)


def test_alpha_to_gamma_shapes_and_symmetry():
    """tests/test_lensing.py's test on the port: shapes and finiteness."""
    n = 64
    kappa = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (n, n)) * 0.01))
    a1, a2 = TL.kappa_to_alpha(kappa, 1.0)
    g1, g2 = TL.alpha_to_gamma(a1, a2, 1.0)
    assert g1.shape == (n, n) and g2.shape == (n, n)
    assert bool(torch.isfinite(g1).all()) and bool(torch.isfinite(g2).all())


def test_kappa_to_gamma_matches_alpha_gradient_chain():
    """tests/test_lensing.py's test on the port: direct spectral shear ==
    kappa_to_alpha + alpha_to_gamma in the interior (2e-3 of max kappa),
    and the exact spin-2 factor on a plane wave (atol 1e-4)."""
    n, oa = 128, 1.0
    e = (torch.arange(n) + 0.5) / n - 0.5
    r2 = e[:, None] ** 2 + e[None, :] ** 2
    kappa = torch.exp(-r2 / (2 * 0.07 ** 2))
    g1, g2 = TL.kappa_to_gamma(kappa, oa, padding_factor=4)
    a1, a2 = TL.kappa_to_alpha(kappa, oa, padding_factor=4)
    g1c, g2c = TL.alpha_to_gamma(a1, a2, oa)
    sl = np.s_[8:-8, 8:-8]
    scale = float(kappa.abs().max())
    npt.assert_allclose(g1.numpy()[sl], g1c.numpy()[sl], atol=2e-3 * scale)
    npt.assert_allclose(g2.numpy()[sl], g2c.numpy()[sl], atol=2e-3 * scale)
    kx_i, ky_i = 3, 5
    ph = 2.0 * np.pi * (kx_i * torch.arange(n)[:, None]
                        + ky_i * torch.arange(n)[None, :]) / n
    kw = torch.cos(ph).to(torch.float32)
    gw1, gw2 = TL.kappa_to_gamma(kw, oa, padding_factor=1)
    fac = (kx_i ** 2 - ky_i ** 2) / (kx_i ** 2 + ky_i ** 2)
    fac2 = 2.0 * kx_i * ky_i / (kx_i ** 2 + ky_i ** 2)
    npt.assert_allclose(gw1.numpy(), fac * kw.numpy(), atol=1e-4)
    npt.assert_allclose(gw2.numpy(), fac2 * kw.numpy(), atol=1e-4)


def test_units_and_rays_copies_bit_identical():
    """code_to_phy_units_factor, SHEAR_CORRECTIONS and rays_to_map (sorted
    by id, with units) equal the JAX package's."""
    for q in ("shear_x", "kappa_2", "isw_rs", "other"):
        assert TL.code_to_phy_units_factor(q) == \
            JL.code_to_phy_units_factor(q)
    assert TR.SHEAR_CORRECTIONS == JR.SHEAR_CORRECTIONS
    rng = np.random.default_rng(3)
    vals = rng.normal(size=256)
    ids = rng.permutation(256)
    for q in (None, "shear_x", "kappa_2"):
        npt.assert_array_equal(TR.rays_to_map(vals, ids, quantity=q),
                               JR.rays_to_map(vals, ids, quantity=q))
    with pytest.raises(ValueError, match="not a square"):
        TR.rays_to_map(np.ones(10))


# ------------------------------------------------------------- SkyArray
def _both(n=128, oa=5.0, key=0):
    kap, ells, cl = _kappa(n, oa, key)
    return (JSky.from_array(kap, oa, "kappa_2"),
            SkyArray.from_array(kap, oa, "kappa_2", device="cpu"), ells, cl)


def test_skyarray_lensing_conversions_match_jax():
    """kappa -> alpha -> gamma and kappa -> gamma through the facade:
    every layer within 1e-5 of max |layer|."""
    sj, st, _, _ = _both()
    for g, w in zip(st.convert_convergence_to_deflection(),
                    sj.convert_convergence_to_deflection()):
        _close(g, w)
    for g, w in zip(st.convert_deflection_to_shear(),
                    sj.convert_deflection_to_shear()):
        _close(g, w)
    for g, w in zip(st.convert_convergence_to_shear(),
                    sj.convert_convergence_to_shear()):
        _close(g, w)
    assert set(st.data) == set(sj.data)


def test_skyarray_facade_xi_and_cosebis():
    """The JAX facade test on the port (xi+ > 0 in the first four bins,
    |B| < 5% of max |E|, E_1 > 0), and xi_pm / COSEBIs against the JAX
    facade on the same map: counts equal, xi within 1e-5 of max |xi+|,
    E and B within 1e-5 of max |E|."""
    sj, st, _, _ = _both(256, 5.0)
    sj.convert_convergence_to_deflection()
    sj.convert_deflection_to_shear()
    st.convert_convergence_to_deflection()
    st.convert_deflection_to_shear()
    th, xp, xm, npair = st.shear_xi_pm(nbins=10, theta_min_arcmin=2,
                                       theta_max_arcmin=100)
    assert np.all(xp.numpy()[:4] > 0)
    want = sj.shear_xi_pm(nbins=10, theta_min_arcmin=2, theta_max_arcmin=100)
    npt.assert_array_equal(npair.numpy(), np.asarray(want[3]))
    scale = float(np.nanmax(np.abs(np.asarray(want[1]))))
    _close(xp, want[1], scale=scale)
    _close(xm, want[2], scale=scale)
    E, B = st.cosebis(4, 3.0, 90.0)
    assert float(B.abs().max()) < 0.05 * float(E.abs().max())
    assert float(E[0]) > 0
    Ej, Bj = sj.cosebis(4, 3.0, 90.0)
    escale = float(np.abs(np.asarray(Ej)).max())
    _close(E, Ej, scale=escale)
    _close(B, Bj, scale=escale)


@pytest.mark.parametrize("interval", [(3.0, 150.0), (0.02, 0.08)])
def test_cosebis_facade_coverage_guard(interval):
    """theta_max at the half box, or a sub-pixel interval with no annulus:
    the informative ValueError of the JAX facade."""
    rng = np.random.default_rng(0)
    sa = SkyArray.from_array(rng.normal(size=(128, 128)).astype(np.float32),
                             5.0, "kappa_2", device="cpu")
    sa.data["shearx"] = torch.from_numpy(
        rng.normal(size=(128, 128)).astype(np.float32))
    sa.data["sheary"] = rng.normal(size=(128, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="coverable"):
        sa.cosebis(3, *interval)


def test_skyarray_analysis_and_transforms_match_jax(tmp_path):
    """pdf bit for bit; peak counts (percentile limits and given limits)
    equal, bin centres within 1e-6 of the largest; resize up and down
    within 1e-5 of max (the antialiased linear resize); crop, division,
    merge and substract_mean equal (the mean to 1e-5 of max); to_file
    round trip."""
    sj, st, _, _ = _both(64, 3.0, key=2)
    for nb in (10, 33):
        gp, wp = st.pdf(nb), sj.pdf(nb)
        npt.assert_array_equal(gp["bins"], wp["bins"])
        npt.assert_array_equal(gp["values"], wp["values"])
    for kw in ({}, {"field_conversion": "normalize"},
               {"limits": (-0.01, 0.02)}):
        gpk, wpk = st.wl_peak_counts(12, **kw), sj.wl_peak_counts(12, **kw)
        _close(gpk["kappa"], wpk["kappa"], tol=1e-6)
        npt.assert_array_equal(gpk["counts"], wpk["counts"])
    for npix in (128, 48, 32):
        _close(st.resize(npix, rtn=True), sj.resize(npix, rtn=True))
    for lim in (([4, 36], [8, 40]), ([10.0, 60.0], [20.0, 70.0])):
        npt.assert_array_equal(st.crop(*lim, rtn=True).numpy(),
                               np.asarray(sj.crop(*lim, rtn=True)))
    tiles_t, tiles_j = st.division(4), sj.division(4)
    npt.assert_array_equal(tiles_t.numpy(), np.asarray(tiles_j))
    npt.assert_array_equal(SkyArray.merge(tiles_t).numpy(),
                           np.asarray(JSky.merge(tiles_j)))
    _close(st.substract_mean(rtn=True), sj.substract_mean(rtn=True))
    st.crop([8, 40], [8, 40])
    sj.crop([8, 40], [8, 40])
    assert st.opening_angle == sj.opening_angle and st.npix == 32
    fname = st.to_file(str(tmp_path))
    npt.assert_array_equal(np.load(fname), st.data["orig"].numpy())
    back = SkyArray.from_file(fname, st.opening_angle, device="cpu")
    assert torch.equal(back.data["orig"], st.data["orig"])


def test_skyarray_noise_and_cmb_layers():
    """Shape noise: std_pix = sigma_e / sqrt(2 n A_pix) (to 5%, 64^2
    pixels), the same seed gives the same layer, a kappa map takes it and
    a shear quantity refuses; the CMB layer: real, its C_ell within 20% of
    the table in bands of >= 1000 modes, add_cmb adds it (overwrite or a
    new layer) and takes a precomputed map."""
    sa = SkyArray.from_array(np.zeros((64, 64), np.float32), 2.0, "kappa_2",
                             device="cpu")
    std_pix = np.sqrt(0.3 ** 2 / (2.0 * (120.0 / 64) ** 2 * 30.0))
    gsn = sa.create_galaxy_shape_noise(0.3, 30.0, rnd_seed=4)
    npt.assert_allclose(float(gsn.std()), std_pix, rtol=0.05)
    assert torch.equal(gsn, SkyArray.from_array(
        np.zeros((64, 64)), 2.0, device="cpu").create_galaxy_shape_noise(
            0.3, 30.0, rnd_seed=4))
    assert torch.equal(sa.add_galaxy_shape_noise(), gsn)
    shear = SkyArray.from_array(np.zeros((8, 8)), 1.0, "shear_x",
                                device="cpu")
    shear.create_galaxy_shape_noise(0.3, 30.0)
    with pytest.raises(ValueError, match="GSN"):
        shear.add_galaxy_shape_noise()
    n, oa = 128, 2.0
    ells = np.concatenate([np.arange(2.0, 12000.0), [12010.0, 40000.0]])
    cl = 1e-8 / (1 + (ells / 3000.0) ** 2) ** 1.5
    cl[-2:] = 0.0
    sky = SkyArray.from_array(np.zeros((n, n), np.float32), oa, "kappa_2",
                              device="cpu")
    cmb = sky.create_cmb(ells, cl, rnd_seed=3)
    kw = dict(nbins=8, ell_min=3000.0, ell_max=10000.0)
    ell_b, cl_b = TAP.cl_flat_sky(cmb, oa, **kw)
    _, nm = TAP.flat_sky_mode_counts(n, oa, device="cpu", **kw)
    sel = nm.numpy() >= 1000
    assert sel.sum() >= 3
    npt.assert_allclose(cl_b.numpy()[sel],
                        np.interp(ell_b.numpy(), ells, cl)[sel], rtol=0.2)
    out = sky.add_cmb(overwrite=False)
    assert torch.equal(out, cmb) and "orig_cmb" in sky.data
    other = SkyArray.from_array(np.ones((n, n), np.float32), oa,
                                device="cpu")
    other.data["cmb"] = cmb.numpy()
    assert torch.equal(other.add_cmb(), 1.0 + cmb)
    with pytest.raises(ValueError, match="filepath"):
        SkyArray.from_array(np.ones((4, 4)), 1.0, device="cpu").add_cmb()


def test_skyarray_from_density_planes_match_jax():
    """Born and ray-traced maps of three random planes, scalar and
    tomographic sources: the Born map within 1e-5 of its max; the
    ray-traced layers within 1e-4 of kappa's max (the bar of
    tests/test_torch_lightcone.py: omega is a difference of nearly equal
    terms)."""
    rng = np.random.default_rng(7)
    planes = rng.normal(size=(3, 32, 32)).astype(np.float32)
    chis = np.array([300.0, 600.0, 900.0], np.float32)
    dchis = np.full(3, 300.0, np.float32)
    for method in ("born", "raytrace"):
        for chi_s in (1000.0, np.array([700.0, 1000.0], np.float32)):
            want = JSky.from_density_planes(planes, chis, dchis, chi_s, 0.3,
                                            2.0, method=method)
            got = SkyArray.from_density_planes(planes, chis, dchis, chi_s,
                                               0.3, 2.0, method=method,
                                               device="cpu")
            if np.ndim(chi_s):
                assert len(got) == len(want) == 2
            else:
                got, want = [got], [want]
            for g, w in zip(got, want):
                assert set(g.data) == set(w.data)
                kscale = float(np.abs(np.asarray(w.data["orig"])).max())
                for name in w.data:
                    if method == "born":
                        _close(g.data[name], w.data[name])
                    else:
                        _close(g.data[name], w.data[name], tol=1e-4,
                               scale=kscale)
    with pytest.raises(ValueError, match="method"):
        SkyArray.from_density_planes(planes, chis, dchis, 1000.0, 0.3, 2.0,
                                     method="nope", device="cpu")


def test_skyarray_from_columns_and_files_match_jax(tmp_path):
    """Ray columns (shuffled ids, units), an h5 table and an npy file give
    the JAX facade's maps (float32 of the same float64 map, equal); the
    SkyMap facade dispatches to them."""
    from astrild_tpu.io import columnar_h5 as JH5

    pytest.importorskip("h5py")
    rng = np.random.default_rng(9)
    cols = {"id": rng.permutation(1024), "kappa_2": rng.normal(size=1024)}
    want = JSky.from_columns(cols, 1.0, "kappa_2")
    got = SkyArray.from_columns(cols, 1.0, "kappa_2", device="cpu")
    npt.assert_array_equal(got.data["orig"].numpy(),
                           np.asarray(want.data["orig"]))
    assert SkyArray.from_dataframe is SkyArray.from_columns.__func__ or \
        SkyArray.from_dataframe.__func__ is SkyArray.from_columns.__func__
    path = str(tmp_path / "rays.h5")
    JH5.write_table(path, cols)
    g5 = SkyArray.from_file(path, 1.0, "kappa_2", device="cpu")
    assert torch.equal(g5.data["orig"], got.data["orig"])
    assert g5.map_file == path
    npy = str(tmp_path / "map.npy")
    np.save(npy, rng.normal(size=(16, 16)))
    via = SkyMap.from_file(16, 1.0, "kappa_2", str(tmp_path), npy,
                           device="cpu")
    npt.assert_array_equal(via.data["orig"].numpy(),
                           np.asarray(JSky.from_file(npy, 1.0)
                                      .data["orig"]))
    assert SkyMap.from_array(np.ones((4, 4)), 1.0, "kappa_2",
                             device="cpu").npix == 4
    assert torch.equal(SkyMap.from_dataframe(cols, 1.0, "kappa_2",
                                             device="cpu").data["orig"],
                       got.data["orig"])
    with pytest.raises(ValueError, match="extension"):
        SkyArray.from_file("map.fits", 1.0, device="cpu")


def test_unported_methods_raise_naming_their_item():
    # the NFW halo constructors are ported (tests/test_torch_moving_lens.py
    # holds them against JAX): each runs, and an unknown signal raises
    # ValueError, as in the JAX package
    halo = {"r200_deg": 0.1, "m200": 5e14, "c_NFW": 6.0, "Dc": 1200.0,
            "theta1_tv": 300.0, "theta2_tv": -200.0, "v_los": 400.0}
    cat = {k: np.array([v, v]) for k, v in halo.items()}
    cat.update(theta1_pix=np.array([10, 20]), theta2_pix=np.array([12, 5]),
               r200_pix=np.array([4.0, 4.0]))
    calls = {
        "from_halo_series": lambda: SkyArray.from_halo_series(
            halo, 9, 1.0, [0, 1], False, 1.0, device="cpu"),
        "from_halo_dataframe": lambda: SkyArray.from_halo_dataframe(
            cat, 32, 1.0, [0, 1], False, 1.0, patch_npix=9, device="cpu"),
        "nfw temperature map": lambda: SkyArray.
        from_halo_catalogue_to_temperature_perturbation_map(
            cat, npix=32, opening_angle=2.0, patch_npix=9, device="cpu"),
    }
    for name, fn in calls.items():
        sky = fn()
        img = sky.data["orig"].numpy()
        assert np.isfinite(img).all() and np.abs(img).max() > 0, name
    assert sky.opening_angle == 2.0 and sky.quantity == "rs"
    with pytest.raises(ValueError, match="unknown signal"):
        SkyArray.from_halo_series(halo, 9, 1.0, [0, 1], False, 1.0,
                                  to="isw", device="cpu")


def test_skyarray_numpy_input_placement(monkeypatch):
    """Numpy maps land on `device=`; without a card and without `device`
    the facade raises; a tensor keeps its device."""
    arr = np.ones((8, 8), np.float32)
    assert SkyArray.from_array(arr, 1.0, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        SkyArray.from_array(arr, 1.0)
    assert SkyArray.from_array(torch.ones(8, 8), 1.0).device.type == "cpu"
