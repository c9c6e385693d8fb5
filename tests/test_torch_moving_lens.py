"""PyTorch port vs JAX package on the CPU: the moving-lens path. The NFW
deflection and moving-lens temperature patches (`ops/lensing.py`), the
halo-patch painting, the SkyArray halo constructors and `Dipoles`
(detection, matching, both transverse-velocity estimators).

Inputs are made with numpy and handed to both packages; each tolerance is
stated where it is checked. The NFW patches agree to 5e-5 of their
largest value (torch's and XLA's float32 transcendental functions differ
in the last ulp, and the JAX package's branch cuts at x = 0.999 / 1.001
turn that into a small jump), but for the pixels within 1e-3 scale radii
of a halo's centre: there the JAX package's g(x) = -ln 2 + log1p(s)/s + ...
is float32 cancellation noise (the true g, ~x^2 ln x, lies below the
rounding of ln 2), which decides the |alpha| > 100 clip as well. The patch
edges and the r = 0 pixel agree exactly, the clip's zero set outside
those pixels too; painting agrees bit for bit on the CPU.
The dipole estimators' sums run in another order than XLA's reductions:
velocities agree to rtol 1e-4, and the float32 ring decision of the
aperture photometry exactly.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.models import dipoles as JD  # noqa: E402
from astrild_tpu.models import skymap as JSM  # noqa: E402
from astrild_tpu.ops import filters as JF  # noqa: E402
from astrild_tpu.ops import lensing as JL  # noqa: E402
from astrild_tpu_torch.models import dipoles as TD  # noqa: E402
from astrild_tpu_torch.models import skymap as TSM  # noqa: E402
from astrild_tpu_torch.ops import filters as TF  # noqa: E402
from astrild_tpu_torch.ops import lensing as TL  # noqa: E402

MAP_TOL = 5e-5     # NFW patches, of the largest |value|
VT_RTOL = 1e-4     # dipole velocities, port against JAX

# the halo behind the reference's golden values (tests/test_lensing.py)
HALO = dict(r200_deg=0.07890977884225592, m200=306600000000000.0,
            c_NFW=1.9267420919614187, rad_dist=961.2600098657648,
            theta1_tv=-739.4726456797774, theta2_tv=305.8846747823117,
            r200_pix=33)


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


def assert_map_close(got, want, tol=MAP_TOL, noise=None):
    """|got - want| <= tol * max |want|, outside the `noise` mask."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    keep = np.ones(got.shape, bool) if noise is None else ~noise
    scale = np.abs(want).max()
    npt.assert_allclose(got[keep], want[keep], rtol=0, atol=tol * scale)


def centre_noise(theta, m, c, dist, npix, extent):
    """The pixels of an NFW patch within 1e-3 scale radii of its centre
    (the float32 cancellation of g), from the port's patch geometry."""
    th, c_t, d, e = TL._halo_tensors(theta, c, dist, extent, device="cpu")
    r200, _, r = TL._nfw_geometry(th, c_t, d, npix, e)
    return (r / (r200 / c_t)[:, None, None] < 1e-3)[0].numpy()


# ------------------------------------------------------------ NFW patches
@pytest.mark.parametrize("directions,suppress,npix", [
    ((0, 1), True, 661), ((0,), False, 661), ((1,), False, 661),
    ((0,), False, 129)])
def test_nfw_alpha_golden_and_parity(directions, suppress, npix):
    """The reference's golden extrema (+-9.0226e-5 for both components,
    suppressed) at rtol 1e-4, and the JAX patch within 5e-5 of max off
    the centre's noise pixels, where the zero set (the clip) of one
    component is equal too (a sum of two is not compared: XLA fuses the
    product into the sum, so where the two cancel it leaves a rounding
    residue and the port an exact zero). At npix = 129 the centre edge
    is exactly 0: the r = 0 pixel is 0 in both."""
    args = (HALO["r200_deg"], HALO["m200"], HALO["c_NFW"],
            HALO["rad_dist"])
    kw = dict(npix=npix, extent=10, directions=directions,
              suppress=suppress, suppression_r=10)
    want = np.asarray(JL.nfw_deflection_angle_map(*args, **kw))
    got = TL.nfw_deflection_angle_map(*args, **kw, device="cpu").numpy()
    noise = centre_noise(*args, npix, 10)
    assert_map_close(got, want, noise=noise)
    if not suppress:
        npt.assert_array_equal(got[~noise] == 0.0, want[~noise] == 0.0)
    if npix == 129:
        assert noise[64, 64] and got[64, 64] == 0.0 and want[64, 64] == 0.0
        th, d, e = TL._halo_tensors(HALO["r200_deg"], HALO["rad_dist"], 10,
                                    device="cpu")
        assert TL._nfw_geometry(th, None, d, npix, e)[2][0, 64, 64] == 0.0
    if directions == (0, 1) and suppress:
        npt.assert_allclose(got.min(), -9.02262751486356e-05, rtol=1e-4)
        npt.assert_allclose(got.max(), 9.02262751486356e-05, rtol=1e-4)


def test_nfw_dt_golden_and_parity():
    """dT/T extrema +-1.7028e-07 (the reference's golden), antisymmetric
    (mean ~ 0), and the JAX patch within 5e-5 of max."""
    npix = int(2 * HALO["r200_pix"] * 10) + 1
    vel = [HALO["theta1_tv"], HALO["theta2_tv"]]
    args = (HALO["r200_deg"], HALO["m200"], HALO["c_NFW"])
    kw = dict(npix=npix, extent=10, directions=(0, 1), suppress=True,
              suppression_r=10)
    want = np.asarray(JL.nfw_temperature_perturbation_map(
        *args, jnp.array(vel), HALO["rad_dist"], **kw))
    got = TL.nfw_temperature_perturbation_map(
        *args, np.array(vel), HALO["rad_dist"], **kw, device="cpu").numpy()
    assert_map_close(got, want, noise=centre_noise(*args, HALO["rad_dist"],
                                                   npix, 10))
    npt.assert_allclose(got.min(), -1.7028239210299853e-07, rtol=1e-4)
    npt.assert_allclose(got.max(), 1.7028239210299855e-07, rtol=1e-4)
    assert abs(got.mean()) < 1e-12


def test_patch_edges_bit_for_bit():
    """The patch offsets linspace(0, 2 R200 extent, npix) - R200 extent
    with traced float32 endpoints, as jit compiles them, equal the port's
    bit for bit, for one halo and for a batch of halos at once."""
    rng = np.random.default_rng(3)
    theta = rng.uniform(0.01, 0.3, 12)
    dist = rng.uniform(100.0, 3000.0, 12)
    ext = 10.0

    @jax.jit
    def edges(th, d, e):
        r200 = jnp.tan(th * jnp.pi / 180.0) * d
        return jnp.linspace(0.0, 2.0 * r200 * e, 101) - r200 * e

    th_t, d_t, e_t = TL._halo_tensors(theta, dist, ext, device="cpu")
    r200, t, _ = TL._nfw_geometry(th_t, None, d_t, 101, e_t)
    for i in range(12):
        want = np.asarray(edges(theta[i], dist[i], ext))
        npt.assert_array_equal(t[i].numpy(), want)


def test_nfw_dipole_patch_antisymmetry_and_parity():
    """Odd under x -> -x (rtol 2e-5), a micro-Kelvin amplitude, and the
    JAX patch within 5e-5 of max (host geometry from the float64 tables
    against JAX's float32 ones)."""
    kw = dict(extent_deg=0.5, npix=64)
    got = TL.nfw_dipole_patch(1e15, [1000.0, 0.0], 0.3, device="cpu",
                              **kw).numpy()
    want = np.asarray(JL.nfw_dipole_patch(1e15, [1000.0, 0.0], 0.3, **kw))
    assert_map_close(got, want)
    npt.assert_allclose(got, -got[:, ::-1], rtol=2e-5, atol=1e-12)
    dty = TL.nfw_dipole_patch(1e15, [0.0, 1000.0], 0.3, device="cpu",
                              **kw).numpy()
    npt.assert_allclose(dty, -dty[::-1, :], rtol=2e-5, atol=1e-12)
    assert 1e-9 < float(np.abs(got).max()) < 1e-5


# ---------------------------------------------------------- patch painting
def test_add_patch_to_map_center_and_clip():
    big = torch.zeros((10, 10))
    patch = torch.ones((3, 3))
    out = TL.add_patch_to_map(big, patch, (5, 5)).numpy()
    assert out.sum() == 9.0 and out[5, 5] == 1.0 and out[4, 4] == 1.0
    out2 = TL.add_patch_to_map(big, patch, (0, 0)).numpy()
    npt.assert_allclose(out2.sum(), 4.0)
    assert out2[0, 0] == 1.0
    want = np.asarray(JL.add_patch_to_map(jnp.zeros((10, 10)),
                                          jnp.ones((3, 3)), (0, 0)))
    npt.assert_array_equal(out2, want)


@pytest.mark.parametrize("n_halo,seed", [(5, 0), (60, 1)])
def test_paint_halo_patches_equals_jax_scan(n_halo, seed):
    """One index_add_ over (halo, row, col) sums in the scan's order on the
    CPU: bit for bit with the JAX package, overlapping and clipped patches
    included, onto a non-zero base map."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((32, 32)).astype(np.float32)
    patches = rng.standard_normal((n_halo, 7, 7)).astype(np.float32)
    centers = rng.integers(-4, 36, (n_halo, 2)).astype(np.int32)
    want = np.asarray(JL.paint_halo_patches(
        jnp.asarray(base), jnp.asarray(patches), jnp.asarray(centers)))
    got = TL.paint_halo_patches(torch.from_numpy(base),
                                torch.from_numpy(patches),
                                torch.from_numpy(centers)).numpy()
    npt.assert_array_equal(got, want)


# ----------------------------------------------------- SkyArray constructors
def _catalog(n=6, seed=5):
    rng = np.random.default_rng(seed)
    return {"r200_deg": rng.uniform(0.03, 0.12, n),
            "m200": 10 ** rng.uniform(13.5, 15.0, n),
            "c_NFW": rng.uniform(3.0, 8.0, n),
            "Dc": rng.uniform(500.0, 2000.0, n),
            "theta1_tv": rng.normal(0, 400, n),
            "theta2_tv": rng.normal(0, 400, n),
            "v_los": rng.normal(0, 400, n),
            "m500": 10 ** rng.uniform(13.5, 14.8, n),
            "r500": rng.uniform(0.5, 1.5, n),
            "e_z": rng.uniform(1.0, 1.6, n),
            "theta1_pix": rng.integers(-5, 133, n).astype(float),
            "theta2_pix": rng.integers(-5, 133, n).astype(float),
            "r200_pix": rng.uniform(2.0, 6.0, n)}


@pytest.mark.parametrize("to", ["dT", "alpha", "ksz"])
def test_from_halo_series_matches_jax(to):
    halo = {k: float(v[0]) for k, v in _catalog().items()}
    kw = dict(npix=33, extent=1.5, direction=(0, 1) if to != "alpha"
              else (0,), suppress=False, suppression_R=1.0, to=to)
    want = JSM.SkyArray.from_halo_series(halo, **kw)
    got = TSM.SkyArray.from_halo_series(halo, **kw, device="cpu")
    assert got.quantity == want.quantity
    npt.assert_allclose(got.opening_angle, want.opening_angle, rtol=1e-12)
    assert_map_close(got.data["orig"].numpy(), want.data["orig"])


@pytest.mark.parametrize("to", ["dT", "alpha", "ksz", "y"])
def test_from_halo_dataframe_matches_jax(to):
    """Six halos on a 128^2 canvas (some clipped at its edges): the JAX
    package's per-halo loop against the port's one broadcast, within 5e-5
    of max (2e-4 for y: the 128-point line-of-sight sum in float32)."""
    cat = _catalog()
    kw = dict(npix=128, extent=2.0 if to == "y" else 1.0, direction=(0, 1),
              suppress=False, suppression_R=1.0, to=to, opening_angle=3.0,
              patch_npix=21)
    want = JSM.SkyArray.from_halo_dataframe(cat, **kw)
    got = TSM.SkyArray.from_halo_dataframe(cat, **kw, device="cpu")
    assert got.quantity == want.quantity and got.opening_angle == 3.0
    # the NFW centres' float32 noise pixels (each halo's centre pixel at
    # this patch resolution) are left out for dT and alpha
    noise = np.zeros((128, 128), bool)
    if to in ("dT", "alpha"):
        r, c = cat["theta2_pix"].astype(int), cat["theta1_pix"].astype(int)
        inside = (r >= 0) & (r < 128) & (c >= 0) & (c < 128)
        noise[r[inside], c[inside]] = True
    assert_map_close(got.data["orig"].numpy(), want.data["orig"],
                     tol=2e-4 if to == "y" else MAP_TOL, noise=noise)


def test_halo_stack_equals_scalar_calls():
    """The broadcast over halos computes each element as the scalar call
    does: the stack of from_halo_dataframe equals the port's scalar patch
    of each halo bit for bit."""
    from astrild_tpu_torch.ops import sz as TZ

    cat = _catalog(n=4)
    th, m, c, d, ext, sup, v1, v2 = TL._halo_tensors(
        cat["r200_deg"], cat["m200"], cat["c_NFW"], cat["Dc"], 1.0, 1.0,
        cat["theta1_tv"], cat["theta2_tv"], device="cpu")
    stack = TL._nfw_temperature_stack(th, m, c, torch.stack([v1, v2], -1),
                                      d, 21, ext, (0, 1), False, sup)
    r200_mpc = np.tan(np.deg2rad(cat["r200_deg"])) * cat["Dc"]
    km, kc, kr, kv, kext = TL._halo_tensors(cat["m200"], cat["c_NFW"],
                                            r200_mpc, cat["v_los"], 1.0,
                                            device="cpu")
    kstack = TZ._ksz_stack(km, kc, kr, kv, 21, kext)
    for i in range(4):
        one = TL.nfw_temperature_perturbation_map(
            cat["r200_deg"][i], cat["m200"][i], cat["c_NFW"][i],
            [cat["theta1_tv"][i], cat["theta2_tv"][i]], cat["Dc"][i],
            npix=21, extent=1.0, device="cpu")
        npt.assert_array_equal(stack[i].numpy(), one.numpy())
        kone = TZ.ksz_patch_from_halo(cat["m200"][i], cat["c_NFW"][i],
                                      float(r200_mpc[i]), cat["v_los"][i],
                                      npix=21, extent=1.0, device="cpu")
        npt.assert_array_equal(kstack[i].numpy(), kone.numpy())


def test_skyarray_halo_catalogue_alias():
    nh = 3
    cat = {"m200": np.full(nh, 1e14), "c_NFW": np.full(nh, 5.0),
           "r200_deg": np.full(nh, 0.05), "Dc": np.full(nh, 1000.0),
           "theta1_tv": np.full(nh, 500.0), "theta2_tv": np.zeros(nh),
           "theta1_pix": np.array([32, 96, 64]),
           "theta2_pix": np.array([32, 64, 96]),
           "r200_pix": np.full(nh, 4.0)}
    kw = dict(extent=1.0, direction=[0], npix=128, opening_angle=2.0,
              patch_npix=33)
    got = TSM.SkyArray.from_halo_catalogue_to_temperature_perturbation_map(
        cat, **kw, device="cpu")
    want = JSM.SkyArray.from_halo_catalogue_to_temperature_perturbation_map(
        cat, **kw)
    assert got.data["orig"].shape == (128, 128)
    assert float(got.data["orig"].abs().max()) > 0
    assert_map_close(got.data["orig"].numpy(), want.data["orig"])


# ------------------------------------------------------------------ Dipoles
def test_dipoles_catalog_roundtrip(tmp_path):
    pytest.importorskip("h5py")
    cat = {"theta1_pix": np.array([3.0, 7.0]),
           "theta2_pix": np.array([4.0, 1.0]),
           "dT": np.array([1e-6, -2e-6]), "snr": np.array([5.0, 7.0])}
    d1 = TD.Dipoles.from_dataframe(cat)
    p = str(tmp_path / "dip.h5")
    d1.to_file(p)
    for d2 in (TD.Dipoles.from_file(p), JD.Dipoles.from_file(p)):
        for k in cat:
            npt.assert_allclose(d2.data[k], cat[k])
    pd = pytest.importorskip("pandas")
    d3 = TD.Dipoles.from_dataframe(pd.DataFrame(cat))
    npt.assert_allclose(d3.data["snr"], cat["snr"])


def test_dipoles_single_transverse_velocity_exact():
    rng = np.random.default_rng(2)
    alphax = rng.normal(0, 1e-5, (32, 32))
    alphay = rng.normal(0, 1e-5, (32, 32))
    vx_true, vy_true = 420.0, -130.0
    dtx = -alphax * vx_true / 299792.458
    dty = -alphay * vy_true / 299792.458
    vx, vy = TD.Dipoles.get_single_transverse_velocity_from_sky(
        dtx, dty, alphax, alphay, device="cpu")
    npt.assert_allclose(float(vx), vx_true, rtol=1e-5)
    npt.assert_allclose(float(vy), vy_true, rtol=1e-5)
    jx, jy = JD.Dipoles.get_single_transverse_velocity_from_sky(
        jnp.asarray(dtx), jnp.asarray(dty), jnp.asarray(alphax),
        jnp.asarray(alphay))
    # float32 sums of 1024 terms in two orders
    npt.assert_allclose(float(vx), float(jx), rtol=1e-5)
    npt.assert_allclose(float(vy), float(jy), rtol=1e-5)


def test_aperture_photometry_float32_ring_decision():
    """Under vmap the ring radius ceil(alpha / 60 * n / theta) is a float32
    decision on a traced R200 * 60. This R200 puts it an ulp away from an
    integer: the float32 form gives 13 pixels, the float64 scalar form 14.
    The port's batched path takes the JAX package's decision (on an
    integer-valued map, whose ring sums are exact in any order, the
    outputs are equal bit for bit), and its scalar path the float64 one."""
    r200 = np.float32(0.9851562976837158)
    npix, pp, oa = 128, 32, 9.7
    p = 2 * pp
    patch_oa = oa * p / npix
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 9, (2, p, p)).astype(np.float32)
    r = np.array([r200, np.float32(0.3)], np.float32)
    want = np.asarray(jax.vmap(lambda im, rr: JF.aperture_photometry(
        im, patch_oa, rr * 60.0))(jnp.asarray(imgs), jnp.asarray(r)))
    got = TF.aperture_photometry(torch.from_numpy(imgs), patch_oa,
                                 torch.from_numpy(r) * 60.0).numpy()
    npt.assert_array_equal(got, want)
    # the float64 scalar form draws the ring one pixel wider, as the JAX
    # package's own scalar call does
    scalar = TF.aperture_photometry(torch.from_numpy(imgs[0]), patch_oa,
                                    float(r200) * 60.0).numpy()
    jscalar = np.asarray(JF.aperture_photometry(jnp.asarray(imgs[0]),
                                                patch_oa, float(r200) * 60.0))
    npt.assert_array_equal(scalar, jscalar)
    assert not np.array_equal(scalar, got[0])


def test_dgd3_window_batched_matches_vmap():
    """One DGD3 window per float32 scale against jax.vmap of the JAX
    window (within 1e-5 of max); axis 1 is axis 0 transposed. (The
    batched high-pass -> DGD3 chain is held against JAX through the
    reference-mode estimator below.)"""
    r = np.array([0.05, 0.11, 0.2], np.float32)
    ti = torch.from_numpy(r) * 60.0
    want = np.asarray(jax.vmap(lambda rr: JF.dgd3_window(
        32, 2.5, rr * 60.0, axis=0))(jnp.asarray(r)))
    got = TF.dgd3_window(32, 2.5, ti, axis=0).numpy()
    assert_map_close(got, want, tol=1e-5)
    npt.assert_array_equal(TF.dgd3_window(32, 2.5, ti, axis=1).numpy(),
                           np.swapaxes(got, 1, 2))


def _dipole_field(n, oa, halos, patch_npix, extent):
    """The JAX dipole tests' synthetic field: NFW dT and deflection patches
    of the halos painted by the JAX package (numpy out)."""
    dT, ax, ay = (jnp.zeros((n, n)) for _ in range(3))
    for i in range(len(halos["m200"])):
        args = (halos["r200_deg"][i], halos["m200"][i], halos["c_NFW"][i])
        cen = jnp.array([[halos["theta1_pix"][i], halos["theta2_pix"][i]]])
        dT = JL.paint_halo_patches(dT, JL.nfw_temperature_perturbation_map(
            *args, jnp.array([halos["theta1_vel"][i],
                              halos["theta2_vel"][i]]), 1000.0,
            npix=patch_npix, extent=extent)[None], cen)
        ax = JL.paint_halo_patches(ax, JL.nfw_deflection_angle_map(
            *args, 1000.0, npix=patch_npix, extent=extent,
            directions=(0,))[None], cen)
        ay = JL.paint_halo_patches(ay, JL.nfw_deflection_angle_map(
            *args, 1000.0, npix=patch_npix, extent=extent,
            directions=(1,))[None], cen)
    return np.asarray(dT), np.asarray(ax), np.asarray(ay)


def _halos(n, oa, pix1, pix2, r200_deg):
    return {"theta1_pix": np.array(pix1), "theta2_pix": np.array(pix2),
            "theta1_deg": np.array(pix1) * (oa / n),
            "theta2_deg": np.array(pix2) * (oa / n),
            "r200_deg": np.array(r200_deg),
            "r200_pix": np.array(r200_deg) * n / oa,
            "m200": np.array([5e14, 3e14]), "c_NFW": np.array([3.0, 3.0]),
            "theta1_vel": np.array([500.0, -300.0]),
            "theta2_vel": np.array([200.0, 100.0])}


@pytest.fixture(scope="module")
def dipole_field():
    """The JAX dipole tests' field at 128^2 / 5 deg (their 256^2 / 10 deg
    and 512^2 / 10 deg fields at this size): two moving NFW halos of R200
    5 and 4.5 pixels painted by the JAX package, and both packages'
    detections on |dT| matched to the halos."""
    n, oa = 128, 5.0
    halos = _halos(n, oa, [38, 90], [42, 82], [0.2, 0.18])
    dT, ax, ay = _dipole_field(n, oa, halos, 51, 5)
    jd = JD.Dipoles.from_sky(JSM.SkyArray.from_array(jnp.asarray(dT), oa,
                                                     "isw_rs"),
                             snr_threshold=1.0, edge_pix=4)
    td = TD.Dipoles.from_sky(TSM.SkyArray.from_array(dT, oa, "isw_rs",
                                                     device="cpu"),
                             snr_threshold=1.0, edge_pix=4)
    jd.find_nearest(halos)
    td.find_nearest(halos)
    return dict(n=n, oa=oa, halos=halos, maps=(dT, ax, ay), jd=jd, td=td)


def _copies(field):
    return (JD.Dipoles(dict(field["jd"].data)),
            TD.Dipoles(dict(field["td"].data)))


def test_dipoles_detection_and_matching_match_jax(dipole_field):
    """Peaks of |dT| at the same pixels in the same order, SNR within rtol
    1e-5, and the same nearest-halo matches (duplicates resolved in the
    order of the distances)."""
    jd, td = dipole_field["jd"], dipole_field["td"]
    for k in ("theta1_pix", "theta2_pix", "theta1_deg", "theta2_deg",
              "halo_idx"):
        npt.assert_array_equal(td.data[k], jd.data[k])
    npt.assert_allclose(td.data["snr"], jd.data["snr"], rtol=1e-5)
    npt.assert_allclose(td.data["halo_dist"], jd.data["halo_dist"],
                        rtol=1e-12)
    assert len(td.data["snr"]) >= 2 and (td.data["halo_idx"] >= 0).sum() >= 2


def test_dipoles_pipeline_matches_jax(dipole_field):
    """The matched-filter velocities within rtol 1e-4 of JAX's and within
    0.35 of the input velocities (the JAX package's bar)."""
    jd, td = _copies(dipole_field)
    dT, ax, ay = dipole_field["maps"]
    oa = dipole_field["oa"]
    jd.get_transverse_velocities_from_sky(jnp.asarray(dT), jnp.asarray(ax),
                                          jnp.asarray(ay), oa, patch_pix=32)
    td.get_transverse_velocities_from_sky(dT, ax, ay, oa, patch_pix=32,
                                          device="cpu")
    vx, vy = td.data["theta1_mtvel"], td.data["theta2_mtvel"]
    ok = vx > -99999
    npt.assert_array_equal(ok, jd.data["theta1_mtvel"] > -99999)
    assert ok.sum() >= 2
    npt.assert_allclose(vx[ok], jd.data["theta1_mtvel"][ok], rtol=VT_RTOL)
    npt.assert_allclose(vy[ok], jd.data["theta2_mtvel"][ok], rtol=VT_RTOL)
    for i in np.where(ok)[0]:
        npt.assert_allclose(vx[i], td.data["theta1_vel"][i], rtol=0.35)
        npt.assert_allclose(vy[i], td.data["theta2_vel"][i], rtol=0.35)


def test_dipoles_reference_mode_matches_jax(dipole_field):
    """The reference-form estimator (crop -> aperture photometry -> 5'
    high-pass -> DGD3(R200) -> Hann -> -c Sum dT / Sum alpha): the same
    crops and Hann cuts as JAX's, the velocities finite and within rtol
    1e-4 of JAX's."""
    jd, td = _copies(dipole_field)
    dT, ax, ay = dipole_field["maps"]
    oa = dipole_field["oa"]
    jd.get_transverse_velocities_reference_mode(
        jnp.asarray(dT), jnp.asarray(ax), jnp.asarray(ay), oa)
    td.get_transverse_velocities_reference_mode(dT, ax, ay, oa,
                                                device="cpu")
    for k in ("theta1_mtvel_ref", "theta2_mtvel_ref"):
        ok = jd.data[k] > -99999
        npt.assert_array_equal(td.data[k] > -99999, ok)
        assert ok.sum() >= 1
        npt.assert_allclose(td.data[k][ok], jd.data[k][ok], rtol=VT_RTOL)
        assert np.isfinite(td.data[k][ok]).all()
