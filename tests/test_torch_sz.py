"""PyTorch port vs JAX package on the CPU: `ops/sz.py` (projected NFW
mass, tau, kSZ, GNFW Compton-y, stacked aperture photometry, the M200m ->
M500c bisection, y_ell, Cl_yy) and `ops/strong_lensing.py` (SPH surface
density, image remapping, stencil shear, the triangle-mapping image
finder, the Fermat potential, time delays).

Inputs are made with numpy and handed to both packages; each tolerance is
stated where it is checked. Patches agree to 2e-5 of their largest value
(float32 transcendental functions in the last ulp), the image finder's
n_found exactly, the stencil shear bit for bit.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.models import skymap as JSM  # noqa: E402
from astrild_tpu.ops import strong_lensing as JS  # noqa: E402
from astrild_tpu.ops import sz as JZ  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.models import skymap as TSM  # noqa: E402
from astrild_tpu_torch.ops import lensing as TL  # noqa: E402
from astrild_tpu_torch.ops import strong_lensing as TS  # noqa: E402
from astrild_tpu_torch.ops import sz as TZ  # noqa: E402
from astrild_tpu_torch.utils.constants import C_LIGHT_KMS, T_CMB  # noqa
from astrild_tpu_torch.utils.cosmology import Cosmology as TC  # noqa: E402

PATCH_TOL = 2e-5   # SZ patches, of the largest |value|


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


def assert_close_of_max(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------- SZ
def _cyl_mass_analytic(m200, c, r200, x):
    """Wright & Brainerd cylindrical NFW mass M_2D(< x r_s)."""
    rs = r200 / c
    rho_s = m200 * c ** 3 / (4 * np.pi * r200 ** 3
                             * (np.log(1 + c) - c / (1 + c)))
    if x < 1:
        g = np.log(x / 2) + np.arccosh(1 / x) / np.sqrt(1 - x ** 2)
    else:
        g = np.log(x / 2) + np.arccos(1 / x) / np.sqrt(x ** 2 - 1)
    return 4 * np.pi * rho_s * rs ** 3 * g


def test_nfw_sigma_mass_closure_and_parity():
    """Cylindrical mass within 0.5 and 0.9 R200 to 2% of Wright &
    Brainerd, and the JAX map within 2e-5 of max (512^2)."""
    m200, c, r200 = 1e15, 5.0, 2.0
    npix, extent = 512, 1.0
    sig = TZ.nfw_sigma_map(m200, c, r200, npix=npix, extent=extent,
                           device="cpu")
    assert_close_of_max(sig, JZ.nfw_sigma_map(m200, c, r200, npix=npix,
                                              extent=extent), PATCH_TOL)
    sig = sig.numpy()
    pix = 2.0 * extent * r200 / npix
    edges = np.linspace(-extent * r200, extent * r200, npix)
    tx, ty = np.meshgrid(edges, edges)
    r = np.sqrt(tx ** 2 + ty ** 2)
    for rcut in (0.5 * r200, 0.9 * r200):
        m_map = sig[r < rcut].sum() * pix ** 2
        m_true = _cyl_mass_analytic(m200, c, r200, rcut / (r200 / c))
        assert abs(m_map / m_true - 1.0) < 0.02


def test_tau_scale_and_shape():
    tau = TZ.nfw_tau_map(1e15, 5.0, 2.0, npix=128, device="cpu")
    assert_close_of_max(tau, JZ.nfw_tau_map(1e15, 5.0, 2.0, npix=128),
                        PATCH_TOL)
    tau = tau.numpy()
    assert np.isfinite(tau).all() and (tau > 0).all()
    center = tau[64, 64]
    assert 1e-4 < center < 5e-2 and center == tau.max()
    assert tau[0, 0] < 0.1 * center


def test_ksz_sign_and_linearity():
    tau = TZ.nfw_tau_map(3e14, 6.0, 1.2, npix=64, device="cpu")
    dt_away = TZ.ksz_patch(tau, +300.0).numpy()
    dt_toward = TZ.ksz_patch(tau, -300.0).numpy()
    assert (dt_away < 0).all()           # receding -> decrement
    npt.assert_allclose(dt_away, -dt_toward, rtol=1e-6)
    npt.assert_allclose(TZ.ksz_patch(tau, +600.0).numpy(), 2 * dt_away,
                        rtol=1e-6)
    assert 1e-6 < -dt_away.min() < 1e-3
    d = TZ.ksz_patch_from_halo(3e14, 6.0, 1.2, 300.0, npix=64,
                               device="cpu")
    npt.assert_allclose(d.numpy(), dt_away, rtol=1e-6)
    assert_close_of_max(d, JZ.ksz_patch_from_halo(3e14, 6.0, 1.2, 300.0,
                                                  npix=64), PATCH_TOL)
    assert_close_of_max(TZ.ksz_patch(tau, 300.0), JZ.ksz_patch(
        JZ.nfw_tau_map(3e14, 6.0, 1.2, npix=64), 300.0), PATCH_TOL)


def test_compton_y_oracle_and_parity():
    """A float64 oracle at three pixels (rtol 2e-3), a massive cluster's
    central y, n_los convergence, and the JAX patch within 2e-5 of max
    (the same 128-term line-of-sight sum in the scan's order)."""
    m500, r500, ez = 5e14, 1.3, 1.0
    npix, n_los = 64, 128
    y = TZ.compton_y_patch(m500, r500, ez, npix=npix, extent=2.0,
                           n_los=n_los, device="cpu")
    assert_close_of_max(y, JZ.compton_y_patch(m500, r500, ez, npix=npix,
                                              extent=2.0, n_los=n_los),
                        PATCH_TOL)
    y = y.numpy()
    p0, c500, gam, alp, bet = TZ.GNFW_ARNAUD10
    h70 = 0.968
    prefac = 6.6524587158e-25 / 511.0 * 3.0856775814913673e24
    amp = 1.65e-3 * (m500 / (3e14 / h70)) ** (2 / 3) * h70 ** 2
    edges = np.linspace(-2.0 * r500, 2.0 * r500, npix)
    l = np.linspace(-5.0 * r500, 5.0 * r500, n_los)
    dl = l[1] - l[0]
    for (i, j) in ((npix // 2, npix // 2), (10, 40), (0, 0)):
        rperp = np.sqrt(edges[j] ** 2 + edges[i] ** 2)
        x = np.sqrt(rperp ** 2 + l ** 2) / r500
        cx = np.maximum(c500 * x, 1e-8)
        p = p0 / (cx ** gam * (1 + cx ** alp) ** ((bet - gam) / alp))
        npt.assert_allclose(y[i, j], prefac * amp * p.sum() * dl, rtol=2e-3)
    assert 3e-5 < y[npix // 2, npix // 2] < 1e-3
    y2 = TZ.compton_y_patch(m500, r500, ez, npix=npix, extent=2.0,
                            n_los=2 * n_los, device="cpu").numpy()
    npt.assert_allclose(y2[npix // 2], y[npix // 2], rtol=5e-3)


def test_skyarray_ksz_facade():
    halo = {"r200_deg": 0.1, "m200": 5e14, "c_NFW": 6.0, "Dc": 1200.0,
            "v_los": 400.0}
    kw = dict(npix=64, extent=1.0, direction=(0,), suppress=False,
              suppression_R=1.0, to="ksz")
    sky = TSM.SkyArray.from_halo_series(halo, **kw, device="cpu")
    arr = sky.data["orig"].numpy()
    assert (arr < 0).all() and np.isfinite(arr).all()
    assert_close_of_max(arr, JSM.SkyArray.from_halo_series(
        halo, **kw).data["orig"], PATCH_TOL)
    cat = {"r200_deg": np.array([0.1, 0.08]), "m200": np.array([5e14, 2e14]),
           "c_NFW": np.array([6.0, 7.0]), "Dc": np.array([1200.0, 1500.0]),
           "v_los": np.array([400.0, -300.0]),
           "theta1_pix": np.array([100, 400]),
           "theta2_pix": np.array([150, 420]),
           "r200_pix": np.array([25.0, 20.0])}
    kw2 = dict(npix=512, extent=1.0, direction=(0,), suppress=False,
               suppression_R=1.0, to="ksz", opening_angle=2.0,
               patch_npix=51)
    m = TSM.SkyArray.from_halo_dataframe(cat, **kw2, device="cpu")
    m = m.data["orig"].numpy()
    assert m[150, 100] < 0 < m[420, 400]
    assert_close_of_max(m, JSM.SkyArray.from_halo_dataframe(
        cat, **kw2).data["orig"], PATCH_TOL)


def test_skyarray_tsz_y_facade():
    cat = {"r200_deg": np.array([0.1]), "m200": np.array([5e14]),
           "c_NFW": np.array([6.0]), "Dc": np.array([1200.0]),
           "m500": np.array([4e14]), "r500": np.array([1.2]),
           "e_z": np.array([1.2]),
           "theta1_pix": np.array([128]), "theta2_pix": np.array([128]),
           "r200_pix": np.array([25.0])}
    kw = dict(npix=256, extent=2.0, direction=(0,), suppress=False,
              suppression_R=1.0, to="y", opening_angle=2.0, patch_npix=51)
    sky = TSM.SkyArray.from_halo_dataframe(cat, **kw, device="cpu")
    m = sky.data["orig"].numpy()
    assert sky.quantity == "y"
    assert m.max() > 1e-5 and (m >= 0).all()
    assert abs(m.argmax() // 256 - 128) <= 1
    assert_close_of_max(m, JSM.SkyArray.from_halo_dataframe(
        cat, **kw).data["orig"], PATCH_TOL)


def test_stacked_aperture_photometry():
    """AP on a uniform disk recovers the disk / ring geometry, a constant
    background nulls out, the weighted stack; against JAX at rtol 1e-5."""
    n, fov = 512, 2.0
    alpha_arcmin = 4.0
    alpha_pix = alpha_arcmin / 60.0 * n / fov
    r0_pix = 0.5 * alpha_pix
    img = np.zeros((n, n), np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    centers = np.array([(150, 150), (380, 300)])
    A = -3e-6
    for (r, c) in centers:
        img[(yy - r) ** 2 + (xx - c) ** 2 <= r0_pix ** 2] = A
    ap, stack = TZ.stacked_aperture_photometry(img, centers, fov,
                                               alpha_arcmin, patch_half=40,
                                               device="cpu")
    jap, jstack = JZ.stacked_aperture_photometry(
        jnp.asarray(img), centers, fov, alpha_arcmin, patch_half=40)
    npt.assert_allclose(ap.numpy(), np.asarray(jap), rtol=1e-5)
    npt.assert_allclose(float(stack), float(jstack), rtol=1e-5)
    ap = ap.numpy()
    npt.assert_allclose(ap, A * (r0_pix / alpha_pix) ** 2, rtol=0.05)
    ap2, _ = TZ.stacked_aperture_photometry(img + 1.7e-4, centers, fov,
                                            alpha_arcmin, patch_half=40,
                                            device="cpu")
    npt.assert_allclose(ap2.numpy(), ap, atol=2e-9)
    _, st = TZ.stacked_aperture_photometry(img, centers, fov, alpha_arcmin,
                                           patch_half=40,
                                           weights=np.array([1.0, 3.0]),
                                           device="cpu")
    npt.assert_allclose(float(st), (ap[0] + 3 * ap[1]) / 4.0, rtol=1e-5)


def test_ksz_closed_loop_map_to_pairwise_momentum():
    """The JAX package's closed loop in the port: a halo catalog with v =
    H x -> painted kSZ map -> aperture photometry at the halo pixels ->
    Hand+12 pairwise momentum -> p(r) = -T tau_AP H <r> / c (rtol 0.1)."""
    from astrild_tpu_torch.ops import pairwise

    rng = np.random.default_rng(7)
    nh, L, H = 600, 400.0, 0.4
    pos = rng.uniform(40.0, L - 40.0, (nh, 3))
    vz = H * pos[:, 2]
    npix = 2048
    pix_mpc = L / npix
    m200, c200, r200 = 3e14, 6.0, 1.0
    extent = 2.0
    patch_npix = int(round(2 * extent * r200 / pix_mpc)) | 1
    tau = TZ.nfw_tau_map(m200, c200, r200, npix=patch_npix, extent=extent,
                         device="cpu")
    patches = tau[None] * (-T_CMB * torch.tensor(vz, dtype=torch.float32)
                           [:, None, None] / C_LIGHT_KMS)
    cols = (pos[:, 0] / pix_mpc).astype(np.int32)
    rows = (pos[:, 1] / pix_mpc).astype(np.int32)
    kmap = TL.paint_halo_patches(torch.zeros((npix, npix)), patches,
                                 np.stack([cols, rows], axis=-1))
    read = np.stack([rows, cols], axis=-1)
    Dc = 50000.0
    fov_deg = np.degrees(L / Dc)
    alpha_arcmin = np.degrees(r200 / Dc) * 60.0
    ph = patch_npix // 2 + 4
    ap, _ = TZ.stacked_aperture_photometry(kmap, read, fov_deg,
                                           alpha_arcmin, patch_half=ph)
    solo = TL.paint_halo_patches(torch.zeros((npix, npix)), tau[None],
                                 np.array([[npix // 2, npix // 2]]))
    tau_ap, _ = TZ.stacked_aperture_photometry(
        solo, np.array([[npix // 2, npix // 2]]), fov_deg, alpha_arcmin,
        patch_half=ph)
    tau_ap = float(tau_ap[0])
    assert tau_ap > 0
    pos_lc = pos - L / 2 + np.array([0.0, 0.0, Dc])
    bins = (np.arange(8) + 1.0) * 12.0
    _, p = pairwise.pairwise_ksz_momentum(
        torch.tensor(pos_lc, dtype=torch.float32), ap,
        torch.tensor(bins, dtype=torch.float32))
    p = p.numpy()
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    d = d[np.triu_indices(nh, k=1)]
    b = (d / 12.0).astype(int)
    mean_r = np.array([d[b == k].mean() if (b == k).sum() > 30 else np.nan
                       for k in range(8)])
    expect = -T_CMB * tau_ap * H * mean_r / C_LIGHT_KMS
    good = ~np.isnan(expect) & ~np.isnan(p)
    good[0] = False
    assert good.sum() >= 5
    npt.assert_allclose(p[good], expect[good], rtol=0.1)


def test_m500c_from_m200m_sane_and_parity():
    """M500c below M200m (0.4-1), r500 rising, the definition closing to
    rtol 1e-3, and JAX's float32 bisection to rtol 1e-5, at z = 0 and at
    a float32 z."""
    m200m = np.array([1e13, 1e14, 1e15], np.float32)
    for z in (0.0, float(np.float32(0.37))):
        m500, r500 = TZ.m500c_from_m200m(m200m, z, TC(), device="cpu")
        jm, jr = JZ.m500c_from_m200m(jnp.asarray(m200m), z, JC())
        npt.assert_allclose(m500.numpy(), np.asarray(jm), rtol=1e-5)
        npt.assert_allclose(r500.numpy(), np.asarray(jr), rtol=1e-5)
    m500, r500 = (t.numpy() for t in TZ.m500c_from_m200m(m200m, 0.0, TC(),
                                                        device="cpu"))
    assert (m500 < m200m).all() and (m500 / m200m > 0.4).all()
    assert (np.diff(r500) > 0).all()
    rho_c = float(TC().rho_crit(0.0))
    npt.assert_allclose(m500, 4 / 3 * np.pi * 500 * rho_c * r500 ** 3,
                        rtol=1e-3)


def test_y_ell_low_ell_limit_and_parity():
    """y_{ell->0} equals the patch integral Y / d_A^2 (rtol 0.06, the JAX
    package's slow test at a coarser patch), and y_ell of one and of
    several clusters against JAX (rtol 1e-5)."""
    m500, r500, ez, d_a = 5e14, 1.3, 1.0, 1000.0
    yl = float(TZ.y_ell(np.array([0.1]), m500, r500, ez, d_a, x_max=5.0,
                        n_x=1024, device="cpu")[0])
    npix = 96
    y = TZ.compton_y_patch(m500, r500, ez, npix=npix, extent=5.0, n_los=128,
                           device="cpu").numpy()
    npt.assert_allclose(yl, y.sum() * (2 * 5.0 * r500 / npix) ** 2
                        / d_a ** 2, rtol=0.06)
    ells = np.array([0.1, 100.0, 1000.0, 5000.0], np.float32)
    npt.assert_allclose(
        TZ.y_ell(ells, m500, r500, ez, d_a, device="cpu").numpy(),
        np.asarray(JZ.y_ell(jnp.asarray(ells), m500, r500, ez, d_a)),
        rtol=1e-5)
    ms = np.array([1e14, 5e14, 2e15], np.float32)
    rs = np.array([0.7, 1.3, 2.0], np.float32)
    npt.assert_allclose(
        TZ.y_ell(ells, ms, rs, 1.2, d_a, device="cpu").numpy(),
        np.asarray(JZ.y_ell(jnp.asarray(ells), ms, rs, 1.2, d_a)),
        rtol=1e-5)


def test_cl_yy_magnitude_and_parity():
    """The JAX package's slow magnitude test in the port (nz 12, nm 16:
    l(l+1)Cl/2pi in the Planck-era tSZ band, falling at high ell) and a
    small grid against JAX (rtol 1e-4: float32 z nodes fed to both)."""
    ells = np.array([200.0, 1000.0, 3000.0, 8000.0], np.float32)
    cl = TZ.cl_yy(ells, TC(), nz=12, nm=16, device="cpu").numpy()
    assert (cl > 0).all()
    dl = ells * (ells + 1) * cl / (2 * np.pi)
    assert 1e-14 < dl[1] < 1e-10 and cl[-1] < cl[1]
    small = TZ.cl_yy(ells[:3], TC(), nz=3, nm=6, device="cpu").numpy()
    want = np.asarray(JZ.cl_yy(jnp.asarray(ells[:3]), JC(), nz=3, nm=6))
    npt.assert_allclose(small, want, rtol=1e-4)


# ---------------------------------------------------------- strong lensing
def test_remap_identity_and_half_pixel_shift():
    img = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    ii = np.arange(8.0, dtype=np.float32)
    c1 = ii[:, None] * np.ones((1, 8), np.float32)
    c2 = ii[None, :] * np.ones((8, 1), np.float32)
    npt.assert_allclose(TS.remap_image(img, c1, c2, device="cpu").numpy(),
                        img, atol=1e-6)
    img2 = ii[None, :] * np.ones((8, 1), np.float32)
    out = TS.remap_image(img2, c1, c2 + 0.5, device="cpu").numpy()
    npt.assert_allclose(out[:, :-1], np.broadcast_to(np.arange(7) + 0.5,
                                                     (8, 7)), atol=1e-6)
    rng = np.random.default_rng(1)
    img3 = rng.normal(size=(16, 16)).astype(np.float32)
    q1, q2 = (rng.uniform(-1, 17, (16, 16)).astype(np.float32)
              for _ in range(2))
    npt.assert_allclose(
        TS.remap_image(img3, q1, q2, device="cpu").numpy(),
        np.asarray(JS.remap_image(jnp.asarray(img3), jnp.asarray(q1),
                                  jnp.asarray(q2))), rtol=0, atol=1e-6)


def test_shear_from_potential_quadratic_bit_for_bit():
    """phi = x^2/2: kappa = gamma1 = 0.5, gamma2 = 0 inside (atol 1e-3);
    jnp.gradient's differences bit for bit on it and on a random phi."""
    n = 32
    x = (np.arange(n) + 0.5) / n
    phi = ((0.5 * x ** 2)[:, None] * np.ones((1, n))).astype(np.float32)
    rand = np.random.default_rng(2).normal(size=(n, n)).astype(np.float32)
    for p in (rand, phi):
        got = TS.shear_from_potential(p, 1.0, device="cpu")
        want = JS.shear_from_potential(jnp.asarray(p), 1.0)
        for g, w in zip(got, want):
            npt.assert_array_equal(g.numpy(), np.asarray(w))
    c = np.s_[4:-4, 4:-4]
    npt.assert_allclose(got[0].numpy()[c], 0.5, atol=1e-3)
    npt.assert_allclose(got[1].numpy()[c], 0.5, atol=1e-3)
    npt.assert_allclose(got[2].numpy()[c], 0.0, atol=1e-3)


def test_sph_surface_density_mass_and_parity():
    """Mass conserved to rtol 1e-3, and the JAX map within 1e-5 of max
    (the same buckets: the bucket index is a division by a tensor and an
    int32 cast, as in the JAX package)."""
    rng = np.random.default_rng(0)
    n = 500
    pos = rng.uniform(10, 90, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 2, n).astype(np.float32)
    hsml = rng.uniform(0.5, 5.0, n).astype(np.float32)
    npix, box = 64, 100.0
    sd = TS.sph_surface_density(pos, mass, hsml, npix, box, device="cpu")
    npt.assert_allclose(float(sd.sum()) * (box / npix) ** 2, mass.sum(),
                        rtol=1e-3)
    assert_close_of_max(sd, JS.sph_surface_density(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(hsml), npix, box),
        1e-5)


def test_sph_surface_density_bucket_convergence():
    """More buckets converge toward each particle smoothed at its own width
    (one FFT a particle): monotone, < 5% rms at 16 buckets, mass conserved
    at every count (rtol 1e-4)."""
    rng = np.random.default_rng(42)
    npix, box, n = 64, 100.0, 40
    pos = rng.uniform(10, 90, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    hsml = rng.uniform(1.0, 12.0, n).astype(np.float32)
    ds = box / npix
    k = np.fft.fftfreq(npix) * 2.0 * np.pi / ds
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    exact = np.zeros((npix, npix))
    for i in range(n):
        dep = np.zeros((npix, npix))
        ii = np.floor(pos[i] / ds).astype(int) % npix
        dep[ii[0], ii[1]] += mass[i]
        exact += np.real(np.fft.ifft2(np.fft.fft2(dep) * np.exp(
            -0.5 * float(hsml[i]) ** 2 * k2)))
    exact /= ds ** 2
    errs = []
    for nb in (2, 4, 8, 16):
        got = TS.sph_surface_density(pos, mass, hsml, npix, box,
                                     n_buckets=nb, device="cpu").numpy()
        errs.append(np.sqrt(np.mean((got - exact) ** 2))
                    / np.sqrt(np.mean(exact ** 2)))
        npt.assert_allclose(got.sum() * ds ** 2, mass.sum(), rtol=1e-4)
    assert errs[1] < errs[0] and errs[3] < errs[1] and errs[3] < 0.05, errs


def test_mapping_triangles_point_lens_matches_jax():
    """Both analytic images of a point lens and their magnifications
    (rtol 0.05), n_found equal to JAX's, the images within 1e-6 and the
    magnifications within rtol 1e-4 of JAX's."""
    n, bs, theta_e, beta = 401, 4.0, 1.0, 0.3
    c = np.linspace(-bs / 2, bs / 2, n).astype(np.float32)
    x1, x2 = np.meshgrid(c, c, indexing="ij")
    r2 = x1 ** 2 + x2 ** 2 + np.float32(1e-12)
    y1 = x1 - theta_e ** 2 * x1 / r2
    y2 = x2 - theta_e ** 2 * x2 / r2
    src = np.array([beta, 0.0], np.float32)
    i1, i2, mag, nf = TS.mapping_triangles(src, x1, x2, y1, y2,
                                           device="cpu")
    j1, j2, jm, jn = JS.mapping_triangles(jnp.asarray(src), jnp.asarray(x1),
                                          jnp.asarray(x2), jnp.asarray(y1),
                                          jnp.asarray(y2))
    assert int(nf) == int(jn)
    npt.assert_allclose(i1.numpy(), np.asarray(j1), rtol=0, atol=1e-6)
    npt.assert_allclose(i2.numpy(), np.asarray(j2), rtol=0, atol=1e-6)
    npt.assert_allclose(mag.numpy(), np.asarray(jm), rtol=1e-4)
    i1, i2, mag = i1.numpy(), i2.numpy(), mag.numpy()
    keep = (i1 > -99998) & (np.abs(mag) > 0.01)
    tp = (beta + np.sqrt(beta ** 2 + 4 * theta_e ** 2)) / 2
    tm = (beta - np.sqrt(beta ** 2 + 4 * theta_e ** 2)) / 2
    npt.assert_allclose(np.sort(i1[keep]), [tm, tp], atol=2 * bs / n)
    npt.assert_allclose(i2[keep], 0.0, atol=2 * bs / n)
    u = beta / theta_e
    mu_p = (u ** 2 + 2) / (2 * u * np.sqrt(u ** 2 + 4)) + 0.5
    npt.assert_allclose(np.sort(mag[keep]), [-(mu_p - 1.0), mu_p], rtol=0.05)


def test_mapping_triangles_no_lens_and_shared_edge():
    """No lens: one image at the source, magnification 1. A source on a
    shared triangle edge is claimed by two triangles and merged into one
    (the 1.5-cell rule), n_found equal to JAX's."""
    n = 65
    c = np.linspace(-1, 1, n).astype(np.float32)
    x1, x2 = np.meshgrid(c, c, indexing="ij")
    for src in ([0.37, -0.21], [float(c[20]), float(c[33])],
                [0.5 * float(c[10] + c[11]), 0.5 * float(c[40] + c[41])]):
        src = np.array(src, np.float32)
        i1, i2, mag, nf = TS.mapping_triangles(src, x1, x2, x1, x2,
                                               device="cpu")
        jn = JS.mapping_triangles(jnp.asarray(src), jnp.asarray(x1),
                                  jnp.asarray(x2), jnp.asarray(x1),
                                  jnp.asarray(x2))[3]
        assert int(nf) == int(jn) == 1
        npt.assert_allclose(float(i1[0]), src[0], atol=1e-5)
        npt.assert_allclose(float(i2[0]), src[1], atol=1e-5)
        npt.assert_allclose(float(mag[0]), 1.0, rtol=1e-5)


def test_fermat_potential_stationary_at_images():
    """Images found by mapping_triangles sit at stationary points of the
    Fermat surface; the delays between them differ; the unit formula; the
    surface against JAX's within 1e-6 of max."""
    n = 256
    oa = 4e-5
    d = oa / n
    t = (np.arange(n) + 0.5) * d
    x1, x2 = np.meshgrid(t, t, indexing="ij")
    cen = oa / 2
    r2 = (x1 - cen) ** 2 + (x2 - cen) ** 2
    kappa = (6.0 * np.exp(-0.5 * r2 / 4.0e-6 ** 2)).astype(np.float32)
    a1, a2 = TL.kappa_to_alpha(torch.from_numpy(kappa), oa)
    x1t = torch.tensor(x1, dtype=torch.float32)
    x2t = torch.tensor(x2, dtype=torch.float32)
    beta = np.array([cen + 1.0e-6, cen], np.float32)
    i1, i2, mag, nf = TS.mapping_triangles(beta, x1t, x2t, x1t - a1,
                                           x2t - a2)
    nf = int(nf)
    assert nf >= 2, nf
    tau = TS.fermat_potential(kappa, oa, beta, device="cpu").numpy()
    assert_close_of_max(tau, JS.fermat_potential(jnp.asarray(kappa), oa,
                                                 jnp.asarray(beta)), 1e-6)
    g1, g2 = np.gradient(tau, d)
    gmag = np.hypot(g1, g2)
    med = np.median(gmag)
    cells = [(int(np.clip(round(float(i1[m]) / d - 0.5), 1, n - 2)),
              int(np.clip(round(float(i2[m]) / d - 0.5), 1, n - 2)))
             for m in range(nf)]
    for p1, p2 in cells:
        assert gmag[p1, p2] < 0.25 * med
    taus = [tau[p1, p2] for p1, p2 in cells]
    days = TS.time_delay_days(np.asarray(taus, np.float32), 0.5, 1000.0,
                              1600.0, 900.0, device="cpu").numpy()
    assert np.ptp(days) > 0
    expect = (taus[0] * (1.5 * 1000.0 * 1600.0 / 900.0)
              * 3.085677581491367e19 / 299792.458 / 86400.0)
    npt.assert_allclose(days[0], expect, rtol=1e-6)
    npt.assert_allclose(days, np.asarray(JS.time_delay_days(
        jnp.asarray(taus), 0.5, 1000.0, 1600.0, 900.0)), rtol=1e-6)
