"""PyTorch port vs JAX package on the CPU: the shear-survey path's
two-point statistics (astrild_tpu_torch/ops/shear_2pt.py, the spin-2 maps
of ops/angular_power.py, ops/sht_spin.py) and examples/shear_survey.py
stages 1-6.

Inputs are made with numpy from a seed and handed to both packages; random
functions go through their `_from_white` forms with the JAX package's own
draws. Host copies are held bit for bit, bin counts equal, float32 maps
and FFT outputs within 1e-5 of the largest value, catalog sums to rtol
1e-5 with equal pair counts. Each tolerance is stated where it is checked.
"""
import dataclasses

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import angular_power as JAP  # noqa: E402
from astrild_tpu.ops import shear_2pt as J  # noqa: E402
from astrild_tpu.ops import sht_spin as JSS  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TAP  # noqa: E402
from astrild_tpu_torch.ops import shear_2pt as T  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402

ARCMIN = np.pi / 180.0 / 60.0
MAP_TOL = 1e-5  # float32 maps / FFT outputs: of the largest |value|


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


def _smooth_cl(ells, amp=1e-8, l0=300.0):
    return amp / (1.0 + (np.asarray(ells, float) / l0) ** 2) ** 1.5


def _band_limited_table(amp=1e-8, l0=800.0, lmax=1400.0):
    ells = np.concatenate([np.arange(2.0, lmax), [lmax + 10.0, 40000.0]])
    cl = _smooth_cl(ells, amp=amp, l0=l0)
    cl[-2:] = 0.0
    return ells, cl


def _jax_white(key, n):
    """The two normal fields cl_to_flat_map draws from `key`."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (n, n))),
            np.asarray(jax.random.normal(k2, (n, n))))


def _shear_from_kappa_fourier(kappa, b_mode=False):
    """gamma_hat = e^{2 i phi_l} kappa_hat (phi from axis 0); b_mode
    rotates by i (the JAX tests' helper)."""
    n = kappa.shape[-1]
    f = np.fft.fftfreq(n) * n
    l1, l2 = f[:, None], f[None, :]
    l2m = l1 ** 2 + l2 ** 2
    safe = np.where(l2m == 0, 1.0, l2m)
    ph = ((l1 ** 2 - l2 ** 2) + 2j * l1 * l2) / safe
    if b_mode:
        ph = 1j * ph
    g = np.fft.ifft2(ph * np.fft.fft2(np.asarray(kappa)))
    return g.real.astype(np.float32), g.imag.astype(np.float32)


# ------------------------------------------------------------- host copies
@pytest.mark.parametrize("m1, m", [(0, 0), (2, 2), (-2, 2), (0, 2)])
def test_wigner_d_rows_bit_identical(m1, m):
    x = np.cos(np.linspace(1e-3, np.pi - 1e-3, 37))
    npt.assert_array_equal(TSS._wigner_d_l_rows(96, x, m1, m),
                           JSS._wigner_d_l_rows(96, x, m1, m))


BINS = [(64, 6, 1.0, 32.0), (65, 10, 1.5, 30.0), (128, 16, 2.56, 106.7),
        (24, 5, 1.0, 11.5)]


@pytest.mark.parametrize("n, nbins, tmin, tmax", BINS)
def test_xi_pm_bins_bit_identical(n, nbins, tmin, tmax):
    got = T._xi_pm_bins(n, nbins, tmin, tmax)
    want = J._xi_pm_bins(n, nbins, tmin, tmax)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        npt.assert_array_equal(g, w)


@pytest.mark.parametrize("n, nbins, tmin, tmax", [(32, 5, 1.0, 16.0),
                                                  (33, 6, 1.5, 14.0)])
def test_annulus_weights_bit_identical(n, nbins, tmin, tmax):
    for g, w in zip(T._annulus_weights(n, nbins, tmin, tmax),
                    J._annulus_weights(n, nbins, tmin, tmax)):
        npt.assert_array_equal(g, w)


@pytest.mark.parametrize("nmax, tmin, tmax, ntheta",
                         [(3, 1.0, 100.0, 512), (5, 3.0, 85.0, 4096)])
def test_cosebis_tables_bit_identical(nmax, tmin, tmax, ntheta):
    for g, w in zip(T.linear_cosebis_filters(nmax, tmin, tmax, ntheta),
                    J.linear_cosebis_filters(nmax, tmin, tmax, ntheta)):
        npt.assert_array_equal(g, w)
    x = np.linspace(0.5, 2.0, 33)
    npt.assert_array_equal(T._trap_weights(x), J._trap_weights(x))


@pytest.mark.parametrize("case", ["plain", "noise", "bmode_window"])
def test_gaussian_covariance_bit_identical(case):
    npix, oa, nbins = 32, 1.0, 6
    ells = np.arange(2.0, 6000.0)
    cl = 2e-8 / (1 + (ells / 1500.0) ** 2) ** 1.2
    kw = {"plain": {}, "noise": {"noise_cl": 1e-10},
          "bmode_window": {"cl_b_tab_val": 0.3 * cl,
                           "theta_min_arcmin": 2.0,
                           "theta_max_arcmin": 25.0}}[case]
    th_t, cov_t = T.xi_pm_gaussian_covariance(npix, oa, ells, cl, nbins,
                                              **kw)
    th_j, cov_j = J.xi_pm_gaussian_covariance(npix, oa, ells, cl, nbins,
                                              **kw)
    npt.assert_array_equal(th_t, th_j)
    npt.assert_array_equal(cov_t, cov_j)


def test_curved_sky_sums_bit_identical():
    lmax = 128
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_e = np.where(ell >= 2, 1e-8 / (1 + (ell / 60.0) ** 2) ** 1.2, 0.0)
    th = np.array([[3.0, 30.0], [90.0, 300.0]]) * ARCMIN
    for g, w in zip(T.xi_pm_from_cl_curved(cl_e, th, cl_b=0.3 * cl_e),
                    J.xi_pm_from_cl_curved(cl_e, th, cl_b=0.3 * cl_e)):
        npt.assert_array_equal(g, w)
    for cross in ("E", "kappa"):
        npt.assert_array_equal(
            T.gamma_t_from_cl_curved(cl_e, th, cross_with=cross),
            J.gamma_t_from_cl_curved(cl_e, th, cross_with=cross))
    npt.assert_array_equal(T.w_theta_from_cl_curved(cl_e, th),
                           J.w_theta_from_cl_curved(cl_e, th))
    with pytest.raises(ValueError):
        T.gamma_t_from_cl_curved(cl_e, th, cross_with="B")


def test_cosebis_from_cl_bit_identical():
    ells = np.arange(2.0, 8000.0, 3.0)
    cl = _smooth_cl(ells)
    for g, w in zip(T.cosebis_from_cl(ells, cl, 4, 2 * ARCMIN, 60 * ARCMIN,
                                      cl_b=0.2 * cl, ntheta=512),
                    J.cosebis_from_cl(ells, cl, 4, 2 * ARCMIN, 60 * ARCMIN,
                                      cl_b=0.2 * cl, ntheta=512)):
        npt.assert_array_equal(g, w)


# -------------------------------------------------------------- spin-2 maps
@pytest.mark.parametrize("n", [64, 65, 128])
def test_cl_to_flat_map_from_white_matches_jax(n):
    """The same draws give the same map: within 1e-5 of max |kappa|."""
    ells, cl = _band_limited_table()
    key = jax.random.PRNGKey(n)
    re, im = _jax_white(key, n)
    want = JAP.cl_to_flat_map(key, jnp.asarray(ells, jnp.float32),
                              jnp.asarray(cl, jnp.float32), n, 2.0)
    got = TAP.cl_to_flat_map_from_white(torch.from_numpy(re.copy()),
                                        torch.from_numpy(im.copy()), ells,
                                        cl, n, 2.0)
    _close(got, want)


def test_cl_to_flat_map_generator_statistics():
    """A generator draw: mean zero, and its C_ell within 20% of the table
    in bands of >= 1000 grid modes (sampling error sqrt(2 / nm) <= 4.5%:
    over 4 sigma); a seed gives the same map again."""
    n, oa = 128, 2.0
    ells, cl = _band_limited_table(l0=3000.0, lmax=12000.0)
    gen = torch.Generator().manual_seed(5)
    kap = TAP.cl_to_flat_map(gen, ells, cl, n, oa, device="cpu")
    again = TAP.cl_to_flat_map(torch.Generator().manual_seed(5), ells, cl,
                               n, oa, device="cpu")
    assert torch.equal(kap, again)
    assert abs(float(kap.mean())) < 1e-3 * float(kap.std())
    kw = dict(nbins=8, ell_min=3000.0, ell_max=10000.0)
    ell_b, cl_b = TAP.cl_flat_sky(kap, oa, **kw)
    _, nm = TAP.flat_sky_mode_counts(n, oa, device="cpu", **kw)
    want = np.interp(ell_b.numpy(), ells, cl)
    sel = nm.numpy() >= 1000
    assert sel.sum() >= 3
    npt.assert_allclose(cl_b.numpy()[sel], want[sel], rtol=0.2)


@pytest.mark.parametrize("n", [64, 65])
def test_kappa_to_shear_and_eb_maps_match_jax(n):
    """Each map within 1e-5 of max |kappa|; E reproduces kappa without its
    Nyquist band and B vanishes (the JAX roundtrip test), 1e-5."""
    rng = np.random.default_rng(0)
    kap = rng.normal(size=(n, n)).astype(np.float32)
    kap -= kap.mean()
    gj = JAP.kappa_to_shear_maps(jnp.asarray(kap))
    gt = TAP.kappa_to_shear_maps(torch.from_numpy(kap))
    ej = JAP.shear_eb_maps(*gj)
    et = TAP.shear_eb_maps(*gt)
    scale = float(np.abs(kap).max())
    for g, w in zip(gt + et, gj + ej):
        _close(g, w, scale=scale)
    kh = np.fft.fft2(kap)
    f = np.fft.fftfreq(n) * n
    if n % 2 == 0:
        keep = (f[:, None] != -(n // 2)) & (f[None, :] != -(n // 2))
        kh = np.where(keep, kh, 0)
    kap_band = np.real(np.fft.ifft2(kh))
    assert float(np.abs(et[0].numpy() - kap_band).max()) < 1e-5
    assert float(et[1].abs().max()) < 1e-5


def test_cl_shear_eb_matches_jax():
    """E and B spectra of a shear pair: rtol 1e-5 of the largest EE."""
    rng = np.random.default_rng(2)
    g1 = rng.normal(size=(64, 64)).astype(np.float32)
    g2 = rng.normal(size=(64, 64)).astype(np.float32)
    want = JAP.cl_shear_eb(jnp.asarray(g1), jnp.asarray(g2), 3.0, nbins=12)
    got = TAP.cl_shear_eb(torch.from_numpy(g1), torch.from_numpy(g2), 3.0,
                          nbins=12)
    npt.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    scale = float(np.asarray(want[1]).max())
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, scale=scale)


# ----------------------------------------------------------- map estimator
@pytest.mark.parametrize("n, nbins, lo, hi", [(64, 8, None, None),
                                              (65, 10, 1.5, 30.0),
                                              (96, 14, 1.0, 60.0)])
def test_xi_pm_flat_sky_matches_jax(n, nbins, lo, hi):
    """Counts equal, empty bins NaN in both, xi within 1e-5 of max |xi+|,
    theta to rtol 1e-6."""
    rng = np.random.default_rng(n)
    g1 = rng.normal(size=(n, n)).astype(np.float32)
    g2 = rng.normal(size=(n, n)).astype(np.float32)
    oa = n / 60.0
    want = J.xi_pm_flat_sky(g1, g2, oa, nbins=nbins, theta_min_arcmin=lo,
                            theta_max_arcmin=hi)
    got = T.xi_pm_flat_sky(g1, g2, oa, nbins=nbins, theta_min_arcmin=lo,
                           theta_max_arcmin=hi, device="cpu")
    npt.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    npt.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    scale = float(np.nanmax(np.abs(np.asarray(want[1]))))
    _close(got[1], want[1], scale=scale)
    _close(got[2], want[2], scale=scale)
    with pytest.raises(ValueError, match="theta_max > theta_min"):
        T.xi_pm_flat_sky(g1, g2, oa, theta_min_arcmin=5.0,
                         theta_max_arcmin=4.0, device="cpu")


def test_xi_pm_flat_sky_matches_bruteforce():
    """Against the O(N^2) direct pair sum (the JAX test's oracle), 1e-6."""
    rng = np.random.default_rng(0)
    n = 16
    g1 = rng.normal(size=(n, n)).astype(np.float32)
    g2 = rng.normal(size=(n, n)).astype(np.float32)
    th, xp, xm, cnt = T.xi_pm_flat_sky(g1, g2, opening_angle_deg=n / 60.0,
                                       nbins=6, device="cpu")
    gam = g1 + 1j * g2
    cp = np.zeros((n, n), complex)
    cm = np.zeros((n, n), complex)
    for dr in range(n):
        for dc in range(n):
            sh = np.roll(gam, (-dr, -dc), (0, 1))
            cp[dr, dc] = np.mean(sh * np.conj(gam))
            cm[dr, dc] = np.mean(sh * gam)
    f = np.fft.fftfreq(n) * n
    dx, dy = np.meshgrid(f, f, indexing="ij")
    r2 = dx ** 2 + dy ** 2
    safe = np.where(r2 == 0, 1, r2)
    z2x, z2y = dx * dx - dy * dy, 2 * dx * dy
    cos4 = (z2x * z2x - z2y * z2y) / (safe * safe)
    sin4 = 2 * z2x * z2y / (safe * safe)
    xim_g = cm.real * cos4 + cm.imag * sin4
    edges2 = np.geomspace(1.0, n / 2.0, 7) ** 2
    idx = np.clip(np.searchsorted(edges2, r2.ravel(), side="right") - 1,
                  0, 5)
    ins = (r2.ravel() >= edges2[0]) & (r2.ravel() <= edges2[-1])
    nmb = np.maximum(np.bincount(idx, weights=ins, minlength=6), 1)
    bp = np.bincount(idx, weights=ins * cp.real.ravel(), minlength=6) / nmb
    bm = np.bincount(idx, weights=ins * xim_g.ravel(), minlength=6) / nmb
    cnt_np = np.bincount(idx, weights=ins, minlength=6)
    occ = cnt_np > 0
    npt.assert_allclose(xp.numpy()[occ], bp[occ], atol=1e-6)
    npt.assert_allclose(xm.numpy()[occ], bm[occ], atol=1e-6)
    assert np.all(np.isnan(xp.numpy()[~occ]))
    npt.assert_array_equal(cnt.numpy(), cnt_np)


def test_xi_pm_pure_e_matches_theory_and_pure_b_flips():
    """The JAX test at 512^2 over 5 deg, from the JAX package's key-3 draws:
    xi+ within 15% (+2e-8) of the input-C_ell theory between 2' and 25',
    xi- within 25% between 4' and 25'; pure B leaves xi+ (rtol 1e-5) and
    flips xi- (rtol 1e-4)."""
    n, oa = 512, 5.0
    ells, cl_tab = _band_limited_table()
    re, im = _jax_white(jax.random.PRNGKey(3), n)
    kappa = TAP.cl_to_flat_map_from_white(re.copy(), im.copy(), ells, cl_tab,
                                          n, oa, device="cpu").numpy()
    g1e, g2e = _shear_from_kappa_fourier(kappa)
    th, xpe, xme, _ = T.xi_pm_flat_sky(g1e, g2e, oa, nbins=14,
                                       theta_min_arcmin=1.0,
                                       theta_max_arcmin=60.0, device="cpu")
    tt, xp_t, xm_t = T.xi_pm_from_cl(ells, cl_tab, device="cpu")
    tt = tt.numpy() / ARCMIN
    th = th.numpy()
    xp_i = np.interp(np.log(th), np.log(tt), xp_t.numpy())
    xm_i = np.interp(np.log(th), np.log(tt), xm_t.numpy())
    sel = (th > 2.0) & (th < 25.0)
    npt.assert_allclose(xpe.numpy()[sel], xp_i[sel], rtol=0.15, atol=2e-8)
    sel_m = (th > 4.0) & (th < 25.0)
    npt.assert_allclose(xme.numpy()[sel_m], xm_i[sel_m], rtol=0.25,
                        atol=2e-8)
    g1b, g2b = _shear_from_kappa_fourier(kappa, b_mode=True)
    _, xpb, xmb, _ = T.xi_pm_flat_sky(g1b, g2b, oa, nbins=14,
                                      theta_min_arcmin=1.0,
                                      theta_max_arcmin=60.0, device="cpu")
    npt.assert_allclose(xpb.numpy(), xpe.numpy(), rtol=1e-5, atol=1e-12)
    npt.assert_allclose(xmb.numpy(), -xme.numpy(), rtol=1e-4, atol=1e-11)


# -------------------------------------------------------- tangential stack
def test_tangential_shear_stack_matches_jax():
    """Centres inside, on and across the map edge (floor-mod wrap), edges
    starting exactly on a pixel radius (2.0 = sqrt(4)) and one at sqrt(8)
    rounded to float32: annulus counts equal, radii rtol 1e-6, gamma_t and
    gamma_x within 1e-5 of max |gamma_t|."""
    rng = np.random.default_rng(4)
    n = 64
    g1 = rng.normal(size=(n, n)).astype(np.float32)
    g2 = rng.normal(size=(n, n)).astype(np.float32)
    centers = np.array([[0, 0], [63, 5], [31, 32], [2, 61], [40, 17]],
                       np.int32)
    edges = np.array([2.0, np.float32(np.sqrt(8.0)), 4.0, 7.5, 12.0, 20.0],
                     np.float32)
    want = J.tangential_shear_stack(jnp.asarray(g1), jnp.asarray(g2),
                                    jnp.asarray(centers), jnp.asarray(edges),
                                    patch_half=21, nbins=5)
    got = T.tangential_shear_stack(torch.from_numpy(g1),
                                   torch.from_numpy(g2), centers, edges,
                                   patch_half=21, nbins=5)
    npt.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    npt.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    scale = float(np.abs(np.asarray(want[1])).max())
    _close(got[1], want[1], scale=scale)
    _close(got[2], want[2], scale=scale)


def test_tangential_stack_gaussian_blob():
    """gamma_t of an axisymmetric Gaussian lens against kbar(<r) - kappa(r)
    (rtol 5%, atol 5e-5; the JAX test) and the gamma_x null (< 2e-4)."""
    n, s, amp = 256, 12.0, 0.08
    f = np.fft.fftfreq(n) * n
    dx, dy = np.meshgrid(f, f, indexing="ij")
    kappa = amp * np.exp(-(dx ** 2 + dy ** 2) / (2 * s * s))
    g1, g2 = _shear_from_kappa_fourier(kappa)
    edges = np.linspace(2.0, 40.0, 13).astype(np.float32)
    r, gt, gx, cnt = T.tangential_shear_stack(
        torch.from_numpy(g1), torch.from_numpy(g2),
        torch.tensor([[0, 0]]), edges, patch_half=48, nbins=12)
    r = r.numpy()
    kbar = 2 * amp * s * s / r ** 2 * (1 - np.exp(-r ** 2 / (2 * s * s)))
    expect = kbar - amp * np.exp(-r ** 2 / (2 * s * s))
    npt.assert_allclose(gt.numpy(), expect, rtol=0.05, atol=5e-5)
    assert float(gx.abs().max()) < 2e-4


# ------------------------------------------------------------------ theory
def _hankel64(grid, vals, mu, q=1.0):
    """The cylindrical FFTLog series in float64 (numpy FFT) of the same
    float32 table and kernel, over 2 pi: the yardstick of both packages'
    float32 FFT rounding."""
    from astrild_tpu_torch.ops import fftlog as TF

    n = grid.size
    dln = float(np.log(grid[-1] / grid[0]) / (n - 1))
    k0 = grid[0]
    r = np.exp(np.arange(n) * dln) / (k0 * np.exp((n - 1) * dln))
    kern = TF._fftlog_kernel_cyl(n, dln, mu, q)
    a = (np.asarray(vals, np.float64) * (grid / k0) ** (2.0 - q)
         * TF._taper(n).astype(np.float64))
    b = np.fft.fft(a) * (kern[0].astype(np.float64)
                         + 1j * kern[1].astype(np.float64))
    out = np.real(np.fft.fft(b)) * k0 ** 2 * (k0 * r) ** (-q) / n
    return out / (2.0 * np.pi)


def _fftlog_parity(got, want, ref):
    """The FFTLog bar of tests/test_torch_tpcf.py: the port's float32
    transform is within 4x the JAX package's error of the float64 series,
    or 5e-5 of its largest |value|, whichever is larger (the biased series
    runs to 1e4-1e9 times the output and cancels, so the two float32 FFTs
    differ by up to ~1e-4 of the output's peak at the grid's ends)."""
    got = np.asarray(got, np.float64)
    err_t = np.abs(got - ref).max()
    err_j = np.abs(np.asarray(want, np.float64) - ref).max()
    assert err_t <= max(4.0 * err_j, 5e-5 * np.abs(ref).max()), (err_t,
                                                                 err_j)


def test_xi_pm_gamma_t_w_theta_from_cl_match_jax():
    """FFTLog theory from tables (C_BB included): the host log-ell table
    bit for bit, theta rtol 1e-6, values by `_fftlog_parity`."""
    ells = np.arange(2.0, 20000.0)
    cl = _smooth_cl(ells)
    for n in (2048, 1024):
        g_t, v_t = T._log_ell_table(ells, cl, n, 2.0)
        g_j, v_j = J._log_ell_table(ells, cl, n, 2.0)
        npt.assert_array_equal(g_t, g_j)
        npt.assert_array_equal(v_t, np.asarray(v_j))
    grid, ce = T._log_ell_table(ells, cl, 2048, 2.0)
    cb = T._log_ell_table(ells, 0.25 * cl, 2048, 2.0)[1]
    want = J.xi_pm_from_cl(ells, cl, cl_b=0.25 * cl)
    got = T.xi_pm_from_cl(ells, cl, cl_b=0.25 * cl, device="cpu")
    npt.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    _fftlog_parity(got[1].numpy(), want[1], _hankel64(grid, ce + cb, 0))
    _fftlog_parity(got[2].numpy(), want[2], _hankel64(grid, ce - cb, 4))
    grid, cv = T._log_ell_table(ells, cl, 1024, 2.0)
    for tf, jf, mu in ((T.gamma_t_from_cl, J.gamma_t_from_cl, 2),
                       (T.w_theta_from_cl, J.w_theta_from_cl, 0)):
        w = jf(ells, cl, n=1024)
        g = tf(ells, cl, n=1024, device="cpu")
        npt.assert_allclose(g[0].numpy(), np.asarray(w[0]), rtol=1e-6)
        _fftlog_parity(g[1].numpy(), w[1], _hankel64(grid, cv, mu))


def test_xi_plus_from_cl_vs_direct_quadrature():
    """The JAX test's oracle: direct integer-ell sums of J0 / J4 at 2', 10'
    and 30' to 2e-3."""
    from scipy.special import jv

    ells = np.arange(2.0, 20000.0)
    cl = _smooth_cl(ells)
    th, xp, xm = T.xi_pm_from_cl(ells, cl, device="cpu")
    th = th.numpy()
    for tv in (2.0, 10.0, 30.0):
        j = int(np.argmin(np.abs(th - tv * ARCMIN)))
        ex_p = np.sum(ells * cl * jv(0, ells * th[j])) / (2 * np.pi)
        ex_m = np.sum(ells * cl * jv(4, ells * th[j])) / (2 * np.pi)
        assert abs(float(xp[j]) / ex_p - 1.0) < 2e-3
        assert abs(float(xm[j]) / ex_m - 1.0) < 2e-3


def test_xi_pm_from_cl_grid_gradient_matches_jax():
    """xi on a given log grid (C_BB included), within 1e-5 of max |xi+|;
    torch.autograd.grad of sum xi+ over 2-60' in the amplitude against
    jax.grad of the same scalar, rtol 1e-5, and equal to the value (xi is
    linear in the amplitude), rtol 1e-4 (the JAX test)."""
    ell = np.geomspace(2.0, 20000.0, 1024)
    cl = (1e-8 / (1 + (ell / 800.0) ** 2) ** 1.5).astype(np.float32)
    want = J.xi_pm_from_cl_grid(ell, jnp.asarray(cl), cl_b=0.1 * cl)
    got = T.xi_pm_from_cl_grid(ell, torch.from_numpy(cl),
                               cl_b=torch.from_numpy(0.1 * cl))
    scale = float(np.abs(np.asarray(want[1])).max())
    _close(got[1], want[1], scale=scale)
    _close(got[2], want[2], scale=scale)
    th = np.asarray(want[0])
    sel = (th > 2 * ARCMIN) & (th < 60 * ARCMIN)
    g_j = float(jax.grad(lambda a: jnp.sum(
        J.xi_pm_from_cl_grid(ell, a * jnp.asarray(cl))[1][sel]))(1.0))
    a = torch.tensor(1.0, requires_grad=True)
    xp = T.xi_pm_from_cl_grid(ell, a * torch.from_numpy(cl))[1]
    (g_t,) = torch.autograd.grad(xp[torch.from_numpy(sel)].sum(), a)
    npt.assert_allclose(float(g_t), g_j, rtol=1e-5)
    npt.assert_allclose(float(g_t), float(xp.detach()[sel].sum()),
                        rtol=1e-4)


def test_delta_sigma_matches_jax():
    """Delta Sigma(r_p) of a realistic P_gm, rtol 1e-5."""
    k = np.geomspace(1e-3, 1e3, 1024)
    pk = 2e4 * (k / 0.02) / (1 + (k / 0.1) ** 3.2)
    rp = np.array([0.5, 1.0, 3.0, 8.0])
    want = np.asarray(J.delta_sigma_from_pk(k, pk, rp, 0.3))
    got = T.delta_sigma_from_pk(k, pk, rp, 0.3, device="cpu")
    npt.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert T.RHO_CRIT0_H2 == J.RHO_CRIT0_H2
    assert T.ARCMIN2RAD == J.ARCMIN2RAD and T.DEG2RAD == J.DEG2RAD


# ----------------------------------------------------------------- COSEBIs
def _xipm_table():
    ells = np.arange(2.0, 20000.0)
    cl = _smooth_cl(ells)
    th, xp, xm = J.xi_pm_from_cl(ells, cl)
    th_am = np.asarray(th) / ARCMIN
    sel = (th_am > 0.3) & (th_am < 300.0)
    return th_am[sel], np.asarray(xp)[sel], np.asarray(xm)[sel]


def test_cosebis_from_xipm_matches_jax():
    """E_n and B_n within 1e-5 of max |E| (B is the cancellation of two
    float32 integrals, so this bounds it at the float32 level); pure B
    swaps the roles (rtol 1e-5)."""
    th, xp, xm = _xipm_table()
    want = J.cosebis_from_xipm(th, xp, xm, 5, 1.0, 100.0)
    got = T.cosebis_from_xipm(th, xp, xm, 5, 1.0, 100.0, device="cpu")
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(got[0], want[0], scale=scale)
    _close(got[1], want[1], scale=scale)
    assert float(got[1].abs().max()) < 1e-4 * scale
    eb, bb = T.cosebis_from_xipm(th, xp, -xm, 5, 1.0, 100.0, device="cpu")
    npt.assert_allclose(bb.numpy(), got[0].numpy(), rtol=1e-5, atol=1e-12)


def test_cosebis_never_reaches_a_matmul():
    """With TF32 allowed by the caller, cosebis_from_xipm dispatches no
    matrix-product operator (mm, bmm, addmm, mv, dot, matmul): the filter
    integrals are elementwise products and sums, full float32 on any
    device. B_n stays below 1e-4 of max |E| (the JAX test's bar)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    th, xp, xm = _xipm_table()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with Record():
            e, b = T.cosebis_from_xipm(th, xp, xm, 5, 1.0, 100.0,
                                       device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen, "the dispatch mode recorded nothing"
    products = {"mm", "bmm", "addmm", "mv", "dot", "matmul", "baddbmm",
                "addmv", "linear", "einsum", "tensordot"}
    assert not [n for n in seen if n.split(".")[0] in products], seen
    assert float(b.abs().max()) < 1e-4 * float(e.abs().max())


def test_cosebis_filters_constraints_and_orthonormality():
    """The JAX test: the two separability constraints to 1e-4 of their
    scale, orthonormality to 1e-4."""
    tmin, tmax = 1.0, 100.0
    tg, Tp, Tm = T.linear_cosebis_filters(6, tmin, tmax)
    w = T._trap_weights(tg)
    scale1 = np.sum(w * tg * np.abs(Tp), axis=1)
    scale3 = np.sum(w * tg ** 3 * np.abs(Tp), axis=1)
    for i in range(6):
        assert abs(np.sum(w * tg * Tp[i])) < 1e-4 * scale1[i]
        assert abs(np.sum(w * tg ** 3 * Tp[i])) < 1e-4 * scale3[i]
    G = (Tp * w) @ Tp.T
    dt = 0.5 * (tmax - tmin)
    npt.assert_allclose(np.diag(G), dt, rtol=1e-4)
    assert np.max(np.abs(G - np.diag(np.diag(G)))) < 1e-4 * dt


def test_cosebis_interval_guard():
    with pytest.raises(ValueError):
        T.cosebis_from_xipm(np.array([2.0, 3.0]), np.zeros(2), np.zeros(2),
                            3, 1.0, 100.0, device="cpu")
    with pytest.raises(ValueError):
        T.linear_cosebis_filters(20, 1.0, 10.0)
    with pytest.raises(ValueError):
        T.linear_cosebis_filters(0, 1.0, 10.0)


def test_cosebis_covariance_matches_jax():
    """The propagated E and B covariances, rtol 1e-5 of their largest
    entry (the transform is float32 on both sides)."""
    npix, oa, nbins = 32, 2.0, 8
    ells = np.arange(2.0, 6000.0)
    cl = 2e-8 / (1 + (ells / 1500.0) ** 2) ** 1.2
    th, cov = J.xi_pm_gaussian_covariance(npix, oa, ells, cl, nbins,
                                          theta_min_arcmin=3.0,
                                          theta_max_arcmin=60.0)
    for g, w in zip(T.cosebis_covariance(th, cov, 3, 4.0, 50.0, ntheta=512),
                    J.cosebis_covariance(th, cov, 3, 4.0, 50.0, ntheta=512)):
        assert isinstance(g, np.ndarray)
        npt.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------------ covariances
def _jax_sampler_draws(key, n_real, n, noise):
    """The fields xi_pm_sample_covariance draws for each realization."""
    rows = []
    for k in jax.random.split(key, n_real):
        k1, k2, k3 = jax.random.split(k, 3)
        re, im = _jax_white(k1, n)
        fields = [re, im]
        if noise:
            fields += [np.asarray(jax.random.normal(k2, (n, n))),
                       np.asarray(jax.random.normal(k3, (n, n)))]
        rows.append(np.stack(fields))
    return np.stack(rows)


@pytest.mark.parametrize("noise_std", [0.0, 3e-3])
def test_xi_pm_sample_covariance_from_jax_draws(noise_std):
    """Three realizations from the JAX sampler's own draws: every sample
    within 1e-5 of max |xi+|, the mean likewise, the covariance within
    1e-4 of its largest entry (a difference of means)."""
    npix, oa, nbins = 32, 2.0, 6
    ells = np.arange(2.0, 6000.0)
    cl = 2e-8 / (1 + (ells / 1500.0) ** 2) ** 1.2
    key = jax.random.PRNGKey(7)
    want = J.xi_pm_sample_covariance(key, ells, cl, npix, oa, nbins,
                                     n_real=3, noise_std=noise_std)
    white = _jax_sampler_draws(key, 3, npix, noise_std > 0)
    got = T.xi_pm_sample_covariance_from_white(
        white, ells, cl, npix, oa, nbins, noise_std=noise_std, device="cpu")
    npt.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    scale = float(np.abs(np.asarray(want[3])).max())
    _close(got[3], want[3], scale=scale)
    _close(got[1], want[1], scale=scale)
    _close(got[2], want[2], tol=1e-4)


def test_xi_pm_sample_covariance_matches_analytic():
    """The generator sampler (400 realizations at 32^2) against the exact
    Gaussian covariance with shape noise: each std within 15% (sampling
    error of a std ~3.5%, 4 sigma), and noise raises every variance."""
    npix, oa, nbins = 32, 2.0, 5
    ells = np.arange(2.0, 6000.0)
    cl = 2e-8 / (1 + (ells / 1500.0) ** 2) ** 1.2
    ns = 3e-3
    ncl = ns ** 2 * (oa * np.pi / 180) ** 2 / npix ** 2
    _, cov_a = T.xi_pm_gaussian_covariance(npix, oa, ells, cl, nbins,
                                           noise_cl=ncl)
    th, mean, cov_m, samples = T.xi_pm_sample_covariance(
        torch.Generator().manual_seed(1), ells, cl, npix, oa, nbins,
        n_real=400, noise_std=ns)
    assert samples.shape == (400, 2 * nbins) and cov_m.shape == (10, 10)
    ratio = np.sqrt(np.diag(cov_m.numpy()) / np.diag(cov_a))
    assert np.all(np.abs(ratio - 1.0) < 0.15), ratio
    _, cov_0 = T.xi_pm_gaussian_covariance(npix, oa, ells, cl, nbins)
    assert np.all(np.diag(cov_a) > np.diag(cov_0))


def test_tomographic_sample_covariance_from_jax_draws():
    """Two bins, two realizations with shape noise, from the JAX sampler's
    own draws: samples within 1e-5 of max |xi+|, the pair list equal."""
    npix, oa, nbins, nb = 32, 2.0, 5, 2
    ells = np.arange(2.0, 6000.0)
    cl = 2e-8 / (1 + (ells / 1500.0) ** 2) ** 1.2
    stack = np.empty((nb, nb, ells.size))
    stack[0, 0], stack[1, 1] = cl, 0.6 * cl
    stack[0, 1] = stack[1, 0] = 0.5 * cl
    key = jax.random.PRNGKey(3)
    ns = 2e-3
    want = J.tomographic_xi_pm_sample_covariance(key, ells, stack, npix, oa,
                                                 nbins, n_real=2,
                                                 noise_std=ns)
    zr, zi, noise = [], [], []
    for k in jax.random.split(key, 2):
        km, kn = jax.random.split(k)
        zr.append(np.asarray(jax.random.normal(km, (npix, npix, nb))))
        zi.append(np.asarray(jax.random.normal(kn, (npix, npix, nb))))
        kk = jax.random.split(k, 2 * nb + 2)
        noise.append(np.stack([np.asarray(jax.random.normal(
            kk[i], (npix, npix))) for i in range(2 * nb)]))
    got = T.tomographic_xi_pm_sample_covariance_from_white(
        np.stack(zr), np.stack(zi), ells, stack, npix, oa, nbins,
        noise_std=ns, noise=np.stack(noise), device="cpu")
    assert got[1] == want[1] == [(0, 0), (0, 1), (1, 1)]
    npt.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    _close(got[4], want[4])
    _close(got[2], want[2], scale=float(np.abs(np.asarray(want[4])).max()))


def test_tomographic_sample_covariance_statistics():
    """One bin reduces to the single-bin sampler: each std within 20% of
    the analytic Gaussian covariance (250 realizations, 4 sigma); two
    independent equal bins: Var[xi^{01}] / Var[xi^{00}] within 0.2 of 1/2
    (Wick), with a CPU generator."""
    npix, oa, nbins = 32, 2.0, 4
    ells = np.arange(2.0, 6000.0)
    cl = 2e-8 / (1 + (ells / 1500.0) ** 2) ** 1.2
    th, pairs, _, cov_t, _ = T.tomographic_xi_pm_sample_covariance(
        torch.Generator().manual_seed(0), ells, cl[None, None, :], npix, oa,
        nbins, n_real=250)
    assert pairs == [(0, 0)]
    _, cov_a = T.xi_pm_gaussian_covariance(npix, oa, ells, cl, nbins)
    ratio = np.sqrt(np.diag(cov_t.numpy()) / np.diag(cov_a))
    assert np.all(np.abs(ratio - 1.0) < 0.2), ratio
    stack2 = np.zeros((2, 2, ells.size))
    stack2[0, 0] = stack2[1, 1] = cl
    _, pairs2, _, c2, _ = T.tomographic_xi_pm_sample_covariance(
        torch.Generator().manual_seed(1), ells, stack2, npix, oa, nbins,
        n_real=250)
    assert pairs2 == [(0, 0), (0, 1), (1, 1)]
    d = np.diag(c2.numpy())
    assert np.all(np.abs(d[2 * nbins:3 * nbins] / d[:nbins] - 0.5) < 0.2)


# --------------------------------------------------------- catalog tiles
def _catalog(n, seed, box=100.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box, n).astype(np.float32)
    y = rng.uniform(0, box, n).astype(np.float32)
    e1 = rng.normal(0, 0.2, n).astype(np.float32)
    e2 = rng.normal(0, 0.2, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, y, e1, e2, w


@pytest.mark.parametrize("n, block, boxsize, weighted",
                         [(1000, 128, None, True), (1500, 256, 100.0, True),
                          (2048, 512, 100.0, False)])
def test_xi_pm_catalog_matches_jax(n, block, boxsize, weighted):
    """Pair counts equal, xi+ and xi- within rtol 1e-5 of the largest |xi+|
    (the weighted bin sums run in the JAX package's float32 order per pair
    and a different order within a tile)."""
    x, y, e1, e2, w = _catalog(n, n)
    w = w if weighted else None
    edges = np.geomspace(2.0, 45.0, 8)
    want = J.xi_pm_catalog(x, y, e1, e2, edges, weights=w, boxsize=boxsize,
                           block=block)
    got = T.xi_pm_catalog(x, y, e1, e2, edges, weights=w, boxsize=boxsize,
                          block=block, device="cpu")
    npt.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(got[0], want[0], scale=scale)
    _close(got[1], want[1], scale=scale)


def test_xi_pm_catalog_matches_bruteforce():
    """The JAX test's numpy oracle over unordered pairs (atol 2e-6, counts
    equal)."""
    x, y, e1, e2, w = _catalog(300, 5)
    edges = np.geomspace(2.0, 50.0, 7)
    xip, xim, cnt = T.xi_pm_catalog(x, y, e1, e2, edges, weights=w,
                                    block=128, device="cpu")
    nb = 6
    num_p, num_m, den, npr = (np.zeros(nb) for _ in range(4))
    for i in range(300):
        dx = x[i] - x[i + 1:]
        dy = y[i] - y[i + 1:]
        r = np.hypot(dx, dy)
        phi = np.arctan2(dy, dx)
        sel = (r >= edges[0]) & (r < edges[-1])
        b = np.clip(np.searchsorted(edges, r, side="right") - 1, 0, nb - 1)
        ww = w[i] * w[i + 1:]
        ei = e1[i] + 1j * e2[i]
        ej = e1[i + 1:] + 1j * e2[i + 1:]
        pp = np.real(ei * np.conj(ej))
        mm = np.real(ei * ej * np.exp(-4j * phi))
        for t in np.nonzero(sel)[0]:
            num_p[b[t]] += ww[t] * pp[t]
            num_m[b[t]] += ww[t] * mm[t]
            den[b[t]] += ww[t]
            npr[b[t]] += 1
    npt.assert_allclose(xip.numpy(), num_p / np.maximum(den, 1e-30),
                        atol=2e-6)
    npt.assert_allclose(xim.numpy(), num_m / np.maximum(den, 1e-30),
                        atol=2e-6)
    npt.assert_array_equal(cnt.numpy(), npr)


def test_xi_pm_catalog_agrees_with_map_estimator():
    """A full pixel-grid catalog with periodic minimum image reproduces the
    FFT map estimator (atol 1e-5; the JAX test)."""
    rng = np.random.default_rng(1)
    n, nbins = 24, 5
    g1 = rng.normal(size=(n, n)).astype(np.float32)
    g2 = rng.normal(size=(n, n)).astype(np.float32)
    _, xp_map, xm_map, _ = T.xi_pm_flat_sky(
        g1, g2, opening_angle_deg=n / 60.0, nbins=nbins,
        theta_min_arcmin=1.0, theta_max_arcmin=11.5, device="cpu")
    rr, cc = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    edges = np.geomspace(1.0, 11.5, nbins + 1)
    xp_cat, xm_cat, _ = T.xi_pm_catalog(
        rr.ravel().astype(np.float32), cc.ravel().astype(np.float32),
        g1.ravel(), g2.ravel(), edges, boxsize=float(n), block=192,
        device="cpu")
    npt.assert_allclose(xp_cat.numpy(), xp_map.numpy(), atol=1e-5)
    npt.assert_allclose(xm_cat.numpy(), xm_map.numpy(), atol=1e-5)


@pytest.mark.parametrize("boxsize", [None, 100.0])
def test_gamma_t_catalog_matches_jax(boxsize):
    """Lenses against sources (block 128, both padded): pair counts equal,
    gamma_t and gamma_x within rtol 1e-5 of max |gamma_t|."""
    lx, ly, _, _, lw = _catalog(200, 11)
    sx, sy, e1, e2, sw = _catalog(700, 12)
    edges = np.linspace(3.0, 40.0, 6)
    want = J.gamma_t_catalog(lx, ly, sx, sy, e1, e2, edges, lens_weights=lw,
                             src_weights=sw, boxsize=boxsize, block=128)
    got = T.gamma_t_catalog(lx, ly, sx, sy, e1, e2, edges, lens_weights=lw,
                            src_weights=sw, boxsize=boxsize, block=128,
                            device="cpu")
    npt.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    scale = float(np.abs(np.asarray(want[0])).max())
    _close(got[0], want[0], scale=scale)
    _close(got[1], want[1], scale=scale)


def test_gamma_t_catalog_gaussian_blob():
    """The JAX test: the analytic gamma_t of a Gaussian lens at the
    pair-weighted radius (rtol 6%, atol 2e-5) and the gamma_x null."""
    n, s, amp = 128, 8.0, 0.05
    f = np.fft.fftfreq(n) * n
    dx, dy = np.meshgrid(f, f, indexing="ij")
    kappa = amp * np.exp(-(dx ** 2 + dy ** 2) / (2 * s * s))
    g1, g2 = _shear_from_kappa_fourier(kappa)
    rr, cc = np.meshgrid(f, f, indexing="ij")
    edges = np.linspace(3.0, 30.0, 10)
    gt, gx, cnt = T.gamma_t_catalog(
        np.zeros(1, np.float32), np.zeros(1, np.float32),
        rr.ravel().astype(np.float32), cc.ravel().astype(np.float32),
        g1.ravel(), g2.ravel(), edges, boxsize=float(n), block=256,
        device="cpu")
    r = np.hypot(rr, cc).ravel()
    rmid = np.asarray([np.mean(r[(r >= edges[i]) & (r < edges[i + 1])])
                       for i in range(9)])
    kbar = 2 * amp * s * s / rmid ** 2 * (
        1 - np.exp(-rmid ** 2 / (2 * s * s)))
    expect = kbar - amp * np.exp(-rmid ** 2 / (2 * s * s))
    npt.assert_allclose(gt.numpy(), expect, rtol=0.06, atol=2e-5)
    assert float(gx.abs().max()) < 2e-4


def test_shear_pair_tiles_reject_bad_chunks():
    """A chunk that is not a nonzero multiple of block raises (the JAX
    package's check)."""
    z = torch.zeros(100)
    with pytest.raises(ValueError, match="multiples of block"):
        T._shear_pair_tiles(*(z,) * 10, torch.tensor([1.0, 2.0]), 1, None,
                            64, True)
    with pytest.raises(ValueError, match="multiples of block"):
        T._shear_pair_tiles(*(torch.zeros(32),) * 10,
                            torch.tensor([1.0, 2.0]), 1, None, 64, True)


# ---------------------------------------------------------- placement
def test_numpy_input_placement(monkeypatch):
    """Numpy input lands on `device=`; without a card and without `device`
    the entry points raise rather than run on the CPU unasked."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(32, 32)).astype(np.float32)
    ells, cl = _band_limited_table()
    calls = {
        "xi_pm_flat_sky": lambda **kw: T.xi_pm_flat_sky(g, g, 1.0, nbins=4,
                                                        **kw)[1],
        "tangential_shear_stack": lambda **kw: T.tangential_shear_stack(
            g, g, np.array([[3, 4]]), np.array([1.0, 4.0, 8.0], np.float32),
            8, 2, **kw)[1],
        "xi_pm_catalog": lambda **kw: T.xi_pm_catalog(
            g[0], g[1], g[2], g[3], np.array([0.1, 1.0, 3.0]), block=32,
            **kw)[0],
        "gamma_t_catalog": lambda **kw: T.gamma_t_catalog(
            g[0], g[1], g[2], g[3], g[4], g[5], np.array([0.1, 1.0, 3.0]),
            block=32, **kw)[0],
        "xi_pm_from_cl": lambda **kw: T.xi_pm_from_cl(ells, cl, n=256,
                                                      **kw)[1],
        "xi_pm_from_cl_grid": lambda **kw: T.xi_pm_from_cl_grid(
            np.geomspace(1, 1e4, 64), np.ones(64, np.float32), **kw)[1],
        "gamma_t_from_cl": lambda **kw: T.gamma_t_from_cl(ells, cl, n=256,
                                                          **kw)[1],
        "w_theta_from_cl": lambda **kw: T.w_theta_from_cl(ells, cl, n=256,
                                                          **kw)[1],
        "delta_sigma_from_pk": lambda **kw: T.delta_sigma_from_pk(
            np.geomspace(1e-2, 1e2, 64), np.ones(64), [1.0], 0.3, **kw),
        "cosebis_from_xipm": lambda **kw: T.cosebis_from_xipm(
            np.geomspace(1.0, 10.0, 8), np.ones(8), np.ones(8), 2, 1.0, 10.0,
            ntheta=64, **kw)[0],
        "xi_pm_sample_covariance_from_white": lambda **kw:
            T.xi_pm_sample_covariance_from_white(
                rng.normal(size=(2, 2, 16, 16)), ells, cl, 16, 1.0, 3,
                **kw)[2],
        "cl_to_flat_map_from_white": lambda **kw:
            TAP.cl_to_flat_map_from_white(g, g, ells, cl, 32, 1.0, **kw),
        "kappa_to_shear_maps": lambda **kw: TAP.kappa_to_shear_maps(g,
                                                                    **kw)[0],
        "shear_eb_maps": lambda **kw: TAP.shear_eb_maps(g, g, **kw)[0],
        "cl_shear_eb": lambda **kw: TAP.cl_shear_eb(g, g, 1.0, nbins=4,
                                                    **kw)[1],
    }
    for name, fn in calls.items():
        assert fn(device="cpu").device.type == "cpu", name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, fn in calls.items():
        with pytest.raises(RuntimeError, match="no card"):
            fn()
        # a tensor keeps its device: no card needed
    assert T.xi_pm_flat_sky(torch.from_numpy(g), torch.from_numpy(g), 1.0,
                            nbins=4)[1].device.type == "cpu"


# ------------------------------------------- examples/shear_survey.py 1-6
NPIX_EX, OA_EX = 128, 2.0


def test_shear_survey_example_stages_1_to_6_match_jax():
    """examples/shear_survey.py stages 1-6 at 128^2 over 2 deg in both
    packages. Stage 1: each package's own halofit Limber C_ell (rtol 3e-3,
    the Limber bar of test_torch_angular_power.py); from there both take
    the JAX package's table and white noise. kappa and shear within 1e-5
    of max |kappa|; xi_pm (16 bins over 1.5-100') to rtol 1e-4 of max
    |xi+| with equal counts; COSEBIs over 3-40' (the field's half box is
    60', so the example's 85' cannot be covered: the facade raises, as in
    JAX) with E_n and B_n to 1e-4 of max |E|; the Gaussian covariance and
    its COSEBIs propagation bit for bit (rtol 1e-5 for the latter); the
    peak stack (peaks equal, profiles 1e-5 of max |gamma_t|); the catalog
    of 2048 galaxies (pair counts equal, xi to rtol 1e-5 of max |xi+|)."""
    from astrild_tpu.models.skymap import SkyArray as JSky
    from astrild_tpu.ops import peaks as JPK
    from astrild_tpu.utils.cosmology import Cosmology as JCosmology
    from astrild_tpu_torch.models import SkyArray as TSky
    from astrild_tpu_torch.ops import peaks as TPK
    from astrild_tpu_torch.utils.cosmology import Cosmology as TCosmology

    n, oa = NPIX_EX, OA_EX
    # 1. theory C_ell -> mock shear
    lf = 2.0 * np.pi / np.deg2rad(oa)
    ell_tab = np.concatenate([np.geomspace(2.0, 1.4 * lf * n / 2, 512),
                              [1.42 * lf * n / 2, 1e6]])
    jc = JCosmology()
    cl_j = np.array(JAP.cl_kappa_limber(jnp.asarray(ell_tab, jnp.float32),
                                        jc, z_source=1.0, nonlinear=True))
    tc = TCosmology.from_jax_fields(
        {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})
    cl_t = TAP.cl_kappa_limber(ell_tab, tc, z_source=1.0, nonlinear=True,
                               device="cpu").numpy()
    npt.assert_allclose(cl_t[:-2], cl_j[:-2], rtol=3e-3)
    cl_tab = cl_j
    cl_tab[-2:] = 0.0
    key = jax.random.PRNGKey(42)
    kap_j = JAP.cl_to_flat_map(key, jnp.asarray(ell_tab, jnp.float32),
                               jnp.asarray(cl_tab, jnp.float32), n, oa)
    g1j, g2j = JAP.kappa_to_shear_maps(kap_j)
    re, im = _jax_white(key, n)
    kap_t = TAP.cl_to_flat_map_from_white(re.copy(), im.copy(), ell_tab,
                                          cl_tab, n, oa, device="cpu")
    g1t, g2t = TAP.kappa_to_shear_maps(kap_t)
    kscale = float(jnp.max(jnp.abs(kap_j)))
    for g, w in ((kap_t, kap_j), (g1t, g1j), (g2t, g2j)):
        _close(g, w, scale=kscale)
    sky_j = JSky.from_array(np.asarray(kap_j), oa, "kappa_2")
    sky_j.data["shearx"], sky_j.data["sheary"] = g1j, g2j
    sky_t = TSky.from_array(kap_t, oa, "kappa_2")
    sky_t.data["shearx"], sky_t.data["sheary"] = g1t, g2t
    assert sky_t.device.type == "cpu"

    # 2. xi_pm map estimator against theory
    want = sky_j.shear_xi_pm(nbins=16, theta_min_arcmin=1.5,
                             theta_max_arcmin=100.0)
    got = sky_t.shear_xi_pm(nbins=16, theta_min_arcmin=1.5,
                            theta_max_arcmin=100.0)
    npt.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    xscale = float(np.nanmax(np.abs(np.asarray(want[1]))))
    _close(got[1], want[1], tol=1e-4, scale=xscale)
    _close(got[2], want[2], tol=1e-4, scale=xscale)
    tt_j = J.xi_pm_from_cl(ell_tab, cl_tab)
    tt_t = T.xi_pm_from_cl(ell_tab, cl_tab, device="cpu")
    grid, ce = T._log_ell_table(ell_tab, cl_tab, 2048, 2.0)
    _fftlog_parity(tt_t[1].numpy(), tt_j[1], _hankel64(grid, ce, 0))

    # 3. COSEBIs (the example's interval does not fit a 2 deg field)
    with pytest.raises(ValueError, match="coverable"):
        sky_t.cosebis(5, 3.0, 85.0)
    e_j, b_j = sky_j.cosebis(5, 3.0, 40.0)
    e_t, b_t = sky_t.cosebis(5, 3.0, 40.0)
    escale = float(np.abs(np.asarray(e_j)).max())
    _close(e_t, e_j, tol=1e-4, scale=escale)
    _close(b_t, b_j, tol=1e-4, scale=escale)

    # 4. Gaussian covariance with shape noise, and its COSEBIs
    nbar = 30.0 / ARCMIN ** 2
    noise_cl = 0.26 ** 2 / (2.0 * nbar)
    th_cj, cov_j = J.xi_pm_gaussian_covariance(
        n, oa, ell_tab, cl_tab, 16, theta_min_arcmin=1.5,
        theta_max_arcmin=100.0, noise_cl=noise_cl)
    th_ct, cov_t = T.xi_pm_gaussian_covariance(
        n, oa, ell_tab, cl_tab, 16, theta_min_arcmin=1.5,
        theta_max_arcmin=100.0, noise_cl=noise_cl)
    npt.assert_array_equal(cov_t, cov_j)
    npt.assert_array_equal(th_ct, th_cj)
    keep = np.asarray(want[3]) > 0
    th_k = th_ct[keep]
    cov_k = cov_t[np.concatenate([keep, keep])][:, np.concatenate(
        [keep, keep])]
    for g, w in zip(T.cosebis_covariance(th_k, cov_k, 5, 3.0, 40.0),
                    J.cosebis_covariance(th_k, cov_k, 5, 3.0, 40.0)):
        npt.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())

    # 5. stacked tangential shear around the kappa peaks
    cat_j = JPK.find_peaks(kap_j, threshold=2.0 * float(jnp.std(kap_j)),
                           max_peaks=64, edge_pix=24)
    cat_t = TPK.find_peaks(kap_t, threshold=2.0 * float(
        kap_t.std(correction=0)), max_peaks=64, edge_pix=24)
    nkeep = int(cat_j.n)
    assert int(cat_t.n) == nkeep > 0
    npt.assert_array_equal(cat_t.pos.numpy()[:nkeep],
                           np.asarray(cat_j.pos)[:nkeep])
    edges = np.linspace(2.0, 20.0, 11).astype(np.float32)
    st_j = J.tangential_shear_stack(
        g1j, g2j, jnp.asarray(cat_j.pos[:nkeep], jnp.int32),
        jnp.asarray(edges), patch_half=24, nbins=10)
    st_t = T.tangential_shear_stack(g1t, g2t, cat_t.pos[:nkeep], edges,
                                    patch_half=24, nbins=10)
    npt.assert_array_equal(st_t[3].numpy(), np.asarray(st_j[3]))
    gscale = float(np.abs(np.asarray(st_j[1])).max())
    _close(st_t[1], st_j[1], scale=gscale)
    _close(st_t[2], st_j[2], scale=gscale)

    # 6. catalog estimator on 2048 sampled galaxies (periodic)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, n, (2048, 2))
    pixscale = oa * 60.0 / n
    xq = (idx[:, 0] * pixscale).astype(np.float32)
    yq = (idx[:, 1] * pixscale).astype(np.float32)
    e1 = np.asarray(g1j)[idx[:, 0], idx[:, 1]]
    e2 = np.asarray(g2j)[idx[:, 0], idx[:, 1]]
    cedges = np.geomspace(3.0, 60.0, 9)
    c_j = J.xi_pm_catalog(xq, yq, e1, e2, cedges, boxsize=oa * 60.0)
    c_t = T.xi_pm_catalog(xq, yq, e1, e2, cedges, boxsize=oa * 60.0,
                          block=1024, device="cpu")
    npt.assert_array_equal(c_t[2].numpy(), np.asarray(c_j[2]))
    cscale = float(np.abs(np.asarray(c_j[0])).max())
    _close(c_t[0], c_j[0], scale=cscale)
    _close(c_t[1], c_j[1], scale=cscale)
