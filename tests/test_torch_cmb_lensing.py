"""PyTorch port vs JAX package on the CPU: CMB lensing
(astrild_tpu_torch/ops/cmb_lensing.py against astrild_tpu/ops/
cmb_lensing.py), mirroring tests/test_cmb_lensing.py, and the two example
paths that run it: examples/cmb_lensing_loop.py stage by stage at its own
parameters and examples/full_pipeline.py's full-sky lightcone stage at
nside 32, in both packages from the same inputs.

Flat-sky maps are numpy Gaussian fields from a seed, as in the JAX tests;
HEALPix CMB maps come from `sht.synfast_from_white` fed the JAX package's
draws. Tolerances, each stated where it is checked: the forward remap
within 1e-5 of the map's max (measured 2.5e-6); the response grid within
2e-6 of its max (measured 3.8e-7); the estimators on the modes the
response supports (R above 1e-3 of its max: the rest divide float32
roundoff by a response near zero in both packages) within 2e-5 of the
largest mode for TT (measured 3.8e-6) and 1e-4 for EB (measured 4.2e-5),
and N0 within 1e-4 relative for TT (measured 1.4e-5) and 5e-4 for EB
(measured 1.6e-4); the curved-sky estimator within 1e-4 of its largest
alm (measured 2.9e-5 on the scan path).
"""
import importlib.util
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from astrild_tpu.models.skyhealpix import SkyHealpix as JSH  # noqa: E402
from astrild_tpu.ops import cmb_lensing as jcml  # noqa: E402
from astrild_tpu.ops import lightcone_sphere as JLS  # noqa: E402
from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu_torch.models.skyhealpix import SkyHealpix  # noqa: E402
from astrild_tpu_torch.ops import cmb_lensing as cml  # noqa: E402
from astrild_tpu_torch.ops import lightcone_sphere as TLS  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402
from astrild_tpu_torch.utils import healpix as TH  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FOV = np.deg2rad(10.0)
LMAX = 3000
N = 128
PIX = FOV / N
LF = 2 * np.pi / FOV


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


def _cl_tt():
    ell = np.arange(LMAX + 1, dtype=np.float64)
    cl = np.zeros(LMAX + 1)
    cl[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1.0)) \
        * np.exp(-(ell[2:] / 2000.0) ** 2)
    return cl


def _grf(key, cl, n=N):
    rng = np.random.default_rng(key)
    w = rng.standard_normal((n, n))
    lx = np.fft.fftfreq(n)[:, None] * n * LF
    ly = np.fft.fftfreq(n)[None, :] * n * LF
    lm = np.hypot(lx, ly)
    c = np.interp(lm, np.arange(len(cl)), cl, left=0, right=0)
    pix = FOV / n
    return (np.real(np.fft.ifft2(np.fft.fft2(w) * np.sqrt(c))) / pix
            ).astype(np.float32)


def _T(a):
    return torch.from_numpy(np.array(a))


def _qe(t, cl, **kw):
    return cml.qe_tt_kappa(_T(t), FOV, cl, lmin=40, lmax_filter=1200,
                           **kw)[0].numpy()


def _lens(t, kap):
    return cml.lens_cmb_map_flat(_T(t), _T(kap), FOV).numpy()


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------- the JAX package's own tests
def test_lens_map_gradient_order():
    """T(x + d) - T(x) == d . grad T at first order for smooth fields."""
    x = np.arange(N) * PIX
    t = np.sin(4 * LF * x)[:, None] * np.ones((1, N), np.float32)
    kap = (1e-3 * np.cos(2 * LF * x))[:, None] * np.ones((1, N))
    lensed = _lens(t.astype(np.float32), kap.astype(np.float32))
    # for kap = A cos(Lx): phi = -2A/L^2 cos(Lx), d1 = 2A/L sin(Lx)
    L0 = 2 * LF
    d1 = 2e-3 / L0 * np.sin(L0 * x)
    want = np.sin(4 * LF * (x + d1))[:, None] * np.ones((1, N))
    npt.assert_allclose(lensed, want, atol=5e-4)


def test_lens_map_zero_kappa_identity():
    t = _grf(1, _cl_tt())
    npt.assert_allclose(_lens(t, np.zeros_like(t)), t, atol=1e-7)


def test_qe_pure_mode_response_unit():
    """The ensemble-mean reconstruction of a pure kappa mode is the input
    mode with unit normalization (lensed - unlensed of the same T cancels
    the Gaussian noise)."""
    cl = _cl_tt()
    x = np.arange(N) * PIX
    A = 3e-3
    R = cml.qe_tt_response(N, FOV, cl, lmin=40, lmax_filter=1200,
                           device="cpu")
    for kmode in (6, 12):
        L0 = kmode * LF
        kap = (A * np.cos(L0 * x)[:, None] * np.ones((1, N))
               ).astype(np.float32)
        acc = 0.0
        for r in range(15):
            t = _grf(1000 + r, cl)
            acc = acc + (_qe(_lens(t, kap), cl, response=R)
                         - _qe(t, cl, response=R))
        acc /= 15
        proj = 2 * np.mean(acc * np.cos(L0 * x)[:, None]) / A
        assert abs(proj - 1.0) < 0.12, (kmode, proj)


def test_qe_n0_matches_unlensed_auto():
    """kappa_hat of unlensed skies is pure reconstruction noise with power
    N0 (the R of the normalization)."""
    cl = _cl_tt()
    lx = np.fft.fftfreq(N)[:, None] * N * LF
    ly = np.fft.fftfreq(N)[None, :] * N * LF
    lm = np.hypot(lx, ly)
    n0 = cml.qe_tt_n0_kappa(N, FOV, cl, lmin=40, lmax_filter=1200,
                            device="cpu").numpy()
    band = (lm > 4 * LF) & (lm < 18 * LF)
    acc = []
    for r in range(12):
        khat = _qe(_grf(3000 + r, cl), cl)
        kl = PIX ** 2 * np.fft.fft2(khat)
        acc.append((np.abs(kl) ** 2 / FOV ** 2)[band])
    ratio = np.mean(np.concatenate(acc)) / np.mean(n0[band])
    assert abs(ratio - 1.0) < 0.2, ratio


def test_qe_mc_cross_correlation():
    """GRF kappa: the kappa_hat x kappa cross-spectrum equals the kappa
    auto-spectrum (unit bias) band by band."""
    cl = _cl_tt()
    ell = np.arange(LMAX + 1, dtype=np.float64)
    cl_kk = np.zeros(LMAX + 1)
    cl_kk[2:] = 3e-7 / (1 + ell[2:] / 300.0) ** 2
    lx = np.fft.fftfreq(N)[:, None] * N * LF
    ly = np.fft.fftfreq(N)[None, :] * N * LF
    lm = np.hypot(lx, ly).ravel()
    edges = np.linspace(3 * LF, 15 * LF, 5)
    idx = np.digitize(lm, edges) - 1

    def bands(a, b):
        fa = PIX ** 2 * np.fft.fft2(a)
        fb = PIX ** 2 * np.fft.fft2(b)
        cr = (np.real(fa * np.conj(fb)) / FOV ** 2).ravel()
        return np.array([cr[idx == i].mean() for i in range(4)])

    R = cml.qe_tt_response(N, FOV, cl, lmin=40, lmax_filter=1200,
                           device="cpu")
    cx = ca = 0.0
    for r in range(16):
        t = _grf(100 + r, cl)
        kap = _grf(900 + r, cl_kk)
        khat = _qe(_lens(t, kap), cl, response=R)
        cx = cx + bands(khat, kap)
        ca = ca + bands(kap, kap)
    ratio = cx / ca
    assert np.all(np.abs(ratio - 1.0) < 0.35), ratio
    assert abs(ratio.mean() - 1.0) < 0.15, ratio


def test_qe_noise_spectrum_raises_n0():
    """Instrument noise in the filter raises N0 everywhere on the joint
    support, away from the |L| ~ 2 lmax_filter sliver where R is
    roundoff."""
    cl = _cl_tt()
    nl = np.full(LMAX + 1, np.interp(1000, np.arange(LMAX + 1), cl))
    n0a = cml.qe_tt_n0_kappa(N, FOV, cl, lmin=40, lmax_filter=1200,
                             device="cpu").numpy()
    n0b = cml.qe_tt_n0_kappa(N, FOV, cl, nl_tt=nl, lmin=40,
                             lmax_filter=1200, device="cpu").numpy()
    lx = np.fft.fftfreq(N)[:, None] * N * LF
    ly = np.fft.fftfreq(N)[None, :] * N * LF
    lm = np.hypot(lx, ly)
    ok = (n0a > 0) & (n0b > 0) & (lm < 2 * 1200 * 0.9)
    assert ok.sum() > 100
    assert np.all(n0b[ok] >= n0a[ok] * 0.999)
    assert np.mean(n0b[ok] / n0a[ok]) > 1.5


def _qu_from_e(key, cl_ee):
    """Pure-E Stokes maps (B identically zero)."""
    rng = np.random.default_rng(key)
    w = rng.standard_normal((N, N))
    lx = np.fft.fftfreq(N)[:, None] * N * LF
    ly = np.fft.fftfreq(N)[None, :] * N * LF
    lm = np.hypot(lx, ly)
    l2 = lx ** 2 + ly ** 2
    safe = np.where(l2 == 0, 1, l2)
    cos2 = np.where(l2 == 0, 1, (lx ** 2 - ly ** 2) / safe)
    sin2 = np.where(l2 == 0, 0, 2 * lx * ly / safe)
    c = np.interp(lm, np.arange(len(cl_ee)), cl_ee, left=0, right=0)
    ek = np.fft.fft2(w) * np.sqrt(c) / PIX
    q = np.real(np.fft.ifft2(cos2 * ek)).astype(np.float32)
    u = np.real(np.fft.ifft2(sin2 * ek)).astype(np.float32)
    return q, u


def _cl_ee():
    ell = np.arange(LMAX + 1, dtype=np.float64)
    cl = np.zeros(LMAX + 1)
    cl[2:] = 4e-11 / (ell[2:] * (ell[2:] + 1.0)) \
        * np.exp(-(ell[2:] / 2000.0) ** 2)
    return cl


def _eb(q, u, cl, **kw):
    return cml.qe_eb_kappa(_T(q), _T(u), FOV, cl, lmin=40, lmax_filter=600,
                           **kw)


def test_qe_eb_unlensed_null():
    """Pure-E unlensed sky: the EB reconstruction sits at the float32
    noise floor, far below a lensed reconstruction of the same sky."""
    cl = _cl_ee()
    q, u = _qu_from_e(5, cl)
    null, _ = _eb(q, u, cl)
    x = np.arange(N) * PIX
    kap = (3e-3 * np.cos(6 * LF * x)[:, None] * np.ones((1, N))
           ).astype(np.float32)
    lensed, _ = _eb(_lens(q, kap), _lens(u, kap), cl)
    assert float(null.std()) < 0.05 * float(lensed.std())


def test_qe_eb_pure_mode_response_unit():
    """The ensemble-mean EB reconstruction of a pure kappa mode is
    unit-normalized (the forward remap damps the generated B modes a few
    percent, hence the tolerance)."""
    cl = _cl_ee()
    x = np.arange(N) * PIX
    A = 3e-3
    L0 = 6 * LF
    kap = (A * np.cos(L0 * x)[:, None] * np.ones((1, N))
           ).astype(np.float32)
    acc = 0.0
    for r in range(12):
        q, u = _qu_from_e(700 + r, cl)
        k1 = _eb(_lens(q, kap), _lens(u, kap), cl)[0].numpy()
        k0 = _eb(q, u, cl)[0].numpy()
        acc = acc + (k1 - k0)
    acc /= 12
    proj = 2 * np.mean(acc * np.cos(L0 * x)[:, None]) / A
    assert abs(proj - 1.0) < 0.12, proj


def test_qe_eb_n0_zero_without_noise_and_positive_with():
    cl = _cl_ee()
    q, u = _qu_from_e(6, cl)
    _, n0a = _eb(q, u, cl)
    assert float(n0a.abs().max()) == 0.0
    _, n0b = _eb(q, u, cl, nl_bb=np.full(LMAX + 1, 1e-13))
    assert float(n0b.max()) > 0
    assert bool((n0b >= 0).all())


def _healpix_cl(Lf):
    ell = np.arange(Lf + 1, dtype=np.float64)
    cl_tt = np.zeros(Lf + 1)
    cl_tt[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1.0))
    return cl_tt


def _jax_white(key, L):
    """The JAX package's synfast draws: normal(k1), normal(k2) of
    split(key)."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (L + 1, L + 1))),
            np.asarray(jax.random.normal(k2, (L + 1, L + 1))))


def _synfast(key, cl, nside, L):
    return TS.synfast_from_white(*_jax_white(key, L), cl, nside, L,
                                 device="cpu")


@pytest.mark.slow
def test_qe_tt_healpix_pure_mode_response():
    """Curved-sky TT estimator: the ensemble-mean reconstruction of a pure
    kappa alm lands on the input within the flat normalization's
    envelope."""
    nside, Lf = 64, 120
    cl_tt = _healpix_cl(Lf)
    sky = SkyHealpix(np.zeros(TH.nside2npix(nside), np.float32),
                     device="cpu")
    L0, A = 20, 2e-2
    kre = torch.zeros((Lf + 1, Lf + 1))
    kre[L0, 0] = A
    kap = TS.synthesize(kre, torch.zeros_like(kre), nside, Lf)
    acc = 0.0
    for r in range(10):
        cmb = _synfast(jax.random.PRNGKey(50 + r), cl_tt, nside, Lf)
        lensed = sky.lens_cmb_from_kappa(cmb, kap, lmax=Lf)
        k1 = cml.qe_tt_kappa_healpix(_T(lensed.astype(np.float32)), cl_tt,
                                     lmin=10, lmax_filter=Lf, lmax_out=40)
        k0 = cml.qe_tt_kappa_healpix(cmb, cl_tt, lmin=10, lmax_filter=Lf,
                                     lmax_out=40)
        acc = acc + (k1[0] - k0[0]).numpy()
    ratio = acc[L0, 0] / 10 / A
    assert 0.85 < ratio < 1.4, ratio


def test_qe_healpix_scan_matches_tables():
    """method='scan' reproduces the table path on the same map; an unknown
    method raises."""
    nside, Lf = 32, 60
    cl_tt = _healpix_cl(Lf)
    cmb = _synfast(jax.random.PRNGKey(3), cl_tt, nside, Lf)
    kt = cml.qe_tt_kappa_healpix(cmb, cl_tt, lmin=8, lmax_filter=Lf,
                                 lmax_out=30, method="tables")
    ks = cml.qe_tt_kappa_healpix(cmb, cl_tt, lmin=8, lmax_filter=Lf,
                                 lmax_out=30, method="scan")
    npt.assert_allclose(ks[2].numpy(), kt[2].numpy(), rtol=1e-5)
    scale = float(kt[0].abs().max())
    npt.assert_allclose(ks[0].numpy(), kt[0].numpy(), atol=2e-3 * scale)
    npt.assert_allclose(ks[1].numpy(), kt[1].numpy(), atol=2e-3 * scale)
    with pytest.raises(ValueError):
        cml.qe_tt_kappa_healpix(cmb, cl_tt, method="banana")


# ------------------------------------------------------ parity with JAX
def _supported(R, frac=1e-3):
    R = R.numpy() if isinstance(R, torch.Tensor) else np.asarray(R)
    return R > frac * R.max()


def _modes_close(got, want, mask, tol=2e-5):
    fg = np.fft.fft2(got.numpy().astype(np.float64))
    fw = np.fft.fft2(np.asarray(want, np.float64))
    assert np.abs(fg - fw)[mask].max() <= tol * np.abs(fw[mask]).max()


def test_lens_cmb_map_flat_matches_jax():
    cl = _cl_tt()
    t, kap = _grf(1, cl), _grf(2, 3e-7 / (1 + np.arange(LMAX + 1) / 300.0))
    assert _rel(cml.lens_cmb_map_flat(_T(t), _T(kap), FOV),
                jcml.lens_cmb_map_flat(t, kap, FOV)) < 1e-5


def test_qe_tt_response_n0_and_kappa_match_jax():
    cl = _cl_tt()
    nl = np.full(LMAX + 1, 0.3 * np.interp(1000, np.arange(LMAX + 1), cl))
    R = cml.qe_tt_response(N, FOV, cl, nl_tt=nl, lmin=40, lmax_filter=1200,
                           device="cpu")
    jR = jcml.qe_tt_response(N, FOV, cl, nl_tt=nl, lmin=40,
                             lmax_filter=1200)
    assert _rel(R, jR) < 2e-6
    ok = _supported(jR)
    n0 = cml.qe_tt_n0_kappa(N, FOV, cl, nl_tt=nl, lmin=40,
                            lmax_filter=1200, device="cpu").numpy()
    jn0 = np.asarray(jcml.qe_tt_n0_kappa(N, FOV, cl, nl_tt=nl, lmin=40,
                                         lmax_filter=1200))
    npt.assert_allclose(n0[ok], jn0[ok], rtol=1e-4)
    t = _grf(7, cl)
    got = cml.qe_tt_kappa(_T(t), FOV, cl, nl_tt=nl, lmin=40,
                          lmax_filter=1200)
    want = jcml.qe_tt_kappa(t, FOV, cl, nl_tt=nl, lmin=40,
                            lmax_filter=1200)
    _modes_close(got[0], want[0], ok)
    npt.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok],
                        rtol=1e-4)
    # the same map with the precomputed response
    again = cml.qe_tt_kappa(_T(t), FOV, cl, nl_tt=nl, lmin=40,
                            lmax_filter=1200, response=R)
    npt.assert_array_equal(again[0].numpy(), got[0].numpy())


def test_qe_eb_kappa_matches_jax():
    cl = _cl_ee()
    q, u = _qu_from_e(5, cl)
    x = np.arange(N) * PIX
    kap = (3e-3 * np.cos(6 * LF * x)[:, None] * np.ones((1, N))
           ).astype(np.float32)
    ql, ul = _lens(q, kap), _lens(u, kap)
    nl = np.full(LMAX + 1, 1e-13)
    got = _eb(ql, ul, cl, nl_bb=nl)
    want = jcml.qe_eb_kappa(ql, ul, FOV, cl, nl_bb=nl, lmin=40,
                            lmax_filter=600)
    # the EB response on the same grid, from the port's own sum
    oa = torch.tensor(FOV, dtype=torch.float32)
    lx, ly, lm = cml._l_grids(N, oa)
    cos2, sin2 = cml._trig2(N, "cpu")
    C = cml._interp_cl(torch.from_numpy(cl.astype(np.float32)), lm)
    band = (lm >= 40) & (lm <= 600)
    FE = torch.where(band & (C > 0), 1.0 / torch.where(C > 0, C, 1.0), 0.0)
    FB = torch.where(band, 1e13, 0.0)
    ok = _supported(cml._eb_quad_sum(N, lx, ly, C, FE, FB, cos2, sin2))
    # four more convolutions than TT, differences of them: 1e-4 of the
    # largest supported mode (measured 4.2e-5)
    _modes_close(got[0], want[0], ok, tol=1e-4)
    # N0 is a ratio of two such sums: 5e-4 (measured 1.6e-4)
    npt.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok],
                        rtol=5e-4)


@pytest.mark.parametrize("method", ["tables", "scan"])
def test_qe_tt_kappa_healpix_matches_jax(method):
    nside, Lf = 32, 60
    cl_tt = _healpix_cl(Lf)
    cmb = np.asarray(JS.synfast(jax.random.PRNGKey(3), cl_tt, nside,
                                lmax=Lf)).astype(np.float32)
    nl = np.full(Lf + 1, 1e-13)
    got = cml.qe_tt_kappa_healpix(_T(cmb), cl_tt, nl_tt=nl, lmin=8,
                                  lmax_filter=Lf, lmax_out=30,
                                  method=method)
    want = jcml.qe_tt_kappa_healpix(cmb, cl_tt, nl_tt=nl, lmin=8,
                                    lmax_filter=Lf, lmax_out=30,
                                    method=method)
    scale = np.abs(np.asarray(want[0])).max()
    for g, w in zip(got[:2], want[:2]):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * scale)
    npt.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_flat_response_radial_bit_for_bit():
    cl = _healpix_cl(200)
    nl = np.full(201, 1e-14)
    L = np.array([1.0, 5.0, 40.0, 150.0])
    npt.assert_array_equal(
        cml._flat_response_radial(L, cl, nl, 8, 200),
        jcml._flat_response_radial(L, cl, nl, 8, 200))
    F, W = cml._qe_filter_weights(cl, nl, 8, 150)
    jF, jW = jcml._qe_filter_weights(cl, nl, 8, 150)
    npt.assert_array_equal(F, jF)
    npt.assert_array_equal(W, jW)


def test_numpy_input_placement():
    cl = _cl_tt()
    t = _grf(1, cl, n=16)
    n = 16
    calls = (lambda **k: cml.lens_cmb_map_flat(t, t, FOV, **k),
             lambda **k: cml.qe_tt_response(n, FOV, cl, lmax_filter=600,
                                            **k),
             lambda **k: cml.qe_tt_kappa(t, FOV, cl, lmax_filter=600, **k),
             lambda **k: cml.qe_tt_n0_kappa(n, FOV, cl, lmax_filter=600,
                                            **k),
             lambda **k: cml.qe_eb_kappa(t, t, FOV, cl, lmax_filter=600,
                                         **k),
             lambda **k: cml.qe_tt_kappa_healpix(
                 np.zeros(TH.nside2npix(4), np.float32), _healpix_cl(8),
                 **k))
    for call in calls:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        out = call(device="cpu")
        for x in (out if isinstance(out, tuple) else (out,)):
            assert x.device.type == "cpu"
    assert cml.qe_tt_kappa(_T(t), FOV, cl, lmax_filter=600)[0].device.type \
        == "cpu"


# ------------------------------------------------- the examples' paths
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    return spec, importlib.util.module_from_spec(spec)


def test_cmb_lensing_loop_stages_match_jax():
    """examples/cmb_lensing_loop.py at its own parameters, stage by stage,
    each stage from the same inputs in both packages: (1) its HEALPix
    shells (the float32 pixel decisions move a few particles) and the Born
    kappa of the JAX shells, (2) the lensed CMB
    of the JAX package's synfast draws by the JAX kappa, (3) the flat-patch
    QE over its 8 patches (per-patch modes on the supported set, the
    cross ratio), (4) the curved-sky QE of the JAX lensed map."""
    BOX, NSIDE = 400.0, 32
    LMAX_EX = 2 * NSIDE
    rng = np.random.default_rng(5)
    pos = tuple(rng.uniform(0, BOX, 400_000).astype(np.float32)
                for _ in range(3))
    edges = np.linspace(150.0, 550.0, 6)
    jd, jchis, jdchis = JLS.density_shells_healpix(pos, edges, NSIDE, BOX)
    jkappa = np.asarray(JLS.born_convergence_healpix(jd, jchis, jdchis,
                                                     700.0, 0.31))
    td, tchis, tdchis = TLS.density_shells_healpix(
        tuple(_T(c) for c in pos), edges, NSIDE, BOX)
    # a particle the float32 pixel decision moves changes two pixels'
    # delta by 1/expected each: at most 0.1% of them moved
    assert np.abs(td.numpy() - np.asarray(jd)).sum() <= 2e-3 * td.numel()
    tkappa = TLS.born_convergence_healpix(_T(np.asarray(jd)), tchis, tdchis,
                                          700.0, 0.31)
    assert _rel(tkappa, jkappa) < 1e-6

    # 2. lens the CMB
    ell = np.arange(LMAX_EX + 1, dtype=np.float64)
    cl_tt = np.zeros(LMAX_EX + 1)
    cl_tt[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1.0))
    jcmb = np.asarray(JS.synfast(jax.random.PRNGKey(0), cl_tt, NSIDE,
                                 lmax=LMAX_EX))
    tcmb = _synfast(jax.random.PRNGKey(0), cl_tt, NSIDE, LMAX_EX)
    assert _rel(tcmb, jcmb) < 2e-6
    jlensed = JSH.from_array(np.zeros_like(jcmb)).lens_cmb_from_kappa(
        jcmb, jkappa, lmax=LMAX_EX)
    tlensed = SkyHealpix(np.zeros_like(jcmb), device="cpu") \
        .lens_cmb_from_kappa(jcmb, jkappa, lmax=LMAX_EX)
    # the float32 remap of the same map by deflections an ulp apart: 2e-5
    # of the CMB's max (measured 6.4e-6; the lensing imprint is 1e-3 of it)
    npt.assert_allclose(tlensed, jlensed, atol=2e-5 * np.abs(jcmb).max())

    # 3. flat-patch QE reconstruction over 8 patches
    n, fov, lmax_flat = 128, np.deg2rad(10.0), 2000
    ellf = np.arange(lmax_flat + 1, dtype=np.float64)
    cl_f = np.zeros(lmax_flat + 1)
    cl_f[2:] = 1e-10 / (ellf[2:] * (ellf[2:] + 1.0)) \
        * np.exp(-(ellf[2:] / 1500.0) ** 2)
    cl_kk = np.zeros(lmax_flat + 1)
    cl_kk[2:] = 3e-7 / (1 + ellf[2:] / 300.0) ** 2
    pix = fov / n

    def grf(seed, cl):
        r = np.random.default_rng(seed)
        w = r.standard_normal((n, n))
        lx = np.fft.fftfreq(n)[:, None] * n * 2 * np.pi / fov
        ly = np.fft.fftfreq(n)[None, :] * n * 2 * np.pi / fov
        c = np.interp(np.hypot(lx, ly), np.arange(len(cl)), cl, left=0,
                      right=0)
        return (np.real(np.fft.ifft2(np.fft.fft2(w) * np.sqrt(c)))
                / pix).astype(np.float32)

    jR = jcml.qe_tt_response(n, fov, cl_f, lmin=40, lmax_filter=1200)
    tR = cml.qe_tt_response(n, fov, cl_f, lmin=40, lmax_filter=1200,
                            device="cpu")
    ok = _supported(jR)
    lx = np.fft.fftfreq(n)[:, None] * n * 2 * np.pi / fov
    ly = np.fft.fftfreq(n)[None, :] * n * 2 * np.pi / fov
    band = (np.hypot(lx, ly) > 100) & (np.hypot(lx, ly) < 500)
    ratios = {}
    for name, (lens, qe, R, wrap) in {
            "jax": (jcml.lens_cmb_map_flat, jcml.qe_tt_kappa, jR,
                    np.asarray),
            "torch": (cml.lens_cmb_map_flat, cml.qe_tt_kappa, tR,
                      lambda a: a.numpy())}.items():
        cx = ca = 0.0
        khats = []
        for r in range(8):
            t, kap_f = grf(10 + r, cl_f), grf(90 + r, cl_kk)
            if name == "torch":
                t, kap_f = _T(t), _T(kap_f)
            tl = lens(t, kap_f, fov)
            khat = wrap(qe(tl, fov, cl_f, lmin=40, lmax_filter=1200,
                           response=R)[0])
            khats.append(khat)
            fa = pix ** 2 * np.fft.fft2(khat)
            fb = pix ** 2 * np.fft.fft2(wrap(kap_f) if name == "torch"
                                        else kap_f)
            cx += np.real(fa * np.conj(fb))[band].mean()
            ca += (np.abs(fb) ** 2)[band].mean()
        ratios[name] = (cx / ca, khats)
    for kt, kj in zip(ratios["torch"][1], ratios["jax"][1]):
        _modes_close(torch.from_numpy(kt), kj, ok, tol=1e-4)
    assert abs(ratios["torch"][0] - ratios["jax"][0]) < 1e-4

    # 4. curved-sky QE of the JAX lensed map
    want = jcml.qe_tt_kappa_healpix(np.asarray(jlensed, np.float32), cl_tt,
                                    lmin=8, lmax_filter=LMAX_EX,
                                    lmax_out=LMAX_EX // 2)
    got = cml.qe_tt_kappa_healpix(_T(np.asarray(jlensed, np.float32)),
                                  cl_tt, lmin=8, lmax_filter=LMAX_EX,
                                  lmax_out=LMAX_EX // 2)
    assert bool(torch.isfinite(got[0]).all())
    scale = np.abs(np.asarray(want[0])).max()
    for g, w in zip(got[:2], want[:2]):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * scale)
    npt.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_full_pipeline_full_sky_lightcone_stage_matches_jax():
    """examples/full_pipeline.py's full-sky lightcone stage at nside 32 on
    the JAX package's synthetic particles (fewer than the example's, the
    same box and shells): the shells' deltas within the particles the
    float32 pixel decisions move, then, from the JAX shells, the traced
    kappa / omega, the Born map and the shear E/B spectra against the JAX
    facade's."""
    spec, ex = _example("full_pipeline")
    spec.loader.exec_module(ex)
    pos = np.asarray(ex.synthetic_particles(jax.random.PRNGKey(9), 32 ** 3))
    edges = np.linspace(150.0, 650.0, 6)
    nside, chi_s = 32, 700.0
    comps = (pos[:, 0], pos[:, 1], pos[:, 2])
    jd, jchis, jdchis = JLS.density_shells_healpix(comps, edges, nside,
                                                   ex.BOX)
    td, _, _ = TLS.density_shells_healpix(tuple(_T(c) for c in comps),
                                          edges, nside, ex.BOX)
    jd = np.asarray(jd)
    # a moved particle changes two pixels' delta by 1/expected each
    assert np.abs(td.numpy() - jd).sum() <= 1e-3 * np.abs(jd).sum()
    jsky = JSH.from_multiplane_shells(jd, np.asarray(jchis),
                                      np.asarray(jdchis), chi_s, 0.31,
                                      lmax=2 * nside)
    tsky = SkyHealpix.from_multiplane_shells(jd, np.asarray(jchis),
                                             np.asarray(jdchis), chi_s,
                                             0.31, lmax=2 * nside,
                                             device="cpu")
    npt.assert_allclose(tsky.data["orig"].numpy(), jsky.data["orig"],
                        atol=5e-7)
    npt.assert_allclose(tsky.data["omega"].numpy(), jsky.data["omega"],
                        atol=5e-7)
    jborn = np.asarray(JLS.born_convergence_healpix(jd, jchis, jdchis,
                                                    chi_s, 0.31))
    tborn = TLS.born_convergence_healpix(_T(jd), np.asarray(jchis),
                                         np.asarray(jdchis), chi_s, 0.31)
    npt.assert_allclose(tborn.numpy(), jborn, atol=1e-6 * np.abs(jborn).max())
    jee, jbb, _ = jsky.shear_eb_spectra(lmax=2 * nside)
    tee, tbb, _ = tsky.shear_eb_spectra(lmax=2 * nside)
    npt.assert_allclose(tee, jee, rtol=1e-3, atol=1e-4 * np.max(jee))
    npt.assert_allclose(tbb, jbb, atol=1e-3 * np.max(jee))
