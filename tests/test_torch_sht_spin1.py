"""PyTorch port vs JAX package on the CPU: the spin-1 (gradient / curl,
lensing deflection) transforms of the table path
(astrild_tpu_torch/ops/sht_spin.py against astrild_tpu/ops/sht_spin.py),
mirroring tests/test_sht_spin1.py.

The d^l_{+-1,m} tables are the host float64 `wigner_d_column`, equal bit
for bit; the transforms are float32 elementwise sums where the JAX package
takes einsums, and the port writes out the adjoint the JAX package takes
from jax.vjp. Maps and alms agree with the JAX package's within 2e-6 of
their max (measured up to 3.3e-7 at nside 16, lmax 47).
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu.ops import sht_spin as JSS  # noqa: E402
from astrild_tpu.utils import healpix as JH  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402
from astrild_tpu_torch.utils import healpix as TH  # noqa: E402

TOL = 2e-6
CASES = [(8, 16), (16, 32), (16, 47)]


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


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _alm(lmax, rng, lmin=1):
    lg = np.arange(lmax + 1)[:, None]
    mg = np.arange(lmax + 1)[None, :]
    valid = (mg <= lg) & (lg >= lmin)
    re = rng.standard_normal((lmax + 1, lmax + 1)) * valid
    im = rng.standard_normal((lmax + 1, lmax + 1)) * valid * (mg > 0)
    return re.astype(np.float32), im.astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=tol * np.abs(want).max())


# ---------------------------------------------- the JAX package's own tests
def test_gradient_analytic_dipole():
    """psi = cos(theta): alpha_theta = -sin(theta), alpha_phi = 0."""
    nside, lmax = 32, 8
    re = np.zeros((lmax + 1, lmax + 1), np.float32)
    im = np.zeros_like(re)
    re[1, 0] = np.sqrt(4 * np.pi / 3)
    g = np.sqrt(2.0)
    a_t, a_p = TSS.synthesize_spin1(re * g, im, 0 * re, 0 * im, nside,
                                    lmax, device="cpu")
    theta, _ = TH.pix2ang_ring(nside, np.arange(TH.nside2npix(nside)))
    npt.assert_allclose(a_t.numpy(), -np.sin(theta), atol=2e-6)
    npt.assert_allclose(a_p.numpy(), 0.0, atol=2e-6)


def test_gradient_analytic_m1():
    """psi = sin(theta) sin(phi): alpha_theta = cos th sin ph, alpha_phi =
    cos ph (the m > 0 fold and both components)."""
    nside, lmax = 32, 8
    npix = TH.nside2npix(nside)
    theta, phi = TH.pix2ang_ring(nside, np.arange(npix))
    psi = (np.sin(theta) * np.sin(phi)).astype(np.float32)
    re, im = TS.analyze(psi, nside, lmax, niter=3, device="cpu")
    L = torch.arange(lmax + 1, dtype=torch.float32)
    g = torch.sqrt(L * (L + 1.0))[:, None]
    z = torch.zeros_like(re)
    a_t, a_p = TSS.synthesize_spin1(re * g, im * g, z, z, nside, lmax)
    npt.assert_allclose(a_t.numpy(), np.cos(theta) * np.sin(phi),
                        atol=2e-4)
    npt.assert_allclose(a_p.numpy(), np.cos(phi), atol=2e-4)


def test_gradient_vs_finite_difference(rng):
    """Random full-spectrum psi: the gradient synthesis matches finite
    differences of the direct scalar evaluation at arbitrary points."""
    lmax, nside = 8, 32
    re, im = _alm(lmax, rng)
    mg = np.arange(lmax + 1)[None, :]

    def scal(theta, phi):
        lam = TS.legendre_table(lmax, np.cos(theta))
        c = np.cos(mg[..., None] * phi)
        s = np.sin(mg[..., None] * phi)
        fac = np.where(mg > 0, 2.0, 1.0)[..., None]
        return np.sum(fac * lam * (re[..., None] * c - im[..., None] * s),
                      axis=(0, 1))

    th = rng.uniform(0.3, np.pi - 0.3, 30)
    ph = rng.uniform(0, 2 * np.pi, 30)
    eps = 1e-4
    fd_t = (scal(th + eps, ph) - scal(th - eps, ph)) / (2 * eps)
    fd_p = (scal(th, ph + eps) - scal(th, ph - eps)) / (2 * eps) / np.sin(th)
    L = np.arange(lmax + 1, dtype=np.float32)
    g = np.sqrt(L * (L + 1.0))[:, None]
    z = np.zeros_like(re)
    a_t, a_p = TSS.synthesize_spin1(re * g, im * g, z, z, nside, lmax,
                                    device="cpu")
    got_t = TH.get_interp_val(a_t.numpy().astype(np.float64), th, ph)
    got_p = TH.get_interp_val(a_p.numpy().astype(np.float64), th, ph)
    scale = np.max(np.abs(fd_t))
    npt.assert_allclose(got_t, fd_t, atol=0.02 * scale)
    npt.assert_allclose(got_p, fd_p, atol=0.02 * scale)


def test_spin1_roundtrip(rng):
    """synthesize -> analyze recovers random E/B alms."""
    nside, lmax = 32, 48
    er, ei = _alm(lmax, rng)
    br, bi = _alm(lmax, rng)
    a_t, a_p = TSS.synthesize_spin1(er, ei, br, bi, nside, lmax,
                                    device="cpu")
    back = TSS.analyze_spin1(a_t, a_p, nside, lmax, niter=3)
    scale = np.max(np.abs(er))
    for got, want in zip(back, (er, ei, br, bi)):
        npt.assert_allclose(got.numpy(), want, atol=3e-3 * scale)


def test_kappa_deflection_closed_loop(rng):
    """kappa alms -> deflection maps -> (kappa, omega): kappa comes back,
    omega is null (a pure-gradient field has no curl)."""
    nside, lmax = 32, 48
    kr, ki = _alm(lmax, rng, lmin=2)
    a_t, a_p = TSS.deflection_from_kappa_alm(kr, ki, nside, lmax,
                                             device="cpu")
    kr2, ki2, wr, wi = TSS.kappa_omega_alm_from_deflection(
        a_t, a_p, nside, lmax, niter=3)
    scale = np.max(np.abs(kr))
    npt.assert_allclose(kr2.numpy(), kr, atol=5e-3 * scale)
    npt.assert_allclose(ki2.numpy(), ki, atol=5e-3 * scale)
    assert float(wr.abs().max()) < 1e-3 * scale
    assert float(wi.abs().max()) < 1e-3 * scale


def test_deflection_of_uniform_kappa_is_null():
    nside, lmax = 16, 8
    kr = np.zeros((lmax + 1, lmax + 1), np.float32)
    a_t, a_p = TSS.deflection_from_kappa_alm(kr, kr, nside, lmax,
                                             device="cpu")
    assert float(a_t.abs().max()) == 0.0
    assert float(a_p.abs().max()) == 0.0


# ------------------------------------------------------ parity with JAX
@pytest.mark.parametrize("nside,lmax", CASES)
def test_spin1_tables_match_jax(nside, lmax):
    """The host float64 tables, cast to float32 as the JAX package does."""
    got = TSS.spin1_tables(nside, lmax, device="cpu")
    want = JSS.spin1_tables(nside, lmax)
    npt.assert_array_equal(got.lam_p.numpy(), np.asarray(want.lam_p))
    npt.assert_array_equal(got.lam_m.numpy(), np.asarray(want.lam_m))


@pytest.mark.parametrize("nside,lmax", CASES)
def test_synthesize_spin1_matches_jax(nside, lmax, rng):
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    for g, w in zip(TSS.synthesize_spin1(*_t(*alms), nside, lmax),
                    JSS.synthesize_spin1(*alms, nside, lmax)):
        _close(g, w)


@pytest.mark.parametrize("niter", [0, 3])
@pytest.mark.parametrize("nside,lmax", CASES)
def test_analyze_spin1_matches_jax(nside, lmax, niter, rng):
    npix = 12 * nside * nside
    a_t = rng.standard_normal(npix).astype(np.float32)
    a_p = rng.standard_normal(npix).astype(np.float32)
    for g, w in zip(TSS.analyze_spin1(*_t(a_t, a_p), nside, lmax,
                                      niter=niter),
                    JSS.analyze_spin1(a_t, a_p, nside, lmax, niter=niter)):
        _close(g, w)


@pytest.mark.parametrize("nside,lmax", CASES)
def test_deflection_and_kappa_omega_match_jax(nside, lmax, rng):
    kr, ki = _alm(lmax, rng, lmin=2)
    want = JSS.deflection_from_kappa_alm(kr, ki, nside, lmax)
    got = TSS.deflection_from_kappa_alm(*_t(kr, ki), nside, lmax)
    for g, w in zip(got, want):
        _close(g, w)
    # omega of a pure-gradient field is float32 noise: every channel is
    # held relative to kappa's max
    kom_t = TSS.kappa_omega_alm_from_deflection(*got, nside, lmax, niter=1)
    kom_j = JSS.kappa_omega_alm_from_deflection(*want, nside, lmax,
                                                 niter=1)
    scale = float(np.abs(np.asarray(kom_j[0])).max())
    for g, w in zip(kom_t, kom_j):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=TOL * scale)
    npt.assert_array_equal(TSS.deflection_E_factor(lmax).numpy(),
                           np.asarray(JSS.deflection_E_factor(lmax)))
    npt.assert_array_equal(TSS._g_ell(lmax).numpy(),
                           np.asarray(JSS._g_ell(lmax)))


def test_spin1_adjoint_is_the_transpose(rng):
    """<S(a), m> = <a, A(m)> with the quadrature weight and the m > 0
    halves undone: the written-out adjoint is the synthesis' transpose for
    l >= 1 (the JAX package's vjp)."""
    nside, lmax = 8, 16
    npix = JH.nside2npix(nside)
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    mt = rng.standard_normal(npix).astype(np.float32)
    mp = rng.standard_normal(npix).astype(np.float32)
    tab = TSS.spin1_tables(nside, lmax, device="cpu")
    st, sp = TSS._synth_spin1_impl(*_t(*alms), tab)
    lhs = float((st.double() * torch.from_numpy(mt).double()).sum()
                + (sp.double() * torch.from_numpy(mp).double()).sum())
    adj = TSS._adjoint_spin1(*_t(mt, mp), tab)
    mg = np.arange(lmax + 1)[None, :]
    unhalf = np.where(mg == 0, 1.0, 2.0) / (4.0 * np.pi / npix)
    rhs = float(sum(np.sum(d.numpy().astype(np.float64) * unhalf * a)
                    for d, a in zip(adj, alms)))
    npt.assert_allclose(lhs, rhs, rtol=2e-5)


def test_numpy_input_placement():
    nside, lmax = 8, 16
    rng = np.random.default_rng(0)
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    maps = tuple(rng.standard_normal(12 * nside ** 2).astype(np.float32)
                 for _ in range(2))
    calls = (lambda **k: TSS.synthesize_spin1(*alms, nside, lmax, **k),
             lambda **k: TSS.analyze_spin1(*maps, nside, lmax, **k),
             lambda **k: TSS.deflection_from_kappa_alm(*alms[:2], nside,
                                                       lmax, **k),
             lambda **k: TSS.kappa_omega_alm_from_deflection(
                 *maps, nside, lmax, **k))
    for call in calls:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert all(t.device.type == "cpu" for t in call(device="cpu"))
    out = TSS.analyze_spin1(*_t(*maps), nside, lmax)
    assert all(t.device.type == "cpu" for t in out)
