"""PyTorch port vs JAX package on the CPU: the spin-1 (deflection)
transforms of the table-free scan path (astrild_tpu_torch/ops/
sht_spin_large.py against astrild_tpu/ops/sht_spin_large.py) and the
routing of SkyHealpix.lens_cmb_from_kappa, mirroring
tests/test_sht_spin1_large.py.

The spin-1 recursion is the spin-2 one started at l = 1 with the seed rows
0..1. Both packages run the scaled float32 Wigner-d recursion; the JAX
package scans m-blocks of 128 from their first m, the port one loop over l
for all m on the northern rings. Up to lmax 63 maps and alms agree with
the JAX package's within 1.5e-5 of their max (measured up to 2.2e-6 for
synthesis and 6.7e-6 for Jacobi analysis at nside 16, lmax 63). At nside
64, lmax 128 the JAX package runs two m-blocks and the gap grows with
lmax as the scalar and spin-2 recursions' do (measured 8.6e-6 for
synthesis, 1.9e-6 for analysis): it is held to 3e-5 there.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu.models.skyhealpix import SkyHealpix as JSH  # noqa: E402
from astrild_tpu.ops import sht_spin_large as JSL  # noqa: E402
from astrild_tpu_torch.models import skyhealpix as tshp  # noqa: E402
from astrild_tpu_torch.models.skyhealpix import SkyHealpix  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin_large as TSL  # noqa: E402
from astrild_tpu_torch.utils import healpix as TH  # noqa: E402

TOL, BLOCK_TOL = 1.5e-5, 3e-5
CASES = [(8, 16), (16, 32), (16, 47), (16, 63)]


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
    return np.random.default_rng(23)


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
def test_spin1_large_matches_table_synthesis(rng):
    """Scan synthesis == table synthesis (both exact at small nside)."""
    nside, lmax = 16, 32
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    for g, w in zip(TSL.synthesize_spin1_large(*alms, nside, lmax,
                                               device="cpu"),
                    TSS.synthesize_spin1(*alms, nside, lmax, device="cpu")):
        _close(g, w, 2e-5)


def test_spin1_large_gradient_analytic():
    """psi = cos(theta) (l = 1, m = 0: the closed-form seed row) gives
    alpha_theta = -sin(theta); psi = sin th sin ph pins the m = 1 fold
    through the seeded recursion."""
    nside, lmax = 32, 8
    re = np.zeros((lmax + 1, lmax + 1), np.float32)
    re[1, 0] = np.sqrt(4 * np.pi / 3) * np.sqrt(2.0)   # E = g psi
    z = np.zeros_like(re)
    a_t, a_p = TSL.synthesize_spin1_large(re, z, z, z, nside, lmax,
                                          device="cpu")
    theta, phi = TH.pix2ang_ring(nside, np.arange(TH.nside2npix(nside)))
    npt.assert_allclose(a_t.numpy(), -np.sin(theta), atol=5e-6)
    npt.assert_allclose(a_p.numpy(), 0.0, atol=5e-6)

    psi = (np.sin(theta) * np.sin(phi)).astype(np.float32)
    pr, pi = TS.analyze(psi, nside, lmax, niter=3, device="cpu")
    L = torch.arange(lmax + 1, dtype=torch.float32)
    g = torch.sqrt(L * (L + 1.0))[:, None]
    zt = torch.zeros_like(pr)
    a_t, a_p = TSL.synthesize_spin1_large(pr * g, pi * g, zt, zt, nside,
                                          lmax)
    npt.assert_allclose(a_t.numpy(), np.cos(theta) * np.sin(phi),
                        atol=3e-4)
    npt.assert_allclose(a_p.numpy(), np.cos(phi), atol=3e-4)


def test_spin1_large_roundtrip(rng):
    nside, lmax = 32, 48
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    a_t, a_p = TSL.synthesize_spin1_large(*alms, nside, lmax, device="cpu")
    back = TSL.analyze_spin1_large(a_t, a_p, nside, lmax, niter=3)
    scale = np.max(np.abs(alms[0]))
    for got, want in zip(back, alms):
        npt.assert_allclose(got.numpy(), want, atol=4e-3 * scale)


def test_spin1_large_super_nyquist_cg(rng):
    """lmax > 2*nside: 'auto' takes CG and the band below 2*nside stays
    unbiased where Jacobi diverges."""
    nside = 16
    lmax = 3 * nside - 1
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    a_t, a_p = TSL.synthesize_spin1_large(*alms, nside, lmax, device="cpu")
    er2 = TSL.analyze_spin1_large(a_t, a_p, nside, lmax, niter=3,
                                  method="auto")[0].numpy()
    lo = slice(1, 2 * nside)
    r = np.linalg.norm(er2[lo] - alms[0][lo]) / np.linalg.norm(alms[0][lo])
    assert r < 0.15, r


def test_deflection_large_matches_table(rng):
    nside, lmax = 16, 32
    kr, ki = _alm(lmax, rng, lmin=2)
    for g, w in zip(TSL.deflection_from_kappa_alm_large(kr, ki, nside, lmax,
                                                        device="cpu"),
                    TSS.deflection_from_kappa_alm(kr, ki, nside, lmax,
                                                  device="cpu")):
        _close(g, w, 2e-5)


def test_spin1_large_adjoint_is_transpose(rng):
    """<S(a), m> = <a, A(m)> with the quadrature weight and the m > 0
    halves undone: the written-out adjoint is the synthesis' transpose."""
    nside, lmax = 8, 16
    npix = TH.nside2npix(nside)
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    mt = rng.standard_normal(npix).astype(np.float32)
    mp = rng.standard_normal(npix).astype(np.float32)
    st, sp = TSL.synthesize_spin1_large(*alms, nside, lmax, device="cpu")
    lhs = float(np.sum(st.numpy() * mt) + np.sum(sp.numpy() * mp))
    tab = TSL.spin1_large_tables(nside, lmax, device="cpu")
    adj = TSL._adjoint_spin1_large_impl(*_t(mt, mp), tab, nside, lmax)
    mg = np.arange(lmax + 1)[None, :]
    unhalf = np.where(mg == 0, 1.0, 2.0) / (4.0 * np.pi / npix)
    rhs = float(sum(np.sum(d.numpy() * unhalf * a)
                    for d, a in zip(adj, alms)))
    npt.assert_allclose(lhs, rhs, rtol=2e-4)


def _dipole_lens_inputs(nside, n_cos):
    theta, _ = TH.pix2ang_ring(nside, np.arange(TH.nside2npix(nside)))
    cmb = np.cos(n_cos * theta).astype(np.float32)
    kap = (0.01 * np.cos(theta)).astype(np.float32)
    return theta, cmb, kap


def test_lens_cmb_from_kappa_facade():
    """kappa -> deflection -> remap: a dipole-kappa lens shifts the CMB by
    the analytic gradient; both backend branches agree, and each equals
    the JAX facade's branch."""
    nside = 32
    theta, cmb, kap = _dipole_lens_inputs(nside, 4)
    sky = SkyHealpix(np.zeros(TH.nside2npix(nside), np.float32),
                     device="cpu")
    lensed_tab = sky.lens_cmb_from_kappa(cmb, kap, lmax=8)
    # alpha_theta = grad psi = 0.01 sin(theta)
    exact = np.cos(4 * np.clip(theta + 0.01 * np.sin(theta), 0, np.pi))
    belt = (theta > 0.3) & (theta < np.pi - 0.3)
    assert np.abs((lensed_tab - exact)[belt]).max() < 2e-3
    jsky = JSH.from_array(np.zeros(TH.nside2npix(nside), np.float32))
    want_tab = jsky.lens_cmb_from_kappa(cmb, kap, lmax=8)
    npt.assert_allclose(lensed_tab, want_tab, atol=2e-6)

    # the large-lmax branch, forced by lmax > _TABLE_LMAX_LIMIT
    import astrild_tpu.models.skyhealpix as jshp
    old_t, old_j = tshp._TABLE_LMAX_LIMIT, jshp._TABLE_LMAX_LIMIT
    tshp._TABLE_LMAX_LIMIT = jshp._TABLE_LMAX_LIMIT = 4
    try:
        lensed_large = sky.lens_cmb_from_kappa(cmb, kap, lmax=8)
        want_large = jsky.lens_cmb_from_kappa(cmb, kap, lmax=8)
    finally:
        tshp._TABLE_LMAX_LIMIT, jshp._TABLE_LMAX_LIMIT = old_t, old_j
    npt.assert_allclose(lensed_large, lensed_tab, atol=2e-4)
    npt.assert_allclose(lensed_large, want_large, atol=2e-6)


def test_lens_cmb_from_kappa_super_nyquist_routing():
    """lmax > 2*nside routes the kappa analysis through the CG solve;
    the kappa is pure l = 1, so both band limits agree closely."""
    nside = 16
    _, cmb, kap = _dipole_lens_inputs(nside, 3)
    sky = SkyHealpix(np.zeros(TH.nside2npix(nside), np.float32),
                     device="cpu")
    out = sky.lens_cmb_from_kappa(cmb, kap, lmax=3 * nside)
    ref = sky.lens_cmb_from_kappa(cmb, kap, lmax=8)
    assert np.all(np.isfinite(out))
    npt.assert_allclose(out, ref, atol=2e-3)
    jsky = JSH.from_array(np.zeros(TH.nside2npix(nside), np.float32))
    npt.assert_allclose(out, jsky.lens_cmb_from_kappa(cmb, kap,
                                                      lmax=3 * nside),
                        atol=2e-6)


# ------------------------------------------------------ parity with JAX
@pytest.mark.parametrize("nside,lmax,tol", [c + (TOL,) for c in CASES]
                         + [(64, 128, BLOCK_TOL)])
def test_synthesize_spin1_large_matches_jax(nside, lmax, tol, rng):
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    for g, w in zip(TSL.synthesize_spin1_large(*_t(*alms), nside, lmax),
                    JSL.synthesize_spin1_large(*alms, nside, lmax)):
        _close(g, w, tol)


# every method at the small sizes; Jacobi (0 and 3 iterations) at nside
# 64, lmax 128 (CPU time)
ANALYSIS_CASES = ([c + (TOL, m, n) for c in CASES
                   for m, n in (("jacobi", 0), ("jacobi", 3), ("cg", 3))]
                  + [(64, 128, BLOCK_TOL, "jacobi", n) for n in (0, 3)])


@pytest.mark.parametrize("nside,lmax,tol,method,niter", ANALYSIS_CASES)
def test_analyze_spin1_large_matches_jax(nside, lmax, tol, method, niter,
                                         rng):
    npix = 12 * nside * nside
    maps = tuple(rng.standard_normal(npix).astype(np.float32)
                 for _ in range(2))
    for g, w in zip(TSL.analyze_spin1_large(*_t(*maps), nside, lmax,
                                            niter=niter, method=method),
                    JSL.analyze_spin1_large(*maps, nside, lmax, niter=niter,
                                            method=method)):
        _close(g, w, tol)


@pytest.mark.parametrize("nside,lmax", CASES)
def test_deflection_from_kappa_alm_large_matches_jax(nside, lmax, rng):
    kr, ki = _alm(lmax, rng, lmin=2)
    for g, w in zip(TSL.deflection_from_kappa_alm_large(*_t(kr, ki), nside,
                                                        lmax),
                    JSL.deflection_from_kappa_alm_large(kr, ki, nside,
                                                        lmax)):
        _close(g, w)


def test_spin1_recursion_seeds_match_jax():
    """The spin-1 seeds of the shared recursion (the closed-form m = 0
    row at l0 = 1 and the log2 amplitude of m >= 1) are the JAX
    package's host values; the spin-2 tables keep their seeds."""
    nside, lmax = 16, 47
    got = TSL.spin1_large_tables(nside, lmax, device="cpu")
    want = JSL.spin1_large_tables(nside, lmax)
    for name in ("log2_ch", "log2_sh", "seed2_p", "seed2_m"):
        npt.assert_array_equal(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)), name)
    npt.assert_array_equal(got.lnc.numpy(),
                           np.asarray(want.lnc)[: lmax + 1])
    assert got.rec_m.spin == got.rec_p.spin == 1
    two = TSL.spin2_large_tables(nside, lmax, device="cpu")
    assert two.rec_m.spin == two.rec_p.spin == 2
    npt.assert_array_equal(two.seed2_p.numpy(),
                           np.asarray(JSL.spin2_large_tables(nside,
                                                             lmax).seed2_p))


def test_raises_and_numpy_input_placement(rng):
    nside, lmax = 8, 16
    with pytest.raises(ValueError, match="alias-fold"):
        TSL.spin1_large_tables(8, 32, device="cpu")
    with pytest.raises(ValueError, match="method"):
        TSL.analyze_spin1_large(np.zeros(768, np.float32),
                                np.zeros(768, np.float32), nside, lmax,
                                method="jacobian", device="cpu")
    alms = _alm(lmax, rng) + _alm(lmax, rng)
    maps = tuple(rng.standard_normal(12 * nside ** 2).astype(np.float32)
                 for _ in range(2))
    calls = (lambda **k: TSL.synthesize_spin1_large(*alms, nside, lmax,
                                                    **k),
             lambda **k: TSL.analyze_spin1_large(*maps, nside, lmax, **k),
             lambda **k: TSL.deflection_from_kappa_alm_large(
                 *alms[:2], nside, lmax, **k))
    for call in calls:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert all(t.device.type == "cpu" for t in call(device="cpu"))
