"""PyTorch port vs JAX package on the CPU: the spin-2 transforms on both
backends (astrild_tpu_torch/ops/sht_spin.py and sht_spin_large.py against
their astrild_tpu twins), the full-sky spin-2 MASTER estimator, mirroring
tests/test_sht_spin.py and tests/test_sht_spin_large.py.

`wigner_d_column` and the spin-2 couplings are host float64, equal bit
for bit. The transforms are float32: the table path's maps and alms agree
with the JAX package's within 2e-6 of their max (measured up to 7.2e-7),
the scan path's within 1.5e-5 (measured up to 4.5e-6 at nside 16, lmax
63). The JAX package takes the analysis adjoint from jax.vjp, the port
writes the transpose out.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu.ops import sht_spin as JSS  # noqa: E402
from astrild_tpu.ops import sht_spin_large as JSL  # noqa: E402
from astrild_tpu.utils import healpix as JH  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin_large as TSL  # noqa: E402

TAB_TOL, SCAN_TOL = 2e-6, 1.5e-5
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


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=tol * np.abs(want).max())


def _random_alms(rng, lmax, lmin=2):
    lg = np.arange(lmax + 1)[:, None]
    mg = np.arange(lmax + 1)[None, :]
    valid = (mg <= lg) & (lg >= lmin)
    re = (rng.normal(0, 1, (lmax + 1,) * 2) * valid).astype(np.float32)
    im = (rng.normal(0, 1, (lmax + 1,) * 2) * valid
          * (mg > 0)).astype(np.float32)
    return re, im


def _eb(seed, lmax):
    rng = np.random.default_rng(seed)
    return _random_alms(rng, lmax) + _random_alms(rng, lmax)


def _qu(seed, nside):
    rng = np.random.default_rng(seed)
    npix = 12 * nside * nside
    return (rng.standard_normal(npix).astype(np.float32),
            rng.standard_normal(npix).astype(np.float32))


# ------------------------------------------------------------ host builders
@pytest.mark.parametrize("m1", [-2, -1, 0, 1, 2])
def test_wigner_d_column_bit_for_bit(m1):
    x = np.cos(JS.ring_geometry(8).theta)
    npt.assert_array_equal(TSS.wigner_d_column(20, x, m1),
                           JSS.wigner_d_column(20, x, m1))


def test_wigner_d_pins():
    """d^l_{0,m} reproduces the scalar Legendre table; d^2_{+-2,m} the
    closed forms."""
    x = np.linspace(-0.95, 0.95, 9)
    d0 = TSS.wigner_d_column(6, x, 0)
    lam = TS.legendre_table(6, x)
    for l in range(7):
        for m in range(l + 1):
            npt.assert_allclose(np.sqrt((2 * l + 1) / (4 * np.pi))
                                * d0[l, m], lam[l, m], atol=1e-12)
    s = np.sqrt(1 - x * x)
    d = TSS.wigner_d_column(4, x, 2)
    npt.assert_allclose(d[2, 2], ((1 + x) / 2) ** 2, atol=1e-12)
    npt.assert_allclose(d[2, 1], -(1 + x) / 2 * s, atol=1e-12)
    npt.assert_allclose(d[2, 0], np.sqrt(6) / 4 * s ** 2, atol=1e-12)
    dm = TSS.wigner_d_column(4, x, -2)
    npt.assert_allclose(dm[2, 2], ((1 - x) / 2) ** 2, atol=1e-12)
    npt.assert_allclose(dm[2, 1], (1 - x) / 2 * s, atol=1e-12)


@pytest.mark.parametrize("lmax,lmax_w", [(24, 48), (31, 20)])
def test_spin2_couplings_bit_for_bit(lmax, lmax_w):
    wl = np.random.default_rng(lmax).uniform(0, 1, lmax_w + 1)
    for g, w in zip(TSS.spin2_coupling_matrices_from_mask_cl(wl, lmax),
                    JSS.spin2_coupling_matrices_from_mask_cl(wl, lmax)):
        npt.assert_array_equal(g, w)


def test_spin2_coupling_unit_mask_identity():
    lmax = 24
    wl = np.zeros(2 * lmax + 1)
    wl[0] = 4 * np.pi
    M_pp, M_pm = TSS.spin2_coupling_matrices_from_mask_cl(wl, lmax)
    npt.assert_allclose(M_pp[2:, 2:], np.eye(lmax - 1), atol=1e-12)
    npt.assert_allclose(M_pm, 0.0, atol=1e-12)


# ------------------------------------------------------------ table path
@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 32)])
def test_synthesize_spin2_matches_jax(nside, lmax):
    alms = _eb(0, lmax)
    for g, w in zip(TSS.synthesize_spin2(*alms, nside, lmax, device="cpu"),
                    JSS.synthesize_spin2(*alms, nside, lmax)):
        _close(g, w, TAB_TOL)


@pytest.mark.parametrize("niter", [0, 3])
@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 47)])
def test_analyze_spin2_matches_jax(nside, lmax, niter):
    q, u = _qu(1, nside)
    for g, w in zip(TSS.analyze_spin2(q, u, nside, lmax, niter=niter,
                                      device="cpu"),
                    JSS.analyze_spin2(q, u, nside, lmax, niter=niter)):
        _close(g, w, TAB_TOL)


def test_spin2_roundtrip_and_null_b():
    """Band-limited E/B round trip within 2e-3 of the scale; a pure-E
    field's BB below 2e-4 of its EE."""
    nside, lmax = 32, 64
    er, ei, br, bi = _eb(0, lmax)
    for a in (er, ei, br, bi):
        a[40:] = 0.0
    tab = TSS.spin2_tables(nside, lmax, device="cpu")
    q, u = TSS.synthesize_spin2(er, ei, br, bi, nside, lmax, tables=tab)
    out = TSS.analyze_spin2(q, u, nside, lmax, niter=3, tables=tab)
    scale = np.abs(er).max()
    for got, want in zip(out, (er, ei, br, bi)):
        npt.assert_allclose(got.numpy(), want, atol=2e-3 * scale)
    z = np.zeros_like(er)
    q, u = TSS.synthesize_spin2(er, ei, z, z, nside, lmax, tables=tab)
    ee, bb, _ = TSS.anafast_spin2(q, u, lmax, tables=tab)
    assert bb.numpy()[2:40].sum() < 2e-4 * ee.numpy()[2:40].sum()


def test_anafast_spin2_and_kappa_to_shear_match_jax():
    nside, lmax = 16, 32
    q, u = _qu(2, nside)
    for g, w in zip(TSS.anafast_spin2(q, u, lmax, device="cpu"),
                    JSS.anafast_spin2(q, u, lmax)):
        _close(g, w, 4 * TAB_TOL)
    k_re, k_im = _random_alms(np.random.default_rng(3), lmax, lmin=0)
    for g, w in zip(TSS.kappa_alm_to_shear_alm(torch.from_numpy(k_re),
                                               torch.from_numpy(k_im)),
                    JSS.kappa_alm_to_shear_alm(jnp.asarray(k_re),
                                               jnp.asarray(k_im))):
        _close(g, w, 1e-7)


def test_synfast_spin2_from_white_with_jax_draws():
    """The twin fed with the JAX package's four draws: normal(k1),
    normal(k2) of split(ka) for EE, then of split(kb) for BB, where
    ka, kb = split(key)."""
    nside, lmax = 16, 32
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_ee = np.zeros(lmax + 1, np.float32)
    cl_ee[2:] = 10.0 / (ell[2:] + 5.0) ** 2
    cl_bb = (0.3 * cl_ee).astype(np.float32)
    key = jax.random.PRNGKey(4)
    white = []
    for k in jax.random.split(key):
        white += [np.asarray(jax.random.normal(kk, (lmax + 1, lmax + 1)))
                  for kk in jax.random.split(k)]
    for g, w in zip(TSS.synfast_spin2_from_white(white, cl_ee, cl_bb, nside,
                                                 lmax, device="cpu"),
                    JSS.synfast_spin2(key, cl_ee, cl_bb, nside, lmax)):
        _close(g, w, TAB_TOL)


def test_synfast_spin2_generator_spectra():
    """Eight generator realizations: EE and BB band power within 10%."""
    nside, lmax = 32, 48
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_ee = np.zeros(lmax + 1)
    cl_ee[2:] = 10.0 / (ell[2:] + 5.0) ** 2
    cl_bb = 0.3 * cl_ee
    tab = TSS.spin2_tables(nside, lmax, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ees, bbs = [], []
    for _ in range(8):
        q, u = TSS.synfast_spin2(gen, cl_ee, cl_bb, nside, lmax, tables=tab)
        ee, bb, _ = TSS.anafast_spin2(q, u, lmax, tables=tab)
        ees.append(ee.numpy())
        bbs.append(bb.numpy())
    r_ee = np.mean(ees, 0)[4:40].mean() / cl_ee[4:40].mean()
    r_bb = np.mean(bbs, 0)[4:40].mean() / cl_bb[4:40].mean()
    assert abs(r_ee - 1) < 0.1 and abs(r_bb - 1) < 0.1, (r_ee, r_bb)


def test_tangential_shear_identity():
    """Azimuthal kappa about the pole: U vanishes and -Q follows the
    aperture identity gamma_t = kbar(<th) - kappa(th) of a Gaussian lens
    (tests/test_sht_spin.py's physical pin of amplitude and sign)."""
    nside, lmax = 64, 128
    sigma = np.radians(3.0)
    ell = np.arange(lmax + 1, dtype=np.float64)
    k_re = np.zeros((lmax + 1, lmax + 1), np.float32)
    k_re[:, 0] = (np.sqrt((2 * ell + 1) / (4 * np.pi))
                  * np.exp(-ell * (ell + 1) * sigma ** 2 / 2))
    k_im = np.zeros_like(k_re)
    er, ei = TSS.kappa_alm_to_shear_alm(torch.from_numpy(k_re),
                                        torch.from_numpy(k_im))
    z = torch.zeros_like(er)
    q, u = (a.numpy() for a in TSS.synthesize_spin2(er, ei, z, z, nside,
                                                    lmax))
    assert np.abs(u).max() < 1e-4 * np.abs(q).max()
    geo = TS.ring_geometry(nside)
    sizes = geo.mask.sum(1).astype(int)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    K = 1.0 / (2.0 * np.pi * sigma ** 2)
    got, want = [], []
    for r in range(len(sizes)):
        th = geo.theta[r]
        if 1.5 * sigma < th < 5 * sigma:
            e = np.exp(-th ** 2 / (2 * sigma ** 2))
            got.append(-q[starts[r]:starts[r + 1]].mean())
            want.append(K * ((2 * sigma ** 2 / th ** 2) * (1 - e) - e))
    want = np.asarray(want)
    npt.assert_allclose(got, want, rtol=0.05,
                        atol=0.02 * np.abs(want).max())


# ------------------------------------------------------------- scan path
@pytest.mark.parametrize("nside,lmax", CASES)
def test_synthesize_spin2_large_matches_jax(nside, lmax):
    alms = _eb(5, lmax)
    for g, w in zip(TSL.synthesize_spin2_large(*alms, nside, lmax,
                                               device="cpu"),
                    JSL.synthesize_spin2_large(*alms, nside, lmax)):
        _close(g, w, SCAN_TOL)


@pytest.mark.parametrize("method,niter", [("jacobi", 0), ("jacobi", 3),
                                          ("cg", 3)])
@pytest.mark.parametrize("nside,lmax", CASES)
def test_analyze_spin2_large_matches_jax(nside, lmax, method, niter):
    q, u = _qu(6, nside)
    for g, w in zip(TSL.analyze_spin2_large(q, u, nside, lmax, niter=niter,
                                            method=method, device="cpu"),
                    JSL.analyze_spin2_large(q, u, nside, lmax, niter=niter,
                                            method=method)):
        _close(g, w, SCAN_TOL)


@pytest.mark.parametrize("nside,lmax", [(16, 32), (32, 95)])
def test_port_scan_path_matches_its_table_path(nside, lmax):
    """tests/test_sht_spin_large.py's bar: synthesis within 3e-5 of the
    map's max on both backends, including lmax = 3 nside - 1."""
    alms = _eb(0, lmax)
    for g, w in zip(TSL.synthesize_spin2_large(*alms, nside, lmax,
                                               device="cpu"),
                    TSS.synthesize_spin2(*alms, nside, lmax,
                                         device="cpu")):
        _close(g, w, 3e-5)


def test_scan_roundtrip_and_super_nyquist_band():
    """Sub-Nyquist round trip within 2e-4 of the scale; at lmax = 3 nside
    - 1 the band below 2 nside within 0.5% of the realization, the
    aliased band above 0.7 lmax within 3%, a pure-E field's BB below 1e-3
    of its EE."""
    nside = 16
    lmax = 2 * nside
    alms = _eb(1, lmax)
    q, u = TSL.synthesize_spin2_large(*alms, nside, lmax, device="cpu")
    out = TSL.analyze_spin2_large(q, u, nside, lmax, niter=3)
    scale = np.abs(alms[0]).max()
    for got, want in zip(out, alms):
        npt.assert_allclose(got.numpy(), want, atol=2e-4 * scale)

    nside, lmax = 32, 95
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl = np.zeros(lmax + 1, np.float32)
    cl[2:] = 1.0 / (ell[2:] * (ell[2:] + 1.0))
    rng = np.random.default_rng(0)
    lg, mg = ell[:, None], ell[None, :]
    valid = (mg <= lg) & (lg >= 2)
    sig = np.sqrt(cl)[:, None]
    er = (rng.normal(0, 1, (lmax + 1,) * 2) * sig * valid).astype(np.float32)
    ei = (rng.normal(0, 1, (lmax + 1,) * 2) * sig * valid
          * (mg > 0)).astype(np.float32)
    er = np.where(mg == 0, er, er * np.sqrt(0.5)).astype(np.float32)
    ei = (ei * np.sqrt(0.5)).astype(np.float32)
    z = np.zeros_like(er)
    cl_real = TS.alm2cl(torch.from_numpy(er), torch.from_numpy(ei)).numpy()
    q, u = TSL.synthesize_spin2_large(er, ei, z, z, nside, lmax,
                                      device="cpu")
    ee, bb, _ = (c.numpy() for c in TSL.anafast_spin2_large(q, u, lmax,
                                                            niter=6))
    mid = (ell > 4) & (ell <= 2 * nside)
    hi = ell > 0.7 * lmax
    assert abs(ee[mid].mean() / cl_real[mid].mean() - 1) < 0.005
    assert abs(ee[hi].mean() / cl_real[hi].mean() - 1) < 0.03
    assert bb[2:].sum() < 1e-3 * ee[2:].sum()


def test_anafast_spin2_large_matches_jax():
    nside, lmax = 16, 47
    q, u = _qu(7, nside)
    for method in ("auto", "jacobi"):
        for g, w in zip(TSL.anafast_spin2_large(q, u, lmax, method=method,
                                                device="cpu"),
                        JSL.anafast_spin2_large(q, u, lmax,
                                                method=method)):
            _close(g, w, 4 * SCAN_TOL)


def test_spin2_large_raises():
    with pytest.raises(ValueError, match="alias-fold"):
        TSL.spin2_large_tables(8, 32, device="cpu")
    q, u = _qu(8, 8)
    with pytest.raises(ValueError, match="method"):
        TSL.analyze_spin2_large(q, u, 8, 16, method="CG", device="cpu")


# ------------------------------------------------------------------ MASTER
def test_anafast_spin2_master_matches_jax():
    """E-only maps under a belt mask: the band powers within 1e-5 of their
    max, with the couplings built and given."""
    nside, lmax, nb = 16, 31, 5
    npix = 12 * nside * nside
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_ee = np.zeros(lmax + 1, np.float32)
    cl_ee[2:] = 1.0 / ell[2:] ** 2
    q, u = (np.asarray(a) for a in JSS.synfast_spin2(
        jax.random.PRNGKey(0), cl_ee, np.zeros_like(cl_ee), nside, lmax))
    theta, _ = JH.pix2ang_ring(nside, np.arange(npix))
    mask = ((theta < 1.2) | (theta > 1.9)).astype(np.float32)
    got = TSS.anafast_spin2_master(q, u, mask, lmax, nbins=nb,
                                   device="cpu")
    want = JSS.anafast_spin2_master(q, u, mask, lmax, nbins=nb)
    npt.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-5)
    wl = np.asarray(JS.anafast(jnp.asarray(mask), 2 * lmax))
    coup = JSS.spin2_coupling_matrices_from_mask_cl(wl, lmax)
    got = TSS.anafast_spin2_master(q, u, mask, lmax, nbins=nb,
                                   coupling=coup, device="cpu")
    want = JSS.anafast_spin2_master(q, u, mask, lmax, nbins=nb,
                                    coupling=coup)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-5)


def test_numpy_input_placement():
    nside, lmax = 8, 16
    q, u = _qu(9, nside)
    if not torch.cuda.is_available():
        for call in (lambda: TSS.anafast_spin2(q, u, lmax),
                     lambda: TSL.anafast_spin2_large(q, u, lmax),
                     lambda: TSS.synthesize_spin2(*_eb(0, lmax), nside,
                                                  lmax)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    out = TSL.analyze_spin2_large(torch.from_numpy(q), torch.from_numpy(u),
                                  nside, lmax)
    assert all(a.device.type == "cpu" for a in out)
