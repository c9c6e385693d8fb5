"""PyTorch port vs JAX package on the CPU: the full-sky multiplane ray
trace (astrild_tpu_torch/ops/lightcone_sphere.py's
`multiplane_raytrace_healpix` and `SkyHealpix.from_multiplane_shells`
against their astrild_tpu twins), mirroring tests/test_lightcone_sphere.py
:115-307.

The shells are the JAX package's own synfast maps (its PRNG keys), handed
to both packages as numpy. The traced maps agree with the JAX function's
within 5e-7 absolute on both backends (measured up to 2.4e-7: kappa and
gamma1 are differences of float32 distortions near 1, whose last bit is
1.2e-7; gamma2 and omega agree to 2e-9), beside kappa maxima of ~1e-3;
the source-plane angles within 1e-6.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from astrild_tpu.models.skyhealpix import SkyHealpix as JSH  # noqa: E402
from astrild_tpu.ops import lightcone_sphere as JLS  # noqa: E402
from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu_torch.models.skyhealpix import SkyHealpix  # noqa: E402
from astrild_tpu_torch.ops import lightcone_sphere as TLS  # noqa: E402
from astrild_tpu_torch.ops import sht as TS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402
from astrild_tpu_torch.ops.raytrace import effective_plane_kappa  # noqa: E402
from astrild_tpu_torch.utils import healpix as TH  # noqa: E402

ATOL = 5e-7
MAPS = ("kappa", "gamma1", "gamma2", "omega")


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


def _smooth_shell(key, nside=16):
    """The JAX tests' band-limited shell: C_l = 1e-4 on 2 <= l < 12."""
    cl = np.zeros(25)
    cl[2:12] = 1e-4
    return np.asarray(JS.synfast(key, cl, nside, lmax=24)).astype(np.float32)


def _band_limited(d, nside, L):
    r, i = TS.analyze(torch.from_numpy(d), nside, L, niter=0)
    return TS.synthesize(r, i, nside, L)


# ---------------------------------------------- the JAX package's own tests
def test_multiplane_single_shell_is_born():
    """One shell: the traced kappa is the Born weight times the
    band-limited shell kappa, gamma the spin-2 synthesis of its alms, and
    omega vanishes (no lens-lens coupling)."""
    nside = 16
    delta = _smooth_shell(jax.random.PRNGKey(0), nside)[None, :]
    chi, dchi, chi_s, om = 400.0, 100.0, 800.0, 0.31
    out = TLS.multiplane_raytrace_healpix(
        torch.from_numpy(delta), np.array([chi], np.float32),
        np.array([dchi], np.float32), chi_s, om, lmax=2 * nside)
    kap_eff = effective_plane_kappa(torch.from_numpy(delta[0]), chi, dchi,
                                    1.0, om)
    L = 2 * nside
    kr, ki = TS.analyze(kap_eff, nside, L, niter=0)
    kap_bl = TS.synthesize(kr, ki, nside, L).numpy()
    w = 1 - chi / chi_s
    scale = np.abs(w * kap_bl).max()
    npt.assert_allclose(out["kappa"].numpy(), w * kap_bl, atol=0.02 * scale)
    assert float(out["omega"].abs().max()) < 1e-4 * scale
    er, ei = TSS.kappa_alm_to_shear_alm(kr, ki)
    z = torch.zeros_like(er)
    g1, g2 = TSS.synthesize_spin2(er, ei, z, z, nside, L)
    npt.assert_allclose(out["gamma1"].numpy(), w * g1.numpy(),
                        atol=0.03 * scale)
    npt.assert_allclose(out["gamma2"].numpy(), w * g2.numpy(),
                        atol=0.03 * scale)


def test_multiplane_two_shells_matches_born_at_first_order():
    """Small-amplitude shells: multiplane -> Born; omega, a pure lens-lens
    signal, scales quadratically with the shells' amplitude."""
    nside = 16
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    d1, d2 = _smooth_shell(k1, nside), _smooth_shell(k2, nside)
    chis = np.array([300.0, 600.0], np.float32)
    dchis = np.array([150.0, 150.0], np.float32)
    chi_s, om = 900.0, 0.31
    L = 2 * nside

    def run(eps):
        delta = np.stack([eps * d1, eps * d2]).astype(np.float32)
        out = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta), chis,
                                              dchis, chi_s, om, lmax=L)
        bl = torch.stack([_band_limited(d, nside, L) for d in delta])
        born = TLS.born_convergence_healpix(bl, chis, dchis, chi_s, om)
        return out["kappa"].numpy(), born.numpy(), out["omega"].numpy()

    got1, born1, om1 = run(1.0)
    assert np.abs(got1 - born1).max() / np.abs(born1).max() < 0.05
    _, _, om2 = run(0.1)
    r1 = float(np.sqrt(np.mean(om1.astype(np.float64) ** 2)))
    r2 = float(np.sqrt(np.mean(om2.astype(np.float64) ** 2)))
    assert r1 > 0
    assert 50 < r1 / max(r2, 1e-30) < 200, r1 / r2   # ~100: quadratic


def test_multiplane_tomography_masks_far_shells():
    rng = np.random.default_rng(42)
    nside = 8
    delta = 0.01 * rng.standard_normal((2, TH.nside2npix(nside))).astype(
        np.float32)
    chis = np.array([300.0, 700.0], np.float32)
    dchis = np.array([100.0, 100.0], np.float32)
    out = TLS.multiplane_raytrace_healpix(
        torch.from_numpy(delta), chis, dchis,
        np.array([500.0, 900.0], np.float32), 0.31, lmax=16)
    one = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta[:1]),
                                          chis[:1], dchis[:1], 500.0, 0.31,
                                          lmax=16)
    assert out["kappa"].shape == (2, TH.nside2npix(nside))
    npt.assert_allclose(out["kappa"][0].numpy(), one["kappa"].numpy(),
                        atol=1e-6)


def test_skyhealpix_multiplane_facade():
    """SkyHealpix.from_multiplane_shells: the traced kappa as the map,
    gamma / omega layers, the Born facade within a few % on a smooth
    single shell; and the JAX facade's layers."""
    nside = 16
    shells = _smooth_shell(jax.random.PRNGKey(2), nside)[None, :]
    chis = np.array([400.0], np.float32)
    dchis = np.array([100.0], np.float32)
    sky = SkyHealpix.from_multiplane_shells(shells, chis, dchis, 800.0,
                                            0.31, lmax=2 * nside,
                                            device="cpu")
    for k in ("gamma1", "gamma2", "omega"):
        assert sky.data[k].shape == sky.data["orig"].shape
    born = SkyHealpix.from_density_shells(shells, chis, dchis, 800.0, 0.31,
                                          device="cpu")
    orig, b = sky.data["orig"].numpy(), born.data["orig"].numpy()
    scale = np.abs(b).max()
    assert np.abs(orig - b).max() < 0.05 * scale
    assert float(sky.data["omega"].abs().max()) < 1e-3 * scale
    want = JSH.from_multiplane_shells(shells, chis, dchis, 800.0, 0.31,
                                      lmax=2 * nside)
    npt.assert_allclose(orig, want.data["orig"], atol=ATOL)
    for k in ("gamma1", "gamma2", "omega"):
        npt.assert_allclose(sky.data[k].numpy(), want.data[k], atol=ATOL)


def test_skyhealpix_multiplane_facade_rejects_tomography():
    shells = np.zeros((1, TH.nside2npix(8)), np.float32)
    with pytest.raises(ValueError, match="scalar chi_s"):
        SkyHealpix.from_multiplane_shells(
            shells, np.array([300.0], np.float32),
            np.array([100.0], np.float32),
            np.array([500.0, 800.0], np.float32), 0.31, lmax=16,
            device="cpu")


def test_multiplane_scan_path_matches_tables():
    """method='scan' (the table-free backends, the production route)
    reproduces the table path; an unknown method raises."""
    rng = np.random.default_rng(7)
    nside = 16
    delta = rng.normal(0.0, 0.3, (3, 12 * nside * nside)).astype(
        np.float32)
    chis = np.array([300.0, 500.0, 700.0], np.float32)
    dchis = np.full(3, 100.0, np.float32)
    kw = dict(chi_s=900.0, omega_m=0.3, lmax=2 * nside)
    out_t = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta), chis,
                                            dchis, method="tables", **kw)
    out_s = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta), chis,
                                            dchis, method="scan", **kw)
    for k in MAPS:
        scale = float(out_t[k].abs().max()) + 1e-12
        npt.assert_allclose(out_s[k].numpy(), out_t[k].numpy(),
                            atol=3e-3 * scale, err_msg=k)
    with pytest.raises(ValueError):
        TLS.multiplane_raytrace_healpix(torch.from_numpy(delta), chis,
                                        dchis, method="nope", **kw)


# ------------------------------------------------------ parity with JAX
@pytest.mark.parametrize("chi_s", [900.0, [450.0, 900.0]])
@pytest.mark.parametrize("method", ["tables", "scan"])
def test_multiplane_raytrace_healpix_matches_jax(method, chi_s):
    """Three rough shells at nside 16, one source and a tomographic pair
    with a shell beyond the near source, on both backends."""
    rng = np.random.default_rng(0)
    nside = 16
    delta = rng.normal(0, 0.3, (3, 12 * nside ** 2)).astype(np.float32)
    chis = np.array([300.0, 500.0, 700.0], np.float32)
    dchis = np.full(3, 100.0, np.float32)
    a = (1.0 / (1.0 + np.array([0.1, 0.17, 0.25]))).astype(np.float32)
    cs = np.asarray(chi_s, np.float32)
    want = JLS.multiplane_raytrace_healpix(delta, chis, dchis, cs, 0.3,
                                           lmax=2 * nside, scale_factors=a,
                                           method=method)
    got = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta), chis,
                                          dchis, cs, 0.3, lmax=2 * nside,
                                          scale_factors=a, method=method)
    assert set(got) == set(want)
    for k in MAPS:
        assert got[k].shape == np.asarray(want[k]).shape
        npt.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL,
                            err_msg=k)
    for k in ("beta_theta", "beta_phi"):
        npt.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6,
                            err_msg=k)


def test_multiplane_nside_out_and_auto_backend_match_jax():
    """A coarser ray grid (nside_out) and the default lmax / 'auto'
    backend (tables at this size), against the JAX function."""
    rng = np.random.default_rng(5)
    nside = 8
    delta = rng.normal(0, 0.3, (2, 12 * nside ** 2)).astype(np.float32)
    chis = np.array([300.0, 600.0], np.float32)
    dchis = np.full(2, 150.0, np.float32)
    want = JLS.multiplane_raytrace_healpix(delta, chis, dchis, 800.0, 0.3,
                                           nside_out=4)
    got = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta), chis,
                                          dchis, 800.0, 0.3, nside_out=4)
    for k in MAPS:
        assert got[k].shape == (TH.nside2npix(4),)
        npt.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


def test_numpy_input_placement():
    nside = 4
    delta = np.zeros((1, TH.nside2npix(nside)), np.float32)
    args = (delta, [300.0], [100.0], 500.0, 0.3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TLS.multiplane_raytrace_healpix(*args, lmax=8)
    out = TLS.multiplane_raytrace_healpix(*args, lmax=8, device="cpu")
    assert all(v.device.type == "cpu" for v in out.values())
    out = TLS.multiplane_raytrace_healpix(torch.from_numpy(delta),
                                          *args[1:], lmax=8)
    assert all(v.device.type == "cpu" for v in out.values())
