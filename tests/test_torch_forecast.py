"""PyTorch port vs JAX package on the CPU: the Fisher forecasts
(astrild_tpu_torch/ops/forecast.py), mirroring tests/test_forecast.py and
the Fisher tests of tests/test_shear_2pt.py, and examples/theory_and_rsd.py
stages 1-5 and examples/shear_survey.py stages 7-8 run whole in both
packages at a small size (npix 64, nell 64, nchi 32, a 16^3 mock).

Tolerances: values rtol 1e-4 (the JAX package is float32); Fisher
matrices within 2e-3 of their max; marginalized errors within 1e-2
relative; the port's float64 Jacobian of each mean model against central
differences of the port (step 1e-6 of each parameter, halofit's ln R_s
held at its fiducial roots as the Jacobian holds it) within 1e-5 of each
column's max. The Jacobian is torch.func.jacfwd's, never a difference.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import jacfwd  # noqa: E402

from astrild_tpu.ops import angular_power as JA  # noqa: E402
from astrild_tpu.ops import forecast as JF  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch import Cosmology as TC  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TA  # noqa: E402
from astrild_tpu_torch.ops import forecast as TF  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402

VAL_RTOL, F_TOL, MARG_RTOL, FD_TOL, FD_STEP = 1e-4, 2e-3, 1e-2, 1e-5, 1e-6
NPIX, OA, NELL, NCHI = 64, 5.0, 64, 32
ZT = np.linspace(0.01, 3.0, 120)
NZ = (ZT, np.asarray(JA.smail_nz(ZT, z0=0.64)))
RP = np.array([2.0, 5.0, 10.0, 20.0])
COV_WP = np.diag((np.array([40.0, 15.0, 8.0, 4.0]) * 0.05) ** 2)
COV_DS = np.diag((np.array([2.0, 1.0, 0.5, 0.2]) * 0.08) ** 2)
HOD_FIXED = {"sigma_logm": 0.3, "log_m0": 12.0, "log_m1": 13.5,
             "alpha": 1.0}
HOD_FID = {"log_mmin": 12.5, **HOD_FIXED}
# the examples' forecasts at the small size: (port call, JAX call, params)
SHEAR = dict(z_sources=[0.6, 1.0, 1.6], fsky=0.36, nchi=NCHI)
XIPM = dict(npix=NPIX, opening_angle_deg=OA, nbins=12, theta_min_arcmin=2.0,
            z_source=1.0, n_fields=40, nell=NELL, nchi=NCHI)
X2 = dict(npix=NPIX, opening_angle_deg=OA, nz=NZ, nbins_xi=10,
          theta_min_arcmin=2.0, n_fields=40, hod_fixed=HOD_FIXED, nell=NELL,
          nchi=NCHI)
P_COSMO = {"Om0": 0.3089, "sigma8": 0.8159}
P_X2 = {"Om0": 0.3089, "sigma8": 0.8159, "log_mmin": 12.5, "A_IA": 1.0}
ELLS = np.geomspace(100, 2000, 10)
_JAX = {}


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


def _jax_once(name, fn):
    """A JAX forecast computed once per module (they take ~10 s each)."""
    if name not in _JAX:
        _JAX[name] = fn()
    return _JAX[name]


def _forecasts(name):
    """(port result, JAX result) of one of the examples' forecasts."""
    calls = {
        "shear": (lambda: TF.shear_fisher(ELLS, P_COSMO, device="cpu",
                                          **SHEAR),
                  lambda: JF.shear_fisher(ELLS, P_COSMO, **SHEAR)),
        "xipm": (lambda: TF.xipm_survey_fisher(P_COSMO, device="cpu",
                                               **XIPM),
                 lambda: JF.xipm_survey_fisher(P_COSMO, **XIPM)),
        "threex2pt": (lambda: TF.threex2pt_fisher(
            P_X2, RP, RP, COV_WP, COV_DS, device="cpu", **X2),
            lambda: JF.threex2pt_fisher(P_X2, RP, RP, COV_WP, COV_DS,
                                        **X2)),
    }
    port, ref = calls[name]
    return port(), _jax_once(name, ref)


def _assert_forecast_matches(got, want):
    assert got["names"] == want["names"]
    f, fj = got["fisher"], np.asarray(want["fisher"], np.float64)
    assert f.dtype == np.float64 and got["covariance"].dtype == np.float64
    npt.assert_allclose(f, fj, rtol=0, atol=F_TOL * np.abs(fj).max())
    npt.assert_allclose(got["marginalized"], want["marginalized"],
                        rtol=MARG_RTOL)
    assert np.abs(f - f.T).max() <= 1e-12 * np.abs(f).max()
    assert np.all(np.linalg.eigvalsh(f) > 0)
    assert np.all(got["marginalized"] > 0)
    cond = 1.0 / np.sqrt(np.diag(f))
    assert np.all(got["marginalized"] >= cond * 0.999)


def _assert_jacobian_matches_fd(mean_fn, params):
    jac, mu = TF._jacobian(mean_fn, params, torch.device("cpu"))
    assert jac.dtype == torch.float64 and mu.dtype == torch.float64
    fd = TF.held_root_differences(mean_fn, params, FD_STEP)
    npar = len(params)
    a, b = jac.numpy().reshape(-1, npar), fd.reshape(-1, npar)
    err = np.abs(a - b).max(0) / np.abs(b).max(0)
    assert (err <= FD_TOL).all(), err


# -------------------------------------------------- tests/test_forecast.py
def test_sigma8_derivative_is_exact():
    """Linear C_ell scales as sigma8^2: dlnC/dlnsigma8 == 2, through
    Cosmology construction, EH98 and Limber (a JAX slow test, cheap
    here)."""
    ells = torch.tensor([100.0, 500.0, 1500.0], dtype=torch.float64)

    def f(s8):
        return TA.cl_kappa_limber(ells, TC(sigma8=s8), z_source=1.0,
                                  nchi=64)

    s8 = torch.tensor(0.8159, dtype=torch.float64)
    npt.assert_allclose((jacfwd(f)(s8) * s8 / f(s8)).numpy(), 2.0,
                        rtol=1e-10)


@pytest.mark.parametrize("form", ["full", "diagonal", "blocks"])
def test_fisher_matrix_linear_model_analytic(form):
    """mu = A p with Gaussian covariance C: F = A^T C^-1 A exactly, for
    a full, a diagonal and an ell-block covariance."""
    A = np.array([[1.0, 2.0], [0.5, -1.0], [3.0, 0.3]])
    cov = np.diag([0.1, 0.2, 0.3])
    At = torch.from_numpy(A)
    want = A.T @ np.linalg.inv(cov) @ A
    if form == "blocks":
        def mean(p):
            return torch.stack([At @ torch.stack([p["a"], p["b"]]),
                                2.0 * At @ torch.stack([p["a"], p["b"]])])

        c = np.stack([cov, cov])
        want = want * 5.0
    else:
        def mean(p):
            return At @ torch.stack([p["a"], p["b"]])

        c = np.diag(cov) if form == "diagonal" else cov
    F, names = TF.fisher_matrix(mean, {"a": 1.0, "b": 2.0}, c,
                                device="cpu")
    npt.assert_allclose(F, want, rtol=1e-12)
    assert names == ["a", "b"] and F.dtype == np.float64
    if form == "full":
        Fj, _ = JF.fisher_matrix(
            lambda p: jnp.asarray(A) @ jnp.array([p["a"], p["b"]]),
            {"a": 1.0, "b": 2.0}, jnp.asarray(cov))
        npt.assert_allclose(F, np.asarray(Fj), rtol=1e-5)


def test_tomographic_stack_matches_jax():
    """Symmetric, deeper bins carry more power, the cross below the
    autos' geometric mean; against the JAX package's stack (float and
    traced cosmology) rtol 1e-4."""
    ells = np.array([100.0, 500.0], np.float32)
    stack = TF.tomographic_shear_cls(ells, TC(), [0.5, 1.0], nchi=64,
                                     device="cpu")
    assert stack.shape == (2, 2, 2)
    npt.assert_array_equal(stack[0, 1].numpy(), stack[1, 0].numpy())
    s = stack.double().numpy()
    assert s[1, 1, 0] > s[0, 0, 0]
    assert s[0, 1, 0] ** 2 <= s[0, 0, 0] * s[1, 1, 0] * 1.0001
    want = np.asarray(JF.tomographic_shear_cls(ells, JC(), [0.5, 1.0],
                                               nchi=64))
    npt.assert_allclose(s, want, rtol=VAL_RTOL)
    traced = TF.tomographic_shear_cls(ells, TC().with_tensor_fields(),
                                      [0.5, 1.0], nchi=64)
    assert traced.dtype == torch.float64
    npt.assert_allclose(traced.numpy(), want, rtol=VAL_RTOL)


def test_covariance_block_structure():
    """The JAX test's block checks, and equality with its covariance."""
    nb, ells = 2, np.array([100.0, 300.0, 900.0])
    stack = np.ones((nb, nb, 3)) * np.array([1.0, 0.5, 0.2])
    cov = TF.shear_cl_data_covariance(stack, ells, fsky=0.5, delta_ell=10.0,
                                      noise_cl=np.array([0.1, 0.2]),
                                      device="cpu").numpy()
    assert cov.shape == (3, 3, 3)
    assert np.allclose(cov, np.swapaxes(cov, 1, 2))
    assert np.all(np.linalg.eigvalsh(cov) > -1e-12)
    want = np.asarray(JF.shear_cl_data_covariance(
        jnp.asarray(stack, jnp.float32), jnp.asarray(ells), fsky=0.5,
        delta_ell=10.0, noise_cl=jnp.asarray([0.1, 0.2])))
    npt.assert_allclose(cov, want, rtol=1e-6)
    c0 = TF.shear_cl_data_covariance(stack, ells, fsky=0.5, delta_ell=10.0,
                                     device="cpu").numpy()
    npt.assert_allclose(c0[0, 0, 0], 2.0 / ((2 * 100.0 + 1) * 0.5 * 10.0),
                        rtol=1e-6)


def test_cosmology_params_are_differentiable():
    """grad of chi(z=1) in Om0 by autograd and by jacfwd (more matter,
    shorter distances); vmap over a grid of Om0 gives the loop's C_ell,
    rising with Om0 (the JAX package's vmap test)."""
    om = torch.tensor(0.3089, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(TC(Om0=om).comoving_distance(1.0), om)
    gf = jacfwd(lambda o: TC(Om0=o).comoving_distance(1.0))(om.detach())
    assert float(g) < 0.0
    npt.assert_allclose(float(gf), float(g), rtol=1e-12)
    ells = torch.tensor([100.0, 500.0], dtype=torch.float64)

    def f(o):
        return TA.cl_kappa_limber(ells, TC(Om0=o), z_source=1.0, nchi=64)

    grid = torch.linspace(0.25, 0.35, 5, dtype=torch.float64)
    out = torch.func.vmap(f)(grid)
    npt.assert_allclose(out.numpy(), torch.stack([f(o) for o in grid])
                        .numpy(), rtol=1e-12)
    assert out.shape == (5, 2) and bool((torch.diff(out[:, 0]) > 0).all())


def test_hod_wp_fisher_matches_jax():
    """wp(rp) of the HOD and its Fisher matrix over the five occupation
    parameters against the JAX package's; dwp/dlog_m1 < 0; F symmetric
    and PSD; the wp model's Jacobian against its central differences."""
    rp = np.asarray([5.0, 10.0, 20.0])
    wp0 = TF.hod_wp_theory(rp, TC(), HOD_FID, pi_max=80.0, device="cpu")
    wpj = np.asarray(JF.hod_wp_theory(jnp.asarray(rp), JC(), HOD_FID,
                                      pi_max=80.0))
    npt.assert_allclose(wp0.numpy(), wpj, rtol=VAL_RTOL)
    assert (wp0.numpy() > 0).all()
    g = jacfwd(lambda x: TF.hod_wp_theory(
        rp, TC(), {**HOD_FID, "log_m1": x}, pi_max=80.0, device="cpu"))(
        torch.tensor(13.5, dtype=torch.float64))
    assert (g.numpy() < 0).all()
    cov = np.diag((0.05 * wpj) ** 2)
    F, names = TF.hod_wp_fisher(rp, TC(), HOD_FID, cov, pi_max=80.0,
                                device="cpu")
    Fj, namesj = JF.hod_wp_fisher(jnp.asarray(rp), JC(), HOD_FID,
                                  jnp.asarray(cov), pi_max=80.0)
    assert names == namesj
    Fj = np.asarray(Fj, np.float64)
    npt.assert_allclose(F, Fj, rtol=0, atol=F_TOL * np.abs(Fj).max())
    npt.assert_allclose(F, F.T, rtol=1e-12)
    ev = np.linalg.eigvalsh(F)
    assert (ev > -1e-6 * ev.max()).all()
    assert F[names.index("log_mmin"), names.index("log_mmin")] > 0
    # <N_sat> has a kink at M = M0, and at log_m0 = 12.0 a node of the
    # halo model's mass grid (1e10-1e16, 64 nodes) sits on it, where a
    # difference quotient averages the two one-sided slopes: the
    # self-check moves M0 off the node
    cosmo = TC().with_tensor_fields()
    _assert_jacobian_matches_fd(
        lambda p: TF.hod_wp_theory(rp, cosmo, p, pi_max=80.0),
        {**HOD_FID, "log_m0": 12.05})


# --------------------------------- the examples' forecasts (stages 5, 7, 8)
def test_shear_fisher_matches_jax():
    """theory_and_rsd.py stage 5 at nchi 32: F, marginalized errors,
    degeneracy (marginalized >= conditional), and its mean model's
    Jacobian against central differences."""
    got, want = _forecasts("shear")
    _assert_forecast_matches(got, want)
    _assert_jacobian_matches_fd(got["mean_fn"], P_COSMO)


def test_xipm_survey_fisher_matches_jax():
    """shear_survey.py stage 7 at 64^2: F and errors against the JAX
    package's; more fields tighten by exactly sqrt(n) (the JAX test); the
    halofit mean model's Jacobian against its central differences."""
    got, want = _forecasts("xipm")
    _assert_forecast_matches(got, want)
    npt.assert_allclose(got["theta_arcmin"], want["theta_arcmin"],
                        rtol=1e-12)
    four = TF.xipm_survey_fisher(P_COSMO, device="cpu",
                                 **{**XIPM, "n_fields": 160})
    npt.assert_allclose(four["marginalized"], got["marginalized"] / 2.0,
                        rtol=1e-10)
    mean_fn = got["mean_fn"]
    assert mean_fn(P_COSMO).shape[0] == 2 * len(got["theta_arcmin"])
    _assert_jacobian_matches_fd(mean_fn, P_COSMO)


def test_threex2pt_fisher_matches_jax():
    """shear_survey.py stage 8 at 64^2: the joint wp + Delta Sigma + xi_pm
    forecast against the JAX package's (F, errors, fiducial mean); the
    joint probe beats shear alone on sigma8; a data vector / covariance
    size mismatch raises; the mean model's Jacobian against its central
    differences."""
    got, want = _forecasts("threex2pt")
    assert got["names"] == ["Om0", "sigma8", "log_mmin", "A_IA"]
    _assert_forecast_matches(got, want)
    npt.assert_allclose(got["mean"], np.asarray(want["mean"]),
                        rtol=VAL_RTOL)
    solo = TF.xipm_survey_fisher(
        {"Om0": 0.3089, "sigma8": 0.8159, "A_IA": 1.0}, device="cpu",
        **{**XIPM, "nz": NZ})
    assert got["marginalized"][1] < solo["marginalized"][1]
    with pytest.raises(ValueError, match="data vector"):
        TF.threex2pt_fisher({"Om0": 0.3}, RP, RP[:2], COV_WP, COV_DS,
                            device="cpu", **X2)
    mean_fn = TF.threex2pt_mean_builder(
        RP, RP, NPIX, OA, NZ, 60.0, 10, 2.0, OA * 60.0 / 2.0, 0.0, NELL,
        NCHI, True, {}, HOD_FIXED, device="cpu")[0]
    _assert_jacobian_matches_fd(mean_fn, P_X2)


# ---------------------------------------- tests/test_shear_2pt.py Fishers
@pytest.mark.parametrize("case", ["w0", "nz_ia"])
def test_xipm_fisher_variants_match_jax(case):
    """w0 through the chain (test_forecast's dark-energy test), and an
    extended n(z) with the NLA nuisance A_IA (test_shear_2pt's nz and IA
    tests): F and errors against the JAX package's; marginalizing A_IA
    loosens Om0 (the JAX test)."""
    if case == "w0":
        params, kw = {"Om0": 0.3089, "sigma8": 0.8159, "w0": -1.0}, XIPM
    else:
        params = {"Om0": 0.3089, "sigma8": 0.8159, "A_IA": 1.0}
        kw = {**XIPM, "nz": NZ, "n_fields": 1}
    got = TF.xipm_survey_fisher(params, device="cpu", **kw)
    want = _jax_once(case, lambda: JF.xipm_survey_fisher(params, **kw))
    assert got["names"] == list(params)
    _assert_forecast_matches(got, want)
    if case == "nz_ia":
        base = TF.xipm_survey_fisher(P_COSMO, device="cpu", **kw)
        assert got["marginalized"][0] > base["marginalized"][0]
        with pytest.raises(ValueError):
            TF.xipm_survey_fisher({"Om0": 0.3, "A_IA": 1.0}, npix=64,
                                  opening_angle_deg=5.0, nbins=6,
                                  device="cpu")


# ------------------------------------ examples/theory_and_rsd.py 1-4
def test_example_stage1_nonlinear_power():
    """Linear, halofit and halo-model P(k) at the example's 64 k: against
    the JAX package's rtol 1e-4; the nonlinear ones at least 0.97 of
    linear and above it beyond 1 h/Mpc."""
    k = np.logspace(-3, 1, 64)
    kj = jnp.asarray(k)
    from astrild_tpu.ops import halo_model as JHM
    from astrild_tpu.ops import linear_power as JL
    from astrild_tpu_torch.ops import halo_model as THM

    got = [TL.linear_power(k, TC(), device="cpu"),
           TL.nonlinear_power(k, TC(), device="cpu"),
           THM.halo_model_power(k, TC(), device="cpu")[2]]
    want = [JL.linear_power(kj, JC()), JL.nonlinear_power(kj, JC()),
            JHM.halo_model_power(kj, JC())[2]]
    for g, w in zip(got, want):
        npt.assert_allclose(g.double().numpy(), np.asarray(w), rtol=VAL_RTOL)
    lin = got[0].double().numpy()
    for p in got[1:]:
        r = p.double().numpy() / lin
        assert r.min() >= 0.97 and (r[k > 1.0] > 1.0).all()


def test_example_stage2_bao_peak():
    """Kaiser multipoles on 1024 k -> FFTLog: s^2 xi_0 against the JAX
    package's within 1e-4 of its peak, the BAO peak at the same s, in
    95-110 Mpc/h."""
    from astrild_tpu.ops import fftlog as JFL
    from astrild_tpu.ops import linear_power as JL
    from astrild_tpu_torch.ops import fftlog as TFL

    kk = np.logspace(-4, 2, 1024)
    p = TL.kaiser_multipoles(kk, TC(), device="cpu")
    s, xi = TFL.xi_multipoles_from_pk(kk, torch.stack(p))
    sj, xij = JFL.xi_multipoles_from_pk(
        kk, jnp.stack(JL.kaiser_multipoles(jnp.asarray(kk), JC())))
    s, v = s.numpy(), xi[0].double().numpy() * s.numpy() ** 2
    vj = np.asarray(xij[0], np.float64) * np.asarray(sj) ** 2
    sel = (s > 90) & (s < 115)
    npt.assert_allclose(v[sel], vj[sel], rtol=0,
                        atol=1e-4 * np.abs(vj[sel]).max())
    peak = s[sel][np.argmax(v[sel])]
    assert peak == np.asarray(sj)[sel][np.argmax(vj[sel])]
    assert 95.0 <= peak <= 110.0


def test_example_stage3_rsd_closure():
    """The Zel'dovich RSD closure at 16^3 (in 250 Mpc/h, the example's
    density, 4 bins of the example's width) from the JAX package's white
    noise: positions, the multipoles and the Gaussian covariance of the
    measured P2/P0 against the JAX package's."""
    from astrild_tpu.ops import covariance as JCV
    from astrild_tpu.ops import mocks as JM
    from astrild_tpu.ops import paint as JP
    from astrild_tpu.ops import power as JPW
    from astrild_tpu.ops import tpcf as JT
    from astrild_tpu_torch.ops import covariance as TCV
    from astrild_tpu_torch.ops import mocks as TM
    from astrild_tpu_torch.ops import power as TPW
    from astrild_tpu_torch.ops import tpcf as TT
    from astrild_tpu_torch.ops.paint import paint

    ngrid, box, nbins = 16, 250.0, 4
    f = float(JC().growth_rate(0.0))
    key = jax.random.PRNGKey(0)
    jpos, jvel = JM.zeldovich_catalog_with_velocities(
        key, ngrid, box, lambda q: 2e4 * jnp.exp(-((q / 0.08) ** 2)), f)
    jgrid = JP.paint(JT.to_redshift_space(jpos, jvel, box), ngrid, box,
                     window="cic")
    jres = JPW.auto_power_multipoles(jgrid, box, nbins=nbins, window="cic")
    _, jcov, _ = JCV.gaussian_multipole_covariance(
        ngrid, box, nbins, lambda q: 2e4 * jnp.exp(-((q / 0.08) ** 2)),
        beta=f)

    def pk(q):
        return 2e4 * torch.exp(-((q / 0.08) ** 2))

    white = torch.from_numpy(np.array(jax.random.normal(key, (ngrid,) * 3)))
    pos, vel = TM.zeldovich_catalog_with_velocities_from_modes(
        TM.modes_from_white(white, ngrid, box, pk), ngrid, box,
        float(TC().growth_rate(0.0)))
    d = pos.numpy() - np.asarray(jpos)
    assert np.abs(d - box * np.round(d / box)).max() < 1e-4
    grid = paint(TT.to_redshift_space(pos, vel, box), ngrid, box,
                 window="cic")
    res = TPW.auto_power_multipoles(grid, box, nbins=nbins, window="cic")
    _, cov, _ = TCV.gaussian_multipole_covariance(ngrid, box, nbins, pk,
                                                  beta=f, device="cpu")
    pj = np.asarray(jres.p_ell, np.float64)
    npt.assert_allclose(res.p_ell.double().numpy(), pj, rtol=0,
                        atol=1e-3 * np.abs(pj).max())
    npt.assert_allclose(cov.double().numpy(), np.asarray(jcov, np.float64),
                        rtol=1e-5, atol=1e-5 * float(np.abs(jcov).max()))
    r = res.p_ell[1] / res.p_ell[0]
    assert bool(torch.isfinite(r).all())


def test_example_stage4_born_and_raytrace():
    """Born and ray-traced SkyArray maps of 8 planes of 64^2 against the
    JAX package's, within 1e-4 of max |kappa| (the ray trace's parity bar
    in test_torch_lightcone.py); omega not 0."""
    from astrild_tpu.models import SkyArray as JS
    from astrild_tpu_torch.models import SkyArray as TS

    rng = np.random.default_rng(1)
    planes = rng.normal(0, 0.3, (8, 64, 64)).astype(np.float32)
    chis = np.linspace(300.0, 2400.0, 8)
    dchis = np.full(8, 300.0)
    for method in ("born", "raytrace"):
        got = TS.from_density_planes(planes, chis, dchis, 2700.0, 0.3089,
                                     5.0, method=method, device="cpu")
        want = JS.from_density_planes(jnp.asarray(planes),
                                      jnp.asarray(chis), jnp.asarray(dchis),
                                      2700.0, 0.3089, 5.0, method=method)
        kj = np.asarray(want.data["orig"], np.float64)
        npt.assert_allclose(got.data["orig"].double().numpy(), kj, rtol=0,
                            atol=1e-4 * np.abs(kj).max())
    assert float(got.data["omega"].std()) > 0.0
