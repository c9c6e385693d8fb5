"""PyTorch port vs JAX package on the CPU: the halo model
(astrild_tpu_torch/ops/halo_model.py), mirroring tests/test_halo_model.py.

The same numpy inputs go to both packages. The port computes the halo
model in float64, the JAX package in float32: spectra rtol 1e-4, Jacobian
columns within 1e-3 of each column's max; float32 functions (nfw_u of
float32 input, nfw_delta_sigma) rtol 1e-5; the host polynomial fit bit for
bit. The JAX package's own limits and consistency checks are held on the
port too.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import jacfwd  # noqa: E402

from astrild_tpu.ops import halo_model as JHM  # noqa: E402
from astrild_tpu.ops import hod as JHOD  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.ops import halo_model as THM  # noqa: E402
from astrild_tpu_torch.ops import hod as THOD  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402
from astrild_tpu_torch.utils.constants import RHO_CRIT0  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology as TC  # noqa: E402

VAL_RTOL, JAC_TOL = 1e-4, 1e-3
HOD = (12.5, 0.3, 12.0, 13.5, 1.0)


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


def N(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _cols_close(jt, jj, tol=JAC_TOL):
    npar = jj.shape[-1]
    a, b = jt.reshape(-1, npar), jj.reshape(-1, npar)
    err = np.abs(a - b).max(0) / np.abs(b).max(0)
    assert (err <= tol).all(), err


def test_nfw_u_matches_jax_and_its_limits():
    """u(k|M) of float32 input against the JAX package's to rtol 1e-5;
    exactly 1 as k -> 0, decaying, and the brute-force normalization of
    the JAX test."""
    k = np.asarray([1e-4, 0.01, 0.1, 1.0, 10.0, 100.0], np.float32)
    c, rv = np.float32([5.0, 10.0]), np.float32([1.0, 2.0])
    u = THM.nfw_u(k, c, rv, device="cpu")
    npt.assert_allclose(N(u), N(JHM.nfw_u(jnp.asarray(k), jnp.asarray(c),
                                          jnp.asarray(rv))), rtol=1e-5,
                        atol=1e-7)
    u = N(u)
    npt.assert_allclose(u[:, 0], 1.0, rtol=1e-5)
    assert np.all(np.diff(u, axis=1) < 1e-6)
    assert np.all(u[:, -1] < 0.05)
    cc, rvv, kk = 7.0, 1.5, 3.0
    x = np.linspace(1e-6, cc, 400_000)
    rs = rvv / cc
    num = np.trapezoid(x / (1 + x) ** 2 * np.sinc(kk * rs * x / np.pi), x)
    den = np.log(1 + cc) - cc / (1 + cc)
    u1 = float(THM.nfw_u(np.float32([kk]), np.float32([cc]),
                         np.float32([rvv]), device="cpu")[0, 0])
    npt.assert_allclose(u1, num / den, rtol=2e-3)


def test_bias_and_concentration_match_jax():
    nu = np.linspace(0.3, 5.0, 50).astype(np.float32)
    b = THM.sheth_tormen_bias(torch.from_numpy(nu))
    npt.assert_allclose(N(b), N(JHM.sheth_tormen_bias(jnp.asarray(nu))),
                        rtol=1e-6)
    assert np.all(np.diff(N(b)) > 0) and N(b)[0] < 1.0 < N(b)[-1]
    m = np.geomspace(1e10, 1e15, 20).astype(np.float32)
    npt.assert_allclose(
        N(THM.duffy_concentration(torch.from_numpy(m), z=0.5)),
        N(JHM.duffy_concentration(jnp.asarray(m), z=0.5)), rtol=1e-6)


@pytest.mark.parametrize("z, model", [(0.0, "st"), (1.0, "tinker08")])
def test_halo_model_power_matches_jax(z, model):
    """p_1h, p_2h and the total against the JAX package's, rtol 1e-4."""
    k = np.logspace(-3, 1, 32).astype(np.float32)
    got = THM.halo_model_power(k, TC(), z=z, model=model, device="cpu")
    want = JHM.halo_model_power(jnp.asarray(k), JC(), z=z, model=model)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        npt.assert_allclose(N(g), N(w), rtol=VAL_RTOL)


def test_halo_model_limits_and_halofit():
    """P_2h -> P_lin at large scales (5%); the total within the halo
    model's ~30% of halofit and far above linear at small scales; it falls
    with redshift (the JAX package's checks)."""
    c = TC()
    k = np.asarray([1e-3, 3e-3, 1e-2])
    _, p2, _ = THM.halo_model_power(k, c, device="cpu")
    npt.assert_allclose(N(p2), N(TL.linear_power(k, c, device="cpu")),
                        rtol=0.05)
    k = np.logspace(-2, 1, 16)
    _, _, pt = THM.halo_model_power(k, c, device="cpu")
    ratio = N(pt) / N(TL.nonlinear_power(k, c, device="cpu"))
    assert np.all(ratio > 0.65) and np.all(ratio < 1.35), ratio
    assert N(pt)[-1] > 10.0 * N(TL.linear_power(k, c, device="cpu"))[-1]
    k = np.asarray([0.5, 2.0])
    p0 = THM.halo_model_power(k, c, z=0.0, device="cpu")[2]
    p1 = THM.halo_model_power(k, c, z=1.0, device="cpu")[2]
    assert np.all(N(p1) < N(p0))


def test_halo_model_jacobian_matches_jax():
    """The total P(k) in (Om0, sigma8, w0) against jax.jacfwd, through
    the traced mass function, bias, u(k|M) and a_corr."""
    k = np.logspace(-2, 1, 12).astype(np.float32)
    names = ("Om0", "sigma8", "w0")
    p0 = np.array([0.3089, 0.8159, -1.0])

    def jf(x):
        return JHM.halo_model_power(jnp.asarray(k),
                                    JC(**dict(zip(names, x))), z=0.5)[2]

    def tf(x):
        return THM.halo_model_power(
            torch.from_numpy(k), TC(**{n: x[i] for i, n in
                                       enumerate(names)}), z=0.5)[2]

    jj = N(jax.jacfwd(jf)(jnp.asarray(p0, jnp.float32)))
    jt = N(jacfwd(tf)(torch.tensor(p0)))
    _cols_close(jt, jj)


def test_hod_galaxy_power_matches_jax_and_its_limits():
    """P_gg terms, n_g and b_g against the JAX package's; P_2h -> b_g^2
    P_lin at k -> 0; 1-halo dominance at high k; n_g against a float64
    brute force of the same integrand (the JAX test)."""
    c = TC()
    k = np.geomspace(1e-3, 10.0, 24).astype(np.float32)
    p = THOD.HODParams(*HOD)
    got = THM.hod_galaxy_power(k, c, p, device="cpu")
    want = JHM.hod_galaxy_power(jnp.asarray(k), JC(), JHOD.HODParams(*HOD))
    for g, w in zip(got, want):
        npt.assert_allclose(N(g), N(w), rtol=VAL_RTOL)
    p1h, p2h, _, n_g, b_g = (N(a) for a in got)
    assert float(n_g) > 0 and float(b_g) > 1.0
    plin0 = N(TL.linear_power(k[:1].astype(np.float64), c,
                              device="cpu"))[0]
    npt.assert_allclose(p2h[0], b_g ** 2 * plin0, rtol=1e-3)
    assert p1h[0] < p2h[0] and p1h[-1] > p2h[-1]
    from astrild_tpu_torch.ops.halo_stats import theory_hmf

    lnm = np.linspace(np.log(1e10), np.log(1e16), 64)
    m = np.exp(lnm)
    n_lnm = N(theory_hmf(m, c, device="cpu"))
    nc, ns = THOD.zheng07_mean_occupation(torch.from_numpy(m), p)
    ng_ref = np.sum(n_lnm * (N(nc) + N(ns))) * (lnm[1] - lnm[0])
    npt.assert_allclose(float(n_g), ng_ref, rtol=1e-4)


def test_hod_galaxy_bias_decreases_with_mmin():
    biases = []
    for lm in (12.0, 12.8, 13.5):
        p = THOD.HODParams(lm, 0.3, lm - 0.5, lm + 1.0, 1.0)
        biases.append(float(THM.hod_galaxy_power(
            np.asarray([0.01]), TC(), p, device="cpu")[4]))
    assert biases[0] < biases[1] < biases[2]


def test_hod_galaxy_matter_power_and_delta_sigma_match_jax():
    """P_gm, Delta Sigma of the HOD against the JAX package's; the 2-halo
    limit b_g P_lin and the bias factorization (the JAX test); the
    log_mmin derivative of Delta Sigma against jax.grad."""
    c = TC()
    k = np.geomspace(1e-3, 50.0, 128).astype(np.float32)
    got = THM.hod_galaxy_matter_power(k, c, device="cpu")
    want = JHM.hod_galaxy_matter_power(jnp.asarray(k), JC())
    for g, w in zip(got, want):
        npt.assert_allclose(N(g), N(w), rtol=VAL_RTOL)
    p1, p2, _, _, bg = (N(a) for a in got)
    pl = N(TL.linear_power(torch.from_numpy(k).double(), c))
    assert abs(p2[0] / (bg * pl[0]) - 1.0) < 2e-3
    pg2 = N(THM.hod_galaxy_power(k, c, device="cpu")[1])
    pm2 = N(THM.halo_model_power(k, c, mmin=1e10, device="cpu")[1])
    assert abs(p2[5] / np.sqrt(pg2[5] * pm2[5]) - 1.0) < 0.02
    assert p1[-1] > p2[-1]
    rp = np.array([0.1, 0.5, 2.0, 10.0])
    ds = THM.delta_sigma_hod(rp, c, device="cpu")
    npt.assert_allclose(N(ds), N(JHM.delta_sigma_hod(rp, JC())),
                        rtol=VAL_RTOL)
    assert np.all(np.diff(N(ds)) < 0) and np.all(N(ds) > 0)

    def jds(lm):
        return jnp.sum(JHM.delta_sigma_hod(
            np.array([5.0]), JC(), hod_params=JHOD.HODParams(log_mmin=lm),
            nk=128))

    def tds(lm):
        return THM.delta_sigma_hod(
            np.array([5.0]), c, hod_params=THOD.HODParams(log_mmin=lm),
            nk=128, device="cpu").sum()

    lm = torch.tensor(12.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tds(lm), lm)
    npt.assert_allclose(float(g), float(jax.grad(jds)(12.0)), rtol=1e-3)
    assert float(g) > 0


def test_nfw_delta_sigma_matches_jax_and_closed_form():
    """The WB00 closed form against the JAX package's (rtol 1e-5) and
    against a quadrature of the NFW profile (the JAX test, 1e-4)."""
    from scipy.integrate import quad

    om, m200, c = 0.3089, 2e14, 5.0
    rho_m = om * RHO_CRIT0
    r200 = (3 * m200 / (4 * np.pi * 200 * rho_m)) ** (1 / 3)
    rs = r200 / c
    radii = np.array([0.1, rs, 0.5, 1.5])
    ds = N(THM.nfw_delta_sigma(radii, m200, c, omega_m=om, device="cpu"))
    npt.assert_allclose(ds, N(JHM.nfw_delta_sigma(radii, m200, c,
                                                  omega_m=om)), rtol=1e-5)
    dc = (200 / 3) * c ** 3 / (np.log(1 + c) - c / (1 + c))
    rho0 = dc * rho_m

    def rho(rr):
        return rho0 / ((rr / rs) * (1 + rr / rs) ** 2)

    def sigma(R):
        return 2 * quad(lambda zz: rho(np.hypot(R, zz)), 0, np.inf,
                        limit=400)[0]

    def sbar(R):
        return 2 * quad(lambda rp: rp * sigma(rp), 1e-6, R,
                        limit=400)[0] / R ** 2

    for i, Rv in enumerate(radii):
        assert abs(ds[i] / ((sbar(Rv) - sigma(Rv)) * 1e-12) - 1.0) < 1e-4
    assert np.all(ds > 0) and np.all(np.diff(ds) < 0)


def test_nfw_delta_sigma_near_rs_band():
    """Within 2% of x = R/r_s = 1 the host polynomial serves: against the
    float64 closed form to 1e-4, exactly 10/3 + 4 ln(1/2) at x = 1, and
    against the JAX package's values to rtol 1e-5."""
    om, m200, c = 0.3089, 2e14, 5.0
    rho_m = om * RHO_CRIT0
    r200 = (3 * m200 / (4 * np.pi * 200 * rho_m)) ** (1 / 3)
    rs = r200 / c
    dc = (200 / 3) * c ** 3 / (np.log(1 + c) - c / (1 + c))
    fac = rs * dc * rho_m * 1e-12
    xs = np.array([0.985, 0.995, 0.999, 0.9999, 1.0001, 1.0002, 1.001,
                   1.005, 1.015, 1.03])
    ds = N(THM.nfw_delta_sigma(xs * rs, m200, c, omega_m=om, device="cpu"))
    npt.assert_allclose(ds, N(JHM.nfw_delta_sigma(xs * rs, m200, c,
                                                  omega_m=om)), rtol=1e-5)
    xl, xg = xs[xs < 1], xs[xs >= 1]
    athl = np.arctanh(np.sqrt((1 - xl) / (1 + xl)))
    sl = np.sqrt(1 - xl ** 2)
    gl = (8 * athl / (xl ** 2 * sl) + 4 / xl ** 2 * np.log(xl / 2)
          - 2 / (xl ** 2 - 1) + 4 * athl / ((xl ** 2 - 1) * sl))
    atng = np.arctan(np.sqrt((xg - 1) / (1 + xg)))
    sg = np.sqrt(xg ** 2 - 1)
    gg = (8 * atng / (xg ** 2 * sg) + 4 / xg ** 2 * np.log(xg / 2)
          - 2 / (xg ** 2 - 1) + 4 * atng / (xg ** 2 - 1) ** 1.5)
    assert np.max(np.abs(ds / (fac * np.concatenate([gl, gg])) - 1)) < 1e-4
    v1 = float(THM.nfw_delta_sigma(np.array([rs]), m200, c, omega_m=om,
                                   device="cpu")[0])
    assert abs(v1 / (fac * (10 / 3 + 4 * np.log(0.5))) - 1.0) < 1e-5


def test_nfw_delta_sigma_gradient_is_finite_in_every_branch():
    """Every branch's argument is clamped, so the gradient in R is finite
    on both sides of x = 1 and in the polynomial band (a NaN in a branch
    not taken would still poison it)."""
    r = torch.tensor([0.01, 0.2, 0.3, 0.31, 2.0], requires_grad=True)
    ds = THM.nfw_delta_sigma(r, 2e14, 5.0)
    (g,) = torch.autograd.grad(ds.sum(), r)
    assert bool(torch.isfinite(g).all()) and bool((g < 0).all())


def test_wb_near1_coeffs_bit_identical():
    npt.assert_array_equal(THM._wb_near1_coeffs(), JHM._wb_near1_coeffs())
    assert isinstance(THM._wb_near1_coeffs(), np.ndarray)


def test_halo_model_numpy_input_without_a_card_raises():
    """Numpy k goes to the CUDA card by default: without one it raises
    (pass device='cpu'); a tensor keeps its device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no card"):
        THM.halo_model_power(np.asarray([0.1, 1.0]), TC())
    out = THM.halo_model_power(torch.tensor([0.1, 1.0]), TC())[2]
    assert out.device.type == "cpu"
