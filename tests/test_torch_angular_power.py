"""PyTorch port vs JAX package on the CPU: flat-sky C_ell estimators, the
halofit P(k) and the Limber convergence power.

Inputs are made with numpy from a seed and handed to both packages. The
flat-sky bin decision compares exact integers in both, so the mode counts
must be equal; the JAX cosmology tables and halofit run in float32, the
port's host tables in float64. Each tolerance is stated where it is
checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import angular_power as JAP  # noqa: E402
from astrild_tpu.ops import linear_power as JL  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JCosmology  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TAP  # noqa: E402
from astrild_tpu_torch.ops import lightcone_sphere as TLS  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402
from astrild_tpu_torch.ops import raytrace as TRT  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

COSMO = {"Om0": 0.3, "h": 0.7}
# (nbins, ell_min, ell_max) of the binning cases
BINNINGS = {"default": (10, None, None), "many": (50, None, None),
            "bounded": (8, 300.0, 2500.0)}


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


# ------------------------------------------------------------ flat-sky C_ell
@pytest.mark.parametrize("n", [64, 96, 128, 65])
@pytest.mark.parametrize("binning", sorted(BINNINGS))
def test_flat_sky_mode_counts_equal_jax(n, binning):
    """Bin membership is exact: the mode counts are equal, the mean ell of
    each bin agrees to float32 rounding of the sum (rtol 1e-5)."""
    nbins, lo, hi = BINNINGS[binning]
    ell_j, nm_j = JAP.flat_sky_mode_counts(n, 5.0, nbins=nbins, ell_min=lo,
                                           ell_max=hi)
    ell_t, nm_t = TAP.flat_sky_mode_counts(n, 5.0, nbins=nbins, ell_min=lo,
                                           ell_max=hi, device="cpu")
    npt.assert_array_equal(nm_t.numpy(), np.asarray(nm_j))
    assert float(nm_t.sum()) > 0
    npt.assert_allclose(ell_t.numpy(), np.asarray(ell_j), rtol=1e-5)


@pytest.mark.parametrize("n", [64, 96, 128])
@pytest.mark.parametrize("binning", sorted(BINNINGS))
def test_cl_flat_sky_matches_jax(rng, n, binning):
    """C_ell of a random map: rtol 1e-5 (one FFT and a float32 bin sum in
    each package)."""
    nbins, lo, hi = BINNINGS[binning]
    img = rng.standard_normal((n, n)).astype(np.float32)
    ell_j, cl_j = JAP.cl_flat_sky(jnp.asarray(img), 5.0, nbins=nbins,
                                  ell_min=lo, ell_max=hi)
    ell_t, cl_t = TAP.cl_flat_sky(torch.from_numpy(img), 5.0, nbins=nbins,
                                  ell_min=lo, ell_max=hi)
    npt.assert_allclose(ell_t.numpy(), np.asarray(ell_j), rtol=1e-5)
    npt.assert_allclose(cl_t.numpy(), np.asarray(cl_j), rtol=1e-5,
                        atol=1e-5 * float(np.asarray(cl_j).max()))


@pytest.mark.parametrize("n", [64, 96])
def test_cl_flat_sky_cross_matches_jax(rng, n):
    """Cross spectrum of two correlated maps: rtol 1e-5 of the largest
    band (a difference of two auto spectra); cross(x, x) is the auto
    spectrum exactly."""
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = (0.6 * a + 0.8 * rng.standard_normal((n, n))).astype(np.float32)
    _, want = JAP.cl_flat_sky_cross(jnp.asarray(a), jnp.asarray(b), 4.0,
                                    nbins=12, ell_min=200.0)
    ell, got = TAP.cl_flat_sky_cross(torch.from_numpy(a),
                                     torch.from_numpy(b), 4.0, nbins=12,
                                     ell_min=200.0)
    want = np.asarray(want)
    npt.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    ta = torch.from_numpy(a)
    _, auto = TAP.cl_flat_sky(ta, 4.0, nbins=12, ell_min=200.0)
    _, self_cross = TAP.cl_flat_sky_cross(ta, ta, 4.0, nbins=12,
                                          ell_min=200.0)
    npt.assert_allclose(self_cross.numpy(), auto.numpy(), rtol=1e-6)
    assert ell.shape == (12,)


# ------------------------------------------------------------------ halofit
@pytest.mark.parametrize("z", [0.0, 0.5, 1.0])
def test_halofit_parameters_match_jax(z):
    """k_sigma, n_eff and C against JAX's bisection and double autodiff of
    ln sigma^2(ln R) (float32 there, closed-form derivatives in float64
    here): rtol 1e-3."""
    jc, tc = JCosmology(**COSMO), Cosmology(**COSMO)
    amp = JL.normalization(jc)
    g2 = jc.growth_factor(z) ** 2

    def ln_s2(lnR):
        return jnp.log(JL._sigma2_gauss(lnR, jc, amp, g2))

    # the reference's own construction (linear_power.py, nonlinear_power)
    lo, hi = jnp.log(1e-3), jnp.log(1e2)
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        high = ln_s2(mid) > 0.0
        lo, hi = jnp.where(high, mid, lo), jnp.where(high, hi, mid)
    lnR_s = 0.5 * (lo + hi)
    dln = jax.grad(ln_s2)
    want = {"k_sigma": float(jnp.exp(-lnR_s)),
            "n_eff": float(-3.0 - dln(lnR_s)),
            "C": float(-jax.grad(lambda q: dln(q))(lnR_s))}
    par = TL.halofit_parameters(tc, z)
    for name, w in want.items():
        npt.assert_allclose(float(par[name]), w, rtol=1e-3, err_msg=name)
    # sigma^2 itself at the nonlinear scale, to float32 rounding
    s2 = TL._sigma2_gauss(float(lnR_s), tc, TL.normalization(tc),
                          float(tc.growth_factor(z)) ** 2)[0]
    npt.assert_allclose(s2, 1.0, rtol=1e-4)


def test_halofit_parameters_vectorize_over_z():
    tc = Cosmology(**COSMO)
    z = np.array([0.0, 0.5, 1.0])
    many = TL.halofit_parameters(tc, z)
    for i, zi in enumerate(z):
        one = TL.halofit_parameters(tc, zi)
        for name in one:
            npt.assert_allclose(many[name][i], one[name], rtol=1e-12,
                                err_msg=name)


@pytest.mark.parametrize("z", [0.0, 0.5, 1.0])
def test_nonlinear_power_matches_jax(z):
    """Halofit P(k, z) over k = 1e-3 .. 30 h/Mpc: rtol 2e-3; and well
    above the linear spectrum at k = 1."""
    jc, tc = JCosmology(**COSMO), Cosmology(**COSMO)
    k = np.logspace(-3, np.log10(30.0), 60).astype(np.float32)
    want = np.asarray(JL.nonlinear_power(jnp.asarray(k), jc, z=z))
    got = TL.nonlinear_power(torch.from_numpy(k), tc, z=z)
    assert got.dtype == torch.float32
    npt.assert_allclose(got.numpy(), want, rtol=2e-3)
    lin = TL.linear_power(torch.tensor([1.0]), tc, z)
    assert float(TL.nonlinear_power(torch.tensor([1.0]), tc, z) / lin) > 2.0
    # a given amplitude is used as it is
    amp = TL.normalization(tc)
    npt.assert_allclose(
        TL.nonlinear_power(torch.from_numpy(k), tc, z, amplitude=amp).numpy(),
        got.numpy(), rtol=1e-6)


# ------------------------------------------------------------------- Limber
@pytest.mark.parametrize("nonlinear", [False, True])
def test_cl_kappa_limber_matches_jax(nonlinear):
    """The Limber auto spectrum at ell = 50 .. 5000: rtol 3e-3 (float32
    tables and halofit in JAX)."""
    jc, tc = JCosmology(**COSMO), Cosmology(**COSMO)
    ells = np.array([50.0, 120.0, 300.0, 800.0, 2000.0, 5000.0], np.float32)
    want = np.asarray(JAP.cl_kappa_limber(jnp.asarray(ells), jc, 1.0,
                                          nonlinear=nonlinear))
    got = TAP.cl_kappa_limber(torch.from_numpy(ells), tc, 1.0,
                              nonlinear=nonlinear)
    assert got.shape == (6,) and got.dtype == torch.float32
    npt.assert_allclose(got.numpy(), want, rtol=3e-3)
    # array-like ells run where they are told to
    again = TAP.cl_kappa_limber(ells, tc, 1.0, nonlinear=nonlinear,
                                device="cpu")
    npt.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("nonlinear", [False, True])
def test_cl_kappa_cross_limber_matches_jax(nonlinear):
    """Two source planes, a coarser quadrature: rtol 3e-3; the cross
    spectrum lies between zero and the geometric mean of the autos."""
    jc, tc = JCosmology(**COSMO), Cosmology(**COSMO)
    ells = np.array([80.0, 400.0, 1500.0, 4000.0], np.float32)
    want = np.asarray(JAP.cl_kappa_cross_limber(
        jnp.asarray(ells), jc, 0.6, 1.2, nchi=128, nonlinear=nonlinear))
    te = torch.from_numpy(ells)
    got = TAP.cl_kappa_cross_limber(te, tc, 0.6, 1.2, nchi=128,
                                    nonlinear=nonlinear)
    npt.assert_allclose(got.numpy(), want, rtol=3e-3)
    a = TAP.cl_kappa_limber(te, tc, 0.6, nchi=128, nonlinear=nonlinear)
    b = TAP.cl_kappa_limber(te, tc, 1.2, nchi=128, nonlinear=nonlinear)
    assert bool(((got > 0) & (got <= torch.sqrt(a * b) * 1.0001)).all())


# ---------------------------------------------------------------- placement
def _placement_calls(rng):
    """name -> (call(input, **kw) returning a tensor, the numpy input) for
    the lane's entry points that take data which may be numpy."""
    tc = Cosmology(**COSMO)
    img = rng.standard_normal((16, 16)).astype(np.float32)
    planes = (0.1 * rng.standard_normal((2, 16, 16))).astype(np.float32)
    shells = (0.1 * rng.standard_normal((2, 48))).astype(np.float32)
    k = np.geomspace(0.01, 5.0, 8).astype(np.float32)
    chis, dchis = [500.0, 900.0], [400.0, 400.0]
    return {
        "multiplane_raytrace": (lambda x, **kw: TRT.multiplane_raytrace(
            x, chis, dchis, 1500.0, 0.3, 0.05, **kw)["kappa"], planes),
        "plane_deflection_fields": (
            lambda x, **kw: TRT.plane_deflection_fields(x, 0.05, **kw)[0],
            img),
        "born_convergence_healpix": (
            lambda x, **kw: TLS.born_convergence_healpix(
                x, chis, dchis, 1500.0, 0.3, **kw), shells),
        "flat_sky_mode_counts": (
            lambda x, **kw: TAP.flat_sky_mode_counts(x, 5.0, nbins=4,
                                                     **kw)[1], 16),
        "cl_flat_sky": (
            lambda x, **kw: TAP.cl_flat_sky(x, 5.0, nbins=4, **kw)[1], img),
        "cl_flat_sky_cross": (
            lambda x, **kw: TAP.cl_flat_sky_cross(x, x, 5.0, nbins=4,
                                                  **kw)[1], img),
        "cl_kappa_limber": (
            lambda x, **kw: TAP.cl_kappa_limber(x, tc, 1.0, nchi=16, **kw),
            np.array([100.0, 1000.0])),
        "nonlinear_power": (
            lambda x, **kw: TL.nonlinear_power(x, tc, 0.5, **kw), k),
        "linear_power": (
            lambda x, **kw: TL.linear_power(x, tc, 0.5, **kw), k),
        "eh98_transfer": (lambda x, **kw: TL.eh98_transfer(x, tc, **kw), k),
    }


@pytest.mark.parametrize("name", [
    "multiplane_raytrace", "plane_deflection_fields",
    "born_convergence_healpix", "flat_sky_mode_counts", "cl_flat_sky",
    "cl_flat_sky_cross", "cl_kappa_limber", "nonlinear_power",
    "linear_power", "eh98_transfer"])
def test_numpy_input_placement(rng, name):
    """Input that is not a tensor goes to the CUDA card unless `device` is
    given: with no card (this machine has none) the call raises instead of
    running on the CPU unasked; with device='cpu' it gives, on the CPU,
    what the same values as a CPU tensor give (equal: the same ops)."""
    call, data = _placement_calls(rng)[name]
    if torch.cuda.is_available():
        assert call(data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(data)
    got = call(data, device="cpu")
    assert got.device.type == "cpu" and bool(torch.isfinite(got).all())
    if isinstance(data, np.ndarray):
        same = call(torch.from_numpy(data))
        assert same.device.type == "cpu"
        npt.assert_array_equal(got.numpy(), same.numpy())
