"""PyTorch port vs JAX package on the CPU: the ISW theory and the 2D
bispectrum. The constants `ops/sz.py` needs, the background `Cosmology`
methods (`H`, `rho_crit`, `rho_mean0`, `angular_diameter_distance`,
`lookback_time`, `age`, `lensing_kernel`, `sigma_crit_inv`) on the host
and the tensor route, the lazy `PLANCK18`, `p_dpdp`, `cl_isw_limber`,
`bispectrum_2d_equilateral` and the facades `LinearPowerSpectrum`,
`LinearAngularPowerSpectrum` and `Bispectrum2D`.

The host route is float64 against the JAX package's float32 tables (rtol
1e-5), the tensor route float64 against the host route (rtol 1e-12);
the theory spectra agree with JAX to rtol 1e-4 (float32 EH98 and growth
in JAX); the bispectrum's shell masks come from squared mode numbers
equal to JAX's bit for bit, its B(ell) within 1e-5 of max.
"""
from functools import lru_cache

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.models import power as JPM  # noqa: E402
from astrild_tpu.ops import angular_power as JAP  # noqa: E402
from astrild_tpu.ops import bispectrum as JB  # noqa: E402
from astrild_tpu.ops import linear_power as JLP  # noqa: E402
from astrild_tpu.utils import constants as JCONST  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.models import power as TPM  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TAP  # noqa: E402
from astrild_tpu_torch.ops import bispectrum as TB  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TLP  # noqa: E402
from astrild_tpu_torch.utils import constants as TCONST  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology as TC  # noqa: E402

HOST_RTOL = 1e-5     # float64 host tables against JAX's float32 ones
TRACED_RTOL = 1e-12  # the tensor route against the host route
THEORY_RTOL = 1e-4   # spectra against JAX
# P_dpdp carries (1 - f(z))^2: the JAX package's float32 growth-rate table
# is 1.5e-5 off the float64 one, 1.4e-4 of 1 - f at z = 1.2
DPDP_RTOL = 5e-4


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


@pytest.mark.parametrize("name", ["G_MPC_KMS2_MSUN", "T_CMB", "MPC_KM",
                                  "SIGMA_T_MPC2", "M_PROTON_MSUN",
                                  "M_ELECTRON_MSUN"])
def test_constants_copied_bit_for_bit(name):
    assert getattr(TCONST, name) == getattr(JCONST, name)


# --------------------------------------------------------------- Cosmology
ZS = np.array([0.0, 0.1, 0.5, 1.0, 2.5, 10.0, 39.0, 45.0])
BACKGROUND = {
    "H": lambda c: c.H(ZS),
    "rho_crit": lambda c: c.rho_crit(ZS),
    "angular_diameter_distance": lambda c: c.angular_diameter_distance(ZS),
    "lookback_time": lambda c: c.lookback_time(ZS[:-1]),
    "age": lambda c: c.age(ZS),
    "lensing_kernel": lambda c: c.lensing_kernel(
        np.array([0.0, 100.0, 1500.0, 2999.0, 3500.0]), 3000.0),
    "sigma_crit_inv": lambda c: c.sigma_crit_inv(
        np.array([0.1, 0.3, 0.6, 1.2]), 1.0),
}


@pytest.mark.parametrize("name", sorted(BACKGROUND))
@pytest.mark.parametrize("fields", [{}, {"Om0": 0.27, "h": 0.72,
                                         "w0": -0.9, "wa": 0.1}])
def test_background_methods_both_routes(name, fields):
    """Each new method: the host route against JAX (rtol 1e-5; zeros
    exact), and the tensor route against the host route (rtol 1e-12)."""
    fn = BACKGROUND[name]
    host = np.asarray(fn(TC(**fields)), np.float64)
    want = np.asarray(fn(JC(**fields)), np.float64)
    npt.assert_allclose(host, want, rtol=HOST_RTOL, atol=0)
    traced = fn(TC(**fields).with_tensor_fields("cpu"))
    assert isinstance(traced, torch.Tensor) and traced.dtype == torch.float64
    npt.assert_allclose(traced.numpy(), host, rtol=TRACED_RTOL, atol=0)


def test_rho_mean0_and_lensing_kernel_shape():
    """rho_mean0 on both routes; the JAX package's lensing-kernel test
    (zero at the ends, chi_s / 4 at chi_s / 2)."""
    c = TC()
    npt.assert_allclose(c.rho_mean0(), float(JC().rho_mean0()), rtol=1e-7)
    assert float(c.with_tensor_fields("cpu").rho_mean0()) == c.rho_mean0()
    chi_s = 3000.0
    assert float(c.lensing_kernel(0.0, chi_s)) == 0.0
    assert float(c.lensing_kernel(chi_s, chi_s)) == 0.0
    npt.assert_allclose(float(c.lensing_kernel(chi_s / 2, chi_s)),
                        chi_s / 4, rtol=1e-6)


def test_tensor_route_is_differentiable():
    """The tensor route's D_A and age follow autograd in Om0 (against a
    central difference of the host route, rtol 1e-5)."""
    om = torch.tensor(0.31, dtype=torch.float64, requires_grad=True)
    c = TC(Om0=om)
    (c.angular_diameter_distance(1.0) + c.age(0.5)).backward()
    eps = 1e-5

    def host(o):
        h = TC(Om0=o)
        return float(h.angular_diameter_distance(1.0) + h.age(0.5))

    fd = (host(0.31 + eps) - host(0.31 - eps)) / (2 * eps)
    npt.assert_allclose(float(om.grad), fd, rtol=1e-5)


def test_planck18_lazy_at_every_level():
    """`PLANCK18` is no module global after import (PEP 562: built on first
    use), and is one object at the package, utils and cosmology levels,
    with the default fields."""
    import astrild_tpu_torch
    import astrild_tpu_torch.utils
    import astrild_tpu_torch.utils.cosmology as tcosmo

    assert "PLANCK18" not in vars(tcosmo)
    assert "PLANCK18" not in vars(astrild_tpu_torch.utils)
    assert "PLANCK18" not in astrild_tpu_torch.utils.__all__
    p = astrild_tpu_torch.PLANCK18
    assert p is astrild_tpu_torch.utils.PLANCK18 is tcosmo.PLANCK18
    assert p == TC() and float(p.comoving_distance(0.0)) == 0.0
    with pytest.raises(AttributeError):
        astrild_tpu_torch.utils.cosmology.PLANCK15  # noqa: B018


# ------------------------------------------------------- ISW theory
ISW_ELLS = (2.0, 10.0, 50.0, 200.0, 1000.0, 2000.0)


@lru_cache(maxsize=None)
def jax_cl_isw():
    """The JAX package's C_ell^TT at ISW_ELLS (z 0.08 - 0.9), once."""
    return np.asarray(JAP.cl_isw_limber(jnp.asarray(ISW_ELLS, jnp.float32),
                                        JC()))


@pytest.mark.parametrize("z", [0.0, 0.5, 1.2])
def test_p_dpdp_matches_jax_both_routes(z):
    k = np.logspace(-3, 0, 24).astype(np.float32)
    want = np.asarray(JLP.p_dpdp(jnp.asarray(k), z, JC()))
    host = TLP.p_dpdp(k, z, TC(), device="cpu")
    assert host.dtype == torch.float32
    npt.assert_allclose(host.numpy(), want, rtol=DPDP_RTOL)
    traced = TLP.p_dpdp(torch.from_numpy(k).double(), z,
                        TC().with_tensor_fields("cpu"))
    assert traced.dtype == torch.float64
    npt.assert_allclose(traced.numpy(), host.numpy(), rtol=1e-6)


def test_cl_isw_limber_matches_jax_both_routes():
    """C_ell^TT at ell 2-2000 against JAX (rtol 1e-4) on both routes,
    positive and falling at high ell; the tensor route carries a gradient
    in Om0 (its tables' derivatives are checked in
    test_tensor_route_is_differentiable)."""
    ells = np.array(ISW_ELLS, np.float32)
    want = jax_cl_isw()
    host = TAP.cl_isw_limber(ells, TC(), device="cpu").numpy()
    npt.assert_allclose(host, want, rtol=THEORY_RTOL)
    traced = TAP.cl_isw_limber(ells, TC().with_tensor_fields("cpu"))
    npt.assert_allclose(traced.numpy(), want, rtol=THEORY_RTOL)
    assert (host > 0).all() and host[-1] < host[0]
    om = torch.tensor(0.3089, dtype=torch.float64, requires_grad=True)
    TAP.cl_isw_limber(ells[:1], TC(Om0=om))[0].backward()
    assert np.isfinite(float(om.grad)) and float(om.grad) != 0.0


# ------------------------------------------------------- 2D bispectrum
@pytest.mark.parametrize("nt", [16, 32, 48, 100, 128])
def test_bispectrum_2d_mode_m2_bit_for_bit(nt):
    """The squared mode numbers the shell masks compare: the JAX package's
    jitted (fftfreq(nt) * nt)^2 sums equal the port's bit for bit."""
    @jax.jit
    def m2():
        fx = (jnp.fft.fftfreq(nt) * nt).astype(jnp.float32)
        fz = (jnp.fft.rfftfreq(nt) * nt).astype(jnp.float32)
        return fx[:, None] ** 2 + fz[None, :] ** 2

    npt.assert_array_equal(TB._mode_m2_2d(nt, "cpu").numpy(),
                           np.asarray(m2()))


def _chi2_map(n=128, seed=7):
    from scipy.ndimage import gaussian_filter

    g = np.random.default_rng(seed).normal(0, 1.0, (n, n)).astype(
        np.float32)
    gs = gaussian_filter(g, 3.0)
    return (gs ** 2 - np.mean(gs ** 2)).astype(np.float32)


@pytest.mark.parametrize("n,nbins,m_max", [(128, 8, None), (64, 6, None),
                                           (128, 6, 20.0)])
def test_bispectrum_2d_matches_jax(n, nbins, m_max):
    """ell and ntri equal (host tables, float32), B within 1e-5 of max;
    the chi^2 field's B positive in the first shells and far above the
    noise shells (the JAX package's test); the host tables cached as
    numpy."""
    img = _chi2_map()[:n, :n]
    kw = dict(nbins=nbins) if m_max is None else dict(nbins=nbins,
                                                      m_max=m_max)
    want = [np.asarray(a) for a in JB.bispectrum_2d_equilateral(
        jnp.asarray(img), 5.0, **kw)]
    got = [a.numpy() for a in TB.bispectrum_2d_equilateral(
        img, 5.0, device="cpu", **kw)]
    npt.assert_array_equal(got[0], want[0])
    npt.assert_array_equal(got[2], want[2])
    npt.assert_allclose(got[1], want[1], rtol=0,
                        atol=1e-5 * np.abs(want[1]).max())
    if m_max is None and n == 128:
        b = got[1]
        assert b[0] > 0 and b[1] > 0 and abs(b[0]) > 100 * abs(b[-1])
    tables = TB.bispectrum_2d_tables_host(TB.band_limited_size(
        n, n / 2.0 - 1.0 if m_max is None else m_max), nbins, 1.0,
        n / 2.0 - 1.0 if m_max is None else m_max)
    assert all(isinstance(t, np.ndarray) for t in tables)


# ------------------------------------------------------------ facades
def test_linear_power_spectrum_facade():
    k = np.logspace(-2, 0.5, 12)
    j, t = JPM.LinearPowerSpectrum(JC()), TPM.LinearPowerSpectrum(
        TC(), device="cpu")
    npt.assert_allclose(t.P_dd(k, z=0.5), j.P_dd(k, z=0.5),
                        rtol=THEORY_RTOL)
    npt.assert_allclose(t.P_dpdp(0.5, k), j.P_dpdp(0.5, k),
                        rtol=DPDP_RTOL)
    # D and f from float64 tables against JAX's float32 ones (its f is
    # 1.5e-5 off)
    npt.assert_allclose(t.growth_functions(0.7), j.growth_functions(0.7),
                        rtol=5e-5)
    for a, b in zip(t.kaiser_multipoles(k, z=0.3, bias=1.5),
                    j.kaiser_multipoles(k, z=0.3, bias=1.5)):
        npt.assert_allclose(a, b, rtol=THEORY_RTOL)
    npt.assert_allclose(t.P_nl(k, z=0.2), j.P_nl(k, z=0.2),
                        rtol=THEORY_RTOL)
    with pytest.raises(ValueError, match="unknown nonlinear method"):
        t.P_nl(k, method="emulator")


def test_linear_angular_power_spectrum_facade():
    """C_TT against JAX's cl_isw_limber over the same redshift range (the
    JAX facade is that call), C_kappa against the JAX facade's."""
    ells = np.array(ISW_ELLS)
    t = TPM.LinearAngularPowerSpectrum(ells, [0.08, 0.5, 0.9], TC(),
                                       device="cpu")
    npt.assert_array_equal(t.ells, ells)
    npt.assert_allclose(t.Cl, jax_cl_isw(), rtol=THEORY_RTOL)
    j = JPM.LinearAngularPowerSpectrum(ells, [0.08, 0.9], JC())
    npt.assert_allclose(t.compute_C_kappa(1.0), j.compute_C_kappa(1.0),
                        rtol=THEORY_RTOL)


def test_bispectrum_classes():
    """The JAX package's facade test: Bispectrum2D from an array and from
    a SkyArray, against JAX."""
    from astrild_tpu_torch.models import SkyArray

    img = np.random.default_rng(42).normal(0, 1, (64, 64)).astype(
        np.float32)
    ell, b, nt = TPM.Bispectrum2D.compute(img, 5.0, nbins=6, device="cpu")
    assert ell.shape == (6,)
    jell, jb, jnt = JPM.Bispectrum2D.compute(jnp.asarray(img), 5.0, nbins=6)
    npt.assert_array_equal(ell, jell)
    npt.assert_allclose(b, jb, rtol=0, atol=1e-5 * np.abs(jb).max())
    sky = SkyArray.from_array(img, 5.0, device="cpu")
    ell2, b2, _ = TPM.Bispectrum2D.compute(sky, nbins=6)
    npt.assert_array_equal(ell2, ell)
    npt.assert_array_equal(b2, b)
