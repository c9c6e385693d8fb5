"""PyTorch port vs JAX package on the CPU: the modified-gravity growth of
`Cosmology` (astrild_tpu_torch/utils/cosmology.py): the mu0 growth ODE
tables ('const' and 'lambda'), mu, mu_k, growth_factor_k and
fofr_pk_enhancement over fR0, n and z, the traced (tensor-field) route
against the float route, a torch.func.jacfwd in fR0 against jax.jacfwd,
and the f(R) PM evolution against linear theory at 32^3.

The JAX package integrates the growth ODE with a float32 RK4 scan; the
port's tables are float64. Measured gaps on these inputs: ln D 4.9e-5
absolute, f 1.3e-6, D(k) 4.4e-5 relative, the enhancement 6.8e-6
relative, the fR0 Jacobian 1.3e-5 of its max. Each check holds about 3x
its gap, as stated where it is made.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import mocks as JM  # noqa: E402
from astrild_tpu.ops import nbody as JN  # noqa: E402
from astrild_tpu.ops.paint import paint as jpaint  # noqa: E402
from astrild_tpu.ops.power import auto_power as jauto_power  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops.paint import paint as tpaint  # noqa: E402
from astrild_tpu_torch.ops.power import auto_power as tauto_power  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology as TC  # noqa: E402

# measured gaps x ~3 (module docstring)
LND_ATOL, F_ATOL, DK_RTOL, ENH_RTOL, JAC_TOL = 1.5e-4, 4e-6, 1.5e-4, 2e-5, 4e-5
MU0_MODELS = [
    {"mu0": 1.0 / 3.0},
    {"mu0": 1.0 / 3.0, "mu_model": "lambda"},
    {"mu0": 0.2, "w0": -0.9, "wa": 0.1},
    {"mu0": 0.2, "mu_model": "lambda", "Om0": 0.28, "h": 0.7},
]
K = np.geomspace(1e-4, 10.0, 48).astype(np.float32)


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


def _t64(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("kw", MU0_MODELS, ids=lambda kw: "-".join(
    f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
    for k, v in kw.items()))
def test_mu0_growth_tables_match_jax(kw):
    """The ODE tables of a float mu0 != 0: ln D within 1.5e-4, f within
    4e-6 (absolute), and growth_factor / growth_rate / mu at a few z."""
    jc, tc = JC(**kw), TC(**kw)
    npt.assert_allclose(tc._lna_tab, np.asarray(jc._lna_tab), rtol=1e-6)
    npt.assert_allclose(tc._lnD_tab, np.asarray(jc._lnD_tab),
                        atol=LND_ATOL)
    npt.assert_allclose(tc._f_tab, np.asarray(jc._f_tab), atol=F_ATOL)
    z = np.array([0.0, 0.3, 1.0, 3.0, 9.0])
    zj = jnp.asarray(z, jnp.float32)
    npt.assert_allclose(tc.growth_factor(z), np.asarray(jc.growth_factor(
        zj)), rtol=LND_ATOL)
    npt.assert_allclose(tc.growth_rate(z), np.asarray(jc.growth_rate(zj)),
                        atol=F_ATOL)
    a = 1.0 / (1.0 + z)
    npt.assert_allclose(tc.mu(a), np.asarray(jc.mu(jnp.asarray(
        a, jnp.float32))), rtol=1e-6)


def test_mu0_ode_in_gr_limit_and_published_behaviour():
    """The JAX package's checks (tests/test_cosmology.py) on the port: the
    ODE at mu0 = 0 reproduces the integral table (D 2e-4, f 2e-3); mu0 =
    1/3 leaves the background alone, grows more since z = 3 and has a
    larger f today; 'lambda' is weaker than 'const'."""
    gr, fr = TC(), TC(mu0=1.0 / 3.0)
    lna, lnD, f = gr._build_growth_table_ode()
    z = np.array([0.0, 0.5, 1.0, 2.0, 5.0])
    a = 1.0 / (1.0 + z)
    npt.assert_allclose(np.exp(np.interp(np.log(a), lna, lnD)),
                        gr.growth_factor(z), rtol=2e-4)
    npt.assert_allclose(np.interp(np.log(a), lna, f), gr.growth_rate(z),
                        rtol=2e-3)
    npt.assert_allclose(fr.comoving_distance(1.0), gr.comoving_distance(1.0),
                        rtol=1e-12)
    assert 0.7 < fr.growth_factor(3.0) / gr.growth_factor(3.0) < 0.95
    tot = {name: float(np.exp(-c._build_growth_table_ode()[1][0]))
           for name, c in (("gr", gr), ("fr", fr),
                           ("lam", TC(mu0=1.0 / 3.0, mu_model="lambda")))}
    assert 2.5 < tot["fr"] / tot["gr"] < 4.0
    assert 1.02 < tot["lam"] / tot["gr"] < 1.35
    assert fr.growth_rate(0.0) > gr.growth_rate(0.0)
    assert (TC(mu0=0.2, mu_model="lambda").growth_factor(3.0)
            > TC(mu0=0.2).growth_factor(3.0))


@pytest.mark.parametrize("fr0", [1e-4, 1e-5, 1e-6])
@pytest.mark.parametrize("n", [1.0, 2.0])
@pytest.mark.parametrize("z", [0.0, 1.0])
def test_fofr_growth_and_enhancement_match_jax(fr0, n, z):
    """growth_factor_k within 1.5e-4 and fofr_pk_enhancement within 2e-5
    (relative) of the JAX package's, both float32 on the device asked;
    mu_k within 1e-5."""
    jc, tc = JC(fR0=fr0, fR_n=n), TC(fR0=fr0, fR_n=n)
    got = tc.growth_factor_k(K, z, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    npt.assert_allclose(got.numpy(), np.asarray(jc.growth_factor_k(K, z)),
                        rtol=DK_RTOL)
    npt.assert_allclose(tc.fofr_pk_enhancement(K, z, device="cpu").numpy(),
                        np.asarray(jc.fofr_pk_enhancement(K, z)),
                        rtol=ENH_RTOL)
    a = np.array([0.1, 0.5, 1.0])[:, None]
    npt.assert_allclose(tc.mu_k(a, K[None, :]), np.asarray(jc.mu_k(
        jnp.asarray(a, jnp.float32), jnp.asarray(K)[None, :])), rtol=1e-5)


def test_fofr_gr_limits_and_published_window():
    """fR0 = 0 gives exactly 1 and mu_k zeros; k -> 0 is GR; monotonic in
    k; F4 at k = 0.1 in 1.15-1.32, F5 in 1.03-1.12; weaker at z = 1."""
    gr = TC(fR0=0.0)
    assert np.all(gr.fofr_pk_enhancement(K, device="cpu").numpy() == 1.0)
    assert np.all(gr.mu_k(0.5, K) == 0.0)
    e4 = TC(fR0=1e-4).fofr_pk_enhancement(K, device="cpu").numpy()
    e5 = TC(fR0=1e-5).fofr_pk_enhancement(K, device="cpu").numpy()
    assert abs(e4[0] - 1.0) < 1e-4 and np.all(np.diff(e4) > 0)
    assert np.all(e5[1:] < e4[1:]) and np.all(e5[1:] > 1.0)
    k01 = np.array([0.1], np.float32)
    f4 = float(TC(fR0=1e-4).fofr_pk_enhancement(k01, device="cpu")[0])
    f5 = float(TC(fR0=1e-5).fofr_pk_enhancement(k01, device="cpu")[0])
    assert 1.15 < f4 < 1.32 and 1.03 < f5 < 1.12
    assert 1.0 < float(TC(fR0=1e-4).fofr_pk_enhancement(
        k01, z=1.0, device="cpu")[0]) < f4


def test_fofr_placement():
    """Numpy k goes to `device`, by default the CUDA card (raises without
    one); a tensor k keeps its device; a traced cosmology answers in
    float64 on its fields' device."""
    c = TC(fR0=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            c.fofr_pk_enhancement(K)
    assert c.growth_factor_k(torch.from_numpy(K)).device.type == "cpu"
    t = TC(fR0=_t64(1e-5)).fofr_pk_enhancement(K)
    assert t.dtype == torch.float64 and t.device.type == "cpu"


@pytest.mark.parametrize("kw", [{"fR0": 1e-4}, {"fR0": 1e-6, "fR_n": 2.0},
                                {"mu0": 1.0 / 3.0, "mu_model": "lambda"}])
def test_traced_route_matches_float_route(kw):
    """Tensor fields take the float64 torch route: its tables and f(R)
    functions equal the host float64 route to 1e-12 (the same
    arithmetic, in torch)."""
    tc = TC(**kw)
    tt = TC(**{k: v if isinstance(v, str) else _t64(v)
               for k, v in kw.items()})
    assert tt.traced and not tc.traced
    npt.assert_allclose(tt._lnD_tab.numpy(), tc._lnD_tab, rtol=1e-12,
                        atol=1e-13)
    npt.assert_allclose(tt._f_tab.numpy(), tc._f_tab, rtol=1e-12)
    for z in (0.0, 1.0):
        want = tc.growth_factor_k(K, z, device="cpu").numpy()
        got = tt.growth_factor_k(K, z).numpy()
        npt.assert_allclose(got, want, rtol=1e-7)   # want is float32
        want = tc.fofr_pk_enhancement(K, z, device="cpu").numpy()
        npt.assert_allclose(tt.fofr_pk_enhancement(K, z).numpy(), want,
                            rtol=1e-7)


def test_fofr_jacobian_in_fR0_matches_jax():
    """torch.func.jacfwd of fofr_pk_enhancement in fR0 through the traced
    route against jax.jacfwd of the JAX package's: within 4e-5 of the
    column's max; and against a central difference of the port (step 1e-3
    of fR0) within 1e-6 of its max."""
    k = K[::4]
    f0 = 1e-5

    def port(x):
        return TC(fR0=x).fofr_pk_enhancement(k)

    jac = torch.func.jacfwd(port)(_t64(f0)).numpy()
    want = np.asarray(jax.jacfwd(lambda x: JC(fR0=x).fofr_pk_enhancement(
        k))(jnp.float32(f0)))
    assert np.abs(jac - want).max() < JAC_TOL * np.abs(want).max()
    h = 1e-3 * f0
    fd = ((port(_t64(f0 + h)) - port(_t64(f0 - h))) / (2 * h)).numpy()
    assert np.abs(jac - fd).max() < 1e-6 * np.abs(fd).max()


def test_tensor_mu0_takes_the_ode():
    """A tensor mu0 is never read as zero (the JAX package's
    _concrete_zero): mu0 = 0 as a tensor takes the ODE table, which
    differs from the integral table by the ODE's own ~1e-4; its jacfwd in
    mu0 is finite and positive at z = 3 for ln D(z = 3) / D(0) < 0."""
    t0 = TC(mu0=_t64(0.0))
    assert t0.traced
    z = np.array([0.0, 1.0, 3.0])
    npt.assert_allclose(t0.growth_factor(z).numpy(), TC().growth_factor(z),
                        rtol=2e-4)

    def d3(m):
        return TC(mu0=m).growth_factor(3.0)

    g = torch.func.jacfwd(d3)(_t64(0.2))
    assert torch.isfinite(g).all() and float(g) < 0.0


def test_fofr_pm_growth_matches_linear_ode():
    """The port's twin of tests/test_nbody.py's
    test_fofr_pm_growth_matches_linear_ode at its own size (32^3 particles
    on 32^3, 400 Mpc/h, flat P(k) = 20, 2LPT at z = 9, 16 KDK steps), from
    the JAX package's modes of PRNGKey(13): P_fR/P_GR on bins 1-8 within
    3% of fofr_pk_enhancement(k, 0) / fofr_pk_enhancement(k, 9), which
    exceeds 1.1 there; and within 2e-3 of the JAX package's measured
    ratio on the same modes."""
    npart, box, z_i = 32, 400.0, 9.0
    a_i = 1.0 / (1.0 + z_i)

    def pk(k):
        return 20.0 * (torch.ones_like(k) if isinstance(k, torch.Tensor)
                       else jnp.ones_like(k))

    gr_kw, fr_kw = {"Om0": 0.3, "h": 0.7}, {"Om0": 0.3, "h": 0.7,
                                             "fR0": 1e-4}
    modes = np.asarray(JM.linear_modes(jax.random.PRNGKey(13), npart, box,
                                       pk))
    ratios = {}
    for pkg, C, lpt, evolve, paint, auto_power, cast in (
            ("jax", JC, JN.lpt_catalog_from_modes, JN.pm_evolve, jpaint,
             jauto_power, jnp.asarray),
            ("port", TC, TN.lpt_catalog_from_modes, TN.pm_evolve, tpaint,
             tauto_power, torch.from_numpy)):
        gr, fr = C(**gr_kw), C(**fr_kw)
        comps, mom = lpt(cast(modes.copy()), npart, box, gr, z_i)
        p = []
        for cosmo in (gr, fr):
            out, _ = evolve(comps, mom, cosmo, npart, box, a_i, 1.0, 16)
            res = auto_power(paint(out, npart, box, window="cic"), box,
                             nbins=10)
            k, power = res[0], res[1]
            p.append(np.asarray(power))
        ratios[pkg] = p[1] / p[0]
    fr = TC(**fr_kw)
    k = np.asarray(k)
    theory = (fr.fofr_pk_enhancement(k, 0.0, device="cpu").numpy()
              / fr.fofr_pk_enhancement(k, z_i, device="cpu").numpy())
    sel = slice(1, 9)
    assert theory[sel].max() > 1.1
    err = np.abs(ratios["port"][sel] / theory[sel] - 1.0)
    assert err.max() < 0.03, (ratios["port"][sel], theory[sel])
    npt.assert_allclose(ratios["port"][sel], ratios["jax"][sel], rtol=2e-3)
