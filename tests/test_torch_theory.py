"""PyTorch port vs JAX package on the CPU: the differentiable theory chain
(astrild_tpu_torch/utils/cosmology.py with tensor fields,
ops/linear_power.py's EH98 / sigma8 normalization / halofit,
ops/halo_stats.theory_hmf, ops/angular_power.py's Limber and n(z)
kernels).

Values and Jacobians in (Om0, sigma8, w0) are held against `jax.jacfwd`
of the JAX functions: values rtol 1e-4 (the JAX package is float32),
Jacobian columns within 1e-3 of each column's max. The port's own
float64 Jacobian is held against central differences of the port (step
1e-6 of each parameter) to 1e-5, with halofit's ln R_s held at its
fiducial root, as the Jacobian holds it. With float fields the routes of
earlier paths return what they returned before the traced route came in,
bit for bit (`tests/data/torch_theory_float_route.npz`, written by the
code before it).
"""
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import jacfwd  # noqa: E402

from astrild_tpu.ops import angular_power as JA  # noqa: E402
from astrild_tpu.ops import halo_stats as JH  # noqa: E402
from astrild_tpu.ops import linear_power as JL  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.ops import angular_power as TA  # noqa: E402
from astrild_tpu_torch.ops import forecast as TF  # noqa: E402
from astrild_tpu_torch.ops import halo_stats as TH  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology as TC  # noqa: E402

NAMES = ("Om0", "sigma8", "w0")
P0 = np.array([0.3089, 0.8159, -1.0])
VAL_RTOL, JAC_TOL, FD_TOL = 1e-4, 1e-3, 1e-5
# central-difference step, relative to each parameter: the n(z) tables are
# linear between their nodes, and a step that carries a Limber node's z
# across a table node measures a chord, not the derivative
FD_STEP = 1e-6
GOLDEN = Path(__file__).parent / "data" / "torch_theory_float_route.npz"


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


def _jc(x):
    return JC(**dict(zip(NAMES, x)))


def _tc(x):
    return TC(**{n: x[i] for i, n in enumerate(NAMES)})


def _both(jf, tf, p=P0):
    """(value, Jacobian) of the JAX function at float32 p and of the port
    at float64 p, as float64 numpy; Jacobians (..., npar)."""
    pj = jnp.asarray(p, jnp.float32)
    pt = torch.tensor(p, dtype=torch.float64)
    vj = np.asarray(jf(pj), np.float64)
    jj = np.asarray(jax.jacfwd(jf)(pj), np.float64)
    vt = tf(pt).detach().double().numpy()
    jt = jacfwd(tf)(pt).double().numpy()
    return vj, jj, vt, jt


def _cols_close(jt, jj, tol=JAC_TOL):
    """Each column within tol of its max; a column that is 0 in the
    reference (a parameter the function does not depend on) is 0."""
    npar = jj.shape[-1]
    a, b = jt.reshape(-1, npar), jj.reshape(-1, npar)
    scale = np.abs(b).max(0)
    err = np.abs(a - b).max(0) / np.where(scale > 0, scale, 1.0)
    assert (err <= tol).all() and (np.abs(a[:, scale == 0]) == 0).all(), \
        err


def _held_fd(fn, p, hold=True):
    """Central differences of fn (of the parameter vector p) through the
    port's `held_root_differences`: halofit's ln R_s held at the fiducial
    call's roots, as the Jacobian holds them, unless `hold` is False."""
    names = [str(i) for i in range(len(p))]
    return TF.held_root_differences(
        lambda d: fn(torch.tensor([d[k] for k in names],
                                  dtype=torch.float64)),
        dict(zip(names, map(float, p))), FD_STEP, hold)


# ------------------------------------------------------------- Cosmology
def test_cosmology_is_exported():
    import astrild_tpu_torch
    import astrild_tpu_torch.utils as U

    assert astrild_tpu_torch.Cosmology is TC and U.Cosmology is TC


def test_traced_tables_match_jax():
    """chi(z), z(chi), D(z), f(z) and E(z) of a traced cosmology against
    jax.jacfwd of the JAX pytree's."""
    z = np.linspace(0.05, 3.0, 12)

    def jf(x):
        c = _jc(x)
        return jnp.stack([c.comoving_distance(z), c.growth_factor(z),
                          c.growth_rate(z), c.efunc(z),
                          c.redshift_at_comoving_distance(1000.0 * z)])

    def tf(x):
        c = _tc(x)
        return torch.stack([c.comoving_distance(z), c.growth_factor(z),
                            c.growth_rate(z), c.efunc(z),
                            c.redshift_at_comoving_distance(1000.0 * z)])

    vj, jj, vt, jt = _both(jf, tf, np.array([0.3089, 0.8159, -0.9]))
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    for row in range(5):
        _cols_close(jt[row][..., [0, 2]], jj[row][..., [0, 2]])
    assert np.abs(jt[..., 1]).max() == 0.0  # sigma8 moves no table


def test_traced_route_equals_float_route():
    """Constant tensor fields give the float-field tables to 1e-12."""
    c, t = TC(w0=-0.9, wa=0.1), TC(w0=-0.9, wa=0.1).with_tensor_fields()
    assert t.traced and not c.traced and t.device == torch.device("cpu")
    z = np.linspace(0.0, 3.0, 31)
    for name in ("comoving_distance", "growth_factor", "growth_rate",
                 "efunc", "Om"):
        npt.assert_allclose(getattr(t, name)(z).numpy(),
                            getattr(c, name)(z), rtol=1e-12, err_msg=name)


def test_traced_cosmology_compares_by_identity():
    """Tensor fields are never compared or hashed. mu0 is ported: a tensor
    mu0 is a traced cosmology on the growth ODE (never read as zero, as
    the JAX package's _concrete_zero), and mu0 != 0 takes the ODE on
    both routes, its growth within 1.5e-4 of the JAX package's float32
    RK4 (the gap tests/test_torch_mg_growth.py states)."""
    a = TC(Om0=torch.tensor(0.3, dtype=torch.float64))
    b = TC(Om0=torch.tensor(0.3, dtype=torch.float64))
    assert a == a and a != b and hash(a) != hash(b)
    assert TC() == TC() and hash(TC()) == hash(TC())
    assert TC() != a
    t0 = TC(mu0=torch.tensor(0.0))
    assert t0.traced and t0 != TC(mu0=torch.tensor(0.0))
    z = np.array([0.0, 1.0, 3.0])
    want = np.asarray(JC(mu0=0.1).growth_factor(jnp.asarray(z, jnp.float32)))
    npt.assert_allclose(TC(mu0=0.1).growth_factor(z), want, rtol=1.5e-4)
    npt.assert_allclose(TC(mu0=torch.tensor(0.1, dtype=torch.float64))
                        .growth_factor(z).numpy(), want, rtol=1.5e-4)


def test_float_route_is_bit_identical_to_before():
    """Cosmology, linear_power, nonlinear_power, theory_hmf and
    cl_kappa_cross_limber with float fields against the values the code
    before the traced route gave (the golden file), bit for bit."""
    want = np.load(GOLDEN)
    z = np.linspace(0.0, 3.0, 31)
    k = np.logspace(-3, 1, 48)
    m = np.geomspace(1e10, 1e15, 24)
    ells = np.geomspace(10.0, 3000.0, 16)
    cosmos = {"planck": TC(),
              "w": TC(Om0=0.28, sigma8=0.75, w0=-0.9, wa=0.1)}
    for tag, c in cosmos.items():
        got = {
            "chi": c.comoving_distance(z),
            "zchi": c.redshift_at_comoving_distance(1000.0 * z),
            "D": c.growth_factor(z), "f": c.growth_rate(z),
            "E": c.efunc(z),
            "lin": TL.linear_power(k, c, device="cpu"),
            "lin_z1": TL.linear_power(k, c, z=1.0, device="cpu"),
            "nl": TL.nonlinear_power(k, c, device="cpu"),
            "nl_z1": TL.nonlinear_power(k, c, z=1.0, device="cpu"),
            "hmf_st": TH.theory_hmf(m, c, device="cpu"),
            "hmf_t08": TH.theory_hmf(m, c, z=0.5, model="tinker08",
                                     device="cpu"),
            "cl": TA.cl_kappa_cross_limber(ells, c, 0.5, 1.0, nchi=64,
                                           device="cpu"),
            "cl_nl": TA.cl_kappa_cross_limber(ells, c, 0.5, 1.0, nchi=64,
                                              nonlinear=True, device="cpu"),
        }
        for name, v in got.items():
            v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            ref = want[f"{tag}_{name}"]
            assert v.dtype == ref.dtype, (tag, name)
            npt.assert_array_equal(v, ref, err_msg=f"{tag} {name}")


# ------------------------------------------------ EH98, sigma8, halofit
@pytest.mark.parametrize("fn", ["linear_power", "linear_power_nowiggle",
                                "kaiser_p2", "eh98_transfer"])
def test_linear_chain_jacobian_matches_jax(fn):
    """EH98 with its k-independent coefficients traced, the sigma8
    normalization a tensor, the growth a tensor: values and Jacobians."""
    k = np.logspace(-3, 1, 24).astype(np.float32)
    kt = torch.from_numpy(k.astype(np.float64))
    calls = {
        "linear_power": (lambda c: JL.linear_power(k, c, z=0.5),
                         lambda c: TL.linear_power(kt, c, z=0.5)),
        "linear_power_nowiggle": (
            lambda c: JL.linear_power_nowiggle(k, c),
            lambda c: TL.linear_power_nowiggle(kt, c)),
        "kaiser_p2": (lambda c: JL.kaiser_multipoles(k, c, z=0.3,
                                                     bias=1.5)[1],
                      lambda c: TL.kaiser_multipoles(kt, c, z=0.3,
                                                     bias=1.5)[1]),
        "eh98_transfer": (lambda c: JL.eh98_transfer(k, c),
                          lambda c: TL.eh98_transfer(kt, c)),
    }
    jfn, tfn = calls[fn]
    vj, jj, vt, jt = _both(lambda x: jfn(_jc(x)), lambda x: tfn(_tc(x)))
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    if fn == "eh98_transfer":
        jt, jj = jt[..., [0]], jj[..., [0]]  # T(k) moves with Om0 only
    _cols_close(jt, jj)


def test_normalization_is_a_tensor_for_a_traced_cosmology():
    amp = TL.normalization(_tc(torch.tensor(P0)))
    assert isinstance(amp, torch.Tensor) and amp.dtype == torch.float64
    assert isinstance(TL.normalization(TC()), float)
    npt.assert_allclose(float(amp), TL.normalization(TC()), rtol=1e-12)


def test_halofit_jacobian_holds_the_root_fixed():
    """nonlinear_power's Jacobian against jax.jacfwd (lnR_s carries no
    derivative in either); against central differences of the port with
    the root held at its fiducial value to 1e-5; and central differences
    that move the root differ from it by more than 1e-2 of the sigma8
    column's max, so a port that differentiated the root would fail the
    first check."""
    k = np.logspace(-2, 1, 16).astype(np.float32)
    kt = torch.from_numpy(k.astype(np.float64))

    def tf(x):
        return TL.nonlinear_power(kt, _tc(x), z=0.5)

    vj, jj, vt, jt = _both(
        lambda x: JL.nonlinear_power(k, _jc(x), z=0.5), tf)
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    _cols_close(jt, jj)
    _cols_close(jt, _held_fd(tf, P0), FD_TOL)
    free = _held_fd(tf, P0, hold=False)
    assert np.abs(free[:, 1] - jt[:, 1]).max() > 1e-2 * np.abs(
        jt[:, 1]).max()


def test_halofit_parameters_traced_match_host():
    """The traced halofit numbers at constant fields against the host
    float64 route: the same root, n_eff and C to 1e-9."""
    c = TC()
    z = np.array([0.0, 0.5, 1.5])
    host = TL.halofit_parameters(c, z)
    traced = TL.halofit_parameters(c.with_tensor_fields(), z)
    for name in ("k_sigma", "n_eff", "C", "a_n", "nu_n", "f1"):
        npt.assert_allclose(traced[name].numpy(), host[name], rtol=1e-9,
                            err_msg=name)


# ------------------------------------------------------------ mass function
def test_sigma_r_slope_matches_autograd():
    """The closed-form d ln sigma / d ln R against autograd through
    sigma_r, to 1e-10, across both window branches (k R < 0.1 at the
    smallest radii)."""
    c = TC()
    r = torch.tensor(np.geomspace(1e-4, 60.0, 40), dtype=torch.float64,
                     requires_grad=True)
    lnr = torch.log(r)
    (g,) = torch.autograd.grad(torch.log(TL.sigma_r(r, c)).sum(), r)
    sig, slope = TL.sigma_r_slope(r.detach(), c)
    npt.assert_allclose(sig.numpy(), TL.sigma_r(r.detach(), c).numpy(),
                        rtol=1e-14)
    npt.assert_allclose(slope.numpy(), (g * r).detach().numpy(), rtol=0,
                        atol=1e-10)
    assert lnr.shape == slope.shape


@pytest.mark.parametrize("model, z", [("st", 0.0), ("tinker08", 0.5),
                                      ("ps", 1.0)])
def test_theory_hmf_traced_matches_jax(model, z):
    """theory_hmf of a traced cosmology (closed-form slope, no nested
    autograd): values against the JAX package's, and the Jacobian against
    jax.jacfwd of the JAX package run with 64-bit types, to 1e-6 of each
    column's max. (In float32 the JAX package's sigma8 column of the
    exponential tail is off by up to 3.4e-3 of its max: it differentiates
    a float32 autodiff slope.)"""
    m = np.geomspace(1e11, 1e15, 12).astype(np.float32)

    def jf(x):
        return JH.theory_hmf(m, _jc(x), z=z, model=model)

    def tf(x):
        return TH.theory_hmf(m, _tc(x), z=z, model=model, device="cpu")

    vj, _, vt, jt = _both(jf, tf)
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    with jax.enable_x64(True):
        jj = np.asarray(jax.jacfwd(jf)(jnp.asarray(P0, jnp.float64)))
    _cols_close(jt, jj, 1e-6)
    # the traced route at constant fields against the host autograd route
    npt.assert_allclose(
        TH.theory_hmf(m, TC().with_tensor_fields(), z=z, model=model,
                      device="cpu").numpy(),
        TH.theory_hmf(m, TC(), z=z, model=model, device="cpu").numpy(),
        rtol=1e-10)


# ---------------------------------------------------------------- Limber
@pytest.mark.parametrize("nonlinear", [False, True])
def test_cl_kappa_cross_limber_traced_matches_jax(nonlinear):
    """The tensor route of cl_kappa_cross_limber (no host node table):
    values and Jacobian against JAX; the port's float64 Jacobian against
    its central differences (root held) to 1e-5."""
    ells = np.geomspace(50.0, 3000.0, 8).astype(np.float32)

    def tf(x):
        return TA.cl_kappa_cross_limber(torch.from_numpy(ells), _tc(x), 0.6,
                                        1.2, nchi=48, nonlinear=nonlinear)

    vj, jj, vt, jt = _both(
        lambda x: JA.cl_kappa_cross_limber(ells, _jc(x), 0.6, 1.2, nchi=48,
                                           nonlinear=nonlinear), tf)
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    _cols_close(jt, jj)
    _cols_close(jt, _held_fd(tf, P0), FD_TOL)


def test_smail_nz_matches_jax():
    z = np.linspace(0.0, 3.0, 50)
    got = TA.smail_nz(z, z0=0.64, device="cpu")
    assert got.dtype == torch.float32
    npt.assert_allclose(got.numpy(), np.asarray(JA.smail_nz(z, z0=0.64)),
                        rtol=VAL_RTOL)
    zt = torch.from_numpy(z)
    npt.assert_allclose(TA.smail_nz(zt, 0.5, 1.5, 2.0).numpy(),
                        np.asarray(JA.smail_nz(z, 0.5, 1.5, 2.0)),
                        rtol=VAL_RTOL)
    assert TA.C1_RHO_CR == JA.C1_RHO_CR


@pytest.mark.parametrize("case", ["auto", "cross", "ia", "nonlinear"])
def test_cl_kappa_limber_nz_matches_jax(case):
    """n(z) convergence spectra: values and Jacobians in (Om0, sigma8,
    w0), and in A_IA / eta_IA for the NLA case, against JAX; the port's
    float64 Jacobian against its central differences (root held)."""
    ells = np.geomspace(50.0, 2000.0, 6).astype(np.float32)
    zt = np.linspace(0.01, 3.0, 80)
    nz = np.asarray(JA.smail_nz(zt, z0=0.64))
    zt2 = np.linspace(0.01, 2.0, 60)
    nz2 = np.asarray(JA.smail_nz(zt2, z0=0.4))
    kw = dict(nchi=48, nz_quad=96)
    extra = {"cross": dict(z_tab2=zt2, nz_tab2=nz2),
             "nonlinear": dict(nonlinear=True)}.get(case, {})
    p = np.concatenate([P0, [1.0, 0.5]]) if case == "ia" else P0

    def split(x):
        if case != "ia":
            return x, {}
        return x[:3], {"a_ia": x[3], "eta_ia": x[4]}

    def jf(x):
        c, ia = split(x)
        return JA.cl_kappa_limber_nz(ells, _jc(c), zt, nz, **kw, **extra,
                                     **ia)

    def tf(x):
        c, ia = split(x)
        return TA.cl_kappa_limber_nz(torch.from_numpy(ells), _tc(c), zt, nz,
                                     **kw, **extra, **ia)

    vj, jj, vt, jt = _both(jf, tf, p)
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    _cols_close(jt, jj)
    if case == "ia":
        # the NLA kernel looks n(z) up at the Limber nodes with right=0,
        # and the last node lies on the table's last z to rounding: there
        # the model jumps by n(z_max) (in both packages), and a difference
        # quotient measures the jump. Its self-check takes a table that
        # has fallen to ~1e-7 of its peak by its end.
        zt = np.linspace(0.01, 5.0, 160)
        nz = np.asarray(JA.smail_nz(zt, z0=0.64))
        jt = jacfwd(tf)(torch.tensor(p)).numpy()
    _cols_close(jt, _held_fd(tf, p), FD_TOL)


@pytest.mark.parametrize("case", ["gg", "g_kappa_nz", "g_kappa_plane"])
def test_cl_galaxy_limber_nz_matches_jax(case):
    """Galaxy clustering and galaxy-convergence spectra, with the bias a
    traced nuisance parameter."""
    ells = np.geomspace(50.0, 2000.0, 6).astype(np.float32)
    zt = np.linspace(0.2, 1.2, 60)
    nz = np.exp(-0.5 * ((zt - 0.7) / 0.15) ** 2)
    zs = np.linspace(0.01, 3.0, 80)
    extra = {"g_kappa_nz": dict(kappa_nz=(zs, np.asarray(
        JA.smail_nz(zs, z0=0.64)))),
        "g_kappa_plane": dict(z_source=1.5)}.get(case, {})
    p = np.concatenate([P0, [1.6]])

    def jf(x):
        return JA.cl_galaxy_limber_nz(ells, _jc(x[:3]), zt, nz, bias=x[3],
                                      nchi=48, nz_quad=96, **extra)

    def tf(x):
        return TA.cl_galaxy_limber_nz(torch.from_numpy(ells), _tc(x[:3]),
                                      zt, nz, bias=x[3], nchi=48,
                                      nz_quad=96, **extra)

    vj, jj, vt, jt = _both(jf, tf, p)
    npt.assert_allclose(vt, vj, rtol=VAL_RTOL)
    _cols_close(jt, jj)


def test_nz_kernels_with_float_fields_and_edges():
    """A float-field cosmology runs the n(z) kernels on the tensor route
    (its fields as constant tensors) and gives the traced route's C_ell; a
    table starting at z = 0 stays finite; NLA is exactly quadratic in
    A_IA (the JAX package's test)."""
    ells = np.asarray([50.0, 200.0, 800.0])
    zt = np.linspace(0.0, 3.0, 100)
    nz = TA.smail_nz(zt, z0=0.64, device="cpu")
    kw = dict(nchi=64, device="cpu")
    c0 = TA.cl_kappa_limber_nz(ells, TC(), zt, nz, **kw)
    assert c0.dtype == torch.float64 and bool(torch.isfinite(c0).all())
    assert bool((c0 > 0).all())
    npt.assert_array_equal(
        c0.numpy(), TA.cl_kappa_limber_nz(ells, TC().with_tensor_fields(),
                                          zt, nz, **kw).numpy())
    c = {a: TA.cl_kappa_limber_nz(ells, TC(), zt, nz, a_ia=a,
                                  **kw).numpy() for a in (1.0, -1.0, 2.0)}
    gi = (c[1.0] - c[-1.0]) / 2
    ii = (c[1.0] + c[-1.0]) / 2 - c0.numpy()
    npt.assert_allclose(c[2.0], c0.numpy() + 2 * gi + 4 * ii, rtol=1e-10)
    assert (gi < 0).all() and (ii > 0).all()


@pytest.mark.parametrize("name", ["smail_nz", "cl_kappa_limber_nz",
                                  "cl_galaxy_limber_nz"])
def test_nz_numpy_input_placement(name):
    """The n(z) kernels place input as the earlier entry points do
    (`test_numpy_input_placement`): numpy input goes to the CUDA card
    unless `device` is given, and without a card the call raises; with
    device='cpu' it gives what the same values as a float32 CPU tensor
    give (numpy input arrives as float32)."""
    zt = np.linspace(0.01, 2.0, 32)
    nz = np.asarray(JA.smail_nz(zt, z0=0.64))
    kw = dict(nchi=16, nz_quad=32)
    call, data = {
        "smail_nz": (lambda x, **d: TA.smail_nz(x, z0=0.64, **d), zt),
        "cl_kappa_limber_nz": (
            lambda x, **d: TA.cl_kappa_limber_nz(x, TC(), zt, nz, **kw, **d),
            np.geomspace(50.0, 500.0, 4)),
        "cl_galaxy_limber_nz": (
            lambda x, **d: TA.cl_galaxy_limber_nz(x, TC(), zt, nz, **kw,
                                                  **d),
            np.geomspace(50.0, 500.0, 4)),
    }[name]
    if torch.cuda.is_available():
        assert call(data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(data)
    got = call(data, device="cpu")
    assert got.device.type == "cpu" and bool(torch.isfinite(got).all())
    same = call(torch.from_numpy(data.astype(np.float32)))
    assert same.device.type == "cpu"
    npt.assert_array_equal(got.numpy(), same.numpy())


def test_interp_edge_rule_matches_jnp():
    """The tensor interp with left / right fill against jnp.interp's, and
    without them (clamped ends)."""
    from astrild_tpu_torch.utils.tables import interp

    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0.0, 1.0, 20))
    fp = rng.normal(size=20)
    x = np.linspace(-0.2, 1.2, 57)
    t = [torch.from_numpy(a) for a in (x, xp, fp)]
    npt.assert_allclose(interp(*t, left=0.0, right=0.0).numpy(),
                        np.interp(x, xp, fp, left=0.0, right=0.0),
                        rtol=1e-12, atol=1e-15)
    npt.assert_allclose(interp(*t).numpy(), np.interp(x, xp, fp),
                        rtol=1e-12, atol=1e-15)
