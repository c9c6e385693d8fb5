"""PyTorch port vs JAX package on the CPU: HMC (`hmc_sample`,
`hmc_sample_from_draws`) and the two log-posteriors of
astrild_tpu_torch/ops/inference.py.

`hmc_sample_from_draws` takes the JAX package's draws (keys = split(key,
total), kp, ku = split(keys[i]), normal(kp, (ndim,)), uniform(ku)). On a
fixed-step chain it takes JAX's accept decisions, every one, and its
samples agree within 1e-4. The two chains part in float32 rounding that
XLA's CPU code does its own way: it contracts the leapfrog's updates into
fused multiply-adds and its exp and log are not torch's
(`test_warmup_gap_starts_in_xla_float32_rounding` witnesses both at the
first step). The dual-averaging warm-up moves its log-step by sqrt(t) /
gamma = 20 sqrt(t) times the acceptance statistic's change, and so
grows such a gap from step to step: over a warm-up the two chains
agree for the first steps only, and are held to JAX's own statistical
checks (tests/test_inference.py) and to JAX's adapted step size and
acceptance within stated bands.

The posteriors compute in float64 (the JAX package in float32): logp
within 2e-3 of JAX's where |logp| > 1, gradients within 2e-3 of their
max, at points off the truth.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import inference as JI  # noqa: E402
from astrild_tpu.ops.angular_power import smail_nz  # noqa: E402
from astrild_tpu.ops.forecast import tomographic_shear_cls as jtsc  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JC  # noqa: E402
from astrild_tpu_torch.ops import inference as TI  # noqa: E402
from astrild_tpu_torch.ops.forecast import (  # noqa: E402
    shear_fisher, threex2pt_mean_builder)

COV = np.array([[1.0, 0.6], [0.6, 1.0]], np.float32)
ICOV = np.linalg.inv(COV).astype(np.float32)
POST_RTOL = 2e-3


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


def _jax_draws(key, total, ndim):
    """The momenta and uniforms hmc_sample draws from `key`."""
    def one(k):
        kp, ku = jax.random.split(k)
        return jax.random.normal(kp, (ndim,)), jax.random.uniform(ku)

    n, u = jax.jit(jax.vmap(one))(jax.random.split(key, total))
    return np.asarray(n), np.asarray(u)


TARGETS = {
    "correlated": (lambda x: -0.5 * x @ jnp.asarray(ICOV) @ x,
                   lambda x: -0.5 * x @ torch.from_numpy(ICOV) @ x),
    "diagonal": (lambda x: -0.5 * jnp.sum(jnp.asarray([1.0, 0.25]) * x * x),
                 lambda x: -0.5 * torch.sum(torch.tensor([1.0, 0.25]) * x
                                            * x)),
}


def _accepts(samples, x0):
    """The accept sequence of a chain: a step moved the state."""
    s = np.concatenate([np.asarray(x0)[None], np.asarray(samples)])
    return np.any(s[1:] != s[:-1], axis=1)


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("key,step", [(0, 0.3), (1, 0.9), (2, 1.2)])
def test_fixed_step_chain_takes_jax_decisions(target, key, step):
    """n_warmup = 0, 400 steps of 12 leapfrogs from (0.5, 0.5): the same
    accept sequence, samples within 1e-4, log_prob within 1e-4, the
    rate equal, the step size the one given."""
    jl, tl = TARGETS[target]
    x0 = np.array([0.5, 0.5], np.float32)
    k = jax.random.PRNGKey(key)
    want = JI.hmc_sample(k, jl, jnp.asarray(x0), n_samples=400, n_warmup=0,
                         n_leapfrog=12, step_size=step)
    n, u = _jax_draws(k, 400, 2)
    got = TI.hmc_sample_from_draws(n, u, tl, torch.from_numpy(x0),
                                   n_samples=400, n_warmup=0, n_leapfrog=12,
                                   step_size=step)
    acc = _accepts(want.samples, x0)
    assert 0 < acc.sum() < 400
    assert np.array_equal(_accepts(got.samples.numpy(), x0), acc)
    npt.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                        atol=1e-4)
    npt.assert_allclose(got.log_prob.numpy(), np.asarray(want.log_prob),
                        atol=1e-4)
    npt.assert_allclose(float(got.accept_rate), float(want.accept_rate),
                        rtol=1e-6)
    npt.assert_allclose(float(got.step_size), float(want.step_size),
                        rtol=1e-6)


def test_warmup_first_steps_follow_jax():
    """The first 3 warm-up steps of JAX's correlated-Gaussian run (step
    0.3, key 0): the port's state after each within 2e-5 of JAX's, and
    its adapted step within 2e-5 relative (the gap grows from there,
    module docstring)."""
    jl, tl = TARGETS["correlated"]
    for w in range(1, 4):
        k = jax.random.PRNGKey(0)
        want = JI.hmc_sample(k, jl, jnp.zeros(2), n_samples=1, n_warmup=w,
                             n_leapfrog=12, step_size=0.3)
        n, u = _jax_draws(k, w + 1, 2)
        got = TI.hmc_sample_from_draws(n, u, tl, torch.zeros(2),
                                       n_samples=1, n_warmup=w,
                                       n_leapfrog=12, step_size=0.3)
        npt.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                            atol=2e-5)
        npt.assert_allclose(float(got.step_size), float(want.step_size),
                            rtol=2e-5)


class _XlaElementary:
    """`torch` for the port's sampler, with exp, log and sqrt taken from
    XLA's compiled float32 code (jitted jnp functions) instead of torch's."""
    _fns = {name: jax.jit(getattr(jnp, name)) for name in ("exp", "log",
                                                           "sqrt")}

    def __getattr__(self, name):
        if name in self._fns:
            return lambda t: torch.from_numpy(np.array(
                self._fns[name](t.detach().numpy())))
        return getattr(torch, name)


def _fused_leapfrog(value_and_grad, x, p, eps, n_steps, inv_mass, g):
    """The port's `_leapfrog` with each update a + b c rounded once, as
    XLA's CPU code contracts the kicks and the drift into fused
    multiply-adds (float64 product and sum, one rounding to float32)."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    half = 0.5 * eps
    lp = None
    for _ in range(n_steps):
        p = fma(half, g, p)
        x = fma(eps * inv_mass, p, x)
        lp, g = value_and_grad(x)
        p = fma(half, g, p)
    return x, p, lp, g


def test_warmup_gap_starts_in_xla_float32_rounding(monkeypatch):
    """Witness of where the two warm-up chains part (diagonal target, JAX
    key 0, step 0.3, 12 leapfrogs, from (0, 0)): the port's first
    proposal is 1-4 ulp off JAX's before any exp or log runs (n_warmup =
    0), and equals it bit for bit once the leapfrog's updates are rounded
    once, as XLA contracts them. With those, the step size adapted by
    one warm-up step is an ulp off JAX's under torch's exp, log and sqrt
    and equals it under XLA's: both gaps are float32 rounding that XLA's
    CPU code does its own way, and the dual averaging feeds each back
    into the step size."""
    jl, tl = TARGETS["diagonal"]
    k = jax.random.PRNGKey(0)
    n, u = _jax_draws(k, 1, 2)

    def both(n_warmup, n_samples):
        want = JI.hmc_sample(k, jl, jnp.zeros(2), n_samples=n_samples,
                             n_warmup=n_warmup, n_leapfrog=12,
                             step_size=0.3)
        got = TI.hmc_sample_from_draws(n, u, tl, torch.zeros(2),
                                       n_samples=n_samples,
                                       n_warmup=n_warmup, n_leapfrog=12,
                                       step_size=0.3)
        return want, got

    want, got = both(0, 1)
    w, g = np.asarray(want.samples[0]), got.samples[0].numpy()
    assert np.any(g != w)
    assert np.all(np.abs(g - w) <= 4 * np.spacing(np.abs(w)))
    monkeypatch.setattr(TI, "_leapfrog", _fused_leapfrog)
    want, got = both(0, 1)
    assert np.array_equal(got.samples[0].numpy(), np.asarray(want.samples[0]))

    want, got = both(1, 0)
    w, g = np.float32(want.step_size), np.float32(got.step_size)
    assert g != w and abs(g - w) <= np.spacing(w)
    monkeypatch.setattr(TI, "torch", _XlaElementary())
    want, got = both(1, 0)
    assert np.float32(got.step_size) == np.float32(want.step_size)


def test_hmc_recovers_correlated_gaussian_with_jax_draws():
    """tests/test_inference.py's check on the port, from the JAX draws of
    PRNGKey(0): acceptance in (0.6, 1], mean within 0.1, covariance within
    0.12; the adapted step within 25% and the acceptance within 0.1 of
    JAX's run."""
    jl, tl = TARGETS["correlated"]
    k = jax.random.PRNGKey(0)
    want = JI.hmc_sample(k, jl, jnp.zeros(2), n_samples=2000, n_warmup=500,
                         n_leapfrog=12, step_size=0.3)
    n, u = _jax_draws(k, 2500, 2)
    res = TI.hmc_sample_from_draws(n, u, tl, torch.zeros(2),
                                   n_samples=2000, n_warmup=500,
                                   n_leapfrog=12, step_size=0.3)
    s = res.samples.numpy()
    assert 0.6 < float(res.accept_rate) <= 1.0
    npt.assert_allclose(s.mean(0), 0.0, atol=0.1)
    npt.assert_allclose(np.cov(s.T), COV, atol=0.12)
    npt.assert_allclose(float(res.step_size), float(want.step_size),
                        rtol=0.25)
    assert abs(float(res.accept_rate) - float(want.accept_rate)) < 0.1


def test_hmc_adapts_step_size_from_a_generator():
    """tests/test_inference.py's adaptation check through `hmc_sample`
    (a torch.Generator): the step shrinks below 0.1 on a 1e-4-wide
    target, acceptance > 0.5; the same seed gives the same chain."""
    def logp(x):
        return -0.5 * torch.sum(x * x) * 1e4

    runs = [TI.hmc_sample(torch.Generator().manual_seed(1), logp,
                          torch.zeros(1) + 0.01, n_samples=200,
                          n_warmup=300, n_leapfrog=8, step_size=0.5)
            for _ in range(2)]
    assert float(runs[0].step_size) < 0.1
    assert float(runs[0].accept_rate) > 0.5
    assert torch.equal(runs[0].samples, runs[1].samples)
    assert runs[0].samples.shape == (200, 1)
    assert runs[0].log_prob.shape == (200,)


def test_hmc_draw_shapes_are_checked():
    with pytest.raises(ValueError, match="draws of shapes"):
        TI.hmc_sample_from_draws(np.zeros((10, 2), np.float32),
                                 np.zeros(9, np.float32),
                                 TARGETS["correlated"][1], torch.zeros(2),
                                 n_samples=5, n_warmup=5)


def test_shear_log_posterior_matches_jax():
    """tests/test_inference.py's shear posterior (ells geomspace(100, 800,
    5), z_s = 1, sigma8 in (0.6, 1), fsky 0.3, nchi 48) on the JAX
    package's data stack: logp and its gradient at five points against
    JAX's, the peak at the truth, the barrier outside the box; with the
    port's own data stack logp(truth) is 0 to 1e-9."""
    ells = np.geomspace(100, 800, 5).astype(np.float32)
    truth = {"Om0": 0.3089, "sigma8": 0.8159}
    stack = np.asarray(jtsc(jnp.asarray(ells), JC(**truth), [1.0], nchi=48))
    kw = dict(fsky=0.3, nchi=48, prior_bounds={"sigma8": (0.6, 1.0)})
    jl, _ = JI.shear_log_posterior(ells, stack, [1.0], ["sigma8"], **kw)
    tl, names = TI.shear_log_posterior(ells, stack, [1.0], ["sigma8"],
                                       device="cpu", **kw)
    assert names == ["sigma8"]
    jvg = jax.jit(jax.value_and_grad(jl))
    for s in (0.7, 0.79, 0.85, 0.95, 1.01):
        v, g = jvg(jnp.asarray([s], jnp.float32))
        x = torch.tensor([s], requires_grad=True)
        lp = tl(x)
        (tg,) = torch.autograd.grad(lp, x)
        npt.assert_allclose(float(lp), float(v), rtol=POST_RTOL)
        npt.assert_allclose(float(tg[0]), float(g[0]), rtol=POST_RTOL)
    assert float(tl(torch.tensor([0.8159]))) > float(tl(torch.tensor([0.9])))
    assert float(tl(torch.tensor([0.55]))) < -1e3
    from astrild_tpu_torch.ops.forecast import tomographic_shear_cls

    from astrild_tpu_torch import Cosmology
    own = tomographic_shear_cls(ells, Cosmology(**truth), [1.0], nchi=48,
                                device="cpu")
    tl_own, _ = TI.shear_log_posterior(ells, own, [1.0], ["sigma8"],
                                       device="cpu", **kw)
    assert abs(float(tl_own(torch.tensor([0.8159], dtype=torch.float64)))
               ) < 1e-9


def _threex2pt_setup():
    zt = np.linspace(0.01, 3.0, 100)
    nz = (zt, np.asarray(smail_nz(zt, z0=0.64)))
    rp = np.array([2.0, 5.0, 10.0])
    hod_fixed = {"sigma_logm": 0.3, "log_m0": 12.0, "log_m1": 13.5,
                 "alpha": 1.0}
    kw = dict(nbins_xi=4, theta_min_arcmin=3.0, theta_max_arcmin=100.0,
              nell=64, nchi=16, hod_fixed=hod_fixed)
    mean_fn, _, _ = threex2pt_mean_builder(rp, rp, 64, 5.0, nz, 60.0, 4, 3.0,
                                           100.0, 0.0, 64, 16, True, {},
                                           hod_fixed, device="cpu")
    truth = {"Om0": 0.3, "sigma8": 0.8, "log_mmin": 12.5}
    data = mean_fn({k: torch.tensor(v, dtype=torch.float64)
                    for k, v in truth.items()}).numpy()
    cov = np.diag((0.05 * np.abs(data) + 1e-8) ** 2)
    return rp, nz, kw, truth, data, cov


def test_threex2pt_log_posterior_matches_jax():
    """tests/test_inference.py's 3x2pt posterior at a reduced size (64^2
    pixels, 4 xi bins, 64 ells, 16 chi nodes), the data the port's mean at
    the truth: the port's logp(truth) 0 to 1e-9 (float64 data), JAX's
    logp and gradient at three points off the truth against the port's,
    the barrier below -1e3 outside the Om0 box."""
    rp, nz, kw, truth, data, cov = _threex2pt_setup()
    bounds = {"Om0": (0.1, 0.6)}
    tl, names = TI.threex2pt_log_posterior(
        torch.from_numpy(data), cov, list(truth), rp, rp, 64, 5.0, nz,
        prior_bounds=bounds, **kw)
    assert names == ["Om0", "sigma8", "log_mmin"]
    assert abs(float(tl(torch.tensor([0.3, 0.8, 12.5],
                                     dtype=torch.float64)))) < 1e-9
    jl, _ = JI.threex2pt_log_posterior(data, cov, list(truth), rp, rp, 64,
                                       5.0, nz, prior_bounds=bounds, **kw)
    jvg = jax.jit(jax.value_and_grad(jl))
    for x in ([0.32, 0.8, 12.5], [0.31, 0.81, 12.55], [0.05, 0.8, 12.5]):
        v, g = jvg(jnp.asarray(x, jnp.float32))
        xt = torch.tensor(x, requires_grad=True)
        lp = tl(xt)
        (tg,) = torch.autograd.grad(lp, xt)
        npt.assert_allclose(float(lp), float(v), rtol=POST_RTOL)
        g = np.asarray(g)
        assert np.abs(tg.numpy() - g).max() < POST_RTOL * np.abs(g).max()
        assert np.isfinite(tg.numpy()).all()
    assert float(tl(torch.tensor([0.05, 0.8, 12.5]))) < -1e3


def test_threex2pt_log_posterior_errors():
    """The size guard (data, covariance and model binning) and the
    positive-definiteness guard raise ValueError, with JAX's messages."""
    rp, nz, kw, truth, data, cov = _threex2pt_setup()
    args = (list(truth), rp, rp, 64, 5.0, nz)
    with pytest.raises(ValueError, match="sizes differ"):
        TI.threex2pt_log_posterior(data[:-1], cov, *args, device="cpu",
                                   **kw)
    with pytest.raises(ValueError, match="sizes differ"):
        TI.threex2pt_log_posterior(data[:-2], cov[:-2, :-2], *args,
                                   device="cpu", **kw)
    with pytest.raises(ValueError, match="positive definite"):
        TI.threex2pt_log_posterior(data, np.ones_like(cov) * 1e-6, *args,
                                   device="cpu", **kw)


def test_shear_posterior_hmc_matches_fisher():
    """tests/test_inference.py's slow HMC check on the port at a quarter
    of its length (n_warmup 60, n_samples 100, 6 leapfrogs): the chain's
    mean within 3 sigma_F of the truth, its width within 0.4-2.5 sigma_F
    (sigma_F from shear_fisher)."""
    ells = np.geomspace(100, 800, 5).astype(np.float32)
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.ops.forecast import tomographic_shear_cls

    stack = tomographic_shear_cls(ells, Cosmology(Om0=0.3089, sigma8=0.8159),
                                  [1.0], nchi=48, device="cpu")
    logp, _ = TI.shear_log_posterior(ells, stack, [1.0], ["sigma8"],
                                     fsky=0.3, nchi=48,
                                     prior_bounds={"sigma8": (0.6, 1.0)})
    fish = shear_fisher(ells, {"sigma8": 0.8159}, [1.0], fsky=0.3, nchi=48,
                        fixed={"Om0": 0.3089}, device="cpu")
    sig = float(fish["marginalized"][0])
    res = TI.hmc_sample(torch.Generator().manual_seed(2), logp,
                        torch.tensor([0.79]), n_samples=100, n_warmup=60,
                        n_leapfrog=6, step_size=0.01,
                        inv_mass=torch.tensor([sig ** 2]))
    s = res.samples.numpy()[:, 0]
    assert abs(s.mean() - 0.8159) < 3.0 * sig
    assert 0.4 < s.std() / sig < 2.5


@pytest.mark.parametrize("nonlinear", [False, True])
def test_tomographic_stack_batched_equals_per_pair(nonlinear):
    """A traced cosmology's tomographic stack (the posteriors' mean
    model), linear or halofit, takes all source pairs in one batched
    pass: every pair equals its own cl_kappa_cross_limber call bit for
    bit, and its gradient in (Om0, sigma8) the per-pair one to 1e-13."""
    from astrild_tpu_torch.ops import angular_power as TAP
    from astrild_tpu_torch.ops.forecast import (_cosmology,
                                                tomographic_shear_cls)
    from astrild_tpu_torch.ops.linear_power import normalization

    ells = np.geomspace(100, 3000, 16).astype(np.float32)
    zs = [0.5, 1.0, 1.5]
    x = torch.tensor([0.31, 0.81], dtype=torch.float64, requires_grad=True)
    cosmo = _cosmology({}, {"Om0": x[0], "sigma8": x[1]}, "cpu")
    stack = tomographic_shear_cls(ells, cosmo, zs, nchi=64,
                                  nonlinear=nonlinear)
    amp = normalization(cosmo)
    per_pair = torch.stack([torch.stack([TAP.cl_kappa_cross_limber(
        ells, cosmo, zs[min(i, j)], zs[max(i, j)], nchi=64, amplitude=amp,
        nonlinear=nonlinear) for j in range(3)]) for i in range(3)])
    assert torch.equal(stack, per_pair)
    (g_b,) = torch.autograd.grad(stack.sum(), x, retain_graph=True)
    (g_p,) = torch.autograd.grad(per_pair.sum(), x)
    npt.assert_allclose(g_b.numpy(), g_p.numpy(), rtol=1e-13)
