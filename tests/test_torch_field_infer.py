"""PyTorch port vs JAX package on the CPU: field-level inference
(ops/field_infer.py) and the gradient of the windowed painter K2.

Mirrors tests/test_field_infer.py. Inputs are made with numpy from a seed
and handed to both packages; on a CPU tensor every paint of the port's
chain is the scatter painter, which autograd differentiates. Each
tolerance is stated where it is checked; the gradient bars follow the
gap of one float32 PM chain to the other (3.1e-5 of a largest gradient of
3.05 at 8^3; 4.6e-6 of the max in GR and f(R) below).

At the prior mean w = 0 the 2LPT particles sit on the lattice, which is
the cell centres: the CIC kink, where the gradient is one-sided and its
side a float32 rounding decision. There the JAX package's jitted and
eager gradients differ by 94 of a largest 105 (its jitted Adam takes the
other side on 122 of 512 coordinates; tools/field_sensitivity.py), so the
optimizer comparisons start off the lattice.

The painter's adjoint is checked three ways here: the plain version
(autograd through `paint_windowed_reference`) by torch's gradcheck in
float64; the kernel's arithmetic (the gather of csrc/paint_windowed.cu's
adjoint, written out in torch below) against the plain version on
positions on cell edges and at x/h -> n; and the wrapper's CPU route.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import field_infer as JF  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JCosmology  # noqa: E402
from astrild_tpu_torch.ops import field_infer as TF  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda as TPC  # noqa: E402
from astrild_tpu_torch.ops.paint import paint  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

BOX = 100.0
SIM_KW = dict(z_init=9.0, nsteps=2, window="cic")
COSMOS = {"gr": {"Om0": 0.3, "h": 0.7},
          "fofr": {"Om0": 0.3, "h": 0.7, "fR0": 1e-5}}
# port gradient against jax.grad: max |diff| <= GRAD_TOL * max |grad|
# (measured 3.9e-6 GR, 4.6e-6 f(R) at 8^3; the issue's chain 1.0e-5)
GRAD_TOL = 2e-5


def _pk(k):
    # smooth red spectrum; amplitude giving mildly nonlinear delta
    return 2.0e3 * (k / 0.1) ** -1.5


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


def _white(rng, n):
    return rng.standard_normal((n, n, n)).astype(np.float32)


def _jax_data(white, cosmo_kw, n):
    return np.array(JF.simulate_density(
        jnp.asarray(white), _pk, JCosmology(**cosmo_kw), ngrid=n,
        boxsize=BOX, **SIM_KW))


# ------------------------------------------------------------ the chain
def test_keyed_pipeline_consistency():
    """simulate_density of the generator's white noise equals the
    lpt_catalog(generator) + pm_evolve + paint chain (the same draw:
    modes_from_white is the one home of the modes); bars as the JAX
    test's (atol 1e-5)."""
    n = 8
    cosmo = Cosmology(**COSMOS["gr"])
    white = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(3))
    got = TF.simulate_density(white, _pk, cosmo, ngrid=n, boxsize=BOX,
                              **SIM_KW)
    comps, mom = TN.lpt_catalog(torch.Generator().manual_seed(3), n, BOX,
                                _pk, cosmo, z_init=9.0)
    comps, _ = TN.pm_evolve(comps, mom, cosmo, n, BOX, 0.1, 1.0, 2,
                            window="cic")
    grid = paint(comps, n, BOX, window="cic", deposit="scatter")
    npt.assert_allclose(got.numpy(), (grid / grid.mean() - 1.0).numpy(),
                        atol=1e-5)


@pytest.mark.parametrize("gravity", sorted(COSMOS))
def test_simulate_density_matches_jax(rng, gravity):
    """The same white noise through both chains: the overdensity within
    2e-5 of its max (two float32 PM runs; measured 6e-6)."""
    n = 8
    white = _white(rng, n)
    want = _jax_data(white, COSMOS[gravity], n)
    got = TF.simulate_density(torch.from_numpy(white), _pk,
                              Cosmology(**COSMOS[gravity]), ngrid=n,
                              boxsize=BOX, **SIM_KW)
    npt.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max())
    # deposit="scatter" is the CPU route, named
    same = TF.simulate_density(torch.from_numpy(white), _pk,
                               Cosmology(**COSMOS[gravity]), ngrid=n,
                               boxsize=BOX, deposit="scatter", **SIM_KW)
    assert torch.equal(same, got)


@pytest.mark.parametrize("gravity", sorted(COSMOS))
def test_field_nll_and_gradient_match_jax(rng, gravity):
    """field_nll and its gradient at 8^3 against jax.grad of the JAX
    package's, at a point off the truth: the loss to rtol 1e-5 (measured
    2e-6), the gradient within GRAD_TOL of its max."""
    n = 8
    truth = _white(rng, n)
    w0 = (0.7 * truth + 0.3 * _white(rng, n)).astype(np.float32)
    data = _jax_data(truth, COSMOS[gravity], n)
    jc = JCosmology(**COSMOS[gravity])
    jloss, jgrad = jax.value_and_grad(
        lambda w: JF.field_nll(w, jnp.asarray(data), 0.05, _pk, jc,
                               boxsize=BOX, **SIM_KW))(jnp.asarray(w0))
    w = torch.from_numpy(w0).requires_grad_(True)
    loss = TF.field_nll(w, torch.from_numpy(data), 0.05, _pk,
                        Cosmology(**COSMOS[gravity]), boxsize=BOX, **SIM_KW)
    (grad,) = torch.autograd.grad(loss, w)
    npt.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    npt.assert_allclose(grad.numpy(), jgrad,
                        atol=GRAD_TOL * np.abs(jgrad).max())


def test_grad_matches_finite_differences():
    """Port of test_grad_matches_finite_differences: the 5 largest-|grad|
    coordinates against central differences (eps 3e-3), with the JAX
    test's bar (5% + 0.3)."""
    n = 8
    gen = torch.Generator().manual_seed(0)
    cosmo = Cosmology(**COSMOS["gr"])
    white_t = torch.randn((n,) * 3, generator=gen)
    data = TF.simulate_density(white_t, _pk, cosmo, ngrid=n, boxsize=BOX,
                               **SIM_KW)
    w0 = 0.7 * white_t + 0.3 * torch.randn((n,) * 3, generator=gen)

    def loss(w):
        return TF.field_nll(w, data, 0.05, _pk, cosmo, boxsize=BOX,
                            **SIM_KW)

    w = w0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(w), w)
    g = g.numpy()
    eps = 3e-3
    with torch.no_grad():
        for idx in np.argsort(-np.abs(g.ravel()))[:5]:
            ijk = np.unravel_index(idx, g.shape)
            wp, wm = w0.clone(), w0.clone()
            wp[ijk] += eps
            wm[ijk] -= eps
            fd = (float(loss(wp)) - float(loss(wm))) / (2 * eps)
            assert abs(fd - g[ijk]) < 0.05 * abs(g[ijk]) + 0.3, (
                ijk, fd, g[ijk])


def test_map_recovery_improves_correlation():
    """Port of test_map_recovery_improves_correlation (16^3, 250 Adam
    iterations from the prior mean at lr 0.08, noise 1e-3) with its bars:
    the loss falls below 5% of its start, and the linear fields correlate
    above 0.9 (the whitened ones above 0.7)."""
    n = 16
    cosmo = Cosmology(**COSMOS["gr"])
    white_t = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(7))
    data = TF.simulate_density(white_t, _pk, cosmo, ngrid=n, boxsize=BOX,
                               **SIM_KW)
    out = TF.infer_initial_field(data, 1e-3, _pk, cosmo, boxsize=BOX,
                                 n_iter=250, lr=0.08, **SIM_KW)
    losses = out["loss"].numpy()
    assert losses.shape == (250,)
    assert losses[-1] < 0.05 * losses[0]
    assert float(losses.min()) == pytest.approx(
        float(TF.field_nll(out["white"], data, 1e-3, _pk, cosmo,
                           boxsize=BOX, **SIM_KW)), rel=1e-5)

    def lin_field(w):
        dk = TM.modes_from_white(w, n, BOX, _pk)
        return torch.fft.ifftn(dk).real.numpy().ravel()

    r_lin = np.corrcoef(lin_field(out["white"]), lin_field(white_t))[0, 1]
    assert r_lin > 0.9, r_lin
    r_white = np.corrcoef(out["white"].numpy().ravel(),
                          white_t.numpy().ravel())[0, 1]
    assert r_white > 0.7, r_white


def test_first_adam_iterates_match_optax(rng):
    """torch.optim.Adam with optax.adam's constants against the JAX
    package's optax loop, from the same warm start off the lattice. The
    returned iterate after 5 steps within 1e-4 (measured 1.5e-5: Adam
    divides each gradient by its own rms, so the float32 gap of the
    gradients shows at full scale in the first steps); the loss history
    over 30 steps to rtol 1e-4 (measured 1.9e-5: the trajectories part
    slowly through the two update orders)."""
    n = 8
    truth = _white(rng, n)
    w0 = (0.5 * truth + 0.3 * _white(rng, n)).astype(np.float32)
    data = _jax_data(truth, COSMOS["gr"], n)
    jc, tc = JCosmology(**COSMOS["gr"]), Cosmology(**COSMOS["gr"])
    for n_iter, w_tol, loss_rtol in ((5, 1e-4, 1e-5), (30, None, 1e-4)):
        want = JF.infer_initial_field(jnp.asarray(data), 1e-2, _pk, jc,
                                      boxsize=BOX, n_iter=n_iter, lr=0.1,
                                      white0=jnp.asarray(w0), **SIM_KW)
        got = TF.infer_initial_field(torch.from_numpy(data), 1e-2, _pk, tc,
                                     boxsize=BOX, n_iter=n_iter, lr=0.1,
                                     white0=torch.from_numpy(w0), **SIM_KW)
        npt.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                            rtol=loss_rtol)
        if w_tol is not None:
            npt.assert_allclose(got["white"].numpy(),
                                np.asarray(want["white"]), atol=w_tol)


def test_infer_initial_field_options():
    """A generator start draws the prior sample from it; the best iterate
    is the one of least loss; NGP raises; numpy input without a card
    raises unless device='cpu'."""
    n = 8
    cosmo = Cosmology(**COSMOS["gr"])
    data = TF.simulate_density(
        torch.randn((n,) * 3, generator=torch.Generator().manual_seed(1)),
        _pk, cosmo, ngrid=n, boxsize=BOX, **SIM_KW)
    out = TF.infer_initial_field(data, 1e-2, _pk, cosmo, boxsize=BOX,
                                 n_iter=3, lr=0.5,
                                 generator=torch.Generator().manual_seed(4),
                                 **SIM_KW)
    start = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(4))
    first = TF.field_nll(start, data, 1e-2, _pk, cosmo, boxsize=BOX,
                         **SIM_KW)
    npt.assert_allclose(float(out["loss"][0]), float(first), rtol=1e-6)
    best = int(torch.argmin(out["loss"]))
    if best == 0:
        assert torch.equal(out["white"], start)
    with pytest.raises(ValueError, match="NGP"):
        TF.infer_initial_field(data, 1e-2, _pk, cosmo, boxsize=BOX,
                               n_iter=1, window="ngp")
    with pytest.raises(ValueError, match="NGP"):
        TF.simulate_density(start, _pk, cosmo, ngrid=n, boxsize=BOX,
                            window="ngp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TF.infer_initial_field(data.numpy(), 1e-2, _pk, cosmo,
                                   boxsize=BOX, n_iter=1, **SIM_KW)
    got = TF.infer_initial_field(data.numpy(), 1e-2, _pk, cosmo, boxsize=BOX,
                                 n_iter=2, device="cpu", **SIM_KW)
    assert got["white"].device.type == "cpu"


def _jax_draws(key, total, ndim):
    """The momenta and uniforms hmc_sample draws from `key`."""
    def one(k):
        kp, ku = jax.random.split(k)
        return jax.random.normal(kp, (ndim,)), jax.random.uniform(ku)

    nrm, uni = jax.jit(jax.vmap(one))(jax.random.split(key, total))
    return np.asarray(nrm), np.asarray(uni)


@pytest.mark.parametrize("n_warmup,n_samples", [(0, 3), (1, 2)])
def test_hmc_chain_from_jax_draws(rng, n_warmup, n_samples):
    """A short field HMC chain at 8^3 (4 leapfrog steps) from the JAX
    package's draws, warm-started off the lattice: every accept decision
    the JAX chain's (its accept rate equal) and the samples within 5e-5
    (measured 3.8e-6). Chains this short flip no decision: the fixed-step
    chain's fourth sample is already 3.3e-4 off (the chain's own
    sensitivity to float32 rounding, through its kinks), and
    the warm-up's second step, whose size the first step's acceptance
    set, flips its accept decision (tools/field_sensitivity.py --part hmc)."""
    n = 8
    truth = _white(rng, n)
    w0 = (0.8 * truth + 0.2 * _white(rng, n)).astype(np.float32)
    data = _jax_data(truth, COSMOS["gr"], n)
    key = jax.random.PRNGKey(6)
    want, want_acc = JF.sample_initial_field(
        key, jnp.asarray(data), 1e-2, _pk, JCosmology(**COSMOS["gr"]),
        boxsize=BOX, n_samples=n_samples, n_warmup=n_warmup, n_leapfrog=4,
        white0=jnp.asarray(w0), **SIM_KW)
    normals, uniforms = _jax_draws(key, n_warmup + n_samples, n ** 3)
    got, acc = TF.sample_initial_field_from_draws(
        normals, uniforms, torch.from_numpy(data), 1e-2, _pk,
        Cosmology(**COSMOS["gr"]), boxsize=BOX, n_samples=n_samples,
        n_warmup=n_warmup, n_leapfrog=4, white0=torch.from_numpy(w0),
        **SIM_KW)
    want = np.asarray(want)
    assert got.shape == (n_samples, n, n, n)
    assert acc == float(want_acc)
    moved = [not np.array_equal(want[i], want[i - 1] if i else w0)
             for i in range(n_samples)]
    assert moved == [not torch.equal(got[i], got[i - 1] if i
                                     else torch.from_numpy(w0))
                     for i in range(n_samples)]
    npt.assert_allclose(got.numpy(), want, atol=5e-5)


def test_sample_initial_field_from_generator():
    """The generator route: samples of the field's shape on the
    generator's device, the same seed the same chain."""
    n = 8
    cosmo = Cosmology(**COSMOS["gr"])
    truth = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(5))
    data = TF.simulate_density(truth, _pk, cosmo, ngrid=n, boxsize=BOX,
                               **SIM_KW)

    def run(seed):
        return TF.sample_initial_field(
            torch.Generator().manual_seed(seed), data.numpy(), 1e-2, _pk,
            cosmo, boxsize=BOX, n_samples=3, n_warmup=2, n_leapfrog=3,
            white0=truth, **SIM_KW)

    (a, acc_a), (b, acc_b) = run(6), run(6)
    assert a.shape == (3, n, n, n) and a.device.type == "cpu"
    assert torch.equal(a, b) and acc_a == acc_b
    assert 0.0 <= acc_a <= 1.0
    with pytest.raises(ValueError, match="NGP"):
        TF.sample_initial_field(torch.Generator(), data, 1e-2, _pk, cosmo,
                                boxsize=BOX, window="ngp")


# ---------------------------------------------------- K2's gradient (CPU)
def _flat(pos):
    return np.ascontiguousarray(pos.T).reshape(-1)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_paint_gradient_gradcheck_float64(rng, order, weighted):
    """The plain version's gradient (autograd through the padded-grid
    index_add_ and the fold) against torch's finite differences in
    float64: gradcheck's fast (directional) and full modes, positions in
    and out of the box."""
    n, ng, box = 30, 6, 50.0
    pos = torch.tensor(_flat(rng.uniform(-box, 2 * box, (n, 3))),
                       dtype=torch.float64, requires_grad=True)
    args = (pos,)
    if weighted:
        args += (torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float64,
                              requires_grad=True),)

    def f(p, *w):
        return TPC.paint_windowed_reference(p, w[0] if w else None, ng, box,
                                            order)

    assert torch.autograd.gradcheck(f, args, fast_mode=True)
    assert torch.autograd.gradcheck(f, args)


def _adjoint_mirror(pos_flat, weights, grad_grid, ngrid, boxsize, order):
    """csrc/paint_windowed.cu's adjoint written out in torch, step for step
    (float32): base cell and fractions of `_windowed_keys`, the 8 / 27
    cells wrapped once, sum_c W_c g_c and w sum_c dW_c/df_a g_c / h."""
    n = pos_flat.shape[0] // 3
    key, frac = TPC._windowed_keys(pos_flat, ngrid, boxsize, order)
    npd = ngrid + 2
    k = key.long()
    base = [k // (npd * npd) - 1, (k // npd) % npd - 1, k % npd - 1]
    lo = 0 if order == 2 else -1
    h = torch.tensor(boxsize / ngrid, dtype=torch.float32)
    g = grad_grid.reshape(-1)
    sw = torch.zeros(n)
    s = torch.zeros(3, n)
    axes = range(order)
    for a in axes:
        for b in axes:
            for c in axes:
                off = (lo + a, lo + b, lo + c)
                cell = [torch.remainder(base[ax] + off[ax], ngrid)
                        for ax in range(3)]
                v = g[(cell[0] * ngrid + cell[1]) * ngrid + cell[2]]
                w = [TPC._axis_weight(frac[ax], off[ax], order)
                     for ax in range(3)]
                dw = [(torch.full_like(frac[ax], float(off[ax] or -1))
                       if order == 2 else
                       (-2.0 * frac[ax] if off[ax] == 0 else
                        off[ax] * (0.5 + off[ax] * frac[ax])))
                      for ax in range(3)]
                sw += w[0] * w[1] * w[2] * v
                s[0] += dw[0] * w[1] * w[2] * v
                s[1] += w[0] * dw[1] * w[2] * v
                s[2] += w[0] * w[1] * dw[2] * v
    wp = torch.ones(n) if weights is None else weights
    return (wp * s / h).reshape(-1), (None if weights is None else sw)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_adjoint_arithmetic_matches_plain_gradient(rng, order, weighted):
    """The kernel's gather against autograd of the plain version, on
    uniform positions, positions on the cell edges where the base cell
    changes (CIC at (k + 0.5) h, TSC at k h) and an ulp to either side,
    and x/h -> n (-1e-8, which wraps to exactly box: TSC's clip). Both
    sum the same float32 products in other orders: within 1e-5 of the
    largest gradient."""
    n, ng, box = 3000, 16, 50.0
    h = box / ng
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    edge = (np.arange(ng) + (0.5 if order == 2 else 0.0)) * h
    pick = rng.integers(0, ng, (n // 2, 3))
    nudge = rng.choice([-1, 0, 1], (n // 2, 3))
    on = edge[pick].astype(np.float32)
    pos[: n // 2] = np.nextafter(on, np.where(nudge < 0, -np.inf, np.inf),
                                 dtype=np.float32)
    pos[: n // 2][nudge == 0] = on[nudge == 0]
    pos[-2:] = [[-1e-8, box - 1e-6, 0.0], [box, -0.0, 1e-8]]
    pf = torch.from_numpy(_flat(pos))
    w = (torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
         if weighted else None)
    g = torch.from_numpy(rng.standard_normal((ng,) * 3).astype(np.float32))
    want_p, want_w = TPC.paint_windowed_adjoint(pf, w, g, ng, box, order)
    got_p, got_w = _adjoint_mirror(pf, w, g, ng, box, order)
    npt.assert_allclose(got_p.numpy(), want_p.numpy(),
                        atol=1e-5 * float(want_p.abs().max()))
    if weighted:
        npt.assert_allclose(got_w.numpy(), want_w.numpy(),
                            atol=1e-5 * float(want_w.abs().max()))
    else:
        assert want_w is None
    # the wrapper's CPU route is the plain version, and paint_windowed
    # differentiates through it
    p = pf.clone().requires_grad_(True)
    out = TPC.paint_windowed(p, w, ng, box, order)
    (gp,) = torch.autograd.grad(out, p, g)
    assert torch.equal(gp, want_p)


def test_refuse_grad_only_where_a_gradient_is_asked():
    """The check by which the kernels without a gradient (K1, K3, K4)
    refuse, on the card, inputs that require grad: it raises only in grad
    mode and only for an input that requires grad (None allowed)."""
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        TPC._refuse_grad("deposit_flat", None, t)
    with torch.no_grad():
        TPC._refuse_grad("deposit_flat", t)
    TPC._refuse_grad("deposit_flat", None, t.detach())
