"""PyTorch port vs JAX package on the CPU: the forward model (cosmology,
linear power, linear modes, 2LPT, the PM force solve and the KDK
evolution).

Inputs are made with numpy from a seed and handed to both packages; the
port's paints run the plain painters, which its wrappers use for CPU
tensors. The JAX cosmology tables are float32 and the port's float64, so
table-derived values agree to float32 rounding. Each tolerance is stated
where it is checked.
"""
import dataclasses

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import linear_power as JL  # noqa: E402
from astrild_tpu.ops import mocks as JM  # noqa: E402
from astrild_tpu.ops import nbody as JN  # noqa: E402
from astrild_tpu.ops import recon as JR  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JCosmology  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops import recon as TR  # noqa: E402
from astrild_tpu_torch.ops.paint import paint as tpaint  # noqa: E402
from astrild_tpu_torch.ops.power import delta_k as tdelta_k  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

COSMOS = {
    "planck": {},
    "lcdm": {"Om0": 0.3, "h": 0.7},
    "w0wa": {"Om0": 0.28, "w0": -0.9, "wa": 0.2},
    "fofr": {"Om0": 0.3, "h": 0.7, "fR0": 1e-5},
}


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


def _both(kw):
    return JCosmology(**kw), Cosmology(**kw)


def _pk_flat(amp):
    def pk(k):
        return amp * (torch.ones_like(k) if isinstance(k, torch.Tensor)
                      else jnp.ones_like(k))
    return pk


def _modes(rng, n, box, amp=50.0):
    """Unnormalized fftn linear modes (complex64 numpy) of a flat P(k) from
    a numpy white-noise field, through the JAX package."""
    white = rng.standard_normal((n, n, n)).astype(np.float32)
    return np.array(JM.modes_from_white(jnp.asarray(white), n, box,
                                        _pk_flat(amp)))


def _tensors(arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)


# ------------------------------------------------------------ cosmology
@pytest.mark.parametrize("name", sorted(COSMOS))
def test_cosmology_matches_jax(name):
    """Background, distances and growth agree to the JAX tables' float32
    rounding: rtol 1e-5 (growth rate 3e-5: the JAX table's f = dlnE/dlna +
    integrand/I is a difference of float32 terms)."""
    jc, tc = _both(COSMOS[name])
    z = np.array([0.0, 0.1, 0.5, 1.0, 2.5, 5.0, 9.0, 30.0])
    a = 1.0 / (1.0 + z)
    zj = jnp.asarray(z, jnp.float32)
    checks = [("efunc", z, 1e-6), ("Om", z, 1e-6),
              ("comoving_distance", z, 1e-5), ("growth_factor", z, 1e-5),
              ("growth_rate", z, 3e-5)]
    for meth, arg, rtol in checks:
        want = np.asarray(getattr(jc, meth)(zj))
        npt.assert_allclose(getattr(tc, meth)(arg), want, rtol=rtol,
                            err_msg=meth)
    npt.assert_allclose(tc.efunc_a(a), np.asarray(jc.efunc_a(
        jnp.asarray(a, jnp.float32))), rtol=1e-6)
    chi = np.array([10.0, 500.0, 2300.0, 6000.0])
    npt.assert_allclose(tc.redshift_at_comoving_distance(chi), np.asarray(
        jc.redshift_at_comoving_distance(jnp.asarray(chi, jnp.float32))),
        rtol=1e-5, atol=1e-6)
    if tc.fR0:
        npt.assert_allclose(tc.scalaron_mass2(a), np.asarray(
            jc.scalaron_mass2(jnp.asarray(a, jnp.float32))), rtol=1e-5)


def test_cosmology_from_jax_fields_and_unported_mu0():
    jc = JCosmology(Om0=0.31, h=0.68, fR0=1e-6, w0=-0.95)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    tc = Cosmology.from_jax_fields(fields)
    assert (tc.Om0, tc.h, tc.fR0, tc.w0) == (0.31, 0.68, 1e-6, -0.95)
    assert tc == Cosmology(Om0=0.31, h=0.68, fR0=1e-6, w0=-0.95)
    npt.assert_allclose(tc.growth_factor(1.0), np.asarray(
        jc.growth_factor(1.0)), rtol=1e-5)
    # mu0 != 0 is ported: the growth ODE table, against the JAX package's
    # float32 RK4 to 1.5e-4 (tests/test_torch_mg_growth.py states the gap)
    jm = JCosmology(mu0=0.1)
    tm = Cosmology.from_jax_fields(
        {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)})
    assert tm == Cosmology(mu0=0.1)
    z = np.array([0.0, 1.0, 3.0])
    npt.assert_allclose(tm.growth_factor(z), np.asarray(
        jm.growth_factor(jnp.asarray(z, jnp.float32))), rtol=1.5e-4)
    npt.assert_allclose(tm.growth_rate(z), np.asarray(
        jm.growth_rate(jnp.asarray(z, jnp.float32))), atol=4e-6)


def test_linear_power_matches_jax():
    """EH98 P(k) and its sigma8 normalization: rtol 1e-4 (the JAX
    sigma_r integral is a float32 trapezoid; the port's is float64)."""
    for kw in (COSMOS["planck"], COSMOS["lcdm"]):
        jc, tc = _both(kw)
        k = np.geomspace(1e-4, 20.0, 200).astype(np.float32)
        npt.assert_allclose(
            TL.eh98_transfer(torch.from_numpy(k), tc).numpy(),
            np.asarray(JL.eh98_transfer(jnp.asarray(k), jc)), rtol=2e-5)
        amp_j = float(JL.normalization(jc))
        npt.assert_allclose(TL.normalization(tc), amp_j, rtol=1e-4)
        npt.assert_allclose(float(TL.sigma_r(8.0, tc, TL.normalization(tc))),
                            tc.sigma8, rtol=1e-12)
        for z in (0.0, 2.0):
            got = TL.linear_power(torch.from_numpy(k), tc, z,
                                  amplitude=amp_j).numpy()
            want = np.asarray(JL.linear_power(jnp.asarray(k), jc, z,
                                              amplitude=amp_j))
            npt.assert_allclose(got, want, rtol=5e-5)


# ------------------------------------------------------- modes, gather
@pytest.mark.parametrize("n", [8, 15])
def test_modes_from_white_matches_jax(rng, n):
    """Same white noise -> the same modes (float32 FFT rounding: atol
    1e-5 of the largest mode)."""
    box = 120.0
    white = rng.standard_normal((n, n, n)).astype(np.float32)
    jc, tc = _both(COSMOS["lcdm"])
    amp = float(JL.normalization(jc))

    def pk_j(k):
        return JL.linear_power(k, jc, 0.0, amplitude=amp)

    def pk_t(k):
        return TL.linear_power(k, tc, 0.0, amplitude=amp)

    want = np.asarray(JM.modes_from_white(jnp.asarray(white), n, box, pk_j))
    got = TM.modes_from_white(torch.from_numpy(white), n, box, pk_t).numpy()
    npt.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_linear_modes_from_generator():
    """The generator replaces the PRNG key: the same seed gives the same
    modes, another seed other modes; the DC mode is zero."""
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return TM.linear_modes(gen, 8, 50.0, _pk_flat(10.0))

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (8, 8, 8) and a.dtype == torch.complex64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a[0, 0, 0] == 0


def test_sample_displacement_matches_jax(rng):
    """Trilinear periodic gather, (n, 3) and tuple positions, including
    positions on and past the box edges: atol 1e-6 of the grid's range."""
    n, box = 12, 60.0
    grids = rng.standard_normal((3, n, n, n)).astype(np.float32)
    pos = rng.uniform(0, box, (500, 3)).astype(np.float32)
    pos[0] = [0.0, box, -0.0]
    pos[1] = [box - 1e-4, -1.0, box + 3.0]
    want = np.asarray(JR.sample_displacement(jnp.asarray(grids), box,
                                             jnp.asarray(pos)))
    for p in (torch.from_numpy(pos), _tensors(pos.T)):
        got = TR.sample_displacement(torch.from_numpy(grids), box, p)
        npt.assert_allclose(got.numpy(), want, atol=1e-6 * 4.0)


# ------------------------------------------------------------------ 2LPT
@pytest.mark.parametrize("n", [9, 16])
def test_lpt_displacements_from_modes_matches_jax(rng, n):
    """psi1 and psi2 from the same modes: atol 2e-5 of each field's max
    (float32 FFTs; psi2 is a product of second derivatives)."""
    box = 100.0
    dk = _modes(rng, n, box)
    j1, j2 = JN.lpt_displacements_from_modes(jnp.asarray(dk), n, box)
    t1, t2 = TN.lpt_displacements_from_modes(torch.from_numpy(dk), n, box)
    for got, want in ((t1, j1), (t2, j2)):
        want = np.asarray(want)
        npt.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max())
    s2j = np.asarray(JN._second_order_source(jnp.asarray(dk), n, box))
    s2t = TN._second_order_source(torch.from_numpy(dk), n, box).numpy()
    npt.assert_allclose(s2t, s2j, atol=2e-5 * np.abs(s2j).max())


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("pass_growth", [False, True])
def test_lpt_catalog_from_modes_matches_jax(rng, order, pass_growth):
    """IC positions and momenta from the same modes. With growth= both
    sides take the same host scalars: positions to 1e-4 Mpc/h (float32
    positions of order 100), momenta to 1e-5 of their max. Without it
    each side uses its own growth tables (rtol ~2e-5 apart)."""
    n, box, z_init = 16, 100.0, 9.0
    jc, tc = _both(COSMOS["lcdm"])
    dk = _modes(rng, n, box, amp=200.0)
    growth = None
    if pass_growth:
        growth = (*TN.lpt_growth(tc, z_init, order), float(tc.efunc(z_init)))
    jcomps, jmom = JN.lpt_catalog_from_modes(jnp.asarray(dk), n, box, jc,
                                             z_init, order=order,
                                             growth=growth)
    tcomps, tmom = TN.lpt_catalog_from_modes(dk, n, box, tc, z_init,
                                             order=order, growth=growth,
                                             device="cpu")
    rel = 1e-5 if pass_growth else 5e-5
    for got, want in zip(tcomps, jcomps):
        d = np.abs(got.numpy() - np.asarray(want))
        npt.assert_array_less(np.minimum(d, box - d), 1e-4)
    for got, want in zip(tmom, jmom):
        want = np.asarray(want)
        npt.assert_allclose(got.numpy(), want, atol=rel * np.abs(want).max())
    if not pass_growth:
        npt.assert_allclose(TN.lpt_growth(tc, z_init, order),
                            JN.lpt_growth(jc, z_init, order), rtol=2e-5)


def test_lpt_catalog_from_generator_and_velocities():
    gen = torch.Generator().manual_seed(1)
    tc = Cosmology(Om0=0.3, h=0.7)
    comps, mom = TN.lpt_catalog(gen, 8, 80.0, _pk_flat(30.0), tc, 9.0)
    assert [c.shape for c in comps + mom] == [(512,)] * 6
    assert all(bool(((c >= 0) & (c <= 80.0)).all()) for c in comps)
    vel = TN.velocities_kms(mom, 0.5)
    torch.testing.assert_close(vel[1], 200.0 * mom[1])
    with pytest.raises(ValueError, match="order"):
        TN.lpt_catalog(gen, 8, 80.0, _pk_flat(30.0), tc, 9.0, order=3)


# -------------------------------------------------------------- PM pieces
@pytest.mark.parametrize("spacing", ["loga", "a"])
def test_factors_from_edges_matches_jax(spacing):
    """KDK integrals: rtol 1e-6 (JAX evaluates E(a) in float32)."""
    jc, tc = _both(COSMOS["lcdm"])
    want = JN.pm_step_factors(jc, 0.1, 1.0, 7, spacing=spacing)
    got = TN.pm_step_factors(tc, 0.1, 1.0, 7, spacing=spacing)
    npt.assert_allclose(got, want, rtol=1e-6)
    edges = TN._a_edges(0.1, 1.0, 7, spacing)
    npt.assert_array_equal(edges, JN._a_edges(0.1, 1.0, 7, spacing))
    npt.assert_array_equal(TN._factors_from_edges(tc, edges[2:5], spacing),
                           got[2:4])


@pytest.mark.parametrize("gravity", ["gr", "fofr"])
def test_force_grids_matches_jax(rng, gravity):
    """Painted density -> force grids, GR (am2 = inf) and f(R) (finite
    am2): atol 1e-5 of the largest force (float32 FFTs)."""
    n, box = 16, 100.0
    pos = rng.uniform(0, box, (3000, 3)).astype(np.float32)
    tc = Cosmology(**COSMOS["fofr"])
    am2 = (float(0.5 ** 2 * tc.scalaron_mass2(0.5)) if gravity == "fofr"
           else np.inf)
    want = np.asarray(JN._force_grids(tuple(jnp.asarray(c) for c in pos.T),
                                      n, box, 0.3, "cic", am2=am2))
    got = TN._force_grids(_tensors(pos.T), n, box, 0.3, "cic", am2=am2)
    npt.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_pm_evolve_matches_jax(rng):
    """The forward path as a whole: the same modes -> 2LPT at z=9 -> 4
    KDK steps to z=0 on a 16^3 mesh, GR and f(R). Positions agree to
    2e-3 Mpc/h (cell 6.25 Mpc/h; float32 rounding grows over the steps)
    and momenta to 1e-3 of their max."""
    n, box = 16, 100.0
    dk = _modes(rng, n, box, amp=400.0)
    for kw in (COSMOS["lcdm"], COSMOS["fofr"]):
        jc, tc = _both(kw)
        growth = (*TN.lpt_growth(tc, 9.0), float(tc.efunc(9.0)))
        jcomps, jmom = JN.lpt_catalog_from_modes(jnp.asarray(dk), n, box,
                                                 jc, 9.0, growth=growth)
        tcomps, tmom = TN.lpt_catalog_from_modes(dk, n, box, tc, 9.0,
                                                 growth=growth, device="cpu")
        jout, jp = JN.pm_evolve(jcomps, jmom, jc, n, box, 0.1, 1.0, 4)
        tout, tp = TN.pm_evolve(tcomps, tmom, tc, n, box, 0.1, 1.0, 4)
        for got, want in zip(tout, jout):
            d = np.abs(got.numpy() - np.asarray(want))
            npt.assert_array_less(np.minimum(d, box - d), 2e-3)
        for got, want in zip(tp, jp):
            want = np.asarray(want)
            npt.assert_allclose(got.numpy(), want,
                                atol=1e-3 * np.abs(want).max())


def _low_mode_growth(paint_fn, delta_k_fn, init, final, n, box):
    """sqrt(P_final / P_init) over the CIC-compensated modes 0 < |m| <= 3
    of the painted particles (the chip run's growth measure)."""
    f = np.fft.fftfreq(n) * n
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + np.abs(f[: n // 2 + 1])[None, None, :] ** 2)
    sel = (m2 > 0) & (m2 <= 9.0)
    p = [np.mean(np.abs(np.asarray(delta_k_fn(
        paint_fn(c, n, box, window="cic"), window="cic")))[sel] ** 2)
        for c in (init, final)]
    return float(np.sqrt(p[1] / p[0]))


def test_pm_growth_matches_jax_at_20_steps(rng):
    """The growth of the lowest modes over 2LPT at z=9 and 20 log-a KDK
    steps to z=0 on a 32^3 mesh (32^3 particles, 500 Mpc/h, the forward
    path's setup cut in size), from the same modes in both packages: the
    two growths agree to 1e-3, so the deficit against D(0)/D(9) that the
    card run shows is the method's (20 steps from z=9), not the port's;
    it stays below the chip run's 5% bar."""
    from astrild_tpu.ops.paint import paint as jpaint
    from astrild_tpu.ops.power import delta_k as jdelta_k

    n, box, z_i = 32, 500.0, 9.0
    dk = _modes(rng, n, box, amp=2000.0)
    jc, tc = _both(COSMOS["lcdm"])
    growth = (*TN.lpt_growth(tc, z_i), float(tc.efunc(z_i)))
    jcomps, jmom = JN.lpt_catalog_from_modes(jnp.asarray(dk), n, box, jc,
                                             z_i, growth=growth)
    tcomps, tmom = TN.lpt_catalog_from_modes(dk, n, box, tc, z_i,
                                             growth=growth, device="cpu")
    a0 = 1.0 / (1.0 + z_i)
    jout, _ = JN.pm_evolve(jcomps, jmom, jc, n, box, a0, 1.0, 20)
    tout, _ = TN.pm_evolve(tcomps, tmom, tc, n, box, a0, 1.0, 20)
    g_jax = _low_mode_growth(jpaint, jdelta_k, jcomps, jout, n, box)
    g_port = _low_mode_growth(tpaint, tdelta_k, tcomps, tout, n, box)
    assert abs(g_port / g_jax - 1.0) < 1e-3, (g_port, g_jax)
    d_ratio = float(tc.growth_factor(0.0) / tc.growth_factor(z_i))
    assert abs(g_port / d_ratio - 1.0) < 0.05, (g_port, d_ratio)


def test_pm_evolve_leaves_inputs_untouched(rng):
    n, box = 8, 50.0
    tc = Cosmology(**COSMOS["lcdm"])
    comps, mom = TN.lpt_catalog_from_modes(_modes(rng, n, box), n, box, tc,
                                           9.0, device="cpu")
    before = [c.clone() for c in comps + mom]
    out, p = TN.pm_evolve(comps, mom, tc, n, box, 0.1, 0.5, 2)
    assert all(torch.equal(a, b) for a, b in zip(before, comps + mom))
    assert not torch.equal(out[0], comps[0])


def test_pm_catalog_from_generator():
    gen = torch.Generator().manual_seed(2)
    tc = Cosmology(**COSMOS["lcdm"])
    comps, vel = TN.pm_catalog(gen, tc, _pk_flat(100.0), 8, 64.0, nsteps=3)
    assert [c.shape for c in comps + vel] == [(512,)] * 6
    assert all(bool(torch.isfinite(c).all()) for c in comps + vel)


# ------------------------------------- the JAX package's own N-body tests
def test_force_accuracy_and_lattice_alias_regimes():
    """Port of tests/test_nbody.py::test_force_accuracy_...: the
    single-mode force at a 1:1 mesh matches -1.5 eps/k sin(kx) damped by
    one CIC window; a 2x-finer force mesh with lattice ICs boosts it."""
    box, eps = 500.0, 1e-3
    kf = 2 * np.pi / box

    def ratio(npart, nforce, m):
        cell = box / npart
        q = (np.arange(npart) + 0.5) * cell
        qx, qy, qz = np.meshgrid(q, q, q, indexing="ij")
        psi = -eps / (m * kf) * np.sin(m * kf * qx)
        comps = tuple(torch.from_numpy(c.ravel().astype(np.float32))
                      for c in ((qx + psi) % box, qy, qz))
        grids = TN._force_grids(comps, nforce, box, 1.0, "cic")
        frc = TR.sample_displacement(grids, box, comps).numpy()
        th = -1.5 * eps / (m * kf) * np.sin(m * kf * comps[0].numpy())
        return float((frc[0] * th).sum() / (th * th).sum())

    def w_cic(m, n):
        return float(np.sinc(m / n) ** 2)

    assert abs(ratio(32, 32, 1) - w_cic(1, 32)) < 4e-3
    assert abs(ratio(32, 32, 2) - w_cic(2, 32)) < 8e-3
    r1, r4 = ratio(32, 64, 1), ratio(32, 64, 4)
    assert r1 > 1.02 and r4 > r1


def test_pm_momentum_conservation(rng):
    """Port of tests/test_nbody.py::test_pm_momentum_conservation: the
    net force on random particles vanishes to 5e-3 of rms * N."""
    n, box, npar = 32, 100.0, 5000
    comps = _tensors((rng.uniform(0, box, (npar, 3)).astype(np.float32)).T)
    frc = TR.sample_displacement(TN._force_grids(comps, n, box, 0.3, "cic"),
                                 box, comps)
    net = frc.sum(dim=1).abs()
    rms = torch.sqrt((frc ** 2).mean(dim=1)) * npar
    assert float((net / rms).max()) < 5e-3


def test_fifth_force_single_mode_geff():
    """Port of tests/test_nbody.py::test_fifth_force_single_mode_geff: the
    f(R)/GR force ratio of grid mode m is 1 + mu_k(a, k_m) to 2e-4, and
    the GR default (am2 = inf) is bit-exact GR."""
    n, box, eps, m = 32, 400.0, 1e-3, 2
    kf = 2 * np.pi / box
    q = (np.arange(n) + 0.5) * (box / n)
    qx, qy, qz = np.meshgrid(q, q, q, indexing="ij")
    psi = -eps / (m * kf) * np.sin(m * kf * qx)
    comps = tuple(torch.from_numpy(c.ravel().astype(np.float32))
                  for c in ((qx + psi) % box, qy, qz))
    cosmo = Cosmology(Om0=0.3, h=0.7, fR0=1e-5)
    a = 0.8
    am2 = float(a ** 2 * cosmo.scalaron_mass2(a))
    g_gr = TN._force_grids(comps, n, box, 0.3, "cic")
    g_fr = TN._force_grids(comps, n, box, 0.3, "cic", am2=am2)
    fk_gr = complex(torch.fft.fftn(g_gr[0])[m, 0, 0])
    fk_fr = complex(torch.fft.fftn(g_fr[0])[m, 0, 0])
    k2 = (m * kf) ** 2
    expect = 1.0 + k2 / (3.0 * (k2 + am2))
    assert abs((fk_fr / fk_gr).real - expect) < 2e-4
    assert torch.equal(g_gr, TN._force_grids(comps, n, box, 0.3, "cic",
                                             am2=float("inf")))


def test_pm_linear_growth_lcdm_small():
    """The growth bar of tests/test_nbody.py::test_pm_linear_growth_lcdm
    (same-realization sqrt(P1/P0) over |m| <= 3 within 5% of D ratio),
    at 16^3 particles on a 16^3 mesh, 8 steps."""
    tc = Cosmology(Om0=0.3, h=0.7)
    n, box, z_i = 16, 500.0, 5.6667
    gen = torch.Generator().manual_seed(7)
    comps, mom = TN.lpt_catalog(gen, n, box, _pk_flat(50.0), tc, z_i)
    dk0 = tdelta_k(tpaint(comps, n, box, window="cic"), window="cic")
    out, _ = TN.pm_evolve(comps, mom, tc, n, box, 1 / (1 + z_i), 1.0, 8)
    dk1 = tdelta_k(tpaint(out, n, box, window="cic"), window="cic")
    f = np.fft.fftfreq(n) * n
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[: n // 2 + 1][None, None, :] ** 2)
    sel = torch.from_numpy((m2 > 0) & (m2 <= 9.0))
    measured = np.sqrt(float((dk1.abs() ** 2)[sel].mean())
                       / float((dk0.abs() ** 2)[sel].mean()))
    d_ratio = float(tc.growth_factor(0.0) / tc.growth_factor(z_i))
    assert abs(measured / d_ratio - 1.0) < 0.05, (measured, d_ratio)


# ------------------------------------------------ keyed 2LPT, checkpoints
def test_lpt_displacements_from_generator():
    """`lpt_displacements(generator)` is `lpt_displacements_from_modes` of
    `linear_modes` drawn from a generator in the same state, bit for bit;
    another seed gives other grids."""
    pk = _pk_flat(40.0)
    got = TN.lpt_displacements(torch.Generator().manual_seed(5), 8, 80.0, pk)
    dk = TM.linear_modes(torch.Generator().manual_seed(5), 8, 80.0, pk)
    want = TN.lpt_displacements_from_modes(dk, 8, 80.0)
    for g, w in zip(got, want):
        assert g.shape == (3, 8, 8, 8) and torch.equal(g, w)
    other = TN.lpt_displacements(torch.Generator().manual_seed(6), 8, 80.0,
                                 pk)
    assert not torch.equal(other[0], got[0])


def _periodic_gap(a, b, box):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(np.minimum(d, box - d).max())


def test_pm_evolve_checkpointed_matches_and_resumes(tmp_path, monkeypatch):
    """Port of tests/test_nbody.py::test_pm_evolve_checkpointed_matches_and_
    resumes. On the CPU the segmented run re-evaluates the force at each
    segment start from the same positions, so it equals pm_evolve bit for
    bit (the JAX test's bars are 1e-3 Mpc/h and 1e-4 of the momenta);
    a crash after the first segment's save resumes at step 2 and ends on
    the same bits; another schedule raises."""
    from astrild_tpu_torch.core import checkpoint as ckpt

    cosmo = Cosmology(Om0=0.3, h=0.7)
    n, box = 16, 100.0
    comps, mom = TN.lpt_catalog(torch.Generator().manual_seed(11), n, box,
                                _pk_flat(40.0), cosmo, 5.0, order=2)
    a0, a1 = 1.0 / 6.0, 1.0
    ref_c, ref_m = TN.pm_evolve(comps, mom, cosmo, n, box, a0, a1, nsteps=6)

    out_c, out_m = TN.pm_evolve_checkpointed(
        comps, mom, cosmo, n, box, a0, a1, 6, tmp_path / "ck1",
        segment_steps=2)
    for r, o in zip(ref_c + ref_m, out_c + out_m):
        assert torch.equal(r, o)

    d2 = tmp_path / "ck2"
    real_save = ckpt.save_state
    calls = {"n": 0}

    def crashy(path, state, step=None):
        real_save(path, state, step=step)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(ckpt, "save_state", crashy)
    with pytest.raises(RuntimeError, match="simulated crash"):
        TN.pm_evolve_checkpointed(comps, mom, cosmo, n, box, a0, a1, 6, d2,
                                  segment_steps=2)
    monkeypatch.setattr(ckpt, "save_state", real_save)
    _, step = ckpt.restore_state(d2, (comps, mom), with_step=True)
    assert step == 2
    res_c, res_m = TN.pm_evolve_checkpointed(comps, mom, cosmo, n, box, a0,
                                             a1, 6, d2, segment_steps=2)
    for r, o in zip(ref_c + ref_m, res_c + res_m):
        assert torch.equal(r, o)
    # the inputs are copied, not changed
    again = TN.lpt_catalog(torch.Generator().manual_seed(11), n, box,
                           _pk_flat(40.0), cosmo, 5.0, order=2)
    for a, b in zip(comps + mom, again[0] + again[1]):
        assert torch.equal(a, b)
    for kw in ({"nsteps": 8}, {"nsteps": 4}, {"a_final": 0.9}):
        args = {"a_final": a1, "nsteps": 6, **kw}
        with pytest.raises(ValueError, match="different schedule"):
            TN.pm_evolve_checkpointed(comps, mom, cosmo, n, box, a0,
                                      args["a_final"], args["nsteps"], d2,
                                      segment_steps=2)
    with pytest.raises(ValueError, match="segment_steps"):
        TN.pm_evolve_checkpointed(comps, mom, cosmo, n, box, a0, a1, 6,
                                  tmp_path / "ck3", segment_steps=0)


def test_pm_evolve_checkpointed_resumes_a_jax_checkpoint(tmp_path, rng,
                                                         monkeypatch):
    """The two packages share the schedule record and the npz layout: a
    JAX run (npz path, orbax patched off) that crashes after its first
    segment is finished by the port, f(R) included. The end state holds
    test_pm_evolve_matches_jax's bars against the JAX package's
    uninterrupted run: 2e-3 Mpc/h, momenta 1e-3 of their max."""
    from astrild_tpu.core import checkpoint as jck

    monkeypatch.setattr(jck, "have_orbax", lambda: False)
    n, box = 16, 100.0
    dk = _modes(rng, n, box, amp=400.0)
    jc, tc = _both(COSMOS["fofr"])
    growth = (*TN.lpt_growth(tc, 9.0), float(tc.efunc(9.0)))
    jcomps, jmom = JN.lpt_catalog_from_modes(jnp.asarray(dk), n, box, jc,
                                             9.0, growth=growth)
    ref_c, ref_m = JN.pm_evolve(jcomps, jmom, jc, n, box, 0.1, 1.0, 4)
    real_save = jck.save_state

    def crashy(path, state, step=None):
        real_save(path, state, step=step)
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(jck, "save_state", crashy)
    with pytest.raises(RuntimeError, match="simulated crash"):
        JN.pm_evolve_checkpointed(jcomps, jmom, jc, n, box, 0.1, 1.0, 4,
                                  tmp_path / "ck", segment_steps=2)
    tcomps, tmom = TN.lpt_catalog_from_modes(dk, n, box, tc, 9.0,
                                             growth=growth, device="cpu")
    out_c, out_m = TN.pm_evolve_checkpointed(tcomps, tmom, tc, n, box, 0.1,
                                             1.0, 4, tmp_path / "ck",
                                             segment_steps=2)
    for got, want in zip(out_c, ref_c):
        assert _periodic_gap(got.numpy(), want, box) < 2e-3
    for got, want in zip(out_m, ref_m):
        want = np.asarray(want)
        npt.assert_allclose(got.numpy(), want,
                            atol=1e-3 * np.abs(want).max())
