"""PyTorch port vs JAX package on the CPU: the grid side of the clustering
lane. BAO reconstruction, velocity fields and their spectra, 3D radial
profiles, density split and counts-in-cells, the marked P(k), and the
galaxy-clustering walkthrough of examples/clustering_toolkit.py as a whole
at 32^3.

Inputs are made with numpy (or with the JAX package's own white noise)
and handed to both packages; each tolerance is stated where it is
checked. On the CPU the port's paints are its scatter painters and the
JAX package's are its own: the same deposits summed in another order, so
grids agree to float32 rounding of their sums.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import density_split as JDS  # noqa: E402
from astrild_tpu.ops import mocks as JM  # noqa: E402
from astrild_tpu.ops import paint as JP  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu.ops import profiles3d as JPR  # noqa: E402
from astrild_tpu.ops import recon as JR  # noqa: E402
from astrild_tpu.ops import velocity as JV  # noqa: E402
from astrild_tpu_torch.ops import density_split as TDS  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import paint as TP  # noqa: E402
from astrild_tpu_torch.ops import power as TPS  # noqa: E402
from astrild_tpu_torch.ops import profiles3d as TPR  # noqa: E402
from astrild_tpu_torch.ops import recon as TR  # noqa: E402
from astrild_tpu_torch.ops import velocity as TV  # noqa: E402

L, NLAT = 500.0, 32
GROWTH_F = 0.52


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


def T(a):
    return torch.from_numpy(np.array(a))


def _pk(k):
    return 4.0e5 * k / (1.0 + (k / 0.04) ** 2) ** 2


@pytest.fixture(scope="module")
def zeldovich():
    """A 32^3 Zel'dovich catalog with velocities (the JAX package's, as
    numpy): the common input of the module tests."""
    pos, vel = JM.zeldovich_catalog_with_velocities(
        jax.random.PRNGKey(2), NLAT, L, _pk, growth_rate=GROWTH_F)
    return np.asarray(pos), np.asarray(vel)


def _periodic_max(a, b, box=L):
    d = np.asarray(a) - np.asarray(b)
    return float(np.abs(d - box * np.round(d / box)).max())


# ------------------------------------------------------------------ recon
def test_displacement_field_matches_jax(zeldovich):
    """psi grids from the same tracers: atol 1e-5 of max |psi| (deposits
    summed in another order, then smoothed); a lattice has no
    displacement (< 1e-3 Mpc/h, the JAX package's bar)."""
    pos, _ = zeldovich
    for kw in ({}, {"f_growth": 0.5, "bias": 1.5, "los": 1}):
        got = TR.displacement_field(T(pos), NLAT, L, smooth=10.0, **kw)
        want = np.asarray(JR.displacement_field(jnp.asarray(pos), NLAT, L,
                                                smooth=10.0, **kw))
        assert got.shape == want.shape == (3, NLAT, NLAT, NLAT)
        npt.assert_allclose(got.numpy(), want,
                            atol=1e-5 * np.abs(want).max())
    x = (np.arange(16, dtype=np.float32) + 0.5) * (L / 16)
    lattice = np.stack(np.meshgrid(x, x, x, indexing="ij"),
                       -1).reshape(-1, 3)
    psi = TR.displacement_field(T(lattice), 16, L, smooth=10.0)
    assert float(psi.abs().max()) < 1e-3


@pytest.mark.parametrize("f_growth", [0.0, 0.5])
def test_reconstruct_catalog_matches_jax(zeldovich, f_growth):
    """Shifted data and randoms (RecIso; the RSD term along los with
    f_growth > 0): within 1e-3 Mpc/h of the JAX package's, periodic
    distance (psi to 1e-5 of its max, then float32 positions ~ 500)."""
    pos, _ = zeldovich
    rng = np.random.default_rng(0)
    randoms = rng.uniform(0, L, (5000, 3)).astype(np.float32)
    got = TR.reconstruct_catalog(T(pos), T(randoms), NLAT, L, smooth=10.0,
                                 f_growth=f_growth)
    want = JR.reconstruct_catalog(jnp.asarray(pos), jnp.asarray(randoms),
                                  NLAT, L, smooth=10.0, f_growth=f_growth)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _periodic_max(g.numpy(), w) < 1e-3
        assert float(g.min()) >= 0.0 and float(g.max()) <= L
    # numpy randoms follow the tracers' device; tuples of components too
    comps = tuple(T(pos[:, i].copy()) for i in range(3))
    again = TR.reconstruct_catalog(comps, randoms, NLAT, L, smooth=10.0,
                                   f_growth=f_growth)
    npt.assert_array_equal(again[0].numpy(), got[0].numpy())
    npt.assert_array_equal(again[1].numpy(), got[1].numpy())


# --------------------------------------------------------------- velocity
def test_velocity_field_matches_jax(zeldovich):
    """The counts and momentum grids to 2e-5 of their max (deposits summed
    in another order); the velocity only where the counts exceed 1e-3 of
    their mean, since a cell holding a sliver of a particle turns the
    rounding of its sums into a large velocity: there within the bar its
    two grids' errors carry, 2e-5 (max|m| + |v| max c) / c."""
    pos, vel = zeldovich
    ng = 16
    vg, counts = TV.velocity_field(T(pos), T(vel), ng, L)
    jvg, jcounts = JV.velocity_field(jnp.asarray(pos), jnp.asarray(vel), ng,
                                     L)
    c, jc = counts.numpy(), np.asarray(jcounts)
    npt.assert_allclose(c, jc, atol=2e-5 * jc.max())
    well = jc > 1e-3 * jc.mean()
    for a in range(3):
        m = TP.paint(T(pos), ng, L, weights=T(vel[:, a].copy())).numpy()
        jm = np.asarray(JP.paint(jnp.asarray(pos), ng, L,
                                 weights=jnp.asarray(vel[:, a])))
        npt.assert_allclose(m, jm, atol=2e-5 * np.abs(jm).max())
        v, jv = vg[a].numpy(), np.asarray(jvg[a])
        bar = 2e-5 * (np.abs(jm).max() + np.abs(jv) * jc.max()) / jc
        assert np.all(np.abs(v - jv)[well] <= bar[well])
    # a uniform flow is recovered and has no divergence
    flat = np.broadcast_to(np.float32([120.0, -50.0, 30.0]),
                           pos.shape).copy()
    vflat, cflat = TV.velocity_field(T(pos), T(flat), ng, L)
    assert float(cflat.min()) > 0
    for a, want in enumerate((120.0, -50.0, 30.0)):
        npt.assert_allclose(vflat[a].numpy(), want, rtol=1e-4)
    assert float(TV.velocity_divergence(vflat, L).abs().max()) < 1e-2


def test_velocity_divergence_and_spectra_match_jax(zeldovich):
    """theta of the same velocity grids: atol 1e-5 of max|theta| (two
    float32 FFTs); P_thetatheta and P_deltatheta from the tracers: rtol
    1e-4 (ratios of the grids above, squared and shell-averaged); k and
    the mode counts equal. Zel'dovich flow: P_dtheta = -aHf P_d at low k
    (10%, the JAX package's bar)."""
    pos, vel = zeldovich
    ng = 16
    jvg, _ = JV.velocity_field(jnp.asarray(pos), jnp.asarray(vel), ng, L)
    th = TV.velocity_divergence(T(np.asarray(jvg)), L)
    jth = np.asarray(JV.velocity_divergence(jvg, L))
    npt.assert_allclose(th.numpy(), jth, atol=1e-5 * np.abs(jth).max())
    for name in ("velocity_divergence_power", "delta_theta_cross_power"):
        got = getattr(TV, name)(T(pos), T(vel), ng, L, nbins=8)
        want = getattr(JV, name)(jnp.asarray(pos), jnp.asarray(vel), ng, L,
                                 nbins=8)
        npt.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-6)
        npt.assert_array_equal(got.nmodes.numpy(), np.asarray(want.nmodes))
        npt.assert_allclose(got.power.numpy(), np.asarray(want.power),
                            rtol=1e-4)
    cross = TV.delta_theta_cross_power(T(pos), T(vel), ng, L, nbins=8)
    pdd = TPS.auto_power(TP.paint(T(pos), ng, L), L, nbins=8).power
    ratio = (cross.power[:3] / (-100.0 * GROWTH_F * pdd[:3])).numpy()
    npt.assert_allclose(ratio, 1.0, rtol=0.1)


# ------------------------------------------------------------- profiles3d
def test_log_edges_are_the_jax_package_float32_edges():
    """The shell edges are the JAX package's float32 formula,
    10 ** linspace(log10 r_min, log10 r_max) with jnp.linspace's own
    interpolation: within rtol 2e-6 of the edges its jitted
    radial_density_profiles builds (XLA's fused float32 pow and log10
    land up to 9 ulp from the eager ones, measured; at test sizes no
    particle sits that close to an edge, and the profile tests below hold
    the shell counts equal)."""
    edges = jax.jit(lambda a, b, nb: 10.0 ** jnp.linspace(
        jnp.log10(a), jnp.log10(b), nb + 1), static_argnums=2)
    for r_min, r_max, nb in ((1.953125, 125.0, 12), (0.1, 3.0, 20),
                             (5.0, 100.0, 7)):
        got = TPR._log_edges(r_min, r_max, nb, "cpu").numpy()
        want = np.asarray(edges(r_min, r_max, nb))
        npt.assert_allclose(got, want, rtol=2e-6)


@pytest.mark.parametrize("boxsize", [None, 100.0])
def test_radial_profiles_match_jax(rng, boxsize):
    """Density profiles (mass sums over shells / shell volumes) and mean
    radial velocities around the same centers: rtol 1e-5 (float32 shell
    volumes; the port sums in float64), counts equal, NaN in the same
    empty shells."""
    pos = rng.uniform(0, 100, (3000, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    vel = rng.normal(0, 100, (3000, 3)).astype(np.float32)
    centers = rng.uniform(0, 100, (40, 3)).astype(np.float32)
    r, rho = TPR.radial_density_profiles(T(pos), T(mass), T(centers), 0.5,
                                         30.0, nbins=10, boxsize=boxsize)
    jr, jrho = JPR.radial_density_profiles(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(centers), 0.5,
        30.0, nbins=10, boxsize=boxsize)
    npt.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    npt.assert_allclose(rho.numpy(), np.asarray(jrho), rtol=1e-5)
    r, vr, cnt = TPR.radial_velocity_profiles(T(pos), T(vel), T(centers),
                                              0.5, 30.0, nbins=10,
                                              boxsize=boxsize)
    jr, jvr, jcnt = JPR.radial_velocity_profiles(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(centers), 0.5, 30.0,
        nbins=10, boxsize=boxsize)
    npt.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    jvr = np.asarray(jvr)
    npt.assert_array_equal(np.isnan(vr.numpy()), np.isnan(jvr))
    npt.assert_allclose(vr.numpy(), jvr, rtol=1e-4, atol=1e-3)
    npt.assert_allclose(TPR.stacked_profile(vr, cnt).numpy(),
                        np.asarray(JPR.stacked_profile(jvr, jcnt)),
                        rtol=1e-4, atol=1e-3)


def test_nfw_fit_matches_jax():
    """Gauss-Newton on log rho from NFW profiles with 5% scatter and a
    masked bin: the fitted (rho_s, r_s) within 1e-3 of the JAX package's
    (the port's jacobian is closed-form, the JAX package's by autodiff)
    and within 10% of the truth."""
    rng = np.random.default_rng(4)
    r = np.geomspace(0.02, 2.0, 16).astype(np.float32)
    rs = np.array([0.1, 0.25, 0.4], np.float32)
    rhos = np.array([1e6, 3e5, 8e4], np.float32)
    rho = np.stack([np.asarray(JPR.nfw_profile(r, a, b)) for a, b in
                    zip(rhos, rs)])
    npt.assert_allclose(TPR.nfw_profile(T(r), 1e6, 0.1).numpy(), rho[0],
                        rtol=1e-6)
    rho = (rho * rng.lognormal(0, 0.05, rho.shape)).astype(np.float32)
    rho[1, 3] = 0.0
    got = TPR.fit_nfw(T(r), T(rho))
    want = JPR.fit_nfw(jnp.asarray(r), jnp.asarray(rho))
    for g, w, truth in zip(got, want, (rhos, rs)):
        npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3)
        npt.assert_allclose(g.numpy(), truth, rtol=0.1)


# ---------------------------------------------------------- density split
def test_smoothing_and_interpolation_match_jax(rng):
    """Top-hat and Gaussian smoothing: atol 1e-6 of max (one FFT pair);
    the query lattice equal; trilinear interpolation at random points
    atol 1e-6 of max, and at cell centres the grid values themselves."""
    delta = rng.normal(0, 1, (16, 16, 16)).astype(np.float32)
    for kind in ("tophat", "gauss"):
        got = TDS.smooth_density(T(delta), 100.0, 12.0, kind=kind)
        want = np.asarray(JDS.smooth_density(jnp.asarray(delta), 100.0, 12.0,
                                             kind=kind))
        npt.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(
            want).max())
    npt.assert_allclose(TDS.smooth_density(T(np.full((8, 8, 8), 0.37,
                                                     np.float32)),
                                           100.0, 10.0).numpy(), 0.37,
                        rtol=1e-5)
    q = TDS.lattice_query_points(8, 100.0, device="cpu")
    npt.assert_array_equal(q.numpy(), np.asarray(JDS.lattice_query_points(
        8, 100.0)))
    pts = rng.uniform(-5, 105, (2000, 3)).astype(np.float32)
    got = TDS.density_at_points(T(delta), 100.0, T(pts))
    want = np.asarray(JDS.density_at_points(jnp.asarray(delta), 100.0,
                                            jnp.asarray(pts)))
    npt.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(delta).max())
    comps = tuple(T(pts[:, i].copy()) for i in range(3))
    npt.assert_array_equal(TDS.density_at_points(T(delta), 100.0,
                                                 comps).numpy(), got.numpy())
    centres = TDS.lattice_query_points(16, 100.0, device="cpu")
    npt.assert_allclose(TDS.density_at_points(T(delta), 100.0,
                                              centres).numpy(),
                        delta.reshape(-1), atol=1e-5)


def test_quantile_labels_match_jax(rng):
    """Stable ranks: labels equal to the JAX package's, ties included, and
    equal counts per quantile."""
    v = rng.normal(0, 1, 1000).astype(np.float32)
    v[::7] = 0.25  # ties
    got = TDS.density_quantile_labels(T(v), 5)
    npt.assert_array_equal(got.numpy(), np.asarray(
        JDS.density_quantile_labels(jnp.asarray(v), 5)))
    assert (np.bincount(got.numpy(), minlength=5) == 200).all()
    tied = TDS.density_quantile_labels(torch.zeros(100), 4)
    npt.assert_array_equal(tied.numpy(), np.repeat(np.arange(4), 25))


def test_density_split_profiles_match_jax(zeldovich):
    """Stacked tracer profiles of 5 quantiles: rtol 1e-4 (per-center
    profiles from equal counts, averaged per quantile in another order),
    the r centres rtol 1e-6; inside, the lowest quantile is the least
    dense and under-dense, the highest the densest and over-dense (8192
    tracers: ~200 a quantile in the two inner shells)."""
    pos, _ = zeldovich
    grid = np.asarray(JP.paint(jnp.asarray(pos), NLAT, L))
    delta = (grid / grid.mean() - 1.0).astype(np.float32)
    tracers = pos[np.random.default_rng(1).choice(pos.shape[0], 8192,
                                                  replace=False)]
    r, prof = TDS.density_split_profiles(T(delta), L, T(tracers), 20.0,
                                         n_quantiles=5, n_query=8,
                                         r_min=8.0, r_max=120.0, nbins=6)
    jr, jprof = JDS.density_split_profiles(jnp.asarray(delta), L,
                                           jnp.asarray(tracers), 20.0,
                                           n_quantiles=5, n_query=8,
                                           r_min=8.0, r_max=120.0, nbins=6)
    npt.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    npt.assert_allclose(prof.numpy(), np.asarray(jprof), rtol=1e-4,
                        atol=1e-5)
    inner = prof[:, :2].mean(dim=1).numpy()
    assert inner[0] < 0 < inner[-1]
    assert inner.argmin() == 0 and inner.argmax() == 4


def test_counts_in_cells_match_jax(rng):
    """Counts per cell and the PDF equal to the JAX package's (a position
    at exactly L lands in cell 0); the moments rtol 1e-5 (float32 means);
    Poisson: var ~ mean."""
    pos = rng.uniform(0, 100.0, (40000, 3)).astype(np.float32)
    pos[:5] = 100.0
    pdf, counts = TDS.counts_in_cells(T(pos), 100.0, 16)
    jpdf, jcounts = JDS.counts_in_cells(jnp.asarray(pos), 100.0, 16)
    npt.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    npt.assert_array_equal(pdf.numpy(), np.asarray(jpdf))
    for a, b in zip(TDS.counts_in_cells_moments(counts),
                    JDS.counts_in_cells_moments(jcounts)):
        npt.assert_allclose(float(a), float(b), rtol=1e-5)
    mu, var, _ = TDS.counts_in_cells_moments(counts)
    assert float(mu) == pytest.approx(40000 / 16 ** 3, rel=1e-6)
    assert abs(float(var) / float(mu) - 1.0) < 0.1
    assert float(pdf.sum()) == pytest.approx(1.0, rel=1e-6)


def test_marked_power_matches_jax(zeldovich):
    """Marks rtol 1e-5 and the marked P(k) rtol 1e-4 of the JAX package's
    (marks interpolated from a smoothed field of grids that agree to
    float32 rounding). The shot noise is the weighted one, V sum(m^2) /
    (sum m)^2 (float64 here: rtol 1e-5); with p = 0 the marks are 1 and
    the result is the plain P(k) with V/N, to rtol 1e-5."""
    pos, _ = zeldovich
    res, marks = TDS.marked_power(T(pos), NLAT, L, 12.0, mark_p=1.0,
                                  nbins=10)
    jres, jmarks = JDS.marked_power(jnp.asarray(pos), NLAT, L, 12.0,
                                    mark_p=1.0, nbins=10)
    npt.assert_allclose(marks.numpy(), np.asarray(jmarks), rtol=1e-5)
    npt.assert_allclose(res.power.numpy(), np.asarray(jres.power),
                        rtol=1e-4)
    m = marks.numpy().astype(np.float64)
    shot = L ** 3 * (m ** 2).sum() / m.sum() ** 2
    grid = TP.paint(T(pos), NLAT, L, weights=marks)
    plain = TPS.auto_power(grid, L, nbins=10, window="cic")
    npt.assert_allclose(res.power.numpy(), plain.power.numpy() - shot,
                        rtol=1e-5)
    res0, marks0 = TDS.marked_power(T(pos), NLAT, L, 12.0, mark_p=0.0,
                                    nbins=10)
    npt.assert_array_equal(marks0.numpy(), 1.0)
    want = TPS.auto_power(TP.paint(T(pos), NLAT, L), L, nbins=10,
                          window="cic", shotnoise=L ** 3 / pos.shape[0])
    npt.assert_allclose(res0.power.numpy(), want.power.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["displacement_field", "velocity_field",
                                  "counts_in_cells", "marked_power",
                                  "radial_density_profiles"])
def test_numpy_input_placement(zeldovich, name):
    """Input that is not a tensor goes to the CUDA card unless `device` is
    given: with no card the call raises; with device='cpu' it runs on the
    CPU and gives what CPU tensors give (equal: the same ops)."""
    pos, vel = zeldovich
    pos, vel = pos[:4000], vel[:4000]
    calls = {
        "displacement_field": lambda p, v, **kw: TR.displacement_field(
            p, 16, L, smooth=10.0, **kw),
        "velocity_field": lambda p, v, **kw: TV.velocity_field(
            p, v, 16, L, **kw)[0],
        "counts_in_cells": lambda p, v, **kw: TDS.counts_in_cells(
            p, L, 8, **kw)[1],
        "marked_power": lambda p, v, **kw: TDS.marked_power(
            p, 16, L, 30.0, nbins=4, **kw)[1],
        "radial_density_profiles": lambda p, v, **kw:
            TPR.radial_density_profiles(p, v[:, 0], p[:5], 1.0, 50.0,
                                        nbins=4, **kw)[1],
    }
    call = calls[name]
    if torch.cuda.is_available():
        assert call(pos, vel).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(pos, vel)
    got = call(pos, vel, device="cpu")
    assert got.device.type == "cpu"
    npt.assert_array_equal(got.numpy(), call(T(pos), T(vel)).numpy())


# --------------------------------------------- the walkthrough as a whole
def _lane_jax(key, key_bao, sub, jit):
    """examples/clustering_toolkit.py's five stages at NLAT^3 (the JAX
    package)."""
    from astrild_tpu.ops import bao, fftlog, linear_power, recon, tpcf
    from astrild_tpu.utils.cosmology import Cosmology

    out = {}
    pos = JM.zeldovich_catalog(key, NLAT, L, _pk)
    out["mock"] = np.asarray(pos)
    p_sub = jnp.asarray((np.asarray(pos)[sub] + jit) % L)
    rp, wp, _ = tpcf.projected_tpcf(p_sub, L, jnp.linspace(4.0, 60.0, 13),
                                    80.0, n_pi=40)
    k_tab = np.geomspace(1e-3, 30.0, 512)
    out["wp"], out["wp_theory"] = np.asarray(wp), np.asarray(
        fftlog.wp_from_pk(k_tab, _pk(jnp.asarray(k_tab, jnp.float32)), rp,
                          80.0))
    res_m, _ = JDS.marked_power(pos, NLAT, L, smooth_radius=12.0,
                                mark_p=1.0, nbins=10)
    grid = JP.paint(pos, NLAT, L, window="cic")
    res_p = JPS.auto_power(grid, L, nbins=10, window="cic",
                           shotnoise=L ** 3 / pos.shape[0])
    out["marked_ratio"] = np.asarray(res_m.power / res_p.power)
    delta = grid / jnp.mean(grid) - 1.0
    _, prof = JDS.density_split_profiles(delta, L, p_sub, smooth_radius=20.0,
                                         n_quantiles=5, n_query=8,
                                         r_min=10.0, r_max=120.0, nbins=6)
    out["split"] = np.asarray(prof)
    x = (jnp.arange(NLAT, dtype=jnp.float32) + 0.25) * (L / NLAT)
    randoms = jnp.stack(jnp.meshgrid(x, x, x, indexing="ij"),
                        axis=-1).reshape(-1, 3)
    pos_rec, rand_rec = recon.reconstruct_catalog(pos, randoms, NLAT, L,
                                                  smooth=10.0)
    delta_l = JM.gaussian_field(key, NLAT, L, _pk)

    def corr(dg):
        pcc = JPS.cross_power(dg + 1.0, delta_l + 1.0, L, nbins=10)
        paa = JPS.auto_power(dg + 1.0, L, nbins=10)
        pbb = JPS.auto_power(delta_l + 1.0, L, nbins=10)
        return np.asarray(pcc.power) / np.sqrt(np.asarray(paa.power)
                                               * np.asarray(pbb.power))

    def delta_of(p):
        g = JP.paint(p, NLAT, L, window="cic")
        return g / jnp.mean(g) - 1.0

    out["r_pre"] = corr(delta_of(pos))
    out["r_post"] = corr(delta_of(pos_rec) - delta_of(rand_rec))
    cosmo = Cosmology()
    wig = JM.gaussian_field(key_bao, NLAT, L,
                            lambda k: linear_power.linear_power(k, cosmo))
    res_l = JPS.auto_power(wig + 1.0, L, nbins=32)
    sig = (np.asarray(res_l.power)
           * np.sqrt(2.0 / np.maximum(np.asarray(res_l.nmodes), 1)))
    fit = bao.fit_bao_scale(np.asarray(res_l.k), np.asarray(res_l.power),
                            cosmo, sigma=sig, sigma_nl=1.0, kmin=0.04,
                            kmax=0.30, alphas=np.linspace(0.7, 1.3, 301))
    out["alpha"], out["alpha_err"] = fit.alpha, fit.alpha_err
    return out


def _lane_torch(white, white_bao, sub, jit):
    """The same five stages in the port, from the same white noise."""
    from astrild_tpu_torch.ops import bao, fftlog, linear_power, recon, tpcf
    from astrild_tpu_torch.utils.cosmology import Cosmology

    out = {}
    modes = TM.modes_from_white(T(white), NLAT, L, _pk)
    pos = TM.zeldovich_catalog_from_modes(modes, NLAT, L)
    out["mock"] = pos.numpy()
    p_sub = T(((pos.numpy()[sub] + jit) % L).astype(np.float32))
    rp, wp, _ = tpcf.projected_tpcf(p_sub, L, torch.linspace(4.0, 60.0, 13),
                                    80.0, n_pi=40)
    k_tab = np.geomspace(1e-3, 30.0, 512)
    out["wp"], out["wp_theory"] = wp.numpy(), fftlog.wp_from_pk(
        k_tab, _pk(T(k_tab.astype(np.float32))), rp, 80.0).numpy()
    res_m, _ = TDS.marked_power(pos, NLAT, L, smooth_radius=12.0,
                                mark_p=1.0, nbins=10)
    grid = TP.paint(pos, NLAT, L, window="cic")
    res_p = TPS.auto_power(grid, L, nbins=10, window="cic",
                           shotnoise=L ** 3 / pos.shape[0])
    out["marked_ratio"] = (res_m.power / res_p.power).numpy()
    delta = grid / torch.mean(grid) - 1.0
    _, prof = TDS.density_split_profiles(delta, L, p_sub, smooth_radius=20.0,
                                         n_quantiles=5, n_query=8,
                                         r_min=10.0, r_max=120.0, nbins=6)
    out["split"] = prof.numpy()
    x = (torch.arange(NLAT, dtype=torch.float32) + 0.25) * (L / NLAT)
    randoms = torch.stack(torch.meshgrid(x, x, x, indexing="ij"),
                          dim=-1).reshape(-1, 3)
    pos_rec, rand_rec = recon.reconstruct_catalog(pos, randoms, NLAT, L,
                                                  smooth=10.0)
    delta_l = TM.gaussian_field_from_modes(modes)

    def corr(dg):
        pcc = TPS.cross_power(dg + 1.0, delta_l + 1.0, L, nbins=10)
        paa = TPS.auto_power(dg + 1.0, L, nbins=10)
        pbb = TPS.auto_power(delta_l + 1.0, L, nbins=10)
        return (pcc.power / torch.sqrt(paa.power * pbb.power)).numpy()

    def delta_of(p):
        g = TP.paint(p, NLAT, L, window="cic")
        return g / torch.mean(g) - 1.0

    out["r_pre"] = corr(delta_of(pos))
    out["r_post"] = corr(delta_of(pos_rec) - delta_of(rand_rec))
    cosmo = Cosmology()
    amp = linear_power.normalization(cosmo)
    wig = TM.gaussian_field_from_modes(TM.modes_from_white(
        T(white_bao), NLAT, L,
        lambda k: linear_power.linear_power(k, cosmo, amplitude=amp)))
    res_l = TPS.auto_power(wig + 1.0, L, nbins=32)
    sig = (res_l.power.numpy()
           * np.sqrt(2.0 / np.maximum(res_l.nmodes.numpy(), 1)))
    fit = bao.fit_bao_scale(res_l.k.numpy(), res_l.power.numpy(), cosmo,
                            sigma=sig, sigma_nl=1.0, kmin=0.04, kmax=0.30,
                            alphas=np.linspace(0.7, 1.3, 301), device="cpu")
    out["alpha"], out["alpha_err"] = fit.alpha, fit.alpha_err
    return out


def test_clustering_lane_matches_jax():
    """examples/clustering_toolkit.py at 32^3 in both packages from the same
    white noise (the JAX package's keys), output for output. The mocks
    agree to 1e-4 Mpc/h (two float32 FFTs), so the pair counts downstream
    may differ by a pair at an edge: wp within 1% of its largest value,
    its FFTLog theory rtol 1e-5; the marked ratio, the propagators
    and the density-split profiles within 1e-3 (absolute, or relative
    where the ratio's denominator is near zero; grids from positions that
    agree to 1e-4 Mpc/h); alpha within 1e-3 and its error rtol 1e-2
    (float32 spectra of two sigma8 integrals). The walkthrough's own
    claims hold in both: reconstruction raises the mean propagator, the
    extreme quantiles straddle zero."""
    key, key_bao = jax.random.PRNGKey(1), jax.random.PRNGKey(7)
    shape = (NLAT,) * 3
    white = np.asarray(jax.random.normal(key, shape))
    white_bao = np.asarray(jax.random.normal(key_bao, shape))
    rng = np.random.default_rng(0)
    sub = rng.choice(NLAT ** 3, 2048, replace=False)
    cell = L / NLAT
    jit = np.random.default_rng(1).uniform(-cell / 2, cell / 2,
                                           (2048, 3)).astype(np.float32)
    want = _lane_jax(key, key_bao, sub, jit)
    got = _lane_torch(white, white_bao, sub, jit)
    assert _periodic_max(got["mock"], want["mock"]) < 1e-4
    npt.assert_allclose(got["wp"], want["wp"],
                        atol=1e-2 * np.abs(want["wp"]).max())
    npt.assert_allclose(got["wp_theory"], want["wp_theory"], rtol=1e-5)
    for name in ("marked_ratio", "r_pre", "r_post", "split"):
        npt.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-3,
                            err_msg=name)
    assert abs(got["alpha"] - want["alpha"]) < 1e-3
    npt.assert_allclose(got["alpha_err"], want["alpha_err"], rtol=1e-2)
    for out in (got, want):
        assert out["r_post"][3:8].mean() > out["r_pre"][3:8].mean()
        assert out["split"][0, 0] < 0 < out["split"][-1, 0]
        assert np.isfinite(out["wp"]).all()
