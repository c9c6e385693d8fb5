"""PyTorch port vs JAX package on the CPU: the galaxy-mocks path. The 3D
void finders (SVF, 3D watershed), the SO halo finder, halo statistics and
the theory mass / void-size functions, HOD galaxies, the 2D watershed,
`find_tunnels_auto` and `peak_counts`, and examples/galaxy_mocks_voids.py
as a whole at 32^3.

Inputs are made with numpy (or with the JAX package's own random draws:
its white noise, its HOD draws) and handed to both packages; each
tolerance is stated where it is checked. The two packages' FFTs round
differently, so fields from them agree to float32 rounding, radii found
by interpolating such fields to ~1e-5 relative, and catalogs (counts,
grid-cell centers, orders) exactly where no candidate sits on a tie
within that rounding.
"""
import math

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import halo_stats as JHS  # noqa: E402
from astrild_tpu.ops import hod as JH  # noqa: E402
from astrild_tpu.ops import paint as JP  # noqa: E402
from astrild_tpu.ops import peaks as JK  # noqa: E402
from astrild_tpu.ops import so_halos as JSO  # noqa: E402
from astrild_tpu.ops import voids as JV  # noqa: E402
from astrild_tpu.ops import voids3d as JV3  # noqa: E402
from astrild_tpu_torch.ops import halo_stats as THS  # noqa: E402
from astrild_tpu_torch.ops import hod as TH  # noqa: E402
from astrild_tpu_torch.ops import paint as TP  # noqa: E402
from astrild_tpu_torch.ops import peaks as TK  # noqa: E402
from astrild_tpu_torch.ops import so_halos as TSO  # noqa: E402
from astrild_tpu_torch.ops import voids as TV  # noqa: E402
from astrild_tpu_torch.ops import voids3d as TV3  # noqa: E402

RTOL = 1e-5  # positions and radii, relative


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


def N(a):
    return np.asarray(a)


# ------------------------------------------------------------- constants
def test_constants_match_jax():
    from astrild_tpu.utils import constants as JC
    from astrild_tpu_torch.utils import constants as TC

    assert TC.G_NEWTON == JC.G_NEWTON
    assert TC.RHO_CRIT0 == JC.RHO_CRIT0
    # the HOD's own G (a different value) is copied verbatim
    assert TH._G_KMS2_MPC_MSUN == JH._G_KMS2_MPC_MSUN


# ------------------------------------------------------------- helpers
def _spherical_void(ngrid, boxsize, center, r0, depth=-0.9):
    """Compensated top-hat void (the JAX package's test field)."""
    cell = boxsize / ngrid
    x = (np.arange(ngrid) + 0.5) * cell
    d = [x[:, None, None] - center[0], x[None, :, None] - center[1],
         x[None, None, :] - center[2]]
    d = [a - boxsize * np.round(a / boxsize) for a in d]
    r = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    inside = r < r0
    n_in = inside.sum()
    bg = -depth * n_in / (ngrid ** 3 - n_in)
    return np.where(inside, depth, bg).astype(np.float32)


def _gauss_wells(ngrid, boxsize, wells):
    cell = boxsize / ngrid
    x = (np.arange(ngrid) + 0.5) * cell
    out = np.zeros((ngrid,) * 3)
    for c, depth, sig in wells:
        r2 = ((x[:, None, None] - c[0]) ** 2 + (x[None, :, None] - c[1]) ** 2
              + (x[None, None, :] - c[2]) ** 2)
        out += depth * np.exp(-0.5 * r2 / sig ** 2)
    return out.astype(np.float32)


def _white(seed, ngrid, sigma=0.5):
    d = np.random.default_rng(seed).normal(0, sigma, (ngrid,) * 3)
    return (d - d.mean()).astype(np.float32)


def _assert_catalogs_match(got, want, extra=("min_delta",)):
    """Counts equal; the same grid cells as centers (to RTOL: the JAX
    package forms its cell size as a traced float32, the port from the
    Python float); radii (and the extra float columns) within RTOL of the
    largest."""
    assert int(got.n) == int(want.n)
    assert int(got.n_candidates) == int(want.n_candidates)
    npt.assert_allclose(got.pos.numpy(), N(want.pos), rtol=RTOL)
    rw = N(want.radius)
    npt.assert_allclose(got.radius.numpy(), rw, rtol=RTOL,
                        atol=RTOL * max(rw.max(), 1e-30))
    for col in extra:
        w = N(getattr(want, col))
        npt.assert_allclose(getattr(got, col).numpy(), w, rtol=RTOL,
                            atol=RTOL * np.abs(w).max())


# --------------------------------------------------------------- voids3d
def test_density_split_uses_voids3d_helpers():
    """density_split keeps no copies of voids3d's helpers."""
    from astrild_tpu_torch.ops import density_split as TDS

    assert TDS._kmag_r is TV3._kmag_r and TDS._tophat is TV3._tophat


@pytest.mark.parametrize("n", [16, 48, 96])
def test_kmag_and_tophat_match_jax(n):
    """|k|/kf within an ulp (integer mode numbers; the two packages' float32
    sqrt differ by one ulp on ~0.1% of the grid). The top-hat window: its
    series branch (x < 1e-4) to 1e-7; the closed form from x = 0.1 within
    3e-5 absolute. Below 0.1 sin x - x cos x cancels in float32 in both
    packages (one ulp of sin or cos, where they differ on ~5% of inputs,
    moves W by ~1e-7 / x^2), so the finders' parity holds where their
    smallest kmag * r, 2 pi * 1.5 / n, stays above ~0.1."""
    npt.assert_allclose(TV3._kmag_r(n).numpy(), N(JV3._kmag_r(n)),
                        rtol=1.2e-7)
    x = np.float32([0.0, 2e-5, 5e-5, 9.9e-5])
    npt.assert_allclose(TV3._tophat(T(x)).numpy(), N(JV3._tophat(x)),
                        rtol=1e-7)
    x = np.geomspace(0.1, 60.0, 4000).astype(np.float32)
    npt.assert_allclose(TV3._tophat(T(x)).numpy(), N(JV3._tophat(x)),
                        atol=3e-5)


def test_top_k_masked_matches_lax_top_k(rng):
    """lax.top_k of where(mask, values, fill): ties in index order, a
    short list padded by the lowest-index entries outside the mask."""
    for n_masked, k in ((300, 64), (20, 64), (0, 8), (64, 64)):
        vals = rng.integers(0, 10, 4096).astype(np.float32)  # many ties
        mask = np.zeros(4096, bool)
        mask[rng.choice(4096, n_masked, replace=False)] = True
        for fill in (-np.inf, 0.0):
            v = vals + 1.0 if fill == 0.0 else vals
            wv, wi = jax.lax.top_k(jnp.where(mask, v, fill), k)
            gv, gi = TK.top_k_masked(T(v), T(mask), k, fill=fill)
            npt.assert_array_equal(gi.numpy(), N(wi))
            npt.assert_array_equal(gv.numpy(), N(wv))


def test_sphere_overlap_fraction_matches_jax(rng):
    """Random sphere pairs in a 100 Mpc/h box (periodic images, contained
    and disjoint cases among them): within 1e-5 relative, 1e-6 absolute."""
    L = 100.0
    c1 = rng.uniform(0, L, (2000, 3)).astype(np.float32)
    c2 = (c1 + rng.normal(0, 8, (2000, 3))).astype(np.float32) % L
    c2[:50] = c1[:50]
    r1 = rng.uniform(0.5, 12, 2000).astype(np.float32)
    r2 = rng.uniform(0.5, 12, 2000).astype(np.float32)
    want = N(JV3.sphere_overlap_fraction(c1, r1[:], c2, r2, L))
    got = TV3.sphere_overlap_fraction(T(c1), T(r1), T(c2), T(r2), L)
    npt.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (want == 0).any() and (want == 1).any() and want.std() > 0.1


@pytest.mark.parametrize("kind", ["white", "plateau"])
def test_local_maxima_periodic_matches_jax(kind):
    """The same mask: strict maxima, and on plateaus the (value, -index)
    tie-break, with the periodic wrap."""
    if kind == "white":
        f = _white(1, 24)
    else:
        f = np.round(_white(2, 24) * 2).astype(np.float32)  # many ties
    want = N(JV3._local_maxima_periodic(jnp.asarray(f)))
    got = TV3._local_maxima_periodic(T(f)).numpy()
    npt.assert_array_equal(got, want)
    assert want.sum() > 10


@pytest.mark.parametrize("kind", ["void", "white", "zero"])
def test_enclosed_density_radius_matches_jax(kind):
    """rstar within 1e-5 of r_max (the ladder's float32 rungs are the
    same; the crossings interpolate fields that the two FFTs round
    differently); the cells with rstar == 0 the same set, and a field
    with no void has none."""
    n, L = 32, 64.0
    delta = {"void": lambda: _spherical_void(n, L, (32.0, 32.0, 32.0), 12.),
             "white": lambda: _white(3, n),
             "zero": lambda: np.zeros((n,) * 3, np.float32)}[kind]()
    want = N(JV3.enclosed_density_radius(jnp.asarray(delta), L, 2.0, 16.0,
                                         n_radii=20, delta_threshold=-0.45))
    got = TV3.enclosed_density_radius(T(delta), L, 2.0, 16.0, n_radii=20,
                                      delta_threshold=-0.45).numpy()
    npt.assert_allclose(got, want, atol=1e-5 * 16.0)
    npt.assert_array_equal(got == 0, want == 0)
    if kind == "zero":
        assert got.max() == 0.0
    else:
        assert got.max() > 2.0


@pytest.mark.parametrize("case", ["analytic", "two_periodic", "capacity",
                                  "white"])
def test_svf_voids_matches_jax(case):
    """svf_voids of test_voids3d.py's fields: the same catalog (counts,
    candidate counts, centers; radii and center densities to 1e-5), and
    the JAX tests' own checks on the port's catalog. The voids are centred
    on a cell, not on a cell corner as in the JAX tests: a void symmetric
    about a corner ties its eight cells, and float32 rounding of the two
    FFTs picks the winner."""
    n, L = 64, 64.0
    if case == "analytic":
        delta = _spherical_void(n, L, (32.5, 32.5, 32.5), 12.0)
        kw = dict(delta_threshold=-0.45, max_voids=32, n_radii=32)
    elif case == "two_periodic":
        delta = (_spherical_void(n, L, (0.5, 0.5, 0.5), 10.0)
                 + _spherical_void(n, L, (40.5, 40.5, 40.5), 6.0))
        kw = dict(delta_threshold=-0.5, max_voids=32)
    elif case == "capacity":
        n, L = 32, 32.0
        delta = _white(5, n)
        kw = dict(delta_threshold=-0.2, max_voids=4)
    else:
        n, L = 32, 96.0
        delta = _white(6, n, 0.8)
        kw = dict(delta_threshold=-0.5, max_voids=64)
    want = JV3.svf_voids(jnp.asarray(delta), L, **kw)
    got = TV3.svf_voids(T(delta), L, **kw)
    _assert_catalogs_match(got, want)
    nv = int(got.n)
    assert nv >= 1
    rad = got.radius.numpy()
    assert np.all(np.diff(rad[:nv]) <= 0) and np.all(rad[nv:] == 0)
    if case == "analytic":
        thr, depth = -0.45, -0.9
        bg = float(delta.max())
        r_star = 12.0 / (((thr - bg) / (depth - bg)) ** (1.0 / 3.0))
        npt.assert_allclose(got.pos[0].numpy(), 32.5, atol=1.0)
        assert abs(float(got.radius[0]) - r_star) / r_star < 0.06
    if case == "capacity":
        assert int(got.n_candidates) > 4 and nv <= 4
    d = TV3.svf_catalog_dict(got, overlap=0.5)
    dw = JV3.svf_catalog_dict(want, overlap=0.5)
    assert d.keys() == dw.keys()
    for k in d:
        assert d[k].shape == dw[k].shape and d[k].dtype == dw[k].dtype
    npt.assert_array_equal(d["x"], dw["x"])
    npt.assert_array_equal(d["void_overlap"], dw["void_overlap"])


@pytest.mark.parametrize("kind", ["wells", "white", "plateau"])
def test_watershed_labels_3d_matches_jax(kind):
    """Basin labels equal, cell for cell (the (value, index) tie-break and
    the periodic neighbour order are the JAX package's)."""
    n = 24
    if kind == "wells":
        f = _gauss_wells(n, 24.0, [((6, 6, 6), -1.0, 3.0),
                                   ((18, 18, 18), -0.95, 2.5)])
    elif kind == "white":
        f = _white(7, n)
    else:
        f = np.round(_white(8, n) * 3).astype(np.float32)
    want = N(JV3.watershed_labels_3d(jnp.asarray(f)))
    got = TV3.watershed_labels_3d(T(f)).numpy()
    npt.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["two_wells", "white"])
def test_watershed_voids_3d_matches_jax(kind):
    """The same catalog: counts, basin-minimum centers, volume radii to
    1e-5 (integer volumes), center densities to 1e-5 of the largest; the
    two wells of test_voids3d.py found where they are. The wells are
    centred on cells, the second off the diagonal, and twice as wide as
    the JAX test's: wells symmetric about cell corners or about each other
    tie cells, and where narrow wells leave the smoothed field at the FFTs'
    rounding noise (~1e-7) the descent follows that noise."""
    if kind == "two_wells":
        n, L = 48, 48.0
        delta = _gauss_wells(n, L, [((12.5, 12.5, 12.5), -1.0, 8.0),
                                    ((36.5, 35.5, 36.5), -0.95, 6.0)])
        kw = dict(max_voids=16, core_delta=-0.5)
    else:
        n, L = 32, 64.0
        delta = _white(9, n, 1.0)
        kw = dict(max_voids=32, core_delta=-0.1)
    want = JV3.watershed_voids_3d(jnp.asarray(delta), L, **kw)
    got = TV3.watershed_voids_3d(T(delta), L, **kw)
    _assert_catalogs_match(got, want)
    if kind == "two_wells":
        assert int(got.n) == 2
        found = {tuple(np.round(p / 12).astype(int))
                 for p in got.pos[:2].numpy()}
        assert found == {(1, 1, 1), (3, 3, 3)}
    else:
        assert int(got.n) > 3


# --------------------------------------------------------------- so halos
C = 48.5 * 100.0 / 96  # a cell center near 50 Mpc/h on the 96^3 grid


def _ball_delta(ngrid, boxsize, center, r_ball, delta0):
    cell = boxsize / ngrid
    x = (np.arange(ngrid) + 0.5) * cell
    g = np.meshgrid(x, x, x, indexing="ij")
    d2 = 0.0
    for gi, c in zip(g, center):
        dd = np.abs(gi - c)
        d2 = d2 + np.minimum(dd, boxsize - dd) ** 2
    return np.where(np.sqrt(d2) < r_ball, delta0, 0.0).astype(np.float32)


def _nfw_particles(rng, n_p, m200m, c, om0, center, boxsize):
    """Inverse-transform sample of an NFW profile truncated at R200m (the
    JAX package's test helper)."""
    from astrild_tpu_torch.utils.constants import RHO_CRIT0

    rho_m = om0 * RHO_CRIT0
    r200 = (3.0 * m200m / (4.0 * np.pi * 200.0 * rho_m)) ** (1.0 / 3.0)
    x_tab = np.linspace(1e-3, 1.0, 2048)
    mu = np.log(1.0 + c * x_tab) - c * x_tab / (1.0 + c * x_tab)
    mu /= mu[-1]
    r = np.interp(rng.uniform(size=n_p), mu, x_tab) * r200
    phi = rng.uniform(0, 2 * np.pi, n_p)
    cth = rng.uniform(-1, 1, n_p)
    sth = np.sqrt(1 - cth ** 2)
    off = np.stack([r * sth * np.cos(phi), r * sth * np.sin(phi),
                    r * cth], axis=-1)
    return (np.asarray(center) + off) % boxsize, r200


def _painted_delta(pos, w, n, box):
    """The JAX package's CIC paint of weighted particles as a density
    contrast (numpy): the common input handed to both finders."""
    grid = JP.paint((jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
                     jnp.asarray(pos[:, 2])), n, box,
                    weights=jnp.asarray(w), window="cic")
    return N(grid / grid.mean() - 1.0)


def _assert_so_match(got, want):
    _assert_catalogs_match(got, want, extra=("mass", "peak_delta"))


def test_so_halos_uniform_ball_matches_jax():
    """The closed-form uniform ball: the same catalog as the JAX package,
    R_Delta within 5% of R_b (delta0/(Delta-1))^(1/3). The balls of these
    tests sit on a cell center (C), not on the cell corner at 50 Mpc/h of
    the JAX tests, whose eight cells tie."""
    from astrild_tpu_torch.utils.constants import RHO_CRIT0

    n, box, om0 = 96, 100.0, 0.3
    delta = _ball_delta(n, box, (C, C, C), 3.0, 2000.0)
    kw = dict(delta_mean=200.0, max_halos=16, n_radii=48)
    want = JSO.so_halos(jnp.asarray(delta), box, om0, **kw)
    got = TSO.so_halos(T(delta), box, om0, **kw)
    _assert_so_match(got, want)
    assert int(got.n) == 1
    r_th = 3.0 * (2000.0 / 199.0) ** (1.0 / 3.0)
    assert abs(float(got.radius[0]) / r_th - 1.0) < 0.05
    m_th = 4.0 / 3.0 * np.pi * r_th ** 3 * 200.0 * om0 * RHO_CRIT0
    assert abs(float(got.mass[0]) / m_th - 1.0) < 0.16


def test_so_halos_nfw_mock_matches_jax():
    """An NFW halo painted with a thinned background: the same catalog;
    the injected halo first, its R200m within 8% (the JAX test's bars);
    so_catalog_dict's columns equal the JAX package's."""
    from astrild_tpu_torch.utils.constants import RHO_CRIT0

    n, box, om0, m200 = 96, 60.0, 0.3, 3.0e14
    rng = np.random.default_rng(3)
    halo, r200 = _nfw_particles(rng, 60000, m200, 6.0, om0,
                                (30.0, 30.0, 30.0), box)
    m_p = m200 / 60000
    n_bg = int(om0 * RHO_CRIT0 * box ** 3 / m_p) - 60000
    bg = rng.uniform(0, box, (n_bg // 100, 3))
    pos = np.concatenate([halo, bg]).astype(np.float32)
    w = np.concatenate([np.ones(len(halo)),
                        np.full(len(bg), 100.0)]).astype(np.float32)
    delta = _painted_delta(pos, w, n, box)
    kw = dict(delta_mean=200.0, max_halos=32, n_radii=48)
    want = JSO.so_halos(jnp.asarray(delta), box, om0, **kw)
    got = TSO.so_halos(T(delta), box, om0, **kw)
    _assert_so_match(got, want)
    npt.assert_allclose(got.pos[0].numpy(), 30.0, atol=1.5 * box / n)
    assert abs(float(got.radius[0]) / r200 - 1.0) < 0.08
    for names in (False, True):
        d = TSO.so_catalog_dict(got, rockstar_names=names)
        dw = JSO.so_catalog_dict(want, rockstar_names=names)
        assert d.keys() == dw.keys()
        npt.assert_array_equal(d["x"], dw["x"])
        npt.assert_allclose(d["mass"], dw["mass"], rtol=3 * RTOL)


def test_so_halos_exclusivity_matches_jax():
    """A ball inside a larger one's R_Delta is absorbed (one halo); a far
    twin survives (two): both packages alike."""
    n, box, om0 = 96, 100.0, 0.3
    d1 = _ball_delta(n, box, (C, C, C), 3.0, 2000.0)
    d2 = _ball_delta(n, box, (C + 4.0, C, C), 1.8, 2000.0)
    d3 = _ball_delta(n, box, (C - 30.0, C - 30.0, C - 30.0), 3.0, 2000.0)
    for delta, nh in ((d1 + d2, 1), (d1 + d3, 2)):
        want = JSO.so_halos(jnp.asarray(delta), box, om0, max_halos=16,
                            n_radii=48)
        got = TSO.so_halos(T(delta), box, om0, max_halos=16, n_radii=48)
        _assert_so_match(got, want)
        assert int(got.n) == nh


def _jax_hod_draws(key, m, params, max_sat):
    """The five random fields of the JAX package's hod_populate, drawn as
    it draws them (astrild_tpu/ops/hod.py:121-143)."""
    nh = m.shape[0]
    k_cen, k_nsat, k_rad, k_dir, k_vel = jax.random.split(key, 5)
    n_cen_mean, n_sat_mean = JH.zheng07_mean_occupation(jnp.asarray(m),
                                                        params)
    return (N(jax.random.bernoulli(k_cen, n_cen_mean)),
            N(jax.random.poisson(k_nsat, n_sat_mean, (nh,))),
            N(jax.random.uniform(k_rad, (nh, max_sat))),
            N(jax.random.normal(k_dir, (3, nh, max_sat))),
            N(jax.random.normal(k_vel, (3, nh, max_sat))))


def _assert_hod_match(got, want, box):
    """Masks, counts and halo indices equal; galaxy positions within 1e-5
    of the box (periodic distance), velocities within 1e-5 of their
    largest."""
    for k in ("valid", "is_central", "halo_index"):
        npt.assert_array_equal(got[k].numpy(), N(want[k]))
    assert int(got["n_gal"]) == int(want["n_gal"])
    assert int(got["overflow"]) == int(want["overflow"])
    for k in ("gx", "gy", "gz"):
        d = got[k].numpy().astype(np.float64) - N(want[k])
        d -= box * np.round(d / box)
        assert np.abs(d).max() <= RTOL * box, k
        assert got[k].min() >= 0 and got[k].max() <= box
    for k in ("gvx", "gvy", "gvz"):
        w = N(want[k])
        npt.assert_allclose(got[k].numpy(), w, atol=RTOL * np.abs(w).max())


def test_so_halos_feed_the_hod_matches_jax():
    """SO halos at 96^3 -> Zheng+07 galaxies (the JAX package's draws)
    -> galaxy P(k): the same catalog and galaxies in both packages,
    galaxy P(k) within 1e-4 of the JAX package's, and the galaxies biased
    (b^2 > 1 at large scales; test_so_halos.py's chain)."""
    from astrild_tpu.ops.power import auto_power as j_auto_power
    from astrild_tpu_torch.ops.power import auto_power
    from astrild_tpu_torch.utils.constants import RHO_CRIT0

    n, box, om0 = 96, 100.0, 0.3
    rng = np.random.default_rng(5)
    centers = rng.uniform(10, 90, (12, 3))
    halos = [_nfw_particles(rng, 4000, 8.0e14, 6.0, om0, c, box)[0]
             for c in centers]
    n_bg = int(om0 * RHO_CRIT0 * box ** 3 / (8.0e14 / 4000)) - 12 * 4000
    bg = rng.uniform(0, box, (max(n_bg, 0) // 200, 3))
    pos = np.concatenate(halos + [bg]).astype(np.float32)
    w = np.concatenate([np.ones(12 * 4000),
                        np.full(len(bg), 200.0)]).astype(np.float32)
    delta = _painted_delta(pos, w, n, box)
    want = JSO.so_halos(jnp.asarray(delta), box, om0, max_halos=64,
                        n_radii=48)
    got = TSO.so_halos(T(delta), box, om0, max_halos=64, n_radii=48)
    _assert_so_match(got, want)
    nh = int(got.n)
    assert nh >= 10
    d, dw = TSO.so_catalog_dict(got), JSO.so_catalog_dict(want)
    zeros = np.zeros(nh, np.float32)
    conc = np.full(nh, 6.0, np.float32)
    params = JH.HODParams()
    key = jax.random.PRNGKey(1)
    jgal = JH.hod_populate(key, dw["mass"], dw["x"], dw["y"], dw["z"],
                           zeros, zeros, zeros, dw["radius"], conc, box,
                           params=params, max_sat=32)
    draws = _jax_hod_draws(key, dw["mass"], params, 32)
    gal = TH.hod_populate_from_draws(
        *[T(a) for a in draws], d["mass"], d["x"], d["y"], d["z"], zeros,
        zeros, zeros, d["radius"], conc, box, max_sat=32)
    _assert_hod_match(gal, jgal, box)
    assert int(gal["n_gal"]) >= nh
    v = gal["valid"]
    gcomps = tuple(gal[k][v] for k in ("gx", "gy", "gz"))
    ggrid = TP.paint(gcomps, 48, box, window="cic")
    k, p_g, _ = auto_power(ggrid, box, nbins=8)
    jv = N(jgal["valid"])
    jgrid = JP.paint(tuple(jnp.asarray(N(jgal[c])[jv])
                           for c in ("gx", "gy", "gz")), 48, box,
                     window="cic")
    _, jp_g, _ = j_auto_power(jgrid, box, nbins=8)
    npt.assert_allclose(p_g.numpy(), N(jp_g), rtol=1e-4)
    pm = auto_power(torch.nn.functional.interpolate(
        T(N(JP.paint((jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
                      jnp.asarray(pos[:, 2])), n, box,
                     weights=jnp.asarray(w))))[None, None],
        size=(48, 48, 48), mode="trilinear")[0, 0], box, nbins=8)[1]
    shot = box ** 3 / float(v.sum())
    assert float(((p_g[1:4] - shot) / pm[1:4]).mean()) > 1.0


# ------------------------------------------------------------------ hod
def _uniform_halos(seed, nh, boxsize=100.0, logm=13.5):
    rng = np.random.default_rng(seed)
    m = np.full(nh, 10.0 ** logm, np.float32)
    x, y, z = (rng.uniform(0, boxsize, nh).astype(np.float32)
               for _ in range(3))
    v = rng.normal(0, 300.0, (3, nh)).astype(np.float32)
    return (m, x, y, z, v[0], v[1], v[2], np.full(nh, 0.8, np.float32),
            np.full(nh, 7.0, np.float32))


def test_mean_occupation_matches_jax():
    """<N_cen>, <N_sat> over 10^10.5-10^15.5 within 2e-6 relative and 3e-6
    absolute (the JAX package's float32 erf is off by up to 2e-6 near -1,
    where torch's gives -1; log10 and pow round differently), exactly 1/2
    at Mmin, 0 below M0."""
    p = JH.HODParams()
    m = np.geomspace(10 ** 10.5, 10 ** 15.5, 500).astype(np.float32)
    for params in (p, JH.HODParams(12.6, 0.3, 12.5, 13.6, 1.0)):
        wc, ws = JH.zheng07_mean_occupation(jnp.asarray(m), params)
        gc, gs = TH.zheng07_mean_occupation(T(m), TH.HODParams(*params))
        npt.assert_allclose(gc.numpy(), N(wc), rtol=2e-6, atol=3e-6)
        npt.assert_allclose(gs.numpy(), N(ws), rtol=2e-6, atol=3e-6)
    c, _ = TH.zheng07_mean_occupation(T(np.float32([10.0 ** p.log_mmin])),
                                      TH.HODParams())
    npt.assert_allclose(float(c[0]), 0.5, atol=1e-6)
    _, s = TH.zheng07_mean_occupation(
        T(np.float32([10.0 ** (p.log_m0 - 0.5)])), TH.HODParams())
    assert float(s[0]) == 0.0
    assert TH.HODParams() == tuple(JH.HODParams())


def test_nfw_radius_sample_matches_jax():
    """r/Rvir of 50-step bisections: within 1e-5 relative of the JAX
    package's (a branch taken on an ulp of log1p moves the root by one
    bisection interval at most; measured 1.4e-6), and an exact inverse CDF
    (2e-4, the JAX test's bar)."""
    u = np.linspace(0.001, 0.999, 2001).astype(np.float32)
    for c in (2.0, 7.0, 20.0):
        want = N(JH.nfw_radius_sample(jnp.asarray(u), c))
        got = TH.nfw_radius_sample(T(u), T(np.float32(c))).numpy()
        npt.assert_allclose(got, want, rtol=RTOL)
        x = got.astype(np.float64) * c

        def mu(t):
            return np.log1p(t) - t / (1.0 + t)

        npt.assert_allclose(mu(x) / mu(c), u, atol=2e-4)


@pytest.mark.parametrize("case", ["default", "example", "overflow"])
def test_hod_populate_from_jax_draws_matches_jax(case):
    """The JAX package's five draws through hod_populate_from_draws give
    its catalog (_assert_hod_match), overflow included."""
    box = 100.0
    if case == "overflow":
        args = _uniform_halos(8, 200, box, logm=14.8)
        params, max_sat = JH.HODParams(12.0, 0.2, 12.0, 12.8, 1.1), 4
    elif case == "example":
        rng = np.random.default_rng(0)
        m = (10.0 ** rng.uniform(12.2, 14.5, 3000)).astype(np.float32)
        args = _uniform_halos(9, 3000, box)
        args = (m,) + args[1:7] + (
            (0.78 * (m / 1e13) ** (1.0 / 3.0)).astype(np.float32),
            (9.0 * (m / 1e13) ** (-0.1)).astype(np.float32))
        params, max_sat = JH.HODParams(12.6, 0.3, 12.5, 13.6, 1.0), 16
    else:
        args = _uniform_halos(10, 2000, box, logm=14.0)
        params, max_sat = JH.HODParams(), 16
    key = jax.random.PRNGKey(7)
    want = JH.hod_populate(key, *[jnp.asarray(a) for a in args], box,
                           params=params, max_sat=max_sat)
    draws = _jax_hod_draws(key, args[0], params, max_sat)
    got = TH.hod_populate_from_draws(*[T(a) for a in draws],
                                     *[T(a) for a in args], box,
                                     max_sat=max_sat)
    _assert_hod_match(got, want, box)
    assert (int(got["overflow"]) > 0) == (case == "overflow")
    com, jcom = TH.compact_catalog(got), JH.compact_catalog(want)
    assert com.keys() == jcom.keys()
    assert com["gx"].shape == jcom["gx"].shape == (int(got["n_gal"]),)
    npt.assert_array_equal(com["halo_index"], jcom["halo_index"])
    assert com["valid"].all()


def test_hod_populate_with_a_generator():
    """hod_populate's own draws (a torch.Generator): the occupation means
    within the JAX test's bars (centrals 0.01 absolute over 40,000 halos,
    binomial std 0.0025; satellites 3%), satellites inside Rvir and the
    box, the virial dispersion within 5%, the same seed the same catalog,
    overflow reported when max_sat is too small."""
    box = 100.0
    p = TH.HODParams(log_mmin=13.0, sigma_logm=0.3, log_m0=12.0,
                     log_m1=13.2, alpha=1.0)
    nh = 40000
    args = [T(a) for a in _uniform_halos(0, nh, box, logm=13.2)]
    gen = torch.Generator().manual_seed(1)
    cat = TH.hod_populate(gen, *args, box, params=p, max_sat=24)
    n_cen, n_sat = TH.zheng07_mean_occupation(args[0], p)
    cen = float(cat["valid"][:nh].float().mean())
    assert abs(cen - float(n_cen[0])) < 0.01
    sat = float(cat["valid"][nh:].float().sum()) / nh
    assert abs(sat - float(n_sat[0])) / float(n_sat[0]) < 0.03
    assert int(cat["overflow"]) == 0
    again = TH.hod_populate(torch.Generator().manual_seed(1), *args, box,
                            params=p, max_sat=24)
    npt.assert_array_equal(again["gx"].numpy(), cat["gx"].numpy())

    args = [T(a) for a in _uniform_halos(2, 2000, box, logm=14.0)]
    zeros = torch.zeros(2000)
    cat = TH.hod_populate(torch.Generator().manual_seed(3), args[0],
                          *args[1:4], zeros, zeros, zeros, *args[7:], box)
    com = TH.compact_catalog(cat)
    assert com["gx"].shape[0] == int(cat["n_gal"]) and com["valid"].all()
    s = ~com["is_central"]
    hidx = com["halo_index"][s]
    d2 = 0.0
    for gk, a in (("gx", 1), ("gy", 2), ("gz", 3)):
        dd = com[gk][s] - args[a].numpy()[hidx]
        dd -= box * np.round(dd / box)
        d2 = d2 + dd ** 2
        assert (com[gk] >= 0).all() and (com[gk] <= box).all()
    assert (np.sqrt(d2) <= 0.8 * 1.0001).all()
    sigma_exp = np.sqrt(4.30091e-9 * 1e14 / (2 * 0.8))
    for vk in ("gvx", "gvy", "gvz"):
        assert abs(com[vk][s].std() - sigma_exp) / sigma_exp < 0.05

    args = [T(a) for a in _uniform_halos(8, 200, box, logm=14.8)]
    cat = TH.hod_populate(torch.Generator().manual_seed(9), *args, box,
                          params=TH.HODParams(12.0, 0.2, 12.0, 12.8, 1.1),
                          max_sat=4)
    assert int(cat["overflow"]) > 0
    assert cat["valid"][200:].reshape(200, 4).sum(1).max() <= 4


# ------------------------------------------------------------ halo stats
def test_halo_mass_function_matches_jax(rng):
    """Cumulative counts equal (whole numbers), centers within 1e-5 (XLA's
    float32 pow for logspace is off by up to 3e-6 relative at 10^14);
    padding dropped by the lower limit."""
    mass = (10.0 ** rng.uniform(11.0, 15.5, 5000)).astype(np.float32)
    mass[:50] = 0.0
    mass[50:60] = -1.0
    for limits, nbins in (((11.78, 16.0), 20), ((12.0, 15.0), 7)):
        wc, wcum = JHS.halo_mass_function(jnp.asarray(mass), limits, nbins)
        gc, gcum = THS.halo_mass_function(T(mass), limits, nbins)
        npt.assert_array_equal(gcum.numpy(), N(wcum))
        npt.assert_allclose(gc.numpy(), N(wc), rtol=1e-5)
    _, cum = THS.halo_mass_function(T(np.float32([1e12, 1e13, 0.0, -1.0])),
                                    nbins=10)
    assert float(cum[0]) == 2.0 and float(cum[-1]) == 0.0


def test_binned_mean_and_histogram_match_jax(rng):
    """binned_mean: within 1e-5 of the JAX package's and of scipy's (the
    right edge in the last bin, NaN in empty bins); histogram_density
    within 1e-6 relative, unit integral."""
    from scipy.stats import binned_statistic

    x = rng.uniform(1, 10, 500)
    x[:3] = [1.0, 10.0, 10.5]
    v = rng.normal(size=500)
    edges = np.linspace(1, 10, 11)
    want = N(JHS.binned_mean(jnp.asarray(x), jnp.asarray(v),
                             jnp.asarray(edges), 10))
    got = THS.binned_mean(x, v, edges, 10, device="cpu").numpy()
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sp, _, _ = binned_statistic(x, v, statistic="mean", bins=edges)
    npt.assert_allclose(got, sp, rtol=1e-5, atol=1e-6)
    wide = np.linspace(1, 30, 11)
    got = THS.binned_mean(T(x), T(v), T(wide), 10).numpy()
    assert np.isnan(got).sum() == np.isnan(N(JHS.binned_mean(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(wide), 10))).sum() > 0

    vals = rng.normal(0, 1, 4000).astype(np.float32)
    valid = rng.uniform(size=4000) < 0.8
    for kw in ({}, {"valid": valid}):
        wc, wd = JHS.histogram_density(jnp.asarray(vals), 20, (-4.0, 4.0),
                                       **{k: jnp.asarray(a)
                                          for k, a in kw.items()})
        gc, gd = THS.histogram_density(T(vals), 20, (-4.0, 4.0),
                                       **{k: T(a) for k, a in kw.items()})
        npt.assert_allclose(gd.numpy(), N(wd), rtol=1e-6)
        npt.assert_allclose(gc.numpy(), N(wc), rtol=1e-6, atol=1e-7)
        npt.assert_allclose(float(gd.sum()) * 0.4, 1.0, rtol=1e-3)


def test_concentrations_match_jax(rng):
    """Prada's Newton from the same start: c within 1e-5 relative and the
    same converged mask (test_halo_stats.py's round trip among the
    halos); the Prada and Rockstar c(M) relations within 1e-5."""
    def ratio(c):
        mu = np.log(1 + c) - c / (1 + c)
        return np.sqrt(0.216 * c / mu)

    c_true = rng.uniform(2.5, 30.0, 400)
    v200 = rng.uniform(50, 500, 400)
    vmax = ratio(c_true) * v200
    vmax[:10] = v200[:10] * 0.9  # unconverged: v200 >= vmax
    vmax, v200 = vmax.astype(np.float32), v200.astype(np.float32)
    wc, wconv = JHS.concentration_prada(jnp.asarray(vmax),
                                        jnp.asarray(v200))
    gc, gconv = THS.concentration_prada(T(vmax), T(v200))
    npt.assert_array_equal(gconv.numpy(), N(wconv))
    ok = N(wconv)
    npt.assert_allclose(gc.numpy()[ok], N(wc)[ok], rtol=RTOL)
    npt.assert_allclose(gc.numpy()[ok], c_true[ok], rtol=1e-3)
    assert ok.sum() == 390

    m = (10.0 ** rng.uniform(11.5, 14.5, 400)).astype(np.float32)
    lim = (11.5, 14.5)
    wcen, wcm = JHS.concentration_mass_prada(jnp.asarray(m),
                                             jnp.asarray(vmax),
                                             jnp.asarray(v200), lim, 6)
    gcen, gcm = THS.concentration_mass_prada(T(m), T(vmax), T(v200), lim, 6)
    npt.assert_allclose(gcm.numpy(), N(wcm), rtol=RTOL)
    npt.assert_allclose(gcen.numpy(), N(wcen), rtol=1e-5)

    r200 = rng.uniform(0.5, 2.0, 400).astype(np.float32)
    rs = (r200 / c_true).astype(np.float32)
    wcen, wcm = JHS.concentration_mass_rockstar(
        jnp.asarray(m), jnp.asarray(r200), jnp.asarray(rs), lim, 6)
    gcen, gcm = THS.concentration_mass_rockstar(T(m), T(r200), T(rs), lim,
                                                6)
    npt.assert_allclose(gcm.numpy(), N(wcm), rtol=RTOL)
    _, cm = THS.concentration_mass_rockstar(
        T(np.float32([1e12, 2e12, 1e13, 2e13])), T(np.float32([1, 1, 2, 2])),
        T(np.full(4, 0.25, np.float32)), (11.5, 13.7), nbins=2)
    npt.assert_allclose(cm.numpy(), [4.0, 8.0], rtol=1e-5)


def _cosmo_pair():
    from astrild_tpu.utils.cosmology import Cosmology as JC
    from astrild_tpu_torch.utils.cosmology import Cosmology as TC

    return JC(), TC()


# the port's float64 theory against the JAX package's float32 one: the gap
# measured over these masses, redshifts and radii (largest |port/JAX - 1|)
# was 2.8e-5 for dn/dlnM and 9.2e-6 for dn/dlnR; the bars hold ~3x that
HMF_JAX_RTOL = 1e-4
VSF_JAX_RTOL = 3e-5


@pytest.mark.parametrize("model", ["ps", "st", "tinker08"])
def test_theory_hmf_matches_jax_and_finite_difference(model):
    """dn/dlnM over 1e10-1e16 Msun/h at z = 0 and 1: within HMF_JAX_RTOL
    of the JAX package's float32 autodiff; the autograd slope within 1e-6
    of a float64 central difference of ln sigma (step 1e-4 in ln M)."""
    from astrild_tpu_torch.ops import linear_power as TL

    jc, tc = _cosmo_pair()
    m = np.geomspace(1e10, 1e16, 40)
    for z in (0.0, 1.0):
        want = N(JHS.theory_hmf(m, jc, z=z, model=model))
        got = THS.theory_hmf(m, tc, z=z, model=model, device="cpu")
        assert got.dtype == torch.float64
        npt.assert_allclose(got.numpy(), want, rtol=HMF_JAX_RTOL)
    amp = TL.normalization(tc)
    rho = tc.Om0 * THS.RHO_CRIT0

    def ln_sigma(lnm):
        r = (3.0 * np.exp(lnm) / (4.0 * math.pi * rho)) ** (1.0 / 3.0)
        return float(torch.log(TL.sigma_r(r, tc, amplitude=amp)))

    lnm = torch.log(torch.tensor(m))
    _, slope = THS._ln_sigma_and_slope(
        lnm, lambda mm: (3.0 * mm / (4.0 * math.pi * rho)) ** (1.0 / 3.0),
        tc, amp, 1.0)
    h = 1e-4
    fd = np.array([(ln_sigma(x + h) - ln_sigma(x - h)) / (2 * h)
                   for x in lnm.numpy()])
    npt.assert_allclose(slope.numpy(), fd, rtol=1e-6)


def test_theory_vsf_and_svdw_match_jax():
    """dn/dlnR (svdw, vdn) within VSF_JAX_RTOL of the JAX package's; the
    vdn / svdw volume relation to 1e-5 (float64 theory of radii rounded to
    float32 on input, where dn/dlnR is steep); svdw_multiplicity on
    both sides of its switch within 1e-5 of the JAX package's (float32
    exp of -av^2 / 2 sigma^2 far in its tail)."""
    jc, tc = _cosmo_pair()
    r = np.geomspace(2.0, 30.0, 12)
    for model in ("svdw", "vdn"):
        want = N(JHS.theory_vsf(jnp.asarray(r), jc, model=model))
        got = THS.theory_vsf(r, tc, model=model, device="cpu").numpy()
        npt.assert_allclose(got, want, rtol=VSF_JAX_RTOL)
    a_v = 0.2 ** (-1.0 / 3.0)
    vdn = THS.theory_vsf(T(r), tc, model="vdn").numpy()
    svdw = THS.theory_vsf(T(r / a_v), tc, model="svdw").numpy()
    npt.assert_allclose(vdn, svdw / a_v ** 3, rtol=1e-5)
    with pytest.raises(ValueError):
        THS.theory_vsf(T(r), tc, model="x")
    av, dc = 2.717, 1.686
    sig = (np.linspace(0.05, 0.6, 200) * av / (av / (dc + av))).astype(
        np.float32)
    npt.assert_allclose(THS.svdw_multiplicity(T(sig)).numpy(),
                        N(JHS.svdw_multiplicity(jnp.asarray(sig))),
                        rtol=1e-5, atol=1e-30)


def test_virial_environment_shape_and_summaries_match_jax(rng):
    """rho_crit_200, virial_radius, virial_velocity within 1e-6; the
    environment tags equal (outside halos included); the inertia axes
    within 1e-5 and their vectors up to sign; binned_halo_statistics (host
    numpy) bit for bit."""
    m = (10.0 ** rng.uniform(11, 15, 300)).astype(np.float32)
    r = rng.uniform(0.1, 2.0, 300).astype(np.float32)
    for name, args in (("rho_crit_200", (m, r)), ("virial_radius", (m,)),
                       ("virial_velocity", (m, r))):
        want = N(getattr(JHS, name)(*[jnp.asarray(a) for a in args]))
        got = getattr(THS, name)(*[T(a) for a in args]).numpy()
        npt.assert_allclose(got, want, rtol=1e-6)
    npt.assert_allclose(THS.virial_radius(T(m), rho_delta=1e13).numpy(),
                        N(JHS.virial_radius(jnp.asarray(m), 1e13)),
                        rtol=1e-6)

    env = rng.integers(0, 4, (8, 6, 5)).astype(np.int32)
    box = (10.0, 90.0, 0.0, 60.0, -5.0, 45.0)
    pos = rng.uniform(-10, 100, (2000, 3)).astype(np.float32)
    want = N(JHS.halo_environment(jnp.asarray(pos), jnp.asarray(env), box))
    got = THS.halo_environment(T(pos), T(env), box).numpy()
    npt.assert_array_equal(got, want)
    assert (got == -1).any()
    got_t = THS.halo_environment(tuple(T(pos[:, a].copy()) for a in range(3)),
                                 T(env), box, outside_value=9).numpy()
    npt.assert_array_equal(got_t, np.where(want == -1, 9, want))

    cloud = (rng.normal(size=(5000, 3)) * [3.0, 1.5, 0.5]) @ np.linalg.qr(
        rng.normal(size=(3, 3)))[0]
    cloud = cloud.astype(np.float32)
    w = rng.uniform(0.5, 1.5, 5000).astype(np.float32)
    for kw in ({}, {"weights": w}):
        wl, wv = JHS.point_cloud_shape(jnp.asarray(cloud),
                                       **{k: jnp.asarray(a)
                                          for k, a in kw.items()})
        gl, gv = THS.point_cloud_shape(T(cloud),
                                       **{k: T(a) for k, a in kw.items()})
        npt.assert_allclose(gl.numpy(), N(wl), rtol=RTOL)
        gv, wv = gv.numpy(), N(wv)
        sign = np.sign(np.sum(gv * wv, axis=1))[:, None]
        npt.assert_allclose(gv * sign, wv, atol=1e-4)

    mass = 10.0 ** rng.uniform(12, 15, 3000)
    props = rng.normal(size=(3000, 2))
    edges = np.linspace(12, 15, 7)
    got = THS.binned_halo_statistics(np.log10(mass), props, edges, n_boot=20)
    want = JHS.binned_halo_statistics(np.log10(mass), props, edges,
                                      n_boot=20)
    assert got.keys() == want.keys()
    for k in got:
        npt.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- voids 2D
def _blob_map(n, centers, amp=1.0, sigma=3.0):
    e = np.arange(n)
    img = np.zeros((n, n), np.float32)
    for (r, c) in centers:
        img += amp * np.exp(-(((e[:, None] - r) ** 2
                               + (e[None, :] - c) ** 2)
                              / (2 * sigma ** 2)))
    return img


@pytest.mark.parametrize("kind", ["wells", "white", "plateau"])
def test_watershed_labels_matches_jax(rng, kind):
    """Basin labels equal pixel for pixel (strict `<` in the loop order,
    +inf beyond the edges, no wrap); two wells drain to their minima."""
    n = 64
    if kind == "wells":
        img = -_blob_map(n, [(16, 16), (48, 48)], sigma=6.0)
    elif kind == "white":
        img = rng.normal(size=(n, n)).astype(np.float32)
    else:
        img = np.round(rng.normal(size=(n, n)) * 2).astype(np.float32)
    want = N(JV.watershed_labels(jnp.asarray(img)))
    got = TV.watershed_labels(T(img)).numpy()
    npt.assert_array_equal(got, want)
    if kind == "wells":
        assert got[20, 20] == 16 * n + 16 and got[44, 44] == 48 * n + 48


@pytest.mark.parametrize("kind", ["wells", "white"])
def test_watershed_voids_matches_jax(rng, kind):
    """The same catalog: count, basin-minimum positions, radii within
    1e-6 (integer areas); the 80th-percentile mask from the JAX package's
    float32 interpolation."""
    n = 64
    img = (-_blob_map(n, [(16, 16), (48, 48)], sigma=6.0) if kind == "wells"
           else rng.normal(size=(n, n)).astype(np.float32))
    for pct in (80.0, 37.5):
        want = JV.watershed_voids(jnp.asarray(img), max_voids=32,
                                  percentile_mask=pct)
        got = TV.watershed_voids(T(img), max_voids=32, percentile_mask=pct)
        assert int(got.n) == int(want.n) >= 2
        npt.assert_array_equal(got.pos.numpy(), N(want.pos))
        npt.assert_allclose(got.radius.numpy(), N(want.radius), rtol=1e-6)
    if kind == "wells":
        pos = got.pos[:2].numpy().tolist()
        assert [16.0, 16.0] in pos and [48.0, 48.0] in pos


@pytest.mark.parametrize("n", [5, 100, 4097, 65536])
def test_percentile_matches_jnp_percentile(rng, n):
    """jnp.percentile's linear interpolation bit for bit (its float32
    position arithmetic), ties and all."""
    x = np.round(rng.normal(size=n) * 50).astype(np.float32)
    for q in (0.0, 12.5, 80.0, 99.9, 100.0):
        want = float(jnp.percentile(jnp.asarray(x), q))
        assert float(TV._percentile(T(x), q)) == want


def test_peak_counts_matches_jax(rng):
    """Counts equal (whole numbers) and bin centers within 1e-6, with and
    without an edge trim; three unit peaks counted (the JAX test)."""
    img = (_blob_map(128, [(20, 30), (50, 60), (90, 10)])
           + 0.05 * rng.normal(size=(128, 128))).astype(np.float32)
    for kw in ({"nbins": 10}, {"nbins": 37, "edge_pix": 6}):
        wc, wh = JK.peak_counts(jnp.asarray(img), -0.2, 1.5, **kw)
        gc, gh = TK.peak_counts(T(img), -0.2, 1.5, **kw)
        npt.assert_array_equal(gh.numpy(), N(wh))
        npt.assert_allclose(gc.numpy(), N(wc), rtol=1e-6, atol=1e-7)
    clean = _blob_map(128, [(20, 30), (50, 60), (90, 10)])
    _, h = TK.peak_counts(T(clean), 0.5, 1.5, nbins=10)
    assert float(h.sum()) == 3.0


def _lattice_peaks(rng, side=6, spacing=10, offset=7):
    g = (np.arange(side) * spacing + offset).astype(np.float32)
    pos = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return pos + rng.uniform(-1, 1, pos.shape).astype(np.float32)


def test_find_tunnels_auto_matches_jax(rng):
    """A dense peak lattice with more candidates than the first capacity:
    the escalated catalog equals the JAX package's, and equals a direct
    run at the final capacity; a capacity_limit below the candidates
    raises."""
    pos = _lattice_peaks(rng)
    valid = np.ones(len(pos), bool)
    want = JV.find_tunnels_auto(jnp.asarray(pos), jnp.asarray(valid), 64,
                                max_voids=8)
    got = TV.find_tunnels_auto(T(pos), T(valid), 64, max_voids=8)
    cap = got.radius.shape[0]
    assert cap == want.radius.shape[0] and cap >= int(got.n_candidates) > 8
    assert int(got.n) == int(want.n)
    npt.assert_array_equal(got.pos.numpy(), N(want.pos))
    npt.assert_allclose(got.radius.numpy(), N(want.radius), rtol=RTOL)
    big = TV.find_tunnels(T(pos), T(valid), 64, max_voids=cap)
    npt.assert_array_equal(big.radius.numpy(), got.radius.numpy())
    with pytest.raises(ValueError, match="capacity limit"):
        TV.find_tunnels_auto(T(pos), T(valid), 64, max_voids=8,
                             capacity_limit=16)


def test_find_tunnels_per_step_form_above_4096(rng, monkeypatch):
    """Above its matrix limit (2^14 candidates) find_tunnels evaluates
    overlaps step by step, no overlap evaluation holding K x K entries: at
    capacity 2^15 it gives the catalog it gives at 4096 (the matrix form)
    on a map with fewer candidates than that, its tail padding."""
    assert TV._OVERLAP_MATRIX_MAX == 1 << 14
    npix, cap = 256, 1 << 15
    pos = rng.uniform(0, npix, (2800, 2)).astype(np.float32)
    valid = np.ones(2800, bool)
    small = TV.find_tunnels(T(pos), T(valid), npix, max_voids=4096)
    ncand = int(small.n_candidates)
    assert 100 < ncand <= 4096
    sizes = []
    overlap_fn = TV.circle_overlap_fraction

    def recording(*args):
        out = overlap_fn(*args)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(TV, "circle_overlap_fraction", recording)
    big = TV.find_tunnels(T(pos), T(valid), npix, max_voids=cap)
    assert 0 < max(sizes) <= cap
    assert int(big.n) == int(small.n) > 10
    assert int(big.n_candidates) == ncand
    nv = int(small.n)
    npt.assert_array_equal(big.pos[:nv].numpy(), small.pos[:nv].numpy())
    npt.assert_array_equal(big.radius[:ncand].numpy(),
                           small.radius[:ncand].numpy())
    assert float(big.radius[ncand:].abs().max()) == 0.0


# ------------------------------------------------------- numpy placement
def _placement_calls():
    rng = np.random.default_rng(0)
    delta = _white(11, 16)
    img = rng.normal(size=(32, 32)).astype(np.float32)
    m = (10.0 ** rng.uniform(12, 15, 200)).astype(np.float32)
    pos = rng.uniform(0, 50, (200, 3)).astype(np.float32)
    peaks = _lattice_peaks(rng, 3, 10, 5)
    halos = _uniform_halos(5, 20, 50.0, logm=14.0)
    draws = (rng.uniform(size=20) < 0.5, rng.poisson(2.0, 20),
             rng.uniform(size=(20, 4)).astype(np.float32),
             rng.normal(size=(3, 20, 4)).astype(np.float32),
             rng.normal(size=(3, 20, 4)).astype(np.float32))
    return {
        "svf_voids": lambda **kw: TV3.svf_voids(delta, 16.0, -0.2,
                                                max_voids=8, **kw).radius,
        "watershed_voids_3d": lambda **kw: TV3.watershed_voids_3d(
            delta, 16.0, 8, -0.1, **kw).radius,
        "enclosed_density_radius": lambda **kw:
            TV3.enclosed_density_radius(delta, 16.0, 1.0, 4.0, 4, -0.2,
                                        **kw),
        "watershed_labels_3d": lambda **kw: TV3.watershed_labels_3d(delta,
                                                                    **kw),
        "sphere_overlap_fraction": lambda **kw: TV3.sphere_overlap_fraction(
            pos[:10], 3.0, pos[10:20], 4.0, 50.0, **kw),
        "so_halos": lambda **kw: TSO.so_halos(delta * 300, 16.0, 0.3,
                                              max_halos=8, **kw).mass,
        "watershed_labels": lambda **kw: TV.watershed_labels(img, **kw),
        "watershed_voids": lambda **kw: TV.watershed_voids(img, 8,
                                                           **kw).radius,
        "find_tunnels_auto": lambda **kw: TV.find_tunnels_auto(
            peaks, np.ones(len(peaks), bool), 32, max_voids=2, **kw).radius,
        "peak_counts": lambda **kw: TK.peak_counts(img, -1.0, 2.0, 8,
                                                   **kw)[1],
        "zheng07_mean_occupation": lambda **kw: TH.zheng07_mean_occupation(
            m, TH.HODParams(), **kw)[1],
        "nfw_radius_sample": lambda **kw: TH.nfw_radius_sample(
            m / m.max(), 5.0, **kw),
        "hod_populate_from_draws": lambda **kw: TH.hod_populate_from_draws(
            *draws, *halos, 50.0, max_sat=4, **kw)["gx"],
        "halo_mass_function": lambda **kw: THS.halo_mass_function(m,
                                                                  **kw)[1],
        "binned_mean": lambda **kw: THS.binned_mean(
            np.log10(m), pos[:, 0], np.linspace(12, 15, 5), 4, **kw),
        "histogram_density": lambda **kw: THS.histogram_density(
            pos[:, 0], 5, (0.0, 50.0), **kw)[1],
        "concentration_prada": lambda **kw: THS.concentration_prada(
            pos[:, 0] + 60.0, pos[:, 1] + 1.0, **kw)[0],
        "concentration_mass_rockstar": lambda **kw:
            THS.concentration_mass_rockstar(m, pos[:, 0] + 1, pos[:, 1] + 1,
                                            (12.0, 15.0), 4, **kw)[1]
            .nan_to_num(),
        "concentration_mass_prada": lambda **kw:
            THS.concentration_mass_prada(m, pos[:, 0] + 60.0,
                                         pos[:, 1] + 1.0, (12.0, 15.0), 4,
                                         **kw)[1].nan_to_num(),
        "theory_hmf": lambda **kw: THS.theory_hmf(
            m[:8], _cosmo_pair()[1], **kw),
        "theory_vsf": lambda **kw: THS.theory_vsf(
            pos[:8, 0] + 2.0, _cosmo_pair()[1], **kw),
        "svdw_multiplicity": lambda **kw: THS.svdw_multiplicity(
            pos[:, 0] / 10 + 0.5, **kw),
        "rho_crit_200": lambda **kw: THS.rho_crit_200(m, pos[:, 0] + 1,
                                                      **kw),
        "virial_radius": lambda **kw: THS.virial_radius(m, **kw),
        "virial_velocity": lambda **kw: THS.virial_velocity(
            m, pos[:, 0] + 1, **kw),
        "halo_environment": lambda **kw: THS.halo_environment(
            pos, np.arange(27).reshape(3, 3, 3), (0, 50, 0, 50, 0, 50),
            **kw),
        "point_cloud_shape": lambda **kw: THS.point_cloud_shape(pos,
                                                                **kw)[0],
    }


@pytest.mark.parametrize("name", sorted(_placement_calls()))
def test_numpy_input_placement(name):
    """Numpy input goes to the CUDA card unless `device` is given: with no
    card the call raises instead of running on the CPU unasked; with
    device='cpu' it runs there, finite."""
    call = _placement_calls()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    got = call(device="cpu")
    assert got.device.type == "cpu"
    assert bool(torch.isfinite(got.to(torch.float64)).all())


def test_hod_populate_numpy_input_follows_the_generator():
    """hod_populate's numpy input goes to `device` (here the CPU, where
    the generator lies) and gives what the same values as tensors give."""
    args = _uniform_halos(12, 100, 50.0, logm=14.0)
    a = TH.hod_populate(torch.Generator().manual_seed(4), *args, 50.0,
                        device="cpu")
    b = TH.hod_populate(torch.Generator().manual_seed(4),
                        *[T(x) for x in args], 50.0)
    for k in a:
        npt.assert_array_equal(a[k].numpy(), b[k].numpy())


# ------------------------------------------------- the example as a whole
def _toy_pk(k):
    return 1.5e5 * k / (1.0 + (k / 0.025) ** 3)


def test_galaxy_mocks_example_matches_jax():
    """examples/galaxy_mocks_voids.py's five stages at 32^3 halos in a
    125 Mpc/h box (the example's density and 3.9 Mpc/h void cell), stage
    by stage: each stage of the port gets what the JAX package's previous
    stage gave it, so every bar is the stage's own.

    1. halo mock from the JAX package's white noise: positions within
       1e-4 Mpc/h (periodic), velocities 1e-3 km/s (two FFTs);
    2. HOD from its five draws: the catalog of _assert_hod_match;
    3. xi(s, mu) of 4000 redshift-space galaxies: within 1e-4 in bins of
       >= 1000 pairs, its multipoles likewise;
    4. the CIC galaxy grid within 2e-5 of its largest cell; SVF and 3D
       watershed catalogs as in _assert_catalogs_match;
    5. void profiles of all galaxies around the largest SVF voids: shell
       counts equal, densities within 1e-5 (XLA's fused pow puts the shell
       volumes a few ulp away), v_r within 1e-4 of its largest, the
       stacks alike.
    """
    from astrild_tpu.ops import mocks as JM
    from astrild_tpu.ops import profiles3d as JPR
    from astrild_tpu.ops import tpcf as JT
    from astrild_tpu_torch.ops import mocks as TM
    from astrild_tpu_torch.ops import profiles3d as TPR
    from astrild_tpu_torch.ops import tpcf as TT

    box, n_ic, n_v = 125.0, 32, 32
    key = jax.random.PRNGKey(42)
    # 1. halo mock
    jpos, jvel = JM.zeldovich_catalog_with_velocities(key, n_ic, box,
                                                      _toy_pk,
                                                      growth_rate=0.53)
    jpos, jvel = N(jpos), N(jvel)
    white = N(jax.random.normal(key, (n_ic,) * 3))
    pos, vel = TM.zeldovich_catalog_with_velocities_from_modes(
        TM.modes_from_white(T(white), n_ic, box, _toy_pk), n_ic, box, 0.53)
    d = pos.numpy() - jpos
    d -= box * np.round(d / box)
    assert np.abs(d).max() < 1e-4
    npt.assert_allclose(vel.numpy(), jvel, atol=1e-3)
    nh = jpos.shape[0]
    rng = np.random.default_rng(0)
    m = 10.0 ** rng.uniform(12.2, 14.5, nh)
    rvir = 0.78 * (m / 1e13) ** (1.0 / 3.0)
    conc = 9.0 * (m / 1e13) ** (-0.1)

    # 2. HOD
    params = JH.HODParams(log_mmin=12.6, sigma_logm=0.3, log_m0=12.5,
                          log_m1=13.6, alpha=1.0)
    key_hod = jax.random.PRNGKey(7)
    halos = (m, jpos[:, 0], jpos[:, 1], jpos[:, 2], jvel[:, 0], jvel[:, 1],
             jvel[:, 2], rvir, conc)
    jcat = JH.hod_populate(key_hod, *[jnp.asarray(a) for a in halos], box,
                           params=params, max_sat=16)
    draws = _jax_hod_draws(key_hod, m.astype(np.float32), params, 16)
    cat = TH.hod_populate_from_draws(*[T(a) for a in draws],
                                     *[T(a) for a in halos], box, max_sat=16)
    _assert_hod_match(cat, jcat, box)
    jgal = JH.compact_catalog(jcat)
    gal = TH.compact_catalog(cat)
    assert gal["gx"].shape == jgal["gx"].shape
    assert 0.3 < gal["is_central"].mean() < 0.9
    gpos = np.stack([jgal["gx"], jgal["gy"], jgal["gz"]], axis=-1)
    gvel = np.stack([jgal["gvx"], jgal["gvy"], jgal["gvz"]], axis=-1)

    # 3. redshift-space clustering
    sub = np.random.default_rng(1).choice(gpos.shape[0], 4000,
                                          replace=False)
    jpos_s = JT.to_redshift_space(jnp.asarray(gpos[sub]),
                                  jnp.asarray(gvel[sub]), box)
    pos_s = TT.to_redshift_space(T(gpos[sub]), T(gvel[sub]), box)
    d = pos_s.numpy() - N(jpos_s)
    assert np.abs(d - box * np.round(d / box)).max() <= 1e-5 * box
    s_edges = np.linspace(2.0, 40.0, 16)
    _, _, jxi = JT.tpcf_s_mu(jpos_s, box, jnp.asarray(s_edges), nmu=20)
    _, _, xi = TT.tpcf_s_mu(T(N(jpos_s)), box, T(s_edges), nmu=20)
    dd = N(JT.pair_counts_s_mu(jpos_s, box, jnp.asarray(s_edges), 15, 20))
    full = dd >= 1000
    assert full.sum() > 50
    npt.assert_allclose(xi.numpy()[full], N(jxi)[full], rtol=1e-4,
                        atol=1e-4)
    for ell in (0, 2):
        want = N(JT.tpcf_multipoles(jxi, ell))
        got = TT.tpcf_multipoles(xi, ell).numpy()
        npt.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())

    # 4. galaxy density grid and the 3D void finders
    comps = tuple(gpos[:, a].copy() for a in range(3))
    jgrid = JP.paint(tuple(jnp.asarray(c) for c in comps), n_v, box,
                     window="cic")
    grid = TP.paint(tuple(T(c) for c in comps), n_v, box, window="cic")
    npt.assert_allclose(grid.numpy(), N(jgrid),
                        atol=2e-5 * float(jgrid.max()))
    jdelta = jgrid / jnp.mean(jgrid) - 1.0
    delta = T(N(jdelta))
    jsvf = JV3.svf_voids(jdelta, box, delta_threshold=-0.6, max_voids=256)
    svf = TV3.svf_voids(delta, box, delta_threshold=-0.6, max_voids=256)
    _assert_catalogs_match(svf, jsvf)
    jwvf = JV3.watershed_voids_3d(jdelta, box, max_voids=256,
                                  core_delta=-0.25)
    wvf = TV3.watershed_voids_3d(delta, box, max_voids=256,
                                 core_delta=-0.25)
    _assert_catalogs_match(wvf, jwvf)
    assert int(svf.n) >= 4 and int(wvf.n) >= 1

    # 5. void-centric profiles
    nv = min(int(jsvf.n), 64)
    centers = N(jsvf.pos)[:nv]
    ones = np.ones(gpos.shape[0], np.float32)
    _, jrho = JPR.radial_density_profiles(jnp.asarray(gpos),
                                          jnp.asarray(ones),
                                          jnp.asarray(centers), 2.0, 60.0,
                                          nbins=12, boxsize=box)
    _, rho = TPR.radial_density_profiles(T(gpos), T(ones), T(centers), 2.0,
                                         60.0, nbins=12, boxsize=box)
    npt.assert_allclose(rho.numpy(), N(jrho), rtol=1e-5)
    _, jvr, jcnt = JPR.radial_velocity_profiles(
        jnp.asarray(gpos), jnp.asarray(gvel), jnp.asarray(centers), 2.0,
        60.0, nbins=12, boxsize=box)
    _, vr, cnt = TPR.radial_velocity_profiles(T(gpos), T(gvel), T(centers),
                                              2.0, 60.0, nbins=12,
                                              boxsize=box)
    npt.assert_array_equal(cnt.numpy(), N(jcnt))
    scale = np.nanmax(np.abs(N(jvr)))
    npt.assert_allclose(vr.numpy(), N(jvr), atol=1e-4 * scale)
    stacked = TPR.stacked_profile(vr, cnt).numpy()
    npt.assert_allclose(stacked, N(JPR.stacked_profile(jvr, jcnt)),
                        atol=1e-4 * scale)
    dens = rho.numpy().mean(axis=0) / (gpos.shape[0] / box ** 3) - 1.0
    # the example's science: underdense inside, outflow around the voids
    assert dens[0] < 0 and dens[-1] > dens[0]
    assert np.nanmean(stacked[:6]) > 0
