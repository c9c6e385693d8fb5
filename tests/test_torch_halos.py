"""PyTorch port vs JAX package on the CPU: the halo-catalog facades. The
`io/rockstar` copy, `Rockstar` and `SubFind` statistics (the SubFind
catalog through h5py, skipped without it, as in JAX), `Halos` (the
registry dispatch on a fake Rockstar tree, resolution cuts, queries and
`populate_hod`), the flat-sky `AngularPowerSpectrum` and
`models/lightcone`.

Inputs are made with numpy (or are the JAX package's HOD draws) and handed
to both packages; each tolerance is stated where it is checked. Binned
statistics of the same catalog agree to float32 rounding; pair counts and
histograms exactly.
"""
import inspect

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.io import rockstar as JR  # noqa: E402
from astrild_tpu.models import halos as JHM  # noqa: E402
from astrild_tpu.models import lightcone as JLC  # noqa: E402
from astrild_tpu.models import power as JPM  # noqa: E402
from astrild_tpu.models.simulation import Simulation as JSim  # noqa: E402
from astrild_tpu_torch.io import rockstar as TR  # noqa: E402
from astrild_tpu_torch.models import halos as THM  # noqa: E402
from astrild_tpu_torch.models import lightcone as TLC  # noqa: E402
from astrild_tpu_torch.models import power as TPM  # noqa: E402
from astrild_tpu_torch.models.simulation import Simulation as TSim  # noqa

STAT_RTOL = 1e-5   # binned float32 statistics, relative
CFG = "astrild_tpu_torch/configs/halo_stats.yaml"


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


def assert_close_nan(got, want, rtol=STAT_RTOL, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    npt.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _rockstar_snapshot(n=400, seed=0, boxsize=100.0):
    """tests/test_facade_surface.py's snapshot."""
    rng = np.random.default_rng(seed)
    m = 10 ** rng.uniform(12.0, 14.5, n)
    return {"x": rng.uniform(0, boxsize, n), "y": rng.uniform(0, boxsize, n),
            "z": rng.uniform(0, boxsize, n), "vx": rng.normal(0, 100, n),
            "vy": rng.normal(0, 100, n), "vz": rng.normal(0, 100, n),
            "m200c": m, "r200c": 0.2 * (m / 1e13) ** (1 / 3),
            "Rs": 0.05 * (m / 1e13) ** (1 / 3)}


@pytest.fixture
def rockstar_tree(tmp_path):
    """tests/test_models.py's fake Rockstar tree: snapshots 8-10, two
    writer files each, 30 halos a file."""
    for snap in (8, 9, 10):
        d = tmp_path / f"rockstar_{snap:03d}"
        d.mkdir()
        for fn in range(2):
            with open(d / f"halos_0.{fn}.ascii", "w") as f:
                f.write("#id x y z vx vy vz m200c r200c Rs\n")
                for _ in range(19):
                    f.write("# c\n")
                rng = np.random.default_rng(snap * 10 + fn)
                for i in range(30):
                    x, y, z = rng.uniform(0, 100, 3)
                    vx, vy, vz = rng.normal(0, 100, 3)
                    m = 10 ** rng.uniform(12.5, 14.5)
                    f.write(f"{i} {x} {y} {z} {vx} {vy} {vz} {m} "
                            f"{0.2} {0.05}\n")
    return str(tmp_path)


# ---------------------------------------------------------------- rockstar
def test_rockstar_reader_is_a_copy(rockstar_tree):
    for name in JR.__all__:
        assert (inspect.getsource(getattr(TR, name))
                == inspect.getsource(getattr(JR, name)))
    sim = TSim(rockstar_tree, None, {"root": "halos", "extension": ".ascii"},
               dir_root="rockstar")
    files = sim.get_file_paths({"root": "halos", "extension": ".ascii"},
                               None, "max")["9"]
    a, b = JR.read_rockstar_files(files), TR.read_rockstar_files(files)
    assert list(b) == list(a)
    for k in a:
        npt.assert_array_equal(b[k], a[k])


def test_rockstar_statics_match_jax():
    snap = _rockstar_snapshot()
    for lim in ((11.78, 16.0), (12.0, 14.5)):
        a = JHM.Rockstar.halo_mass_fct(snap, limits=lim, nbins=12)
        b = THM.Rockstar.halo_mass_fct(snap, limits=lim, nbins=12,
                                       device="cpu")
        # float32 10 ** x of the log-spaced centres: an ulp or two apart
        npt.assert_allclose(b[0], a[0], rtol=STAT_RTOL)
        npt.assert_array_equal(b[1], a[1])
    a = JHM.Rockstar.concentration_mass_rel(snap, nbins=8)
    b = THM.Rockstar.concentration_mass_rel(snap, nbins=8, device="cpu")
    assert_close_nan(b[0], a[0])
    assert_close_nan(b[1], a[1])
    # r200c / Rs = 4 by construction (the JAX test's closed form)
    npt.assert_allclose(b[1][np.isfinite(b[1])], 4.0, rtol=1e-5)
    props = {"m200c": (1e12, 10 ** 14.5), "vx": (-300.0, 300.0)}
    a = JHM.Rockstar.histograms(snap, nbins=16, properties=props)
    b = THM.Rockstar.histograms(snap, nbins=16, properties=props,
                                device="cpu")
    for k in props:
        npt.assert_allclose(b[k], a[k], rtol=1e-6)
    a = JHM.Rockstar.two_point_corr_fct(snap, limits=(2.0, 20.0), nbins=6,
                                        boxsize=100.0)
    b = THM.Rockstar.two_point_corr_fct(snap, limits=(2.0, 20.0), nbins=6,
                                        boxsize=100.0, device="cpu")
    npt.assert_allclose(b[0], a[0], rtol=1e-6)
    npt.assert_allclose(b[1], a[1], rtol=1e-5, atol=1e-6)
    assert np.abs(b[1]).max() < 1.0


@pytest.mark.parametrize("limits,nbins", [(None, None), ((0.0, 30.0), 11)])
def test_rockstar_mean_pairwise_velocity_matches_jax(limits, nbins):
    snap = _rockstar_snapshot(n=600, seed=2)
    a = JHM.Rockstar.mean_pairwise_velocity(snap, limits=limits,
                                            nbins=nbins, boxsize=100.0)
    b = THM.Rockstar.mean_pairwise_velocity(snap, limits=limits,
                                            nbins=nbins, boxsize=100.0,
                                            device="cpu")
    npt.assert_allclose(b[0], a[0], rtol=1e-6)
    assert_close_nan(b[1], a[1], rtol=1e-4, atol=1e-3)


def _subfind_tree(tmp_path, rng, ngroups=50):
    """tests/test_facade_surface.py's SubFind group file."""
    h5py = pytest.importorskip("h5py")
    gdir = tmp_path / "groups_004"
    gdir.mkdir()
    with h5py.File(gdir / "fof_subhalo_tab_004.0.hdf5", "w") as f:
        h = f.create_group("Header")
        h.attrs["Ngroups_ThisFile"] = ngroups
        h.attrs["Ngroups_Total"] = ngroups
        h.attrs["Nsubgroups_ThisFile"] = ngroups
        h.attrs["Nsubgroups_Total"] = ngroups
        h.attrs["HubbleParam"] = 0.7
        g = f.create_group("Group")
        g["GroupPos"] = rng.uniform(0, 100, (ngroups, 3)) * 1e3  # kpc/h
        g["Group_M_Crit200"] = 10 ** rng.uniform(2.0, 4.0, ngroups)
        r200 = np.full(ngroups, 0.2 * 1e3)
        r200[0] = 0.0  # an unresolved group
        g["Group_R_Crit200"] = r200
        first = np.arange(ngroups)
        first[1] = -1  # a group with no subhalo
        g["GroupFirstSub"] = first
        s = f.create_group("Subhalo")
        s["SubhaloVmax"] = rng.uniform(150.0, 400.0, ngroups)
    return str(tmp_path)


def test_subfind_facades_match_jax(tmp_path, rng):
    root = _subfind_tree(tmp_path, rng)
    a = JHM.Halos.from_subfind(4, JSim(root))
    b = THM.Halos.from_subfind(4, TSim(root), device="cpu")
    assert b.data["n_groups"] == a.data["n_groups"] == 50
    assert np.isnan(b.data["SubhaloVmax"][1])
    for k in ("GroupPos", "Group_M_Crit200", "SubhaloVmax"):
        npt.assert_array_equal(b.data[k], a.data[k])
    fa = JHM.Halos.filter_nonzero_subfind_halos_size(a.data)
    fb = THM.Halos.filter_nonzero_subfind_halos_size(b.data)
    npt.assert_array_equal(fb["Group_M_Crit200"], fa["Group_M_Crit200"])
    # c-M on a catalog whose vmax / v200 the Newton steps can solve (the
    # file's 1e2-1e4 masses give v200 ~ 1e-4 km/s, where the solver's
    # convergence test is left to rounding)
    m = 10 ** rng.uniform(12.0, 15.0, 400)
    r = 0.2 * (m / 1e13) ** (1 / 3)
    v200 = np.sqrt(4.300917270e-9 * m / r)
    cat = {"Group_M_Crit200": m, "Group_R_Crit200": r,
           "SubhaloVmax": v200 * rng.uniform(1.1, 1.8, 400)}
    x = JHM.SubFind.concentration_mass_rel(cat, limits=(12.0, 15.0),
                                           nbins=10)
    y = THM.SubFind.concentration_mass_rel(cat, limits=(12.0, 15.0),
                                           nbins=10, device="cpu")
    assert_close_nan(y[0], x[0])
    assert_close_nan(y[1], x[1], rtol=1e-4)
    assert np.isfinite(y[1]).all()
    x = JHM.SubFind.halo_mass_fct(a.data, limits=(10.0, 16.0), nbins=10)
    y = THM.SubFind.halo_mass_fct(b.data, limits=(10.0, 16.0), nbins=10,
                                  device="cpu")
    npt.assert_array_equal(y[1], x[1])


def test_subfind_power_spectrum_matches_jax(rng):
    """The weighted TSC paint and P(k) with the mass-weighted shot noise
    V sum(m^2) / (sum m)^2 (not V / N)."""
    n = 3000
    snap = {"GroupPos": rng.uniform(0, 100.0, (n, 3)),
            "Group_M_Crit200": 10 ** rng.uniform(12.0, 15.0, n)}
    a = JHM.SubFind.power_spectrum(snap, boxsize=100.0, ngrid=32)
    b = THM.SubFind.power_spectrum(snap, boxsize=100.0, ngrid=32,
                                   device="cpu")
    npt.assert_allclose(b[0], a[0], rtol=1e-6)
    m = snap["Group_M_Crit200"]
    shot = 100.0 ** 3 * np.sum(m ** 2) / np.sum(m) ** 2
    assert shot > 3 * 100.0 ** 3 / n
    # the measured power before the shot noise is taken off (the
    # difference cancels toward 0), to the float32 mean of a grid of masses
    # up to 1e15 that normalizes it
    npt.assert_allclose(b[1] + shot, a[1] + shot, rtol=5e-5)
    c = THM.SubFind.power_spectrum(snap, boxsize=100.0, ngrid=32, nbins=8,
                                   device="cpu")
    assert c[0].shape == (8,)


# ------------------------------------------------------------------- halos
def test_halos_stats_pipeline_matches_jax(rockstar_tree):
    """tests/test_models.py::test_halos_stats_pipeline: the registry's
    statistics in resolution order on snapshot 9 (60 halos), both
    packages, from the port's own copy of the registry."""
    out = {}
    for name, Sim, mod in (("jax", JSim, JHM), ("torch", TSim, THM)):
        sim = Sim(rockstar_tree, None,
                  {"root": "halos", "extension": ".ascii"},
                  dir_root="rockstar")
        sim.files["halos"] = sim.get_file_paths(
            {"root": "halos", "extension": ".ascii"}, None, "max")
        kw = {} if name == "jax" else {"device": "cpu"}
        halos = mod.Halos.from_rockstar(9, sim, **kw)
        assert len(halos.data["m200c"]) == 60
        out[name] = halos._get_stats("rockstar", CFG, snap_nrs=[9],
                                     save=False, dm_particle_mass=1e8)
    a, b = out["jax"], out["torch"]
    assert list(b) == list(a)
    for stat in a:
        ra, rb = a[stat]["results"], b[stat]["results"]
        assert list(rb["values"]) == list(ra["values"]) == ["snap_9"]
        assert_close_nan(rb["bins"]["snap_9"], ra["bins"]["snap_9"])
        assert_close_nan(rb["values"]["snap_9"], ra["values"]["snap_9"],
                         rtol=1e-4, atol=1e-6)
    hmf = b["halo_mass_fct"]["results"]["values"]["snap_9"]
    assert np.all(np.diff(hmf) <= 0)
    assert b["mean_pairwise_velocity"]["results"]["values"][
        "snap_9"].shape == (25,)


def test_get_rockstar_stats_saves_and_reads_back(rockstar_tree):
    pytest.importorskip("h5py")
    from astrild_tpu_torch.io import columnar_h5

    sim = TSim(rockstar_tree, None, {"root": "halos", "extension": ".ascii"},
               dir_root="rockstar")
    sim.files["halos"] = sim.get_file_paths(
        {"root": "halos", "extension": ".ascii"}, None, "max")
    halos = THM.Halos(None, sim, device="cpu")
    stats = halos.get_rockstar_stats(CFG, snap_nrs=[8, 10], save=True,
                                     dm_particle_mass=1e8)
    back = columnar_h5.read_table(f"{rockstar_tree}/rockstar_halo_mass_fct.h5")
    for s in ("snap_8", "snap_10"):
        npt.assert_array_equal(
            back[s], stats["halo_mass_fct"]["results"]["values"][s])


def test_load_stats_config_and_resolution_cut(tmp_path):
    cfg = tmp_path / "t.yaml"
    cfg.write_text("a:\n  resolution: 5\n  args: !!python/tuple [1, 2]\n"
                   "b:\n  resolution: 1\n")
    got = THM.load_stats_config(str(cfg))
    assert got == JHM.load_stats_config(str(cfg))
    assert got["a"]["args"] == (1, 2)
    assert THM.Halos._sort_statistics(got) == ["b", "a"]
    snap = {"m200c": np.array([1e10, 1e12, 1e14]), "x": np.arange(3.0),
            "n": 3}
    a = JHM.Halos._filter_resolved("rockstar", snap, 100, 1e8)
    b = THM.Halos._filter_resolved("rockstar", snap, 100, 1e8)
    assert list(b) == list(a) and b["n"] == 3
    npt.assert_array_equal(b["x"], a["x"])


def test_populate_hod_from_jax_draws_matches_jax():
    """tests/test_hod.py::test_halos_facade_populate_hod's catalog: the
    JAX package's draws (its split order) through the port's facade give
    its galaxies (positions to 1e-5 relative, counts equal)."""
    from astrild_tpu.ops import hod as JH

    rng = np.random.default_rng(0)
    nh, max_sat = 300, 12
    data = {"m200c": 10 ** rng.uniform(13.0, 14.5, nh),
            "x": rng.uniform(0, 100, nh), "y": rng.uniform(0, 100, nh),
            "z": rng.uniform(0, 100, nh),
            "vx": rng.normal(0, 200, nh), "vy": rng.normal(0, 200, nh),
            "vz": rng.normal(0, 200, nh),
            "r200c": np.full(nh, 500.0), "Rs": np.full(nh, 80.0)}
    want = JHM.Halos(data).populate_hod(boxsize=100.0, key=11,
                                        max_sat=max_sat)
    # the draws of ops/hod.py's hod_populate, in its split order
    m = jnp.asarray(np.asarray(data["m200c"], np.float32))
    k_cen, k_nsat, k_rad, k_dir, k_vel = jax.random.split(
        jax.random.PRNGKey(11), 5)
    n_cen_mean, n_sat_mean = JH.zheng07_mean_occupation(
        m, JH.HODParams())
    draws = [jax.random.bernoulli(k_cen, n_cen_mean),
             jax.random.poisson(k_nsat, n_sat_mean, (nh,)),
             jax.random.uniform(k_rad, (nh, max_sat)),
             jax.random.normal(k_dir, (3, nh, max_sat)),
             jax.random.normal(k_vel, (3, nh, max_sat))]
    got = THM.Halos(data, device="cpu").populate_hod_from_draws(
        100.0, *[np.asarray(d) for d in draws], max_sat=max_sat)
    assert sorted(got) == sorted(want)
    for k in want:
        if np.asarray(want[k]).dtype.kind in "iub":
            npt.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            npt.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-3,
                                err_msg=k)
    # the JAX test's checks, on a seeded torch generator and on an int
    for key in (11, torch.Generator().manual_seed(3)):
        gal = THM.Halos(data, device="cpu").populate_hod(
            boxsize=100.0, key=key, max_sat=max_sat)
        assert gal["gx"].shape[0] == gal["valid"].sum()
        assert gal["gx"].shape[0] > nh / 2
        assert (gal["gx"] >= 0).all() and (gal["gx"] < 100.0).all()


def test_halos_queries_match_jax(rng):
    snap = _rockstar_snapshot(n=50, seed=3)
    snap["id"] = np.arange(50)
    snap["theta1_deg"] = rng.uniform(0, 5, 50)
    snap["theta2_deg"] = rng.uniform(0, 5, 50)
    snap["r200_deg"] = rng.uniform(0.1, 1.0, 50)
    a, b = JHM.Halos(dict(snap)), THM.Halos(dict(snap), device="cpu")
    for x, y in ((a.in_mass_range(1e13, 1e14), b.in_mass_range(1e13, 1e14)),
                 (a.select_in_box([-10, 50, 0, 50, 20, 120], 100.0),
                  b.select_in_box([-10, 50, 0, 50, 20, 120], 100.0))):
        assert list(y.data) == list(x.data)
        for k in x.data:
            npt.assert_array_equal(y.data[k], x.data[k])
    for p, q in zip(a.nearest_neighbours(k=3), b.nearest_neighbours(k=3)):
        npt.assert_array_equal(q, p)
    for p, q in zip(a.neighbours_within(7, extent=2.0),
                    b.neighbours_within(7, extent=2.0)):
        npt.assert_array_equal(q, p)
    with pytest.raises(KeyError):
        b.neighbours_within(999)
    for order, relabel in (("descending", False), ("ascending", True)):
        a.sort_by("m200c", order=order, relabel=relabel)
        b.sort_by("m200c", order=order, relabel=relabel)
        for k in a.data:
            npt.assert_array_equal(b.data[k], a.data[k])
    with pytest.raises(ValueError):
        b.sort_by("m200c", order="sideways")
    h = THM.Halos({"id": np.arange(4),
                   "flag": np.array([False, True, False, True])})
    h.sort_by("flag")
    npt.assert_array_equal(h.data["id"], [1, 3, 0, 2])
    env = rng.integers(0, 4, (8, 8, 8)).astype(np.int32)
    box = (0.0, 100.0, 0.0, 100.0, 0.0, 100.0)
    npt.assert_array_equal(b.environment(env, box), a.environment(env, box))


# ------------------------------------------------- AngularPowerSpectrum
def test_angular_power_spectrum_flat_matches_jax(rng):
    from astrild_tpu.models.skymap import SkyArray as JS
    from astrild_tpu_torch.models.skymap import SkyArray as TS

    img = rng.normal(0, 1, (128, 128)).astype(np.float32)
    a = JPM.AngularPowerSpectrum.from_array(img, 10.0, nbins=12)
    b = TPM.AngularPowerSpectrum.from_array(img, 10.0, nbins=12,
                                            device="cpu")
    c = TPM.AngularPowerSpectrum.from_skymap(
        TS.from_array(img, 10.0, device="cpu"), nbins=12)
    d = JPM.AngularPowerSpectrum.from_skymap(JS.from_array(img, 10.0),
                                             nbins=12)
    for x, y in ((b, a), (c, d)):
        npt.assert_allclose(y[0], x[0], rtol=1e-6)
        npt.assert_allclose(y[1], x[1], rtol=1e-5)
    g1 = rng.normal(0, 1, (64, 64)).astype(np.float32)
    g2 = rng.normal(0, 1, (64, 64)).astype(np.float32)
    a = JPM.AngularPowerSpectrum.from_shear(g1, g2, 5.0, nbins=8)
    b = TPM.AngularPowerSpectrum.from_shear(g1, g2, 5.0, nbins=8,
                                            device="cpu")
    for x, y in zip(b, a):
        npt.assert_allclose(x, y, rtol=1e-5)


def test_angular_power_to_flat_map_and_healpix_raise():
    """to_flat_map is cl_to_flat_map of a generator seeded with rnd_seed
    (another realization than the JAX key): its C_ell against the table
    within the mode-count noise of 256^2 pixels. The full-sky half, once
    a raise: from_healpix is the layer's anafast (the JAX package's within
    1e-6 of its max), to_skyhealpix is SkyHealpix.from_Cl_array of the
    same seed."""
    from astrild_tpu_torch.ops import angular_power as TAP

    ells = np.linspace(1.0, 20000.0, 512)
    cls = 1e-9 * (1.0 + (ells / 1000.0) ** 2) ** -1
    m = TPM.AngularPowerSpectrum.to_flat_map(ells, cls, 256, 10.0,
                                             rnd_seed=4, device="cpu")
    want = TAP.cl_to_flat_map(torch.Generator().manual_seed(4), ells, cls,
                              256, 10.0)
    assert isinstance(m, np.ndarray)
    npt.assert_array_equal(m, want.numpy())
    ell, cl = TPM.AngularPowerSpectrum.from_array(m, 10.0, nbins=10,
                                                  device="cpu")
    ratio = cl / np.interp(ell, ells, cls)
    assert np.all(np.abs(ratio[2:] - 1.0) < 0.25)
    from astrild_tpu.models.skyhealpix import SkyHealpix as JSH
    from astrild_tpu_torch.models import SkyHealpix as TSH

    hmap = np.random.default_rng(5).standard_normal(768).astype(np.float32)
    ell_t, cl_t = TPM.AngularPowerSpectrum.from_healpix(
        TSH(hmap, device="cpu"), 16)
    ell_j, cl_j = JPM.AngularPowerSpectrum.from_healpix(JSH(hmap), 16)
    assert isinstance(cl_t, np.ndarray)
    npt.assert_array_equal(ell_t, ell_j)
    npt.assert_allclose(cl_t, cl_j, atol=1e-6 * np.abs(cl_j).max())
    cl_in = 1e-2 / (1.0 + np.arange(17.0)) ** 2
    sky = TPM.AngularPowerSpectrum.to_skyhealpix(cl_in, 8, rnd_seed=3,
                                                 device="cpu")
    want = TSH.from_Cl_array(cl_in, "kappa_2", 8, rnd_seed=3, device="cpu")
    assert isinstance(sky, TSH) and sky.nside == 8
    npt.assert_array_equal(sky.data["orig"].numpy(),
                           want.data["orig"].numpy())


# -------------------------------------------------------------- lightcone
def _lc_inputs():
    pos = np.array([[250.0, 250.0, 100.0], [250.0, 250.0, 400.0],
                    [490.0, 250.0, 100.0], [260.0, 240.0, 120.0]])
    vel = np.array([[100.0, 50.0, 1000.0], [0.0, 0.0, 0.0],
                    [0.0, 0.0, 0.0], [-30.0, 20.0, 10.0]])
    return (pos, vel, np.array([1e14, 1e13, 1e13, 5e13]),
            np.array([1.0, 0.5, 0.5, 0.7]))


@pytest.mark.parametrize("snaplimit", [(1050.0, 1200.0), (10.0, 20.0)])
def test_halo_lightcone_catalog_matches_jax(snaplimit):
    pos, vel, m, r = _lc_inputs()
    kw = dict(boxsize=500.0, boxdist=1000.0, snaplimit=snaplimit,
              opening_angle=20.0, npix=1024, box_nr=1, snap_nr=5, ray_nr=3,
              extra_columns={"tag": np.arange(4)})
    a = JLC.halo_lightcone_catalog(pos, vel, m, r, **kw)
    b = TLC.halo_lightcone_catalog(pos, vel, m, r, **kw)
    if a is None:
        assert b is None
        return
    assert list(b) == list(a)
    for k in a:
        assert b[k].dtype == a[k].dtype
        npt.assert_array_equal(b[k], a[k])
    npt.assert_allclose(b["rad_dist"][0], 1100.0)
    npt.assert_allclose(b["theta1_tv"][0], 100.0, atol=1e-6)
    merged = TLC.merge_lightcone_catalogs([None, b, b])
    assert len(merged["m200"]) == 2 * len(b["m200"])
    assert TLC.merge_lightcone_catalogs([None]) == {}
    npt.assert_array_equal(TLC.degree_to_pixel([0.5, 9.99], 20.0, 1024),
                           JLC.degree_to_pixel([0.5, 9.99], 20.0, 1024))


def test_lightcone_transform_float64_precision():
    import warnings

    boxdist = 3000.0
    pos = np.array([[250.0 + 1e-4, 250.0, 123.456789]])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cat = TLC.halo_lightcone_catalog(
            pos, np.array([[100.0, 50.0, 25.0]]), np.array([1e13]),
            np.array([0.2]), 500.0, boxdist, snaplimit=(2900.0, 3300.0),
            opening_angle=10.0, npix=1024)
    assert cat["x"].dtype == np.float64
    expected = np.sqrt(1e-4 ** 2 + (boxdist + 123.456789) ** 2)
    assert abs(float(cat["rad_dist"][0]) - expected) < 1e-3


def test_numpy_input_placement(monkeypatch):
    """The statistics put numpy columns on `device=`; without a card and
    without `device` they raise."""
    snap = _rockstar_snapshot(n=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: THM.Rockstar.halo_mass_fct(snap),
        lambda: THM.Rockstar.mean_pairwise_velocity(snap, boxsize=100.0),
        lambda: THM.SubFind.power_spectrum(
            {"GroupPos": np.ones((4, 3)), "Group_M_Crit200": np.ones(4)},
            ngrid=8),
        lambda: THM.Halos(snap).populate_hod(100.0),
        lambda: TPM.AngularPowerSpectrum.from_array(np.ones((8, 8)), 1.0),
        lambda: TPM.AngularPowerSpectrum.to_flat_map(
            np.arange(1.0, 10.0), np.ones(9), 8, 1.0),
    ]
    for fn in calls:
        with pytest.raises(RuntimeError, match="no card"):
            fn()
