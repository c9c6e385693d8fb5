"""PyTorch port vs JAX package on the CPU: the map-analysis and catalog
facades. `core.Dataset`, the config copies, `Peaks`, `TunnelsFinder`,
`WatershedFinder`, the 3D finders, `Voids`, `SkyArray`'s filters,
smoothing, Minkowski functionals and aperture mass, and
examples/full_pipeline.py stages 1-4 (collection P(k), bispectrum, Born
kappa, the void pipeline) at a small size in both packages, stage by
stage.

Inputs are made with numpy (or are the JAX package's own draws: the
example's particles, the bootstrap's blocks) and handed to both packages;
each tolerance is stated where it is checked. Catalogs found on the same
map agree exactly (positions, radii to 1e-6 relative); maps to float32
rounding of their FFTs. The bootstrap envelopes of the facades draw from a
torch generator (another realization than the JAX key of the same seed):
they are held against the JAX package through
`bootstrap_profiles_from_draws` with its draws.
"""
import filecmp
import importlib.util
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu import models as JMOD  # noqa: E402
from astrild_tpu.models import voids as JVM  # noqa: E402
from astrild_tpu.ops import profiles as JP  # noqa: E402
from astrild_tpu_torch import models as TMOD  # noqa: E402
from astrild_tpu_torch.models import voids as TVM  # noqa: E402
from astrild_tpu_torch.ops import profiles as TP  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAP_TOL = 1e-5   # maps: max |port - JAX| / max |JAX|


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
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_map_close(got, want, tol=MAP_TOL):
    got, want = N(got), np.asarray(want)
    assert got.shape == want.shape
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-30)
        assert float(np.abs(got[fin] - want[fin]).max()) <= tol * scale


def assert_columns_equal(got: dict, want: dict, rtol=1e-6):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "iub":
            npt.assert_array_equal(g, w, err_msg=k)
        else:
            npt.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)


def _blob_map(n=128, seed=0, centers=((32.0, 32.0), (64.0, 96.0),
                                      (100.0, 40.0))):
    """The JAX tests' kappa_sky: noise and three Gaussian blobs."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 0.01, (n, n)).astype(np.float32)
    e = np.arange(n)
    for (r, c) in centers:
        img += (0.1 * np.exp(-((e[:, None] - r) ** 2 + (e[None, :] - c) ** 2)
                             / (2 * 4.0 ** 2))).astype(np.float32)
    return img


@pytest.fixture(scope="module")
def skies():
    img = _blob_map()
    return (JMOD.SkyArray.from_array(img, 10.0, "kappa_2"),
            TMOD.SkyArray.from_array(img, 10.0, "kappa_2", device="cpu"))


@pytest.fixture(scope="module")
def tunnels(skies):
    js, ts = skies
    jf, tf = JMOD.TunnelsFinder(js), TMOD.TunnelsFinder(ts)
    for f in (jf, tf):
        f.find_peaks(thresholds_dsc={"on": "orig", "nbins": 100}, edge_pix=2)
        f.find_voids(sigmas=[0.0, 1.0])
    return jf, tf


# ------------------------------------------------------- dataset, configs
def test_dataset_is_a_copy_and_round_trips(tmp_path):
    pytest.importorskip("h5py")
    import inspect

    from astrild_tpu.core import dataset as JD
    from astrild_tpu_torch.core import Dataset

    for name in ("__getitem__", "dims_of", "to_hdf5", "from_hdf5"):
        assert (inspect.getsource(getattr(Dataset, name))
                == inspect.getsource(getattr(JD.Dataset, name)))
    ds = Dataset(data_vars={"mean": (("sigma", "radius"), np.ones((2, 3)))},
                 coords={"sigma": np.array([0.0, 1.0]),
                         "radius": np.arange(3.0),
                         "name": np.array(["a", "b"]),
                         "nr": (("sigma",), np.array([4.0, 5.0]))},
                 attrs={"finder": "tunnels"})
    ds.to_hdf5(tmp_path / "a.h5")
    # each package reads the other's file
    for back in (JD.Dataset.from_hdf5(tmp_path / "a.h5"),
                 Dataset.from_hdf5(tmp_path / "a.h5")):
        npt.assert_array_equal(back["mean"], ds["mean"])
        npt.assert_array_equal(back["nr"], [4.0, 5.0])
        assert list(back["name"]) == ["a", "b"]
        assert back.dims_of("mean") == ("sigma", "radius")
        assert back.attrs["finder"] == "tunnels"


@pytest.mark.parametrize("name", ["tunnels_isw.json", "svf_isw.json",
                                  "zobov_isw.json", "halo_stats.yaml"])
def test_config_files_are_byte_copies(name):
    assert filecmp.cmp(ROOT / "astrild_tpu_torch" / "configs" / name,
                       ROOT / "astrild_tpu" / "configs" / name,
                       shallow=False)


def test_load_void_config_matches_jax(tmp_path):
    for name in ("tunnels_isw", "svf_isw.json", "zobov_isw"):
        assert TVM.load_void_config(name) == JVM.load_void_config(name)
    with pytest.raises(FileNotFoundError):
        TVM.load_void_config("no_such_config")
    # a path with directories never falls back to the template
    with pytest.raises(FileNotFoundError):
        TVM.load_void_config(str(tmp_path / "nodir" / "svf_isw.json"))
    own = tmp_path / "mine.json"
    own.write_text('{"extend": 1.5}')
    assert TVM.load_void_config(str(own)) == {"extend": 1.5}
    # the port reads its own copies, never the JAX package's files
    assert TVM._CONFIG_DIR == ROOT / "astrild_tpu_torch" / "configs"


# -------------------------------------------------------------- skyarray
@pytest.mark.parametrize("dsc", [
    {"gaussian": {"abbrev": "smooth", "fwhm_arcmin": 5.0}},
    {"gaussian_high_pass": {"sigma_arcmin": 3.0},
     "apodization": {"abbrev": "apo"}},
    {"gaussian_third_derivative": {"theta_i_arcmin": 4.0, "axis": 1}},
    {"gaussian_compensated": {"theta_i_arcmin": 3.0,
                              "theta_o_arcmin": 9.0}},
    {"aperture_photometry": {"alpha_arcmin": 10.0}},
])
def test_skyarray_filter_matches_jax(dsc):
    img = _blob_map(n=96)
    js = JMOD.SkyArray.from_array(img, 10.0, "kappa_2")
    ts = TMOD.SkyArray.from_array(img, 10.0, "kappa_2", device="cpu")
    js.filter(dsc)
    ts.filter(dsc)
    new = [k for k in js.data if k != "orig"]
    assert [k for k in ts.data if k != "orig"] == new
    assert_map_close(ts.data[new[0]], js.data[new[0]])
    assert_map_close(ts.filter(dsc, rtn=True), js.filter(dsc, rtn=True))


def test_skyarray_smoothing_minkowski_and_aperture_mass_match_jax(skies):
    js, ts = skies
    assert_map_close(ts.smoothing(2.0), js.smoothing(2.0))
    assert_map_close(ts.data["orig_smooth"], js.data["orig_smooth"])
    a = js.minkowski_functionals(nbins=12, limits=(-0.02, 0.05))
    b = ts.minkowski_functionals(nbins=12, limits=(-0.02, 0.05))
    npt.assert_array_equal(b["V0"], a["V0"])
    for k in ("V1", "V2"):
        assert_map_close(b[k], a[k])
    assert_map_close(ts.aperture_mass(8.0), js.aperture_mass(8.0))
    ts.aperture_mass(8.0, rtn=False)
    js.aperture_mass(8.0, rtn=False)
    assert_map_close(ts.data["orig_map8"], js.data["orig_map8"])
    a = js.aperture_mass_moments([4.0, 8.0])
    b = ts.aperture_mass_moments([4.0, 8.0])
    for k in ("map2", "map3", "skewness"):
        npt.assert_allclose(b[k], a[k], rtol=1e-4)


# ------------------------------------------------------------ finders 2D
def test_tunnels_finder_matches_jax(tunnels, tmp_path):
    jf, tf = tunnels
    # the same peaks: positions and heights exactly, SNR to the std's
    # float32 sum
    snr_j, snr_t = jf.peaks["snr"], tf.peaks["snr"]
    assert_columns_equal({k: v for k, v in tf.peaks.items() if k != "snr"},
                         {k: v for k, v in jf.peaks.items() if k != "snr"},
                         rtol=0)
    npt.assert_allclose(snr_t, snr_j, rtol=1e-5)
    assert len(jf.voids["rad_pix"]) > 0
    assert_columns_equal(tf.voids, jf.voids)
    assert_columns_equal(tf.filtered_peaks, jf.filtered_peaks, rtol=1e-5)
    assert_columns_equal(tf.set_peak_radii(), jf.set_peak_radii(),
                         rtol=1e-5)
    pytest.importorskip("h5py")
    from astrild_tpu_torch.io import columnar_h5

    tf.to_file(str(tmp_path / "cat"))
    back = columnar_h5.read_table(str(tmp_path / "cat" / "voids_in_kappa2.h5"))
    npt.assert_array_equal(back["rad_pix"], tf.voids["rad_pix"])
    with pytest.raises(RuntimeError, match="find_peaks"):
        TMOD.TunnelsFinder(tf.skymap).find_voids()


def test_watershed_finder_matches_jax(skies):
    js, ts = skies
    a = JMOD.WatershedFinder(js).find_voids(smooth_arcmin=5.0)
    b = TMOD.WatershedFinder(ts).find_voids(smooth_arcmin=5.0)
    assert len(a["rad_pix"]) > 0
    assert_columns_equal(b, a)


def test_peaks_facade_matches_jax(tunnels, tmp_path):
    from astrild_tpu.models.peaks import Peaks as JPk
    from astrild_tpu_torch.models.peaks import Peaks as TPk

    jf, tf = tunnels
    jp, tp = JPk.from_tunnels_finder(jf), TPk.from_tunnels_finder(tf)
    assert_columns_equal(tp.data, jp.data, rtol=1e-5)
    for p in (jp, tp):
        p.data["rad_pix"] = np.maximum(p.data["rad_pix"], 1)
    a = jp.get_profiles(1.0, 6, skymap=jf.skymap.data["orig"])
    b = tp.get_profiles(1.0, 6, skymap=tf.skymap.data["orig"])
    npt.assert_array_equal(b["radii"], a["radii"])
    assert_map_close(b["values"], a["values"])
    da, db = jp.get_profile_stats(n_boot=10), tp.get_profile_stats(n_boot=10)
    assert_map_close(db["mean"], da["mean"], tol=1e-6)
    assert np.all(db["lowerr"] <= db["higherr"])
    sig = np.unique(tp.data["sigma"])[0]
    assert len(tp.filter_sigma(sig)["x_pix"]) == int(
        (tp.data["sigma"] == sig).sum())
    # from_txt, size categories and set_radii, as the JAX tests
    rows = np.array([[1.0, 2.0, 3.5], [5.0, 4.0, 4.2], [9.9, 0.1, 2.8]])
    f = str(tmp_path / "peaks.txt")
    np.savetxt(f, rows)
    a, b = (JPk.from_txt(f, npix=128, field_width_deg=10.0),
            TPk.from_txt(f, npix=128, field_width_deg=10.0))
    assert_columns_equal(b.data, a.data)
    for p in (a, b):
        p.data["rad_deg"] = np.array([0.1, 0.5, 1.0])
        p.data["sigma"] = np.array([0.0, 0.0, 3.0])
        p.categorize_sizes(bins=2, min_obj_nr=1)
    assert_columns_equal(b.data, a.data)
    a = JPk({"x_deg": np.array([1.0, 5.0]), "y_deg": np.array([1.0, 5.0])},
            {"npix": 100, "opening_angle": 10.0})
    b = TPk({"x_deg": np.array([1.0, 5.0]), "y_deg": np.array([1.0, 5.0])},
            {"npix": 100, "opening_angle": 10.0})
    voids = {"x_deg": np.array([1.0, 9.0]), "y_deg": np.array([2.0, 9.0])}
    a.set_radii(voids)
    b.set_radii(voids)
    assert_columns_equal(b.data, a.data)


# ------------------------------------------------------------ finders 3D
def _void_field(ngrid=48, box=48.0, center=(24.5, 24.5, 24.5), r0=9.0,
                depth=-0.9):
    """A compensated top-hat void centred on a cell (not on a cell
    corner, where the two packages' FFTs break ties differently)."""
    cell = box / ngrid
    x = (np.arange(ngrid) + 0.5) * cell
    d = [x[:, None, None] - center[0], x[None, :, None] - center[1],
         x[None, None, :] - center[2]]
    d = [a - box * np.round(a / box) for a in d]
    r = np.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    inside = r < r0
    bg = -depth * inside.sum() / (ngrid ** 3 - inside.sum())
    return np.where(inside, depth, bg).astype(np.float32)


def test_3d_finders_match_jax():
    from astrild_tpu.models.voids import (SphericalVoidFinder3D as JSVF,
                                          WatershedFinder3D as JWVF)
    from astrild_tpu_torch.models.voids import (SphericalVoidFinder3D as TSVF,
                                                WatershedFinder3D as TWVF)

    # a little noise: the background's plateau would leave the watershed
    # basins to FFT rounding
    delta = _void_field() + 0.02 * np.random.default_rng(1).standard_normal(
        (48, 48, 48)).astype(np.float32)
    a = JSVF(delta, 48.0).find_voids(delta_threshold=-0.5, max_voids=16)
    tsvf = TSVF(delta, 48.0, device="cpu")
    b = tsvf.find_voids(delta_threshold=-0.5, max_voids=16)
    assert len(a["x"]) >= 1
    assert_columns_equal(b, a, rtol=1e-5)
    a = JWVF(delta, 48.0).find_voids(core_delta=-0.3)
    twvf = TWVF(delta, 48.0, device="cpu")
    b = twvf.find_voids(core_delta=-0.3)
    assert_columns_equal(b, a, rtol=1e-5)
    assert TMOD.Voids.from_finder(tsvf).finder == "svf"
    vw = TMOD.Voids.from_finder(twvf)
    assert vw.finder == "zobov" and vw.device.type == "cpu"
    assert (vw.filter_sigma(float(b["halo_den"][0]))["radius"] > 0).all()


def test_svf_from_particles_matches_jax():
    """tests/test_voids3d.py's particle constructor: the grids agree to
    float32 sums, and the void is found at the carved centre in both."""
    from astrild_tpu.models.voids import SphericalVoidFinder3D as JSVF
    from astrild_tpu_torch.models.voids import SphericalVoidFinder3D as TSVF

    rng = np.random.default_rng(0)
    box = 48.0
    pos = rng.uniform(0, box, (20000, 3)).astype(np.float32)
    r = np.linalg.norm((pos - 24.5 + box / 2) % box - box / 2, axis=1)
    pos = pos[r > 9.0]
    a = JSVF.from_particles(jnp.asarray(pos), 48, box)
    b = TSVF.from_particles(pos, 48, box, device="cpu")
    assert b.delta.device.type == "cpu"
    assert_map_close(b.delta, a.delta, tol=1e-5)
    # a tuple of components paints the same grid
    c = TSVF.from_particles(tuple(T(pos[:, i]) for i in range(3)), 48, box)
    assert torch.equal(c.delta, b.delta)
    ca = a.find_voids(delta_threshold=-0.5, max_voids=16)
    cb = b.find_voids(delta_threshold=-0.5, max_voids=16)
    for cat in (ca, cb):
        found = np.array([cat["x"][0], cat["y"][0], cat["z"][0]])
        assert np.linalg.norm(found - 24.5) < 4.0
    npt.assert_allclose(cb["radius"][0], ca["radius"][0], rtol=1e-3)


# ----------------------------------------------------------------- voids
def test_voids_pipeline_matches_jax(tunnels):
    jf, tf = tunnels
    n = tf.skymap.npix
    jv = JMOD.Voids.from_finder(jf, {"npix": n})
    tv = TMOD.Voids.from_finder(tf, {"npix": n})
    assert tv.device == tf.skymap.device
    jv.trim_edges(n, extend=2.0)
    tv.trim_edges(n, extend=2.0)
    assert_columns_equal(tv.data, jv.data)
    a, b = jv.get_void_size_fct(nbins=8), tv.get_void_size_fct(nbins=8)
    assert list(b) == list(a)
    for s in a:
        npt.assert_array_equal(b[s]["counts"], a[s]["counts"])
        npt.assert_allclose(b[s]["rad"], a[s]["rad"])
    pa = jv.get_profiles(2.0, 8, skymap=jf.skymap.data["orig"],
                         field_conversion="normalize")
    pb = tv.get_profiles(2.0, 8, skymap=tf.skymap.data["orig"],
                         field_conversion="normalize")
    npt.assert_array_equal(pb["radii"], pa["radii"])
    assert_map_close(pb["values"], pa["values"])
    for conv in (None, "tangential_shear"):
        da = jv.get_profile_stats(n_boot=20, field_conversion=conv)
        db = tv.get_profile_stats(n_boot=20, field_conversion=conv)
        assert_map_close(db["mean"], da["mean"], tol=1e-5)
        npt.assert_array_equal(db["sigma"], da["sigma"])
        for k in ("size_min", "size_max", "nr_of_obj"):
            npt.assert_array_equal(db[k], da[k])
        assert np.all(db["lowerr"] <= db["higherr"])
    # the envelopes: the JAX draws of category 0 (PRNGKey(0)) through the
    # port's resampling give the JAX envelopes
    sel = np.where(tv.data["sigma"] == 0.0)[0]
    npix = 128
    nblk = 16
    key = jax.random.PRNGKey(0)
    drawn = jax.vmap(lambda k: jax.random.randint(
        k, (nblk * nblk,), 0, nblk * nblk))(jax.random.split(key, 20))
    centers = np.stack([tv.data["y_pix"].astype(np.int32)[sel],
                        tv.data["x_pix"].astype(np.int32)[sel]], axis=-1)
    lo, hi = TP.bootstrap_profiles_from_draws(
        T(pb["values"][sel]), T(centers), T(drawn), block_pix=npix // 16,
        npix=npix)
    jlo, jhi = JP.bootstrap_profiles(
        jnp.asarray(pa["values"][sel]), jnp.asarray(centers), key,
        n_boot=20, block_pix=npix // 16, npix=npix)
    assert_map_close(lo, jlo, tol=1e-5)
    assert_map_close(hi, jhi, tol=1e-5)


def test_voids_stats_saved(tunnels, tmp_path):
    pytest.importorskip("h5py")
    from astrild_tpu_torch.core import Dataset

    _, tf = tunnels
    tv = TMOD.Voids.from_finder(tf, {"npix": 128})
    tv.get_profiles(2.0, 6, skymap=tf.skymap.data["orig"])
    ds = tv.get_profile_stats(n_boot=5, dir_out=str(tmp_path), save=True)
    back = Dataset.from_hdf5(tmp_path / "tunnels_profiles.stats.h5")
    npt.assert_array_equal(back["mean"], ds["mean"])
    with pytest.raises(RuntimeError, match="get_profiles"):
        TMOD.Voids({"sigma": np.zeros(1)}).get_profile_stats()


def test_voids_selection_and_config_match_jax(rng):
    n, npix = 40, 128
    data = {"rad_deg": 10 ** rng.uniform(-1.5, 0.0, n),
            "rad_pix": rng.uniform(2, 6, n),
            "x_pix": rng.integers(20, npix - 20, n),
            "y_pix": rng.integers(20, npix - 20, n),
            "sigma": np.repeat([0.0, 1.0], n // 2),
            "halo_den": np.repeat([0.2, 0.5], n // 2),
            "void_overlap": np.repeat([0.0, 0.2], n // 2),
            "ray_nr": np.tile([3, 5], n // 2)}
    img = rng.normal(0.0, 1.0, (npix, npix)).astype(np.float32)
    for finder, cfg in (("zobov", "zobov_isw"), ("svf", "svf_isw"),
                        ("tunnels", "tunnels_isw")):
        jv = JMOD.Voids(dict(data), finder=finder)
        tv = TMOD.Voids(dict(data), finder=finder, device="cpu")
        pa = jv.apply_profile_config(cfg, skymap=img)
        pb = tv.apply_profile_config(cfg, skymap=img)
        assert_columns_equal(tv.data, jv.data)
        assert tv.field_conversion == jv.field_conversion
        npt.assert_array_equal(pb["radii"], pa["radii"])
        assert_map_close(pb["values"], pa["values"])
        for s in (0.2, 1.0, 0.0):
            assert_columns_equal(tv.filter_sigma(s), jv.filter_sigma(s))
        assert_columns_equal(tv.filter_snapshot(5), jv.filter_snapshot(5))
    with pytest.raises(ValueError):
        TMOD.Voids(dict(data), finder="svf").apply_profile_config("svf_isw")
    jv = JMOD.Voids(dict(data))
    tv = TMOD.Voids(dict(data))
    jv.categorize_sizes(bins=4, min_obj_nr=2)
    tv.categorize_sizes(bins=4, min_obj_nr=2)
    assert_columns_equal(tv.data, jv.data)
    cat = int(np.unique(tv.data["size_cat"])[0])
    assert_columns_equal(tv.filter_size(cat), jv.filter_size(cat))
    tracers = rng.uniform(0, npix, (500, 2))
    jv.select_type("minimal", tracers, {"field_width": float(npix)})
    tv.select_type("minimal", T(tracers), {"field_width": float(npix)})
    npt.assert_array_equal(tv.data["minimal"], jv.data["minimal"])
    with pytest.raises(KeyError):
        tv.select_type("minimal", tracers, {})


# ----------------------------------------------- examples/full_pipeline.py
def _example():
    spec = importlib.util.spec_from_file_location(
        "full_pipeline_example", ROOT / "examples" / "full_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_pipeline_stages_1_to_4_match_jax():
    """examples/full_pipeline.py stages 1-4 at 32^3 particles on 64^3
    grids (the example: 64^3 on 128^3), its box, slabs and void stage, in
    both packages, each stage from the same input: the JAX package's
    particles for stages 1-3, its Born map for stage 4."""
    from astrild_tpu import Cosmology as JCosmo
    from astrild_tpu.ops import lensing as JL
    from astrild_tpu.ops import paint as JPa
    from astrild_tpu.ops import power as JPw
    from astrild_tpu_torch import Cosmology as TCosmo
    from astrild_tpu_torch.ops import lensing as TL
    from astrild_tpu_torch.ops import paint as TPa
    from astrild_tpu_torch.ops import power as TPw

    ex = _example()
    box, ngrid, n_part, n_sims = ex.BOX, 64, 32 ** 3, ex.N_SIMS
    keys = jax.random.split(jax.random.PRNGKey(0), n_sims)
    pos_batch = np.stack([np.asarray(ex.synthetic_particles(k, n_part))
                          for k in keys])

    # ---- 1. collection P(k): TSC paint and auto_power per realization
    def jpk(pos):
        g = JPa.paint(pos, ngrid, box, window="tsc")
        return JPw.auto_power(g, box, nbins=32, window="tsc",
                              shotnoise=box ** 3 / n_part)

    jres = jax.vmap(jpk)(jnp.asarray(pos_batch))
    for i in range(n_sims):
        g = TPa.paint(T(pos_batch[i]), ngrid, box, window="tsc")
        res = TPw.auto_power(g, box, nbins=32, window="tsc",
                             shotnoise=box ** 3 / n_part)
        npt.assert_allclose(N(res.k), np.asarray(jres.k[i]), rtol=1e-6)
        npt.assert_allclose(N(res.power), np.asarray(jres.power[i]),
                            rtol=2e-4)

    # ---- 2. bispectrum of realization 0's CIC grid
    jg = JPa.paint(jnp.asarray(pos_batch[0]), ngrid, box, window="cic")
    tg = TPa.paint(T(pos_batch[0]), ngrid, box, window="cic")
    assert_map_close(tg, jg, tol=1e-5)
    jbs = JMOD.Bispectrum3D.compute(jg, box, nbins=4)
    tbs = TMOD.Bispectrum3D.compute(tg, box, nbins=4)
    for k in jbs:
        fin = np.isfinite(jbs[k])
        npt.assert_array_equal(np.isfinite(tbs[k]), fin)
        npt.assert_allclose(tbs[k][fin], jbs[k][fin], rtol=1e-3,
                            atol=1e-6 * np.abs(jbs[k][fin]).max())

    # ---- 3. Born kappa of the first 32 z-slabs
    def born(L, g, xp, transpose, cosmo):
        delta = g / xp.mean(g) - 1.0
        planes = transpose(delta)[:32]
        chis = xp.linspace(100.0, 1500.0, 32)
        dchis = xp.full((32,), box / ngrid)
        return L.born_convergence(planes, chis, dchis, 2000.0, cosmo.Om0)

    jk = born(JL, jg, jnp, lambda d: jnp.transpose(d, (2, 0, 1)), JCosmo())
    tk = born(TL, tg, torch, lambda d: d.permute(2, 0, 1), TCosmo())
    assert_map_close(tk, jk, tol=1e-4)

    # ---- 4. the void pipeline on the JAX Born map
    kappa = np.asarray(jk)
    out = {}
    for pkg, sky in (("jax", JMOD.SkyArray.from_array(kappa, 5.0,
                                                      "kappa_2")),
                     ("torch", TMOD.SkyArray.from_array(kappa, 5.0,
                                                        "kappa_2",
                                                        device="cpu"))):
        mods = JMOD if pkg == "jax" else TMOD
        sky.smoothing(2.0)
        finder = mods.TunnelsFinder(sky)
        finder.find_peaks(on="orig_smooth")
        finder.find_voids(sigmas=[0.0])
        voids = mods.Voids.from_finder(finder, {"npix": sky.npix})
        voids.trim_edges(sky.npix)
        prof = voids.get_profiles(2.0, 10, skymap=sky.data["orig"])
        ds = voids.get_profile_stats(n_boot=30)
        out[pkg] = (sky, finder, voids, prof, ds)
    (js, jf, jv, jp, jd), (ts, tf, tv, tp, td) = out["jax"], out["torch"]
    assert_map_close(ts.data["orig_smooth"], js.data["orig_smooth"])
    assert len(jv.data["rad_pix"]) > 0
    assert_columns_equal(tf.voids, jf.voids)
    assert_columns_equal(tv.data, jv.data)
    assert_map_close(tp["values"], jp["values"])
    assert_map_close(td["mean"], jd["mean"], tol=1e-5)
    assert np.all(td["lowerr"] <= td["higherr"])


def test_new_modules_import_without_jax_yaml_h5py_sklearn():
    """The slice's modules (and the moving-lens, SZ and ISW modules, the
    file layer, the collection, the containers, observability, the native
    bridge and the visual layer after them) import no JAX, no module of
    the JAX package and none of PyYAML, h5py, sklearn or scipy: those load
    inside the functions that need them."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import astrild_tpu_torch.models, astrild_tpu_torch.core\n"
        "from astrild_tpu_torch.ops import (filters, profiles, troughs,\n"
        "    minkowski, aperture_mass, map_transform, object_selection)\n"
        "from astrild_tpu_torch.io import rockstar\n"
        "from astrild_tpu_torch.ops import (lensing, sz, strong_lensing,\n"
        "    bispectrum, angular_power, linear_power)\n"
        "from astrild_tpu_torch.models import (Dipoles, Bispectrum2D,\n"
        "    LinearPowerSpectrum, LinearAngularPowerSpectrum)\n"
        "from astrild_tpu_torch.io import (ramses, binary_formats, mmf,\n"
        "    save, rays)\n"
        "from astrild_tpu_torch.models import simcoll, SimulationCollection\n"
        "from astrild_tpu_torch.core import grid, catalog, manifest\n"
        "from astrild_tpu_torch.utils import observability\n"
        "from astrild_tpu_torch import native, visual\n"
        "from astrild_tpu_torch.visual import figures, maps\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'astrild_tpu', 'yaml', 'h5py', 'sklearn', 'scipy')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
