"""The port's core containers and artifact store (astrild_tpu_torch.core:
grid, catalog, manifest; checkpoint of the containers) against the JAX
package's on the CPU, and tests/test_e2e_filedriven.py's four file-driven
workflows run in both packages.

Containers hold float32 values exactly as jnp.asarray makes them (x64
off); content hashes and stored artifacts are shared across packages, so
either package's stage is fresh for the other; checkpoints of the
containers restore across packages bit for bit.
"""
import os

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.core import Catalog as JCatalog  # noqa: E402
from astrild_tpu.core import Grid3D as JGrid3D  # noqa: E402
from astrild_tpu.core import SkyGrid as JSkyGrid  # noqa: E402
from astrild_tpu.core import checkpoint as jck  # noqa: E402
from astrild_tpu.core import manifest as jman  # noqa: E402
from astrild_tpu.core.dataset import Dataset as JDataset  # noqa: E402
import astrild_tpu.models as JMOD  # noqa: E402
from astrild_tpu.ops import angular_power as jap  # noqa: E402

from astrild_tpu_torch.core import Catalog, Grid3D, SkyGrid  # noqa: E402
from astrild_tpu_torch.core import checkpoint as ck  # noqa: E402
from astrild_tpu_torch.core import manifest as man  # noqa: E402
from astrild_tpu_torch.core.dataset import Dataset  # noqa: E402
from astrild_tpu_torch.io import columnar_h5 as tcol  # noqa: E402
import astrild_tpu_torch.models as TMOD  # noqa: E402
from astrild_tpu_torch.ops import angular_power as tap  # noqa: E402
from astrild_tpu_torch.utils.constants import C_LIGHT_KMS  # noqa: E402


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


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _columns(rng):
    return {"m": 10 ** rng.uniform(12, 15, 9),                  # float64
            "x": rng.uniform(0, 100, 9).astype(np.float32),
            "id": np.arange(9, dtype=np.int64) * 1000003,
            "host": np.arange(9, dtype=np.int32) - 4,
            "flag": rng.uniform(size=9) < 0.5,
            "nsub": rng.integers(0, 200, 9).astype(np.uint8),
            "e": rng.standard_normal((9, 2)),                    # 2-D
            "c": rng.standard_normal(9) + 1j * rng.standard_normal(9)}


# ------------------------------------------------------------- catalog
def test_catalog_dtypes_and_values_match_jnp_asarray(rng):
    cols = _columns(rng)
    cat = Catalog.from_dict(cols, device="cpu")
    jcat = JCatalog.from_dict(cols)
    assert cat.names == jcat.names and len(cat) == len(jcat) == 9
    for k in cols:
        assert _dtype_name(cat[k]) == str(jcat[k].dtype), k
        npt.assert_array_equal(cat[k].numpy(), np.asarray(jcat[k]))
    assert "m" in cat and "nope" not in cat
    # with_column takes jnp.asarray's dtype too, and leaves the original
    cat2 = cat.with_column("r", np.linspace(0, 1, 9), device="cpu")
    assert "r" in cat2 and "r" not in cat
    assert _dtype_name(cat2["r"]) == str(
        jcat.with_column("r", np.linspace(0, 1, 9))["r"].dtype)


def test_catalog_select_positions_and_frames(rng):
    pd = pytest.importorskip("pandas")
    cols = {k: rng.uniform(0, 100, 12) for k in ("x", "y", "z", "m")}
    cols["e"] = rng.standard_normal((12, 3))
    cat, jcat = Catalog.from_dict(cols, device="cpu"), JCatalog.from_dict(cols)
    mask = cols["m"] > 50
    idx = np.array([3, 0, 7])
    for sel in (mask, idx):
        a, b = cat.select(sel), jcat.select(sel)
        for k in cols:
            npt.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    a = cat.select(torch.from_numpy(mask))
    npt.assert_array_equal(a["m"].numpy(), np.asarray(jcat.select(mask)["m"]))
    npt.assert_array_equal(cat.positions().numpy(),
                           np.asarray(jcat.positions()))
    npt.assert_array_equal(cat.positions(("m", "x")).numpy(),
                           np.asarray(jcat.positions(("m", "x"))))
    df, jdf = cat.to_dataframe(), jcat.to_dataframe()
    assert list(df.columns) == list(jdf.columns)
    assert "e_2" in df.columns
    pd.testing.assert_frame_equal(df, jdf)
    back, jback = (Catalog.from_dataframe(jdf, device="cpu"),
                   JCatalog.from_dataframe(df))
    for k in back.names:
        assert _dtype_name(back[k]) == str(jback[k].dtype)
        npt.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


# ---------------------------------------------------------------- grids
def test_grid3d_matches_jax(rng):
    counts = rng.poisson(3.0, (16, 16, 16)).astype(np.float32)
    g, jg = Grid3D(torch.from_numpy(counts), 200.0), JGrid3D(
        jnp.asarray(counts), 200.0)
    assert g.ngrid == jg.ngrid == 16 and g.cell_size == jg.cell_size == 12.5
    # integer counts: the mean is exact in both, so the contrast is too
    dc, jdc = g.density_contrast(), jg.density_contrast()
    assert dc.boxsize == 200.0 and dc.values.dtype == torch.float32
    npt.assert_array_equal(dc.values.numpy(), np.asarray(jdc.values))
    vals = rng.lognormal(size=(8, 8, 8)).astype(np.float32)
    npt.assert_allclose(
        Grid3D(torch.from_numpy(vals), 1.0).density_contrast().values.numpy(),
        np.asarray(JGrid3D(jnp.asarray(vals), 1.0).density_contrast().values),
        rtol=0, atol=4e-7 * np.abs(vals / vals.mean()).max())
    # an empty grid divides by 1, as the JAX package's
    z = Grid3D(torch.zeros(4, 4, 4), 1.0).density_contrast().values
    npt.assert_array_equal(z.numpy(), np.asarray(
        JGrid3D(jnp.zeros((4, 4, 4)), 1.0).density_contrast().values))
    with pytest.raises(Exception):
        g.boxsize = 1.0  # frozen


def test_skygrid_matches_jax():
    sky = SkyGrid({"orig": torch.zeros(60, 60)}, opening_angle=10.0,
                  quantity="kappa_2")
    jsky = JSkyGrid({"orig": jnp.zeros((60, 60))}, opening_angle=10.0,
                    quantity="kappa_2")
    assert sky.npix == jsky.npix == 60
    assert sky.pixel_arcmin == jsky.pixel_arcmin == 10.0
    sky2 = sky.with_layer("filtered", torch.ones(60, 60))
    assert "filtered" in sky2.data and "filtered" not in sky.data
    assert sky2.quantity == "kappa_2" and sky2.opening_angle == 10.0
    npt.assert_array_equal(sky2.layer("filtered").numpy(), 1.0)
    assert sky2.layer() is sky.layer()


# ----------------------------------------------------------- checkpoints
def _containers(rng, mod_cat, mod_grid, mod_sky, asarray):
    cols = {"m": rng.uniform(size=5).astype(np.float32),
            "id": np.arange(5, dtype=np.int32), "e": np.ones((5, 2),
                                                             np.float32)}
    grid = rng.standard_normal((4, 4, 4)).astype(np.float32)
    layers = {"orig": rng.standard_normal((6, 6)).astype(np.float32),
              "filtered": rng.standard_normal((6, 6)).astype(np.float32)}
    return {"cat": mod_cat({k: asarray(v) for k, v in cols.items()}),
            "grid": mod_grid(asarray(grid), 250.0),
            "sky": mod_sky({k: asarray(v) for k, v in layers.items()}, 5.0,
                           "kappa_2"),
            "step": asarray(np.float32(3.5))}


def test_container_checkpoints_cross_packages(tmp_path, monkeypatch):
    """A checkpoint of a Catalog / Grid3D / SkyGrid written by either
    package restores in the other, leaf for leaf, in the JAX package's
    pytree order (sorted names; a grid's values)."""
    monkeypatch.setattr(jck, "have_orbax", lambda: False)
    jstate = _containers(np.random.default_rng(1), JCatalog, JGrid3D,
                         JSkyGrid, jnp.asarray)
    tstate = _containers(np.random.default_rng(1), Catalog, Grid3D,
                         SkyGrid, lambda v: torch.from_numpy(np.asarray(v)))
    import jax

    jleaves = jax.tree_util.tree_leaves(jstate)
    tleaves = ck._flatten(tstate)
    assert len(jleaves) == len(tleaves) == 7
    for a, b in zip(jleaves, tleaves):
        npt.assert_array_equal(np.asarray(a), b.numpy())
    jck.save_state(tmp_path / "j", jstate, step=4)
    got, step = ck.restore_state(tmp_path / "j", tstate, with_step=True)
    assert step == 4
    assert isinstance(got["cat"], Catalog) and isinstance(got["grid"], Grid3D)
    assert got["grid"].boxsize == 250.0 and got["sky"].opening_angle == 5.0
    for a, b in zip(ck._flatten(got), tleaves):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    ck.save_state(tmp_path / "t", tstate, step=2)
    back = jck.restore_state(tmp_path / "t", jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), tleaves):
        npt.assert_array_equal(np.asarray(a), b.numpy())
    assert isinstance(back["sky"], JSkyGrid)


# ------------------------------------------------------------- manifest
def test_content_hash_matches_jax(rng):
    a = rng.standard_normal(10).astype(np.float32)
    objs = [{"x": np.arange(10.0), "p": 3}, [1, 2.5, None, "s", True],
            {"nested": {"b": np.ones((2, 3), np.int32), "a": (1, "x")}}]
    for o in objs:
        assert man.content_hash(o) == jman.content_hash(o)
    # a tensor hashes as its host numpy form: as the same jax array does
    assert man.content_hash({"a": torch.from_numpy(a)}) == jman.content_hash(
        {"a": jnp.asarray(a)})
    assert man.content_hash(torch.arange(4, dtype=torch.int32)) \
        == jman.content_hash(jnp.arange(4, dtype=jnp.int32))
    assert man.content_hash({"x": np.arange(10.0), "p": 3}) != \
        man.content_hash({"x": np.arange(10.0), "p": 4})


def test_artifact_store_shared_across_packages(tmp_path):
    """One store directory: a stage either package computed is fresh for
    the other, loads to the same arrays, and verifies; the manifest is
    the JAX package's."""
    inputs = {"seed": 1, "n": 100}
    store = man.ArtifactStore(str(tmp_path))
    assert not store.fresh("pk", inputs)
    store.save("pk", {"k": torch.arange(5.0), "p": np.ones(5)}, inputs,
               meta={"who": "torch"})
    jstore = jman.ArtifactStore(str(tmp_path))
    assert jstore.fresh("pk", inputs) and not jstore.fresh("pk", {"seed": 2})
    assert jstore.verify("pk")
    jload = jstore.load("pk")
    tload = man.ArtifactStore(str(tmp_path)).load("pk")
    for k in ("k", "p"):
        npt.assert_array_equal(tload[k], jload[k])
    # to_device: the JAX package's device dtypes
    dev = store.load("pk", to_device=True, device="cpu")
    jdev = jstore.load("pk", to_device=True)
    for k in dev:
        assert _dtype_name(dev[k]) == str(jdev[k].dtype)
        npt.assert_array_equal(dev[k].numpy(), np.asarray(jdev[k]))
    # memoization across packages, both ways
    calls = []

    def compute(tag):
        def fn():
            calls.append(tag)
            return {"v": torch.ones(3) if tag == "torch" else jnp.ones(3)}
        return fn

    # (a store reads manifest.json when it opens, so each stage below
    # opens the directory afresh, as a later run would)
    def tstore():
        return man.ArtifactStore(str(tmp_path))

    def jstore_():
        return jman.ArtifactStore(str(tmp_path))

    out1 = tstore().stage("s", {"a": 1}, compute("torch"))
    out2 = jstore_().stage("s", {"a": 1}, compute("jax"))
    assert calls == ["torch"]
    npt.assert_array_equal(out1["v"], out2["v"])
    jstore_().stage("s2", {"a": 2}, compute("jax"))
    tstore().stage("s2", {"a": 2}, compute("torch"))
    assert calls == ["torch", "jax"]
    tstore().stage("s", {"a": 3}, compute("torch"))
    assert calls == ["torch", "jax", "torch"]
    entry = jman.ArtifactStore(str(tmp_path)).manifest["pk"]
    assert entry["meta"] == {"who": "torch"} and entry["file"] == "pk.h5"


def test_artifact_store_roundtrip_and_freshness(tmp_path):
    """tests/test_manifest_pallas.py's store tests in the port."""
    store = man.ArtifactStore(str(tmp_path))
    inputs = {"seed": 1, "n": 100}
    store.save("pk", {"k": np.arange(5.0), "p": np.ones(5)}, inputs)
    assert store.fresh("pk", inputs)
    npt.assert_allclose(store.load("pk")["k"], np.arange(5.0))
    assert store.verify("pk")
    assert man.ArtifactStore(str(tmp_path)).fresh("pk", inputs)
    os.remove(tmp_path / "pk.h5")
    assert not store.fresh("pk", inputs)
    calls = []
    for a in (1, 1, 2):
        store.stage("s", {"a": a},
                    lambda: calls.append(1) or {"v": torch.ones(3)})
    assert len(calls) == 2


# ------------------------------------------- test_e2e_filedriven, both ways
@pytest.fixture
def ray_file(tmp_path, rng):
    """A Ray-Ramses-style map file: code units, shuffled ray ids."""
    npix = 128
    e = np.arange(npix)
    kappa = rng.normal(0, 0.01, (npix, npix))
    for (r, c) in [(30, 40), (90, 100), (64, 20)]:
        kappa += 0.08 * np.exp(-((e[:, None] - r) ** 2
                                 + (e[None, :] - c) ** 2) / (2 * 3.0 ** 2))
    ids = np.arange(npix * npix)
    perm = rng.permutation(npix * npix)
    path = str(tmp_path / "Ray_maps_output00005.h5")
    tcol.write_table(path, {
        "id": ids[perm].astype(np.float64),
        "kappa_2": (kappa.reshape(-1) * C_LIGHT_KMS ** 2)[perm],
    })
    return path, kappa


def _map_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def test_skymap_file_to_voids(ray_file, tmp_path):
    path, kappa_true = ray_file
    res = {}
    for pkg, mod in (("jax", JMOD), ("torch", TMOD)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        sky = mod.SkyMap.from_file(128, 10.0, "kappa_2", str(tmp_path), path,
                                   **kw)
        sky.smoothing(5.0)
        finder = mod.TunnelsFinder(sky)
        finder.find_peaks(on="orig_smooth", edge_pix=2)
        finder.find_voids(sigmas=[0.0])
        voids = mod.Voids.from_finder(finder, {"npix": sky.npix})
        voids.trim_edges(sky.npix)
        voids.get_profiles(2.0, 8, skymap=sky.data["orig"])
        ds = voids.get_profile_stats(n_boot=10)
        out = str(tmp_path / f"stats_{pkg}")
        os.makedirs(out, exist_ok=True)
        ds.to_hdf5(os.path.join(out, "profiles.h5"))
        res[pkg] = (sky, voids, ds)
    (jsky, jvoids, jds), (tsky, tvoids, tds) = res["jax"], res["torch"]
    npt.assert_allclose(tsky.data["orig"].numpy(), kappa_true, rtol=1e-5,
                        atol=1e-9)
    _map_close(tsky.data["orig"].numpy(), jsky.data["orig"], 1e-6)
    assert len(tvoids.data["rad_pix"]) == len(jvoids.data["rad_pix"]) > 0
    npt.assert_array_equal(tvoids.data["rad_pix"], jvoids.data["rad_pix"])
    _map_close(tds["mean"], jds["mean"], 1e-5)
    # each package's persisted stats reload in the other
    back = Dataset.from_hdf5(str(tmp_path / "stats_jax" / "profiles.h5"))
    jback = JDataset.from_hdf5(str(tmp_path / "stats_torch" / "profiles.h5"))
    npt.assert_allclose(back["mean"], jds["mean"])
    npt.assert_allclose(jback["mean"], tds["mean"])


@pytest.fixture
def snapshot_files(tmp_path, rng):
    """Point-set h5 files per snapshot (the PowerSpectrum3D.compute input)."""
    box = 100.0
    for snap in (3, 4):
        centers = rng.uniform(0, box, (30, 3))
        pts = np.mod(centers[:, None, :] + rng.normal(0, 1.5, (30, 300, 3)),
                     box).reshape(-1, 3)
        tcol.write_table(
            str(tmp_path / f"grav_out_0000{snap}.h5"),
            {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    return str(tmp_path), box


def _ps(pkg, path):
    if pkg == "torch":
        sim = TMOD.Simulation(path, None, {"root": "grav_out",
                                           "extension": "h5"})
        return TMOD.PowerSpectrum3D("particles", sim, device="cpu")
    sim = JMOD.Simulation(path, None, {"root": "grav_out", "extension": "h5"})
    return JMOD.PowerSpectrum3D("particles", sim)


def test_power_spectrum_compute_filedriven(snapshot_files, tmp_path):
    path, box = snapshot_files
    out = {pkg: _ps(pkg, path).compute(
        ["density"], [{"path": path, "root": "grav_out", "extension": "h5"}],
        dir_out=str(tmp_path / f"pk_{pkg}"), save=True, boxsize=box,
        ngrid=32) for pkg in ("jax", "torch")}
    got, want = out["torch"], out["jax"]
    assert set(got["P"]) == set(want["P"]) == {"snap_3", "snap_4"}
    assert got["P"]["snap_3"][1] > 0  # clustered: strong large-scale power
    for snap in got["P"]:
        npt.assert_allclose(got["P"][snap], want["P"][snap], rtol=1e-5)
    saved = tcol.read_table(str(tmp_path / "pk_torch" / "pk_density.h5"))
    npt.assert_array_equal(saved["snap_3"], got["P"]["snap_3"])


def test_power_spectrum_compute_cross(snapshot_files, tmp_path):
    """compute() with two file_dscs is the cross spectrum in both
    packages: a field with itself tracks the auto spectrum, an
    independent Poisson field decorrelates."""
    path, box = snapshot_files
    rng = np.random.default_rng(5)
    for snap in (3, 4):
        pts = rng.uniform(0, box, (9000, 3))
        tcol.write_table(str(tmp_path / f"rand_out_0000{snap}.h5"),
                         {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    dsc_a = {"path": path, "root": "grav_out", "extension": "h5"}
    dsc_r = {"path": str(tmp_path), "root": "rand_out", "extension": "h5"}
    res = {}
    for pkg in ("jax", "torch"):
        res[pkg] = [_ps(pkg, path).compute(["density"], d, save=False,
                                           boxsize=box, ngrid=32)["P"]
                    ["snap_3"] for d in ([dsc_a], [dsc_a, dsc_a],
                                         [dsc_a, dsc_r])]
    pa, paa, par = res["torch"]
    assert paa[1] > 0.5 * pa[1]
    assert abs(par[1]) < 0.2 * paa[1]
    for got, want in zip(res["torch"], res["jax"]):
        npt.assert_allclose(got, want, rtol=1e-5,
                            atol=1e-5 * np.abs(res["jax"][0]).max())


def test_artifact_staged_pipeline(ray_file, tmp_path):
    """Manifest-memoized pipeline stage over a file artifact: the port
    computes it once, the JAX package finds it fresh, and its own compute
    gives the same C_ell."""
    path, _ = ray_file
    store = man.ArtifactStore(str(tmp_path / "artifacts"))
    calls = []

    def compute():
        calls.append(1)
        sky = TMOD.SkyMap.from_file(128, 10.0, "kappa_2", "", path,
                                    device="cpu")
        ell, cl = tap.cl_flat_sky(sky.data["orig"], 10.0, nbins=8)
        return {"ell": ell, "cl": cl}

    inputs = {"file": path, "nbins": 8}
    out1 = store.stage("cl_map5", inputs, compute)
    out2 = store.stage("cl_map5", inputs, compute)
    assert len(calls) == 1
    npt.assert_allclose(out1["cl"], out2["cl"])
    assert store.verify("cl_map5")
    jstore = jman.ArtifactStore(str(tmp_path / "artifacts"))
    assert jstore.fresh("cl_map5", inputs)
    jsky = JMOD.SkyMap.from_file(128, 10.0, "kappa_2", "", path)
    jell, jcl = jap.cl_flat_sky(jsky.data["orig"], 10.0, nbins=8)
    npt.assert_allclose(out1["ell"], np.asarray(jell), rtol=1e-6)
    npt.assert_allclose(out1["cl"], np.asarray(jcl), rtol=1e-4)
