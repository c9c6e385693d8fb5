"""SimulationCollection (astrild_tpu_torch.models.simcoll) against the JAX
package's on the CPU: construction from the YAML registry and the
snapshot-info table, stat and histogram compression, lightcone ray sums,
the source-plane shift, the device batch; RayRamses.sum_snapshots'
selection; and examples/generate_snapshot_info.py's round trip in the port.

Tables, selections and sums are host numpy in both packages and equal
exactly; the redshift shift reads each package's own distance table (the
port's in float64, the JAX package's in float32) and agrees to 1e-5.
"""
import os

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")
yaml = pytest.importorskip("yaml")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.core.dataset import Dataset as JDataset  # noqa: E402
from astrild_tpu.io import columnar_h5 as jcol  # noqa: E402
from astrild_tpu.models import Ecosmog as JEcosmog  # noqa: E402
from astrild_tpu.models import RayRamses as JRayRamses  # noqa: E402
from astrild_tpu.models import SimulationCollection as JColl  # noqa: E402
from astrild_tpu.models import write_snapshot_info as jwrite_info  # noqa: E402

from astrild_tpu_torch.core.dataset import Dataset  # noqa: E402
from astrild_tpu_torch.io import columnar_h5 as tcol  # noqa: E402
from astrild_tpu_torch.models import (Ecosmog, RayRamses,  # noqa: E402
                                      SimulationCollection,
                                      snapshot_info_table,
                                      write_snapshot_info)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def collection(tmp_path):
    """tests/test_simcoll.py's fixture: two simulations with
    snapshot-info + per-sim stat files and ray map files."""
    sims = {}
    for b in (1, 2):
        d = tmp_path / f"box{b}"
        d.mkdir()
        sims[f"box{b}"] = {
            "type": "particles",
            "init": {"dir_sim": str(d) + "/", "boxsize": 100.0,
                     "domain_level": 64},
        }
        jcol.write_table(
            str(d / "halo_mass_fct.h5"),
            {"bin": np.logspace(12, 14, 5),
             "snap_1": np.full(5, 10.0 * b),
             "snap_2": np.full(5, 20.0 * b)})
        for ray in (1, 2):
            jcol.write_table(
                str(d / f"Ray_maps_output0000{ray}.h5"),
                {"kappa_2": np.full(4, float(b * ray)),
                 "isw_rs": np.full(4, 0.1 * b * ray)})
        sims[f"box{b}"]["init"]["file_dsc"] = {"root": "Ray_maps_output",
                                               "extension": "h5"}
    cfg_yaml = tmp_path / "coll.yaml"
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump(sims, f)
    cfg_h5 = tmp_path / "info.h5"
    jwrite_info(str(cfg_h5), {1: [1.0, 0.5], 2: [1.0, 0.5]})
    return str(cfg_yaml), str(cfg_h5)


def _both(collection):
    return (SimulationCollection.from_file(*collection),
            JColl.from_file(*collection))


def _assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        npt.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_from_file_builds_sims(collection):
    coll, jcoll = _both(collection)
    assert list(coll.sim) == list(jcoll.sim) == ["box1", "box2"]
    assert all(isinstance(s, Ecosmog) for s in coll.sim.values())
    npt.assert_array_equal(coll.sim_nrs, jcoll.sim_nrs)
    assert coll.sim["box1"].boxsize == 100.0
    _assert_dicts_equal(coll.config, jcoll.config)
    for nr in (1, 2):
        _assert_dicts_equal(coll._config_rows(coll.config, nr),
                            jcoll._config_rows(jcoll.config, nr))
    npt.assert_array_equal(coll._find_common_z(), jcoll._find_common_z())


def test_from_file_rays_type_and_unknown_type(tmp_path, collection):
    _, cfg_h5 = collection
    reg = {"lc1": {"type": "rays",
                   "init": {"dir_sim": str(tmp_path / "box1"),
                            "file_dsc": {"root": "Ray_maps_output",
                                         "extension": "h5"},
                            "opening_angle": 10.0, "npix": 64}}}
    p = tmp_path / "rays.yaml"
    p.write_text(yaml.safe_dump(reg))
    coll = SimulationCollection.from_file(str(p), cfg_h5)
    jcoll = JColl.from_file(str(p), cfg_h5)
    assert isinstance(coll.sim["lc1"], RayRamses)
    assert coll.sim["lc1"].npix == jcoll.sim["lc1"].npix == 64
    npt.assert_array_equal(coll.sim["lc1"].file_nrs,
                           jcoll.sim["lc1"].file_nrs)
    reg["lc1"]["type"] = "maps"
    p.write_text(yaml.safe_dump(reg))
    with pytest.raises(ValueError, match="unknown simulation type"):
        SimulationCollection.from_file(str(p), cfg_h5)


@pytest.mark.parametrize("kw", [{"z_nrs": [1.0, 0.5]}, {"a_nrs": [0.5]},
                                {"zmatch": True}])
def test_compress_stats(collection, tmp_path, kw):
    coll, jcoll = _both(collection)
    dsc = {"root": "halo_mass_fct", "extension": "h5"}
    ds = coll.compress_stats(dsc, str(tmp_path / "t"), **kw)
    jds = jcoll.compress_stats(dsc, str(tmp_path / "j"), **kw)
    npt.assert_array_equal(ds["value"], jds["value"])
    for c in ("box", "redshift", "bin", "snapshot"):
        npt.assert_array_equal(ds.coords[c][-1] if isinstance(
            ds.coords[c], tuple) else ds.coords[c], jds.coords[c][-1]
            if isinstance(jds.coords[c], tuple) else jds.coords[c])
    if "z_nrs" in kw:
        # box 1 snap_1 (z=1.0) -> 10 ; box 2 snap_2 (z=0.5) -> 40
        npt.assert_allclose(ds["value"][0, 0], 10.0)
        npt.assert_allclose(ds["value"][1, 1], 40.0)
    # each package's persisted Dataset reloads in the other
    back = Dataset.from_hdf5(str(tmp_path / "j" / "halo_mass_fct.stats.h5"))
    jback = JDataset.from_hdf5(str(tmp_path / "t" / "halo_mass_fct.stats.h5"))
    npt.assert_array_equal(back["value"], jback["value"])


def test_compress_histograms(tmp_path):
    """tests/test_facade_surface.py::test_simcoll_compress_histograms in
    both packages."""
    out = {}
    for pkg, eco, coll_cls in (("jax", JEcosmog, JColl),
                               ("torch", Ecosmog, SimulationCollection)):
        sims = {}
        for i, name in enumerate(["boxA", "boxB"]):
            d = tmp_path / pkg / name
            d.mkdir(parents=True)
            jcol.write_table(str(d / "hist.h5"),
                             {"bin": np.arange(4.0),
                              "m200c": np.full(4, float(i + 1)),
                              "r200c": np.arange(4.0) * (i + 1)})
            sims[name] = eco(dir_sim=str(d), boxsize=100.0)
        coll = coll_cls({}, sims)
        out[pkg] = coll.compress_histograms(
            {"root": "hist", "extension": "h5"}, str(tmp_path / pkg / "out"))
    ds, jds = out["torch"], out["jax"]
    assert ds["count"].shape == (2, 2, 4)
    npt.assert_array_equal(ds["count"], jds["count"])
    npt.assert_array_equal(ds.coords["property"], jds.coords["property"])
    npt.assert_allclose(ds["count"][1, 0], 2.0)
    assert os.path.exists(str(tmp_path / "torch" / "out" / "hist.stats.h5"))


@pytest.mark.parametrize("kw", [
    {"integration_range": {"box": [1, 2], "ray": [], "z": None}},
    {},  # box [0] (the default): the whole lightcone
    {"integration_range": {"box": [2], "ray": [], "z": None}},
    {"integration_range": {"box": [], "ray": [2], "z": None}},
    {"integration_range": {"box": [], "ray": [], "z": [0.6, 1.2]}},
    {"rm_ray": {1: [2]}},
    {"columns": ("kappa_2", "isw_rs"), "z_src": 1.0, "z_src_shift": 2.0},
])
def test_sum_raytracing_snapshots(collection, kw):
    coll, jcoll = _both(collection)
    cols = kw.get("columns", ("kappa_2",))
    total = coll.sum_raytracing_snapshots(**{"columns": cols, **kw})
    want = jcoll.sum_raytracing_snapshots(**{"columns": cols, **kw})
    assert total is not None and sorted(total) == sorted(cols)
    if "z_src_shift" in kw:
        for c in cols:
            npt.assert_allclose(total[c], want[c], rtol=1e-5)
    else:
        _assert_dicts_equal(total, want)
    if not kw:
        # sum over boxes and rays: (1*1 + 1*2) + (2*1 + 2*2) = 9
        npt.assert_allclose(total["kappa_2"], 9.0)


def test_sum_raytracing_exact_ray_file_match(collection, tmp_path):
    """A ray number matches the file whose trailing number is exactly it
    (ray 1 must not also pick Ray_maps_output00011.h5), and save writes the
    sum under the table's redshift range."""
    coll, jcoll = _both(collection)
    for b in (1, 2):
        jcol.write_table(str(tmp_path / f"box{b}" / "Ray_maps_output00011.h5"),
                         {"kappa_2": np.full(4, 1000.0)})
    rng = {"box": [1, 2], "ray": [], "z": None}
    total = coll.sum_raytracing_snapshots(
        dir_out=str(tmp_path / "t"), integration_range=rng, save=True)
    want = jcoll.sum_raytracing_snapshots(
        dir_out=str(tmp_path / "j"), integration_range=rng, save=True)
    _assert_dicts_equal(total, want)
    npt.assert_allclose(total["kappa_2"], 9.0)
    name = "Ray_maps_zrange_0.50_1.00.h5"
    _assert_dicts_equal(jcol.read_table(str(tmp_path / "t" / name)),
                        tcol.read_table(str(tmp_path / "j" / name)))


def test_box_and_ray_nrs_and_boxnr(collection):
    coll, jcoll = _both(collection)
    for rng, rm in (({"box": [0]}, None), ({"box": [2]}, {2: [1]}),
                    ({"ray": [1, 2]}, None), ({"z": [0.4, 0.6]}, None)):
        assert coll._box_and_ray_nrs(rng, rm) == jcoll._box_and_ray_nrs(rng,
                                                                         rm)
    for name in ("box7", 3, "lc12_a"):
        assert (SimulationCollection._boxnr_from_simname(name)
                == JColl._boxnr_from_simname(name))


def test_translate_redshift_kernel_ratio(collection):
    coll, jcoll = _both(collection)
    q = np.linspace(0.5, 1.5, 4)
    out = coll._translate_redshift(q, z_near=0.4, z_far=0.5, z_src=1.0,
                                   z_src_shift=2.0)
    want = jcoll._translate_redshift(q, z_near=0.4, z_far=0.5, z_src=1.0,
                                     z_src_shift=2.0)
    npt.assert_allclose(out, want, rtol=1e-5)
    chi = coll.cosmo.comoving_distance
    x_mid = 0.5 * (float(chi(0.4)) + float(chi(0.5)))
    ratio = (coll._kernel_function(x_mid, float(chi(2.0)))
             / coll._kernel_function(x_mid, float(chi(1.0))))
    npt.assert_allclose(out, q * ratio, rtol=1e-12)
    # a tensor stays a tensor on its device, to float32 precision
    t = coll._translate_redshift(torch.from_numpy(q.astype(np.float32)),
                                 0.4, 0.5, 1.0, 2.0)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    npt.assert_allclose(t.numpy(), out, rtol=1e-6)
    # z_far above the shifted source: the source distance is z_far's
    npt.assert_allclose(
        coll._translate_redshift(q, 0.4, 1.5, 1.0, 1.2),
        jcoll._translate_redshift(q, 0.4, 1.5, 1.0, 1.2), rtol=1e-5)


def test_stack_for_devices(collection):
    coll, jcoll = _both(collection)
    batch = coll.stack_for_devices(lambda s: torch.full((3,), s.boxsize))
    jbatch = jcoll.stack_for_devices(lambda s: jnp.full((3,), s.boxsize))
    assert tuple(batch.shape) == jbatch.shape == (2, 3)
    npt.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    # a nested loader of numpy leaves, placed on the given device with the
    # JAX package's device dtypes
    def loader(s):
        return {"b": np.full(2, s.boxsize), "n": (np.arange(3),
                                                  s.domain_level)}
    tree = coll.stack_for_devices(loader, device="cpu")
    jtree = jcoll.stack_for_devices(loader)
    for got, want in ((tree["b"], jtree["b"]), (tree["n"][0], jtree["n"][0]),
                      (tree["n"][1], jtree["n"][1])):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        npt.assert_array_equal(got.numpy(), np.asarray(want))
    sub = coll.stack_for_devices(lambda s: torch.ones(2), sim_names=["box2"])
    assert tuple(sub.shape) == (1, 2)


# ------------------------------------------------- sum_snapshots selection
@pytest.fixture
def ray_dir(tmp_path):
    for nr, val in ((1, 1.0), (2, 2.0), (3, 4.0)):
        jcol.write_table(
            str(tmp_path / f"Ray_maps_output{nr:05d}.h5"),
            {"kappa_2": np.full(8, val), "isw_rs": np.full(8, 10 * val)})
    return str(tmp_path) + "/"


def test_sum_snapshots_honors_snap_nrs(ray_dir):
    """tests/test_round3_fixes.py:115 in both packages."""
    dsc = {"root": "Ray_maps", "extension": ".h5"}
    sim, jsim = RayRamses(dir_sim=ray_dir, file_dsc=dsc), JRayRamses(
        dir_sim=ray_dir, file_dsc=dsc)
    full = sim.sum_snapshots(["kappa_2"])
    npt.assert_allclose(full["kappa_2"], 7.0)
    sub = sim.sum_snapshots(["kappa_2"], snap_nrs=[1, 3])
    npt.assert_allclose(sub["kappa_2"], 5.0)
    _assert_dicts_equal(sub, jsim.sum_snapshots(["kappa_2"], snap_nrs=[1, 3]))
    _assert_dicts_equal(full, jsim.sum_snapshots(["kappa_2"]))


def test_sum_snapshots_z_range(ray_dir):
    """tests/test_round3_fixes.py:127 in both packages."""
    dsc = {"root": "Ray_maps", "extension": ".h5"}
    sim, jsim = RayRamses(dir_sim=ray_dir, file_dsc=dsc), JRayRamses(
        dir_sim=ray_dir, file_dsc=dsc)
    zs = {1: 0.3, 2: 0.5, 3: 1.0}
    got = sim.sum_snapshots(["kappa_2", "isw_rs"], z_range=(0.4, 1.5),
                            redshifts=zs)
    npt.assert_allclose(got["kappa_2"], 6.0)
    npt.assert_allclose(got["isw_rs"], 60.0)
    _assert_dicts_equal(got, jsim.sum_snapshots(
        ["kappa_2", "isw_rs"], z_range=(0.4, 1.5), redshifts=zs))
    with pytest.raises(ValueError):
        sim.sum_snapshots(["kappa_2"], z_range=(5.0, 9.0), redshifts=zs)
    with pytest.raises(ValueError):
        sim.sum_snapshots(["kappa_2"], z_range=(0.4, 1.5))


# ------------------------------------- examples/generate_snapshot_info.py
def test_generate_snapshot_info_round_trip(tmp_path):
    """The example's path in the port: write_snapshot_info, a collection
    YAML, SimulationCollection.from_file, _config_rows, then read_table of
    the same file; the table equals the JAX package's, and each package's
    file builds the other's collection."""
    redshifts_per_box = {1: [0.0, 0.25, 0.5, 1.0], 2: [0.5, 1.0, 1.5, 2.0]}
    part = str(tmp_path / "particle_snapshot_info.h5")
    jpart = str(tmp_path / "jax_particle_snapshot_info.h5")
    write_snapshot_info(part, redshifts_per_box)
    jwrite_info(jpart, redshifts_per_box)
    table = snapshot_info_table(redshifts_per_box)
    yaml_path = tmp_path / "collection.yaml"
    with open(yaml_path, "w") as f:
        for box in (1, 2):
            os.makedirs(tmp_path / f"box{box}", exist_ok=True)
            f.write(f"box{box}:\n  type: particles\n  init:\n"
                    f"    dir_sim: {tmp_path}/box{box}\n"
                    f"    boxsize: 500.0\n    domain_level: 512\n")
    coll = SimulationCollection.from_file(str(yaml_path), part)
    jcoll = JColl.from_file(str(yaml_path), jpart)
    sub = coll._config_rows(coll.config, 1)
    npt.assert_allclose(sub["redshift"], redshifts_per_box[1])
    assert sorted(coll.sim) == sorted(jcoll.sim) == ["box1", "box2"]
    back = tcol.read_table(part, key="df")
    assert set(back) == set(table)
    jsub = jcoll._config_rows(jcoll.config, 1)
    assert sorted(sub) == sorted(jsub)
    for k in ("_index_1", "redshift", "a"):
        npt.assert_array_equal(sub[k], jsub[k])
    for k in ("Hz", "lookback_time", "Dc"):
        npt.assert_allclose(sub[k], jsub[k], rtol=1e-5)
    # each package's file builds the other's collection, column for column
    _assert_dicts_equal(SimulationCollection.from_file(str(yaml_path),
                                                       jpart).config,
                        jcol.read_table(jpart, key="df"))
    _assert_dicts_equal(JColl.from_file(str(yaml_path), part).config, back)


def test_template_config_is_a_byte_copy():
    a = os.path.join(REPO, "astrild_tpu", "configs",
                     "template_simulation_collection.yaml")
    b = os.path.join(REPO, "astrild_tpu_torch", "configs",
                     "template_simulation_collection.yaml")
    assert open(a, "rb").read() == open(b, "rb").read()
    reg = yaml.safe_load(open(b))
    assert [v["type"] for v in reg.values()] == ["particles", "rays"]
