"""The port's I/O copies (astrild_tpu_torch.io) vs the JAX package's
(astrild_tpu.io) on the CPU, and the Simulation handle's discovery.

The copies must write byte-identical files, read each other's files to the
same arrays, and hold the same multi-file, unit and dtype rules. Every
comparison here is exact: these are file formats and integer ids.
"""
import os
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import astrild_tpu.io as jio  # noqa: E402
from astrild_tpu.io import columnar_h5 as jcol  # noqa: E402
from astrild_tpu.io import gadget_binary as jgb  # noqa: E402
from astrild_tpu.io import gadget_hdf5 as jgh  # noqa: E402
from astrild_tpu.io import pandas_hdf5 as jph  # noqa: E402
from astrild_tpu.models import Ecosmog as JEcosmog  # noqa: E402
from astrild_tpu.models import Simulation as JSimulation  # noqa: E402

import astrild_tpu_torch.io as tio  # noqa: E402
from astrild_tpu_torch.io import columnar_h5 as tcol  # noqa: E402
from astrild_tpu_torch.io import gadget_binary as tgb  # noqa: E402
from astrild_tpu_torch.io import gadget_hdf5 as tgh  # noqa: E402
from astrild_tpu_torch.io import pandas_hdf5 as tph  # noqa: E402
from astrild_tpu_torch.models import Ecosmog, RayRamses, Simulation  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _particles(rng, n):
    pos = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 300, (n, 3)).astype(np.float32)
    ids = rng.permutation(n).astype(np.uint32)
    return pos, vel, ids


def _assert_header_equal(a, b):
    assert a.dtype == b.dtype
    for name in a.dtype.names:
        npt.assert_array_equal(a[name], b[name])


# -------------------------------------------------------- gadget binary
@pytest.mark.parametrize("snap_format", [1, 2])
@pytest.mark.parametrize("masses", [False, True])
def test_write_gadget_byte_identical(tmp_path, rng, snap_format, masses):
    pos, vel, ids = _particles(rng, 257)
    m = rng.uniform(0.5, 2, 257).astype(np.float32) if masses else None
    kw = dict(masses=m, time=0.5, redshift=1.0, omega_m=0.31,
              omega_l=0.69, hubble=0.68, snap_format=snap_format)
    jgb.write_gadget(tmp_path / "jax", pos, vel, ids, 250.0, **kw)
    tgb.write_gadget(tmp_path / "torch", pos, vel, ids, 250.0, **kw)
    assert (tmp_path / "jax").read_bytes() == (tmp_path / "torch").read_bytes()
    assert tgb.detect_format(tmp_path / "jax") == snap_format


def test_write_gadget_mass_table_byte_identical(tmp_path, rng):
    pos, vel, ids = _particles(rng, 40)
    table = np.array([0, 0.25, 0, 0, 0, 0])
    for mod, name in ((jgb, "jax"), (tgb, "torch")):
        mod.write_gadget(tmp_path / name, pos, vel, ids, 100.0,
                         mass_table=table, part_type=1)
    assert (tmp_path / "jax").read_bytes() == (tmp_path / "torch").read_bytes()


@pytest.mark.parametrize("snap_format", [1, 2])
def test_gadget_packages_read_each_other(tmp_path, rng, snap_format):
    pos, vel, ids = _particles(rng, 300)
    m = rng.uniform(0.5, 2, 300).astype(np.float32)
    jgb.write_gadget(tmp_path / "a", pos, vel, ids, 100.0, masses=m,
                     snap_format=snap_format)
    tgb.write_gadget(tmp_path / "b", pos, vel, ids, 100.0, masses=m,
                     snap_format=snap_format)
    for path in (tmp_path / "a", tmp_path / "b"):
        hj, dj = jgb.read_gadget(path)
        ht, dt = tgb.read_gadget(path)
        _assert_header_equal(ht, hj)
        assert set(dt) == set(dj) == {"pos", "vel", "ids", "mass"}
        for key in dj:
            assert dt[key].dtype == dj[key].dtype
            npt.assert_array_equal(dt[key], dj[key])
        npt.assert_array_equal(dt["pos"], pos)
        npt.assert_array_equal(dt["ids"], ids)


def test_read_gadget_multi_matches_jax(tmp_path, rng):
    """An 8-file snapshot base.0 .. base.7 (the file lane's layout) written
    by the port reads back bit for bit, and as the JAX reader reads it."""
    pos, vel, ids = _particles(rng, 8 * 37 + 5)
    bounds = np.linspace(0, len(pos), 9).astype(int)
    for f in range(8):
        sl = slice(bounds[f], bounds[f + 1])
        tgb.write_gadget(tmp_path / f"snap_000.{f}", pos[sl], vel[sl],
                         ids[sl], 100.0)
    hj, dj = jgb.read_gadget_multi(str(tmp_path / "snap_000"))
    ht, dt = tgb.read_gadget_multi(str(tmp_path / "snap_000"))
    _assert_header_equal(ht, hj)
    assert int(ht["npart"][1]) == len(pos)
    for key, want in (("pos", pos), ("vel", vel), ("ids", ids)):
        npt.assert_array_equal(dt[key].view(np.uint32),
                               want.view(np.uint32))
        npt.assert_array_equal(dt[key], dj[key])
    with pytest.raises(FileNotFoundError):
        tgb.read_gadget_multi(str(tmp_path / "missing"))


def test_combine_gadget_matches_jax(tmp_path, rng):
    parts = []
    for f in range(3):
        pos, vel, ids = _particles(rng, 10 + f)
        tgb.write_gadget(tmp_path / f"p{f}", pos, vel, ids, 50.0,
                         masses=np.ones(10 + f, np.float32))
        parts.append(tgb.read_gadget(tmp_path / f"p{f}"))
    hj, dj = jgb.combine_gadget(parts)
    ht, dt = tgb.combine_gadget(parts)
    _assert_header_equal(ht, hj)
    for key in dj:
        npt.assert_array_equal(dt[key], dj[key])
    with pytest.raises(ValueError):
        tgb.combine_gadget([])


def test_detect_format_rejects_other_files(tmp_path):
    (tmp_path / "x").write_bytes(b"\x07\x00\x00\x00" + bytes(16))
    with pytest.raises(ValueError, match="not a gadget"):
        tgb.detect_format(tmp_path / "x")


@pytest.mark.parametrize("region", [[10, 60, 0, 100, 20, 30],
                                    [-20, 20, 90, 130, 0, 100]])
def test_select_box_matches_jax(rng, region):
    pos, vel, ids = _particles(rng, 2000)
    got = tgb.select_box(pos, region, 100.0, extra=[vel, ids])
    want = jgb.select_box(pos, region, 100.0, extra=[vel, ids])
    for g, w in zip(got, want):
        npt.assert_array_equal(g, w)
    npt.assert_array_equal(tgb.select_box(pos, region, 100.0),
                           jgb.select_box(pos, region, 100.0))


@pytest.mark.parametrize("a,b", [([0, 1, 0, 1, 0, 1], [0.5, 2, 0.5, 2, 0.5, 2]),
                                 ([0, 1, 0, 1, 0, 1], [2, 3, 0, 1, 0, 1]),
                                 ([0, 4, 0, 4, 0, 4], [1, 2, 1, 2, 1, 2])])
def test_box_predicates_match_jax(a, b):
    assert tgb.box_overlap(a, b) == jgb.box_overlap(a, b)
    assert tgb.box_fully_contained(a, b) == jgb.box_fully_contained(a, b)
    assert tgb.box_fully_contained(b, a) == jgb.box_fully_contained(b, a)


# ---------------------------------------------------------- gadget HDF5
@pytest.fixture
def synth_snapshot(tmp_path):
    """Two-file Gadget HDF5 snapshot and a group catalog (the JAX package's
    own synthetic snapshot, tests/test_io.py)."""
    rng = np.random.default_rng(3)
    n = 100
    sdir = tmp_path / "snapdir_012"
    sdir.mkdir()
    for fn in range(2):
        with h5py.File(sdir / f"snap_012.{fn}.hdf5", "w") as f:
            h = f.create_group("Header")
            h.attrs["NumPart_ThisFile"] = np.array([0, n, 0, 0, 0, 0])
            h.attrs["NumPart_Total"] = np.array([0, 2 * n, 0, 0, 0, 0])
            h.attrs["MassTable"] = np.array([0, 0.05, 0, 0, 0, 0])
            h.attrs["Time"] = 1.0
            h.attrs["Redshift"] = 0.0
            h.attrs["BoxSize"] = 100.0
            h.attrs["Omega0"] = 0.3
            h.attrs["OmegaLambda"] = 0.7
            h.attrs["HubbleParam"] = 0.7
            h.attrs["NumFilesPerSnapshot"] = 2
            pt = f.create_group("PartType1")
            pt["Coordinates"] = rng.uniform(0, 100, (n, 3))
            pt["Velocities"] = rng.normal(0, 100, (n, 3))
            pt["ParticleIDs"] = (np.arange(fn * n, (fn + 1) * n,
                                           dtype=np.uint64) + 2 ** 60)
    gdir = tmp_path / "groups_012"
    gdir.mkdir()
    with h5py.File(gdir / "fof_subhalo_tab_012.0.hdf5", "w") as f:
        h = f.create_group("Header")
        h.attrs["Ngroups_ThisFile"] = 5
        h.attrs["Ngroups_Total"] = 5
        h.attrs["Nsubgroups_ThisFile"] = 5
        h.attrs["Nsubgroups_Total"] = 5
        g = f.create_group("Group")
        g["GroupPos"] = rng.uniform(0, 100, (5, 3))
        g["Group_M_Crit200"] = np.full(5, 10.0)
        g["Group_R_Crit200"] = np.full(5, 0.2)
        s = f.create_group("Subhalo")
        s["SubhaloVmax"] = np.full(5, 300.0)
    return str(tmp_path)


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            npt.assert_array_equal(g, w)
        else:
            assert g == w, key


@pytest.mark.parametrize("partition", [(1, 0), (2, 0), (2, 1)])
def test_gadget_snapshot_read_matches_jax(synth_snapshot, partition):
    blocks = ["Coordinates", "Velocities", "Masses", "ParticleIDs"]
    want = jgh.GadgetSnapshot(12, synth_snapshot)
    got = tgh.GadgetSnapshot(12, synth_snapshot)
    _assert_dicts_equal(got.header, want.header)
    wd = want.read(blocks, parttype=[1], partition=partition)
    gd = got.read(blocks, parttype=[1], partition=partition)
    _assert_dicts_equal(gd, wd)
    n = 200 if partition == (1, 0) else 100
    assert gd["Coordinates"].shape == (n, 3)
    # the native ids dtype survives (no float promotion above 2^53)
    assert gd["ParticleIDs"].dtype == np.uint64
    npt.assert_allclose(gd["Masses"], 0.05 * 1e10 / 0.7)
    # parttype=-1 reads every PartType group present
    _assert_dicts_equal(
        tgh.GadgetSnapshot(12, synth_snapshot).read("Velocities", -1),
        jgh.GadgetSnapshot(12, synth_snapshot).read("Velocities", -1))


def test_gadget_group_catalog_matches_jax(synth_snapshot):
    names = ["GroupPos", "Group_M_Crit200", "SubhaloVmax"]
    want = jgh.GadgetSnapshot(12, synth_snapshot).group_catalog(names)
    got = tgh.GadgetSnapshot(12, synth_snapshot).group_catalog(names)
    _assert_dicts_equal(got, want)
    npt.assert_allclose(got["Group_M_Crit200"], 10.0 * 1e10 / 0.7)
    fast = tgh.GadgetSnapshot(12, synth_snapshot).fast_group_catalog(names)
    _assert_dicts_equal(fast, want)


def test_gadget_contents_match_jax(synth_snapshot):
    got = tgh.list_snapshot_contents(12, synth_snapshot)
    want = jgh.list_snapshot_contents(12, synth_snapshot)
    assert got == want
    assert got["PartType1/Coordinates"][0] == (200, 3)
    assert (tgh.list_group_catalog_contents(12, synth_snapshot)
            == jgh.list_group_catalog_contents(12, synth_snapshot))


def test_gadget_hdf5_errors_match_jax(tmp_path):
    snap = tgh.GadgetSnapshot(7, str(tmp_path))  # lenient construction
    with pytest.raises(FileNotFoundError, match="snap_007"):
        snap.read(["Coordinates"])
    with pytest.raises(FileNotFoundError, match="group catalog"):
        snap.group_catalog()
    gdir = tmp_path / "groups_012"
    gdir.mkdir()
    with h5py.File(gdir / "fof_subhalo_tab_012.0.hdf5", "w") as f:
        h = f.create_group("Header")
        h.attrs["Ngroups_Total"] = 2
        h.attrs["HubbleParam"] = 0.8
        g = f.create_group("Group")
        g["Group_M_Crit200"] = np.array([1.0, 2.0])
        g["GroupLen"] = np.array([10, 20], dtype=np.int32)
    names = ["Group_M_Crit200", "GroupLen"]
    # catalog only: h from the catalog's header, ints keep their dtype
    _assert_dicts_equal(tgh.GadgetSnapshot(12, str(tmp_path)).group_catalog(
        names), jgh.GadgetSnapshot(12, str(tmp_path)).group_catalog(names))


def test_unit_tables_match_jax():
    assert tgh.LENGTH_BLOCKS == jgh.LENGTH_BLOCKS
    assert tgh.MASS_BLOCKS == jgh.MASS_BLOCKS
    for block in ("Coordinates", "Masses", "Velocities", "ParticleIDs"):
        assert tgh.unit_factor(block, 0.7) == jgh.unit_factor(block, 0.7)


# ------------------------------------------------------------- tables
def _table(rng):
    return {"x": rng.normal(size=50), "n": np.arange(50, dtype=np.int32),
            "name": np.array([f"h{i}" for i in range(50)])}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_columnar_h5_round_trip_both_ways(tmp_path, rng, writer):
    cols = _table(rng)
    path = str(tmp_path / "t.h5")
    (jcol if writer == "jax" else tcol).write_table(
        path, cols, attrs={"boxsize": 100.0})
    got = tcol.read_table(path)
    want = jcol.read_table(path)
    _assert_dicts_equal(got, want)
    npt.assert_array_equal(got["x"], cols["x"])
    npt.assert_array_equal(got["name"], cols["name"])
    with h5py.File(path, "r") as f:
        assert f["df"].attrs["boxsize"] == 100.0


def test_columnar_h5_append_key(tmp_path, rng):
    path = str(tmp_path / "t.h5")
    tcol.write_table(path, {"a": np.arange(3)})
    tcol.write_table(path, {"b": np.arange(4)}, key="other", mode="a")
    tcol.write_table(path, {"c": np.arange(5)}, key="other", mode="a")
    assert set(tcol.read_table(path, "other")) == {"c"}
    _assert_dicts_equal(tcol.read_table(path), jcol.read_table(path))


@pytest.fixture
def pandas_fixed_file(tmp_path, rng):
    """A pandas fixed-format store written with h5py: two blocks, one
    index; and one with a two-level row index."""
    path = str(tmp_path / "fixed.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("df")
        g["axis0"] = np.array([b"a", b"b", b"c"])
        g["axis1"] = np.arange(6)
        g["block0_items"] = np.array([b"a", b"b"])
        g["block0_values"] = rng.normal(size=(6, 2))
        g["block1_items"] = np.array([b"c"])
        g["block1_values"] = np.arange(6, dtype=np.int64)[:, None]
        m = f.create_group("multi")
        m["axis1_level0"] = np.array([10, 20])
        m["axis1_label0"] = np.array([0, 0, 1, 1])
        m["axis1_level1"] = np.array([1, 2])
        m["axis1_label1"] = np.array([0, 1, 0, 1])
        m["block0_items"] = np.array([b"v"])
        m["block0_values"] = rng.normal(size=(4, 1))
    return path


@pytest.mark.parametrize("key", ["df", "multi"])
def test_pandas_fixed_reader_matches_jax(pandas_fixed_file, key):
    _assert_dicts_equal(tph.read_pandas_fixed_hdf_as_dict(pandas_fixed_file,
                                                          key),
                        jph.read_pandas_fixed_hdf_as_dict(pandas_fixed_file,
                                                          key))
    # columnar read_table falls back to the fixed format
    _assert_dicts_equal(tcol.read_table(pandas_fixed_file, key),
                        jcol.read_table(pandas_fixed_file, key))


def test_pandas_fixed_dataframe_matches_jax(pandas_fixed_file):
    pd = pytest.importorskip("pandas")
    for key in ("df", "multi"):
        got = tph.read_pandas_fixed_hdf(pandas_fixed_file, key)
        want = jph.read_pandas_fixed_hdf(pandas_fixed_file, key)
        pd.testing.assert_frame_equal(got, want)


def test_io_exports_only_what_is_ported():
    assert set(tio.__all__) <= set(jio.__all__)
    assert tio.GadgetSnapshot is tgh.GadgetSnapshot


# -------------------------------------------------- package boundaries
def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_io_and_models_import_without_h5py_or_jax():
    """With h5py blocked, the I/O and model modules import, and the port
    pulls in neither JAX nor the JAX package."""
    res = _run(
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import astrild_tpu_torch.io, astrild_tpu_torch.models\n"
        "from astrild_tpu_torch.io import gadget_binary\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'astrild_tpu.')) or m == 'astrild_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---------------------------------------------------------- simulation
@pytest.fixture
def fake_sim_tree(tmp_path):
    """Numbered rockstar_* dirs with per-CPU halo files, and a flat run of
    numbered h5 outputs."""
    for snap in (8, 9, 10):
        d = tmp_path / f"rockstar_{snap:03d}"
        d.mkdir()
        for fn in range(2 if snap == 9 else 1):
            (d / f"halos_{fn}.ascii").write_text("# c\n")
    for snap in (12, 3, 7):
        (tmp_path / f"grav_out_{snap:05d}.h5").write_bytes(b"")
    (tmp_path / "rockstar_011.txt").write_text("not a dir")
    return str(tmp_path)


def test_simulation_discovery_matches_jax(fake_sim_tree):
    dsc = {"root": "halos", "extension": ".ascii"}
    got = Simulation(fake_sim_tree, None, dsc, dir_root="rockstar")
    want = JSimulation(fake_sim_tree, None, dsc, dir_root="rockstar")
    npt.assert_array_equal(got.dir_nrs, want.dir_nrs)
    assert list(got.dir_nrs) == [8, 9, 10]
    assert got.dirs == want.dirs
    files = got.get_file_paths(dsc, None, "max")
    assert files == want.get_file_paths(dsc, None, "max")
    assert set(files) == {"8", "9", "10"} and len(files["9"]) == 2
    assert got.name == want.name


def test_simulation_flat_files_match_jax(fake_sim_tree):
    dsc = {"root": "grav_out", "extension": "h5"}
    got = Simulation(fake_sim_tree, None, dsc)
    want = JSimulation(fake_sim_tree, None, dsc)
    npt.assert_array_equal(got.file_nrs, want.file_nrs)
    assert list(got.file_nrs) == [3, 7, 12]
    assert got.files == want.files
    assert [os.path.basename(p) for p in got.files["grav_out"]] == [
        "grav_out_00003.h5", "grav_out_00007.h5", "grav_out_00012.h5"]
    npt.assert_array_equal(got.get_file_nrs(dsc, None, "min"),
                           want.get_file_nrs(dsc, None, "min"))
    npt.assert_array_equal(got.get_dir_nrs("rockstar"),
                           want.get_dir_nrs("rockstar"))
    assert (got.get_dir_paths([8, 10], "rockstar")
            == want.get_dir_paths([8, 10], "rockstar"))
    with pytest.raises(FileNotFoundError):
        got.get_dir_paths([99], "rockstar")


def test_ecosmog_to_gadget_matches_jax(tmp_path, rng):
    """to_gadget writes the JAX package's bytes (header cosmology from the
    handle's Cosmology), from numpy arrays or tensors."""
    pos, vel, _ = _particles(rng, 40)
    want = JEcosmog(dir_sim=str(tmp_path), boxsize=100.0).to_gadget(
        str(tmp_path / "jax"), pos, vel)
    sim = Ecosmog(dir_sim=str(tmp_path), boxsize=100.0)
    got = sim.to_gadget(str(tmp_path / "torch"), pos, vel)
    assert open(got, "rb").read() == open(want, "rb").read()
    sim.to_gadget(str(tmp_path / "tensors"), torch.from_numpy(pos),
                  torch.from_numpy(vel))
    assert (tmp_path / "tensors").read_bytes() == open(want, "rb").read()
    hdr, data = tgb.read_gadget(got)
    npt.assert_array_equal(data["pos"], pos)
    assert hdr["BoxSize"] == 100.0
    npt.assert_allclose(hdr["Omega0"], sim.cosmo.Om0)


def test_unported_handles_raise(tmp_path):
    """The two handles that raised before the RAMSES and ray readers were
    ported (Ecosmog.compress_snapshot, RayRamses) now match the JAX
    package's: the same columns from the same grav and ray files."""
    import struct

    from astrild_tpu.models import RayRamses as JRayRamses

    rng = np.random.default_rng(3)
    d = tmp_path / "output_00007"
    d.mkdir()
    vals = rng.standard_normal((8, 2, 4))  # (sub-grid, field, cell)
    buf = b"".join(struct.pack("iii", 4, v, 4) for v in (1, 3, 7, 0, 7, 4))
    for dim in range(8):
        for fi in range(2):
            buf += (struct.pack("i", 32) + vals[dim, fi].astype("<f8").tobytes()
                    + struct.pack("i", 32))
    (d / "grav_00007.out00001").write_bytes(buf)
    kw = dict(dir_sim=str(tmp_path), dir_root="output")
    got = Ecosmog(**kw).compress_snapshot([7], 7, ["phi", "f"], save=False)
    want = JEcosmog(**kw).compress_snapshot([7], 7, ["phi", "f"], save=False)
    assert list(got) == list(want) == [7]
    for k in ("phi", "f"):
        npt.assert_array_equal(got[7][k], want[7][k])
    assert len(got[7]["phi"]) == 32
    for cpu in (1, 2):
        np.savetxt(tmp_path / f"Ray_maps_output00003.out{cpu:05d}",
                   rng.standard_normal((3, 3)), header="id kappa_2 shear_x")
    dsc = {"root": "Ray_maps", "extension": "out*"}
    rr = RayRamses(dir_sim=str(tmp_path), file_dsc=dsc, npix=64)
    jr = JRayRamses(dir_sim=str(tmp_path), file_dsc=dsc, npix=64)
    assert rr.npix == jr.npix and rr.opening_angle == jr.opening_angle
    npt.assert_array_equal(rr.file_nrs, jr.file_nrs)
    cols = ["id", "kappa_2", "shear_x"]
    a = rr.compress_snapshot(cols, save=False)
    b = jr.compress_snapshot(cols, save=False)
    assert list(a) == list(b) == [3]
    for k in cols:
        npt.assert_array_equal(a[3][k], b[3][k])
