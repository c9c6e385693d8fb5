"""The port's file layer (astrild_tpu_torch.io: ramses, binary_formats,
mmf, save, rays.merge_ray_outputs; Ecosmog.compress_snapshot and
RayRamses) against the JAX package's on the CPU.

The copies must write byte-identical files, read each other's files to
the same arrays, and return the same columns in the same row order. Every
comparison here is exact (file formats, host numpy copies) except the
redshift inversion, which runs on each package's own distance table.
"""
import os
import struct

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import astrild_tpu.io as jio  # noqa: E402
from astrild_tpu.io import columnar_h5 as jcol  # noqa: E402
from astrild_tpu.models import Ecosmog as JEcosmog  # noqa: E402
from astrild_tpu.models import RayRamses as JRayRamses  # noqa: E402

import astrild_tpu_torch.io as tio  # noqa: E402
from astrild_tpu_torch.io import columnar_h5 as tcol  # noqa: E402
from astrild_tpu_torch.models import Ecosmog, RayRamses, SkyArray  # noqa: E402

FIELDS = ["x", "y", "z", "phi", "f"]


def _grav_file(path, ncache, n_fields, level, seed, ndim=3):
    """The JAX package's single-level grav F77 fixture (tests/test_io.py,
    tests/test_facade_surface.py): one CPU, ncache octs, 2^ndim sub-grids
    of n_fields records each."""
    buf = b""
    for v in (1, ndim, level, 0):  # ncpu, ndim, nlevelmax, nboundary
        buf += struct.pack("iii", 4, v, 4)
    buf += struct.pack("iii", 4, level, 4)
    buf += struct.pack("iii", 4, ncache, 4)
    rng = np.random.default_rng(seed)
    expect = [[] for _ in range(n_fields)]
    for _dim in range(2 ** ndim):
        for fi in range(n_fields):
            vals = rng.standard_normal(ncache)
            expect[fi].append(vals)
            buf += struct.pack("i", 8 * ncache)
            buf += vals.astype("<f8").tobytes()
            buf += struct.pack("i", 8 * ncache)
    with open(path, "wb") as f:
        f.write(buf)
    return [np.concatenate(e) for e in expect]


def _grav_snapshot(directory, snap, level, ncpu, ghosts, seed):
    """A domain level split over ncpu per-CPU grav files (fields x, y, z,
    phi, f): CPU c holds its octs and, as ghost rows, copies of `ghosts`
    octs of CPU c + 1. Every file lists a (level, ncache) block for every
    CPU, empty but its own. Returns the (cells, 5) rows without ghosts."""
    n = 2 ** level
    rng = np.random.default_rng(seed)
    ox, oy, oz = np.meshgrid(*[np.arange(n // 2)] * 3, indexing="ij")
    octs = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], -1)
    octs = octs[rng.permutation(len(octs))]
    per = len(octs) // ncpu
    dims = np.array([[d & 1, (d >> 1) & 1, (d >> 2) & 1] for d in range(8)])
    # (oct, dim, field) values: cell centres in box units, random phi, f
    centres = (2 * octs[:, None, :] + dims[None] + 0.5) / n
    vals = np.concatenate([centres, rng.standard_normal(
        (len(octs), 8, 2))], axis=-1)
    for c in range(ncpu):
        own = np.arange(c * per, (c + 1) * per)
        nxt = ((c + 1) % ncpu) * per + np.arange(ghosts)
        block = vals[np.concatenate([own, nxt])]  # (ncache, 8, 5)
        ncache = block.shape[0]
        parts = [struct.pack("iii", 4, v, 4) for v in (ncpu, 3, level, 0)]
        for ib in range(ncpu):
            parts.append(struct.pack("iii", 4, level, 4))
            parts.append(struct.pack("iii", 4, ncache if ib == c else 0, 4))
            if ib != c:
                continue
            marker = struct.pack("i", 8 * ncache)
            for d in range(8):
                for fi in range(5):
                    parts += [marker, block[:, d, fi].astype("<f8").tobytes(),
                              marker]
        path = os.path.join(directory, f"grav_{snap:05d}.out{c + 1:05d}")
        with open(path, "wb") as f:
            f.write(b"".join(parts))
    return vals.reshape(-1, 5)


# ------------------------------------------------------------------- ramses
def test_read_grav_file_matches_jax_bit_for_bit(tmp_path):
    p = str(tmp_path / "grav_00012.out00001")
    expect = _grav_file(p, 5, 2, 7, seed=5)
    got = tio.ramses.read_grav_file(p, 2, 7, 7, ndim=3)
    want = jio.ramses.read_grav_file(p, 2, 7, 7, ndim=3)
    for g, w, e in zip(got, want, expect):
        assert g.dtype == w.dtype == np.float64
        npt.assert_array_equal(g, w)
        npt.assert_array_equal(g, e)


@pytest.mark.parametrize("deduplicate", [False, True])
def test_read_grav_snapshot_matches_jax(tmp_path, deduplicate):
    rows = _grav_snapshot(str(tmp_path), 3, 3, 4, ghosts=2, seed=1)
    paths = [str(p) for p in sorted(tmp_path.glob("grav_*"))][::-1]
    got = tio.ramses.read_grav_snapshot(paths, FIELDS, 3, 3,
                                        deduplicate=deduplicate)
    want = jio.ramses.read_grav_snapshot(paths, FIELDS, 3, 3,
                                         deduplicate=deduplicate)
    assert list(got) == list(want) == FIELDS
    for k in FIELDS:
        npt.assert_array_equal(got[k], want[k])
    n = len(got["x"])
    if deduplicate:
        # the ghosts are gone, and the rows come in lexicographic order
        assert n == 8 ** 3
        npt.assert_array_equal(np.stack([got[k] for k in FIELDS], 1),
                               np.unique(rows, axis=0))
    else:
        assert n == 8 ** 3 + 4 * 2 * 8


# ------------------------------------------------------------ binary formats
@pytest.mark.parametrize("file_type,shape", [(1, (8, 8, 8)), (11, (4, 4, 4, 3)),
                                             (101, (4, 6, 5))])
def test_density_files_byte_identical_and_cross_read(tmp_path, rng,
                                                     file_type, shape):
    data = rng.standard_normal(shape).astype(np.float32)
    if file_type == 101:
        data = rng.integers(0, 9, shape).astype(np.int32)
    kw = dict(file_type=file_type, boxsize=100.0, redshift=0.5,
              omega_m=0.3, omega_l=0.7, hubble=0.7)
    jio.write_density(str(tmp_path / "j.bin"), data, **kw)
    tio.write_density(str(tmp_path / "t.bin"), torch.from_numpy(data), **kw)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    th, tdata = tio.read_density(str(tmp_path / "j.bin"))
    jh, jdata = jio.read_density(str(tmp_path / "t.bin"))
    assert th.dtype == jh.dtype
    for name in th.dtype.names:
        npt.assert_array_equal(th[name], jh[name])
    assert tdata.dtype == jdata.dtype and tdata.shape == shape
    npt.assert_array_equal(tdata, data)
    npt.assert_array_equal(jdata, data)


def test_halo_catalog_byte_identical_and_cross_read(tmp_path, rng):
    ints = rng.integers(0, 100, (10, 2)).astype(np.int32)
    floats = rng.standard_normal((10, 4)).astype(np.float32)
    args = (["id", "pid"], ["x", "y", "z", "mass"])
    kw = dict(boxsize=100.0, mass_column=3)
    jio.write_halo_catalog(str(tmp_path / "j.bin"), ints, floats, *args, **kw)
    tio.write_halo_catalog(str(tmp_path / "t.bin"), torch.from_numpy(ints),
                           torch.from_numpy(floats), *args, **kw)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    got = tio.read_halo_catalog(str(tmp_path / "j.bin"))
    want = jio.read_halo_catalog(str(tmp_path / "t.bin"))
    assert got[1:3] == want[1:3] == (["id", "pid"], ["x", "y", "z", "mass"])
    npt.assert_array_equal(got[3], ints)
    npt.assert_array_equal(got[4], floats)
    npt.assert_array_equal(got[0]["massRange"], want[0]["massRange"])


def test_text_tables_and_info_header_match_jax(tmp_path, rng):
    data = rng.standard_normal((4, 3))
    jio.write_text_table(str(tmp_path / "j.txt"), data, header="x y z")
    tio.write_text_table(str(tmp_path / "t.txt"), torch.from_numpy(data),
                         header="x y z")
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    npt.assert_array_equal(tio.read_text_table(str(tmp_path / "j.txt"), 1),
                           jio.read_text_table(str(tmp_path / "t.txt"), 1))
    cube = rng.standard_normal((2, 3, 4))
    jio.write_text_table_gnuplot3d(str(tmp_path / "j3"), cube, "demo")
    tio.write_text_table_gnuplot3d(str(tmp_path / "t3"), torch.from_numpy(cube),
                                   "demo")
    assert (tmp_path / "j3").read_bytes() == (tmp_path / "t3").read_bytes()
    with pytest.raises(ValueError, match="3D"):
        tio.write_text_table_gnuplot3d(str(tmp_path / "bad"), data)
    pj = jio.binary_formats.write_info_header(str(tmp_path / "j"), "d", ["a"])
    pt = tio.binary_formats.write_info_header(str(tmp_path / "t"), "d", ["a"])
    assert open(pj).read() == open(pt).read()


# ---------------------------------------------------------------------- mmf
@pytest.mark.parametrize("file_type,dtype", [(0, np.float32), (1, np.float32),
                                             (20, np.int16), (30, np.int32)])
def test_mmf_byte_identical_and_cross_read(tmp_path, rng, file_type, dtype):
    grid = (rng.standard_normal((8, 8, 8)) * 3).astype(dtype)
    jio.mmf.write_mmf(str(tmp_path / "j.mmf"), grid, file_type, 100.0, 0.5)
    tio.mmf.write_mmf(str(tmp_path / "t.mmf"), torch.from_numpy(grid),
                      file_type, 100.0, 0.5)
    assert (tmp_path / "j.mmf").read_bytes() == (tmp_path / "t.mmf").read_bytes()
    th, tgrid = tio.mmf.read_mmf(str(tmp_path / "j.mmf"))
    jh, jgrid = jio.mmf.read_mmf(str(tmp_path / "t.mmf"))
    assert tgrid.dtype == jgrid.dtype == dtype
    npt.assert_array_equal(tgrid, grid)
    npt.assert_array_equal(jgrid, grid)
    npt.assert_array_equal(th["BoxSize"], jh["BoxSize"])


def test_nexus_environments_match_jax(rng):
    masks = [(rng.uniform(size=(6, 6, 6)) < p).astype(np.float32)
             for p in (0.05, 0.2, 0.4)]
    density = rng.lognormal(size=(6, 6, 6))
    want = jio.mmf.nexus_combine_environments(*masks)
    got = tio.mmf.nexus_combine_environments(*[torch.from_numpy(m)
                                               for m in masks])
    assert got.dtype == want.dtype
    npt.assert_array_equal(got, want)
    assert (tio.mmf.nexus_environment_properties(got, density, 100.0)
            == jio.mmf.nexus_environment_properties(want, density, 100.0))
    assert (tio.mmf.NODE, tio.mmf.FILAMENT, tio.mmf.WALL, tio.mmf.FIELD) \
        == (jio.mmf.NODE, jio.mmf.FILAMENT, jio.mmf.WALL, jio.mmf.FIELD)


# --------------------------------------------------------------------- save
def test_save_helpers_match_jax(tmp_path, rng):
    img = rng.standard_normal((6, 6)).astype(np.float32)
    pj = jio.save.save_skymap(img, str(tmp_path / "j" / "m.npy"))
    sky = SkyArray.from_array(img, 5.0, "kappa_2", device="cpu")
    pt = tio.save.save_skymap(sky, str(tmp_path / "t" / "m.npy"))
    pt2 = tio.save.save_skymap(torch.from_numpy(img),
                               str(tmp_path / "t" / "m2.npy"))
    assert open(pj, "rb").read() == open(pt, "rb").read() \
        == open(pt2, "rb").read()
    with pytest.raises(ImportError, match="astropy"):
        tio.save.save_skymap(img, str(tmp_path / "m.fits"))
    r, xi = np.arange(5.0), rng.standard_normal(5)
    mp = {0: rng.standard_normal(5), 2: rng.standard_normal(5)}
    pj = jio.save.save_tpcf(str(tmp_path / "j"), "tpcf.h5", r, xi, mp)
    pt = tio.save.save_tpcf(str(tmp_path / "t"), "tpcf.h5",
                            torch.from_numpy(r), xi,
                            {k: torch.from_numpy(v) for k, v in mp.items()})
    a, b = tcol.read_table(pj), jcol.read_table(pt)
    assert sorted(a) == sorted(b) == ["r", "xi", "xi_0", "xi_2"]
    for k in a:
        npt.assert_array_equal(a[k], b[k])
    assert tio.save.save_dataFrame is tio.save.save_columns


# --------------------------------------------------------------------- rays
def _ray_dump(path, rng, ids, cols):
    block = np.column_stack([ids.astype(float)] + [
        rng.normal(0, s, len(ids)) for s in (1e-2, 1e-3, 1e-3)])
    np.savetxt(path, block, header=" ".join(cols))
    return block


def test_merge_ray_outputs_matches_jax(tmp_path, rng):
    cols = ["id", "kappa_2", "shear_x", "shear_y"]
    paths = []
    for cpu, n in ((1, 7), (2, 0), (3, 5)):
        p = str(tmp_path / f"Ray_maps_output00001.out{cpu:05d}")
        _ray_dump(p, rng, np.arange(cpu * 100, cpu * 100 + n), cols)
        paths.append(p)
    got = tio.rays.merge_ray_outputs(paths, cols)
    want = jio.rays.merge_ray_outputs(paths, cols)
    assert list(got) == list(want) == cols
    for k in cols:
        npt.assert_array_equal(got[k], want[k])
    assert len(got["id"]) == 12


# ------------------------------------------------- compress_snapshot
def test_ecosmog_compress_snapshot_matches_jax(tmp_path):
    """Numbered snapshot dirs of per-CPU grav files with ghost rows: both
    packages return and save the same deduplicated columns, and read each
    other's tables."""
    for snap in (7, 8):
        d = tmp_path / f"output_{snap:05d}"
        d.mkdir()
        _grav_snapshot(str(d), snap, 3, 4, ghosts=3, seed=snap)
    outs = {}
    for pkg, cls in (("jax", JEcosmog), ("torch", Ecosmog)):
        out_dir = tmp_path / pkg
        out_dir.mkdir()
        eco = cls(dir_sim=str(tmp_path), dir_out=str(out_dir),
                  dir_root="output", boxsize=100.0, domain_level=8)
        outs[pkg] = eco.compress_snapshot([3], 3, FIELDS, snap_nrs=[8],
                                          dir_out=str(out_dir), save=True)
    assert list(outs["torch"]) == list(outs["jax"]) == [8]
    for k in FIELDS:
        npt.assert_array_equal(outs["torch"][8][k], outs["jax"][8][k])
    assert len(outs["torch"][8]["x"]) == 8 ** 3
    a = jcol.read_table(str(tmp_path / "torch" / "grav_out00008.h5"))
    b = tcol.read_table(str(tmp_path / "jax" / "grav_out00008.h5"))
    for k in FIELDS:
        npt.assert_array_equal(a[k], b[k])
    # without save nothing is written
    eco = Ecosmog(dir_sim=str(tmp_path), dir_root="output")
    got = eco.compress_snapshot([3], 3, FIELDS, save=False)
    assert sorted(got) == [7, 8]
    assert not (tmp_path / "grav_out00007.h5").exists()


@pytest.fixture
def ray_ascii_tree(tmp_path):
    """Two ray snapshots over two per-CPU ASCII dumps each (the JAX
    package's test_facade_surface fixture, 8 rays a CPU)."""
    rng = np.random.default_rng(0)
    cols = ["ray_id", "kappa_2", "shear_x", "shear_y"]
    truth = {}
    for snap in (1, 2):
        truth[snap] = np.concatenate([
            _ray_dump(tmp_path / f"Ray_maps_output{snap:05d}.out{cpu:05d}",
                      rng, np.arange(cpu * 100, cpu * 100 + 8), cols)
            for cpu in (1, 2)])
    return str(tmp_path), cols, truth


def test_rayramses_compress_snapshot_matches_jax(ray_ascii_tree, tmp_path):
    path, cols, truth = ray_ascii_tree
    dsc = {"root": "Ray_maps", "extension": "out*"}
    outs = {}
    for pkg, cls in (("jax", JRayRamses), ("torch", RayRamses)):
        out_dir = tmp_path / f"out_{pkg}"
        out_dir.mkdir()
        rr = cls(dir_sim=path, file_dsc=dsc, opening_angle=10.0, npix=64)
        outs[pkg] = rr.compress_snapshot(cols, dir_out=str(out_dir),
                                         save=True)
    assert sorted(outs["torch"]) == sorted(outs["jax"]) == [1, 2]
    for snap in (1, 2):
        for k in cols:
            npt.assert_array_equal(outs["torch"][snap][k],
                                   outs["jax"][snap][k])
    npt.assert_array_equal(outs["torch"][1]["shear_x"], -truth[1][:, 2])
    npt.assert_array_equal(outs["torch"][2]["kappa_2"], truth[2][:, 1])
    a = jcol.read_table(str(tmp_path / "out_torch" / "Ray_maps_output00002.h5"))
    b = tcol.read_table(str(tmp_path / "out_jax" / "Ray_maps_output00002.h5"))
    for k in cols:
        npt.assert_array_equal(a[k], b[k])


@pytest.fixture
def ray_dir(tmp_path):
    """Ray map tables 1-3 (tests/test_round3_fixes.py's fixture)."""
    for nr, val in ((1, 1.0), (2, 2.0), (3, 4.0)):
        jcol.write_table(str(tmp_path / f"Ray_maps_output{nr:05d}.h5"),
                         {"kappa_2": np.full(8, val),
                          "isw_rs": np.full(8, 10 * val)})
    return str(tmp_path) + "/"


@pytest.mark.parametrize("kw", [{}, {"snap_nrs": [1, 3]},
                                {"snap_nrs": torch.tensor([2])},
                                {"z_range": (0.4, 1.5)},
                                {"z_range": (0.2, 0.6), "snap_nrs": [2, 3]}])
def test_rayramses_sum_snapshots_matches_jax(ray_dir, kw):
    dsc = {"root": "Ray_maps", "extension": ".h5"}
    zs = {1: 0.3, 2: 0.5, 3: 1.0}
    extra = {"redshifts": zs} if "z_range" in kw else {}
    jkw = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    got = RayRamses(dir_sim=ray_dir, file_dsc=dsc).sum_snapshots(
        ["kappa_2", "isw_rs"], **kw, **extra)
    want = JRayRamses(dir_sim=ray_dir, file_dsc=dsc).sum_snapshots(
        ["kappa_2", "isw_rs"], **jkw, **extra)
    for k in ("kappa_2", "isw_rs"):
        assert got[k].dtype == want[k].dtype
        npt.assert_array_equal(got[k], want[k])


def test_rayramses_sum_snapshots_raises_as_jax(ray_dir):
    sim = RayRamses(dir_sim=ray_dir,
                    file_dsc={"root": "Ray_maps", "extension": ".h5"})
    with pytest.raises(ValueError, match="matched no"):
        sim.sum_snapshots(["kappa_2"], z_range=(5.0, 9.0),
                          redshifts={1: 0.3, 2: 0.5, 3: 1.0})
    with pytest.raises(ValueError, match="redshifts"):
        sim.sum_snapshots(["kappa_2"], z_range=(0.4, 1.5))


def test_rayramses_dc_to_redshift_matches_jax():
    """Each package inverts its own distance table (the port's in host
    float64, the JAX package's in float32): the same z to float32
    precision, and a round trip to the JAX test's 2e-3."""
    import jax.numpy as jnp

    rr = RayRamses(dir_sim=".", opening_angle=10.0, npix=64)
    jr = JRayRamses(dir_sim=".", opening_angle=10.0, npix=64)
    z = np.array([0.2, 0.5, 1.0, 2.0])
    dc = np.asarray(rr.cosmo.comoving_distance(z))
    got = np.asarray(rr.Dc_to_redshift(dc))
    want = np.asarray(jr.Dc_to_redshift(jnp.asarray(dc)))
    npt.assert_allclose(got, want, rtol=1e-5)
    npt.assert_allclose(got, z, rtol=2e-3)


@pytest.fixture
def rockstar_tree(tmp_path):
    """tests/test_facade_surface.py's rockstar tree: 3 snapshots of 2
    per-CPU ASCII halo files."""
    for snap in [1, 2, 3]:
        d = tmp_path / f"rockstar_{snap:03d}"
        d.mkdir()
        for fn in range(2):
            with open(d / f"halos_0.{fn}.ascii", "w") as f:
                f.write("#id x y z vx vy vz m200c r200c Rs\n")
                for _ in range(19):
                    f.write("# c\n")
                rng = np.random.default_rng(snap * 10 + fn)
                for i in range(25):
                    x, y, z = rng.uniform(5, 95, 3)
                    vx, vy, vz = rng.normal(0, 100, 3)
                    m = 10 ** rng.uniform(12.5, 14.5)
                    f.write(f"{i} {x} {y} {z} {vx} {vy} {vz} {m} "
                            f"{0.2} {0.05}\n")
    return str(tmp_path)


def test_find_halos_in_raytracing_box_matches_jax(rockstar_tree, tmp_path):
    ray_dir = tmp_path / "rays"
    ray_dir.mkdir()
    for snap in (1, 2, 3):
        np.savetxt(ray_dir / f"Ray_maps_output{snap:05d}.out00001",
                   np.zeros((2, 2)), header="h")
    dsc = {"root": "halos", "extension": ".ascii"}
    snapdist = np.array([500.0, 450.0, 400.0])
    cats = {}
    for pkg, eco_cls, rr_cls in (("jax", JEcosmog, JRayRamses),
                                 ("torch", Ecosmog, RayRamses)):
        eco = eco_cls(dir_sim=rockstar_tree, dir_root="rockstar",
                      file_dsc=dsc, boxsize=100.0)
        eco.files["halos"] = eco.get_file_paths(dsc, None, "max")
        rr = rr_cls(dir_sim=str(ray_dir),
                    file_dsc={"root": "Ray_maps", "extension": "out*"},
                    opening_angle=20.0, npix=128)
        cats[pkg] = rr.find_halos_in_raytracing_box(eco, snapdist, box_nr=0,
                                                    boxsize=100.0)
    got, want = cats["torch"], cats["jax"]
    assert got and list(got) == list(want)
    for k in want:
        npt.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert set(np.unique(got["ray_nr"])).issubset({2, 3})
