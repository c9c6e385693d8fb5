"""The file-driven P(k) lane of the port vs the JAX package on the CPU:
`divergence`, `Ecosmog.density_fields`, the `PowerSpectrum3D`,
`Bispectrum3D` and `PowMes` facades, and the lane as a whole (an 8-file
Gadget snapshot written in lattice order, read back, P(k) through the
segment-sorted deposit's plain version).

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas deposits in interpret mode, as its own tests do.
Each tolerance is stated where it is checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.io import columnar_h5 as jcol  # noqa: E402
from astrild_tpu.io import gadget_binary as jgb  # noqa: E402
from astrild_tpu.models import power as JMP  # noqa: E402
from astrild_tpu.models import simulation as JMS  # noqa: E402
from astrild_tpu.ops import map_transform as JMT  # noqa: E402
from astrild_tpu.ops import paint_pallas as JPP  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu_torch.io import columnar_h5 as tcol  # noqa: E402
from astrild_tpu_torch.io import gadget_binary as tgb  # noqa: E402
from astrild_tpu_torch.models import power as TMP  # noqa: E402
from astrild_tpu_torch.models import simulation as TMS  # noqa: E402
from astrild_tpu_torch.ops import map_transform as TMT  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda as TPC  # noqa: E402
from astrild_tpu_torch.ops import power as TPS  # noqa: E402

BOX = 100.0
# float32 FFTs in both packages: P(k) of clustered particles to 1e-5
PK_RTOL = 1e-5


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


def _clustered(rng, n_halo=30, per_halo=300, spread=3.0):
    centers = rng.uniform(0, BOX, (n_halo, 3))
    pts = centers[:, None, :] + rng.normal(0, spread, (n_halo, per_halo, 3))
    return np.mod(pts.reshape(-1, 3), BOX).astype(np.float32)


def _lattice_snapshot(rng, side):
    """Particles displaced from a side^3 lattice, in lattice order (the
    order the PM code keeps them in), with velocities and ids."""
    q = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                  -1).reshape(-1, 3) + 0.5) * (BOX / side)
    disp = rng.normal(0, 1.0, q.shape)
    disp += 2.0 * np.sin(2 * np.pi * q[:, [1, 2, 0]] / BOX)
    pos = np.mod(q + disp, BOX).astype(np.float32)
    vel = (100.0 * disp).astype(np.float32)
    return pos, vel, np.arange(side ** 3, dtype=np.uint32)


# ------------------------------------------------------------ divergence
@pytest.mark.parametrize("n,spacing", [(16, 1.0), (9, 3.90625)])
def test_divergence_matches_jax(rng, n, spacing):
    """A non-linear field (random plus a quadratic ramp), so the
    second-order interior and first-order edge stencils both show:
    atol 1e-6 of the largest value."""
    v = rng.normal(size=(3, n, n, n)).astype(np.float32)
    x = np.arange(n, dtype=np.float32)
    v[0] += 0.3 * x[:, None, None] ** 2
    v[2] += 0.1 * x[None, None, :] ** 3
    want = np.asarray(JMT.divergence(jnp.asarray(v), spacing))
    got = TMT.divergence(torch.from_numpy(v), spacing).numpy()
    npt.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_divergence_edge_stencils():
    """v = (x^2, 0, 0): 2x inside, first-order one-sided at the edges."""
    n = 8
    x = torch.arange(n, dtype=torch.float32)
    v = torch.zeros(3, n, n, n)
    v[0] = (x ** 2)[:, None, None]
    div = TMT.divergence(v, 1.0)[:, 0, 0]
    want = 2 * x
    want[0], want[-1] = 1.0, float(2 * n - 3)
    assert torch.equal(div, want)


# --------------------------------------------------------- density fields
@pytest.mark.parametrize("window", ["tsc", "cic"])
def test_ecosmog_density_fields_matches_jax(tmp_path, rng, window):
    """Scatter sums in another order: atol 1e-6 of each field's largest
    value (velocity = momentum / density amplifies the order difference
    in nearly empty cells)."""
    pos = _clustered(rng)
    vel = rng.normal(0, 100, pos.shape).astype(np.float32)
    fields = ("density", "velocity", "divergence")
    want = JMS.Ecosmog(dir_sim=str(tmp_path), boxsize=BOX,
                       domain_level=16).density_fields(
        jnp.asarray(pos), jnp.asarray(vel), window=window, fields=fields)
    sim = TMS.Ecosmog(dir_sim=str(tmp_path), boxsize=BOX, domain_level=16)
    got = sim.density_fields(pos, vel, window=window, fields=fields,
                             device="cpu")
    as_tuple = sim.density_fields(
        tuple(torch.from_numpy(pos[:, i].copy()) for i in range(3)),
        tuple(torch.from_numpy(vel[:, i].copy()) for i in range(3)),
        window=window, fields=fields)
    assert set(got) == set(fields)
    for name in fields:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape
        npt.assert_allclose(got[name].numpy(), w, rtol=0,
                            atol=1e-6 * np.abs(w).max())
        assert torch.equal(as_tuple[name], got[name])
    # mass conservation: mean density N / V
    npt.assert_allclose(float(got["density"].double().mean()),
                        pos.shape[0] / BOX ** 3, rtol=1e-5)


def test_ecosmog_density_only_and_rules(tmp_path, rng):
    pos = _clustered(rng, 5, 100)
    sim = TMS.Ecosmog(dir_sim=str(tmp_path), boxsize=BOX, domain_level=8)
    out = sim.density_fields(pos, device="cpu")
    assert set(out) == {"density"} and out["density"].shape == (8, 8, 8)
    with pytest.raises(ValueError, match="vel"):
        sim.density_fields(pos, fields=("velocity",), device="cpu")


# ------------------------------------------------------ PowerSpectrum3D
@pytest.mark.parametrize("method,interlaced,weighted",
                         [("fast", False, False), ("fast", False, True),
                          ("window", False, False), ("window", True, False),
                          ("window", False, True)])
def test_power_from_points_matches_jax(rng, method, interlaced, weighted):
    """Clustered particles, P(k) to rtol 1e-5 (1e-4 weighted, the JAX
    package's bar for weighted deposits); numpy output like JAX's."""
    pos = _clustered(rng)
    w = rng.uniform(0.5, 2.0, pos.shape[0]).astype(np.float32) \
        if weighted else None
    kw = dict(nbins=6, method=method, interlaced=interlaced)
    kj, pj = JMP.PowerSpectrum3D(window="tsc").power_from_points(
        pos, BOX, 16, weights=w, **kw)
    kt, pt = TMP.PowerSpectrum3D(window="tsc",
                                 device="cpu").power_from_points(
        pos, BOX, 16, weights=w, **kw)
    assert isinstance(pt, np.ndarray) and pt.dtype == np.float32
    npt.assert_allclose(kt, kj, rtol=1e-6)
    npt.assert_allclose(pt, pj, rtol=1e-4 if weighted else PK_RTOL)


def test_power_from_points_takes_tensors_and_device(rng):
    pos = _clustered(rng)
    ps = TMP.PowerSpectrum3D(device="cpu")
    a = ps.power_from_points(pos, BOX, 16, nbins=6, method="fast")
    b = ps.power_from_points(torch.from_numpy(pos), BOX, 16, nbins=6,
                             method="fast")
    npt.assert_array_equal(a[1], b[1])
    # mesh=: the distributed estimator on a world of one. It holds one
    # mode fewer in the last bin than the meshless estimator (whose rfft
    # storage counts the z-Nyquist column twice), so the other bins hold
    # to rtol 1e-5 and the last to the JAX test's rtol 5e-3; against the
    # JAX facade's mesh= on one device, every bin to rtol 1e-5
    from astrild_tpu.parallel import make_mesh as jmake_mesh
    from astrild_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, 1, device="cpu")
    km, pm = ps.power_from_points(pos, BOX, 16, nbins=6, method="fast",
                                  mesh=mesh)
    assert isinstance(pm, np.ndarray) and pm.dtype == np.float32
    npt.assert_allclose(km[:-1], a[0][:-1], rtol=1e-5)
    npt.assert_allclose(pm[:-1], a[1][:-1], rtol=1e-5)
    npt.assert_allclose(km[-1], a[0][-1], rtol=5e-3)
    npt.assert_allclose(pm[-1], a[1][-1], rtol=5e-3)
    kj, pj = JMP.PowerSpectrum3D().power_from_points(
        pos, BOX, 16, nbins=6, method="fast", mesh=jmake_mesh(1, 1, 1))
    npt.assert_allclose(km, kj, rtol=1e-6)
    npt.assert_allclose(pm, pj, rtol=1e-5)
    with pytest.raises(ValueError, match="fast"):
        ps.power_from_points(pos, BOX, 16, mesh=mesh)
    with pytest.raises(ValueError, match="lacks"):
        ps.power_from_points(pos, BOX, 16, method="fast", mesh=object())


def test_facades_put_numpy_input_on_the_card(tmp_path, rng):
    """numpy input with no `device` goes to the CUDA card; with no card the
    facades raise instead of running on the CPU. Tensors keep their
    device."""
    pos = _clustered(rng, 5, 100)
    grid = rng.normal(1, 0.3, (8, 8, 8)).astype(np.float32)
    sim = TMS.Ecosmog(dir_sim=str(tmp_path), boxsize=BOX, domain_level=8)
    calls = {
        "PowerSpectrum3D": lambda: TMP.PowerSpectrum3D().power_from_points(
            pos, BOX, 8, nbins=4, method="fast"),
        "Bispectrum3D.compute": lambda: TMP.Bispectrum3D.compute(
            grid, BOX, nbins=2),
        "Bispectrum3D.from_points": lambda: TMP.Bispectrum3D.from_points(
            pos, BOX, 8, nbins=2),
        "density_fields": lambda: sim.density_fields(pos),
    }
    if torch.cuda.is_available():
        for call in calls.values():
            call()
        assert sim.density_fields(pos)["density"].device.type == "cuda"
    else:
        for call in calls.values():
            with pytest.raises(RuntimeError, match="no card"):
                call()
    assert TMP.default_device("cpu") == torch.device("cpu")
    on_cpu = sim.density_fields(torch.from_numpy(pos))["density"]
    assert on_cpu.device.type == "cpu"


def test_power_from_grid_and_cross_match_jax(rng):
    n = 16
    grid = rng.normal(1, 0.3, (n, n, n)).astype(np.float32)
    other = (grid + rng.normal(0, 0.3, (n, n, n))).astype(np.float32)
    jps, tps = JMP.PowerSpectrum3D(), TMP.PowerSpectrum3D(device="cpu")
    for window in (None, "cic"):
        kj, pj = jps.power_from_grid(grid, BOX, nbins=8, window=window,
                                     shotnoise=0.5)
        kt, pt = tps.power_from_grid(grid, BOX, nbins=8, window=window,
                                     shotnoise=0.5)
        npt.assert_allclose(kt, kj, rtol=1e-6)
        npt.assert_allclose(pt, pj, rtol=PK_RTOL)
        kj, cj = jps.cross_power_from_grids(grid, other, BOX, nbins=8,
                                            window=window)
        kt, ct = tps.cross_power_from_grids(grid, other, BOX, nbins=8,
                                            window=window)
        npt.assert_allclose(ct, cj, rtol=PK_RTOL)
    # cross of a field with itself is its auto spectrum
    _, p_auto = tps.power_from_grid(grid, BOX, nbins=8)
    _, p_self = tps.cross_power_from_grids(grid, grid, BOX, nbins=8)
    npt.assert_allclose(p_self, p_auto, rtol=1e-6)


def test_multipoles_from_grid_matches_jax(rng):
    """Monopole rtol 1e-5; the higher multipoles, sums of terms of both
    signs, with an atol of 1e-5 of the monopole's largest bin."""
    pos = _clustered(rng)
    grid = np.asarray(JMP.paint_ops.paint(jnp.asarray(pos), 16, BOX,
                                          window="cic"))
    kj, pj = JMP.PowerSpectrum3D().multipoles_from_grid(
        grid, BOX, nbins=6, window="cic", shotnoise=2.0)
    kt, pt = TMP.PowerSpectrum3D(device="cpu").multipoles_from_grid(
        grid, BOX, nbins=6, window="cic", shotnoise=2.0)
    assert set(pt) == set(pj) == {0, 2, 4}
    npt.assert_allclose(kt, kj, rtol=1e-6)
    atol = 1e-5 * np.abs(pj[0]).max()
    for ell in (0, 2, 4):
        npt.assert_allclose(pt[ell], pj[ell], rtol=PK_RTOL, atol=atol)


@pytest.fixture
def snapshot_files(tmp_path, rng):
    """Point-set h5 files per snapshot (the `compute` input), clustered
    field A and a Poisson field R, and one npy grid per snapshot."""
    for snap in (3, 4):
        pts = _clustered(rng, 30, 300, 1.5).astype(np.float64)
        jcol.write_table(str(tmp_path / f"grav_out_0000{snap}.h5"),
                         {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
        rnd = rng.uniform(0, BOX, (9000, 3))
        tcol.write_table(str(tmp_path / f"rand_out_0000{snap}.h5"),
                         {"x": rnd[:, 0], "y": rnd[:, 1], "z": rnd[:, 2]})
        np.save(tmp_path / f"grid_out_0000{snap}.npy",
                rng.normal(1, 0.2, (16, 16, 16)).astype(np.float32))
    return str(tmp_path)


def _compute(mod, sim_mod, path, dscs, **kw):
    sim = sim_mod.Simulation(path, None, {"root": "grav_out",
                                          "extension": "h5"})
    # the port's facade runs numpy input on the card unless told otherwise
    ps = (TMP.PowerSpectrum3D("particles", sim, device="cpu") if mod is TMP
          else mod.PowerSpectrum3D("particles", sim))
    return ps.compute(["density"], dscs, boxsize=BOX, ngrid=32, **kw)


@pytest.mark.parametrize("roots", [("grav_out",), ("grid_out",),
                                   ("grav_out", "grav_out"),
                                   ("grav_out", "rand_out")])
def test_compute_matches_jax(snapshot_files, roots):
    """compute() over the files, auto (one file_dsc) and cross (two),
    point sets and npy grids, against JAX's own numbers: rtol 1e-5, with an
    atol of 1e-5 of the auto spectrum's largest bin for the cross with an
    independent field (near zero)."""
    path = snapshot_files
    ext = {"grav_out": "h5", "rand_out": "h5", "grid_out": "npy"}
    dscs = [{"path": path, "root": r, "extension": ext[r]} for r in roots]
    want = _compute(JMP, JMS, path, dscs, save=False)
    got = _compute(TMP, TMS, path, dscs, save=False)
    assert set(got["P"]) == set(want["P"]) == {"snap_3", "snap_4"}
    auto = _compute(JMP, JMS, path, dscs[:1], save=False)
    for snap in want["P"]:
        npt.assert_allclose(got["k"][snap], want["k"][snap], rtol=1e-6)
        atol = 1e-5 * np.abs(auto["P"][snap]).max()
        npt.assert_allclose(got["P"][snap], want["P"][snap], rtol=PK_RTOL,
                            atol=atol)


def test_compute_saves_and_selects_snapshots(snapshot_files, tmp_path):
    path = snapshot_files
    dsc = [{"path": path, "root": "grav_out", "extension": "h5"}]
    out = _compute(TMP, TMS, path, dsc, snap_nrs=[4],
                   dir_out=str(tmp_path / "pk"), save=True)
    assert set(out["P"]) == {"snap_4"}
    saved = jcol.read_table(str(tmp_path / "pk" / "pk_density.h5"))
    assert set(saved) == {"k", "snap_4"}
    npt.assert_array_equal(saved["snap_4"], out["P"]["snap_4"])
    want = _compute(JMP, JMS, path, dsc, save=False)
    npt.assert_allclose(out["P"]["snap_4"], want["P"]["snap_4"],
                        rtol=PK_RTOL)


# ----------------------------------------------- Bispectrum3D and PowMes
def test_bispectrum3d_matches_jax(rng):
    """B over shell triples from float32 FFTs: rtol 1e-4, with an atol of
    1e-4 of the largest |B| (open triangles are NaN in both)."""
    pos = _clustered(rng)
    want = JMP.Bispectrum3D.from_points(pos, BOX, 16, nbins=4)
    got = TMP.Bispectrum3D.from_points(pos, BOX, 16, nbins=4, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        npt.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        npt.assert_allclose(g[fin], w[fin], rtol=1e-4,
                            atol=1e-4 * np.abs(w[fin]).max(initial=0.0))
    grid = np.asarray(JMP.paint_ops.paint(jnp.asarray(pos), 16, BOX))
    direct = TMP.Bispectrum3D.compute(grid, BOX, nbins=4, device="cpu")
    for key, w in JMP.Bispectrum3D.compute(grid, BOX, nbins=4).items():
        fin = np.isfinite(w)
        npt.assert_allclose(direct[key][fin], w[fin], rtol=1e-4,
                            atol=1e-4 * np.abs(w[fin]).max(initial=0.0))


def test_powmes_matches_jax(tmp_path):
    paths = {}
    for snap in (3, 5):
        tab = np.column_stack([np.arange(1, 9, dtype=float),
                               np.linspace(1, 2, 8) * snap])
        p = str(tmp_path / f"powmes_{snap}.ascii")
        np.savetxt(p, tab, header="i P")
        paths[snap] = p
    for snap, p in paths.items():
        for a, b in zip(TMP.PowMes.read_pk_file(p, 250.0),
                        JMP.PowMes.read_pk_file(p, 250.0)):
            npt.assert_array_equal(a, b)
    got = TMP.PowMes.to_table(paths, 250.0, dir_out=str(tmp_path))
    want = JMP.PowMes.to_table(paths, 250.0)
    assert set(got) == set(want) == {"k", "snap_3", "snap_5"}
    for key in want:
        npt.assert_array_equal(got[key], want[key])
    npt.assert_array_equal(
        jcol.read_table(str(tmp_path / "powmes_pk.h5"))["snap_5"],
        want["snap_5"])
    k = np.geomspace(1e-3, 1, 20)
    lin, nonlin = 1 / k, 1 / k + 0.1 * k
    assert TMP.PowMes.align_lin_nonlin(lin, nonlin, k) == \
        JMP.PowMes.align_lin_nonlin(lin, nonlin, k)
    with pytest.raises(ValueError, match="band"):
        TMP.PowMes.align_lin_nonlin(lin, nonlin, k, band=(5, 6))


# ------------------------------------------------------ the lane, whole
def test_file_lane_matches_jax(tmp_path, rng):
    """The lane at a small size: a 32^3 lattice snapshot written by the port
    as 8 Gadget files in lattice order, read back bit for bit by both
    packages; the fine deposit of its file-order keys through K4's plain
    version equals JAX's segmented Pallas deposit (interpret mode) count
    for count; P(k) through the port's scatter equals JAX's 'pallas_seg'
    P(k) to rtol 1e-5; the density fields agree as above."""
    side, ngrid = 32, 16
    pos, vel, ids = _lattice_snapshot(rng, side)
    bounds = np.linspace(0, side ** 3, 9).astype(int)
    for f in range(8):
        sl = slice(bounds[f], bounds[f + 1])
        tgb.write_gadget(tmp_path / f"snap_000.{f}", pos[sl], vel[sl],
                         ids[sl], BOX)
    _, data = tgb.read_gadget_multi(str(tmp_path / "snap_000"))
    _, jdata = jgb.read_gadget_multi(str(tmp_path / "snap_000"))
    for key, want in (("pos", pos), ("vel", vel), ("ids", ids)):
        npt.assert_array_equal(data[key].view(np.uint32),
                               want.view(np.uint32))
        npt.assert_array_equal(jdata[key], data[key])
    xyz = [np.ascontiguousarray(data["pos"][:, i]) for i in range(3)]

    keys_t = TPS._fast_keys(tuple(torch.from_numpy(c) for c in xyz), BOX,
                            ngrid=ngrid, fine_factor=2)
    keys_j = JPS._fast_keys(tuple(jnp.asarray(c) for c in xyz), BOX,
                            ngrid=ngrid, fine_factor=2)
    npt.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    n_cells = 8 * ngrid ** 3
    dep_t = TPC.deposit_flat_segmented(keys_t, None, n_cells).numpy()
    dep_j = np.asarray(JPP.deposit_flat_segmented(
        keys_j, None, n_cells, n_seg=8, window=4096, chunk_rows=4,
        interpret=True))
    npt.assert_array_equal(dep_t, dep_j)
    npt.assert_array_equal(dep_t, np.bincount(keys_t.numpy(),
                                              minlength=n_cells))

    want = JPS.auto_power_fast(tuple(jnp.asarray(c) for c in xyz), ngrid,
                               BOX, nbins=8, deposit="pallas_seg_interpret")
    got = TPS.auto_power_fast(tuple(torch.from_numpy(c) for c in xyz),
                              ngrid, BOX, nbins=8, deposit="scatter")
    npt.assert_allclose(got.power.numpy(), np.asarray(want.power),
                        rtol=PK_RTOL)
    k_f, p_f = TMP.PowerSpectrum3D(device="cpu").power_from_points(
        data["pos"], BOX, ngrid, nbins=8, method="fast")
    npt.assert_array_equal(p_f, got.power.numpy())

    fields = ("density", "velocity", "divergence")
    dj = JMS.Ecosmog(dir_sim=str(tmp_path), boxsize=BOX,
                     domain_level=ngrid).density_fields(
        jnp.asarray(data["pos"]), jnp.asarray(data["vel"]), window="tsc",
        fields=fields)
    dt = TMS.Ecosmog(dir_sim=str(tmp_path), boxsize=BOX,
                     domain_level=ngrid).density_fields(
        data["pos"], data["vel"], window="tsc", fields=fields,
        device="cpu")
    for name in fields:
        w = np.asarray(dj[name])
        npt.assert_allclose(dt[name].numpy(), w, rtol=0,
                            atol=1e-6 * np.abs(w).max())
    cell = (BOX / ngrid) ** 3
    npt.assert_allclose(float(dt["density"].double().sum()) * cell,
                        side ** 3, rtol=1e-5)
