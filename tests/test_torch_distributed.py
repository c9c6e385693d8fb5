"""The port's distributed layer, part A, against the JAX package's on the
CPU: the pencil FFT, the distributed P(k) (CIC, batched, fast), the
bispectrum in both bodies, the painter in a shard body, the multipoles,
the default weights, the weighted shot noise and the sharded map filters.

The JAX reference runs in this process on the conftest's 8-device mesh.
The port runs as a gloo world of 8 processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy) on the mesh
shapes below; every rank writes its blocks, and each is held against the
JAX device of the same mesh coordinates. One world serves the whole file
(a module-scoped fixture). Inputs are made with numpy from seeds. Each
tolerance is stated where it is checked: the JAX test's own bar or
tighter, equality for mode counts and for outputs that every rank must
hold alike.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from astrild_tpu.ops import bispectrum as JOB  # noqa: E402
from astrild_tpu.ops import filters as JF  # noqa: E402
from astrild_tpu.ops import mocks as JMO  # noqa: E402
from astrild_tpu.ops import paint as JPA  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu.ops import tpcf as JTP  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel import bispectrum as JB  # noqa: E402
from astrild_tpu.parallel import maps as JM  # noqa: E402
from astrild_tpu.parallel import power as JP  # noqa: E402
from astrild_tpu.parallel.pfft import make_pfft3d as jmake_pfft3d  # noqa
from astrild_tpu_torch.parallel import make_mesh  # noqa: E402
from astrild_tpu_torch.parallel import power as TP  # noqa: E402
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

BOX = 100.0
NG = 16
NRANKS = 8
# the JAX tests' mesh (2, 2, 2) and one other shape of 8 ranks
SHAPES = ((2, 2, 2), (1, 2, 4))
# the sharded map filter's cases (tests/test_distributed_maps.py)
MAP_CASES = (((1, 4, 2), 128, 5.0, 4.0), ((2, 2, 2), 96, 10.0, 8.0),
             ((1, 8, 1), 256, 5.0, 2.0))
AXES = ("sim", "x", "y")


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


_WORKER = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.ops import paint as TPA
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import bispectrum as DB
    from astrild_tpu_torch.parallel import maps as DM
    from astrild_tpu_torch.parallel import power as DP
    from astrild_tpu_torch.parallel.mesh import psum, shard
    from astrild_tpu_torch.parallel.pfft import make_pfft3d

    AXES = ("sim", "x", "y")
    BOX, NG = 100.0, 16
    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    out = {}

    def put(key, value):
        if isinstance(value, tuple):
            for name, v in zip(value._fields, value):
                out[key + "." + name] = v.numpy()
        else:
            out[key] = value.numpy()

    def rows(mesh, x):
        return shard(x, mesh, (AXES,))

    for shape in [tuple(s) for s in inp["shapes"].tolist()]:
        mesh = make_mesh(*shape, device="cpu")
        tag = "x".join(map(str, shape)) + ":"
        pencil = ("x", "y", None)
        # pencil FFT and its inverse
        fwd, inv = make_pfft3d(mesh), make_pfft3d(mesh, inverse=True)
        spec = fwd(shard(inp["field"], mesh, pencil))
        put(tag + "pfft", spec)
        put(tag + "pfft_back", inv(spec).real)
        # CIC P(k), (n, 3) and component-tuple input
        pos, w1 = rows(mesh, inp["pos"]), rows(mesh, inp["ones"])
        fn = DP.make_distributed_auto_power(mesh, NG, BOX, 6, window="cic")
        put(tag + "power", fn(pos, w1))
        put(tag + "power_t", fn(tuple(pos.t()), w1))
        # default weights (fn(pos) builds ones)
        put(tag + "power_default", fn(pos))
        mfn = DP.make_distributed_multipoles(mesh, NG, BOX, 6, window="cic")
        put(tag + "multipoles_default", mfn(rows(mesh, inp["pos"])))
        # batched: one simulation per 'sim' block
        bfn = DP.make_distributed_auto_power(mesh, NG, BOX, 5, window="cic",
                                             batched=True)
        put(tag + "batched", bfn(shard(inp["pos_b"], mesh,
                                       ("sim", ("x", "y"), None)),
                                 shard(inp["ones_b"], mesh,
                                       ("sim", ("x", "y")))))
        # the fast estimator: K1's plain version (deposit=None) and the
        # scatter, (n, 3) and components, unit and non-uniform weights
        ffn = DP.make_distributed_auto_power_fast(mesh, NG, BOX, 6)
        put(tag + "fast", ffn(pos, w1))
        put(tag + "fast_t", ffn(tuple(pos.t()), w1))
        put(tag + "fast_scatter", DP.make_distributed_auto_power_fast(
            mesh, NG, BOX, 6, deposit="scatter")(pos, w1))
        wv = rows(mesh, inp["w"])
        put(tag + "fast_w", ffn(pos, wv))
        put(tag + "shot_w", DP._weighted_shotnoise(wv, BOX, mesh, AXES))
        # the bispectrum, full and truncated bodies
        put(tag + "bk_full", DB.make_distributed_bispectrum(
            mesh, NG, BOX, nbins=3, m_min=1.0, m_max=7.0)(
            shard(inp["grid16"], mesh, pencil)))
        put(tag + "bk_trunc", DB.make_distributed_bispectrum(
            mesh, 32, BOX, nbins=3, m_min=1.0, m_max=4.0)(
            shard(inp["grid32"], mesh, pencil)))
        # the painter in a shard body: each rank paints its rows, psum
        for order, window in ((2, "cic"), (3, "tsc")):
            g = TPA.paint(rows(mesh, inp["pos4096"]), NG, BOX,
                          window=window)
            put(tag + "painter_" + window, psum(g, mesh, AXES))
        # redshift-space multipoles
        rsd = rows(mesh, inp["pos_rsd"])
        put(tag + "multipoles", mfn(rsd, rows(mesh, inp["ones_rsd"])))
        put(tag + "multipoles_t", mfn(tuple(rsd.t()),
                                      rows(mesh, inp["ones_rsd"])))
    # the sharded map filters (tests/test_distributed_maps.py)
    for i, (shape, n, theta, sigma) in enumerate(
            [(tuple(int(v) for v in c[:3]), int(c[3]), float(c[4]),
              float(c[5])) for c in inp["map_cases"].tolist()]):
        mesh = make_mesh(*shape, device="cpu")
        fn = DM.make_sharded_gaussian_filter(mesh, n, theta, sigma)
        put("map%d" % i, fn(shard(inp["img%d" % i], mesh, ("x", None))))
    mesh = make_mesh(1, 4, 2, device="cpu")
    put("pfft2d", DM.pfft2d_local(shard(inp["img64"], mesh, ("x", None)),
                                  mesh))
    np.savez(work + "/out_%d.npz" % rank, **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


def _inputs():
    rng = np.random.default_rng(42)
    pk = lambda k: 5e3 * jnp.exp(-((k / 0.1) ** 2))  # noqa: E731
    pos, vel = JMO.zeldovich_catalog_with_velocities(
        jax.random.PRNGKey(2), 16, BOX, pk, 0.5)
    pos_rsd = np.asarray(JTP.to_redshift_space(pos, vel, BOX), np.float32)
    inp = {
        "shapes": np.asarray(SHAPES),
        "field": rng.standard_normal((NG, NG, NG)).astype(np.float32),
        "pos": rng.uniform(0, BOX, (8192, 3)).astype(np.float32),
        "ones": np.ones(8192, np.float32),
        "w": rng.uniform(0.5, 2.0, 8192).astype(np.float32),
        "pos_b": rng.uniform(0, BOX, (2, 4096, 3)).astype(np.float32),
        "ones_b": np.ones((2, 4096), np.float32),
        "grid16": (1.0 + 0.2 * rng.standard_normal((NG, NG, NG))
                   ).astype(np.float32),
        "grid32": (1.0 + 0.2 * rng.standard_normal((32, 32, 32))
                   ).astype(np.float32),
        "pos4096": rng.uniform(0, BOX, (4096, 3)).astype(np.float32),
        "pos_rsd": pos_rsd,
        "ones_rsd": np.ones(pos_rsd.shape[0], np.float32),
        "map_cases": np.asarray([s + (n, th, sg)
                                 for s, n, th, sg in MAP_CASES], np.float64),
        "img64": rng.standard_normal((64, 64)).astype(np.float32),
    }
    for i, (_, n, _, _) in enumerate(MAP_CASES):
        inp["img%d" % i] = rng.standard_normal((n, n)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, outputs of every rank): the 8-rank world run once."""
    work = tmp_path_factory.mktemp("torch_dist")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, NRANKS, work, timeout=300)
    outs = [dict(np.load(work / f"out_{r}.npz")) for r in range(NRANKS)]
    return inp, outs


def _tag(shape):
    return "x".join(map(str, shape)) + ":"


def _jax_shard_of_rank(arr, mesh, rank):
    """The shard JAX keeps on device `rank` of `mesh`."""
    dev = mesh.devices.reshape(-1)[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


def _put(x, mesh, *spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_fft_matches_jax(world, shape):
    """Every rank's TRANSPOSED_OUT block equals the JAX shard on the
    device of its mesh coordinates (JAX's bar: rtol 2e-4, atol 2e-3), and
    the blocks together are fftn."""
    inp, outs = world
    mesh = jmake_mesh(*shape)
    got_j = jmake_pfft3d(mesh)(_put(inp["field"], mesh, "x", "y", None))
    for r in range(NRANKS):
        blk = outs[r][_tag(shape) + "pfft"]
        assert blk.shape == (NG, NG // shape[1], NG // shape[2])
        npt.assert_allclose(blk, _jax_shard_of_rank(got_j, mesh, r),
                            rtol=2e-4, atol=2e-3)
    want = np.fft.fftn(inp["field"])
    _, px, py = shape
    nj, nk = NG // px, NG // py
    for r in range(NRANKS):
        xi, yi = (r // py) % px, r % py
        npt.assert_allclose(outs[r][_tag(shape) + "pfft"],
                            want[:, xi * nj:(xi + 1) * nj,
                                 yi * nk:(yi + 1) * nk],
                            rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_fft_roundtrip(world, shape):
    """The inverse returns each rank's input block (JAX's bar, 1e-4)."""
    inp, outs = world
    _, px, py = shape
    nx, ny = NG // px, NG // py
    for r in range(NRANKS):
        xi, yi = (r // py) % px, r % py
        npt.assert_allclose(outs[r][_tag(shape) + "pfft_back"],
                            inp["field"][xi * nx:(xi + 1) * nx,
                                         yi * ny:(yi + 1) * ny],
                            rtol=1e-4, atol=1e-4)


def _jax_row_put(mesh, x):
    return _put(x, mesh, AXES, *([None] * (np.ndim(x) - 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_distributed_power_matches_jax(world, shape):
    """CIC P(k) through the port's painter against JAX's factory on the
    same mesh: mode counts equal, k to 1e-6, P to the JAX test's bar
    (rtol 5e-3, atol 1e-3 shot) and in fact to 1e-4 of the shot noise;
    the component tuple equals the (n, 3) input to 1e-6."""
    inp, outs = world
    mesh = jmake_mesh(*shape)
    jfn = JP.make_distributed_auto_power(mesh, NG, BOX, 6, window="cic")
    want = jfn(_jax_row_put(mesh, inp["pos"]),
               _jax_row_put(mesh, inp["ones"]))
    shot = BOX ** 3 / 8192
    t = _tag(shape) + "power."
    npt.assert_array_equal(_replicated(outs, t + "nmodes"),
                           np.asarray(want.nmodes))
    npt.assert_allclose(_replicated(outs, t + "k"), np.asarray(want.k),
                        rtol=1e-6)
    got = _replicated(outs, t + "power")
    npt.assert_allclose(got, np.asarray(want.power), rtol=5e-3,
                        atol=1e-3 * shot)
    npt.assert_allclose(got, np.asarray(want.power), rtol=0,
                        atol=1e-4 * shot)
    npt.assert_allclose(_replicated(outs, _tag(shape) + "power_t.power"),
                        got, rtol=1e-6)
    # and the JAX package's single-device estimator, as its test holds it
    g = JPA.paint(jnp.asarray(inp["pos"]), NG, BOX, window="cic")
    ref = JPS.auto_power(g, BOX, nbins=6, window="cic", shotnoise=shot)
    npt.assert_array_equal(got.shape, np.asarray(ref.power).shape)
    npt.assert_allclose(got, np.asarray(ref.power), rtol=5e-3,
                        atol=1e-3 * shot)


@pytest.mark.parametrize("shape", SHAPES)
def test_distributed_power_batched_sims(world, shape):
    """batched=True: each rank holds the rows of its 'sim' block, as JAX's
    out_specs P('sim') give; against the JAX factory (rtol 5e-3, atol
    1e-3 shot, the JAX test's bar; counts equal)."""
    inp, outs = world
    mesh = jmake_mesh(*shape)
    jfn = JP.make_distributed_auto_power(mesh, NG, BOX, 5, window="cic",
                                         batched=True)
    want = jfn(_put(inp["pos_b"], mesh, "sim", ("x", "y"), None),
               _put(inp["ones_b"], mesh, "sim", ("x", "y")))
    n_sim = shape[0]
    shot = BOX ** 3 / 4096
    for r in range(NRANKS):
        s = r // (shape[1] * shape[2])
        rows = slice(s * 2 // n_sim, (s + 1) * 2 // n_sim)
        key = _tag(shape) + "batched."
        assert outs[r][key + "power"].shape == (2 // n_sim, 5)
        npt.assert_array_equal(outs[r][key + "nmodes"],
                               np.asarray(want.nmodes)[rows])
        npt.assert_allclose(outs[r][key + "power"],
                            np.asarray(want.power)[rows], rtol=5e-3,
                            atol=1e-3 * shot)


@pytest.mark.parametrize("shape", SHAPES)
def test_distributed_fast_power_matches_jax(world, shape):
    """The fast estimator (K1's plain version in the shard body) against
    JAX's factory on the same mesh (k to 1e-6, counts equal, P to 1e-4 of
    the shot noise, inside the JAX test's rtol 5e-3 / atol 2e-3 shot) and
    against JAX's single-device auto_power_fast with the JAX test's bar;
    the component tuple and the explicit scatter give the same P (1e-6)."""
    inp, outs = world
    mesh = jmake_mesh(*shape)
    want = JP.make_distributed_auto_power_fast(mesh, NG, BOX, 6)(
        _jax_row_put(mesh, inp["pos"]), _jax_row_put(mesh, inp["ones"]))
    shot = BOX ** 3 / 8192
    t = _tag(shape)
    got = _replicated(outs, t + "fast.power")
    npt.assert_array_equal(_replicated(outs, t + "fast.nmodes"),
                           np.asarray(want.nmodes))
    npt.assert_allclose(_replicated(outs, t + "fast.k"), np.asarray(want.k),
                        rtol=1e-6)
    npt.assert_allclose(got, np.asarray(want.power), rtol=0,
                        atol=1e-4 * shot)
    xyz = tuple(jnp.asarray(inp["pos"][:, i]) for i in range(3))
    ref = JPS.auto_power_fast(xyz, NG, BOX, nbins=6, deposit="scatter")
    npt.assert_allclose(got, np.asarray(ref.power), rtol=5e-3,
                        atol=2e-3 * shot)
    for other in ("fast_t", "fast_scatter"):
        npt.assert_allclose(_replicated(outs, t + other + ".power"), got,
                            rtol=1e-6)
        npt.assert_array_equal(_replicated(outs, t + other + ".nmodes"),
                               _replicated(outs, t + "fast.nmodes"))


@pytest.mark.parametrize("shape", SHAPES)
def test_weighted_shot_noise(world, shape):
    """Non-uniform weights: the distributed shot noise is V sum(w^2) /
    (sum w)^2 of the global weights (float64 numpy, rtol 1e-6), and the
    weighted fast P(k) equals JAX's factory to 1e-4 of that shot noise."""
    inp, outs = world
    w = inp["w"].astype(np.float64)
    shot = BOX ** 3 * np.sum(w * w) / np.sum(w) ** 2
    t = _tag(shape)
    npt.assert_allclose(_replicated(outs, t + "shot_w"), shot, rtol=1e-6)
    assert abs(shot / (BOX ** 3 / 8192) - 1.0) > 0.05  # not V/N
    mesh = jmake_mesh(*shape)
    want = JP.make_distributed_auto_power_fast(mesh, NG, BOX, 6)(
        _jax_row_put(mesh, inp["pos"]), _jax_row_put(mesh, inp["w"]))
    npt.assert_allclose(_replicated(outs, t + "fast_w.power"),
                        np.asarray(want.power), rtol=0, atol=1e-4 * shot)


def test_fast_power_deposit_spellings():
    """deposit=None on a CPU block is K1's plain version (equal to the
    scatter); the JAX spelling 'pallas' means the kernel, which a CPU
    tensor refuses, and 'pallas_interpret' has no port."""
    mesh = make_mesh(1, 1, 1, device="cpu")
    pos = torch.from_numpy(np.random.default_rng(5).uniform(
        0, BOX, (2048, 3)).astype(np.float32))
    a = TP.make_distributed_auto_power_fast(mesh, NG, BOX, 4)(pos)
    b = TP.make_distributed_auto_power_fast(mesh, NG, BOX, 4,
                                            deposit="scatter")(pos)
    npt.assert_array_equal(a.power.numpy(), b.power.numpy())
    for spelling, match in (("pallas", "CUDA"),
                            ("pallas_interpret", "interpret")):
        fn = TP.make_distributed_auto_power_fast(mesh, NG, BOX, 4,
                                                 deposit=spelling)
        with pytest.raises(ValueError, match=match):
            fn(pos)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("body", ["full", "truncated"])
def test_distributed_bispectrum_matches_jax(world, shape, body):
    """Both bodies against JAX's factory on the same mesh: ntri to 1e-4
    (the JAX test's bar), B on closed triangles to rtol 2e-3 / atol 1e-8
    (its bar), k1 to 1e-6."""
    inp, outs = world
    mesh = jmake_mesh(*shape)
    if body == "full":
        grid, ng, m_max, key = inp["grid16"], NG, 7.0, "bk_full"
    else:
        grid, ng, m_max, key = inp["grid32"], 32, 4.0, "bk_trunc"
        assert JB._coarse_size(ng, m_max) == 16  # truncation engaged
        # the JAX package caches these tables from its first call; made
        # inside a shard_map trace they hold that trace's values, which a
        # later mesh cannot use, so make them outside any trace
        JOB.get_bispectrum_tables.cache_clear()
        JOB.get_bispectrum_tables(16, 3, 1.0, m_max)
    want = JB.make_distributed_bispectrum(mesh, ng, BOX, nbins=3,
                                          m_min=1.0, m_max=m_max)(
        _put(grid, mesh, "x", "y", None))
    t = _tag(shape) + key + "."
    ntri = _replicated(outs, t + "ntri")
    npt.assert_allclose(ntri, np.asarray(want.ntri), rtol=1e-4, atol=1.0)
    closed = np.asarray(want.ntri) > 1.0
    npt.assert_allclose(_replicated(outs, t + "b")[closed],
                        np.asarray(want.b)[closed], rtol=2e-3, atol=1e-8)
    npt.assert_array_equal(np.isnan(_replicated(outs, t + "b")),
                           np.isnan(np.asarray(want.b)))
    npt.assert_allclose(_replicated(outs, t + "k1"), np.asarray(want.k1),
                        rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", ["cic", "tsc"])
def test_painter_in_shard_body_matches_local(world, shape, window):
    """Each rank paints its rows (K2's plain version on the CPU) and the
    psum over the mesh equals JAX's single-device paint of all particles
    (the JAX test's bar, 2e-5 of the max)."""
    inp, outs = world
    want = np.asarray(JPA.paint(jnp.asarray(inp["pos4096"]), NG, BOX,
                                window=window))
    got = _replicated(outs, _tag(shape) + "painter_" + window)
    npt.assert_allclose(got, want, atol=2e-5 * max(1.0, want.max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_distributed_multipoles_match_jax(world, shape):
    """Redshift-space multipoles against JAX's factory on the same mesh
    (counts equal, k to 1e-6, P_ell to rtol 5e-3 / atol 2e-3 shot, the
    JAX test's bar, and to 1e-4 of the shot noise); the component tuple
    equals the (n, 3) input to 1e-6; the quadrupole is nonzero."""
    inp, outs = world
    mesh = jmake_mesh(*shape)
    n_part = inp["pos_rsd"].shape[0]
    want = JP.make_distributed_multipoles(mesh, NG, BOX, 6, window="cic")(
        _jax_row_put(mesh, inp["pos_rsd"]),
        _jax_row_put(mesh, inp["ones_rsd"]))
    shot = BOX ** 3 / n_part
    t = _tag(shape) + "multipoles."
    npt.assert_array_equal(_replicated(outs, t + "nmodes"),
                           np.asarray(want.nmodes))
    npt.assert_allclose(_replicated(outs, t + "k"), np.asarray(want.k),
                        rtol=1e-6)
    got = _replicated(outs, t + "p_ell")
    npt.assert_allclose(got, np.asarray(want.p_ell), rtol=5e-3,
                        atol=2e-3 * shot)
    npt.assert_allclose(got, np.asarray(want.p_ell), rtol=0,
                        atol=1e-4 * shot)
    npt.assert_allclose(
        _replicated(outs, _tag(shape) + "multipoles_t.p_ell"), got,
        rtol=1e-6, atol=1e-6 * shot)
    assert np.abs(got[1][:3]).max() > 0.05 * np.abs(got[0][:3]).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_distributed_factories_default_weights(world, shape):
    """fn(pos) builds unit weights: equal to fn(pos, ones) (1e-6), and the
    multipoles come out finite."""
    _, outs = world
    t = _tag(shape)
    npt.assert_allclose(_replicated(outs, t + "power_default.power"),
                        _replicated(outs, t + "power.power"), rtol=1e-6)
    assert np.all(np.isfinite(_replicated(outs,
                                          t + "multipoles_default.p_ell")))


@pytest.mark.parametrize("case", range(len(MAP_CASES)))
def test_sharded_gaussian_matches_local(world, case):
    """Each rank's row block of the filtered map against JAX's sharded
    filter on the same mesh and JAX's single-device filter (atol 2e-4,
    the JAX test's bar)."""
    inp, outs = world
    shape, n, theta, sigma = MAP_CASES[case]
    img = inp["img%d" % case]
    want = np.asarray(JF.gaussian(jnp.asarray(img), theta,
                                  sigma_arcmin=sigma))
    mesh = jmake_mesh(*shape)
    got_j = JM.make_sharded_gaussian_filter(mesh, n, theta, sigma)(
        _put(img, mesh, "x", None))
    _, px, py = shape
    rows = n // px
    for r in range(NRANKS):
        blk = outs[r]["map%d" % case]
        xi = (r // py) % px
        assert blk.shape == (rows, n)
        npt.assert_allclose(blk, want[xi * rows:(xi + 1) * rows],
                            atol=2e-4)
        npt.assert_allclose(blk, _jax_shard_of_rank(got_j, mesh, r),
                            atol=2e-4)


def test_pfft2d_matches_fft2(world):
    """pfft2d's transposed blocks (columns over 'x') against fft2 and the
    JAX body's shards (rtol 1e-3, atol 1e-2, the JAX test's bar)."""
    inp, outs = world
    img = inp["img64"]
    want = np.fft.fft2(img)
    mesh = jmake_mesh(1, 4, 2)
    fn = jax.jit(jax.shard_map(JM.pfft2d_local, mesh=mesh,
                               in_specs=P("x", None),
                               out_specs=P(None, "x")))
    got_j = fn(_put(img, mesh, "x", None))
    for r in range(NRANKS):
        blk = outs[r]["pfft2d"]
        xi = r // 2
        npt.assert_allclose(blk, want[:, xi * 16:(xi + 1) * 16], rtol=1e-3,
                            atol=1e-2)
        npt.assert_allclose(blk, _jax_shard_of_rank(got_j, mesh, r),
                            rtol=1e-3, atol=1e-2)


def test_mesh_rank_layout_and_world_size():
    """make_mesh works in a plain process (a world of one), raises with
    JAX's message on a wrong size, and shard/unshard follow JAX's
    row-major layout."""
    from astrild_tpu_torch.parallel import mesh as TM

    mesh = make_mesh(1, 1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("sim", "x", "y")
    with pytest.raises(ValueError, match="mesh 2x2x2 needs 8 devices, "
                                         "have 1"):
        make_mesh(2, 2, 2, device="cpu")
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(TM.shard(x, mesh, ("x", None)), x)
    assert torch.equal(TM.unshard(x, mesh, ("x", None)), x)
    assert TM.pencil_sharding(mesh) == ("x", "y", None)
    assert TM.replicated(mesh) == ()
    assert TM.auto_mesh(device="cpu").shape == (1, 1, 1)
    assert TM.sim_axis_mesh(device="cpu").shape == (1, 1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            make_mesh(1, 1, 1)
