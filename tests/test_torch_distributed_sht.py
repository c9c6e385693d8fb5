"""The port's distributed SHTs (parallel/sht.py, parallel/sht_large.py)
and SkyHealpix(mesh=) against the JAX package on the CPU.

The port runs as a gloo world of 4 processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy) on mesh
(1, 2, 2): the transforms split over 'x' of size 2, as on the JAX tests'
mesh22. The JAX references run in this process. The m-sharded scan path
is held to the port's unsharded scan path bit for bit (the same
recursion rows, one psum of disjoint rows; the JAX test's own bar against
its local path) and to the JAX package within the bars of
tests/test_torch_sht_large.py; nside 64 / lmax 160 puts rows on both
ranks (the m-blocks of 128: m < 128 on rank 0, the rest on rank 1),
which the JAX tests' lmax <= 63 never does. Each tolerance is stated
where it is checked.
"""
import textwrap
import warnings

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu.models import SkyHealpix as JSH  # noqa: E402
from astrild_tpu.ops import sht as JS  # noqa: E402
from astrild_tpu.ops import sht_large as JL  # noqa: E402
from astrild_tpu.ops import sht_spin_large as JSL  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel import sht as JDS  # noqa: E402
from astrild_tpu.parallel import sht_large as JDL  # noqa: E402
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

NRANKS = 4
LARGE = ((16, 31), (16, 63))
SOLVES = (("jacobi", 2), ("cg", 3))
BLOCKS = (64, 160)
TABLE = (8, 12)
SKY = (16, 31)
# tests/test_torch_sht_large.py's bars against JAX: 1e-5 of the max, and
# 1.5e-5 where the JAX package scans two m-blocks
TOL, BLOCK_TOL = 1e-5, 1.5e-5

_WORKER = textwrap.dedent('''
    import sys
    import warnings
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.models import SkyHealpix
    from astrild_tpu_torch.ops import sht_large as SL
    from astrild_tpu_torch.ops import sht_spin_large as SSL
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import sht as DS
    from astrild_tpu_torch.parallel import sht_large as DL

    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    out = {}
    mesh = make_mesh(1, 2, 2, device="cpu")

    def put(key, value):
        for i, v in enumerate(value):
            out[key + "." + str(i)] = np.asarray(v)

    # the ring-sharded table path
    nside, lmax = inp["table"].tolist()
    synth, analyze = DS.make_distributed_sht(mesh, nside, lmax)
    out["table_synth"] = synth(inp["table_re"], inp["table_im"]).numpy()
    put("table_analyze", analyze(inp["table_map"].numpy(), niter=3))
    # the m-sharded scan paths, and the unsharded ones on the same input
    for nside, lmax in inp["large"].tolist():
        t = "%d_%d" % (nside, lmax)
        synth, analyze = DL.make_distributed_sht_large(mesh, nside, lmax)
        a = (inp["alm_re_" + t], inp["alm_im_" + t])
        out["synth_" + t] = synth(*a).numpy()
        out["synth1_" + t] = SL.synthesize_large(*a, nside, lmax).numpy()
        m = inp["map_" + t]
        for method, niter in (("jacobi", 2), ("cg", 3)):
            put("analyze_%s_%s" % (t, method),
                analyze(m, niter=niter, method=method))
            put("analyze1_%s_%s" % (t, method),
                SL.analyze_large(m, nside, lmax, niter=niter,
                                 method=method))
        try:
            analyze(m, method="jacobi3")
        except ValueError as e:
            out["method_raise"] = np.asarray("method" in str(e))
        eb = tuple(inp["eb%d_%s" % (k, t)] for k in range(4))
        s2, a2 = DL.make_distributed_sht_spin2_large(mesh, nside, lmax)
        put("spin2_" + t, s2(*eb))
        put("spin2_1_" + t, SSL.synthesize_spin2_large(*eb, nside, lmax))
        q, u = inp["q_" + t], inp["u_" + t]
        for method, niter in (("jacobi", 2), ("cg", 3)):
            put("spin2_analyze_%s_%s" % (t, method),
                a2(q, u, niter=niter, method=method))
            put("spin2_analyze1_%s_%s" % (t, method),
                SSL.analyze_spin2_large(q, u, nside, lmax, niter=niter,
                                        method=method))
        if lmax == 31:
            s1, a1 = DL.make_distributed_sht_spin1_large(mesh, nside, lmax)
            put("spin1_" + t, s1(*eb))
            put("spin1_1_" + t, SSL.synthesize_spin1_large(*eb, nside,
                                                           lmax))
            put("spin1_analyze_" + t, a1(q, u, niter=2, method="jacobi"))
            put("spin1_analyze1_" + t, SSL.analyze_spin1_large(
                q, u, nside, lmax, niter=2, method="jacobi"))
    # rows on both ranks
    nside, lmax = inp["blocks"].tolist()
    synth, analyze = DL.make_distributed_sht_large(mesh, nside, lmax)
    a = (inp["blk_re"], inp["blk_im"])
    out["blk_synth"] = synth(*a).numpy()
    out["blk_synth1"] = SL.synthesize_large(*a, nside, lmax).numpy()
    put("blk_analyze", analyze(inp["blk_map"], niter=1, method="jacobi"))
    put("blk_analyze1", SL.analyze_large(inp["blk_map"], nside, lmax,
                                         niter=1, method="jacobi"))
    s2, _ = DL.make_distributed_sht_spin2_large(mesh, nside, lmax)
    eb = (inp["blk_re"], inp["blk_im"], inp["blk_im"], inp["blk_re"])
    put("blk_spin2", s2(*eb))
    put("blk_spin2_1", SSL.synthesize_spin2_large(*eb, nside, lmax))
    # SkyHealpix(mesh=): the m-sharded analysis and shear, the cache
    nside, lmax = inp["sky"].tolist()
    sky = SkyHealpix(inp["sky_map"], device="cpu")
    out["sky_anafast"] = sky.anafast(lmax, niter=2, mesh=mesh)
    sky.anafast(lmax, niter=2, mesh=mesh)
    out["sky_cached"] = np.asarray(len(SkyHealpix._dist_sht))
    put("sky_shear", sky.shear_from_kappa(lmax=lmax, niter=2, mesh=mesh))
    try:
        sky.anafast(lmax, mesh=mesh, ax="rings")
    except ValueError as e:
        out["sky_axis_raise"] = np.asarray("no axis 'rings'" in str(e))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sky.anafast(lmax, niter=0, mesh=mesh, ax="sim")
    out["sky_warned"] = np.asarray(any("no speedup" in str(x.message)
                                       for x in w))
    n_cached = len(SkyHealpix._dist_sht)
    sky_b = SkyHealpix(inp["sky_map"] * 2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sky_b.anafast(lmax, niter=0, mesh=mesh, ax="sim")
    out["sky_shared"] = np.asarray(len(SkyHealpix._dist_sht) == n_cached)
    np.savez(work + "/out_%d.npz" % rank, **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


def _alms(rng, lmax, lmin=0, scale=0.1):
    lg = np.arange(lmax + 1)[:, None]
    mg = np.arange(lmax + 1)[None, :]
    valid = ((mg <= lg) & (lg >= lmin)).astype(np.float32)
    re = (rng.standard_normal((lmax + 1,) * 2) * valid * scale
          ).astype(np.float32)
    im = (rng.standard_normal((lmax + 1,) * 2) * valid * scale
          ).astype(np.float32)
    im[:, 0] = 0.0
    return re, im


def _inputs():
    rng = np.random.default_rng(5)
    nside, lmax = TABLE
    re, im = _alms(rng, lmax, scale=1.0)
    inp = {"table": np.asarray(TABLE), "table_re": re, "table_im": im,
           "large": np.asarray(LARGE), "blocks": np.asarray(BLOCKS),
           "sky": np.asarray(SKY)}
    inp["table_map"] = JDS.pad_map(np.asarray(JS.synthesize(
        re, im, nside, lmax)), nside)
    for nside, lmax in LARGE:
        t = "%d_%d" % (nside, lmax)
        inp["alm_re_" + t], inp["alm_im_" + t] = _alms(rng, lmax)
        inp["map_" + t] = rng.standard_normal(12 * nside ** 2
                                              ).astype(np.float32)
        e = _alms(rng, lmax, lmin=2)
        b = _alms(rng, lmax, lmin=2)
        for k, v in enumerate(e + b):
            inp["eb%d_%s" % (k, t)] = v
        inp["q_" + t] = rng.standard_normal(12 * nside ** 2
                                            ).astype(np.float32)
        inp["u_" + t] = rng.standard_normal(12 * nside ** 2
                                            ).astype(np.float32)
    nside, lmax = BLOCKS
    inp["blk_re"], inp["blk_im"] = _alms(rng, lmax, lmin=2)
    inp["blk_map"] = rng.standard_normal(12 * nside ** 2).astype(np.float32)
    nside, lmax = SKY
    cl = np.zeros(lmax + 1)
    cl[2:] = 1.0 / np.arange(2, lmax + 1) ** 2
    inp["sky_map"] = np.asarray(JSH.from_Cl_array(
        cl, "kappa_2", nside, lmax=lmax, rnd_seed=1).data["orig"],
        np.float32)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, outputs of every rank): the 4-rank world run once."""
    work = tmp_path_factory.mktemp("torch_dist_sht")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, NRANKS, work, timeout=300)
    return inp, [dict(np.load(work / f"out_{r}.npz"))
                 for r in range(NRANKS)]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def mesh22():
    return jmake_mesh(2, 2, 2)


def test_distributed_sht_matches_local(world, mesh22):
    """Mirror of test_distributed.py:257: the ring-sharded table path.
    Each rank holds its (nring_p / 2, pmax) block (ranks 0, 1 the first
    half: x = rank // 2); the assembled map matches the JAX package's
    local synthesis and its ring-sharded one (the JAX test's bar, atol
    2e-5), and the analysis (niter 3) returns the input alms (atol 5e-4)
    and the JAX distributed analysis within 1e-5."""
    inp, outs = world
    nside, lmax = TABLE
    blocks = [outs[r]["table_synth"] for r in (0, 2)]
    for r in (1, 3):
        npt.assert_array_equal(outs[r]["table_synth"],
                               outs[r - 1]["table_synth"])
    plane = np.concatenate(blocks)
    got_map = JDS.unpad_map(plane[: 4 * nside - 1], nside)
    want = np.asarray(JS.synthesize(inp["table_re"], inp["table_im"], nside,
                                    lmax))
    npt.assert_allclose(got_map, want, atol=2e-5)
    synth_j, analyze_j = JDS.make_distributed_sht(mesh22, nside, lmax)
    npt.assert_allclose(plane, np.asarray(synth_j(inp["table_re"],
                                                  inp["table_im"])),
                        atol=2e-5)
    b_re = _replicated(outs, "table_analyze.0")
    b_im = _replicated(outs, "table_analyze.1")
    npt.assert_allclose(b_re, inp["table_re"], atol=5e-4)
    npt.assert_allclose(b_im, inp["table_im"], atol=5e-4)
    j_re, j_im = analyze_j(inp["table_map"], niter=3)
    npt.assert_allclose(b_re, np.asarray(j_re), atol=1e-5)
    npt.assert_allclose(b_im, np.asarray(j_im), atol=1e-5)


@pytest.mark.parametrize("nside,lmax", LARGE)
def test_distributed_sht_large_matches_local(world, nside, lmax):
    """Mirror of test_distributed.py:280: the m-sharded scalar scan path
    (lmax ~2 nside, Jacobi's regime, and 4 nside - 1, the alias fold and
    CG's), synthesis and both solvers equal to the port's unsharded path
    bit for bit (the JAX test's own bar against its local path) and
    within 1e-5 of the max of the JAX package's local path."""
    inp, outs = world
    t = "%d_%d" % (nside, lmax)
    got = _replicated(outs, "synth_" + t)
    npt.assert_array_equal(got, outs[0]["synth1_" + t])
    _close(got, JL.synthesize_large(inp["alm_re_" + t], inp["alm_im_" + t],
                                    nside, lmax))
    for method, niter in SOLVES:
        want = JL.analyze_large(inp["map_" + t], nside, lmax, niter=niter,
                                method=method)
        for k in range(2):
            g = _replicated(outs, "analyze_%s_%s.%d" % (t, method, k))
            npt.assert_array_equal(
                g, outs[0]["analyze1_%s_%s.%d" % (t, method, k)])
            _close(g, want[k])


@pytest.mark.parametrize("nside,lmax", LARGE)
def test_distributed_sht_spin2_large_matches_local(world, nside, lmax):
    """Mirror of test_distributed.py:321: the m-sharded spin-2 scan path,
    (Q, U) and both solvers' E / B equal to the port's unsharded path bit
    for bit and within 1e-5 of the max of the JAX package's local path
    (the JAX test's own bars against its local path: 2e-6 of the std,
    5e-6 absolute)."""
    inp, outs = world
    t = "%d_%d" % (nside, lmax)
    eb = [inp["eb%d_%s" % (k, t)] for k in range(4)]
    want = JSL.synthesize_spin2_large(*eb, nside, lmax)
    for k in range(2):
        g = _replicated(outs, "spin2_%s.%d" % (t, k))
        npt.assert_array_equal(g, outs[0]["spin2_1_%s.%d" % (t, k)])
        _close(g, want[k])
    for method, niter in SOLVES:
        want = JSL.analyze_spin2_large(inp["q_" + t], inp["u_" + t], nside,
                                       lmax, niter=niter, method=method)
        for k in range(4):
            g = _replicated(outs, "spin2_analyze_%s_%s.%d" % (t, method, k))
            npt.assert_array_equal(
                g, outs[0]["spin2_analyze1_%s_%s.%d" % (t, method, k)])
            _close(g, want[k])


def test_distributed_sht_large_rejects_bad_method(world):
    """Mirror of test_distributed.py:519: an unknown method raises."""
    _, outs = world
    assert all(bool(o["method_raise"]) for o in outs)


def test_distributed_sht_spin1_large_matches_local(world, mesh22):
    """Mirror of test_distributed.py:673: the m-sharded spin-1 path,
    synthesis and the Jacobi analysis equal to the port's unsharded path
    bit for bit and within 1e-5 of the max of the JAX package's
    distributed path on mesh22."""
    inp, outs = world
    nside, lmax = 16, 31
    t = "%d_%d" % (nside, lmax)
    eb = [inp["eb%d_%s" % (k, t)] for k in range(4)]
    synth_j, analyze_j = JDL.make_distributed_sht_spin1_large(mesh22, nside,
                                                              lmax)
    want = synth_j(*eb)
    for k in range(2):
        g = _replicated(outs, "spin1_%s.%d" % (t, k))
        npt.assert_array_equal(g, outs[0]["spin1_1_%s.%d" % (t, k)])
        _close(g, want[k])
    want = analyze_j(inp["q_" + t], inp["u_" + t], niter=2, method="jacobi")
    for k in range(4):
        g = _replicated(outs, "spin1_analyze_%s.%d" % (t, k))
        npt.assert_array_equal(g, outs[0]["spin1_analyze1_%s.%d" % (t, k)])
        _close(g, want[k])


def test_m_rows_on_both_ranks(world):
    """nside 64, lmax 160: m < 128 on rank 0's recursion, 128 <= m <= 160
    on rank 1's; the scalar synthesis and analysis and the spin-2
    synthesis equal the port's unsharded path bit for bit, and the scalar
    synthesis is within 1.5e-5 of the max of the JAX package's (the bar of
    tests/test_torch_sht_large.py where JAX scans two m-blocks)."""
    inp, outs = world
    nside, lmax = BLOCKS
    got = _replicated(outs, "blk_synth")
    npt.assert_array_equal(got, outs[0]["blk_synth1"])
    _close(got, JL.synthesize_large(inp["blk_re"], inp["blk_im"], nside,
                                    lmax), BLOCK_TOL)
    for key, one in (("blk_analyze", "blk_analyze1"),
                     ("blk_spin2", "blk_spin2_1")):
        for k in range(2):
            npt.assert_array_equal(_replicated(outs, "%s.%d" % (key, k)),
                                   outs[0]["%s.%d" % (one, k)])


def test_skyhealpix_anafast_mesh_dispatch(world, mesh22):
    """Mirror of test_distributed.py:478: SkyHealpix.anafast(mesh=) takes
    the m-sharded scan path, within the JAX test's 1e-7 of the local
    facade's Cl and of the JAX facade's on mesh22, and reuses its cached
    factory; shear_from_kappa(mesh=) within 1e-5 of the shear's std of
    both; a missing axis raises, a size-1 axis warns, and the cache is
    shared across maps."""
    inp, outs = world
    nside, lmax = SKY
    sky = JSH(inp["sky_map"])
    want = sky.anafast(lmax, niter=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_d = sky.anafast(lmax, niter=2, mesh=mesh22)
        g1d, g2d = sky.shear_from_kappa(lmax=lmax, niter=2, mesh=mesh22)
    got = _replicated(outs, "sky_anafast")
    npt.assert_allclose(got, want, atol=1e-7)
    npt.assert_allclose(got, want_d, atol=1e-7)
    g1w, g2w = sky.shear_from_kappa(lmax=lmax, niter=2)
    scale = max(float(np.std(g1w)), 1e-6)
    for k, (w, wd) in enumerate(((g1w, g1d), (g2w, g2d))):
        g = _replicated(outs, "sky_shear.%d" % k)
        npt.assert_allclose(g, w, atol=1e-5 * scale)
        npt.assert_allclose(g, wd, atol=1e-5 * scale)
    for key in ("sky_axis_raise", "sky_warned", "sky_shared"):
        assert all(bool(o[key]) for o in outs), key
    assert int(outs[0]["sky_cached"]) == 1
