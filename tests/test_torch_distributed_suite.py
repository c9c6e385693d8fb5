"""The port's composed distributed z=0 suite against the JAX package's on
the CPU (tests/test_distributed_suite.py's case on the port).

The JAX reference runs in this process on the conftest's 8-device mesh,
and the JAX single-device chain beside it, as the JAX test builds it. The
port runs as a gloo world of 8 processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy): the suite
on the mesh (2, 2, 2) with the bispectrum's full body and on (1, 2, 4) with
its truncated body, from (n, 3) rows, from component tuples, and with
zero-weight padding rows. Each tolerance is stated where it is checked.
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
from astrild_tpu.ops import lensing as JL  # noqa: E402
from astrild_tpu.ops import peaks as JPK  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu.ops import voids as JV  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel.bispectrum import _coarse_size  # noqa: E402
from astrild_tpu.parallel.suite import (  # noqa: E402
    make_distributed_z0_suite as jsuite)
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

BOX = 500.0
NG = 32
NPLANES = 8
NRANKS = 8
N_PART = 1 << 17
N_PAD = 8 * 5  # zero-weight rows, 5 a rank
# (mesh shape, bk_m_max): the full body (n_c = 32 = NG) and the
# truncated body (n_c = 16 < NG)
CASES = (((2, 2, 2), 10.0), ((1, 2, 4), 4.0))
KW = dict(nbins_pk=10, nbins_bk=3, bk_m_min=2.0, nplanes=NPLANES,
          max_peaks=256, max_voids=64)


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
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel.mesh import shard
    from astrild_tpu_torch.parallel.suite import make_distributed_z0_suite

    AXES = ("sim", "x", "y")
    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    out = {}

    def put(key, res):
        for name, v in zip(res._fields, res):
            if isinstance(v, tuple):
                for sub, t in zip(v._fields, v):
                    out[key + "." + name + "." + sub] = t.numpy()
            else:
                out[key + "." + name] = v.numpy()

    for shape, m_max in zip(inp["shapes"].tolist(), inp["m_max"].tolist()):
        mesh = make_mesh(*shape, device="cpu")
        tag = "x".join(map(str, shape))
        fn = make_distributed_z0_suite(
            mesh, 32, 500.0, nbins_pk=10, nbins_bk=3, bk_m_min=2.0,
            bk_m_max=m_max, nplanes=8, max_peaks=256, max_voids=64)
        pos = shard(inp["pos"], mesh, (AXES, None))
        put(tag + ":rows", fn(pos))
        put(tag + ":tuple", fn(tuple(pos.t())))
        put(tag + ":padded", fn(shard(inp["pos_pad"], mesh, (AXES, None)),
                                shard(inp["w_pad"], mesh, (AXES,))))
    np.savez(work + "/out_%d.npz" % rank, **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, outputs of every rank): the 8-rank world run once."""
    work = tmp_path_factory.mktemp("torch_dist_suite")
    rng = np.random.default_rng(42)
    pos = rng.uniform(0, BOX, (N_PART, 3)).astype(np.float32)
    # 5 zero-weight rows at the origin after each rank's real rows
    per = N_PART // NRANKS
    blocks = [np.concatenate([pos[r * per:(r + 1) * per],
                              np.zeros((N_PAD // NRANKS, 3), np.float32)])
              for r in range(NRANKS)]
    w_pad = np.concatenate([np.r_[np.ones(per, np.float32),
                                  np.zeros(N_PAD // NRANKS, np.float32)]
                            for _ in range(NRANKS)])
    inp = {"shapes": np.asarray([c[0] for c in CASES]),
           "m_max": np.asarray([c[1] for c in CASES]),
           "pos": pos, "pos_pad": np.concatenate(blocks), "w_pad": w_pad}
    np.savez(work / "inputs.npz", **inp)
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, NRANKS, work, timeout=300)
    return inp, [dict(np.load(work / f"out_{r}.npz"))
                 for r in range(NRANKS)]


def _single_device_chain(pos, m_max):
    """The JAX test's single-device reference: the bench chain on
    contiguous z-slabs."""
    res, grid = JPS.auto_power_fast(
        tuple(jnp.asarray(pos[:, i]) for i in range(3)), NG, BOX, nbins=10,
        return_coarse_grid=True, deposit="scatter")
    bk = JOB.bispectrum_3d(grid, BOX, nbins=3, m_min=2.0, m_max=m_max)
    delta = grid / jnp.mean(grid) - 1.0
    planes = jnp.moveaxis(
        delta.reshape(NG, NG, NPLANES, NG // NPLANES).sum(3), -1, 0)
    chis = jnp.linspace(200.0, 2800.0, NPLANES)
    dchis = jnp.full((NPLANES,), BOX / NPLANES)
    kappa = JL.born_convergence(planes, chis, dchis, 3000.0, 0.3089)
    a1, a2 = JL.kappa_to_alpha(kappa, 0.35, padding_factor=2)
    g1, g2 = JL.alpha_to_gamma(a1, a2, 0.35)
    cat = JPK.find_peaks(kappa, threshold=jnp.std(kappa), max_peaks=256,
                         edge_pix=4)
    vcat = JV.find_tunnels(cat.pos.astype(jnp.float32),
                           cat.values > -jnp.inf, NG, max_voids=64)
    return res, bk, kappa, g1, g2, vcat


@pytest.mark.parametrize("case", range(len(CASES)))
def test_composed_suite_matches_jax(world, case):
    """The port's suite against JAX's suite on the same mesh: P(k) to
    1e-4 of the shot noise (inside the JAX test's rtol 5e-3 / atol 1e-3
    shot), mode counts equal, B to rtol 2e-3 on closed triangles (the JAX
    test holds its own to 2e-2), ntri to 1e-4, kappa and gamma to rtol
    1e-4 / atol 1e-6 (the JAX test's bar), the void counts and candidate
    counts equal and the radii to 1e-4; and against the JAX single-device
    chain with the JAX test's bars."""
    inp, outs = world
    shape, m_max = CASES[case]
    t = "x".join(map(str, shape)) + ":rows."
    mesh = jmake_mesh(*shape)
    # tables made outside any trace (the JAX package caches them)
    JOB.get_bispectrum_tables.cache_clear()
    n_c = _coarse_size(NG, m_max)
    assert (n_c < NG) == (case == 1)  # each body once
    JOB.get_bispectrum_tables(n_c, 3, 2.0, m_max)
    fn = jsuite(mesh, NG, BOX, bk_m_max=m_max, **KW)
    want = fn(jax.device_put(
        jnp.asarray(inp["pos"]),
        NamedSharding(mesh, P(("sim", "x", "y"), None))))
    shot = BOX ** 3 / N_PART
    got_p = _replicated(outs, t + "pk.power")
    npt.assert_array_equal(_replicated(outs, t + "pk.nmodes"),
                           np.asarray(want.pk.nmodes))
    npt.assert_allclose(got_p, np.asarray(want.pk.power), rtol=0,
                        atol=1e-4 * shot)
    closed = np.asarray(want.bk.ntri) > 1.0
    npt.assert_allclose(_replicated(outs, t + "bk.b")[closed],
                        np.asarray(want.bk.b)[closed], rtol=2e-3)
    npt.assert_allclose(_replicated(outs, t + "bk.ntri"),
                        np.asarray(want.bk.ntri), rtol=1e-4, atol=1.0)
    for name in ("kappa", "gamma1", "gamma2"):
        npt.assert_allclose(_replicated(outs, t + name),
                            np.asarray(getattr(want, name)), rtol=1e-4,
                            atol=1e-6)
    nv = int(want.n_voids)
    assert int(_replicated(outs, t + "n_voids")) == nv
    assert int(_replicated(outs, t + "n_void_candidates")) == int(
        want.n_void_candidates)
    npt.assert_allclose(_replicated(outs, t + "void_radius")[:nv],
                        np.asarray(want.void_radius)[:nv], rtol=1e-4,
                        atol=1e-4)

    res, bk, kappa, g1, g2, vcat = _single_device_chain(inp["pos"], m_max)
    npt.assert_allclose(got_p, np.asarray(res.power), rtol=5e-3,
                        atol=1e-3 * shot)
    npt.assert_allclose(_replicated(outs, t + "bk.b"), np.asarray(bk.b),
                        rtol=2e-2)
    npt.assert_allclose(_replicated(outs, t + "kappa"), np.asarray(kappa),
                        rtol=1e-4, atol=1e-6)
    for name, ref in (("gamma1", g1), ("gamma2", g2)):
        npt.assert_allclose(_replicated(outs, t + name), np.asarray(ref),
                            rtol=1e-4, atol=1e-6)
    assert int(_replicated(outs, t + "n_voids")) == int(vcat.n)
    assert int(_replicated(outs, t + "n_void_candidates")) == int(
        vcat.n_candidates)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("form", ["tuple", "padded"])
def test_suite_input_forms(world, case, form):
    """The component tuple (the multihost loader's layout) and rows padded
    with zero-weight rows give the (n, 3) run's P(k) (rtol 1e-5; the
    padding leaves the shot noise V/N) and kappa (rtol 1e-5, atol
    1e-7), with the same void count."""
    _, outs = world
    shape, _ = CASES[case]
    base = "x".join(map(str, shape)) + ":"
    ref, got = base + "rows.", base + form + "."
    npt.assert_allclose(_replicated(outs, got + "pk.power"),
                        _replicated(outs, ref + "pk.power"), rtol=1e-5)
    npt.assert_allclose(_replicated(outs, got + "kappa"),
                        _replicated(outs, ref + "kappa"), rtol=1e-5,
                        atol=1e-7)
    assert int(_replicated(outs, got + "n_voids")) == int(
        _replicated(outs, ref + "n_voids"))
