"""The port's pair rings (parallel/pairwise.py, parallel/tpcf.py) and the
collectives they and the rest of the distributed layer stand on
(parallel/mesh.py: ppermute, all_gather, and the backward of psum,
psum_scatter, all_gather and all_to_all) against the JAX package on the
CPU.

The port runs as two gloo worlds of processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy): an even
world of 4 ranks (the half ring's last hop with the global i < j dedup)
and an odd one of 3 (no last hop). The JAX references run in this
process, on the JAX tests' own meshes of the conftest's 8 CPU devices.
Each test mirrors one of tests/test_distributed.py; each tolerance is
stated where it is checked. Outputs every rank must hold alike are equal
bit for bit on every rank.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from astrild_tpu.ops import pairwise as JPW  # noqa: E402
from astrild_tpu.ops import tpcf as JT  # noqa: E402
from astrild_tpu.ops.shear_2pt import xi_pm_catalog  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel import pairwise as JDP  # noqa: E402
from astrild_tpu.parallel import tpcf as JDT  # noqa: E402
from astrild_tpu_torch.parallel import tpcf as DT  # noqa: E402
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

BOX = 100.0
WORLDS = (4, 3)
# the collectives' unit check: mesh (1, 2, 2) of the 4-rank world
COLL_SHAPE = (1, 2, 2)

_WORKER = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import pairwise as DP
    from astrild_tpu_torch.parallel import tpcf as DT
    from astrild_tpu_torch.parallel.mesh import (all_gather, all_to_all,
                                                 ppermute, psum,
                                                 psum_scatter, shard)

    BOX = 100.0
    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    out = {}
    ring = make_mesh(world, 1, 1, device="cpu")

    def rows(x, mesh=ring, axis="sim"):
        return shard(x, mesh, (axis,) + (None,) * (x.dim() - 1))

    def put(key, value):
        for i, v in enumerate(value if isinstance(value, tuple)
                              else (value,)):
            out[key + "." + str(i)] = v.numpy()

    # v12 (Yasini) and kSZ on 256 rows a rank
    n = 256 * world
    pw = DP.make_distributed_pairwise(ring, 16, 10.0, block=256)
    put("pairwise", pw(rows(inp["pw_pos"][:n]), rows(inp["pw_vel"][:n])))
    put("ksz", DP.make_distributed_ksz(ring, 12, 12.0, block=256)(
        rows(inp["ksz_pos"][:n]), rows(inp["ksz_dT"][:n])))
    if world == 4:
        # per-shard padding masked, wp(rp), shear xi
        pwm = DP.make_distributed_pairwise(ring, 16, 10.0, block=256,
                                           with_valid_mask=True)
        put("pairwise_mask", pwm(rows(inp["pm_pos"]), rows(inp["pm_vel"]),
                                 rows(inp["pm_valid"])))
        put("wp", DT.make_distributed_projected_tpcf(
            ring, 150.0, inp["rp_edges"].numpy(), 40.0, n_pi=10,
            block=256)(tuple(rows(inp["wp_pos"][:, i].contiguous())
                             for i in range(3))))
        sx = [rows(inp["sh_" + k]) for k in ("x", "y", "e1", "e2", "w")]
        put("shear", DT.make_distributed_shear_xi(
            ring, inp["theta_edges"].numpy(), block=128)(*sx[:4],
                                                        weights=sx[4]))
    # xi(s, mu): the odd world's ring over 3 ranks (component tuple), the
    # even world's over the 2-rank 'sim' axis of mesh (2, 2, 1) (the JAX
    # test's 2-shard mesh22 axis), plain and masked
    edges = inp["s_edges"].numpy()
    if world == 3:
        f = DT.make_distributed_tpcf_s_mu(ring, BOX, edges, nmu=10,
                                          block=128)
        put("tpcf_odd", f(tuple(rows(inp["tp3_pos"][:, i].contiguous())
                                for i in range(3))))
        try:
            f(tuple(rows(inp["tp3_pos"][:, i].contiguous())
                    for i in range(3)), rows(torch.ones(768)))
        except ValueError as e:
            out["mask_raise"] = np.asarray("valid mask" in str(e))
    else:
        m2 = make_mesh(2, 2, 1, device="cpu")
        f = DT.make_distributed_tpcf_s_mu(m2, BOX, edges, nmu=10,
                                          block=128)
        put("tpcf", f(rows(inp["tp_pos"], m2)))
        fm = DT.make_distributed_tpcf_s_mu(m2, BOX, edges, nmu=10,
                                           block=128, with_valid_mask=True)
        put("tpcf_mask", fm(rows(inp["tp_pos_m"], m2),
                            rows(inp["tp_valid"], m2)))
        # the collectives: forward values and the gradient of
        # sum(c_r * f(v_r)) for this rank's v_r, c_r
        mesh = make_mesh(*[int(v) for v in inp["coll_shape"]],
                         device="cpu")
        v = inp["v"][rank].clone().requires_grad_(True)
        c = inp["c"][rank]
        ops = {
            "psum_x": lambda t: psum(t, mesh, "x"),
            "psum_xy": lambda t: psum(t, mesh, ("x", "y")),
            "psum_scatter_x0": lambda t: psum_scatter(t, mesh, "x", 0),
            "psum_scatter_y1": lambda t: psum_scatter(t, mesh, "y", 1),
            "all_gather_x0": lambda t: all_gather(t, mesh, "x", 0),
            "all_gather_y1": lambda t: all_gather(t, mesh, "y", 1),
            "all_to_all_x": lambda t: all_to_all(t, mesh, "x", 0, 1),
            "all_to_all_y": lambda t: all_to_all(t, mesh, "y", 1, 0),
        }
        for name, op in ops.items():
            y = op(v)
            cc = c[tuple(slice(0, n) for n in y.shape)]
            (g,) = torch.autograd.grad((y * cc).sum(), v)
            out["coll." + name] = y.detach().numpy()
            out["grad." + name] = g.numpy()
        perm = [((i + 1) % world, i) for i in range(world)]
        out["ppermute"] = ppermute(inp["v"][rank], ring, "sim",
                                   perm).numpy()
        out["ppermute_partial"] = ppermute(inp["v"][rank], ring, "sim",
                                           [(0, 1)]).numpy()
    np.savez(work + "/out_%d.npz" % rank, **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


def _padded_catalog(rng):
    """The JAX mask test's catalog: 4 shards of 256 rows, ragged real
    counts, zero rows after them."""
    pos, vel, val = [], [], []
    for nr in (200, 256, 120, 256):
        p = rng.uniform(400, 600, (256, 3)).astype(np.float32)
        v = rng.normal(0, 100, (256, 3)).astype(np.float32)
        p[nr:] = 0.0
        v[nr:] = 0.0
        m = np.zeros(256, np.float32)
        m[:nr] = 1.0
        pos.append(p)
        vel.append(v)
        val.append(m)
    return np.concatenate(pos), np.concatenate(vel), np.concatenate(val)


def _inputs():
    rng = np.random.default_rng(21)
    pm_pos, pm_vel, pm_valid = _padded_catalog(rng)
    wp_pos = rng.uniform(0, 150.0, (1024, 3)).astype(np.float32)
    wp_pos[:256] = (wp_pos[256:512] + rng.normal(0, 3.0, (256, 3))) % 150.0
    tp_pos = rng.uniform(0, BOX, (1024, 3)).astype(np.float32)
    tp_valid = np.zeros(1024, np.float32)
    tp_valid[:450] = 1
    tp_valid[512:962] = 1
    tp_pos_m = tp_pos.copy()
    tp_pos_m[tp_valid == 0] = 0.0
    return {
        "pw_pos": rng.uniform(400, 600, (1024, 3)).astype(np.float32),
        "pw_vel": rng.normal(0, 100, (1024, 3)).astype(np.float32),
        "pm_pos": pm_pos, "pm_vel": pm_vel, "pm_valid": pm_valid,
        "ksz_pos": (rng.uniform(-60, 60, (1024, 3))
                    + np.array([0, 0, 900.0])).astype(np.float32),
        "ksz_dT": rng.normal(0, 1, 1024).astype(np.float32),
        "wp_pos": wp_pos.astype(np.float32),
        "rp_edges": np.linspace(2.0, 30.0, 6).astype(np.float32),
        "sh_x": rng.uniform(0, 100, 2048).astype(np.float32),
        "sh_y": rng.uniform(0, 100, 2048).astype(np.float32),
        "sh_e1": rng.normal(0, 0.2, 2048).astype(np.float32),
        "sh_e2": rng.normal(0, 0.2, 2048).astype(np.float32),
        "sh_w": rng.uniform(0.5, 2.0, 2048).astype(np.float32),
        "theta_edges": np.geomspace(2.0, 40.0, 9),
        "s_edges": np.linspace(1.0, 40.0, 9).astype(np.float32),
        "tp_pos": tp_pos, "tp_pos_m": tp_pos_m, "tp_valid": tp_valid,
        "tp3_pos": rng.uniform(0, BOX, (768, 3)).astype(np.float32),
        "coll_shape": np.asarray(COLL_SHAPE),
        "v": rng.standard_normal((4, 4, 6)).astype(np.float32),
        "c": rng.standard_normal((4, 8, 12)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(inputs, {world size: outputs of every rank})."""
    inp = _inputs()
    outs = {}
    for n in WORLDS:
        work = tmp_path_factory.mktemp(f"torch_rings_{n}")
        np.savez(work / "inputs.npz", **inp)
        script = work / "worker.py"
        script.write_text(_WORKER)
        _run_world(script, n, work, timeout=300)
        outs[n] = [dict(np.load(work / f"out_{r}.npz")) for r in range(n)]
    return inp, outs


def _sh(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1, 1),
                ("sim", "x", "y"))


def _ratio(nom, den):
    return np.asarray(nom) / np.maximum(np.asarray(den), 1e-30)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_pairwise_matches_local(worlds, world):
    """Mirror of test_distributed.py:149 (256 rows a rank). v12 of the
    port's ring against the single-device JAX estimator (the JAX test's
    bar, rtol 2e-3, atol 0.3) and against the JAX ring on as many devices:
    the sums are the JAX ring's up to the float32 order of the in-tile bin
    sums, held to rtol 1e-5 of each bin's nom and den (the JAX ring's own
    gap to its single-device estimator is the JAX test's bar, far
    larger)."""
    inp, outs = worlds
    o = outs[world]
    n = 256 * world
    nom = _replicated(o, "pairwise.0")
    den = _replicated(o, "pairwise.1")
    bins = jnp.asarray(np.arange(16, dtype=np.float64) * 10.0)
    _, v12 = JPW.mean_pairwise_velocity(jnp.asarray(inp["pw_pos"][:n]),
                                        jnp.asarray(inp["pw_vel"][:n]),
                                        bins, backend="xla")
    good = np.isfinite(np.asarray(v12))
    npt.assert_allclose(_ratio(nom, den)[good], np.asarray(v12)[good],
                        rtol=2e-3, atol=0.3)
    mesh = _jax_mesh(world)
    jn, jd = JDP.make_distributed_pairwise(mesh, 16, 10.0, block=256)(
        _sh(mesh, inp["pw_pos"][:n], P("sim", None)),
        _sh(mesh, inp["pw_vel"][:n], P("sim", None)))
    npt.assert_allclose(nom, np.asarray(jn), rtol=1e-5,
                        atol=1e-5 * np.abs(np.asarray(jn)).max())
    npt.assert_allclose(den, np.asarray(jd), rtol=1e-5)


def test_distributed_pairwise_valid_mask_per_shard_padding(worlds):
    """Mirror of test_distributed.py:172: per-shard padding masked by the
    validity vector matches the single-device estimator on the real rows
    (the JAX test's bar) and the JAX ring with the mask (rtol 1e-5), on
    the JAX test's 4 shards."""
    inp, outs = worlds
    o = outs[4]
    nom = _replicated(o, "pairwise_mask.0")
    den = _replicated(o, "pairwise_mask.1")
    real = inp["pm_valid"] > 0
    bins = jnp.asarray(np.arange(16, dtype=np.float64) * 10.0)
    _, v12 = JPW.mean_pairwise_velocity(jnp.asarray(inp["pm_pos"][real]),
                                        jnp.asarray(inp["pm_vel"][real]),
                                        bins, backend="xla")
    good = np.isfinite(np.asarray(v12))
    npt.assert_allclose(_ratio(nom, den)[good], np.asarray(v12)[good],
                        rtol=2e-3, atol=0.3)
    mesh = _jax_mesh(4)
    jn, jd = JDP.make_distributed_pairwise(
        mesh, 16, 10.0, block=256, with_valid_mask=True)(
        _sh(mesh, inp["pm_pos"], P("sim", None)),
        _sh(mesh, inp["pm_vel"], P("sim", None)),
        _sh(mesh, inp["pm_valid"], P("sim")))
    npt.assert_allclose(nom, np.asarray(jn), rtol=1e-5,
                        atol=1e-5 * np.abs(np.asarray(jn)).max())
    npt.assert_allclose(den, np.asarray(jd), rtol=1e-5)


def test_distributed_tpcf_matches_local(worlds):
    """Mirror of test_distributed.py:358 on the 2-rank 'sim' axis (the JAX
    test's mesh22 axis): xi(s, mu) equal bit for bit to the single-device
    JAX estimator and the JAX ring (whole-number counts, Kahan sums),
    plain and with per-shard tail padding masked."""
    inp, outs = worlds
    o = outs[4]
    s_edges = jnp.asarray(inp["s_edges"])
    _, _, want = JT.tpcf_s_mu(jnp.asarray(inp["tp_pos"]), BOX, s_edges,
                              nmu=10, block=128)
    npt.assert_array_equal(_replicated(o, "tpcf.2"), np.asarray(want))
    mesh22 = jmake_mesh(2, 2, 2)
    _, _, jd = JDT.make_distributed_tpcf_s_mu(
        mesh22, BOX, s_edges, nmu=10, axis="sim", block=128)(
        _sh(mesh22, inp["tp_pos"], P("sim", None)))
    npt.assert_array_equal(_replicated(o, "tpcf.2"), np.asarray(jd))
    real = inp["tp_valid"] > 0
    _, _, want_m = JT.tpcf_s_mu(jnp.asarray(inp["tp_pos"][real]), BOX,
                                s_edges, nmu=10, block=128)
    npt.assert_array_equal(_replicated(o, "tpcf_mask.2"),
                           np.asarray(want_m))
    npt.assert_array_equal(_replicated(o, "tpcf.0"), np.asarray(
        0.5 * (s_edges[1:] + s_edges[:-1])))


def test_distributed_tpcf_odd_shards_and_tuple_input(worlds):
    """Mirror of test_distributed.py:442: 3 ranks (the half ring with no
    last hop) from component tuples, equal bit for bit to the JAX
    package's 3-device ring and single-device estimator; a mask passed to
    a maskless factory raises."""
    inp, outs = worlds
    o = outs[3]
    s_edges = jnp.asarray(inp["s_edges"])
    pos = inp["tp3_pos"]
    _, _, want = JT.tpcf_s_mu(jnp.asarray(pos), BOX, s_edges, nmu=10,
                              block=128)
    got = _replicated(o, "tpcf_odd.2")
    npt.assert_array_equal(got, np.asarray(want))
    mesh3 = _jax_mesh(3)
    _, _, jd = JDT.make_distributed_tpcf_s_mu(
        mesh3, BOX, s_edges, nmu=10, axis="sim", block=128)(
        tuple(_sh(mesh3, pos[:, i], P("sim")) for i in range(3)))
    npt.assert_array_equal(got, np.asarray(jd))
    assert all(bool(r["mask_raise"]) for r in o)


def test_distributed_tpcf_halfbox_guard():
    """Mirror of test_distributed.py:469: edges past boxsize/2 raise when
    the factory is built."""
    with pytest.raises(ValueError, match="boxsize/2"):
        DT.make_distributed_tpcf_s_mu(None, BOX, np.linspace(1.0, BOX, 9))


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ksz_matches_local(worlds, world):
    """Mirror of test_distributed.py:705 (256 rows a rank): the kSZ ring
    against the single-device JAX estimator (the JAX test's bar, rtol
    2e-3, atol 1e-4) and the JAX ring on as many devices (rtol 1e-5 of
    nom and den)."""
    inp, outs = worlds
    o = outs[world]
    n = 256 * world
    nom, den = _replicated(o, "ksz.0"), _replicated(o, "ksz.1")
    bins = jnp.asarray(np.arange(12, dtype=np.float64) * 12.0)
    _, p = JPW.pairwise_ksz_momentum(jnp.asarray(inp["ksz_pos"][:n]),
                                     jnp.asarray(inp["ksz_dT"][:n]), bins)
    good = np.isfinite(np.asarray(p))
    npt.assert_allclose(_ratio(nom, den)[good], np.asarray(p)[good],
                        rtol=2e-3, atol=1e-4)
    mesh = _jax_mesh(world)
    jn, jd = JDP.make_distributed_ksz(mesh, 12, 12.0, block=256)(
        _sh(mesh, inp["ksz_pos"][:n], P("sim", None)),
        _sh(mesh, inp["ksz_dT"][:n], P("sim")))
    npt.assert_allclose(nom, np.asarray(jn), rtol=1e-5,
                        atol=1e-5 * np.abs(np.asarray(jn)).max())
    npt.assert_allclose(den, np.asarray(jd), rtol=1e-5)


def test_distributed_projected_tpcf_matches_local(worlds):
    """Mirror of test_distributed.py:729 on its 4 shards: wp and xi(rp,
    pi) against the single-device JAX estimator (the JAX test's bar, rtol
    1e-5, atol 1e-5) and equal bit for bit to the JAX ring (whole-number
    counts)."""
    inp, outs = worlds
    o = outs[4]
    rp_edges = jnp.asarray(inp["rp_edges"])
    _, wp_l, xi_l = JT.projected_tpcf(jnp.asarray(inp["wp_pos"]), 150.0,
                                      rp_edges, 40.0, n_pi=10)
    npt.assert_allclose(_replicated(o, "wp.2"), np.asarray(xi_l),
                        rtol=1e-5, atol=1e-5)
    npt.assert_allclose(_replicated(o, "wp.1"), np.asarray(wp_l),
                        rtol=1e-5, atol=1e-5)
    mesh = _jax_mesh(4)
    _, wp_d, xi_d = JDT.make_distributed_projected_tpcf(
        mesh, 150.0, rp_edges, 40.0, n_pi=10, block=256)(
        tuple(_sh(mesh, inp["wp_pos"][:, i], P("sim")) for i in range(3)))
    npt.assert_array_equal(_replicated(o, "wp.2"), np.asarray(xi_d))
    npt.assert_array_equal(_replicated(o, "wp.1"), np.asarray(wp_d))


def test_distributed_shear_xi_matches_local(worlds):
    """Mirror of test_distributed.py:755 (4 ranks of 512 rows; the JAX
    test's 8 shards of 256): npairs equal to the single-device JAX
    estimator and to the JAX 8-device ring, xi_pm within the JAX test's
    atol 1e-6 of both (Kahan-summed float32 channels)."""
    inp, outs = worlds
    o = outs[4]
    cols = [inp["sh_" + k] for k in ("x", "y", "e1", "e2", "w")]
    edges = inp["theta_edges"]
    xp_l, xm_l, c_l = xi_pm_catalog(*cols[:4], edges, weights=cols[4],
                                    block=128)
    mesh = jmake_mesh(8, 1, 1)
    xp_d, xm_d, c_d = JDT.make_distributed_shear_xi(mesh, edges, block=128)(
        *[_sh(mesh, v, P("sim")) for v in cols[:4]],
        weights=_sh(mesh, cols[4], P("sim")))
    for want in ((xp_l, xm_l, c_l), (xp_d, xm_d, c_d)):
        npt.assert_array_equal(_replicated(o, "shear.2"),
                               np.asarray(want[2]))
        npt.assert_allclose(_replicated(o, "shear.0"), np.asarray(want[0]),
                            atol=1e-6)
        npt.assert_allclose(_replicated(o, "shear.1"), np.asarray(want[1]),
                            atol=1e-6)


# ------------------------------------------------------------ collectives
def _groups(axis):
    """The rank groups of mesh COLL_SHAPE along `axis` (rank = x * 2 + y),
    each in axis-index order."""
    if axis == "x":
        return [[y, 2 + y] for y in range(2)]
    if axis == "y":
        return [[2 * x, 2 * x + 1] for x in range(2)]
    return [[0, 1, 2, 3]]


def _reference(name, v):
    """The collective of every rank at once, on the stacked (4, ...)
    inputs, in one process: a list of the ranks' outputs."""
    op, axis, dim = {
        "psum_x": ("psum", "x", 0), "psum_xy": ("psum", "xy", 0),
        "psum_scatter_x0": ("scatter", "x", 0),
        "psum_scatter_y1": ("scatter", "y", 1),
        "all_gather_x0": ("gather", "x", 0),
        "all_gather_y1": ("gather", "y", 1),
        "all_to_all_x": ("a2a", "x", (0, 1)),
        "all_to_all_y": ("a2a", "y", (1, 0))}[name]
    out = [None] * 4
    for g in _groups(axis):
        total = sum(v[r] for r in g)
        for i, r in enumerate(g):
            if op == "psum":
                out[r] = total
            elif op == "scatter":
                out[r] = total.chunk(len(g), dim)[i]
            elif op == "gather":
                out[r] = torch.cat([v[s] for s in g], dim)
            else:
                split, concat = dim
                out[r] = torch.cat([v[s].chunk(len(g), split)[i]
                                    for s in g], concat)
    return out


@pytest.mark.parametrize("name", [
    "psum_x", "psum_xy", "psum_scatter_x0", "psum_scatter_y1",
    "all_gather_x0", "all_gather_y1", "all_to_all_x", "all_to_all_y"])
def test_collective_and_its_backward(worlds, name):
    """Each collective of parallel/mesh.py in the 4-rank world (mesh 1 x 2
    x 2) against the same collective written out on all ranks' inputs in
    one process, and its explicit backward against autograd of that
    single-process function: the gradient of sum_r <c_r, f(v)_r> with
    respect to each rank's v_r. Equal to float32 rounding of sums of 2-4
    terms (1e-6). psum's backward all-reduces the ranks' cotangents, so
    a replicated output read differently by each rank gets the sum of
    their uses."""
    inp, outs = worlds
    o = outs[4]
    v = torch.from_numpy(inp["v"]).requires_grad_(True)
    c = torch.from_numpy(inp["c"])
    ys = _reference(name, list(v.unbind(0)))
    loss = sum((y * c[r][tuple(slice(0, n) for n in y.shape)]).sum()
               for r, y in enumerate(ys))
    (g,) = torch.autograd.grad(loss, v)
    for r in range(4):
        npt.assert_allclose(o[r]["coll." + name], ys[r].detach().numpy(),
                            rtol=1e-6, atol=1e-6)
        npt.assert_allclose(o[r]["grad." + name], g[r].numpy(), rtol=1e-6,
                            atol=1e-6)


def test_ppermute(worlds):
    """ppermute on the 4-rank ring: rank r gets rank r + 1's block (the
    half ring's perm_back); with one pair (0 -> 1) rank 1 gets rank 0's
    block and the others zeros, as lax.ppermute."""
    inp, outs = worlds
    o = outs[4]
    for r in range(4):
        npt.assert_array_equal(o[r]["ppermute"], inp["v"][(r + 1) % 4])
        npt.assert_array_equal(o[r]["ppermute_partial"],
                               inp["v"][0] if r == 1
                               else np.zeros_like(inp["v"][0]))
