"""The port's multi-process layer (parallel/multihost) against the JAX
package's on the CPU: striped reads feeding this rank's blocks, the
padded global array they belong to, the estimators they feed, the
process-group bootstrap, and a real two-process run.

The JAX reference runs in this process on the conftest's 8-device mesh.
The port runs as gloo worlds of processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy; h5py inside
the reader): a world of 8 ranks on the meshes (2, 2, 2) and (1, 2, 4), with
emulated hosts and with real striped reads, and a world of 2 ranks, the
twin of the JAX package's two-process test, which takes seconds here and
is not marked slow. Each tolerance is stated where it is checked.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import torch.distributed as dist  # noqa: E402

from astrild_tpu.io.gadget_hdf5 import GadgetSnapshot  # noqa: E402
from astrild_tpu.ops import lens_planes as JLP  # noqa: E402
from astrild_tpu.ops import paint as JPA  # noqa: E402
from astrild_tpu.ops import power as JPS  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel import multihost as JMH  # noqa: E402
from astrild_tpu.parallel.power import (  # noqa: E402
    make_distributed_auto_power as jauto_power)
from astrild_tpu_torch.parallel import make_mesh  # noqa: E402
from astrild_tpu_torch.parallel import mesh as M  # noqa: E402
from astrild_tpu_torch.parallel import multihost  # noqa: E402
from torch_gloo import REPO, run_ranks  # noqa: E402
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

BOX = 100.0
COUNTS = [37, 20, 11, 52]
N_TOT = sum(COUNTS)
COMPS = tuple(f"Coordinates:{i}" for i in range(3))
# (mesh shape, emulated hosts; None: each rank reads its own stripe)
LOADS = (((2, 2, 2), 4), ((2, 2, 2), 8), ((1, 2, 4), 4), ((1, 2, 4), None))


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


def _write_snapshot(root: Path) -> str:
    """4-file snapshot with UNEQUAL per-file particle counts (the JAX
    test's fixture, same seed)."""
    rng = np.random.default_rng(7)
    sdir = root / "snapdir_012"
    sdir.mkdir(parents=True)
    for fn, n in enumerate(COUNTS):
        with h5py.File(sdir / f"snap_012.{fn}.hdf5", "w") as f:
            h = f.create_group("Header")
            h.attrs["NumPart_ThisFile"] = np.array([0, n, 0, 0, 0, 0])
            h.attrs["NumPart_Total"] = np.array([0, N_TOT, 0, 0, 0, 0])
            h.attrs["MassTable"] = np.array([0, 0.05, 0, 0, 0, 0])
            h.attrs["Time"] = 1.0
            h.attrs["Redshift"] = 0.0
            h.attrs["BoxSize"] = BOX
            h.attrs["HubbleParam"] = 1.0
            h.attrs["NumFilesPerSnapshot"] = 4
            pt = f.create_group("PartType1")
            pt["Coordinates"] = rng.uniform(0, BOX, (n, 3))
    return str(root)


_WORKER = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import lensing as DL
    from astrild_tpu_torch.parallel import power as DP

    AXES = ("sim", "x", "y")
    BOX = 100.0
    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    assert multihost.process_count() == world
    assert multihost.process_index() == rank
    assert multihost.is_distributed()
    snapdir = open(work + "/snapdir.txt").read()
    loads = [l.split() for l in open(work + "/loads_%d.txt" % world)]
    out = {}
    for shape_s, hosts_s in loads:
        shape = tuple(int(v) for v in shape_s.split("x"))
        hosts = None if hosts_s == "none" else int(hosts_s)
        mesh = make_mesh(*shape, device="cpu")
        tag = shape_s + ":" + hosts_s + ":"
        data, w = multihost.load_snapshot_sharded(
            12, snapdir, mesh, blocks=("Coordinates",), emulate_hosts=hosts)
        comps = tuple(data["Coordinates:%d" % i] for i in range(3))
        for i, c in enumerate(comps):
            out[tag + "c%d" % i] = c.numpy()
        out[tag + "w"] = w.numpy()
        out[tag + "boxsize"] = np.asarray(data["header"]["boxsize"])
        pos = torch.stack(comps, dim=-1)
        res = DP.make_distributed_auto_power(mesh, 16, BOX, 6,
                                             window="cic")(pos, w)
        for name, v in zip(res._fields, res):
            out[tag + "power." + name] = v.numpy()
        fast = DP.make_distributed_auto_power_fast(mesh, 16, BOX, 6)
        out[tag + "fast_t"] = fast(comps, w).power.numpy()
        out[tag + "fast"] = fast(pos, w).power.numpy()
        out[tag + "shot"] = DP._weighted_shotnoise(w, BOX, mesh,
                                                   AXES).numpy()
        # lens planes from the same loader output, padding rows masked:
        # the scatter path (the JAX test's) and the deposit route
        for dep, key in (("scatter", "planes"), (None, "planes_deposit")):
            lpf = DL.make_distributed_lens_planes(
                mesh, BOX, 80.0, 20.0, 4, 0.5, 16, axis=AXES,
                with_valid_mask=True, deposit=dep)
            planes, chis = lpf(comps, w)
            out[tag + key] = planes.numpy()
        out[tag + "chis"] = chis.numpy()
    np.savez(work + "/out_%d_%d.npz" % (world, rank), **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


def _tag(shape, hosts):
    return "x".join(map(str, shape)) + ":" + (
        "none" if hosts is None else str(hosts)) + ":"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(snapshot directory, outputs of the 8-rank world's ranks, outputs of
    the 2-rank world's ranks)."""
    work = tmp_path_factory.mktemp("torch_multihost")
    snapdir = _write_snapshot(work / "snap")
    (work / "snapdir.txt").write_text(snapdir)
    (work / "loads_8.txt").write_text("".join(
        _tag(s, h).replace(":", " ").strip() + "\n" for s, h in LOADS))
    (work / "loads_2.txt").write_text("1x2x1 none\n")
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, 8, work, timeout=300)
    _run_world(script, 2, work, timeout=300)
    outs8 = [dict(np.load(work / f"out_8_{r}.npz")) for r in range(8)]
    outs2 = [dict(np.load(work / f"out_2_{r}.npz")) for r in range(2)]
    return snapdir, outs8, outs2


def _full_read(snapdir):
    return GadgetSnapshot(12, snapdir).read(["Coordinates"],
                                            parttype=[1])["Coordinates"]


def _jax_global(snapdir, shape, hosts, nranks):
    """JAX's padded global arrays (components, weights) on a mesh of the
    same shape: what a real `hosts`-host run assembles."""
    mesh = jmake_mesh(*shape)
    data, w = JMH.load_snapshot_sharded(
        12, snapdir, mesh, blocks=("Coordinates",),
        emulate_hosts=hosts if hosts is not None else nranks)
    return [np.asarray(data[c]) for c in COMPS], np.asarray(w), data, w, \
        mesh


def _rank_rows(outs, tag, key):
    return np.concatenate([o[tag + key] for o in outs])


@pytest.mark.parametrize("shape,hosts", LOADS)
def test_striped_load_matches_jax_global_array(worlds, shape, hosts):
    """Every rank's rows are its block of the same padded global array
    JAX assembles (bit for bit, weights too); every real row is there
    exactly once (the weights sum to the count; the rows are the file
    rows as a multiset, rtol 1e-6 against the float64 read), and the
    header carries the box."""
    snapdir, outs, _ = worlds
    tag = _tag(shape, hosts)
    comps_j, w_j, _, _, _ = _jax_global(snapdir, shape, hosts, 8)
    for i, c in enumerate(COMPS):
        npt.assert_array_equal(_rank_rows(outs, tag, "c%d" % i), comps_j[i])
    w = _rank_rows(outs, tag, "w")
    npt.assert_array_equal(w, w_j)
    assert w.sum() == N_TOT
    got = np.stack([_rank_rows(outs, tag, "c%d" % i)[w > 0]
                    for i in range(3)], axis=-1)
    want = _full_read(snapdir)
    npt.assert_allclose(got[np.lexsort(got.T)], want[np.lexsort(want.T)],
                        rtol=1e-6)
    assert all(float(o[tag + "boxsize"]) == BOX for o in outs)


@pytest.mark.parametrize("shape,hosts", LOADS)
def test_loader_output_feeds_distributed_power(worlds, shape, hosts):
    """The loader's blocks through the CIC factory (padded rows weight 0)
    against JAX's loader -> factory on the same mesh (counts equal, P to
    1e-4 of the shot noise) and JAX's single-device estimator on the file
    rows (the JAX test's bar: rtol 5e-3, atol 1e-3 shot)."""
    snapdir, outs, _ = worlds
    tag = _tag(shape, hosts)
    _, _, data, w, mesh = _jax_global(snapdir, shape, hosts, 8)
    pos = jnp.stack([data[c] for c in COMPS], axis=-1)
    want = jauto_power(mesh, 16, BOX, 6, window="cic")(pos, w)
    shot = BOX ** 3 / N_TOT
    got = outs[0][tag + "power.power"]
    for o in outs:
        npt.assert_array_equal(o[tag + "power.power"], got)
    npt.assert_array_equal(outs[0][tag + "power.nmodes"],
                           np.asarray(want.nmodes))
    npt.assert_allclose(got, np.asarray(want.power), rtol=0,
                        atol=1e-4 * shot)
    g = JPA.paint(jnp.asarray(_full_read(snapdir), jnp.float32), 16, BOX,
                  window="cic")
    ref = JPS.auto_power(g, BOX, nbins=6, window="cic", shotnoise=shot)
    npt.assert_allclose(got, np.asarray(ref.power), rtol=5e-3,
                        atol=1e-3 * shot)


@pytest.mark.parametrize("shape,hosts", LOADS)
def test_padding_rows_are_inert(worlds, shape, hosts):
    """The loader's zero-weight padding rows add nothing: the shot noise
    is V/N of the real rows (rtol 1e-6), and the component tuple feeds the
    fast estimator as the stacked (n, 3) rows do (rtol 1e-5)."""
    _, outs, _ = worlds
    tag = _tag(shape, hosts)
    w = _rank_rows(outs, tag, "w")
    assert (w == 0).sum() > 0 or hosts is None  # padding present
    for o in outs:
        npt.assert_allclose(o[tag + "shot"], BOX ** 3 / N_TOT, rtol=1e-6)
        npt.assert_allclose(o[tag + "fast_t"], o[tag + "fast"], rtol=1e-5)


def test_two_process_distributed_power(worlds):
    """A real two-rank world (the twin of the JAX package's two-process
    test): each rank reads its own stripe, pads to the larger count, and
    the CIC P(k) matches the single-device estimator on the file rows
    (the JAX test's bar: counts equal, rtol 5e-3, atol 1e-3 shot); the
    ranks' rows are JAX's two-host global array bit for bit. The JAX
    test's second factory: lens planes through the same loader output
    with the padding rows masked (with_valid_mask=True), on the scatter
    path and on the deposit route, match the JAX package's
    single-process build (the JAX test's bar, rtol 1e-3, atol 1e-4) and
    are alike on both ranks; on the meshes of the 8-rank world too."""
    snapdir, outs8, outs = worlds
    tag = _tag((1, 2, 1), None)
    comps_j, w_j, _, _, _ = _jax_global(snapdir, (1, 2, 1), 2, 2)
    for i in range(3):
        npt.assert_array_equal(_rank_rows(outs, tag, "c%d" % i), comps_j[i])
    npt.assert_array_equal(_rank_rows(outs, tag, "w"), w_j)
    shot = BOX ** 3 / N_TOT
    full = _full_read(snapdir)
    g = JPA.paint(jnp.asarray(full, jnp.float32), 16, BOX, window="cic")
    ref = JPS.auto_power(g, BOX, nbins=6, window="cic", shotnoise=shot)
    for o in outs:
        npt.assert_array_equal(o[tag + "power.nmodes"],
                               np.asarray(ref.nmodes))
        npt.assert_allclose(o[tag + "power.power"], np.asarray(ref.power),
                            rtol=5e-3, atol=1e-3 * shot)
    want, chis = JLP.density_planes_from_particles(
        tuple(jnp.asarray(full[:, i], jnp.float32) for i in range(3)),
        BOX, 80.0, 20.0, 4, 0.5, 16)
    for o_all, t in [(outs, tag)] + [(outs8, _tag(s, h)) for s, h in LOADS]:
        for key in ("planes", "planes_deposit"):
            got = _replicated(o_all, t + key)
            npt.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)
        npt.assert_array_equal(_replicated(o_all, t + "chis"),
                               np.asarray(chis))


def test_load_snapshot_sharded_missing_dir_clear_error(tmp_path):
    """A typo'd snapshot directory fails with FileNotFoundError naming the
    attempted paths."""
    mesh = make_mesh(1, 1, 1, device="cpu")
    with pytest.raises(FileNotFoundError, match="no snapshot files"):
        multihost.load_snapshot_sharded(12, str(tmp_path / "typo"), mesh,
                                        blocks=("Coordinates",),
                                        emulate_hosts=1)


def test_world_of_one_emulates_hosts(tmp_path):
    """In a world of one the emulation assembles JAX's global array (4
    emulated hosts on a one-rank mesh: every row, JAX's order)."""
    snapdir = _write_snapshot(tmp_path)
    mesh = make_mesh(1, 1, 1, device="cpu")
    data, w = multihost.load_snapshot_sharded(
        12, snapdir, mesh, blocks=("Coordinates",), emulate_hosts=1)
    jdata, jw = JMH.load_snapshot_sharded(
        12, snapdir, jmake_mesh(1, 1, 1), blocks=("Coordinates",),
        emulate_hosts=1)
    npt.assert_array_equal(w.numpy(), np.asarray(jw))
    for c in COMPS:
        npt.assert_array_equal(data[c].numpy(), np.asarray(jdata[c]))


def test_pad_to_shard_contract():
    a = np.arange(10, dtype=np.float32)
    (pa,), w = multihost.pad_to_shard([a], nshards=4)
    assert pa.shape[0] == 12 and w.sum() == 10
    npt.assert_array_equal(pa[:10], a)
    npt.assert_array_equal(pa[10:], 0.0)
    with pytest.raises(ValueError):
        multihost.pad_to_shard([a], nshards=4, target_rows=8)
    # the JAX package's helper pads alike
    (ja,), jw = JMH.pad_to_shard([a], nshards=4)
    npt.assert_array_equal(pa, ja)
    npt.assert_array_equal(w, jw)


def test_pad_to_shard_ragged_raises():
    a = np.arange(10, dtype=np.float32)
    b = np.arange(9, dtype=np.float32)
    with pytest.raises(ValueError, match="disagree"):
        multihost.pad_to_shard([a, b], nshards=2)


_LAUNCHER = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID")


@pytest.fixture
def no_group(monkeypatch):
    """No process group yet, and init_process_group recorded instead of
    run; the launcher's variables cleared."""
    recorded = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: recorded.update(kw))
    for name in _LAUNCHER:
        monkeypatch.delenv(name, raising=False)
    return recorded


@pytest.mark.parametrize("names", [("WORLD_SIZE", "RANK"),
                                   ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID")])
def test_initialize_env_fallback(no_group, monkeypatch, names):
    """A launcher that sets only the world size and rank (torchrun's or
    the JAX package's names) reaches init_process_group with them, not a
    silent single-process run where every rank would read the full
    snapshot."""
    monkeypatch.setenv(names[0], "2")
    monkeypatch.setenv(names[1], "1")
    multihost.initialize(device="cpu")
    assert no_group["world_size"] == 2 and no_group["rank"] == 1
    assert no_group["backend"] == "gloo"
    assert no_group["init_method"] == "env://"


def test_initialize_reads_torchrun_address(no_group, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    multihost.initialize(device="cpu")
    assert no_group["init_method"] == "tcp://127.0.0.1:29511"
    assert (no_group["world_size"], no_group["rank"]) == (4, 3)


def test_initialize_single_process(no_group):
    """Nothing configured: a world of one (gloo on the CPU), so pipelines
    can call it unconditionally."""
    multihost.initialize(device="cpu")
    assert no_group["world_size"] == 1 and no_group["rank"] == 0
    assert no_group["backend"] == "gloo"
    assert multihost.process_count() == 1
    assert not multihost.is_distributed()


def test_initialize_ntasks_one(no_group, monkeypatch):
    """A world size of 1 with no address (a wrapper exporting $NTASKS run
    with one task) is a world of one, not a rendezvous."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    multihost.initialize(device="cpu")
    assert no_group["world_size"] == 1
    assert "init_method" not in no_group


def test_initialize_world_without_rank_raises(no_group, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        multihost.initialize(device="cpu")
    assert not no_group


def test_initialize_cuda_without_card_raises(no_group):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no card"):
        multihost.initialize(device="cuda")
    assert not no_group


# ---- the exit hook: a group `initialize` started is torn down at exit

# registered before `initialize`, so it runs after the package's hook
# (atexit runs its handlers last in, first out): whether a group is up,
# the joint groups cached, and the gloo threads still alive as the
# interpreter's own teardown begins (a gloo worker thread that frees a
# tensor's Python object after that point aborts the process)
_AFTER_HOOK = textwrap.dedent('''
    import atexit
    import os
    import torch.distributed as dist
    from astrild_tpu_torch.parallel import mesh as M
    from astrild_tpu_torch.parallel import multihost

    def _after():
        names = [open("/proc/self/task/%s/comm" % t).read()
                 for t in os.listdir("/proc/self/task")]
        print("AFTER", dist.is_initialized(), len(M._GROUPS),
              sum("gloo" in n for n in names), flush=True)

    atexit.register(_after)
''')


def _run_py(code: str, tmp_path) -> str:
    """Run `code` in a fresh process (PYTHONPATH the repo, no launcher
    variables); it must exit 0 with no abort's message. Returns its
    output."""
    script = tmp_path / "hook.py"
    script.write_text(code)
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER}
    res = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, env={**env, "OMP_NUM_THREADS": "1",
                          "PYTHONPATH": str(REPO)})
    out = res.stdout + res.stderr
    assert res.returncode == 0 and "terminate called" not in out, out
    return out


def test_exit_hook_tears_down_world_of_one(tmp_path):
    """`initialize` starts a world of one, a mesh and a joint group of two
    of its axes (in mesh._GROUPS); at exit the hook leaves no group up,
    _GROUPS empty and no gloo thread alive, and the process exits 0."""
    out = _run_py(_AFTER_HOOK + textwrap.dedent('''
        multihost.initialize(device="cpu")
        m = M.make_mesh(1, 1, 1, device="cpu")
        M._group(m, ("sim", "x"))
        assert dist.is_initialized() and len(M._GROUPS) == 1
        print("WORK_DONE", flush=True)
    '''), tmp_path)
    assert "WORK_DONE" in out and "AFTER False 0 0" in out, out


def test_exit_hook_registered_once(tmp_path):
    """However often `initialize` runs, and however many groups it starts
    after the caller destroyed the last one, the hook is registered once,
    and it tears down the group started last."""
    out = _run_py(_AFTER_HOOK + textwrap.dedent('''
        hooks = []
        register = atexit.register
        atexit.register = lambda f, *a: (hooks.append(f), register(f, *a))
        multihost.initialize(device="cpu")
        multihost.initialize(device="cpu")
        dist.destroy_process_group()
        multihost.initialize(device="cpu")
        multihost.initialize(device="cpu")
        assert hooks == [multihost._teardown], hooks
        assert multihost._STARTED is dist.group.WORLD
        print("ONCE", flush=True)
    '''), tmp_path)
    assert "ONCE" in out and "AFTER False 0 0" in out, out


def test_exit_hook_noop_after_destroy(tmp_path):
    """After the caller's own destroy_process_group the hook does nothing
    (it runs, here and at exit, without raising); nor does it touch a
    group the caller started after that by hand."""
    out = _run_py(_AFTER_HOOK + textwrap.dedent('''
        multihost.initialize(device="cpu")
        dist.destroy_process_group()
        multihost._teardown()
        assert not dist.is_initialized()
        multihost.initialize(device="cpu")
        dist.destroy_process_group()
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        multihost.initialize(device="cpu")
        print("DESTROYED", flush=True)
    '''), tmp_path)
    # the hand-started group is still up after the hook
    assert "DESTROYED" in out and "AFTER True 0 " in out, out


def test_exit_hook_noop_for_a_group_initialize_did_not_start(tmp_path):
    """A group the caller started before `initialize` is theirs: no hook
    is registered, and the group is up at exit."""
    out = _run_py(_AFTER_HOOK + textwrap.dedent('''
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        multihost.initialize(device="cpu")
        assert not multihost._HOOKED and multihost._STARTED is None
        print("THEIRS", flush=True)
    '''), tmp_path)
    assert "THEIRS" in out and "AFTER True 0 " in out, out


def test_exit_hook_noop_when_init_is_monkeypatched(no_group, monkeypatch):
    """With init_process_group patched no group starts: `initialize`
    records none for the hook, and the hook destroys nothing."""
    started, destroyed = [], []
    monkeypatch.setattr(multihost, "_started", started.append)
    monkeypatch.setattr(multihost, "_STARTED", multihost._STARTED)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: destroyed.append(a))
    monkeypatch.setattr(M, "_GROUPS", {})
    multihost.initialize(device="cpu")
    assert no_group["world_size"] == 1
    assert not started
    multihost._teardown()
    assert not destroyed


_HOOK_WORKER = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
''') + _AFTER_HOOK + textwrap.dedent('''
    import torch
    torch.set_num_threads(1)
    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    m = M.make_mesh(1, world, 1, device="cpu")
    t = torch.full((4,), float(rank + 1))
    dist.all_reduce(t, group=M._group(m, ("sim", "x")))
    assert t.tolist() == [3.0] * 4
    got = M.ppermute(torch.full((3,), float(rank)), m, "x",
                     [(0, 1), (1, 0)])
    assert got.tolist() == [float(1 - rank)] * 3
    y = M.psum(torch.ones(2, requires_grad=True), m, "x")
    y.sum().backward()
    assert dist.is_initialized() and len(M._GROUPS) == 1
    print("WORKER_OK", rank, flush=True)
''')


def test_exit_hook_ends_a_two_rank_gloo_world(tmp_path):
    """Two gloo ranks end their work with the group, a DeviceMesh and a
    cached joint group still up, and no teardown of their own: both exit
    0 with no abort's message, and the hook has torn down every group and
    joined every gloo thread before the interpreter's own teardown."""
    script = tmp_path / "worker.py"
    script.write_text(_HOOK_WORKER)
    ranks = run_ranks(script, 2, tmp_path, timeout=120)
    for code, out in ranks:
        assert code == 0 and "terminate called" not in out, out
        assert "WORKER_OK" in out and "AFTER False 0 0" in out, out
