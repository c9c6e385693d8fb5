"""The collectives the port's distributed factories issue, held against
the JAX package's compiled-HLO manifest (tests/data/collective_manifest
.json, tests/test_collective_inventory.py).

The port runs as a gloo world of 8 processes on mesh (2, 2, 2), each
running `_WORKER` (it imports only astrild_tpu_torch, torch and numpy):
every one of the manifest's 13 factories at the manifest's shapes, under
the recorder of parallel/mesh.py (parallel/inventory.collective_inventory).
Each rank's record is {kind: {"count", "bytes"}}, bytes the outputs'
bytes on the rank, as the JAX package's hlo_collectives gives them.

The rule that maps the port's counts onto XLA's (parallel/inventory.py):
a collective inside a `lax.scan` counts once in XLA's module and once a
step in the port (EXTRA below: the force evaluations of the steps after
the first), and XLA's combiner merges independent all-reduces that the
port issues one by one. Every other difference is listed in UNEXPLAINED
with its reason (PERF.md section 7) and pinned at the port's numbers; the
manifest itself is not changed.
"""
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_gloo import run_world as _run_world  # noqa: E402

MANIFEST = Path(__file__).resolve().parent / "data" / \
    "collective_manifest.json"
NRANKS = 8
FACTORIES = ("auto_power", "auto_power_fast", "multipoles", "bispectrum",
             "z0_suite", "pm_evolve", "sht_synth", "sht_analyze",
             "gaussian_filter", "pairwise", "sht_large_synth", "raytrace",
             "field_infer_grad")

# one force evaluation of the PM step at NGRID 16 on mesh (2, 2, 2): the
# two all-gathers of the (3, 8, 8, 16) force pencils (24576 + 49152 B),
# the two reduce-scatters of the 16^3 paint (8192 + 4096 B), the 8
# all-to-alls of one forward and three inverse pencil FFTs (8192 B each),
# the all-reduce of the 'sim' paints (16384 B) and of the mean (4 B)
_FORCE = {"all-gather": (2, 73728), "reduce-scatter": (2, 12288),
          "all-to-all": (8, 65536)}
# what the port issues beyond the manifest's record, by the rule:
# (count, bytes) a kind
EXTRA = {
    # nsteps 2: force0 and two steps' forces issued, force0 and the scan
    # body compiled
    "pm_evolve": {**_FORCE, "all-reduce": (2, 16388)},
    # the same one forward force evaluation (its all-reduce: the mean, 4
    # B; no 'sim' psum, field inference repeats the work over 'sim'); its
    # backward does not run (the last force only kicks the momenta, which
    # the density does not read), so the backward matches the transposed
    # scan body; and XLA's combiner merges two of the scalar psums into
    # one all-reduce of 8 B: one more issued all-reduce, no more bytes
    "field_infer_grad": {**_FORCE, "all-reduce": (2, 4)},
}
# differences the rule does not explain: the port's all-reduce record
# (count, bytes) and why (PERF.md section 7)
UNEXPLAINED = {
    # the global mean and the shell sums are float64 in the port (part
    # A's bincount sums), float32 in JAX: 12 more bytes
    "auto_power": (3, 168),
    "auto_power_fast": (4, 131240),
    # float64 sums as above, and one all-reduce fewer: the port stacks the
    # weight sums sum(w) and sum(w^2) into one psum, JAX psums each
    "multipoles": (4, 16568),
    # one psum of the global mean (float64 in the port: 4 more bytes), one
    # a shell (its mode sum and count) and one a closed triangle (its two
    # sums): 1 + 3 + 10, issued one by one; XLA's combiner merges them
    # into 2
    "bispectrum": (14, 112),
    # the bispectrum's 14 and the fast P(k)'s and the planes' psums,
    # issued one by one (float64 sums as above); XLA merges them into 6
    "z0_suite": (20, 135456),
    # the port psums the lmax + 1 = 16 m rows of the ring coefficients,
    # JAX its m-block-padded 256 rows (the same single all-reduce)
    "sht_large_synth": (1, 3968),
}

_WORKER = textwrap.dedent('''
    import json
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import bispectrum as B
    from astrild_tpu_torch.parallel import field_infer as F
    from astrild_tpu_torch.parallel import lensing as L
    from astrild_tpu_torch.parallel import maps as M
    from astrild_tpu_torch.parallel import nbody as N
    from astrild_tpu_torch.parallel import pairwise as PW
    from astrild_tpu_torch.parallel import power as P
    from astrild_tpu_torch.parallel import sht as SH
    from astrild_tpu_torch.parallel import sht_large as SL
    from astrild_tpu_torch.parallel import suite as S
    from astrild_tpu_torch.parallel.inventory import collective_inventory
    from astrild_tpu_torch.parallel.mesh import shard, unshard
    from astrild_tpu_torch.utils.cosmology import Cosmology

    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    NGRID, BOX, NBINS = 16, 100.0, 6
    mesh = make_mesh(2, 2, 2, device="cpu")
    allax = (("sim", "x", "y"),)
    pos, w = inp["pos"], torch.ones(2, 8192)
    pos_b = shard(pos, mesh, ("sim", ("x", "y"), None))
    w_b = shard(w, mesh, ("sim", ("x", "y")))
    pos_f = shard(pos.reshape(-1, 3), mesh, allax + (None,))
    w_f = shard(w.reshape(-1), mesh, allax)
    cosmo = Cosmology(Om0=0.3, h=0.7)
    calls = {
        "auto_power": lambda: (P.make_distributed_auto_power(
            mesh, NGRID, BOX, NBINS, window="cic", batched=True),
            (pos_b, w_b)),
        "auto_power_fast": lambda: (P.make_distributed_auto_power_fast(
            mesh, NGRID, BOX, NBINS), (pos_f, w_f)),
        "multipoles": lambda: (P.make_distributed_multipoles(
            mesh, NGRID, BOX, 4), (pos_f, w_f)),
        "bispectrum": lambda: (B.make_distributed_bispectrum(
            mesh, NGRID, BOX, nbins=3, m_min=1.0, m_max=7.0),
            (shard(inp["grid"], mesh, ("x", "y", None)),)),
        "z0_suite": lambda: (S.make_distributed_z0_suite(
            mesh, NGRID, BOX, nbins_pk=NBINS, nbins_bk=3, bk_m_min=2.0,
            bk_m_max=7.0, nplanes=4, max_peaks=64, max_voids=16),
            (pos_f, w_f)),
        "pm_evolve": lambda: (N.make_distributed_pm_evolve(
            mesh, NGRID, BOX, cosmo, nsteps=2),
            (tuple(shard(c, mesh, allax) for c in inp["comps"]),
             tuple(torch.zeros(NGRID ** 3 // 8) for _ in range(3)),
             0.1, 1.0)),
        "gaussian_filter": lambda: (M.make_sharded_gaussian_filter(
            mesh, 64, theta_deg=5.0, sigma_arcmin=4.0),
            (shard(inp["kappa"], mesh, ("x", None)),)),
        "pairwise": lambda: (PW.make_distributed_pairwise(
            mesh, nbins=8, binwidth=20.0, axis="sim", block=128),
            (shard(inp["ppos"], mesh, ("sim", None)),
             shard(inp["pvel"], mesh, ("sim", None)))),
        "raytrace": lambda: (L.make_distributed_raytrace(
            mesh, 3000.0, 0.3, 0.1), (shard(inp["planes"], mesh, ("sim",)),
                                      np.linspace(300.0, 2500.0, 4),
                                      np.full(4, 50.0))),
    }
    alm = torch.zeros(9, 9)
    alm[2, 1] = 0.7
    synth, analyze = SH.make_distributed_sht(mesh, 8, 8)
    calls["sht_synth"] = lambda: (synth, (alm, torch.zeros_like(alm)))
    sky = unshard(synth(alm, torch.zeros_like(alm)), mesh, ("x", None))
    calls["sht_analyze"] = lambda: (lambda m: analyze(m, niter=2), (sky,))
    alm15 = torch.zeros(16, 16)
    alm15[2, 1] = 0.7
    calls["sht_large_synth"] = lambda: (
        SL.make_distributed_sht_large(mesh, 8, 15)[0],
        (alm15, torch.zeros_like(alm15)))
    pk = lambda k: 2.0e3 * (k / 0.1) ** -1.5  # noqa: E731
    fac = F.make_distributed_field_infer(mesh, NGRID, BOX, pk, cosmo,
                                         z_init=9.0, nsteps=2, window="cic")
    wf = shard(inp["white"], mesh, ("x", "y", None))
    calls["field_infer_grad"] = lambda: (
        fac.value_and_grad, (wf, torch.zeros_like(wf), 0.05))
    out = {}
    for name, build in calls.items():
        fn, args = build()
        out[name] = collective_inventory(fn, *args)
    # a deliberately other sharding: pencils (4, 1) for the manifest's
    # (2, 2)
    bad = make_mesh(2, 4, 1, device="cpu")
    out["auto_power_fast_4x1"] = collective_inventory(
        P.make_distributed_auto_power_fast(bad, NGRID, BOX, NBINS),
        shard(pos.reshape(-1, 3), bad, allax + (None,)),
        shard(w.reshape(-1), bad, allax))
    with open(work + "/out_%d.json" % rank, "w") as f:
        json.dump(out, f, sort_keys=True)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(the manifest, each rank's records)."""
    rng = np.random.default_rng(1)
    inp = {"pos": rng.uniform(0, 100.0, (2, 8192, 3)).astype(np.float32),
           "grid": rng.uniform(0.5, 1.5, (16,) * 3).astype(np.float32),
           "comps": rng.uniform(0, 100.0, (3, 16 ** 3)).astype(np.float32),
           "kappa": (rng.standard_normal((64, 64)) * 0.01
                     ).astype(np.float32),
           "ppos": rng.uniform(400, 600, (256, 3)).astype(np.float32),
           "pvel": (rng.standard_normal((256, 3)) * 100).astype(np.float32),
           "planes": (rng.standard_normal((2, 4, 32, 32)) * 0.3
                      ).astype(np.float32),
           "white": rng.standard_normal((16,) * 3).astype(np.float32)}
    work = tmp_path_factory.mktemp("torch_inventory")
    np.savez(work / "inputs.npz", **inp)
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, NRANKS, work, timeout=300)
    with open(MANIFEST) as f:
        manifest = json.load(f)
    return manifest, [json.loads((work / f"out_{r}.json").read_text())
                      for r in range(NRANKS)]


def _expected(name, want):
    """The manifest's record of `name` as the port issues it."""
    out = {k: dict(v) for k, v in want.items()}
    for kind, (count, nbytes) in EXTRA.get(name, {}).items():
        rec = out.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += count
        rec["bytes"] += nbytes
    if name in UNEXPLAINED:
        count, nbytes = UNEXPLAINED[name]
        out["all-reduce"] = {"count": count, "bytes": nbytes}
    return out


def test_manifest_lists_the_factories(records):
    manifest, _ = records
    assert sorted(manifest) == sorted(FACTORIES)


@pytest.mark.parametrize("name", FACTORIES)
def test_collective_inventory_matches_manifest(records, name):
    """Every rank issues the same collectives, and they are the
    manifest's record mapped by the rule (EXTRA) or listed (UNEXPLAINED):
    kinds, counts and bytes. A kind the port issued that XLA's module
    lacks, or the reverse, fails. The empty records (the ring-sharded
    synthesis, the realization-parallel ray trace) stay empty."""
    manifest, outs = records
    for o in outs[1:]:
        assert o[name] == outs[0][name]
    assert outs[0][name] == _expected(name, manifest[name]), (
        f"{name}: port {json.dumps(outs[0][name], sort_keys=True)} "
        f"manifest {json.dumps(manifest[name], sort_keys=True)}")


def test_detects_structural_change(records):
    """Mirror of tests/test_collective_inventory.py::
    test_detects_structural_change: pencils (4, 1) instead of the
    manifest's (2, 2) change the record (8 all-to-alls, not 16; one
    reduce-scatter, not 2), so the inventory pins structure."""
    manifest, outs = records
    got = outs[0]["auto_power_fast_4x1"]
    assert got, "the recorder found no collectives in a pencil FFT"
    assert got != _expected("auto_power_fast", manifest["auto_power_fast"])
    assert got["all-to-all"]["count"] == 8
    assert got["reduce-scatter"]["count"] == 1
