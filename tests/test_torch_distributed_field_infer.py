"""The port's distributed PM and field-level inference (parallel/nbody.py,
parallel/field_infer.py) against the JAX package on the CPU.

The port runs as a gloo world of 8 processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy) on mesh
(2, 2, 2), the JAX tests' mesh22: the white field and the data split over
the pencil axes ('x', 'y'), the 'sim' ranks repeating the work; the PM
particles split over all three axes. The JAX references run in this
process. The mirrored tests are tests/test_distributed_field_infer.py's
four; the PM evolver is held to ops.nbody.pm_evolve of both packages.

As there, the parity point starts off the lattice (0.8 white_t + 0.2
noise): at the prior mean the 2LPT particles sit on CIC's kinks, where
the gradient's side is a float32 rounding decision (ROADMAP.md section 3).
The gradient is held both to the port's single-device gradient and to the
JAX package's distributed one: a gradient off by the number of ranks (the
psum rule of parallel/mesh.py) fails both. Each tolerance is stated where
it is checked.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu.ops import field_infer as JF  # noqa: E402
from astrild_tpu.ops import nbody as JN  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel.field_infer import (  # noqa: E402
    make_distributed_field_infer as jfield_infer)
from astrild_tpu.utils.cosmology import Cosmology as JCosmology  # noqa: E402
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

NRANKS = 8
BOX = 100.0
NGRID = 16
KW = dict(z_init=9.0, nsteps=2, window="cic")
COSMOS = {"gr": {"Om0": 0.3, "h": 0.7},
          "fofr": {"Om0": 0.3, "h": 0.7, "fR0": 1e-5}}
# the PM evolver's particles (random in the box, small momenta) and steps
PM_STEPS, PM_A = 3, (0.2, 1.0)


def _pk(k):
    return 2.0e3 * (k / 0.1) ** -1.5


_WORKER = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.ops import field_infer as FI
    from astrild_tpu_torch.ops import nbody as NB
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import field_infer as DF
    from astrild_tpu_torch.parallel import nbody as DN
    from astrild_tpu_torch.parallel.mesh import shard, unshard
    from astrild_tpu_torch.utils.cosmology import Cosmology

    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    out = {}
    mesh = make_mesh(2, 2, 2, device="cpu")
    box, ng = 100.0, 16
    kw = dict(z_init=9.0, nsteps=2, window="cic")
    pk = lambda k: 2.0e3 * (k / 0.1) ** -1.5  # noqa: E731
    cosmo = Cosmology(Om0=0.3, h=0.7)
    spec = ("x", "y", None)
    fac = DF.make_distributed_field_infer(mesh, ng, box, pk, cosmo, **kw)
    white_t, white = inp["white_t"], inp["white"]
    data = inp["data"]
    out["simulate"] = unshard(fac.simulate(shard(white_t, mesh, spec)),
                              mesh, spec).numpy()
    # deposit="scatter" (the JAX package's forced route) names the CPU's
    out["simulate_scatter"] = unshard(DF.make_distributed_field_infer(
        mesh, ng, box, pk, cosmo, deposit="scatter", **kw).simulate(
        shard(white_t, mesh, spec)), mesh, spec).numpy()
    out["loss"] = fac.loss(shard(white, mesh, spec), shard(data, mesh, spec),
                           0.05).numpy()
    val, g = fac.value_and_grad(shard(white, mesh, spec),
                                shard(data, mesh, spec), 0.05)
    out["value"] = val.numpy()
    out["grad_block"] = g.numpy()
    g = unshard(g, mesh, spec)
    out["grad"] = g.numpy()
    # one descent step, scaled to a largest move of 1e-2
    alpha = 1e-2 / float(g.abs().max())
    out["loss_after"] = fac.loss(shard(white - alpha * g, mesh, spec),
                                 shard(data, mesh, spec), 0.05).numpy()
    if rank == 0:
        w = white.clone().requires_grad_(True)
        loss = FI.field_nll(w, data, 0.05, pk, cosmo, boxsize=box, **kw)
        out["grad1"] = torch.autograd.grad(loss, w)[0].numpy()
        out["simulate1"] = FI.simulate_density(white_t, pk, cosmo, ngrid=ng,
                                               boxsize=box, **kw).numpy()
    # the PM evolver, GR and f(R), particles over every axis
    row = (("sim", "x", "y"),)
    steps = int(inp["pm_steps"])
    a0, a1 = inp["pm_a"].tolist()
    for name, ckw in (("gr", {}), ("fofr", {"fR0": 1e-5})):
        cos = Cosmology(Om0=0.3, h=0.7, **ckw)
        ev = DN.make_distributed_pm_evolve(mesh, ng, box, cos, steps)
        comps = tuple(shard(inp["pm_pos"][i].contiguous(), mesh, row)
                      for i in range(3))
        mom = tuple(shard(inp["pm_mom"][i].contiguous(), mesh, row)
                    for i in range(3))
        c, m = ev(comps, mom, a0, a1)
        if name == "gr":
            cs, _ = DN.make_distributed_pm_evolve(
                mesh, ng, box, cos, steps, deposit="scatter")(comps, mom,
                                                              a0, a1)
            out["pm_scatter_same"] = np.asarray(all(
                torch.equal(x, y) for x, y in zip(c, cs)))
        out["pm_pos_" + name] = torch.stack(
            [unshard(x, mesh, row) for x in c]).numpy()
        out["pm_mom_" + name] = torch.stack(
            [unshard(x, mesh, row) for x in m]).numpy()
        if rank == 0:
            c1, m1 = NB.pm_evolve(tuple(inp["pm_pos"]), tuple(inp["pm_mom"]),
                                  cos, ng, box, a0, a1, steps)
            out["pm_pos1_" + name] = torch.stack(c1).numpy()
            out["pm_mom1_" + name] = torch.stack(m1).numpy()
    np.savez(work + "/out_%d.npz" % rank, **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX mesh22, JAX distributed factory, inputs, outputs of every
    rank): the JAX test's setup, and the 8-rank world run once."""
    mesh = jmake_mesh(2, 2, 2)
    jc = JCosmology(**COSMOS["gr"])
    fac = jfield_infer(mesh, NGRID, BOX, _pk, jc, **KW)
    white_t = jax.random.normal(jax.random.PRNGKey(3), (NGRID,) * 3)
    data = JF.simulate_density(white_t, _pk, jc, ngrid=NGRID, boxsize=BOX,
                               **KW)
    white = 0.8 * white_t + 0.2 * jax.random.normal(
        jax.random.PRNGKey(4), (NGRID,) * 3)
    rng = np.random.default_rng(9)
    inp = {"white_t": np.asarray(white_t, np.float32),
           "white": np.asarray(white, np.float32),
           "data": np.asarray(data, np.float32),
           "pm_pos": rng.uniform(0, BOX, (3, NGRID ** 3)).astype(np.float32),
           "pm_mom": rng.normal(0, 0.5, (3, NGRID ** 3)).astype(np.float32),
           "pm_steps": np.asarray(PM_STEPS), "pm_a": np.asarray(PM_A)}
    work = tmp_path_factory.mktemp("torch_dist_field")
    np.savez(work / "inputs.npz", **inp)
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, NRANKS, work, timeout=300)
    outs = [dict(np.load(work / f"out_{r}.npz")) for r in range(NRANKS)]
    return mesh, fac, inp, outs


def test_simulate_matches_local(setup):
    """Mirror of test_simulate_matches_local: the sharded forward model of
    the truth field against the JAX package's single-device chain (the
    JAX test's bar, atol 2e-4) and its sharded one (the same bar), and
    within 1e-5 of the port's single-device chain (c2c pencil FFTs
    against r2c ones); deposit="scatter", the CPU's route named, equal
    bit for bit."""
    _, fac, inp, outs = setup
    got = _replicated(outs, "simulate")
    npt.assert_allclose(got, inp["data"], atol=2e-4)
    npt.assert_allclose(got, np.asarray(fac.simulate(inp["white_t"])),
                        atol=2e-4)
    npt.assert_allclose(got, outs[0]["simulate1"], atol=1e-5)
    npt.assert_array_equal(_replicated(outs, "simulate_scatter"), got)


def test_loss_matches_local(setup):
    """Mirror of test_loss_matches_local: the sharded posterior within the
    JAX test's 1e-3 of the JAX package's field_nll and of its sharded
    loss; value_and_grad's value is the loss."""
    _, fac, inp, outs = setup
    want = float(JF.field_nll(jnp.asarray(inp["white"]),
                              jnp.asarray(inp["data"]), 0.05, _pk,
                              JCosmology(**COSMOS["gr"]), boxsize=BOX, **KW))
    got = float(_replicated(outs, "loss"))
    assert abs(got - want) < 1e-3 * abs(want), (got, want)
    want_d = float(fac.loss(inp["white"], inp["data"], 0.05))
    assert abs(got - want_d) < 1e-3 * abs(want_d), (got, want_d)
    npt.assert_allclose(float(_replicated(outs, "value")), got, rtol=1e-6)


def test_gradient_matches_local(setup):
    """Mirror of test_gradient_matches_local: the sharded gradient against
    jax.grad of the JAX package's single-device loss and its distributed
    value_and_grad (the JAX test's bar, relative L2 1e-3), and the port's
    single-device gradient (relative L2 1e-4). Each rank's block is its
    part of the assembled gradient."""
    _, fac, inp, outs = setup
    got = _replicated(outs, "grad")
    jc = JCosmology(**COSMOS["gr"])
    g_local = np.asarray(jax.grad(lambda w: JF.field_nll(
        w, jnp.asarray(inp["data"]), 0.05, _pk, jc, boxsize=BOX, **KW))(
        jnp.asarray(inp["white"])))
    _, g_dist = fac.value_and_grad(jnp.asarray(inp["white"]),
                                   jnp.asarray(inp["data"]), 0.05)
    for want, bar in ((g_local, 1e-3), (np.asarray(g_dist), 1e-3),
                      (outs[0]["grad1"], 1e-4)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < bar, rel
    for r in range(NRANKS):
        x, y = (r // 2) % 2, r % 2
        npt.assert_array_equal(outs[r]["grad_block"],
                               got[x * 8:(x + 1) * 8, y * 8:(y + 1) * 8])


def test_gradient_descends(setup):
    """Mirror of test_gradient_descends: one step along -grad (largest
    move 1e-2) lowers the sharded loss."""
    _, _, _, outs = setup
    assert float(_replicated(outs, "loss_after")) < float(
        _replicated(outs, "loss"))


def _periodic(a, b):
    return np.abs((a - b + BOX / 2) % BOX - BOX / 2)


@pytest.mark.parametrize("gravity", sorted(COSMOS))
def test_pm_evolve_matches_single_device(setup, gravity):
    """make_distributed_pm_evolve ('sim' paints psum'd, reduce-scatter
    re-pencil, pencil FFT forces, all-gather readout) against
    ops.nbody.pm_evolve: positions within 1e-4 Mpc/h (periodic) and
    momenta within 1e-5 of their max of the port's (one float32 chain
    against another: c2c pencil transforms against r2c ones), and within
    1e-3 Mpc/h and 1e-4 of the max of the JAX package's; deposit="scatter"
    (the CPU's route named) equal bit for bit."""
    _, _, inp, outs = setup
    assert all(bool(o["pm_scatter_same"]) for o in outs)
    pos = _replicated(outs, "pm_pos_" + gravity)
    mom = _replicated(outs, "pm_mom_" + gravity)
    assert _periodic(pos, outs[0]["pm_pos1_" + gravity]).max() < 1e-4
    m1 = outs[0]["pm_mom1_" + gravity]
    npt.assert_allclose(mom, m1, atol=1e-5 * np.abs(m1).max())
    jc = JCosmology(**COSMOS[gravity])
    jp, jm = JN.pm_evolve(tuple(jnp.asarray(c) for c in inp["pm_pos"]),
                          tuple(jnp.asarray(p) for p in inp["pm_mom"]), jc,
                          NGRID, BOX, *PM_A, PM_STEPS)
    jp = np.stack([np.asarray(c) for c in jp])
    jm = np.stack([np.asarray(p) for p in jm])
    assert _periodic(pos, jp).max() < 1e-3
    npt.assert_allclose(mom, jm, atol=1e-4 * np.abs(jm).max())
