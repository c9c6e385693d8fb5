"""The port's distributed lensing (parallel/lensing.py) against the JAX
package's on the CPU: the per-realization lensing suite and ray trace
over 'sim', particle-sharded lens planes and HEALPix shells (the deposit
route, K1's plain version on a CPU block, and the scatter path, with and
without the per-shard validity mask), and the ray-sharded full-sky
multiplane tracer.

The port runs as a gloo world of 8 processes, one a rank, each running
`_WORKER` (it imports only astrild_tpu_torch, torch and numpy) on the JAX
tests' mesh shapes; the JAX references run in this process on the
conftest's 8 CPU devices. Each test mirrors one of
tests/test_distributed_lensing.py or tests/test_distributed.py (:396,
:634); each tolerance is stated where it is checked. Outputs every rank
must hold alike are equal bit for bit on every rank, and each rank's
block of a sharded output equals the port's single-device result on it.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

from astrild_tpu.ops import lens_planes as JLP  # noqa: E402
from astrild_tpu.ops import lightcone_sphere as JLS  # noqa: E402
from astrild_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from astrild_tpu.parallel import lensing as JDL  # noqa: E402
from torch_gloo import replicated as _replicated  # noqa: E402
from torch_gloo import run_world as _run_world  # noqa: E402

BOX = 100.0
NRANKS = 8
# (mesh shape, realizations, planes, pixels): the JAX suite test's cases
SUITE = (((4, 1, 2), 4, 8, 64), ((2, 2, 2), 2, 6, 96))
RAYTRACE = (((4, 1, 2), 4, 64), ((2, 2, 2), 2, 48))
SUITE_KW = dict(max_peaks=128, max_voids=32)
# lens planes: (chi0, dchi, nplanes, fov, npix); shells: edges, nside
PLANES = (200.0, 31.25, 8, 0.35, 32)
SHELL_EDGES = np.array([20.0, 60.0, 110.0, 170.0])
SHELL_NSIDE = 8
# the multiplane tracer: nside, shells' distances, source, lmax
MP_NSIDE, MP_CHIS, MP_CHI_S = 8, (300.0, 500.0, 700.0), 900.0

_WORKER = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from astrild_tpu_torch.ops import lensing as L
    from astrild_tpu_torch.ops import peaks as PK
    from astrild_tpu_torch.ops import voids as V
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import lensing as DL
    from astrild_tpu_torch.parallel.mesh import shard

    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(work + "/inputs.npz").items()}
    out = {}
    kw = dict(max_peaks=128, max_voids=32)
    for i, c in enumerate(inp["suite_cases"].tolist()):
        shape = tuple(int(v) for v in c[:3])
        mesh = make_mesh(*shape, device="cpu")
        planes = inp["suite%d" % i]
        chis, dchis = inp["suite_chis%d" % i], inp["suite_dchis%d" % i]
        npix = planes.shape[-1]
        res = DL.make_distributed_lensing_suite(
            mesh, npix, 0.1, 3000.0, 0.3, **kw)(
            shard(planes, mesh, ("sim",)), chis, dchis)
        for name, v in zip(res._fields, res):
            out["suite%d.%s" % (i, name)] = v.numpy()
        # the single-device chain on this rank's realizations
        for j, p in enumerate(shard(planes, mesh, ("sim",))):
            kap = L.born_convergence(p, chis, dchis, 3000.0, 0.3)
            a1, a2 = L.kappa_to_alpha(kap, 0.1, padding_factor=2)
            g1, g2 = L.alpha_to_gamma(a1, a2, 0.1)
            cat = PK.find_peaks(kap, threshold=kap.std(correction=0),
                                max_peaks=128, edge_pix=4)
            vc = V.find_tunnels(cat.pos.to(torch.float32),
                                cat.values > float("-inf"), npix,
                                max_voids=32)
            for name, v in (("kappa", kap), ("gamma1", g1),
                            ("gamma2", g2), ("void_radius", vc.radius)):
                out["local%d.%d.%s" % (i, j, name)] = v.numpy()
    for i, c in enumerate(inp["rt_cases"].tolist()):
        mesh = make_mesh(*(int(v) for v in c[:3]), device="cpu")
        planes = inp["rt%d" % i]
        res = DL.make_distributed_raytrace(mesh, 2500.0, 0.3,
                                           float(inp["rt_oa"]))(
            shard(planes, mesh, ("sim",)), inp["rt_chis"], inp["rt_dchis"])
        for name in ("kappa", "gamma1", "gamma2", "omega"):
            out["rt%d.%s" % (i, name)] = res[name].numpy()
    # particle-sharded planes and shells on mesh (2, 2, 2), over 'sim'
    mesh = make_mesh(2, 2, 2, device="cpu")
    pos = tuple(shard(inp["pos"][:, i].contiguous(), mesh, ("sim",))
                for i in range(3))
    pos_m = tuple(shard(inp["pos_m"][:, i].contiguous(), mesh, ("sim",))
                  for i in range(3))
    valid = shard(inp["valid"], mesh, ("sim",))
    chi0, dchi, npl, fov, npx = inp["planes_geo"].tolist()
    edges = inp["shell_edges"].numpy()
    nside = int(inp["shell_nside"])
    for dep in ("scatter", "pallas", None):
        tag = str(dep)
        delta, chis = DL.make_distributed_lens_planes(
            mesh, 100.0, chi0, dchi, int(npl), fov, int(npx), axis="sim",
            deposit=dep)(pos)
        out["planes." + tag] = delta.numpy()
        out["planes_chis." + tag] = chis.numpy()
        out["shells." + tag] = DL.make_distributed_healpix_shells(
            mesh, edges, nside, 100.0, axis="sim", deposit=dep)(pos).numpy()
    for dep in ("scatter", None):
        tag = str(dep)
        out["planes_mask." + tag] = DL.make_distributed_lens_planes(
            mesh, 100.0, chi0, dchi, int(npl), fov, int(npx), axis="sim",
            with_valid_mask=True, deposit=dep)(pos_m, valid)[0].numpy()
        out["shells_mask." + tag] = DL.make_distributed_healpix_shells(
            mesh, edges, nside, 100.0, axis="sim", with_valid_mask=True,
            deposit=dep)(pos_m, valid).numpy()
    try:
        DL.make_distributed_lens_planes(mesh, 100.0, chi0, dchi, int(npl),
                                        fov, int(npx), deposit="pallas3")
    except ValueError as e:
        out["deposit_raise"] = np.asarray("deposit must be" in str(e))
    # the ray-sharded tracer over 'x' of mesh (1, 4, 2)
    mesh = make_mesh(1, 4, 2, device="cpu")
    mp_nside = int(inp["mp_nside"])
    fn = DL.make_distributed_multiplane_healpix(mesh, mp_nside, 0.3,
                                                lmax=2 * mp_nside)
    res = fn(inp["mp_delta"], inp["mp_chis"], inp["mp_dchis"],
             float(inp["mp_chi_s"]))
    for name in ("kappa", "gamma1", "gamma2", "omega"):
        out["mp." + name] = res[name].numpy()
    try:
        fn(inp["mp_delta"], inp["mp_chis"], inp["mp_dchis"],
           np.array([700.0, 900.0]))
    except ValueError:
        out["mp_chi_s_raise"] = np.asarray(True)
    np.savez(work + "/out_%d.npz" % rank, **out)
    assert "jax" not in sys.modules, "a worker imported jax"
    print("WORKER_OK", rank)
''')


def _inputs():
    rng = np.random.default_rng(11)
    inp = {"suite_cases": np.asarray([s + (n, p, x)
                                      for s, n, p, x in SUITE]),
           "rt_cases": np.asarray([s + (n, x) for s, n, x in RAYTRACE]),
           "rt_oa": np.asarray(np.radians(5.0)),
           "rt_chis": np.linspace(500.0, 2000.0, 4).astype(np.float32),
           "rt_dchis": np.full(4, 375.0, np.float32)}
    for i, (_, nsim, nplane, npix) in enumerate(SUITE):
        inp["suite%d" % i] = rng.normal(0, 0.5, (nsim, nplane, npix, npix)
                                        ).astype(np.float32)
        inp["suite_chis%d" % i] = np.asarray(
            jnp.linspace(300.0, 2500.0, nplane), np.float32)
        inp["suite_dchis%d" % i] = np.full(nplane, 50.0, np.float32)
    for i, (_, nsim, npix) in enumerate(RAYTRACE):
        inp["rt%d" % i] = rng.normal(0, 0.3, (nsim, 4, npix, npix)
                                     ).astype(np.float32)
    pos = rng.uniform(0, BOX, (4096, 3)).astype(np.float32)
    valid = np.ones(4096, np.float32)
    valid[1000:2048] = 0.0
    inp.update(pos=pos, valid=valid,
               pos_m=np.where(valid[:, None] > 0, pos, 0.0
                              ).astype(np.float32),
               planes_geo=np.asarray(PLANES, np.float64),
               shell_edges=SHELL_EDGES, shell_nside=np.asarray(SHELL_NSIDE),
               mp_nside=np.asarray(MP_NSIDE),
               mp_delta=rng.normal(0.0, 0.3, (3, 12 * MP_NSIDE ** 2)
                                   ).astype(np.float32),
               mp_chis=np.asarray(MP_CHIS, np.float32),
               mp_dchis=np.full(3, 100.0, np.float32),
               mp_chi_s=np.asarray(MP_CHI_S))
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, outputs of every rank): the 8-rank world run once."""
    work = tmp_path_factory.mktemp("torch_dist_lensing")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    script = work / "worker.py"
    script.write_text(_WORKER)
    _run_world(script, NRANKS, work, timeout=300)
    return inp, [dict(np.load(work / f"out_{r}.npz"))
                 for r in range(NRANKS)]


def _sim_blocks(outs, key, shape):
    """The global (nsim, ...) array of a P('sim') output: rank r holds
    block r // (n_x n_y); the ranks of one block hold it alike."""
    per = shape[1] * shape[2]
    for r in range(NRANKS):
        npt.assert_array_equal(outs[r][key], outs[r - r % per][key])
    return np.concatenate([outs[s * per][key] for s in range(shape[0])])


def _jsh(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


@pytest.mark.parametrize("case", range(len(SUITE)))
def test_distributed_lensing_matches_local(world, case):
    """Mirror of test_distributed_lensing.py::
    test_distributed_lensing_matches_local: every realization of the
    port's suite equals the port's single-device chain on it bit for bit,
    and the JAX package's distributed suite on the same mesh within the
    JAX test's bars (kappa rtol 1e-5 / atol 1e-8, gamma rtol 1e-4 / atol
    1e-7, void radii rtol 1e-5, void counts equal)."""
    inp, outs = world
    shape, nsim, nplane, npix = SUITE[case]
    t = "suite%d." % case
    got = {name: _sim_blocks(outs, t + name, shape)
           for name in ("kappa", "gamma1", "gamma2", "void_radius",
                        "n_voids")}
    per = shape[1] * shape[2]
    nloc = nsim // shape[0]
    for s in range(nsim):
        r, j = (s // nloc) * per, s % nloc
        for name in ("kappa", "gamma1", "gamma2", "void_radius"):
            npt.assert_array_equal(got[name][s],
                                   outs[r]["local%d.%d.%s" % (case, j, name)])
    mesh = jmake_mesh(*shape)
    want = JDL.make_distributed_lensing_suite(
        mesh, npix, 0.1, 3000.0, 0.3, **SUITE_KW)(
        _jsh(mesh, inp["suite%d" % case], P("sim")),
        jnp.asarray(inp["suite_chis%d" % case]),
        jnp.asarray(inp["suite_dchis%d" % case]))
    assert got["kappa"].shape == (nsim, npix, npix)
    npt.assert_allclose(got["kappa"], np.asarray(want.kappa), rtol=1e-5,
                        atol=1e-8)
    for name in ("gamma1", "gamma2"):
        npt.assert_allclose(got[name], np.asarray(getattr(want, name)),
                            rtol=1e-4, atol=1e-7)
    npt.assert_allclose(got["void_radius"], np.asarray(want.void_radius),
                        rtol=1e-5)
    npt.assert_array_equal(got["n_voids"], np.asarray(want.n_voids))


@pytest.mark.parametrize("case", range(len(RAYTRACE)))
def test_distributed_raytrace_matches_local(world, case):
    """Mirror of test_distributed_lensing.py::
    test_distributed_raytrace_matches_local: the port's ray trace over
    'sim' against the JAX package's on the same mesh (the JAX test's bar,
    rtol 2e-4, atol 5e-7)."""
    inp, outs = world
    shape, nsim, npix = RAYTRACE[case]
    mesh = jmake_mesh(*shape)
    want = JDL.make_distributed_raytrace(
        mesh, 2500.0, 0.3, float(inp["rt_oa"]))(
        _jsh(mesh, inp["rt%d" % case], P("sim")),
        jnp.asarray(inp["rt_chis"]), jnp.asarray(inp["rt_dchis"]))
    for name in ("kappa", "gamma1", "gamma2", "omega"):
        got = _sim_blocks(outs, "rt%d.%s" % (case, name), shape)
        assert got.shape == (nsim, npix, npix)
        npt.assert_allclose(got, np.asarray(want[name]), rtol=2e-4,
                            atol=5e-7)


def _jax_particles(inp, key="pos"):
    mesh22 = jmake_mesh(2, 2, 2)
    sh = NamedSharding(mesh22, P("sim"))
    return mesh22, tuple(jax.device_put(jnp.asarray(inp[key][:, i]), sh)
                         for i in range(3))


def test_distributed_lens_planes_matches_local(world):
    """Mirror of test_distributed.py:396: particle-sharded planes on
    mesh22's 'sim' axis, through the deposit route (None and the JAX
    spelling 'pallas': K1's plain version here) and the scatter path,
    against the JAX package's single-device function (the JAX test's bar,
    1e-3 of the field's std) and its distributed scatter path (the same
    bar); the scatter path equals the port's own two-rank psum of scatter
    paths; with per-shard padding masked, against the compacted catalog
    (the JAX test's bar, rtol 1e-3, atol 1e-5). Any other deposit raises
    the JAX package's ValueError."""
    inp, outs = world
    chi0, dchi, npl, fov, npix = PLANES
    pos = tuple(jnp.asarray(inp["pos"][:, i]) for i in range(3))
    want, chis = JLP.density_planes_from_particles(pos, BOX, chi0, dchi,
                                                   npl, fov, npix)
    want = np.asarray(want)
    mesh22, posd = _jax_particles(inp)
    jd, _ = JDL.make_distributed_lens_planes(
        mesh22, BOX, chi0, dchi, npl, fov, npix, axis="sim",
        deposit="scatter")(posd)
    tol = 1e-3 * float(np.std(want))
    for dep in ("scatter", "pallas", "None"):
        got = _replicated(outs, "planes." + dep)
        npt.assert_allclose(got, want, atol=tol)
        npt.assert_allclose(got, np.asarray(jd), atol=tol)
        npt.assert_array_equal(_replicated(outs, "planes_chis." + dep),
                               np.asarray(chis))
    npt.assert_array_equal(_replicated(outs, "planes.pallas"),
                           _replicated(outs, "planes.None"))
    real = inp["valid"] > 0
    want_m, _ = JLP.density_planes_from_particles(
        tuple(jnp.asarray(inp["pos"][real, i]) for i in range(3)), BOX,
        chi0, dchi, npl, fov, npix)
    for dep in ("scatter", "None"):
        npt.assert_allclose(_replicated(outs, "planes_mask." + dep),
                            np.asarray(want_m), rtol=1e-3, atol=1e-5)
    assert all(bool(o["deposit_raise"]) for o in outs)


def test_distributed_healpix_shells_matches_local(world):
    """Mirror of test_distributed.py:634: particle-sharded HEALPix shells
    (edges that need box replication) through the deposit route and the
    scatter path against the JAX package's single-device function and its
    distributed scatter path (the JAX test's bar, 1e-3 of the field's
    std); the masked catalog against the compacted one (rtol 1e-3, atol
    1e-5)."""
    inp, outs = world
    pos = tuple(jnp.asarray(inp["pos"][:, i]) for i in range(3))
    want, _, _ = JLS.density_shells_healpix(pos, SHELL_EDGES, SHELL_NSIDE,
                                            BOX)
    want = np.asarray(want)
    mesh22, posd = _jax_particles(inp)
    jd = JDL.make_distributed_healpix_shells(
        mesh22, SHELL_EDGES, SHELL_NSIDE, BOX, axis="sim",
        deposit="scatter")(posd)
    tol = 1e-3 * float(np.std(want))
    for dep in ("scatter", "pallas", "None"):
        got = _replicated(outs, "shells." + dep)
        npt.assert_allclose(got, want, atol=tol)
        npt.assert_allclose(got, np.asarray(jd), atol=tol)
    real = inp["valid"] > 0
    want_m, _, _ = JLS.density_shells_healpix(
        tuple(jnp.asarray(inp["pos"][real, i]) for i in range(3)),
        SHELL_EDGES, SHELL_NSIDE, BOX)
    for dep in ("scatter", "None"):
        npt.assert_allclose(_replicated(outs, "shells_mask." + dep),
                            np.asarray(want_m), rtol=1e-3, atol=1e-5)


def _ray_blocks(outs, key):
    """The (npix,) map of a ray-sharded output over 'x' of mesh (1, 4, 2):
    rank r holds block r // 2; the two ranks of a block hold it alike."""
    for r in range(0, NRANKS, 2):
        npt.assert_array_equal(outs[r + 1][key], outs[r][key])
    return np.concatenate([outs[r][key] for r in range(0, NRANKS, 2)])


def test_distributed_multiplane_healpix_matches_local(world):
    """Mirror of test_distributed_lensing.py::
    test_distributed_multiplane_healpix_matches_local: the ray-sharded
    tracer (4 ray blocks) against the JAX package's on its 4-device 'x'
    mesh and its single-device tracer (the JAX test's bar, atol 1e-5)."""
    inp, outs = world
    want = JLS.multiplane_raytrace_healpix(
        inp["mp_delta"], inp["mp_chis"], inp["mp_dchis"], MP_CHI_S, 0.3,
        lmax=2 * MP_NSIDE)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("x",))
    jd = JDL.make_distributed_multiplane_healpix(
        mesh, MP_NSIDE, 0.3, lmax=2 * MP_NSIDE)(
        inp["mp_delta"], inp["mp_chis"], inp["mp_dchis"], MP_CHI_S)
    for name in ("kappa", "gamma1", "gamma2", "omega"):
        got = _ray_blocks(outs, "mp." + name)
        npt.assert_allclose(got, np.asarray(want[name]), atol=1e-5,
                            err_msg=name)
        npt.assert_allclose(got, np.asarray(jd[name]), atol=1e-5,
                            err_msg=name)


def test_distributed_multiplane_rejects_array_chi_s(world):
    """Mirror of test_distributed_lensing.py::
    test_distributed_multiplane_rejects_array_chi_s: an array chi_s raises
    the JAX package's ValueError on every rank."""
    _, outs = world
    assert all(bool(o["mp_chi_s_raise"]) for o in outs)
