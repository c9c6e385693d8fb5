"""PyTorch port vs JAX package on the CPU: the pair estimator (binred,
the pair-tile plain version of K3, mean_pairwise_velocity) and the plain
version of the windowed CIC/TSC painter K2.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas kernels as its own tests do (interpret mode on the
CPU); the port's side runs the plain versions, which its wrappers use for
CPU tensors. Each tolerance is stated where it is checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import binred as JB  # noqa: E402
from astrild_tpu.ops import paint as JP  # noqa: E402
from astrild_tpu.ops import pairwise as JPW  # noqa: E402
from astrild_tpu.ops.paint_pallas import paint_windowed as j_windowed  # noqa: E402,E501
from astrild_tpu.ops.pallas_pairwise import pairwise_accumulate_pallas  # noqa: E402,E501
from astrild_tpu_torch.ops import binred as TB  # noqa: E402
from astrild_tpu_torch.ops import paint as TP  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda as TPC  # noqa: E402
from astrild_tpu_torch.ops import pairwise as TPW  # noqa: E402
from astrild_tpu_torch.ops import pairwise_cuda as TPWC  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a))


def _catalog(rng, n, lo=400.0, hi=600.0):
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 100, (n, 3)).astype(np.float32)
    return pos, vel


# -------------------------------------------------------------- binred
@pytest.mark.parametrize("chunk", [1024, 65536])
def test_masked_bin_reduce_full_f32_on_cancelling_values(rng, chunk):
    """Pairs of +-1e4 values with small residues cancel in every bin. A
    TF32 or bf16 contraction would keep ~1e-3 of each 1e4 value (errors
    of ~10); full float32 keeps the residues to 1e-6 of sum|v| per bin,
    against a float64 oracle and against the JAX package."""
    n, nbins = 5000, 7
    big = rng.uniform(5e3, 1e4, n // 2)
    small = rng.uniform(-1.0, 1.0, n)
    vals = np.concatenate([big, -big]) + small
    chans = np.stack([vals, 2.0 * vals[::-1]]).astype(np.float32)
    binidx = rng.integers(0, nbins + 1, n).astype(np.int32)  # nbins = drop
    binidx[: n // 2] = binidx[n // 2:]  # each +big meets its -big
    chans[:, binidx == nbins] = 0.0
    want = np.zeros((2, nbins))
    scale = np.zeros((2, nbins))
    for b in range(nbins):
        want[:, b] = chans[:, binidx == b].astype(np.float64).sum(1)
        scale[:, b] = np.abs(chans[:, binidx == b]).astype(np.float64).sum(1)
    got = TB.masked_bin_reduce(T(chans), T(binidx), nbins, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (2, nbins)
    npt.assert_array_less(np.abs(got.numpy() - want), 1e-6 * scale + 1e-6)
    jgot = np.asarray(JB.masked_bin_reduce(jnp.asarray(chans),
                                           jnp.asarray(binidx), nbins))
    npt.assert_array_less(np.abs(got.numpy() - jgot), 2e-6 * scale + 1e-6)


# ------------------------------------------------------ K3 plain version
def test_pairwise_accumulate_reference_matches_pallas(rng):
    """The plain tiles vs the JAX Pallas kernel (interpret) and the JAX
    tile scan, n = 300 (tests/test_manifest_pallas.py:51): rtol 1e-4 with
    atol 1e-4 of each output's max (float32 sums in other orders)."""
    n, nbins, binw = 300, 20, 5.0
    pos, vel = _catalog(rng, n)
    nom_p, den_p = pairwise_accumulate_pallas(jnp.asarray(pos),
                                              jnp.asarray(vel), n, binw,
                                              nbins, block=128)
    nom_x, den_x = JPW._pairwise_accumulate(jnp.asarray(pos),
                                            jnp.asarray(vel), n, nbins,
                                            binw, block=128)
    for block in (128, 512):
        nom, den = TPWC.pairwise_accumulate_reference(T(pos), T(vel), n,
                                                      binw, nbins,
                                                      block=block)
        for got, wants in ((nom, (nom_p, nom_x)), (den, (den_p, den_x))):
            for want in wants:
                want = np.asarray(want)
                npt.assert_allclose(got.numpy(), want, rtol=1e-4,
                                    atol=1e-4 * np.abs(want).max())


def test_pairwise_accumulate_respects_n_valid(rng):
    """Junk rows past n_valid form no pairs
    (tests/test_manifest_pallas.py:65): equal to the clean catalog's sums
    to rtol 1e-5, and to the JAX kernel's on the same padded input."""
    n = 100
    pos, vel = _catalog(rng, n)
    pos2 = np.concatenate([pos, np.full((28, 3), 500.0, np.float32)])
    vel2 = np.concatenate([vel, np.full((28, 3), 1e6, np.float32)])
    a = TPWC.pairwise_accumulate(T(pos), T(vel), n, 5.0, 10)
    b = TPWC.pairwise_accumulate(T(pos2), T(vel2), n, 5.0, 10)
    for x, y in zip(a, b):
        npt.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5)
    jn, jd = pairwise_accumulate_pallas(jnp.asarray(pos2),
                                        jnp.asarray(vel2), n, 5.0, 10)
    npt.assert_allclose(b[0].numpy(), np.asarray(jn), rtol=1e-4,
                        atol=1e-4 * np.abs(np.asarray(jn)).max())
    npt.assert_allclose(b[1].numpy(), np.asarray(jd), rtol=1e-4)


def test_pairwise_accumulate_wrapper_rules(rng):
    """On a CPU tensor the wrapper runs the plain tiles and counts no
    launch; pairs beyond the last bin are dropped before the bin cast;
    malformed inputs raise."""
    pos, vel = _catalog(rng, 64, 0.0, 1000.0)
    before = dict(TPWC.LAUNCHES)
    nom, den = TPWC.pairwise_accumulate(T(pos), T(vel), 64, 1e-3, 4)
    assert dict(TPWC.LAUNCHES) == before
    assert float(nom.abs().sum()) == 0.0 and float(den.sum()) == 0.0
    with pytest.raises(ValueError, match="nbins"):
        TPWC.pairwise_accumulate(T(pos), T(vel), 64, 1.0, 129)
    with pytest.raises(ValueError, match="n_valid"):
        TPWC.pairwise_accumulate(T(pos), T(vel), 65, 1.0, 4)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        TPWC.pairwise_accumulate(T(pos[:, :2]), T(vel[:, :2]), 64, 1.0, 4)


# ------------------------------------------------ mean_pairwise_velocity
@pytest.mark.parametrize("block", [64, 512])
def test_mean_pairwise_velocity_matches_jax(rng, block):
    """Uniform make_rsep bins (the halos.py defaults): bin centres to
    rtol 1e-6 (torch and jnp evaluate float32 linspace an ulp apart), v12
    to rtol 1e-4 (ratios of float32 sums)."""
    pos, vel = _catalog(rng, 400, 450.0, 550.0)
    bins = np.linspace(0, 50, 25)
    jr, jv = JPW.mean_pairwise_velocity(jnp.asarray(pos), jnp.asarray(vel),
                                        jnp.asarray(bins), block=block)
    tr, tv = TPW.mean_pairwise_velocity(T(pos), T(vel),
                                        T(bins.astype(np.float32)),
                                        block=block)
    npt.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    npt.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-3)
    npt.assert_allclose(TPW.make_rsep(25, 2.0).numpy(),
                        np.asarray(JPW.make_rsep(25, 2.0)), rtol=1e-6)


def test_pairwise_infall_sign():
    """Port of tests/test_halo_stats.py::test_pairwise_infall_sign."""
    rng = np.random.default_rng(0)
    n = 256
    pos = np.zeros((2 * n, 3), np.float32)
    pos[:n] = rng.normal([480, 500, 500], 1.0, (n, 3))
    pos[n:] = rng.normal([520, 500, 500], 1.0, (n, 3))
    vel = np.zeros((2 * n, 3), np.float32)
    vel[:n, 0] = 100.0
    vel[n:, 0] = -100.0
    rsep, v12 = TPW.mean_pairwise_velocity(T(pos), T(vel),
                                           np.linspace(0, 50, 25))
    i40 = int(np.argmin(np.abs(rsep.numpy() - 40.0)))
    assert float(v12[i40]) < -100.0


def test_pairwise_uneven_bins_match_bruteforce_and_jax():
    """Port of tests/test_halo_stats.py::test_pairwise_uneven_bins_...:
    a float64 O(N^2) oracle with half-open intervals (rtol 5e-3, as the
    JAX test), and the JAX package on the same input (rtol 1e-4)."""
    rng = np.random.default_rng(7)
    n = 96
    pos = rng.uniform(400.0, 600.0, (n, 3))
    vel = rng.normal(0.0, 200.0, (n, 3))
    edges = np.array([5.0, 20.0, 50.0, 110.0, 200.0])
    nb = edges.size - 1
    nom = np.zeros(nb)
    den = np.zeros(nb)
    for i in range(n):
        for j in range(i + 1, n):
            rij = pos[i] - pos[j]
            r = np.linalg.norm(rij)
            b = np.searchsorted(edges, r, side="right") - 1
            if r < edges[0] or b < 0 or b >= nb:
                continue
            rhat = rij / r
            pi = pos[i] / np.linalg.norm(pos[i])
            pj = pos[j] / np.linalg.norm(pos[j])
            q = 0.5 * (2.0 * rhat - pi * np.dot(rhat, pi)
                       - pj * np.dot(rhat, pj))
            nom[b] += np.dot(vel[i] - vel[j], q)
            den[b] += np.dot(q, q)
    want = nom / np.maximum(den, 1e-30)
    p32, v32 = pos.astype(np.float32), vel.astype(np.float32)
    rsep, v12 = TPW.mean_pairwise_velocity(T(p32), T(v32), edges, block=64)
    npt.assert_allclose(rsep.numpy(), 0.5 * (edges[1:] + edges[:-1]))
    npt.assert_allclose(v12.numpy(), want, rtol=5e-3)
    _, jv = JPW.mean_pairwise_velocity(jnp.asarray(p32), jnp.asarray(v32),
                                       jnp.asarray(edges), block=64)
    npt.assert_allclose(v12.numpy(), np.asarray(jv), rtol=1e-4)


def test_pairwise_uniform_offset_edges_take_edge_path():
    """Port of tests/test_halo_stats.py::test_pairwise_uniform_offset_...:
    uniform edges with a nonzero start bin into len(edges)-1 intervals."""
    rng = np.random.default_rng(11)
    pos, vel = (rng.uniform(400.0, 600.0, (64, 3)).astype(np.float32),
                rng.normal(0.0, 200.0, (64, 3)).astype(np.float32))
    rsep, v12 = TPW.mean_pairwise_velocity(T(pos), T(vel),
                                           np.array([5.0, 15.0, 25.0, 35.0]),
                                           block=64)
    assert v12.shape == (3,)
    npt.assert_allclose(rsep.numpy(), [10.0, 20.0, 30.0])
    _, v12b = TPW.mean_pairwise_velocity(
        T(pos), T(vel), np.array([5.0, 15.0, 25.0, 35.000001]), block=64)
    npt.assert_allclose(v12.numpy(), v12b.numpy(), rtol=1e-4)


def test_pairwise_backend_rules(rng):
    """'auto' runs the plain tiles on the CPU; 'kernel' on a CPU tensor
    raises; unknown backends and non-ascending edges raise."""
    pos, vel = _catalog(rng, 50)
    bins = np.linspace(0, 50, 11)
    before = dict(TPWC.LAUNCHES)
    _, a = TPW.mean_pairwise_velocity(T(pos), T(vel), bins)
    _, b = TPW.mean_pairwise_velocity(T(pos), T(vel), bins, backend="plain")
    assert torch.equal(a.isnan(), b.isnan())
    torch.testing.assert_close(a[~a.isnan()], b[~b.isnan()])
    assert dict(TPWC.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        TPW.mean_pairwise_velocity(T(pos), T(vel), bins, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        TPW.mean_pairwise_velocity(T(pos), T(vel), bins, backend="pallas")
    with pytest.raises(ValueError, match="ascending"):
        TPW.mean_pairwise_velocity(T(pos), T(vel), [0.0, 2.0, 1.0])


# ------------------------------------------------------ K2 plain version
def _flat(pos):
    return np.concatenate([pos[:, 0], pos[:, 1], pos[:, 2]])


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_paint_windowed_reference_matches_pallas(rng, order, weighted):
    """The plain windowed painter vs the JAX Pallas painter in interpret
    mode (n = 2000, ng 8, window 1024): atol 3e-5 of the grid's max."""
    n, ng, box = 2000, 8, 50.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    want = np.asarray(j_windowed(jnp.asarray(_flat(pos)),
                                 None if w is None else jnp.asarray(w), ng,
                                 box, order=order, window=1024,
                                 interpret=True))
    got = TPC.paint_windowed_reference(T(_flat(pos)),
                                       None if w is None else T(w), ng, box,
                                       order=order)
    assert got.shape == (ng, ng, ng)
    npt.assert_allclose(got.numpy(), want, atol=3e-5 * want.max())
    npt.assert_allclose(float(got.double().sum()),
                        n if w is None else float(w.astype(np.float64).sum()),
                        rtol=1e-5)


@pytest.mark.parametrize("ng", [16, 13])
def test_paint_windowed_reference_periodic_wrap(rng, ng):
    """Port of tests/test_paint_power.py::test_pallas_painter_periodic_wrap:
    positions a box below and above, and on the edges (0, box, -0.0),
    deposit as the JAX scatter painters do (atol 3e-5 of the max), with no
    mass lost (rtol 1e-5)."""
    n, box = 4096, 50.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    pos[:n // 3] -= box
    pos[n // 3: 2 * n // 3] += box
    pos[0] = [0.0, box, -0.0]
    for order, ref_fn in ((2, JP.paint_cic), (3, JP.paint_tsc)):
        ref = np.asarray(ref_fn(jnp.asarray(pos), ng, box))
        got = TPC.paint_windowed(T(_flat(pos)), None, ng, box, order=order)
        npt.assert_allclose(got.numpy(), ref, atol=3e-5 * max(1.0, ref.max()))
        npt.assert_allclose(float(got.double().sum()), n, rtol=1e-5)


def test_paint_windowed_tsc_edge_clip():
    """A position whose x/h rounds to n takes centre n-1 with d = +0.5 from
    the CLIPPED index (paint_pallas.py:690-704): the same deposit as a
    particle at 0, i.e. half in cell n-1 and half in cell 0."""
    ng, box = 8, 50.0
    edge = np.float32(-1e-8)  # wraps to exactly box in float32
    assert np.float32(np.remainder(edge, np.float32(box))) == box
    pos = np.array([[edge, 25.0 + 3.125, 25.0 + 3.125]], np.float32)
    key, frac = TPC._windowed_keys(T(_flat(pos)), ng, box, 3)
    assert int(key[0]) // (ng + 2) ** 2 == ng  # padded centre n-1 + 1
    assert float(frac[0, 0]) == 0.5
    got = TPC.paint_windowed(T(_flat(pos)), None, ng, box, order=3)
    at0 = TPC.paint_windowed(T(_flat(np.array([[0.0, 28.125, 28.125]],
                                                  np.float32))), None, ng,
                             box, order=3)
    npt.assert_allclose(got.numpy(), at0.numpy(), atol=1e-7)
    npt.assert_allclose(got[[ng - 1, 0]].sum(dim=(1, 2)).numpy(),
                        [0.5, 0.5], atol=1e-7)
    want = np.asarray(JP.paint_tsc(jnp.asarray(pos), ng, box))
    npt.assert_allclose(got.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("ngrid", [1, 16, 37, 97, 512])
def test_k2_tile_grid_brute_force(ngrid):
    """K2's tiles per axis: as many as the distinct c // tile side over the
    base cells c of an axis."""
    got = TPC._tile_grid(ngrid)
    for ax, side in enumerate(TPC._TILE):
        assert got[ax] == len({c // side for c in range(ngrid)})


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("ng", [37, 64])
def test_k2_tile_ids_brute_force(rng, order, ng):
    """`_tile_ids` (the bin pass's tile of each particle, from the plain
    version's keys) against a loop over the particles, on positions on and
    next to tile borders, on the box edges and outside the box: tile ids
    and per-tile counts equal, and every cell a particle deposits into lies
    in its tile's halo block."""
    box = 50.0
    h = box / ng
    n = 3000
    pos = rng.uniform(-box, 2 * box, (n, 3)).astype(np.float32)
    borders = np.array([16, 32, 48, 0, ng], np.float64) * h
    pick = rng.integers(0, len(borders), (n // 2, 3))
    nudge = rng.choice([-1e-5, 0.0, 1e-5], (n // 2, 3))
    pos[: n // 2] = (borders[pick] + nudge).astype(np.float32)
    pos[-3:] = [[0.0, box, -0.0], [-1e-8, box - 1e-6, 1e-8], [box, box, box]]
    key, _ = TPC._windowed_keys(T(_flat(pos)), ng, box, order)
    got = TPC._tile_ids(key, ng, order).numpy()
    ntx, nty, ntz = TPC._tile_grid(ng)
    npd = ng + 2
    lo = 0 if order == 2 else -1
    want = []
    for i, k in enumerate(key.tolist()):
        ip = (k // (npd * npd), (k // npd) % npd, k % npd)
        base = [(c - 1) % ng for c in ip]
        tile = [b // s for b, s in zip(base, TPC._TILE)]
        want.append((tile[0] * nty + tile[1]) * ntz + tile[2])
        for ax in range(3):
            first = tile[ax] * TPC._TILE[ax] + lo
            for a in range(order):
                cell = base[ax] + lo + a
                assert first <= cell < first + TPC._TILE[ax] + order - 1
    npt.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=ntx * nty * ntz)
    for t in set(want):
        assert counts[t] == want.count(t)


def test_paint_windowed_rejects_bad_inputs(rng):
    pf = T(_flat(rng.uniform(0, 10, (10, 3)).astype(np.float32)))
    with pytest.raises(ValueError, match="order"):
        TPC.paint_windowed(pf, None, 4, 10.0, order=4)
    with pytest.raises(ValueError, match="flat"):
        TPC.paint_windowed(pf[:-1], None, 4, 10.0, order=2)
    with pytest.raises(ValueError, match="weights"):
        TPC.paint_windowed(pf, torch.ones(9), 4, 10.0, order=2)


def test_paint_dispatch_rules_on_cpu(rng):
    """deposit=None gives the scatter painters on the CPU (bit-equal, no
    kernel launch); deposit='kernel' on a CPU tensor raises."""
    pos = T(rng.uniform(0, 50.0, (3000, 3)).astype(np.float32))
    before = dict(TPC.LAUNCHES)
    for window, fn in (("cic", TP.paint_cic), ("tsc", TP.paint_tsc)):
        assert torch.equal(TP.paint(pos, 8, 50.0, window=window),
                           fn(pos, 8, 50.0))
        assert torch.equal(TP.paint(tuple(pos.unbind(-1)), 8, 50.0,
                                    window=window), fn(pos, 8, 50.0))
        with pytest.raises(ValueError, match="CUDA"):
            TP.paint(pos, 8, 50.0, window=window, deposit="kernel")
    assert dict(TPC.LAUNCHES) == before
