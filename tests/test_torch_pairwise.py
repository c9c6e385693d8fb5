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
    # beside JAX in one process, torch's first threaded float32 sqrt now
    # and then comes back 2^-12 low on the second thread's half of the
    # array; a first call below the threading grain settles it
    torch.sqrt(torch.ones(16))
    try:
        yield
    finally:
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


def test_pairwise_accumulate_reference_permutation_invariant(rng):
    """The sums over pairs do not depend on the order of the rows (the
    invariance that lets K3 reorder them): shuffled rows give the same
    nom and den to rtol 1e-5 (float32 sums in another order)."""
    n = 700
    pos, vel = _catalog(rng, n, -80.0, 80.0)
    perm = rng.permutation(n)
    a = TPWC.pairwise_accumulate_reference(T(pos), T(vel), n, 4.0, 25)
    b = TPWC.pairwise_accumulate_reference(T(pos[perm]), T(vel[perm]), n,
                                           4.0, 25)
    for x, y in zip(a, b):
        npt.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                            atol=1e-5 * float(y.abs().max()))


# ------------------------------------------ K3's cut, order and culling
_BINWIDTHS = [float(np.float32(50.0 / 24.0)), 2.0, 7.3, 1e-5, 1e30]


@pytest.mark.parametrize("nbins", [1, 25, 128])
@pytest.mark.parametrize("binwidth", _BINWIDTHS)
def test_s_max_matches_bruteforce(rng, binwidth, nbins):
    """`s < s_max` equals float32 `sqrt(s) / binwidth < nbins` (torch's
    CPU float32 ops, a tensor divisor) for every float within 2048 ulps of
    s_max and for 10^5 random floats in [0, 4 s_max]; where s_max is +inf
    (binwidth 1e30), +inf itself is dropped."""
    smax = TPWC.s_max(binwidth, nbins)
    bits = int(np.array([smax], np.float32).view(np.uint32)[0])
    near = np.arange(max(bits - 2048, 0), min(bits + 2049, 0x7F800001),
                     dtype=np.int64).astype(np.uint32).view(np.float32)
    samples = [near]
    if np.isfinite(smax):
        samples.append((rng.uniform(0.0, 4.0, 100000) * np.float64(smax))
                       .astype(np.float32))
    else:
        assert binwidth == 1e30
        samples.append(np.array([np.inf], np.float32))
    s = np.concatenate(samples)
    bw = torch.tensor(binwidth, dtype=torch.float32)
    ts = torch.from_numpy(s)
    want = (torch.sqrt(ts) / bw) < nbins
    got = ts < torch.tensor(float(smax), dtype=torch.float32)
    assert torch.equal(got, want)
    assert not bool(got[ts == np.inf].any())
    assert bool(got[ts == 0.0].all())


def _clumpy(rng, n, n_valid):
    """Clumps (a Gaussian one at the origin, one straddling x = 0 and
    y = 0, a tight one, two a little more than 10 apart) over a uniform
    background in [-60, 60)^3, then junk rows past n_valid (far away, huge
    velocities, a NaN)."""
    pos = rng.uniform(-60.0, 60.0, (n, 3))
    k = n_valid // 6
    pos[:k] = rng.normal(0.0, 3.0, (k, 3))
    pos[k:2 * k] = rng.normal([0.0, 0.0, 30.0], [20.0, 20.0, 1.0], (k, 3))
    pos[2 * k:3 * k] = rng.normal([-40.0, 25.0, -10.0], 0.05, (k, 3))
    pos[3 * k:4 * k] = rng.uniform([30.0, 30.0, 30.0], [31.0, 31.0, 31.0],
                                   (k, 3))
    pos[4 * k:5 * k] = rng.uniform([30.0, 30.0, 42.0], [31.0, 31.0, 43.0],
                                   (k, 3))
    vel = rng.normal(0.0, 200.0, (n, 3))
    pos[n_valid:] = 1e6
    vel[n_valid:] = 1e7
    if n > n_valid:
        pos[-1, 0] = np.nan
    return pos.astype(np.float32), vel.astype(np.float32)


def _f32_s(a, b):
    """Squared separations of rows a (m, 3) and b (k, 3), every step a
    float32 op rounded to nearest, in the kernel's order."""
    r = a[:, None, :] - b[None, :, :]
    return (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]) \
        + r[..., 2] * r[..., 2]


@pytest.mark.parametrize("case", [(2600, 2600, 0.45, 25),
                                  (2600, 2600, 0.43, 25),
                                  (2600, 2311, 0.45, 25),
                                  (3000, 2900, 1e-5, 25),
                                  (1800, 1700, 0.1, 128)])
def test_k3_culling_is_sound(rng, case):
    """On clumpy catalogs (negative coordinates, clumps across x = 0 and
    y = 0, two clumps just beyond reach of each other, junk rows past
    n_valid): the ordering keeps the multiset of the first n_valid rows and
    leaves the rest out; the list holds exactly the tile pairs whose box
    gap is below s_max (the diagonal ones always, unless a tile is empty),
    and no pair in a culled tile pair, nor in a chunk pair that the kernel
    skips inside a listed one, has s < s_max (brute force in float32)."""
    n, n_valid, binw, nbins = case
    pos, vel = _clumpy(rng, n, n_valid)
    p = TPWC.plan(T(pos), T(vel), n_valid, binw, nbins)
    tile = TPWC.TILE
    n_tiles = -(-n_valid // tile)
    assert p.pos4.shape == (n_tiles * tile, 4)
    got = np.hstack([p.pos4[:n_valid, :3].numpy(),
                     p.vel4[:n_valid, :3].numpy()])
    npt.assert_array_equal(_lexsorted(got), _lexsorted(
        np.hstack([pos[:n_valid], vel[:n_valid]])))
    assert np.isnan(p.pos4[n_valid:, :3].numpy()).all()
    items = TPWC.tile_pairs(p.lo, p.hi, p.s_max)
    visited = {tuple(x) for x in items.tolist()}
    assert [tuple(x) for x in items.tolist()] == sorted(visited)
    assert all((t, t) in visited for t in range(n_tiles))
    smax = np.float32(p.s_max)
    tiles = p.pos4[:, :3].numpy().reshape(n_tiles, tile, 3)
    culled = 0
    for a in range(n_tiles):
        for b in range(a, n_tiles):
            if (a, b) in visited:
                continue
            culled += 1
            with np.errstate(invalid="ignore"):
                s = _f32_s(tiles[a], tiles[b])
            assert s.dtype == np.float32
            assert not bool((s < smax).any()), (a, b)
    assert culled > 0
    chunk, k = TPWC.CHUNK, TPWC.TILE // TPWC.CHUNK
    walked = TPWC.chunk_pairs(p, items).numpy()
    skipped = 0
    for (a, b), w in zip(items.tolist(), walked):
        for ca in range(k):
            for cb in range(ca if a == b else 0, k):
                if w[ca, cb]:
                    continue
                skipped += 1
                with np.errstate(invalid="ignore"):
                    s = _f32_s(tiles[a, ca * chunk:(ca + 1) * chunk],
                               tiles[b, cb * chunk:(cb + 1) * chunk])
                assert not bool((s < smax).any()), (a, b, ca, cb)
    assert skipped > 0


def _lexsorted(a):
    return a[np.lexsort(a.T[::-1])]


def _smoke():
    """chip_smoke.py's catalog builders (the repository root's script)."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_k3_every_pair_beyond_reach_visits_the_diagonal_only(rng):
    """Every pair beyond the last bin (binwidth 1e-5 on a unit lattice):
    only the diagonal tile pairs (box gap 0) are listed, and the emulated
    sums are zeros."""
    pos = _smoke().k3_lattice()[rng.permutation(16 ** 3 + 1)]
    vel = rng.normal(0.0, 100.0, pos.shape).astype(np.float32)
    p = TPWC.plan(T(pos), T(vel), pos.shape[0], 1e-5, 25)
    n_tiles = p.lo.shape[0]
    assert TPWC.tile_pairs(p.lo, p.hi, p.s_max).tolist() == [
        [t, t] for t in range(n_tiles)]
    nom, den = _plan_sums(p, 1e-5, 25)
    assert float(nom.abs().sum()) == 0.0 == float(den.abs().sum())


def _plan_sums(p, binwidth, nbins):
    """The kernel's arithmetic on the listed tile pairs only, and in them
    on the chunk pairs it walks (float32 torch ops on the CPU), summed in
    float64."""
    tile = TPWC.TILE
    nom = torch.zeros(nbins, dtype=torch.float64)
    den = torch.zeros(nbins, dtype=torch.float64)
    bw = torch.tensor(binwidth, dtype=torch.float32)
    items = TPWC.tile_pairs(p.lo, p.hi, p.s_max)
    walked = TPWC.chunk_pairs(p, items).repeat_interleave(TPWC.CHUNK, dim=1) \
        .repeat_interleave(TPWC.CHUNK, dim=2)
    for (a, b), w in zip(items.tolist(), walked):
        sa, sb = slice(a * tile, (a + 1) * tile), slice(b * tile,
                                                       (b + 1) * tile)
        pi, pj = p.pos4[sa, :3], p.pos4[sb, :3]
        r = pi[:, None, :] - pj[None, :, :]
        s = (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]) \
            + r[..., 2] * r[..., 2]
        keep = (s < p.s_max) & w
        if a == b:
            keep &= torch.ones_like(keep).triu(1)
        dist = torch.sqrt(s)
        t = dist / bw
        assert bool((t[keep] < nbins).all())
        u = r / dist.clamp_min(1e-12)[..., None]
        hi, hj = p.hat4[sa, None, :3], p.hat4[None, sb, :3]
        di = (u * hi).sum(-1, keepdim=True)
        dj = (u * hj).sum(-1, keepdim=True)
        q = 0.5 * (2.0 * u - hi * di - hj * dj)
        v = p.vel4[sa, None, :3] - p.vel4[None, sb, :3]
        b_of = t[keep].to(torch.int64)
        nom.index_add_(0, b_of, (v * q).sum(-1)[keep].double())
        den.index_add_(0, b_of, (q * q).sum(-1)[keep].double())
    return nom.float(), den.float()


@pytest.mark.parametrize("case", [(2600, 2311, 0.45, 25),
                                  (1500, 1500, 4.0, 25),
                                  (900, 850, 0.02, 128)])
def test_k3_plan_sums_match_all_pairs(rng, case):
    """The kernel's work, emulated on the CPU over the plan (reordered
    rows, listed tile pairs, walked chunk pairs, the s < s_max cut, j > i
    on the diagonal),
    gives the plain all-pairs version's sums: rtol 1e-4 with atol 1e-4 of
    each output's max (float32 terms summed in other orders)."""
    n, n_valid, binw, nbins = case
    pos, vel = _clumpy(rng, n, n_valid)
    p = TPWC.plan(T(pos), T(vel), n_valid, binw, nbins)
    got = _plan_sums(p, binw, nbins)
    want = TPWC.pairwise_accumulate_reference(T(pos), T(vel), n_valid, binw,
                                              nbins)
    assert float(want[1].sum()) > 0.0
    for g, w in zip(got, want):
        npt.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                            atol=1e-4 * float(w.abs().max()))


def test_k3_order_and_boxes_leave_out_non_finite_rows(rng):
    """Rows with a NaN or infinite coordinate go last in the Morton order
    (which stays a permutation of the first n_valid rows and is the same
    on a second call) and stay out of their group's box; a group of such
    rows only gets the empty box (lo = +inf, hi = -inf)."""
    pos = rng.uniform(-5.0, 5.0, (64, 3)).astype(np.float32)
    pos[[3, 17, 40], [0, 2, 1]] = [np.nan, np.inf, -np.inf]
    order = TPWC.spatial_order(T(pos), 60)
    assert sorted(order.tolist()) == list(range(60))
    assert set(order[-3:].tolist()) == {3, 17, 40}
    assert torch.equal(order, TPWC.spatial_order(T(pos), 60))
    pos4 = np.zeros((64, 4), np.float32)
    pos4[:, :3] = pos
    pos4[32:, :3] = np.nan
    lo, hi = TPWC.boxes(T(pos4), 32)
    good = np.delete(pos[:32], [3, 17], axis=0)
    npt.assert_array_equal(lo[0, :3].numpy(), good.min(axis=0))
    npt.assert_array_equal(hi[0, :3].numpy(), good.max(axis=0))
    assert float(lo[0, 3]) == 0.0 == float(hi[0, 3])
    assert bool((lo[1, :3] == np.inf).all()) and bool((hi[1, :3] == -np.inf)
                                                      .all())


@pytest.mark.parametrize("n_tiles", [1, 2, 7, 64, 4096, 65536])
def test_k3_triangle_walk(n_tiles):
    """The kernel's in-place walk of the tile pairs: item k of the triangle
    decodes (`triangle_item`, its plain version) to (ti, tj) in row-major
    order, ti <= tj, every pair once: all items for a small triangle; for a
    large one (2^24 tracers are 65,536 tiles) the first, last and
    neighbouring items of every row, where a float64 estimate of the row
    could miss."""
    total = n_tiles * (n_tiles + 1) // 2
    if total <= 1 << 12:
        k = np.arange(total, dtype=np.int64)
        ti, tj = TPWC.triangle_item(k, n_tiles)
        want = [(a, b) for a in range(n_tiles) for b in range(a, n_tiles)]
        assert list(zip(ti.tolist(), tj.tolist())) == want
        return
    t = np.arange(n_tiles, dtype=np.int64)
    start = t * n_tiles - t * (t - 1) // 2
    end = start + (n_tiles - t) - 1
    k = np.concatenate([start, end, np.minimum(start + 1, end),
                        np.maximum(end - 1, start)])
    ti, tj = TPWC.triangle_item(k, n_tiles)
    npt.assert_array_equal(ti, np.tile(t, 4))
    npt.assert_array_equal(tj, np.concatenate([
        t, np.full(n_tiles, n_tiles - 1), np.minimum(t + 1, n_tiles - 1),
        np.maximum(n_tiles - 2, t)]))
    assert int(end[-1]) == total - 1


def test_k3_plan_stats_and_rejects(rng):
    """`plan_stats` counts the pairs the visited tile pairs hold and the
    pairs the kernel walks in them (all of them when nothing is culled); a
    non-positive or non-finite binwidth raises."""
    pos, vel = _catalog(rng, 600, 0.0, 10.0)
    p = TPWC.plan(T(pos), T(vel), 600, 5.0, 25)
    st = TPWC.plan_stats(p, 25)
    assert st["tiles"] == 3 and st["tile_pairs_visited"] == 6
    assert st["pairs_visited"] == st["pairs_walked"] == 600 * 599 // 2
    assert st["scratch_bytes"] == 2 * (3 + 3 * 8) * 4 * 4
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="binwidth"):
            TPWC.s_max(bad, 25)


# ------------------------------------------------ mean_pairwise_velocity
def test_mean_pairwise_velocity_numpy_input_placement(rng):
    """numpy input goes to the CUDA card unless `device` is given, and
    raises without a card (this machine has none); with device='cpu' it
    matches the JAX package (rtol 1e-4, ratios of float32 sums)."""
    pos, vel = _catalog(rng, 300, 450.0, 550.0)
    bins = np.linspace(0, 50, 25)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TPW.mean_pairwise_velocity(pos, vel, bins)
    before = dict(TPWC.LAUNCHES)
    r, v = TPW.mean_pairwise_velocity(pos, vel, bins, device="cpu")
    assert r.device.type == "cpu" and v.device.type == "cpu"
    assert dict(TPWC.LAUNCHES) == before
    jr, jv = JPW.mean_pairwise_velocity(jnp.asarray(pos), jnp.asarray(vel),
                                        jnp.asarray(bins))
    npt.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    npt.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-3)


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
    with pytest.raises(ValueError, match="backend must be"):
        TPW.mean_pairwise_velocity(T(pos), T(vel), bins, backend="mosaic")
    with pytest.raises(ValueError, match="ascending"):
        TPW.mean_pairwise_velocity(T(pos), T(vel), [0.0, 2.0, 1.0])


@pytest.mark.parametrize("jax_name,port_name", [("pallas", "kernel"),
                                                ("xla", "plain")])
def test_pairwise_accepts_jax_backend_spellings(rng, jax_name, port_name):
    """`mean_pairwise_velocity(backend=)` takes the JAX package's
    spellings as aliases: 'xla' gives the plain tiles' result bit for bit,
    'pallas' on a CPU tensor raises what 'kernel' raises (on uniform and
    on uneven bins), and the interpret spelling says that the port has no
    such mode."""
    pos, vel = _catalog(rng, 50)
    bins = np.linspace(0, 50, 11)
    uneven = np.array([0.0, 5.0, 12.0, 30.0])
    if port_name == "plain":
        for b in (bins, uneven):
            _, want = TPW.mean_pairwise_velocity(T(pos), T(vel), b,
                                                 backend=port_name)
            _, got = TPW.mean_pairwise_velocity(T(pos), T(vel), b,
                                                backend=jax_name)
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got[~got.isnan()], want[~want.isnan()])
    else:
        for b in (bins, uneven):
            errors = []
            for name in (jax_name, port_name):
                with pytest.raises(ValueError, match="CUDA") as err:
                    TPW.mean_pairwise_velocity(T(pos), T(vel), b,
                                               backend=name)
                errors.append(str(err.value))
            assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="no interpret mode"):
        TPW.mean_pairwise_velocity(T(pos), T(vel), bins,
                                   backend=f"{jax_name}_interpret")


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
