"""The port's CUDA kernels and their callers on the card (marker `cuda`).

These tests need a CUDA card and skip without one. They import no JAX, so
they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu_torch import suite  # noqa: E402
from astrild_tpu_torch.ops import lens_planes as TLP  # noqa: E402
from astrild_tpu_torch.ops import lightcone_sphere as TLS  # noqa: E402
from astrild_tpu_torch.ops import paint as TP  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda as TPC  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops import pairwise as TPW  # noqa: E402
from astrild_tpu_torch.ops import pairwise_cuda as TPWC  # noqa: E402
from astrild_tpu_torch.ops import power as TPS  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

pytestmark = pytest.mark.cuda

BOX = 100.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _sorted_case(keys, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    keys_sorted, order = torch.sort(keys.to(dev), stable=False)
    vals = torch.rand(keys.shape[0], generator=gen, device=dev) + 0.5
    return keys_sorted, vals[order].contiguous()


def _k1_case(case, rng):
    """(keys, n_cells) of one K1 case, in no order."""
    n_cells = {"dense": 1 << 20, "sparse": 1 << 22, "empty": 999,
               "one_cell": 1 << 16, "ragged": 1 << 18,
               "last_window": 5 * 8192 + 77, "clustered_29": 1 << 20,
               "junk_cell": 4 * 2048 * 2048 + 1,
               "ragged_last_window": 5 * 8192 + 77,
               "2^24_in_one_cell": 999}[case]
    keys = {
        "dense": lambda: rng.integers(0, n_cells, 1 << 20),
        "sparse": lambda: rng.integers(0, n_cells, 1000),
        "empty": lambda: np.zeros(0),
        "one_cell": lambda: np.full(100000, 12345),
        "ragged": lambda: rng.integers(0, n_cells, (1 << 18) + 12345),
        "last_window": lambda: np.repeat(np.arange(n_cells - 300, n_cells),
                                         5),
        # the lens planes: ~29 keys a cell over whole windows, heavy
        # enough that the card splits each window over several blocks
        "clustered_29": lambda: rng.permutation(
            np.repeat(np.arange(3 * 8192, 12 * 8192), 29)),
        # and their junk cell n_cells - 1 (the corners outside the map)
        "junk_cell": lambda: rng.permutation(np.concatenate([
            rng.integers(0, n_cells - 1, 1 << 20),
            np.full(100000, n_cells - 1)])),
        "ragged_last_window": lambda: rng.permutation(np.concatenate([
            rng.integers(0, n_cells, 5000),
            np.repeat(np.arange(5 * 8192, n_cells), 29 * 100)])),
        "2^24_in_one_cell": lambda: np.full(1 << 24, 500),
    }[case]()
    return keys, n_cells


@pytest.mark.parametrize("case", ["dense", "sparse", "empty", "one_cell",
                                  "ragged", "last_window", "clustered_29",
                                  "junk_cell", "ragged_last_window",
                                  "2^24_in_one_cell"])
def test_k1_matches_plain(cuda, case):
    """Both entry points against the plain version: `deposit_sorted` on
    the sorted keys and `deposit_flat` on the keys as they come. Counts
    equal; weighted sums within 2e-5 * max (the JAX kernel's bar), except
    for 2^24 keys in one cell, where counts are held (exact up to 2^24)
    and float32 sums of 2^24 weights round by ~2^12 in both versions,
    above the bar (as K4's test notes); one launch per call."""
    rng = np.random.default_rng(3)
    keys, n_cells = _k1_case(case, rng)
    flat = torch.from_numpy(np.asarray(keys, np.int32)).to(cuda)
    keys_sorted, vals = _sorted_case(flat, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    w = torch.rand(flat.shape[0], generator=gen, device=cuda) + 0.5
    for entry, k, v in (("sorted", keys_sorted, vals), ("flat", flat, w)):
        deposit = TPC.deposit_sorted if entry == "sorted" else TPC.deposit_flat
        before = TPC.LAUNCHES["deposit_sorted"]
        got = deposit(k, None, n_cells)
        assert TPC.LAUNCHES["deposit_sorted"] == before + 1, entry
        assert torch.equal(got, TPC.deposit_sorted_reference(k, None,
                                                             n_cells)), entry
        if case == "2^24_in_one_cell":
            assert float(got[500]) == float(1 << 24)
            continue
        gotw = deposit(k, v, n_cells)
        want = TPC.deposit_sorted_reference(k, v, n_cells)
        scale = float(want.abs().max()) if n_cells else 0.0
        assert float((gotw - want).abs().max()) <= 2e-5 * scale, entry


def _file_order(keys, rng):
    """Keys in a spatially coherent order, as a snapshot in the PM code's
    order gives them: ascending runs of 4096 keys, the runs shuffled."""
    keys = np.sort(keys)
    runs = [keys[i:i + 4096] for i in range(0, keys.shape[0], 4096)]
    return np.concatenate([runs[i] for i in rng.permutation(len(runs))])


@pytest.mark.parametrize("order", ["random", "file"])
@pytest.mark.parametrize("n_cells", [999, 1 << 20, (1 << 30) + 5])
def test_k1_flat_matches_index_add(cuda, order, n_cells):
    """`deposit_flat` on keys as they come (uniform random order, or
    coherent file order) with keys outside [0, n_cells) mixed in, against
    `index_add_` of the keys inside: counts equal (the dropped keys leave
    no trace), weighted sums within 2e-5 * max, one launch counted."""
    rng = np.random.default_rng(9)
    n = 1 << 21
    keys = rng.integers(0, n_cells, n)
    if order == "file":
        keys = _file_order(keys, rng)
    junk = np.array([-1, -7, -(1 << 31), n_cells, n_cells + 7,
                     (1 << 31) - 1], np.int64)
    at = rng.integers(0, n, junk.shape[0])
    keys = np.insert(keys, at, junk).astype(np.int32)
    flat = torch.from_numpy(keys).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, keys.shape[0]).astype(
        np.float32)).to(cuda)
    inside = (flat >= 0) & (flat < n_cells)
    ones = torch.ones(keys.shape[0], device=cuda)
    before = TPC.LAUNCHES["deposit_sorted"]
    got = TPC.deposit_flat(flat, None, n_cells)
    assert TPC.LAUNCHES["deposit_sorted"] == before + 1
    want = torch.zeros(n_cells, device=cuda).index_add_(
        0, flat[inside].long(), ones[inside])
    assert torch.equal(got, want)
    del got, want
    gotw = TPC.deposit_flat(flat, w, n_cells)
    assert TPC.LAUNCHES["deposit_sorted"] == before + 2
    wantw = torch.zeros(n_cells, device=cuda).index_add_(
        0, flat[inside].long(), w[inside])
    torch.cuda.synchronize()
    assert float((gotw - wantw).abs().max()) <= 2e-5 * float(wantw.max())


def test_k1_flat_runs_no_radix_sort(cuda):
    """Under `torch.profiler`, a `deposit_flat` call runs K1's own passes
    and no kernel whose name holds `RadixSort` (the device-wide sort it
    replaces)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(4)
    keys = torch.randint(0, 1 << 24, (1 << 22,), generator=gen,
                         device=cuda, dtype=torch.int32)
    w = torch.rand(keys.shape[0], generator=gen, device=cuda)
    TPC.deposit_flat(keys, w, 1 << 24)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TPC.deposit_flat(keys, None, 1 << 24)
        TPC.deposit_flat(keys, w, 1 << 24)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.self_device_time_total > 0]
    assert not [k for k in names if "RadixSort" in k], names
    assert any("deposit_accumulate" in k for k in names), names
    assert any("deposit_partition" in k for k in names), names


def test_k1_rejects_bad_inputs(cuda):
    keys = torch.arange(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        TPC.deposit_sorted(keys.long(), None, 64)
    with pytest.raises(ValueError, match="contiguous"):
        TPC.deposit_sorted(keys[::2], None, 64)
    with pytest.raises(ValueError, match="float32"):
        TPC.deposit_sorted(keys, keys.double(), 64)
    with pytest.raises(ValueError, match="vals on"):
        TPC.deposit_sorted(keys, keys.float().cpu(), 64)
    with pytest.raises(ValueError, match="float32 of shape"):
        TPC.deposit_flat(keys, keys.float()[:10], 64)
    with pytest.raises(ValueError, match="2\\^31"):
        TPC.deposit_flat(keys, None, 1 << 31)


def test_auto_power_fast_kernel_matches_scatter(cuda):
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.uniform(0, BOX, (1 << 18, 3)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 1 << 18).astype(
        np.float32)).to(cuda)
    TPS.last_auto_deposit = None
    a = TPS.auto_power_fast(pos, 32, BOX, nbins=12)
    assert TPS.last_auto_deposit == "kernel"
    b = TPS.auto_power_fast(pos, 32, BOX, nbins=12, deposit="scatter")
    torch.testing.assert_close(a.power, b.power, rtol=1e-5, atol=0)
    aw = TPS.auto_power_fast(pos, 32, BOX, nbins=12, weights=w,
                             deposit="kernel")
    bw = TPS.auto_power_fast(pos, 32, BOX, nbins=12, weights=w,
                             deposit="scatter")
    torch.testing.assert_close(aw.power, bw.power, rtol=1e-4, atol=0)


# ------------------------------------------------------------------ K4
def _k4_case(case, rng):
    """(keys, n_cells, n_seg) of one K4 edge case."""
    n_cells = 1 << 18
    # fine NGP keys (fine factor 2, subgrid-major) of a 64^3 lattice in
    # lattice order: the coherent key order of a snapshot in PM order
    side = 64
    ux, uy, uz = np.unravel_index(np.arange(side ** 3), (side,) * 3)
    sid = ((ux % 2) * 2 + uy % 2) * 2 + uz % 2
    lattice = ((sid * 32 + ux // 2) * 32 + uy // 2) * 32 + uz // 2
    return {
        "random": (rng.integers(0, n_cells, 1 << 18), n_cells, 64),
        "file_order": (lattice, side ** 3, 64),
        "shuffled": (rng.permutation(lattice), side ** 3, 64),
        "sorted": (np.sort(rng.integers(0, n_cells, 1 << 18)), n_cells, 64),
        "n_below_n_seg": (rng.integers(0, 5000, 40), 5000, 64),
        "n_not_multiple": (rng.integers(0, n_cells, 100003), n_cells, 64),
        "one_segment": (rng.integers(0, n_cells, 50000), n_cells, 1),
        "one_cell": (np.full(100000, 12345), 1 << 16, 64),
        "empty_windows": (rng.integers(0, 1 << 22, 1000), 1 << 22, 64),
        "ragged_last_window": (rng.integers(0, 5 * 8192 + 77, 60000),
                               5 * 8192 + 77, 16),
        "many_segments": (rng.integers(0, n_cells, 1 << 18), n_cells, 1500),
        "no_keys": (np.zeros(0), 1000, 64),
        # the chunk-sorted design: n one past a whole number of 4096-key
        # chunks; the largest key 2^16 - 1, whose sorted bits equal the
        # padding's, spread over a ragged last chunk; one run of equal keys
        # crossing many chunks; keys that fill no whole chunk
        "chunk_edges": (rng.integers(0, n_cells, 3 * 4096 + 1), n_cells, 64),
        "max_key_and_padding": (
            np.concatenate([np.full(5000, (1 << 16) - 1),
                            rng.integers(0, 1 << 16, 3001)]), 1 << 16, 64),
        "run_across_chunks": (
            np.concatenate([rng.integers(0, n_cells, 3000),
                            np.full(5 * 4096, 777),
                            rng.integers(0, n_cells, 3000)]), n_cells, 64),
        "short_chunk": (rng.integers(0, 100, 17), 100, 64),
    }[case]


@pytest.mark.parametrize("case", ["random", "file_order", "shuffled",
                                  "sorted", "n_below_n_seg",
                                  "n_not_multiple", "one_segment",
                                  "one_cell", "empty_windows",
                                  "ragged_last_window", "many_segments",
                                  "no_keys", "chunk_edges",
                                  "max_key_and_padding", "run_across_chunks",
                                  "short_chunk"])
def test_k4_matches_plain(cuda, case):
    """K4 vs its plain version on the same keys: counts equal, weighted
    sums within 2e-5 * max (float sums in another order); one launch per
    call."""
    rng = np.random.default_rng(7)
    keys, n_cells, n_seg = _k4_case(case, rng)
    flat = torch.from_numpy(np.asarray(keys, np.int32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, flat.shape[0]).astype(
        np.float32)).to(cuda)
    before = TPC.LAUNCHES["deposit_segmented"]
    got = TPC.deposit_flat_segmented(flat, None, n_cells, n_seg=n_seg)
    assert TPC.LAUNCHES["deposit_segmented"] == before + 1
    want = TPC.deposit_flat_segmented_reference(flat, None, n_cells,
                                                n_seg=n_seg)
    assert torch.equal(got, want)
    assert float(got.double().sum()) == flat.shape[0]
    gotw = TPC.deposit_flat_segmented(flat, w, n_cells, n_seg=n_seg)
    wantw = TPC.deposit_flat_segmented_reference(flat, w, n_cells,
                                                 n_seg=n_seg)
    torch.cuda.synchronize()
    scale = float(wantw.abs().max()) if n_cells else 0.0
    assert float((gotw - wantw).abs().max()) <= 2e-5 * scale
    # the same sum as K1 and its full sort
    assert torch.equal(got, TPC.deposit_flat(flat, None, n_cells))


def test_k4_rejects_bad_inputs(cuda):
    keys = torch.arange(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="n_seg"):
        TPC.deposit_flat_segmented(keys, None, 64, n_seg=0)
    with pytest.raises(ValueError, match="weights"):
        TPC.deposit_flat_segmented(keys, keys.float()[:10], 64)
    with pytest.raises(ValueError, match="2\\^31"):
        TPC.deposit_flat_segmented(keys, None, 1 << 31)


def test_auto_power_fast_kernel_seg_matches_kernel(cuda):
    """deposit='kernel_seg' (K4) gives the P(k) of 'kernel' (K1): the
    fine counts are equal, so the spectra agree to float32 rounding."""
    rng = np.random.default_rng(11)
    side = 64
    q = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                  -1).reshape(-1, 3) + 0.5) * (BOX / side)
    pos = np.mod(q + rng.normal(0, 0.4, q.shape), BOX).astype(np.float32)
    for order in (np.arange(side ** 3), rng.permutation(side ** 3)):
        xyz = tuple(torch.from_numpy(np.ascontiguousarray(pos[order, i]))
                    .to(cuda) for i in range(3))
        before = dict(TPC.LAUNCHES)
        a = TPS.auto_power_fast(xyz, 32, BOX, nbins=12, deposit="kernel_seg")
        assert TPC.LAUNCHES["deposit_segmented"] == \
            before.get("deposit_segmented", 0) + 1
        assert TPC.LAUNCHES["deposit_sorted"] == \
            before.get("deposit_sorted", 0)
        b = TPS.auto_power_fast(xyz, 32, BOX, nbins=12, deposit="kernel")
        torch.testing.assert_close(a.power, b.power, rtol=1e-5, atol=0)


def test_file_lane_small_on_card(cuda, tmp_path):
    """The file lane at 64^3: an 8-file Gadget snapshot in lattice order,
    read back, P(k) through K4 equal to K1's and the facade's (rtol 1e-5),
    the density fields through K2 (4 launches) equal to the CPU's scatter
    paints within K2's bar (atol 2e-5 of each field's largest value) with
    the mass kept."""
    from astrild_tpu_torch.io.gadget_binary import (read_gadget_multi,
                                                    write_gadget)
    from astrild_tpu_torch.models import Ecosmog, PowerSpectrum3D

    rng = np.random.default_rng(12)
    side = 64
    q = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                  -1).reshape(-1, 3) + 0.5) * (BOX / side)
    disp = rng.normal(0, 0.5, q.shape)
    pos = np.mod(q + disp, BOX).astype(np.float32)
    vel = (100.0 * disp).astype(np.float32)
    ids = np.arange(side ** 3, dtype=np.uint32)
    bounds = np.linspace(0, side ** 3, 9).astype(int)
    for f in range(8):
        sl = slice(bounds[f], bounds[f + 1])
        write_gadget(tmp_path / f"snap_000.{f}", pos[sl], vel[sl], ids[sl],
                     BOX)
    _, data = read_gadget_multi(str(tmp_path / "snap_000"))
    assert np.array_equal(data["pos"].view(np.uint32), pos.view(np.uint32))
    xyz = tuple(torch.from_numpy(np.ascontiguousarray(data["pos"][:, i]))
                .to(cuda) for i in range(3))
    seg = TPS.auto_power_fast(xyz, 32, BOX, nbins=12, deposit="kernel_seg")
    ref = TPS.auto_power_fast(xyz, 32, BOX, nbins=12, deposit="kernel")
    torch.testing.assert_close(seg.power, ref.power, rtol=1e-5, atol=0)
    _, facade = PowerSpectrum3D().power_from_points(
        torch.stack(xyz, dim=1), BOX, 32, nbins=12, method="fast")
    np.testing.assert_allclose(facade, ref.power.cpu().numpy(), rtol=1e-5)
    fields = ("density", "velocity", "divergence")
    vel_dev = tuple(torch.from_numpy(np.ascontiguousarray(
        data["vel"][:, i])).to(cuda) for i in range(3))
    sim = Ecosmog(dir_sim=str(tmp_path), boxsize=BOX, domain_level=32)
    before = TPC.LAUNCHES["paint_windowed"]
    got = sim.density_fields(xyz, vel_dev, window="tsc", fields=fields)
    assert TPC.LAUNCHES["paint_windowed"] == before + 4
    want = sim.density_fields(data["pos"], data["vel"], window="tsc",
                              fields=fields, device="cpu")
    for name in fields:
        g, w = got[name].cpu(), want[name]
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=2e-5 * float(w.abs().max()))
    mass = float(got["density"].double().sum()) * (BOX / 32) ** 3
    assert abs(mass - side ** 3) <= 1e-5 * side ** 3


def test_paint_ngp_kernel_matches_scatter(cuda):
    rng = np.random.default_rng(9)
    pos = torch.from_numpy(rng.uniform(-10, BOX + 10, (50000, 3)).astype(
        np.float32)).to(cuda)
    for ng in (8, 10, 33):  # cell counts that fill no whole window
        a = TP.paint(pos, ng, BOX, window="ngp", deposit="scatter")
        b = TP.paint(pos, ng, BOX, window="ngp", deposit="kernel")
        assert torch.equal(a, b)


def test_small_suite_on_card_matches_cpu(cuda):
    """The suite on the card (kernel deposit) vs on the CPU (scatter)."""
    pos = suite.uniform_positions(32, 500.0, "cpu", seed=1)
    cpu = suite.make_stages(32, 64, 256, 500.0, 64, "cpu")(pos)
    gpu = suite.make_stages(32, 64, 256, 500.0, 64, cuda)(pos.to(cuda))
    assert TPS.last_auto_deposit == "kernel"
    pk_c, pk_g = cpu[0], gpu[0].cpu()
    shot = 500.0 ** 3 / 32 ** 3
    # P(k) of uniform particles sits near zero after shot-noise
    # subtraction: compare at rtol 1e-5 of the shot level
    torch.testing.assert_close(pk_g, pk_c, rtol=0, atol=1e-5 * shot)
    kappa_c, kappa_g = cpu[2], gpu[2].cpu()
    torch.testing.assert_close(kappa_g, kappa_c, rtol=1e-4,
                               atol=1e-5 * float(kappa_c.abs().max()))
    assert bool(torch.isfinite(gpu[5]).all())


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["uniform", "odd_grid", "edges",
                                  "one_cell", "tile_borders", "one_tile",
                                  "empty_tiles", "odd_97"])
def test_k2_matches_plain(cuda, order, weighted, case):
    """K2 vs its plain version on the same inputs: max |kernel - plain| <=
    2e-5 * max(plain) (float sums in another order), mass to rtol 1e-5.
    The last four cases aim at the 16 x 16 x 32-cell tiles: positions on
    and an ulp beside tile borders, every particle in one tile, particles
    in a slab that leaves most tiles empty, and a grid (97) that no tile
    side divides."""
    rng = np.random.default_rng(4)
    n, ng, box = {"uniform": ((1 << 18) + 333, 64, BOX),
                  "odd_grid": (100003, 37, BOX),
                  "edges": (30000, 16, BOX),
                  "one_cell": (50000, 16, BOX),
                  "tile_borders": (60000, 64, BOX),
                  "one_tile": (40000, 64, BOX),
                  "empty_tiles": (50000, 64, BOX),
                  "odd_97": (200003, 97, BOX)}[case]
    pos = rng.uniform(0, box, (n, 3))
    if case == "edges":
        pos[: n // 3] -= box
        pos[n // 3: 2 * n // 3] += box
        pos[:3] = [[0.0, box, -0.0], [box, 0.0, box], [-1e-8, box, 0.0]]
    if case == "one_cell":
        pos = 3.0 * box / ng + rng.uniform(0, box / ng, (n, 3))
    if case == "tile_borders":
        # CIC's base cell changes at (k + 0.5) h, TSC's at k h
        h = box / ng
        edges = np.concatenate([np.arange(0, ng + 1, 16) * h,
                                (np.arange(0, ng + 1, 16) + 0.5) * h])
        on = edges[rng.integers(0, len(edges), (n, 3))].astype(np.float32)
        step = rng.integers(-1, 2, (n, 3))
        pos = np.nextafter(on, np.where(step < 0, -np.inf, np.inf)
                           ).astype(np.float32)
        pos[step == 0] = on[step == 0]
    if case == "one_tile":
        h = box / ng
        pos = (np.array([16, 32, 0]) + 1.5) * h + rng.uniform(
            0, 13 * h, (n, 3)) * np.array([1.0, 1.0, 2.0])
    if case == "empty_tiles":
        pos[:, 0] = rng.uniform(0.3 * box, 0.35 * box, n)
    pf = torch.from_numpy(np.concatenate(pos.T).astype(np.float32)).to(cuda)
    w = (torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
         .to(cuda) if weighted else None)
    before = TPC.LAUNCHES["paint_windowed"]
    got = TPC.paint_windowed(pf, w, ng, box, order=order)
    assert TPC.LAUNCHES["paint_windowed"] == before + 1
    want = TPC.paint_windowed_reference(pf, w, ng, box, order=order)
    torch.cuda.synchronize()
    assert got.shape == (ng, ng, ng)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.max())
    mass = float(w.double().sum()) if weighted else float(n)
    assert abs(float(got.double().sum()) - mass) <= 1e-5 * mass


def test_k2_paint_dispatch(cuda):
    rng = np.random.default_rng(8)
    pos = torch.from_numpy(rng.uniform(0, BOX, (20000, 3)).astype(
        np.float32)).to(cuda)
    before = TPC.LAUNCHES["paint_windowed"]
    a = TP.paint(pos, 16, BOX, window="tsc")
    b = TP.paint(tuple(pos.unbind(-1)), 16, BOX, window="cic")
    assert TPC.LAUNCHES["paint_windowed"] == before + 2
    sa = TP.paint(pos, 16, BOX, window="tsc", deposit="scatter")
    sb = TP.paint(pos, 16, BOX, window="cic", deposit="scatter")
    assert TPC.LAUNCHES["paint_windowed"] == before + 2
    torch.testing.assert_close(a, sa, rtol=0, atol=2e-5 * float(sa.max()))
    torch.testing.assert_close(b, sb, rtol=0, atol=2e-5 * float(sb.max()))


@pytest.mark.parametrize("order", [2, 3])
def test_k2_bins_match_windowed_keys(cuda, order):
    """K2's bin pass computes the plain version's keys and fractions bit
    for bit (true division by h, TSC clip before d) on a boundary-heavy
    input: positions on cell and tile edges, an ulp beside them, on the
    box edges and a box outside; its tiles and per-tile counts are those
    of the plain keys."""
    rng = np.random.default_rng(13)
    ng, box, n = 97, 500.0, 300000
    h = box / ng
    edges = np.concatenate([np.arange(-1, ng + 2) * h,
                            (np.arange(-1, ng + 2) + 0.5) * h])
    on = edges[rng.integers(0, len(edges), (n, 3))].astype(np.float32)
    pos = np.nextafter(on, rng.choice([-np.inf, np.inf], (n, 3))
                       ).astype(np.float32)
    pos[: n // 3] = on[: n // 3]
    pos[n // 3: n // 2] += np.float32(box) * rng.choice([-1, 1], (
        n // 2 - n // 3, 3)).astype(np.float32)
    pos[:4] = [[0.0, box, -0.0], [-1e-8, 1e-8, box], [box, box, box],
               [-box, 2 * box, -2e-8]]
    pf = torch.from_numpy(np.concatenate(pos.T).astype(np.float32)).to(cuda)
    tiles, counts, keys, frac = TPC.windowed_bins(pf, ng, box, order)
    want_key, want_frac = TPC._windowed_keys(pf, ng, box, order)
    assert int((keys != want_key).sum()) == 0
    assert torch.equal(frac, want_frac)
    want_tiles = TPC._tile_ids(want_key, ng, order)
    assert torch.equal(tiles, want_tiles)
    assert torch.equal(counts, torch.bincount(
        want_tiles.long(), minlength=counts.numel()).to(torch.int32))


def test_facades_numpy_input_runs_on_the_card(cuda, tmp_path):
    """numpy input with no `device` runs on the card: the P(k) facade
    launches K1, `density_fields` K2, and `Bispectrum3D` returns the CPU's
    numbers to float32 rounding."""
    from astrild_tpu_torch.models import (Bispectrum3D, Ecosmog,
                                          PowerSpectrum3D)

    rng = np.random.default_rng(14)
    pos = rng.uniform(0, BOX, (50000, 3)).astype(np.float32)
    before = dict(TPC.LAUNCHES)
    _, p_card = PowerSpectrum3D().power_from_points(pos, BOX, 32, nbins=8,
                                                    method="fast")
    assert TPC.LAUNCHES["deposit_sorted"] == before.get("deposit_sorted",
                                                        0) + 1
    _, p_cpu = PowerSpectrum3D(device="cpu").power_from_points(
        pos, BOX, 32, nbins=8, method="fast")
    # uniform points: P(k) sits near zero after shot-noise subtraction, so
    # compare at 1e-5 of the shot level
    shot = BOX ** 3 / pos.shape[0]
    np.testing.assert_allclose(p_card, p_cpu, rtol=0, atol=1e-5 * shot)
    sim = Ecosmog(dir_sim=str(tmp_path), boxsize=BOX, domain_level=16)
    rho = sim.density_fields(pos)["density"]
    assert rho.device.type == "cuda"
    assert TPC.LAUNCHES["paint_windowed"] == before.get("paint_windowed",
                                                        0) + 1
    b_card = Bispectrum3D.from_points(pos, BOX, 16, nbins=3)
    b_cpu = Bispectrum3D.from_points(pos, BOX, 16, nbins=3, device="cpu")
    for key, w in b_cpu.items():
        fin = np.isfinite(w)
        np.testing.assert_allclose(b_card[key][fin], w[fin], rtol=1e-3,
                                   atol=1e-4 * np.abs(w[fin]).max(
                                       initial=0.0))


# ------------------------------------------------------------------ K3
def _smoke():
    """chip_smoke.py's catalog builders (the repository root's script)."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("case", ["uniform", "ragged_valid", "coincident",
                                  "beyond", "edge_pairs", "clumps_reach",
                                  "negative", "nbins128", "lattice_beyond",
                                  "one_cell"])
def test_k3_matches_plain(cuda, case):
    """K3 vs its plain version: rtol 1e-4 on nom and den, with atol 1e-4
    of each output's max for bins that hold few pairs. The cases of
    chip_smoke.py phase 5 at a smaller size: pairs at the cut s_max of
    the last and a middle edge and an ulp below, clumps just inside and
    just outside reach, coordinates around the origin, 128 bins, a lattice
    beyond reach (only diagonal tile pairs visited), one cell."""
    rng = np.random.default_rng(6)
    n, box, binw, nbins = 3000 + 77, 60.0, 2.0, 25
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 300, (n, 3)).astype(np.float32)
    n_valid = n
    if case == "ragged_valid":
        n_valid = n - 200
        pos[n_valid:] = 30.0
        vel[n_valid:] = 1e6
    if case == "coincident":
        pos[n // 2:] = pos[: n - n // 2]
    if case == "beyond":
        binw = 1e-4
    if case == "edge_pairs":
        pos = _smoke().k3_edge_pairs(binw, (nbins, 7), per=32)
    if case == "clumps_reach":
        reach = float(np.sqrt(TPWC.s_max(binw, nbins)))
        a = rng.uniform(0.0, 2.0, (256, 3)).astype(np.float32)
        pos = np.concatenate([a, a + [2.0 + reach - 0.05, 0.0, 0.0],
                              a + [0.0, 500.0, 0.0],
                              a + [2.0 + reach + 0.05, 500.0, 0.0]])
    if case == "negative":
        pos -= box / 2
    if case == "nbins128":
        binw, nbins = 0.25, 128
    if case == "lattice_beyond":
        pos, binw = _smoke().k3_lattice(), 1e-5
    if case == "one_cell":
        pos = pos / box + 7.0
    pos = pos.astype(np.float32)
    if pos.shape[0] != n:
        n_valid = pos.shape[0]
        vel = rng.normal(0, 300, pos.shape).astype(np.float32)
    p = torch.from_numpy(pos).to(cuda)
    v = torch.from_numpy(vel).to(cuda)
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    nom, den = TPWC.pairwise_accumulate(p, v, n_valid, binw, nbins)
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before + 1
    pnom, pden = TPWC.pairwise_accumulate_reference(p, v, n_valid, binw,
                                                    nbins)
    for got, want in ((nom, pnom), (den, pden)):
        torch.testing.assert_close(
            got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    if case in ("beyond", "lattice_beyond"):
        assert float(nom.abs().sum()) == 0.0 == float(den.abs().sum())
    if case == "lattice_beyond":
        plan = TPWC.plan(p, v, n_valid, binw, nbins)
        items = TPWC.tile_pairs(plan.lo, plan.hi, plan.s_max).cpu()
        assert items.tolist() == [[t, t] for t in range(items.shape[0])]


def _peak_above_base(fn) -> int:
    """Card memory that `fn` allocates at its peak above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def test_k3_scratch_with_every_tile_pair_in_reach(cuda):
    """2^18 tracers with every pair in reach (binwidth 1e30, one bin): every
    tile pair is visited, and the call allocates no more above its plan
    (the tiled rows and boxes, O(n)) than its partial rows and output: no
    list of the n_tiles^2 / 2 tile pairs. Prints the scratch; the bin's
    sums are finite, den positive."""
    n = 1 << 18
    gen = torch.Generator(device=cuda).manual_seed(11)
    p = torch.rand((n, 3), generator=gen, device=cuda) * 500.0 - 250.0
    v = torch.randn((n, 3), generator=gen, device=cuda) * 300.0
    plan_peak = _peak_above_base(lambda: TPWC.plan(p, v, n, 1e30, 1))
    out = []
    call_peak = _peak_above_base(
        lambda: out.extend(TPWC.pairwise_accumulate(p, v, n, 1e30, 1)))
    st = TPWC.plan_stats(TPWC.plan(p, v, n, 1e30, 1), 1)
    print(f"K3 at {n} tracers, every tile pair in reach: {st}; peak above "
          f"base: plan {plan_peak} B, call {call_peak} B")
    assert st["tile_pairs_visited"] == st["tile_pairs"] == 1024 * 1025 // 2
    partials = st["grid"] * 2 * 4
    assert call_peak - plan_peak <= partials + 4096
    nom, den = out
    assert bool(torch.isfinite(nom).all()) and float(den[0]) > 0.0


def test_k3_runs_are_bit_identical(cuda):
    """Two K3 calls on the same clustered tracers return the same bits."""
    rng = np.random.default_rng(10)
    pos = np.concatenate([rng.uniform(0, 300, (30000, 3)),
                          rng.normal(150, 3.0, (10000, 3))])
    p = torch.from_numpy(pos.astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(0, 300, pos.shape).astype(
        np.float32)).to(cuda)
    a = TPWC.pairwise_accumulate(p, v, p.shape[0], 50.0 / 24.0, 25)
    b = TPWC.pairwise_accumulate(p, v, p.shape[0], 50.0 / 24.0, 25)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k3_numpy_input_runs_on_the_card(cuda):
    """mean_pairwise_velocity given numpy arrays and no `device` runs on
    the card: one K3 launch, the plain version's v12 to rtol 1e-4."""
    rng = np.random.default_rng(12)
    pos = rng.uniform(400, 600, (2000, 3)).astype(np.float32)
    vel = rng.normal(0, 200, (2000, 3)).astype(np.float32)
    bins = np.linspace(0, 50, 25)
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    r, v = TPW.mean_pairwise_velocity(pos, vel, bins)
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before + 1
    assert v.device.type == "cuda" and r.device.type == "cuda"
    _, vp = TPW.mean_pairwise_velocity(pos, vel, bins, device="cpu")
    torch.testing.assert_close(v.cpu(), vp, rtol=1e-4, atol=1e-3,
                               equal_nan=True)


def test_k3_mean_pairwise_velocity_auto(cuda):
    rng = np.random.default_rng(2)
    pos = torch.from_numpy(rng.uniform(400, 600, (2000, 3)).astype(
        np.float32)).to(cuda)
    vel = torch.from_numpy(rng.normal(0, 200, (2000, 3)).astype(
        np.float32)).to(cuda)
    bins = np.linspace(0, 50, 25)
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    r, v = TPW.mean_pairwise_velocity(pos, vel, bins)
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before + 1
    _, vp = TPW.mean_pairwise_velocity(pos, vel, bins, backend="plain")
    torch.testing.assert_close(v, vp, rtol=1e-4, atol=1e-3,
                               equal_nan=True)


def test_k3_uneven_edges_never_plain_under_kernel(cuda):
    """Uneven edges have no kernel: 'auto' takes the plain searchsorted
    tiles, an explicit 'kernel' raises rather than run them."""
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.uniform(0, 60, (500, 3)).astype(
        np.float32)).to(cuda)
    vel = torch.from_numpy(rng.normal(0, 200, (500, 3)).astype(
        np.float32)).to(cuda)
    bins = np.array([0.0, 2.0, 5.0, 10.0, 20.0])
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    _, v = TPW.mean_pairwise_velocity(pos, vel, bins)
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before
    assert v.shape == (4,)
    with pytest.raises(ValueError, match="uniform bins"):
        TPW.mean_pairwise_velocity(pos, vel, bins, backend="kernel")


# ------------------------------------------------------- forward model
def test_pm_evolve_on_card_matches_cpu(cuda):
    """2LPT + 2 KDK steps at 32^3 on a 32^3 mesh: the card (K2 paints) vs
    the CPU port (scatter paints). Positions to 1e-3 Mpc/h (cell 3.9),
    momenta to 1e-3 of their max (float sums in other orders)."""
    tc = Cosmology(Om0=0.3, h=0.7)
    n, box = 32, 125.0
    gen = torch.Generator().manual_seed(5)

    def pk(k):
        return 300.0 * torch.ones_like(k)

    comps, mom = TN.lpt_catalog(gen, n, box, pk, tc, 9.0)
    before = TPC.LAUNCHES["paint_windowed"]
    out_g, mom_g = TN.pm_evolve(tuple(c.to(cuda) for c in comps),
                                tuple(p.to(cuda) for p in mom), tc, n, box,
                                0.1, 0.4, 2)
    assert TPC.LAUNCHES["paint_windowed"] == before + 3
    out_c, mom_c = TN.pm_evolve(comps, mom, tc, n, box, 0.1, 0.4, 2)
    for g, c in zip(out_g, out_c):
        d = (g.cpu() - c).abs()
        assert float(torch.minimum(d, box - d).max()) < 1e-3
    for g, c in zip(mom_g, mom_c):
        torch.testing.assert_close(g.cpu(), c, rtol=0,
                                   atol=1e-3 * float(c.abs().max()))


# ------------------------------------------------ K1's lightcone callers
LIGHTCONE_BOX = 500.0
# (chi0, dchi, nplanes, fov, npix, n_rep): a narrow cone, and a wide one
# whose planes span several box depths along the line of sight
CONES = {"narrow": (200.0, 31.25, 8, 0.35, 64, 0),
         "wide_nrep1": (950.0, 100.0, 6, 0.6, 32, 1)}


def _lightcone_pos(dev, n=200000, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.rand(n, generator=gen, device=dev) * LIGHTCONE_BOX
                 for _ in range(3))


def _deposit_flushes(monkeypatch, budget, *args):
    """`_plane_counts_deposit(*args)` with room for `budget` entries a
    flush (None: what the card reports); returns (counts, chis, the
    entries of each flush)."""
    sizes = []
    real = TPC.deposit_flat

    def recording(keys, weights, n_cells):
        sizes.append(keys.shape[0])
        return real(keys, weights, n_cells)

    with monkeypatch.context() as patch:
        patch.setattr(TPC, "deposit_flat", recording)
        if budget is not None:
            patch.setattr(TLP, "_entry_budget", lambda dev, n_cells: budget)
        counts, chis = TLP._plane_counts_deposit(*args)
    return counts, chis, sizes


@pytest.mark.parametrize("cone", sorted(CONES))
@pytest.mark.parametrize("group", [None, 1, 4])
def test_lens_planes_k1_matches_scan(cuda, cone, group, monkeypatch):
    """The lens planes through K1 against the per-plane scan on the same
    particles, weighted, off-centre observer: atol 1e-4 of the largest
    count + 1e-3, sums to rtol 1e-6; one K1 launch per flush. With room
    for `group` times the largest plane's entries the planes go in the
    groups that room gives (one plane a flush on the far planes at
    `group` 1) and add up to the same counts."""
    chi0, dchi, nplanes, fov, npix, n_rep = CONES[cone]
    pos = _lightcone_pos(cuda)
    w = torch.rand(pos[0].shape[0], device=cuda) + 0.5
    oxy = (123.0, 377.5)
    want, _ = TLP._plane_counts_scan(pos, LIGHTCONE_BOX, chi0, dchi, nplanes,
                                     fov, npix, 2, oxy, n_rep, w)
    # each plane's entries, from one-plane calls (chi0 and dchi are exact
    # in float32, so these are the stacked call's planes)
    per_plane = [_deposit_flushes(monkeypatch, None, pos, LIGHTCONE_BOX,
                                  chi0 + i * dchi, dchi, 1, fov, npix, 2,
                                  oxy, n_rep, w)[2][0]
                 for i in range(nplanes)]
    budget = None if group is None else group * max(per_plane)
    groups = [0]
    for e in per_plane:
        if budget is not None and groups[-1] and groups[-1] + e > budget:
            groups.append(0)
        groups[-1] += e
    before = TPC.LAUNCHES["deposit_sorted"]
    got, chis, sizes = _deposit_flushes(monkeypatch, budget, pos,
                                        LIGHTCONE_BOX, chi0, dchi, nplanes,
                                        fov, npix, 2, oxy, n_rep, w)
    assert sizes == groups
    assert len(sizes) == 1 if group is None else len(sizes) > 1
    assert TPC.LAUNCHES["deposit_sorted"] == before + len(sizes)
    assert got.device.type == "cuda" and chis.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-4 * float(want.max()) + 1e-3
    assert abs(float(got.double().sum()) - float(want.double().sum())) \
        <= 1e-6 * float(want.double().sum())


def test_density_planes_take_k1_on_the_card(cuda):
    """`density_planes_from_particles` launches K1 for a CUDA tensor and
    for numpy input (which lands on the card), and agrees with its CPU run
    (the scan) to rtol 1e-4 of the largest |delta|."""
    pos = torch.stack(_lightcone_pos(cuda, n=100000), dim=1)
    args = (LIGHTCONE_BOX, 600.0, 200.0, 3, 0.1, 32)
    before = TPC.LAUNCHES["deposit_sorted"]
    got, chis = TLP.density_planes_from_particles(pos, *args)
    assert TPC.LAUNCHES["deposit_sorted"] == before + 1
    from_numpy, _ = TLP.density_planes_from_particles(pos.cpu().numpy(),
                                                      *args)
    assert TPC.LAUNCHES["deposit_sorted"] == before + 2
    assert from_numpy.device.type == "cuda"
    cpu, _ = TLP.density_planes_from_particles(pos.cpu(), *args)
    scale = float(cpu.abs().max())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale
    assert float((from_numpy.cpu() - cpu).abs().max()) <= 1e-4 * scale
    assert chis.tolist() == [600.0, 800.0, 1000.0]


def test_lens_planes_refuse_what_cannot_fit(cuda, monkeypatch):
    """2^31 cells or more raise before any key is built; a plane whose
    entries pass the card's room (set here) raises with both sizes and
    launches nothing."""
    pos = _lightcone_pos(cuda, n=20000)
    before = TPC.LAUNCHES["deposit_sorted"]
    with pytest.raises(ValueError, match="2\\^31"):
        TLP._plane_counts_deposit(pos, LIGHTCONE_BOX, 300.0, 100.0, 512,
                                  0.05, 2048, 2, None, 0)
    assert TLP._entry_budget(cuda, 1 << 20) > 1 << 20
    monkeypatch.setattr(TLP, "_entry_budget", lambda dev, n_cells: 1000)
    with pytest.raises(RuntimeError, match="room for 1000"):
        TLP._plane_counts_deposit(pos, LIGHTCONE_BOX, 950.0, 100.0, 6, 0.6,
                                  32, 2, None, 1)
    assert TPC.LAUNCHES["deposit_sorted"] == before


@pytest.mark.parametrize("weighted", [False, True])
def test_shells_k1_matches_index_add(cuda, weighted):
    """HEALPix shells through K1 against `index_add_` of the same keys
    (`deposit="scatter"`): counts equal, weighted sums within 2e-5 * max;
    the JAX package's spelling "pallas" is the kernel; numpy input lands
    on the card."""
    pos = torch.stack(_lightcone_pos(cuda), dim=1)
    w = torch.rand(pos.shape[0], device=cuda) + 0.5 if weighted else None
    edges = np.array([150.0, 300.0, 450.0, 650.0])
    before = TPC.LAUNCHES["deposit_sorted"]
    got = TLS.shell_counts_healpix(pos, edges, 64, LIGHTCONE_BOX, weights=w)
    assert TPC.LAUNCHES["deposit_sorted"] == before + 1
    want = TLS.shell_counts_healpix(pos, edges, 64, LIGHTCONE_BOX, weights=w,
                                    deposit="scatter")
    assert TPC.LAUNCHES["deposit_sorted"] == before + 1
    if weighted:
        assert float((got - want).abs().max()) <= 2e-5 * float(want.max())
    else:
        assert torch.equal(got, want)
    alias = TLS.shell_counts_healpix(pos, edges, 64, LIGHTCONE_BOX,
                                     weights=w, deposit="pallas")
    assert TPC.LAUNCHES["deposit_sorted"] == before + 2
    assert float((alias - got).abs().max()) <= 2e-5 * float(want.max())
    from_numpy = TLS.shell_counts_healpix(
        pos.cpu().numpy(), edges, 64, LIGHTCONE_BOX,
        weights=None if w is None else w.cpu().numpy())
    assert from_numpy.device.type == "cuda"
    assert float((from_numpy - got).abs().max()) <= 2e-5 * float(want.max())


def test_shells_grouped_flushes_on_the_card(cuda, monkeypatch):
    """A room for one box image's keys flushes image by image (one K1
    launch each) and gives the same counts; no room raises with its
    sizes."""
    pos = _lightcone_pos(cuda, n=50000)
    edges = np.array([150.0, 400.0, 650.0])
    want = TLS.shell_counts_healpix(pos, edges, 16, LIGHTCONE_BOX)
    monkeypatch.setattr(TLS, "_entry_budget", lambda dev, n: 50000)
    before = TPC.LAUNCHES["deposit_sorted"]
    got = TLS.shell_counts_healpix(pos, edges, 16, LIGHTCONE_BOX)
    assert TPC.LAUNCHES["deposit_sorted"] - before > 5
    assert torch.equal(got, want)
    monkeypatch.setattr(TLS, "_entry_budget", lambda dev, n: 10)
    with pytest.raises(RuntimeError, match="room for 10"):
        TLS.shell_counts_healpix(pos, edges, 16, LIGHTCONE_BOX)


def test_lightcone_numpy_input_lands_on_the_card(cuda):
    """The lane's entry points that take maps, shells or wavenumbers put
    numpy input on the card and agree there with their CPU runs (rtol 1e-4
    of the largest value: FFTs and float32 sums in another order)."""
    from astrild_tpu_torch.ops import angular_power as TAP
    from astrild_tpu_torch.ops import linear_power as TL
    from astrild_tpu_torch.ops import raytrace as TRT

    rng = np.random.default_rng(3)
    tc = Cosmology(Om0=0.3, h=0.7)
    img = rng.standard_normal((32, 32)).astype(np.float32)
    planes = (0.1 * rng.standard_normal((2, 32, 32))).astype(np.float32)
    shells = (0.1 * rng.standard_normal((2, 48))).astype(np.float32)
    k = np.geomspace(0.01, 5.0, 8).astype(np.float32)
    chis, dchis = [500.0, 900.0], [400.0, 400.0]
    calls = {
        "multiplane_raytrace": lambda **kw: TRT.multiplane_raytrace(
            planes, chis, dchis, 1500.0, 0.3, 0.05, **kw)["kappa"],
        "plane_deflection_fields": lambda **kw: TRT.plane_deflection_fields(
            img, 0.05, **kw)[0],
        "born_convergence_healpix": lambda **kw:
            TLS.born_convergence_healpix(shells, chis, dchis, 1500.0, 0.3,
                                         **kw),
        "flat_sky_mode_counts": lambda **kw: TAP.flat_sky_mode_counts(
            32, 5.0, nbins=4, **kw)[1],
        "cl_flat_sky": lambda **kw: TAP.cl_flat_sky(img, 5.0, nbins=4,
                                                    **kw)[1],
        "cl_flat_sky_cross": lambda **kw: TAP.cl_flat_sky_cross(
            img, img[::-1].copy(), 5.0, nbins=4, **kw)[1],
        "nonlinear_power": lambda **kw: TL.nonlinear_power(k, tc, 0.5, **kw),
        "linear_power": lambda **kw: TL.linear_power(k, tc, 0.5, **kw),
    }
    for name, call in calls.items():
        got, cpu = call(), call(device="cpu")
        assert got.device.type == "cuda" and cpu.device.type == "cpu", name
        assert float((got.cpu() - cpu).abs().max()) \
            <= 1e-4 * float(cpu.abs().max()), name


def test_jax_spellings_run_the_kernels_on_the_card(cuda):
    """`deposit="pallas"` / `"pallas_seg"` and `backend="pallas"` launch
    the kernels their port spellings launch and give the same results."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    pos = torch.rand((100000, 3), generator=gen, device=cuda) * BOX
    for jax_name, port_name, counter in (
            ("pallas", "kernel", "deposit_sorted"),
            ("pallas_seg", "kernel_seg", "deposit_segmented")):
        before = TPC.LAUNCHES[counter]
        a = TPS.auto_power_fast(pos, 32, BOX, nbins=8, deposit=jax_name)
        b = TPS.auto_power_fast(pos, 32, BOX, nbins=8, deposit=port_name)
        assert TPC.LAUNCHES[counter] == before + 2
        assert torch.equal(a.power, b.power)
    before = TPC.LAUNCHES["paint_windowed"]
    a = TP.paint(pos, 32, BOX, deposit="pallas")
    b = TP.paint(pos, 32, BOX, deposit="kernel")
    assert TPC.LAUNCHES["paint_windowed"] == before + 2
    # K2's float atomics land in another order from run to run
    assert float((a - b).abs().max()) <= 2e-5 * float(b.max())
    vel = torch.randn((100000, 3), generator=gen, device=cuda) * 300.0
    bins = np.linspace(0.0, 40.0, 9)
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    _, a = TPW.mean_pairwise_velocity(pos[:4000], vel[:4000], bins,
                                      backend="pallas")
    _, b = TPW.mean_pairwise_velocity(pos[:4000], vel[:4000], bins,
                                      backend="kernel")
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before + 2
    assert torch.equal(a, b)
    _, c = TPW.mean_pairwise_velocity(pos[:1000], vel[:1000], bins,
                                      backend="xla")
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before + 2
    assert bool(torch.isfinite(c).all())


def test_pm_lightcone_planes_on_card_matches_cpu(cuda):
    """The lightcone forward model from the same modes and shifts on the
    card (K2 every force evaluation, K1 every plane) and on the CPU: rtol
    5e-3 of each plane's max |delta| (two float32 PM runs)."""
    cosmo = Cosmology(Om0=0.3, h=0.7)
    rng = np.random.default_rng(2)
    n, box = 32, 200.0
    dk = np.fft.fftn(rng.standard_normal((n, n, n))).astype(np.complex64)
    dk *= 3.0
    args = (cosmo, n, box, 0.05, 32, 6)
    kw = dict(z_source=0.4, nsteps_init=4, steps_per_plane=1,
              shifts=rng.uniform(0, box, (5, 2)))
    launches = dict(TPC.LAUNCHES)
    got, chis, dchi = TN.pm_lightcone_planes_from_modes(dk, *args, **kw)
    assert got.device.type == "cuda"  # numpy modes land on the card
    assert TPC.LAUNCHES["deposit_sorted"] == launches.get(
        "deposit_sorted", 0) + 6
    assert TPC.LAUNCHES["paint_windowed"] == launches.get(
        "paint_windowed", 0) + 4 + 5 + 6
    want, _, _ = TN.pm_lightcone_planes_from_modes(dk, *args, device="cpu",
                                                   **kw)
    for i in range(6):
        scale = float(want[i].abs().max())
        assert float((got[i].cpu() - want[i]).abs().max()) <= 5e-3 * scale


# ---------------------------------------------------------- clustering lane
def _clumpy(rng, n, box=BOX):
    """float32 positions, half in Gaussian clumps, and velocities whose
    signs cancel (km/s)."""
    centers = rng.uniform(0, box, (64, 3))
    half = n // 2
    pos = np.concatenate([centers[rng.integers(0, 64, half)]
                          + rng.normal(0, 1.5, (half, 3)),
                          rng.uniform(0, box, (n - half, 3))]) % box
    vel = rng.normal(0, 300, (n, 3))
    return pos.astype(np.float32), vel.astype(np.float32)


def test_k2_signed_weights_and_velocity_grids(cuda):
    """K2 with a signed weight (a velocity component) at 2^20 particles
    onto 64^3 against its plain version: within 2e-5 of the largest |cell|,
    the total within 1e-5 of sum |w|. velocity_field on the card (four K2
    launches) against the same call on the CPU: counts and momentum grids
    within 2e-5 of their max, the velocity where the counts exceed 1e-3 of
    their mean within the bar the two grids' errors carry (a cell with a
    sliver of a particle turns rounding into a large velocity)."""
    from astrild_tpu_torch.ops import velocity as TV

    rng = np.random.default_rng(21)
    pos, vel = _clumpy(rng, 1 << 20)
    pf = torch.from_numpy(pos.T.copy().reshape(-1)).to(cuda)
    for a in range(3):
        w = torch.from_numpy(vel[:, a].copy()).to(cuda)
        got = TPC.paint_windowed(pf, w, 64, BOX, order=2)
        want = TPC.paint_windowed_reference(pf, w, 64, BOX, order=2)
        assert float((got - want).abs().max()) <= 2e-5 * float(
            want.abs().max())
        assert abs(float(got.double().sum()) - float(w.double().sum())) \
            <= 1e-5 * float(w.double().abs().sum())
    before = TPC.LAUNCHES["paint_windowed"]
    vg, counts = TV.velocity_field(torch.from_numpy(pos).to(cuda),
                                   torch.from_numpy(vel).to(cuda), 64, BOX)
    assert TPC.LAUNCHES["paint_windowed"] - before == 4
    cvg, ccounts = TV.velocity_field(torch.from_numpy(pos),
                                     torch.from_numpy(vel), 64, BOX)
    c, cc = counts.cpu().numpy(), ccounts.numpy()
    assert np.abs(c - cc).max() <= 2e-5 * cc.max()
    well = cc > 1e-3 * cc.mean()
    for a in range(3):
        m = TP.paint(torch.from_numpy(pos).to(cuda), 64, BOX,
                     weights=torch.from_numpy(vel[:, a].copy()).to(cuda))
        cm = TP.paint(torch.from_numpy(pos), 64, BOX,
                      weights=torch.from_numpy(vel[:, a].copy())).numpy()
        assert np.abs(m.cpu().numpy() - cm).max() <= 2e-5 * np.abs(cm).max()
        v, cv = vg[a].cpu().numpy(), cvg[a].numpy()
        bar = 2e-5 * (np.abs(cm).max() + np.abs(cv) * cc.max()) / cc
        assert np.all(np.abs(v - cv)[well] <= bar[well])


def test_clustering_numpy_input_lands_on_the_card(cuda):
    """The clustering lane's entry points put numpy input on the card and
    agree there with their CPU runs: pair counts equal (the same float32
    formulas elementwise), the rest within 1e-4 of the largest value (K2
    against the scatter painters, FFTs and float32 sums in another
    order); mean_pv_from_tv runs K3 (one launch) and matches its CPU plain
    tiles to 1e-4 in bins of >= 1000 pairs."""
    from astrild_tpu_torch.ops import bao as TBAO
    from astrild_tpu_torch.ops import density_split as TDS
    from astrild_tpu_torch.ops import fftlog as TF
    from astrild_tpu_torch.ops import linear_power as TL
    from astrild_tpu_torch.ops import profiles3d as TPR
    from astrild_tpu_torch.ops import recon as TR
    from astrild_tpu_torch.ops import tpcf as TT
    from astrild_tpu_torch.ops import velocity as TV
    from astrild_tpu_torch.utils import geometry as TG

    rng = np.random.default_rng(22)
    pos, vel = _clumpy(rng, 20000)
    tc = Cosmology(Om0=0.3, h=0.7)
    k = np.geomspace(1e-3, 10.0, 256)
    lc = TG.transform_box_to_lc_cart_coords(pos, BOX, 300.0)
    edges = np.linspace(0.0, 20.0, 11)
    bins = np.linspace(0.0, 20.0, 21)
    exact = {
        "pairwise_velocity_pdf": lambda **kw: TPW.pairwise_velocity_pdf(
            pos[:4000], vel[:4000], 20, 400, **kw),
        "pair_counts_s_mu": lambda **kw: TT.pair_counts_s_mu(
            pos[:4000], BOX, edges, 10, nmu=5, **kw),
        "counts_in_cells": lambda **kw: TDS.counts_in_cells(pos, BOX, 16,
                                                            **kw)[1],
    }
    close = {
        "velocity_field": lambda **kw: TV.velocity_field(
            pos, vel, 32, BOX, **kw)[1],
        "displacement_field": lambda **kw: TR.displacement_field(
            pos, 32, BOX, smooth=8.0, **kw),
        "reconstruct_catalog": lambda **kw: TR.reconstruct_catalog(
            pos, pos[:1000], 32, BOX, smooth=8.0, **kw)[1],
        "marked_power": lambda **kw: TDS.marked_power(
            pos, 32, BOX, 10.0, nbins=8, **kw)[0].power,
        "radial_density_profiles": lambda **kw: TPR.radial_density_profiles(
            pos, vel[:, 0] ** 2, pos[:50], 0.5, 20.0, nbins=8, boxsize=BOX,
            **kw)[1],
        "tpcf_real": lambda **kw: TT.tpcf_real(pos[:4000], BOX, edges,
                                               **kw)[1],
        "projected_tpcf": lambda **kw: TT.projected_tpcf(
            pos[:4000], BOX, edges[1:], 20.0, n_pi=5, **kw)[1],
        "to_redshift_space": lambda **kw: TT.to_redshift_space(pos, vel, BOX,
                                                               **kw),
        "pairwise_ksz_momentum": lambda **kw: TPW.pairwise_ksz_momentum(
            lc[:4000], vel[:4000, 2], bins, **kw)[1].nan_to_num(),
        "convert_vec_cart_to_sph": lambda **kw: TG.convert_vec_cart_to_sph(
            pos[:, 0], pos[:, 1], vel, **kw),
        "sph_bessel_transform": lambda **kw: TF.sph_bessel_transform(
            k, k * np.exp(-k), 0, **kw)[1],
        "wp_from_pk": lambda **kw: TF.wp_from_pk(
            k, TL.linear_power(k, tc, **kw), np.linspace(5, 40, 8), 60.0),
        "eh98_transfer_nowiggle": lambda **kw: TL.eh98_transfer_nowiggle(
            k, tc, **kw),
        "kaiser_multipoles": lambda **kw: TL.kaiser_multipoles(
            k, tc, **kw)[1],
    }
    for name, call in {**exact, **close}.items():
        got, cpu = call(), call(device="cpu")
        assert got.device.type == "cuda" and cpu.device.type == "cpu", name
        if name in exact:
            assert torch.equal(got.cpu(), cpu), name
        else:
            assert float((got.cpu() - cpu).abs().max()) \
                <= 1e-4 * float(cpu.abs().max()), name
    # the BAO template is evaluated on the card by default (numpy out)
    t_card = TBAO.bao_template_power(k[40:120], tc)
    t_cpu = TBAO.bao_template_power(k[40:120], tc, device="cpu")
    assert np.abs(t_card - t_cpu).max() <= 1e-4 * np.abs(t_cpu).max()
    # v12 from transverse velocities: K3 on the card
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    lc8, vel8 = lc[:8000], vel[:8000]
    r, v12 = TPW.mean_pv_from_tv(lc8, vel8[:, :2], bins)
    assert TPWC.LAUNCHES["pairwise_accumulate"] - before == 1
    rc, v12c = TPW.mean_pv_from_tv(lc8, vel8[:, :2], bins, device="cpu")
    # pairs per 1 Mpc/h bin (every |v12| below 10^4 km/s), on the card
    pairs = TPW.pairwise_velocity_pdf(lc8, vel8, 20, 20000).sum(1).cpu()
    many = pairs >= 1000
    assert bool(many.any())
    got, want = v12.cpu()[:20][many], v12c[:20][many]
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max()) + 1e-3


# ------------------------------------------------------ galaxy mocks
@pytest.mark.parametrize("n, ngrid", [(1 << 20, 128), (1 << 22, 768)])
def test_k2_at_the_galaxy_mocks_shapes(cuda, n, ngrid):
    """K2 CIC counts at the galaxy-mocks path's two new grids (the galaxy
    grid, 128^3, and the SO grid, 768^3) at a reduced particle count,
    clustered: within 2e-5 of the plain version's largest cell, the mass
    N to rtol 1e-5."""
    rng = np.random.default_rng(23)
    pos, _ = _clumpy(rng, n)
    pf = torch.from_numpy(pos.T.copy().reshape(-1)).to(cuda)
    got = TPC.paint_windowed(pf, None, ngrid, BOX, order=2)
    want = TPC.paint_windowed_reference(pf, None, ngrid, BOX, order=2)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.max())
    assert abs(float(got.double().sum()) - n) <= 1e-5 * n


def test_galaxy_mocks_numpy_input_lands_on_the_card(cuda):
    """The galaxy-mocks path's entry points put numpy input on the card and
    agree there with their CPU runs: counts, labels and catalog sizes
    equal, the rest within 1e-4 of the largest value (FFTs and float32
    sums in another order)."""
    from astrild_tpu_torch.ops import halo_stats as THS
    from astrild_tpu_torch.ops import hod as TH
    from astrild_tpu_torch.ops import peaks as TK
    from astrild_tpu_torch.ops import so_halos as TSO
    from astrild_tpu_torch.ops import voids as TV
    from astrild_tpu_torch.ops import voids3d as TV3

    rng = np.random.default_rng(24)
    pos, _ = _clumpy(rng, 20000)
    # smooth fields (a void, two balls) centred on cells: on a noisy field
    # cuFFT's rounding can move a finder's candidates across a tie
    cell = BOX / 32
    x = (np.arange(32) + 0.5) * cell
    r2 = lambda c: sum((g - c) ** 2 for g in np.meshgrid(x, x, x,  # noqa
                                                          indexing="ij"))
    c0 = 16.5 * cell
    delta = np.where(r2(c0) < 20.0 ** 2, -0.9, 0.1).astype(np.float32)
    balls = (np.where(r2(c0) < 4.0 ** 2, 2000.0, 0.0)
             + np.where(r2(c0 - 12 * cell) < 3.0 ** 2, 2000.0, 0.0)).astype(
                 np.float32)
    # broad wells: no flat region where the smoothed field's rounding would
    # steer the watershed
    wells = (-np.exp(-0.5 * r2(c0) / 25.0 ** 2)
             - 0.8 * np.exp(-0.5 * r2(c0 - 12 * cell) / 20.0 ** 2)).astype(
                 np.float32)
    c_true = rng.uniform(3.0, 20.0, 500)
    v200 = rng.uniform(50.0, 500.0, 500)
    vmax = v200 * np.sqrt(0.216 * c_true / (np.log1p(c_true)
                                            - c_true / (1.0 + c_true)))
    v200, vmax = v200.astype(np.float32), vmax.astype(np.float32)
    img = rng.normal(size=(64, 64)).astype(np.float32)
    m = (10.0 ** rng.uniform(12, 15, 500)).astype(np.float32)
    g = (np.arange(6) * 10 + 7).astype(np.float32)
    peaks = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    peaks = peaks + rng.uniform(-1, 1, peaks.shape).astype(np.float32)
    tc = Cosmology()
    draws = (rng.uniform(size=500) < 0.5, rng.poisson(2.0, 500),
             rng.uniform(size=(500, 4)).astype(np.float32),
             rng.normal(size=(3, 500, 4)).astype(np.float32),
             rng.normal(size=(3, 500, 4)).astype(np.float32))
    exact = {
        "svf_voids": lambda **kw: TV3.svf_voids(delta, BOX, -0.5,
                                                max_voids=32, **kw).n,
        "watershed_voids_3d_n": lambda **kw: TV3.watershed_voids_3d(
            wells, BOX, 32, -0.3, **kw).n,
        "watershed_labels_3d": lambda **kw: TV3.watershed_labels_3d(
            delta, **kw),
        "so_halos": lambda **kw: TSO.so_halos(balls, BOX, 0.3, max_halos=32,
                                              **kw).n_candidates,
        "watershed_labels": lambda **kw: TV.watershed_labels(img, **kw),
        "find_tunnels_auto": lambda **kw: TV.find_tunnels_auto(
            peaks, np.ones(len(peaks), bool), 64, max_voids=8, **kw).n,
        "peak_counts": lambda **kw: TK.peak_counts(img, -1.0, 3.0, 8,
                                                   **kw)[1],
        "halo_mass_function": lambda **kw: THS.halo_mass_function(m,
                                                                  **kw)[1],
        "halo_environment": lambda **kw: THS.halo_environment(
            pos, np.arange(27).reshape(3, 3, 3), (0, BOX, 0, BOX, 0, BOX),
            **kw),
    }
    close = {
        "svf_radius": lambda **kw: TV3.svf_voids(delta, BOX, -0.5,
                                                 max_voids=32, **kw).radius,
        "watershed_voids_3d": lambda **kw: TV3.watershed_voids_3d(
            wells, BOX, 32, -0.3, **kw).radius,
        "enclosed_density_radius": lambda **kw:
            TV3.enclosed_density_radius(delta, BOX, 5.0, 25.0, 8, -0.5,
                                        **kw),
        "sphere_overlap_fraction": lambda **kw: TV3.sphere_overlap_fraction(
            pos[:50], 3.0, pos[50:100], 4.0, BOX, **kw),
        "so_mass": lambda **kw: TSO.so_halos(balls, BOX, 0.3, max_halos=32,
                                             **kw).mass,
        "watershed_voids": lambda **kw: TV.watershed_voids(img, 16,
                                                           **kw).radius,
        "zheng07_mean_occupation": lambda **kw: TH.zheng07_mean_occupation(
            m, TH.HODParams(), **kw)[1],
        "nfw_radius_sample": lambda **kw: TH.nfw_radius_sample(
            m / m.max(), 5.0, **kw),
        "hod_populate_from_draws": lambda **kw: TH.hod_populate_from_draws(
            *draws, m, *pos[:500].T, *(100.0 * pos[:500].T), m / m.max() + 0.5,
            c_true.astype(np.float32), BOX, max_sat=4, **kw)["gx"],
        "binned_mean": lambda **kw: THS.binned_mean(
            np.log10(m), m / m.max(), np.linspace(12, 15, 5), 4, **kw),
        "histogram_density": lambda **kw: THS.histogram_density(
            pos[:, 0], 5, (0.0, BOX), **kw)[1],
        "concentration_prada": lambda **kw: THS.concentration_prada(
            vmax, v200, **kw)[0],
        "theory_hmf": lambda **kw: THS.theory_hmf(m[:16], tc, **kw),
        "theory_vsf": lambda **kw: THS.theory_vsf(pos[:16, 0] / 10 + 2.0,
                                                  tc, **kw),
        "virial_radius": lambda **kw: THS.virial_radius(m, **kw),
        "point_cloud_shape": lambda **kw: THS.point_cloud_shape(
            pos - pos.mean(0), **kw)[0],
    }
    failed = {}
    for name, call in {**exact, **close}.items():
        got = call()
        assert got.device.type == "cuda", name
        want = call(device="cpu")
        g = got.cpu().to(torch.float64).numpy()
        w = want.to(torch.float64).numpy()
        if name in exact:
            ok = np.array_equal(g, w)
        else:
            ok = np.allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
        if not ok:
            failed[name] = (np.ravel(g)[:8].tolist(), np.ravel(w)[:8].tolist())
    assert not failed, f"{sorted(failed)}: {failed}"


def test_hod_populate_with_a_cuda_generator(cuda):
    """hod_populate with a generator on the card: everything on the card,
    the occupation means within the bars of the JAX package's test (40,000
    halos: centrals within 0.01, four binomial sigmas; satellites within
    3%), satellites inside Rvir, the same seed the same catalog."""
    from astrild_tpu_torch.ops import hod as TH

    nh, box = 40000, 100.0
    rng = np.random.default_rng(25)
    m = torch.full((nh,), 10.0 ** 13.2, device=cuda)
    xyz = [torch.from_numpy(rng.uniform(0, box, nh).astype(np.float32)).to(
        cuda) for _ in range(3)]
    v = [torch.zeros(nh, device=cuda)] * 3
    rvir = torch.full((nh,), 0.8, device=cuda)
    conc = torch.full((nh,), 7.0, device=cuda)
    p = TH.HODParams(log_mmin=13.0, sigma_logm=0.3, log_m0=12.0,
                     log_m1=13.2, alpha=1.0)

    def run(seed):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return TH.hod_populate(gen, m, *xyz, *v, rvir, conc, box, params=p,
                               max_sat=24)

    cat = run(1)
    assert all(t.device.type == "cuda" for t in cat.values())
    n_cen, n_sat = TH.zheng07_mean_occupation(m, p)
    assert abs(float(cat["valid"][:nh].float().mean())
               - float(n_cen[0])) < 0.01
    sat = float(cat["valid"][nh:].float().sum()) / nh
    assert abs(sat - float(n_sat[0])) / float(n_sat[0]) < 0.03
    assert int(cat["overflow"]) == 0
    com = TH.compact_catalog(cat)
    s = ~com["is_central"]
    h = com["halo_index"][s]
    d2 = sum(((com[k][s] - xyz[a].cpu().numpy()[h] + box / 2) % box
              - box / 2) ** 2 for a, k in enumerate(("gx", "gy", "gz")))
    assert (np.sqrt(d2) <= 0.8 * 1.0001).all()
    again = run(1)
    assert torch.equal(again["gx"], cat["gx"])


def test_find_tunnels_auto_escalates_on_the_card(cuda):
    """A peak lattice with more candidates than the first capacity: on the
    card find_tunnels_auto escalates to the capacity the CPU run reaches
    and returns its catalog (counts equal, radii within 1e-6); above 4096
    candidates' capacity the per-step form gives the 4096 catalog."""
    from astrild_tpu_torch.ops import voids as TV

    rng = np.random.default_rng(26)
    g = (np.arange(6) * 10 + 7).astype(np.float32)
    peaks = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    peaks = peaks + rng.uniform(-1, 1, peaks.shape).astype(np.float32)
    valid = np.ones(len(peaks), bool)
    got = TV.find_tunnels_auto(torch.from_numpy(peaks).to(cuda),
                               torch.from_numpy(valid).to(cuda), 64,
                               max_voids=8)
    want = TV.find_tunnels_auto(torch.from_numpy(peaks),
                                torch.from_numpy(valid), 64, max_voids=8)
    assert got.radius.shape[0] == want.radius.shape[0] > 8
    assert int(got.n) == int(want.n)
    assert int(got.n_candidates) == int(want.n_candidates)
    np.testing.assert_allclose(got.radius.cpu().numpy(),
                               want.radius.numpy(), rtol=1e-6)
    pos = torch.from_numpy(rng.uniform(0, 128, (700, 2)).astype(
        np.float32)).to(cuda)
    ok = torch.ones(700, dtype=torch.bool, device=cuda)
    small = TV.find_tunnels(pos, ok, 128, max_voids=4096)
    big = TV.find_tunnels(pos, ok, 128, max_voids=8192)
    nv = int(small.n)
    assert int(big.n) == nv > 10
    assert torch.equal(big.radius[:nv], small.radius[:nv])


def test_shear_survey_numpy_input_lands_on_the_card(cuda):
    """The shear-survey path's entry points put numpy input on the card and
    agree there with their CPU runs: counts equal, the rest within 1e-4 of
    the largest value (cuFFT and float32 sums in another order)."""
    from astrild_tpu_torch.models import SkyArray
    from astrild_tpu_torch.ops import angular_power as TAP
    from astrild_tpu_torch.ops import lensing as TL
    from astrild_tpu_torch.ops import shear_2pt as TS

    rng = np.random.default_rng(31)
    n = 64
    g1 = rng.normal(size=(n, n)).astype(np.float32)
    g2 = rng.normal(size=(n, n)).astype(np.float32)
    ells = np.concatenate([np.arange(2.0, 3000.0), [3010.0, 40000.0]])
    cl = 1e-8 / (1.0 + (ells / 800.0) ** 2) ** 1.5
    cl[-2:] = 0.0
    x, y = (rng.uniform(0, 60.0, 3000).astype(np.float32) for _ in "xy")
    e1, e2 = (rng.normal(0, 0.2, 3000).astype(np.float32) for _ in "12")
    edges = np.geomspace(1.0, 20.0, 7)
    white = rng.normal(size=(3, 4, 32, 32)).astype(np.float32)
    centers = np.array([[0, 0], [20, 40], [63, 1]])
    r_edges = np.array([2.0, 4.0, 8.0, 16.0], np.float32)
    sky = lambda **kw: SkyArray.from_array(g1, 2.0, **kw)  # noqa: E731

    def sky_shear(**kw):
        s = sky(**kw)
        s.convert_convergence_to_deflection()
        s.convert_deflection_to_shear()
        return s.shear_xi_pm(nbins=6, theta_min_arcmin=2.0,
                             theta_max_arcmin=40.0)[1]

    exact = {
        "xi_pm_flat_sky_counts": lambda **kw: TS.xi_pm_flat_sky(
            g1, g2, 2.0, nbins=8, **kw)[3],
        "xi_pm_catalog_pairs": lambda **kw: TS.xi_pm_catalog(
            x, y, e1, e2, edges, boxsize=60.0, block=1024, **kw)[2],
        "gamma_t_catalog_pairs": lambda **kw: TS.gamma_t_catalog(
            x[:100], y[:100], x, y, e1, e2, edges, boxsize=60.0, block=512,
            **kw)[2],
        "tangential_shear_stack_counts": lambda **kw:
            TS.tangential_shear_stack(g1, g2, centers, r_edges, 16, 3,
                                      **kw)[3],
    }
    close = {
        "cl_to_flat_map_from_white": lambda **kw:
            TAP.cl_to_flat_map_from_white(g1, g2, ells, cl, n, 2.0, **kw),
        "kappa_to_shear_maps": lambda **kw: TAP.kappa_to_shear_maps(
            g1, **kw)[1],
        "shear_eb_maps": lambda **kw: TAP.shear_eb_maps(g1, g2, **kw)[0],
        "cl_shear_eb": lambda **kw: TAP.cl_shear_eb(g1, g2, 2.0, nbins=8,
                                                    **kw)[1],
        "xi_pm_flat_sky": lambda **kw: TS.xi_pm_flat_sky(
            g1, g2, 2.0, nbins=8, **kw)[1],
        "tangential_shear_stack": lambda **kw: TS.tangential_shear_stack(
            g1, g2, centers, r_edges, 16, 3, **kw)[1],
        "xi_pm_catalog": lambda **kw: TS.xi_pm_catalog(
            x, y, e1, e2, edges, boxsize=60.0, block=1024, **kw)[0],
        "gamma_t_catalog": lambda **kw: TS.gamma_t_catalog(
            x[:100], y[:100], x, y, e1, e2, edges, boxsize=60.0, block=512,
            **kw)[0],
        "xi_pm_from_cl_grid": lambda **kw: TS.xi_pm_from_cl_grid(
            np.geomspace(2.0, 2e4, 512),
            1e-8 / (1 + np.geomspace(2.0, 2e4, 512) / 800.0) ** 3, **kw)[1],
        "delta_sigma_from_pk": lambda **kw: TS.delta_sigma_from_pk(
            np.geomspace(1e-3, 1e3, 512),
            2e4 / (1 + np.geomspace(1e-3, 1e3, 512) / 0.1) ** 2,
            [0.5, 2.0], 0.3, **kw),
        "cosebis_from_xipm": lambda **kw: TS.cosebis_from_xipm(
            np.geomspace(1.0, 100.0, 40), np.geomspace(1.0, 0.01, 40),
            np.geomspace(0.5, 0.02, 40), 4, 2.0, 80.0, **kw)[0],
        "xi_pm_sample_covariance_from_white": lambda **kw:
            TS.xi_pm_sample_covariance_from_white(
                white, ells, cl, 32, 1.0, 4, noise_std=1e-3, **kw)[3],
        "tomographic_from_white": lambda **kw:
            TS.tomographic_xi_pm_sample_covariance_from_white(
                white[:, 0, :, :, None], white[:, 1, :, :, None], ells,
                cl[None, None], 32, 1.0, 4, **kw)[4],
        "skyarray_chain_xi": sky_shear,
    }
    failed = {}
    for name, call in {**exact, **close}.items():
        got = call()
        assert got.device.type == "cuda", name
        want = call(device="cpu")
        g = got.cpu().to(torch.float64).numpy()
        w = want.to(torch.float64).numpy()
        if name in exact:
            ok = np.array_equal(g, w)
        else:
            ok = np.allclose(g, w, rtol=1e-4, atol=1e-4 * np.nanmax(
                np.abs(w)), equal_nan=True)
        if not ok:
            failed[name] = (np.ravel(g)[:8].tolist(), np.ravel(w)[:8].tolist())
    assert not failed, f"{sorted(failed)}: {failed}"
    # the FFTLog theory: within 4x the CPU run's error of a float64 series
    # of the same table, or 5e-5 of its largest value (the two float32
    # FFTs differ by up to ~1e-4 of the peak at the grid's small-r end,
    # tests/test_torch_shear.py::_fftlog_parity)
    from astrild_tpu_torch.ops import fftlog as TF

    grid, vals = TS._log_ell_table(ells, cl, 2048, 2.0)
    nn = grid.size
    dln = float(np.log(grid[-1] / grid[0]) / (nn - 1))
    r = np.exp(np.arange(nn) * dln) / (grid[0] * np.exp((nn - 1) * dln))
    a = (vals.astype(np.float64) * (grid / grid[0])
         * TF._taper(nn).astype(np.float64))
    for name, fn, mu in (("xi_pm_from_cl", TS.xi_pm_from_cl, 0),
                         ("gamma_t_from_cl", TS.gamma_t_from_cl, 2),
                         ("w_theta_from_cl", TS.w_theta_from_cl, 0)):
        kern = TF._fftlog_kernel_cyl(nn, dln, mu, 1.0)
        b = np.fft.fft(a) * (kern[0].astype(np.float64)
                             + 1j * kern[1].astype(np.float64))
        ref = (np.real(np.fft.fft(b)) * grid[0] ** 2 / (grid[0] * r) / nn
               / (2.0 * np.pi))
        got = fn(ells, cl)[1]
        assert got.device.type == "cuda", name
        want = fn(ells, cl, device="cpu")[1].double().numpy()
        err_t = np.abs(got.cpu().double().numpy() - ref).max()
        err_c = np.abs(want - ref).max()
        assert err_t <= max(4.0 * err_c, 5e-5 * np.abs(ref).max()), (
            name, err_t, err_c)
    # kappa_to_phi / alpha_to_gamma take tensors: on the card, as on the CPU
    kt = torch.from_numpy(g1)
    for fn in (lambda k: TL.kappa_to_phi(k, 0.03),
               lambda k: TL.alpha_to_gamma(k, 0.5 * k, 0.03)[0]):
        got, want = fn(kt.to(cuda)), fn(kt)
        assert got.device.type == "cuda"
        npt_ok = np.allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                             atol=1e-4 * float(want.abs().max()))
        assert npt_ok


def test_cosebis_b_modes_hold_with_tf32_allowed(cuda):
    """With TF32 allowed by the caller, E_n and B_n on the card stay within
    1e-5 of max |E| of a float64 evaluation of the same float32 inputs
    (TF32's 10-bit mantissa would leave ~1e-3 of E in B)."""
    from astrild_tpu_torch.ops import fftlog as TF
    from astrild_tpu_torch.ops import shear_2pt as TS

    ells = np.arange(2.0, 20000.0)
    cl = 1e-8 / (1.0 + (ells / 300.0) ** 2) ** 1.5
    th, xp, xm = TS.xi_pm_from_cl(ells, cl, device="cpu")
    th_am = th.numpy() / (np.pi / 180.0 / 60.0)
    sel = (th_am > 0.3) & (th_am < 300.0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        e, b = TS.cosebis_from_xipm(th_am[sel], xp.numpy()[sel],
                                    xm.numpy()[sel], 5, 1.0, 100.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert e.device.type == "cuda"
    tg, Tp, Tm = TS.linear_cosebis_filters(5, 1.0, 100.0)
    lt = torch.from_numpy(np.log(th_am[sel]).astype(np.float32))
    ltg = torch.from_numpy(np.log(tg).astype(np.float32))
    xpi = TF._interp(ltg, lt, xp[torch.from_numpy(sel)]).double().numpy()
    xmi = TF._interp(ltg, lt, xm[torch.from_numpy(sel)]).double().numpy()
    w = (TS._trap_weights(tg) * tg).astype(np.float32).astype(np.float64)
    tp = Tp.astype(np.float32).astype(np.float64) @ (w * xpi)
    tm = Tm.astype(np.float32).astype(np.float64) @ (w * xmi)
    e64, b64 = 0.5 * (tp + tm), 0.5 * (tp - tm)
    scale = np.abs(e64).max()
    assert np.abs(e.cpu().numpy() - e64).max() < 1e-5 * scale
    assert np.abs(b.cpu().numpy() - b64).max() < 1e-5 * scale


def test_shear_generators_on_the_card(cuda):
    """Random entry points with a CUDA generator: cl_to_flat_map and the
    SkyArray noise / CMB layers land on the card, the same seed gives the
    same map; the sampler's covariance is finite and symmetric."""
    from astrild_tpu_torch.models import SkyArray
    from astrild_tpu_torch.ops import angular_power as TAP
    from astrild_tpu_torch.ops import shear_2pt as TS

    ells = np.concatenate([np.arange(2.0, 3000.0), [3010.0, 40000.0]])
    cl = 1e-8 / (1.0 + (ells / 800.0) ** 2) ** 1.5
    cl[-2:] = 0.0
    gen = lambda: torch.Generator(device=cuda).manual_seed(3)  # noqa: E731
    a = TAP.cl_to_flat_map(gen(), ells, cl, 64, 2.0)
    assert a.device.type == "cuda"
    assert torch.equal(a, TAP.cl_to_flat_map(gen(), ells, cl, 64, 2.0))
    sky = SkyArray.from_array(np.zeros((64, 64), np.float32), 2.0)
    assert sky.device.type == "cuda"
    assert sky.create_cmb(ells, cl, rnd_seed=3).device.type == "cuda"
    assert sky.create_galaxy_shape_noise(0.26, 30.0).device.type == "cuda"
    th, mean, cov, samples = TS.xi_pm_sample_covariance(
        gen(), ells, cl, 32, 1.0, 4, n_real=20, noise_std=1e-3)
    assert cov.device.type == "cuda" and samples.shape == (20, 8)
    assert bool(torch.isfinite(cov).all())
    assert torch.allclose(cov, cov.T)


# ------------------------------------------------------ theory and forecasts
def test_raytrace_holds_with_tf32_allowed(cuda):
    """multiplane_raytrace on seeded planes with TF32 allowed for float32
    matmuls equals the run without: kappa, gamma1, gamma2 and omega within
    1e-6 of their max (the distortion matrix is built from elementwise
    products and sums, so no matmul takes the caller's TF32)."""
    from astrild_tpu_torch.ops import raytrace as TRT

    rng = np.random.default_rng(1)
    planes = torch.from_numpy(
        rng.normal(0, 0.3, (8, 256, 256)).astype(np.float32)).to(cuda)
    args = (planes, np.linspace(300.0, 2400.0, 8), np.full(8, 300.0),
            2700.0, 0.3089, np.deg2rad(5.0))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = TRT.multiplane_raytrace(*args)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = TRT.multiplane_raytrace(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for name in ("kappa", "gamma1", "gamma2", "omega"):
        scale = float(off[name].abs().max())
        assert scale > 0.0, name
        assert float((on[name] - off[name]).abs().max()) <= 1e-6 * scale, \
            name


def test_fisher_matrix_ignores_tf32(cuda):
    """xipm_survey_fisher on the card with TF32 allowed equals the run
    without to 1e-6 of max |F| (the chain, the contraction and the solve
    are float64), and its numpy input lands on the card: F agrees with the
    CPU run to 1e-3 of max |F|."""
    from astrild_tpu_torch.ops import forecast as TFC

    kw = dict(npix=128, opening_angle_deg=5.0, nbins=8,
              theta_min_arcmin=3.0, nell=128, nchi=48, n_fields=10)
    params = {"Om0": 0.3, "sigma8": 0.8}
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = TFC.xipm_survey_fisher(params, **kw)["fisher"]
        torch.backends.cuda.matmul.allow_tf32 = True
        on = TFC.xipm_survey_fisher(params, **kw)["fisher"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    scale = np.abs(off).max()
    assert np.abs(on - off).max() <= 1e-6 * scale
    cpu = TFC.xipm_survey_fisher(params, device="cpu", **kw)["fisher"]
    assert np.abs(off - cpu).max() <= 1e-3 * scale


@pytest.mark.parametrize("ngrid, box", [(64, 1000.0), (256, 4000.0)])
def test_k2_at_the_theory_rsd_shapes(cuda, ngrid, box):
    """K2 CIC counts of a Zel'dovich mock in redshift space at the theory
    path's two RSD shapes (64^3 in 1000 Mpc/h and 2^24 particles onto
    256^3 in 4000 Mpc/h): within 2e-5 of the plain version's largest cell,
    the mass N to rtol 1e-5."""
    from astrild_tpu_torch.ops import mocks as TM
    from astrild_tpu_torch.ops import tpcf as TT

    gen = torch.Generator(device=cuda).manual_seed(14)
    pos, vel = TM.zeldovich_catalog_with_velocities(
        gen, ngrid, box, lambda q: 2e4 * torch.exp(-((q / 0.08) ** 2)),
        0.53, device=cuda)
    pos_s = TT.to_redshift_space(pos, vel, box)
    pf = torch.cat([pos_s[:, a] for a in range(3)])
    got = TPC.paint_windowed(pf, None, ngrid, box, order=2)
    want = TPC.paint_windowed_reference(pf, None, ngrid, box, order=2)
    n = ngrid ** 3
    assert float((got - want).abs().max()) <= 2e-5 * float(want.max())
    assert abs(float(got.double().sum()) - n) <= 1e-5 * n


# ------------------------------------------- map analysis and halo facades
def _tf32_on_and_off(fn):
    """fn() with TF32 refused, then allowed, for float32 matmuls."""
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = fn()
        torch.backends.cuda.matmul.allow_tf32 = True
        on = fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return off, on


@pytest.mark.parametrize("chi_s", [2000.0, [1200.0, 2000.0]])
def test_born_healpix_holds_with_tf32_allowed(cuda, chi_s):
    """born_convergence_healpix with TF32 allowed equals the run without
    to 1e-6 of max |kappa| (the shell weights are summed from elementwise
    products, not by a matmul), for one source and for a batch."""
    rng = np.random.default_rng(2)
    nside = 64
    shells = torch.from_numpy(rng.normal(
        0, 0.5, (6, 12 * nside * nside)).astype(np.float32)).to(cuda)
    chis = np.linspace(300.0, 1800.0, 6)
    off, on = _tf32_on_and_off(lambda: TLS.born_convergence_healpix(
        shells, chis, np.full(6, 250.0), np.asarray(chi_s), 0.3089))
    assert off.shape == ((12 * nside * nside,) if np.ndim(chi_s) == 0
                         else (2, 12 * nside * nside))
    scale = float(off.abs().max())
    assert scale > 0.0
    assert float((on - off).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("site", ["v12", "ksz"])
def test_plain_pair_tiles_hold_with_tf32_allowed(cuda, site):
    """The plain pair tiles (v12's and the kSZ estimator's) with TF32
    allowed equal the runs without to 1e-6 of max |estimate| (their
    direction cosines are elementwise sums, not einsums)."""
    rng = np.random.default_rng(3)
    pos, vel = _clumpy(rng, 3000)
    pos_t = torch.from_numpy(pos + 1000.0).to(cuda)
    bins = np.linspace(0.0, 30.0, 16).astype(np.float32)
    if site == "v12":
        vel_t = torch.from_numpy(vel).to(cuda)
        fn = lambda: TPW.mean_pairwise_velocity(  # noqa: E731
            pos_t, vel_t, bins, backend="plain")[1]
    else:
        dT = torch.from_numpy(vel[:, 0].copy()).to(cuda)
        fn = lambda: TPW.pairwise_ksz_momentum(  # noqa: E731
            pos_t, dT, bins)[1]
    off, on = _tf32_on_and_off(fn)
    fin = torch.isfinite(off)
    assert bool(fin.any()) and torch.equal(fin, torch.isfinite(on))
    scale = float(off[fin].abs().max())
    assert float((on[fin] - off[fin]).abs().max()) <= 1e-6 * scale


def test_halo_and_void_facades_reach_k2_and_k3(cuda):
    """SubFind.power_spectrum (weighted TSC) and
    SphericalVoidFinder3D.from_particles (CIC) paint through K2 on the
    card, Rockstar.mean_pairwise_velocity runs K3, one launch each; numpy
    input lands on the card. Each is held against its plain version on the
    same input: P(k) and delta within 1e-4 of their max, v12 within 1e-4
    relative of the plain pair tiles."""
    from astrild_tpu_torch.models import halos as THM
    from astrild_tpu_torch.models import voids as TVM

    rng = np.random.default_rng(5)
    pos, vel = _clumpy(rng, 20000)
    mass = 10 ** rng.uniform(12.0, 15.0, pos.shape[0])
    snap = {"GroupPos": pos, "Group_M_Crit200": mass}
    before = dict(TPC.LAUNCHES)
    k, p = THM.SubFind.power_spectrum(snap, boxsize=BOX, ngrid=64)
    assert TPC.LAUNCHES["paint_windowed"] == before.get("paint_windowed",
                                                        0) + 1
    kc, pc = THM.SubFind.power_spectrum(snap, boxsize=BOX, ngrid=64,
                                        device="cpu")
    np.testing.assert_allclose(k, kc, rtol=1e-6)
    assert np.abs(p - pc).max() <= 1e-4 * np.abs(pc).max()

    before = dict(TPC.LAUNCHES)
    svf = TVM.SphericalVoidFinder3D.from_particles(pos, 64, BOX)
    assert svf.delta.is_cuda
    assert TPC.LAUNCHES["paint_windowed"] == before.get("paint_windowed",
                                                        0) + 1
    pf = torch.from_numpy(np.ascontiguousarray(pos.T).reshape(-1)).to(cuda)
    grid = TPC.paint_windowed_reference(pf, None, 64, BOX, order=2)
    want = grid / grid.mean() - 1.0
    assert float((svf.delta - want).abs().max()) <= 1e-4 * float(
        want.abs().max())

    cat = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
           "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2]}
    before = dict(TPWC.LAUNCHES)
    r, v12 = THM.Rockstar.mean_pairwise_velocity(cat, boxsize=BOX)
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before.get(
        "pairwise_accumulate", 0) + 1
    pos_t = torch.from_numpy(pos).to(cuda)
    _, plain = TPW.mean_pairwise_velocity(
        pos_t, torch.from_numpy(vel).to(cuda),
        torch.from_numpy(np.linspace(0.0, 50.0, 25).astype(np.float32)).to(
            cuda), backend="plain")
    plain = plain.cpu().numpy()
    fin = np.isfinite(plain)
    np.testing.assert_array_equal(np.isfinite(v12), fin)
    np.testing.assert_allclose(v12[fin], plain[fin], rtol=1e-4,
                               atol=1e-4 * np.abs(plain[fin]).max())


def test_map_analysis_numpy_input_lands_on_the_card(cuda):
    """The sky-map operations and the 2D facades put numpy input on the
    card and agree there with their CPU runs: catalogs and bin decisions
    equal, maps within 1e-4 of their max (cuFFT rounds otherwise)."""
    from astrild_tpu_torch.models import SkyArray, TunnelsFinder, Voids
    from astrild_tpu_torch.ops import aperture_mass as TA
    from astrild_tpu_torch.ops import filters as TF
    from astrild_tpu_torch.ops import minkowski as TM
    from astrild_tpu_torch.ops import profiles as TPR
    from astrild_tpu_torch.ops import troughs as TT

    rng = np.random.default_rng(6)
    n = 128
    e = np.arange(n)
    img = rng.normal(0, 0.01, (n, n)).astype(np.float32)
    for (r, c) in ((32.0, 32.0), (64.0, 96.0), (100.0, 40.0)):
        img += (0.1 * np.exp(-((e[:, None] - r) ** 2 + (e[None, :] - c) ** 2)
                             / 32.0)).astype(np.float32)
    cen = rng.integers(0, n, (30, 2)).astype(np.int32)
    rad = rng.uniform(2.0, 10.0, 30).astype(np.float32)
    maps = {
        "gaussian": lambda **kw: TF.gaussian(img, 10.0, sigma_arcmin=8.0,
                                             **kw),
        "dgd3": lambda **kw: TF.dgd3(img, 10.0, 10.0, **kw),
        "compensated": lambda **kw: TF.gaussian_compensated(
            img, 10.0, 5.0, 15.0, **kw),
        "pca": lambda **kw: TF.pca_foreground_separation(img, 8, 5, **kw),
        "profiles": lambda **kw: TPR.object_profiles(img, cen, rad, 25,
                                                     8, 2.0, **kw)[1],
        "aperture_mass": lambda **kw: TA.aperture_mass_map(img, 10.0, 8.0,
                                                           **kw),
        "trough_profiles": lambda **kw: TT.trough_profiles(
            img, np.array([[2.0, 3.0], [5.0, 5.0]], np.float32), 0.5, 6,
            10.0, **kw)[1],
    }
    for name, fn in maps.items():
        got, want = fn(), fn(device="cpu")
        assert got.is_cuda, name
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want)), name
        fin = ~torch.isnan(want)
        assert float((got[fin] - want[fin]).abs().max()) <= 1e-4 * float(
            want[fin].abs().max()), name
    a = TM.minkowski_functionals(img, nbins=10, limits=(-0.02, 0.08))
    b = TM.minkowski_functionals(img, nbins=10, limits=(-0.02, 0.08),
                                 device="cpu")
    np.testing.assert_array_equal(a["V0"], b["V0"])
    # the void pipeline on the card: the same catalog as on the CPU
    out = []
    for dev in (None, "cpu"):
        sky = SkyArray.from_array(img, 10.0, device=dev)
        sky.smoothing(2.0)
        finder = TunnelsFinder(sky)
        finder.find_peaks(on="orig_smooth")
        finder.find_voids(sigmas=[0.0])
        voids = Voids.from_finder(finder, {"npix": n})
        voids.trim_edges(n)
        prof = voids.get_profiles(2.0, 10, skymap=sky.data["orig"])
        out.append((sky, voids, prof, voids.get_profile_stats(n_boot=30)))
    (gs, gv, gp, gd), (cs, cv, cp, cd) = out
    assert gs.device.type == "cuda"
    for k in cv.data:
        np.testing.assert_allclose(gv.data[k], cv.data[k], rtol=1e-5)
    np.testing.assert_allclose(gp["values"], cp["values"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gd["mean"], cd["mean"], rtol=1e-4, atol=1e-6)
    assert np.all(gd["lowerr"] <= gd["higherr"])
    # the random entry points with CUDA generators
    gen = torch.Generator(device=cuda).manual_seed(1)
    pos, m = TT.find_troughs(img, gen, 200, 0.2, 0.3, 10.0)
    assert pos.is_cuda and bool(torch.isfinite(m).all())
    lo, hi = TPR.bootstrap_profiles(
        torch.from_numpy(rng.normal(2.0, 0.1, (64, 6)).astype(
            np.float32)).to(cuda), cen[:1].repeat(64, 0),
        torch.Generator(device=cuda).manual_seed(2), n_boot=50,
        block_pix=32, npix=128)
    assert lo.is_cuda and bool((lo <= hi).all())


def test_fit_nfw_holds_with_tf32_allowed(cuda):
    """profiles3d.fit_nfw on the card with TF32 allowed for float32 matmuls
    equals the run without bit for bit (its normal equations are sums of
    elementwise products, solved in closed form), and agrees with its CPU
    run to rtol 1e-4."""
    from astrild_tpu_torch.ops import profiles3d as TP3

    rng = np.random.default_rng(4)
    r = np.logspace(-1.5, 0.3, 24).astype(np.float32)
    rs = rng.uniform(0.1, 0.5, 64)
    rhos = 10 ** rng.uniform(13.0, 15.0, 64)
    x = r[None, :] / rs[:, None]
    rho = (rhos[:, None] / (x * (1 + x) ** 2)
           * rng.lognormal(0, 0.05, x.shape)).astype(np.float32)
    args = (torch.from_numpy(r).to(cuda), torch.from_numpy(rho).to(cuda))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = TP3.fit_nfw(*args)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = TP3.fit_nfw(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu = TP3.fit_nfw(torch.from_numpy(r), torch.from_numpy(rho))
    for a, b, c in zip(on, off, cpu):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-4)


def _moving_lens_catalog(n, npix, seed=5):
    rng = np.random.default_rng(seed)
    return {"r200_deg": rng.uniform(0.03, 0.12, n),
            "m200": 10 ** rng.uniform(13.5, 15.0, n),
            "c_NFW": rng.uniform(3.0, 8.0, n),
            "Dc": rng.uniform(500.0, 2000.0, n),
            "theta1_tv": rng.normal(0, 400, n),
            "theta2_tv": rng.normal(0, 400, n),
            "v_los": rng.normal(0, 400, n),
            "m500": 10 ** rng.uniform(13.5, 14.8, n),
            "r500": rng.uniform(0.5, 1.5, n),
            "e_z": rng.uniform(1.0, 1.6, n),
            "theta1_pix": rng.integers(-5, npix + 5, n).astype(float),
            "theta2_pix": rng.integers(-5, npix + 5, n).astype(float),
            "r200_pix": rng.uniform(2.0, 6.0, n)}


@pytest.mark.parametrize("to", ["dT", "alpha", "ksz", "y"])
def test_halo_patch_painting_on_the_card(cuda, to):
    """SkyArray.from_halo_dataframe of 3,000 overlapping halos on a 1024^2
    canvas (patches of 41 pixels, in chunks): numpy columns land on the
    card, and the map agrees with its CPU run to 2e-5 of max (the card's
    atomics add overlapping patches in another order; its transcendental
    functions differ in the last ulp), the halo centres' float32 noise
    pixels (dT, alpha) left out."""
    from astrild_tpu_torch.models import SkyArray

    npix = 1024
    cat = _moving_lens_catalog(3000, npix)
    kw = dict(npix=npix, extent=2.0 if to == "y" else 1.0, direction=(0, 1),
              suppress=False, suppression_R=1.0, to=to, opening_angle=5.0,
              patch_npix=41)
    card = SkyArray.from_halo_dataframe(cat, **kw)
    assert card.device.type == "cuda"
    cpu = SkyArray.from_halo_dataframe(cat, **kw, device="cpu")
    got, want = card.data["orig"].cpu().numpy(), cpu.data["orig"].numpy()
    keep = np.ones((npix, npix), bool)
    if to in ("dT", "alpha"):
        r, c = cat["theta2_pix"].astype(int), cat["theta1_pix"].astype(int)
        inside = (r >= 0) & (r < npix) & (c >= 0) & (c < npix)
        keep[r[inside], c[inside]] = False
    scale = np.abs(want[keep]).max()
    assert scale > 0
    assert np.abs(got - want)[keep].max() <= 2e-5 * scale


def test_batched_dipole_estimators_on_the_card(cuda):
    """Both transverse-velocity estimators on a 512^2 field of 40 moving
    NFW halos: numpy maps land on the card; the velocities agree with the
    CPU run to rtol 1e-4 (the float32 ring and Hann decisions are the
    same on both), and the matched filter recovers isolated halos'
    velocities within 0.35."""
    from astrild_tpu_torch.models import Dipoles, SkyArray

    npix, oa, n = 512, 10.0, 40
    rng = np.random.default_rng(8)
    pix1 = rng.integers(40, npix - 40, n)
    pix2 = rng.integers(40, npix - 40, n)
    halos = {"theta1_pix": pix1.astype(float),
             "theta2_pix": pix2.astype(float),
             "theta1_deg": pix1 * oa / npix, "theta2_deg": pix2 * oa / npix,
             "r200_deg": rng.uniform(0.08, 0.2, n),
             "m200": 10 ** rng.uniform(14.3, 15.0, n),
             "c_NFW": rng.uniform(3.0, 5.0, n), "Dc": np.full(n, 1000.0),
             "theta1_tv": rng.normal(0, 400, n),
             "theta2_tv": rng.normal(0, 400, n)}
    halos["r200_pix"] = halos["r200_deg"] * npix / oa
    halos["theta1_vel"] = halos["theta1_tv"]
    halos["theta2_vel"] = halos["theta2_tv"]
    kw = dict(npix=npix, extent=5.0, suppress=False, suppression_R=1.0,
              opening_angle=oa, patch_npix=101)
    maps = [SkyArray.from_halo_dataframe(halos, direction=d, to=t, **kw,
                                         device="cpu").data["orig"].numpy()
            for d, t in (((0, 1), "dT"), ((0,), "alpha"), ((1,), "alpha"))]
    out = {}
    for dev in ("cuda", "cpu"):
        sky = SkyArray.from_array(maps[0], oa, "isw_rs",
                                  device=None if dev == "cuda" else "cpu")
        assert sky.device.type == dev
        dips = Dipoles.from_sky(sky, snr_threshold=1.0, edge_pix=4)
        dips.find_nearest(halos)
        kwd = {} if dev == "cuda" else {"device": "cpu"}
        dips.get_transverse_velocities_from_sky(*maps, oa, patch_pix=40,
                                                **kwd)
        dips.get_transverse_velocities_reference_mode(*maps, oa, **kwd)
        out[dev] = dips.data
    for k in ("theta1_mtvel", "theta2_mtvel", "theta1_mtvel_ref",
              "theta2_mtvel_ref"):
        ok = out["cpu"][k] > -99999
        np.testing.assert_array_equal(out["cuda"][k] > -99999, ok)
        assert ok.sum() >= 5, k
        np.testing.assert_allclose(out["cuda"][k][ok], out["cpu"][k][ok],
                                   rtol=1e-4)


def test_moving_lens_numpy_input_lands_on_the_card(cuda):
    """Each new entry point of the moving-lens, SZ and ISW path, given
    numpy input and no device, computes on the card; its result agrees
    with the CPU run (rtol 1e-4 of max)."""
    from astrild_tpu_torch.models import Bispectrum2D
    from astrild_tpu_torch.ops import angular_power as TAP
    from astrild_tpu_torch.ops import bispectrum as TB
    from astrild_tpu_torch.ops import lensing as TL
    from astrild_tpu_torch.ops import linear_power as TLPW
    from astrild_tpu_torch.ops import strong_lensing as TS
    from astrild_tpu_torch.ops import sz as TZ

    rng = np.random.default_rng(9)
    img = rng.normal(size=(64, 64)).astype(np.float32)
    pos = rng.uniform(0, 10.0, (500, 2)).astype(np.float32)
    w = rng.uniform(1, 2, 500).astype(np.float32)
    c = np.linspace(-1, 1, 33).astype(np.float32)
    x1, x2 = np.meshgrid(c, c, indexing="ij")
    cosmo = Cosmology()
    calls = {
        "nfw_deflection_angle_map": lambda **d: TL.nfw_deflection_angle_map(
            0.08, 3e14, 4.0, 900.0, npix=33, **d),
        "nfw_temperature_perturbation_map": lambda **d:
            TL.nfw_temperature_perturbation_map(0.08, 3e14, 4.0,
                                                np.array([300.0, -100.0]),
                                                900.0, npix=33, **d),
        "nfw_dipole_patch": lambda **d: TL.nfw_dipole_patch(
            1e15, [1000.0, 0.0], 0.3, npix=32, **d),
        "nfw_sigma_map": lambda **d: TZ.nfw_sigma_map(1e15, 5.0, 2.0,
                                                      npix=32, **d),
        "ksz_patch_from_halo": lambda **d: TZ.ksz_patch_from_halo(
            3e14, 6.0, 1.2, 300.0, npix=32, **d),
        "compton_y_patch": lambda **d: TZ.compton_y_patch(
            5e14, 1.3, 1.0, npix=32, **d),
        "stacked_aperture_photometry": lambda **d:
            TZ.stacked_aperture_photometry(img, np.array([[20, 30]]), 2.0,
                                           4.0, 8, **d)[0],
        "m500c_from_m200m": lambda **d: TZ.m500c_from_m200m(
            np.array([1e14, 1e15]), 0.3, cosmo, **d)[0],
        "y_ell": lambda **d: TZ.y_ell(np.array([100.0, 1000.0]), 5e14, 1.3,
                                      1.0, 1000.0, **d),
        "cl_yy": lambda **d: TZ.cl_yy(np.array([300.0, 3000.0]), cosmo,
                                      nz=4, nm=8, **d),
        "sph_surface_density": lambda **d: TS.sph_surface_density(
            pos, w, w, 32, 10.0, **d),
        "remap_image": lambda **d: TS.remap_image(img, x1 * 20 + 30,
                                                  x2 * 20 + 30, **d),
        "shear_from_potential": lambda **d: TS.shear_from_potential(
            img, 1.0, **d)[1],
        "mapping_triangles": lambda **d: TS.mapping_triangles(
            np.array([0.1, -0.2], np.float32), x1, x2, x1, x2, **d)[0],
        "fermat_potential": lambda **d: TS.fermat_potential(
            img, 1e-4, np.array([5e-5, 5e-5]), **d),
        "p_dpdp": lambda **d: TLPW.p_dpdp(np.logspace(-2, 0, 8), 0.5,
                                          cosmo, **d),
        "cl_isw_limber": lambda **d: TAP.cl_isw_limber(
            np.array([10.0, 100.0]), cosmo, **d),
        "bispectrum_2d_equilateral": lambda **d:
            TB.bispectrum_2d_equilateral(img, 5.0, nbins=4, **d)[1],
    }
    for name, fn in calls.items():
        got = fn()
        assert got.device.type == "cuda", name
        want = fn(device="cpu").numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    ell, b, _ = Bispectrum2D.compute(img, 5.0, nbins=4)
    np.testing.assert_allclose(b, Bispectrum2D.compute(
        img, 5.0, nbins=4, device="cpu")[1], rtol=1e-4)


# ------------------------------------- MG growth, MASTER, HMC, analysis
def _master_inputs(n, oa, seed):
    """A seeded map, shear pair and edge-and-holes mask of side n."""
    from astrild_tpu_torch.ops import angular_power as TA

    rng = np.random.default_rng(seed)
    ell = np.linspace(1.0, 40000.0, 2048)
    cl = 1.0 / (ell * (ell + 1.0))
    gen = torch.Generator().manual_seed(seed)
    img = TA.cl_to_flat_map(gen, ell, cl, n, oa, device="cpu")
    g1, g2 = TA.kappa_to_shear_maps(img)
    mask = np.ones((n, n), np.float32)
    mask[:, : 30 * n // 128] = 0.0
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    for cy, cx in rng.uniform(0, n, (16, 2)):
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < (n / 64) ** 2] = 0.0
    return img, g1, g2, mask


def test_master_couplings_on_the_card_match_the_cpu(cuda):
    """At 256^2 over 10 deg, 12 bands: the card's float64 couplings
    (scalar and spin-2) within 1e-10 of the CPU's numpy build's max; the
    three masked spectra on the card within 1e-5 of their CPU runs; the
    spectra of numpy maps land on the card."""
    from astrild_tpu_torch.ops import angular_power as TA

    img, g1, g2, mask = _master_inputs(256, 10.0, 3)
    mc = torch.from_numpy(mask.astype(np.float64)).to(cuda)
    want = TA.flat_sky_coupling_matrix(mask, 10.0, 12)
    got = TA.flat_sky_coupling_matrix(mc, 10.0, 12)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    want2 = TA.flat_sky_spin2_coupling_matrices(mask, 10.0, 12)
    got2 = TA.flat_sky_spin2_coupling_matrices(mc, 10.0, 12)
    for g, w in zip(got2, want2):
        assert np.abs(g - w).max() <= 1e-10 * np.abs(want2[0]).max()
    for fn, args in (("cl_flat_sky_masked", (img, mask)),
                     ("cl_flat_sky_master", (img, mask)),
                     ("cl_flat_sky_shear_master", (g1, g2, mask))):
        cpu = getattr(TA, fn)(*args, 10.0, nbins=12)
        card = getattr(TA, fn)(*[a.numpy() if isinstance(a, torch.Tensor)
                                 else a for a in args], 10.0, nbins=12)
        for c, w in zip(card, cpu):
            assert c.device.type == "cuda"
            scale = float(w.abs().max())
            assert float((c.cpu() - w).abs().max()) <= 1e-5 * scale, fn


def test_skynamaster_on_the_card(cuda):
    """The facade with its default device: the coupling is built on the
    card, cached, and the spectra equal the CPU facade's within 1e-5."""
    from astrild_tpu_torch.models import SkyNamaster

    img, g1, g2, mask = _master_inputs(128, 10.0, 4)
    out = {}
    for dev in (None, "cpu"):
        sn = SkyNamaster.from_array(img.numpy(), opening_angle=10.0,
                                    device=dev)
        sn.set_mask(mask)
        out[dev] = (sn.compute_cl(nbins=8)[1], sn.compute_cl(nbins=8)[1],
                    sn.compute_cl_spin2(g1.numpy(), g2.numpy(),
                                        nbins=8)[1])
        assert set(sn._workspace) == {("flat", 8), ("flat-spin2", 8)}
    assert out[None][0].device.type == "cuda"
    # the band sums are float atomics on the card: the cached second call
    # agrees to rounding
    assert float((out[None][0] - out[None][1]).abs().max()) <= 1e-6 * float(
        out[None][0].abs().max())
    for c, w in zip(out[None], out["cpu"]):
        assert float((c.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


def test_fofr_growth_on_the_card(cuda):
    """fofr_pk_enhancement and growth_factor_k: the float route returns
    float32 on the card, equal to its CPU placement; the traced route
    (tensor fR0) on the card within 1e-10 of the same on the CPU, and its
    jacfwd in fR0 within 1e-8 of its max."""
    k = np.geomspace(1e-4, 10.0, 256).astype(np.float32)
    c = Cosmology(fR0=1e-5)
    card = c.fofr_pk_enhancement(k)
    assert card.device.type == "cuda" and card.dtype == torch.float32
    assert torch.equal(card.cpu(), c.fofr_pk_enhancement(k, device="cpu"))
    kt = torch.from_numpy(k).to(cuda)
    assert c.growth_factor_k(kt, 1.0).device.type == "cuda"

    def traced(dev):
        def fn(x):
            return Cosmology(fR0=x).fofr_pk_enhancement(k, 1.0)
        x = torch.tensor(1e-5, dtype=torch.float64, device=dev)
        return fn(x), torch.func.jacfwd(fn)(x)

    (v_gpu, j_gpu), (v_cpu, j_cpu) = traced(cuda), traced("cpu")
    assert v_gpu.device.type == "cuda"
    assert float((v_gpu.cpu() - v_cpu).abs().max()) <= 1e-10
    assert float((j_gpu.cpu() - j_cpu).abs().max()) <= 1e-8 * float(
        j_cpu.abs().max())


def test_hmc_on_the_card(cuda):
    """hmc_sample from a CUDA generator on a correlated Gaussian: mean
    within 0.1, covariance within 0.12, acceptance in (0.6, 1]; a
    fixed-step chain from given draws on the card takes the CPU run's
    accept decisions and stays within 1e-4 of it."""
    from astrild_tpu_torch.ops import inference as TI

    icov = torch.linalg.inv(torch.tensor([[1.0, 0.6], [0.6, 1.0]]))

    def logp_on(dev):
        a = icov.to(dev)
        return lambda x: -0.5 * torch.sum(x * (a * x[None, :]).sum(1))

    res = TI.hmc_sample(torch.Generator(device=cuda).manual_seed(0),
                        logp_on(cuda), torch.zeros(2, device=cuda),
                        n_samples=2000, n_warmup=500, n_leapfrog=12,
                        step_size=0.3)
    s = res.samples.cpu().numpy()
    assert res.samples.device.type == "cuda"
    assert 0.6 < float(res.accept_rate) <= 1.0
    assert np.abs(s.mean(0)).max() < 0.1
    assert np.abs(np.cov(s.T) - [[1.0, 0.6], [0.6, 1.0]]).max() < 0.12
    gen = torch.Generator().manual_seed(1)
    n, u = torch.randn(300, 2, generator=gen), torch.rand(300, generator=gen)
    runs = [TI.hmc_sample_from_draws(n.to(d), u.to(d), logp_on(d),
                                     torch.full((2,), 0.5, device=d),
                                     n_samples=300, n_warmup=0,
                                     n_leapfrog=12, step_size=0.9)
            for d in (cuda, "cpu")]
    a, b = (r.samples.cpu().numpy() for r in runs)
    moved = [np.any(np.diff(np.concatenate([[[0.5, 0.5]], x]), axis=0) != 0,
                    axis=1) for x in (a, b)]
    assert np.array_equal(*moved) and np.abs(a - b).max() < 1e-4


def test_analysis_fits_hold_with_tf32_allowed(cuda):
    """least_squares_fit, pca, covariance_from_realizations,
    nonlinear_least_squares, the MASTER coupling and the shear
    log-posterior on the card with TF32 allowed for float32 matmuls equal
    the runs without to 1e-12 of their max (they compute in float64 or
    from elementwise products: TF32 would move them by ~1e-3; the
    coupling's band sums are float64 atomics, equal to rounding), and
    agree with their CPU runs to 1e-5."""
    from astrild_tpu_torch.ops import angular_power as TA
    from astrild_tpu_torch.ops import inference as TI
    from astrild_tpu_torch.ops.forecast import tomographic_shear_cls
    from astrild_tpu_torch.utils import analysis as TAN

    rng = np.random.default_rng(5)
    x = np.linspace(0, 10, 200).astype(np.float32)
    y = (2 * x + 1 + 0.05 * x ** 2 + rng.normal(0, 0.1, 200)).astype(
        np.float32)
    d = (rng.normal(size=(400, 1)) * np.array([[3.0, 1.0, 0.5]])
         + rng.normal(size=(400, 3)) * 0.1).astype(np.float32)
    r = np.geomspace(0.05, 3.0, 40).astype(np.float32)
    prof = np.log(2.5) - np.log(r / 0.4) - 2 * np.log(1 + r / 0.4)
    _, _, _, mask = _master_inputs(128, 10.0, 6)
    ells = np.geomspace(100, 800, 5).astype(np.float32)
    stack = tomographic_shear_cls(ells, Cosmology(), [0.8, 1.2], nchi=32,
                                  device=cuda)
    logp, _ = TI.shear_log_posterior(ells, stack, [0.8, 1.2],
                                     ["Om0", "sigma8"], nchi=32)

    def nfw(rr, p):
        xx = rr / p[1]
        return torch.log(p[0]) - torch.log(xx) - 2.0 * torch.log(1.0 + xx)

    def run(dev):
        return [TAN.least_squares_fit(x, y, 2, device=dev),
                TAN.pca(d, 2, device=dev)[1],
                TAN.covariance_from_realizations(d, True, device=dev),
                torch.as_tensor(TAN.nonlinear_least_squares(
                    nfw, r, prof, [1.0, 1.0], device=dev)[0]),
                torch.as_tensor(TA.flat_sky_coupling_matrix(
                    torch.from_numpy(mask.astype(np.float64)).to(dev),
                    10.0, 8))]

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = run(cuda) + [logp(torch.tensor([0.31, 0.8], device=cuda))]
        torch.backends.cuda.matmul.allow_tf32 = True
        on = run(cuda) + [logp(torch.tensor([0.31, 0.8], device=cuda))]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(on, off):
        a, b = a.cpu().double(), b.cpu().double()
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    for a, b in zip(off, run("cpu")):
        b = b.cpu().double()
        assert float((a.cpu().double() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())


def test_new_entry_points_put_numpy_on_the_card(cuda):
    """Numpy input to the slice's entry points lands on the card:
    lognormal_map_from_white, bootstrap_statistic_from_draws, percentiles,
    pca, the posterior's data, hmc_sample_from_draws's start."""
    from astrild_tpu_torch.ops import mocks as TM
    from astrild_tpu_torch.utils import analysis as TAN

    rng = np.random.default_rng(2)
    w = rng.standard_normal((2, 64, 64)).astype(np.float32)
    ell = np.geomspace(30.0, 20000.0, 64)
    m = TM.lognormal_map_from_white(w[0], w[1], 64, 10.0, ell,
                                    1e-6 * (ell / 1000.0) ** -2)
    v = rng.normal(size=(100, 2)).astype(np.float32)
    outs = [m, TAN.bootstrap_statistic_from_draws(
        v, rng.integers(0, 100, (20, 100)))[0], TAN.percentiles(v),
        TAN.pca(v)[0]]
    assert all(o.device.type == "cuda" for o in outs)


# ------------------------------------------------- spherical harmonics
def _sht_inputs(nside, lmax, seed=0):
    """A map pair and E/B alm sets (float32, [l, m], zero above the
    triangle, below l = 2 for the spin-2 ones)."""
    rng = np.random.default_rng(seed)
    npix = 12 * nside * nside
    lg = np.arange(lmax + 1)[:, None]
    mg = np.arange(lmax + 1)[None, :]

    def alms(lmin):
        valid = (mg <= lg) & (lg >= lmin)
        re = (rng.standard_normal((lmax + 1,) * 2) * valid).astype(np.float32)
        im = (rng.standard_normal((lmax + 1,) * 2) * valid
              * (mg > 0)).astype(np.float32)
        return re, im

    maps = tuple(rng.standard_normal(npix).astype(np.float32)
                 for _ in range(2))
    return maps, alms(0), alms(2) + alms(2)


def _sht_runs(dev, nside, lmax, maps, scalar, spin):
    """Every transform of both backends on `dev` (numpy input placed
    there): synthesis and Jacobi analysis (niter 3), scalar and spin-2."""
    from astrild_tpu_torch.ops import sht, sht_large, sht_spin, sht_spin_large

    out = []
    if lmax <= 2 * nside:
        out += [sht.synthesize(*scalar, nside, lmax, device=dev),
                *sht.analyze(maps[0], nside, lmax, device=dev),
                *sht_spin.synthesize_spin2(*spin, nside, lmax, device=dev),
                *sht_spin.analyze_spin2(*maps, nside, lmax, device=dev)]
    out += [sht_large.synthesize_large(*scalar, nside, lmax, device=dev),
            *sht_large.analyze_large(maps[0], nside, lmax, device=dev),
            *sht_spin_large.synthesize_spin2_large(*spin, nside, lmax,
                                                   device=dev),
            *sht_spin_large.analyze_spin2_large(*maps, nside, lmax,
                                                device=dev)]
    return out


@pytest.mark.parametrize("lmax", [128, 191])
def test_sht_transforms_on_the_card_match_the_cpu(cuda, lmax):
    """At nside 64: the table and scan paths (lmax 128), and the scan
    path's alias fold and CG analysis (lmax 191, method 'auto'), scalar
    and spin-2, on the card within 1e-5 of the CPU's max."""
    nside = 64
    maps, scalar, spin = _sht_inputs(nside, lmax)
    card = _sht_runs(cuda, nside, lmax, maps, scalar, spin)
    cpu = _sht_runs("cpu", nside, lmax, maps, scalar, spin)
    assert len(card) == (18 if lmax <= 2 * nside else 9)
    for c, w in zip(card, cpu):
        assert c.device.type == "cuda"
        scale = float(w.abs().max())
        assert float((c.cpu() - w).abs().max()) <= 1e-5 * scale


def test_analyze_large_cg_on_the_card_matches_the_cpu(cuda):
    """method='cg' at lmax = 3 nside - 1, scalar and spin-2, niter 3: the
    stopping rule stays on the card; alms within 1e-5 of the CPU's max."""
    from astrild_tpu_torch.ops import sht_large, sht_spin_large

    nside, lmax = 64, 191
    maps, _, _ = _sht_inputs(nside, lmax, seed=1)
    card = (*sht_large.analyze_large(maps[0], nside, lmax, method="cg"),
            *sht_spin_large.analyze_spin2_large(*maps, nside, lmax,
                                                method="cg"))
    cpu = (*sht_large.analyze_large(maps[0], nside, lmax, method="cg",
                                    device="cpu"),
           *sht_spin_large.analyze_spin2_large(*maps, nside, lmax,
                                               method="cg", device="cpu"))
    for c, w in zip(card, cpu):
        assert c.device.type == "cuda"
        assert float((c.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


def test_sht_transforms_hold_with_tf32_allowed(cuda):
    """Every transform on both backends with TF32 allowed for float32
    matmuls equals the run without: no contraction reaches a matrix
    product (TF32 would move them by ~1e-3)."""
    nside, lmax = 64, 128
    maps, scalar, spin = _sht_inputs(nside, lmax, seed=2)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = _sht_runs(cuda, nside, lmax, maps, scalar, spin)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = _sht_runs(cuda, nside, lmax, maps, scalar, spin)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_skyhealpix_and_full_sky_master_on_the_card(cuda):
    """SkyHealpix of a numpy map lands on the card; anafast, the shear
    layers, their E/B spectra and a rotation equal the CPU facade's within
    1e-5 of their max; SkyNamaster's full-sky compute_cl (cached coupling)
    and compute_cl_spin2 on the card within 1e-5 of the CPU's."""
    from astrild_tpu_torch.models import SkyHealpix, SkyNamaster
    from astrild_tpu_torch.utils import healpix as TH

    nside, lmax = 32, 64
    maps, _, _ = _sht_inputs(nside, lmax, seed=3)
    th, _ = TH.pix2ang_ring(nside, np.arange(12 * nside * nside))
    mask = (np.abs(th - np.pi / 2) > 0.35).astype(np.float64)
    out = {}
    for dev in (None, "cpu"):
        sky = SkyHealpix(maps[0], device=dev)
        assert sky.device.type == ("cuda" if dev is None else "cpu")
        res = [sky.anafast(lmax), *sky.shear_from_kappa(lmax=lmax),
               *sky.shear_eb_spectra(lmax=lmax)[:1],
               sky.rotate((10.0, 20.0, 5.0))]
        sn = SkyNamaster.from_array(maps[0], device=dev)
        sn.set_mask(mask)
        first = sn.compute_cl(lmax=lmax, nbins=8)[1]
        res += [first.cpu().numpy(),
                sn.compute_cl(lmax=lmax, nbins=8)[1].cpu().numpy()]
        res += [c.cpu().numpy() for c in sn.compute_cl_spin2(
            *maps, lmax=lmax, nbins=8)[1:]]
        out[dev] = res
    for c, w in zip(out[None], out["cpu"]):
        assert np.abs(c - w).max() <= 1e-5 * np.abs(w).max()


# ------------------------------------------- spin-1, the stencil, CMB lensing
def _spin1_inputs(nside, lmax, seed=0):
    rng = np.random.default_rng(seed)
    npix = 12 * nside * nside
    lg, mg = np.arange(lmax + 1)[:, None], np.arange(lmax + 1)[None, :]
    alms = tuple((rng.standard_normal((lmax + 1,) * 2) * (mg <= lg)
                  * (lg >= 1) * ((mg > 0) | (k % 2 == 0))).astype(np.float32)
                 for k in range(4))
    maps = tuple(rng.standard_normal(npix).astype(np.float32)
                 for _ in range(2))
    return alms, maps


def _spin1_runs(dev, nside, lmax, alms, maps):
    """Every spin-1 transform of both backends on `dev` (numpy in)."""
    from astrild_tpu_torch.ops import sht_spin, sht_spin_large

    out = []
    if lmax <= 2 * nside:
        out += [*sht_spin.synthesize_spin1(*alms, nside, lmax, device=dev),
                *sht_spin.analyze_spin1(*maps, nside, lmax, device=dev),
                *sht_spin.deflection_from_kappa_alm(alms[0], alms[1], nside,
                                                    lmax, device=dev),
                *sht_spin.kappa_omega_alm_from_deflection(
                    *maps, nside, lmax, device=dev)]
    out += [*sht_spin_large.synthesize_spin1_large(*alms, nside, lmax,
                                                   device=dev),
            *sht_spin_large.analyze_spin1_large(*maps, nside, lmax,
                                                device=dev),
            *sht_spin_large.deflection_from_kappa_alm_large(
                alms[0], alms[1], nside, lmax, device=dev)]
    return out


@pytest.mark.parametrize("lmax", [128, 191])
def test_spin1_transforms_on_the_card_match_the_cpu(cuda, lmax):
    """At nside 64: the spin-1 transforms of the table and scan paths
    (lmax 128), and the scan path's alias fold and CG analysis (lmax 191,
    method 'auto'), on the card within 2e-5 of the CPU's max."""
    nside = 64
    alms, maps = _spin1_inputs(nside, lmax)
    card = _spin1_runs(cuda, nside, lmax, alms, maps)
    cpu = _spin1_runs("cpu", nside, lmax, alms, maps)
    assert len(card) == (20 if lmax <= 2 * nside else 8)
    for c, w in zip(card, cpu):
        assert c.device.type == "cuda"
        assert float((c.cpu() - w).abs().max()) <= 2e-5 * float(
            w.abs().max())


def _stencil_runs(dev, nside, theta, phi, hmap, a_t, a_p):
    from astrild_tpu_torch.utils import healpix_torch as hpt

    pix, wgt = hpt.get_interp_weights(nside, theta, phi, device=dev)
    th, ph = hpt.pix2ang_ring(nside, np.arange(12 * nside * nside),
                              device=dev)
    return (pix, wgt, th, ph,
            hpt.ang2pix_ring(nside, theta, phi, device=dev),
            hpt.get_interp_val(hmap, theta, phi, device=dev),
            hpt.remap_by_deflection(hmap, a_t, a_p, nside, device=dev))


def test_stencil_and_remap_on_the_card_match_the_cpu(cuda):
    """The tensor HEALPix routines at nside 256 on the card against the
    CPU: >= 99.9% of the stencils, ang2pix pixels and remap samples equal
    (a float32 decision can flip a neighbour), pix2ang within 4 ulp."""
    nside = 256
    rng = np.random.default_rng(4)
    theta = np.arccos(rng.uniform(-1, 1, 1 << 18)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, 1 << 18).astype(np.float32)
    npix = 12 * nside * nside
    hmap = rng.standard_normal(npix).astype(np.float32)
    a_t = (1e-3 * rng.standard_normal(npix)).astype(np.float32)
    a_p = (1e-3 * rng.standard_normal(npix)).astype(np.float32)
    card = _stencil_runs(cuda, nside, theta, phi, hmap, a_t, a_p)
    cpu = _stencil_runs("cpu", nside, theta, phi, hmap, a_t, a_p)
    assert all(c.device.type == "cuda" for c in card)
    card = [c.cpu() for c in card]
    same = (card[0] == cpu[0]).all(0)
    assert float(same.double().mean()) >= 0.999
    assert float((card[1] - cpu[1])[:, same].abs().max()) <= 2e-4
    np.testing.assert_array_max_ulp(card[2].numpy(), cpu[2].numpy(),
                                    maxulp=4)
    np.testing.assert_array_max_ulp(card[3].numpy(), cpu[3].numpy(),
                                    maxulp=4)
    assert float((card[4] == cpu[4]).double().mean()) >= 0.999
    for c, w in zip(card[5:], cpu[5:]):
        assert float(((c - w).abs() < 2e-3 * float(w.abs().max()))
                     .double().mean()) >= 0.999


def _tracer_runs(dev, delta, chis, dchis):
    out = TLS.multiplane_raytrace_healpix(delta, chis, dchis, 900.0, 0.3,
                                          method="tables", device=dev)
    scan = TLS.multiplane_raytrace_healpix(
        delta, chis, dchis, np.array([450.0, 900.0], np.float32), 0.3,
        method="scan", device=dev)
    return [out[k] for k in ("kappa", "gamma1", "gamma2", "omega")] + [
        scan[k] for k in ("kappa", "gamma1", "gamma2", "omega")]


def test_multiplane_tracer_on_the_card_matches_the_cpu(cuda):
    """The spherical ray trace at nside 32 (3 shells, the table path for
    one source, the scan path for a tomographic pair) on the card against
    the CPU within 5e-7 absolute: the maps are differences of float32
    distortions near 1."""
    rng = np.random.default_rng(5)
    nside = 32
    delta = rng.normal(0, 0.3, (3, 12 * nside ** 2)).astype(np.float32)
    chis = np.array([300.0, 500.0, 700.0], np.float32)
    dchis = np.full(3, 100.0, np.float32)
    card = _tracer_runs(None, delta, chis, dchis)
    cpu = _tracer_runs("cpu", delta, chis, dchis)
    for c, w in zip(card, cpu):
        assert c.device.type == "cuda"
        assert float((c.cpu() - w).abs().max()) <= 5e-7


def _qe_runs(dev, t, q, u, cmb, cl_flat, cl_hp):
    from astrild_tpu_torch.ops import cmb_lensing as cml

    fov = np.deg2rad(10.0)
    R = cml.qe_tt_response(128, fov, cl_flat, lmin=40, lmax_filter=1200,
                           device=dev)
    tt = cml.qe_tt_kappa(t, fov, cl_flat, lmin=40, lmax_filter=1200,
                         device=dev)
    eb = cml.qe_eb_kappa(q, u, fov, cl_flat, nl_bb=np.full(
        cl_flat.size, 1e-13), lmin=40, lmax_filter=600, device=dev)
    lensed = cml.lens_cmb_map_flat(t, 1e-3 * t / np.abs(t).max(), fov,
                                   device=dev)
    hp = {m: cml.qe_tt_kappa_healpix(cmb, cl_hp, lmin=8, lmax_filter=64,
                                     lmax_out=32, method=m, device=dev)
          for m in ("tables", "scan")}
    return R, tt, eb, lensed, hp


def test_quadratic_estimators_on_the_card_match_the_cpu(cuda):
    """Both flat QEs (on the modes each one's response supports, R above
    1e-2 of its max), the flat remap and the curved-sky TT QE on both
    backends at nside 32 on the card against the CPU: within 1e-4 of the
    largest supported mode or alm; the TT N0 within 1e-4 relative, the EB
    N0 within 5e-4, since its response is 1/2 - (cos4 cos4 + sin4 sin4)/2
    of three FFT convolutions that cancel where the pair angle is small,
    which raises cuFFT's and the CPU FFT's ~1e-7 difference more."""
    rng = np.random.default_rng(6)
    t, q, u = (rng.standard_normal((128, 128)).astype(np.float32)
               for _ in range(3))
    ell = np.arange(3001, dtype=np.float64)
    cl_flat = np.zeros(3001)
    cl_flat[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1))
    cl_hp = cl_flat[:65]
    cmb = rng.standard_normal(12 * 32 ** 2).astype(np.float32)
    from astrild_tpu_torch.ops import cmb_lensing as cml

    card = _qe_runs(None, t, q, u, cmb, cl_flat, cl_hp)
    cpu = _qe_runs("cpu", t, q, u, cmb, cl_flat, cl_hp)
    # modes with R above 1e-2 of its max: cuFFT and the CPU FFT differ by
    # ~1e-7, which phi_un / R raises by R_max / R
    ok = (cpu[0] > 1e-2 * cpu[0].max()).numpy()
    assert float((card[0].cpu() - cpu[0]).abs().max()) <= 1e-5 * float(
        cpu[0].abs().max())
    # the EB response of its filters (white band B filter of nl_bb)
    lx, ly, lm = cml._l_grids(128, torch.tensor(np.deg2rad(10.0),
                                                dtype=torch.float32))
    cos2, sin2 = cml._trig2(128, "cpu")
    C = cml._interp_cl(torch.from_numpy(cl_flat.astype(np.float32)), lm)
    band = (lm >= 40) & (lm <= 600)
    FE = torch.where(band & (C > 0), 1.0 / torch.where(C > 0, C, 1.0), 0.0)
    FB = torch.where(band, 1e13, 0.0)
    R_eb = cml._eb_quad_sum(128, lx, ly, C, FE, FB, cos2, sin2)
    ok_eb = (R_eb > 1e-2 * R_eb.max()).numpy()
    for (c, w), mask in (((card[1], cpu[1]), ok), ((card[2], cpu[2]), ok_eb)):
        fc = np.fft.fft2(c[0].cpu().numpy().astype(np.float64))
        fw = np.fft.fft2(w[0].numpy().astype(np.float64))
        assert np.abs(fc - fw)[mask].max() <= 1e-4 * np.abs(fw[mask]).max()
    np.testing.assert_allclose(card[1][1].cpu().numpy()[ok],
                               cpu[1][1].numpy()[ok], rtol=1e-4)
    np.testing.assert_allclose(card[2][1].cpu().numpy()[ok_eb],
                               cpu[2][1].numpy()[ok_eb], rtol=5e-4)
    assert float((card[3].cpu() - cpu[3]).abs().max()) <= 1e-5 * float(
        cpu[3].abs().max())
    for m in ("tables", "scan"):
        scale = float(cpu[4][m][0].abs().max())
        for c, w in zip(card[4][m][:2], cpu[4][m][:2]):
            assert c.device.type == "cuda"
            assert float((c.cpu() - w).abs().max()) <= 1e-4 * scale
        np.testing.assert_array_equal(card[4][m][2].cpu().numpy(),
                                      cpu[4][m][2].numpy())


def test_skyhealpix_cmb_lensing_on_the_card_matches_the_cpu(cuda):
    """lens_cmb_from_kappa at lmax 2 nside (the plain adjoint) and above
    (the scan path's CG), lens_cmb_by_deflection and
    from_multiplane_shells at nside 32 on the card against the CPU."""
    from astrild_tpu_torch.models import SkyHealpix

    rng = np.random.default_rng(7)
    nside = 32
    npix = 12 * nside ** 2
    cmb = 2.7255 + 1e-5 * rng.standard_normal(npix)
    kap = (1e-2 * rng.standard_normal(npix)).astype(np.float32)
    shells = rng.normal(0, 0.3, (2, npix)).astype(np.float32)
    out = {}
    for dev in (None, "cpu"):
        sky = SkyHealpix(np.zeros(npix), device=dev)
        res = [sky.lens_cmb_from_kappa(cmb, kap, lmax=64),
               sky.lens_cmb_from_kappa(cmb, kap, lmax=80)]
        ms = SkyHealpix.from_multiplane_shells(
            shells, np.array([300.0, 600.0]), np.array([150.0, 150.0]),
            800.0, 0.3, lmax=64, device=dev)
        assert ms.device.type == ("cuda" if dev is None else "cpu")
        res += [ms.data[k].cpu().numpy() for k in ("orig", "omega")]
        out[dev] = res
    fluct = np.abs(cmb - cmb.mean()).max()
    for c, w in zip(out[None][:2], out["cpu"][:2]):
        assert np.quantile(np.abs(c - w), 0.999) <= 1e-4 * fluct
    for c, w in zip(out[None][2:], out["cpu"][2:]):
        assert np.abs(c - w).max() <= 5e-7


def test_cmb_lensing_paths_hold_with_tf32_allowed(cuda):
    """Every new path with TF32 allowed for float32 matmuls equals the run
    without: the spin-1 transforms, the tracer, the remap and the QEs
    reach no matrix product."""
    rng = np.random.default_rng(8)
    nside, lmax = 32, 64
    alms, maps = _spin1_inputs(nside, lmax, seed=8)
    delta = rng.normal(0, 0.3, (2, 12 * nside ** 2)).astype(np.float32)
    chis = np.array([300.0, 600.0], np.float32)
    dchis = np.full(2, 150.0, np.float32)
    t = rng.standard_normal((128, 128)).astype(np.float32)
    ell = np.arange(3001, dtype=np.float64)
    cl = np.zeros(3001)
    cl[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1))

    def runs():
        from astrild_tpu_torch.models import SkyHealpix
        from astrild_tpu_torch.ops import cmb_lensing as cml

        out = _spin1_runs(cuda, nside, lmax, alms, maps)
        out += _tracer_runs(None, delta, chis, dchis)
        sky = SkyHealpix(maps[0], device=cuda)
        sky.lens_cmb_from_kappa(maps[1], 1e-2 * maps[0], lmax=lmax)
        out.append(sky.data["cmb_lensed"])
        fov = np.deg2rad(10.0)
        out += list(cml.qe_tt_kappa(t, fov, cl, lmin=40, lmax_filter=1200,
                                    device=cuda))
        out += list(cml.qe_eb_kappa(t, t.T.copy(), fov, cl, lmin=40,
                                    lmax_filter=600, device=cuda))
        out += list(cml.qe_tt_kappa_healpix(maps[0], cl[:lmax + 1], lmin=8,
                                            lmax_filter=lmax,
                                            lmax_out=lmax // 2,
                                            device=cuda))
        return out

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = runs()
        torch.backends.cuda.matmul.allow_tf32 = True
        on = runs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_cmb_lensing_slice_numpy_input_lands_on_the_card(cuda):
    """The slice's new entry points and the two repaired ones
    (paint.paint with numpy components, healpix_torch.ang2pix_ring) put
    numpy input on the card."""
    from astrild_tpu_torch.ops import cmb_lensing as cml
    from astrild_tpu_torch.ops import sht_spin, sht_spin_large
    from astrild_tpu_torch.utils import healpix_torch as hpt

    rng = np.random.default_rng(9)
    nside, lmax, npix = 8, 16, 768
    alms, maps = _spin1_inputs(nside, lmax, seed=9)
    th = np.arccos(rng.uniform(-1, 1, 50)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 50).astype(np.float32)
    patch = rng.standard_normal((16, 16)).astype(np.float32)
    cl = np.linspace(1e-10, 1e-12, 3001)
    pos = rng.uniform(0, BOX, (1000, 3)).astype(np.float32)
    outs = [TP.paint(tuple(pos.T.copy()), 16, BOX),
            hpt.ang2pix_ring(nside, th, ph),
            *hpt.pix2ang_ring(nside, np.arange(npix)),
            *hpt.get_interp_weights(nside, th, ph),
            hpt.get_interp_val(maps[0], th, ph),
            hpt.remap_by_deflection(maps[0], 1e-3 * maps[0],
                                    1e-3 * maps[1], nside),
            *sht_spin.synthesize_spin1(*alms, nside, lmax),
            *sht_spin.analyze_spin1(*maps, nside, lmax),
            *sht_spin.deflection_from_kappa_alm(alms[0], alms[1], nside,
                                                lmax),
            *sht_spin.kappa_omega_alm_from_deflection(*maps, nside, lmax),
            *sht_spin_large.synthesize_spin1_large(*alms, nside, lmax),
            *sht_spin_large.analyze_spin1_large(*maps, nside, lmax),
            *sht_spin_large.deflection_from_kappa_alm_large(
                alms[0], alms[1], nside, lmax),
            *TLS.multiplane_raytrace_healpix(
                0.1 * maps[0][None, :], [300.0], [100.0], 500.0, 0.3,
                lmax=lmax).values(),
            cml.lens_cmb_map_flat(patch, 1e-3 * patch, 0.03),
            cml.qe_tt_response(16, 0.03, cl, lmax_filter=1500),
            cml.qe_tt_n0_kappa(16, 0.03, cl, lmax_filter=1500),
            *cml.qe_tt_kappa(patch, 0.03, cl, lmax_filter=1500),
            *cml.qe_eb_kappa(patch, patch.T.copy(), 0.03, cl,
                             lmax_filter=1500),
            *cml.qe_tt_kappa_healpix(maps[0], cl[:lmax + 1],
                                     lmax_filter=lmax)]
    for t in outs:
        assert t.device.type == "cuda"


# ------------------------------------- K2's adjoint and field inference
def _k2_adjoint_case(case, order, rng, n, ng, box):
    """Positions of one adjoint case: uniform, on the cell edges where
    the base cell changes (CIC at (k + 0.5) h, TSC at k h) and an ulp to
    either side, or at x/h -> n and the box edges (TSC's clip)."""
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    h = box / ng
    if case == "cell_edges":
        edge = (np.arange(-1, ng + 2) + (0.5 if order == 2 else 0.0)) * h
        on = edge[rng.integers(0, len(edge), (n, 3))].astype(np.float32)
        step = rng.integers(-1, 2, (n, 3))
        pos = np.nextafter(on, np.where(step < 0, -np.inf, np.inf)
                           ).astype(np.float32)
        pos[step == 0] = on[step == 0]
    if case == "box_edges":
        pick = rng.choice(np.array([-1e-8, 0.0, -0.0, box, box - 1e-5,
                                    1e-8], np.float32), (n // 2, 3))
        pos[: n // 2] = pick
    return np.concatenate(pos.T).astype(np.float32)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["uniform", "cell_edges", "box_edges"])
def test_k2_adjoint_matches_plain_autograd(cuda, order, weighted, case):
    """K2's adjoint against autograd of the plain version on the same
    inputs on the card: the position and weight gradients within 1e-5 of
    their max (the same float32 products summed in another order; the
    bin decisions are the bin pass's, so a particle on a cell edge takes
    the same stencil on both routes). One launch a call."""
    rng = np.random.default_rng(21)
    n, ng, box = 100003, 37, BOX
    pf = torch.from_numpy(_k2_adjoint_case(case, order, rng, n, ng,
                                           box)).to(cuda)
    w = (torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
         .to(cuda) if weighted else None)
    g = torch.randn((ng,) * 3, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    before = TPC.LAUNCHES["paint_windowed_adjoint"]
    got_p, got_w = TPC.paint_windowed_adjoint(pf, w, g, ng, box, order)
    assert TPC.LAUNCHES["paint_windowed_adjoint"] == before + 1
    want_p, want_w = TPC.paint_windowed_adjoint_reference(pf, w, g, ng, box,
                                                          order)
    torch.cuda.synchronize()
    assert float((got_p - want_p).abs().max()) <= 1e-5 * float(
        want_p.abs().max())
    if weighted:
        assert float((got_w - want_w).abs().max()) <= 1e-5 * float(
            want_w.abs().max())
    else:
        assert got_w is None and want_w is None


def test_k2_plain_gradient_gradcheck_float64_on_the_card(cuda):
    """The plain version's gradient on the card by torch's gradcheck in
    float64 (directional and full), CIC and TSC, weighted."""
    rng = np.random.default_rng(5)
    n, ng, box = 24, 6, 50.0
    for order in (2, 3):
        pos = torch.tensor(np.concatenate(rng.uniform(-box, 2 * box,
                                                      (n, 3)).T),
                           dtype=torch.float64, device=cuda,
                           requires_grad=True)
        w = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float64,
                         device=cuda, requires_grad=True)

        def f(p, ww):
            return TPC.paint_windowed_reference(p, ww, ng, box, order)

        assert torch.autograd.gradcheck(f, (pos, w), fast_mode=True)
        assert torch.autograd.gradcheck(f, (pos, w))


@pytest.mark.parametrize("window", ["cic", "tsc"])
def test_paint_gradient_through_k2_matches_scatter(cuda, window):
    """paint(...) of positions and weights that require grad, on the card:
    the default route is K2 forward and its adjoint backward (one launch
    each), and its gradients equal the scatter route's within 1e-5 of
    their max."""
    rng = np.random.default_rng(9)
    n, ng = 200000, 32
    pos = torch.from_numpy(rng.uniform(0, BOX, (n, 3)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(
        cuda)
    target = torch.randn((ng,) * 3, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    grads = {}
    for route in (None, "scatter"):
        comps = tuple(c.clone().requires_grad_(True) for c in pos.unbind(1))
        ww = w.clone().requires_grad_(True)
        before = dict(TPC.LAUNCHES)
        grid = TP.paint(comps, ng, BOX, weights=ww, window=window,
                        deposit=route)
        loss = torch.sum((grid - target) ** 2)
        loss.backward()
        launched = {k: TPC.LAUNCHES[k] - before.get(k, 0)
                    for k in ("paint_windowed", "paint_windowed_adjoint")}
        assert launched == ({"paint_windowed": 1, "paint_windowed_adjoint": 1}
                            if route is None else
                            {"paint_windowed": 0,
                             "paint_windowed_adjoint": 0})
        grads[route] = torch.cat([c.grad for c in comps] + [ww.grad])
    torch.cuda.synchronize()
    scale = float(grads["scatter"].abs().max())
    assert float((grads[None] - grads["scatter"]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("wrapper", ["deposit_flat", "deposit_sorted",
                                     "deposit_flat_segmented",
                                     "pairwise_accumulate"])
def test_kernels_without_a_gradient_refuse_to_detach(cuda, wrapper):
    """K1's two entry points, K4 and K3 have no gradient (nor have their
    TPU twins): on the card they raise when grad mode is on and an input
    requires grad, and run under no_grad (or on detached inputs)."""
    rng = np.random.default_rng(2)
    n = 4096
    keys = torch.from_numpy(np.sort(rng.integers(0, 1000, n)).astype(
        np.int32)).to(cuda)
    vals = torch.rand(n, device=cuda, requires_grad=True)
    pos = (torch.rand(n, 3, device=cuda) * 50).requires_grad_(True)
    vel = torch.randn(n, 3, device=cuda)
    call = {
        "deposit_flat": lambda v: TPC.deposit_flat(keys, v, 1000),
        "deposit_sorted": lambda v: TPC.deposit_sorted(keys, v, 1000),
        "deposit_flat_segmented": lambda v: TPC.deposit_flat_segmented(
            keys, v, 1000),
        "pairwise_accumulate": lambda v: TPWC.pairwise_accumulate(
            pos if v is vals else pos.detach(), vel, n, 2.0, 16),
    }[wrapper]
    with pytest.raises(RuntimeError, match="no gradient"):
        call(vals)
    with torch.no_grad():
        call(vals)
    call(vals.detach())
    torch.cuda.synchronize()


def test_field_inference_on_the_card_matches_the_cpu(cuda):
    """field_nll's value and gradient at 16^3 (3 steps) on the card, K2
    in every paint (nsteps + 2 launches) and its adjoint in all but the
    last force paint's backward (nsteps + 1), against the
    same port on the CPU: the loss to rtol 1e-5, the gradient within 1e-4
    of its max (K2's float atomics against index_add_); infer_initial_field
    and sample_initial_field run there from numpy input and a CUDA
    generator."""
    from astrild_tpu_torch.ops import field_infer as TF

    def pk(k):
        return 2.0e3 * (k / 0.1) ** -1.5

    n, kw = 16, dict(z_init=9.0, nsteps=3, window="cic")
    cosmo = Cosmology(Om0=0.3, h=0.7)
    rng = np.random.default_rng(4)
    truth = rng.standard_normal((n,) * 3).astype(np.float32)
    w0 = (0.7 * truth + 0.3 * rng.standard_normal((n,) * 3)).astype(
        np.float32)
    data = TF.simulate_density(truth, pk, cosmo, ngrid=n, boxsize=BOX,
                               device="cpu", **kw)
    out = {}
    for dev in ("cpu", cuda):
        w = torch.from_numpy(w0).to(dev).requires_grad_(True)
        before = dict(TPC.LAUNCHES)
        loss = TF.field_nll(w, data.to(dev), 0.05, pk, cosmo, boxsize=BOX,
                            **kw)
        (g,) = torch.autograd.grad(loss, w)
        launched = {k: TPC.LAUNCHES[k] - before.get(k, 0)
                    for k in ("paint_windowed", "paint_windowed_adjoint")}
        out[str(dev)] = (float(loss.detach()), g.cpu(), launched)
    (l_cpu, g_cpu, _), (l_card, g_card, launched) = out["cpu"], out[
        str(cuda)]
    # the last force only kicks the momenta, which the density does not
    # read: autograd runs no adjoint for its paint
    assert launched == {"paint_windowed": 5, "paint_windowed_adjoint": 4}
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    assert float((g_card - g_cpu).abs().max()) <= 1e-4 * float(
        g_cpu.abs().max())
    res = TF.infer_initial_field(data.numpy(), 0.05, pk, cosmo, boxsize=BOX,
                                 n_iter=5, lr=0.05, white0=w0, **kw)
    assert res["white"].device.type == "cuda" and res["loss"].shape == (5,)
    samples, acc = TF.sample_initial_field(
        torch.Generator(device=cuda).manual_seed(0), data.numpy(), 0.05, pk,
        cosmo, boxsize=BOX, n_samples=2, n_warmup=1, n_leapfrog=2,
        white0=res["white"], **kw)
    assert samples.device.type == "cuda" and 0.0 <= acc <= 1.0


def test_checkpointed_evolution_and_lightcone_on_the_card(cuda, tmp_path):
    """pm_evolve_checkpointed and pm_lightcone_planes(ckpt_dir=) on the
    card: a resumed run restores onto the card and ends within the gap of
    two plain runs (K2's float atomics; bounded here by 1e-3 Mpc/h at 32^3
    and 3 steps, planes by 1e-4 of their max)."""
    from astrild_tpu_torch.core import checkpoint as ckpt

    cosmo = Cosmology(Om0=0.3, h=0.7)

    def pk(k):
        return 100.0 * torch.ones_like(k)

    n, box = 32, 200.0
    comps, mom = TN.lpt_catalog(torch.Generator(device=cuda).manual_seed(1),
                                n, box, pk, cosmo, 9.0)
    ref, _ = TN.pm_evolve(comps, mom, cosmo, n, box, 0.1, 1.0, 6)
    real_save = ckpt.save_state
    state = {"n": 0}

    def crashy(path, st, step=None):
        real_save(path, st, step=step)
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("simulated crash")

    ckpt.save_state = crashy
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            TN.pm_evolve_checkpointed(comps, mom, cosmo, n, box, 0.1, 1.0, 6,
                                      tmp_path / "ev", segment_steps=4)
    finally:
        ckpt.save_state = real_save
    got, _ = TN.pm_evolve_checkpointed(comps, mom, cosmo, n, box, 0.1, 1.0,
                                       6, tmp_path / "ev", segment_steps=4)
    assert got[0].device.type == "cuda"
    for a, b in zip(got, ref):
        d = (a - b).abs()
        assert float(torch.minimum(d, box - d).max()) < 1e-3
    args = (cosmo, pk, 16, 200.0, 0.05, 32, 6)
    kw = dict(z_source=0.4, z_init=9.0, nsteps_init=4, steps_per_plane=1)
    want = TN.pm_lightcone_planes(torch.Generator(device=cuda).manual_seed(2),
                                  *args, **kw)[0]
    ckpt.save_state = crashy
    state["n"] = 0
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            TN.pm_lightcone_planes(
                torch.Generator(device=cuda).manual_seed(2), *args,
                ckpt_dir=tmp_path / "lc", **kw)
    finally:
        ckpt.save_state = real_save
    planes = TN.pm_lightcone_planes(
        torch.Generator(device=cuda).manual_seed(2), *args,
        ckpt_dir=tmp_path / "lc", **kw)[0]
    assert planes.device.type == "cuda"
    assert float((planes - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _clustered_tracers(rng, n: int, side: float = 200.0, lo: float = 500.0):
    """n tracers in a cube of `side` Mpc/h at `lo` from the observer at the
    origin: half in 256 clumps (3 Mpc/h) falling in at 30 km/s per Mpc/h,
    half uniform, all with 100 km/s noise; every bin below 50 Mpc/h holds
    over a hundred pairs at 2^13 tracers."""
    nc = n // 2
    centres = lo + rng.uniform(0, side, (256, 3))
    off = rng.normal(0, 3.0, (nc, 3))
    pos = np.concatenate([centres[rng.integers(0, 256, nc)] + off,
                          lo + rng.uniform(0, side, (n - nc, 3))])
    vel = np.concatenate([-30.0 * off, np.zeros((n - nc, 3))]) \
        + rng.normal(0, 100.0, (n, 3))
    return pos, vel


def test_k3_matches_native_oracle(cuda):
    """K3 (mean_pairwise_velocity on the card) against the float64 OpenMP
    estimator of the native C++ oracle at 2^13 clustered tracers, with
    the JAX package's test_native bar: rtol 2e-3, atol 0.5 km/s in the
    bins both fill."""
    from astrild_tpu_torch import native

    assert native.available(), native.build_log
    rng = np.random.default_rng(13)
    pos, vel = _clustered_tracers(rng, 1 << 13)
    bins = np.linspace(0.0, 50.0, 25)
    _, v_ref = native.pairwise_velocity(pos, vel, bins)
    before = TPWC.LAUNCHES["pairwise_accumulate"]
    _, v12 = TPW.mean_pairwise_velocity(
        torch.tensor(pos, dtype=torch.float32, device=cuda),
        torch.tensor(vel, dtype=torch.float32, device=cuda), bins)
    assert TPWC.LAUNCHES["pairwise_accumulate"] == before + 1
    v12 = v12.cpu().numpy()
    good = np.isfinite(v_ref) & np.isfinite(v12)
    assert good.sum() >= 20
    np.testing.assert_allclose(v12[good], v_ref[good], rtol=2e-3, atol=0.5)


def test_distributed_fast_power_on_a_world_of_one(cuda):
    """parallel.power.make_distributed_auto_power_fast on a world of one
    over NCCL: one K1 launch in the shard body, and P(k) against
    auto_power_fast on the same particles. Before the shot noise (the same
    V/N in both) every bin but the last to rtol 1e-5; the last holds one
    mode fewer on the pencil (the rfft storage counts the (0, 0, n/2) mode
    twice), its mode count one less and its P to rtol 1e-3."""
    import torch.distributed as dist

    from astrild_tpu_torch.parallel import make_mesh
    from astrild_tpu_torch.parallel import power as DP

    mesh = make_mesh(1, 1, 1, device="cuda")
    try:
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        gen = torch.Generator(device=cuda).manual_seed(3)
        n, ngrid, nbins = 1 << 22, 128, 32
        pos = torch.rand(n, 3, generator=gen, device=cuda) * BOX
        fn = DP.make_distributed_auto_power_fast(mesh, ngrid, BOX, nbins)
        TPC.LAUNCHES.clear()
        got = fn(pos)
        torch.cuda.synchronize()
        assert dict(TPC.LAUNCHES) == {"deposit_sorted": 1}
    finally:
        dist.destroy_process_group()
    ref = TPS.auto_power_fast(pos, ngrid, BOX, nbins=nbins)
    shot = BOX ** 3 / n
    raw, raw_ref = (got.power + shot).cpu().numpy(), \
        (ref.power + shot).cpu().numpy()
    np.testing.assert_allclose(raw[:-1], raw_ref[:-1], rtol=1e-5)
    np.testing.assert_allclose(raw[-1], raw_ref[-1], rtol=1e-3)
    nm, nm_ref = got.nmodes.cpu().numpy(), ref.nmodes.cpu().numpy()
    np.testing.assert_array_equal(nm[:-1], nm_ref[:-1])
    assert nm_ref[-1] - nm[-1] == 1.0


# ------------------------------------ the distributed layer, part B
@pytest.fixture
def nccl_mesh(cuda):
    """A world of one over NCCL, (1, 1, 1) on the card; the process group
    is taken down after the test."""
    import torch.distributed as dist

    from astrild_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, 1, device="cuda")
    try:
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        yield mesh
    finally:
        dist.destroy_process_group()


def test_distributed_lens_planes_and_shells_on_a_world_of_one(cuda,
                                                              nccl_mesh):
    """make_distributed_lens_planes and make_distributed_healpix_shells on
    a world of one over NCCL: the shard bodies launch K1 once a flush (one
    flush at this size, so one launch each) and match the single-device
    functions on the card (which take the same deposit) within 1e-5 of the
    field's max; deposit="scatter" stays accepted and launches nothing."""
    from astrild_tpu_torch.parallel import lensing as DL

    gen = torch.Generator(device=cuda).manual_seed(5)
    pos = tuple(torch.rand(1 << 20, generator=gen, device=cuda) * BOX
                for _ in range(3))
    geo = (200.0, 31.25, 8, 0.35, 256)
    edges = np.array([20.0, 60.0, 110.0, 170.0])
    for name, fn, ref in (
            ("planes", DL.make_distributed_lens_planes(
                nccl_mesh, BOX, *geo, axis="sim"),
             lambda: TLP.density_planes_from_particles(pos, BOX, *geo)[0]),
            ("shells", DL.make_distributed_healpix_shells(
                nccl_mesh, edges, 64, BOX, axis="sim"),
             lambda: TLS.density_shells_healpix(pos, edges, 64, BOX)[0])):
        TPC.LAUNCHES.clear()
        got = fn(pos)
        got = got[0] if isinstance(got, tuple) else got
        torch.cuda.synchronize()
        assert dict(TPC.LAUNCHES) == {"deposit_sorted": 1}, name
        want = ref()
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), name
    TPC.LAUNCHES.clear()
    DL.make_distributed_lens_planes(nccl_mesh, BOX, *geo, axis="sim",
                                    deposit="scatter")(pos)
    assert not dict(TPC.LAUNCHES)


def test_distributed_field_infer_on_a_world_of_one(cuda, nccl_mesh):
    """make_distributed_field_infer's value_and_grad at 16^3 (3 steps) on a
    world of one over NCCL: K2 in every paint (nsteps + 2 launches) and
    its adjoint in all but the last force paint's backward (nsteps + 1),
    the loss to rtol 1e-5 and the gradient within 1e-4 of its max of the
    single-device chain on the card (c2c pencil FFTs against r2c ones, K2's
    float atomics): not off by any factor; deposit="scatter" launches no
    K2 and its loss is within 1e-4 (the scatter painter multiplies by
    1/h where K2 divides)."""
    from astrild_tpu_torch.ops import field_infer as TF
    from astrild_tpu_torch.parallel import field_infer as DF

    def pk(k):
        return 2.0e3 * (k / 0.1) ** -1.5

    n, kw = 16, dict(z_init=9.0, nsteps=3, window="cic")
    cosmo = Cosmology(Om0=0.3, h=0.7)
    rng = np.random.default_rng(4)
    truth = rng.standard_normal((n,) * 3).astype(np.float32)
    w0 = (0.7 * truth + 0.3 * rng.standard_normal((n,) * 3)).astype(
        np.float32)
    data = TF.simulate_density(truth, pk, cosmo, ngrid=n, boxsize=BOX, **kw)
    fac = DF.make_distributed_field_infer(nccl_mesh, n, BOX, pk, cosmo, **kw)
    TPC.LAUNCHES.clear()
    val, g = fac.value_and_grad(w0, data, 0.05)
    torch.cuda.synchronize()
    assert {k: TPC.LAUNCHES[k] for k in ("paint_windowed",
                                         "paint_windowed_adjoint")} == {
        "paint_windowed": 5, "paint_windowed_adjoint": 4}
    w = torch.from_numpy(w0).to(cuda).requires_grad_(True)
    loss = TF.field_nll(w, data, 0.05, pk, cosmo, boxsize=BOX, **kw)
    (g1,) = torch.autograd.grad(loss, w)
    assert g.device.type == "cuda"
    loss = float(loss.detach())
    assert abs(float(val) - loss) <= 1e-5 * abs(loss)
    assert float((g - g1).abs().max()) <= 1e-4 * float(g1.abs().max())
    # deposit="scatter" stays accepted: the scatter painter, no K2
    TPC.LAUNCHES.clear()
    fac_s = DF.make_distributed_field_infer(nccl_mesh, n, BOX, pk, cosmo,
                                            deposit="scatter", **kw)
    val_s = fac_s.loss(w0, data, 0.05)
    torch.cuda.synchronize()
    assert not dict(TPC.LAUNCHES)
    assert abs(float(val_s) - loss) <= 1e-4 * abs(loss)


def test_distributed_rings_hold_with_tf32_allowed(cuda, nccl_mesh):
    """The pair rings (v12, kSZ, xi(s, mu), wp, shear xi) on a world of
    one with TF32 allowed for float32 matmuls equal the runs without to
    1e-6 of each output's max: their tiles are elementwise products and
    sums, not einsums."""
    from astrild_tpu_torch.parallel import pairwise as DPW
    from astrild_tpu_torch.parallel import tpcf as DT

    rng = np.random.default_rng(8)
    pos, vel = _clumpy(rng, 2048)
    pos_t = torch.from_numpy(pos).to(cuda)
    far = pos_t + 1000.0
    vel_t = torch.from_numpy(vel).to(cuda)
    e = torch.from_numpy(rng.normal(0, 0.2, (2, 2048)).astype(
        np.float32)).to(cuda)

    def runs():
        return [
            *DPW.make_distributed_pairwise(nccl_mesh, 16, 2.0,
                                           block=256)(far, vel_t),
            *DPW.make_distributed_ksz(nccl_mesh, 16, 2.0, block=256)(
                far, vel_t[:, 0].contiguous()),
            DT.make_distributed_tpcf_s_mu(nccl_mesh, BOX, np.linspace(
                1.0, 40.0, 9), nmu=10, block=256)(pos_t)[2],
            DT.make_distributed_projected_tpcf(
                nccl_mesh, BOX, np.linspace(2.0, 30.0, 6), 40.0, n_pi=10,
                block=256)(pos_t)[1],
            *DT.make_distributed_shear_xi(nccl_mesh, np.geomspace(
                2.0, 40.0, 9), block=256)(pos_t[:, 0].contiguous(),
                                           pos_t[:, 1].contiguous(), e[0],
                                           e[1])]

    off, on = _tf32_on_and_off(runs)
    for a, b in zip(off, on):
        fin = torch.isfinite(a)
        assert bool(fin.any()) and torch.equal(fin, torch.isfinite(b))
        scale = float(a[fin].abs().max())
        assert float((b[fin] - a[fin]).abs().max()) <= 1e-6 * scale


def test_msharded_sht_holds_with_tf32_allowed(cuda, nccl_mesh):
    """The m-sharded scalar and spin-2 transforms (synthesis, both
    solvers) on a world of one with TF32 allowed for float32 matmuls equal
    the runs without, bit for bit: the recursion's contractions are
    elementwise products and sums; and they equal the unsharded scan
    path on the card bit for bit (the same rows, one psum of a world of
    one)."""
    from astrild_tpu_torch.ops import sht_large as SL
    from astrild_tpu_torch.ops import sht_spin_large as SSL
    from astrild_tpu_torch.parallel import sht_large as DSL

    nside, lmax = 64, 191
    rng = np.random.default_rng(6)
    valid = np.tril(np.ones((lmax + 1, lmax + 1), np.float32))
    alms = [torch.from_numpy((rng.standard_normal((lmax + 1,) * 2)
                              * valid * 0.1).astype(np.float32)).to(cuda)
            for _ in range(4)]
    s0, a0 = DSL.make_distributed_sht_large(nccl_mesh, nside, lmax)
    s2, a2 = DSL.make_distributed_sht_spin2_large(nccl_mesh, nside, lmax)

    def runs():
        m = s0(alms[0], alms[1])
        q, u = s2(*alms)
        return [m, q, u, *a0(m, niter=2, method="jacobi"),
                *a0(m, niter=2, method="cg"),
                *a2(q, u, niter=2, method="jacobi")]

    off, on = _tf32_on_and_off(runs)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert torch.equal(off[0], SL.synthesize_large(alms[0], alms[1], nside,
                                                   lmax))
    q1, u1 = SSL.synthesize_spin2_large(*alms, nside, lmax)
    assert torch.equal(off[1], q1) and torch.equal(off[2], u1)
