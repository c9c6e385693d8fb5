"""The port's CUDA kernel and its callers on the card (marker `cuda`).

These tests need a CUDA card and skip without one. They import no JAX, so
they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu_torch import suite  # noqa: E402
from astrild_tpu_torch.ops import paint as TP  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda as TPC  # noqa: E402
from astrild_tpu_torch.ops import power as TPS  # noqa: E402

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


@pytest.mark.parametrize("case", ["dense", "sparse", "empty", "one_cell",
                                  "ragged", "last_window"])
def test_k1_matches_plain(cuda, case):
    """Counts equal; weighted sums within 2e-5 * max (the JAX kernel's
    bar)."""
    rng = np.random.default_rng(3)
    n_cells = {"dense": 1 << 20, "sparse": 1 << 22, "empty": 999,
               "one_cell": 1 << 16, "ragged": 1 << 18,
               "last_window": 5 * 8192 + 77}[case]
    keys = {
        "dense": rng.integers(0, n_cells, 1 << 20),
        "sparse": rng.integers(0, n_cells, 1000),
        "empty": np.zeros(0),
        "one_cell": np.full(100000, 12345),
        "ragged": rng.integers(0, n_cells, (1 << 18) + 12345),
        "last_window": np.repeat(np.arange(n_cells - 300, n_cells), 5),
    }[case]
    keys_sorted, vals = _sorted_case(
        torch.from_numpy(np.asarray(keys, np.int32)), cuda)
    before = TPC.LAUNCHES["deposit_sorted"]
    got = TPC.deposit_sorted(keys_sorted, None, n_cells)
    assert TPC.LAUNCHES["deposit_sorted"] == before + 1
    assert torch.equal(got, TPC.deposit_sorted_reference(keys_sorted, None,
                                                         n_cells))
    gotw = TPC.deposit_sorted(keys_sorted, vals, n_cells)
    want = TPC.deposit_sorted_reference(keys_sorted, vals, n_cells)
    scale = float(want.abs().max()) if n_cells else 0.0
    assert float((gotw - want).abs().max()) <= 2e-5 * scale


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
