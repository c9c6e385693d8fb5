"""PyTorch port vs JAX package on the CPU: core/checkpoint.py.

The port mirrors tests/test_checkpoint.py's roundtrip and accumulator
tests (not the sharding one: the port has no mesh). Checkpoints are the
JAX package's npz layout, so a JAX checkpoint written without orbax
restores in the port and the reverse; both are checked with the JAX
package's `have_orbax` patched off, as its own test_npz_fallback_roundtrip
does. Values round-trip bit for bit.
"""
import json

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.core import checkpoint as jck  # noqa: E402
from astrild_tpu_torch.core import checkpoint as ck  # noqa: E402


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


def _state(rng):
    return {"kappa": torch.from_numpy(
                rng.standard_normal((8, 8)).astype(np.float32)),
            "nplanes": torch.tensor(3),
            "k": torch.arange(5, dtype=torch.float32)}


def test_save_restore_roundtrip(tmp_path, rng):
    state = _state(rng)
    ck.save_state(tmp_path / "ck", state, step=7)
    got, step = ck.restore_state(tmp_path / "ck", state, with_step=True)
    assert step == 7
    for key in state:
        assert torch.equal(got[key], state[key])
        assert got[key].dtype == state[key].dtype
    # no step saved: None, and restore without with_step gives the state
    ck.save_state(tmp_path / "ck2", state)
    assert ck.restore_state(tmp_path / "ck2", state,
                            with_step=True)[1] is None
    assert torch.equal(ck.restore_state(tmp_path / "ck2", state)["k"],
                       state["k"])


def test_nested_structures_and_flatten_order(tmp_path, rng):
    """Tuples, lists, dicts (by sorted key), namedtuples and None (no
    leaf) round-trip in the JAX package's flatten order."""
    from collections import namedtuple

    pair = namedtuple("pair", "a b")
    state = {"z": (torch.ones(2), [torch.zeros(3), None]),
             "a": pair(torch.tensor(1.5), torch.arange(4))}
    assert [tuple(x.shape) for x in ck._flatten(state)] == [
        (), (4,), (2,), (3,)]
    ck.save_state(tmp_path / "ck", state, step=0)
    got = ck.restore_state(tmp_path / "ck", state)
    assert isinstance(got["a"], pair) and got["z"][1][1] is None
    for a, b in zip(ck._flatten(got), ck._flatten(state)):
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["step"] == 0 and "treedef" in meta


def test_restore_checks_template(tmp_path):
    ck.save_state(tmp_path / "ck", (torch.ones(3), torch.ones(2)))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore_state(tmp_path / "ck", (torch.ones(3),))
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore_state(tmp_path / "ck", (torch.ones(3), torch.ones(5)))
    # the template's dtype wins (the template states the layout)
    got = ck.restore_state(tmp_path / "ck",
                           (torch.ones(3, dtype=torch.float64),
                            torch.ones(2)))
    assert got[0].dtype == torch.float64


def test_orbax_checkpoint_raises_clearly(tmp_path):
    (tmp_path / "ck" / "state").mkdir(parents=True)
    assert ck.checkpoint_exists(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="orbax"):
        ck.restore_state(tmp_path / "ck", (torch.ones(3),))


def test_jax_npz_checkpoint_restores_in_port(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(jck, "have_orbax", lambda: False)
    kappa = rng.standard_normal((8, 8)).astype(np.float32)
    jstate = {"kappa": jnp.asarray(kappa), "b": jnp.asarray(2.5),
              "t": (jnp.arange(6.0), jnp.asarray(3))}
    jck.save_state(tmp_path / "ck", jstate, step=4)
    template = {"kappa": torch.zeros(8, 8), "b": torch.tensor(0.0),
                "t": (torch.zeros(6), torch.tensor(0, dtype=torch.int32))}
    got, step = ck.restore_state(tmp_path / "ck", template, with_step=True)
    assert step == 4
    npt.assert_array_equal(got["kappa"].numpy(), kappa)
    assert float(got["b"]) == 2.5
    npt.assert_array_equal(got["t"][0].numpy(), np.arange(6.0))
    assert int(got["t"][1]) == 3


def test_port_checkpoint_restores_in_jax(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(jck, "have_orbax", lambda: False)
    state = _state(rng)
    state["t"] = (torch.arange(6.0), [torch.ones(2, 2)])
    ck.save_state(tmp_path / "ck", state, step=9)
    jtemplate = {"kappa": jnp.zeros((8, 8)), "nplanes": jnp.asarray(0),
                 "k": jnp.zeros(5), "t": (jnp.zeros(6), [jnp.zeros((2, 2))])}
    got, step = jck.restore_state(tmp_path / "ck", jtemplate,
                                  with_step=True)
    assert step == 9
    npt.assert_array_equal(np.asarray(got["kappa"]), state["kappa"].numpy())
    assert int(got["nplanes"]) == 3
    npt.assert_array_equal(np.asarray(got["t"][1][0]), np.ones((2, 2)))
    # and the port accumulator resumes a JAX accumulator's stream
    planes = rng.standard_normal((6, 4, 4)).astype(np.float32)
    jacc = jck.CheckpointedAccumulator(tmp_path / "acc", jnp.zeros((4, 4)),
                                       lambda s, c: s + c, every=2)
    for i in range(5):
        jacc.step(i, jnp.asarray(planes[i]))
    acc = ck.CheckpointedAccumulator(tmp_path / "acc", torch.zeros(4, 4),
                                     lambda s, c: s + c, every=2)
    assert acc.resumed_at == 4
    for i in range(6):
        acc.step(i, torch.from_numpy(planes[i]))
    npt.assert_allclose(acc.finish().numpy(), planes.sum(0), rtol=1e-6,
                        atol=1e-6)


def test_bind_schedule_refuses_another_schedule(tmp_path):
    ck.bind_schedule(tmp_path / "ck", {"kind": "x", "n": 3, "t": (1, 2)})
    # the same schedule (a tuple stored as a list) is accepted
    ck.bind_schedule(tmp_path / "ck", {"kind": "x", "n": 3, "t": [1, 2]})
    with pytest.raises(ValueError, match="different schedule"):
        ck.bind_schedule(tmp_path / "ck", {"kind": "x", "n": 4,
                                           "t": [1, 2]})
    # the two packages write the same record
    jck.bind_schedule(tmp_path / "ck", {"kind": "x", "n": 3, "t": (1, 2)})


def test_accumulator_resumes_mid_stream(tmp_path, rng):
    planes = torch.from_numpy(
        rng.standard_normal((16, 4, 4)).astype(np.float32))
    init = torch.zeros((4, 4))
    update = lambda s, c: s + c  # noqa: E731

    want = planes.numpy().sum(0)

    # first run folds 10 chunks, checkpointing every 4, then "crashes"
    acc = ck.CheckpointedAccumulator(tmp_path / "acc", init, update, every=4)
    for i in range(10):
        assert acc.step(i, planes[i])

    # resumed run: chunks up to the last checkpoint (index 7) are skipped
    acc2 = ck.CheckpointedAccumulator(tmp_path / "acc", init, update,
                                      every=4)
    assert acc2.resumed_at == 8
    applied = [acc2.step(i, planes[i]) for i in range(16)]
    assert applied == [False] * 8 + [True] * 8
    final = acc2.finish()
    npt.assert_allclose(final.numpy(), want, rtol=1e-6)

    # a third run after finish() resumes past the end: nothing reapplied
    acc3 = ck.CheckpointedAccumulator(tmp_path / "acc", init, update)
    assert acc3.resumed_at == 16
    npt.assert_allclose(acc3.state.numpy(), want, rtol=1e-6)


def test_accumulator_rejects_out_of_order(tmp_path):
    acc = ck.CheckpointedAccumulator(tmp_path / "acc", torch.zeros(()),
                                     lambda s, c: s + c)
    acc.step(0, torch.tensor(1.0))
    with pytest.raises(ValueError, match="out of order"):
        acc.step(2, torch.tensor(1.0))
