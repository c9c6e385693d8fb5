"""Where the port's entry points put numpy input: on `device`, by default
the CUDA card, raising without one (astrild_tpu_torch/_device.py); a
tensor keeps its device. One case for each entry point that once turned
its input into a tensor with a bare `torch.as_tensor` (and so ran numpy
input on the CPU unasked): `nbody.pm_evolve`,
`nbody.lpt_catalog_from_modes`, `mocks.modes_from_white`,
`density_split.density_at_points`, `density_split.counts_in_cells_moments`,
`tpcf.tpcf_multipoles`, `profiles3d.stacked_profile`, `profiles3d.fit_nfw`
and `binred.masked_bin_reduce`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu_torch.ops import binred as TB  # noqa: E402
from astrild_tpu_torch.ops import density_split as TDS  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops import profiles3d as TPR  # noqa: E402
from astrild_tpu_torch.ops import tpcf as TT  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

N, BOX = 8, 50.0


def _modes():
    rng = np.random.default_rng(0)
    white = rng.standard_normal((N, N, N)).astype(np.float32)
    return TM.modes_from_white(torch.from_numpy(white), N, BOX,
                               lambda k: 50.0 * torch.ones_like(k)).numpy()


def _catalog():
    comps, mom = TN.lpt_catalog_from_modes(torch.from_numpy(_modes()), N,
                                           BOX, Cosmology(), 9.0)
    return [c.numpy() for c in comps], [p.numpy() for p in mom]


def _outputs(res):
    """The tensors of a result (tuples and lists flattened)."""
    if isinstance(res, torch.Tensor):
        return [res]
    out = []
    for r in res:
        out += _outputs(r)
    return out


def _cases():
    rng = np.random.default_rng(1)
    r = np.geomspace(0.1, 2.0, 12).astype(np.float32)
    rho = (100.0 / (r / 0.5 * (1 + r / 0.5) ** 2))[None, :].astype(
        np.float32)
    prof = rng.uniform(0.5, 1.5, (5, 10)).astype(np.float32)
    counts = rng.integers(1, 20, (5, 10)).astype(np.float32)
    chans = rng.standard_normal((2, 1000)).astype(np.float32)
    binidx = rng.integers(0, 9, 1000)
    field = rng.standard_normal((N, N, N)).astype(np.float32)
    pts = rng.uniform(0, BOX, (50, 3)).astype(np.float32)
    return {
        "pm_evolve": (lambda *a, **k: TN.pm_evolve(
            *a, Cosmology(), N, BOX, 0.1, 0.2, 1, **k), lambda: _catalog()),
        "lpt_catalog_from_modes": (lambda dk, **k: TN.lpt_catalog_from_modes(
            dk, N, BOX, Cosmology(), 9.0, **k), lambda: (_modes(),)),
        "modes_from_white": (lambda w, **k: TM.modes_from_white(
            w, N, BOX, lambda q: torch.ones_like(q), **k),
            lambda: (rng.standard_normal((N, N, N)).astype(np.float32),)),
        "density_at_points": (lambda f, p, **k: TDS.density_at_points(
            f, BOX, p, **k), lambda: (field, pts)),
        "counts_in_cells_moments": (TDS.counts_in_cells_moments,
                                    lambda: (counts,)),
        "tpcf_multipoles": (lambda x, **k: TT.tpcf_multipoles(x, 2, **k),
                            lambda: (prof,)),
        "stacked_profile": (TPR.stacked_profile, lambda: (prof, counts)),
        "fit_nfw": (TPR.fit_nfw, lambda: (r, rho)),
        "masked_bin_reduce": (lambda c, b, **k: TB.masked_bin_reduce(
            c, b, 8, **k), lambda: (chans, binidx)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_numpy_input_placement(name):
    fn, make = _cases()[name]
    args = make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)
    for t in _outputs(fn(*args, device="cpu")):
        assert t.device.type == "cpu"
    tensors = [tuple(torch.from_numpy(np.asarray(c)) for c in a)
               if isinstance(a, (list, tuple)) else torch.from_numpy(a)
               for a in args]
    for t in _outputs(fn(*tensors)):
        assert t.device.type == "cpu"
