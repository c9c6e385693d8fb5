"""The port's profiler spans on the CPU: a tiny suite pass and a tiny
`pm_evolve` under `torch.profiler`, each span's count a unit, its parent,
and the spans' layout (the void finder's three parts side by side, the
accept loop in one span). No JAX here."""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from astrild_tpu_torch import suite  # noqa: E402
from astrild_tpu_torch.ops import nbody  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

N_SIDE, NGRID, NPIX, BOX, NPLANES = 16, 16, 64, 200.0, 8
PASSES = 2
STAGES = ("suite.matter", "suite.bispectrum", "suite.lensing", "suite.voids")
# span -> the span it runs in
SUITE_PARENT = {
    **{s: "suite.pass" for s in STAGES},
    "power.keys": "suite.matter", "power.deposit": "suite.matter",
    "power.fft_bin": "suite.matter",
    "peaks.find": "suite.voids", "voids.distance": "suite.voids",
    "voids.candidates": "suite.voids", "voids.accept": "suite.voids",
}
PM_STEPS = 2
PM_SPANS = ("pm.evolve", "pm.paint", "pm.poisson", "pm.gather", "pm.kick",
            "pm.drift")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spans(prof, names):
    """The profiler's events of the named spans, each with the name of the
    nearest span it runs in (None for none)."""
    out = []
    for e in prof.events():
        if e.name not in names:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in names:
            parent = parent.cpu_parent
        out.append((e, None if parent is None else parent.name))
    return out


def _ops_under(prof, span):
    """Names of the aten ops whose nearest enclosing span is `span`."""
    spans = set(SUITE_PARENT) | {"suite.pass"} | set(PM_SPANS)
    out = []
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in spans:
            parent = parent.cpu_parent
        if parent is not None and parent.name == span:
            out.append(e.name)
    return out


@pytest.fixture(scope="module")
def suite_trace():
    run = suite.make_stages(N_SIDE, NGRID, NPIX, BOX, NPLANES, "cpu")
    pos = suite.uniform_positions(N_SIDE, BOX, "cpu", seed=3)
    run(pos)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(PASSES):
            out = run(pos)
    return prof, out, run, pos


@pytest.mark.parametrize("name", ["suite.pass", *SUITE_PARENT])
def test_suite_span_once_a_pass(suite_trace, name):
    prof = suite_trace[0]
    found = _spans(prof, {name, "suite.pass"} | set(SUITE_PARENT))
    mine = [p for e, p in found if e.name == name]
    assert len(mine) == PASSES
    assert set(mine) == {SUITE_PARENT.get(name)}


def test_void_parts_are_siblings(suite_trace):
    """The distance transform, the candidates and the accept loop follow
    one another inside `suite.voids`: none holds another, and the accept
    loop, with its step per candidate, is one span a pass."""
    prof = suite_trace[0]
    parts = ("voids.distance", "voids.candidates", "voids.accept")
    found = _spans(prof, set(parts) | {"suite.voids"})
    per_pass = [[e for e, _ in found if e.name == p] for p in parts]
    assert [len(x) for x in per_pass] == [PASSES] * 3
    assert all(p == "suite.voids" for e, p in found if e.name in parts)
    for k in range(PASSES):
        ranges = [per_pass[i][k].time_range for i in range(3)]
        for a, b in zip(ranges, ranges[1:]):
            assert a.end <= b.start


def test_suite_pass_has_no_work_of_its_own(suite_trace):
    """Every op of a pass runs inside a stage span: the root's self time
    holds none."""
    assert _ops_under(suite_trace[0], "suite.pass") == []


def test_run_stages_carry_the_stage_spans(suite_trace):
    """`run.stages[...]` called one at a time opens the same stage spans,
    with no root around them."""
    _, _, run, pos = suite_trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        grid, _ = run.stages["matter"](pos)
        run.stages["bispectrum"](grid)
        kappa, _, _ = run.stages["lensing"](grid)
        run.stages["voids"](kappa)
    found = _spans(prof, set(STAGES) | {"suite.pass"})
    assert sorted(e.name for e, _ in found) == sorted(STAGES)
    assert {p for _, p in found} == {None}


def test_spans_leave_the_outputs_alone(suite_trace):
    """A pass inside the profiler returns what a pass outside it does."""
    _, out, run, pos = suite_trace
    again = run(pos)
    for a, b in zip(out, again):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.fixture(scope="module")
def pm_trace():
    cosmo = Cosmology(Om0=0.3, h=0.7)
    gen = torch.Generator().manual_seed(5)
    comps = tuple(torch.rand(N_SIDE ** 3, generator=gen) * BOX
                  for _ in range(3))
    mom = tuple(0.01 * torch.randn(N_SIDE ** 3, generator=gen)
                for _ in range(3))
    before = tuple(c.clone() for c in comps + mom)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x, p = nbody.pm_evolve(comps, mom, cosmo, N_SIDE, BOX, 0.1, 1.0,
                               PM_STEPS, device="cpu")
    return prof, (x, p), comps + mom, before


@pytest.mark.parametrize("name", PM_SPANS)
def test_pm_span_counts(pm_trace, name):
    want = {"pm.evolve": 1, "pm.paint": PM_STEPS + 1,
            "pm.poisson": PM_STEPS + 1, "pm.gather": PM_STEPS + 1,
            "pm.kick": 2 * PM_STEPS, "pm.drift": PM_STEPS}
    found = _spans(pm_trace[0], set(PM_SPANS))
    mine = [p for e, p in found if e.name == name]
    assert len(mine) == want[name]
    assert set(mine) == {None if name == "pm.evolve" else "pm.evolve"}


def test_pm_evolve_root_holds_the_copies(pm_trace):
    """The flat copies of the particles run in `pm.evolve` itself, outside
    the loop's spans; the inputs stay as they were."""
    prof, (x, p), inputs, before = pm_trace
    assert _ops_under(prof, "pm.evolve").count("aten::clone") == 6
    assert all(bool(torch.isfinite(c).all()) for c in x + p)
    assert all(torch.equal(a, b) for a, b in zip(inputs, before))
