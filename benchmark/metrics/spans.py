"""Arithmetic shared by the readers of the program's spans: device time,
device-idle time, self time and blocking host calls per unit of work,
from the public fields of `benchmark.trace.Trace`.

A unit is one root span of the program: `suite.pass` (`suite.py`, one
pass of the z=0 suite) or `pm.evolve` (`ops/nbody.py`, one simulation).
Every value is per unit of the traced window, the unit count being the
number of root spans in it. A kernel, copy or memset belongs to a span
when its launch (matched by correlation id) happened inside the span on
the host. Each function returns None when the window holds no root span
or the trace no device event (a trace taken without a card), so a run of
a program without these spans leaves the metric out.
"""
from __future__ import annotations

import bisect

from benchmark.trace import _merge

__all__ = ["ROOTS", "SYNC_CALLS", "root_of", "span_ms", "idle_ms",
           "self_ms", "host_syncs"]

ROOTS = ("suite.pass", "pm.evolve")
# CUDA runtime calls that block the host until the card has caught up
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))


def _host(trace, name: str) -> list:
    """The sorted host intervals of a span that lie inside the window."""
    return sorted((a, b) for a, b in trace.spans.get(name, ())
                  if a >= trace.w0 and b <= trace.w1)


def _cover(merged):
    """A test of whether t lies in one of the disjoint sorted
    intervals."""
    starts = [a for a, _ in merged]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]
    return inside


def _units(trace, root: str):
    """The number of root spans in the window, or None where there are
    none or the trace holds no device event."""
    n = len(_host(trace, root))
    return n if n and trace.device else None


def root_of(trace):
    """The root span whose units the window holds, or None."""
    return next((r for r in ROOTS if _host(trace, r)), None)


def span_ms(trace, span: str, root: str):
    """Device milliseconds a unit of the work launched inside `span`."""
    n = _units(trace, root)
    secs = trace.span_device_seconds(span) if n else None
    return None if secs is None else 1e3 * secs / n


def idle_ms(trace, span: str, root: str):
    """Milliseconds a unit in which the host was inside `span` and no
    kernel, copy or memset ran on the card."""
    n = _units(trace, root)
    host = _host(trace, span)
    if not n or not host:
        return None
    busy = _merge((max(a, trace.w0), min(b, trace.w1))
                  for a, b, *_ in trace.device)
    gaps, edge = [], trace.w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if trace.w1 > edge:
        gaps.append((edge, trace.w1))
    total = 0.0
    for h0, h1 in host:
        for g0, g1 in gaps:
            total += max(0.0, min(h1, g1) - max(h0, g0))
    return 1e-3 * total / n


def self_ms(trace, root: str):
    """Device milliseconds a unit launched inside the root span but
    inside none of the spans nested in it: the root's self time."""
    n = _units(trace, root)
    if not n:
        return None
    roots = _host(trace, root)
    in_root = _cover(roots)
    in_nested = _cover(_merge(
        (a, b) for name, ivs in trace.spans.items() if name != root
        for a, b in ivs
        if any(r0 <= a and b <= r1 for r0, r1 in roots)))
    total = 0.0
    for a, b, _, _, corr in trace.device:
        t = trace.launch_ts.get(corr)
        if t is not None and in_root(t) and not in_nested(t):
            total += b - a
    return 1e-3 * total / n


def host_syncs(trace, root: str):
    """Blocking CUDA runtime calls (`SYNC_CALLS`) a unit made inside the
    root span: the harness's own sync after the window lies outside it."""
    n = _units(trace, root)
    if not n:
        return None
    in_root = _cover(_host(trace, root))
    count = sum(1 for a, _, name, cat in trace.host
                if cat == "cuda_runtime" and name in SYNC_CALLS
                and in_root(a))
    return count / n
