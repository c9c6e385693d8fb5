"""Reading a `torch.profiler` trace (its Chrome-trace JSON export).

The traced window is the host span `bench.window`, which the harness
opens after a device sync and closes after another, so every kernel of
its units runs inside it. Device time is taken from kernel, memcpy and
memset events; a kernel belongs to a program span (`record_function`)
when its launch (matched by correlation id) happened inside that span on
the host, or, where the trace has no launch records for it, when it ran
inside the span's device-side annotation.
"""
from __future__ import annotations

import bisect
import json
import re

__all__ = ["Trace", "WINDOW_SPAN", "kernel_name"]

WINDOW_SPAN = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_name(full: str) -> str:
    """The bare function name of a demangled kernel signature:
    'void ns::foo<8>(int const*, long)' -> 'foo'."""
    s = re.sub(r"^void\s+", "", full.strip().replace("(anonymous namespace)::",
                                                      ""))
    depth = 0
    out = []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip()


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


class Trace:
    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat", "").lower() == "user_annotation"]
        if not win:
            raise ValueError(f"the trace holds no '{WINDOW_SPAN}' span")
        self.w0 = float(win[0]["ts"])
        self.w1 = self.w0 + float(win[0]["dur"])
        self.device = []   # (start us, end us, name, category, correlation)
        self.launch_ts = {}  # correlation -> host launch time
        self.host = []     # (start, end, name, category) of host events
        self.spans = {}    # name -> [(start, end)] host spans
        self.gpu_spans = {}  # name -> [(start, end)] device annotations
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "").lower()
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in _DEVICE_CATS:
                if t1 > self.w0 and t0 < self.w1:
                    self.device.append((t0, t1, e.get("name", ""), cat,
                                        corr))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                if corr is not None:
                    self.launch_ts[corr] = t0
                self.host.append((t0, t1, e.get("name", ""), cat))
            elif cat == "user_annotation":
                self.spans.setdefault(e["name"], []).append((t0, t1))
                self.host.append((t0, t1, e.get("name", ""), cat))
            elif cat == "gpu_user_annotation":
                self.gpu_spans.setdefault(e["name"], []).append((t0, t1))
            elif cat == "cpu_op":
                self.host.append((t0, t1, e.get("name", ""), cat))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def _busy(self):
        return _merge([(max(a, self.w0), min(b, self.w1))
                       for a, b, *_ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def kernel_seconds(self, names) -> tuple[float, int]:
        """(device seconds, launches) of the kernels with these bare names."""
        names = set(names)
        total, count = 0.0, 0
        for a, b, full, cat, _ in self.device:
            if cat == "kernel" and kernel_name(full) in names:
                total += b - a
                count += 1
        return total * 1e-6, count

    def span_count(self, span: str) -> int:
        return sum(1 for a, b in self.spans.get(span, ())
                   if a >= self.w0 and b <= self.w1)

    def span_device_seconds(self, span: str) -> float | None:
        """Device seconds of the kernels a program span launched inside
        the window, or None if the window holds no such span."""
        host = sorted((a, b) for a, b in self.spans.get(span, ())
                      if a >= self.w0 and b <= self.w1)
        if not host:
            return None
        starts = [a for a, _ in host]

        def launched_inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= host[i][1]

        gpu = sorted(self.gpu_spans.get(span, ()))
        gstarts = [a for a, _ in gpu]

        def ran_inside(a, b):
            i = bisect.bisect_right(gstarts, a) - 1
            return i >= 0 and b <= gpu[i][1]

        total = 0.0
        for a, b, _, _, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is not None:
                if launched_inside(t):
                    total += b - a
            elif ran_inside(a, b):
                total += b - a
        return total * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host event under way when the
        gap began."""
        by_name = {}
        for a, b, full, _, _ in self.device:
            key = kernel_name(full) or full
            by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self._busy()
        gaps = []
        edge = self.w0
        for a, b in busy:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.w1 > edge:
            gaps.append((edge, self.w1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        named = []
        for a, b in gaps[:top]:
            t = a + 0.5
            inner = None
            for h0, h1, name, cat in self.host:
                if h0 <= t <= h1 and name != WINDOW_SPAN and (
                        inner is None or h0 >= inner[0]):
                    inner = (h0, name)
            named.append([inner[1] if inner else "host (no event)",
                          (b - a) * 1e-6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)
