"""Reading a torch.profiler trace: spans, their unions, the device's busy
and idle time, and the breakdown of a traced run.

Times are the chrome trace's microseconds, on one clock for the host's
ranges and the device's kernels. `length(merged(spans))` is the union
arithmetic of the program's train bench (`span_union`), and `load` reads
the chrome trace as its `profile_step` does.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Span = Tuple[float, float]
WINDOW = "bench/window"   # the harness's range around the traced calls


def merged(spans: Sequence[Span]) -> List[Span]:
    """The union of `spans` as sorted, disjoint spans."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(x: Sequence[Span], y: Sequence[Span]) -> List[Span]:
    """The intersection of two sets of sorted, disjoint spans."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(spans: Sequence[Span]) -> float:
    return sum(b - a for a, b in spans)


def gaps(busy: Sequence[Span], window: Span) -> List[Span]:
    """The parts of `window` that the sorted, disjoint `busy` leaves
    free."""
    out, at = [], window[0]
    for a, b in busy:
        if a > at:
            out.append((at, min(a, window[1])))
        at = max(at, b)
    if at < window[1]:
        out.append((at, window[1]))
    return [g for g in out if g[1] > g[0]]


@dataclass
class Trace:
    """The events of one traced window."""

    window: Span
    kernels: List[Tuple[float, float, str]] = field(default_factory=list)
    copies: List[Tuple[float, float, str]] = field(default_factory=list)
    memsets: List[Span] = field(default_factory=list)
    ranges: List[Tuple[float, float, str]] = field(default_factory=list)
    host_ops: List[Tuple[float, float, str]] = field(default_factory=list)

    def kernel_spans(self) -> List[Span]:
        return merged([(a, b) for a, b, _ in self.kernels])

    def h2d_spans(self) -> List[Span]:
        return merged([(a, b) for a, b, n in self.copies if "HtoD" in n])

    def busy_spans(self) -> List[Span]:
        """Kernels, copies and memsets: every operation on the device."""
        return merged([(a, b) for a, b, _ in self.kernels + self.copies]
                      + self.memsets)

    def range_spans(self, name: str) -> List[Span]:
        return [(a, b) for a, b, n in self.ranges if n == name]

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


def load(path: str) -> Trace:
    """Parse a chrome trace that holds one `bench/window` range; keep the
    events inside it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: Dict[str, list] = defaultdict(list)
    window: Optional[Span] = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"])
        b = a + float(e["dur"])
        name = str(e.get("name", ""))
        if cat == "user_annotation" and name == WINDOW:
            window = (a, b)
        spans[cat].append((a, b, name))
    if window is None:
        raise RuntimeError("the trace holds no bench/window range")

    def inside(items):
        return [s for s in items if s[0] >= window[0] and s[1] <= window[1]]

    return Trace(window=window, kernels=inside(spans["kernel"]),
                 copies=inside(spans["gpu_memcpy"]),
                 memsets=[(a, b) for a, b, _ in inside(spans["gpu_memset"])],
                 ranges=[s for s in inside(spans["user_annotation"])
                         if s[2] != WINDOW],
                 host_ops=inside(spans["cpu_op"]))


def idle_share(t: Trace) -> float:
    """Share of the window with no kernel running; copies count as
    idle."""
    busy = length(intersect(t.kernel_spans(), [t.window]))
    return 1.0 - busy / (t.window[1] - t.window[0])


def _host_activity(t: Trace):
    """A function naming the innermost host range or op that covers a
    time."""
    events = sorted(t.ranges + t.host_ops)
    starts = [e[0] for e in events]

    def at(time: float) -> str:
        i = bisect.bisect_right(starts, time) - 1
        for j in range(i, max(-1, i - 4000), -1):
            if events[j][1] >= time:
                return events[j][2]
        for a, b, n in sorted(t.ranges, key=lambda r: -r[0]):
            if a <= time <= b:
                return n
        return "host: outside any op"

    return at


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the idle
    gaps (no kernel) summed by what the host was doing at their middle;
    seconds."""
    by_kernel: Dict[str, float] = defaultdict(float)
    for a, b, n in t.kernels:
        by_kernel[n[:160]] += (b - a) * 1e-6
    for a, b, n in t.copies:
        by_kernel[n[:160]] += (b - a) * 1e-6
    at = _host_activity(t)
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps(t.kernel_spans(), t.window):
        by_host[at((a + b) / 2)[:160]] += (b - a) * 1e-6
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def export(prof, directory: str) -> Trace:
    """Write the profile's chrome trace under `directory`, parse it and
    delete the file."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        return load(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
