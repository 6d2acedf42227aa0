"""The device trace of a `--trace 1` window: `torch.profiler`'s Chrome
trace, each device operation attributed to the harness's span that
launched it, and the union of the device's busy intervals.

The spans are `record_function` ranges the harness puts around the calls
into the program's layers (`bench.step`, `bench.group`, `bench.finish`)
and around the whole window (`bench.window`). A device operation belongs
to the innermost span that holds the host call that launched it (matched
by the profiler's correlation id).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench.window", "bench.step", "bench.group", "bench.finish",
         "bench.probe")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float        # microseconds, the trace's clock
    dur: float
    span: str | None    # innermost harness span of the launch
    bytes: int | None = None


@dataclasses.dataclass
class Trace:
    window: tuple       # (start, end) microseconds
    ops: list           # DeviceOp, in the window
    spans: list         # (start, end, name) host spans, by start

    def busy_intervals(self) -> list:
        """Union of the device's busy intervals inside the window."""
        w0, w1 = self.window
        return union((max(o.start, w0), min(o.start + o.dur, w1))
                     for o in self.ops)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def host_at(self, t: float) -> str:
        """The innermost harness span open at time t, or "run_blocks"
        (`run_blocks` between the spans, the harness's feed and
        the formatting of lines)."""
        best = None
        for a, b, name in self.spans:
            if a > t:
                break
            if b >= t and name != "bench.window":
                best = name
        return best or "run_blocks"

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between busy intervals inside the window,
        as [host activity at the gap's middle, seconds]."""
        w0, w1 = self.window
        busy = self.busy_intervals()
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((a + b) / 2), (b - a) * 1e-6]
                for a, b in gaps[:n]]

    def top_ops(self, n: int = 10) -> list:
        """The n device operations that took the most time, by name:
        [name, seconds]."""
        tot = collections.Counter()
        for o in self.ops:
            tot[o.name] += o.dur * 1e-6
        return [[k, v] for k, v in tot.most_common(n)]


def union(intervals) -> list:
    out = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def parse(events: list) -> Trace:
    """A Trace from the Chrome trace's event list."""
    spans, launches, dev = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        name = e.get("name", "")
        if cat == "user_annotation" and name in SPANS:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          name))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = (float(e["ts"]),)
        elif cat in DEVICE_CATS:
            dev.append(e)
    spans.sort()
    windows = [s for s in spans if s[2] == "bench.window"]
    if not windows:
        raise ValueError("the trace holds no bench.window span")
    w0, w1 = windows[0][0], windows[0][1]
    inner = [s for s in spans if s[2] != "bench.window"]
    starts = [s[0] for s in inner]
    # each span's enclosing span (the harness's spans nest, never cross)
    parent, stack = [], []
    for i, s in enumerate(inner):
        while stack and inner[stack[-1]][1] < s[0]:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)

    def innermost(t):
        j = bisect.bisect_right(starts, t) - 1
        while j is not None and j >= 0:
            if inner[j][1] >= t:
                return inner[j][2]
            j = parent[j]
        return None

    ops = []
    for e in dev:
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        if a + d < w0 or a > w1:
            continue
        args = e.get("args", {})
        ln = launches.get(args.get("correlation"))
        ops.append(DeviceOp(e.get("name", ""), e["cat"], a, d,
                            None if ln is None else innermost(ln[0]),
                            args.get("bytes")))
    return Trace((w0, w1), ops, spans)


def load(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return parse(data["traceEvents"] if isinstance(data, dict) else data)
