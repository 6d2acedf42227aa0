"""The pipelines' one timing mechanism: cumulative totals of host spans,
device spans and counters under one key each, with the spans named in a
`torch.profiler` trace while tracing is on.

  span(key)    host seconds into totals[key], always; while tracing is on
               also a profiler range "iridium.<key>", so the program's
               spans sit, nested, on the clock of the trace's device
               operations
  device(key)  while tracing is on, on the card and outside a graph
               capture: a pair of timing CUDA events around the enclosed
               work on the current stream, resolved into totals[key] in
               device seconds by `drain` (`always=True`: whether tracing
               is on or not)
  count(key)   a count; `add(key, seconds)` host seconds measured
               elsewhere

Tracing is on while `Tracer.on` is true: each `run_blocks` call sets it at
its start from `recording()`, whether a torch profiler records, so the
CLI's `--profile` and a profiled window turn it on and every other decode
leaves it off. A nested span's time is also in its parent's key.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

PREFIX = "iridium."
HOST, DEVICE, COUNT = "host", "device", "count"
_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler is recording."""
    return torch.autograd.profiler._is_profiler_enabled


class Tracer:
    """Totals (`totals`, a Counter: a pipeline's `timing`) and the kind of
    each key (`kinds`: HOST seconds, DEVICE seconds or a COUNT). The keys
    of `counts` are in every new totals, at 0."""

    def __init__(self, device: torch.device, counts: tuple = ()):
        self.cuda = torch.device(device).type == "cuda"
        self.on = False
        self.counts = counts
        self.kinds: dict = dict.fromkeys(counts, COUNT)
        self.pending: collections.deque = collections.deque()
        self._events: list = []      # resolved events, for reuse
        self.reset()

    def reset(self) -> None:
        """New totals; event pairs not yet resolved are dropped."""
        self.totals = collections.Counter(dict.fromkeys(self.counts, 0))
        self.pending.clear()

    def span(self, key: str) -> "_Span":
        return _Span(self, key)

    def device(self, key: str, always: bool = False):
        if not (self.cuda and (self.on or always)) or (
                torch.cuda.is_current_stream_capturing()):
            return _NULL
        return _Device(self, key)

    def count(self, key: str, n: int = 1) -> None:
        if key not in self.kinds:
            self.kinds[key] = COUNT
        self.totals[key] += n

    def add(self, key: str, seconds: float) -> None:
        if key not in self.kinds:
            self.kinds[key] = HOST
        self.totals[key] += seconds

    def drain(self) -> None:
        """Resolve the event pairs whose end has run, in the order they
        were recorded (one stream), without waiting."""
        p = self.pending
        while p and p[0][1].query():
            a, b, key = p.popleft()
            self.totals[key] += a.elapsed_time(b) / 1e3
            self._events += (a, b)

    def _event(self) -> torch.cuda.Event:
        if self._events:
            return self._events.pop()
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("tr", "key", "rf", "t0")

    def __init__(self, tr: Tracer, key: str):
        self.tr, self.key = tr, key

    def __enter__(self):
        self.rf = None
        if self.tr.on:
            self.rf = torch.profiler.record_function(PREFIX + self.key)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tr.add(self.key, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Device:
    __slots__ = ("tr", "key", "start")

    def __init__(self, tr: Tracer, key: str):
        self.tr, self.key = tr, key
        tr.kinds[key] = DEVICE

    def __enter__(self):
        self.start = self.tr._event()
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = self.tr._event()
        end.record()
        self.tr.pending.append((self.start, end, self.key))
        return False
