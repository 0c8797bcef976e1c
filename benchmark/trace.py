"""Reading a ``torch.profiler`` trace of a few timed units.

The benchmark wraps its calls into each layer in ``record_function`` spans
whose names start with ``bench.``; the device side is every kernel, copy
and set on the card.  From one profiled window this gives the device's busy
time (the union of its intervals), the window's length, the device time of
named kernels unit by unit, the top device operations, and the longest
idle gaps named by the innermost benchmark span the host was in.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

SPAN_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str, on: bool = True):
    """A benchmark span around a call into a layer (a no-op when off)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Profile:
    """Device intervals and benchmark spans of one profiled window, in ns on
    the profiler's clock."""

    def __init__(self, device: List[Tuple[int, int, str]], spans: List[Tuple[int, int, str]]):
        self.device = sorted(device)
        self.spans = sorted(spans)
        if not self.spans:
            raise RuntimeError("the profiled window holds no benchmark span")
        self.start = min(s for s, _, _ in self.spans)
        self.end = max(e for _, e, _ in self.spans)
        inside = [(max(s, self.start), min(e, self.end), n) for s, e, n in self.device
                  if e > self.start and s < self.end]
        self.busy = _union(inside)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def spans_named(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for s, e, n in self.spans if n == SPAN_PREFIX + name]

    def kernel_s(self, names: Sequence[str], within: Tuple[int, int] = None) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``, inside ``within`` (ns) or the whole window."""
        lo, hi = within or (self.start, self.end)
        return sum(min(e, hi) - max(s, lo) for s, e, n in self.device
                   if any(k in n for k in names) and e > lo and s < hi) / 1e9

    def top_ops(self, k: int = 10) -> List[list]:
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, n in self.device:
            if e > self.start and s < self.end:
                by_name[n] += min(e, self.end) - max(s, self.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches in which the device ran nothing, each
        named by the innermost benchmark span open on the host at its start."""
        edges, prev = [], self.start
        for s, e in self.busy:
            if s > prev:
                edges.append((prev, s))
            prev = max(prev, e)
        if self.end > prev:
            edges.append((prev, self.end))
        gaps = sorted(edges, key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in gaps:
            open_spans = [(ss, n) for ss, se, n in self.spans if ss <= s < se]
            name = max(open_spans)[1][len(SPAN_PREFIX):] if open_spans else "outside spans"
            out.append([name, (e - s) / 1e9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def _union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def profile(fn: Callable[[], None]) -> Profile:
    """Run ``fn`` under ``torch.profiler`` with the CPU and CUDA activities
    and read the device intervals and the benchmark spans out of it."""
    from torch.profiler import ProfilerActivity
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(SPAN_PREFIX):
            # A span shows on both timelines; the host's is the span.
            if ev.device_type() != DeviceType.CUDA:
                spans.append((ev.start_ns(), ev.end_ns(), name))
        elif ev.device_type() == DeviceType.CUDA:
            device.append((ev.start_ns(), ev.end_ns(), name))
    return Profile(device, spans)
