"""Tracing and throughput helpers on ``torch.profiler``.

The program's spans (:func:`trace_annotation`) mark its layer boundaries.
They are off unless switched on with :func:`tracing`; off, a span is one
check of a module flag and a shared null context.  On, each span keeps its
name (``pikazoo.<name>``), its host start and end (``perf_counter_ns``), the
index of the span it opened inside, and the unit it belongs to (an update's
``update_index``, a ``fused_rollout`` call's number); :func:`take_spans`
hands them over.  While a ``torch.profiler`` session is active a span also
enters ``record_function`` under its name, so it lies on the profiler's
clock beside the kernels it launched.  A one-call trace context writes a
Chrome trace of the host and, where there is a card, the device, with the
spans on; a steps/s meter ticks after each unit of work the caller waited for.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity

SPAN_PREFIX = "pikazoo."

_on = False
_null = contextlib.nullcontext()
_records: list = []  # [name, start_ns, end_ns, parent record, unit] per span, in start order
_open = threading.local()  # .stack: the records of this thread's open spans


class Span(NamedTuple):
    """One recorded span; ``parent`` indexes the list :func:`take_spans`
    returned (-1 at the top, or where the parent was taken earlier) and
    ``unit`` is -1 where no enclosing span named one."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int


class _Span:
    __slots__ = ("name", "unit", "record", "region")

    def __init__(self, name: str, unit: Optional[int]):
        self.name = name if name.startswith(SPAN_PREFIX) else SPAN_PREFIX + name
        self.unit = unit

    def __enter__(self) -> None:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        unit = self.unit
        if unit is None:
            unit = parent[4] if parent is not None else -1
        self.region = None
        if torch.autograd._profiler_enabled():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        self.record = [self.name, time.perf_counter_ns(), -1, parent, int(unit)]
        _records.append(self.record)
        stack.append(self.record)

    def __exit__(self, *exc) -> None:
        self.record[2] = time.perf_counter_ns()
        _open.stack.pop()
        if self.region is not None:
            self.region.__exit__(*exc)


def trace_annotation(name: str, unit: Optional[int] = None):
    """The span ``pikazoo.<name>`` around a ``with`` body: a shared null
    context while tracing is off.  ``unit`` names the update or call the
    span belongs to; without it a span takes its parent's."""
    if not _on:
        return _null
    return _Span(name, unit)


@contextlib.contextmanager
def tracing(on: bool = True) -> Iterator[None]:
    """Spans on (or off) for the body; the previous setting after it."""
    global _on
    before, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = before


def take_spans() -> List[Span]:
    """The spans recorded since the last call, in start order; clears them."""
    global _records
    records, _records = _records, []
    index = {id(r): i for i, r in enumerate(records)}
    return [Span(name, start, end, index.get(id(parent), -1), unit)
            for name, start, end, parent, unit in records]


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the body, host and (with a card) device, into
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome / Perfetto format), with the
    program's spans on."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, tracing():
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Throughput:
    """Steps/s meter: ``tick`` after each unit of work that has finished
    (on the card, after a synchronise or a read-back).  The first tick
    starts the clock, so the first unit (compilation, kernel builds) is
    left out."""

    def __init__(self, unit_steps: int):
        self.unit_steps = unit_steps
        self.reset()

    def reset(self) -> None:
        self._start: Optional[float] = None
        self._ticks = 0

    def tick(self) -> None:
        if self._start is None:
            self._start = time.perf_counter()
        else:
            self._ticks += 1

    @property
    def steps_per_s(self) -> float:
        if self._start is None or self._ticks == 0:
            return 0.0
        return self.unit_steps * self._ticks / (time.perf_counter() - self._start)
