"""Tracing and throughput helpers on ``torch.profiler``.

Named regions (``record_function``) show in the trace's timeline; a
one-call trace context writes a Chrome trace of the host and, where there is
a card, the device; a steps/s meter that the caller ticks after each unit of
work it has waited for.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Named region in the profiler timeline (a no-op when not tracing)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the body, host and (with a card) device, into
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome / Perfetto format)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
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
