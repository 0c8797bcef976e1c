"""The program's own spans (``pikazoo.<name>``), read for the per-layer
metrics that name them.

The program records a span at each layer boundary only while its tracing is
switched on (``pikazoo_tpu_torch.utils.tracing``), so the window and the
benchmark's own profiled pass run without them.  After those, two passes
drive ``trace_calls`` more calls or ``trace_updates`` more updates, as the
session's ``profile()`` does, each once a run:

* the host pass: tracing on, no profiler, in a fresh process of the same
  cell and seed (:func:`host_spans` says why); the spans' host durations
  come from the program's ``take_spans()`` (under the profiler an update
  takes about twice as long on the host);
* the profiled pass: tracing on under ``torch.profiler``; the spans lie on
  the profiler's clock beside the host's kernel launches and the device's
  intervals, from which both the benchmark's and the program's annotations
  are kept out, as ``trace.py`` keeps out its own.

A program without tracing (one that cannot switch its spans on) gives
neither pass, and the metrics that read them read nothing.
"""

from __future__ import annotations

import bisect
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from benchmark.trace import SPAN_PREFIX as BENCH_PREFIX
from benchmark.trace import _union

ROOT = Path(__file__).resolve().parent.parent
PROGRAM_PREFIX = "pikazoo."
# Host calls that put a kernel or a graph on the card's queue.
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
K3 = "fused_rollout_kernel"

Interval = Tuple[int, int]


class Event(NamedTuple):
    """One profiler event, as the reading below needs it (ns)."""

    name: str
    on_device: bool
    start: int
    end: int
    correlation: int
    linked: int  # a device event's host event (its correlation), 0 where none


class Profiled:
    """The program's spans, the benchmark's spans, the host's launches and
    the device's intervals of one profiled pass, in ns on one clock."""

    def __init__(self, events: Iterable[Event]):
        self.spans: List[Tuple[int, int, str]] = []
        self.bench: List[Tuple[int, int, str]] = []
        self.launches: List[Tuple[int, int]] = []  # (host start, correlation)
        self.device: List[Event] = []
        self.host_start: Dict[int, int] = {}  # correlation -> start of any host event
        for ev in events:
            if ev.name.startswith(PROGRAM_PREFIX):
                # A span shows on both timelines; the host's is the span.
                if not ev.on_device:
                    self.spans.append((ev.start, ev.end, ev.name[len(PROGRAM_PREFIX):]))
            elif ev.name.startswith(BENCH_PREFIX):
                if not ev.on_device:
                    self.bench.append((ev.start, ev.end, ev.name[len(BENCH_PREFIX):]))
            elif ev.on_device:
                self.device.append(ev)
            else:
                self.host_start[ev.correlation] = ev.start
                if ev.name.startswith(LAUNCH_PREFIXES):
                    self.launches.append((ev.start, ev.correlation))
        self.spans.sort()
        self.bench.sort()
        self.launches.sort()
        self.device.sort(key=lambda ev: ev.start)
        self.busy = _union((ev.start, ev.end) for ev in self.device)

    def named(self, name: str) -> List[Interval]:
        return [(s, e) for s, e, n in self.spans if n == name]

    def unit_windows(self, unit: str) -> List[Interval]:
        """Each traced unit, from its ``bench.<unit>`` span's start to the
        end of the ``bench.readback`` span that follows it."""
        starts = [(s, e) for s, e, n in self.bench if n == unit]
        ends = [(s, e) for s, e, n in self.bench if n == "readback"]
        return [(s, e) for (s, _), (_, e) in zip(starts, ends)]

    def launch_times(self) -> List[int]:
        """Host start of every kernel launch; where the profiler kept no
        launch call, the host start of each device kernel's linked event."""
        if self.launches:
            return [s for s, _ in self.launches]
        return sorted(self.host_start[ev.linked] for ev in self.device
                      if ev.linked and ev.linked in self.host_start and _is_kernel(ev.name))

    def launches_in(self, intervals: Sequence[Interval]) -> List[int]:
        """Kernel launches whose host start lies inside each interval."""
        times = self.launch_times()
        return [bisect.bisect_left(times, e) - bisect.bisect_left(times, s)
                for s, e in intervals]

    def idle_ns(self, intervals: Sequence[Interval]) -> int:
        """Device-idle ns inside the union of ``intervals``."""
        within = _union(intervals)
        return _length(within) - _overlap(within, self.busy)


def _is_kernel(name: str) -> bool:
    return not name.lower().startswith(("memcpy", "memset"))


def _length(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def _overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """ns in both of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def from_kineto(prof) -> Profiled:
    from torch.autograd import DeviceType

    return Profiled(Event(ev.name(), ev.device_type() == DeviceType.CUDA, ev.start_ns(),
                          ev.end_ns(), ev.correlation_id(), ev.linked_correlation_id())
                    for ev in prof.profiler.kineto_results.events())


def idle_share(p: Optional[Profiled], part: Sequence[Interval],
               whole: Sequence[Interval]) -> Optional[float]:
    """Device-idle time inside ``part`` over that inside ``whole``, in %;
    None where the pass saw no device work or ``whole`` has no idle time."""
    if p is None or not p.device or not part or not whole:
        return None
    total = p.idle_ns(whole)
    return p.idle_ns(part) / total * 100 if total > 0 else None


def clock_check(p: Profiled) -> Optional[dict]:
    """Each ``fused.run`` span holds one launch, and K3's interval starts
    after its span's host start: the program's spans and the device lie on
    one clock.  The i-th K3 interval belongs to the i-th span."""
    runs = p.named("fused.run")
    kernels = [ev for ev in p.device if K3 in ev.name]
    if not runs or len(kernels) != len(runs):
        return None
    leads = [(k.start - s) / 1e3 for (s, _), k in zip(runs, kernels)]
    launches = p.launches_in(runs)
    return {"runs": len(runs), "launches": launches,
            "lead_us_min": min(leads), "lead_us_max": max(leads),
            "holds": all(n == 1 for n in launches) and min(leads) > 0}


def idle_gaps(p: Profiled, k: int = 10) -> List[list]:
    """The ``k`` longest device-idle gaps between the first program span's
    start and the last one's end, each named by the innermost program span
    open on the host at its start ("outside spans" where none is)."""
    if not p.spans:
        return []
    lo, hi = p.spans[0][0], max(e for _, e, _ in p.spans)
    gaps, prev = [], lo
    for s, e in p.busy:
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        open_spans = [(ss, n) for ss, se, n in p.spans if ss <= s < se]
        out.append([max(open_spans)[1] if open_spans else "outside spans", (e - s) / 1e9])
    return out


# ------------------------------------------------------------------ passes --

def _program():
    """The program's ``(tracing, take_spans)``, or None where it has none."""
    try:
        from pikazoo_tpu_torch.utils.profiling import take_spans, tracing
    except ImportError:
        return None
    return tracing, take_spans


def drive(run, bench_spans: bool) -> None:
    """The traced units of the cell's session (``trace_calls`` calls or
    ``trace_updates`` updates), as its ``profile()`` runs them, with the
    benchmark's spans on or off."""
    s = run.session
    if "trace_calls" in run.params:
        s.spans = bench_spans
        try:
            for _ in range(int(run.params["trace_calls"])):
                s.unit()
        finally:
            s.spans = False
    else:
        for _ in range(int(run.params["trace_updates"])):
            s.unit(spans=bench_spans)
    s.sync()


class HostSpan(NamedTuple):
    """One span of the host pass, as the program recorded it."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int


def host_spans(run) -> Optional[List[HostSpan]]:
    """The host pass's spans, once a run.  The pass runs in a fresh process
    of the same cell and seed, set up as the run was: a process that has
    run ``torch.profiler`` with CUDA keeps paying for it on every later
    kernel launch (a pack 2.3 ms before, 3.5 ms after; a learner frame 18.8
    ms before, 25.0 ms after, on an H100), so after the traced calls this
    process would read the host's times too long.  None where the program
    has no tracing or the pass fails (its error on stderr)."""
    def measure():
        if _program() is None:
            return None
        argv = [sys.executable, "-m", "benchmark.program_spans", run.cell.name, str(run.seed),
                run.device.type, json.dumps(run.params)]
        out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(f"program spans: the host pass failed: {out.stderr[-2000:]}", file=sys.stderr)
            return None
        return [HostSpan(*s) for s in json.loads(out.stdout.strip().splitlines()[-1])]

    return run.once("program_host", measure)


def host_pass(cell_name: str, seed: int, device: str, params: dict) -> List[list]:
    """The host pass itself: the cell's session set up from ``seed``, then
    its traced units with the program's tracing on and no profiler."""
    from benchmark import harness

    run = harness.Run(harness.Cell(ROOT, cell_name), seed, 0.0, True, torch.device(device))
    run.params.update(params)
    run.session = run.cell.driver.Session(run)
    run.session.setup()
    tracing, take_spans = _program()
    take_spans()
    with tracing():
        drive(run, False)
    return [list(s) for s in take_spans()]


def profiled(run) -> Optional[Profiled]:
    """The profiled pass, once a run; prints its longest idle gaps named by
    program span, and the clock check where the cell runs ``fused_rollout``."""
    def measure():
        from torch.profiler import ProfilerActivity

        program = _program()
        if program is None:
            return None
        tracing, take_spans = program
        activities = [ProfilerActivity.CPU]
        if run.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with tracing():
                drive(run, True)
        take_spans()  # the same spans, on the host's clock: not read
        p = from_kineto(prof)
        if not p.spans:
            return None
        check = clock_check(p)
        if check is not None:
            print(f"program spans: clock check {check}", file=sys.stderr)
        print(f"program spans: idle gaps {idle_gaps(p)}", file=sys.stderr)
        return p

    return run.once("program_profiled", measure)


def durations_ms(spans: Optional[list], name: str) -> List[float]:
    """Host durations in ms of the spans named ``pikazoo.<name>``."""
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans or ()
            if s.name == PROGRAM_PREFIX + name]

if __name__ == "__main__":
    # python -m benchmark.program_spans CELL SEED DEVICE PARAMS_JSON (from the
    # checkout's root): the host pass, its spans as one JSON line.
    cell_name, seed, device, params = sys.argv[1:]
    print(json.dumps(host_pass(cell_name, int(seed), device, json.loads(params))))
