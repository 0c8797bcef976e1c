"""fused.pack_ms: the host's time a call in the program's
``pikazoo.fused.pack`` span (``_check_state`` and ``pack_state``: the
action keys' threefry over every env and the 56-row stack), the median over
the traced calls of the host pass (``benchmark/program_spans.py``): tracing
on, no profiler.  The median, since one call in a few can stall the host for
tens of ms (76.7 ms against 2-4 ms, once in five, on an H100's host)."""

import statistics

from benchmark.program_spans import durations_ms, host_spans


def collect(run):
    host_spans(run)


def read(run):
    packs = durations_ms(host_spans(run), "fused.pack")
    return statistics.median(packs) if packs else None
