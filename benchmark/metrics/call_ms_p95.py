"""call_ms_p95: the 95th percentile over all calls of the window of one
call's wall time, from its issue until its results are on the host."""

from benchmark.counts import percentile


def read(run):
    return percentile([u["ms"] for u in run.units], 95)
