"""fused.pack_idle: the device-idle time inside the program's
``pikazoo.fused.pack`` spans over the device-idle time of the traced calls'
windows (``bench.fused_rollout`` start to ``bench.readback`` end), in the
profiled pass (``benchmark/program_spans.py``): the share of the card's
idling that the host's pack causes."""

from benchmark.program_spans import idle_share, profiled


def collect(run):
    profiled(run)


def read(run):
    p = profiled(run)
    if p is None:
        return None
    return idle_share(p, p.named("fused.pack"), p.unit_windows("fused_rollout"))
