"""``benchmark/program_spans.py`` and the metrics that read the program's
spans, on synthetic profiler events (CPU): device-idle time inside spans,
launches counted per span, the program's annotations kept out of the
device's intervals, the clock check, and every reader reading nothing where
its spans or counts are absent."""

from pathlib import Path

import pytest

from benchmark import harness, program_spans
from benchmark.program_spans import Event, Profiled, clock_check, idle_gaps, idle_share

METRICS = Path(__file__).resolve().parent.parent / "metrics"
NEW = ("fused.pack_ms", "fused.pack_idle", "k3.pool_lane_eff", "ppo.frame_ms",
       "ppo.launches_per_frame", "ppo.env_step_idle")


def host(name, start, end, correlation=0):
    return Event(name, False, start, end, correlation, 0)


def device(name, start, end, correlation=0, linked=0):
    return Event(name, True, start, end, correlation, linked)


def _reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name.replace('.', '_')}")


class FakeRun:
    """What the readers use of a run: its readings, filled once."""

    def __init__(self, readings):
        self.readings = dict(readings)
        self.device = None

    def once(self, key, fn):
        if key not in self.readings:
            self.readings[key] = fn()
        return self.readings[key]


def test_idle_inside_spans():
    p = Profiled([device("k", 10, 20), device("k", 30, 40), device("memcpy", 15, 25),
                  host("pikazoo.fused.pack", 0, 10), host("pikazoo.fused.pack", 20, 28),
                  host("bench.fused_rollout", 0, 28), host("bench.readback", 28, 50)])
    assert p.busy == [(10, 25), (30, 40)]
    assert p.idle_ns(p.named("fused.pack")) == 10 + 3
    assert p.unit_windows("fused_rollout") == [(0, 50)]
    assert p.idle_ns([(0, 50)]) == 50 - 25
    assert idle_share(p, p.named("fused.pack"), p.unit_windows("fused_rollout")) == \
        pytest.approx(13 / 25 * 100)
    assert p.idle_ns([(0, 12), (5, 18)]) == 10  # the spans' union, counted once


def test_idle_gaps_named_by_the_innermost_span():
    p = Profiled([host("pikazoo.ppo.frame", 0, 100), host("pikazoo.env.step", 10, 60),
                  device("k", 0, 5), device("k", 20, 30), device("k", 70, 75)])
    assert idle_gaps(p) == [["env.step", 40e-9], ["ppo.frame", 25e-9], ["ppo.frame", 15e-9]]
    assert idle_gaps(p, k=1) == [["env.step", 40e-9]]


def test_launches_counted_per_span():
    events = [host("cudaLaunchKernel", t, t + 1, correlation=100 + t) for t in (1, 5, 12, 13)]
    events += [host("cuLaunchKernel", 30, 31, 200), host("cudaGraphLaunch", 35, 36, 201),
               host("cudaMemcpyAsync", 8, 9, 202), host("aten::add", 2, 4, 7)]
    events += [host("pikazoo.ppo.frame", 0, 10), host("pikazoo.ppo.frame", 10, 20),
               host("pikazoo.ppo.frame", 20, 40)]
    p = Profiled(events)
    assert p.launches_in(p.named("ppo.frame")) == [2, 2, 2]


def test_launches_from_linked_kernels_where_the_runtime_calls_are_missing():
    p = Profiled([host("aten::add", 2, 3, correlation=7), host("aten::mul", 12, 13, 8),
                  device("add_kernel", 20, 21, linked=7), device("mul_kernel", 22, 23, linked=8),
                  device("mul_kernel_2", 24, 25, linked=8), device("Memcpy HtoD", 26, 27, linked=7),
                  host("pikazoo.ppo.frame", 0, 10), host("pikazoo.ppo.frame", 10, 20)])
    assert p.launches_in(p.named("ppo.frame")) == [1, 2]


def test_annotations_are_kept_out_of_the_device_intervals():
    p = Profiled([host("pikazoo.fused.pack", 0, 10), device("pikazoo.fused.pack", 0, 10),
                  host("bench.fused_rollout", 0, 30), device("bench.fused_rollout", 0, 30),
                  device("fused_rollout_kernel", 12, 20)])
    assert [ev.name for ev in p.device] == ["fused_rollout_kernel"]
    assert p.busy == [(12, 20)]
    assert p.spans == [(0, 10, "fused.pack")]
    assert p.bench == [(0, 30, "fused_rollout")]


def test_clock_check():
    events = [host("pikazoo.fused.run", 0, 10), host("cudaLaunchKernel", 2, 3, 1),
              device("fused_rollout_kernel_true", 4, 40, 1),
              host("pikazoo.fused.run", 50, 60), host("cudaLaunchKernel", 52, 53, 2),
              device("fused_rollout_kernel_true", 61, 90, 2)]
    check = clock_check(Profiled(events))
    assert check["holds"] and check["launches"] == [1, 1] and check["lead_us_min"] == 0.004
    late = events[:2] + [device("fused_rollout_kernel_true", -1, 40, 1)] + events[3:]
    assert not clock_check(Profiled(late))["holds"]
    twice = events + [host("cudaLaunchKernel", 55, 56, 3)]
    assert clock_check(Profiled(twice))["launches"] == [1, 2]


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_programs_spans(name):
    """A program that cannot switch its spans on gives no pass; a pass with
    no span of the metric's, or no device work, reads nothing."""
    reader = _reader(name)
    absent = FakeRun({"program_host": None, "program_profiled": None, "k3_pool_counts": None})
    assert reader.read(absent) is None
    other = Profiled([host("pikazoo.unrelated", 0, 10), device("k", 2, 4),
                      host("cudaLaunchKernel", 1, 2, 1)])
    empty = FakeRun({"program_host": [], "program_profiled": other,
                     "k3_pool_counts": (0, 0)})
    assert reader.read(empty) is None


def test_a_program_without_tracing_gives_no_pass(monkeypatch):
    monkeypatch.setattr(program_spans, "_program", lambda: None)
    run = FakeRun({})
    assert program_spans.host_spans(run) is None
    assert program_spans.profiled(run) is None


def test_readers_read_the_spans():
    from pikazoo_tpu_torch.utils import Span

    spans = [Span("pikazoo.fused.pack", 0, 2_000_000, 1, 4),
             Span("pikazoo.fused.pack", 5_000_000, 9_000_000, 1, 5),
             Span("pikazoo.fused.pack", 10_000_000, 90_000_000, 1, 6),  # a host stall
             Span("pikazoo.ppo.frame", 0, 20_000_000, 0, 3)]
    p = Profiled([host("pikazoo.ppo.rollout", 0, 100), host("pikazoo.env.step", 10, 30),
                  host("pikazoo.ppo.frame", 0, 50), host("pikazoo.ppo.frame", 50, 100),
                  host("cudaLaunchKernel", 40, 41, 1), device("k", 20, 60, 1)])
    run = FakeRun({"program_host": spans, "program_profiled": p,
                   "k3_pool_counts": (3 * 32, 4)})
    assert _reader("fused.pack_ms").read(run) == pytest.approx(4.0)  # the median
    assert _reader("ppo.frame_ms").read(run) == pytest.approx(20.0)
    assert _reader("ppo.launches_per_frame").read(run) == pytest.approx(0.5)
    assert _reader("ppo.env_step_idle").read(run) == pytest.approx(10 / 60 * 100)
    assert _reader("k3.pool_lane_eff").read(run) == pytest.approx(75.0)


@pytest.mark.parametrize("cell, params, name, count", [
    ("learner_selfplay.ppo", {"learner": dict(num_envs=32, rollout_length=8)}, "ppo.frame", 8),
    ("rule_ai_selfplay.fused", dict(batch=1024, frames=4, warmup_calls=1, trace_calls=2),
     "fused.pack", 2)])
def test_host_pass_runs_in_a_fresh_process(cell, params, name, count):
    """The host pass (CPU, tiny sizes): the cell's session set up anew from
    the seed in a child process, its traced units' spans handed back."""
    import torch

    run = harness.Run(harness.Cell(harness.BENCH_DIR.parent, cell), 2 ** 31 + 29, 0.0, True,
                      torch.device("cpu"))
    run.params.update(params)
    spans = program_spans.host_spans(run)
    assert sum(s.name == "pikazoo." + name for s in spans) == count
    assert run.readings["program_host"] is spans
    assert _reader(name + "_ms").read(run) > 0
