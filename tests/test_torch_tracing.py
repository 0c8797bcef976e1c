"""The port's spans (``utils.profiling.trace_annotation``) on the CPU: off,
they enter nothing and record nothing; on, ``train_step`` and
``fused_rollout`` record their phases, frames and calls under one parent
and one unit, the results stay bit-identical, and ``profile_trace`` writes
them into its trace."""

import os

import pytest
import torch

from pikazoo_tpu_torch import EnvConfig, PikaZoo, fused_rollout
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu_torch.utils import profile_trace, take_spans, trace_annotation, tracing
from pikazoo_tpu_torch.utils import profiling
from torch_helpers import assert_same

T = 4  # frames of the tiny update


@pytest.fixture(autouse=True)
def _fresh_spans():
    take_spans()
    yield
    take_spans()


def _trainer():
    cfg = PPOConfig(num_envs=8, rollout_length=T, num_minibatches=2, update_epochs=1,
                    hidden=(16, 16))
    return make_ppo_trainer(PikaZoo(EnvConfig(winning_score=2)), cfg, device="cpu")


def _state(batch=1024):
    env = PikaZoo(EnvConfig(is_player1_computer=True, is_player2_computer=True))
    state, _ = env.reset_batch(3, batch, device="cpu")
    return state, env.config


def _children(spans, parent):
    return [s for s in spans if s.parent == parent]


@pytest.fixture
def entered(monkeypatch):
    """The names of the ``record_function`` regions entered from now on."""
    names = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return names


def test_off_by_default_enters_and_records_nothing(entered):
    assert not profiling._on
    assert trace_annotation("x") is trace_annotation("y")  # the shared null context
    init_fn, train_step, _ = _trainer()
    state, cfg = _state()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace_annotation("ppo.frame"):
            pass
        train_step(init_fn(0))
        fused_rollout(state, 5, cfg, 1)
    assert entered == [] and take_spans() == []


def test_spans_enter_record_function_only_under_a_profiler(entered):
    with tracing():
        with trace_annotation("alone"):
            pass
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with trace_annotation("profiled"):
                pass
    assert entered == ["pikazoo.profiled"]
    assert [s.name for s in take_spans()] == ["pikazoo.alone", "pikazoo.profiled"]
    assert not profiling._on


def test_train_step_spans_frames_phases_and_unit():
    init_fn, train_step, _ = _trainer()
    runner, _ = train_step(init_fn(0))
    with tracing():
        train_step(runner)
    spans = take_spans()
    (top,) = [i for i, s in enumerate(spans) if s.parent == -1]
    assert spans[top].name == "pikazoo.ppo.train_step"
    assert [spans[i].name for i in range(len(spans)) if spans[i].parent == top] == [
        "pikazoo.ppo.rollout", "pikazoo.ppo.gae", "pikazoo.ppo.update"]
    rollout = spans.index(next(s for s in spans if s.name == "pikazoo.ppo.rollout"))
    frames = [i for i, s in enumerate(spans) if s.name == "pikazoo.ppo.frame"]
    assert len(frames) == T and all(spans[i].parent == rollout for i in frames)
    for i in frames:
        kids = _children(spans, i)
        assert sorted(s.name for s in kids) == ["pikazoo.env.step", "pikazoo.ppo.policy"]
        assert all(spans[i].start_ns <= s.start_ns <= s.end_ns <= spans[i].end_ns
                   for s in kids)
    assert {s.unit for s in spans} == {runner.update_index}
    assert all(s.start_ns <= s.end_ns for s in spans)


def test_fused_rollout_spans_pack_run_unpack_under_one_call():
    state, cfg = _state()
    with tracing():
        fused_rollout(state, 5, cfg, 2)
        fused_rollout(state, 5, cfg, 1)
    spans = take_spans()
    tops = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in tops] == ["pikazoo.fused_rollout"] * 2
    for i in tops:
        assert [s.name for s in _children(spans, i)] == [
            "pikazoo.fused.pack", "pikazoo.fused.run", "pikazoo.fused.unpack"]
    units = [spans[i].unit for i in tops]
    assert units[1] == units[0] + 1 == fused_rollout.calls
    assert all(s.unit == spans[tops[0]].unit for s in spans[:4])


def test_outputs_bit_identical_with_tracing_on_and_off():
    state, cfg = _state()
    off = fused_rollout(state, 5, cfg, 3)
    with tracing():
        on = fused_rollout(state, 5, cfg, 3)
    assert_same(off, on, "fused_rollout")

    results = []
    for traced in (False, True):
        init_fn, train_step, _ = _trainer()
        runner = init_fn(1)
        with tracing(traced):
            for _ in range(2):
                runner, m = train_step(runner)
        results.append((runner.params, torch.stack([m.total_loss, m.policy_loss, m.value_loss,
                                                    m.entropy, m.approx_kl])))
    (p_off, l_off), (p_on, l_on) = results
    assert torch.equal(l_on, l_off)
    assert p_on.keys() == p_off.keys()
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_off)


def test_profile_trace_holds_the_frame_spans(tmp_path):
    init_fn, train_step, _ = _trainer()
    runner = init_fn(0)
    with profile_trace(str(tmp_path / "trace")):
        train_step(runner)
    assert not profiling._on
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        text = f.read()
    assert text.count('"pikazoo.ppo.frame"') >= T
