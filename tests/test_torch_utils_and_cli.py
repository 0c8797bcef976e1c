"""The port's ``utils`` against the JAX package's (the JSONL format, the
throughput meter, ``validate_state``), ``profile_trace``, and the training
CLI with every flag the port added, checkpoint resume included, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from pikazoo_tpu.utils import MetricsLogger as JaxMetricsLogger
from pikazoo_tpu.utils import validate_state as jax_validate_state
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import env_state_to_numpy
from pikazoo_tpu_torch.train import run as port_run
from pikazoo_tpu_torch.utils import (MetricsLogger, Throughput, profile_trace,
                                     trace_annotation, validate_state)


def test_metrics_jsonl_matches_jax(tmp_path):
    """The same header and records give the same JSONL lines (the wall
    clock aside); tensors are read as floats."""
    lines = {}
    for name, cls, value in (("jax", JaxMetricsLogger, np.float32(1.5)),
                             ("port", MetricsLogger, torch.tensor(1.5))):
        path = str(tmp_path / f"{name}.jsonl")
        logger = cls(path, print_every=0)
        logger.header({"provenance": {"fused_update": "fm"}})
        logger.log(0, {"loss": value, "episodes": 3})
        logger.log(1, {"loss": 2.0, "episodes": 0})
        logger.close()
        lines[name] = [json.loads(line) for line in open(path)]
        for row in lines[name][1:]:
            assert row.pop("wall_s") >= 0
    assert lines["port"] == lines["jax"]
    assert lines["port"][1] == {"step": 0, "loss": 1.5, "episodes": 3.0}


def test_throughput_meter():
    meter = Throughput(unit_steps=100)
    assert meter.steps_per_s == 0.0
    meter.tick()  # starts the clock: the first unit is not counted
    assert meter.steps_per_s == 0.0
    meter.tick()
    assert meter.steps_per_s > 0
    meter.reset()
    assert meter.steps_per_s == 0.0


def test_validate_state_matches_jax():
    """A long random rollout stays in the envelope; corrupted leaves give
    JAX's message, word for word."""
    env = PikaZoo(EnvConfig(auto_reset=True))
    state, _ = env.reset_batch(0, 64, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(300):
        actions = torch.randint(0, 18, (64, 2), generator=gen, dtype=torch.int32)
        state, _ = env.step_batch(state, actions)
    validate_state(state)
    jax_validate_state(env_state_to_numpy(state))

    ball = state.ball._replace(x=state.ball.x.clone().fill_(-500))
    bad = state._replace(ball=ball, scores=state.scores.clone().fill_(-1),
                         p1=state.p1._replace(state=state.p1.state.clone().fill_(9)))
    with pytest.raises(AssertionError) as port_err:
        validate_state(bad)
    with pytest.raises(AssertionError) as jax_err:
        jax_validate_state(env_state_to_numpy(bad))
    assert "ball.x" in str(port_err.value) and "p1.state" in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        with trace_annotation("pikazoo_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        assert "pikazoo_region" in f.read()


def test_cli_every_flag_and_resume(tmp_path, capsys):
    """The wrapped CLI run with a checkpoint every 2 updates, a profile of
    update 3 and metrics; a second call resumes from update 4."""
    ckpt_dir, metrics = tmp_path / "ckpt", tmp_path / "metrics.jsonl"
    argv = ["--device", "cpu", "--num-envs", "64", "--rollout-length", "8",
            "--simplify-actions", "--ball-shaping", "0", "0", "0", "0", "0", "0", "0", "0",
            "--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "2",
            "--metrics", str(metrics)]
    runner = port_run.main(argv + ["--updates", "4", "--profile-dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert "resumed" not in out and "checkpointed at update 3" in out
    assert runner.update_index == 4 and runner.params["layers.2.kernel"].shape[1] == 13
    assert os.listdir(ckpt_dir) == ["latest"] and len(os.listdir(tmp_path / "prof")) == 1

    runner = port_run.main(argv + ["--updates", "1"])
    out = capsys.readouterr().out
    assert "resumed from update 4" in out and "done: 1 updates" in out
    assert runner.update_index == 5
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    headers = [row for row in rows if "provenance" in row]
    assert len(headers) == 2 and headers[0]["provenance"]["device_name"] == "cpu"
    assert [row["step"] for row in rows if "step" in row] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(row["loss"]) for row in rows if "step" in row)
