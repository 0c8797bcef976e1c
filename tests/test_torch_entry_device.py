"""The port's entry points run on the card unless the caller asks for the
CPU: the default ``device`` of ``PikaZoo.reset`` / ``reset_batch``,
``make_ppo_trainer``, the PettingZoo drop-in (``compat.raw_env`` /
``pikazoo_v0.env``) and the parity replay is CUDA, and the training CLI
never drops to the CPU on its own."""

import inspect

import pytest
import torch

from pikazoo_tpu_torch import EnvConfig, PikaZoo, compat, pikazoo_v0
from pikazoo_tpu_torch.parity import replay_and_compare
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu_torch.train import run as port_run


@pytest.mark.parametrize("fn", [PikaZoo.reset, PikaZoo.reset_batch, make_ppo_trainer,
                                compat.raw_env, replay_and_compare],
                         ids=["reset", "reset_batch", "make_ppo_trainer", "compat.raw_env",
                              "replay_and_compare"])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_pettingzoo_drop_in_without_a_card_raises(monkeypatch):
    """``pikazoo_v0.env()`` builds its env on the card: without one it
    raises instead of running on the CPU; ``device="cpu"`` runs there."""
    assert pikazoo_v0.env is compat.env and pikazoo_v0.raw_env is compat.raw_env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        pikazoo_v0.env(seed=0)
    env = pikazoo_v0.env(seed=0, device="cpu")
    env.reset()
    assert env._state.scores.device.type == "cpu"


def test_cli_defaults_to_the_card():
    assert port_run.parse_args([]).device == "cuda"


def test_cli_without_a_card_raises_instead_of_training_on_the_cpu(monkeypatch, capsys):
    """Without ``--device cpu`` and without a card, the CLI raises before it
    builds anything; with ``--device cpu`` the same run trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--num-envs", "8", "--rollout-length", "8", "--updates", "1"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_run.main(argv)
    assert "update 0" not in capsys.readouterr().out
    port_run.main(argv + ["--device", "cpu"])
    assert "done: 1 updates" in capsys.readouterr().out


def test_explicit_cpu_builds_on_the_cpu():
    env = PikaZoo(EnvConfig(winning_score=2))
    state, ts = env.reset_batch(0, 4, device="cpu")
    assert state.scores.device.type == "cpu" and ts.obs.device.type == "cpu"
    init_fn, train_step, _ = make_ppo_trainer(
        env, PPOConfig(num_envs=4, rollout_length=2, num_minibatches=1, update_epochs=1,
                       hidden=(16,)), device="cpu")
    assert train_step.provenance["backend"] == "cpu"
    assert init_fn(0).params["layers.0.kernel"].device.type == "cpu"
