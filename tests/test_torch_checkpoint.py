"""Checkpoint and resume of the port's trainer: an in-process round trip
gives the next update exactly, a resumed run equals an uninterrupted one bit
for bit, the crash-safe swap recovers a stranded ``.new`` and falls back to
``.old`` as the JAX package's does (tests/test_train_ppo.py), and a CLI run
killed with SIGKILL resumes from its checkpoint (tests/test_restart_drill.py)."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu_torch.train import checkpoint as ckpt
from pikazoo_tpu_torch.wrappers import RewardByBallPosition, SimplifyAction

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPING = (0.5, -0.25, 0.125, 0.0, 0.0, 0.125, -0.25, 0.5)
SIZES = dict(num_envs=64, rollout_length=8, num_minibatches=2, update_epochs=2,
             hidden=(32, 32), fused_update="off")


def trainer(wrapped=False, shuffle=False):
    env = PikaZoo(EnvConfig(winning_score=2, auto_reset=True))
    if wrapped:
        env = SimplifyAction(RewardByBallPosition(env, SHAPING))
    cfg = PPOConfig(**SIZES, num_actions=env.num_actions, shuffle_minibatches=shuffle)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device="cpu")
    return init_fn, train_step


def leaves(tree, prefix=""):
    """(name, tensor or int) of a runner, the generator as its state."""
    if isinstance(tree, torch.Generator):
        yield prefix + "key", tree.get_state()
    elif isinstance(tree, tuple):
        for f, sub in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from leaves(sub, f"{prefix}{f}.")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def assert_runners_equal(a, b):
    for (name, x), (name_b, y) in zip(leaves(a), leaves(b), strict=True):
        assert name == name_b
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def test_round_trip_gives_the_next_update_exactly(tmp_path):
    init_fn, train_step = trainer()
    runner, _ = train_step(init_fn(3))
    path = str(tmp_path / "latest")
    ckpt.save(path, runner)
    restored = ckpt.restore(path, init_fn(4))
    assert_runners_equal(runner, restored)
    assert restored.key is not runner.key
    r1, m1 = train_step(runner)
    r2, m2 = train_step(restored)
    assert_runners_equal(r1, r2)
    for x, y in zip(m1, m2, strict=True):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("wrapped,shuffle", [(False, False), (True, True)],
                         ids=["plain", "wrapped_shuffled"])
def test_resumed_run_equals_uninterrupted_run(tmp_path, wrapped, shuffle):
    """B=64, T=8: 3 updates in one go == 2 updates, save, restore into a
    runner of another seed, 1 more; the shuffle draws its permutation from
    the restored generator."""
    init_fn, train_step = trainer(wrapped, shuffle)
    straight = init_fn(0)
    for _ in range(3):
        straight, _ = train_step(straight)
    first = init_fn(0)
    for _ in range(2):
        first, _ = train_step(first)
    path = str(tmp_path / "latest")
    ckpt.save(path, first)
    del first
    resumed = ckpt.restore(ckpt.latest_restorable(path), init_fn(7))
    assert resumed.update_index == 2
    resumed, _ = train_step(resumed)
    assert_runners_equal(straight, resumed)


def test_restore_refuses_another_shape(tmp_path):
    init_fn, _ = trainer()
    path = str(tmp_path / "latest")
    ckpt.save(path, init_fn(0))
    env = PikaZoo(EnvConfig(winning_score=2))
    other, _, _ = make_ppo_trainer(env, PPOConfig(**dict(SIZES, num_envs=32)), device="cpu")
    with pytest.raises(ValueError, match="env_state"):
        ckpt.restore(path, other(0))


def test_recovers_stranded_new_and_falls_back_to_old(tmp_path, monkeypatch):
    """A crash between save()'s renames leaves the newest complete
    checkpoint at ``path.new``: latest_restorable and save promote it.  A
    crash inside the write leaves only a staging file, which is ignored; a
    crash after ``path`` moved to ``.old`` restores from ``.old``."""
    init_fn, train_step = trainer()
    runner, _ = train_step(init_fn(3))
    runner2, _ = train_step(runner)
    path = str(tmp_path / "latest")
    ckpt.save(path, runner)
    ckpt.save(path, runner2)
    assert sorted(os.listdir(tmp_path)) == ["latest"]

    # Stranded at .new, nothing at path: promoted, not ignored.
    os.rename(path, path + ".new")
    assert ckpt.latest_restorable(path) == path
    assert ckpt.restore(path, init_fn(4)).update_index == runner2.update_index

    # save() promotes a stranded .new before it writes; a crash inside the
    # write then leaves it as the restorable checkpoint.
    os.rename(path, path + ".new")

    def boom(*args, **kwargs):
        raise RuntimeError("simulated mid-save crash")

    monkeypatch.setattr(torch, "save", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        ckpt.save(path, runner)
    monkeypatch.undo()
    assert ckpt.latest_restorable(path) == path
    assert ckpt.restore(path, init_fn(4)).update_index == runner2.update_index
    assert os.path.isfile(path + ".new.partial")

    # Crash after path -> .old, before .new -> path: the newer .new is
    # promoted over .old.
    ckpt.save(path, runner)
    os.rename(path, path + ".old")
    ckpt.save(path + ".new", runner2)
    assert ckpt.latest_restorable(path) == path
    assert ckpt.restore(path, init_fn(4)).update_index == runner2.update_index

    # Only .old left (path lost): restore falls back to it.
    os.remove(path)
    assert ckpt.latest_restorable(path) == path + ".old"
    assert ckpt.restore(path + ".old", init_fn(4)).update_index == runner.update_index
    assert ckpt.latest_restorable(str(tmp_path / "none")) is None


def _launch(tmp_path, updates):
    cmd = [sys.executable, "-m", "pikazoo_tpu_torch.train.run", "--device", "cpu",
           "--num-envs", "64", "--rollout-length", "8", "--updates", str(updates),
           "--checkpoint-dir", str(tmp_path / "ckpt"), "--checkpoint-every", "2",
           "--metrics", str(tmp_path / f"metrics_{updates}.jsonl"), "--seed", "3"]
    return subprocess.Popen(cmd, cwd=_REPO, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def test_kill_and_resume_via_cli(tmp_path):
    """A CLI run is SIGKILLed after its first checkpoint; relaunched with the
    same directory it resumes (not a cold start) and its metrics continue
    from the resume point."""
    proc = _launch(tmp_path, updates=200)
    latest = tmp_path / "ckpt" / "latest"
    deadline = time.time() + 300
    try:
        while time.time() < deadline:
            time.sleep(0.2)
            if proc.poll() is not None:
                raise AssertionError(f"run exited before a checkpoint:\n{proc.stdout.read()}")
            if latest.is_file():
                break
        else:
            raise AssertionError("no checkpoint within 300 s")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)

    proc = _launch(tmp_path, updates=1)
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    assert "resumed from update" in out, f"a cold start:\n{out}"
    resumed_at = int(out.split("resumed from update")[1].split()[0])
    assert resumed_at >= 2 and resumed_at % 2 == 0, out
    assert "done: 1 updates" in out, out
    rows = [json.loads(line) for line in (tmp_path / "metrics_1.jsonl").read_text().splitlines()]
    steps = [row["step"] for row in rows if "step" in row]
    assert steps == [resumed_at]
    assert np.isfinite([row["loss"] for row in rows if "step" in row]).all()
