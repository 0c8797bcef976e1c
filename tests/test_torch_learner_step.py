"""The learner step's kernel, ``csrc/learner_step.cu``, on the CPU.

The kernel runs only on a card (``chip_smoke.py`` holds it against the plain
version there), but its frame code is plain C++ under a host compiler: built
with g++, ``core.learner_step.launch`` drives it on CPU tensors as the card's
library is driven.  Here, with human seats, the host build equals the
eager step and JAX's frame by frame (``learner_step_cases``; the files
``test_torch_learner_step_ai_*.py`` hold the seat mixes with a computer);
and the wrapper's layout, checks and dispatch, and the trainer's one call a
frame through the env stack."""

import numpy as np
import pytest
import torch

from learner_step_cases import (B, MODE_IDS, MODES, actions, hold_frames,  # noqa: F401
                                host_library, one_thread)
from pikazoo_tpu_torch.core import learner_step
from pikazoo_tpu_torch.core.learner_step import ROWS, launch
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer

CONFIG = EnvConfig(winning_score=2, is_player2_computer=True)


@pytest.mark.parametrize("serve,auto_reset", MODES, ids=MODE_IDS)
def test_host_build_matches_eager_and_jax(host_library, serve, auto_reset):
    hold_frames(host_library, "human", serve, auto_reset, seed=10)


def played_state(frames: int = 40, seed: int = 3):
    """A mid-game CPU state after ``frames`` eager frames of random play."""
    env = PikaZoo(CONFIG)
    state, _ = env.reset_batch(seed, B, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        state, *_ = env.step_batch_learner_fm(state, torch.from_numpy(actions(rng)),
                                              torch.from_numpy(actions(rng)))
    return env, state


def leaves(state):
    """The state's tensors in field order."""
    return [leaf for part in state for leaf in (part if isinstance(part, tuple) else (part,))]


def test_new_state_is_views_of_one_buffer(host_library):
    """The new state's leaves are contiguous views of one buffer of 54 x B
    int32, each laid out as its leaf's shape says."""
    env, state = played_state()
    a = torch.zeros(B, dtype=torch.int32)
    new, obs, rewards, terminated = launch(host_library, env.config, state, a, a)
    assert len({leaf.untyped_storage().data_ptr() for leaf in leaves(new)}) == 1
    assert new.scores.untyped_storage().nbytes() == ROWS * B * 4
    for old, leaf in zip(leaves(state), leaves(new), strict=True):
        assert leaf.is_contiguous() and leaf.shape == old.shape and leaf.dtype == torch.int32
    assert terminated.data_ptr() == new.game_ended.data_ptr()
    assert obs.shape == (35, 2 * B) and rewards.shape == (2 * B,)


def test_reads_any_leaves_in_place_and_never_writes_them(host_library):
    """The state it returned (views of one buffer), a clone of it, and a
    state whose leaves are strided views of other tensors give the same
    step; the input leaves are left as they were."""
    env, state = played_state()
    rng = np.random.default_rng(5)
    a1, a2 = torch.from_numpy(actions(rng)), torch.from_numpy(actions(rng))
    returned, *_ = launch(host_library, env.config, state, a1, a1)
    before = [leaf.clone() for leaf in leaves(returned)]
    strided = type(returned)(*[
        type(part)(*[torch.stack([leaf, leaf + 7], dim=-1)[..., 0] for leaf in part])
        if isinstance(part, tuple) else
        torch.stack([part, part + 7], dim=0)[0].t().contiguous().t()
        for part in returned])
    assert not strided.p1.x.is_contiguous()
    outs = [launch(host_library, env.config, returned, a1, a2)]
    outs += [launch(host_library, env.config, s, a1, a2)
             for s in (tuple_clone(returned), strided)]
    for leaf, was in zip(leaves(returned), before):
        assert torch.equal(leaf, was)
    for out in outs[1:]:
        for got, want in zip(flat(out), flat(outs[0]), strict=True):
            assert torch.equal(got, want)


def tuple_clone(state):
    """A copy of the state in new tensors."""
    return type(state)(*[type(part)(*[leaf.clone() for leaf in part])
                         if isinstance(part, tuple) else part.clone() for part in state])


def flat(out):
    """A step's outputs as integer bits."""
    state, obs, rewards, terminated = out
    return [*leaves(state), obs.view(torch.int16), rewards.view(torch.int32), terminated]


def test_actions_of_any_integer_type_clamp_as_the_eager_step(host_library):
    """int64 actions past int32's range and negative ones decode as the
    eager step decodes them (JAX's gather clamp)."""
    env, state = played_state()
    wild = torch.tensor([2 ** 33 + 1, -1, -18, -19, -(2 ** 40), 17, 18, 99] * 6)[:B]
    want = env.step_batch_learner_fm_plain(state, wild, wild.flip(0))
    got = launch(host_library, env.config, state, wild, wild.flip(0))
    for g, w in zip(flat(got), flat(want), strict=True):
        assert torch.equal(g, w)


def test_refuses_leaves_and_actions_it_does_not_take(host_library):
    env, state = played_state(frames=1)
    a = torch.zeros(B, dtype=torch.int32)
    bad = state._replace(step_count=state.step_count.long())
    with pytest.raises(ValueError, match="int32 state leaves"):
        launch(host_library, env.config, bad, a, a)
    bad = state._replace(scores=state.scores[:, :1])
    with pytest.raises(ValueError, match="int32 state leaves"):
        launch(host_library, env.config, bad, a, a)
    with pytest.raises(ValueError, match="actions"):
        launch(host_library, env.config, state, a[:-1], a)


def test_cpu_state_takes_the_plain_version():
    """On the CPU the env step runs the eager ops and launches nothing; the
    kernel's wrapper refuses a CPU state."""
    env, state = played_state(frames=1)
    a = torch.zeros(B, dtype=torch.int32)
    before = learner_step.learner_step.launches
    env.step_batch_learner_fm(state, a, a)
    assert learner_step.learner_step.launches == before
    with pytest.raises(ValueError, match="runs on CUDA"):
        learner_step.learner_step(env.config, state, a, a)


class CountingEnv:
    """An env layer that passes every call on and counts the learner steps."""

    def __init__(self, env):
        self.env, self.num_actions, self.config = env, env.num_actions, env.config
        self.calls = 0

    def reset_batch(self, *args, **kwargs):
        return self.env.reset_batch(*args, **kwargs)

    def step_batch_learner_fm(self, state, a1, a2):
        self.calls += 1
        return self.env.step_batch_learner_fm(state, a1, a2)


def test_rollout_calls_the_env_stack_once_a_frame():
    """The trainer's rollout steps through the env stack's
    ``step_batch_learner_fm`` once a frame, so a wrapper's per-frame Python
    runs every frame."""
    env = CountingEnv(PikaZoo(EnvConfig(winning_score=2)))
    cfg = PPOConfig(num_envs=16, rollout_length=8, num_minibatches=2, update_epochs=1,
                    hidden=(16, 16))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device="cpu")
    runner = init_fn(0)
    for update in (1, 2):
        runner, _ = train_step(runner)
        assert env.calls == update * cfg.rollout_length
