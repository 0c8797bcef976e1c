"""Parity replays through the port's oracle mode.

The counterparts of ``tests/test_parity_fuzz.py`` and the reference part of
``tests/test_parity_wrappers.py`` record the reference env with the port's
copy of the harness and replay through ``pikazoo_tpu_torch.parity``; like
JAX's, they skip when the reference checkout is absent (the port's harness
reads its directory from ``PIKAZOO_REFERENCE_PATH``, set here to the JAX
harness's default).  The replay helper itself is held here on a
``ReferenceTrace`` recorded from the JAX env's own oracle run.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.parity import harness as jax_harness
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.parity import (ReferenceTrace, pad_oracle, record_reference_trace,
                                      reference_available, replay_and_compare)
from pikazoo_tpu_torch.wrappers import RewardByBallPosition, SimplifyAction

os.environ.setdefault("PIKAZOO_REFERENCE_PATH", jax_harness.REFERENCE_PATH)
needs_reference = pytest.mark.skipif(not reference_available(),
                                     reason="reference repo not mounted")

SEATS = [(False, False), (True, False), (False, True), (True, True)]
SERVES = ["winner", "alternate", "random"]
SEEDS_PER_CONFIG = 4
SHAPING = (0.5, -0.25, 0.125, 0.0, 0.0, 0.125, -0.25, 0.5)


def random_actions(t, rng):
    return rng.integers(0, 18, size=2)


@needs_reference
@pytest.mark.parametrize("serve", SERVES)
@pytest.mark.parametrize("p1c,p2c", SEATS)
def test_parity_fuzz(p1c, p2c, serve):
    cfg = EnvConfig(auto_reset=False, winning_score=3, serve=serve,
                    is_player1_computer=p1c, is_player2_computer=p2c)
    env = PikaZoo(cfg)
    base = (SEATS.index((p1c, p2c)) * len(SERVES) + SERVES.index(serve)) \
        * SEEDS_PER_CONFIG + 100
    finished = 0
    for seed in range(base, base + SEEDS_PER_CONFIG):
        trace = record_reference_trace(
            seed, 8000, random_actions, winning_score=3, serve=serve,
            is_player1_computer=p1c, is_player2_computer=p2c)
        replay_and_compare(trace, cfg, env=env, device="cpu")
        finished += bool(trace.terminations[-1])
    assert finished == SEEDS_PER_CONFIG


def _reference_wrap(env):
    import pikazoo.wrappers as ref_wrappers
    return ref_wrappers.SimplifyAction(
        ref_wrappers.RewardByBallPosition(env, additional_reward=SHAPING))


@needs_reference
def test_parity_simplify_and_ball_position_rewards():
    trace = record_reference_trace(
        21, 4000, lambda t, rng: rng.integers(0, 13, size=2),
        serve="random", wrap=_reference_wrap)
    env = SimplifyAction(RewardByBallPosition(
        PikaZoo(EnvConfig(auto_reset=False, serve="random")), additional_reward=SHAPING))
    oracle = pad_oracle(trace.draws, device="cpu")
    state, ts = env.reset(0, "cpu", oracle=oracle)
    np.testing.assert_array_equal(ts.obs.numpy(), trace.obs[0])
    for t in range(trace.actions.shape[0]):
        state, ts = env.step(state, torch.from_numpy(trace.actions[t]), oracle)
        np.testing.assert_array_equal(ts.obs.numpy(), trace.obs[t + 1],
                                      err_msg=f"obs mismatch at {t}")
        np.testing.assert_allclose(ts.rewards.numpy(), trace.rewards[t], rtol=0, atol=1e-6,
                                   err_msg=f"reward mismatch at {t}")
        assert bool(ts.terminated) == bool(trace.terminations[t])


def jax_oracle_trace(cfg: JaxConfig, seed: int, steps: int) -> ReferenceTrace:
    """A ``ReferenceTrace`` of the JAX env's own oracle run: numpy-seeded
    draws in [0, 2) and actions, recorded as the harness records the
    reference, until termination."""
    gen = np.random.default_rng(seed)
    draws = gen.integers(0, 2, 4096).astype(np.int32)
    env = JaxZoo(cfg)
    oracle = jnp.asarray(draws)
    state, ts = env.reset(jax.random.key(0), oracle=oracle)
    step = jax.jit(env.step)
    obs, rewards, terms, scores, counts, actions = [np.asarray(ts.obs)], [], [], [], [], []
    after_reset = int(state.draw_counter)
    for _ in range(steps):
        a = gen.integers(0, 18, 2).astype(np.int32)
        state, ts = step(state, jnp.asarray(a), oracle)
        actions.append(a)
        obs.append(np.asarray(ts.obs))
        rewards.append(np.asarray(ts.rewards, np.float64))
        terms.append(bool(ts.terminated))
        scores.append(np.asarray(ts.scores))
        counts.append(int(state.draw_counter))
        if terms[-1]:
            break
    return ReferenceTrace(np.asarray(actions), np.asarray(obs), np.asarray(rewards),
                          np.asarray(terms), np.asarray(scores, np.int32),
                          draws[:counts[-1]], after_reset, np.asarray(counts, np.int32))


@pytest.mark.parametrize("p1c,p2c,serve", [(False, False, "random"), (False, True, "winner")],
                         ids=["human-random-serve", "human-ai"])
def test_replay_of_a_jax_oracle_trace(p1c, p2c, serve):
    kw = dict(winning_score=2, serve=serve, auto_reset=False,
              is_player1_computer=p1c, is_player2_computer=p2c)
    trace = jax_oracle_trace(JaxConfig(**kw), 11, 1500)
    assert trace.terminations[-1], "the trace should reach the game's end"
    assert np.abs(trace.rewards).sum() >= 2
    replay_and_compare(trace, EnvConfig(**kw), device="cpu")
    broken = ReferenceTrace(**{**trace.__dict__, "draw_count_after_step":
                               trace.draw_count_after_step + (np.arange(len(trace.actions)) == 5)})
    with pytest.raises(AssertionError, match="draw counter mismatch at step 5"):
        replay_and_compare(broken, EnvConfig(**kw), device="cpu")


def test_replay_needs_pettingzoo_semantics():
    trace = jax_oracle_trace(JaxConfig(auto_reset=False), 1, 3)
    with pytest.raises(ValueError, match="auto_reset"):
        replay_and_compare(trace, EnvConfig(), device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        pad_oracle(np.zeros(10, np.int32), capacity=4, device="cpu")
