"""The port's wrappers against the JAX package's, batch-shaped: the same
reset key and actions give bit-equal observations, rewards, termination,
episode statistics and states over 60 frames at B=8; the learner step
through a wrapper equals the wrapped ``step_batch``; and the trainer runs
through the wrappers where JAX's skips them (ROADMAP Queue 3, R1)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu import wrappers as jw
from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.train import PPOConfig as JaxPPOConfig
from pikazoo_tpu.train import make_ppo_trainer as jax_make_trainer
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch import wrappers as tw
from pikazoo_tpu_torch.convert import env_state_to_numpy
from pikazoo_tpu_torch.core.rng import randint, split
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu_torch.train.networks import normalize_obs
from torch_helpers import assert_same

B, FRAMES, SEED = 8, 60, 5
# winning_score=1: a point ends a game, so games end within the 60 frames.
KW = dict(winning_score=1, serve="random", auto_reset=True)
SHAPING = (0.5, -0.25, 0.125, 0.0, 0.0, 0.125, -0.25, 0.5)

# name: (JAX stack, port stack, actions a seat)
STACKS = {
    "simplify": (jw.SimplifyAction, tw.SimplifyAction, 13),
    "ball_position": (lambda e: jw.RewardByBallPosition(e, SHAPING),
                      lambda e: tw.RewardByBallPosition(e, SHAPING), 18),
    "normal_state_float": (lambda e: jw.RewardInNormalState(e, -0.01),
                           lambda e: tw.RewardInNormalState(e, -0.01), 18),
    "normal_state_int": (lambda e: jw.RewardInNormalState(e, 3),
                         lambda e: tw.RewardInNormalState(e, 3), 18),
    "normalize": (jw.NormalizeObservation, tw.NormalizeObservation, 18),
    "episode_stats": (jw.RecordEpisodeStatistics, tw.RecordEpisodeStatistics, 18),
    "stack": (lambda e: jw.NormalizeObservation(jw.RewardByBallPosition(
                  jw.SimplifyAction(e), SHAPING)),
              lambda e: tw.NormalizeObservation(tw.RewardByBallPosition(
                  tw.SimplifyAction(e), SHAPING)), 13),
}


def inner_state(state):
    """The wrapped EnvState and the wrapper's own leaves, as numpy."""
    if isinstance(state, (tw.transforms.EpisodeStatsState, jw.transforms.EpisodeStatsState)):
        return inner_state(state.inner) + [np.asarray(state.episode_return),
                                           np.asarray(state.episode_length)]
    if isinstance(state, (tw.transforms.SingleAgentState, jw.transforms.SingleAgentState)):
        return inner_state(state.inner) + [np.asarray(state.key).view(np.uint32)]
    if isinstance(state, tuple) and hasattr(state, "rng_key") and torch.is_tensor(state.rng_key):
        return [env_state_to_numpy(state)]
    return [jax.device_get(state)]


def assert_states(want, got, where):
    for w, g in zip(inner_state(want), inner_state(got), strict=True):
        assert_same(w, g, where)


def assert_ts(want, got, where, normalized):
    """Every leaf equal; normalised observations within one ulp: jitted,
    XLA divides by the constant span as a multiply by its reciprocal, which
    rounds differently from the true division on 2-3% of the entries."""
    if normalized:
        assert got.obs.dtype == torch.float32 and want.obs.dtype == np.float32
        np.testing.assert_array_max_ulp(got.obs.numpy(), want.obs, maxulp=1)
        want, got = want._replace(obs=0), got._replace(obs=0)
    assert_same(want, got, where)


@pytest.mark.parametrize("name", list(STACKS))
def test_wrapper_matches_jax(name):
    """Each wrapper and the stack ``NormalizeObservation(RewardByBallPosition(
    SimplifyAction(env)))``: every TimeStep leaf (and ``EpisodeStats``) and
    the state bit-equal, with dtypes; normalised observations within one
    ulp of JAX's (``assert_ts``)."""
    jax_wrap, port_wrap, n_actions = STACKS[name]
    jenv, env = jax_wrap(JaxZoo(JaxConfig(**KW))), port_wrap(PikaZoo(EnvConfig(**KW)))
    jstate, jts = jenv.reset_batch(jax.random.key(SEED), B)
    state, ts = env.reset_batch(SEED, B, device="cpu")
    normalized = name in ("normalize", "stack")
    assert_ts(jax.device_get(jts), ts, "reset", normalized)
    assert_states(jstate, state, "reset")
    step = jax.jit(jenv.step_batch)
    rng = np.random.default_rng(1)
    ended = 0
    for t in range(FRAMES):
        actions = rng.integers(0, n_actions, (B, 2)).astype(np.int32)
        jout = jax.device_get(step(jstate, jnp.asarray(actions)))
        out = env.step_batch(state, torch.from_numpy(actions))
        jstate, state = jout[0], out[0]
        assert_ts(jout[1], out[1], f"frame {t}", normalized)
        if len(out) == 3:
            assert_same(jout[2], out[2], f"frame {t} EpisodeStats")
        assert_states(jstate, state, f"frame {t}")
        ended += int(out[1].terminated.sum())
    assert ended > 0, "no game ended: termination was not exercised"


@pytest.mark.parametrize("side", ["player_1", "player_2"])
def test_convert_single_agent_matches_jax(side):
    """The single-agent view over SimplifyAction: the carried keys, the
    opponent's random actions (13 a seat, the inner env's count), the
    view and the inner state, bit-equal."""
    jenv = jw.ConvertSingleAgent(jw.SimplifyAction(JaxZoo(JaxConfig(**KW))), side)
    env = tw.ConvertSingleAgent(tw.SimplifyAction(PikaZoo(EnvConfig(**KW))), side)
    assert env.opponent_actions == jenv.opponent_actions == 13
    jstate, jts = jenv.reset_batch(jax.random.key(SEED), B)
    state, ts = env.reset_batch(SEED, B, device="cpu")
    assert_same(jax.device_get(jts), ts, "reset")
    step = jax.jit(jenv.step_batch)
    jax_opp = jax.jit(jax.vmap(lambda k: jax.random.randint(
        jax.random.split(k)[1], (), 0, 13, dtype=jnp.int32)))
    rng = np.random.default_rng(2)
    for t in range(FRAMES):
        np.testing.assert_array_equal(randint(split(state.key)[..., 1, :], (), 0, 13).numpy(),
                                      np.asarray(jax_opp(jstate.key)), err_msg=f"frame {t}")
        action = rng.integers(0, 13, B).astype(np.int32)
        jstate, jts = jax.device_get(step(jstate, jnp.asarray(action)))
        state, ts = env.step_batch(state, torch.from_numpy(action))
        assert ts.obs.shape == (B, 35) and ts.rewards.shape == (B,)
        assert_same(jts, ts, f"frame {t}")
        assert_states(jstate, state, f"frame {t}")


LEARNER_STACKS = {
    "simplify": tw.SimplifyAction,
    "ball_position": lambda e: tw.RewardByBallPosition(e, SHAPING),
    "cli_stack": lambda e: tw.SimplifyAction(tw.RewardByBallPosition(e, SHAPING)),
}


@pytest.mark.parametrize("name", list(LEARNER_STACKS))
def test_learner_step_equals_wrapped_step_batch(name):
    """``step_batch_learner_fm`` through the wrappers == the wrapped
    ``step_batch`` for the same actions: the state, both seats' rewards
    (float32, seat-blocked), termination, and the observations normalised
    feature-major as the rollout does it."""
    wrap = LEARNER_STACKS[name]
    env = wrap(PikaZoo(EnvConfig(**KW)))
    state, _ = env.reset_batch(SEED, B, device="cpu")
    learner_state = state
    rng = np.random.default_rng(3)
    shaped = 0
    for t in range(FRAMES):
        actions = torch.from_numpy(rng.integers(0, env.num_actions, (B, 2)).astype(np.int32))
        state, ts = env.step_batch(state, actions)
        learner_state, norm, reward, term = env.step_batch_learner_fm(
            learner_state, actions[:, 0], actions[:, 1])
        assert_same(env_state_to_numpy(state), env_state_to_numpy(learner_state), f"frame {t}")
        want_norm = torch.cat([normalize_obs(ts.obs[:, 0]).t(),
                               normalize_obs(ts.obs[:, 1]).t()], dim=1).to(torch.bfloat16)
        assert torch.equal(norm, want_norm), f"frame {t}"
        assert reward.dtype == torch.float32
        want_reward = torch.cat([ts.rewards[:, 0], ts.rewards[:, 1]]).to(torch.float32)
        assert torch.equal(reward, want_reward), f"frame {t}"
        assert torch.equal(term, ts.terminated), f"frame {t}"
        shaped += int((reward != reward.round()).sum())
    if name != "simplify":
        assert shaped > 0, "no shaping bonus was seen"


def test_r1_jax_trainer_bypasses_wrappers_the_port_does_not():
    """R1: the JAX wrappers forward ``step_batch_learner_fm`` to the inner
    env by ``__getattr__``, so JAX's trainer steps the raw env (raw actions
    0-12, no bonus).  The port's learner step maps the actions and adds the
    bonus; its trainer's rollout takes both."""
    jinner = JaxZoo(JaxConfig(**KW))
    jenv = jw.SimplifyAction(jw.RewardByBallPosition(jinner, SHAPING))
    assert jenv.step_batch_learner_fm.__self__ is jinner
    # JAX's trainer accepts the stack and rolls out on the inner env.
    jax_make_trainer(jenv, JaxPPOConfig(num_envs=B, rollout_length=4, num_minibatches=1,
                                        update_epochs=1, hidden=(16,), num_actions=13))

    inner = PikaZoo(EnvConfig(**KW))
    env = tw.SimplifyAction(tw.RewardByBallPosition(inner, SHAPING))
    cfg = PPOConfig(num_envs=B, rollout_length=8, num_minibatches=1, update_epochs=1,
                    hidden=(16,), num_actions=13, fused_update="off")
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device="cpu")
    runner = init_fn(0)
    uniforms = torch.rand((cfg.rollout_length, 1, 2 * B),
                          generator=torch.Generator().manual_seed(1))
    _, traj = train_step.rollout_fn(runner.params, runner.env_state, runner.last_obs, uniforms)
    # Replay the sampled 13-action choices through the wrapped step_batch:
    # the rollout's rewards are the shaped ones, frame by frame.
    state = runner.env_state
    for t in range(cfg.rollout_length):
        actions = torch.stack([traj.action[t, :B], traj.action[t, B:]], dim=1)
        state, ts = env.step_batch(state, actions)
        np.testing.assert_array_equal(
            traj.reward[t].numpy(), torch.cat([ts.rewards[:, 0], ts.rewards[:, 1]]).numpy())
    assert (traj.reward != traj.reward.round()).any(), "the bonus never reached the rollout"
    # The raw env's step on the same actions differs (unmapped, unshaped).
    raw_state, _, raw_reward, _ = inner.step_batch_learner_fm(
        runner.env_state, traj.action[0, :B], traj.action[0, B:])
    _, _, reward, _ = env.step_batch_learner_fm(runner.env_state, traj.action[0, :B],
                                                traj.action[0, B:])
    assert not torch.equal(raw_reward, reward)


@pytest.mark.parametrize("wrap", [
    tw.NormalizeObservation, tw.RecordEpisodeStatistics,
    lambda e: tw.RewardInNormalState(e, -0.01),
    lambda e: tw.ConvertSingleAgent(e, "player_1"),
    lambda e: tw.SimplifyAction(tw.NormalizeObservation(e))])
def test_trainer_refuses_wrapper_without_learner_step(wrap):
    env = wrap(PikaZoo(EnvConfig()))
    cfg = PPOConfig(num_envs=B, rollout_length=4, num_minibatches=1,
                    num_actions=getattr(env, "num_actions", 18))
    with pytest.raises(ValueError, match="learner step"):
        make_ppo_trainer(env, cfg, device="cpu")


def test_trainer_refuses_action_count_of_another_env():
    with pytest.raises(ValueError, match="num_actions"):
        make_ppo_trainer(tw.SimplifyAction(PikaZoo(EnvConfig())), PPOConfig(), device="cpu")
    with pytest.raises(ValueError, match="num_actions"):
        make_ppo_trainer(PikaZoo(EnvConfig()), PPOConfig(num_actions=13), device="cpu")
