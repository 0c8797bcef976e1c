"""The learner's observation layouts and env steps against the JAX package:
``assemble_norm_obs_{blocked,fm}`` and ``step_batch_learner{,_fm}`` are
bit-exact, frame by frame, over AI-vs-random play."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.envs.observations import assemble_norm_obs_blocked as jax_blocked
from pikazoo_tpu.envs.observations import assemble_norm_obs_fm as jax_fm
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from pikazoo_tpu_torch.envs.observations import (assemble_norm_obs_blocked,
                                                 assemble_norm_obs_fm)
from torch_helpers import assert_same, bf16_bits

B, FRAMES = 64, 50
KW = dict(winning_score=2, is_player2_computer=True)


def test_learner_steps_bit_exact_over_ai_vs_random_play():
    """Seat 1 random, seat 2 the rule AI: the env state, both observation
    layouts, reward and termination equal JAX's on every frame."""
    jax_env, env = JaxZoo(JaxConfig(**KW)), PikaZoo(EnvConfig(**KW))
    jax_state, _ = jax_env.reset_batch(jax.random.key(3), B)
    state = env_state_from_numpy(jax.device_get(jax_state))

    @jax.jit
    def jax_step(s, a1, a2):
        s1, blocked, r, term = jax_env.step_batch_learner(s, a1, a2)
        s2, fm, r2, term2 = jax_env.step_batch_learner_fm(s, a1, a2)
        return s1, blocked, fm, r, term

    rng = np.random.default_rng(0)
    rewarded = 0
    for t in range(FRAMES):
        a1 = rng.integers(0, 18, B).astype(np.int32)
        a2 = rng.integers(0, 18, B).astype(np.int32)
        jax_state, blocked, fm, reward, term = jax.device_get(
            jax_step(jax_state, jnp.asarray(a1), jnp.asarray(a2)))
        ta1, ta2 = torch.from_numpy(a1), torch.from_numpy(a2)
        state_b, got_blocked, got_r, got_term = env.step_batch_learner(state, ta1, ta2)
        state, got_fm, got_r2, got_term2 = env.step_batch_learner_fm(state, ta1, ta2)
        assert_same(jax_state, env_state_to_numpy(state), f"frame {t}")
        assert_same(jax_state, env_state_to_numpy(state_b), f"frame {t}")
        assert got_blocked.dtype == got_fm.dtype == torch.bfloat16
        assert got_blocked.shape == (2 * B, 35) and got_fm.shape == (35, 2 * B)
        np.testing.assert_array_equal(bf16_bits(got_blocked), bf16_bits(blocked),
                                      err_msg=f"frame {t}")
        np.testing.assert_array_equal(bf16_bits(got_fm), bf16_bits(fm),
                                      err_msg=f"frame {t}")
        np.testing.assert_array_equal(got_r.numpy(), reward)
        # The feature-major step returns both seats' rewards, as float32.
        assert got_r2.dtype == torch.float32
        np.testing.assert_array_equal(got_r2.numpy(),
                                      np.concatenate([reward, -reward]).astype(np.float32))
        for got in (got_term, got_term2):
            np.testing.assert_array_equal(got.numpy(), term)
        rewarded += int((reward != 0).sum())
    assert rewarded > 0, "no point was scored: the test saw no scoring frame"


def test_assemble_norm_obs_bit_exact_mid_game():
    """Both layouts straight from a mid-game state with set latches; the
    feature-major layout is the transpose of the blocked one."""
    jax_env = JaxZoo(JaxConfig(serve="random"))
    state, _ = jax_env.reset_batch(jax.random.key(11), B)
    step = jax.jit(jax_env.step_batch)
    rng = np.random.default_rng(4)
    for _ in range(30):
        state, _ = step(state, jnp.asarray(rng.integers(0, 18, (B, 2)), jnp.int32))
    want = jax.device_get(state)
    assert want.power_hit_key_down_prev.any()
    jax_args = (state.p1, state.p2, state.ball, state.power_hit_key_down_prev)
    port = env_state_from_numpy(want)
    args = (port.p1, port.p2, port.ball, port.power_hit_key_down_prev)
    blocked = assemble_norm_obs_blocked(*args)
    fm = assemble_norm_obs_fm(*args)
    np.testing.assert_array_equal(bf16_bits(blocked), bf16_bits(jax_blocked(*jax_args)))
    np.testing.assert_array_equal(bf16_bits(fm), bf16_bits(jax_fm(*jax_args)))
    np.testing.assert_array_equal(bf16_bits(fm), bf16_bits(blocked.t().contiguous()))
