"""The slice as a whole: the port's reset_batch + step_batch == the JAX
package's jit(step_batch), every leaf of every frame, exactly.

Both sides start from the same key and take the same numpy-seeded actions.
Each case uses a small winning score, so the horizon sees round ends and
game ends (with a computer seat, the port runs its landing simulation every
frame, through the kernel wrapper's plain path on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import env_state_to_numpy
from torch_helpers import assert_same

B = 64

# (serve, auto_reset, player 1 computer, player 2 computer, winning score, frames)
CASES = {
    "human-human-winner-auto": ("winner", True, False, False, 2, 300),
    "human-human-random-noauto": ("random", False, False, False, 2, 300),
    "ai-human-alternate-auto": ("alternate", True, True, False, 2, 120),
    # AI rallies are long: the first rounds end after ~150 frames.
    "ai-ai-random-auto": ("random", True, True, True, 1, 240),
}


def assert_frame_equal(frame, jax_out, torch_out):
    state, ts = torch_out
    assert_same(jax.device_get(jax_out), (env_state_to_numpy(state), ts),
                f"frame {frame}:")


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case):
    serve, auto_reset, ai1, ai2, winning_score, frames = CASES[case]
    kw = dict(winning_score=winning_score, serve=serve, auto_reset=auto_reset,
              is_player1_computer=ai1, is_player2_computer=ai2)
    jax_env, env = JaxZoo(JaxConfig(**kw)), PikaZoo(EnvConfig(**kw))
    key = jax.random.key(11)
    jax_out = jax_env.reset_batch(key, B)
    out = env.reset_batch(np.asarray(jax.random.key_data(key)), B, device="cpu")
    assert_frame_equal(-1, jax_out, out)

    jax_step = jax.jit(jax_env.step_batch)
    rng = np.random.default_rng(sum(map(ord, case)))
    round_ends = game_ends = 0
    for t in range(frames):
        actions = rng.integers(0, 18, (B, 2)).astype(np.int32)
        jax_out = jax_step(jax_out[0], jnp.asarray(actions))
        out = env.step_batch(out[0], torch.from_numpy(actions))
        assert_frame_equal(t, jax_out, out)
        round_ends += int(out[1].round_ended.sum())
        game_ends += int(out[1].terminated.sum())
    assert round_ends > 0 and game_ends > 0, (round_ends, game_ends)


def test_single_env_reset_and_step_match_jax():
    """``reset(key)`` gives 0-d leaves, like the JAX package's unbatched
    ``reset``, and ``step`` takes (2,) actions for it."""
    jax_env, env = JaxZoo(JaxConfig(serve="random")), PikaZoo(EnvConfig(serve="random"))
    key = jax.random.key(4)
    jax_out = jax_env.reset(key)
    out = env.reset(np.asarray(jax.random.key_data(key)), device="cpu")
    assert out[0].ball.x.shape == () and out[1].obs.shape == (2, 35)
    assert_frame_equal(-1, jax_out, out)
    jax_step = jax.jit(jax_env.step)
    rng = np.random.default_rng(4)
    for t in range(100):
        actions = rng.integers(0, 18, 2).astype(np.int32)
        jax_out = jax_step(jax_out[0], jnp.asarray(actions))
        out = env.step(out[0], torch.from_numpy(actions))
        assert_frame_equal(t, jax_out, out)
