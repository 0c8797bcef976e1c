"""The learner step's cases, shared by ``tests/test_torch_learner_step*.py``
(no tests here).  One file a seat mix: the tier-1 command (``-n 6 --dist
loadfile``) hands each worker whole files, and a seat mix's six cases take
~2.5 min of a worker, each mostly JAX compiling its config's step.
A file imports ``host_library`` and ``one_thread`` with the cases: the
fixtures then serve its tests.

Each case runs ``FRAMES`` frames of seeded random actions (numpy; a few out
of range, which every side clamps alike) at a batch that is no multiple of
32, with a small winning score so that games end, and reset where the
config auto-resets.  On every frame the host (g++) build of
``csrc/learner_step.cu`` must equal both the port's eager step
(``step_batch_learner_fm`` on CPU tensors) and the JAX package's, bit for
bit: every ``EnvState`` leaf, the observation bits as int16, the reward bits
(seat 2's the float negation of seat 1's, -0.0 included) and
``terminated``."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from pikazoo_tpu_torch.core import learner_step
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.envs.pika_volley import SERVE_MODES
from torch_helpers import assert_same, bf16_bits

B, FRAMES = 45, 200  # two warps, the second ragged
# A game to 2, or to 1 where both seats are the rule AI, whose rallies are
# long: in 200 frames the 45 envs then see a few points.
WINNING_SCORE = {"human": 2, "ai_p1": 2, "ai_p2": 2, "ai_both": 1}
SEATS = {"human": {}, "ai_p1": dict(is_player1_computer=True),
         "ai_p2": dict(is_player2_computer=True),
         "ai_both": dict(is_player1_computer=True, is_player2_computer=True)}
# (serve mode, auto reset) of every case of a seat mix.
MODES = [(serve, auto) for serve in SERVE_MODES for auto in (True, False)]
MODE_IDS = [f"{serve}-{'auto_reset' if auto else 'no_reset'}" for serve, auto in MODES]


@pytest.fixture(scope="module")
def host_library(tmp_path_factory) -> ctypes.CDLL:
    """``csrc/learner_step.cu`` built with g++ for the host: its frame and
    pool code on emulated 32-lane warps, bound as the card's library is."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's frame code for the host")
    path = tmp_path_factory.mktemp("learner_host") / "liblearner_step_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
                    str(path), str(_build.CSRC_DIR / "learner_step.cu")],
                   check=True, capture_output=True)
    return learner_step.bind(ctypes.CDLL(str(path)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the eager AI frame is many tiny ops, which torch's
    threads would only oversubscribe the suite's workers with."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def actions(rng: np.random.Generator) -> np.ndarray:
    """(B,) int32 actions in [0, 18), one in twenty out of range."""
    a = rng.integers(0, 18, B)
    wild = rng.random(B) < 0.05
    return np.where(wild, rng.integers(-30, 50, B), a).astype(np.int32)


def hold_frames(lib: ctypes.CDLL, seats: str, serve: str, auto_reset: bool, seed: int):
    kw = dict(winning_score=WINNING_SCORE[seats], serve=serve, auto_reset=auto_reset,
              **SEATS[seats])
    jax_env, env = JaxZoo(JaxConfig(**kw)), PikaZoo(EnvConfig(**kw))
    jax_state, _ = jax_env.reset_batch(jax.random.key(seed), B)
    state = kernel_state = env_state_from_numpy(jax.device_get(jax_state))
    jax_step = jax.jit(jax_env.step_batch_learner_fm)
    rng = np.random.default_rng(seed)
    scored = ended = 0
    for t in range(FRAMES):
        a1, a2 = actions(rng), actions(rng)
        jax_state, jax_obs, jax_reward, jax_term = jax.device_get(
            jax_step(jax_state, jnp.asarray(a1), jnp.asarray(a2)))
        ta1, ta2 = torch.from_numpy(a1), torch.from_numpy(a2)
        state, obs, rewards, term = env.step_batch_learner_fm(state, ta1, ta2)
        kernel_state, k_obs, k_rewards, k_term = learner_step.launch(
            lib, env.config, kernel_state, ta1, ta2)
        where = f"frame {t}"
        got = env_state_to_numpy(kernel_state)
        assert_same(jax_state, got, where)
        assert_same(env_state_to_numpy(state), got, where)
        assert k_obs.dtype == torch.bfloat16 and k_obs.shape == (35, 2 * B)
        np.testing.assert_array_equal(bf16_bits(k_obs), bf16_bits(jax_obs), err_msg=where)
        np.testing.assert_array_equal(bf16_bits(k_obs), bf16_bits(obs), err_msg=where)
        r1 = jax_reward.astype(np.float32)
        want = np.concatenate([r1, -r1])
        assert k_rewards.dtype == torch.float32
        np.testing.assert_array_equal(k_rewards.numpy().view(np.int32), want.view(np.int32),
                                      err_msg=where)
        np.testing.assert_array_equal(k_rewards.numpy().view(np.int32),
                                      rewards.numpy().view(np.int32), err_msg=where)
        np.testing.assert_array_equal(k_term.numpy(), jax_term, err_msg=where)
        np.testing.assert_array_equal(k_term.numpy(), term.numpy(), err_msg=where)
        scored += int((jax_reward != 0).sum())
        ended += int(((jax_term == 1) & (jax_reward != 0)).sum())
    # The run saw points and games ending on a point (and, with auto reset,
    # the frames after them reset the game).
    assert scored > 0 and ended > 0, (scored, ended)
