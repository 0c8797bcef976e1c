"""The committed trained policy carried across: restored through the JAX
package's checkpoint, converted with ``params_from_flax``, the port's
``ActorCritic`` gives JAX's logits on real observations."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.train import PPOConfig as JaxPPOConfig
from pikazoo_tpu.train import make_ppo_trainer as jax_make_trainer
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import params_from_flax
from pikazoo_tpu_torch.train import ActorCritic

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "vs_ai_policy")


def real_observations(batch=256, frames=60, every=5):
    """(N, 35) int32 observations of seat 1 from random-vs-rule-AI play."""
    env = PikaZoo(EnvConfig(is_player2_computer=True))
    state, ts = env.reset_batch(5, batch, device="cpu")
    rng = np.random.default_rng(5)
    seen = []
    for t in range(frames):
        actions = torch.from_numpy(rng.integers(0, 18, (batch, 2)).astype(np.int32))
        state, ts = env.step_batch(state, actions)
        if t % every == 0:
            seen.append(ts.obs[:, 0])
    return torch.cat(seen).numpy()


@pytest.mark.skipif(not os.path.isdir(ARTIFACT), reason="trained artifact not present")
def test_vs_ai_policy_carries_across():
    pytest.importorskip("orbax.checkpoint")
    from pikazoo_tpu.train import checkpoint as ckpt

    # The recipe of tests/test_trained_artifact.py:23-29.
    env = JaxZoo(JaxConfig(winning_score=15, auto_reset=True, is_player2_computer=True))
    cfg = JaxPPOConfig(num_envs=8192, rollout_length=128, num_minibatches=8,
                       update_epochs=4, hidden=(256, 256), entropy_coef=0.01,
                       learner_seats="p1", learning_rate=5e-4)
    init_fn, _, network = jax_make_trainer(env, cfg)
    runner = ckpt.restore(ARTIFACT, init_fn(jax.random.key(0)))

    net = ActorCritic(hidden=(256, 256))
    net.load_state_dict(params_from_flax(jax.device_get(runner.params)))
    obs = real_observations()
    want, _ = network.apply(runner.params, jnp.asarray(obs))
    want = np.asarray(want)
    with torch.no_grad():
        logits, value = net(torch.from_numpy(obs))
    assert np.isfinite(value.numpy()).all()
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-2, atol=1e-2)
    agree = (logits.numpy().argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree
