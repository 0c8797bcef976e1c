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


# How pikazoo_tpu_torch/policies/<name>.pt were made: each artifact restored
# through the JAX package's checkpoint with its training recipe
# (tests/test_trained_artifact.py), its params through params_from_flax,
# saved with torch.save beside hidden, num_actions, activation and
# learner_seats.
POLICY_RECIPES = {
    "vs_ai_policy": (JaxConfig(winning_score=15, auto_reset=True, is_player2_computer=True),
                     JaxPPOConfig(num_envs=8192, rollout_length=128, num_minibatches=8,
                                  update_epochs=4, hidden=(256, 256), entropy_coef=0.01,
                                  learner_seats="p1", learning_rate=5e-4)),
    "selfplay_policy": (JaxConfig(auto_reset=True),
                        JaxPPOConfig(num_envs=8192, rollout_length=128)),
    "selfplay_policy_xl": (JaxConfig(auto_reset=True),
                           JaxPPOConfig(num_envs=8192, rollout_length=128)),
}


@pytest.mark.parametrize("name", list(POLICY_RECIPES))
def test_committed_policy_equals_its_artifact(name):
    """Each committed ``.pt`` == ``params_from_flax`` of its orbax artifact,
    bit for bit, loads with ``weights_only=True`` and stays well under 1 MB;
    ``load_policy`` gives the module with those params."""
    pytest.importorskip("orbax.checkpoint")
    from pikazoo_tpu.train import checkpoint as ckpt
    from pikazoo_tpu_torch.policies import load_policy, policy_path

    artifact = os.path.join(os.path.dirname(ARTIFACT), name)
    if not os.path.isdir(artifact):
        pytest.skip(f"artifact {name} not present")
    env_cfg, cfg = POLICY_RECIPES[name]
    init_fn, _, _ = jax_make_trainer(JaxZoo(env_cfg), cfg)
    runner = ckpt.restore(artifact, init_fn(jax.random.key(0)))
    want = params_from_flax(jax.device_get(runner.params))

    path = policy_path(name)
    assert os.path.getsize(path) < 1_000_000
    data = torch.load(path, weights_only=True)
    assert (data["hidden"], data["num_actions"], data["activation"], data["learner_seats"]) == \
        (list(cfg.hidden), cfg.num_actions, cfg.activation, cfg.learner_seats)
    assert data["params"].keys() == want.keys()
    for k, v in want.items():
        assert data["params"][k].dtype == v.dtype and torch.equal(data["params"][k], v), k
    net = load_policy(path, device="cpu")
    assert not net.training
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
