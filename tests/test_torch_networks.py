"""The learner network against the JAX package: flax params carried across
exactly, ``ActorCritic`` and ``apply_fm`` on converted params, and GAE."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs.observations import OBS_HIGH, OBS_LOW
from pikazoo_tpu.train.networks import ActorCritic as JaxActorCritic
from pikazoo_tpu.train.networks import apply_fm as jax_apply_fm
from pikazoo_tpu.train.ppo import gae_associative as jax_gae
from pikazoo_tpu_torch.convert import params_from_flax, params_to_flax
from pikazoo_tpu_torch.train.networks import ActorCritic, apply_fm, dense_layers
from pikazoo_tpu_torch.train.ppo import gae_associative
from torch_helpers import to_torch

# The bf16 rounding points of XLA's and torch's products differ
# (tests/test_train_ppo.py::test_apply_fm_matches_module_apply holds two JAX
# forwards to the same 1e-2).
TOL = dict(rtol=1e-2, atol=1e-2)


def jax_params(hidden, seed=0, activation="tanh"):
    net = JaxActorCritic(num_actions=18, hidden=hidden, activation=activation)
    return net, net.init(jax.random.key(seed), jnp.zeros((4, 35), jnp.int32))


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256), (64, 48, 32)])
def test_params_round_trip_is_exact(hidden):
    _, params = jax_params(hidden)
    want = jax.device_get(params)
    port = params_from_flax(want)
    assert {v.dtype for v in port.values()} == {torch.float32}
    got = params_to_flax(port)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The module takes them as its state_dict, layer order kept.
    net = ActorCritic(hidden=hidden)
    net.load_state_dict(port)
    _, L, w, _ = dense_layers(net.params())
    assert L == len(hidden) and w[L].shape == (hidden[-1], 18)
    np.testing.assert_array_equal(params_to_flax(net)["params"]["Dense_0"]["kernel"],
                                  want["params"]["Dense_0"]["kernel"])


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_actor_critic_matches_flax_module(activation):
    jnet, params = jax_params((32, 32), seed=1, activation=activation)
    net = ActorCritic(hidden=(32, 32), activation=activation)
    net.load_state_dict(params_from_flax(jax.device_get(params)))
    rng = np.random.default_rng(0)
    raw = rng.integers(OBS_LOW, OBS_HIGH + 1, (256, 35)).astype(np.int32)
    want_logits, want_value = jnet.apply(params, jnp.asarray(raw))
    with torch.no_grad():
        logits, value = net(torch.from_numpy(raw))
    assert logits.dtype == value.dtype == torch.float32
    assert logits.shape == (256, 18) and value.shape == (256,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), **TOL)

    normed = jnp.asarray(rng.random((256, 35), dtype=np.float32)).astype(jnp.bfloat16)
    want_logits, want_value = jnet.apply(params, normed, pre_normalized=True)
    with torch.no_grad():
        logits, value = net(to_torch(normed), pre_normalized=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), **TOL)


def test_apply_fm_matches_jax():
    _, params = jax_params((32, 32), seed=2)
    port = params_from_flax(jax.device_get(params))
    x = jnp.asarray(np.random.default_rng(1).random((35, 512), dtype=np.float32)
                    ).astype(jnp.bfloat16)
    want_logits, want_value = jax_apply_fm(params, x)
    logits, value = apply_fm(port, to_torch(x))
    assert logits.shape == (18, 512) and value.shape == (512,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), **TOL)


def test_orthogonal_init_gains():
    """Orthogonal kernels with gains sqrt(2), 0.01 and 1.0, zero biases,
    drawn from the generator given."""
    def make(seed):
        return ActorCritic(hidden=(64, 32), generator=torch.Generator().manual_seed(seed))

    net = make(0)
    _, L, w, b = dense_layers(net.params())
    for k, gain in zip(w, [np.sqrt(2), np.sqrt(2), 0.01, 1.0]):
        k = k.detach().double()
        small = k.t() @ k if k.shape[0] >= k.shape[1] else k @ k.t()
        np.testing.assert_allclose(small.numpy(), gain ** 2 * np.eye(small.shape[0]),
                                   atol=1e-5)
    assert all(float(x.detach().abs().max()) == 0 for x in b)
    for a, c in zip(net.parameters(), make(0).parameters()):
        assert torch.equal(a, c)
    assert not torch.equal(w[0], dense_layers(make(1).params())[2][0])


def test_gae_matches_jax():
    T, n = 37, 64
    rng = np.random.default_rng(7)
    value = rng.standard_normal((T, n)).astype(np.float32)
    reward = rng.standard_normal((T, n)).astype(np.float32)
    done = (rng.random((T, n)) < 0.1).astype(np.float32)
    last = rng.standard_normal(n).astype(np.float32)
    want_adv, want_tgt = jax_gae(*map(jnp.asarray, (value, reward, done, last)),
                                 0.99, 0.95)
    adv, tgt = gae_associative(*map(torch.from_numpy, (value, reward, done, last)),
                               0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(want_tgt), rtol=1e-5, atol=1e-5)
