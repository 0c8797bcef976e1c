"""The PPO learner as a whole, from a JAX runner carried across to the port:
the rollout frame by frame (sampling and env), the update phase epoch by
epoch (autograd, K1 and K4), and port-only tests of ``train_step`` in every
configuration of the update: K1's precision modes, K4 and the shuffle."""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.train import PPOConfig as JaxPPOConfig
from pikazoo_tpu.train import make_ppo_trainer as jax_make_trainer
from pikazoo_tpu.train.networks import apply_fm as jax_apply_fm
from pikazoo_tpu.train.ppo import Transition as JaxTransition
from pikazoo_tpu.train.ppo import gae_associative as jax_gae
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import (env_state_from_numpy, env_state_to_numpy,
                                       params_from_flax, params_to_flax)
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu_torch.train import run as port_run
from pikazoo_tpu_torch.train.networks import apply_fm
from pikazoo_tpu_torch.train.ppo import Transition, gae_associative
from torch_helpers import assert_same, bf16_bits, to_torch

SIZES = dict(num_envs=64, rollout_length=8, num_minibatches=2, update_epochs=2,
             hidden=(32, 32))
B, T = SIZES["num_envs"], SIZES["rollout_length"]


@pytest.fixture(scope="module")
def jax_run():
    """A JAX runner and one rollout from it, with the uniforms its rollout
    drew (the same key splits as ``_rollout_body``)."""
    env = JaxZoo(JaxConfig(auto_reset=True, winning_score=2))
    init_fn, train_step, _ = jax_make_trainer(env, JaxPPOConfig(**SIZES, fused_update="off"))
    runner = init_fn(jax.random.key(0))
    (env_state, last_norm, _), traj = jax.jit(train_step.rollout_fn)(
        runner.params, runner.env_state, runner.last_obs, runner.key)
    key, uniforms = runner.key, []
    for _ in range(T):
        key, akey = jax.random.split(key)
        uniforms.append(jax.random.uniform(akey, (1, 2 * B), jnp.float32))
    return dict(runner=runner, env_state=env_state, last_norm=last_norm, traj=traj,
                uniforms=uniforms)


def test_rollout_frame_by_frame_matches_jax(jax_run):
    """On JAX's observations and uniforms the port samples JAX's actions on
    every column whose CDF margin exceeds 1e-3, with log-prob and value
    within 1e-2; fed JAX's actions, the port's env gives bit-exact
    observations, rewards and dones."""
    runner, traj = jax_run["runner"], jax.device_get(jax_run["traj"])
    _, train_step, _ = make_ppo_trainer(PikaZoo(EnvConfig(auto_reset=True, winning_score=2)),
                                        PPOConfig(**SIZES), device="cpu")
    params = params_from_flax(jax.device_get(runner.params))
    env = PikaZoo(EnvConfig(auto_reset=True, winning_score=2))
    state = env_state_from_numpy(jax.device_get(runner.env_state))
    checked = 0
    for t in range(T):
        obs = traj.obs[t]
        action, log_prob, value = train_step.policy_sample_fn(
            params, to_torch(obs), to_torch(jax_run["uniforms"][t]))
        logits, _ = jax_apply_fm(runner.params, jnp.asarray(obs))
        p = np.exp(np.asarray(jax.nn.log_softmax(logits, axis=0), np.float64))
        cdf = np.cumsum(p, axis=0)
        threshold = np.asarray(jax_run["uniforms"][t], np.float64) * cdf[-1:]
        clear = np.abs(cdf - threshold).min(axis=0) > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(action.numpy()[clear], traj.action[t][clear])
        np.testing.assert_allclose(log_prob.numpy()[clear], traj.log_prob[t][clear],
                                   atol=1e-2)
        np.testing.assert_allclose(value.numpy(), traj.value[t], atol=1e-2)
        checked += int(clear.sum())

        a = torch.tensor(np.asarray(traj.action[t]))
        state, norm, reward, terminated = env.step_batch_learner_fm(state, a[:B], a[B:])
        want_next = traj.obs[t + 1] if t + 1 < T else jax_run["last_norm"]
        np.testing.assert_array_equal(bf16_bits(norm), bf16_bits(want_next))
        np.testing.assert_array_equal(reward.numpy(), traj.reward[t])
        np.testing.assert_array_equal((terminated == 1).float().numpy(), traj.done[t][:B])
    assert_same(jax.device_get(jax_run["env_state"]), env_state_to_numpy(state))
    assert checked > 0.9 * T * 2 * B


@pytest.mark.parametrize("mode", ["fm", "on", "off"])
def test_update_phase_matches_jax_epoch_loop(jax_run, mode):
    """From JAX's trajectory, the port's update_fn against JAX's epoch loop
    rebuilt from its minibatch_grads_fn and tx, as ppo.py:514-536 runs it.
    Losses agree per minibatch to rtol 1e-4, atol 1e-5 (the loss terms pass
    through zero; K1's loss tolerance).  Params agree to 2 * lr * steps:
    Adam's first steps divide each gradient by its own magnitude, so a
    near-zero gradient whose sign differs at rounding level moves its
    parameter by up to lr the other way.  On the autodiff path ("off") the
    grads themselves differ at bf16 level (XLA sums the bias grads in bf16;
    torch accumulates bf16 sums in f32), so the later minibatches drift
    apart by that much."""
    env = JaxZoo(JaxConfig(auto_reset=True, winning_score=2))
    cfg = JaxPPOConfig(**SIZES, fused_update=mode)
    _, jax_step, _ = jax_make_trainer(env, cfg)
    runner, traj = jax_run["runner"], jax_run["traj"]
    _, last_value = jax_apply_fm(runner.params, jax_run["last_norm"])
    adv, targets = jax_gae(traj.value, traj.reward, traj.done, last_value,
                           cfg.gamma, cfg.gae_lambda)
    grads_fn = jax.jit(jax_step.minibatch_grads_fn)
    params, opt_state = runner.params, runner.opt_state
    t_mb = T // cfg.num_minibatches
    want_losses = []
    for _ in range(cfg.update_epochs):
        for i in range(cfg.num_minibatches):
            sl = slice(i * t_mb, (i + 1) * t_mb)
            grads, losses = grads_fn(params, JaxTransition(*[x[sl] for x in traj]),
                                     adv[sl], targets[sl])
            updates, opt_state = jax_step.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            want_losses.append(np.asarray(losses))

    _, port_step, _ = make_ppo_trainer(PikaZoo(EnvConfig()),
                                       PPOConfig(**SIZES, fused_update=mode), device="cpu")
    tx_init, _ = port_step.tx
    port_params = params_from_flax(jax.device_get(runner.params))
    got_params, got_opt, got_losses = port_step.update_fn(
        port_params, tx_init(port_params), Transition(*[to_torch(x) for x in traj]),
        to_torch(adv), to_torch(targets))
    steps = cfg.update_epochs * cfg.num_minibatches
    assert int(got_opt.count) == steps
    np.testing.assert_allclose(got_losses.reshape(steps, 5).numpy(),
                               np.stack(want_losses), rtol=1e-4, atol=1e-5)
    bound = 2 * cfg.learning_rate * steps + 1e-5
    got = params_to_flax(got_params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=bound)


def small_trainer(**kw):
    cfg = PPOConfig(num_envs=16, rollout_length=8, num_minibatches=2, update_epochs=2,
                    hidden=(32, 32), **kw)
    return make_ppo_trainer(PikaZoo(EnvConfig(winning_score=2)), cfg, device="cpu")


# (config, the minibatch gradient it resolves to on the CPU)
SMOKE = {
    "fm": (dict(fused_update="fm"), "fm"),
    "off": (dict(fused_update="off"), "autograd"),
    "on": (dict(fused_update="on"), "row"),
    "fm+int8": (dict(fused_update="fm", update_quant="int8"), "fm"),
    "fm+int8fwd": (dict(fused_update="fm", update_quant="int8fwd"), "fm"),
    "fm+bwd_bf16": (dict(fused_update="fm", update_bwd_bf16=True), "fm"),
    "shuffle": (dict(fused_update="fm", shuffle_minibatches=True), "fm"),
}


@pytest.mark.parametrize("case", list(SMOKE))
def test_train_step_smoke(case):
    kw, resolved = SMOKE[case]
    init_fn, train_step, _ = small_trainer(**kw)
    assert train_step.provenance["fused_update"] == resolved
    runner = init_fn(1)
    start = {k: v.clone() for k, v in runner.params.items()}
    for update in range(2):
        runner, metrics = train_step(runner)
        assert all(np.isfinite(float(x)) for x in metrics[:7])
        assert float(metrics.entropy) > 0
        assert metrics.env_steps == 16 * 8
        assert int(runner.env_state.step_count.min()) == 8 * (update + 1)
    assert runner.update_index == 2
    assert any(not torch.equal(start[k], runner.params[k]) for k in start)
    again, _ = train_step(init_fn(1))
    once, _ = train_step(init_fn(1))
    for k in once.params:
        assert torch.equal(once.params[k], again.params[k])


def test_vs_ai_learner_seat_and_anneal():
    cfg = PPOConfig(num_envs=16, rollout_length=8, num_minibatches=2, update_epochs=1,
                    hidden=(32, 32), learner_seats="p1", anneal_updates=2)
    env = PikaZoo(EnvConfig(winning_score=2, is_player2_computer=True))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device="cpu")
    runner, metrics = train_step(init_fn(0))
    assert np.isfinite(float(metrics.total_loss))
    assert int(runner.opt_state.count) == 2


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_quant_requires_feature_major(mode):
    """K1's precision modes with any other resolution raise, as in JAX
    ("auto" resolves to autograd on the CPU)."""
    with pytest.raises(ValueError, match="feature-major"):
        small_trainer(fused_update=mode, update_quant="int8")
    with pytest.raises(ValueError, match="feature-major"):
        small_trainer(fused_update=mode, update_bwd_bf16=True)


def test_int8_mode_checks_at_build():
    with pytest.raises(ValueError, match="tanh"):
        small_trainer(fused_update="fm", update_quant="int8", activation="relu")
    with pytest.raises(ValueError, match="unknown quant"):
        small_trainer(fused_update="fm", update_quant="int4")


def test_shuffle_applies_one_permutation_from_the_runner_generator():
    """train_step with the shuffle equals its phases run by hand: the
    rollout's uniforms, then one ``randperm`` of the time axis from the same
    generator, applied to the trajectory, advantages and targets before the
    minibatch split."""
    init_fn, train_step, _ = small_trainer(fused_update="fm", shuffle_minibatches=True)
    runner = init_fn(4)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(runner.key.get_state())
    frames, columns = 8, 2 * 16    # small_trainer's rollout_length, 2 * num_envs
    uniforms = torch.rand((frames, 1, columns), generator=gen)
    (_, last_norm), traj = train_step.rollout_fn(
        runner.params, runner.env_state, runner.last_obs, uniforms)
    _, last_value = apply_fm(runner.params, last_norm)
    adv, targets = gae_associative(traj.value, traj.reward, traj.done, last_value,
                                   0.99, 0.95)
    probe = torch.Generator().manual_seed(0)
    probe.set_state(gen.get_state())
    perm = torch.randperm(frames, generator=probe)
    assert not torch.equal(perm, torch.arange(frames))
    shuffled = train_step.shuffle_fn((traj, adv, targets), gen)
    assert torch.equal(shuffled[1], adv[perm]) and torch.equal(shuffled[2], targets[perm])
    assert all(torch.equal(a, b[perm]) for a, b in zip(shuffled[0], traj))
    want_params, _, _ = train_step.update_fn(runner.params, runner.opt_state, *shuffled)
    got, _ = train_step(runner)
    for k in want_params:
        assert torch.equal(got.params[k], want_params[k]), k


def test_mesh_raises():
    """A mesh whose world does not divide num_envs, or whose tensors lie on
    another device type, raises (the meshed trainer itself is held in
    tests/test_torch_parallel.py)."""
    from pikazoo_tpu_torch.parallel import EnvMesh

    with pytest.raises(ValueError, match="mesh"):
        make_ppo_trainer(PikaZoo(), PPOConfig(num_envs=6), device="cpu",
                         mesh=EnvMesh(0, 4, torch.device("cpu")))
    with pytest.raises(ValueError, match="mesh"):
        make_ppo_trainer(PikaZoo(), PPOConfig(), device="cpu",
                         mesh=EnvMesh(0, 1, torch.device("cuda")))


def test_cli_writes_metrics(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    port_run.main(["--num-envs", "8", "--rollout-length", "8", "--updates", "2",
                   "--metrics", str(path), "--device", "cpu"])
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[0]["provenance"]["fused_update"] == "autograd"
    # The JAX CLI's records: "step" the update, "loss" the total loss.
    assert [row["step"] for row in lines[1:]] == [0, 1]
    assert all(np.isfinite(row["loss"]) for row in lines[1:])
    assert "done: 2 updates" in capsys.readouterr().out
