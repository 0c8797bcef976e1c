"""The benchmark's plain reference against the port's CPU path at a tiny
size: the same frames bit for bit, the same policy step, and an update that
agrees within the rounding of bf16 products."""

import pytest
import torch

from benchmark.reference import learner as ref_learner
from benchmark.reference.pika import env as ref_env
from benchmark.traffic_common import packed_state
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.core import fused_step
from pikazoo_tpu_torch.train import networks, ppo


@pytest.mark.parametrize("computer", [False, True])
def test_fused_frames_bit_equal(computer):
    settings = dict(is_player1_computer=computer, is_player2_computer=computer)
    env = PikaZoo(EnvConfig(**settings))
    state, _ = env.reset_batch([11, 12], 1024, device="cpu")
    packed = fused_step.pack_state(state, [13, 14])
    ref = ref_env.reset_packed(ref_env.EnvConfig(**settings), [11, 12], [13, 14], 1024, "cpu")
    assert torch.equal(packed, ref)
    got = fused_step.rollout_packed_plain(packed, env.config, 12)
    want = ref_env.rollout_packed(ref, ref_env.EnvConfig(**settings), 12)
    assert torch.equal(got, want)


def test_learner_step_bit_equal():
    env = PikaZoo(EnvConfig())
    state, ts = env.reset_batch(7, 256, device="cpu")
    ref = ref_env.reset_packed(ref_env.EnvConfig(), 7, 0, 256, "cpu")
    assert torch.equal(ref_env.raw_obs(ref), ts.obs)
    gen = torch.Generator().manual_seed(1)
    for _ in range(30):
        a1, a2 = (torch.randint(0, 18, (256,), generator=gen, dtype=torch.int32) for _ in "ab")
        state, norm, reward, term = env.step_batch_learner_fm(state, a1, a2)
        ref, rnorm, rreward, rterm = ref_env.learner_step(ref_env.EnvConfig(), ref, a1, a2)
        assert torch.equal(norm, rnorm) and torch.equal(reward, rreward)
        assert torch.equal(term, rterm)
        assert torch.equal(packed_state(state), ref[:packed_state(state).shape[0]])


def test_policy_step_equal():
    net = networks.ActorCritic(generator=torch.Generator().manual_seed(2))
    params = {k: v.detach() for k, v in net.params().items()}
    x = torch.rand((35, 512), generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    logits, value = networks.apply_fm(params, x)
    rlogits, rvalue = ref_learner.forward_fm(params, x)
    assert torch.equal(logits, rlogits) and torch.equal(value, rvalue)


def test_sample_gap_reads_the_ports_draws_as_zero():
    """The port's inverse-CDF draws lie inside the reference's buckets, and
    another action lies outside by its distance."""
    logits = torch.randn((4096, 18), generator=torch.Generator().manual_seed(4))
    u = torch.rand(4096, generator=torch.Generator().manual_seed(5))
    log_probs = torch.log_softmax(logits.t(), dim=0)
    cdf = torch.cumsum(torch.exp(log_probs), dim=0)
    action = (cdf < u * cdf[-1:]).sum(dim=0)
    assert float(ref_learner.sample_gap(logits, u, action).max()) < 1e-6
    assert float(ref_learner.sample_gap(logits, u, (action + 9) % 18).min()) > 0


def test_update_agrees_with_the_ports_autograd_update():
    """One update of 2 epochs x 2 minibatches on the same trajectory: the
    port's trainer (autograd on the CPU) and the reference agree to the
    rounding of bf16 products."""
    cfg = ppo.PPOConfig(num_envs=16, rollout_length=8, num_minibatches=2, update_epochs=2)
    init_fn, train_step, _ = ppo.make_ppo_trainer(PikaZoo(EnvConfig()), cfg, device="cpu")
    runner = init_fn(3)
    uniforms = torch.rand((8, 1, 32), generator=torch.Generator().manual_seed(6))
    (env_state, last_norm), traj = train_step.rollout_fn(runner.params, runner.env_state,
                                                         runner.last_obs, uniforms)
    _, last_value = networks.apply_fm(runner.params, last_norm)
    adv, targets = ppo.gae_associative(traj.value, traj.reward, traj.done, last_value,
                                       cfg.gamma, cfg.gae_lambda)
    radv, rtargets = ref_learner.gae(traj.value, traj.reward, traj.done, last_value,
                                     cfg.gamma, cfg.gae_lambda)
    assert torch.allclose(adv, radv) and torch.allclose(targets, rtargets)
    params, _, losses = train_step.update_fn(runner.params, runner.opt_state, traj, adv, targets)
    r = ref_learner.Recipe(num_envs=16, rollout_length=8, num_minibatches=2, update_epochs=2,
                           hidden=(256, 256))
    rtraj = {"obs": traj.obs.transpose(1, 2), "action": traj.action, "log_prob": traj.log_prob,
             "value": traj.value}
    opt = ref_learner.Adam(runner.params, r.learning_rate, r.max_grad_norm)
    rparams, rlosses = ref_learner.update(dict(runner.params), opt, r, rtraj, adv, targets)
    assert torch.allclose(losses.reshape(-1, 5), rlosses, rtol=1e-3, atol=1e-5)
    for k in params:
        step, rstep = params[k] - runner.params[k], rparams[k] - runner.params[k]
        assert float((step - rstep).norm()) <= 0.05 * float(rstep.norm()) + 1e-7, k
