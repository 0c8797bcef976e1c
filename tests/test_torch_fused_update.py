"""K1's plain version (``fused_ppo_grads_fm_plain``, what the CPU runs and
what the CUDA kernel is held against on the card) against the JAX package's
``fused_ppo_grads_fm`` in interpret mode, and against autograd of a
transcribed forward.  The kernel itself builds only with nvcc: chip_smoke.py
holds it against this plain version on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads_fm as jax_fused_fm
from pikazoo_tpu.train.networks import ActorCritic as JaxActorCritic
from pikazoo_tpu_torch.convert import params_from_flax
from pikazoo_tpu_torch.train import fused_update
from pikazoo_tpu_torch.train.fused_update import (fused_ppo_grads_fm,
                                                  fused_ppo_grads_fm_plain)
from pikazoo_tpu_torch.train.networks import BF16, dense_layers
from torch_helpers import to_torch

A, F = 18, 35
HIDDEN = (32, 32)
CLIP, VCOEF, ECOEF = 0.2, 0.5, 0.01
# (frames, columns, activation): the recipe of tests/test_fused_update.py
# (M = 512 as (4, 128)), relu, and ragged column counts.
CASES = [(4, 128, "tanh"), (4, 128, "relu"), (3, 200, "tanh"), (2, 77, "relu")]


def make_inputs(t_mb, n, activation, seed=0):
    """numpy-seeded inputs built as tests/test_fused_update.py::_make_inputs
    builds them: logp_old perturbed so both clip branches fire."""
    rng = np.random.default_rng(seed)
    net = JaxActorCritic(num_actions=A, hidden=HIDDEN, activation=activation)
    params = net.init(jax.random.key(seed), jnp.zeros((4, F), jnp.int32))
    m = t_mb * n
    obs = jnp.asarray(rng.random((m, F), dtype=np.float32)).astype(jnp.bfloat16)
    action = rng.integers(0, A, m).astype(np.int32)
    logits, value = net.apply(params, obs, pre_normalized=True)
    logp_old = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)),
                                  action[:, None], 1)[:, 0]
    logp_old = logp_old + 0.3 * rng.standard_normal(m).astype(np.float32)
    adv = rng.standard_normal(m).astype(np.float32)
    adv_n = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    target = np.asarray(value) + rng.standard_normal(m).astype(np.float32)
    fm = lambda x: np.asarray(x).reshape(t_mb, n, *np.shape(x)[1:])
    obs_fm = jnp.swapaxes(jnp.asarray(fm(obs)), 1, 2)          # (T, F, N)
    leaves = (obs_fm, fm(action), fm(logp_old), fm(value), fm(adv_n), fm(target))
    return params, leaves


KW = dict(num_actions=A, clip_eps=CLIP, value_coef=VCOEF, entropy_coef=ECOEF)


def port_call(fn, params, leaves, activation):
    port = params_from_flax(jax.device_get(params))
    return fn(port, *[to_torch(x) for x in leaves], activation=activation, **KW)


def flat(grads):
    return np.concatenate([np.asarray(g, np.float64).ravel() for g in grads])


def cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("t_mb,n,activation", CASES)
def test_plain_matches_jax_interpret(t_mb, n, activation):
    params, leaves = make_inputs(t_mb, n, activation)
    want_grads, want_losses = jax_fused_fm(params, *map(jnp.asarray, leaves),
                                           activation=activation, interpret=True, **KW)
    grads, losses = port_call(fused_ppo_grads_fm_plain, params, leaves, activation)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=1e-4, atol=1e-5)
    names, L, _, _ = dense_layers(grads)
    dense = want_grads["params"]
    for i, name in enumerate(names):
        for leaf in ("kernel", "bias"):
            g = grads[f"{name}.{leaf}"].double().numpy().ravel()
            w = np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel()
            assert g.shape == w.shape, (name, leaf)
            rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert cos(g, w) >= 0.9999, (name, leaf, cos(g, w))
            assert rel <= 2e-3, (name, leaf, rel)


def transcribed_loss(params, obs, action, logp_old, value_old, adv_n, target,
                     activation):
    """The kernel-precision forward and loss in torch, differentiable: bf16
    operands, f32 accumulation, bf16 activations."""
    _, L, w, b = dense_layers(params)
    h = obs.float()                                            # (T, F, N)
    for l in range(L):
        pre = torch.einsum("fh,tfn->thn", w[l].to(BF16).float(), h) + b[l][:, None]
        h = (torch.relu(pre) if activation == "relu" else torch.tanh(pre)).to(BF16).float()
    logits = torch.einsum("ha,thn->tan", w[L].to(BF16).float(), h) + b[L][:, None]
    value = torch.einsum("hv,thn->tvn", w[L + 1].to(BF16).float(), h)[:, 0] + b[L + 1]
    logp_all = torch.log_softmax(logits, dim=1)
    lp_new = torch.gather(logp_all, 1, action.long()[:, None])[:, 0]
    ratio = torch.exp(lp_new - logp_old)
    policy = -torch.minimum(ratio * adv_n,
                            torch.clamp(ratio, 1 - CLIP, 1 + CLIP) * adv_n).mean()
    vclip = value_old + torch.clamp(value - value_old, -CLIP, CLIP)
    vloss = 0.5 * torch.maximum((value - target) ** 2, (vclip - target) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(1).mean()
    return policy + VCOEF * vloss - ECOEF * entropy


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_plain_matches_autograd_of_transcription(activation):
    """The hand-written backward against autograd (looser: the backward
    rounds dheads and dpre to bf16 before its products, autograd does not)."""
    params, leaves = make_inputs(4, 128, activation)
    grads, _ = port_call(fused_ppo_grads_fm_plain, params, leaves, activation)
    port = {k: v.requires_grad_(True)
            for k, v in params_from_flax(jax.device_get(params)).items()}
    loss = transcribed_loss(port, *[to_torch(x) for x in leaves], activation)
    ref = dict(zip(port, torch.autograd.grad(loss, list(port.values()))))
    keys = sorted(grads)
    g = flat([grads[k] for k in keys])
    r = flat([ref[k].detach() for k in keys])
    assert cos(g, r) > 0.9995, cos(g, r)


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    params, leaves = make_inputs(3, 200, "tanh")
    before = fused_ppo_grads_fm.launches
    grads, losses = port_call(fused_ppo_grads_fm, params, leaves, "tanh")
    plain_grads, plain_losses = port_call(fused_ppo_grads_fm_plain, params, leaves, "tanh")
    assert fused_ppo_grads_fm.launches == before  # no kernel ran
    assert torch.equal(losses, plain_losses)
    assert all(torch.equal(grads[k], plain_grads[k]) for k in grads)
    port = params_from_flax(jax.device_get(params))
    args = [to_torch(x) for x in leaves]
    with pytest.raises(ValueError):   # obs must be bf16
        fused_ppo_grads_fm(port, args[0].float(), *args[1:], activation="tanh", **KW)
    with pytest.raises(ValueError):   # per-row shapes must match obs
        fused_ppo_grads_fm(port, args[0], args[1][:, :10], *args[2:],
                           activation="tanh", **KW)
    with pytest.raises(TypeError):    # float inputs must be float32
        fused_ppo_grads_fm(port, *args[:2], args[2].double(), *args[3:],
                           activation="tanh", **KW)


def test_kernel_shape_limits_raise_before_launch():
    """What the kernels cannot take raises before any launch (the checks run
    without a card), with and without the bf16 backward chain."""
    params, leaves = make_inputs(2, 64, "tanh")
    port = params_from_flax(jax.device_get(params))
    port["layers.0.kernel"] = torch.zeros((F, 24))   # width not a multiple of 16
    port["layers.0.bias"] = torch.zeros(24)
    port["layers.1.kernel"] = torch.zeros((24, 32))
    args = [to_torch(x) for x in leaves]
    for bwd_bf16 in (False, True):
        with pytest.raises(ValueError, match="multiples of 16"):
            fused_update._launch_bf16(port, *args, activation="tanh", inv_m=1.0,
                                      bwd_bf16=bwd_bf16, **KW)
