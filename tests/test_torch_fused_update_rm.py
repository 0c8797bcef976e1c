"""K4's plain version (``fused_ppo_grads_rm_plain``, what the CPU runs and what
the CUDA kernel is held against on the card) against the JAX package's
row-major ``fused_ppo_grads`` in interpret mode.  The kernel itself builds
only with nvcc: chip_smoke.py holds it against this plain version on the
card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads as jax_fused
from pikazoo_tpu.train.networks import ActorCritic as JaxActorCritic
from pikazoo_tpu_torch.convert import params_from_flax
from pikazoo_tpu_torch.train import fused_update
from pikazoo_tpu_torch.train.fused_update import (fused_ppo_grads,
                                                  fused_ppo_grads_fm_plain,
                                                  fused_ppo_grads_rm_plain)
from pikazoo_tpu_torch.train.networks import dense_layers
from torch_helpers import to_torch

A, F = 18, 35
HIDDEN = (32, 32)
KW = dict(num_actions=A, clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
# K1's bounds (tests/test_torch_fused_update.py, chip_smoke.py phase 9).
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
GRAD_REL_L2, GRAD_COS = 1e-3, 0.99999


def make_inputs(m, activation, seed=0):
    """numpy-seeded row-major inputs, built as tests/test_fused_update.py
    builds them: logp_old perturbed so both clip branches fire."""
    rng = np.random.default_rng(seed)
    net = JaxActorCritic(num_actions=A, hidden=HIDDEN, activation=activation)
    params = net.init(jax.random.key(seed), jnp.zeros((4, F), jnp.int32))
    obs = jnp.asarray(rng.random((m, F), dtype=np.float32)).astype(jnp.bfloat16)
    action = rng.integers(0, A, m).astype(np.int32)
    logits, value = net.apply(params, obs, pre_normalized=True)
    logp_old = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)),
                                  action[:, None], 1)[:, 0]
    logp_old = logp_old + 0.3 * rng.standard_normal(m).astype(np.float32)
    adv = rng.standard_normal(m).astype(np.float32)
    adv_n = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    target = np.asarray(value) + rng.standard_normal(m).astype(np.float32)
    return params, (obs, action, logp_old, np.asarray(value), adv_n, target)


def port_args(params, leaves):
    return params_from_flax(jax.device_get(params)), [to_torch(x) for x in leaves]


def leaf_errors(got, want):
    """(relative L2, cos) of two gradient leaves, in float64."""
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
    return rel, cos


@pytest.mark.parametrize("m", [512, 1000])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_plain_matches_jax_interpret(m, activation):
    params, leaves = make_inputs(m, activation)
    want_grads, want_losses = jax_fused(params, *map(jnp.asarray, leaves),
                                        activation=activation, interpret=True, **KW)
    port, args = port_args(params, leaves)
    grads, losses = fused_ppo_grads_rm_plain(port, *args, activation=activation, **KW)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    names, _, _, _ = dense_layers(grads)
    dense = want_grads["params"]
    for i, name in enumerate(names):
        for leaf in ("kernel", "bias"):
            g, w = grads[f"{name}.{leaf}"].numpy(), np.asarray(dense[f"Dense_{i}"][leaf])
            assert g.shape == w.shape, (name, leaf)
            rel, cos = leaf_errors(g, w)
            assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, leaf, rel, cos)


def test_rm_plain_differs_from_fm_plain_on_the_same_rows():
    """K4 takes the tanh derivative from the f32 activation, K1 from its
    bf16 round: on the same rows every hidden-layer grad differs by more
    than the bound K4 holds against JAX (measured 4e-3 to 6.5e-3, as JAX's
    own two kernels differ), while the losses and the head grads agree."""
    t_mb, n = 4, 128
    params, leaves = make_inputs(t_mb * n, "tanh")
    port, args = port_args(params, leaves)
    rm_grads, rm_losses = fused_ppo_grads_rm_plain(port, *args, activation="tanh", **KW)
    obs_fm = args[0].reshape(t_mb, n, F).transpose(1, 2).contiguous()
    fm_args = [obs_fm] + [x.reshape(t_mb, n) for x in args[1:]]
    fm_grads, fm_losses = fused_ppo_grads_fm_plain(port, *fm_args, activation="tanh", **KW)
    np.testing.assert_allclose(rm_losses.numpy(), fm_losses.numpy(), rtol=1e-5, atol=1e-7)
    for k in rm_grads:
        rel, _ = leaf_errors(rm_grads[k], fm_grads[k])
        hidden = int(k.split(".")[1]) < len(HIDDEN)
        assert (rel > GRAD_REL_L2) if hidden else (rel < 1e-5), (k, rel)


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    params, leaves = make_inputs(300, "relu")
    port, args = port_args(params, leaves)
    before = fused_ppo_grads.launches
    grads, losses = fused_ppo_grads(port, *args, activation="relu", **KW)
    plain_grads, plain_losses = fused_ppo_grads_rm_plain(port, *args, activation="relu", **KW)
    assert fused_ppo_grads.launches == before  # no kernel ran
    assert torch.equal(losses, plain_losses)
    assert all(torch.equal(grads[k], plain_grads[k]) for k in grads)
    with pytest.raises(ValueError, match="bf16"):
        fused_ppo_grads(port, args[0].float(), *args[1:], activation="relu", **KW)
    with pytest.raises(ValueError, match="per-row"):
        fused_ppo_grads(port, args[0], args[1][:10], *args[2:], activation="relu", **KW)
    with pytest.raises(TypeError):
        fused_ppo_grads(port, *args[:2], args[2].double(), *args[3:], activation="relu",
                        **KW)


def test_total_rows_scales_the_mean():
    params, leaves = make_inputs(256, "tanh")
    port, args = port_args(params, leaves)
    g1, l1 = fused_ppo_grads_rm_plain(port, *args, activation="tanh", **KW)
    g2, l2 = fused_ppo_grads_rm_plain(port, *args, activation="tanh", total_rows=512, **KW)
    torch.testing.assert_close(l2, l1 / 2, rtol=1e-6, atol=1e-8)
    torch.testing.assert_close(g2["layers.1.bias"], g1["layers.1.bias"] / 2,
                               rtol=1e-2, atol=1e-7)


def test_kernel_shape_limits_raise_before_launch():
    """What K4 cannot take raises before any launch (the checks run without
    a card)."""
    params, leaves = make_inputs(64, "tanh")
    port, args = port_args(params, leaves)
    port["layers.0.kernel"] = torch.zeros((F, 24))   # width not a multiple of 16
    port["layers.0.bias"] = torch.zeros(24)
    port["layers.1.kernel"] = torch.zeros((24, 32))
    with pytest.raises(ValueError, match="multiples of 16"):
        fused_update._launch_rm(port, *args, activation="tanh", inv_m=1.0, **KW)
