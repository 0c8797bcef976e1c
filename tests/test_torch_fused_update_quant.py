"""K1's other precision modes (``quant="int8"``, ``quant="int8fwd"``,
``bwd_bf16=True``): the plain version against the JAX package's
``fused_ppo_grads_fm`` in interpret mode, the JAX package's own int8 quality
contract held on the port, and the mode checks.  The kernel builds only with
nvcc: chip_smoke.py holds it against this plain version on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.train import fused_update as jax_fu
from pikazoo_tpu_torch.convert import params_from_flax
from pikazoo_tpu_torch.train import fused_update
from pikazoo_tpu_torch.train.fused_update import (cell_cols, fused_ppo_grads_fm,
                                                  fused_ppo_grads_fm_plain, mode_name,
                                                  pick_tile, quantize_weights)
from test_torch_fused_update import KW, make_inputs
from torch_helpers import to_torch

# These modes round to a coarse grid inside the chain (an int8 value; dh to
# bf16 at every layer with bwd_bf16).  A last-bit difference between XLA's and
# torch's f32 (a tanh, a dot's summation order) flips such a rounding now and
# then, and the flip runs down the chain: bwd_bf16 measured 1.5e-3 to 2.2e-3,
# the int8 modes under 4e-5.
LOSS_RTOL, GRAD_REL_L2, GRAD_COS = 1e-3, 5e-3, 0.9999
# (quant, bwd_bf16) as the JAX kernel takes them.
MODES = [("int8", False), ("int8fwd", False), ("none", True), ("int8fwd", True)]


def jax_args(leaves):
    return [jnp.asarray(x) for x in leaves]


def port_grads(params, leaves, **kw):
    port = params_from_flax(jax.device_get(params))
    return fused_ppo_grads_fm_plain(port, *[to_torch(x) for x in leaves],
                                    activation="tanh", **KW, **kw)


def leaf_pairs(grads, jax_grads):
    """(name, port leaf, JAX leaf) as float64 numpy, every leaf."""
    dense = jax_grads["params"]
    for i in range(len(dense)):
        for leaf in ("kernel", "bias"):
            yield (f"layers.{i}.{leaf}",
                   grads[f"layers.{i}.{leaf}"].double().numpy().ravel(),
                   np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel())


def rel_cos(g, w):
    rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
    return rel, g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)


@pytest.mark.parametrize("n", [256, 1000])
@pytest.mark.parametrize("quant,bwd_bf16", MODES)
def test_plain_matches_jax_interpret(quant, bwd_bf16, n):
    """N=256 gives cells of 256 columns; N=1000 (not a multiple of 128) one
    cell of the whole width."""
    params, leaves = make_inputs(4, n, "tanh")
    want, want_losses = jax_fu.fused_ppo_grads_fm(
        params, *jax_args(leaves), activation="tanh", interpret=True, quant=quant,
        bwd_bf16=bwd_bf16, **KW)
    grads, losses = port_grads(params, leaves, quant=quant, bwd_bf16=bwd_bf16)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=LOSS_RTOL, atol=1e-5)
    for name, g, w in leaf_pairs(grads, want):
        rel, cos = rel_cos(g, w)
        assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, rel, cos)


def test_bf16_chain_differs_from_bf16_mode():
    """The bf16 backward chain's plain version is further from the bf16
    mode's than GRAD_REL_L2 on some leaf, so the bound above would catch a
    port that ran the f32 chain.  T=8, N=4096: at T=4, N=256 the two sit
    4.6e-3 apart, inside the bound; chip_smoke.py makes this check at full
    width against the kernel's bound."""
    params, leaves = make_inputs(8, 4096, "tanh")
    stock, _ = port_grads(params, leaves)
    chain, _ = port_grads(params, leaves, bwd_bf16=True)
    worst = max(rel_cos(chain[k].double().numpy().ravel(),
                        stock[k].double().numpy().ravel())[0] for k in stock)
    assert worst > GRAD_REL_L2, worst


def test_int8_cell_wider_than_exact_f32_matches_jax():
    """N=3000 is one dynamic-scale cell of 3000 columns, past the width
    where integer-valued f32 products stay exact: the plain version takes
    that cell's dW products in float64."""
    params, leaves = make_inputs(2, 3000, "tanh", seed=3)
    assert cell_cols(3000) == 3000 > fused_update.EXACT_F32_CELL
    want, want_losses = jax_fu.fused_ppo_grads_fm(
        params, *jax_args(leaves), activation="tanh", interpret=True, quant="int8", **KW)
    grads, losses = port_grads(params, leaves, quant="int8")
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               rtol=LOSS_RTOL, atol=1e-5)
    for name, g, w in leaf_pairs(grads, want):
        rel, cos = rel_cos(g, w)
        assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, rel, cos)


@pytest.mark.parametrize("quant", ["int8", "int8fwd"])
def test_int8_grads_track_bf16(quant):
    """The JAX package's contract (tests/test_fused_update.py:336-352) on
    the port: per leaf cos >= 0.99 and norm ratio 0.9-1.1 against the bf16
    mode, losses within 1%."""
    params, leaves = make_inputs(4, 128, "tanh")
    g0, l0 = port_grads(params, leaves)
    g1, l1 = port_grads(params, leaves, quant=quant)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=0.01, atol=1e-4)
    for k in g0:
        a, b = g0[k].double().numpy().ravel(), g1[k].double().numpy().ravel()
        _, cos = rel_cos(b, a)
        assert cos > 0.99, (k, cos)
        ratio = np.linalg.norm(b) / (np.linalg.norm(a) + 1e-30)
        assert 0.9 < ratio < 1.1, (k, ratio)


def test_weight_quantisation_matches_jax():
    """One per-tensor scale from the f32 params, the merged head as one
    tensor, round half to even: the JAX wrapper's ``_qw``."""
    params, _ = make_inputs(1, 128, "tanh")
    port = params_from_flax(jax.device_get(params))
    names = sorted(port, key=lambda k: (int(k.split(".")[1]), k))
    w = [port[k] for k in names if k.endswith("kernel")]
    q, s = quantize_weights(w, 2)
    dense = jax.device_get(params)["params"]
    heads = np.concatenate([dense["Dense_2"]["kernel"], dense["Dense_3"]["kernel"]], 1)
    for i, t in enumerate([dense["Dense_0"]["kernel"], dense["Dense_1"]["kernel"], heads]):
        scale = np.maximum(np.abs(t).max(), np.float32(1e-30)) / np.float32(127.0)
        np.testing.assert_array_equal(q[i].numpy(), np.round(t / scale).astype(np.int8))
        assert float(s[i]) == float(scale)


@pytest.mark.parametrize("n", [131072, 4096, 1000, 384])
def test_pick_tile_mirrors_jax(n):
    assert pick_tile(n, 1024, floor=128) == jax_fu._pick_tile(n, 1024, floor=128)
    assert pick_tile(n, 8, floor=1) == jax_fu._pick_tile(n, 8, floor=1)
    assert cell_cols(n) == jax_fu._pick_tile(n, 1024, floor=128)


def test_mode_errors():
    params, leaves = make_inputs(2, 128, "relu")
    port = params_from_flax(jax.device_get(params))
    args = [to_torch(x) for x in leaves]
    for fn in (fused_ppo_grads_fm, fused_ppo_grads_fm_plain):
        with pytest.raises(ValueError, match="tanh"):
            fn(port, *args, activation="relu", quant="int8", **KW)
        with pytest.raises(ValueError, match="tanh"):
            fn(port, *args, activation="relu", quant="int8fwd", **KW)
        with pytest.raises(ValueError, match="unknown quant"):
            fn(port, *args, activation="tanh", quant="int4", **KW)


def test_int8_layer_limit():
    """More than 7 hidden layers with int8 raises, as in JAX."""
    width = 16
    port = {}
    for i in range(8):
        port[f"layers.{i}.kernel"] = torch.zeros((35 if i == 0 else width, width))
        port[f"layers.{i}.bias"] = torch.zeros(width)
    port["layers.8.kernel"], port["layers.8.bias"] = torch.zeros((width, 18)), torch.zeros(18)
    port["layers.9.kernel"], port["layers.9.bias"] = torch.zeros((width, 1)), torch.zeros(1)
    _, leaves = make_inputs(1, 128, "tanh")
    args = [to_torch(x) for x in leaves]
    with pytest.raises(ValueError, match="7 hidden layers"):
        fused_ppo_grads_fm(port, *args, activation="tanh", quant="int8", **KW)


def test_wrapper_runs_plain_on_cpu_per_mode():
    """On the CPU the wrapper runs the plain version in every mode and
    counts no launch."""
    params, leaves = make_inputs(2, 200, "tanh")
    before = dict(fused_ppo_grads_fm.launches_by_mode)
    port = params_from_flax(jax.device_get(params))
    args = [to_torch(x) for x in leaves]
    for quant, bwd_bf16 in MODES:
        got = fused_ppo_grads_fm(port, *args, activation="tanh", quant=quant,
                                 bwd_bf16=bwd_bf16, **KW)
        want = fused_ppo_grads_fm_plain(port, *args, activation="tanh", quant=quant,
                                        bwd_bf16=bwd_bf16, **KW)
        assert torch.equal(got[1], want[1])
        assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    assert fused_ppo_grads_fm.launches_by_mode == before
    assert {mode_name(q, b) for q, b in MODES} == {
        "int8", "int8fwd", "bwd_bf16", "int8fwd+bwd_bf16"}
