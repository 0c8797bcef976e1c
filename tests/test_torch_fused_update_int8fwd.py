"""K1's int8fwd mode as its two kernels compute it: the chain's plain
version (``k1_chain_plain(..., quant="int8fwd")``, kernel A of
``csrc/fused_update_bf16.cu`` with the int8 forward) and the dW products'
(``k1_dw_plain``, kernel B, as in the bf16 mode), composed, against the JAX
package's ``fused_ppo_grads_fm(quant="int8fwd")`` in interpret mode; the
columns past N of a padded workspace; the operands' rounding points; the
stage entries on the CPU.  The kernels build only with nvcc: chip_smoke.py
holds them against these plain versions on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads_fm as jax_fused_fm
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.networks import BF16, dense_layers
from test_torch_fused_update_split import make_inputs, pad_columns

A = 18
KW = dict(num_actions=A, clip_eps=0.2, value_coef=0.5, entropy_coef=0.01, activation="tanh")
INT8FWD = dict(KW, quant="int8fwd")
# The int8 modes' bounds against JAX (tests/test_torch_fused_update_quant.py):
# an int8 value a last f32 bit puts on the other side of a rounding boundary
# runs down the chain.
LOSS_RTOL, GRAD_REL_L2, GRAD_COS = 1e-3, 5e-3, 0.9999
# (hidden, frames, columns): one, two and three layers; N a multiple of 64
# and ragged.
CASES = [((32,), 2, 128), ((32, 32), 2, 100), ((32, 16, 16), 3, 256)]


def composed(port, args):
    """k1_dw_plain(k1_chain_plain(..., quant="int8fwd")) as grads and the
    loss vector."""
    chain = fu.k1_chain_plain(port, *args, **INT8FWD)
    dw, dwpv = fu.k1_dw_plain(chain, args[0])
    grads = fu._merged_grads(dense_layers(port)[0], dw, chain.db, dwpv, chain.dbpv, A)
    m = args[1].numel()
    return grads, fu._loss_vector(chain.sums, 1.0 / m, KW["value_coef"], KW["entropy_coef"])


@pytest.mark.parametrize("hidden,t_mb,n", CASES)
def test_composed_stages_match_jax_interpret(hidden, t_mb, n):
    params, port, leaves, args = make_inputs(hidden, "tanh", t_mb, n)
    want_grads, want_losses = jax_fused_fm(params, *map(jnp.asarray, leaves), interpret=True,
                                           **INT8FWD)
    grads, losses = composed(port, args)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL,
                               atol=1e-5)
    dense = want_grads["params"]
    for i, name in enumerate(dense_layers(grads)[0]):
        for leaf in ("kernel", "bias"):
            g = grads[f"{name}.{leaf}"].double().numpy().ravel()
            w = np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel()
            assert g.shape == w.shape, (name, leaf)
            rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
            assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, leaf, rel, cos)
    # The int8fwd mode of the plain version is these two stages.
    plain_grads, plain_losses = fu.fused_ppo_grads_fm_plain(port, *args, **INT8FWD)
    assert torch.equal(plain_losses, losses)
    for k in grads:
        torch.testing.assert_close(plain_grads[k], grads[k], rtol=1e-6, atol=1e-9)


def test_columns_past_n_contribute_nothing():
    """A ragged frame's pad columns hold h != 0 but dheads = dpre = 0: the dW
    are bit for bit those of zero padding."""
    _, port, _, args = make_inputs((32, 16), "tanh", 2, 77, seed=3)
    chain = fu.k1_chain_plain(port, *args, **INT8FWD)
    padded, obs_p = pad_columns(chain, args[0], 128, 4)
    zeros = fu.K1Chain([h.clone() for h in padded.hs], padded.dheads, padded.dpres,
                       chain.db, chain.dbpv, chain.sums)
    for h in zeros.hs:
        h[..., 77:] = 0
    obs_z = obs_p.clone()
    obs_z[..., 77:] = 0
    got, got_pv = fu.k1_dw_plain(padded, obs_p)
    want, want_pv = fu.k1_dw_plain(zeros, obs_z)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(got_pv, want_pv)


def test_hs_are_the_f32_activations_bf16_not_the_dequantised_int8():
    """The forward runs on int8 products, the weight scale riding the bias
    add; hs[l] is bf16 of the f32 tanh (JAX :352), while the next product
    takes its int8 q127 (which, dequantised, is another value)."""
    _, port, _, args = make_inputs((32, 32), "tanh", 2, 96, seed=5)
    _, L, w, b = dense_layers(port)
    chain = fu.k1_chain_plain(port, *args, **INT8FWD)
    wq, sw = fu.quantize_weights(w, L)
    flat = lambda x: x.float().reshape(x.shape[0], -1)              # (rows, T*N)
    h_q = fu._q127(flat(args[0].transpose(0, 1)))
    apart = 0
    for l in range(L):
        h_f = torch.tanh(wq[l].float().t() @ h_q * (sw[l] * fu.S_IN) + b[l][:, None])
        assert torch.equal(chain.hs[l], h_f.to(BF16).reshape(chain.hs[l].shape))
        h_q = fu._q127(h_f)
        apart += int((flat(chain.hs[l]) != (h_q * fu.S_IN).to(BF16).float()).sum())
    assert apart > 0, "bf16(h_f) equals the dequantised h_q everywhere"


def test_backward_is_the_bf16_chain_on_the_bf16_weights():
    """After the int8 forward, the chain is the bf16 mode's: dh from the
    bf16 weights (not the int8 ones), dpre_l = bf16(dh * (1 - h^2)) with h
    the bf16 operand, the bias grads the f32 row sums of the unrounded dpre."""
    _, port, _, args = make_inputs((32, 16), "tanh", 2, 64, seed=6)
    _, L, w, b = dense_layers(port)
    chain = fu.k1_chain_plain(port, *args, **INT8FWD)
    flat = lambda x: x.float().reshape(x.shape[0], -1)
    dh = torch.cat([w[L], w[L + 1]], dim=1).to(BF16).float() @ flat(chain.dheads)
    for l in range(L - 1, -1, -1):
        h = flat(chain.hs[l])
        dpre = dh * (1.0 - h * h)
        assert torch.equal(chain.dpres[l], dpre.to(BF16).reshape(chain.dpres[l].shape))
        torch.testing.assert_close(chain.db[l], dpre.sum(dim=1), rtol=1e-5, atol=1e-8)
        dh = w[l].to(BF16).float() @ flat(chain.dpres[l])


def test_stage_entries_run_plain_on_cpu():
    _, port, _, args = make_inputs((32,), "tanh", 2, 64, seed=7)
    before = (fu.k1_chain.launches, fu.k1_dw.launches, fu.fused_ppo_grads_fm.launches,
              dict(fu.fused_ppo_grads_fm.launches_by_kernel))
    chain = fu.k1_chain(port, *args, **INT8FWD)
    want = fu.k1_chain_plain(port, *args, **INT8FWD)
    for a, b in zip((*chain.hs, chain.dheads, *chain.dpres, *chain.db, chain.dbpv, chain.sums),
                    (*want.hs, want.dheads, *want.dpres, *want.db, want.dbpv, want.sums)):
        assert torch.equal(a, b)
    dw, dwpv = fu.k1_dw(chain, args[0])
    dw_p, dwpv_p = fu.k1_dw_plain(chain, args[0])
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_p)) and torch.equal(dwpv, dwpv_p)
    grads, losses = fu.fused_ppo_grads_fm(port, *args, **INT8FWD)
    plain_grads, plain_losses = fu.fused_ppo_grads_fm_plain(port, *args, **INT8FWD)
    assert torch.equal(losses, plain_losses)
    assert all(torch.equal(grads[k], plain_grads[k]) for k in grads)
    assert (fu.k1_chain.launches, fu.k1_dw.launches, fu.fused_ppo_grads_fm.launches,
            fu.fused_ppo_grads_fm.launches_by_kernel) == before


def test_chain_takes_only_its_modes():
    """Kernel A runs the bf16 and int8fwd modes only; int8fwd takes tanh
    only, as the JAX wrapper's checks say."""
    _, port, _, args = make_inputs((32,), "tanh", 1, 64, seed=8)
    for fn in (fu.k1_chain, fu.k1_chain_plain):
        with pytest.raises(ValueError, match="int8fwd"):
            fn(port, *args, **dict(KW, quant="int8"))
        with pytest.raises(ValueError, match="tanh"):
            fn(port, *args, **dict(INT8FWD, activation="relu"))
