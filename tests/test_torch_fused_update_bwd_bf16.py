"""K1's bf16 backward chain (``bwd_bf16=True``, after the bf16 or the
int8fwd forward) as its two kernels compute it: the chain's plain version
(``k1_chain_plain(..., bwd_bf16=True)``, kernel A of
``csrc/fused_update_bf16.cu`` with the bf16 chain in its backward epilogue)
and the dW products' (``k1_dw_plain``, kernel B, unchanged), composed,
against the JAX package's ``fused_ppo_grads_fm(bwd_bf16=True)`` in interpret
mode; the chain's rounding points; the columns past N of a padded
workspace; the stage entries on the CPU.  The kernels build only with nvcc:
chip_smoke.py holds them against these plain versions on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads_fm as jax_fused_fm
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.networks import BF16, dense_layers
from test_torch_fused_update_quant import GRAD_COS, GRAD_REL_L2, LOSS_RTOL
from test_torch_fused_update_split import KW, make_inputs, pad_columns

A = KW["num_actions"]
# (quant, activation, hidden, frames, columns): one, two and three layers; N
# a multiple of 64 and ragged; int8fwd takes tanh only.
CASES = [("none", "tanh", (32,), 2, 128), ("none", "relu", (32, 32), 2, 100),
         ("none", "tanh", (32, 16, 16), 3, 77), ("none", "relu", (16, 32), 2, 256),
         ("int8fwd", "tanh", (32, 32), 2, 128), ("int8fwd", "tanh", (32, 16, 16), 2, 100)]
# (quant, activation) of the chain's own checks.
MODES = [("none", "tanh"), ("none", "relu"), ("int8fwd", "tanh")]


def mode_kw(quant, activation):
    return dict(KW, activation=activation, quant=quant, bwd_bf16=True)


def composed(port, args, kw):
    """k1_dw_plain(k1_chain_plain(..., bwd_bf16=True)) as grads and the loss
    vector."""
    chain = fu.k1_chain_plain(port, *args, **kw)
    dw, dwpv = fu.k1_dw_plain(chain, args[0])
    grads = fu._merged_grads(dense_layers(port)[0], dw, chain.db, dwpv, chain.dbpv, A)
    m = args[1].numel()
    return grads, fu._loss_vector(chain.sums, 1.0 / m, KW["value_coef"], KW["entropy_coef"])


def summed_unrounded(port, chain, activation):
    """The f32 row sums of the chain's dh_b * act'(h) before that product's
    bf16 round, layer by layer, dh_b rebuilt from the chain's own operands:
    what the JAX kernel's bias grads come to in interpret mode on the CPU,
    where XLA drops the bf16 round between the product and its f32 sum
    (``colsum(dpre_b.astype(f32))``).  The port and kernel A sum the rounded
    dpre_b, as that line says; the two differ by ~1e-3 to 1e-2 relative on
    a tanh layer's bias at these widths (relu's products are exact)."""
    _, L, w, _ = dense_layers(port)
    flat = lambda x: x.float().reshape(x.shape[0], -1)              # (rows, T*N)
    dh_b = (torch.cat([w[L], w[L + 1]], dim=1).to(BF16).float() @ flat(chain.dheads)).to(BF16)
    sums = [None] * L
    for l in range(L - 1, -1, -1):
        h = flat(chain.hs[l])
        da = (h > 0).float() if activation == "relu" else (1.0 - h.to(BF16) * h.to(BF16)).float()
        sums[l] = (dh_b.float() * da).sum(dim=1)
        dh_b = (w[l].to(BF16).float() @ flat(chain.dpres[l])).to(BF16)
    return sums


@pytest.mark.parametrize("quant,activation,hidden,t_mb,n", CASES)
def test_composed_stages_match_jax_interpret(quant, activation, hidden, t_mb, n):
    """Losses and every weight grad against JAX; each hidden bias grad of
    JAX against the sums it takes in interpret mode (``summed_unrounded``)
    of the port's chain, and the port's own bias grads are the f32 sums of
    its rounded dpre_b."""
    params, port, leaves, args = make_inputs(hidden, activation, t_mb, n)
    kw = mode_kw(quant, activation)
    want_grads, want_losses = jax_fused_fm(params, *map(jnp.asarray, leaves), interpret=True,
                                           **kw)
    grads, losses = composed(port, args, kw)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL,
                               atol=1e-5)
    chain = fu.k1_chain_plain(port, *args, **kw)
    unrounded = summed_unrounded(port, chain, activation)
    names = dense_layers(grads)[0]
    dense = want_grads["params"]
    for i, name in enumerate(names):
        for leaf in ("kernel", "bias"):
            port_leaf = grads[f"{name}.{leaf}"]
            if leaf == "bias" and i < len(hidden):
                port_leaf = unrounded[i]
                torch.testing.assert_close(grads[f"{name}.bias"],
                                           chain.dpres[i].float().sum(dim=(1, 2)),
                                           rtol=1e-5, atol=1e-8)
            g = port_leaf.double().numpy().ravel()
            w = np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel()
            assert g.shape == w.shape, (name, leaf)
            rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
            assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, leaf, rel, cos)
    # The bf16 chain of the plain version is these two stages.
    plain_grads, plain_losses = fu.fused_ppo_grads_fm_plain(port, *args, **kw)
    assert torch.equal(plain_losses, losses)
    for k in grads:
        torch.testing.assert_close(plain_grads[k], grads[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("quant,activation", MODES)
def test_chain_is_the_bf16_recurrence(quant, activation):
    """Entry for entry: dh_b = bf16(Wpv . dheads_b), then layer by layer
    dpre_b = dh_b * act'(h) with each op rounded to bf16 (tanh: 1 - h*h;
    relu: [h > 0]) and dh_b = bf16(W_l . dpre_b); db[l] is the f32 sum of
    the rounded dpre_b, not of the f32 chain's unrounded dpre."""
    _, port, _, args = make_inputs((32, 16), activation, 2, 64, seed=6)
    _, L, w, _ = dense_layers(port)
    chain = fu.k1_chain_plain(port, *args, **mode_kw(quant, activation))
    for x in (*chain.hs, chain.dheads, *chain.dpres):
        assert x.dtype == BF16
    flat = lambda x: x.float().reshape(x.shape[0], -1)              # (rows, T*N)
    dh_b = (torch.cat([w[L], w[L + 1]], dim=1).to(BF16).float() @ flat(chain.dheads)).to(BF16)
    for l in range(L - 1, -1, -1):
        h = flat(chain.hs[l]).to(BF16)
        da = (h > 0).to(BF16) if activation == "relu" else 1.0 - h * h
        dpre_b = dh_b * da
        assert dpre_b.dtype == BF16
        assert torch.equal(chain.dpres[l], dpre_b.reshape(chain.dpres[l].shape))
        torch.testing.assert_close(chain.db[l], dpre_b.float().sum(dim=1), rtol=1e-5, atol=1e-8)
        unrounded = (dh_b.float() * (h.float() > 0).float() if activation == "relu"
                     else dh_b.float() * (1.0 - h.float() * h.float())).sum(dim=1)
        if activation == "tanh":
            assert float((chain.db[l] - unrounded).abs().max()) > 0, "db summed the f32 chain"
        dh_b = (w[l].to(BF16).float() @ dpre_b.float()).to(BF16)
    # The f32 chain of the same mode sums other values into db; with tanh it
    # rounds its operands elsewhere too (relu's bf16(dh * [h > 0]) is
    # bf16(dh) * [h > 0], so there the operands agree).
    f32_chain = fu.k1_chain_plain(port, *args, **dict(mode_kw(quant, activation), bwd_bf16=False))
    apart = any(not torch.equal(a, b) for a, b in zip(chain.dpres, f32_chain.dpres))
    assert apart == (activation == "tanh")
    assert any(not torch.equal(a, b) for a, b in zip(chain.db, f32_chain.db))
    assert all(torch.equal(a, b) for a, b in zip(chain.hs, f32_chain.hs))
    assert torch.equal(chain.dheads, f32_chain.dheads) and torch.equal(chain.sums, f32_chain.sums)


@pytest.mark.parametrize("quant,activation", MODES)
def test_columns_past_n_contribute_nothing(quant, activation):
    """A ragged frame's pad columns hold h != 0 but dheads = dpre_b = 0: the
    dW are bit for bit those of zero padding."""
    _, port, _, args = make_inputs((32, 16), activation, 2, 77, seed=3)
    chain = fu.k1_chain_plain(port, *args, **mode_kw(quant, activation))
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


@pytest.mark.parametrize("quant", ["none", "int8fwd"])
def test_stage_entries_run_plain_on_cpu(quant):
    _, port, _, args = make_inputs((32,), "tanh", 2, 64, seed=7)
    kw = mode_kw(quant, "tanh")
    before = (fu.k1_chain.launches, fu.k1_dw.launches, fu.fused_ppo_grads_fm.launches,
              dict(fu.fused_ppo_grads_fm.launches_by_mode),
              dict(fu.fused_ppo_grads_fm.launches_by_kernel))
    chain = fu.k1_chain(port, *args, **kw)
    want = fu.k1_chain_plain(port, *args, **kw)
    for a, b in zip((*chain.hs, chain.dheads, *chain.dpres, *chain.db, chain.dbpv, chain.sums),
                    (*want.hs, want.dheads, *want.dpres, *want.db, want.dbpv, want.sums)):
        assert torch.equal(a, b)
    dw, dwpv = fu.k1_dw(chain, args[0])
    dw_p, dwpv_p = fu.k1_dw_plain(chain, args[0])
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_p)) and torch.equal(dwpv, dwpv_p)
    grads, losses = fu.fused_ppo_grads_fm(port, *args, **kw)
    plain_grads, plain_losses = fu.fused_ppo_grads_fm_plain(port, *args, **kw)
    assert torch.equal(losses, plain_losses)
    assert all(torch.equal(grads[k], plain_grads[k]) for k in grads)
    assert (fu.k1_chain.launches, fu.k1_dw.launches, fu.fused_ppo_grads_fm.launches,
            fu.fused_ppo_grads_fm.launches_by_mode,
            fu.fused_ppo_grads_fm.launches_by_kernel) == before
    # The one-kernel design is gone: its launches are counted nowhere.
    assert set(fu.fused_ppo_grads_fm.launches_by_kernel) == {"bf16_chain", "bf16_chain_wgmma",
                                                            "bf16_dw", *fu.INT8_KERNELS}
    assert not hasattr(fu, "_library")


def test_chain_takes_only_its_modes():
    """Kernel A's bf16 chain runs after the bf16 and int8fwd forwards only:
    the int8 mode has its own backward; int8fwd takes tanh only."""
    _, port, _, args = make_inputs((32,), "tanh", 1, 64, seed=8)
    for fn in (fu.k1_chain, fu.k1_chain_plain):
        with pytest.raises(ValueError, match="int8fwd"):
            fn(port, *args, **mode_kw("int8", "tanh"))
        with pytest.raises(ValueError, match="tanh"):
            fn(port, *args, **mode_kw("int8fwd", "relu"))
