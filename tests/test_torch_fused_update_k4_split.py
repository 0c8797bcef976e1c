"""K4 as its two kernels compute it: the chain's plain version
(``k4_chain_plain``, kernel A of ``csrc/k4_split.cu``) and K1 bf16's dW
products' (``k1_dw_plain`` on the rows as one frame of columns, kernel B),
composed, against the JAX package's row-major ``fused_ppo_grads`` in
interpret mode; the rows past M of a padded workspace; the operands'
rounding points; the stage entries on the CPU.  The kernels build only with
nvcc: chip_smoke.py holds them against these plain versions on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads as jax_fused
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.networks import BF16, dense_layers
from test_torch_fused_update_split import make_inputs as make_fm_inputs
from torch_helpers import to_torch

A, F = 18, 35
KW = dict(num_actions=A, clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
# K4's bounds against JAX (tests/test_torch_fused_update_rm.py).
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
GRAD_REL_L2, GRAD_COS = 1e-3, 0.99999
# (hidden, activation, rows): one, two and three layers; M a multiple of 64
# and ragged.
CASES = [((32,), "tanh", 256), ((32, 32), "relu", 512), ((32, 16, 16), "tanh", 300),
         ((16, 32), "relu", 1000)]


def make_inputs(hidden, activation, m, seed=0):
    """The row-major minibatch of ``m`` rows that tests/test_torch_fused_update_split.py
    builds for one frame: (flax params, port params, JAX leaves, port leaves),
    obs (M, F) bf16 and the per-row inputs (M,)."""
    params, port, leaves, _ = make_fm_inputs(hidden, activation, 1, m, seed)
    rows = (jnp.swapaxes(leaves[0][0], 0, 1), *[np.asarray(x).reshape(-1) for x in leaves[1:]])
    return params, port, rows, [to_torch(x) for x in rows]


def composed(port, args, activation):
    """k1_dw_plain(k4_chain_plain(...)) as grads and the loss vector."""
    chain = fu.k4_chain_plain(port, *args, activation=activation, **KW)
    dw, dwpv = fu.k1_dw_plain(chain, args[0].t()[None])
    grads = fu._merged_grads(dense_layers(port)[0], dw, chain.db, dwpv, chain.dbpv, A)
    m = args[0].shape[0]
    return grads, fu._loss_vector(chain.sums, 1.0 / m, KW["value_coef"], KW["entropy_coef"])


@pytest.mark.parametrize("hidden,activation,m", CASES)
def test_composed_stages_match_jax_interpret(hidden, activation, m):
    params, port, leaves, args = make_inputs(hidden, activation, m)
    want_grads, want_losses = jax_fused(params, *map(jnp.asarray, leaves),
                                        activation=activation, interpret=True, **KW)
    grads, losses = composed(port, args, activation)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    dense = want_grads["params"]
    for i, name in enumerate(dense_layers(grads)[0]):
        for leaf in ("kernel", "bias"):
            g = grads[f"{name}.{leaf}"].double().numpy().ravel()
            w = np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel()
            assert g.shape == w.shape, (name, leaf)
            rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
            assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, leaf, rel, cos)
    # K4's plain version is these two stages.
    plain_grads, plain_losses = fu.fused_ppo_grads_rm_plain(port, *args, activation=activation,
                                                            **KW)
    assert torch.equal(plain_losses, losses)
    assert all(torch.equal(plain_grads[k], grads[k]) for k in grads)


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_rows_past_m_contribute_nothing(activation):
    """A ragged chunk's pad rows hold h = act(b) != 0 in the workspace but
    dheads = dpre = 0: the dW are bit for bit those of zero padding, and
    those of no padding up to the f32 sums' order."""
    _, port, _, args = make_inputs((32, 16), activation, 77, seed=3)
    chain = fu.k4_chain_plain(port, *args, activation=activation, **KW)
    x_t = args[0].t()[None]                                     # (1, F, M)
    gen = torch.Generator().manual_seed(4)

    def pad(x, fill):
        out = (torch.rand((*x.shape[:-1], 128), generator=gen) + 0.5 if fill
               else torch.zeros((*x.shape[:-1], 128))).to(x.dtype)
        out[..., :77] = x
        return out

    padded = fu.K1Chain([pad(h, True) for h in chain.hs], pad(chain.dheads, False),
                        [pad(d, False) for d in chain.dpres], chain.db, chain.dbpv, chain.sums)
    zeros = fu.K1Chain([h.clone() for h in padded.hs], padded.dheads, padded.dpres,
                       chain.db, chain.dbpv, chain.sums)
    for h in zeros.hs:
        h[..., 77:] = 0
    x_p = pad(x_t, True)
    x_z = x_p.clone()
    x_z[..., 77:] = 0
    got, got_pv = fu.k1_dw_plain(padded, x_p)
    want, want_pv = fu.k1_dw_plain(zeros, x_z)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(got_pv, want_pv)
    ref, ref_pv = fu.k1_dw_plain(chain, x_t)
    for a, b in [*zip(got, ref), (got_pv, ref_pv)]:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_dpre_takes_the_f32_derivative():
    """Each operand is the bf16 of the f32 value K4 computes from the
    operands before it: h_l from bf16(h_{l-1}); dpre_l = dh * (1 - h_l^2)
    with h_l the f32 activation, not its bf16 round (which K1 takes, and
    which gives other roundings); dh of the top layer the policy head's
    product plus the value head's; the bias grads the f32 row sums of the
    unrounded dpre."""
    _, port, _, args = make_inputs((32, 32, 16), "tanh", 192, seed=5)
    _, L, w, b = dense_layers(port)
    chain = fu.k4_chain_plain(port, *args, activation="tanh", **KW)
    for x in (*chain.hs, chain.dheads, *chain.dpres):
        assert x.dtype == BF16 and x.shape[1] == 1
    flat = lambda x: x.float()[:, 0]                                # (rows, M)
    below, h32 = args[0].float().t(), []
    for l in range(L):
        h = torch.tanh(w[l].to(BF16).float().t() @ below + b[l][:, None])
        assert torch.equal(chain.hs[l][:, 0], h.to(BF16))
        h32.append(h)
        below = flat(chain.hs[l])
    heads = flat(chain.dheads)
    dh = (w[L].to(BF16).float() @ heads[:A]) + (w[L + 1].to(BF16).float() @ heads[A:])
    flips = 0
    for l in range(L - 1, -1, -1):
        dpre = dh * (1.0 - h32[l] * h32[l])
        assert torch.equal(chain.dpres[l][:, 0], dpre.to(BF16))
        torch.testing.assert_close(chain.db[l], dpre.sum(dim=1), rtol=1e-5, atol=1e-8)
        hb = flat(chain.hs[l])
        flips += int((dpre.to(BF16) != (dh * (1.0 - hb * hb)).to(BF16)).sum())
        dh = w[l].to(BF16).float() @ flat(chain.dpres[l])
    assert flips > 0, "the f32 and the bf16 derivative round alike everywhere"


def test_stage_entries_run_plain_on_cpu():
    _, port, _, args = make_inputs((32,), "tanh", 64, seed=7)
    before = (fu.k4_chain.launches, fu.k4_dw.launches, fu.fused_ppo_grads.launches,
              dict(fu.fused_ppo_grads.launches_by_kernel))
    chain = fu.k4_chain(port, *args, activation="tanh", **KW)
    want = fu.k4_chain_plain(port, *args, activation="tanh", **KW)
    for a, b in zip((*chain.hs, chain.dheads, *chain.dpres, *chain.db, chain.dbpv, chain.sums),
                    (*want.hs, want.dheads, *want.dpres, *want.db, want.dbpv, want.sums)):
        assert torch.equal(a, b)
    dw, dwpv = fu.k4_dw(chain, args[0])
    dw_p, dwpv_p = fu.k1_dw_plain(chain, args[0].t()[None])
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_p)) and torch.equal(dwpv, dwpv_p)
    grads, losses = fu.fused_ppo_grads(port, *args, activation="tanh", **KW)
    plain_grads, plain_losses = fu.fused_ppo_grads_rm_plain(port, *args, activation="tanh", **KW)
    assert torch.equal(losses, plain_losses)
    assert all(torch.equal(grads[k], plain_grads[k]) for k in grads)
    assert (fu.k4_chain.launches, fu.k4_dw.launches, fu.fused_ppo_grads.launches,
            fu.fused_ppo_grads.launches_by_kernel) == before
    # K4's workspace: x^T (Fp rows), then K1's rows.
    assert fu._ws_rows([32, 16], 48) == ([48, 80], 96, [128, 160], 176)
