"""K1's int8 mode as its split kernels compute it: the chain's plain version
(``k1_int8_chain_plain``, kernels A and S of ``csrc/fused_update_int8.cu``)
and the dW products' (``k1_int8_dw_plain``, kernel Q and the head's bf16
product), composed, against the JAX package's ``fused_ppo_grads_fm(quant=
"int8")`` in interpret mode; the operands' rounding points; the columns past
N of a padded workspace; the weights as the kernels take them; and the cell
width the int32 sums allow.  The kernels themselves build only with nvcc:
chip_smoke.py holds them against these plain versions on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads_fm as jax_fused_fm
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.networks import BF16, dense_layers
from test_torch_fused_update_quant import GRAD_COS, GRAD_REL_L2, LOSS_RTOL
from test_torch_fused_update_split import KW, make_inputs

A = KW["num_actions"]
TANH = dict(KW, activation="tanh")


def composed(port, args):
    """k1_int8_dw_plain(k1_int8_chain_plain(...)) as grads and the loss vector."""
    chain = fu.k1_int8_chain_plain(port, *args, **TANH)
    dw, dwpv = fu.k1_int8_dw_plain(chain)
    names = dense_layers(port)[0]
    grads = fu._merged_grads(names, dw, chain.db, dwpv, chain.dbpv, A)
    m = args[1].numel()
    return grads, fu._loss_vector(chain.sums, 1.0 / m, KW["value_coef"], KW["entropy_coef"])


@pytest.mark.parametrize("n", [1000, 2048])
@pytest.mark.parametrize("hidden", [(32,), (32, 32)])
def test_composed_stages_match_jax_interpret(hidden, n):
    """N=1000 is one whole-frame cell, N=2048 two cells of 1024 columns."""
    params, port, leaves, args = make_inputs(hidden, "tanh", 2, n, seed=1)
    want_grads, want_losses = jax_fused_fm(params, *map(jnp.asarray, leaves), activation="tanh",
                                           interpret=True, quant="int8", **KW)
    grads, losses = composed(port, args)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL, atol=1e-5)
    dense = want_grads["params"]
    for i, name in enumerate(dense_layers(grads)[0]):
        for leaf in ("kernel", "bias"):
            g = grads[f"{name}.{leaf}"].double().numpy().ravel()
            w = np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel()
            assert g.shape == w.shape, (name, leaf)
            rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
            assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (name, leaf, rel, cos)
    # The int8 mode of the plain version is these stages, a frame at a time.
    plain_grads, plain_losses = fu.fused_ppo_grads_fm_plain(port, *args, quant="int8", **TANH)
    torch.testing.assert_close(plain_losses, losses, rtol=1e-6, atol=1e-9)
    for k in grads:
        torch.testing.assert_close(plain_grads[k], grads[k], rtol=1e-6, atol=1e-9)


def test_chain_operands_are_the_rounding_points():
    """x_q, h_q and dp_q are integers in [-127, 127]; each is the rounding of
    the f32 value the layer computes from the operands before it; each cell
    maximum is the max-abs of that frame and cell's f32 dpre; bf16(dheads)
    is the bf16 of the f32 dheads, bf16(h_top) that of bf16(h_q) *
    bf16(1/127); the bias grads are the f32 row sums of the unquantised
    dpre."""
    _, port, _, args = make_inputs((32, 16), "tanh", 2, 512, seed=5)
    _, L, w, b = dense_layers(port)
    chain = fu.k1_int8_chain_plain(port, *args, **TANH)
    ints = [chain.x_q, *chain.hs, *chain.dp_q]
    assert all(x.dtype == torch.int8 and int(x.abs().max()) <= 127 for x in ints)
    assert chain.dheads.dtype == chain.h_top.dtype == BF16
    flat = lambda x: x.float().reshape(x.shape[0], -1)                # (rows, T*N)
    wq, sw = fu.quantize_weights(w, L)
    wq = [q.float() for q in wq]
    below = fu._q127(flat(args[0].transpose(0, 1)))
    assert torch.equal(flat(chain.x_q), below)
    for l in range(L):
        pre = wq[l].t() @ below * (sw[l] * fu.S_IN) + b[l].float()[:, None]
        below = fu._q127(torch.tanh(pre))
        assert torch.equal(flat(chain.hs[l]), below)
    s_in_b = torch.tensor(fu.S_IN, dtype=BF16)
    assert torch.equal(chain.h_top, chain.hs[-1].to(BF16) * s_in_b)
    bpv = torch.cat([b[L], b[L + 1]]).float()
    heads = wq[L].t() @ below * (sw[L] * fu.S_IN) + bpv[:, None]
    action, logp_old, value_old, adv, target = (x.reshape(-1) for x in args[1:])
    _, dlogits, dvalue = fu._loss_and_dheads(heads[:A], heads[A], action, logp_old, adv,
                                             value_old, target, inv_m=1.0 / action.numel(),
                                             clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
    dheads = torch.cat([dlogits, dvalue[None]])
    assert torch.equal(flat(chain.dheads), dheads.to(BF16).float())
    torch.testing.assert_close(chain.dbpv, dheads.sum(dim=1), rtol=1e-5, atol=1e-8)
    cell = fu.cell_cols(512)
    for l in range(L):
        dpre = chain.dpres[l]                                         # (H, T, N)
        amax = dpre.abs().reshape(dpre.shape[0], 2, -1, cell).amax(dim=(0, 3))
        assert torch.equal(chain.cellmax[l], amax)
        scale = (127.0 / torch.clamp(amax, min=1e-30)).repeat_interleave(cell, dim=1)
        assert torch.equal(chain.dp_q[l].float(), torch.round(dpre * scale))
        torch.testing.assert_close(chain.db[l], flat(dpre).sum(dim=1), rtol=1e-5, atol=1e-8)


def pad_chain(chain, cols, seed):
    """The chain padded to ``cols`` columns as kernels A and S pad the
    workspace: dheads, dpre and dp_q zero, x_q zero, h_q and bf16(h_top) not
    (random here: the kernel leaves the activations of x_q = 0)."""
    gen = torch.Generator().manual_seed(seed)
    n = chain.x_q.shape[-1]

    def pad(x, fill):
        out = torch.zeros((*x.shape[:-1], cols), dtype=x.dtype)
        if fill:
            out = torch.randint(-127, 128, out.shape, generator=gen).to(x.dtype)
        out[..., :n] = x
        return out

    return fu.K1Int8Chain(pad(chain.x_q, False), [pad(h, True) for h in chain.hs],
                          pad(chain.h_top, True), pad(chain.dheads, False),
                          [pad(d, False) for d in chain.dpres], [pad(d, False) for d in chain.dp_q],
                          chain.cellmax, chain.db, chain.dbpv, chain.sums)


def test_columns_past_n_contribute_nothing():
    """A ragged frame (N=1000, one whole-frame cell) padded to 1024 columns:
    the pad holds nonzero h_q but dp_q = dheads = 0, so every hidden dW is
    bit for bit the unpadded one (exact integer sums), the head's up to the
    f32 sums' order, and the cell maxima and bias grads of the padded dpre
    are the unpadded ones."""
    _, port, _, args = make_inputs((32, 16), "tanh", 2, 1000, seed=3)
    chain = fu.k1_int8_chain_plain(port, *args, **TANH)
    padded = pad_chain(chain, 1024, 4)
    assert fu.cell_cols(1024) == 1024 and fu.cell_cols(1000) == 1000
    assert all(bool((h[..., 1000:] != 0).any()) for h in padded.hs)
    got, got_pv = fu.k1_int8_dw_plain(padded)
    want, want_pv = fu.k1_int8_dw_plain(chain)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.testing.assert_close(got_pv, want_pv, rtol=1e-5, atol=1e-7)
    for l, dpre in enumerate(padded.dpres):
        assert torch.equal(dpre.abs().amax(dim=(0, 2)), chain.cellmax[l][:, 0])
        torch.testing.assert_close(dpre.sum(dim=(1, 2)), chain.db[l], rtol=1e-6, atol=1e-9)


def test_stage_entries_run_plain_on_cpu():
    _, port, _, args = make_inputs((32,), "tanh", 2, 256, seed=7)
    counts = lambda: (fu.k1_int8_chain.launches, fu.k1_int8_dw.launches,
                      dict(fu.fused_ppo_grads_fm.launches_by_mode),
                      dict(fu.fused_ppo_grads_fm.launches_by_kernel))
    before = counts()
    chain = fu.k1_int8_chain(port, *args, **TANH)
    want = fu.k1_int8_chain_plain(port, *args, **TANH)
    for a, b in zip(torch.utils._pytree.tree_leaves(tuple(chain)),
                    torch.utils._pytree.tree_leaves(tuple(want))):
        assert torch.equal(a, b)
    dw, dwpv = fu.k1_int8_dw(chain)
    dw_p, dwpv_p = fu.k1_int8_dw_plain(chain)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_p)) and torch.equal(dwpv, dwpv_p)
    assert counts() == before
    # The workspace's rows and cells as the kernels lay them out.
    assert fu._int8_rows(35, [32, 16]) == ([48, 80], [96, 128], 144)
    assert fu._int8_cells(131072) == (1024, 128)
    assert fu._int8_cells(1000) == (1024, 1) and fu._int8_cells(3000) == (3008, 1)


def test_int8_net_is_the_quantised_net_padded():
    """The weights the kernels take: the forward kernels transposed with the
    contraction zero-padded to 32 (the first from Fp = 48 to 64), the merged
    head likewise; the hidden kernels for the dh products with their
    outputs padded to 32; the int8 head as bf16; the same scales as
    ``quantize_weights``."""
    _, port, _, _ = make_inputs((48, 16), "tanh", 1, 64, seed=2)
    _, L, w, b = dense_layers(port)
    hidden = [48, 16]
    fwd, bwd, whb, biases, sw = fu._int8_net(w, b, L, 35, A, hidden)
    wq, sw_want = fu.quantize_weights(w, L)
    assert torch.equal(sw, sw_want)
    assert [tuple(x.shape) for x in fwd] == [(48, 64), (16, 64), (32, 32)]
    assert [tuple(x.shape) for x in bwd[1:]] == [(48, 32)]
    assert torch.equal(fwd[0][:, :35], wq[0].t()) and not fwd[0][:, 35:].any()
    assert torch.equal(fwd[1][:, :48], wq[1].t()) and not fwd[1][:, 48:].any()
    assert torch.equal(fwd[2][:A + 1, :16], wq[2].t()) and not fwd[2][A + 1:].any()
    assert not fwd[2][:, 16:].any()
    assert torch.equal(bwd[1][:, :16], wq[1]) and not bwd[1][:, 16:].any()
    assert whb.dtype == BF16 and torch.equal(whb[:, :A + 1].float(), wq[2].float())
    assert not whb[:, A + 1:].any()
    assert torch.equal(biases[-1][:A + 1], torch.cat([b[L], b[L + 1]]).float())
    assert not biases[-1][A + 1:].any()


def test_wrapper_raises_on_a_cell_too_wide_for_int32():
    """A frame of N columns, N no multiple of 128, is one cell; past 133,144
    columns its int32 dW sums could overflow, so the int8 mode refuses it.
    A multiple of 128 that wide has cells of 1024 columns and passes the
    check."""
    assert fu.INT8_MAX_CELL * 127 ** 2 < 2 ** 31 <= (fu.INT8_MAX_CELL + 1) * 127 ** 2
    fu.check_int8_cells(fu.INT8_MAX_CELL)
    fu.check_int8_cells(1040 * 128)
    _, port, _, _ = make_inputs((16,), "tanh", 1, 64, seed=4)
    n = 133200
    obs = torch.zeros((1, 35, n), dtype=BF16)
    zeros = torch.zeros((1, n))
    action = torch.zeros((1, n), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fu.fused_ppo_grads_fm(port, obs, action, zeros, zeros, zeros, zeros, quant="int8", **TANH)
    with pytest.raises(ValueError, match="int32"):
        fu.check_int8_cells(n)


def test_precision_probe_anchors_match_the_source():
    """tools/k1_precision_probe.py probes every mode of K1 on its split
    source: each mode names a source that exists, none names the deleted
    one-kernel csrc/fused_update.cu, the modes are the wrapper's, and
    without a card the tool refuses before it builds anything."""
    from pikazoo_tpu_torch import _build
    from pikazoo_tpu_torch.tools import k1_precision_probe as probe

    assert set(probe.SOURCES) == set(probe.MODES) == {
        fu.mode_name(kw.get("quant", "none"), kw.get("bwd_bf16", False))
        for kw in probe.MODES.values()}
    assert set(probe.MODES) == set(fu.fused_ppo_grads_fm.launches_by_mode)
    assert all((_build.CSRC_DIR / name).is_file() for name in probe.SOURCES.values())
    assert "fused_update.cu" not in probe.SOURCES.values()
    assert probe.SOURCES["int8"] == "fused_update_int8.cu"
    assert not (_build.CSRC_DIR / "fused_update.cu").exists()
    assert probe.main([]) == 1
