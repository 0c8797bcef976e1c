"""K1's bf16 mode as its two kernels compute it: the chain's plain version
(``k1_chain_plain``, kernel A of ``csrc/fused_update_bf16.cu``) and the dW
products' (``k1_dw_plain``, kernel B), composed, against the JAX package's
``fused_ppo_grads_fm`` in interpret mode; the columns past N of a padded
workspace; and the operands' rounding points.  The kernels themselves build
only with nvcc: chip_smoke.py holds them against these plain versions on
the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.train.fused_update import fused_ppo_grads_fm as jax_fused_fm
from pikazoo_tpu.train.networks import ActorCritic as JaxActorCritic
from pikazoo_tpu_torch.convert import params_from_flax
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.networks import BF16, dense_layers
from torch_helpers import to_torch

A, F = 18, 35
KW = dict(num_actions=A, clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
# (hidden, activation, frames, columns): one, two and three layers; N a
# multiple of 64 and ragged.
CASES = [((32,), "tanh", 2, 128), ((32, 32), "relu", 2, 128),
         ((32, 16, 16), "tanh", 2, 77), ((16, 32), "relu", 3, 100)]


def make_inputs(hidden, activation, t_mb, n, seed=0):
    """numpy-seeded inputs as tests/test_torch_fused_update.py builds them,
    for any hidden widths; returns (flax params, port params, JAX leaves,
    port leaves)."""
    rng = np.random.default_rng(seed)
    net = JaxActorCritic(num_actions=A, hidden=hidden, activation=activation)
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
    port = params_from_flax(jax.device_get(params))
    return params, port, leaves, [to_torch(x) for x in leaves]


def composed(port, args, activation):
    """k1_dw_plain(k1_chain_plain(...)) as grads and the loss vector."""
    chain = fu.k1_chain_plain(port, *args, activation=activation, **KW)
    dw, dwpv = fu.k1_dw_plain(chain, args[0])
    names = dense_layers(port)[0]
    grads = fu._merged_grads(names, dw, chain.db, dwpv, chain.dbpv, A)
    m = args[1].numel()
    return grads, fu._loss_vector(chain.sums, 1.0 / m, KW["value_coef"], KW["entropy_coef"])


@pytest.mark.parametrize("hidden,activation,t_mb,n", CASES)
def test_composed_stages_match_jax_interpret(hidden, activation, t_mb, n):
    params, port, leaves, args = make_inputs(hidden, activation, t_mb, n)
    want_grads, want_losses = jax_fused_fm(params, *map(jnp.asarray, leaves),
                                           activation=activation, interpret=True, **KW)
    grads, losses = composed(port, args, activation)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4, atol=1e-5)
    names = dense_layers(grads)[0]
    dense = want_grads["params"]
    for i, name in enumerate(names):
        for leaf in ("kernel", "bias"):
            g = grads[f"{name}.{leaf}"].double().numpy().ravel()
            w = np.asarray(dense[f"Dense_{i}"][leaf], np.float64).ravel()
            assert g.shape == w.shape, (name, leaf)
            rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)
            assert cos >= 0.9999 and rel <= 2e-3, (name, leaf, rel, cos)
    # The bf16 mode of the plain version is these two stages.
    plain_grads, plain_losses = fu.fused_ppo_grads_fm_plain(port, *args, activation=activation,
                                                            **KW)
    assert torch.equal(plain_losses, losses)
    for k in grads:
        torch.testing.assert_close(plain_grads[k], grads[k], rtol=1e-6, atol=1e-9)


def pad_columns(chain, obs, cols, seed):
    """The chain's operands and obs padded to ``cols`` columns as kernel A's
    workspace pads them: dheads and dpre zero, h and x not (random here)."""
    gen = torch.Generator().manual_seed(seed)
    n = obs.shape[2]

    def pad(x, fill):
        out = (torch.rand((*x.shape[:-1], cols), generator=gen) + 0.5 if fill
               else torch.zeros((*x.shape[:-1], cols))).to(x.dtype)
        out[..., :n] = x
        return out

    return (fu.K1Chain([pad(h, True) for h in chain.hs], pad(chain.dheads, False),
                       [pad(d, False) for d in chain.dpres], chain.db, chain.dbpv, chain.sums),
            pad(obs, True))


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_columns_past_n_contribute_nothing(activation):
    """A ragged frame's pad columns hold h = act(b) != 0 but dheads = dpre = 0:
    the dW are bit for bit those of zero padding, and those of no padding
    up to the f32 sums' order."""
    _, port, _, args = make_inputs((32, 16), activation, 2, 77, seed=3)
    chain = fu.k1_chain_plain(port, *args, activation=activation, **KW)
    obs = args[0]
    padded, obs_p = pad_columns(chain, obs, 128, 4)
    zeros = fu.K1Chain([h.clone() for h in padded.hs], padded.dheads, padded.dpres,
                       chain.db, chain.dbpv, chain.sums)
    for h in zeros.hs:
        h[..., 77:] = 0
    obs_z = obs_p.clone()
    obs_z[..., 77:] = 0
    assert all(bool((h[..., 77:] != 0).all()) for h in padded.hs)
    got, got_pv = fu.k1_dw_plain(padded, obs_p)
    want, want_pv = fu.k1_dw_plain(zeros, obs_z)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(got_pv, want_pv)
    ref, ref_pv = fu.k1_dw_plain(chain, obs)
    for a, b in [*zip(got, ref), (got_pv, ref_pv)]:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_chain_operands_are_the_rounding_points(activation):
    """Each operand is the bf16 of the f32 value that the layer computes from
    the operands before it, and the bias grads are the f32 row sums of the
    unrounded dpre (not of its bf16)."""
    _, port, _, args = make_inputs((32, 32, 16), activation, 2, 96, seed=5)
    names, L, w, b = dense_layers(port)
    chain = fu.k1_chain_plain(port, *args, activation=activation, **KW)
    for x in (*chain.hs, chain.dheads, *chain.dpres):
        assert x.dtype == BF16
    flat = lambda x: x.float().reshape(x.shape[0], -1)              # (rows, T*N)
    act = torch.relu if activation == "relu" else torch.tanh
    below = flat(args[0].transpose(0, 1))
    for l in range(L):
        pre = w[l].to(BF16).float().t() @ below + b[l][:, None]
        assert torch.equal(chain.hs[l], act(pre).to(BF16).reshape(chain.hs[l].shape))
        below = flat(chain.hs[l])
    wpv = torch.cat([w[L], w[L + 1]], dim=1).to(BF16).float()
    dh = wpv @ flat(chain.dheads)
    for l in range(L - 1, -1, -1):
        h = flat(chain.hs[l])
        dpre = dh * ((h > 0).float() if activation == "relu" else 1.0 - h * h)
        assert torch.equal(chain.dpres[l], dpre.to(BF16).reshape(chain.dpres[l].shape))
        torch.testing.assert_close(chain.db[l], dpre.sum(dim=1), rtol=1e-5, atol=1e-8)
        rounded = flat(chain.dpres[l]).sum(dim=1)
        assert float((chain.db[l] - rounded).abs().max()) > 0, "db summed bf16(dpre)"
        dh = w[l].to(BF16).float() @ flat(chain.dpres[l])


def test_stage_entries_run_plain_on_cpu():
    _, port, _, args = make_inputs((32,), "tanh", 2, 64, seed=7)
    before = (fu.k1_chain.launches, fu.k1_dw.launches, fu.fused_ppo_grads_fm.launches)
    chain = fu.k1_chain(port, *args, activation="tanh", **KW)
    want = fu.k1_chain_plain(port, *args, activation="tanh", **KW)
    for a, b in zip((*chain.hs, chain.dheads, *chain.dpres, *chain.db, chain.dbpv, chain.sums),
                    (*want.hs, want.dheads, *want.dpres, *want.db, want.dbpv, want.sums)):
        assert torch.equal(a, b)
    dw, dwpv = fu.k1_dw(chain, args[0])
    dw_p, dwpv_p = fu.k1_dw_plain(chain, args[0])
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_p)) and torch.equal(dwpv, dwpv_p)
    assert (fu.k1_chain.launches, fu.k1_dw.launches, fu.fused_ppo_grads_fm.launches) == before
    assert fu._ws_rows([32, 16]) == ([0, 32], 48, [80, 112], 128)



@pytest.mark.parametrize("quant, bound_ms", [("none", 1.94337), ("int8fwd", 1.60664),
                                             ("int8", 1.01247)])
def test_chip_smoke_takes_the_benchmark_yardstick(quant, bound_ms):
    """chip_smoke.py's bounds come from benchmark/counts.py's constants and
    arithmetic, so the bound a kernel is printed beside and the one the
    benchmark's roofline metrics divide by cannot drift apart.  K1 at full
    width (32 x 131,072 columns, hidden (256, 256)) reads the bounds that
    PERF.md quotes."""
    import chip_smoke
    from benchmark import counts

    assert chip_smoke.PEAK_OPS_PER_S is counts.PEAK_OPS_PER_S
    rows = 32 * 131072
    got = chip_smoke.grad_bound(rows, quant)
    assert got[0] == pytest.approx(bound_ms, rel=1e-4) and got[1] == "operations"
    if quant == "none":
        assert got[0] == counts.grad_bound_s(rows, chip_smoke.HIDDEN)[0] * 1e3
