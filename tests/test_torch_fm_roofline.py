"""The products-only probe (``pikazoo_tpu_torch.tools.fm_roofline``): its
plain version against the JAX probe's Pallas kernel ``_mm_kernel`` in
interpret mode, both orders.

The JAX tool runs its variants when it is imported, so it is loaded from its
file under small sizes (T=8, N=1024, one step, no timing); the test then
builds its own ``pallas_call`` of ``_mm_kernel`` as the tool's ``mm_grads``
does (the tool's ``k_mm`` returns only ``dWp[0, 0]``).  The CUDA kernel runs
only on a card; ``chip_smoke.py`` holds it against this plain version
there."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pikazoo_tpu_torch.tools import fm_roofline as fr
from torch_helpers import to_torch

ROOT = Path(__file__).resolve().parents[1]
T_MB, B2, FT, C = 8, 1024, 8, 512
F, H, A = 35, 256, 18


@pytest.fixture(scope="module")
def jax_tool():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(PPO_2B=B2, PPO_T_MB=T_MB, K_STEPS=1, ITERS=0).items():
            mp.setenv(k, str(v))
        spec = importlib.util.spec_from_file_location("jax_fm_roofline",
                                                      ROOT / "tools" / "fm_roofline.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    """obs uniform in bf16, W1, W2 ~ 0.3 N, Wp ~ 0.05 N (the JAX probe's
    scales), from numpy."""
    rng = np.random.default_rng(0)
    obs = jnp.asarray(rng.random((T_MB, F, B2), dtype=np.float32)).astype(jnp.bfloat16)
    ws = [np.float32(s) * rng.standard_normal(shape, dtype=np.float32)
          for s, shape in ((0.3, (F, H)), (0.3, (H, H)), (0.05, (H, A)))]
    return obs, ws


def jax_mm_grads(mod, mode, obs, ws):
    """``make_k_mm(mode, 8, 512).mm_grads`` of the JAX tool, built here."""
    whole = lambda shape: pl.BlockSpec(shape, lambda i, j: (0,) * len(shape),
                                       memory_space=pltpu.VMEM)
    w_in = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
    out_shapes = [jax.ShapeDtypeStruct(w.shape, jnp.float32) for w in ws]
    return pl.pallas_call(
        functools.partial(mod._mm_kernel, mode, FT, C),
        grid=(T_MB // FT, B2 // C),
        in_specs=[pl.BlockSpec((FT, F, C), lambda i, j: (i, 0, j),
                               memory_space=pltpu.VMEM)] + [whole(w.shape) for w in ws],
        out_specs=[whole(s.shape) for s in out_shapes],
        out_shape=out_shapes,
        interpret=True,
    )(obs, *w_in)


def rel_cos(g, w):
    g, w = np.asarray(g, np.float64).ravel(), np.asarray(w, np.float64).ravel()
    rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
    return rel, g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)


@pytest.mark.parametrize("mode", ["chain", "phased"])
def test_plain_matches_jax_interpret(mode, jax_tool, inputs):
    obs, ws = inputs
    want = jax_mm_grads(jax_tool, mode, obs, ws)
    got = fr.mm_grads(to_torch(obs), *map(to_torch, ws), phased=mode == "phased")
    assert fr.mm_grads.launches == 0   # the plain path
    for name, g, w in zip(("dW1", "dW2", "dWp"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        rel, cos = rel_cos(g.numpy(), w)
        assert rel <= 2e-3 and cos >= 0.9999, (name, rel, cos)


def test_matmul_sequence_computes_the_same_products(inputs):
    """The timing yardstick (eight bf16 ``torch.matmul`` calls over all
    columns) computes what the plain version does, to bf16's precision."""
    obs, ws = inputs
    x = to_torch(obs)
    plain = fr.mm_grads_plain(x, *map(to_torch, ws))
    seq = fr.matmul_sequence(x.permute(1, 0, 2).reshape(F, -1),
                             *(to_torch(w).to(torch.bfloat16) for w in ws))
    for g, w in zip(seq, plain):
        rel, cos = rel_cos(g.float().numpy(), w.numpy())
        assert cos >= 0.999, cos


def test_wrapper_checks_inputs_before_any_launch(inputs):
    obs, ws = inputs
    x, w1, w2, wp = to_torch(obs), *map(to_torch, ws)
    with pytest.raises(ValueError, match="bf16"):
        fr.mm_grads(x.float(), w1, w2, wp)
    with pytest.raises(ValueError, match="chain"):
        fr.mm_grads(x, w1, w2.t()[:100], wp)
    with pytest.raises(ValueError, match="multiples of 16"):
        fr._launch(x, torch.zeros(F, 24), torch.zeros(24, H), wp, False)


def test_tool_runs_on_the_cpu_and_needs_a_card_by_default(monkeypatch, capsys):
    argv = ["--frames", "2", "--cols", "256", "--steps", "1", "--iters", "1"]
    assert fr.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CPU, host clock" in out and "mm-only phased" in out and "K1 bf16" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fr.main(argv)


# ------------------------------------------------- the split design's stages --
def small_inputs(t_mb, n, seed):
    rng = np.random.default_rng(seed)
    obs = torch.from_numpy(rng.random((t_mb, F, n), dtype=np.float32)).to(torch.bfloat16)
    ws = [torch.from_numpy(np.float32(s) * rng.standard_normal(shape, dtype=np.float32))
          for s, shape in ((0.3, (F, H)), (0.3, (H, H)), (0.05, (H, A)))]
    return obs, ws


@pytest.mark.parametrize("t_mb,n", [(2, 256), (3, 1000)], ids=["small", "ragged"])
def test_stages_compose_to_the_plain_version(t_mb, n):
    """Kernel A's plain version (mm_chain_plain) composed with kernel B's
    (mm_dw_plain) is mm_grads_plain, bit for bit."""
    obs, ws = small_inputs(t_mb, n, 1)
    chain = fr.mm_chain_plain(obs, *ws)
    assert [x.shape for x in chain] == [(F, t_mb, n), (H, t_mb, n), (H, t_mb, n), (A, t_mb, n),
                                        (H, t_mb, n), (H, t_mb, n)]
    assert all(x.dtype == torch.bfloat16 for x in chain)
    got = fr.mm_dw_plain(chain)
    want = fr.mm_grads_plain(obs, *ws)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_padded_columns_are_zero():
    """The workspace pads a frame's columns past N with x = 0; with no bias
    every operand kernel A writes there is zero, and the dW do not move."""
    obs, ws = small_inputs(2, 77, 2)
    padded = torch.zeros((2, F, 128), dtype=torch.bfloat16)
    padded[..., :77] = obs
    chain = fr.mm_chain_plain(padded, *ws)
    for x in chain:
        assert bool((x[..., 77:] == 0).all())
        assert bool((x[..., :77] != 0).any())
    got = fr.mm_dw_plain(chain)
    want = fr.mm_grads_plain(obs, *ws)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_plain_gives_both_variants_the_same_values(inputs):
    """The variant picks an order on the card only: on the CPU both are the
    plain version's values, bit for bit."""
    obs, ws = inputs
    x, w = to_torch(obs), [to_torch(v) for v in ws]
    fr.zero_counts()
    chain, phased = (fr.mm_grads(x, *w, phased=v) for v in (False, True))
    assert all(torch.equal(a, b) for a, b in zip(chain, phased))
    assert fr.mm_grads.launches == 0 and fr.mm_grads.launches_by_kernel == {"mm_chain": 0,
                                                                            "mm_dw": 0}


def test_stage_entries_run_their_plain_versions_on_the_cpu():
    obs, ws = small_inputs(2, 130, 3)
    chain = fr.mm_chain(obs, *ws, phased=True)
    want = fr.mm_chain_plain(obs, *ws)
    assert all(torch.equal(a, b) for a, b in zip(chain, want))
    assert all(torch.equal(a, b) for a, b in zip(fr.mm_dw(chain), fr.mm_dw_plain(want)))
    assert fr.mm_chain.launches == 0 and fr.mm_dw.launches == 0


def test_workspace_and_chunks():
    """2,208 bytes a column at hidden (256, 256); a chunk is whole frames
    where one fits in CHUNK_COLS, else part of one; hidden widths are padded
    to 256, the features to 48."""
    widths = fr._widths(F, H, H, A)
    assert widths == (48, 256, 256)
    assert fr.ws_rows(*widths)[-1] * 2 == 2208
    assert fr._chunk(32, 131072, 16384) == (1, 16384)
    assert fr._chunk(32, 1000, 16384) == (16, 1000)
    assert fr._chunk(3, 1000, 16384) == (3, 1000)
    assert fr._widths(20, 48, 112, A) == (48, 256, 256)
    w1, w2, wp = fr._padded(torch.ones(F, 48), torch.ones(48, 112), torch.ones(112, A), 48, 256, 256)
    assert w1.shape == (48, 256) and float(w1.float().sum()) == F * 48
    assert w2.shape == (256, 256) and wp.shape == (256, 32) and float(wp.float().sum()) == 112 * A
    with pytest.raises(ValueError, match="up to 48 features"):
        fr._widths(49, H, H, A)


def test_float64_reference_is_near_the_plain_version():
    obs, ws = small_inputs(2, 256, 4)
    exact = fr.mm_grads_float64(obs, *ws)
    plain = fr.mm_grads_plain(obs, *ws)
    assert 0.0 < fr.distance(plain, exact) <= 1e-4


def test_rounding_table_on_the_cpu_is_the_plain_versions():
    """On the CPU every rounding length runs the plain versions, so each row
    of the table is the plain row (-1): kernel B's distance on kernel A's
    operands and the call's, each from its float64 reference."""
    obs, ws = small_inputs(2, 200, 5)
    table = fr.rounding_table(obs, *ws)
    assert sorted(table) == [-1, 0, 1, 2, 4, 8, 16, 64, 256]
    assert all(v == table[-1] for v in table.values())
    b, call = table[-1]
    assert 0.0 < b <= 1e-5 and 0.0 < call <= 1e-4
    assert call == fr.distance(fr.mm_grads_plain(obs, *ws), fr.mm_grads_float64(obs, *ws))
