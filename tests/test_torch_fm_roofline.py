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
