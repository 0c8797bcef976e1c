"""The feature-major prototype (``pikazoo_tpu_torch.tools.fm_kernel_probe``):
its plain version ``fm_grads`` against the JAX probe's ``fm_grads`` in
interpret mode, and its ``ref_loss`` against autograd.

The JAX tool checks and benchmarks when it is imported, so it is loaded from
its file with both off, at T=8 frames and N=1024 columns (its grid needs
T % 8 == 0 and N % 512 == 0).  The CUDA kernel runs only on a card;
``chip_smoke.py`` holds it against this plain version there, at full width
and ragged."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pikazoo_tpu_torch.tools import fm_kernel_probe as fk
from pikazoo_tpu_torch.train.networks import BF16
from torch_helpers import to_torch

ROOT = Path(__file__).resolve().parents[1]
T_MB, B2 = 8, 1024
F, H, A = 35, 256, 18
LABELS = fk.LABELS
GRAD_REL, GRAD_COS = 2e-3, 0.9999   # K1's JAX bounds (tests/test_torch_fused_update.py)
# The leaves that the value head's gradient reaches.  They take no bf16
# rounding that K1's JAX bound is sized for (dvalue stays f32), and the plain
# version sits within ~7e-6 of JAX there (seeds 0-2); rounding dvalue to bf16,
# as K1 does, puts them 6e-5 to 1.2e-4 away, inside K1's bound.  This bound
# tells the two functions apart.
VALUE_PATH = ("dW1", "db1", "dW2", "db2", "dWv", "dbv")
VALUE_PATH_REL = 2e-5


@pytest.fixture(scope="module")
def jax_tool():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(PPO_2B=B2, PPO_T_MB=T_MB, FM_CHECK=0, FM_BENCH=0).items():
            mp.setenv(k, str(v))
        spec = importlib.util.spec_from_file_location("jax_fm_kernel_probe",
                                                      ROOT / "tools" / "fm_kernel_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def make_inputs(t_mb, n, seed=0):
    """numpy: the JAX probe's weight scales with small random biases, uniform
    bf16 observations and actions, logp_old about the uniform policy's so
    that both clip branches fire, normalised advantages."""
    rng = np.random.default_rng(seed)
    normal = lambda s, *shape: np.float32(s) * rng.standard_normal(shape, dtype=np.float32)
    params = (normal(0.3, F, H), normal(0.1, H), normal(0.3, H, H), normal(0.1, H),
              normal(0.05, H, A), normal(0.1, A), normal(0.5, H, 1), normal(0.1, 1))
    obs = jnp.asarray(rng.random((t_mb, F, n), dtype=np.float32)).astype(jnp.bfloat16)
    action = rng.integers(0, A, (t_mb, n)).astype(np.int32)
    lpold = (-np.log(np.float32(A)) + normal(0.1, t_mb, n)).astype(np.float32)
    vold = normal(1.0, t_mb, n)
    adv = normal(1.0, t_mb, n)
    adv = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    tgt = normal(1.0, t_mb, n)
    return params, (obs, action, lpold, vold, adv, tgt)


def port(params, leaves):
    return [to_torch(p) for p in params], [to_torch(x) for x in leaves]


def call(fn, params, leaves):
    p, args = port(params, leaves)
    return fn(p, *args)


def rel_cos(g, w):
    g, w = np.asarray(g, np.float64).ravel(), np.asarray(w, np.float64).ravel()
    rel = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
    return rel, g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30)


@pytest.fixture(scope="module")
def case(jax_tool):
    params, leaves = make_inputs(T_MB, B2)
    want = jax_tool.fm_grads(tuple(map(jnp.asarray, params)), *map(jnp.asarray, leaves))
    return params, leaves, [np.asarray(w) for w in want]


def test_plain_matches_jax_interpret(case):
    params, leaves, want = case
    got = call(fk.fm_grads, params, leaves)
    assert fk.fm_grads.launches == 0   # the plain path
    assert len(got) == len(want) == 9
    np.testing.assert_allclose(got[8].numpy(), want[8], rtol=1e-4, atol=1e-5)
    for label, g, w in zip(LABELS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, label
        rel, cos = rel_cos(g.numpy(), w)
        assert rel <= GRAD_REL and cos >= GRAD_COS, (label, rel, cos)
        if label in VALUE_PATH:
            assert rel <= VALUE_PATH_REL, (label, rel)


def test_bf16_dvalue_is_further_from_jax_than_the_bound(case, monkeypatch):
    """K1 rounds dvalue to bf16; the prototype keeps it in f32.  A plain
    version that rounds it passes K1's bound, so that bound cannot tell the
    two functions apart, and lies outside VALUE_PATH_REL, which can."""
    params, leaves, want = case
    loss_and_dheads = fk._loss_and_dheads

    def rounded(*args, **kw):
        sums, dlogits, dvalue = loss_and_dheads(*args, **kw)
        return sums, dlogits, dvalue.to(BF16).float()

    monkeypatch.setattr(fk, "_loss_and_dheads", rounded)
    got = call(fk.fm_grads_plain, params, leaves)
    rel = {label: rel_cos(g.numpy(), w)[0] for label, g, w in zip(LABELS, got, want)}
    assert max(rel.values()) <= GRAD_REL, rel
    assert max(rel[k] for k in VALUE_PATH) > VALUE_PATH_REL, rel


def test_ref_loss_matches_jax(case, jax_tool):
    params, leaves, _ = case
    want = float(jax_tool.ref_loss(tuple(map(jnp.asarray, params)), *map(jnp.asarray, leaves)))
    got = float(call(fk.ref_loss, params, leaves))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("t_mb,n", [(2, 256), (3, 1000)], ids=["small", "ragged"])
def test_plain_passes_the_tools_check_against_autograd(t_mb, n, capsys):
    """The tool's check (the JAX probe's FM_CHECK gate) at a small and a
    ragged size: the hand-written backward against autograd of ref_loss."""
    params, leaves = make_inputs(t_mb, n, seed=1)
    assert call(fk.check, params, leaves)
    assert "grads OK" in capsys.readouterr().out


def test_wrapper_checks_inputs(case):
    params, leaves, _ = case
    p, (obs, action, *scalars) = port(params, leaves)
    with pytest.raises(ValueError, match="bf16"):
        fk.fm_grads(p, obs.float(), action, *scalars)
    with pytest.raises(ValueError, match="per-column"):
        fk.fm_grads(p, obs, action[:, :10], *scalars)
    with pytest.raises(TypeError, match="float32"):
        fk.fm_grads(p, obs, action, scalars[0].double(), *scalars[1:])
    with pytest.raises(ValueError, match="chain"):
        fk.fm_grads([p[0][:, :100], *p[1:]], obs, action, *scalars)


def test_tool_runs_on_the_cpu_and_needs_a_card_by_default(monkeypatch, capsys):
    argv = ["--frames", "2", "--cols", "128", "--steps", "1", "--iters", "1"]
    assert fk.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CPU, host clock" in out and "grads OK" in out and "grad+adam" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fk.main(argv)


# ------------------------------------------------- the split design's stages --
@pytest.mark.parametrize("t_mb,n", [(2, 256), (3, 1000)], ids=["small", "ragged"])
def test_stages_compose_to_the_plain_version(t_mb, n):
    """Kernel A's plain version (p3_chain_plain) composed with kernel B's
    (K1's k1_dw_plain) is fm_grads_plain, bit for bit: the card's two
    kernels compute the function, split where they split it."""
    params, leaves = make_inputs(t_mb, n, seed=2)
    p, args = port(params, leaves)
    chain = fk.p3_chain_plain(p, *args)
    assert chain.dheads.shape == (A, t_mb, n) and chain.dheads.dtype == BF16
    assert [h.shape[0] for h in (*chain.hs, *chain.dpres)] == [H] * 4
    got = fk.compose(chain, *fk.k1_dw_plain(chain, args[0]))
    want = fk.fm_grads_plain(p, *args)
    for label, g, w in zip((*LABELS, "loss"), got, want):
        assert torch.equal(g, w), label


def test_stage_entries_run_their_plain_versions_on_the_cpu():
    params, leaves = make_inputs(2, 128, seed=4)
    p, args = port(params, leaves)
    fk.zero_counts()
    chain = fk.p3_chain(p, *args)
    want = fk.p3_chain_plain(p, *args)
    for g, w in zip((*chain.hs, chain.dheads, *chain.dpres, *chain.db, chain.dwv, chain.sums),
                    (*want.hs, want.dheads, *want.dpres, *want.db, want.dwv, want.sums)):
        assert torch.equal(g, w)
    dw, dwp = fk.p3_dw(p, chain, args[0])
    ref, refp = fk.k1_dw_plain(want, args[0])
    assert all(torch.equal(a, b) for a, b in zip((*dw, dwp), (*ref, refp)))
    assert (fk.p3_chain.launches, fk.p3_dw.launches, fk.fm_grads.launches) == (0, 0, 0)
    assert fk.fm_grads.launches_by_kernel == {"p3_chain": 0, "p3_dw": 0}


def test_columns_past_n_contribute_nothing():
    """The workspace pads a ragged frame's columns with dheads = dpre = 0 (h =
    tanh(b) there is not zero): kernel B's dW are bit for bit those of zero
    padding, and those of no padding up to the f32 sums' order."""
    params, leaves = make_inputs(2, 77, seed=5)
    p, args = port(params, leaves)
    chain = fk.p3_chain_plain(p, *args)
    obs = args[0]
    gen = torch.Generator().manual_seed(6)

    def pad(x, fill):
        out = (torch.rand((*x.shape[:-1], 128), generator=gen) + 0.5 if fill
               else torch.zeros((*x.shape[:-1], 128))).to(x.dtype)
        out[..., :77] = x
        return out

    padded = chain._replace(hs=[pad(h, True) for h in chain.hs], dheads=pad(chain.dheads, False),
                            dpres=[pad(d, False) for d in chain.dpres])
    zeros = padded._replace(hs=[h.clone() for h in padded.hs])
    for h in zeros.hs:
        h[..., 77:] = 0
    obs_p = pad(obs, True)
    obs_z = obs_p.clone()
    obs_z[..., 77:] = 0
    got = fk.k1_dw_plain(padded, obs_p)
    want = fk.k1_dw_plain(zeros, obs_z)
    assert all(torch.equal(a, b) for a, b in zip((*got[0], got[1]), (*want[0], want[1])))
    ref = fk.k1_dw_plain(chain, obs)
    for a, b in zip((*got[0], got[1]), (*ref[0], ref[1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_chain_keeps_dvalue_in_f32(case, monkeypatch):
    """Kernel A's plain version keeps dvalue in f32: composed with kernel B's,
    it sits within VALUE_PATH_REL of JAX on the leaves the value head
    reaches; rounding dvalue to bf16, as K1 does, puts it outside."""
    params, leaves, want = case
    p, args = port(params, leaves)

    def value_path(chain):
        got = fk.compose(chain, *fk.k1_dw_plain(chain, args[0]))
        return {label: rel_cos(g.numpy(), w)[0] for label, g, w in zip(LABELS, got, want)
                if label in VALUE_PATH}

    rel = value_path(fk.p3_chain_plain(p, *args))
    assert max(rel.values()) <= VALUE_PATH_REL, rel
    loss_and_dheads = fk._loss_and_dheads

    def rounded(*a, **kw):
        sums, dlogits, dvalue = loss_and_dheads(*a, **kw)
        return sums, dlogits, dvalue.to(BF16).float()

    monkeypatch.setattr(fk, "_loss_and_dheads", rounded)
    rel = value_path(fk.p3_chain_plain(p, *args))
    assert max(rel.values()) > VALUE_PATH_REL, rel


def test_float64_reference_is_near_the_plain_version():
    """The float64 reference phase 15 measures the kernel against: the plain
    version with float64 products, within bf16's reach of it."""
    params, leaves = make_inputs(2, 256, seed=7)
    p, args = port(params, leaves)
    exact = fk.fm_grads_float64(p, *args)
    plain = fk.fm_grads_plain(p, *args)
    for label, g, w in zip(LABELS, plain, exact):
        rel, cos = rel_cos(g.numpy(), w.numpy())
        assert rel <= 1e-4 and cos >= 0.99999999, (label, rel)
