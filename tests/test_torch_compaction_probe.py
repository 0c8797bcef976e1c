"""The compaction probe's flat landing sims (``pikazoo_tpu_torch.tools.
compaction_probe``) against the JAX probe's kernel body, bit for bit.

The JAX tool ``tools/compaction_probe.py`` rolls out states and runs its
variants when it is imported, so it is not imported here: its Pallas kernel
``flat_sims`` runs ``_sim_loop`` of ``pikazoo_tpu.core.predict`` over flat
lanes with a static rule, and that is what the plain version is held
against (jitted on the CPU); the composed lanes are held against
``landing_sims_batched`` in interpret mode.  The CUDA kernel runs only on a
card; ``chip_smoke.py`` holds it against this plain version there."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.core.predict import _sim_loop
from pikazoo_tpu.core.predict_pallas import landing_sims_batched as jax_landing_kernel
from pikazoo_tpu_torch.tools import compaction_probe as cp

NET_TRAP_CASES = np.array([
    [216, 180, 0, 1],    # pure net trap (fast exit)
    [216, 192, 0, 0],    # boundary of the strict < 192 band
    [200, 177, 3, 10],   # in-column moving
    [230, 190, -1, -5],
    [56, 0, 0, 1],       # fresh serve
    [432, 100, 20, -60],  # wall-hugging lob
], np.int32).T
LIVE_BATCH, LIVE_FRAMES = 256, 200

# The loop's unroll does not change its results (finished lanes are frozen);
# a short one compiles faster than the kernel's 32.
jax_sim_loop = jax.jit(functools.partial(_sim_loop, unroll=4), static_argnames=("full_rule",))


def random_lanes(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(20, 433, n), rng.integers(0, 253, n),
                     rng.integers(-20, 21, n), rng.integers(-60, 61, n)]).astype(np.int32)


def candidate_lanes_np(x, y, vx, vy):
    """The JAX tool's ``candidate_lanes`` (:77-86) in numpy: lane k of env b
    at k*B + b."""
    lane = np.arange(6, dtype=np.int32)[:, None]
    speed = ((lane < 3).astype(np.int32) + 1) * 10
    cvx = np.where(x[None, :] < 216, speed, -speed)
    cvy = np.abs(vy)[None, :] * ((lane % 3) - 1) * 2
    b = x.shape[0]
    return np.stack([np.broadcast_to(x, (6, b)).reshape(-1),
                     np.broadcast_to(y, (6, b)).reshape(-1),
                     cvx.reshape(-1), cvy.reshape(-1)]).astype(np.int32)


def eta_np(y_, vx_, vy_):
    """The JAX tool's ``eta_np`` (:220-224)."""
    disc = np.maximum(vy_.astype(np.float32) ** 2
                      + 2.0 * (253.0 - y_.astype(np.float32)), 0.0)
    k = -vy_.astype(np.float32) + np.sqrt(disc)
    return np.where(vx_ == 0, np.float32(-1.0), k)


@pytest.fixture(scope="module")
def live():
    """Ball states after 200 frames of AI self-play at B=256 (the port's env,
    held bit-exact to the JAX env by the env tests), as numpy (4, B)."""
    return np.stack([v.numpy() for v in cp.live_ball(LIVE_BATCH, LIVE_FRAMES, 0, "cpu")])


def lanes_of(case, live):
    if case == "random":
        return random_lanes(3000, 0)          # not a multiple of the 1024-lane block
    if case == "net_trap":
        return NET_TRAP_CASES
    if case == "live_true":
        return live
    return candidate_lanes_np(*live)          # "live_cand": the 6B candidate lanes


def torch_lanes(cols):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in cols)


@pytest.mark.parametrize("full_rule", [True, False], ids=["full_rule", "mistake_rule"])
@pytest.mark.parametrize("case", ["random", "net_trap", "live_true", "live_cand"])
def test_plain_flat_sims_matches_jax_sim_loop(case, full_rule, live):
    cols = lanes_of(case, live)
    want = np.asarray(jax_sim_loop(*map(jnp.asarray, cols), full_rule=full_rule))
    got = cp.flat_sims(*torch_lanes(cols), full_rule=full_rule)
    assert cp.flat_sims.launches == 0   # the plain path
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_candidate_lanes_match_the_jax_tools(live):
    got = cp.candidate_lanes(*torch_lanes(live))
    np.testing.assert_array_equal(np.stack([v.numpy() for v in got]), candidate_lanes_np(*live))


@pytest.mark.parametrize("case", ["random", "net_trap", "live_true"])
def test_sims_flat_natural_matches_jax_landing_kernel(case, live):
    cols = lanes_of(case, live)
    want_exp, want_cand = jax_landing_kernel(*map(jnp.asarray, cols), interpret=True)
    exp, cand = cp.sims_flat_natural(*torch_lanes(cols))
    assert cand.shape == (cols.shape[1], 6)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(want_exp))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))


def test_eta_sorted_results_are_the_permuted_natural_ones(live):
    """The ETA key and its stable order are the JAX tool's; the sorted
    lanes' results are the natural results permuted (both lane sets)."""
    exp, cand = cp.sims_flat_natural(*torch_lanes(live))
    for cols, rule, natural in ((live, True, exp),
                                (candidate_lanes_np(*live), False, cand.t().reshape(-1))):
        lanes = torch_lanes(cols)
        key = cp.eta(*lanes[1:])
        np.testing.assert_array_equal(key.numpy(), eta_np(*cols[1:]))
        perm = cp.eta_order(lanes)
        np.testing.assert_array_equal(perm.numpy(), np.argsort(eta_np(*cols[1:]), kind="stable"))
        assert not torch.equal(perm, torch.arange(len(perm)))
        got = cp.flat_sims(*cp.permuted(lanes, perm), rule)
        assert torch.equal(got, natural[perm])


def test_wrapper_rejects_bad_inputs():
    x, y, vx, vy = torch_lanes(random_lanes(8, 1))
    with pytest.raises(ValueError, match="int32"):
        cp.flat_sims(x.long(), y, vx, vy, True)
    with pytest.raises(ValueError, match="contiguous"):
        cp.flat_sims(torch.zeros(16, dtype=torch.int32)[::2], y, vx, vy, True)
    with pytest.raises(ValueError):
        cp.flat_sims(x[:4], y, vx, vy, True)
    with pytest.raises(ValueError, match="no version"):
        cp.flat_sims(*(t.to("meta") for t in (x, y, vx, vy)), True)


@pytest.mark.parametrize("stage", ["kern", "prim"])
def test_tool_runs_on_the_cpu_and_needs_a_card_by_default(stage, monkeypatch, capsys):
    argv = ["--stage", stage, "--batch", "64", "--roll-frames", "4", "--chain", "1",
            "--iters", "1"]
    assert cp.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CPU, host clock" in out
    assert ("ETA-sorted results match" in out) if stage == "kern" else ("take 1 field" in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cp.main(argv)
