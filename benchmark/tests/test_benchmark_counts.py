"""The yardstick's arithmetic against hand-worked values, and K3's work
count against the port's own counting tool on a small rollout."""

import pytest
import torch

from benchmark import counts
from benchmark.reference.pika import env as ref_env


def test_rate_and_percentile():
    assert counts.rate(3.0e9, 1.5) == 2.0e9
    with pytest.raises(ValueError):
        counts.rate(1, 0.0)
    values = list(range(1, 101))  # 1..100
    # position 0.95 * 99 = 94.05 between 95 and 96
    assert counts.percentile(values, 95) == pytest.approx(95.05)
    assert counts.percentile([7.0], 95) == 7.0


def test_param_count_and_train_flops():
    # (35, 256, 256) body, an 18-logit policy head and a value head
    p = (35 * 256 + 256) + (256 * 256 + 256) + (256 * 18 + 18) + (256 + 1)
    assert p == 79891
    assert counts.param_count((256, 256)) == p
    B, T, E = 65536, 128, 4
    columns = T * 2 * B  # 16,777,216
    want = 2 * p * (columns + 2 * B) + 6 * p * E * columns
    assert counts.update_model_flops(B, T, E, (256, 256)) == want
    assert want == pytest.approx(3.4869e13, rel=1e-4)


def test_k1_call_bound():
    # 32 frames x 131,072 columns; forward 2 (35*256 + 256*256) + 2*256*19,
    # backward the body's dW, the head's dW and dh, and the hidden dh.
    cols = 32 * 131072
    body = 2 * (35 * 256 + 256 * 256)
    head = 2 * 256 * 19
    flops = cols * ((body + head) + (body + 2 * head + 2 * 256 * 256))
    seconds, by = counts.grad_bound_s(cols, (256, 256))
    assert by == "operations"
    assert seconds == pytest.approx(flops / 989e12)
    assert seconds * 1e3 == pytest.approx(1.943, abs=5e-4)


def test_bound_takes_the_larger():
    s, by = counts.bound_s(3.35e12, {"int32": 1.0})
    assert (s, by) == (pytest.approx(1.0), "bytes")
    s, by = counts.bound_s(0, {"int32": 132 * 64 * 1.98e9})
    assert (s, by) == (pytest.approx(1.0), "operations")
    assert counts.THREEFRY_OPS == 77 and counts.LANDING_ITERATION_OPS == 28


def _ai_state(batch, frames, seed=3):
    cfg = ref_env.EnvConfig(is_player1_computer=True, is_player2_computer=True)
    packed = ref_env.reset_packed(cfg, seed, seed + 1, batch, "cpu")
    return cfg, ref_env.rollout_packed(packed, cfg, frames)


def test_random_work_is_draws_alone():
    cfg = ref_env.EnvConfig()
    packed = ref_env.reset_packed(cfg, 5, 6, 64, "cpu")
    work = counts.K3Work(64, "cpu")
    out = work.run(packed, cfg, 10)
    assert work.landing_iterations == 0
    advance = int((ref_env.split(out)[3]["draw_counter"] - ref_env.split(packed)[3]["draw_counter"]).sum())
    assert work.draws == 2 * 64 * 10 + advance
    assert work.ops() == work.draws * 77
    seconds, by = counts.k3_call_bound_s(work, 64 * 4)
    assert seconds == pytest.approx(max(work.ops() * 4 / (132 * 64 * 1.98e9),
                                        2 * ref_env.NFIELDS * 256 * 4 / 3.35e12))


def test_k3_work_matches_the_ports_counting_tool():
    """The needed iterations are the port tool's: true-ball iterations of
    frames whose trajectory changed, and each asking seat's candidates up
    to its first accepted one."""
    from pikazoo_tpu_torch.envs import EnvConfig
    from pikazoo_tpu_torch.tools import k3_probe

    cfg, packed = _ai_state(64, 60)
    frames = 40
    work = counts.K3Work(64, "cpu")
    ours = work.run(packed.clone(), cfg, frames)
    theirs, lw = k3_probe.landing_work(packed.clone(), EnvConfig(
        is_player1_computer=True, is_player2_computer=True), frames)
    assert torch.equal(ours, theirs)
    true_needed = int(torch.where(lw.continues, 0, lw.true_iterations)[1:].sum())
    # frame 0 has no previous frame here: every iteration of it counts
    assert work.true_iterations == true_needed + int(lw.true_iterations[0].sum())
    assert work.candidate_iterations == int(lw.needed.sum())
    assert work.true_iterations > 0 and work.candidate_iterations > 0
