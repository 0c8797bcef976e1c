"""The K3 probe's counts on the plain version (``tools/k3_probe.py``), on
the CPU: the hooks leave the rollout as it is, and what they count agrees
with the rollout itself.  The card half of the probe (builds, times, the
counting instance) runs only on a card; ``chip_smoke.py`` phase 8 uses the
same counts there."""

import pytest
import torch

from pikazoo_tpu_torch.core import fused_step
from pikazoo_tpu_torch.envs import PikaZoo
from pikazoo_tpu_torch.tools import k3_probe

B, WARM, FRAMES = 256, 150, 40
CFG = k3_probe.AI_CONFIG


@pytest.fixture(scope="module")
def live():
    """AI self-play, WARM plain frames from a reset: mid-rally."""
    state, _ = PikaZoo(CFG).reset_batch(4, B, device="cpu")
    return fused_step.rollout_packed_plain(fused_step.pack_state(state, 4), CFG, WARM)


@pytest.fixture(scope="module")
def work(live):
    return k3_probe.landing_work(live, CFG, FRAMES)


@pytest.fixture(scope="module")
def expected_x(live):
    """The expected landing x after each of FRAMES plain frames."""
    rows, packed = [], live
    for _ in range(FRAMES):
        packed = fused_step.rollout_packed_plain(packed, CFG, 1)
        rows.append(fused_step._split(packed)[2].expected_landing_point_x)
    return torch.stack(rows), packed


def test_landing_work_leaves_the_rollout_as_it_is(work, expected_x):
    assert torch.equal(work[0], expected_x[1])


def test_continuing_frames_keep_the_landing_x(work, expected_x):
    """A frame whose true ball continues the previous frame's trajectory
    lands where that one did."""
    continues = work[1].continues
    exp = expected_x[0]
    assert not bool(continues[0].any())  # no previous frame in the call
    assert int(continues.sum()) > B * FRAMES // 2
    assert not bool((continues[1:] & (exp[1:] != exp[:-1])).any())


def test_lazy_search_needs_at_most_the_pooled_candidates(work):
    w = work[1]
    assert bool((w.needed <= w.candidate_iterations[:, None]).all())
    assert bool((w.needed[~w.asks] == 0).all())
    assert bool((w.candidate_iterations[~w.asks.any(1)] == 0).all())
    assert 0 < int(w.needed.sum()) < int(w.candidate_iterations.sum())


def test_serial_steps_cover_each_warp(work):
    """The one-thread design's steps: at least the longest true ball of each
    warp, and at least its useful iterations over 32 lanes."""
    w = work[1]
    longest = w.true_iterations.reshape(FRAMES, -1, 32).amax(-1)
    useful = (w.true_iterations + w.needed.sum(1)).reshape(FRAMES, -1, 32).sum(-1)
    assert bool((w.serial_steps >= longest).all())
    assert bool((32 * w.serial_steps >= useful).all())
    assert 0 < k3_probe.serial_efficiency(w) <= 1


def test_lane_efficiency():
    assert k3_probe.lane_efficiency({"iterations": 64, "pool_steps": 4}) == 0.5


def test_cpu_main_prints_the_counts(capsys):
    assert k3_probe.main(["--device", "cpu", "--batch", "64", "--frames", "3"]) == 0
    assert "landing work [AI self-play, CPU] B=64 x 3 frames" in capsys.readouterr().out


def test_pool_report(work):
    counts = {"true_jobs": B * FRAMES, "candidate_jobs": 0, "jobs_run": B * FRAMES,
              "iterations": 3200, "pool_steps": 200, "misses": 0}
    line = k3_probe.pool_report(counts, work[1])
    assert line.startswith(str(counts)) and "lane efficiency 0.5000" in line
    assert "the warps' longest true balls alone" in line
