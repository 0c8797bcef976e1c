#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``pikazoo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, ``nvcc``
and ``nvidia-smi``.  It builds every kernel of the port from the sources in
the checkout, holds each against its plain PyTorch version on the card,
drives the port's env paths with rule-AI and random-action seats (the eager
``PikaZoo.reset_batch`` / ``step_batch``, and ``fused_rollout``, many frames
per launch: K3 held against its plain version from fresh resets and from a
live mid-rally state, its landing pool's lane efficiency and its ``-Xptxas
-v`` figures printed), compares a card trajectory with a CPU trajectory leaf
by leaf, and trains: the self-play PPO learner through ``make_ppo_trainer`` at full
width, its minibatch gradients in the fused kernel K1 (bf16), then in the
row-major kernel K4 and in K1's int8, int8fwd, bf16-backward and
int8fwd+bf16-backward modes, each of those held against its plain version
first; then runs the three probe tools (the flat landing sims of the
compaction probe, the products-only floor of K1, the feature-major
prototype), each kernel held against its plain version and each tool driven
through its ``main``; then the trainer's user surface: the training CLI
through the wrappers at full width, run once uninterrupted and once resumed
from its checkpoint by a second call, the two bit-equal; the committed
vs-AI policy against the rule AI at the JAX gate's settings; the golden
trajectory replayed on the card; the PettingZoo drop-in (``pikazoo_v0.env``)
at batch 1 on the card, the CPU and the native host engine, equal step by
step and frame by frame, and the oracle draw mode card vs CPU; the landing
kernel's leap, hybrid and mixed modes with the ydir split, each bit-equal to
its plain version and to the frame loop, timed beside it; and the meshed
trainer: a one-rank nccl mesh bit-equal to the unmeshed trainer, two ranks
sharing the card over gloo against one rank, and the CLI's --distributed; and
the learner's env step as one kernel (``csrc/learner_step.cu``), bit-equal to
its plain version over 300 frames of each seat mix, timed beside its bound.
Every phase prints at least one line; any failure raises and the script exits non-zero.  The line
before the last lists every kernel with its launches on the main path, its
error against its plain version, its time, its plain version's time and its
bound (by the benchmark's yardstick, ``benchmark/counts.py``); the last line
is a JSON object naming the device.  Without a CUDA device it exits with
status 1 before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from benchmark import counts
from benchmark.counts import (HBM_BYTES_PER_S, LANDING_ITERATION_OPS, PEAK_OPS_PER_S,
                              THREEFRY_OPS)
from pikazoo_tpu_torch import EnvConfig, PikaZoo, _build, fused_rollout, pikazoo_v0
from pikazoo_tpu_torch.core import fused_step, predict, predict_cuda
from pikazoo_tpu_torch.core import learner_step as learner_step_module
from pikazoo_tpu_torch.core.learner_step import learner_step
from pikazoo_tpu_torch.core.predict import landing_sims_any
from pikazoo_tpu_torch.envs import OBS_HIGH, OBS_LOW
from pikazoo_tpu_torch.envs.pika_volley import EnvState, batch_keys
from pikazoo_tpu_torch.policies import load_policy, policy_path
from pikazoo_tpu_torch.tools import (compaction_probe, fm_kernel_probe, fm_roofline,
                                     k2_leap_probe, k3_probe)
from pikazoo_tpu_torch.tools._timing import HOLD_CYCLES, card_line
from pikazoo_tpu_torch.tools.k1_precision_probe import (HIDDEN, K1_FULL, K1_KW, float64_plain,
                                                        k1_inputs)
from pikazoo_tpu_torch.tools.k2_leap_probe import AI_BATCH, HARVEST_FRAME, harvest_ball_states
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer, ppo
from pikazoo_tpu_torch.train import checkpoint, fused_update
from pikazoo_tpu_torch.train import run as train_run
from pikazoo_tpu_torch.train.evaluate import evaluate_vs_computer
from pikazoo_tpu_torch.train.fused_update import fused_ppo_grads, fused_ppo_grads_fm
from pikazoo_tpu_torch.train.networks import apply_fm, dense_layers

AI_FRAMES = 500  # rule-AI self-play (both seats), B=AI_BATCH
RANDOM_BATCH, RANDOM_FRAMES = 262144, 200  # random-action self-play
PARITY_BATCH, PARITY_FRAMES = 4096, 300    # card vs CPU, leaf by leaf
# The fused path: calls of FUSED_FRAMES frames each.
FUSED_FRAMES = 100
FUSED_AI_CALLS = 5        # B=AI_BATCH x 500 frames
FUSED_RANDOM_CALLS = 2    # B=RANDOM_BATCH x 200 frames
MODE_BATCH, MODE_FRAMES = 4096, 200
AI_CONFIG = EnvConfig(auto_reset=True, is_player1_computer=True,
                      is_player2_computer=True)
# Observation dim 33, the ball's y velocity, can pass its declared OBS_HIGH
# (124): a smash doubles |y_velocity|, so a ball smashed again on its way
# down exceeds it, in the JAX package as in the port
# (tests/test_torch_core.py::test_chained_smash_passes_declared_obs_high).
LOOSE_OBS_HIGH = 33

# The net-trap and edge states of tests/test_predict_pallas.py: pure net trap
# (fast exit), the strict < 192 band edge, in-column moving, fresh serve and
# a wall-hugging lob.
NET_TRAP_CASES = np.array([
    [216, 180, 0, 1],
    [216, 192, 0, 0],
    [200, 177, 3, 10],
    [230, 190, -1, -5],
    [56, 0, 0, 1],
    [432, 100, 20, -60],
], np.int32)


def leaves(tree):
    """The tensors of a (nested) NamedTuple, in field order."""
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for sub in tree for leaf in leaves(sub)]


def bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the benchmark's ``bound_s`` in milliseconds."""
    seconds, by = counts.bound_s(nbytes, ops)
    return seconds * 1e3, by


def count_landing_iterations(fn):
    """Run ``fn()`` with the plain landing loop counting, for each of its 7
    lanes, the iterations in which the lane was live: the work these inputs
    need, since each lane's loop ends at its landing.  Returns (fn's result,
    counts (7,) int64)."""
    orig = predict._one_iteration
    total = [0]

    def counting(x, y, vx, vy, count, full_rule):
        total[0] = total[0] + (vx != 0).reshape(vx.shape[0], -1).sum(dim=1)
        return orig(x, y, vx, vy, count, full_rule)

    predict._one_iteration = counting
    try:
        out = fn()
    finally:
        predict._one_iteration = orig
    return out, total[0]


def cuda_ms(fn, reps: int, hold: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events.  With
    ``hold`` the stream is held first while the host queues the calls, so a
    kernel shorter than its launch's host work is timed alone (the probe
    tools' clock, ``pikazoo_tpu_torch/tools/_timing.py``)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_ball_states(n: int, seed: int, device):
    """The ranges of tests/test_predict_pallas.py::random_ball_states."""
    rng = np.random.default_rng(seed)
    cols = (rng.integers(20, 433, n), rng.integers(0, 253, n),
            rng.integers(-20, 21, n), rng.integers(-60, 61, n))
    return tuple(torch.tensor(c, dtype=torch.int32, device=device) for c in cols)


def compare_landing(name: str, balls) -> int:
    """Kernel vs plain on the same CUDA tensors; raises unless bit-equal.
    Returns the largest absolute difference (0)."""
    exp_k, cand_k = predict_cuda.landing_sims_batched(*balls)
    exp_p, cand_p = landing_sims_any(*balls)
    cand_p = cand_p.t()
    torch.cuda.synchronize()
    err = max(int((exp_k - exp_p).abs().max()), int((cand_k - cand_p).abs().max()))
    if err or not (torch.equal(exp_k, exp_p) and torch.equal(cand_k, cand_p)):
        raise AssertionError(f"landing kernel != plain on {name}: max |diff| {err}")
    print(f"phase 3 kernel vs plain [{name}]: B={balls[0].numel()} bit-equal "
          "(expected and 6 candidates)")
    return err


def rollout_checks(env: PikaZoo, batch: int, frames: int, actions_fn, card: str,
                   label: str):
    """Drive the main path; return (env-steps/s, landing kernel launches).
    Raises unless rewards are zero-sum, some env scored, and every
    observation dimension stayed in [OBS_LOW, OBS_HIGH], save the ball's y
    velocity above its declared high (see LOOSE_OBS_HIGH)."""
    device = torch.device("cuda")
    low = torch.tensor(OBS_LOW, device=device)
    high = torch.tensor(OBS_HIGH, device=device)
    state, _ = env.reset_batch(0, batch, device=device)
    bad_sum = torch.zeros((), dtype=torch.bool, device=device)
    seen_min, seen_max = low.clone(), high.clone()
    rounds = torch.zeros((), dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for t in range(frames):
        state, ts = env.step_batch(state, actions_fn(t))
        bad_sum |= (ts.rewards.sum(-1) != 0).any()
        seen_min = torch.minimum(seen_min, ts.obs.amin(dim=(0, 1)))
        seen_max = torch.maximum(seen_max, ts.obs.amax(dim=(0, 1)))
        rounds += ts.round_ended.sum()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = predict_cuda.landing_sims_batched.launches
    if fused_rollout.launches:
        raise AssertionError(f"{label}: the eager step launched the fused kernel")
    if bool(bad_sum):
        raise AssertionError(f"{label}: rewards are not zero-sum")
    below = (seen_min < low).nonzero().flatten().tolist()
    above = (seen_max > high).nonzero().flatten().tolist()
    if below or set(above) - {LOOSE_OBS_HIGH}:
        raise AssertionError(
            f"{label}: observations left [OBS_LOW, OBS_HIGH]: dims {below} "
            f"below (min {seen_min[below].tolist()}), dims {above} above "
            f"(max {seen_max[above].tolist()})")
    scored = int((state.scores.sum(-1) > 0).sum())
    if scored == 0 or int(rounds) == 0:
        raise AssertionError(f"{label}: no env scored in {frames} frames")
    rate = batch * frames / seconds
    print(f"{label}: B={batch} x {frames} frames in {seconds:.3f} s = "
          f"{rate:.0f} env-steps/s (checks included), {int(rounds)} round ends, "
          f"{scored} envs with points at the end, landing launches {launches}, "
          f"obs in bounds (ball y velocity max {int(seen_max[LOOSE_OBS_HIGH])}, "
          f"declared high {int(high[LOOSE_OBS_HIGH])}) [{card}]")
    return rate, launches


def zero_counts():
    predict_cuda.zero_counts()
    fused_rollout.launches = 0
    learner_step.launches = 0
    fused_update.zero_fm_counts()
    fused_ppo_grads.launches = 0
    compaction_probe.flat_sims.launches = 0
    fm_roofline.zero_counts()
    fm_kernel_probe.zero_counts()


# The sources whose kernels' registers, stack and spills phase 2 prints
# (fused_update_bf16.cu: every chain_kernel instance beside K1 bf16's wgmma
# kernel A).
PTXAS_SOURCES = ("landing.cu", "learner_step.cu", "fm_roofline.cu", "fm_kernel_probe.cu",
                 "fused_update_bf16.cu")


def build_all(card: str):
    """Build every library at once, one nvcc each; print each one's time."""
    def timed_build(build):
        t0 = time.perf_counter()
        lib = build()
        return lib._name, time.perf_counter() - t0

    libraries = (predict_cuda._library, fused_step._library, learner_step_module._library,
                 fused_update._library_bf16, fused_update._library_int8, fused_update._library_k4,
                 compaction_probe._library, fm_roofline._library, fm_kernel_probe._library)
    with ThreadPoolExecutor(max_workers=len(libraries) + 1) as pool:
        builds = [pool.submit(timed_build, b) for b in libraries]
        usage = pool.submit(k3_probe.instance_lines, _build.CSRC_DIR / "fused_step.cu")
        notes = {src: [] for src in PTXAS_SOURCES}
        probes = {src: pool.submit(_build.resource_usage, _build.CSRC_DIR / src, notes[src])
                  for src in PTXAS_SOURCES}
        for future in builds:
            name, seconds = future.result()
            print(f"phase 2 build: {seconds:.2f} s -> {name} [{card}]")
        for line in usage.result():
            print(f"phase 2 ptxas fused_step.cu: {line}")
        for src, future in probes.items():
            for entry, regs, stack, stores, loads in future.result():
                print(f"phase 2 ptxas {src}: {entry}: {regs} registers, {stack} B stack, spill "
                      f"stores {stores} B, spill loads {loads} B")
            # P2's and K1 bf16's wgmma kernels A issue each group's wgmma
            # back to back only if ptxas does not serialize them, as it does
            # when a loop count is not a constant or a wgmma sits under a
            # condition (its performance warnings C7514, C7518, C7520;
            # PERF.md §6).
            if any("wgmma" in n for n in notes[src]):
                raise AssertionError(f"phase 2: ptxas serializes wgmma in {src}: {notes[src]}")


def rows_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest absolute difference of two packed states; 0 when bit-equal."""
    return int((got.long() - want.long()).abs().max())


def compare_fused(label: str, cfg: EnvConfig, batch: int, frames: int,
                  seed: int):
    """Kernel vs plain version from a fresh reset on the card: all NFIELDS
    rows bit-equal.  Returns (max |diff| (0), packed start, kernel result)."""
    state, _ = PikaZoo(cfg).reset_batch(seed, batch, device="cuda")
    packed = fused_step.pack_state(state, seed + 1)
    got = fused_step.rollout_packed(packed.clone(), cfg, frames)
    want = fused_step.rollout_packed_plain(packed, cfg, frames)
    torch.cuda.synchronize()
    err = rows_differ(got, want)
    if err:
        rows = (got != want).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"fused kernel != plain [{label}]: rows {rows}, "
                             f"max |diff| {err}")
    after = fused_step.unpack_state(got)
    points = int(after.scores.sum())
    print(f"phase 7 kernel vs plain [{label}]: B={batch} x {frames} frames, "
          f"all {fused_step.NFIELDS} rows bit-equal, {points} points scored, "
          f"{int(after.game_ended.sum())} envs at game end")
    return err, packed, got


def fused_path(label: str, cfg: EnvConfig, batch: int, calls: int,
               card: str) -> EnvState:
    """Drive ``fused_rollout`` ``calls`` times from a reset; check the proof
    of work (every env's step_count advanced by exactly the frames run) and
    that envs scored.  Returns the final state."""
    state, _ = PikaZoo(cfg).reset_batch(0, batch, device="cuda")
    base = state.step_count.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        state = fused_rollout(state, 1, cfg, FUSED_FRAMES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    frames = calls * FUSED_FRAMES
    advanced = state.step_count - base
    if not bool((advanced == frames).all()):
        raise AssertionError(f"{label}: step_count advanced by "
                             f"{advanced.min()}..{advanced.max()}, not {frames}")
    scores = state.scores
    if int(scores.min()) < 0 or int(scores.max()) > cfg.winning_score:
        raise AssertionError(f"{label}: scores outside [0, {cfg.winning_score}]")
    scored = int((scores.sum(-1) > 0).sum())
    if scored == 0:
        raise AssertionError(f"{label}: no env scored in {frames} frames")
    print(f"phase 8 {label}: B={batch} x {frames} frames in {calls} calls, "
          f"{seconds:.4f} s = {batch * frames / seconds:.0f} env-steps/s, every "
          f"step_count advanced by {frames}, {scored} envs with points [{card}]")
    return state


def time_fused(label: str, cfg: EnvConfig, state: EnvState, card: str):
    """K3 from a live state (``state`` continued with phase 8's action key).
    With a computer seat, first the hold: one FUSED_FRAMES-frame call of the
    kernel and one of its counting instance against the plain version, all
    NFIELDS rows bit-equal, and the landing pool's lane efficiency beside
    the one-thread design's, estimated from the plain version's counts.
    Then CUDA-event ms of one call, kernel and plain, interleaved plain,
    kernel, kernel, plain (the kernel in place on its own buffer, so its
    calls continue one another), and the bound: the packed state read and
    written once, the landing iterations this call needs (the true ball's,
    and for each seat that asks the candidates in its coin's order up to
    and including the first accepted, all 6 if none is; counted on the
    plain version) and the threefry draws (2 action draws an env-frame and
    the site draws, the draw counters' advance).  The physics' own
    operations are not counted.  Returns (kernel ms, plain ms, bound, max
    |diff| of the hold)."""
    live = fused_step.pack_state(state, 1)
    batch = live.shape[1]
    after = fused_step.rollout_packed(live.clone(), cfg, FUSED_FRAMES)
    err, iterations = 0, 0
    if cfg.is_player1_computer or cfg.is_player2_computer:
        counted = live.clone()
        counts = fused_step.rollout_packed_counted(counted, cfg, FUSED_FRAMES)
        want, work = k3_probe.landing_work(live, cfg, FUSED_FRAMES)
        for name, got in (("kernel", after), ("counting instance", counted)):
            err = max(err, rows_differ(got, want))
            if err:
                rows = (got != want).any(dim=1).nonzero().flatten().tolist()
                raise AssertionError(f"fused {name} != plain from the live state [{label}]: "
                                     f"rows {rows}, max |diff| {err}")
        asks = work.asks.any(1)
        print(f"phase 8 hold [{label}] from the live state: B={batch} x {FUSED_FRAMES} "
              f"frames, kernel and counting instance == plain on all {fused_step.NFIELDS} "
              f"rows; {int(asks.sum())} env-frames ask for candidates, at most "
              f"{int(asks.reshape(FUSED_FRAMES, -1, 32).sum(-1).max())} of a warp's 32")
        iterations = int(work.true_iterations.sum()) + int(work.needed.sum())
        print(f"phase 8 pool [{label}]: {k3_probe.pool_report(counts, work)} [{card}]")
    buf = live.clone()
    kernel = lambda: fused_step.rollout_packed(buf, cfg, FUSED_FRAMES)
    plain = lambda: fused_step.rollout_packed_plain(live, cfg, FUSED_FRAMES)
    p1, k1, k2, p2 = (cuda_ms(plain, 1), cuda_ms(kernel, 5),
                      cuda_ms(kernel, 5), cuda_ms(plain, 1))
    draw_counter = lambda packed: fused_step._split(packed)[3]["draw_counter"].long()
    draws = 2 * batch * FUSED_FRAMES + int((draw_counter(after) - draw_counter(live)).sum())
    bound_ms, bound_by = bound(2 * live.numel() * 4,
                               {"int32": iterations * LANDING_ITERATION_OPS +
                                draws * THREEFRY_OPS})
    print(f"phase 8 time [{label}] B={batch} x {FUSED_FRAMES} frames: kernel "
          f"{k1:.4f} / {k2:.4f} ms ({batch * FUSED_FRAMES / min(k1, k2) * 1e3:.0f} "
          f"env-steps/s), plain {p1:.1f} / {p2:.1f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({iterations} landing iterations x {LANDING_ITERATION_OPS} and "
          f"{draws} threefry draws x {THREEFRY_OPS} int32 operations, "
          f"{2 * live.numel() * 4} bytes; the physics' own operations not counted) "
          f"[{card}]")
    return min(k1, k2), min(p1, p2), (bound_ms, bound_by), err


def compare_devices(cfg: EnvConfig, label: str, seed: int):
    """The same actions on the card (kernel) and on the CPU (plain version):
    every EnvState leaf and TimeStep field equal on every frame."""
    env = PikaZoo(cfg)
    actions = np.random.default_rng(seed).integers(
        0, 18, (PARITY_FRAMES, PARITY_BATCH, 2)).astype(np.int32)
    on_card = env.reset_batch(seed, PARITY_BATCH, device="cuda")
    on_cpu = env.reset_batch(seed, PARITY_BATCH, device="cpu")
    launches = predict_cuda.landing_sims_batched.launches
    for t in range(-1, PARITY_FRAMES):
        if t >= 0:
            a = torch.from_numpy(actions[t])
            on_card = env.step_batch(on_card[0], a.cuda())
            on_cpu = env.step_batch(on_cpu[0], a)
        for i, (g, c) in enumerate(zip(leaves(on_card), leaves(on_cpu))):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"{label}: card != CPU at frame {t}, leaf {i}")
    launched = predict_cuda.landing_sims_batched.launches - launches
    if launched != PARITY_FRAMES:
        raise AssertionError(f"{label}: {launched} kernel launches for "
                             f"{PARITY_FRAMES} frames")
    print(f"phase 6 card vs CPU [{label}]: B={PARITY_BATCH} x {PARITY_FRAMES} frames, "
          "every EnvState leaf and TimeStep field equal on every frame")

# K1, K4 and the learner (phases 9-12).
# (losses rtol, grad leaf relative L2, grad leaf cos).  Kernel vs plain differ
# in summation order and so in rare bf16 roundings.  Every mode and K4 are
# held to it.
LOSS_ATOL = 1e-6
BF16_TOL = (1e-4, 1e-3, 0.99999)
# K1 bf16's kernel B against its plain version on the same bf16 operands:
# only the order of the f32 sums of exact products differs.
K1_DW_REL = 1e-5
# K1 bf16 at full width may sit at most this many times as far from a
# float64 plain version as the plain version does.
K1_F64_RATIO = 2.0
# P2's call from float64 against its plain version's: kernel A sums each
# product's K on the tensor cores, toward zero, before its bf16 round, and
# kernel B sums fm_roofline.RLEN slices so: 3.0x at RLEN 1 on an H100 (PERF.md
# §6), past K1_F64_RATIO.  Held here so that it does not drift further.
P2_F64_RATIO = 3.5
# K1 int8's kernels A and S against their plain version: an integer operand
# (x_q, h_q, dp_q) may differ by one step only where its f32 value lies on a
# rounding boundary that the two sides' last bits put on opposite sides (a
# tanh, an f32 sum's order, a cell maximum that moved with them); at most
# this share of the entries.
INT8_STEP_SHARE = 1e-3
INT8_HOLD_FRAMES = 8  # frames of the full-width minibatch that the stage holds take
OPERAND_COLS = 131072  # columns of an operand a float64 distance sums at once
LEARNER = PPOConfig(num_envs=65536, rollout_length=128, num_minibatches=4,
                    update_epochs=4, hidden=HIDDEN)
LEARNER_UPDATES = 3
K4_UPDATES = 2
# The artifacts/vs_ai_policy recipe (tests/test_trained_artifact.py:23-26).
VS_AI = PPOConfig(num_envs=8192, rollout_length=128, num_minibatches=8,
                  update_epochs=4, hidden=HIDDEN, entropy_coef=0.01,
                  learner_seats="p1", learning_rate=5e-4)
# K1's modes other than bf16: (kernels-line name, keywords, tolerance).
K1_MODES = {"int8": dict(quant="int8"), "int8fwd": dict(quant="int8fwd"),
            "bwd_bf16": dict(bwd_bf16=True)}
# bwd_bf16's case after the int8fwd forward: the int8fwd+bwd_bf16 mode.
FWD8_CASE = "full width, int8fwd forward"
# P3 keeps dvalue in f32 where K1 rounds it to bf16; a kernel that rounded it
# would sit ~1e-4 off its plain version on the leaves the value head reaches
# (tests/test_torch_fm_kernel_probe.py), inside BF16_TOL.  This bound on
# those leaves tells the two apart.
P3_VALUE_PATH = ("dW1", "db1", "dW2", "db2", "dWv", "dbv")
P3_VALUE_PATH_REL = 2e-5
# P3's stage hold leaves out the columns where kernel and plain version may
# take different branches of the clip: those whose branch differs between
# the two sides' h2 (a bf16 flip moves the logits by ~1e-4), and those whose
# ratio lies this close to an edge (the two compute it from f32 sums in
# another order, ~1e-7 apart).  A column on the other side of an edge
# changes its dlogits by the whole policy term (~1e-8 against ~1e-11 at full
# width): 3 such columns of 4,194,304 put dheads 2e-3 from the plain
# version's (relative L2, measured on an H100).
CLIP_EDGE = 1e-5


def rows_of(args):
    """A feature-major minibatch flattened to K4's rows, as the trainer
    flattens it: obs (T, F, N) -> (T*N, F), per-row (T, N) -> (T*N,)."""
    params, obs, *rest = args
    return (params, obs.transpose(1, 2).reshape(-1, obs.shape[1]),
            *[x.reshape(-1) for x in rest])


def compare_grads(label: str, fn, plain, args, kw, tol, card: str, phase: int):
    """Kernel vs its plain version on the same card tensors, within ``tol``
    (losses rtol, grad leaf relative L2, grad leaf cos), and two launches
    bit-identical.  Returns the largest absolute difference over the grads
    and losses."""
    loss_rtol, rel_l2, min_cos = tol
    grads, losses = fn(*args, **kw)
    grads2, losses2 = fn(*args, **kw)
    want, want_losses = plain(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(losses, losses2)
            and all(torch.equal(grads[k], grads2[k]) for k in grads)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    if not torch.allclose(losses, want_losses, rtol=loss_rtol, atol=LOSS_ATOL):
        raise AssertionError(f"{label}: losses {losses.tolist()} vs plain "
                             f"{want_losses.tolist()}")
    worst_rel, worst_cos = 0.0, 1.0
    err = float((losses - want_losses).abs().max())
    for k, w in want.items():
        g, w = grads[k].double().flatten(), w.double().flatten()
        rel = float((g - w).norm() / w.norm())
        cos = float(g @ w / (g.norm() * w.norm()))
        if not (rel <= rel_l2 and cos >= min_cos):
            raise AssertionError(f"{label}: {k} relative L2 {rel:.3e}, cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        err = max(err, float((g - w).abs().max()))
    shape = "x".join(str(d) for d in args[1].shape)
    print(f"phase {phase} {label} vs plain, obs {shape}, {kw['activation']}: losses "
          f"{[round(x, 6) for x in losses.tolist()]}, worst grad leaf relative L2 "
          f"{worst_rel:.3e} cos {worst_cos:.8f}, max |diff| {err:.3e}, two launches "
          f"bit-identical [{card}]")
    return err


def operand_distance(got: torch.Tensor, want: torch.Tensor, keep=None):
    """(relative L2, cos) of two tensors, summed in float64 a frame and
    OPERAND_COLS columns at a time for the split designs' (rows, T, N)
    workspace operands (K4's: T = 1, N = M); ``keep`` (T, N) bool: only
    those columns."""
    got, want = (x.reshape(x.shape[0], -1, x.shape[-1]) for x in (got, want))
    dd = gg = ww = gw = 0.0
    for t in range(got.shape[1]):
        for c0 in range(0, got.shape[2], OPERAND_COLS):
            g = got[:, t, c0:c0 + OPERAND_COLS].double()
            w = want[:, t, c0:c0 + OPERAND_COLS].double()
            if keep is not None:
                g, w = (x * keep[t, c0:c0 + OPERAND_COLS] for x in (g, w))
            dd += float((g - w).square().sum())
            gg += float(g.square().sum())
            ww += float(w.square().sum())
            gw += float((g * w).sum())
    return (dd / max(ww, 1e-300)) ** 0.5, gw / max((gg * ww) ** 0.5, 1e-300)


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference of two tensors, a frame and
    OPERAND_COLS columns at a time, as :func:`operand_distance` walks them."""
    got, want = (x.reshape(x.shape[0], -1, x.shape[-1]) for x in (got, want))
    return max(float((got[:, t, c0:c0 + OPERAND_COLS].float()
                      - want[:, t, c0:c0 + OPERAND_COLS].float()).abs().max())
               for t in range(got.shape[1]) for c0 in range(0, got.shape[2], OPERAND_COLS))


# The split designs' stage entries: (kernel A, its plain version, kernel B,
# kernel B's plain version), kernel B's taking (chain, obs) as the call does.
SPLIT_STAGES = {
    "K1": (fused_update.k1_chain, fused_update.k1_chain_plain, fused_update.k1_dw,
           fused_update.k1_dw_plain),
    "K4": (fused_update.k4_chain, fused_update.k4_chain_plain, fused_update.k4_dw,
           lambda chain, obs: fused_update.k1_dw_plain(chain, obs.t()[None])),
}


def hold_split(name: str, label: str, args, kw, card: str, phase: int, design: str = "K1"):
    """A split design's two kernels (K1 bf16 and int8fwd, each with or
    without the bf16 backward chain: ``k1_chain`` / ``k1_dw``; K4:
    ``k4_chain`` / ``k4_dw``), each against its plain version
    on the card: kernel A (the whole minibatch) against its plain chain, its
    operands and bias grads within BF16_TOL's relative L2 and cos and its
    loss sums (as means) within its rtol; then kernel B on kernel A's own
    operands against ``k1_dw_plain`` on the same operands, each dW within
    K1_DW_REL.  Raises on the first miss.  Returns kernel A's largest
    absolute difference from its plain chain over the operands, the bias
    grads and the loss sums (as means, as they are held)."""
    chain_fn, chain_plain, dw_fn, dw_plain = SPLIT_STAGES[design]
    loss_rtol, rel_l2, min_cos = BF16_TOL
    got = chain_fn(*args, **kw)
    want = chain_plain(*args, **kw)
    torch.cuda.synchronize()
    L = len(got.hs)
    pairs = [*[(f"h{l}", got.hs[l], want.hs[l]) for l in range(L)],
             ("dheads", got.dheads, want.dheads),
             *[(f"dpre{l}", got.dpres[l], want.dpres[l]) for l in range(L)],
             *[(f"db{l}", got.db[l][:, None, None], want.db[l][:, None, None]) for l in range(L)],
             ("dbpv", got.dbpv[:, None, None], want.dbpv[:, None, None])]
    worst_rel, worst_cos, err = 0.0, 1.0, 0.0
    for leaf, g, w in pairs:
        rel, cos = operand_distance(g, w)
        if not (rel <= rel_l2 and cos >= min_cos):
            raise AssertionError(f"{name} kernel A [{label}]: {leaf} relative L2 {rel:.3e}, "
                                 f"cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        err = max(err, max_abs_diff(g, w))
    inv_m = 1.0 / args[2].numel()
    if not torch.allclose(got.sums * inv_m, want.sums * inv_m, rtol=loss_rtol, atol=LOSS_ATOL):
        raise AssertionError(f"{name} kernel A [{label}]: loss sums {got.sums.tolist()} vs plain "
                             f"{want.sums.tolist()}")
    err = max(err, float((got.sums * inv_m - want.sums * inv_m).abs().max()))
    del want
    obs = args[1]
    dw, dwpv = dw_fn(got, obs)
    dw_p, dwpv_p = dw_plain(got, obs)
    torch.cuda.synchronize()
    rels = {leaf: float((g.double() - w.double()).norm() / w.double().norm())
            for leaf, g, w in [*[(f"dW{l}", dw[l], dw_p[l]) for l in range(L)],
                               ("dWpv", dwpv, dwpv_p)]}
    worst_dw = max(rels, key=rels.get)
    if rels[worst_dw] > K1_DW_REL:
        raise AssertionError(f"{name} kernel B [{label}]: {worst_dw} relative L2 {rels[worst_dw]:.3e} "
                             f"> {K1_DW_REL}")
    shape = "x".join(str(d) for d in obs.shape)
    chain_name = chain_plain.__name__
    print(f"phase {phase} {name} kernel A vs {chain_name} [{label}], obs {shape}, "
          f"{kw['activation']}: worst operand / bias grad relative L2 {worst_rel:.3e} cos "
          f"{worst_cos:.8f}, max |diff| {err:.3e}, loss sums {got.sums.tolist()}; kernel B vs "
          f"k1_dw_plain on kernel A's operands: worst {worst_dw} relative L2 "
          f"{rels[worst_dw]:.3e} [{card}]")
    return err


def k1_split_floor(rows: int, f: int = 35, x_rows: int = 0):
    """(ms, bytes) of the split design's own floor by bytes at HIDDEN: kernel
    A reads the observations and the 5 per-column inputs and writes the
    workspace; kernel B reads the workspace and, for K1, the observations
    again (K4's workspace holds ``x_rows`` rows of x^T instead)."""
    ws = 2 * (x_rows + 2 * sum(HIDDEN) + fused_update.HEAD_PAD)
    nbytes = rows * (f * 2 + 5 * 4 + ws + ws + (0 if x_rows else f * 2))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def split_times(name: str, args, kw, card: str, call_ms: float, phase: int):
    """CUDA-event ms of a split design's kernel A alone and kernel B alone
    over the wrapper's own chunks (min of two readings of 5 calls), beside
    the whole call's and the design's floor by bytes: K1 bf16 or int8fwd
    (``kw["quant"]``, with or without ``kw["bwd_bf16"]``, args feature-major)
    or K4 (name "K4", args rows).  Returns (A ms, B ms)."""
    params, obs, action, *scalars = args
    common = dict(num_actions=kw["num_actions"], activation=kw["activation"],
                  clip_eps=kw["clip_eps"], value_coef=kw["value_coef"],
                  entropy_coef=kw["entropy_coef"], inv_m=1.0 / action.numel())
    if name == "K4":
        rows, chunk = obs.shape[0], min(fused_update.CHUNK_COLS, obs.shape[0])
        chunks, unit = -(-rows // chunk), "row(s)"
        run = lambda stages: fused_update._run_k4(params, obs, action, scalars, chunk=chunk,
                                                  stages=stages, **common)
        floor_ms, nbytes = k1_split_floor(rows, x_rows=-(-obs.shape[1] // 16) * 16)
    else:
        t_mb, _, n = obs.shape
        rows, chunk = t_mb * n, fused_update.chunk_frames(t_mb, n)
        chunks, unit = -(-t_mb // chunk), "frame(s)"
        run = lambda stages: fused_update._run_bf16(params, obs, action, scalars, chunk=chunk,
                                                    stages=stages, quant=kw.get("quant", "none"),
                                                    bwd_bf16=kw.get("bwd_bf16", False), **common)
        floor_ms, nbytes = k1_split_floor(rows)
    a_ms = min(cuda_ms(lambda: run(fused_update.STAGE_CHAIN), 5) for _ in range(2))
    b_ms = min(cuda_ms(lambda: run(fused_update.STAGE_DW), 5) for _ in range(2))
    b = grad_bound(rows, kw.get("quant", "none"))
    relu = ""
    if kw["activation"] == "tanh" and kw.get("quant", "none") == "none" and not kw.get("bwd_bf16"):
        # Kernel A on the same inputs with relu: no tanh, and K4 keeps no f32
        # activations (relu's derivative is the same from the bf16 value).
        common["activation"] = "relu"
        relu_ms = min(cuda_ms(lambda: run(fused_update.STAGE_CHAIN), 5) for _ in range(2))
        relu = f"; kernel A with relu {relu_ms:.3f} ms"
    print(f"phase {phase} time {name} split, {rows} columns: call {call_ms:.3f} ms = kernel A "
          f"{a_ms:.3f} ms ({a_ms / call_ms:.1%}) + kernel B {b_ms:.3f} ms ({b_ms / call_ms:.1%}); "
          f"chunks of {chunk} {unit}, {2 * chunks} launches of A and B; the design's floor by "
          f"bytes {floor_ms:.3f} ms ({nbytes / 1e9:.2f} GB), the function's bound {b[0]:.3f} ms "
          f"by {b[1]}{relu} [{card}]")
    return a_ms, b_ms


def k1_chain_work(rows: int, f: int = 35, num_actions: int = 18):
    """(bytes, operations) of K1 bf16's kernel A over ``rows`` columns at
    HIDDEN, as :func:`bound` takes them: its inputs read (observations, the
    5 per-column scalars) and its workspace written once (2,112 bytes a
    column at (256, 256)); its products (the forward, the head's and the
    hidden dh) at the bf16 peak."""
    widths = [f, *HIDDEN]
    head = num_actions + 1
    macs = (sum(i * o for i, o in zip(widths[:-1], widths[1:])) + 2 * widths[-1] * head
            + sum(i * o for i, o in zip(widths[1:-1], widths[2:])))
    ws = 2 * (2 * sum(HIDDEN) + fused_update.HEAD_PAD)
    return rows * (f * 2 + 5 * 4 + ws), {"bf16": rows * 2 * macs}


def chain_times(args, kw, card: str, phase: int = 9):
    """K1 bf16's kernel A (``wgmma_chain_kernel`` at HIDDEN) at full width
    alone, over the wrapper's chunks, twice, beside the plain chain's ms and
    kernel A's bounds by bytes and by products.  Returns (ms, plain ms,
    bound)."""
    params, obs, action, *scalars = args
    t_mb, _, n = obs.shape
    common = dict(num_actions=kw["num_actions"], activation=kw["activation"],
                  clip_eps=kw["clip_eps"], value_coef=kw["value_coef"],
                  entropy_coef=kw["entropy_coef"], inv_m=1.0 / action.numel())
    run = lambda: fused_update._run_bf16(
        params, obs, action, scalars, chunk=fused_update.chunk_frames(t_mb, n),
        stages=fused_update.STAGE_CHAIN, **common)
    w1, w2 = cuda_ms(run, 5), cuda_ms(run, 5)
    plain_ms = cuda_ms(lambda: fused_update.k1_chain_plain(*args, **kw), 1)
    nbytes, ops = k1_chain_work(t_mb * n)
    b = bound(nbytes, ops)
    print(f"phase {phase} time K1 bf16 kernel A, {t_mb * n} columns: wgmma_chain_kernel "
          f"{w1:.3f} / {w2:.3f} ms, plain {plain_ms:.3f} ms; bound {b[0]:.3f} ms by {b[1]} "
          f"({bound(nbytes, {})[0]:.3f} ms by bytes, {bound(0, ops)[0]:.3f} ms by products) "
          f"[{card}]")
    return min(w1, w2), plain_ms, b


def chain_key(cfg: PPOConfig) -> str:
    """The ``launches_by_kernel`` key of kernel A in a trainer's K1 bf16 or
    int8fwd calls: ``bf16_chain_wgmma`` where ``chain_design`` gives the call
    to the wgmma kernel, else ``bf16_chain``."""
    design = fused_update.chain_design(cfg.hidden, 35, cfg.num_actions, cfg.update_quant,
                                       cfg.update_bwd_bf16)
    return "bf16_chain_wgmma" if design == "wgmma" else "bf16_chain"


def hold_k1_int8_split(label: str, args, kw, card: str) -> float:
    """K1 int8's kernels, each against its plain version on the card:
    kernels A and S (``k1_int8_chain``, the whole minibatch) against
    ``k1_int8_chain_plain``: each integer operand within one step, on at most
    INT8_STEP_SHARE of its entries; the f32 dpre, the cell maxima, the bf16
    operands and the bias grads within BF16_TOL's relative L2 and cos, the
    loss sums (as means) within its rtol; then kernel Q and the head's dW
    (``k1_int8_dw``) on the kernels' own operands against
    ``k1_int8_dw_plain`` on the same operands, each dW within K1_DW_REL.
    Raises on the first miss; returns the largest share of entries a step
    apart."""
    loss_rtol, rel_l2, min_cos = BF16_TOL
    got = fused_update.k1_int8_chain(*args, **kw)
    want = fused_update.k1_int8_chain_plain(*args, **kw)
    torch.cuda.synchronize()
    L = len(got.hs)
    share, worst_share = {}, 0.0
    for name, g, w in [("x_q", got.x_q, want.x_q),
                       *[(f"h_q{l}", got.hs[l], want.hs[l]) for l in range(L)],
                       *[(f"dp_q{l}", got.dp_q[l], want.dp_q[l]) for l in range(L)]]:
        apart = steps = 0
        for t in range(g.shape[1]):
            d = (g[:, t].int() - w[:, t].int()).abs()
            steps = max(steps, int(d.max()))
            apart += int((d != 0).sum())
        share[name] = apart / g.numel()
        if steps > 1 or share[name] > INT8_STEP_SHARE:
            raise AssertionError(f"kernels A+S [{label}]: {name} {steps} steps apart on "
                                 f"{share[name]:.3e} of its entries")
        worst_share = max(worst_share, share[name])
    pairs = [("h_top", got.h_top, want.h_top), ("dheads", got.dheads, want.dheads),
             *[(f"dpre{l}", got.dpres[l], want.dpres[l]) for l in range(L)],
             ("cellmax", got.cellmax, want.cellmax),
             *[(f"db{l}", got.db[l][:, None, None], want.db[l][:, None, None]) for l in range(L)],
             ("dbpv", got.dbpv[:, None, None], want.dbpv[:, None, None])]
    worst_rel, worst_cos = 0.0, 1.0
    for name, g, w in pairs:
        rel, cos = operand_distance(g, w)
        if not (rel <= rel_l2 and cos >= min_cos):
            raise AssertionError(f"kernels A+S [{label}]: {name} relative L2 {rel:.3e}, cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    inv_m = 1.0 / args[2].numel()
    if not torch.allclose(got.sums * inv_m, want.sums * inv_m, rtol=loss_rtol, atol=LOSS_ATOL):
        raise AssertionError(f"kernels A+S [{label}]: loss sums {got.sums.tolist()} vs plain "
                             f"{want.sums.tolist()}")
    del want
    dw, dwpv = fused_update.k1_int8_dw(got)
    dw_p, dwpv_p = fused_update.k1_int8_dw_plain(got)
    torch.cuda.synchronize()
    rels = {name: float((g.double() - w.double()).norm() / w.double().norm())
            for name, g, w in [*[(f"dW{l}", dw[l], dw_p[l]) for l in range(L)],
                               ("dWpv", dwpv, dwpv_p)]}
    worst_dw = max(rels, key=rels.get)
    if rels[worst_dw] > K1_DW_REL:
        raise AssertionError(f"kernel Q [{label}]: {worst_dw} relative L2 {rels[worst_dw]:.3e} "
                             f"> {K1_DW_REL}")
    shape = "x".join(str(d) for d in args[1].shape)
    print(f"phase 11 K1 int8 kernels A+S vs k1_int8_chain_plain [{label}], obs {shape}: entries "
          f"one step apart {json.dumps({k: float(f'{v:.3e}') for k, v in share.items()})} (bound "
          f"{INT8_STEP_SHARE}, none further), worst f32 / bf16 operand, cell maximum or bias grad "
          f"relative L2 {worst_rel:.3e} cos {worst_cos:.8f}; dW kernels vs k1_int8_dw_plain on the "
          f"kernels' operands: worst {worst_dw} relative L2 {rels[worst_dw]:.3e} [{card}]")
    return worst_share


def k1_int8_split_floor(rows: int, f: int = 35, num_actions: int = 18):
    """(ms, bytes) of K1 int8's own floor by bytes at HIDDEN: kernel A reads
    the observations and the 5 per-column inputs and writes x_q, h_q_l,
    bf16(h_top), bf16(dheads) and the f32 dpre_{L-1}; kernel S for layer l
    reads dpre_l and writes dp_q_l, and for l > 0 reads h_q_{l-1} and
    writes dpre_{l-1}; the dW kernels read x_q, h_q_0..h_q_{L-2}, every dp_q,
    bf16(h_top) and bf16(dheads)."""
    hidden, fp = list(HIDDEN), -(-f // 16) * 16
    head = 2 * fused_update.HEAD_PAD
    a = f * 2 + 5 * 4 + fp + sum(hidden) + 2 * hidden[-1] + head + 4 * hidden[-1]
    s = sum(4 * h + h + (5 * hidden[l - 1] if l else 0) for l, h in enumerate(hidden))
    q = fp + sum(hidden[:-1]) + sum(hidden) + 2 * hidden[-1] + head
    nbytes = rows * (a + s + q)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def k1_int8_split_times(args, kw, card: str, call_ms: float):
    """CUDA-event ms of K1 int8's kernel A alone, A with kernel S (so S is
    their difference) and the dW kernels alone, over the wrapper's own
    chunks (min of two readings of 5 calls), beside the whole call's and
    the design's floor by bytes.  Returns (A, S, dW) ms."""
    params, obs, action, *scalars = args
    t_mb, _, n = obs.shape
    chunk = fused_update.chunk_frames(t_mb, n)
    run = lambda stages: fused_update._run_int8(
        params, obs, action, scalars, num_actions=kw["num_actions"],
        activation=kw["activation"], clip_eps=kw["clip_eps"], value_coef=kw["value_coef"],
        entropy_coef=kw["entropy_coef"], inv_m=1.0 / (t_mb * n), chunk=chunk, stages=stages)
    timed = lambda stages: min(cuda_ms(lambda: run(stages), 5) for _ in range(2))
    a_ms = timed(fused_update.STAGE_CHAIN)
    s_ms = timed(fused_update.STAGE_CHAIN | fused_update.STAGE_REQUANT) - a_ms
    q_ms = timed(fused_update.STAGE_DW)
    floor_ms, nbytes = k1_int8_split_floor(t_mb * n)
    b = grad_bound(t_mb * n, "int8")
    L = len(HIDDEN)
    print(f"phase 11 time K1 int8 split T={t_mb} N={n}: call {call_ms:.3f} ms = kernel A "
          f"{a_ms:.3f} ms + kernel S x {L} {s_ms:.3f} ms (A with S, less A) + dW kernels (Q and "
          f"the head's B) {q_ms:.3f} ms; chunks of {chunk} frame(s), {-(-t_mb // chunk)} x "
          f"(A, {L} S, Q, B) launches; the design's floor by bytes {floor_ms:.3f} ms "
          f"({nbytes / 1e9:.2f} GB), the function's bound {b[0]:.3f} ms by {b[1]} [{card}]")
    return a_ms, s_ms, q_ms


def hold_k1_float64(args, kw, card: str, label: str = "K1 bf16", phase: int = 9):
    """The worst grad leaf's distance from a float64 plain version, of the
    kernel and of the plain version; raises unless the kernel's is at most
    K1_F64_RATIO times the plain version's (one-signed drift in kernel B's
    long sums would put it further, as would the bf16 chain's head dh on
    the tensor cores)."""
    exact = float64_plain(args, kw)
    got, _ = fused_ppo_grads_fm(*args, **kw)
    plain, _ = fused_update.fused_ppo_grads_fm_plain(*args, **kw)
    torch.cuda.synchronize()
    dist = lambda g: max((float((g[k].double() - exact[k].double()).norm()
                                / exact[k].double().norm()), k) for k in exact)
    kd, pd = dist(got), dist(plain)
    if kd[0] > K1_F64_RATIO * pd[0]:
        raise AssertionError(f"{label} {kd[0]:.3e} ({kd[1]}) from float64, plain {pd[0]:.3e}: "
                             f"more than {K1_F64_RATIO}x")
    print(f"phase {phase} {label} vs a float64 plain version: kernel worst leaf {kd[0]:.3e} "
          f"({kd[1]}), plain {pd[0]:.3e} ({pd[1]}), ratio {kd[0] / pd[0]:.3f} <= {K1_F64_RATIO} "
          f"[{card}]")


def hold_chain_float64(label: str, args, kw, card: str):
    """The bf16 backward chain on kernel A's own operands (``k1_chain``, the
    whole minibatch): layer by layer, dpre_b = bf16(bf16(W . below) * act'(h))
    from kernel A's hs, dheads and the dpre_b above, with the product in
    float64 and in f32 (the plain version's).  Raises unless kernel A's
    dpre_b sits at most K1_F64_RATIO times as far (relative L2) from the
    float64 recurrence as the f32 one does: a product that rounds one way
    before the bf16 round (the head's dh on the tensor cores) would put it
    further.  Unlike the call's distance from float64, this one is blind to
    the loss's exp / log roundings, which move dheads and, after the int8
    forward (exact integer products in f32 and float64 alike), are all
    that keeps the kernel off a float64 plain version."""
    chain = fused_update.k1_chain(*args, **kw)
    _, L, w, _ = dense_layers(args[0])
    bf = torch.bfloat16
    weights = [x.to(bf) for x in w[1:L]] + [torch.cat([w[L], w[L + 1]], dim=1).to(bf)]
    relu = kw["activation"] == "relu"
    sq = {key: [0.0] * L for key in ("kernel", "f32", "norm")}
    for t in range(chain.dheads.shape[1]):
        for c0 in range(0, chain.dheads.shape[2], OPERAND_COLS):
            cols = slice(c0, c0 + OPERAND_COLS)
            for l in range(L):
                above = chain.dheads if l == L - 1 else chain.dpres[l + 1]
                wt, below = weights[l], above[:, t, cols]
                h = chain.hs[l][:, t, cols]
                da = (h > 0).to(bf) if relu else 1.0 - h * h
                exact = (torch.matmul(wt.double(), below.double()).to(bf) * da).double()
                f32 = (torch.matmul(wt.float(), below.float()).to(bf) * da).double()
                got = chain.dpres[l][:, t, cols].double()
                sq["kernel"][l] += float((got - exact).square().sum())
                sq["f32"][l] += float((f32 - exact).square().sum())
                sq["norm"][l] += float(exact.square().sum())
    del chain
    rel = {key: [(sq[key][l] / sq["norm"][l]) ** 0.5 for l in range(L)] for key in ("kernel", "f32")}
    for l in range(L):
        if rel["kernel"][l] > K1_F64_RATIO * rel["f32"][l]:
            raise AssertionError(f"{label}: kernel A's dpre{l} {rel['kernel'][l]:.3e} from the "
                                 f"float64 chain, f32 products {rel['f32'][l]:.3e}: more than "
                                 f"{K1_F64_RATIO}x")
    shape = "x".join(str(d) for d in args[1].shape)
    print(f"phase 11 {label}, the bf16 chain on kernel A's operands vs float64 products, obs "
          f"{shape}: dpre_l relative L2 kernel {[float(f'{x:.3e}') for x in rel['kernel']]}, f32 "
          f"products {[float(f'{x:.3e}') for x in rel['f32']]}, each ratio <= {K1_F64_RATIO} "
          f"[{card}]")


def chains_apart(args, kw, card: str):
    """The bf16 backward chain's plain version against the bf16 mode's on
    the same inputs.  Raises unless some grad leaf differs by more than
    BF16_TOL's relative L2: the bound K1 bwd_bf16 is held to then tells a
    kernel that ran the other chain from the right one."""
    plain = fused_update.fused_ppo_grads_fm_plain
    chain, _ = plain(*args, **dict(kw, bwd_bf16=True))
    stock, _ = plain(*args, **kw)
    rel = {k: float((chain[k].double() - stock[k].double()).norm() / stock[k].double().norm())
           for k in stock}
    worst = max(rel, key=rel.get)
    if rel[worst] <= BF16_TOL[1]:
        raise AssertionError(f"bwd_bf16 plain within {rel[worst]:.3e} of the bf16 mode's: "
                             f"its bound {BF16_TOL[1]} cannot tell the chains apart")
    shape = "x".join(str(d) for d in args[1].shape)
    print(f"phase 11 K1 plain bf16 chain vs plain bf16 mode, obs {shape}: worst grad leaf "
          f"relative L2 {rel[worst]:.3e} ({worst}), above the bound {BF16_TOL[1]} [{card}]")


def time_grads(label: str, fn, plain, args, kw, card: str, phase: int):
    """CUDA-event ms of a kernel and of its plain version, interleaved plain,
    kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(lambda: plain(*args, **kw), 1),
                      cuda_ms(lambda: fn(*args, **kw), 5),
                      cuda_ms(lambda: fn(*args, **kw), 5),
                      cuda_ms(lambda: plain(*args, **kw), 1))
    print(f"phase {phase} time {label}: kernel {k1:.3f} / {k2:.3f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms [{card}]")
    return min(k1, k2), min(p1, p2)


def grad_bound(rows: int, quant: str = "none"):
    """(bound_ms, bound_by) of one PPO-gradient call over ``rows`` columns
    at HIDDEN: the inputs read and the grads written once, and the products'
    operations by type (forward, the dW products, the dh products).  The bf16
    mode's is the benchmark's ``grad_bound_s``; an int8 mode moves its
    products to the int8 rate, but for the two bf16 head products of the int8
    backward."""
    if quant == "none":
        seconds, by = counts.grad_bound_s(rows, HIDDEN)
        return seconds * 1e3, by
    widths = counts.mlp_widths(HIDDEN)
    hidden = 2 * sum(i * o for i, o in zip(widths[:-1], widths[1:]))  # one pass
    hidden_dh = 2 * sum(i * o for i, o in zip(widths[1:-1], widths[2:]))
    head = 2 * widths[-1] * (K1_KW["num_actions"] + 1)
    forward, backward = hidden + head, hidden + 2 * head + hidden_dh
    ops = {"int8fwd": {"int8": forward, "bf16": backward},
           "int8": {"int8": forward + hidden + hidden_dh, "bf16": 2 * head}}[quant]
    n_params = counts.param_count(HIDDEN, K1_KW["num_actions"])
    nbytes = rows * (widths[0] * 2 + 5 * 4) + n_params * (4 + 4)
    return bound(nbytes, {t: rows * n for t, n in ops.items()})


def capture_first_minibatch():
    """Wrap the trainer's K1 entry so that its first call's arguments are
    kept (the first live minibatch); returns (store, restore)."""
    store = []

    def wrapper(*args, **kw):
        if not store:
            store.append((args, kw))
        return fused_ppo_grads_fm(*args, **kw)

    ppo.fused_ppo_grads_fm = wrapper
    return store, lambda: setattr(ppo, "fused_ppo_grads_fm", fused_ppo_grads_fm)


def train(env_config: EnvConfig, cfg: PPOConfig, updates: int, label: str, card: str,
          phase: int = 10):
    """``updates`` train steps from ``init_fn(0)`` through the trainer's
    entry points, the counts set to 0 just before and read just after.
    Raises unless the configured kernel serves, every env advanced
    ``updates * rollout_length`` frames, the metrics are finite and the
    params moved.  Returns (runner, train_step, launches by kernel,
    env-steps/s)."""
    init_fn, train_step, _ = make_ppo_trainer(PikaZoo(env_config), cfg, device="cuda")
    want = "row" if cfg.fused_update == "on" else "fm"
    if train_step.provenance["fused_update"] != want:
        raise AssertionError(f"{label}: update served by {train_step.provenance}")
    runner = init_fn(0)
    start = runner.env_state.step_count.clone()
    params0 = runner.params
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(updates):
        runner, m = train_step(runner)
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fused_ppo_grads_fm": dict(fused_ppo_grads_fm.launches_by_mode),
                "by_kernel": dict(fused_ppo_grads_fm.launches_by_kernel),
                "fused_ppo_grads": fused_ppo_grads.launches,
                "k4_by_kernel": dict(fused_ppo_grads.launches_by_kernel),
                "landing_sims_batched": predict_cuda.landing_sims_batched.launches,
                "fused_rollout": fused_rollout.launches,
                "learner_step": learner_step.launches}
    frames = updates * cfg.rollout_length
    advanced = runner.env_state.step_count - start
    if not bool((advanced == frames).all()):
        raise AssertionError(f"{label}: step_count advanced by {int(advanced.min())}.."
                             f"{int(advanced.max())}, not {frames}")
    values = torch.stack([torch.stack([x.float() for x in m[:7]]) for m in metrics])
    if not bool(torch.isfinite(values).all()):
        raise AssertionError(f"{label}: metrics not finite: {values.tolist()}")
    moved = max(float((runner.params[k] - params0[k]).abs().max()) for k in params0)
    if moved == 0:
        raise AssertionError(f"{label}: the params did not move")
    rate = updates * cfg.rollout_length * cfg.num_envs / seconds
    last = dict(zip(metrics[-1]._fields[:7], values[-1].tolist()))
    print(f"phase {phase} {label}: B={cfg.num_envs} x {frames} frames in {updates} "
          f"update(s), {seconds:.3f} s = {rate:.0f} env-steps/s (train-step wall), "
          f"every step_count +{frames}, params moved (max |change| {moved:.3e}), "
          f"launches {launches}, last update {json.dumps(last)} [{card}]")
    return runner, train_step, launches, rate


def expect_launches(label: str, launches, k1_mode: str = "", k1=0, k4=0, landing=0,
                    steps=0):
    """The run launched exactly ``k1`` K1 calls, all in ``k1_mode``, ``k4`` K4
    calls, ``landing`` landing kernels and ``steps`` learner steps (one a
    frame of a rollout), and no fused rollout."""
    by_mode = launches["fused_ppo_grads_fm"]
    others = {m: n for m, n in by_mode.items() if m != k1_mode and n}
    if (by_mode.get(k1_mode, 0) != k1 or others or launches["fused_ppo_grads"] != k4
            or launches["landing_sims_batched"] != landing or launches["fused_rollout"]
            or launches["learner_step"] != steps):
        raise AssertionError(f"{label}: launches {launches}, want {k1} K1 in mode "
                             f"{k1_mode or '-'}, {k4} K4, {landing} landing, {steps} "
                             "learner steps, no other")


def expect_kernels(label: str, got: dict, want: dict, card: str, phase: int):
    """The run launched each kernel exactly as often as ``want`` says (those
    it does not name 0 times)."""
    want = dict(dict.fromkeys(got, 0), **want)
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, want {want}")
    print(f"phase {phase} {label} kernel launches {got} [{card}]")


def k1_chunks(cfg: PPOConfig) -> int:
    """Chunks of K1's split kernels in one update: each call's frames in
    chunks of ``chunk_frames``, update_epochs x num_minibatches calls."""
    frames, cols = cfg.rollout_length // cfg.num_minibatches, 2 * cfg.num_envs
    return (cfg.update_epochs * cfg.num_minibatches
            * -(-frames // fused_update.chunk_frames(frames, cols)))


def time_learner_phases(runner, train_step, cfg: PPOConfig, card: str, phase: int = 10):
    """CUDA-event ms of one more update, phase by phase, driven through the
    trainer's phase attributes: rollout, GAE, update."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    uniforms = torch.rand((cfg.rollout_length, 1, 2 * cfg.num_envs),
                          generator=runner.key, device="cuda")
    events[0].record()
    (env_state, last_norm), traj = train_step.rollout_fn(
        runner.params, runner.env_state, runner.last_obs, uniforms)
    events[1].record()
    _, last_value = apply_fm(runner.params, last_norm, cfg.activation)
    adv, targets = ppo.gae_associative(traj.value, traj.reward, traj.done,
                                       last_value, cfg.gamma, cfg.gae_lambda)
    events[2].record()
    train_step.update_fn(runner.params, runner.opt_state, traj, adv, targets)
    events[3].record()
    events[3].synchronize()
    rollout, gae, update = (events[i].elapsed_time(events[i + 1]) for i in range(3))
    total = rollout + gae + update
    kernel = "K4" if cfg.fused_update == "on" else f"K1 {fused_update.mode_name(cfg.update_quant, cfg.update_bwd_bf16)}"
    print(f"phase {phase} update phases (CUDA events): rollout {rollout:.1f} ms, GAE "
          f"{gae:.2f} ms, update {update:.1f} ms ({cfg.update_epochs * cfg.num_minibatches}"
          f" {kernel} calls); rollout share {rollout / total:.1%} [{card}]")

# The probe tools (phases 13-15).
P2_FULL = (32, 131072)    # the JAX probes' minibatch: T=32 frames x 2B = 131072 columns
P3_RAGGED = (3, 1000)
P1_ROLL_FRAMES = 128      # AI frames before the P1 tool's live states
RULES = {True: "full rule", False: "mistake rule"}


def compare_flat(name: str, lanes) -> int:
    """The flat kernel vs its plain version on the same card lanes, under
    both rules; raises unless bit-equal.  Returns the largest absolute
    difference (0)."""
    err = 0
    for rule, rule_name in RULES.items():
        got = compaction_probe.flat_sims(*lanes, rule)
        want = compaction_probe.flat_sims_plain(*lanes, rule)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"flat_sims != plain on {name}, {rule_name}: max |diff| {err}")
    print(f"phase 13 flat_sims vs plain [{name}]: n={lanes[0].numel()} bit-equal under both rules")
    return err


def probe_p1(live, card: str):
    """P1 on the card: bit-equal cases, the composed lanes against K2, the
    ETA-sorted check, kernel and plain times on the candidate lanes of the
    live states (the larger call; the kernel timed with the stream held, and
    K2 on the same states both ways beside it), and the tool's main (stages
    kern and prim) with the counts from 0.  Returns (err, ms, plain_ms,
    bound, launches)."""
    device = live[0].device
    cand = tuple(v.contiguous() for v in compaction_probe.candidate_lanes(*live))
    err = compare_flat("random states", random_ball_states(AI_BATCH, 2, device))
    err = max(err, compare_flat("net-trap cases", tuple(
        torch.tensor(c, device=device) for c in NET_TRAP_CASES.T.copy())))
    err = max(err, compare_flat(f"AI self-play frame {HARVEST_FRAME}, true lanes", live))
    err = max(err, compare_flat(f"AI self-play frame {HARVEST_FRAME}, candidate lanes", cand))
    compaction_probe.check_lanes(live)
    print(f"phase 13 flat natural == landing_sims_batched (expected, 6 candidates) and "
          f"ETA-sorted == permuted natural, B={AI_BATCH} frame-{HARVEST_FRAME} states")
    timed = {}
    for label, lanes, rule in (("true lanes, full rule", live, True),
                               ("candidate lanes, mistake rule", cand, False)):
        kernel = lambda: compaction_probe.flat_sims(*lanes, rule)
        plain = lambda: compaction_probe.flat_sims_plain(*lanes, rule)
        kernel(), plain()
        p1, k1, k2, p2 = (cuda_ms(plain, 2), cuda_ms(kernel, 50, hold=True),
                          cuda_ms(kernel, 50, hold=True), cuda_ms(plain, 2))
        _, iters = count_landing_iterations(plain)
        b = bound(5 * 4 * lanes[0].numel(), {"int32": int(iters.sum()) * LANDING_ITERATION_OPS})
        timed[rule] = (min(k1, k2), min(p1, p2), b)
        print(f"phase 13 time [{label}] n={lanes[0].numel()}: kernel {k1:.4f} / {k2:.4f} ms "
              f"(stream held), plain {p1:.3f} / {p2:.3f} ms; bound {b[0]:.5f} ms by {b[1]} "
              f"({int(iters.sum())} lane iterations) [{card}]")
    k2_call = lambda: predict_cuda.landing_sims_batched(*live)
    print(f"phase 13 time K2 on the same states: {cuda_ms(k2_call, 50):.4f} ms as phase 3 "
          f"times it, {cuda_ms(k2_call, 50, hold=True):.4f} ms with the stream held [{card}]")
    zero_counts()
    for stage in ("kern", "prim"):
        if compaction_probe.main(["--stage", stage, "--batch", str(AI_BATCH), "--roll-frames",
                                  str(P1_ROLL_FRAMES), "--chain", "16", "--iters", "3"]):
            raise AssertionError(f"compaction_probe stage {stage} failed")
    launches = compaction_probe.flat_sims.launches
    if launches == 0:
        raise AssertionError("the compaction probe's main launched no flat_sims")
    print(f"phase 13 compaction_probe main: flat_sims launches {launches} [{card}]")
    return (err, *timed[False], launches)


def hold_leaves(label: str, names, fn, plain, card: str, phase: int, value_path=()):
    """Kernel vs plain on the same card tensors, leaf by leaf: relative L2 <=
    BF16_TOL's and cos >= its (and relative L2 <= P3_VALUE_PATH_REL on the
    leaves named in ``value_path``), two launches bit-identical.  Returns the
    largest absolute difference."""
    _, rel_l2, min_cos = BF16_TOL
    got, got2, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, got2)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    worst_rel, worst_cos, err = 0.0, 1.0, 0.0
    for name, g, w in zip(names, got, want):
        g, w = g.double().flatten(), w.double().flatten()
        rel = float((g - w).norm() / w.norm())
        cos = float(g @ w / (g.norm() * w.norm()))
        if not (rel <= rel_l2 and cos >= min_cos) or (name in value_path
                                                      and rel > P3_VALUE_PATH_REL):
            raise AssertionError(f"{label}: {name} relative L2 {rel:.3e}, cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        err = max(err, float((g - w).abs().max()))
    print(f"phase {phase} {label} vs plain: worst leaf relative L2 {worst_rel:.3e} cos "
          f"{worst_cos:.8f}, max |diff| {err:.3e}, two launches bit-identical [{card}]")
    return got, want, err


def mm_bound(rows: int, f: int = 35, h: int = 256, a: int = 18):
    """(bound_ms, bound_by) of the eight products over ``rows`` columns: obs
    read and the three dW written once, weights read once, bf16 operations."""
    ops = 2 * (2 * f * h + 3 * h * h + 3 * h * a)
    nbytes = rows * f * 2 + (f * h + h * h + h * a) * (2 + 4)
    return bound(nbytes, {"bf16": rows * ops})


def p2_split_floor(rows: int, f: int = 35):
    """(ms, bytes) of P2's split design's own floor by bytes at HIDDEN: kernel
    A reads the observations and writes the workspace (x, h1, h2, dl, dh2,
    dh1), kernel B reads it once."""
    ws = 2 * fm_roofline.ws_rows(*fm_roofline._widths(f, *HIDDEN, fm_roofline.A))[-1]
    nbytes = rows * (f * 2 + 2 * ws)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def hold_p2_split(label: str, obs, weights, phased: bool, card: str):
    """P2's two kernels, each against its plain version on the card: kernel A
    (``mm_chain``, the whole minibatch) against ``mm_chain_plain``, each
    operand within BF16_TOL's relative L2 and cos, the workspace zero in its
    padded rows (x past F, dl past A) and columns (past N); then kernel B
    (``mm_dw``) on kernel A's own operands against ``mm_dw_plain`` on them,
    each dW within K1_DW_REL.  Raises on the first miss."""
    _, rel_l2, min_cos = BF16_TOL
    variant = fm_roofline.VARIANTS[int(phased)]
    got = fm_roofline.mm_chain(obs, *weights, phased=phased)
    want = fm_roofline.mm_chain_plain(obs, *weights)
    torch.cuda.synchronize()
    worst_rel, worst_cos = 0.0, 1.0
    for name, g, w in zip(fm_roofline.MMChain._fields, got, want):
        rel, cos = operand_distance(g, w)
        if not (rel <= rel_l2 and cos >= min_cos):
            raise AssertionError(f"P2 {variant} kernel A [{label}]: {name} relative L2 {rel:.3e}, "
                                 f"cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    del want
    t_mb, f, n = obs.shape
    rows = fm_roofline.ws_rows(*fm_roofline._widths(f, *HIDDEN, weights[2].shape[1]))
    ws = fm_roofline.mm_chain.workspace.view(rows[-1], t_mb, -1)
    pad = (int((ws[:, :, n:] != 0).sum()) + int((ws[f:rows[1], :, :n] != 0).sum())
           + int((ws[rows[3] + weights[2].shape[1]:rows[4], :, :n] != 0).sum()))
    if pad:
        raise AssertionError(f"P2 {variant} kernel A [{label}]: {pad} padded workspace entries "
                             f"are not zero")
    dw = fm_roofline.mm_dw(got)
    dw_p = fm_roofline.mm_dw_plain(got)
    torch.cuda.synchronize()
    rels = {name: float((g.double() - w.double()).norm() / w.double().norm())
            for name, g, w in zip(("dW1", "dW2", "dWp"), dw, dw_p)}
    worst_dw = max(rels, key=rels.get)
    if rels[worst_dw] > K1_DW_REL:
        raise AssertionError(f"P2 kernel B [{label}]: {worst_dw} relative L2 {rels[worst_dw]:.3e} "
                             f"> {K1_DW_REL}")
    print(f"phase 14 P2 {variant} kernel A vs mm_chain_plain [{label}], obs "
          f"{'x'.join(map(str, obs.shape))}: worst operand relative L2 {worst_rel:.3e} cos "
          f"{worst_cos:.8f}, padded rows and columns zero; kernel B vs mm_dw_plain on kernel A's "
          f"operands: worst {worst_dw} relative L2 {rels[worst_dw]:.3e} [{card}]")


def float64_line(label: str, got, plain, exact, names, card: str, phase: int,
                 ratio: float | None = None):
    """Print the worst leaf's distance from a float64 reference, of the
    kernel and of the plain version; with ``ratio``, raise if the kernel's
    is more than ``ratio`` times the plain version's."""
    dist = lambda g: max((float((a.double() - e.double()).norm() / e.double().norm()), k)
                         for k, a, e in zip(names, g, exact))
    kd, pd = dist(got), dist(plain)
    if ratio is not None and kd[0] > ratio * pd[0]:
        raise AssertionError(f"{label} {kd[0]:.3e} ({kd[1]}) from float64, plain {pd[0]:.3e}: "
                             f"more than {ratio}x")
    held = "" if ratio is None else f", ratio {kd[0] / pd[0]:.3f} <= {ratio}"
    print(f"phase {phase} {label} vs a float64 plain version: kernel worst leaf {kd[0]:.3e} "
          f"({kd[1]}), plain {pd[0]:.3e} ({pd[1]}){held} [{card}]")


def probe_p2(card: str):
    """P2 on the card at the JAX probe's size: both variants vs plain (and
    ragged), each stage vs its plain version, the distance from float64, the
    rounding lengths of kernel B, the chunk sizes, the times of kernel,
    kernels A and B, plain, K1 bf16 on the same inputs and the eight
    torch.matmul calls, and the tool's main with the counts from 0.  Returns
    (err, ms of mm_grads' default variant, phased, plain_ms, bound, launches,
    library_ms)."""
    obs, W1, W2, Wp = fm_roofline.make_inputs(*P2_FULL, 0, "cuda")
    weights = (W1, W2, Wp)
    names = ("dW1", "dW2", "dWp")
    plain = lambda: fm_roofline.mm_grads_plain(obs, *weights)
    err, ms = 0.0, {}
    ragged = fm_roofline.make_inputs(*P3_RAGGED, 3, "cuda")
    for variant in fm_roofline.VARIANTS:
        phased = variant == "phased"
        kernel = lambda: fm_roofline.mm_grads(obs, *weights, phased=phased)
        err = max(err, hold_leaves(f"mm_grads {variant} [T=32 N=131072]", names, kernel, plain,
                                   card, 14)[2])
        err = max(err, hold_leaves(f"mm_grads {variant} [ragged T=3 N=1000]", names,
                                   lambda: fm_roofline.mm_grads(*ragged, phased=phased),
                                   lambda: fm_roofline.mm_grads_plain(*ragged), card, 14)[2])
        hold_p2_split("T=32 N=131072", obs, weights, phased, card)
        hold_p2_split("ragged T=3 N=1000", ragged[0], ragged[1:], phased, card)
        ms[variant] = time_grads(f"mm_grads {variant}", kernel, plain, (), {}, card, 14)
    # From here on mm_grads' default variant, phased: the kernels line's.
    float64_line("mm_grads", fm_roofline.mm_grads(obs, *weights), plain(),
                 fm_roofline.mm_grads_float64(obs, *weights), names, card, 14, P2_F64_RATIO)
    table = fm_roofline.rounding_table(obs, *weights)
    chunks = {c: min(cuda_ms(lambda: fm_roofline._launch(obs, *weights, True, chunk_cols=c), 3)
                     for _ in range(2))
              for c in (16384, 131072)}
    t_mb, f, n = obs.shape
    widths = fm_roofline._widths(f, *HIDDEN, fm_roofline.A)
    chunk = fm_roofline._chunk(t_mb, n, fm_roofline.CHUNK_COLS)
    ws = fm_roofline._workspace(widths, chunk, obs.device)
    padded = fm_roofline._padded(*weights, *widths)
    stage = lambda st, rlen=fm_roofline.RLEN: min(
        cuda_ms(lambda: fm_roofline._call(obs, padded, widths, phased=True, chunk=chunk, ws=ws,
                                          stages=st, rlen=rlen), 3) for _ in range(2))
    stage_ms = {st: stage(st) for st in (1, 2)}
    rows = {k: [float(f"{d:.3e}") for d in v] + ([round(stage(2, k), 3)] if k >= 0 else [])
            for k, v in table.items()}
    del ws
    print(f"phase 14 P2 kernel B's rounding lengths (slices of 64 columns a fresh accumulation; "
          f"0: a block's whole range; -1: the plain versions): [kernel B on kernel A's operands, "
          f"the call; worst dW relative L2 from float64], kernel B's ms over the wrapper's chunks: "
          f"{json.dumps(rows)}; the wrapper's {fm_roofline.RLEN} [{card}]")
    k1_args = fm_roofline.k1_inputs(obs, *weights, 1)
    k1_ms = min(cuda_ms(lambda: fused_ppo_grads_fm(*k1_args, **fm_roofline.K1_KW), 5)
                for _ in range(2))
    del k1_args
    x_all = obs.permute(1, 0, 2).reshape(obs.shape[1], -1)
    bw = [w.to(torch.bfloat16) for w in weights]
    mm_ms = min(cuda_ms(lambda: fm_roofline.matmul_sequence(x_all, *bw), 5) for _ in range(2))
    del x_all
    b = mm_bound(P2_FULL[0] * P2_FULL[1])
    floor_ms, nbytes = p2_split_floor(P2_FULL[0] * P2_FULL[1])
    kernel_ms, plain_ms = ms["phased"][0], min(v[1] for v in ms.values())
    print(f"phase 14 time P2 (fm_roofline.cu, wgmma + TMA): chain {ms['chain'][0]:.3f} ms, phased "
          f"{ms['phased'][0]:.3f} ms; phased: kernel A {stage_ms[1]:.3f} ms + kernel B "
          f"{stage_ms[2]:.3f} ms over chunks of {fm_roofline.CHUNK_COLS} columns (chunks of "
          f"16384: {chunks[16384]:.3f} ms, of 131072: {chunks[131072]:.3f} ms); 8 torch.matmul calls "
          f"{mm_ms:.3f} ms; K1 bf16 on the same obs and weights {k1_ms:.3f} ms; the design's floor "
          f"by bytes {floor_ms:.3f} ms ({nbytes / 1e9:.2f} GB), the function's bound {b[0]:.4f} ms "
          f"by {b[1]} [{card}]")
    zero_counts()
    if fm_roofline.main(["--steps", "2", "--iters", "2"]):
        raise AssertionError("fm_roofline main failed")
    launches = fm_roofline.mm_grads.launches
    by_kernel = fm_roofline.mm_grads.launches_by_kernel
    if not all(fm_roofline.mm_grads.launches_by_variant.values()) or not all(by_kernel.values()):
        raise AssertionError(f"fm_roofline main: launches {fm_roofline.mm_grads.launches_by_variant}"
                             f", kernels {by_kernel}")
    print(f"phase 14 fm_roofline main: mm_grads launches "
          f"{fm_roofline.mm_grads.launches_by_variant}, kernels {by_kernel} [{card}]")
    return err, kernel_ms, plain_ms, b, launches, mm_ms


def clip_branches(args, h2):
    """The clip's branch of every column, (T, N) int8, from an h2 (H2, T, N)
    bf16 with the plain version's ops: 2 where the unclipped term is the
    smaller, plus 1 where the ratio lies inside the clip range; and (T, N)
    bool, the columns whose ratio lies within CLIP_EDGE of an edge."""
    params, _, action, lpold, _, adv = args[:6]
    wp, bp = params[4].to(torch.bfloat16).float(), params[5].float()
    clip = fm_kernel_probe.CLIP
    code = torch.empty(action.shape, dtype=torch.int8, device=action.device)
    near = torch.empty(action.shape, dtype=torch.bool, device=action.device)
    for t in range(action.shape[0]):
        logits = torch.matmul(wp.t(), h2[:, t].float()) + bp[:, None]
        lp = torch.log_softmax(logits, 0).gather(0, action[t][None].long())[0]
        ratio = torch.exp(lp - lpold[t])
        unclipped = ratio * adv[t] <= torch.clamp(ratio, 1 - clip, 1 + clip) * adv[t]
        inside = (ratio > 1 - clip) & (ratio < 1 + clip)
        code[t] = 2 * unclipped.to(torch.int8) + inside.to(torch.int8)
        near[t] = ((ratio - (1 - clip)).abs() < CLIP_EDGE) | ((ratio - (1 + clip)).abs() < CLIP_EDGE)
    return code, near


def hold_p3_split(label: str, args, card: str):
    """P3's two kernels, each against its plain version on the card: kernel A
    (``p3_chain``, the whole minibatch) against ``p3_chain_plain``: the
    operands within BF16_TOL's relative L2 and cos on every column but those
    where the two sides' clip branches may differ (``clip_branches``: a bf16
    flip in h2 moves a column's ratio by up to ~1e-3), the bias grads, dWv and the loss
    sums (as means) within BF16_TOL, the workspace's dheads and dpre rows zero
    past column N; then kernel B (``p3_dw``) on kernel A's own operands against
    ``k1_dw_plain`` on them, each dW within K1_DW_REL.  Raises on the first
    miss."""
    loss_rtol, rel_l2, min_cos = BF16_TOL
    got = fm_kernel_probe.p3_chain(*args)
    want = fm_kernel_probe.p3_chain_plain(*args)
    torch.cuda.synchronize()
    (code_k, near_k), (code_p, near_p) = clip_branches(args, got.hs[1]), clip_branches(args, want.hs[1])
    keep = (code_k == code_p) & ~near_k & ~near_p
    vec = lambda v: v[:, None, None]
    pairs = [("h1", got.hs[0], want.hs[0], keep), ("h2", got.hs[1], want.hs[1], keep),
             ("dheads", got.dheads, want.dheads, keep), ("dpre1", got.dpres[0], want.dpres[0], keep),
             ("dpre2", got.dpres[1], want.dpres[1], keep),
             *[(k, vec(g), vec(w), None) for k, g, w in (
                 ("db1", got.db[0], want.db[0]), ("db2", got.db[1], want.db[1]),
                 ("dbp", got.dbp, want.dbp), ("dbv", got.dbv, want.dbv), ("dWv", got.dwv, want.dwv))]]
    worst_rel, worst_cos = 0.0, 1.0
    for name, g, w, k in pairs:
        rel, cos = operand_distance(g, w, k)
        if not (rel <= rel_l2 and cos >= min_cos):
            raise AssertionError(f"P3 kernel A [{label}]: {name} relative L2 {rel:.3e}, cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    inv_m = 1.0 / args[2].numel()
    if not torch.allclose(got.sums * inv_m, want.sums * inv_m, rtol=loss_rtol, atol=LOSS_ATOL):
        raise AssertionError(f"P3 kernel A [{label}]: loss sums {got.sums.tolist()} vs plain "
                             f"{want.sums.tolist()}")
    dheads_all = operand_distance(got.dheads, want.dheads)[0]
    del want
    t_mb, _, n = args[1].shape
    row_dh = fused_update._ws_rows([h.shape[0] for h in got.hs])[1]
    ws = fm_kernel_probe.p3_chain.workspace.view(-1, t_mb, fused_update._npad(n))
    pad = int((ws[row_dh:, :, n:] != 0).sum())
    if pad:
        raise AssertionError(f"P3 kernel A [{label}]: {pad} dheads / dpre entries past N not zero")
    dw, dwp = fm_kernel_probe.p3_dw(args[0], got, args[1])
    dw_p, dwp_p = fused_update.k1_dw_plain(got, args[1])
    torch.cuda.synchronize()
    rels = {name: float((g.double() - w.double()).norm() / w.double().norm())
            for name, g, w in (("dW1", dw[0], dw_p[0]), ("dW2", dw[1], dw_p[1]), ("dWp", dwp, dwp_p))}
    worst_dw = max(rels, key=rels.get)
    if rels[worst_dw] > K1_DW_REL:
        raise AssertionError(f"P3 kernel B [{label}]: {worst_dw} relative L2 {rels[worst_dw]:.3e} "
                             f"> {K1_DW_REL}")
    print(f"phase 15 P3 kernel A vs p3_chain_plain [{label}], obs {'x'.join(map(str, args[1].shape))}: "
          f"worst operand / bias grad / dWv relative L2 {worst_rel:.3e} cos {worst_cos:.8f} "
          f"({int((~keep).sum())} columns whose clip branch may differ left out of the operands, "
          f"{int((code_k != code_p).sum())} whose branch differs; dheads over every column "
          f"{dheads_all:.3e}), loss sums "
          f"{got.sums.tolist()}, dheads / dpre zero past N; kernel B vs k1_dw_plain on kernel A's "
          f"operands: worst {worst_dw} relative L2 {rels[worst_dw]:.3e} [{card}]")


def probe_p3(card: str):
    """P3 on the card: kernel vs plain at the JAX probe's size and ragged,
    losses within BF16_TOL's rtol, grads as phase 14 plus the value path,
    each stage vs its plain version, the distance from float64, the times
    of the call and of kernels A and B, and the tool's main (check and Adam
    bench) with the counts from 0.  Returns (err, ms, plain_ms, bound,
    launches)."""
    names = fm_kernel_probe.LABELS
    err, timed = 0.0, None
    for label, size, seed in (("T=32 N=131072", P2_FULL, 1), ("ragged T=3 N=1000", P3_RAGGED, 2)):
        args = fm_kernel_probe.make_inputs(*size, seed, "cuda")
        kernel = lambda: fm_kernel_probe.fm_grads(*args)
        plain = lambda: fm_kernel_probe.fm_grads_plain(*args)
        got, want, e = hold_leaves(f"fm_grads [{label}]", names, kernel, plain, card, 15,
                                   value_path=P3_VALUE_PATH)
        if not torch.allclose(got[8], want[8], rtol=BF16_TOL[0], atol=LOSS_ATOL):
            raise AssertionError(f"fm_grads [{label}]: loss sums {got[8].tolist()} vs plain "
                                 f"{want[8].tolist()}")
        # The loss sums as means (K1's entries compare means).
        err = max(err, e, float((got[8] - want[8]).abs().max()) / (size[0] * size[1]))
        hold_p3_split(label, args, card)
        if timed is None:
            float64_line("fm_grads", got, want, fm_kernel_probe.fm_grads_float64(*args), names,
                         card, 15)
            timed = time_grads(f"fm_grads {label}", kernel, plain, (), {}, card, 15)
            t_mb, _, n = args[1].shape
            chunk = fused_update.chunk_frames(t_mb, n)
            ws = fm_kernel_probe._workspace(args[0], args[1], chunk)
            stage_ms = {st: min(cuda_ms(lambda: fm_kernel_probe._call(
                args[0], args[1], args[2], args[3:], ws, chunk, st), 3) for _ in range(2))
                for st in (fused_update.STAGE_CHAIN, fused_update.STAGE_DW)}
            del ws
            floor_ms, nbytes = k1_split_floor(t_mb * n)
            b = grad_bound(t_mb * n)
            print(f"phase 15 time P3 split (fm_kernel_probe.cu, kernel A in k1_split.cuh's CHAIN_P3 "
                  f"mode) T={t_mb} N={n}: call {timed[0]:.3f} ms = kernel A "
                  f"{stage_ms[fused_update.STAGE_CHAIN]:.3f} ms + kernel B "
                  f"{stage_ms[fused_update.STAGE_DW]:.3f} ms over chunks of {chunk} frame(s); the "
                  f"design's floor by bytes {floor_ms:.3f} ms ({nbytes / 1e9:.2f} GB), the "
                  f"function's bound {b[0]:.3f} ms by {b[1]} [{card}]")
        del args, got, want
    zero_counts()
    if fm_kernel_probe.main(["--frames", "8", "--steps", "4", "--iters", "2"]):
        raise AssertionError("fm_kernel_probe main: the check against autograd failed")
    launches = fm_kernel_probe.fm_grads.launches
    by_kernel = fm_kernel_probe.fm_grads.launches_by_kernel
    if launches == 0 or not all(by_kernel.values()):
        raise AssertionError(f"fm_kernel_probe main: fm_grads launches {launches}, kernels "
                             f"{by_kernel}")
    print(f"phase 15 fm_kernel_probe main: fm_grads launches {launches}, kernels {by_kernel} "
          f"[{card}]")
    return (err, *timed, grad_bound(P2_FULL[0] * P2_FULL[1]), launches)


# The trainer's user surface (phases 16-18).
# The CLI's wrappers at full width: SimplifyAction over RewardByBallPosition,
# K1 bf16 (auto), hidden (256, 256), 16 K1 calls an update.
SHAPING = ("0.5", "-0.25", "0.125", "0", "0", "0.125", "-0.25", "0.5")
WRAPPED_ARGV = ["--device", "cuda", "--num-envs", "65536", "--rollout-length", "128",
                "--simplify-actions", "--ball-shaping", *SHAPING, "--seed", "0"]
WRAPPED_UPDATES = 3   # run A uninterrupted; run B 2, killed, then resumed for 1
# tests/test_trained_artifact.py:31-37, the JAX gate of the vs-AI policy.
EVAL_GATE = dict(num_envs=16, max_frames=8000, winning_score=5, greedy=False, seed=3)
EVAL_WIN_RATE, EVAL_GAMES = 0.9, 8
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden_trajectory.npz"


def named_tensors(tree, prefix=""):
    """(name, tensor) of a runner's leaves, a generator as its state, an int
    as a tensor."""
    if isinstance(tree, torch.Generator):
        yield prefix + "key", tree.get_state()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_tensors(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, tuple):
        for f, sub in zip(tree._fields, tree):
            yield from named_tensors(sub, f"{prefix}{f}.")
    else:
        yield prefix.rstrip("."), torch.as_tensor(tree)


def runners_differ(a, b) -> list:
    """The leaves of two runners that are not bit-equal (dtype, shape, value)."""
    return [name for (name, x), (_, y) in zip(named_tensors(a), named_tensors(b), strict=True)
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x.cpu(), y.cpu())]


def k1_counts() -> dict:
    return {"by_mode": dict(fused_ppo_grads_fm.launches_by_mode),
            "by_kernel": dict(fused_ppo_grads_fm.launches_by_kernel),
            "fused_ppo_grads": fused_ppo_grads.launches,
            "landing_sims_batched": predict_cuda.landing_sims_batched.launches,
            "fused_rollout": fused_rollout.launches,
            "learner_step": learner_step.launches}


def wrapped_training(card: str):
    """Phase 16: the CLI's ``main`` through the wrappers at B=65536, run A
    uninterrupted and run B stopped after a checkpoint and resumed by a
    second ``main``; the two final runners bit-equal, K1 bf16 launched 16
    times an update (A and B once a chunk) and the learner step once a frame
    through the wrappers in each, nothing else; the
    checkpoint's save and restore timed at this width."""
    cfg = dataclasses.replace(LEARNER, num_actions=13)
    calls = WRAPPED_UPDATES * cfg.update_epochs * cfg.num_minibatches
    chunks = WRAPPED_UPDATES * k1_chunks(cfg)
    want = {"by_mode": {"none": calls}, "by_kernel": {chain_key(cfg): chunks, "bf16_dw": chunks},
            "fused_ppo_grads": 0, "landing_sims_batched": 0, "fused_rollout": 0,
            "learner_step": WRAPPED_UPDATES * cfg.rollout_length}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        runs, counts = {}, {}
        for run, steps in (("A", [(WRAPPED_UPDATES, WRAPPED_UPDATES)]),
                           ("B", [(WRAPPED_UPDATES - 1, WRAPPED_UPDATES - 1), (1, 1)])):
            zero_counts()
            t0 = time.perf_counter()
            for i, (updates, every) in enumerate(steps):
                if i:
                    # The second main call starts from the checkpoint alone.
                    restorable = checkpoint.latest_restorable(os.path.join(tmp, run, "latest"))
                    if restorable is None:
                        raise AssertionError(f"phase 16 run {run}: no checkpoint to resume")
                runs[run] = train_run.main(WRAPPED_ARGV + [
                    "--updates", str(updates), "--checkpoint-dir", os.path.join(tmp, run),
                    "--checkpoint-every", str(every)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts[run] = k1_counts()
            got = {k: ({m: n for m, n in v.items() if n} if isinstance(v, dict) else v)
                   for k, v in counts[run].items()}
            if got != want:
                raise AssertionError(f"phase 16 run {run}: launches {got}, want {want}")
            print(f"phase 16 wrapped CLI run {run}: {' + '.join(str(u) for u, _ in steps)} "
                  f"update(s) at B={cfg.num_envs} in {seconds:.3f} s, launches {got} [{card}]")
        a, b = runs["A"], runs["B"]
        if a.update_index != WRAPPED_UPDATES or b.update_index != WRAPPED_UPDATES:
            raise AssertionError(f"phase 16: update index {a.update_index} / {b.update_index}")
        if a.params["layers.2.kernel"].shape[1] != 13:
            raise AssertionError("phase 16: the policy head is not SimplifyAction's 13 actions")
        differ = runners_differ(a, b)
        if differ:
            raise AssertionError(f"phase 16: the resumed run differs from the uninterrupted "
                                 f"one in {differ}")
        path = os.path.join(tmp, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, a)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.restore(path, b)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if runners_differ(a, back) or back.env_state.scores.device.type != "cuda":
            raise AssertionError("phase 16: a restored checkpoint differs or left the card")
        size = os.path.getsize(path)
    n = sum(1 for _ in named_tensors(a))
    print(f"phase 16 resume: run B (2 updates, checkpoint, a second main for 1) == run A "
          f"(3 updates) on all {n} leaves, bit for bit; checkpoint at B={cfg.num_envs}: save "
          f"{save_s:.3f} s, restore {restore_s:.3f} s, {size} bytes [{card}]")


def evaluate_policy(card: str):
    """Phase 17: the committed vs-AI policy against the rule AI at the JAX
    gate's settings, sampled: at least 8 games, win rate above 0.9, one K2
    launch a frame and no other kernel; ms a frame."""
    net = load_policy(policy_path("vs_ai_policy"), device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    r = evaluate_vs_computer(net, device="cuda", **EVAL_GATE)
    games, wins, rate = int(r.games), int(r.policy_wins), float(r.win_rate)
    seconds = time.perf_counter() - t0
    got = k1_counts()
    frames = EVAL_GATE["max_frames"]
    if (got["landing_sims_batched"] != frames or got["fused_rollout"] or got["fused_ppo_grads"]
            or got["learner_step"] or any(got["by_mode"].values())):
        raise AssertionError(f"phase 17: launches {got}, want {frames} landing launches only")
    if games < EVAL_GAMES or not rate > EVAL_WIN_RATE:
        raise AssertionError(f"phase 17: vs_ai_policy won {wins}/{games} ({rate:.4f}); the "
                             f"gate is > {EVAL_WIN_RATE} over >= {EVAL_GAMES} games")
    print(f"phase 17 vs_ai_policy.pt vs rule AI ({EVAL_GATE}): {wins}/{games} = {rate:.4f} "
          f"(gate > {EVAL_WIN_RATE}), mean score diff {float(r.mean_score_diff):+.4f}; "
          f"{frames} frames in {seconds:.3f} s = {seconds * 1e3 / frames:.3f} ms a frame; "
          f"landing_sims_batched {got['landing_sims_batched']} launches [{card}]")


def golden_on_card(card: str):
    """Phase 18: tests/test_golden_trajectory.py's recording replayed on the
    card (B=4, AI seats, serve random, key 2026, actions from
    default_rng(816)): observations, rewards, final scores and draw
    counters bit-equal; one K2 launch a frame."""
    data = np.load(GOLDEN)
    env = PikaZoo(EnvConfig(auto_reset=True, winning_score=3, serve="random",
                            is_player1_computer=True, is_player2_computer=True))
    frames, batch = data["obs"].shape[:2]
    state, _ = env.reset_batch(2026, batch, device="cuda")
    rng = np.random.default_rng(816)
    zero_counts()
    obs, rewards = [], []
    for _ in range(frames):
        actions = torch.from_numpy(rng.integers(0, 18, size=(batch, 2)).astype(np.int32))
        state, ts = env.step_batch(state, actions.cuda())
        obs.append(ts.obs)
        rewards.append(ts.rewards)
    launches = predict_cuda.landing_sims_batched.launches
    for name, got in (("obs", torch.stack(obs)), ("rewards", torch.stack(rewards)),
                      ("final_scores", state.scores), ("final_draws", state.draw_counter)):
        bad = np.argwhere(got.cpu().numpy() != data[name])
        if len(bad):
            raise AssertionError(f"phase 18 golden trajectory: {name} diverged at "
                                 f"{bad[0].tolist()}")
    if launches != frames:
        raise AssertionError(f"phase 18: {launches} landing launches in {frames} frames")
    print(f"phase 18 golden trajectory: B={batch} x {frames} frames on the card bit-equal to "
          f"tests/golden_trajectory.npz (obs, rewards, final scores and draws); "
          f"{launches} landing launches [{card}]")


# Phase 19: the PettingZoo drop-in.  The seed's AI-vs-AI game to 2 ends at
# step 404 of its first episode (the port's native engine on a CPU), so the
# run crosses an episode end and the reset that carries its state.
PZ_KW = dict(seed=37, winning_score=2, is_player1_computer=True, is_player2_computer=True,
             render_mode="rgb_array")
PZ_STEPS, PZ_FRAME_EVERY = 1000, 100
PZ_BACKENDS = {"card": dict(), "CPU": dict(device="cpu"), "native": dict(backend="native")}
ORACLE_CAP = 1024


def drive_adapter(env, actions):
    """PZ_STEPS steps of one adapter, resetting at each episode end: (what
    it returned, as host values; frames every PZ_FRAME_EVERY steps; episode
    ends; seconds in ``step`` calls)."""
    record, frames, ends, seconds = [env.reset()[0]], [env.render()], 0, 0.0
    for t in range(PZ_STEPS):
        if not env.agents:
            ends += 1
            record.append(env.reset()[0])
        acts = {a: int(actions[t, i]) for i, a in enumerate(env.agents)}
        t0 = time.perf_counter()
        obs, rew, term, trunc, infos = env.step(acts)
        seconds += time.perf_counter() - t0
        record.append((obs, rew, term, trunc,
                       {a: list(info["score"]) for a, info in infos.items()}))
        if t % PZ_FRAME_EVERY == PZ_FRAME_EVERY - 1:
            frames.append(env.render())
    return record, frames, ends, seconds


def same_records(a, b) -> bool:
    """Two adapters' returns equal, arrays by value, dicts key by key."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_records(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_records(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def pettingzoo_drop_in(card: str):
    """Phase 19 (a): ``pikazoo_v0.env`` on the card, on the CPU and on the
    native engine, the same seed and actions: every return equal step by
    step, through an episode end and its carried reset; the rgb_array frames
    equal every PZ_FRAME_EVERY steps; one K2 launch a step on the card."""
    actions = np.random.default_rng(19).integers(0, 18, (PZ_STEPS, 2))
    runs = {}
    for name, kw in PZ_BACKENDS.items():
        env = pikazoo_v0.env(**PZ_KW, **kw)
        predict_cuda.landing_sims_batched.launches = 0
        runs[name] = drive_adapter(env, actions)
        launches = predict_cuda.landing_sims_batched.launches
        env.close()
        want = PZ_STEPS if name == "card" else 0
        if launches != want:
            raise AssertionError(f"phase 19 [{name}]: {launches} landing launches in "
                                 f"{PZ_STEPS} steps, expected {want}")
    record, frames, ends, _ = runs["card"]
    if ends < 1:
        raise AssertionError(f"phase 19: no episode ended in {PZ_STEPS} steps")
    for name in ("CPU", "native"):
        other = runs[name]
        for i, (a, b) in enumerate(zip(record, other[0], strict=True)):
            if not same_records(a, b):
                raise AssertionError(f"phase 19: card != {name} at record {i}")
        for i, (a, b) in enumerate(zip(frames, other[1], strict=True)):
            if not np.array_equal(a, b):
                raise AssertionError(f"phase 19: card frame {i} != {name} frame")
    times = ", ".join(f"{name} {run[3] * 1e3 / PZ_STEPS:.3f}" for name, run in runs.items())
    print(f"phase 19 PettingZoo drop-in: pikazoo_v0.env AI vs AI to 2, {PZ_STEPS} steps, "
          f"{ends} episode end(s) and carried reset(s); card, CPU and native equal on every "
          f"return, {len(frames)} rgb_array frames equal; {PZ_STEPS} landing launches on the "
          f"card, one a step; ms a step (batch 1): {times} [{card}]")


def oracle_card_vs_cpu(card: str):
    """Phase 19 (b): the oracle draw mode, both seats the rule AI, B =
    PARITY_BATCH x PARITY_FRAMES, a synthetic (B, ORACLE_CAP) oracle: every
    leaf and the draw counter equal on the card and the CPU, frame by frame."""
    env = PikaZoo(EnvConfig(winning_score=3, auto_reset=False, is_player1_computer=True,
                            is_player2_computer=True))
    gen = np.random.default_rng(20)
    oracle = torch.from_numpy(gen.integers(0, 2, (PARITY_BATCH, ORACLE_CAP)).astype(np.int32))
    actions = torch.from_numpy(gen.integers(0, 18, (PARITY_FRAMES, PARITY_BATCH, 2))
                               .astype(np.int32))
    keys = batch_keys(20, PARITY_BATCH, "cpu")
    on_cpu = env._reset_from_keys(keys, oracle=oracle)
    oracle_card = oracle.cuda()
    on_card = env._reset_from_keys(keys.cuda(), oracle=oracle_card)
    flat = lambda out: torch.cat([leaf.reshape(-1) for leaf in leaves(out)])
    for t in range(-1, PARITY_FRAMES):
        if t >= 0:
            on_card = env.step(on_card[0], actions[t].cuda(), oracle_card)
            on_cpu = env.step(on_cpu[0], actions[t], oracle)
        if not torch.equal(flat(on_card).cpu(), flat(on_cpu)):  # one copy a frame
            bad = [i for i, (g, c) in enumerate(zip(leaves(on_card), leaves(on_cpu)))
                   if not torch.equal(g.cpu(), c)]
            raise AssertionError(f"phase 19 oracle mode: card != CPU at frame {t}, leaves {bad}")
    draws = on_cpu[0].draw_counter
    print(f"phase 19 oracle mode card vs CPU: AI vs AI, B={PARITY_BATCH} x {PARITY_FRAMES} "
          f"frames, a ({PARITY_BATCH}, {ORACLE_CAP}) oracle, every EnvState leaf and TimeStep "
          f"field equal on every frame; draws read an env {int(draws.min())}-"
          f"{int(draws.max())} [{card}]")


# Phase 20: K2's landing-loop algorithms.  The modes held (algo, split): every
# loop, the two mixes, each with one candidate loop and with the ydir split.
K2_ALGOS = ("iter", "leap", "hyb", "leap,iter", "iter,leap")
K2_SPLITS = ("none", "ydir")
# Integer operations of one leap jump on the common path (a lane outside the
# net band), counted from the plain version (core/predict.py::make_leap_step)
# and kept as the bound's measure of the leap's work: the wall span
# (compares, selects, subtractions, one division), the band-entry span (one
# division), the ground/ceiling distance and its k_disp (the float seed:
# conversions, a product, sqrt, each one operation; the two integer checks
# of the displacement, four each), the cap and the three minima, then the
# jump's four updates.  A lane in the band runs two k_disp more.
LEAP_JUMP_OPS = 68
# The default unroll of the hybrid loop (exact iterations after a jump).
HYB_UNROLL = predict.HYB_UNROLL


def leap_corpus(device, n: int = 20_000):
    """tests/test_leap_sim.py's state corpus, numpy-seeded: the boxes, the
    net band's boundary lattice and the |vy| <= 2000 cap box."""
    rng = np.random.default_rng(0)

    def box(m, xlo, xhi, ylo, yhi, vlo, vhi, wlo, whi):
        return (rng.integers(xlo, xhi, m), rng.integers(ylo, yhi, m),
                rng.integers(vlo, vhi, m), rng.integers(wlo, whi, m))

    cases = [box(n, 0, 453, -300, 253, -64, 65, -128, 129),
             box(n, 180, 253, 150, 253, -6, 7, -12, 13),
             box(n // 2, 0, 45, -50, 253, -30, 31, -40, 41),
             box(n // 2, 408, 453, -50, 253, -30, 31, -40, 41),
             box(n // 2, 0, 453, 230, 260, -20, 21, -30, 31),
             box(n // 2, 0, 453, -10, 15, -20, 21, -30, 31),
             box(n // 4, 0, 453, -10_000, 253, -64, 65, -2000, 2001)]
    xs = np.tile(np.array([191, 192, 193, 215, 216, 217, 239, 240, 241]), 500)
    cases.append((xs, rng.integers(170, 200, xs.size), rng.integers(-4, 5, xs.size),
                  rng.integers(-8, 9, xs.size)))
    return tuple(torch.tensor(np.concatenate([c[i] for c in cases]), dtype=torch.int32,
                              device=device) for i in range(4))


def lane_work(x, y, vx, vy, full_rule: bool, algo: str):
    """A counting pass of the plain primitives (``predict.make_leap_step``)
    as one card thread runs each lane under ``algo``: per lane, the trips of
    its loop (a frame loop's trip is an iteration, a leap's a jump and an
    iteration, a hybrid's a jump and up to HYB_UNROLL iterations), its jumps
    and its exact iterations, int64."""
    one_leap, jump, exact = predict.make_leap_step(full_rule)
    carry = predict.leap_carry(x, y, vx, vy)
    trips, jumps, iters = (torch.zeros(x.shape, dtype=torch.int64, device=x.device)
                           for _ in range(3))
    while bool((carry[2] != 0).any()):
        live = carry[2] != 0
        trips += live
        if algo == "iter":
            iters += live
            carry = exact(carry)
        elif algo == "leap":
            jumps += live
            iters += live
            carry = one_leap(carry)
        else:
            jumps += live
            carry = jump(carry)
            for _ in range(HYB_UNROLL):
                iters += carry[2] != 0
                carry = exact(carry)
    return trips, jumps, iters


def warp_trips(trips: torch.Tensor):
    """(mean, largest) over K2's warps of their longest lane's trips: each
    warp holds 32 consecutive envs of one lane kind."""
    per_warp = torch.nn.functional.pad(trips, (0, -trips.numel() % 32)).reshape(-1, 32)
    worst = per_warp.max(dim=1).values.double()
    return float(worst.mean()), int(worst.max())


def mode_work(balls, algo: str):
    """K2's work in mode ``algo`` on ``balls``: the true ball's and the
    candidates' warp trips (mean, largest), and the bound's operations."""
    algo_true, algo_cand = predict.parse_algo(algo)
    x, y, vx, vy = balls
    lane = torch.arange(6, dtype=torch.int32, device=x.device)[:, None]
    cvx, cvy = predict.candidate_velocities(x, vy, lane)
    shape = cvx.shape
    true = lane_work(x, y, vx, vy, True, algo_true)
    cand = lane_work(x.expand(shape).reshape(-1), y.expand(shape).reshape(-1),
                     cvx.reshape(-1), cvy.reshape(-1), False, algo_cand)
    ops = sum(int(w[1].sum()) * LEAP_JUMP_OPS + int(w[2].sum()) * LANDING_ITERATION_OPS
              for w in (true, cand))
    cand_warps = [warp_trips(t) for t in cand[0].reshape(6, -1)]
    return (warp_trips(true[0]),
            (float(np.mean([m for m, _ in cand_warps])), max(w for _, w in cand_warps)), ops)


def k2_modes(live, card: str):
    """Phase 20: K2 in every mode bit-equal to its plain version and to K2
    iter on random, net-trap, live and corpus states; then, on the live
    states, each mode's time (stream held, interleaved with iter), the warps'
    trips and the mode's bound.  Returns {mode: (launches, err, ms, plain_ms,
    bound)} for the kernels line's leap and hyb entries."""
    device = live[0].device
    cases = {"random states": random_ball_states(AI_BATCH, 3, device),
             "net-trap cases": tuple(torch.tensor(c, device=device)
                                     for c in NET_TRAP_CASES.T.copy()),
             f"AI self-play frame {HARVEST_FRAME}": live,
             "the leap corpus (boxes, band lattice, cap box)": leap_corpus(device)}
    for name, balls in cases.items():
        base = predict_cuda.landing_sims_batched(*balls)
        for algo in K2_ALGOS:
            for split in K2_SPLITS:
                got = predict_cuda.landing_sims_batched(*balls, algo=algo, split=split)
                want_e, want_c = landing_sims_any(*balls, algo=algo, split=split)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want_e) and torch.equal(got[1], want_c.t())):
                    raise AssertionError(f"phase 20 K2 {algo}/{split} != its plain version "
                                         f"on {name}")
                if not (torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])):
                    raise AssertionError(f"phase 20 K2 {algo}/{split} != K2 iter on {name}")
        print(f"phase 20 K2 modes [{name}]: n={balls[0].numel()}, algo {K2_ALGOS} x split "
              f"{K2_SPLITS} each bit-equal to its plain version and to K2 iter [{card}]")
    # What one jump costs in instructions: cuobjdump -sass of a kernel that
    # runs one leap_jump from csrc/landing_sim.cuh, less the same kernel's
    # loads and stores alone.
    for rule, (count, by_class) in k2_leap_probe.jump_sass(_build.CSRC_DIR).items():
        print(f"phase 20 SASS of one jump ({rule} rule): {count} instructions "
              f"(tools/k2_leap_probe.py's one_jump less no_jump); {by_class} [{card}]")
    out = {}
    iter_call = lambda: predict_cuda.landing_sims_batched(*live)
    iter_call()
    for algo in K2_ALGOS:
        call = lambda: predict_cuda.landing_sims_batched(*live, algo=algo)
        plain = lambda: landing_sims_any(*live, algo=algo)
        call(), plain()
        predict_cuda.zero_counts()
        i1, k1, k2, i2 = (cuda_ms(iter_call, 50, hold=True), cuda_ms(call, 50, hold=True),
                          cuda_ms(call, 50, hold=True), cuda_ms(iter_call, 50, hold=True))
        launches = predict_cuda.landing_sims_batched.launches_by_algo[algo]
        plain_ms = cuda_ms(plain, 2)
        (tm, tw), (cm, cw), ops = mode_work(live, algo)
        b = bound(11 * 4 * AI_BATCH, {"int32": ops})
        out[algo] = (launches, 0, min(k1, k2), plain_ms, b)
        print(f"phase 20 time K2 {algo} B={AI_BATCH} frame-{HARVEST_FRAME} states: {k1:.4f} / "
              f"{k2:.4f} ms (stream held), K2 iter {i1:.4f} / {i2:.4f} ms in turns; plain "
              f"{plain_ms:.3f} ms; warps' trips: true ball mean {tm:.2f} largest {tw}, "
              f"candidates mean {cm:.2f} largest {cw}; bound {b[0]:.5f} ms by {b[1]} ({ops} "
              f"operations: jumps x {LEAP_JUMP_OPS} + iterations x {LANDING_ITERATION_OPS}); "
              f"{launches} launches [{card}]")
    return out


# Phase 21: the meshed trainer at the learner's width, 2 updates.
MESH_UPDATES = 2
MESH_ENV = EnvConfig(auto_reset=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def first_minibatch_grads(runner, train_step, cfg: PPOConfig):
    """The first minibatch's gradient of ``runner``'s next update, driven
    through the trainer's phases (the generator copied, not advanced)."""
    key = torch.Generator(device=runner.key.device)
    key.set_state(runner.key.get_state())
    (_, last_norm), traj = train_step.rollout_fn(runner.params, runner.env_state,
                                                 runner.last_obs, train_step.uniforms_fn(key))
    _, last_value = apply_fm(runner.params, last_norm, cfg.activation)
    adv, targets = ppo.gae_associative(traj.value, traj.reward, traj.done, last_value,
                                       cfg.gamma, cfg.gae_lambda)
    t_mb = cfg.rollout_length // cfg.num_minibatches
    grads, _ = train_step.minibatch_grads_fn(
        runner.params, ppo.Transition(*[leaf[:t_mb] for leaf in traj]), adv[:t_mb],
        targets[:t_mb])
    return grads


def sampling_apart(params, train_step, cols: int, card: str):
    """The premise of bit-identical sampling on a mesh: the policy step gives
    a column the same action, log-prob and value whether it runs among
    ``cols`` columns or among half as many (cuBLAS picks a GEMM by shape)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    obs = (torch.rand((35, cols), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    u = torch.rand((1, cols), generator=gen, device="cuda")
    whole = train_step.policy_sample_fn(params, obs, u)
    half = cols // 2
    halves = [train_step.policy_sample_fn(params, obs[:, i:i + half].contiguous(),
                                          u[:, i:i + half]) for i in (0, half)]
    apart = [int((w != torch.cat([h[j] for h in halves])).sum()) for j, w in enumerate(whole)]
    if any(apart):
        raise AssertionError(f"phase 21: the policy step at {cols} vs {half} columns differs "
                             f"in {apart} (action, log-prob, value) columns")
    print(f"phase 21 the policy step at {cols} columns == at {half}, column for column "
          f"(actions, log-probs, values) [{card}]")


def mesh_run(cfg: PPOConfig, mesh, updates: int):
    """``updates`` updates of the trainer (on ``mesh``, or none) from seed 0:
    (final runner, metrics of each update, ms an update, the env state after
    the first update)."""
    init_fn, train_step, _ = make_ppo_trainer(PikaZoo(MESH_ENV), cfg, mesh=mesh)
    runner, metrics, ms, first = init_fn(0), [], [], None
    for _ in range(updates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, m = train_step(runner)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(torch.stack([x.float() for x in m[:7]]))
        first = runner.env_state if first is None else first
    return runner, torch.stack(metrics), ms, first

# Phase 22: the learner step's kernel (csrc/learner_step.cu) against its plain
# version, each seat mix at the learner's width, and once with a ragged
# batch; a few actions out of range (both sides clamp them).  A game to 2,
# or to 1 where both seats are the rule AI, so that games end in 300 frames.
LEARNER_STEP_FRAMES = 300
LEARNER_STEP_CASES = (
    ("human seats (self-play)", EnvConfig(winning_score=2), AI_BATCH),
    ("AI seat 1, serve random", EnvConfig(winning_score=2, serve="random",
                                          is_player1_computer=True), AI_BATCH),
    ("AI seat 2, serve alternate, no auto reset",
     EnvConfig(winning_score=2, serve="alternate", auto_reset=False,
               is_player2_computer=True), AI_BATCH),
    ("AI vs AI", EnvConfig(winning_score=1, is_player1_computer=True,
                           is_player2_computer=True), AI_BATCH),
    ("AI vs AI, serve random, ragged batch",
     EnvConfig(winning_score=1, serve="random", is_player1_computer=True,
               is_player2_computer=True), 1000),
)


def step_outputs(out) -> dict:
    """A learner step's outputs by name: every ``EnvState`` leaf, the
    observations, the rewards and ``terminated``."""
    state, obs, rewards, terminated = out
    return dict(named_tensors(state, "state."), obs=obs, rewards=rewards,
                terminated=terminated)


FLOAT_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers of its width; others as they are."""
    return t.view(FLOAT_BITS[t.dtype]) if t.dtype in FLOAT_BITS else t


def hold_learner_step(label: str, cfg: EnvConfig, batch: int, seed: int, card: str):
    """``LEARNER_STEP_FRAMES`` frames of the kernel beside the plain version
    from one reset, with the same random actions; raises at the first frame
    whose outputs are not bit-equal (the observations as int16, the rewards
    as int32 bits).  Returns the kernel's last state and the largest
    absolute difference of any output over the frames."""
    env = PikaZoo(cfg)
    plain_state, _ = env.reset_batch(seed, batch, device="cuda")
    state = plain_state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = learner_step.launches
    points = ends = 0
    err = 0.0
    for frame in range(LEARNER_STEP_FRAMES):
        a1, a2 = (torch.randint(-2, 20, (batch,), generator=gen, device="cuda",
                                dtype=torch.int32) for _ in range(2))
        want = env.step_batch_learner_fm_plain(plain_state, a1, a2)
        got = env.step_batch_learner_fm(state, a1, a2)
        w, g = step_outputs(want), step_outputs(got)
        gaps = torch.stack([(w[name].double() - g[name].double()).abs().max() for name in w])
        err = max(err, float(gaps.max()))
        differ = [name for name in w if not torch.equal(bits(w[name]), bits(g[name]))]
        if differ:
            raise AssertionError(f"phase 22 [{label}] frame {frame}: the kernel differs "
                                 f"from the plain version in {differ}, by up to {err}")
        plain_state, state = want[0], got[0]
        scored = want[2][:batch] != 0
        points += int(scored.sum())
        ends += int((scored & (want[3] == 1)).sum())
    launches = learner_step.launches - before
    if launches != LEARNER_STEP_FRAMES or points == 0 or ends == 0:
        raise AssertionError(f"phase 22 [{label}]: {launches} launches in "
                             f"{LEARNER_STEP_FRAMES} frames, {points} points, {ends} games ended")
    print(f"phase 22 kernel vs plain [{label}]: B={batch} x {LEARNER_STEP_FRAMES} frames "
          f"bit-equal (every EnvState leaf, observation bits, reward bits, terminated); "
          f"{points} points, {ends} games ended; {launches} launches; largest difference "
          f"{err} [{card}]")
    return state, err


def learner_step_bytes(batch: int) -> int:
    """The bytes one learner step must move: the 54 state rows read and
    written, two int32 actions read, 70 bf16 observations and 2 float32
    rewards written, an env."""
    return batch * (2 * 54 * 4 + 2 * 4 + 2 * 35 * 2 + 2 * 4)


def time_learner_step(label: str, cfg: EnvConfig, state: EnvState, card: str):
    """The kernel's ms a step (CUDA events over 30 launches, the stream held
    while the host queues them: 30 calls of up to ~800 us of host each fit in
    the hold's ~25 ms), the plain version's, the host's time a call, and the
    byte bound, from the live ``state``."""
    env = PikaZoo(cfg)
    batch = state.scores.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    a1, a2 = (torch.randint(0, 18, (batch,), generator=gen, device="cuda", dtype=torch.int32)
              for _ in range(2))
    kernel = lambda: env.step_batch_learner_fm(state, a1, a2)
    plain = lambda: env.step_batch_learner_fm_plain(state, a1, a2)
    kernel(), plain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        kernel()
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (cuda_ms(plain, 3), cuda_ms(kernel, 30, hold=True),
                      cuda_ms(kernel, 30, hold=True), cuda_ms(plain, 3))
    step_bound = bound(learner_step_bytes(batch), {})
    print(f"phase 22 time [{label}] B={batch}: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.3f} / {p2:.3f} ms; bound {step_bound[0]:.5f} ms by {step_bound[1]} "
          f"({learner_step_bytes(batch) / 1e6:.1f} MB); {host_us:.1f} us of host a call "
          f"[{card}]")
    return min(k1, k2), min(p1, p2), step_bound


def learner_step_phase(card: str):
    """Phase 22: every case held, then the kernel timed from the self-play
    and the AI-vs-AI live states.  Returns the kernels line's (error, ms,
    plain ms, bound): the largest difference of any case, and the times of
    the self-play step, the PPO rollout's."""
    live, err = {}, 0.0
    for seed, (label, cfg, batch) in enumerate(LEARNER_STEP_CASES):
        state, case_err = hold_learner_step(label, cfg, batch, seed, card)
        live[label], err = (cfg, state), max(err, case_err)
    timed = [time_learner_step(label, *live[label], card)
             for label in ("human seats (self-play)", "AI vs AI")]
    return (err, *timed[0])


def meshed_trainer(card: str):
    """Phase 21: (1) a one-rank nccl group's mesh == the unmeshed trainer,
    bit for bit; (2) two ranks sharing the card over gloo (the port's
    multihost_smoke tool, 2 subprocesses) against the one-rank run; (3) the
    CLI's --distributed with a world of one."""
    from pikazoo_tpu_torch.parallel import init_distributed, make_env_mesh
    import torch.distributed as dist

    cfg = LEARNER
    device = torch.device("cuda", 0)
    # (1) One rank, nccl.
    init_distributed(init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"phase 21: init_distributed took {dist.get_backend()}")
        mesh = make_env_mesh(device)
        init_fn, plain_step, _ = make_ppo_trainer(PikaZoo(MESH_ENV), cfg)
        start = init_fn(0)
        sampling_apart(start.params, plain_step, 2 * cfg.num_envs, card)
        ref_grads = first_minibatch_grads(start, plain_step, cfg)
        del start
        alone, alone_metrics, alone_ms, alone_first = mesh_run(cfg, None, MESH_UPDATES)
        meshed, meshed_metrics, meshed_ms, _ = mesh_run(cfg, mesh, MESH_UPDATES)
        diff = runners_differ(alone, meshed)
        if diff or not torch.equal(alone_metrics, meshed_metrics):
            raise AssertionError(f"phase 21 one-rank mesh != mesh=None: {diff[:5]}")
    finally:
        dist.destroy_process_group()
    print(f"phase 21 one-rank nccl mesh == mesh=None bit for bit: B={cfg.num_envs}, "
          f"{MESH_UPDATES} updates, every runner leaf and metric; ms an update "
          f"{[round(t, 1) for t in alone_ms]} / {[round(t, 1) for t in meshed_ms]} [{card}]")

    # (2) Two ranks on the one card over gloo.
    out_dir = Path(__file__).resolve().parent / "build" / "phase21"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    argv = ["--num-envs", str(cfg.num_envs), "--rollout-length", str(cfg.rollout_length),
            "--minibatches", str(cfg.num_minibatches), "--epochs", str(cfg.update_epochs),
            "--hidden", *map(str, cfg.hidden), "--winning-score",
            str(MESH_ENV.winning_score), "--updates", str(MESH_UPDATES), "--no-traj"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "pikazoo_tpu_torch.tools.multihost_smoke",
                               str(r), "2", str(port), "cuda:0", "fm", "-",
                               str(out_dir / "out.npz"), *argv],
                              cwd=Path(__file__).resolve().parent, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(f"phase 21 rank {r}: {log.strip().splitlines()[-1] if log.strip() else ''}")
        if p.returncode != 0:
            raise AssertionError(f"phase 21 rank {r} failed ({p.returncode}):\n{log[-4000:]}")
    ranks = [dict(np.load(out_dir / f"out.rank{r}.npz")) for r in range(2)]
    for k in ranks[0]:
        if k.startswith(("params.", "metrics", "env.", "last_obs", "grad.")) and \
                not np.array_equal(ranks[0][k], ranks[1][k]):
            raise AssertionError(f"phase 21: the two ranks differ in {k}")
    got = ranks[0]
    # The first update samples with the same params on both worlds: its env
    # state is bit-equal.  Later updates sample with params that differ by
    # the grads' summation order, so near-tie columns may draw other actions.
    for name, leaf in named_tensors(alone_first, "env."):
        if not np.array_equal(got[f"first.{name}"], leaf.cpu().numpy()):
            raise AssertionError(f"phase 21: the gathered {name} after update 1 != the "
                                 "one-rank run's")
    _, rel_l2, min_cos = BF16_TOL
    worst_rel, worst_cos = 0.0, 1.0
    for k, w in ref_grads.items():
        g = torch.from_numpy(got[f"grad.{k}"]).double().flatten()
        w = w.double().cpu().flatten()
        rel = float((g - w).norm() / w.norm())
        cos = float(g @ w / (g.norm() * w.norm()))
        if not (rel <= rel_l2 and cos >= min_cos):
            raise AssertionError(f"phase 21 first summed gradient: {k} relative L2 {rel:.3e}, "
                                 f"cos {cos:.8f} from the one-rank run's")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    steps = MESH_UPDATES * cfg.update_epochs * cfg.num_minibatches
    atol = 2 * cfg.learning_rate * steps + 1e-5
    worst_param = max(float(np.abs(got[f"params.{k}"] - v.cpu().numpy()).max())
                      for k, v in alone.params.items())
    if worst_param > atol:
        raise AssertionError(f"phase 21: params {worst_param:.3e} from the one-rank run's "
                             f"(bound {atol:.3e})")
    want_reduce = steps * 3 + MESH_UPDATES
    for r, rank in enumerate(ranks):
        counts = (int(rank["k1_launches"]), int(rank["rollout_collectives"]),
                  int(rank["all_reduce_calls"]), int(rank["update_collectives"]))
        if counts != (steps, 0, want_reduce, want_reduce):
            raise AssertionError(f"phase 21 rank {r}: K1 launches, rollout collectives, "
                                 f"all_reduce calls, update collectives {counts}; want "
                                 f"({steps}, 0, {want_reduce}, {want_reduce})")
    ms = [rank["update_ms"].tolist() for rank in ranks]
    print(f"phase 21 two ranks on one card over gloo (B={cfg.num_envs} global, "
          f"{cfg.num_envs // 2} a rank, {MESH_UPDATES} updates, {seconds:.1f} s with start-up): "
          f"losses, params, grads and gathered runner bit-identical across ranks; gathered "
          f"env state after update 1 == the one-rank run's; first summed gradient vs the one-rank run's: "
          f"worst leaf relative L2 {worst_rel:.3e} cos {worst_cos:.8f}; params within "
          f"{worst_param:.3e} (bound {atol:.3e}); each rank {steps} K1 bf16 launches, 0 "
          f"rollout collectives, {want_reduce} all_reduce calls ({steps} x (grads + 2 "
          f"advantage statistics) + {MESH_UPDATES} metrics); ms an update per rank "
          f"{[[round(t, 1) for t in m] for m in ms]}, one rank alone "
          f"{[round(t, 1) for t in alone_ms]} [{card}]")
    del alone, meshed

    # (3) The CLI, --distributed, a world of one from the torchrun variables.
    saved = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                            "MASTER_ADDR", "MASTER_PORT")}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    try:
        runner = train_run.main(["--distributed", "--num-envs", "8192", "--rollout-length",
                                 "16", "--updates", "1"])
        world, backend = dist.get_world_size(), dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (world, backend, runner.update_index) != (1, "nccl", 1):
        raise AssertionError(f"phase 21 CLI --distributed: world {world}, backend {backend}, "
                             f"update {runner.update_index}")
    print(f"phase 21 CLI --distributed: a world of {world} over {backend}, 1 update on "
          f"{runner.params['layers.0.kernel'].device} [{card}]")
    return float(np.mean(ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # Phase 1: device.
    card = card_line()
    print(card)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # Phase 2: build every kernel from the checkout's sources.
    build_all(card)

    # Phase 3: kernel vs plain version, on the card, bit-exact.
    err = compare_landing("random states", random_ball_states(AI_BATCH, 0, device))
    err = max(err, compare_landing(
        "net-trap cases", tuple(torch.tensor(c, device=device)
                                for c in NET_TRAP_CASES.T.copy())))
    live = harvest_ball_states(device, AI_BATCH, HARVEST_FRAME)
    err = max(err, compare_landing(f"AI self-play frame {HARVEST_FRAME}", live))
    timed = {}
    for name, balls in (("random states", random_ball_states(AI_BATCH, 1, device)),
                        (f"AI self-play frame {HARVEST_FRAME}", live)):
        kernel = lambda: predict_cuda.landing_sims_batched(*balls)
        plain = lambda: landing_sims_any(*balls)
        kernel(), plain()  # warm up
        # Interleaved: plain, kernel, kernel, plain.
        p1, k1, k2, p2 = (cuda_ms(plain, 3), cuda_ms(kernel, 50),
                          cuda_ms(kernel, 50), cuda_ms(plain, 3))
        # Bound: 4 int32 inputs read and 7 outputs written once; every lane's
        # loop iterations, counted on one more plain call.
        _, lanes = count_landing_iterations(plain)
        k2_bound = bound(11 * 4 * AI_BATCH,
                         {"int32": int(lanes.sum()) * LANDING_ITERATION_OPS})
        timed[name] = (min(k1, k2), min(p1, p2), k2_bound)
        print(f"phase 3 time [{name}] B={AI_BATCH}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.3f} / {p2:.3f} ms; bound {k2_bound[0]:.5f} ms by "
              f"{k2_bound[1]} ({int(lanes.sum())} lane iterations) [{card}]")

    # Phase 4: main path, rule-AI self-play; every frame launches the kernel.
    ai_env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                               is_player2_computer=True))
    zeros = torch.zeros((AI_BATCH, 2), dtype=torch.int32, device=device)
    _, launches = rollout_checks(ai_env, AI_BATCH, AI_FRAMES, lambda t: zeros,
                                 card, "phase 4 rule-AI self-play")
    if launches != AI_FRAMES:
        raise AssertionError(f"landing kernel launched {launches} times in "
                             f"{AI_FRAMES} AI frames")

    # Phase 5: main path, random-action self-play; no computer seat, no launch.
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    random_actions = lambda t: torch.randint(
        0, 18, (RANDOM_BATCH, 2), generator=gen, device=device, dtype=torch.int32)
    _, launches_random = rollout_checks(PikaZoo(EnvConfig()), RANDOM_BATCH,
                                        RANDOM_FRAMES, random_actions, card,
                                        "phase 5 random-action self-play")
    if launches_random != 0:
        raise AssertionError(f"{launches_random} landing launches without a "
                             "computer seat")

    # Phase 6: card trajectory == CPU trajectory.
    compare_devices(EnvConfig(winning_score=3, is_player1_computer=True,
                              is_player2_computer=True), "AI vs AI", 7)
    compare_devices(EnvConfig(winning_score=3, is_player1_computer=True),
                    "AI vs random actions", 8)

    # Phase 7: the fused kernel vs its plain version on the card, all rows.
    fused_err, start, ai_100 = compare_fused(
        "AI self-play", AI_CONFIG, AI_BATCH, FUSED_FRAMES, 11)
    for label, cfg, batch, frames in (
            ("random actions", EnvConfig(), RANDOM_BATCH, FUSED_FRAMES),
            ("serve random", EnvConfig(winning_score=2, serve="random"),
             MODE_BATCH, MODE_FRAMES),
            ("serve alternate", EnvConfig(winning_score=2, serve="alternate"),
             MODE_BATCH, MODE_FRAMES),
            # AI rallies are long: these two reach round and game ends.
            ("AI vs random actions, serve random",
             EnvConfig(winning_score=2, serve="random", is_player1_computer=True),
             MODE_BATCH, MODE_FRAMES),
            ("AI self-play to 2", EnvConfig(winning_score=2, is_player1_computer=True,
                                            is_player2_computer=True),
             MODE_BATCH, 2 * MODE_FRAMES)):
        fused_err = max(fused_err, compare_fused(label, cfg, batch, frames, 12)[0])
    half = FUSED_FRAMES // 2
    twice = fused_step.rollout_packed(
        fused_step.rollout_packed(start.clone(), AI_CONFIG, half), AI_CONFIG, half)
    torch.cuda.synchronize()
    if rows_differ(twice, ai_100):
        raise AssertionError(f"fused kernel: 2 x {half} frames != {FUSED_FRAMES}")
    print(f"phase 7 continuation [AI self-play]: 2 x {half} frames == "
          f"{FUSED_FRAMES} frames on all {fused_step.NFIELDS} rows")

    # Phase 8: the fused path at full width; one launch per call, no landing
    # kernel launch.
    zero_counts()
    ai_state = fused_path("fused AI self-play", AI_CONFIG, AI_BATCH,
                          FUSED_AI_CALLS, card)
    random_state = fused_path("fused random actions", EnvConfig(), RANDOM_BATCH,
                              FUSED_RANDOM_CALLS, card)
    fused_launches = fused_rollout.launches
    landing_launches = predict_cuda.landing_sims_batched.launches
    calls = FUSED_AI_CALLS + FUSED_RANDOM_CALLS
    if fused_launches != calls or landing_launches != 0:
        raise AssertionError(f"fused path: {fused_launches} fused launches for "
                             f"{calls} calls, {landing_launches} landing launches")
    print(f"phase 8 launches: fused_rollout {fused_launches} in {calls} calls, "
          f"landing_sims_batched {landing_launches}")
    fused_ms, fused_plain_ms, fused_bound, hold_err = time_fused(
        "AI self-play", AI_CONFIG, ai_state, card)
    fused_err = max(fused_err, hold_err)
    time_fused("random actions", EnvConfig(), random_state, card)

    # Phase 9: K1 vs its plain version on the card, full width and ragged.
    plain_fm = fused_update.fused_ppo_grads_fm_plain
    full = k1_inputs(*K1_FULL, "tanh", 21)
    tanh_kw = dict(K1_KW, activation="tanh")
    k1_err = compare_grads("K1 [full width]", fused_ppo_grads_fm, plain_fm, full, tanh_kw,
                           BF16_TOL, card, 9)
    k1_err = max(k1_err, compare_grads(
        "K1 [ragged]", fused_ppo_grads_fm, plain_fm, k1_inputs(3, 1000, "relu", 22),
        dict(K1_KW, activation="relu"), BF16_TOL, card, 9))
    k1_ms, k1_plain_ms = time_grads("K1 T=32 N=131072", fused_ppo_grads_fm, plain_fm, full,
                                    tanh_kw, card, 9)
    # K1 bf16's two kernels, each against its plain version; its distance
    # from float64; A's and B's share of the call.
    chain_err = hold_split("K1 bf16", "full width", full, tanh_kw, card, 9)
    hold_split("K1 bf16", "ragged", k1_inputs(3, 1000, "relu", 22),
               dict(K1_KW, activation="relu"), card, 9)
    # An odd number of tiles in the chunk (1 frame of 47): the wgmma
    # kernel's second warpgroup has no tile in the last unit.
    odd = k1_inputs(1, 3000, "tanh", 28)
    hold_split("K1 bf16", "odd tile count", odd, tanh_kw, card, 9)
    k1_err = max(k1_err, compare_grads("K1 [odd tile count]", fused_ppo_grads_fm, plain_fm, odd,
                                       tanh_kw, BF16_TOL, card, 9))
    del odd
    hold_k1_float64(full, tanh_kw, card)
    split_times("K1 bf16", full, tanh_kw, card, k1_ms, 9)
    chain_ms, chain_plain_ms, chain_b = chain_times(full, tanh_kw, card)
    # The bf16 mode at widths the wgmma kernel does not take: chain_kernel.
    narrow = k1_inputs(2, 1000, "tanh", 27, hidden=(128, 64))
    if fused_update.chain_design((128, 64), 35, 18) != "mma":
        raise AssertionError("hidden (128, 64) is not chain_kernel's")
    hold_split("K1 bf16", "hidden (128, 64), chain_kernel", narrow, tanh_kw, card, 9)
    compare_grads("K1 [hidden (128, 64), chain_kernel]", fused_ppo_grads_fm, plain_fm, narrow,
                  tanh_kw, BF16_TOL, card, 9)
    del narrow

    # Phase 10: the learner through its entry points at full width.  The
    # symmetric self-play run is the main path of K1; its first minibatch is
    # kept and held against the plain version afterwards.
    first, restore = capture_first_minibatch()
    try:
        runner, train_step, learner_launches, _ = train(
            EnvConfig(auto_reset=True), LEARNER, LEARNER_UPDATES, "self-play", card)
    finally:
        restore()
    k1_launches = learner_launches["fused_ppo_grads_fm"]["none"]
    step_launches = learner_launches["learner_step"]
    expect_launches("self-play", learner_launches, "none",
                    k1=LEARNER_UPDATES * LEARNER.update_epochs * LEARNER.num_minibatches,
                    steps=LEARNER_UPDATES * LEARNER.rollout_length)
    chunks = LEARNER_UPDATES * k1_chunks(LEARNER)
    if chain_key(LEARNER) != "bf16_chain_wgmma":
        raise AssertionError("the learner's K1 bf16 calls are not the wgmma kernel's")
    expect_kernels("self-play, K1 bf16", learner_launches["by_kernel"],
                   {"bf16_chain_wgmma": chunks, "bf16_dw": chunks}, card, 10)
    chain_launches = chunks
    args, kw = first[0]
    k1_err = max(k1_err, compare_grads("K1 [first live minibatch of update 1]",
                                       fused_ppo_grads_fm, plain_fm, args, kw, BF16_TOL,
                                       card, 10))
    time_learner_phases(runner, train_step, LEARNER, card)
    del runner, train_step, first, args
    _, _, vs_ai, _ = train(EnvConfig(winning_score=15, auto_reset=True,
                                     is_player2_computer=True),
                           VS_AI, 1, "vs rule AI, learner seat 1", card)
    # The learner step's kernel runs the rule AI's landing loops itself: no
    # landing kernel launches from the rollout.
    expect_launches("vs rule AI", vs_ai, "none",
                    k1=VS_AI.update_epochs * VS_AI.num_minibatches,
                    steps=VS_AI.rollout_length)

    # Phase 11: K4 and K1's other modes vs their plain versions on the card:
    # full width, ragged, and for int8 one dynamic-scale cell of 3000 columns
    # (a frame whose width is no multiple of 128 is one cell); bwd_bf16 also
    # after the int8fwd forward.  Each also stage by stage, and bwd_bf16
    # against a float64 plain version.
    plain_rm = fused_update.fused_ppo_grads_rm_plain
    rows = rows_of(full)
    k4_ragged = rows_of(k1_inputs(1, 3000, "relu", 23))
    k4_err = compare_grads("K4 [full width]", fused_ppo_grads, plain_rm, rows, tanh_kw,
                           BF16_TOL, card, 11)
    k4_err = max(k4_err, compare_grads("K4 [ragged]", fused_ppo_grads, plain_rm, k4_ragged,
                                       dict(K1_KW, activation="relu"), BF16_TOL, card, 11))
    k4_ms, k4_plain_ms = time_grads(f"K4 M={K1_FULL[0] * K1_FULL[1]}", fused_ppo_grads,
                                    plain_rm, rows, tanh_kw, card, 11)
    hold_split("K4", "full width", rows, tanh_kw, card, 11, "K4")
    hold_split("K4", "ragged", k4_ragged, dict(K1_KW, activation="relu"), card, 11, "K4")
    split_times("K4", rows, tanh_kw, card, k4_ms, 11)
    del rows, k4_ragged
    ragged_tanh = k1_inputs(3, 1000, "tanh", 24)
    mode_stats = {}
    for name, mode_kw in K1_MODES.items():
        kw = dict(tanh_kw, **mode_kw)
        cases = [("full width", full, kw)]
        if name == "bwd_bf16":
            chains_apart(full, tanh_kw, card)
            cases.append(("ragged", k1_inputs(3, 1000, "relu", 25),
                          dict(kw, activation="relu")))
            cases.append((FWD8_CASE, full, dict(kw, quant="int8fwd")))
            # Its two kernels stage by stage, and its distance from float64
            # (the head's dh on the tensor cores would put it off): the call's
            # after the bf16 forward; kernel A's chain on its own operands at
            # full width (after the int8 forward the call's distance is the
            # loss's roundings alone, see hold_chain_float64).
            for case, args, case_kw in cases:
                hold_split("K1 bwd_bf16", case, args, case_kw, card, 11)
                if case_kw.get("quant", "none") == "none":
                    hold_k1_float64(args, case_kw, card, f"K1 bwd_bf16 [{case}]", 11)
                if case != "ragged":
                    hold_chain_float64(f"K1 bwd_bf16 [{case}]", args, case_kw, card)
        else:
            cases.append(("ragged", ragged_tanh, kw))
        if name == "int8":
            if fused_update.cell_cols(3000) != 3000:
                raise AssertionError("N=3000 is not one cell")
            cases.append(("one cell of 3000 columns", k1_inputs(2, 3000, "tanh", 26), kw))
            # Its kernels stage by stage, on the same three cases (the full
            # width on its first INT8_HOLD_FRAMES frames).
            step_share = max(hold_k1_int8_split(
                case if case != "full width" else f"full width, {INT8_HOLD_FRAMES} frames",
                args if case != "full width" else
                (args[0], *[x[:INT8_HOLD_FRAMES] for x in args[1:]]), tanh_kw, card)
                for case, args, _ in cases)
        if name == "int8fwd":
            # Its two kernels stage by stage, full width and ragged.
            for case, args, case_kw in cases:
                hold_split("K1 int8fwd", case, args, case_kw, card, 11)
        errs = {case: compare_grads(f"K1 {name} [{case}]", fused_ppo_grads_fm, plain_fm,
                                    args, case_kw, BF16_TOL, card, 11)
                for case, args, case_kw in cases}
        m_err = max(e for case, e in errs.items() if case != FWD8_CASE)
        m_ms, m_plain_ms = time_grads(f"K1 {name} T=32 N=131072", fused_ppo_grads_fm,
                                      plain_fm, full, kw, card, 11)
        mode_stats[name] = (m_err, m_ms, m_plain_ms)
        if name == "int8":
            k1_int8_split_times(full, tanh_kw, card, m_ms)
            print(f"phase 11 K1 int8: the largest share of operand entries one step apart "
                  f"{step_share:.3e} (bound {INT8_STEP_SHARE}) [{card}]")
        if name == "int8fwd":
            split_times("K1 int8fwd", full, kw, card, m_ms, 11)
        if name == "bwd_bf16":
            split_times("K1 bwd_bf16", full, kw, card, m_ms, 11)
            fwd8_kw = dict(kw, quant="int8fwd")
            fwd8_ms, fwd8_plain_ms = time_grads("K1 int8fwd+bwd_bf16 T=32 N=131072",
                                                fused_ppo_grads_fm, plain_fm, full, fwd8_kw,
                                                card, 11)
            mode_stats["int8fwd+bwd_bf16"] = (errs[FWD8_CASE], fwd8_ms, fwd8_plain_ms)
            split_times("K1 int8fwd+bwd_bf16", full, fwd8_kw, card, fwd8_ms, 11)
        del cases
    del full, ragged_tanh

    # Phase 12: the learner with K4, then with each of K1's other modes (the
    # int8 run with the minibatch shuffle), each run's counts from 0.
    cfg = dataclasses.replace(LEARNER, fused_update="on")
    runner, train_step, k4_run, _ = train(EnvConfig(auto_reset=True), cfg, K4_UPDATES,
                                          "self-play, K4", card, phase=12)
    k4_launches = k4_run["fused_ppo_grads"]
    expect_launches("self-play, K4", k4_run,
                    k4=K4_UPDATES * cfg.update_epochs * cfg.num_minibatches,
                    steps=K4_UPDATES * cfg.rollout_length)
    # Its two kernels once a chunk of CHUNK_COLS rows, K1's none.
    rows = cfg.rollout_length // cfg.num_minibatches * 2 * cfg.num_envs
    chunks = k4_launches * -(-rows // fused_update.CHUNK_COLS)
    expect_kernels("self-play, K4", k4_run["k4_by_kernel"], {"k4_chain": chunks, "k4_dw": chunks},
                   card, 12)
    expect_kernels("self-play, K4 (K1's kernels)", k4_run["by_kernel"], {}, card, 12)
    time_learner_phases(runner, train_step, cfg, card, phase=12)
    del runner, train_step
    mode_launches = {}
    for name, cfg in (
            ("int8", dataclasses.replace(LEARNER, fused_update="fm", update_quant="int8",
                                         shuffle_minibatches=True)),
            ("int8fwd", dataclasses.replace(LEARNER, fused_update="fm",
                                            update_quant="int8fwd")),
            ("bwd_bf16", dataclasses.replace(LEARNER, fused_update="fm",
                                             update_bwd_bf16=True)),
            ("int8fwd+bwd_bf16", dataclasses.replace(LEARNER, fused_update="fm",
                                                     update_quant="int8fwd",
                                                     update_bwd_bf16=True))):
        runner, train_step, run, _ = train(EnvConfig(auto_reset=True), cfg, 1,
                                           f"self-play, K1 {name}", card, phase=12)
        calls = cfg.update_epochs * cfg.num_minibatches
        expect_launches(f"self-play, K1 {name}", run, name, k1=calls, steps=cfg.rollout_length)
        mode_launches[name] = run["fused_ppo_grads_fm"][name]
        # Which kernels served, each chunk of frames: the int8 mode's split
        # kernels (A, S a layer, Q and the head's B), the other modes' the
        # bf16 mode's (A with the int8 forward, the bf16 chain or both, B).
        chunks = k1_chunks(cfg)
        want = ({"int8_chain": chunks, "int8_requant": len(cfg.hidden) * chunks,
                 "int8_dw": chunks, "int8_head_dw": chunks} if name == "int8"
                else {chain_key(cfg): chunks, "bf16_dw": chunks})
        expect_kernels(f"self-play, K1 {name}", run["by_kernel"], want, card, 12)
        time_learner_phases(runner, train_step, cfg, card, phase=12)
        del runner, train_step

    # Phases 13-15: the probe tools, each kernel against its plain version,
    # each tool's main with the counts from 0.
    p1 = probe_p1(live, card)
    p2 = probe_p2(card)
    p3 = probe_p3(card)

    # Phases 16-18: the trainer's user surface.  The wrapped CLI at full
    # width, killed and resumed; the committed vs-AI policy against the rule
    # AI (K2 a frame); the golden trajectory on the card.
    wrapped_training(card)
    evaluate_policy(card)
    golden_on_card(card)

    # Phase 19: the PettingZoo drop-in at batch 1 on three backends, and the
    # oracle draw mode card vs CPU.
    pettingzoo_drop_in(card)
    oracle_card_vs_cpu(card)

    # Phase 20: K2's landing-loop algorithms (leap, hyb, the mixes, the ydir
    # split) against their plain versions and K2 iter, timed beside iter.
    k2_mode_stats = k2_modes(live, card)

    # Phase 21: the meshed trainer: a one-rank nccl mesh, two ranks sharing
    # the card over gloo, and the CLI's --distributed.
    meshed_trainer(card)

    # Phase 22: the learner step's kernel against its plain version, and timed.
    learner_step_stats = learner_step_phase(card)

    ms, plain_ms, k2_bound = timed[f"AI self-play frame {HARVEST_FRAME}"]
    rows = K1_FULL[0] * K1_FULL[1]
    entries = [
        ("landing_sims_batched", "landing.cu", "pikazoo_tpu/core/predict_pallas.py:72",
         launches, err, ms, plain_ms, k2_bound),
        # K2's leap and hybrid modes: launches in phase 20's timed runs.
        *[(f"landing_sims_batched[{algo}]", "landing.cu",
           "pikazoo_tpu/core/predict_pallas.py:72", *k2_mode_stats[algo])
          for algo in ("leap", "hyb")],
        ("fused_rollout", "fused_step.cu", "pikazoo_tpu/core/fused_step.py:200",
         fused_launches, fused_err, fused_ms, fused_plain_ms, fused_bound),
        # No TPU kernel: JAX jits the learner step (pikazoo_tpu/envs/pika_volley.py:359).
        ("learner_step", "learner_step.cu", "none", step_launches, *learner_step_stats),
        ("fused_ppo_grads_fm", "fused_update_bf16.cu", "pikazoo_tpu/train/fused_update.py:504",
         k1_launches, k1_err, k1_ms, k1_plain_ms, grad_bound(rows)),
        # K1 bf16's kernel A alone (launches: once a chunk in phase 10).
        ("fused_ppo_grads_fm[kernel A]", "k1_wgmma.cuh", "pikazoo_tpu/train/fused_update.py:504",
         chain_launches, chain_err, chain_ms, chain_plain_ms, chain_b),
    ]
    # (source, the forward's precision, which sets the bound)
    mode_sources = {"int8": ("fused_update_int8.cu", "int8"),
                    "int8fwd": ("fused_update_bf16.cu", "int8fwd"),
                    "bwd_bf16": ("fused_update_bf16.cu", "none"),
                    "int8fwd+bwd_bf16": ("fused_update_bf16.cu", "int8fwd")}
    for name, (source, forward) in mode_sources.items():
        m_err, m_ms, m_plain = mode_stats[name]
        entries.append((f"fused_ppo_grads_fm[{name}]", source,
                        "pikazoo_tpu/train/fused_update.py:504", mode_launches[name],
                        m_err, m_ms, m_plain, grad_bound(rows, forward)))
    entries.append(("fused_ppo_grads", "k4_split.cu",
                    "pikazoo_tpu/train/fused_update.py:651", k4_launches, k4_err, k4_ms,
                    k4_plain_ms, grad_bound(rows)))
    for name, source, replaces, (e, t, tp, b, n, *lib) in (
            ("flat_sims", "flat_sims.cu", "tools/compaction_probe.py:102", p1),
            ("mm_grads", "fm_roofline.cu", "tools/fm_roofline.py:95", p2),
            ("fm_grads", "fm_kernel_probe.cu", "tools/fm_kernel_probe.py:185", p3)):
        entries.append((name, source, replaces, n, e, t, tp, b, *lib))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"pikazoo_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": n,
        "max_abs_err": e,
        "ms": t,
        "plain_ms": tp,
        "bound_ms": b[0],
        "bound_by": b[1],
        # P2's yardstick: its eight products as eight torch.matmul calls, timed
        # in phase 14; no one PyTorch call computes any other entry's function.
        "library_ms": lib[0] if lib else None,
    } for name, source, replaces, n, e, t, tp, b, *lib in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
