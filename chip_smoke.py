#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``pikazoo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, ``nvcc``
and ``nvidia-smi``.  It builds every kernel of the port from the sources in
the checkout, holds each against its plain PyTorch version on the card,
drives the port's env paths with rule-AI and random-action seats (the eager
``PikaZoo.reset_batch`` / ``step_batch``, and ``fused_rollout``, many frames
per launch), compares a card trajectory with a CPU trajectory leaf by leaf,
and trains: the self-play PPO learner through ``make_ppo_trainer`` at full
width, its minibatch gradients in the fused kernel K1.  Every phase prints
at least one line; any failure raises and the script exits non-zero.  The last line is a JSON object naming the device.  Without a
CUDA device it exits with status 1 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pikazoo_tpu_torch import EnvConfig, PikaZoo, fused_rollout
from pikazoo_tpu_torch.core import fused_step, predict_cuda
from pikazoo_tpu_torch.core.predict import landing_sims_any
from pikazoo_tpu_torch.envs import OBS_HIGH, OBS_LOW
from pikazoo_tpu_torch.envs.pika_volley import EnvState
from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer, ppo
from pikazoo_tpu_torch.train import fused_update
from pikazoo_tpu_torch.train.fused_update import fused_ppo_grads_fm
from pikazoo_tpu_torch.train.networks import ActorCritic, apply_fm

AI_BATCH, AI_FRAMES = 65536, 500          # rule-AI self-play (both seats)
RANDOM_BATCH, RANDOM_FRAMES = 262144, 200  # random-action self-play
PARITY_BATCH, PARITY_FRAMES = 4096, 300    # card vs CPU, leaf by leaf
HARVEST_FRAME = 300
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def harvest_ball_states(device, batch: int, frames: int):
    """Ball (x, y, vx, vy) after ``frames`` frames of AI-vs-AI self-play."""
    env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(1, batch, device=device)
    actions = torch.zeros((batch, 2), dtype=torch.int32, device=device)
    for _ in range(frames):
        state, _ = env.step_batch(state, actions)
    b = state.ball
    return b.x, b.y, b.x_velocity, b.y_velocity


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
    predict_cuda.landing_sims_batched.launches = 0
    fused_rollout.launches = 0
    fused_ppo_grads_fm.launches = 0


def build_all(card: str):
    """Build every library at once, one nvcc each; print each one's time."""
    def timed_build(build):
        t0 = time.perf_counter()
        lib = build()
        return lib._name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(timed_build, b) for b in
                  (predict_cuda._library, fused_step._library, fused_update._library)]
        for future in builds:
            name, seconds = future.result()
            print(f"phase 2 build: {seconds:.2f} s -> {name} [{card}]")


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
    """CUDA-event ms of one FUSED_FRAMES-frame call from a live state, kernel
    and plain, interleaved plain, kernel, kernel, plain.  The kernel runs in
    place on its own buffer, so its calls continue one another."""
    live = fused_step.pack_state(state, 1)
    buf = live.clone()
    kernel = lambda: fused_step.rollout_packed(buf, cfg, FUSED_FRAMES)
    plain = lambda: fused_step.rollout_packed_plain(live, cfg, FUSED_FRAMES)
    p1, k1, k2, p2 = (cuda_ms(plain, 1), cuda_ms(kernel, 5),
                      cuda_ms(kernel, 5), cuda_ms(plain, 1))
    batch = live.shape[1]
    print(f"phase 8 time [{label}] B={batch} x {FUSED_FRAMES} frames: kernel "
          f"{k1:.4f} / {k2:.4f} ms ({batch * FUSED_FRAMES / min(k1, k2) * 1e3:.0f} "
          f"env-steps/s), plain {p1:.1f} / {p2:.1f} ms [{card}]")
    return min(k1, k2), min(p1, p2)


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

# K1 and the learner (phases 9-10).
K1_KW = dict(num_actions=18, clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
K1_FULL = (32, 131072)  # a full-width minibatch: 32 frames x 2B = 131072 columns
# Kernel vs plain differ in summation order and so in rare bf16 roundings.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
GRAD_REL_L2, GRAD_COS = 1e-3, 0.99999
LEARNER = PPOConfig(num_envs=65536, rollout_length=128, num_minibatches=4,
                    update_epochs=4, hidden=(256, 256))
LEARNER_UPDATES = 3
# The artifacts/vs_ai_policy recipe (tests/test_trained_artifact.py:23-26).
VS_AI = PPOConfig(num_envs=8192, rollout_length=128, num_minibatches=8,
                  update_epochs=4, hidden=(256, 256), entropy_coef=0.01,
                  learner_seats="p1", learning_rate=5e-4)


def k1_inputs(frames: int, cols: int, activation: str, seed: int):
    """A minibatch built as tests/test_fused_update.py:32-46 builds one, from
    numpy: uniform bf16 observations, uniform actions, logp_old of the
    network perturbed by 0.3 N(0, 1) so that both clip branches fire,
    normalised N(0, 1) advantages, targets = value + N(0, 1)."""
    rng = np.random.default_rng(seed)
    net = ActorCritic(18, (256, 256), activation,
                      generator=torch.Generator().manual_seed(seed))
    params = {k: v.detach().cuda() for k, v in net.params().items()}
    card = lambda a: torch.from_numpy(a).cuda()
    obs = card(rng.random((frames, 35, cols), dtype=np.float32)).to(torch.bfloat16)
    action = card(rng.integers(0, 18, (frames, cols)).astype(np.int32))
    logits, value = apply_fm(params, obs.permute(1, 0, 2).reshape(35, -1), activation)
    logp = torch.log_softmax(logits, 0).gather(0, action.reshape(1, -1).long())
    logp_old = logp.reshape(frames, cols) + 0.3 * card(
        rng.standard_normal((frames, cols), dtype=np.float32))
    adv = card(rng.standard_normal((frames, cols), dtype=np.float32))
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    value = value.reshape(frames, cols)
    target = value + card(rng.standard_normal((frames, cols), dtype=np.float32))
    return params, obs, action, logp_old, value, adv, target


def compare_k1(label: str, args, activation: str, card: str, phase: int = 9):
    """K1 vs its plain version on the same card tensors, within the stated
    tolerances, and two launches bit-identical.  Returns the largest
    absolute difference over the grads and losses."""
    kw = dict(K1_KW, activation=activation)
    grads, losses = fused_ppo_grads_fm(*args, **kw)
    grads2, losses2 = fused_ppo_grads_fm(*args, **kw)
    want, want_losses = fused_update.fused_ppo_grads_fm_plain(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(losses, losses2)
            and all(torch.equal(grads[k], grads2[k]) for k in grads)):
        raise AssertionError(f"K1 [{label}]: two launches on the same inputs differ")
    if not torch.allclose(losses, want_losses, rtol=LOSS_RTOL, atol=LOSS_ATOL):
        raise AssertionError(f"K1 [{label}]: losses {losses.tolist()} vs plain "
                             f"{want_losses.tolist()}")
    worst_rel, worst_cos = 0.0, 1.0
    err = float((losses - want_losses).abs().max())
    for k, w in want.items():
        g, w = grads[k].double().flatten(), w.double().flatten()
        rel = float((g - w).norm() / w.norm())
        cos = float(g @ w / (g.norm() * w.norm()))
        if not (rel <= GRAD_REL_L2 and cos >= GRAD_COS):
            raise AssertionError(f"K1 [{label}]: {k} relative L2 {rel:.3e}, cos {cos:.8f}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        err = max(err, float((g - w).abs().max()))
    frames, _, cols = args[1].shape
    print(f"phase {phase} K1 vs plain [{label}] T={frames} N={cols} {activation}: losses "
          f"{[round(x, 6) for x in losses.tolist()]}, worst grad leaf relative L2 "
          f"{worst_rel:.3e} cos {worst_cos:.8f}, max |diff| {err:.3e}, two launches "
          f"bit-identical [{card}]")
    return err


def time_k1(args, activation: str, card: str):
    """CUDA-event ms of K1 and of its plain version, interleaved plain,
    kernel, kernel, plain."""
    kw = dict(K1_KW, activation=activation)
    kernel = lambda: fused_ppo_grads_fm(*args, **kw)
    plain = lambda: fused_update.fused_ppo_grads_fm_plain(*args, **kw)
    p1, k1, k2, p2 = (cuda_ms(plain, 1), cuda_ms(kernel, 5), cuda_ms(kernel, 5),
                      cuda_ms(plain, 1))
    frames, _, cols = args[1].shape
    print(f"phase 9 time K1 T={frames} N={cols}: kernel {k1:.3f} / {k2:.3f} ms, "
          f"plain {p1:.3f} / {p2:.3f} ms [{card}]")
    return min(k1, k2), min(p1, p2)


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


def train(env_config: EnvConfig, cfg: PPOConfig, updates: int, label: str, card: str):
    """``updates`` train steps from ``init_fn(0)`` through the trainer's
    entry points.  Raises unless K1 serves, every env advanced
    ``updates * rollout_length`` frames, the metrics are finite and the
    params moved.  Returns (runner, train_step, launches by kernel,
    env-steps/s)."""
    init_fn, train_step, _ = make_ppo_trainer(PikaZoo(env_config), cfg, device="cuda")
    if train_step.provenance["fused_update"] != "fm":
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
    launches = {"fused_ppo_grads_fm": fused_ppo_grads_fm.launches,
                "landing_sims_batched": predict_cuda.landing_sims_batched.launches,
                "fused_rollout": fused_rollout.launches}
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
    print(f"phase 10 {label}: B={cfg.num_envs} x {frames} frames in {updates} "
          f"update(s), {seconds:.3f} s = {rate:.0f} env-steps/s (train-step wall), "
          f"every step_count +{frames}, params moved (max |change| {moved:.3e}), "
          f"launches {launches}, last update {json.dumps(last)} [{card}]")
    return runner, train_step, launches, rate


def time_learner_phases(runner, train_step, cfg: PPOConfig, card: str):
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
    print(f"phase 10 update phases (CUDA events): rollout {rollout:.1f} ms, GAE "
          f"{gae:.2f} ms, update {update:.1f} ms ({cfg.update_epochs * cfg.num_minibatches}"
          f" K1 calls); rollout share {rollout / total:.1%} [{card}]")


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
        timed[name] = (min(k1, k2), min(p1, p2))
        print(f"phase 3 time [{name}] B={AI_BATCH}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.3f} / {p2:.3f} ms [{card}]")

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
    fused_ms, fused_plain_ms = time_fused("AI self-play", AI_CONFIG, ai_state, card)
    time_fused("random actions", EnvConfig(), random_state, card)

    # Phase 9: K1 vs its plain version on the card, full width and ragged.
    full = k1_inputs(*K1_FULL, "tanh", 21)
    k1_err = compare_k1("full width", full, "tanh", card)
    k1_err = max(k1_err, compare_k1("ragged", k1_inputs(3, 1000, "relu", 22), "relu",
                                    card))
    k1_ms, k1_plain_ms = time_k1(full, "tanh", card)
    del full

    # Phase 10: the learner through its entry points at full width.  The
    # symmetric self-play run is the main path of K1; its first minibatch is
    # kept and held against the plain version afterwards.
    first, restore = capture_first_minibatch()
    try:
        runner, train_step, learner_launches, _ = train(
            EnvConfig(auto_reset=True), LEARNER, LEARNER_UPDATES, "self-play", card)
    finally:
        restore()
    k1_launches = learner_launches["fused_ppo_grads_fm"]
    want = LEARNER_UPDATES * LEARNER.update_epochs * LEARNER.num_minibatches
    if learner_launches != {"fused_ppo_grads_fm": want, "landing_sims_batched": 0,
                            "fused_rollout": 0}:
        raise AssertionError(f"self-play: launches {learner_launches}, want {want} "
                             "K1 and no other")
    args, kw = first[0]
    k1_err = max(k1_err, compare_k1("first live minibatch of update 1", args,
                                    kw["activation"], card, phase=10))
    time_learner_phases(runner, train_step, LEARNER, card)
    del runner, train_step, first, args
    _, _, vs_ai, _ = train(EnvConfig(winning_score=15, auto_reset=True,
                                     is_player2_computer=True),
                           VS_AI, 1, "vs rule AI, learner seat 1", card)
    if (vs_ai["landing_sims_batched"] != VS_AI.rollout_length
            or vs_ai["fused_ppo_grads_fm"] != VS_AI.update_epochs * VS_AI.num_minibatches
            or vs_ai["fused_rollout"]):
        raise AssertionError(f"vs rule AI: launches {vs_ai}")

    ms, plain_ms = timed[f"AI self-play frame {HARVEST_FRAME}"]
    print(json.dumps({"kernels": [{
        "name": "landing_sims_batched",
        "route": "cuda",
        "source": "pikazoo_tpu_torch/csrc/landing.cu",
        "replaces": "pikazoo_tpu/core/predict_pallas.py:72",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "fused_rollout",
        "route": "cuda",
        "source": "pikazoo_tpu_torch/csrc/fused_step.cu",
        "replaces": "pikazoo_tpu/core/fused_step.py:200",
        "launches": fused_launches,
        "max_abs_err": fused_err,
        "ms": fused_ms,
        "plain_ms": fused_plain_ms,
    }, {
        "name": "fused_ppo_grads_fm",
        "route": "cuda",
        "source": "pikazoo_tpu_torch/csrc/fused_update.cu",
        "replaces": "pikazoo_tpu/train/fused_update.py:504",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
