"""The live-lane compaction probe of the rule AI's landing sims, on the card.

Counterpart of the JAX package's ``tools/compaction_probe.py``.  The landing
kernel K2 (``csrc/landing.cu``) runs one thread per (lane, env), so a warp
runs until the slowest of its 32 lanes has landed.  This probe measures
whether ordering the lanes by a closed-form time-to-ground estimate (the ETA:
the root of the free-flight parabola; wall bounces do not change the y
dynamics) before the loop, so that neighbouring lanes land together, buys
more than the sort costs.  The sorted results are a permutation of the
natural ones, bit for bit.

    python3 -m pikazoo_tpu_torch.tools.compaction_probe            # stage kern
    python3 -m pikazoo_tpu_torch.tools.compaction_probe --stage prim
    python3 -m pikazoo_tpu_torch.tools.compaction_probe --device cpu --batch 256 \\
        --roll-frames 8 --chain 2 --iters 1

``--stage kern`` rolls out live ball states (AI self-play from a reset),
checks that the flat kernel over the true lanes (full net rule) and the 6B
candidate lanes (mistake rule) equals K2, and that the ETA-sorted lanes give
the permuted natural results, then times, each as ``--chain`` calls in a
row on the same lanes, min of ``--iters``:

- A  K2, ``predict_cuda.landing_sims_batched`` (true and candidate lanes);
- B.t / B.c  the flat kernel over the true / candidate lanes, natural order;
- D.t / D.c  the same lanes ETA-sorted (the sort not timed: its ceiling);
- E  K2 on the envs sorted by their worst lane's ETA.

``--stage prim`` times the primitives any reordering pays, at n = B and 6B:
a sort of one key with its payloads (``torch.sort`` returns the key's
permutation, and the 4 payloads follow it by ``index_select``: PyTorch has
no multi-operand sort), ``argsort`` + 4 ``index_select``, a ``scatter`` of
one field and an ``index_select`` of one field.

On the card the times are CUDA events with the stream held while the host
queues the calls (``tools/_timing.py``), so they time the card's work, not
the host's issue of many short launches; nothing on the card caches a
call's result, so the calls need not feed one another (the JAX tool chains
them through a nudge of x for that reason).  With ``--device cpu`` the times
are the host's clock and say nothing of the card.  The flat kernel is
``csrc/flat_sims.cu``; a CPU tensor takes its plain version
(:func:`flat_sims_plain`).  Nothing runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from typing import Dict, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core import constants as C
from pikazoo_tpu_torch.core import predict_cuda
from pikazoo_tpu_torch.core.predict import sim_loop
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.tools._timing import best_of, resolve, timer, where

SOURCES = ("flat_sims.cu",)
Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ------------------------------------------------------------ flat kernel --
@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("flat_sims", SOURCES)
    fn = lib.flat_sims_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flat_sims_plain(x, y, vx, vy, full_rule: bool) -> torch.Tensor:
    """The plain version: ``core.predict.sim_loop`` with one rule for every
    lane (the JAX kernel's body, ``_sim_loop`` with a static rule)."""
    return sim_loop(x, y, vx, vy, full_rule=torch.tensor(bool(full_rule), device=x.device))


def _check(lanes: Lanes) -> torch.device:
    device, shape = lanes[0].device, lanes[0].shape
    for t in lanes:
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != shape:
            raise ValueError("flat_sims takes four (n,) int32 tensors, got "
                             f"{[(tuple(u.shape), u.dtype) for u in lanes]}")
        if not t.is_contiguous():
            raise ValueError("flat_sims takes contiguous tensors")
        if t.device != device:
            raise ValueError(f"flat_sims inputs lie on {sorted({str(u.device) for u in lanes})}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flat_sims has no version for {device}")
    return device


def flat_sims(x: torch.Tensor, y: torch.Tensor, vx: torch.Tensor, vy: torch.Tensor,
              full_rule: bool) -> torch.Tensor:
    """(n,) int32 lanes -> (n,) landing x, every lane under the full net rule
    (``full_rule=True``, the true ball's) or the mistake rule (the power-hit
    candidates').  On CUDA this launches ``csrc/flat_sims.cu`` on the current
    stream without synchronising and adds one to ``flat_sims.launches``; on
    the CPU it runs :func:`flat_sims_plain`."""
    device = _check((x, y, vx, vy))
    if device.type == "cpu":
        return flat_sims_plain(x, y, vx, vy, full_rule)
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().flat_sims_launch(x.data_ptr(), y.data_ptr(), vx.data_ptr(),
                                          vy.data_ptr(), out.data_ptr(), x.shape[0],
                                          int(bool(full_rule)), stream)
    if err != 0:
        raise RuntimeError(f"flat_sims kernel launch failed: CUDA error {err}")
    flat_sims.launches += 1
    return out


flat_sims.launches = 0


# ---------------------------------------------------------------- lanes --
def candidate_lanes(x, y, vx, vy) -> Lanes:
    """(B,) ball state -> the flat (6B,) candidate lanes, lane k of env b at
    index k*B + b (canonical order A: |x_dir| = (k < 3), y_dir = k % 3 - 1)."""
    lane = torch.arange(6, dtype=torch.int32, device=x.device)[:, None]
    speed = ((lane < 3).to(torch.int32) + 1) * 10
    cvx = torch.where(x[None, :] < C.GROUND_HALF_WIDTH, speed, -speed)
    cvy = vy.abs()[None, :] * (lane % 3 - 1) * 2
    shape = (6, x.shape[0])
    return (x.expand(shape).reshape(-1), y.expand(shape).reshape(-1),
            cvx.reshape(-1), cvy.reshape(-1))


def sims_flat_natural(x, y, vx, vy) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's outputs from two flat calls: (expected (B,), candidates (B, 6))."""
    expected = flat_sims(x, y, vx, vy, full_rule=True)
    cand = flat_sims(*candidate_lanes(x, y, vx, vy), full_rule=False)
    return expected, cand.reshape(6, x.shape[0]).t()


def eta(y, vx, vy) -> torch.Tensor:
    """The time-to-ground key in f32: the free-flight parabola's root,
    ``-vy + sqrt(max(vy^2 + 2 (253 - y), 0))``; -1 for a finished lane
    (vx == 0), which never iterates."""
    vyf = vy.float()
    disc = torch.clamp(vyf * vyf + 2.0 * (253.0 - y.float()), min=0.0)
    return torch.where(vx == 0, -1.0, -vyf + torch.sqrt(disc))


def eta_order(lanes: Lanes) -> torch.Tensor:
    """The stable permutation that sorts ``lanes`` by their ETA."""
    return torch.argsort(eta(*lanes[1:]), stable=True)


def live_ball(batch: int, frames: int, seed: int, device) -> Lanes:
    """Ball (x, y, vx, vy) after ``frames`` frames of AI-vs-AI self-play."""
    env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(seed, batch, device=device)
    actions = torch.zeros((batch, 2), dtype=torch.int32, device=device)
    for _ in range(frames):
        state, _ = env.step_batch(state, actions)
    b = state.ball
    return b.x, b.y, b.x_velocity, b.y_velocity


# --------------------------------------------------------------- chains --
def chain_flat(lanes: Lanes, full_rule: bool, calls: int) -> None:
    """``calls`` flat calls in a row on ``lanes``."""
    for _ in range(calls):
        flat_sims(*lanes, full_rule)


def chain_prod(balls: Lanes, calls: int) -> None:
    """``calls`` K2 calls in a row on ``balls``."""
    for _ in range(calls):
        predict_cuda.landing_sims_batched(*balls)


def permuted(lanes: Lanes, perm: torch.Tensor) -> Lanes:
    return tuple(v.index_select(0, perm).contiguous() for v in lanes)


# --------------------------------------------------------------- stages --
def check_lanes(balls: Lanes) -> None:
    """The flat kernel over natural lanes equals K2, and over ETA-sorted
    lanes gives the permuted natural results; raises otherwise."""
    exp_a, cand_a = predict_cuda.landing_sims_batched(*balls)
    exp_b, cand_b = sims_flat_natural(*balls)
    if not (torch.equal(exp_a, exp_b) and torch.equal(cand_a, cand_b)):
        raise AssertionError("flat natural lanes != landing_sims_batched")
    cand = candidate_lanes(*balls)
    for lanes, rule, natural in ((balls, True, exp_a), (cand, False, cand_a.t().reshape(-1))):
        perm = eta_order(lanes)
        if not torch.equal(flat_sims(*permuted(lanes, perm), rule), natural[perm]):
            raise AssertionError(f"ETA-sorted results != permuted natural ({rule=})")


def run_kern(opts, device, clock) -> Dict[str, float]:
    """Live states, the checks, then variants A, B, D, E; returns us/call."""
    batch, calls = opts.batch, opts.chain
    print(f"collecting live ball states: B={batch}, {opts.roll_frames} AI frames", flush=True)
    balls = tuple(v.contiguous() for v in live_ball(batch, opts.roll_frames, 0, device))
    check_lanes(balls)
    print(f"  flat kernels bit-equal to landing_sims_batched on {batch} live states; "
          "ETA-sorted results match (permutation only)", flush=True)
    cand = candidate_lanes(*balls)
    true_srt = permuted(balls, eta_order(balls))
    cand_srt = permuted(cand, eta_order(cand))
    # E: the envs ordered by their worst lane's ETA (K2's layout kept).
    env_key = torch.maximum(eta(*balls[1:]), eta(*cand[1:]).reshape(6, batch).amax(dim=0))
    env_srt = permuted(balls, torch.argsort(env_key, stable=True))
    runs = {
        "A production (true+cand)": lambda: chain_prod(balls, calls),
        "B.t flat true natural": lambda: chain_flat(balls, True, calls),
        "B.c flat cand natural": lambda: chain_flat(cand, False, calls),
        "D.t flat true SORTED": lambda: chain_flat(true_srt, True, calls),
        "D.c flat cand SORTED": lambda: chain_flat(cand_srt, False, calls),
        "E production env-SORTED": lambda: chain_prod(env_srt, calls),
    }
    results = {}
    for name, fn in runs.items():
        results[name] = best_of(fn, opts.iters, clock) / calls * 1e6
        print(f"{name:28s} {results[name]:10.2f} us/call  (min of {opts.iters}, "
              f"{calls} calls)", flush=True)
    total = results["B.t flat true natural"] + results["B.c flat cand natural"]
    print(f"B total {total:.2f} us vs A {results['A production (true+cand)']:.2f} us",
          flush=True)
    total = results["D.t flat true SORTED"] + results["D.c flat cand SORTED"]
    print(f"D total (free-sort ceiling) {total:.2f} us", flush=True)
    return results


def run_prim(opts, device, clock) -> Dict[str, float]:
    """The reordering primitives at n = B and 6B; returns us/call."""
    calls = opts.chain
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    results = {}
    for n in (opts.batch, 6 * opts.batch):
        key0 = torch.randn(n, generator=gen, device=device)
        vals = [torch.randint(0, 400, (n,), generator=gen, device=device, dtype=torch.int32)
                for _ in range(4)]
        # A real (non-identity) permutation.
        idx = torch.randperm(n, generator=gen, device=device)

        def sort6(key, a, b, c, d):
            skey, perm = torch.sort(key, stable=True)
            return (skey, *(v.index_select(0, perm) for v in (a, b, c, d)), perm)

        def argsort_take(key, a, b, c, d):
            perm = torch.argsort(key)
            return (*(v.index_select(0, perm) for v in (a, b, c, d)), perm)

        def scatter1(perm, a):
            return torch.zeros_like(a).scatter_(0, perm, a)

        def take1(perm, a):
            return a.index_select(0, perm)

        def loop(fn, *args):
            def run():
                for _ in range(calls):
                    fn(*args)
            return run

        for label, fn, args in (("sort 1key+5payload", sort6, (key0, *vals)),
                                ("argsort+4x take", argsort_take, (key0, *vals)),
                                ("scatter 1 field", scatter1, (idx, vals[0])),
                                ("take 1 field", take1, (idx, vals[0]))):
            us = best_of(loop(fn, *args), opts.iters, clock) / calls * 1e6
            results[f"n={n} {label}"] = us
            print(f"n={n:8d} {label:24s} {us:10.2f} us/call", flush=True)
    return results


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=("kern", "prim"), default="kern")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=65536, help="envs B (true lanes)")
    ap.add_argument("--roll-frames", type=int, default=512,
                    help="AI self-play frames before the states are taken")
    ap.add_argument("--chain", type=int, default=64, help="calls a timing")
    ap.add_argument("--iters", type=int, default=5, help="timings; the least is kept")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse(argv)
    device = resolve(opts.device, "compaction_probe")
    print(f"compaction probe, stage {opts.stage}, B={opts.batch} [{where(device)}]", flush=True)
    clock = timer(device)
    results = (run_prim if opts.stage == "prim" else run_kern)(opts, device, clock)
    print({k: round(v, 2) for k, v in results.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
