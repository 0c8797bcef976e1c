"""K3 (``csrc/fused_step.cu``, the fused rollout) on the card: its time
beside another tree's build of it, its landing pool's lane efficiency, and
the work of its landing loops counted on the plain version.  Needs a card and nvcc:

    python3 -m pikazoo_tpu_torch.tools.k3_probe [--parent DIR]

From a live AI self-play state (B=65536 after 500 fused frames) and a live
random-action state (B=262144 after 200), it prints:

- the ``-Xptxas -v`` resources of every kernel instance of each build;
- CUDA-event ms of one 100-frame call of each build in turns, first to last
  and back (parent, change, change, parent), each build on its own copy of
  the live state, so every build runs the same frames; at the end every
  build's state must be bit-equal to the repo's;
- the landing pool's counts from the counting instance (one 100-frame call)
  and its lane efficiency, iterations / (32 x pool steps);
- the one-thread design's lane efficiency estimated from the plain version's
  iteration counts (``landing_work``): the same useful iterations over
  32 x its loop steps, the longest true ball of each warp plus, seat by seat
  and search position by position, the longest candidate loop of the lanes
  still searching.

``--parent DIR`` adds the build of another tree's ``csrc/`` (DIR is the
root of a checkout, or its ``csrc`` directory): unpack the parent commit
with ``git archive`` under ``build/``.  ``--device cpu`` prints
``landing_work``'s counts at a small batch instead (no times).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core import constants as C
from pikazoo_tpu_torch.core import engine, fused_step, predict
from pikazoo_tpu_torch.core.rng import site_value
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.tools._timing import card_line, resolve, timer

WARP = 32
AI_CONFIG = EnvConfig(auto_reset=True, is_player1_computer=True,
                      is_player2_computer=True)
FRAMES = 100


class LandingWork(NamedTuple):
    """The landing loops' work of a plain rollout, frame by frame.  An
    iteration is one ``sim_step`` of a live lane (vx != 0 at its start)."""

    true_iterations: torch.Tensor       # (T, B) the true ball's
    asks: torch.Tensor                  # (T, 2, B) bool: computer seat asks for the candidates
    needed: torch.Tensor                # (T, 2, B) candidate iterations the seat's lazy search
    #                                     needs: in its coin's order up to and including the
    #                                     first accepted candidate, all 6 if none is
    candidate_iterations: torch.Tensor  # (T, B) all 6 candidates', where either seat asks
    serial_steps: torch.Tensor          # (T, B // 32) loop steps of one thread an env
    #                                     running its loops in turn (see the module note)
    continues: torch.Tensor             # (T, B) bool: the true ball starts where the previous
    #                                     frame's true ball stood after its first iteration,
    #                                     which then landed within the cap: its landing x is
    #                                     the previous frame's, and its loop could be skipped


def landing_work(packed: torch.Tensor, config: EnvConfig, frames: int):
    """Run the plain version ``frames`` frames from ``packed`` with its
    landing loop and its AI counting, on any device.  Returns (the new
    packed matrix, :class:`LandingWork`).  The rollout is the plain
    version's, unchanged: the hooks only read."""
    batch = packed.shape[1]
    if batch % WARP:
        raise ValueError(f"batch must be a multiple of {WARP}, got {batch}")
    dev = packed.device
    frame = {}
    one_iteration, decide = predict._one_iteration, engine.computer_decide_input
    k = torch.arange(6, device=dev).reshape(6, 1)
    order_b = torch.where(k < 3, 2 - k, 8 - k)  # candidate at position p, coin 1

    def counting_iteration(x, y, vx, vy, count, full_rule):
        frame["live"] += (vx != 0).to(torch.int32)
        out = one_iteration(x, y, vx, vy, count, full_rule)
        if count == 1:  # the true ball (lane 0) before and after its first iteration
            frame["start"] = torch.stack([x[0], y[0], vx[0], vy[0]])
            frame["first"] = torch.stack([o[0] for o in out])
        return out

    def counting_decide(p, other, ball, cand, is_player2, ds):
        out = decide(p, other, ball, cand, is_player2, ds)
        seat = int(is_player2)
        asks = (((p.state == 1) | (p.state == 2)) & ((ball.x - p.x).abs() < 48) &
                ((ball.y - p.y).abs() < 48))
        coin = site_value(out[2].key, out[2].counter - 1, 2)  # its last draw: the smash coin
        lb = C.GROUND_HALF_WIDTH if is_player2 else 0
        far_side = (C.GROUND_WIDTH if is_player2 else 0) + C.GROUND_HALF_WIDTH
        accepted = (((cand <= lb) | (cand >= far_side)) &
                    ((cand - other.x).abs() > C.PLAYER_LENGTH))
        order = torch.where(coin == 0, k, order_b).expand(6, batch)
        acc = accepted.gather(0, order).to(torch.int32)
        iters = frame["live"][1:].gather(0, order)
        searching = asks & (acc.cumsum(0) - acc == 0)
        loops = torch.where(searching, iters, 0)
        frame["asks"][seat] = asks
        frame["needed"][seat] = loops.sum(0)
        frame["serial"] += loops.reshape(6, -1, WARP).amax(-1).sum(0)
        return out

    rows = {name: [] for name in LandingWork._fields}
    landed_after = None  # the previous frame's true ball after its first iteration, if it landed
    p1, p2, ball, game = fused_step._split(packed)
    predict._one_iteration, engine.computer_decide_input = counting_iteration, counting_decide
    try:
        for _ in range(frames):
            frame.pop("start", None)
            frame.update(live=torch.zeros((7, batch), dtype=torch.int32, device=dev),
                         asks=torch.zeros((2, batch), dtype=torch.bool, device=dev),
                         needed=torch.zeros((2, batch), dtype=torch.int32, device=dev),
                         serial=torch.zeros(batch // WARP, dtype=torch.int32, device=dev))
            p1, p2, ball, game = fused_step._fused_frame(config, p1, p2, ball, game)
            live = frame["live"]
            frame["serial"] += live[0].reshape(-1, WARP).amax(-1)
            rows["true_iterations"].append(live[0])
            rows["asks"].append(frame["asks"])
            rows["needed"].append(frame["needed"])
            rows["candidate_iterations"].append(
                torch.where(frame["asks"].any(0), live[1:].sum(0), 0))
            rows["serial_steps"].append(frame["serial"])
            continues = torch.zeros(batch, dtype=torch.bool, device=dev)
            if landed_after is not None and "start" in frame:
                continues = (frame["start"] == landed_after[0]).all(0) & landed_after[1]
            rows["continues"].append(continues)
            landed_after = None
            if "start" in frame:
                # Live after its first iteration (vx != 0) and landed within the cap.
                landed_after = (frame["first"], (frame["first"][2] != 0) &
                                (live[0] < C.INFINITE_LOOP_LIMIT))
    finally:
        predict._one_iteration, engine.computer_decide_input = one_iteration, decide
    return fused_step._join(p1, p2, ball, game), LandingWork(
        *(torch.stack(rows[name]) for name in LandingWork._fields))


def instance_lines(source: Path) -> list[str]:
    """``-Xptxas -v`` of a ``fused_step.cu``, a line per kernel instance:
    ``fused_rollout_kernel<C1, C2, counts>`` (the computer flags and whether
    it is the counting instance), registers, stack and spills."""
    lines = []
    for entry, regs, stack, stores, loads in _build.resource_usage(source):
        m = re.search(r"fused_rollout_kernelILb(\d)ELb(\d)E(?:NS_\d+(\w+?)EE)?E", entry)
        name = (f"fused_rollout_kernel<{m.group(1)}, {m.group(2)}"
                f"{', ' + m.group(3) if m.group(3) else ''}>" if m else entry)
        lines.append(f"{name}: {regs} registers, {stack} B stack, spill stores {stores} B, "
                     f"spill loads {loads} B")
    return lines


def lane_efficiency(counts: dict) -> float:
    """Useful iterations over the lane-steps the pool ran."""
    return counts["iterations"] / max(WARP * counts["pool_steps"], 1)


def serial_efficiency(work: LandingWork) -> float:
    """The one-thread design's lane efficiency, estimated: the iterations its
    lazy search needs over 32 x its loop steps."""
    useful = int(work.true_iterations.sum()) + int(work.needed.sum())
    return useful / max(WARP * int(work.serial_steps.sum()), 1)


def continuing_share(work: LandingWork) -> float:
    """The share of the true ball's iterations spent in frames whose true
    ball continues the previous frame's trajectory."""
    total = int(work.true_iterations.sum())
    return int(work.true_iterations[work.continues].sum()) / max(total, 1)


def pool_report(counts: dict, work: LandingWork) -> str:
    """The counting instance's counts beside the plain version's, for one
    call from one state."""
    longest = int(work.true_iterations.reshape(work.true_iterations.shape[0], -1, WARP)
                  .amax(-1).sum())
    return (f"{counts}; lane efficiency {lane_efficiency(counts):.4f} (iterations / (32 x "
            f"pool steps)); the one-thread design's, estimated from the plain version's "
            f"counts, {serial_efficiency(work):.4f} ({int(work.serial_steps.sum())} warp loop "
            f"steps); the warps' longest true balls alone {longest} steps; candidate "
            f"iterations {int(work.candidate_iterations.sum())} pooled, "
            f"{int(work.needed.sum())} needed lazily; true-ball iterations "
            f"{int(work.true_iterations.sum())}, {continuing_share(work):.4f} of them in "
            f"frames that continue the previous frame's trajectory")


def build(csrc: Path) -> ctypes.CDLL:
    """``csrc``'s ``fused_step.cu`` built with the port's nvcc flags (into
    ``build/kernels/``, named by a hash of its sources), bound as the repo's
    library is."""
    lib = ctypes.CDLL(str(_build.build("fused_step", ("fused_step.cu",), csrc=csrc)))
    lib.fused_rollout_launch.argtypes = fused_step._library().fused_rollout_launch.argtypes
    lib.fused_rollout_launch.restype = ctypes.c_int
    return lib


def live_state(config: EnvConfig, batch: int, calls: int) -> torch.Tensor:
    """The packed state after ``calls`` 100-frame calls from a reset (the
    repo's kernel, action key 1, as ``chip_smoke.py`` phase 8)."""
    state, _ = PikaZoo(config).reset_batch(0, batch, device="cuda")
    packed = fused_step.pack_state(state, 1)
    for _ in range(calls):
        fused_step.rollout_packed(packed, config, FRAMES)
    return packed


def time_builds(label: str, libs: dict, config: EnvConfig, start: torch.Tensor,
                reps: int, card: str) -> dict:
    """Each build's ms a call in turns, first to last and back; every
    build's state bit-equal to the repo's at the end."""
    clock = timer(start.device)
    bufs = {name: start.clone() for name in libs}
    original = fused_step._library
    times = {name: [] for name in libs}
    try:
        for name in list(libs) + list(reversed(libs)):
            fused_step._library = lambda lib=libs[name]: lib
            buf = bufs[name]

            def calls():
                for _ in range(reps):
                    fused_step.rollout_packed(buf, config, FRAMES)
            times[name].append(clock(calls) * 1e3 / reps)
    finally:
        fused_step._library = original
    torch.cuda.synchronize()
    for name, buf in bufs.items():
        if not torch.equal(buf, bufs["change"]):
            raise AssertionError(f"{label}: build {name} != change after the same frames")
    text = ", ".join(f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items())
    print(f"k3_probe time [{label}] B={start.shape[1]} x {FRAMES} frames, ms a call: "
          f"{text}; all builds bit-equal [{card}]", flush=True)
    return times


def run_card(opts, card: str) -> int:
    libs = {"change": fused_step._library()}
    sources = {"change": _build.CSRC_DIR}
    if opts.parent:
        csrc = Path(opts.parent)
        csrc = csrc / "pikazoo_tpu_torch" / "csrc" if (csrc / "pikazoo_tpu_torch").is_dir() else csrc
        libs["parent"] = build(csrc)
        sources["parent"] = csrc
    if "parent" in libs:  # parent first: parent, change, change, parent
        libs = {"parent": libs.pop("parent"), **libs}
    for name, csrc in sources.items():
        for line in instance_lines(csrc / "fused_step.cu"):
            print(f"k3_probe ptxas [{name}] {line}", flush=True)

    ai = live_state(AI_CONFIG, 65536, 5)
    random = live_state(EnvConfig(), 262144, 2)
    time_builds("AI self-play", libs, AI_CONFIG, ai, opts.reps, card)
    time_builds("random actions", libs, EnvConfig(), random, opts.reps, card)

    counted = ai.clone()
    counts = fused_step.rollout_packed_counted(counted, AI_CONFIG, FRAMES)
    plain, work = landing_work(ai, AI_CONFIG, FRAMES)
    if not torch.equal(plain, counted):
        raise AssertionError("the counting instance != the plain version")
    print(f"k3_probe pool [AI self-play] B=65536 x {FRAMES} frames: "
          f"{pool_report(counts, work)} [{card}]", flush=True)
    return 0


def run_cpu(opts) -> int:
    state, _ = PikaZoo(AI_CONFIG).reset_batch(0, opts.batch, device="cpu")
    packed = fused_step.pack_state(state, 1)
    _, work = landing_work(packed, AI_CONFIG, opts.frames)
    print(f"k3_probe landing work [AI self-play, CPU] B={opts.batch} x {opts.frames} frames: "
          f"true-ball iterations {int(work.true_iterations.sum())}, asks "
          f"{work.asks.sum((0, 2)).tolist()}, candidate iterations needed "
          f"{int(work.needed.sum())}, pooled {int(work.candidate_iterations.sum())}; "
          f"the one-thread design's lane efficiency {serial_efficiency(work):.4f}; "
          f"{continuing_share(work):.4f} of the true-ball iterations in frames that continue "
          f"the previous frame's trajectory", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--parent", default="", help="a checkout (or its csrc/) to time beside")
    ap.add_argument("--reps", type=int, default=20, help="calls a timing")
    ap.add_argument("--batch", type=int, default=1024, help="envs on the CPU")
    ap.add_argument("--frames", type=int, default=20, help="frames on the CPU")
    opts = ap.parse_args(argv)
    device = resolve(opts.device, "k3_probe")
    if device.type == "cpu":
        return run_cpu(opts)
    return run_card(opts, card_line())


if __name__ == "__main__":
    sys.exit(main())
