"""Fused multi-frame rollout: ``frames`` whole env frames in one launch.

Counterpart of ``pikazoo_tpu.core.fused_step``.  The batched state is packed
into one ``(NFIELDS, B)`` int32 matrix (one row per field, in the JAX pack
order, plus two rows of per-env action keys), and every frame samples both
seats' actions in place from the shared threefry PRF, decodes them, and runs
the same env frame as :meth:`PikaZoo.step_batch`.  Actions are keyed on the
env's cumulative ``step_count``, so the stream continues across calls and a
host-side caller can reproduce it (:func:`fused_actions`).  No per-frame
observations or rewards come out: this is the engine for benchmarks,
self-play data generation and AI-vs-AI rollouts.

A CUDA state runs the hand-written Hopper kernel ``csrc/fused_step.cu``
(built by ``pikazoo_tpu_torch._build`` at first use), one launch per call,
with the state held in registers for all frames and the rule AI's landing
loops pooled over each warp's 32 lanes.  A CPU state runs the plain
PyTorch version, a Python loop of :func:`_fused_frame` over the port's
``decode_action_arith`` and ``env_frame`` with the plain landing
simulation.  On CUDA the kernel launches or the call raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core.input import decode_action_arith
from pikazoo_tpu_torch.core.predict import landing_sims_any
from pikazoo_tpu_torch.core.rng import DrawState, fold_key, key_data, threefry2x32
from pikazoo_tpu_torch.core.state import I32, BallState, PlayerState
from pikazoo_tpu_torch.envs.pika_volley import (SERVE_MODES, EnvConfig,
                                                EnvState, env_frame)
from pikazoo_tpu_torch.utils.profiling import trace_annotation

BLOCK_ENVS = 1024  # the batch must be a multiple of this, as in JAX
ACTION_TAG = 2  # threefry word-1 tag of the action stream (the seat adds 0/1)

_PLAYER_FIELDS = list(PlayerState._fields)
_BALL_FIELDS = list(BallState._fields)
# Scalar game fields in pack order (after the p1, p2 and ball blocks).
_GAME_FIELDS = ["latch1", "latch2", "score1", "score2", "is_player2_serve",
                "round_ended", "game_ended", "step_count", "draw_counter",
                "rng_lo", "rng_hi", "akey_lo", "akey_hi"]
NFIELDS = 2 * len(_PLAYER_FIELDS) + len(_BALL_FIELDS) + len(_GAME_FIELDS)

SOURCES = ("fused_step.cu",)

Fields = Tuple[PlayerState, PlayerState, BallState, Dict[str, torch.Tensor]]


def sample_action(akey: torch.Tensor, t: torch.Tensor, seat: int,
                  num_actions: int = 18) -> torch.Tensor:
    """Uniform action from the shared PRF: the first threefry word of
    ``(t, ACTION_TAG + seat)`` under ``akey`` (``(..., 2)`` int32 bits),
    modulo ``num_actions`` in unsigned arithmetic.  ``t`` is the env's
    cumulative step_count."""
    bits, _ = threefry2x32(akey, t, ACTION_TAG + seat)
    return (bits % num_actions).to(I32)


def _action_keys(action_key, batch: int, device) -> torch.Tensor:
    """(batch, 2) int32: env i's action key is ``fold_key(action_key, i)``."""
    base = key_data(action_key, device)
    return fold_key(base, torch.arange(batch, dtype=torch.int64, device=device))


def pack_state(state: EnvState, action_key) -> torch.Tensor:
    """Batched EnvState -> (NFIELDS, B) int32, with the per-env action keys
    of ``action_key`` (an int seed or 2-word key data) in the last two rows."""
    B = state.scores.shape[0]
    akey = _action_keys(action_key, B, state.scores.device)
    cols = (list(state.p1) + list(state.p2) + list(state.ball) +
            [state.power_hit_key_down_prev[:, 0],
             state.power_hit_key_down_prev[:, 1],
             state.scores[:, 0], state.scores[:, 1],
             state.is_player2_serve, state.round_ended, state.game_ended,
             state.step_count, state.draw_counter,
             state.rng_key[:, 0], state.rng_key[:, 1],
             akey[:, 0], akey[:, 1]])
    return torch.stack(cols)


def _split(matrix: torch.Tensor) -> Fields:
    """(NFIELDS, B) -> (p1, p2, ball, game rows by name); rows are views."""
    rows = matrix.unbind(0)
    np1, nb = len(_PLAYER_FIELDS), len(_BALL_FIELDS)
    return (PlayerState(*rows[:np1]), PlayerState(*rows[np1:2 * np1]),
            BallState(*rows[2 * np1:2 * np1 + nb]),
            dict(zip(_GAME_FIELDS, rows[2 * np1 + nb:])))


def _join(p1: PlayerState, p2: PlayerState, ball: BallState,
          game: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(p1) + list(p2) + list(ball) +
                       [game[name] for name in _GAME_FIELDS])


def unpack_state(matrix: torch.Tensor) -> EnvState:
    """(NFIELDS, B) -> batched EnvState; the action-key rows are dropped.
    The scalar leaves are views of ``matrix``'s rows."""
    p1, p2, ball, g = _split(matrix)
    pair = lambda a, b: torch.stack([g[a], g[b]], dim=-1)
    return EnvState(
        p1=p1, p2=p2, ball=ball,
        power_hit_key_down_prev=pair("latch1", "latch2"),
        scores=pair("score1", "score2"),
        is_player2_serve=g["is_player2_serve"], round_ended=g["round_ended"],
        game_ended=g["game_ended"], step_count=g["step_count"],
        rng_key=pair("rng_lo", "rng_hi"), draw_counter=g["draw_counter"])


def fused_actions(action_key, batch: int, frames: int, num_actions: int = 18,
                  start: int = 0, device="cpu") -> torch.Tensor:
    """Host-side reproduction of the in-kernel action stream:
    ``(frames, batch, 2)`` int32.  ``start`` is the envs' step_count at the
    first frame (actions are keyed on the cumulative step_count, not on a
    per-call counter)."""
    akey = _action_keys(action_key, batch, device)
    t = torch.arange(start, start + frames, dtype=torch.int64,
                     device=device).reshape(frames, 1)
    return torch.stack([sample_action(akey, t, seat, num_actions)
                        for seat in (0, 1)], dim=-1)


def _plain_landing(ball: BallState):
    return landing_sims_any(ball.x, ball.y, ball.x_velocity, ball.y_velocity)


def _fused_frame(cfg: EnvConfig, p1: PlayerState, p2: PlayerState,
                 ball: BallState, game: Dict[str, torch.Tensor]) -> Fields:
    """One env step on (B,) rows: action sampling and decode, then the same
    env frame as ``PikaZoo.step_batch``.  Both seats' latches follow the
    sampled actions, even for a computer seat, whose AI then replaces only
    the input."""
    ds = DrawState(key=torch.stack([game["rng_lo"], game["rng_hi"]], dim=-1),
                   counter=game["draw_counter"])
    akey = torch.stack([game["akey_lo"], game["akey_hi"]], dim=-1)
    a1 = sample_action(akey, game["step_count"], 0)
    a2 = sample_action(akey, game["step_count"], 1)
    inp1, latch1 = decode_action_arith(a1, game["latch1"])
    inp2, latch2 = decode_action_arith(a2, game["latch2"])

    fr = env_frame(cfg, ds, p1, p2, ball, game["score1"], game["score2"],
                   game["is_player2_serve"], game["round_ended"],
                   game["game_ended"], inp1, inp2, landing_fn=_plain_landing)

    game = dict(game, latch1=latch1, latch2=latch2, score1=fr.score1,
                score2=fr.score2, is_player2_serve=fr.is_player2_serve,
                round_ended=fr.round_ended, game_ended=fr.game_ended,
                step_count=game["step_count"] + 1,
                draw_counter=fr.draw_counter)
    return fr.p1, fr.p2, fr.ball, game


def rollout_packed_plain(packed: torch.Tensor, config: EnvConfig,
                         frames: int) -> torch.Tensor:
    """The plain PyTorch version on a packed ``(NFIELDS, B)`` matrix, on any
    device: returns a new matrix and leaves ``packed`` as it was."""
    p1, p2, ball, game = _split(packed)
    for _ in range(frames):
        p1, p2, ball, game = _fused_frame(config, p1, p2, ball, game)
    return _join(p1, p2, ball, game)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_step", SOURCES)
    lib.fused_step_nfields.argtypes = []
    lib.fused_step_nfields.restype = ctypes.c_int
    if lib.fused_step_nfields() != NFIELDS:
        raise RuntimeError(f"csrc/fused_step.cu takes {lib.fused_step_nfields()} "
                           f"rows, the packed state has {NFIELDS}")
    fn = lib.fused_rollout_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counted = lib.fused_rollout_count_launch
    counted.argtypes = fn.argtypes[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
    counted.restype = ctypes.c_int
    lib.fused_step_num_counts.restype = ctypes.c_int
    if lib.fused_step_num_counts() != len(POOL_COUNTS):
        raise RuntimeError(f"csrc/fused_step.cu keeps {lib.fused_step_num_counts()} "
                           f"pool counts, the wrapper names {len(POOL_COUNTS)}")
    return lib


# The counts of the kernel's counting instance (enum Count): true-ball jobs
# and candidate jobs posted, jobs run, sim_step iterations, pool steps
# (warp-wide), and results written other than once (checked by the host
# build only).
POOL_COUNTS = ("true_jobs", "candidate_jobs", "jobs_run", "iterations",
               "pool_steps", "misses")


def _check_frames(frames) -> None:
    if not isinstance(frames, int) or not 0 <= frames < 2 ** 31:
        raise ValueError(f"frames must be an int in [0, 2^31), got {frames!r}")


def _check_device(device: torch.device) -> torch.device:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_rollout has no version for {device}")
    return device


def _check_batch(batch: int) -> None:
    if batch % BLOCK_ENVS != 0:
        raise ValueError(f"batch must be a multiple of {BLOCK_ENVS}, got {batch}")


def _check_packed(packed: torch.Tensor) -> torch.device:
    if packed.dtype != I32 or packed.dim() != 2 or packed.shape[0] != NFIELDS:
        raise ValueError(f"packed state must be ({NFIELDS}, B) int32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("packed state must be contiguous")
    _check_batch(packed.shape[1])
    return _check_device(packed.device)


def rollout_packed(packed: torch.Tensor, config: EnvConfig,
                   frames: int) -> torch.Tensor:
    """Advance a packed ``(NFIELDS, B)`` int32 state ``frames`` frames.

    On CUDA this launches the kernel once, on the current stream, without
    synchronising, and updates ``packed`` IN PLACE (it returns it); each
    launch adds one to ``fused_rollout.launches``.  On the CPU it returns
    :func:`rollout_packed_plain`'s new matrix."""
    _check_frames(frames)
    device = _check_packed(packed)
    if device.type == "cpu":
        return rollout_packed_plain(packed, config, frames)
    if frames == 0:
        return packed
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().fused_rollout_launch(
            *_launch_args(packed, config, frames), stream)
    if err != 0:
        raise RuntimeError(f"fused rollout kernel launch failed: CUDA error {err}")
    fused_rollout.launches += 1
    return packed


def _launch_args(packed: torch.Tensor, config: EnvConfig, frames: int):
    return (packed.data_ptr(), packed.shape[1], frames, config.winning_score,
            SERVE_MODES.index(config.serve), int(config.is_player1_computer),
            int(config.is_player2_computer), int(config.auto_reset))


def rollout_packed_counted(packed: torch.Tensor, config: EnvConfig,
                           frames: int) -> Dict[str, int]:
    """Advance a packed CUDA state in place, as :func:`rollout_packed`, by
    the kernel's counting instance, and return the landing pool's counts
    (:data:`POOL_COUNTS`; ``misses`` stays 0 on the card).  Lane efficiency
    is ``iterations / (32 * pool_steps)``.  A measuring launch: it
    synchronises, and it does not count in ``fused_rollout.launches``."""
    _check_frames(frames)
    if _check_packed(packed).type != "cuda":
        raise ValueError("the counting instance runs on the card only")
    counts = torch.zeros(len(POOL_COUNTS), dtype=torch.int64, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = _library().fused_rollout_count_launch(
            *_launch_args(packed, config, frames), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused rollout counting launch failed: CUDA error {err}")
    return dict(zip(POOL_COUNTS, counts.tolist()))


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _check_state(state: EnvState) -> None:
    leaves = _leaves(state)
    devices = {leaf.device for leaf in leaves}
    if len(devices) != 1:
        raise ValueError(f"state leaves lie on {sorted(map(str, devices))}")
    _check_device(devices.pop())
    for leaf in leaves:
        if leaf.dtype != I32:
            raise TypeError(f"state leaves must be int32, got {leaf.dtype}")
        if not leaf.is_contiguous():
            raise ValueError("state leaves must be contiguous")
    _check_batch(state.scores.shape[0])


def fused_rollout_plain(state: EnvState, action_key, config: EnvConfig,
                        frames: int) -> EnvState:
    """The plain PyTorch version of :func:`fused_rollout`, on any device."""
    _check_frames(frames)
    _check_state(state)
    return unpack_state(rollout_packed_plain(pack_state(state, action_key),
                                             config, frames))


def fused_rollout(state: EnvState, action_key, config: EnvConfig,
                  frames: int) -> EnvState:
    """Advance a batched EnvState ``frames`` frames with sampled actions.

    ``action_key`` is what ``key_data`` takes (an int seed or 2-word key
    data); env i's actions come from ``fold_key(action_key, i)``.  Every leaf
    must be int32, contiguous and on one device, and the batch a multiple of
    ``BLOCK_ENVS``.  A CUDA state launches ``csrc/fused_step.cu`` once, on a
    freshly packed buffer that it updates in place; the returned leaves are
    views of that buffer.  A CPU state runs the plain version.  Each call
    adds one to ``fused_rollout.calls``, the unit of its spans."""
    fused_rollout.calls += 1
    with trace_annotation("fused_rollout", unit=fused_rollout.calls):
        _check_frames(frames)
        with trace_annotation("fused.pack"):
            _check_state(state)
            packed = pack_state(state, action_key)
        with trace_annotation("fused.run"):
            packed = rollout_packed(packed, config, frames)
        with trace_annotation("fused.unpack"):
            return unpack_state(packed)


fused_rollout.launches = 0
fused_rollout.calls = 0
