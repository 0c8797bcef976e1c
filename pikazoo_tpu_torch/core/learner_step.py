"""The learner's env step as one kernel launch: ``csrc/learner_step.cu``.

``PikaZoo.step_batch_learner_fm`` calls :func:`learner_step` for a CUDA state
and its plain version, ``PikaZoo.step_batch_learner_fm_plain`` (the eager
ops), for a CPU state.  The kernel repeats the plain version bit for bit:
every ``EnvState`` leaf, the observation bits, the reward bits (-0.0
included) and ``terminated``.  On CUDA it launches or raises: there is no
fallback.

The kernel replaces no TPU kernel: the JAX package jits this step, where
eager PyTorch ran it as ~1,380 launches a frame.  It is bound by bytes: at
B = 65,536 a frame reads and writes the 54 state rows and reads the actions,
and writes the (35, 2B) bf16 observations and the (2B,) rewards, ~38.5 MB or
~11.5 us at 3.35 TB/s; one lane an env reads and writes each row once.

State between frames: the kernel reads each of the incoming state's 54 rows
where it lies (an address and an element stride a row: no pack, whatever
tensors hold the leaves), and writes the new state into a fresh int32 buffer
of 54 x B whose views are the returned leaves, so a state the caller was
handed is never overwritten.
"""

from __future__ import annotations

import array
import ctypes
import functools
from typing import List, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core.input import clamp_action
from pikazoo_tpu_torch.core.state import I32, BallState, PlayerState
from pikazoo_tpu_torch.envs.observations import OBS_DIM, OBS_HIGH, OBS_LOW
from pikazoo_tpu_torch.envs.pika_volley import SERVE_MODES, EnvConfig, EnvState

SOURCES = ("learner_step.cu",)

_BODY = 2 * len(PlayerState._fields) + len(BallState._fields)  # p1, p2, ball rows
# The game rows in the kernel's field order (csrc/env_frame.cuh enum Field,
# without K3's action-key rows): (EnvState leaf, column of a (B, 2) leaf).
_GAME_ROWS = (("power_hit_key_down_prev", 0), ("power_hit_key_down_prev", 1),
              ("scores", 0), ("scores", 1), ("is_player2_serve", None),
              ("round_ended", None), ("game_ended", None), ("step_count", None),
              ("draw_counter", None), ("rng_key", 0), ("rng_key", 1))
ROWS = _BODY + len(_GAME_ROWS)
# The game leaves in EnvState order and their widths: the new state's buffer
# holds p1's, p2's and the ball's rows, then these leaves, each contiguous.
_GAME_LEAVES = tuple(EnvState._fields[3:])
_WIDTHS = {name: 1 if column is None else 2 for name, column in _GAME_ROWS}
# The launch's arguments (csrc/learner_step.cu Args), 8-byte words: the rows'
# addresses and strides in and out, the actions', observations' and rewards'
# addresses, B.
_ARGS_BYTES = 8 * (4 * ROWS + 5)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_build.load("learner_step", SOURCES))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry points' types of a build of ``csrc/learner_step.cu``
    (the card's or a host build) and check its layout and observation
    bounds against this module's."""
    lib.learner_step_rows.restype = ctypes.c_int
    lib.learner_step_args_bytes.restype = ctypes.c_int
    if (lib.learner_step_rows(), lib.learner_step_args_bytes()) != (ROWS, _ARGS_BYTES):
        raise RuntimeError(f"csrc/learner_step.cu takes {lib.learner_step_rows()} rows in "
                           f"{lib.learner_step_args_bytes()} bytes of arguments, the wrapper "
                           f"{ROWS} in {_ARGS_BYTES}")
    low, high = (ctypes.c_int32 * OBS_DIM)(), (ctypes.c_int32 * OBS_DIM)()
    lib.learner_step_obs_bounds(low, high)
    if list(low) != OBS_LOW.tolist() or list(high) != OBS_HIGH.tolist():
        raise RuntimeError("csrc/learner_step.cu normalises the observations with other "
                           f"bounds than OBS_LOW / OBS_HIGH: {list(low)} / {list(high)}")
    fn = lib.learner_step_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _rows(state: EnvState, batch: int, device: torch.device) -> List[int]:
    """The state's 54 rows in the kernel's order: their addresses, then their
    element strides.  Raises unless every leaf is int32 on ``device`` with
    the batch shape, ``(batch, 2)`` for a pair."""
    rows = ([(leaf, None) for leaf in (*state.p1, *state.p2, *state.ball)] +
            [(getattr(state, name), column) for name, column in _GAME_ROWS])
    addresses, strides = [], []
    for leaf, column in rows:
        shape = (batch,) if column is None else (batch, 2)
        if leaf.dtype != I32 or leaf.device != device or leaf.shape != shape:
            raise ValueError(f"the learner step takes int32 state leaves of shape (B,) or "
                             f"(B, 2) on {device}, got {leaf.dtype} {tuple(leaf.shape)} "
                             f"on {leaf.device}")
        column_offset = 0 if column is None else column * leaf.stride(1)
        addresses.append(leaf.data_ptr() + 4 * column_offset)
        strides.append(leaf.stride(0))
    return addresses + strides


@functools.lru_cache(maxsize=8)
def _layout(batch: int) -> Tuple[List[int], List[int], List[int]]:
    """The new state's buffer: its split sizes (the body's rows, then each
    game leaf), and each kernel row's offset and element stride in it."""
    sizes = [batch] * _BODY + [_WIDTHS[name] * batch for name in _GAME_LEAVES]
    starts, offset = {}, _BODY * batch
    for name in _GAME_LEAVES:
        starts[name] = offset
        offset += _WIDTHS[name] * batch
    offsets = [r * batch for r in range(_BODY)] + [
        starts[name] + (column or 0) for name, column in _GAME_ROWS]
    strides = [1] * _BODY + [_WIDTHS[name] for name, _ in _GAME_ROWS]
    return sizes, offsets, strides


def _new_state(batch: int, device: torch.device) -> Tuple[EnvState, List[int]]:
    """A state whose leaves are views of one fresh ``ROWS * batch`` int32
    buffer, and its rows (addresses, then strides)."""
    sizes, offsets, strides = _layout(batch)
    buf = torch.empty(ROWS * batch, dtype=I32, device=device)
    parts = buf.split_with_sizes(sizes)
    n = len(PlayerState._fields)
    game = [part if _WIDTHS[name] == 1 else part.view(batch, 2)
            for name, part in zip(_GAME_LEAVES, parts[_BODY:])]
    state = EnvState(PlayerState(*parts[:n]), PlayerState(*parts[n:2 * n]),
                     BallState(*parts[2 * n:_BODY]), *game)
    base = buf.data_ptr()
    return state, [base + 4 * o for o in offsets] + strides


def _action(a: torch.Tensor, batch: int, device: torch.device) -> torch.Tensor:
    """A seat's ``(batch,)`` actions as contiguous int32 on ``device``; an
    int32 action is clamped in the kernel, any other type here, alike."""
    if a.device != device or a.shape != (batch,):
        raise ValueError(f"the learner step takes ({batch},) actions on {device}, got "
                         f"{tuple(a.shape)} on {a.device}")
    if a.dtype != I32:
        a = clamp_action(a).to(I32)
    return a.contiguous()


def launch(lib: ctypes.CDLL, config: EnvConfig, state: EnvState, a1: torch.Tensor,
           a2: torch.Tensor, stream=None
           ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One learner step through ``lib`` (the card's library, or a host build
    on CPU tensors with ``stream`` None): ``(state, norm_obs, rewards,
    terminated)`` as :meth:`PikaZoo.step_batch_learner_fm` returns them."""
    device, batch = state.scores.device, state.scores.shape[0]
    rows = _rows(state, batch, device)
    a1, a2 = _action(a1, batch, device), _action(a2, batch, device)
    new_state, new_rows = _new_state(batch, device)
    obs = torch.empty((OBS_DIM, 2 * batch), dtype=torch.bfloat16, device=device)
    rewards = torch.empty(2 * batch, dtype=torch.float32, device=device)
    # The launch copies its arguments before it returns.
    args = array.array("Q", [*rows, *new_rows, a1.data_ptr(), a2.data_ptr(),
                             obs.data_ptr(), rewards.data_ptr(), batch])
    err = lib.learner_step_launch(
        args.buffer_info()[0], config.winning_score, SERVE_MODES.index(config.serve),
        int(config.is_player1_computer), int(config.is_player2_computer),
        int(config.auto_reset), stream)
    if err != 0:
        raise RuntimeError(f"learner step kernel launch failed: error {err}")
    return new_state, obs, rewards, new_state.game_ended


def learner_step(config: EnvConfig, state: EnvState, a1: torch.Tensor, a2: torch.Tensor
                 ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The learner step of a CUDA state: one launch of the kernel on the
    current stream, not synchronised; adds one to ``learner_step.launches``.
    Returns what :meth:`PikaZoo.step_batch_learner_fm` does; the new state's
    leaves are views of one buffer the kernel wrote."""
    device = state.scores.device
    if device.type != "cuda":
        raise ValueError(f"the learner step kernel runs on CUDA, the state is on {device}")
    with torch.cuda.device(device):
        out = launch(_library(), config, state, a1, a2,
                     torch.cuda.current_stream(device).cuda_stream)
    learner_step.launches += 1
    return out


learner_step.launches = 0
