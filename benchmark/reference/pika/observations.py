"""Observation layout and bounds.

35-dim int32 observation per agent, mirrored: dims 0-12 describe "me",
13-25 the opponent, 26-34 the ball (same layout as
``pikazoo_tpu.envs.observations``):

  per player (13): x, y, y_velocity, diving_direction,
      lying_down_duration_left, frame_number, delay_before_next_frame,
      one_hot(state, 5), power_hit_key_is_down_previous
  ball (9): x, y, previous_x, previous_y, previous_previous_x,
      previous_previous_y, x_velocity, y_velocity, is_power_hit
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .input import NUM_ACTIONS
from .state import I32, BallState, PlayerState

OBS_DIM = 35

# 108 = the highest point a player can reach (jump from y=244 with v=-16).
_PLAYER_LOW = [C.PLAYER_HALF_LENGTH, 108, -15, -1, -2, 0, 0,
               0, 0, 0, 0, 0, 0]
_PLAYER_HIGH = [C.GROUND_WIDTH - C.PLAYER_HALF_LENGTH,
                C.PLAYER_TOUCHING_GROUND_Y_COORD, 16, 1, 3, 4, 4,
                1, 1, 1, 1, 1, 1]
_BALL_LOW = [C.BALL_RADIUS, 0, 0, 0, 0, 0, -20, -124, 0]
_BALL_HIGH = [C.GROUND_WIDTH, C.BALL_TOUCHING_GROUND_Y_COORD,
              C.GROUND_WIDTH, C.BALL_TOUCHING_GROUND_Y_COORD,
              C.GROUND_WIDTH, C.BALL_TOUCHING_GROUND_Y_COORD,
              20, 124, 1]

OBS_LOW = np.asarray(_PLAYER_LOW + _PLAYER_LOW + _BALL_LOW, np.int32)
OBS_HIGH = np.asarray(_PLAYER_HIGH + _PLAYER_HIGH + _BALL_HIGH, np.int32)

__all__ = ["OBS_DIM", "OBS_LOW", "OBS_HIGH", "NUM_ACTIONS", "assemble_obs",
           "assemble_norm_obs_fm"]

# Normalisation constants of the learner layouts (as float32, like JAX's).
_LOW_F = OBS_LOW.astype(np.float32)
_SPAN_F = (OBS_HIGH - OBS_LOW).astype(np.float32)


def _player_cols(p: PlayerState, latch: torch.Tensor) -> list:
    """13 per-field columns in observation order (incl. the 5-wide one-hot)."""
    return ([p.x, p.y, p.y_velocity, p.diving_direction,
             p.lying_down_duration_left, p.frame_number,
             p.delay_before_next_frame]
            + [(p.state == k).to(I32) for k in range(5)]
            + [latch])


def _ball_cols(b: BallState) -> list:
    return [b.x, b.y, b.previous_x, b.previous_y,
            b.previous_previous_x, b.previous_previous_y,
            b.x_velocity, b.y_velocity, b.is_power_hit]


def assemble_obs(p1: PlayerState, p2: PlayerState, b: BallState,
                 latch: torch.Tensor) -> torch.Tensor:
    """``S + (2, 35)`` mirrored observations from leaves of batch shape S:
    row 0 for player 1, row 1 for player 2.  ``latch`` is ``S + (2,)``."""
    c1 = _player_cols(p1, latch[..., 0])
    c2 = _player_cols(p2, latch[..., 1])
    cb = _ball_cols(b)
    return torch.stack([torch.stack(c1 + c2 + cb, dim=-1),
                        torch.stack(c2 + c1 + cb, dim=-1)], dim=-2)


def _norm_seats(p1: PlayerState, p2: PlayerState, b: BallState,
                latch: torch.Tensor, dim: int) -> torch.Tensor:
    """Both seats' normalised bf16 columns stacked on ``dim`` (0: feature-
    major ``(35, B)`` per seat, -1: ``(B, 35)``), seat-blocked along the
    other axis.  Each column is ``(c.float() - low) / span`` in float32 (a
    true division, as ``networks.normalize_obs`` and JAX compute it), then
    rounded once to bf16, so the result is bit-identical with JAX's.  The
    bounds are divided as tensors on the leaves' device: a Python scalar
    divisor may be turned into a reciprocal multiply on CUDA."""
    device = b.x.device
    shape = (-1, 1) if dim == 0 else (1, -1)
    low = torch.tensor(_LOW_F, device=device).reshape(shape)
    span = torch.tensor(_SPAN_F, device=device).reshape(shape)

    def seat(me, opp, latch_me, latch_opp):
        cols = (_player_cols(me, latch_me) + _player_cols(opp, latch_opp)
                + _ball_cols(b))
        raw = torch.stack(cols, dim=dim).float()
        return ((raw - low) / span).to(torch.bfloat16)

    seat_axis = 1 if dim == 0 else 0
    return torch.cat([seat(p1, p2, latch[:, 0], latch[:, 1]),
                      seat(p2, p1, latch[:, 1], latch[:, 0])], dim=seat_axis)


def assemble_norm_obs_fm(p1: PlayerState, p2: PlayerState, b: BallState,
                         latch: torch.Tensor) -> torch.Tensor:
    """(35, 2B) bf16 normalised mirrored observations, feature-major: the
    transpose of :func:`assemble_norm_obs_blocked` (same per-column
    arithmetic).  This is the layout the PPO rollout and K1 consume."""
    return _norm_seats(p1, p2, b, latch, dim=0)
