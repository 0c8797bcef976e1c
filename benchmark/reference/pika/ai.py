"""Rule-based computer AI.

Counterpart of ``pikazoo_tpu.core.ai`` (reference
``let_computer_decide_user_input``, ``physics.py:689-771``, and
``decide_whether_input_power_hit``, ``physics.py:774-817``):

* draws go through the draw-slot stream with the reference's conditional
  consumption, in its order: the reposition coin ``coin20`` only when NOT
  chasing, the stand-by draw only when that coin lands 0, and the smash-order
  coin ``coin2`` only when airborne within 48px of the ball;
* the reference's early-exit double loop over six power-hit candidates is a
  first-accepted select over the precomputed candidate landing points: the
  coin picks one of two enumeration orders, and the minimum of
  ``rank * 8 + candidate index`` over the accepted candidates finds the
  first in that order and carries its index in the low bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import constants as C
from .rng import DrawState, draw
from .state import I32, BallState, PlayerInput, PlayerState


def computer_decide_input(p: PlayerState, other: PlayerState, ball: BallState,
                          candidate_landing_x: torch.Tensor, is_player2: bool,
                          ds: DrawState
                          ) -> Tuple[PlayerInput, torch.Tensor, DrawState]:
    """Decide this frame's input for a computer-controlled player.

    ``candidate_landing_x`` is ``(6,) + S``: the candidate axis first, as in
    the JAX package's shape-generic AI.  Returns the decided input, the
    updated ``computer_where_to_stand_by``, and the advanced draw stream."""
    where = torch.where
    boldness = p.computer_boldness
    expected = ball.expected_landing_point_x
    left_boundary = C.GROUND_HALF_WIDTH if is_player2 else 0
    right_boundary = C.GROUND_WIDTH if is_player2 else C.GROUND_HALF_WIDTH
    far_side = (C.GROUND_WIDTH if is_player2 else 0) + C.GROUND_HALF_WIDTH
    ball_dx = (ball.x - p.x).abs()
    toward_ball = where(p.x < ball.x, 1, -1).to(I32)

    # Reposition target when the ball hangs around the other side.
    hanging = (ball_dx > 100) & (ball.x_velocity.abs() < boldness + 5)
    out_of_side = (expected <= left_boundary) | (expected >= far_side)
    use_midpoint = hanging & out_of_side & (p.computer_where_to_stand_by == 0)
    virtual_expected = where(use_midpoint,
                             left_boundary + C.GROUND_HALF_WIDTH // 2, expected)

    chase = (virtual_expected - p.x).abs() > boldness + 8
    xd = where(chase, where(p.x < virtual_expected, 1, -1).to(I32), 0)

    # Reposition coin + conditional stand-by draw (physics.py:728-729).
    coin20, ds = draw(ds, ~chase, 20)
    standby_consume = ~chase & (coin20 == 0)
    standby, ds = draw(ds, standby_consume, 2)
    where_to_stand_by = where(standby_consume, standby,
                              p.computer_where_to_stand_by)

    # --- grounded (state 0): jump timing and dive decision ---
    grounded = p.state == 0
    jump = (ball.x_velocity.abs() < boldness + 3) & \
           (ball_dx < C.PLAYER_HALF_LENGTH) & \
           (ball.y > -36) & (ball.y < 10 * boldness + 84) & \
           (ball.y_velocity > 0)
    yd = where(grounded & jump, -1, 0).to(I32)

    dive = grounded & (expected > left_boundary) & (expected < right_boundary) & \
           (ball_dx > boldness * 5 + C.PLAYER_LENGTH) & \
           (ball.x > left_boundary) & (ball.x < right_boundary) & \
           (ball.y > 174)
    power = dive.to(I32)
    xd = where(dive, toward_ball, xd)

    # --- airborne (state 1 or 2): chase and smash ---
    airborne = (p.state == 1) | (p.state == 2)
    xd = where(airborne & (ball_dx > 8), toward_ball, xd)

    near = (ball_dx < 48) & ((ball.y - p.y).abs() < 48)
    smash_consume = airborne & near
    coin2, ds = draw(ds, smash_consume, 2)
    # Order "B" (coin 1) is the involution c < 3 ? 2 - c : 8 - c of the
    # canonical order (reference loops physics.py:796-816).
    c_idx = torch.arange(6, dtype=I32, device=p.x.device).reshape(
        (6,) + (1,) * p.x.dim())
    position = where(coin2 == 0, c_idx, where(c_idx < 3, 2 - c_idx, 8 - c_idx))
    accepted = ((candidate_landing_x <= left_boundary) |
                (candidate_landing_x >= far_side)) & \
               ((candidate_landing_x - other.x).abs() > C.PLAYER_LENGTH)
    best = (where(accepted, position, 99) * 8 + c_idx).amin(dim=0)
    found = (best >> 3) < 99
    first = best & 7
    will_power_hit = smash_consume & found
    cand_xd = (first < 3).to(I32)
    cand_yd = (first % 3) - 1
    xd = where(will_power_hit, cand_xd, xd)
    yd = where(will_power_hit, cand_yd, yd)
    power = where(will_power_hit, 1, power)
    # Forced up-input when the opponent is close (physics.py:770-771).
    force_up = will_power_hit & ((other.x - p.x).abs() < 80) & (cand_yd != -1)
    yd = where(force_up, -1, yd)

    return PlayerInput(xd, yd, power), where_to_stand_by, ds
