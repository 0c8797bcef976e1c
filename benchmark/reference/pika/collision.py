"""Ball-player collision test and response.

Counterpart of ``pikazoo_tpu.core.collision`` (reference AABB test,
``physics.py:340-356``, and hit response, ``physics.py:580-641``), with the
response masked by ``active`` so it runs unconditionally over the batch.  The
kick draw is consumed only where the response fires AND the computed x
velocity is zero (the reference keeps the *old* velocity when
ball.x == player.x, and only then tests for zero).  ``|diff| // 3`` is taken
on a non-negative value, so floor and truncation agree.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import constants as C
from .rng import DrawState, draw
from .state import I32, BallState, PlayerInput


def ball_player_overlap(ball: BallState, player_x: torch.Tensor,
                        player_y: torch.Tensor) -> torch.Tensor:
    return ((ball.x - player_x).abs() <= C.PLAYER_HALF_LENGTH) & \
           ((ball.y - player_y).abs() <= C.PLAYER_HALF_LENGTH)


def collision_response(ball: BallState, player_x: torch.Tensor,
                       inp: PlayerInput, player_state: torch.Tensor,
                       active: torch.Tensor, ds: DrawState
                       ) -> Tuple[BallState, torch.Tensor, DrawState]:
    """Apply the hit response where ``active``; returns (ball, power_hit_sound, ds)."""
    where = torch.where
    diff = ball.x - player_x
    vx = where(diff < 0, -(diff.abs() // 3),
               where(diff > 0, diff.abs() // 3, ball.x_velocity))

    kick_consume = active & (vx == 0)
    kick, ds = draw(ds, kick_consume, 3)
    vx = where(kick_consume, kick - 1, vx)

    abs_vy = ball.y_velocity.abs()
    vy = where(abs_vy < 15, -15, -abs_vy)

    # Jumping-and-power-hitting player: directed smash.
    smash = player_state == 2
    smash_speed = (inp.x_direction.abs() + 1) * 10
    vx = where(smash, where(ball.x < C.GROUND_HALF_WIDTH, smash_speed,
                            -smash_speed), vx)
    vy = where(smash, vy.abs() * inp.y_direction * 2, vy)

    hit = active & smash
    w = lambda new, old: where(active, new, old)
    ws = lambda new, old: where(hit, new, old)
    new_ball = ball._replace(
        x_velocity=w(vx, ball.x_velocity),
        y_velocity=w(vy, ball.y_velocity),
        punch_effect_x=ws(ball.x, ball.punch_effect_x),
        punch_effect_y=ws(ball.y, ball.punch_effect_y),
        punch_effect_radius=ws(C.BALL_RADIUS, ball.punch_effect_radius),
        is_power_hit=w(smash.to(I32), ball.is_power_hit),
    )
    return new_ball, hit.to(I32), ds
