"""Ball-world collision and integration.

Counterpart of ``pikazoo_tpu.core.ball`` (reference
``process_collision_between_ball_and_world_and_set_ball_position``,
``physics.py:359-436``), with its deliberate quirks:

* the asymmetric wall bound ``x > GROUND_WIDTH``;
* the hyper-ball fine-rotation glitch: ``fine_rotation += x_velocity // 2``
  with *floor* division (torch's integer ``//`` floors, as Python does;
  truncating division would change negative velocities);
* the net-pillar top band: bounce off the top for y <= 192, push out sideways
  below it.

Returns the new ball and a 0/1 ``touched_ground`` flag; on the touching frame
the ball's y is pinned to 252, x is NOT advanced, y_velocity flips, and the
punch-effect witness fields are set.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import constants as C
from .state import I32, BallState


def ball_world_step(b: BallState) -> Tuple[BallState, torch.Tensor]:
    # Rotation bookkeeping (hyper-ball glitch preserved: ==50 passes through).
    fr = b.fine_rotation + b.x_velocity // 2
    fr = torch.where(fr < 0, fr + 50, torch.where(fr > 50, fr - 50, fr))
    rotation = fr // 10

    # Wall bounce — asymmetric bound kept on purpose.
    future_x = b.x + b.x_velocity
    vx = torch.where((future_x < C.BALL_RADIUS) | (future_x > C.GROUND_WIDTH),
                     -b.x_velocity, b.x_velocity)

    # Ceiling.
    vy = torch.where(b.y + b.y_velocity < 0, 1, b.y_velocity)

    # Net pillar: top bounce vs side push-out.
    at_net = ((b.x - C.GROUND_HALF_WIDTH).abs() < C.NET_PILLAR_HALF_WIDTH) & \
             (b.y > C.NET_PILLAR_TOP_TOP_Y_COORD)
    on_top = b.y <= C.NET_PILLAR_TOP_BOTTOM_Y_COORD
    vy = torch.where(at_net & on_top & (vy > 0), -vy, vy)
    side_vx = torch.where(b.x < C.GROUND_HALF_WIDTH, -vx.abs(), vx.abs())
    vx = torch.where(at_net & ~on_top, side_vx, vx)

    future_y = b.y + vy
    t = future_y > C.BALL_TOUCHING_GROUND_Y_COORD

    new = b._replace(
        previous_x=b.x,
        previous_y=b.y,
        previous_previous_x=b.previous_x,
        previous_previous_y=b.previous_y,
        fine_rotation=fr,
        rotation=rotation,
        x=torch.where(t, b.x, b.x + vx),
        y=torch.where(t, C.BALL_TOUCHING_GROUND_Y_COORD, future_y),
        x_velocity=vx,
        y_velocity=torch.where(t, -vy, vy + 1),
        punch_effect_x=torch.where(t, b.x, b.punch_effect_x),
        punch_effect_y=torch.where(
            t, C.BALL_TOUCHING_GROUND_Y_COORD + C.BALL_RADIUS, b.punch_effect_y),
        punch_effect_radius=torch.where(t, C.BALL_RADIUS, b.punch_effect_radius),
    )
    return new, t.to(I32)
