"""Landing-point forward simulation: the reference's frame loop.

Seven lanes per env: lane 0, the true ball under the full net rule (strict
``y < 192`` top band, side push-out below it), gives
``expected_landing_point_x``; lanes 1-6, the power-hit candidates under the
flip-only "mistake" net rule, give the landing points the AI picks its
smash from.  Candidate k has ``|x_dir| = (k < 3)`` and ``y_dir = k % 3 - 1``.
The seven lanes run in one loop, iteration by iteration, as the reference
engine does.  A frozen copy of the port's plain frame loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import constants as C

# Loop iterations between two "any lane still live?" checks.  Each check
# reads a flag back to the host; finished lanes are frozen by the masks, so
# iterating past a lane's exit changes nothing.
UNROLL = 32


def _one_iteration(x, y, vx, vy, count: int, full_rule: torch.Tensor,
                   cap: int = C.INFINITE_LOOP_LIMIT):
    # A finished lane (vx == 0) keeps vx2 == 0 below (the wall and net rules
    # only negate or take |vx|), so it needs no mask: its x and vx stay put,
    # and its y and vy, which no result reads, drift harmlessly.
    future_x = x + vx
    vx1 = torch.where((future_x < C.BALL_RADIUS) | (future_x > C.GROUND_WIDTH),
                      -vx, vx)
    vy1 = torch.where(y + vy < 0, 1, vy)
    at_net = ((x - C.GROUND_HALF_WIDTH).abs() < C.NET_PILLAR_HALF_WIDTH) & \
             (y > C.NET_PILLAR_TOP_TOP_Y_COORD)
    # Full rule: bounce off the top band (y < 192), push out sideways below.
    # Mistake rule: bounce anywhere in the net column.  A bounce makes a
    # downward vy upward: -|vy1| (a vy1 <= 0 is left as it is).
    bounce = at_net & (~full_rule | (y < C.NET_PILLAR_TOP_BOTTOM_Y_COORD))
    vy2 = torch.where(bounce, -vy1.abs(), vy1)
    side_vx = torch.where(x < C.GROUND_HALF_WIDTH, -vx1.abs(), vx1.abs())
    vx2 = torch.where(at_net & ~bounce, side_vx, vx1)
    y = y + vy2
    # Landing (y > 252) or the iteration cap finishes a lane; x is not
    # advanced on the finishing iteration.
    if count >= cap:
        vx = torch.zeros_like(vx2)
    else:
        vx = torch.where(y <= C.BALL_TOUCHING_GROUND_Y_COORD, vx2, 0)
    return x + vx, y, vx, vy2 + 1


def sim_loop(x, y, vx, vy, full_rule: torch.Tensor, cap: int = C.INFINITE_LOOP_LIMIT,
             live=None) -> torch.Tensor:
    """Bounded landing loop over int32 tensors of one shape; ``full_rule``
    (bool, broadcastable) selects each lane's net rule.  Returns the landing x.

    ``vx == 0`` encodes "finished": a live lane's vx never becomes 0 (the
    wall and net rules only negate it), and x is not advanced on the
    finishing iteration, so a finished lane's frozen x IS its result.  A
    lane that starts with ``vx == 0`` never iterates (the net-top trap's fast
    exit).  Every live lane has been live since iteration 0, so one Python
    counter is every lane's iteration count, capped at ``cap`` (the
    reference's 1000).  ``live``, if given, is an int32 tensor of the lanes'
    shape that gains 1 for each iteration in which a lane was live."""
    count = 0
    while bool((vx != 0).any()):
        for _ in range(UNROLL):
            count += 1
            if live is not None:
                live += (vx != 0).to(torch.int32)
            x, y, vx, vy = _one_iteration(x, y, vx, vy, count, full_rule, cap)
    return x


def candidate_velocities(x, vy, lane):
    """Candidate launch velocities (physics.py:841-845) for candidate index
    ``lane`` (canonical order "A"): toward the far side at (|x_dir| + 1) *
    10, and |vy| * y_dir * 2."""
    speed = ((lane < 3).to(torch.int32) + 1) * 10
    return (torch.where(x < C.GROUND_HALF_WIDTH, speed, -speed),
            vy.abs() * ((lane % 3) - 1) * 2)


def landing_sims_any(x: torch.Tensor, y: torch.Tensor, vx: torch.Tensor,
                     vy: torch.Tensor, cap: int = C.INFINITE_LOOP_LIMIT, live=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """7-lane landing simulation over int32 tensors of shape S: returns
    ``(expected with shape S, candidates with shape (6,) + S)``.  ``cap`` and
    ``live`` (``(7,) + S`` int32) go to :func:`sim_loop`."""
    ones = (1,) * x.dim()
    lane = torch.arange(7, dtype=torch.int32, device=x.device).reshape((7,) + ones)
    cvx, cvy = candidate_velocities(x, vy, lane - 1)
    lane_vx = torch.where(lane == 0, vx, cvx)
    lane_vy = torch.where(lane == 0, vy, cvy)
    shape7 = lane_vx.shape
    out = sim_loop(x.expand(shape7), y.expand(shape7), lane_vx, lane_vy,
                   full_rule=lane == 0, cap=cap, live=live)
    return out[0], out[1:]
