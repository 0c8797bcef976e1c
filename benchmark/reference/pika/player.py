"""Player movement and finite-state machine.

Counterpart of ``pikazoo_tpu.core.player`` (reference
``process_player_movement_and_set_player_position``, ``physics.py:439-564``,
plus ``process_game_end_frame_for``, ``physics.py:567-577``): every branch of
the imperative code is a ``torch.where`` in the same evaluation order, so
intermediate-state interactions (landing changing ``state`` before the
power-hit check reads it) are preserved exactly.  The reference's early
return for a lying player (state 4) computes both paths and selects on the
entry state.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import constants as C
from .state import I32, PlayerInput, PlayerState


def move_player(p: PlayerState, inp: PlayerInput, is_player2: bool
                ) -> Tuple[PlayerState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance one player one frame.  Returns (player, chu, pika, pipikachu)
    sound event flags."""
    where = torch.where
    entry_lying = p.state == 4

    # ---- lying-down path (early return in the reference) ----
    lying_left_l = p.lying_down_duration_left - 1
    state_l = where(lying_left_l < -1, 0, 4).to(I32)

    # ---- main path ----
    # x velocity: walk +-6, dive +-8 (state 5/6 freeze movement).
    vx = where(p.state < 5,
               where(p.state < 3, inp.x_direction * 6, p.diving_direction * 8),
               0)
    future_x = p.x + vx
    if is_player2:
        x = future_x.clamp(C.GROUND_HALF_WIDTH + C.PLAYER_HALF_LENGTH,
                           C.GROUND_WIDTH - C.PLAYER_HALF_LENGTH)
    else:
        x = future_x.clamp(C.PLAYER_HALF_LENGTH,
                           C.GROUND_HALF_WIDTH - C.PLAYER_HALF_LENGTH)

    # Jump: up input while standing on the ground.
    jump = (p.state < 3) & (inp.y_direction == -1) & \
           (p.y == C.PLAYER_TOUCHING_GROUND_Y_COORD)
    yv = where(jump, -16, p.y_velocity)
    state = where(jump, 1, p.state)
    frame = where(jump, 0, p.frame_number)
    chu = jump

    # Gravity and landing.
    future_y = p.y + yv
    y = future_y
    rising = future_y < C.PLAYER_TOUCHING_GROUND_Y_COORD
    landing = future_y > C.PLAYER_TOUCHING_GROUND_Y_COORD
    yv = where(rising, yv + 1, yv)
    was_diving = state == 3
    lying_left = where(landing & was_diving, 3, p.lying_down_duration_left)
    yv = where(landing, 0, yv)
    y = where(landing, C.PLAYER_TOUCHING_GROUND_Y_COORD, y)
    frame = where(landing, 0, frame)
    state = where(landing, where(was_diving, 4, 0).to(I32), state)

    # Power hit: jumping -> smash pose; grounded + direction -> dive.
    delay = p.delay_before_next_frame
    diving_dir = p.diving_direction
    ph = inp.power_hit == 1
    smash = ph & (state == 1)
    delay = where(smash, 5, delay)
    frame = where(smash, 0, frame)
    state = where(smash, 2, state)
    pika = smash
    dive = ph & (state == 0) & (inp.x_direction != 0)
    state = where(dive, 3, state)
    frame = where(dive, 0, frame)
    diving_dir = where(dive, inp.x_direction, diving_dir)
    yv = where(dive, -5, yv)
    chu = chu | dive

    # Animation-frame counters, keyed on the post-power-hit state.
    arm = p.normal_status_arm_swing_direction
    s1 = state == 1
    frame = where(s1, (frame + 1) % 3, frame)
    s2 = state == 2
    s2_adv = s2 & (delay < 1)
    frame_s2 = frame + 1
    wrap = frame_s2 > 4
    frame = where(s2_adv, where(wrap, 0, frame_s2), frame)
    state = where(s2_adv & wrap, 1, state)
    delay = where(s2 & ~s2_adv, delay - 1, delay)
    s0 = state == 0
    delay_s0 = delay + 1
    tick = s0 & (delay_s0 > 3)
    delay = where(s0, where(tick, 0, delay_s0), delay)
    future_frame = frame + arm
    flip = (future_frame < 0) | (future_frame > 4)
    arm = where(tick & flip, -arm, arm)
    # The reference adds the possibly-flipped direction (physics.py:549-552).
    frame = where(tick, frame + arm, frame)

    # Game-end win/lose poses (dead code when driven through the env).
    ge = (p.game_ended == 1) & (state == 0)
    pipikachu = ge & (p.is_winner == 1)
    state = where(ge, where(p.is_winner == 1, 5, 6).to(I32), state)
    delay = where(ge, 0, delay)
    frame = where(ge, 0, frame)
    g2 = (p.game_ended == 1) & (frame < 4)
    delay_g2 = delay + 1
    adv = g2 & (delay_g2 > 4)
    delay = where(g2, where(adv, 0, delay_g2), delay)
    frame = where(adv, frame + 1, frame)

    # ---- select lying vs main path ----
    sel = lambda lying, main: where(entry_lying, lying, main)
    out = p._replace(
        x=sel(p.x, x),
        y=sel(p.y, y),
        y_velocity=sel(p.y_velocity, yv),
        state=sel(state_l, state),
        frame_number=sel(p.frame_number, frame),
        normal_status_arm_swing_direction=sel(
            p.normal_status_arm_swing_direction, arm),
        delay_before_next_frame=sel(p.delay_before_next_frame, delay),
        diving_direction=sel(p.diving_direction, diving_dir),
        lying_down_duration_left=sel(lying_left_l, lying_left),
    )
    active = ~entry_lying
    return (out, (active & chu).to(I32), (active & pika).to(I32),
            (active & pipikachu).to(I32))
