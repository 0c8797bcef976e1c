"""State tuples for the physics step.

Every leaf is an ``int32`` tensor of one batch shape ``S`` (``(B,)`` for a
batch of environments, ``()`` for one); booleans are stored as 0/1 int32 so
the whole state is a homogeneous integer tuple.  Field names and order match
``pikazoo_tpu.core.state`` exactly, so a state converts leaf by leaf.

Functions return new tuples (``_replace``) and never write into their
arguments: a caller may keep the previous frame's state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as C

I32 = torch.int32


class PlayerInput(NamedTuple):
    """Decoded per-frame input: directions in {-1,0,1} and an edge-detected
    power-hit bit (``PikaUserInput`` semantics, ``physics.py:36-99``)."""

    x_direction: torch.Tensor
    y_direction: torch.Tensor
    power_hit: torch.Tensor


class PlayerState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    y_velocity: torch.Tensor
    # 0 normal, 1 jumping, 2 jumping+power-hitting, 3 diving, 4 lying down,
    # 5 won, 6 lost.
    state: torch.Tensor
    frame_number: torch.Tensor
    normal_status_arm_swing_direction: torch.Tensor
    delay_before_next_frame: torch.Tensor
    diving_direction: torch.Tensor  # persists across rounds (reference quirk)
    lying_down_duration_left: torch.Tensor  # persists across rounds too
    is_collision_with_ball_happened: torch.Tensor  # 0/1 edge latch
    computer_boldness: torch.Tensor  # redrawn in [0,5) each round init
    computer_where_to_stand_by: torch.Tensor  # 0 mid-court / 1 near net
    is_winner: torch.Tensor
    game_ended: torch.Tensor


class BallState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    x_velocity: torch.Tensor
    y_velocity: torch.Tensor
    # Two-frame position history; NOT reset between rounds (reference quirk).
    previous_x: torch.Tensor
    previous_y: torch.Tensor
    previous_previous_x: torch.Tensor
    previous_previous_y: torch.Tensor
    is_power_hit: torch.Tensor
    expected_landing_point_x: torch.Tensor
    rotation: torch.Tensor  # 0..5; 5 = hyper-ball glitch sprite
    fine_rotation: torch.Tensor
    punch_effect_x: torch.Tensor  # also the scoring-side witness on ground touch
    punch_effect_y: torch.Tensor
    punch_effect_radius: torch.Tensor


class SoundEvents(NamedTuple):
    """Per-frame audio event flags (fresh each step, never latched)."""

    p1_chu: torch.Tensor
    p1_pika: torch.Tensor
    p1_pipikachu: torch.Tensor
    p2_chu: torch.Tensor
    p2_pika: torch.Tensor
    p2_pipikachu: torch.Tensor
    power_hit: torch.Tensor
    ball_touches_ground: torch.Tensor

    @classmethod
    def none(cls, shape, device) -> "SoundEvents":
        return cls(*(torch.zeros(shape, dtype=I32, device=device)
                     for _ in cls._fields))


def full(shape, value: int, device) -> torch.Tensor:
    """An int32 leaf of batch shape ``shape`` filled with ``value``."""
    return torch.full(shape, value, dtype=I32, device=device)


def init_player_construction(is_player2: bool, shape, device) -> PlayerState:
    """Construction-time defaults (reference ``Player.__init__``), *before*
    the first round init.  Boldness is a placeholder until round init draws it."""
    f = lambda v: full(shape, v, device)
    return PlayerState(
        x=f(C.GROUND_WIDTH - 36 if is_player2 else 36),
        y=f(C.PLAYER_TOUCHING_GROUND_Y_COORD),
        y_velocity=f(0),
        state=f(0),
        frame_number=f(0),
        normal_status_arm_swing_direction=f(1),
        delay_before_next_frame=f(0),
        diving_direction=f(0),
        lying_down_duration_left=f(-1),
        is_collision_with_ball_happened=f(0),
        computer_boldness=f(0),
        computer_where_to_stand_by=f(0),
        is_winner=f(0),
        game_ended=f(0),
    )


def round_init_player(p: PlayerState, do: torch.Tensor, boldness: torch.Tensor,
                      is_player2: bool) -> PlayerState:
    """Masked per-round re-init (reference ``initialize_for_new_round``,
    ``physics.py:181-218``).  Only the listed fields reset; diving_direction,
    lying_down_duration_left, computer_where_to_stand_by, is_winner and
    game_ended deliberately persist."""
    w = lambda new, old: torch.where(do, new, old)
    return p._replace(
        x=w(C.GROUND_WIDTH - 36 if is_player2 else 36, p.x),
        y=w(C.PLAYER_TOUCHING_GROUND_Y_COORD, p.y),
        y_velocity=w(0, p.y_velocity),
        is_collision_with_ball_happened=w(0, p.is_collision_with_ball_happened),
        state=w(0, p.state),
        frame_number=w(0, p.frame_number),
        normal_status_arm_swing_direction=w(1, p.normal_status_arm_swing_direction),
        delay_before_next_frame=w(0, p.delay_before_next_frame),
        computer_boldness=w(boldness, p.computer_boldness),
    )


def init_ball_construction(shape, device) -> BallState:
    """Construction-time defaults (reference ``Ball.__init__``)."""
    f = lambda v: full(shape, v, device)
    return BallState(
        x=f(56), y=f(0), x_velocity=f(0), y_velocity=f(1),
        previous_x=f(0), previous_y=f(0),
        previous_previous_x=f(0), previous_previous_y=f(0),
        is_power_hit=f(0), expected_landing_point_x=f(0),
        rotation=f(0), fine_rotation=f(0),
        punch_effect_x=f(0), punch_effect_y=f(0), punch_effect_radius=f(0),
    )


def round_init_ball(b: BallState, do: torch.Tensor,
                    is_player2_serve: torch.Tensor) -> BallState:
    """Masked per-round ball re-init (reference ``physics.py:258-277``).
    Position history, rotation and punch-effect coordinates persist."""
    serve_x = torch.where(is_player2_serve != 0, C.GROUND_WIDTH - 56, 56).to(I32)
    w = lambda new, old: torch.where(do, new, old)
    return b._replace(
        x=w(serve_x, b.x),
        y=w(0, b.y),
        x_velocity=w(0, b.x_velocity),
        y_velocity=w(1, b.y_velocity),
        punch_effect_radius=w(0, b.punch_effect_radius),
        is_power_hit=w(0, b.is_power_hit),
    )


