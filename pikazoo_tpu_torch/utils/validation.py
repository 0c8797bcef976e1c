"""State validation: every field of an (optionally batched) ``EnvState``
inside its physical envelope.  The JAX package's ``validate_state`` and
bounds, on the port's leaves (read back to the host); for tests and
debugging, not for the hot path."""

from __future__ import annotations

import numpy as np
import torch

from pikazoo_tpu_torch.core import constants as C

_PLAYER_BOUNDS = {
    "x": (C.PLAYER_HALF_LENGTH, C.GROUND_WIDTH - C.PLAYER_HALF_LENGTH),
    "y": (108, C.PLAYER_TOUCHING_GROUND_Y_COORD),
    "y_velocity": (-16, 16),
    "state": (0, 6),
    "frame_number": (0, 5),
    "normal_status_arm_swing_direction": (-1, 1),
    "delay_before_next_frame": (0, 5),
    "diving_direction": (-1, 1),
    "lying_down_duration_left": (-2, 3),
    "is_collision_with_ball_happened": (0, 1),
    "computer_boldness": (0, 4),
    "computer_where_to_stand_by": (0, 1),
    "is_winner": (0, 1),
    "game_ended": (0, 1),
}

_BALL_BOUNDS = {
    "x": (0, C.GROUND_WIDTH + 20),
    "y": (-150, C.BALL_TOUCHING_GROUND_Y_COORD),
    "x_velocity": (-20, 20),
    "y_velocity": (-130, 130),
    "is_power_hit": (0, 1),
    "rotation": (0, 5),
    "fine_rotation": (0, 50),
    "punch_effect_radius": (0, C.BALL_RADIUS),
}


def _check(name, leaf, lo, hi, problems):
    arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    bad = (arr < lo) | (arr > hi)
    if bad.any():
        first = tuple(np.argwhere(bad)[0]) if arr.ndim else ()
        problems.append(
            f"{name}: {bad.sum()} values outside [{lo}, {hi}] "
            f"(e.g. {arr[first]} at {list(first)})")


def validate_state(state) -> None:
    """Raise AssertionError listing every out-of-envelope field."""
    problems: list[str] = []
    for prefix, obj, bounds in (("p1", state.p1, _PLAYER_BOUNDS),
                                ("p2", state.p2, _PLAYER_BOUNDS),
                                ("ball", state.ball, _BALL_BOUNDS)):
        for field, (lo, hi) in bounds.items():
            _check(f"{prefix}.{field}", getattr(obj, field), lo, hi, problems)
    _check("scores", state.scores, 0, 10_000, problems)
    for flag in ("is_player2_serve", "round_ended", "game_ended"):
        _check(flag, getattr(state, flag), 0, 1, problems)
    _check("draw_counter", state.draw_counter, 0, 2 ** 31 - 1, problems)
    if problems:
        raise AssertionError("invalid EnvState:\n  " + "\n  ".join(problems))
