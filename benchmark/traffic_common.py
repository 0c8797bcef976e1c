"""What the traffic drivers share: the program's EnvState as the
reference's packed rows."""

from __future__ import annotations

import torch


def packed_state(state) -> torch.Tensor:
    """An EnvState's leaves as the reference's packed ``(54, B)`` rows (the
    fused rollout's field order, without its two action-key rows)."""
    game = [state.power_hit_key_down_prev[:, 0], state.power_hit_key_down_prev[:, 1],
            state.scores[:, 0], state.scores[:, 1], state.is_player2_serve,
            state.round_ended, state.game_ended, state.step_count, state.draw_counter,
            state.rng_key[:, 0], state.rng_key[:, 1]]
    return torch.stack(list(state.p1) + list(state.p2) + list(state.ball) + game)


def envs_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Envs (columns) in which any row differs; a shape mismatch is every env."""
    if got.shape != want.shape:
        return int(want.shape[-1])
    return int((got.to(want.device) != want).any(0).sum())
