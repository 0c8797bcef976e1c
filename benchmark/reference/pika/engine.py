"""One physics frame — the orchestrator.

Counterpart of ``pikazoo_tpu.core.engine`` (reference ``physics_engine``,
``physics.py:280-337``), with its strict sequential structure, which the
draw order and the players' view of each other depend on:

  1. ball-world collision + integration;
  2. player 1: [AI decision] then movement; player 2: [AI decision — seeing
     player 1's already-updated position] then movement;
  3. collisions: player 1 test/response, then player 2 against the
     possibly-updated ball; each guarded by the per-player edge latch.

The landing simulation runs once per frame, for the whole batch, and only
when a seat is a computer, here by the plain loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .ai import computer_decide_input
from .ball import ball_world_step
from .collision import ball_player_overlap, collision_response
from .player import move_player
from .predict import landing_sims_any
from .rng import DrawState
from .state import (I32, BallState, PlayerInput,
                                          PlayerState, SoundEvents)


def landing_sims(ball: BallState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expected with the batch shape S, candidates ``(6,) + S``): the plain
    7-lane landing loop."""
    return landing_sims_any(ball.x, ball.y, ball.x_velocity, ball.y_velocity)


def physics_step(
    p1: PlayerState,
    p2: PlayerState,
    ball: BallState,
    inp1: PlayerInput,
    inp2: PlayerInput,
    ds: DrawState,
    is_player1_computer: bool,
    is_player2_computer: bool,
    landing_fn=None,
    decide_fn=None,
) -> Tuple[PlayerState, PlayerState, BallState, torch.Tensor, DrawState,
           SoundEvents]:
    """Advance the physics one frame for every env of the batch.

    ``landing_fn`` (ball -> (expected, candidates ``(6,) + S``)) replaces
    :func:`landing_sims`, the kernel wrapper, as in the JAX package; the
    fused rollout's plain version passes the plain simulation.
    ``decide_fn`` replaces :func:`computer_decide_input` (the benchmark's
    work counts wrap it)."""
    decide = decide_fn or computer_decide_input
    ball, touched = ball_world_step(ball)

    candidate_landing = None
    if is_player1_computer or is_player2_computer:
        expected_x, candidate_landing = (landing_fn or landing_sims)(ball)
        ball = ball._replace(expected_landing_point_x=expected_x)

    # Player 1 (left): optional AI decision, then movement.
    if is_player1_computer:
        inp1, wtsb, ds = decide(
            p1, p2, ball, candidate_landing, False, ds)
        p1 = p1._replace(computer_where_to_stand_by=wtsb)
    p1, chu1, pika1, pipi1 = move_player(p1, inp1, is_player2=False)

    # Player 2 (right): its AI sees player 1's post-move position.
    if is_player2_computer:
        inp2, wtsb, ds = decide(
            p2, p1, ball, candidate_landing, True, ds)
        p2 = p2._replace(computer_where_to_stand_by=wtsb)
    p2, chu2, pika2, pipi2 = move_player(p2, inp2, is_player2=True)

    # Sequential collision handling, player 1 first.
    power_sound = torch.zeros_like(touched)
    players = []
    for p, inp in ((p1, inp1), (p2, inp2)):
        overlap = ball_player_overlap(ball, p.x, p.y)
        fresh = overlap & (p.is_collision_with_ball_happened == 0)
        ball, ps, ds = collision_response(ball, p.x, inp, p.state, fresh, ds)
        power_sound = power_sound | ps
        players.append(p._replace(is_collision_with_ball_happened=overlap.to(I32)))
    p1, p2 = players

    sounds = SoundEvents(
        p1_chu=chu1, p1_pika=pika1, p1_pipikachu=pipi1,
        p2_chu=chu2, p2_pika=pika2, p2_pipikachu=pipi2,
        power_hit=power_sound, ball_touches_ground=touched)
    return p1, p2, ball, touched, ds, sounds
