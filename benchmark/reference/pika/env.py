"""The environment's frame, reset and the two step paths the benchmark drives.

A frozen copy of the port's ``env_frame`` with its reset (no oracle, no
carry), the learner's step (feature-major observations) and the fused
rollout's frame (actions sampled from the shared threefry stream), over
the packed ``(NFIELDS, B)`` int32 layout the fused rollout uses.  It is the
benchmark's plain reference: nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from . import constants as C
from .engine import physics_step
from .input import decode_action, decode_action_arith
from .observations import assemble_norm_obs_fm, assemble_obs
from .rng import DrawState, draw, fold_key, key_data, threefry2x32
from .state import (I32, BallState, PlayerState, SoundEvents,
                    init_ball_construction, init_player_construction,
                    round_init_ball, round_init_player)

SERVE_MODES = ("winner", "alternate", "random")
ACTION_TAG = 2  # threefry word-1 tag of the action stream (the seat adds 0/1)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """The environment's settings: the reference env's constructor
    arguments plus the batched ``auto_reset``."""

    winning_score: int = 15
    serve: str = "winner"
    is_player1_computer: bool = False
    is_player2_computer: bool = False
    auto_reset: bool = True


class FrameResult(NamedTuple):
    p1: PlayerState
    p2: PlayerState
    ball: BallState
    score1: torch.Tensor
    score2: torch.Tensor
    is_player2_serve: torch.Tensor
    round_ended: torch.Tensor
    game_ended: torch.Tensor
    draw_counter: torch.Tensor
    touched: torch.Tensor
    reward_p1: torch.Tensor
    sounds: SoundEvents


def env_frame(cfg: EnvConfig, ds: DrawState, p1: PlayerState,
              p2: PlayerState, ball: BallState, score1, score2,
              is_player2_serve, round_ended, game_ended,
              inp1: PlayerInput, inp2: PlayerInput,
              landing_fn=None, decide_fn=None) -> FrameResult:
    """One environment frame: lazy round / auto game reset with its draw
    consumption (``pikazoo_env.py:176-180``), serve selection
    (``:242-248``), physics, scoring (``:190-210``) and the zero-sum reward.
    Inputs must already be decoded.  ``landing_fn`` goes to
    :func:`~pikazoo_tpu_torch.core.engine.physics_step`."""
    where = torch.where
    game_reset = (game_ended == 1) if cfg.auto_reset \
        else torch.zeros_like(game_ended, dtype=torch.bool)
    round_reset = (round_ended == 1) & (game_ended == 0)
    do_init = round_reset | game_reset

    score1 = where(game_reset, 0, score1)
    score2 = where(game_reset, 0, score2)
    is_player2_serve = where(game_reset, 0, is_player2_serve)
    game_ended = where(game_reset, 0, game_ended)
    # With auto_reset=False a terminated lane keeps round_ended=1; this mask
    # keeps it from re-emitting the terminal reward on every further step.
    game_ended_at_entry = game_ended
    clear = lambda p: p._replace(
        is_winner=where(game_reset, 0, p.is_winner),
        game_ended=where(game_reset, 0, p.game_ended))
    p1, p2 = clear(p1), clear(p2)

    b1, ds = draw(ds, do_init, 5)
    b2, ds = draw(ds, do_init, 5)
    if cfg.serve == "winner":
        server = is_player2_serve
    elif cfg.serve == "alternate":
        server = ((score1 + score2) % 2 == 1).to(I32)
    else:
        sv, ds = draw(ds, do_init, 2)
        server = (sv == 0).to(I32)
    p1 = round_init_player(p1, do_init, b1, is_player2=False)
    p2 = round_init_player(p2, do_init, b2, is_player2=True)
    ball = round_init_ball(ball, do_init, server)
    round_ended = where(do_init, 0, round_ended)

    p1, p2, ball, touched, ds, sounds = physics_step(
        p1, p2, ball, inp1, inp2, ds,
        cfg.is_player1_computer, cfg.is_player2_computer, landing_fn, decide_fn)

    score_event = (touched == 1) & (round_ended == 0) & (game_ended == 0)
    p2_scored = ball.punch_effect_x < C.GROUND_HALF_WIDTH
    score1 = score1 + (score_event & ~p2_scored).to(I32)
    score2 = score2 + (score_event & p2_scored).to(I32)
    is_player2_serve = where(score_event, p2_scored.to(I32), is_player2_serve)
    p1_won = score_event & (score1 >= cfg.winning_score) & ~p2_scored
    p2_won = score_event & (score2 >= cfg.winning_score) & p2_scored
    game_over = p1_won | p2_won
    game_ended = where(game_over, 1, game_ended)
    p1 = p1._replace(
        is_winner=where(game_over, p1_won.to(I32), p1.is_winner),
        game_ended=where(game_over, 1, p1.game_ended))
    p2 = p2._replace(
        is_winner=where(game_over, p2_won.to(I32), p2.is_winner),
        game_ended=where(game_over, 1, p2.game_ended))
    round_ended = where(score_event, 1, round_ended)

    reward_p1 = where((round_ended == 1) & (game_ended_at_entry == 0),
                      where(is_player2_serve == 1, -1, 1).to(I32), 0)
    return FrameResult(p1, p2, ball, score1, score2, is_player2_serve,
                       round_ended, game_ended, ds.counter, touched,
                       reward_p1, sounds)


_PLAYER_FIELDS = list(PlayerState._fields)
_BALL_FIELDS = list(BallState._fields)
# Scalar game rows in pack order, after the p1, p2 and ball blocks.
GAME_FIELDS = ["latch1", "latch2", "score1", "score2", "is_player2_serve",
               "round_ended", "game_ended", "step_count", "draw_counter",
               "rng_lo", "rng_hi", "akey_lo", "akey_hi"]
FIELD_NAMES = ([f"p1.{f}" for f in _PLAYER_FIELDS] + [f"p2.{f}" for f in _PLAYER_FIELDS]
               + [f"ball.{f}" for f in _BALL_FIELDS] + GAME_FIELDS)
NFIELDS = len(FIELD_NAMES)
Fields = Tuple[PlayerState, PlayerState, BallState, Dict[str, torch.Tensor]]


def env_keys(key, batch: int, device) -> torch.Tensor:
    """(batch, 2) int32: env i's key is ``fold_key(key, i)``."""
    base = key_data(key, device)
    return fold_key(base, torch.arange(batch, dtype=torch.int64, device=base.device))


def reset_packed(cfg: EnvConfig, key, action_key, batch: int, device) -> torch.Tensor:
    """New games for ``batch`` envs keyed by :func:`env_keys`, packed, with
    the per-env action keys of ``action_key`` in the last two rows."""
    keys = env_keys(key, batch, device)
    shape = (batch,)
    zeros = lambda: torch.zeros(shape, dtype=I32, device=device)
    ds = DrawState(key=keys, counter=zeros())
    p1 = init_player_construction(False, shape, device)
    p2 = init_player_construction(True, shape, device)
    ball = init_ball_construction(shape, device)
    true = torch.ones(shape, dtype=torch.bool, device=device)
    b1, ds = draw(ds, true, 5)
    b2, ds = draw(ds, true, 5)
    if cfg.serve == "random":
        sv, ds = draw(ds, true, 2)
        server = (sv == 0).to(I32)
    else:
        server = zeros()
    p1 = round_init_player(p1, true, b1, is_player2=False)
    p2 = round_init_player(p2, true, b2, is_player2=True)
    ball = round_init_ball(ball, true, server)
    akey = env_keys(action_key, batch, device)
    game = dict(latch1=zeros(), latch2=zeros(), score1=zeros(), score2=zeros(),
                is_player2_serve=zeros(), round_ended=zeros(), game_ended=zeros(),
                step_count=zeros(), draw_counter=ds.counter,
                rng_lo=keys[:, 0].to(I32), rng_hi=keys[:, 1].to(I32),
                akey_lo=akey[:, 0], akey_hi=akey[:, 1])
    return join(p1, p2, ball, game)


def split(matrix: torch.Tensor) -> Fields:
    """(NFIELDS, B) -> (p1, p2, ball, game rows by name); rows are views."""
    rows = matrix.unbind(0)
    np1, nb = len(_PLAYER_FIELDS), len(_BALL_FIELDS)
    return (PlayerState(*rows[:np1]), PlayerState(*rows[np1:2 * np1]),
            BallState(*rows[2 * np1:2 * np1 + nb]),
            dict(zip(GAME_FIELDS, rows[2 * np1 + nb:])))


def join(p1: PlayerState, p2: PlayerState, ball: BallState,
         game: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(p1) + list(p2) + list(ball) + [game[n] for n in GAME_FIELDS])


def sample_action(akey: torch.Tensor, t: torch.Tensor, seat: int, num_actions: int = 18,
                  rounds: int = 20) -> torch.Tensor:
    """Uniform action: the first threefry word of ``(t, ACTION_TAG + seat)``
    under ``akey``, modulo ``num_actions`` in unsigned arithmetic."""
    bits, _ = threefry2x32(akey, t, ACTION_TAG + seat, rounds=rounds)
    return (bits % num_actions).to(I32)


def fused_frame(cfg: EnvConfig, p1: PlayerState, p2: PlayerState, ball: BallState,
                game: Dict[str, torch.Tensor], landing_fn=None, decide_fn=None,
                rounds: int = 20) -> Fields:
    """One env frame of the fused rollout: both seats' actions sampled from
    the shared stream and decoded (the latches follow them, also for a
    computer seat), then :func:`env_frame`.  ``rounds`` is threefry's."""
    ds = DrawState(key=torch.stack([game["rng_lo"], game["rng_hi"]], dim=-1),
                   counter=game["draw_counter"])
    akey = torch.stack([game["akey_lo"], game["akey_hi"]], dim=-1)
    a1 = sample_action(akey, game["step_count"], 0, rounds=rounds)
    a2 = sample_action(akey, game["step_count"], 1, rounds=rounds)
    inp1, latch1 = decode_action_arith(a1, game["latch1"])
    inp2, latch2 = decode_action_arith(a2, game["latch2"])
    fr = env_frame(cfg, ds, p1, p2, ball, game["score1"], game["score2"],
                   game["is_player2_serve"], game["round_ended"], game["game_ended"],
                   inp1, inp2, landing_fn=landing_fn, decide_fn=decide_fn)
    game = dict(game, latch1=latch1, latch2=latch2, score1=fr.score1, score2=fr.score2,
                is_player2_serve=fr.is_player2_serve, round_ended=fr.round_ended,
                game_ended=fr.game_ended, step_count=game["step_count"] + 1,
                draw_counter=fr.draw_counter)
    return fr.p1, fr.p2, fr.ball, game


def rollout_packed(packed: torch.Tensor, cfg: EnvConfig, frames: int, **frame_kw) -> torch.Tensor:
    """``frames`` fused frames from a packed state; returns a new matrix."""
    p1, p2, ball, game = split(packed)
    for _ in range(frames):
        p1, p2, ball, game = fused_frame(cfg, p1, p2, ball, game, **frame_kw)
    return join(p1, p2, ball, game)


def learner_step(cfg: EnvConfig, packed: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor):
    """The learner's frame on a packed state (its action-key rows unused):
    per-seat actions in; ``(packed, norm_obs (35, 2B) bf16, reward (2B,)
    f32 seat-blocked, terminated (B,))`` out."""
    p1, p2, ball, game = split(packed)
    ds = DrawState(key=torch.stack([game["rng_lo"], game["rng_hi"]], dim=-1),
                   counter=game["draw_counter"])
    inp1, latch1 = decode_action(a1, game["latch1"])
    inp2, latch2 = decode_action(a2, game["latch2"])
    fr = env_frame(cfg, ds, p1, p2, ball, game["score1"], game["score2"],
                   game["is_player2_serve"], game["round_ended"], game["game_ended"],
                   inp1, inp2)
    game = dict(game, latch1=latch1, latch2=latch2, score1=fr.score1, score2=fr.score2,
                is_player2_serve=fr.is_player2_serve, round_ended=fr.round_ended,
                game_ended=fr.game_ended, step_count=game["step_count"] + 1,
                draw_counter=fr.draw_counter)
    latch = torch.stack([latch1, latch2], dim=-1)
    norm = assemble_norm_obs_fm(fr.p1, fr.p2, fr.ball, latch)
    reward = fr.reward_p1.to(torch.float32)
    return (join(fr.p1, fr.p2, fr.ball, game), norm, torch.cat([reward, -reward]),
            fr.game_ended)


def raw_obs(packed: torch.Tensor) -> torch.Tensor:
    """(B, 2, 35) int32 observations of a packed state."""
    p1, p2, ball, game = split(packed)
    return assemble_obs(p1, p2, ball, torch.stack([game["latch1"], game["latch2"]], dim=-1))
