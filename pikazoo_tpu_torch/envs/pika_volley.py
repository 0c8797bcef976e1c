"""The batched Pikachu Volleyball environment in PyTorch.

Counterpart of ``pikazoo_tpu.envs.pika_volley``: the same reset and step
semantics (lazy round reset, scoring by ``punch_effect_x < 216``, zero-sum
+-1 rewards on the scoring frame, persistent quirk fields, auto reset), on
int32 tensors whose leading dimensions are the batch.  Where the JAX package
writes a per-env function and ``vmap``s it, the port writes the batch
dimension out: every function takes leaves of one batch shape ``S``
(``(B,)`` from :meth:`PikaZoo.reset_batch`, ``()`` from :meth:`PikaZoo.reset`).

Every leaf equals the JAX package's for the same key and actions; the tests
hold them frame by frame.  With a computer seat, each frame runs the landing
simulation once for the whole batch, on CUDA as one launch of the
hand-written kernel (``core.predict_cuda``).  The PPO rollout's step,
``step_batch_learner_fm``, is on CUDA one launch of another
(``core.learner_step``): the whole frame, the observations and the rewards,
with the new state's leaves views of one buffer it wrote; on the CPU it runs
the same eager ops as the other steps.  ``reset`` takes the previous
state (``carry``), a starting draw counter and an oracle of recorded draws,
and ``step`` the oracle, as the JAX package's do: the PettingZoo adapter
(``compat``) and the parity replay use them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from pikazoo_tpu_torch.core import constants as C
from pikazoo_tpu_torch.core.engine import physics_step
from pikazoo_tpu_torch.core.input import decode_action
from pikazoo_tpu_torch.core.rng import DrawState, draw, fold_key, key_data
from pikazoo_tpu_torch.core.state import (I32, BallState, PlayerInput,
                                          PlayerState, SoundEvents,
                                          init_ball_construction,
                                          init_player_construction,
                                          round_init_ball, round_init_player)
from pikazoo_tpu_torch.envs.observations import (NUM_ACTIONS,
                                                 assemble_norm_obs_blocked,
                                                 assemble_norm_obs_fm,
                                                 assemble_obs)
from pikazoo_tpu_torch.utils.profiling import trace_annotation

SERVE_MODES = ("winner", "alternate", "random")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (reference constructor kwargs,
    ``pikazoo_env.py:79-86``, plus the batched-mode ``auto_reset``)."""

    winning_score: int = 15
    serve: str = "winner"
    is_player1_computer: bool = False
    is_player2_computer: bool = False
    auto_reset: bool = True

    def __post_init__(self):
        if self.serve not in SERVE_MODES:
            raise ValueError(f"serve must be one of {SERVE_MODES}")


class EnvState(NamedTuple):
    p1: PlayerState
    p2: PlayerState
    ball: BallState
    power_hit_key_down_prev: torch.Tensor  # S + (2,) int32 input latches
    scores: torch.Tensor  # S + (2,) int32
    is_player2_serve: torch.Tensor
    round_ended: torch.Tensor
    game_ended: torch.Tensor
    step_count: torch.Tensor
    rng_key: torch.Tensor  # S + (2,) int32 bits of the threefry stream key
    draw_counter: torch.Tensor


class FrameResult(NamedTuple):
    """Output of :func:`env_frame`."""

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


class TimeStep(NamedTuple):
    obs: torch.Tensor  # S + (2, 35) int32, row 0 = player 1's view
    rewards: torch.Tensor  # S + (2,) int32, zero-sum
    terminated: torch.Tensor  # 0/1
    round_ended: torch.Tensor  # 0/1
    scores: torch.Tensor  # S + (2,) int32
    touched_ground: torch.Tensor  # 0/1
    sounds: SoundEvents


def env_frame(cfg: EnvConfig, ds: DrawState, p1: PlayerState,
              p2: PlayerState, ball: BallState, score1, score2,
              is_player2_serve, round_ended, game_ended,
              inp1: PlayerInput, inp2: PlayerInput,
              landing_fn=None) -> FrameResult:
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
        cfg.is_player1_computer, cfg.is_player2_computer, landing_fn)

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


def _checked_oracle(oracle: Optional[torch.Tensor], device: torch.device
                    ) -> Optional[torch.Tensor]:
    """``oracle`` after checking that it is int32 on the state's device."""
    if oracle is not None and (oracle.dtype != I32 or oracle.device != device):
        raise ValueError(f"an oracle is int32 on the state's device ({device}), "
                         f"got {oracle.dtype} on {oracle.device}")
    return oracle


def batch_keys(key, batch_size: int, device="cuda") -> torch.Tensor:
    """The ``(batch_size, 2)`` per-env key bits of :meth:`PikaZoo.reset_batch`:
    env i's key is ``fold_key(key, i)``, as in the JAX package.  ``key`` is
    an int seed (key data ``[0, seed]``, as ``jax.random.key(seed)``) or
    2-word key data."""
    base = key_data(key, device)
    index = torch.arange(batch_size, dtype=torch.int64, device=base.device)
    return fold_key(base, index)


class PikaZoo:
    """Two-agent Pikachu Volleyball over a batch of environments.

    >>> env = PikaZoo(EnvConfig(is_player1_computer=True, is_player2_computer=True))
    >>> state, ts = env.reset_batch(0, 4096, device="cuda")
    >>> state, ts = env.step_batch(state, torch.zeros((4096, 2), dtype=torch.int32,
    ...                                                device="cuda"))
    """

    num_actions = NUM_ACTIONS

    def __init__(self, config: EnvConfig = EnvConfig()):
        self.config = config

    def _reset_from_keys(self, keys: torch.Tensor, *, counter=0,
                         oracle: Optional[torch.Tensor] = None,
                         carry: Optional[EnvState] = None
                         ) -> Tuple[EnvState, TimeStep]:
        """Start new games from per-env key bits ``S + (2,)``; leaves get the
        batch shape S.  ``counter``, ``oracle`` and ``carry`` as in
        :meth:`reset`."""
        shape, device = keys.shape[:-1], keys.device
        zeros = lambda s=(): torch.zeros(shape + s, dtype=I32, device=device)
        ds = DrawState(key=keys,
                       counter=zeros() + torch.as_tensor(counter, dtype=I32,
                                                         device=device),
                       oracle=_checked_oracle(oracle, device))
        if carry is None:
            p1 = init_player_construction(False, shape, device)
            p2 = init_player_construction(True, shape, device)
            ball = init_ball_construction(shape, device)
            latch = zeros((2,))
        else:
            if carry.scores.device != device:
                raise ValueError(f"carry on {carry.scores.device}, keys on {device}")
            clear = lambda p: p._replace(is_winner=torch.zeros_like(p.is_winner),
                                         game_ended=torch.zeros_like(p.game_ended))
            p1, p2, ball = clear(carry.p1), clear(carry.p2), carry.ball
            latch = carry.power_hit_key_down_prev
        true = torch.ones(shape, dtype=torch.bool, device=device)
        b1, ds = draw(ds, true, 5)
        b2, ds = draw(ds, true, 5)
        # Serve at reset (pikazoo_env.py:149-164): winner/alternate both give
        # player 1 after the scores were zeroed; random draws after boldness.
        if self.config.serve == "random":
            sv, ds = draw(ds, true, 2)
            server = (sv == 0).to(I32)
        else:
            server = zeros()
        p1 = round_init_player(p1, true, b1, is_player2=False)
        p2 = round_init_player(p2, true, b2, is_player2=True)
        ball = round_init_ball(ball, true, server)
        state = EnvState(
            p1=p1, p2=p2, ball=ball,
            power_hit_key_down_prev=latch,
            scores=zeros((2,)),
            is_player2_serve=zeros(),
            round_ended=zeros(),
            game_ended=zeros(),
            step_count=zeros(),
            rng_key=keys.to(I32),
            draw_counter=ds.counter,
        )
        ts = TimeStep(
            obs=assemble_obs(p1, p2, ball, latch),
            rewards=zeros((2,)),
            terminated=zeros(),
            round_ended=zeros(),
            scores=zeros((2,)),
            touched_ground=zeros(),
            sounds=SoundEvents.none(shape, device),
        )
        return state, ts

    def reset(self, key, device="cuda", *, counter=0,
              oracle: Optional[torch.Tensor] = None,
              carry: Optional[EnvState] = None) -> Tuple[EnvState, TimeStep]:
        """Start one game (0-d leaves) from an int seed or 2-word key data,
        used directly as the env's stream key (like the JAX ``reset``), on
        ``device`` (the card unless the caller asks for the CPU).

        ``carry`` keeps the reference's construction-vs-reset split: the
        players (``is_winner`` and ``game_ended`` cleared), the ball and the
        input latches of the previous :class:`EnvState` go into the new game,
        as the reference's partially reset objects do; without it the game
        starts from a fresh construction.  ``counter`` (an int or an int32
        tensor of the batch shape) starts the draw counter, and ``oracle``
        (``(cap,)`` int32 on ``device``) supplies the reset's draws, as in the
        JAX package's oracle mode."""
        return self._reset_from_keys(key_data(key, device), counter=counter,
                                     oracle=oracle, carry=carry)

    def reset_batch(self, key, batch_size: int, device="cuda"
                    ) -> Tuple[EnvState, TimeStep]:
        """Start ``batch_size`` independent games on ``device`` (the card
        unless the caller asks for the CPU), keyed by :func:`batch_keys`, so
        the port and the JAX package start from identical states."""
        return self._reset_from_keys(batch_keys(key, batch_size, device))

    def _advance(self, state: EnvState, a1: torch.Tensor, a2: torch.Tensor,
                 oracle: Optional[torch.Tensor] = None
                 ) -> Tuple[EnvState, FrameResult]:
        """One frame of state evolution from per-seat actions of batch shape
        S, without observations (shared by ``step`` and the learner path)."""
        for a in (a1, a2):
            if a.device != state.scores.device:
                raise ValueError(f"actions on {a.device}, state on "
                                 f"{state.scores.device}")
        ds = DrawState(key=state.rng_key, counter=state.draw_counter,
                       oracle=_checked_oracle(oracle, state.scores.device))
        prev = state.power_hit_key_down_prev
        inp1, latch1 = decode_action(a1, prev[..., 0])
        inp2, latch2 = decode_action(a2, prev[..., 1])
        latch = torch.stack([latch1, latch2], dim=-1)

        fr = env_frame(self.config, ds, state.p1, state.p2, state.ball,
                       state.scores[..., 0], state.scores[..., 1],
                       state.is_player2_serve, state.round_ended,
                       state.game_ended, inp1, inp2)

        new_state = EnvState(
            p1=fr.p1, p2=fr.p2, ball=fr.ball,
            power_hit_key_down_prev=latch,
            scores=torch.stack([fr.score1, fr.score2], dim=-1),
            is_player2_serve=fr.is_player2_serve,
            round_ended=fr.round_ended,
            game_ended=fr.game_ended,
            step_count=state.step_count + 1,
            rng_key=state.rng_key,
            draw_counter=fr.draw_counter,
        )
        return new_state, fr

    def step(self, state: EnvState, actions: torch.Tensor,
             oracle: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, TimeStep]:
        """Advance every env one frame.  ``actions`` is ``S + (2,)`` int
        (one per seat, in [0, 18); out-of-range actions clamp as in JAX), on
        the state's device.  ``oracle`` (``S + (cap,)`` int32) supplies the
        frame's draws in place of the threefry stream."""
        with trace_annotation("env.step"):
            new_state, fr = self._advance(state, actions[..., 0], actions[..., 1],
                                          oracle)
            ts = TimeStep(
                obs=assemble_obs(fr.p1, fr.p2, fr.ball,
                                 new_state.power_hit_key_down_prev),
                rewards=torch.stack([fr.reward_p1, -fr.reward_p1], dim=-1),
                terminated=fr.game_ended,
                round_ended=fr.round_ended,
                scores=new_state.scores,
                touched_ground=fr.touched,
                sounds=fr.sounds,
            )
        return new_state, ts

    # ``step`` already takes any batch shape; ``step_batch`` is the name the
    # JAX package gives its vmapped form, for ``(B, 2)`` actions.
    step_batch = step

    def step_batch_learner(self, state: EnvState, a1: torch.Tensor,
                           a2: torch.Tensor
                           ) -> Tuple[EnvState, torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """Learner path: per-seat ``(B,)`` actions in, normalised
        observations out.  Returns ``(state, norm_obs, reward_p1,
        terminated)``: ``norm_obs`` is (2B, 35) bf16 seat-blocked (rows
        [0, B) are player 1's view), ``reward_p1`` and ``terminated`` are
        (B,) int32; player 2's reward is ``-reward_p1``."""
        with trace_annotation("env.step"):
            new_state, fr = self._advance(state, a1, a2)
            norm_obs = assemble_norm_obs_blocked(
                new_state.p1, new_state.p2, new_state.ball,
                new_state.power_hit_key_down_prev)
        return new_state, norm_obs, fr.reward_p1, fr.game_ended

    def step_batch_learner_fm(self, state: EnvState, a1: torch.Tensor,
                              a2: torch.Tensor
                              ) -> Tuple[EnvState, torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """The PPO rollout's step: like :meth:`step_batch_learner`, with the
        observations feature-major, (35, 2B) bf16 with seat-blocked columns
        (the layout the fused gradient kernel consumes), and both seats'
        rewards, (2B,) float32 seat-blocked like the columns.  JAX's returns
        player 1's int32 reward alone; both seats' let a wrapper shape each
        seat's reward on this path (``wrappers.RewardByBallPosition``).

        A CUDA state takes one launch of the hand-written kernel
        (``core.learner_step``, ``csrc/learner_step.cu``), any seats, serve
        mode and batch; the returned state's leaves are then views of one new
        int32 buffer the kernel wrote, and ``terminated`` is its
        ``game_ended``.  A CPU state runs the plain version,
        :meth:`step_batch_learner_fm_plain`, which the kernel repeats bit for
        bit."""
        with trace_annotation("env.step"):
            if state.scores.device.type == "cpu":
                return self.step_batch_learner_fm_plain(state, a1, a2)
            from pikazoo_tpu_torch.core.learner_step import learner_step
            return learner_step(self.config, state, a1, a2)

    def step_batch_learner_fm_plain(self, state: EnvState, a1: torch.Tensor,
                                    a2: torch.Tensor
                                    ) -> Tuple[EnvState, torch.Tensor,
                                               torch.Tensor, torch.Tensor]:
        """The plain PyTorch version of :meth:`step_batch_learner_fm`, on
        any device: the frame, the observations and the rewards as eager
        ops (with a computer seat, the landing simulation on CUDA is one
        launch of ``core.predict_cuda``'s kernel)."""
        new_state, fr = self._advance(state, a1, a2)
        norm_obs = assemble_norm_obs_fm(
            new_state.p1, new_state.p2, new_state.ball,
            new_state.power_hit_key_down_prev)
        reward = fr.reward_p1.to(torch.float32)
        rewards = torch.cat([reward, -reward])
        return new_state, norm_obs, rewards, fr.game_ended
