"""Evaluation harness: a policy's win rate against the rule AI or against
another policy, and Bradley-Terry Elo from a league's results.

Counterpart of ``pikazoo_tpu.train.evaluate``.  The policy plays seat 1;
with ``is_player2_computer=True`` the rule AI overwrites seat 2's input, so
every frame runs the landing simulation (on the card, one launch of K2,
``csrc/landing.cu``).  Batched and auto-resetting: ``num_envs`` matches for
``max_frames`` frames, a Python loop over ``step_batch`` on the device where
the JAX package scans, tallying terminations by winner.  The env keys are
JAX's (``split(fold_in(key, 1 | 2))``), so greedy play (``argmax``) gives the
JAX harness's result.  Sampled play draws Gumbel noise from a device
``torch.Generator`` seeded with ``seed`` where JAX draws
``jax.random.categorical`` from its key: the same distribution, another
stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pikazoo_tpu_torch.core.rng import fold_in, key_data, split
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.train.networks import ActorCritic
from pikazoo_tpu_torch.wrappers import SIMPLIFY_P1, SIMPLIFY_P2
from pikazoo_tpu_torch.wrappers.transforms import simplify


class EvalResult(NamedTuple):
    games: torch.Tensor            # () int64: terminations counted
    policy_wins: torch.Tensor      # () int64: of them, won by seat 1
    win_rate: torch.Tensor         # () float32
    mean_score_diff: torch.Tensor  # () float32: seat 1's score - seat 2's, at terminations


def _act(net: ActorCritic, obs: torch.Tensor, gen: Optional[torch.Generator],
         table: Optional[torch.Tensor]) -> torch.Tensor:
    """Greedy (``gen`` None) or sampled int32 actions of ``net`` on raw
    observations ``(B, 35)``, mapped through ``table`` if given."""
    logits, _ = net(obs)
    if gen is not None:
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        logits = logits - torch.log(-torch.log(u))
    action = torch.argmax(logits, dim=-1).to(torch.int32)
    return simplify(table, action) if table is not None else action


def _play(env: PikaZoo, key: torch.Tensor, num_envs: int, max_frames: int,
          actions_fn) -> EvalResult:
    """``max_frames`` frames from ``reset_batch(key)``; ``actions_fn(obs)``
    gives each frame's ``(B, 2)`` actions from the last observations."""
    state, ts = env.reset_batch(key, num_envs, device=key.device)
    obs = ts.obs
    games = torch.zeros((), dtype=torch.int64, device=key.device)
    wins, diff = torch.zeros_like(games), torch.zeros_like(games)
    for _ in range(max_frames):
        state, ts = env.step_batch(state, actions_fn(obs))
        done = ts.terminated == 1
        margin = ts.scores[:, 0] - ts.scores[:, 1]
        games += done.sum()
        wins += (done & (margin > 0)).sum()
        diff += torch.where(done, margin, 0).sum()
        obs = ts.obs
    n = torch.clamp(games, min=1).to(torch.float32)
    return EvalResult(games, wins, wins.to(torch.float32) / n, diff.to(torch.float32) / n)


@torch.no_grad()
def evaluate_vs_computer(network: ActorCritic, *, num_envs: int = 512,
                         max_frames: int = 20_000, winning_score: int = 5,
                         greedy: bool = True, seed: int = 0,
                         simplify_actions: bool = False,
                         env_config: Optional[EnvConfig] = None,
                         device="cuda") -> EvalResult:
    """Play ``network`` (seat 1) against the rule AI (seat 2) on ``device``
    (the card unless the caller asks for the CPU).  ``simplify_actions``:
    the policy was trained on the 13-action ``SimplifyAction`` space, so its
    choices go through the seat-1 table."""
    cfg = env_config or EnvConfig(winning_score=winning_score,
                                  is_player2_computer=True, auto_reset=True)
    ekey = split(fold_in(key_data(seed, device), 1))[0]
    gen = None if greedy else torch.Generator(device=device).manual_seed(seed)
    table = SIMPLIFY_P1 if simplify_actions else None

    def actions(obs):
        a1 = _act(network, obs[:, 0], gen, table)
        return torch.stack([a1, torch.zeros_like(a1)], dim=1)

    return _play(PikaZoo(cfg), ekey, num_envs, max_frames, actions)


@torch.no_grad()
def evaluate_head_to_head(network_a: ActorCritic, network_b: ActorCritic, *,
                          num_envs: int = 512, max_frames: int = 20_000,
                          winning_score: int = 5, greedy: bool = True, seed: int = 0,
                          simplify_actions_a: bool = False,
                          simplify_actions_b: bool = False,
                          device="cuda") -> EvalResult:
    """Play policy A (seat 1, ``obs[:, 0]``) against policy B (seat 2,
    ``obs[:, 1]``); the result is A's.  Observations and raw actions are
    absolute, so a seat specialist (``learner_seats="p1"``) is out of
    distribution on seat 2: compare policies in both seat orders (see
    ``pikazoo_tpu.train.evaluate.evaluate_head_to_head``)."""
    cfg = EnvConfig(winning_score=winning_score, auto_reset=True)
    ekey = split(fold_in(key_data(seed, device), 2))[0]
    gen = None if greedy else torch.Generator(device=device).manual_seed(seed)
    table_a = SIMPLIFY_P1 if simplify_actions_a else None
    table_b = SIMPLIFY_P2 if simplify_actions_b else None

    def actions(obs):
        return torch.stack([_act(network_a, obs[:, 0], gen, table_a),
                            _act(network_b, obs[:, 1], gen, table_b)], dim=1)

    return _play(PikaZoo(cfg), ekey, num_envs, max_frames, actions)


def bradley_terry_elo(wins, games, anchor: int = -1, anchor_elo: float = 1000.0,
                      prior_games: float = 1.0, iters: int = 500, tol: float = 1e-10):
    """Fit Bradley-Terry strengths to a league result matrix, as Elo.

    ``wins[i][j]`` = games i beat j, ``games[i][j]`` = games i played j
    (symmetric).  The MM fixed point (Hunter 2004) with ``prior_games``
    pseudo-games at 50% against the field mean, so an undefeated or winless
    member stays finite.  Returns Elo ratings (400 log10 scale) with member
    ``anchor`` pinned at ``anchor_elo`` (e.g. the rule AI).  The JAX
    package's numpy function, copied."""
    wins = np.asarray(wins, dtype=np.float64)
    games = np.asarray(games, dtype=np.float64)
    n = wins.shape[0]
    if wins.shape != (n, n) or games.shape != (n, n):
        raise ValueError(f"wins {wins.shape} and games {games.shape} must be square "
                         "and of one size")
    p = np.ones(n)
    half = prior_games / 2.0
    for _ in range(iters):
        p_new = np.empty(n)
        mean = p.mean()
        for i in range(n):
            num = wins[i].sum() + half
            den = prior_games / (p[i] + mean)
            for j in range(n):
                if j != i and games[i, j] > 0:
                    den += games[i, j] / (p[i] + p[j])
            p_new[i] = num / den
        p_new /= np.exp(np.mean(np.log(p_new)))  # fix the scale each sweep
        done = np.max(np.abs(np.log(p_new) - np.log(p))) < tol
        p = p_new
        if done:
            break
    return anchor_elo + 400.0 * (np.log10(p) - np.log10(p[anchor]))
