"""The port's evaluation harness against the JAX package's: greedy
``evaluate_vs_computer`` and ``evaluate_head_to_head`` with the converted
``vs_ai_policy`` give JAX's ``EvalResult`` over a short window, a random
policy loses to the rule AI, and ``bradley_terry_elo`` returns JAX's numbers."""

import numpy as np
import pytest
import torch

from pikazoo_tpu.train.evaluate import bradley_terry_elo as jax_elo
from pikazoo_tpu.train.evaluate import evaluate_head_to_head as jax_head_to_head
from pikazoo_tpu.train.evaluate import evaluate_vs_computer as jax_vs_computer
from pikazoo_tpu.train.networks import ActorCritic as JaxActorCritic
from pikazoo_tpu_torch.convert import params_to_flax
from pikazoo_tpu_torch.policies import load_policy, policy_path
from pikazoo_tpu_torch.train import ActorCritic
from pikazoo_tpu_torch.train.evaluate import (bradley_terry_elo, evaluate_head_to_head,
                                              evaluate_vs_computer)

# Short greedy windows: winning_score=1 ends a game at its first point.
WINDOW = dict(num_envs=16, max_frames=120, winning_score=1, greedy=True)


def assert_result(got, want):
    assert int(got.games) == int(want.games) and int(got.policy_wins) == int(want.policy_wins)
    assert got.win_rate.dtype == got.mean_score_diff.dtype == torch.float32
    assert float(got.win_rate) == float(want.win_rate)
    assert float(got.mean_score_diff) == float(want.mean_score_diff)


@pytest.fixture(scope="module")
def trained():
    net = load_policy(policy_path("vs_ai_policy"), device="cpu")
    return net, JaxActorCritic(num_actions=18, hidden=(256, 256)), params_to_flax(net)


@pytest.mark.parametrize("simplify", [False, True])
def test_greedy_vs_computer_matches_jax(trained, simplify):
    """``simplify_actions`` maps the greedy choice through the seat-1 table
    (clamped, as JAX's gather clamps; on this 18-action policy it only
    exercises the path)."""
    net, jnet, jparams = trained
    want = jax_vs_computer(jnet, jparams, seed=3, simplify_actions=simplify, **WINDOW)
    got = evaluate_vs_computer(net, seed=3, simplify_actions=simplify, device="cpu", **WINDOW)
    assert int(got.games) >= 8, got
    assert_result(got, want)


def test_greedy_head_to_head_matches_jax(trained):
    """The trained seat-1 policy against a fresh one (the port's init, carried
    to flax), both seat orders."""
    net, jnet, jparams = trained
    fresh = ActorCritic(hidden=(256, 256), generator=torch.Generator().manual_seed(0))
    fresh_flax = params_to_flax(fresh)
    for a, b, ja, jb in ((net, fresh, jparams, fresh_flax), (fresh, net, fresh_flax, jparams)):
        want = jax_head_to_head(jnet, ja, jnet, jb, seed=5, **WINDOW)
        got = evaluate_head_to_head(a, b, seed=5, device="cpu", **WINDOW)
        assert int(got.games) >= 4, got
        assert_result(got, want)


def test_random_policy_loses_to_rule_ai():
    """Sampled actions of an untrained policy against the rule AI."""
    net = ActorCritic(hidden=(16,), generator=torch.Generator().manual_seed(1))
    result = evaluate_vs_computer(net, num_envs=32, max_frames=150, winning_score=1,
                                  greedy=False, seed=0, device="cpu")
    assert int(result.games) >= 16, "most matches should finish"
    assert float(result.win_rate) < 0.4
    assert float(result.mean_score_diff) < 0


def test_bradley_terry_elo_matches_jax():
    """A synthetic league (known strengths, one undefeated member): the
    same ratings as JAX's, the anchor pinned, the order recovered."""
    true_elo = np.array([800.0, 1000.0, 1200.0, 1600.0])
    n = len(true_elo)
    rng = np.random.default_rng(0)
    games, wins = np.zeros((n, n)), np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            p_i = 1.0 / (1.0 + 10 ** ((true_elo[j] - true_elo[i]) / 400.0))
            w = rng.binomial(4000, p_i)
            games[i, j] = games[j, i] = 4000
            wins[i, j], wins[j, i] = w, 4000 - w
    elo = bradley_terry_elo(wins, games, anchor=1, anchor_elo=1000.0)
    np.testing.assert_array_equal(elo, jax_elo(wins, games, anchor=1, anchor_elo=1000.0))
    assert abs(elo[1] - 1000.0) < 1e-9
    assert list(np.argsort(elo)) == [0, 1, 2, 3]
    undefeated = (np.array([[0.0, 100.0], [0.0, 0.0]]), np.array([[0.0, 100.0], [100.0, 0.0]]))
    np.testing.assert_array_equal(bradley_terry_elo(*undefeated, anchor=1),
                                  jax_elo(*undefeated, anchor=1))
    with pytest.raises(ValueError, match="square"):
        bradley_terry_elo(np.zeros((2, 3)), np.zeros((2, 3)))
