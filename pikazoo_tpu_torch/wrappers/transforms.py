"""The six wrappers, batch-shaped.

Counterparts of ``pikazoo_tpu.wrappers.transforms``, each a thin layer over a
:class:`~pikazoo_tpu_torch.envs.PikaZoo`-shaped object: ``reset`` /
``reset_batch`` / ``step`` / ``step_batch`` with the port's signatures, on
leaves of any batch shape.  Every reset goes through ``_reset_from_keys``
with the per-env keys ``PikaZoo`` derives, so a stateless wrapper never
changes the trajectory of a seed; ``reset``'s ``counter`` / ``oracle`` /
``carry`` and ``step``'s ``oracle`` pass through to the env, as in JAX.  Stateless wrappers pass the inner state
through; :class:`RecordEpisodeStatistics` and :class:`ConvertSingleAgent`
wrap it in their own NamedTuple.  Observations, rewards, termination and
episode statistics equal the JAX wrappers' bit for bit
(``tests/test_torch_wrappers.py``).

The trainer's rollout calls ``step_batch_learner_fm``.  The JAX wrappers
forward it to the inner env through ``__getattr__``, so their trainer skips
them; here nothing is forwarded by name.  :class:`SimplifyAction` and
:class:`RewardByBallPosition` apply their transform on that path too, and
``make_ppo_trainer`` refuses a stack with any other wrapper in it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pikazoo_tpu_torch.core.rng import key_data, randint, split
from pikazoo_tpu_torch.envs.observations import _LOW_F, _SPAN_F
from pikazoo_tpu_torch.envs.pika_volley import batch_keys

# Per-seat 13 -> 18 action maps (reference simplify_action.py:16-20): FRONT
# and BACK are relative to the net, so the two seats' tables differ.
SIMPLIFY_P1 = torch.tensor((0, 1, 2, 3, 4, 6, 7, 10, 11, 12, 13, 14, 16),
                           dtype=torch.int32)
SIMPLIFY_P2 = torch.tensor((0, 1, 2, 4, 3, 7, 6, 10, 12, 11, 13, 15, 17),
                           dtype=torch.int32)


def simplify(table: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``table[actions]`` on ``actions``' device, indices clamped as JAX's
    gather clamps them (a negative index counts from the end first)."""
    n = table.shape[0]
    index = torch.where(actions < 0, actions + n, actions).clamp(0, n - 1)
    return table.to(actions.device)[index.long()]


class _Wrapper:
    def __init__(self, env):
        self.env = env

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    def _reset_from_keys(self, keys: torch.Tensor, **kwargs):
        return self.env._reset_from_keys(keys, **kwargs)

    def reset(self, key, device="cuda", **kwargs):
        return self._reset_from_keys(key_data(key, device), **kwargs)

    def reset_batch(self, key, batch_size: int, device="cuda"):
        return self._reset_from_keys(batch_keys(key, batch_size, device))

    def step(self, state, actions, oracle=None):
        return self.env.step(state, actions, oracle)

    def step_batch(self, state, actions):
        return self.step(state, actions)


class SimplifyAction(_Wrapper):
    """Relative-direction 13-action space mapped onto the raw 18."""

    num_actions = 13

    def step(self, state, actions, oracle=None):
        mapped = torch.stack([simplify(SIMPLIFY_P1, actions[..., 0]),
                              simplify(SIMPLIFY_P2, actions[..., 1])], dim=-1)
        return self.env.step(state, mapped, oracle)

    def step_batch_learner_fm(self, state, a1: torch.Tensor, a2: torch.Tensor):
        """The learner step on the seats' 13-action choices, each mapped
        through its own table."""
        return self.env.step_batch_learner_fm(state, simplify(SIMPLIFY_P1, a1),
                                              simplify(SIMPLIFY_P2, a2))


class RewardByBallPosition(_Wrapper):
    """Quadrant shaping reward from the ball position (8-tuple, 4 per
    seat), added every frame: quadrant ``(ball_y > y_line) + 2 * (ball_x >=
    x_line)`` of player 1's observation dims 26/27, so it must sit below
    :class:`NormalizeObservation` in a stack."""

    def __init__(self, env, additional_reward, x_line: int = 216,
                 y_line: int = 176):
        super().__init__(env)
        if len(additional_reward) != 8:
            raise ValueError(f"additional_reward needs 8 entries, got "
                             f"{len(additional_reward)}")
        self.additional_reward = torch.tensor(tuple(additional_reward),
                                              dtype=torch.float32)
        self.x_line = x_line
        self.y_line = y_line

    def _bonus(self, ball_x: torch.Tensor, ball_y: torch.Tensor):
        """``(seat 1's bonus, seat 2's bonus)``, float32 of the ball's shape."""
        pos = (ball_y > self.y_line).long() + 2 * (ball_x >= self.x_line).long()
        table = self.additional_reward.to(ball_x.device)
        return table[pos], table[4 + pos]

    def step(self, state, actions, oracle=None):
        state, ts = self.env.step(state, actions, oracle)
        bonus = torch.stack(self._bonus(ts.obs[..., 0, 26], ts.obs[..., 0, 27]), dim=-1)
        return state, ts._replace(rewards=ts.rewards.to(torch.float32) + bonus)

    def step_batch_learner_fm(self, state, a1: torch.Tensor, a2: torch.Tensor):
        """The learner step with each seat's bonus added to its reward
        column; the quadrant from the new state's ball, the values player
        1's observation dims 26/27 hold."""
        state, norm_obs, reward, terminated = self.env.step_batch_learner_fm(state, a1, a2)
        bonus = torch.cat(self._bonus(state.ball.x, state.ball.y))
        return state, norm_obs, reward + bonus, terminated


class RewardInNormalState(_Wrapper):
    """Replace zero (non-scoring-frame) rewards with a constant."""

    def __init__(self, env, reward):
        super().__init__(env)
        self.reward = reward

    def step(self, state, actions, oracle=None):
        state, ts = self.env.step(state, actions, oracle)
        r = ts.rewards
        # JAX's promotion: a Python int fill is int32, a float one float32.
        fill = torch.tensor(self.reward, dtype=torch.int32 if isinstance(self.reward, int)
                            else torch.float32, device=r.device)
        out = torch.promote_types(r.dtype, fill.dtype)
        return state, ts._replace(rewards=torch.where(r == 0, fill.to(out), r.to(out)))


class NormalizeObservation(_Wrapper):
    """Min-max normalise observations to [0, 1] float32 with the Box bounds:
    ``(obs - low) / span``, a true division by a tensor, as JAX computes it."""

    @staticmethod
    def _norm(ts):
        device = ts.obs.device
        low = torch.tensor(_LOW_F, device=device)
        span = torch.tensor(_SPAN_F, device=device)
        return ts._replace(obs=(ts.obs.to(torch.float32) - low) / span)

    def _reset_from_keys(self, keys: torch.Tensor, **kwargs):
        state, ts = self.env._reset_from_keys(keys, **kwargs)
        return state, self._norm(ts)

    def step(self, state, actions, oracle=None):
        state, ts = self.env.step(state, actions, oracle)
        return state, self._norm(ts)


class EpisodeStatsState(NamedTuple):
    inner: object
    episode_return: torch.Tensor  # S + (2,) float32
    episode_length: torch.Tensor  # S + (2,) int32


class EpisodeStats(NamedTuple):
    episode_return: torch.Tensor
    episode_length: torch.Tensor
    done: torch.Tensor


class RecordEpisodeStatistics(_Wrapper):
    """Accumulate per-seat episode return and length; report them on the
    termination frame.

    ``step`` returns ``(state, ts, EpisodeStats)``; the stats are valid where
    ``done`` is set.  The accumulators zero on the termination frame, as
    JAX's do, so the wrapper composes with auto reset."""

    def _reset_from_keys(self, keys: torch.Tensor, **kwargs):
        inner, ts = self.env._reset_from_keys(keys, **kwargs)
        shape, device = keys.shape[:-1] + (2,), keys.device
        return EpisodeStatsState(inner, torch.zeros(shape, dtype=torch.float32, device=device),
                                 torch.zeros(shape, dtype=torch.int32, device=device)), ts

    def step(self, state: EpisodeStatsState, actions, oracle=None):
        inner, ts = self.env.step(state.inner, actions, oracle)
        ep_ret = state.episode_return + ts.rewards.to(torch.float32)
        ep_len = state.episode_length + 1
        done = ts.terminated == 1
        stats = EpisodeStats(ep_ret, ep_len, done.to(torch.int32))
        ep_ret = torch.where(done[..., None], 0.0, ep_ret)
        ep_len = torch.where(done[..., None], 0, ep_len)
        return EpisodeStatsState(inner, ep_ret, ep_len), ts, stats


class SingleAgentState(NamedTuple):
    inner: object
    key: torch.Tensor  # S + (2,) int32 key bits of the opponent's draws


class ConvertSingleAgent(_Wrapper):
    """Single-agent view of one side; the opponent acts uniformly at random
    from a carried key, drawn as JAX draws it (``split`` and ``randint``)."""

    def __init__(self, env, side: str):
        super().__init__(env)
        if side not in ("player_1", "player_2"):
            raise ValueError(f"side must be 'player_1' or 'player_2', got {side!r}")
        self.me = 0 if side == "player_1" else 1
        self.opponent_actions = env.num_actions

    def _reset_from_keys(self, keys: torch.Tensor, **kwargs):
        keys = split(keys)
        inner, ts = self.env._reset_from_keys(keys[..., 1, :], **kwargs)
        return SingleAgentState(inner, keys[..., 0, :]), self._view(ts)

    def step(self, state: SingleAgentState, action, oracle=None):
        keys = split(state.key)
        opp = randint(keys[..., 1, :], (), 0, self.opponent_actions)
        pair = [action.to(torch.int32), opp]
        if self.me == 1:
            pair.reverse()
        inner, ts = self.env.step(state.inner, torch.stack(pair, dim=-1), oracle)
        return SingleAgentState(inner, keys[..., 0, :]), self._view(ts)

    def _view(self, ts):
        return ts._replace(obs=ts.obs[..., self.me, :], rewards=ts.rewards[..., self.me])
