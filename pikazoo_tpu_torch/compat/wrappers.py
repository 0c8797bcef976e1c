"""PettingZoo-level wrappers for the compat env.

The same six wrapper capabilities as the functional transforms in
``pikazoo_tpu_torch.wrappers`` (and as the reference's ``pikazoo/wrappers``), here
operating on any PettingZoo ``ParallelEnv`` via a single generic delegating
base.  Use these when driving the compat adapter through host-side PettingZoo
tooling; use the functional transforms for traced/batched pipelines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# 13 -> 18 action maps (relative FRONT/BACK per side); see
# pikazoo_tpu_torch.wrappers.transforms for the derivation.
_SIMPLIFY = {
    "player_1": (0, 1, 2, 3, 4, 6, 7, 10, 11, 12, 13, 14, 16),
    "player_2": (0, 1, 2, 4, 3, 7, 6, 10, 12, 11, 13, 15, 17),
}


class ParallelWrapper:
    """Minimal delegating base (PettingZoo's BaseParallelWrapper-equivalent,
    kept dependency-light)."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, actions):
        return self.env.step(actions)

    def observation_space(self, agent=None):
        return self.env.observation_space(agent)

    def action_space(self, agent=None):
        return self.env.action_space(agent)

    @property
    def unwrapped(self):
        return self.env.unwrapped


class SimplifyAction(ParallelWrapper):
    """13 relative-direction actions mapped onto the raw 18."""

    def action_space(self, agent=None):
        from gymnasium import spaces  # noqa: PLC0415
        return spaces.Discrete(13)

    def step(self, actions):
        mapped = {agent: _SIMPLIFY[agent][actions[agent]]
                  for agent in actions}
        return self.env.step(mapped)


class RewardByBallPosition(ParallelWrapper):
    def __init__(self, env, additional_reward, x_line: int = 216,
                 y_line: int = 176):
        super().__init__(env)
        assert len(additional_reward) == 8
        self.additional_reward = tuple(additional_reward)
        self.x_line = x_line
        self.y_line = y_line

    def step(self, actions):
        obs, rews, term, trunc, infos = self.env.step(actions)
        quadrant = int(obs["player_1"][27] > self.y_line) + \
            2 * int(obs["player_1"][26] >= self.x_line)
        for i, agent in enumerate(self.possible_agents):
            rews[agent] += self.additional_reward[i * 4 + quadrant]
        return obs, rews, term, trunc, infos


class RewardInNormalState(ParallelWrapper):
    def __init__(self, env, reward):
        super().__init__(env)
        self.reward = reward

    def step(self, actions):
        obs, rews, term, trunc, infos = self.env.step(actions)
        rews = {a: (self.reward if r == 0 else r) for a, r in rews.items()}
        return obs, rews, term, trunc, infos


class NormalizeObservation(ParallelWrapper):
    def __init__(self, env):
        super().__init__(env)
        space = env.observation_space("player_1")
        self._low = space.low.astype(np.float32)
        self._span = (space.high - space.low).astype(np.float32)

    def observation_space(self, agent=None):
        from gymnasium import spaces  # noqa: PLC0415
        return spaces.Box(low=0.0, high=1.0, shape=(35,), dtype=np.float32)

    def _norm(self, obs):
        return {a: (o.astype(np.float32) - self._low) / self._span
                for a, o in obs.items()}

    def reset(self, seed=None, options=None):
        obs, infos = self.env.reset(seed=seed, options=options)
        return self._norm(obs), infos

    def step(self, actions):
        obs, rews, term, trunc, infos = self.env.step(actions)
        return self._norm(obs), rews, term, trunc, infos


class RecordEpisodeStatistics(ParallelWrapper):
    def __init__(self, env):
        super().__init__(env)
        self._returns = {a: 0.0 for a in env.possible_agents}
        self._lengths = {a: 0 for a in env.possible_agents}

    def reset(self, seed=None, options=None):
        obs, infos = self.env.reset(seed=seed, options=options)
        for a in self.possible_agents:
            self._returns[a] = 0.0
            self._lengths[a] = 0
        return obs, infos

    def step(self, actions):
        obs, rews, term, trunc, infos = self.env.step(actions)
        for a in self.possible_agents:
            self._returns[a] += rews[a]
            self._lengths[a] += 1
        if all(term.values()) or all(trunc.values()):
            for a in self.possible_agents:
                infos.setdefault(a, {})["episode"] = {
                    "r": self._returns[a], "l": self._lengths[a]}
        return obs, rews, term, trunc, infos


class ConvertSingleAgent(ParallelWrapper):
    """Gymnasium-style single-agent view; the opponent samples uniformly."""

    def __init__(self, env, side: str, opponent_seed: Optional[int] = None):
        super().__init__(env)
        assert side in ("player_1", "player_2")
        self.side = side
        self.other_side = "player_1" if side == "player_2" else "player_2"
        self._opp_space = env.action_space(self.other_side)
        if opponent_seed is not None:
            self._opp_space.seed(opponent_seed)

    def reset(self, seed=None, options=None):
        obs, infos = self.env.reset(seed=seed, options=options)
        return obs[self.side], infos[self.side]

    def step(self, action):
        actions = {self.side: action,
                   self.other_side: self._opp_space.sample()}
        obs, rews, term, trunc, infos = self.env.step(actions)
        return (obs[self.side], rews[self.side], term[self.side],
                trunc[self.side], infos[self.side])
