"""PettingZoo ``ParallelEnv`` adapter — the reference's API surface.

A drop-in replacement for the reference ``pikazoo_v0.env(...)``
(``pikazoo_env.py:27-29, 72-248``) and for the JAX package's adapter: the
same constructor kwargs, agent names, ``Discrete(18)`` action spaces,
``Box`` int32 35-dim observation space with the same bounds, shared mutable
``infos["score"]`` list and agent-list lifecycle.  It steps one env (batch
shape ``()``) of :class:`~pikazoo_tpu_torch.envs.PikaZoo` eagerly, on the
card unless the caller passes ``device="cpu"``, or (``backend="native"``)
the C++ host engine.

Reproduced quirks:

* ``reset(seed=...)`` **ignores its seed**: seeding happens only at
  construction (reference ``pikazoo_env.py:149-173`` never re-seeds).  Pass
  ``seed=`` to the constructor for reproducibility.  Episode ``i`` is keyed
  ``core.rng.fold_in(key_data(seed), i)``, as in the JAX adapter.
* State that the reference only initializes at construction (ball position
  history, diving_direction, input latches, ...) leaks across ``reset()``
  boundaries: the adapter carries the previous state into reset exactly as
  the reference's partially reset objects do.

A torch step makes one host copy: observations, player 1's reward,
termination, scores and the draw counter come back in one transfer.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from pikazoo_tpu_torch.core.rng import fold_in, key_data, site_value_host
from pikazoo_tpu_torch.envs import (NUM_ACTIONS, OBS_DIM, OBS_HIGH, OBS_LOW,
                                    EnvConfig, PikaZoo)
from pikazoo_tpu_torch.render import Renderer

BACKENDS = ("torch", "native")


def env(**kwargs):
    return raw_env(**kwargs)


class raw_env:  # noqa: N801 — matches the reference class name
    metadata = {
        "render_modes": ["human", "rgb_array"],
        "name": "pikazoo_v0",
        "render_fps": 20,
    }

    # The five reference kwargs stay positional-compatible
    # (pikazoo_env.py:79-86); everything after ``*`` is an extension of this
    # adapter and keyword-only, so adding extensions can never silently
    # reinterpret an existing caller's positional argument.
    def __init__(self, winning_score: int = 15, serve: str = "winner",
                 is_player1_computer: bool = False,
                 is_player2_computer: bool = False,
                 render_mode: Optional[str] = None, *,
                 seed: Optional[int] = None,
                 render_rng_coupled: bool = False,
                 sprite_dir: Optional[str] = None,
                 render_style: Optional[str] = None,
                 backend: str = "torch",
                 device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.possible_agents = ["player_1", "player_2"]
        self.agents = self.possible_agents[:]
        self._config = EnvConfig(
            winning_score=winning_score, serve=serve,
            is_player1_computer=is_player1_computer,
            is_player2_computer=is_player2_computer,
            auto_reset=False)
        self._env = PikaZoo(self._config)
        self._backend = backend
        # backend="native" serves the frame loop from the C++ host engine
        # (bit-equal to the torch env from the same key) and the whole
        # dict-level step in one call of the CPython fast path; both build
        # at first use and raise if they cannot.  Its state lives on the host.
        self._device = torch.device("cpu" if backend == "native" else device)
        if backend == "native":
            from pikazoo_tpu_torch.native import engine as native  # noqa: PLC0415

            self._eng = native.NativeEngine(
                winning_score=winning_score, serve=serve,
                is_player1_computer=is_player1_computer,
                is_player2_computer=is_player2_computer, auto_reset=False)
            self._matrix = None
            self._stepper = None
            self._fast = None
            self._cols = tuple(native.FIELDS.index(f) for f in
                               ("score1", "score2", "draw_counter"))
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        self._key = key_data(seed)
        self._episode_index = 0
        self._state = None
        self.scores = [0, 0]
        self.render_mode = render_mode
        # The host's mirror of the stream key and draw counter, for the
        # coupled render draws (no device round trip a draw); a dirty
        # counter goes back into the state before the next step.
        self._rng_key_host = None
        self._draw_counter_host = 0
        self._draws_dirty = False
        # Perform the reference's construction-time initialization so that a
        # pre-reset step() (out of contract, but possible) sees sane state.
        # Constructed BEFORE the renderer: in coupled mode the renderer's 40
        # cloud-construction draws follow the boldness/serve draws, exactly
        # the reference's construction order (physics at pikazoo_env.py:97,
        # get_all_image clouds at :475-479).
        self._do_reset()
        # Opt-in reference-compatible render RNG coupling: cloud/wave
        # dynamics consume the env's draw-slot stream, so rendering perturbs
        # subsequent gameplay draws like the reference (cloud_and_wave.py
        # drawing from self.np_random, pikazoo_env.py:349).
        self._render_rng_coupled = bool(render_rng_coupled and render_mode)
        draw_source = self._coupled_draw if self._render_rng_coupled else None
        self._renderer = Renderer(render_mode, seed=seed & 0xFFFFFFFF,
                                  sprite_dir=sprite_dir,
                                  draw_source=draw_source,
                                  style=render_style)

    # ------------------------------------------------------------ spaces --
    @functools.lru_cache(maxsize=None)
    def observation_space(self, agent=None):
        from gymnasium import spaces  # noqa: PLC0415
        return spaces.Box(low=OBS_LOW, high=OBS_HIGH, shape=(OBS_DIM,),
                          dtype=np.int32)

    @functools.lru_cache(maxsize=None)
    def action_space(self, agent=None):
        from gymnasium import spaces  # noqa: PLC0415
        return spaces.Discrete(NUM_ACTIONS)

    # --------------------------------------------------------------- api --
    def _do_reset(self):
        """Start a new episode; returns the (2, 35) int32 reset observation."""
        key = fold_in(self._key, self._episode_index)
        self._episode_index += 1
        self._rng_key_host = key.numpy()
        if self._backend == "native":
            if self._matrix is None:
                # Episode 0: construction-time init through the torch reset
                # on the CPU, then hand the packed state to the C++ engine.
                # Later resets run natively, bit-equal to the torch reset.
                from pikazoo_tpu_torch.native import engine as native  # noqa: PLC0415

                self._state, _ = self._env.reset(key, "cpu")
                self._matrix = native.NativeEngine.pack(self._state)
                self._stepper = self._eng.single_stepper(self._matrix)
                self._fast = native.make_fast_stepper(
                    self._matrix, self.scores,
                    winning_score=self._config.winning_score,
                    serve_mode=self._eng.serve_mode,
                    is_p1_computer=self._eng.p1_cpu,
                    is_p2_computer=self._eng.p2_cpu, auto_reset=0)
            else:
                self._eng.reset(self._matrix, rng_key=self._rng_key_host)
            return self._stepper.observe()
        self._state, ts = self._env.reset(key, self._device, carry=self._state)
        host = torch.cat([ts.obs.reshape(-1),
                          self._state.draw_counter.reshape(1)]).cpu().numpy()
        self._draw_counter_host = int(host[-1])
        self._draws_dirty = False
        return host[:2 * OBS_DIM].reshape(2, OBS_DIM)

    def _coupled_draw(self, upper: int) -> int:
        if self._backend == "native":
            # The draw counter lives in the state matrix the C++ engine
            # steps, so host draws advance the same stream with no syncing.
            col = self._cols[2]
            value = site_value_host(self._matrix[0, -2:], int(self._matrix[0, col]), upper)
            self._matrix[0, col] += 1
            return value
        value = site_value_host(self._rng_key_host, self._draw_counter_host, upper)
        self._draw_counter_host += 1
        self._draws_dirty = True
        return value

    def reset(self, seed=None, options=None):
        # NOTE: ``seed`` ignored on purpose (reference quirk, see module doc).
        del seed, options
        self.agents = self.possible_agents[:]
        self.scores[0] = 0
        self.scores[1] = 0
        obs = self._do_reset()
        if self.render_mode == "human":
            self.render()
        return self._obs_dict(obs), self._infos()

    def step(self, actions: Dict[str, int]):
        if self._backend == "native":
            out = self._fast.step(actions)
            if self.render_mode == "human":
                self.render()
            if out[5] & 1:  # terminated
                self.agents = []
            return out[:5]
        if self._draws_dirty:
            self._state = self._state._replace(draw_counter=torch.tensor(
                self._draw_counter_host, dtype=torch.int32, device=self._device))
            self._draws_dirty = False
        acts = torch.tensor([int(actions[a]) for a in self.agents],
                            dtype=torch.int32).to(self._device)
        self._state, ts = self._env.step(self._state, acts)
        host = torch.cat([ts.obs.reshape(-1), ts.rewards[:1], ts.terminated.reshape(1),
                          ts.scores, self._state.draw_counter.reshape(1)]).cpu().numpy()
        n = 2 * OBS_DIM
        r1, terminated = int(host[n]), bool(host[n + 1])
        self.scores[0] = int(host[n + 2])
        self.scores[1] = int(host[n + 3])
        self._draw_counter_host = int(host[n + 4])
        return self._finish_step(host[:n].reshape(2, OBS_DIM), r1, terminated)

    def _finish_step(self, obs, r1: int, terminated: bool):
        if self.render_mode == "human":
            self.render()
        observations = self._obs_dict(obs)
        rewards = {self.agents[0]: r1, self.agents[1]: -r1}
        terminations = {agent: terminated for agent in self.agents}
        truncations = {agent: False for agent in self.agents}
        infos = self._infos()
        if terminated:
            self.agents = []
        return observations, rewards, terminations, truncations, infos

    def _step_native_plain(self, actions: Dict[str, int]):
        """The native backend's step assembled in Python over
        ``SingleStepper.step_obs``: the plain version of the fast path's
        one native call, which the tests hold it against."""
        obs, rew, flags = self._stepper.step_obs(int(actions["player_1"]),
                                                 int(actions["player_2"]))
        r1 = 0
        if flags & 2:  # scores only change on round-end frames
            row = self._matrix[0]
            self.scores[0] = int(row[self._cols[0]])
            self.scores[1] = int(row[self._cols[1]])
            r1 = int(rew[0])
        return self._finish_step(obs, r1, bool(flags & 1))

    def render(self):
        if self.render_mode is None:
            import gymnasium  # noqa: PLC0415
            gymnasium.logger.warn(
                "You are calling render method without specifying any "
                "render mode.")
            return None
        state = self._state
        if self._backend == "native":
            from pikazoo_tpu_torch.native import NativeEngine  # noqa: PLC0415
            state = NativeEngine.unpack(self._matrix, self._state)
        return self._renderer.render(state)

    def close(self):
        self._renderer.close()

    # ----------------------------------------------------------- helpers --
    def _obs_dict(self, obs):
        return {"player_1": np.array(obs[0]), "player_2": np.array(obs[1])}

    def _infos(self):
        # Shared mutable list, like the reference (consumers must copy).
        return {agent: {"score": self.scores} for agent in self.agents}

    # PettingZoo helpers some tools expect.
    @property
    def num_agents(self):
        return len(self.agents)

    @property
    def max_num_agents(self):
        return len(self.possible_agents)

    def state(self):
        raise NotImplementedError

    def __str__(self):
        return self.metadata["name"]

    @property
    def unwrapped(self):
        return self
