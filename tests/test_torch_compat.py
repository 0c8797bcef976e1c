"""The port's PettingZoo drop-in (``pikazoo_tpu_torch.pikazoo_v0`` /
``compat``): pettingzoo's API tests on the torch backend (on the CPU) and
the native backend, trajectories equal to the JAX adapter's from the same
seed across episode ends and their carried resets, and the PettingZoo-level
wrapper stacks equal to JAX's."""

import numpy as np
import pytest
import torch

pytest.importorskip("pettingzoo")

from pettingzoo.test import api_test, parallel_api_test  # noqa: E402
from pettingzoo.utils.conversions import parallel_to_aec  # noqa: E402

from pikazoo_tpu import compat as jax_compat  # noqa: E402
from pikazoo_tpu.compat import wrappers as jax_cw  # noqa: E402
from pikazoo_tpu_torch import compat, pikazoo_v0  # noqa: E402
from pikazoo_tpu_torch.compat import wrappers as cw  # noqa: E402

AGENTS = ("player_1", "player_2")


def test_parallel_api_conformance():
    parallel_api_test(pikazoo_v0.env(seed=0, device="cpu"), num_cycles=1000)


def test_parallel_api_conformance_native_backend():
    parallel_api_test(pikazoo_v0.env(seed=0, backend="native"), num_cycles=3000)


def test_parallel_api_conformance_native_backend_soak():
    """The reference's own cycle count (``parallel_api_test(env,
    num_cycles=1_000_000)``): both episodes run to their natural 15-point
    end under random actions, through the agent-list-emptying path."""
    parallel_api_test(pikazoo_v0.env(seed=0, backend="native"), num_cycles=1_000_000)


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_aec_conversion_conformance(backend):
    aec = parallel_to_aec(pikazoo_v0.env(seed=0, backend=backend, device="cpu"))
    api_test(aec, num_cycles=300 if backend == "torch" else 1000)


def same_step(want, got, where):
    """Two adapters' step (or reset) results are equal, dict by dict."""
    if len(want) == 2:  # reset: (observations, infos)
        want, got = (want[0], {}, {}, {}, want[1]), (got[0], {}, {}, {}, got[1])
    for name, w, g in zip(("obs", "rewards", "terminations", "truncations", "infos"),
                          want, got, strict=True):
        assert list(w) == list(g), (where, name)
        for agent in w:
            if name == "obs":
                assert g[agent].dtype == np.int32 and g[agent].shape == (35,)
                np.testing.assert_array_equal(g[agent], w[agent], err_msg=f"{where} {agent}")
            elif name == "infos":
                assert g[agent]["score"] == w[agent]["score"], (where, agent)
            else:
                assert g[agent] == w[agent] and type(g[agent]) is type(w[agent]), \
                    (where, name, agent)


# (config, steps cap); each runs until two episode ends or the cap.
TRAJECTORIES = {
    "human-winner": (dict(winning_score=2), 600),
    "human-random-serve": (dict(winning_score=2, serve="random"), 600),
    "ai-seat-2-alternate": (dict(winning_score=1, serve="alternate",
                                 is_player2_computer=True), 300),
}


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_trajectories_match_the_jax_adapter(case):
    """Obs, rewards, terminations, truncations and ``infos["score"]`` of the
    torch backend (CPU) and the native backend equal the JAX adapter's from
    the same seed (>= 2^32: the key keeps its low 32 bits), step by step,
    through an episode end and the reset that carries its state."""
    kw, cap = TRAJECTORIES[case]
    seed = 2 ** 32 + 17
    envs = (jax_compat.env(seed=seed, **kw), pikazoo_v0.env(seed=seed, device="cpu", **kw),
            pikazoo_v0.env(seed=seed, backend="native", **kw))
    gen = np.random.default_rng(5)
    ends = steps = 0
    while ends < 2 and steps < cap:
        outs = [e.reset() for e in envs]
        for out in outs[1:]:
            same_step(outs[0], out, f"reset after {ends} ends")
        while envs[0].agents and steps < cap:
            acts = {a: int(gen.integers(0, 18)) for a in envs[0].agents}
            outs = [e.step(dict(acts)) for e in envs]
            for out in outs[1:]:
                same_step(outs[0], out, f"step {steps}")
            assert [e.agents for e in envs[1:]] == [envs[0].agents] * 2
            assert [e.scores for e in envs[1:]] == [envs[0].scores] * 2
            steps += 1
        ends += not envs[0].agents
    assert ends >= 1, f"{case}: no episode ended in {steps} steps"


def test_seed_keeps_its_low_32_bits():
    """``seed`` and ``seed + 2^32`` key the same episodes, as
    ``jax.random.key`` does."""
    a, b = (pikazoo_v0.env(seed=s, device="cpu", winning_score=3) for s in (5, 2 ** 32 + 5))
    same_step(a.reset(), b.reset(), "reset")
    gen = np.random.default_rng(0)
    for t in range(60):
        acts = {x: int(gen.integers(0, 18)) for x in AGENTS}
        same_step(a.step(dict(acts)), b.step(dict(acts)), f"step {t}")


def test_compat_seeded_reproducibility():
    def rollout(seed):
        env = compat.env(seed=seed, device="cpu")
        env.reset()
        gen = np.random.default_rng(0)
        frames = []
        for _ in range(150):
            acts = {a: int(gen.integers(0, 18)) for a in env.agents}
            obs, _, term, _, _ = env.step(acts)
            frames.append(np.concatenate([obs["player_1"], obs["player_2"]]))
            if term["player_1"]:
                break
        return np.asarray(frames)

    a, b, c = rollout(7), rollout(7), rollout(8)
    np.testing.assert_array_equal(a, b)
    assert a.shape != c.shape or not np.array_equal(a, c)


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_wrapper_stack_matches_jax(backend):
    """``SimplifyAction(RewardByBallPosition(env))`` over the port's adapter
    equals the same stack of JAX's wrappers over JAX's adapter."""
    shaping = (0.1, 0.2, -0.1, -0.2, -0.1, -0.2, 0.1, 0.2)

    def stack(lib, env):
        return lib.SimplifyAction(lib.RewardByBallPosition(env, additional_reward=shaping))

    want = stack(jax_cw, jax_compat.env(seed=11))
    got = stack(cw, pikazoo_v0.env(seed=11, backend=backend, device="cpu"))
    assert got.action_space("player_1").n == 13
    same_step(want.reset(), got.reset(), "reset")
    gen = np.random.default_rng(4)
    for t in range(120):
        acts = {a: int(gen.integers(0, 13)) for a in want.agents}
        w, g = want.step(dict(acts)), got.step(dict(acts))
        for agent in AGENTS:
            np.testing.assert_array_equal(g[0][agent], w[0][agent])
            assert g[1][agent] == w[1][agent] and g[2][agent] == w[2][agent], (t, agent)


def test_single_agent_and_stats_match_jax():
    """``ConvertSingleAgent(RecordEpisodeStatistics(env))`` through an
    episode end: the same observations, rewards and episode statistics."""
    def stack(lib, env):
        return lib.ConvertSingleAgent(lib.RecordEpisodeStatistics(env), side="player_1",
                                      opponent_seed=0)

    want = stack(jax_cw, jax_compat.env(seed=2, winning_score=1))
    got = stack(cw, pikazoo_v0.env(seed=2, winning_score=1, device="cpu"))
    (w_obs, _), (g_obs, _) = want.reset(), got.reset()
    np.testing.assert_array_equal(g_obs, w_obs)
    gen = np.random.default_rng(2)
    for t in range(3000):
        action = int(gen.integers(0, 18))
        w, g = want.step(action), got.step(action)
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"step {t}")
        assert g[1:4] == w[1:4], t
        if w[2]:
            assert g[4]["episode"] == w[4]["episode"]
            assert abs(g[4]["episode"]["r"]) == 1 and g[4]["episode"]["l"] > 0
            return
    pytest.fail("episode did not finish")


def test_render_rgb_array_torch_and_native_agree():
    e1 = pikazoo_v0.env(seed=3, render_mode="rgb_array", device="cpu")
    e2 = pikazoo_v0.env(seed=3, render_mode="rgb_array", backend="native")
    e1.reset(), e2.reset()
    frame = e1.render()
    assert frame.shape == (304, 432, 3) and frame.dtype == np.uint8
    assert not np.array_equal(frame[0, 0], frame[290, 0])
    np.testing.assert_array_equal(frame, e2.render())
    for _ in range(30):
        acts = {"player_1": 5, "player_2": 2}
        e1.step(dict(acts)), e2.step(dict(acts))
    np.testing.assert_array_equal(e1.render(), e2.render())
    e1.close(), e2.close()


def test_backend_must_be_torch_or_native():
    with pytest.raises(ValueError, match="backend"):
        pikazoo_v0.env(seed=0, backend="jax", device="cpu")


def test_one_host_copy_a_step(monkeypatch):
    """A torch step brings obs, rewards, termination, scores and the draw
    counter to the host in one copy, with no per-field read."""
    env = pikazoo_v0.env(seed=1, device="cpu", is_player2_computer=True)
    env.reset()
    counts = {"cpu": 0, "item": 0, "tolist": 0}
    for name in counts:
        original = getattr(torch.Tensor, name)

        def counted(self, *args, _name=name, _original=original, **kwargs):
            counts[_name] += 1
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    for _ in range(5):
        env.step({"player_1": 3, "player_2": 0})
    assert counts == {"cpu": 5, "item": 0, "tolist": 0}, counts


def test_spaces_and_helpers():
    env = pikazoo_v0.env(seed=0, device="cpu")
    jax_env = jax_compat.env(seed=0)
    for agent in AGENTS:
        assert env.observation_space(agent) == jax_env.observation_space(agent)
        assert env.action_space(agent) == jax_env.action_space(agent)
    assert str(env) == "pikazoo_v0" and env.unwrapped is env
    assert env.num_agents == env.max_num_agents == 2
    assert env.metadata == jax_env.metadata
