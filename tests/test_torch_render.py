"""The port's renderer (``pikazoo_tpu_torch.render``): frames equal to the JAX
``Renderer``'s from the same state in the pixel-art and flat styles, the
coupled render mode equal to the JAX adapter's (frames and draw counter),
and the counterparts of ``tests/test_pixel_art.py`` and the layout checks of
``tests/test_render_parity.py``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu import compat as jax_compat
from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.render import Renderer as JaxRenderer
from pikazoo_tpu_torch import EnvConfig, PikaZoo, pikazoo_v0
from pikazoo_tpu_torch.convert import env_state_from_numpy
from pikazoo_tpu_torch.core.state import host_state
from pikazoo_tpu_torch.native import FIELDS
from pikazoo_tpu_torch.render import Renderer
from pikazoo_tpu_torch.render.pixel_art import build_sprites
from pikazoo_tpu_torch.render.sprites import _POSE_NAMES, player_sprite_index

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

# Reference asset sizes the generated set must honor.
_EXPECT_SIZES = {
    "sky_blue": (16, 16), "mountain": (64, 432), "ground_red": (16, 16),
    "ground_line": (16, 16), "ground_line_leftmost": (16, 16),
    "ground_line_rightmost": (16, 16), "ground_yellow": (16, 16),
    "net_pillar": (8, 8), "net_pillar_top": (8, 8), "cloud": (24, 48),
    "wave": (32, 16), "shadow": (8, 32), "ball_punch": (40, 40),
    "ball_trail": (40, 40), "ball_hyper": (40, 40),
}


def jax_states(frames: int):
    """A JAX game's states every 25 frames (power hits, punch effects and
    score changes among them), numpy leaves."""
    env = JaxZoo(JaxConfig(winning_score=15, serve="random", is_player2_computer=True))
    state, _ = env.reset(jax.random.key(4))
    step = jax.jit(env.step)
    gen = np.random.default_rng(8)
    out = []
    for t in range(frames):
        state, _ = step(state, jnp.asarray(gen.integers(0, 18, 2), jnp.int32))
        if t % 25 == 0:
            out.append(jax.device_get(state))
    return out


@pytest.mark.parametrize("style", ["pixel", "flat"])
def test_frames_match_the_jax_renderer(style):
    """One renderer each, the same seed, the same states (the port's as
    tensors): the same frames, punch countdown and cloud motion included."""
    states = jax_states(600)
    assert any(int(s.ball.is_power_hit) for s in states)
    assert any(int(s.scores.sum()) for s in states)
    want, got = JaxRenderer("rgb_array", seed=9, style=style), Renderer("rgb_array", seed=9,
                                                                        style=style)
    for i, state in enumerate(states):
        np.testing.assert_array_equal(got.render(env_state_from_numpy(state)),
                                      want.render(state), err_msg=f"state {i}")


def test_tensor_and_numpy_states_draw_the_same():
    env = PikaZoo(EnvConfig())
    state, _ = env.reset(0, "cpu")
    host = host_state(state)
    assert isinstance(host.ball.x, np.ndarray) and host.rng_key.shape == (2,)
    a, b = Renderer("rgb_array", seed=1), Renderer("rgb_array", seed=1)
    np.testing.assert_array_equal(a.draw(state), b.draw(host))


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_coupled_render_matches_the_jax_adapter(backend):
    """``render_rng_coupled=True``: the cloud / wave draws come from the
    env's stream, so frames and the draw counter equal the JAX adapter's,
    across an episode end and its reset."""
    kw = dict(seed=31, winning_score=1, render_mode="rgb_array", render_rng_coupled=True)
    want = jax_compat.env(**kw)
    got = pikazoo_v0.env(backend=backend, device="cpu", **kw)
    gen = np.random.default_rng(3)
    ends = 0
    for episode in range(2):
        want.reset(), got.reset()
        np.testing.assert_array_equal(got.render(), want.render())
        for t in range(400):
            acts = {a: int(gen.integers(0, 18)) for a in want.agents}
            w, g = want.step(dict(acts)), got.step(dict(acts))
            for agent in w[0]:
                np.testing.assert_array_equal(g[0][agent], w[0][agent])
            np.testing.assert_array_equal(got.render(), want.render(),
                                          err_msg=f"episode {episode} step {t}")
            counter = got._draw_counter_host if backend == "torch" else \
                int(got._matrix[0, FIELDS.index("draw_counter")])
            assert counter == want._draw_counter_host, (episode, t)
            if not want.agents:
                ends += 1
                break
    assert ends == 2


def test_compat_coupled_render_perturbs_stream():
    coupled = pikazoo_v0.env(seed=123, render_mode="rgb_array", render_rng_coupled=True,
                             device="cpu")
    plain = pikazoo_v0.env(seed=123, device="cpu")
    coupled.reset(), plain.reset()
    gen = np.random.default_rng(0)
    for _ in range(30):
        acts = {a: int(x) for a, x in zip(("player_1", "player_2"), gen.integers(0, 18, 2))}
        coupled.step(dict(acts))
        coupled.render()
        plain.step(dict(acts))
    assert coupled._draw_counter_host > int(plain._state.draw_counter)


def test_renderer_decoupled_by_default():
    plain = pikazoo_v0.env(seed=123, device="cpu")
    rendered = pikazoo_v0.env(seed=123, render_mode="rgb_array", device="cpu")
    plain.reset(), rendered.reset()
    gen = np.random.default_rng(0)
    for _ in range(60):
        acts = {a: int(x) for a, x in zip(("player_1", "player_2"), gen.integers(0, 18, 2))}
        obs_a, *_ = plain.step(dict(acts))
        obs_b, *_ = rendered.step(dict(acts))
        rendered.render()
        np.testing.assert_array_equal(obs_a["player_1"], obs_b["player_1"])


def test_procedural_layout_regression():
    """Flat style: ball, players, net and ground strata on the expected
    pixels (reference layout pikazoo_env.py:250-362)."""
    state, _ = PikaZoo(EnvConfig()).reset(0, "cpu")
    frame = Renderer("rgb_array", style="flat").render(state)
    assert frame.shape == (304, 432, 3)
    bx, by = int(state.ball.x), int(state.ball.y)
    assert tuple(frame[by, bx]) in ((232, 64, 56), (255, 255, 255))
    p1x, p1y = int(state.p1.x), int(state.p1.y)
    assert tuple(frame[p1y + 20, p1x]) == (252, 208, 56)
    p2x, p2y = int(state.p2.x), int(state.p2.y)
    assert tuple(frame[p2y + 20, p2x]) == (248, 176, 40)
    assert tuple(frame[200, 216]) == (240, 240, 240)  # net pillar
    assert tuple(frame[256, 100]) == (208, 96, 88)  # ground red stratum
    assert tuple(frame[270, 100]) == (248, 248, 248)  # ground line


def test_sprite_inventory_complete_and_sized():
    s = build_sprites()
    for name, hw in _EXPECT_SIZES.items():
        assert s[name].shape == hw + (4,), name
    for i in range(5):
        assert s[f"ball_{i}"].shape == (40, 40, 4)
    for i in range(10):
        assert s[f"number_{i}"].shape == (32, 32, 4)
    for n in _POSE_NAMES:
        assert s[f"player_{n}"].shape == (64, 64, 4), n
    idx = {player_sprite_index(st, f)
           for st, nf in ((0, 5), (1, 5), (2, 5), (3, 2), (4, 1), (5, 5), (6, 5))
           for f in range(nf)}
    assert idx == set(range(28))
    for name in ("sky_blue", "mountain", "ground_red", "ground_yellow", "ground_line",
                 "net_pillar"):
        assert (s[name][..., 3] == 255).all(), name


def test_pixel_art_is_deterministic_and_equals_jax():
    from pikazoo_tpu.render.pixel_art import build_sprites as jax_build_sprites

    a = build_sprites()
    build_sprites.cache_clear()
    b = build_sprites()
    want = jax_build_sprites()
    assert set(a) == set(want)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], want[k])


def test_default_render_is_pixel_art():
    state, _ = PikaZoo(EnvConfig()).reset(0, "cpu")
    frame = Renderer("rgb_array").render(state)
    assert frame.shape == (304, 432, 3) and frame.dtype == np.uint8
    assert np.unique(frame.reshape(-1, 3), axis=0).shape[0] > 25
    for p in (state.p1, state.p2):
        px, py = int(p.x), int(p.y)
        patch = frame[py - 10:py + 10, px - 10:px + 10]
        assert np.unique(patch.reshape(-1, 3), axis=0).shape[0] >= 3
    assert not (frame[200, 214:220] == frame[100, 214:220]).all()


def test_pixel_render_tracks_state():
    """Moving the ball moves the drawn ball; scores change the scoreboard."""
    state, _ = PikaZoo(EnvConfig()).reset(0, "cpu")
    f1 = Renderer("rgb_array", seed=7).draw(state)
    moved = state._replace(
        ball=state.ball._replace(x=torch.tensor(100, dtype=torch.int32),
                                 y=torch.tensor(100, dtype=torch.int32)),
        scores=torch.tensor([12, 3], dtype=torch.int32))
    f2 = Renderer("rgb_array", seed=7).draw(moved)
    assert not (f1[90:110, 90:110] == f2[90:110, 90:110]).all()
    assert not (f1[10:42, 14:46] == f2[10:42, 14:46]).all()


def test_flat_style_and_bad_style():
    state, _ = PikaZoo(EnvConfig()).reset(0, "cpu")
    frame = Renderer("rgb_array", style="flat").render(state)
    assert tuple(frame[256, 100]) == (208, 96, 88)
    with pytest.raises(ValueError):
        Renderer("rgb_array", style="bogus")
