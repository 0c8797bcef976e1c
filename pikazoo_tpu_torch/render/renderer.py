"""Host-side renderer.

Consumes an :class:`~pikazoo_tpu_torch.envs.pika_volley.EnvState` (tensors on
the card or on the CPU, or numpy leaves; a state on the card comes to the
host in one copy a frame) and draws the
432x304 scene with numpy — court, net pillar, both players (with state/facing
cues), ball with rotation frames and hyper/trail afterimages, shrinking punch
effect, and score boards (reference draw path: ``pikazoo_env.py:250-362``).

The default output is the repo's ORIGINAL pixel-art sprite set
(:mod:`pikazoo_tpu_torch.render.pixel_art`, generated in code — the reference's
third-party PNG assets are not copied into this repo), drawn in the
reference's exact layout/order by :mod:`pikazoo_tpu_torch.render.sprites`.  Users
with the original assets can pass ``sprite_dir=`` (or set
``PIKAZOO_SPRITE_DIR``) for pixel-faithful frames; ``style="flat"`` (or
``PIKAZOO_RENDER_STYLE=flat``) selects the minimal flat-geometry style.
``human`` mode blits through pygame; ``rgb_array`` returns an (H, W, 3)
uint8 frame like the reference.

RNG coupling: in the reference, the decorative clouds/wave consume draws from
the *physics* generator, so rendering perturbs gameplay streams
(``cloud_and_wave.py``; SURVEY section 2.3).  By default this renderer is a
pure read of env state (cloud/wave motion from a private host RNG).  Passing
``draw_source`` (a ``draw(upper) -> int`` callable over the env's draw-slot
stream — see ``compat.parallel_env`` ``render_rng_coupled``) reproduces the
reference's coupled behavior exactly, including the 40 cloud-construction
draws and the per-frame engine draw order.
"""

from __future__ import annotations

import os

import numpy as np

from pikazoo_tpu_torch.core import constants as C
from pikazoo_tpu_torch.core.state import host_state
from pikazoo_tpu_torch.render.cloud_wave import CloudWave
from pikazoo_tpu_torch.render.sprites import SpriteSet, find_sprite_dir

_SKY = (140, 200, 240)
_GROUND_RED = (208, 96, 88)
_GROUND_LINE = (248, 248, 248)
_GROUND_YELLOW = (224, 184, 96)
_NET = (240, 240, 240)
_P1_BODY = (252, 208, 56)
_P2_BODY = (248, 176, 40)
_BALL = (232, 64, 56)
_BALL_HYPER = (255, 255, 255)
_TRAIL = (250, 140, 130)
_PUNCH = (255, 255, 255)
_SCORE = (16, 16, 16)
_CLOUD = (250, 250, 250)
_WAVE = (64, 120, 208)

# 3x5 digit font for the score boards.
_DIGITS = {
    0: ("111", "101", "101", "101", "111"),
    1: ("010", "110", "010", "010", "111"),
    2: ("111", "001", "111", "100", "111"),
    3: ("111", "001", "111", "001", "111"),
    4: ("101", "101", "111", "001", "001"),
    5: ("111", "100", "111", "001", "111"),
    6: ("111", "100", "111", "101", "111"),
    7: ("111", "001", "010", "010", "010"),
    8: ("111", "101", "111", "101", "111"),
    9: ("111", "101", "111", "001", "111"),
}


def _fill(img, x0, y0, x1, y1, color):
    x0, x1 = max(0, x0), min(img.shape[1], x1)
    y0, y1 = max(0, y0), min(img.shape[0], y1)
    if x0 < x1 and y0 < y1:
        img[y0:y1, x0:x1] = color


def _disc(img, cx, cy, r, color):
    x0, x1 = max(0, cx - r), min(img.shape[1], cx + r + 1)
    y0, y1 = max(0, cy - r), min(img.shape[0], cy + r + 1)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    img[y0:y1, x0:x1][mask] = color


def _ring(img, cx, cy, r, color):
    if r <= 0:
        return
    yy, xx = np.mgrid[max(0, cy - r):min(img.shape[0], cy + r + 1),
                      max(0, cx - r):min(img.shape[1], cx + r + 1)]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    mask = (d2 <= r * r) & (d2 >= (r - 2) ** 2)
    img[max(0, cy - r):min(img.shape[0], cy + r + 1),
        max(0, cx - r):min(img.shape[1], cx + r + 1)][mask] = color


def _digit(img, x, y, d, scale=4):
    rows = _DIGITS[d % 10]
    for j, row in enumerate(rows):
        for i, ch in enumerate(row):
            if ch == "1":
                _fill(img, x + i * scale, y + j * scale,
                      x + (i + 1) * scale, y + (j + 1) * scale, _SCORE)


class Renderer:
    """Stateful host renderer; one instance per (compat) env."""

    def __init__(self, render_mode: str | None = None, seed: int = 0,
                 sprite_dir: str | None = None, draw_source=None,
                 style: str | None = None):
        self.render_mode = render_mode
        self._screen = None
        self._clock = None
        self._rng = np.random.default_rng(seed)
        self._punch_radius = 0
        self._draw_source = draw_source or \
            (lambda upper: int(self._rng.integers(0, upper)))
        # Cloud construction draws (reference get_all_image,
        # pikazoo_env.py:475-479): 40 draws from the coupled stream when a
        # draw_source is given, private RNG otherwise.
        self._cloud_wave = CloudWave(self._draw_source)
        # Sprite source: user assets > generated pixel art (default) > the
        # flat geometric style ("flat", or PIKAZOO_RENDER_STYLE=flat).
        style = style or os.environ.get("PIKAZOO_RENDER_STYLE", "pixel")
        if style not in ("pixel", "flat"):
            raise ValueError(f"unknown render style {style!r} "
                             "(expected 'pixel' or 'flat')")
        resolved = find_sprite_dir(sprite_dir)
        if resolved:
            self._sprites = SpriteSet.from_dir(resolved)
        elif style == "pixel":
            self._sprites = SpriteSet.from_pixel_art()
        else:
            self._sprites = None

    @staticmethod
    def _scalar(v) -> int:
        return int(v)

    def draw(self, state) -> np.ndarray:
        state = host_state(state)
        s = self._scalar

        # Cloud/wave dynamics run once per drawn frame, consuming draws from
        # the coupled stream or the private RNG (reference draw order:
        # cloud_and_wave_engine runs first inside draw_clouds_and_wave,
        # pikazoo_env.py:345-349).
        self._cloud_wave.step(self._draw_source)

        if self._sprites is not None:
            pr = s(state.ball.punch_effect_radius)
            if pr > self._punch_radius:
                self._punch_radius = pr
            frame = self._sprites.draw(state, self._cloud_wave,
                                       self._punch_radius, s)
            self._punch_radius = max(0, self._punch_radius - 2)
            return frame

        img = np.empty((C.GROUND_HEIGHT, C.GROUND_WIDTH, 3), np.uint8)
        img[:] = _SKY

        for (cx, cy, cw, ch) in self._cloud_wave.cloud_rects():
            _fill(img, cx, cy, cx + cw, cy + ch, _CLOUD)

        # Court strata (reference rows: red 248, line 264, yellow 280+).
        _fill(img, 0, 248, C.GROUND_WIDTH, 264, _GROUND_RED)
        _fill(img, 0, 264, C.GROUND_WIDTH, 280, _GROUND_LINE)
        _fill(img, 0, 280, C.GROUND_WIDTH, C.GROUND_HEIGHT, _GROUND_YELLOW)

        # Shoreline wave columns (reference draws 16-wide wave sprites at
        # cloud_wave.wave_y; only the top slice reaches into the 304-high
        # frame).  Drawn over the ground strata like the reference.
        for i, wy in enumerate(self._cloud_wave.wave_y):
            _fill(img, i * 16, wy, (i + 1) * 16, wy + 16, _WAVE)

        # Net pillar (sprite at x=213, top at y=176).
        _fill(img, 213, C.NET_PILLAR_TOP_TOP_Y_COORD, 219, 264, _NET)

        # Players: 64x64 body with an eye marking the facing side.
        for p, body, facing_right in (
                (state.p1, _P1_BODY, True), (state.p2, _P2_BODY, False)):
            px, py, st = s(p.x), s(p.y), s(p.state)
            half = C.PLAYER_HALF_LENGTH
            squash = 16 if st == 4 else 0  # lying down flattens the sprite
            _fill(img, px - half, py - half + squash, px + half, py + half, body)
            dd = s(p.diving_direction)
            if st in (3, 4) and dd != 0:
                facing_right = dd > 0
            eye_x = px + (12 if facing_right else -18)
            _fill(img, eye_x, py - 16 + squash, eye_x + 6, py - 10 + squash,
                  (0, 0, 0))

        # Power-hit trail from the position history.
        if s(state.ball.is_power_hit):
            _disc(img, s(state.ball.previous_previous_x),
                  s(state.ball.previous_previous_y), C.BALL_RADIUS - 6, _TRAIL)
            _disc(img, s(state.ball.previous_x), s(state.ball.previous_y),
                  C.BALL_RADIUS - 2, _TRAIL)

        # Ball with a rotation tick; rotation 5 = hyper-ball tint.
        bx, by = s(state.ball.x), s(state.ball.y)
        rot = s(state.ball.rotation)
        _disc(img, bx, by, C.BALL_RADIUS,
              _BALL_HYPER if rot == 5 else _BALL)
        ang = rot * np.pi / 2.5
        _disc(img, bx + int(10 * np.cos(ang)), by + int(10 * np.sin(ang)),
              4, (255, 255, 255))

        # Shrinking punch effect (render-side countdown like the reference's
        # draw_ball, which mutates punch_effect_radius on the render path).
        pr = s(state.ball.punch_effect_radius)
        if pr > self._punch_radius:
            self._punch_radius = pr
        if self._punch_radius > 0:
            _ring(img, s(state.ball.punch_effect_x),
                  s(state.ball.punch_effect_y), self._punch_radius, _PUNCH)
            self._punch_radius = max(0, self._punch_radius - 2)

        # Score boards (reference layout: left at x=14, right mirrored).
        s1, s2 = s(state.scores[0]), s(state.scores[1])
        if s1 >= 10:
            _digit(img, 14, 10, s1 // 10, scale=6)
        _digit(img, 14 + 32, 10, s1 % 10, scale=6)
        if s2 >= 10:
            _digit(img, C.GROUND_WIDTH - 78, 10, s2 // 10, scale=6)
        _digit(img, C.GROUND_WIDTH - 46, 10, s2 % 10, scale=6)
        return img

    def render(self, state):
        if self.render_mode is None:
            return None
        frame = self.draw(state)
        if self.render_mode == "rgb_array":
            return frame
        if self.render_mode == "human":
            import pygame  # noqa: PLC0415
            if self._screen is None:
                pygame.init()
                self._screen = pygame.display.set_mode(
                    (C.GROUND_WIDTH, C.GROUND_HEIGHT))
                pygame.display.set_caption("pikazoo-tpu")
                self._clock = pygame.time.Clock()
            surf = pygame.surfarray.make_surface(frame.transpose(1, 0, 2))
            self._screen.blit(surf, (0, 0))
            pygame.display.flip()
            self._clock.tick(20)
        return None

    def close(self):
        if self._screen is not None:
            import pygame  # noqa: PLC0415
            pygame.quit()
            self._screen = None
