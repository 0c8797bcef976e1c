"""Sprite-sheet rendering: the default original pixel-art set, or
user-supplied assets.

The compositor (:class:`SpriteSet`) is a pure-numpy alpha blitter that
follows the reference's exact draw layout and order (``pikazoo_env.py:
250-362``): background tiling, mountain, ground strata, net pillar,
clouds/wave, players with x-flip rules and shadows, rotation-indexed ball
with hyper/trail afterimages and the shrinking punch effect, and the score
boards (including the reference's hardcoded ``number[1]`` tens digit,
``pikazoo_env.py:338-343``).

Two sprite sources feed it:

* :meth:`SpriteSet.from_pixel_art` — the repo's ORIGINAL generated pixel-art
  set (:mod:`pikazoo_tpu_torch.render.pixel_art`), the default.  No asset files,
  no pygame needed for ``rgb_array`` rendering.
* :meth:`SpriteSet.from_dir` — PNG assets from disk (``sprite_dir=`` or
  ``PIKAZOO_SPRITE_DIR``), e.g. the reference's own ``pikazoo/env/img/``
  for pixel-faithful frames.  The reference's art is third-party and is NOT
  copied into this repo.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pikazoo_tpu_torch.core import constants as C
from pikazoo_tpu_torch.render.cloud_wave import NUM_WAVE_COLUMNS, CloudWave


def player_sprite_index(state: int, frame_number: int) -> int:
    """Sprite sheet index for a player animation frame
    (``get_frame_number_for_player_animated_sprite``, ``pikazoo_env.py:46-69``):
    states 0-2 have 5 frames, state 3 has 2, state 4 has 1, states 5-6 have 5.
    """
    if state < 4:
        return 5 * state + frame_number
    if state == 4:
        return 17 + frame_number
    return 18 + 5 * (state - 5) + frame_number


# Player pose names in sheet-index order (28 entries).
_POSE_NAMES = [f"{s}_{f}" for s in range(3) for f in range(5)] + \
    ["3_0", "3_1", "4_0"] + \
    [f"{s}_{f}" for s in (5, 6) for f in range(5)]


def find_sprite_dir(sprite_dir: Optional[str] = None) -> Optional[str]:
    """Resolve a usable sprite directory or None.  Accepts either the img/
    directory itself or a pika-zoo checkout root."""
    candidates = []
    if sprite_dir:
        candidates += [sprite_dir, os.path.join(sprite_dir, "pikazoo", "env",
                                                "img")]
    env_dir = os.environ.get("PIKAZOO_SPRITE_DIR")
    if env_dir:
        candidates += [env_dir, os.path.join(env_dir, "pikazoo", "env", "img")]
    for cand in candidates:
        if os.path.isfile(os.path.join(cand, "ball_0.png")):
            return cand
    return None


def _scale_nn(sprite: np.ndarray, w: int, h: int) -> np.ndarray:
    """Nearest-neighbour resize to (h, w)."""
    sh, sw = sprite.shape[:2]
    if (sw, sh) == (w, h) or w <= 0 or h <= 0:
        return sprite if (sw, sh) == (w, h) else sprite[:0, :0]
    ys = (np.arange(h) * sh // h).clip(0, sh - 1)
    xs = (np.arange(w) * sw // w).clip(0, sw - 1)
    return sprite[ys[:, None], xs[None, :]]


class SpriteSet:
    """Draws reference-layout frames from a named dict of RGBA sprites."""

    def __init__(self, sprites: dict):
        self._s = sprites
        self.ball = tuple(sprites[f"ball_{i}"] for i in range(5)) + \
            (sprites["ball_hyper"],)
        self.number = tuple(sprites[f"number_{i}"] for i in range(10))
        self.player = tuple(sprites[f"player_{n}"] for n in _POSE_NAMES)
        self._canvas = np.empty((C.GROUND_HEIGHT, C.GROUND_WIDTH, 3),
                                np.uint8)

    @classmethod
    def from_pixel_art(cls) -> "SpriteSet":
        from pikazoo_tpu_torch.render.pixel_art import build_sprites
        return cls(build_sprites())

    @classmethod
    def from_dir(cls, img_dir: str) -> "SpriteSet":
        """Load PNG assets through pygame into RGBA numpy arrays."""
        import pygame  # noqa: PLC0415

        if not pygame.get_init():
            pygame.init()

        def load(name):
            image = pygame.image.load(os.path.join(img_dir, name + ".png"))
            sfc = pygame.Surface(image.get_size(), flags=pygame.SRCALPHA)
            sfc.blit(image, (0, 0))
            rgb = np.transpose(pygame.surfarray.array3d(sfc), (1, 0, 2))
            alpha = np.transpose(pygame.surfarray.array_alpha(sfc), (1, 0))
            return np.dstack([rgb, alpha]).astype(np.uint8)

        names = ["sky_blue", "mountain", "ground_red", "ground_line",
                 "ground_line_leftmost", "ground_line_rightmost",
                 "ground_yellow", "net_pillar", "net_pillar_top", "cloud",
                 "wave", "shadow", "ball_hyper", "ball_trail", "ball_punch"]
        sprites = {n: load(n) for n in names}
        for i in range(5):
            sprites[f"ball_{i}"] = load(f"ball_{i}")
        for i in range(10):
            sprites[f"number_{i}"] = load(f"number_{i}")
        for n in _POSE_NAMES:
            sprites[f"player_{n}"] = load(f"pikachu_{n}")
        return cls(sprites)

    # -- compositor ---------------------------------------------------------

    def _blit(self, sprite: np.ndarray, x: int, y: int) -> None:
        """Alpha-blit ``sprite`` with its top-left at (x, y)."""
        canvas = self._canvas
        h, w = sprite.shape[:2]
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(canvas.shape[1], x + w), min(canvas.shape[0], y + h)
        if x0 >= x1 or y0 >= y1:
            return
        src = sprite[y0 - y:y1 - y, x0 - x:x1 - x]
        a = src[..., 3:4].astype(np.uint16)
        if (a >= 255).all():
            canvas[y0:y1, x0:x1] = src[..., :3]
            return
        dst = canvas[y0:y1, x0:x1]
        canvas[y0:y1, x0:x1] = (
            (src[..., :3].astype(np.uint16) * a + dst * (255 - a)) // 255
        ).astype(np.uint8)

    def _blit_center(self, sprite: np.ndarray, x: int, y: int) -> None:
        self._blit(sprite, x - sprite.shape[1] // 2, y - sprite.shape[0] // 2)

    def draw(self, state, cloud_wave: CloudWave, punch_radius: int,
             scalar) -> np.ndarray:
        """One frame in reference draw order (``draw``, pikazoo_env.py:250-255
        and the draw_* bodies).  ``scalar`` converts state leaves to ints;
        ``punch_radius`` is the renderer-side countdown value."""
        sp, s = self._s, scalar

        # Background (draw_background, pikazoo_env.py:305-333).
        for j in range(12):
            for i in range(NUM_WAVE_COLUMNS):
                self._blit(sp["sky_blue"], 16 * i, 16 * j)
        self._blit(sp["mountain"], 0, 188)
        for i in range(NUM_WAVE_COLUMNS):
            self._blit(sp["ground_red"], 16 * i, 248)
        for i in range(1, NUM_WAVE_COLUMNS - 1):
            self._blit(sp["ground_line"], 16 * i, 264)
        self._blit(sp["ground_line_leftmost"], 0, 264)
        self._blit(sp["ground_line_rightmost"], C.GROUND_WIDTH - 16, 264)
        for j in range(2):
            for i in range(NUM_WAVE_COLUMNS):
                self._blit(sp["ground_yellow"], 16 * i, 280 + 16 * j)
        self._blit(sp["net_pillar_top"], 213, 176)
        for j in range(12):
            self._blit(sp["net_pillar"], 213, 184 + 8 * j)

        # Clouds and wave (draw_clouds_and_wave, pikazoo_env.py:345-362;
        # the dynamics step happens in the Renderer, which owns the draws).
        for (x, y, w, h) in cloud_wave.cloud_rects():
            self._blit(_scale_nn(sp["cloud"], w, h), x, y)
        for i in range(NUM_WAVE_COLUMNS):
            self._blit(sp["wave"], i * 16, cloud_wave.wave_y[i])

        # Players (draw_player, pikazoo_env.py:257-278): p1 flips only when
        # diving left; p2 flips in every pose EXCEPT diving right.
        for p, is_p1 in ((state.p1, True), (state.p2, False)):
            st, fn = s(p.state), s(p.frame_number)
            sprite = self.player[player_sprite_index(st, fn)]
            diving = st in (3, 4)
            dd = s(p.diving_direction)
            xflip = (diving and dd == -1) if is_p1 \
                else not (diving and dd == 1)
            if xflip:
                sprite = sprite[:, ::-1]
            self._blit_center(sprite, s(p.x), s(p.y))
        self._blit_center(sp["shadow"], s(state.p1.x), 273)
        self._blit_center(sp["shadow"], s(state.p2.x), 273)

        # Ball (draw_ball, pikazoo_env.py:280-302).
        ball = state.ball
        self._blit_center(self.ball[s(ball.rotation)], s(ball.x), s(ball.y))
        self._blit_center(sp["shadow"], s(ball.x), 273)
        if s(ball.is_power_hit):
            self._blit_center(sp["ball_hyper"], s(ball.previous_x),
                              s(ball.previous_y))
            self._blit_center(sp["ball_trail"], s(ball.previous_previous_x),
                              s(ball.previous_previous_y))
        if punch_radius > 0:
            scaled = _scale_nn(sp["ball_punch"], 2 * punch_radius,
                               2 * punch_radius)
            self._blit_center(scaled, s(ball.punch_effect_x),
                              s(ball.punch_effect_y))

        # Score boards (draw_scores_to_score_boards, pikazoo_env.py:335-343)
        # including the reference's hardcoded number[1] tens digit.
        s1, s2 = s(state.scores[0]), s(state.scores[1])
        if s1 >= 10:
            self._blit(self.number[1], 14, 10)
        self._blit(self.number[s1 % 10], 14 + 32, 10)
        if s2 >= 10:
            self._blit(self.number[1], C.GROUND_WIDTH - 32 - 32 - 14, 10)
        self._blit(self.number[s2 % 10], C.GROUND_WIDTH - 32 - 32 - 14 + 32,
                   10)

        return self._canvas.copy()
