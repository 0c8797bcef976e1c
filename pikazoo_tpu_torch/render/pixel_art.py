"""Original pixel-art sprite set, generated procedurally at import time.

The reference ships 73 PNG assets (``pikazoo/env/img/``) that are third-party
game art and are deliberately NOT copied into this repo.  This module closes
the default-output gap with an ORIGINAL, license-clean sprite set drawn in
code: a round axolotl-like volleyball critter (distinct silhouette and
palette from the reference's character), a two-tone beach ball with five
rotation frames, scoreboard digits, and the full background tile set — every
sprite at the reference asset's pixel dimensions so the reference draw
layout (``pikazoo_env.py:250-362``, implemented in ``render/sprites.py``)
applies unchanged.

All sprites are (H, W, 4) uint8 RGBA numpy arrays; :func:`build_sprites`
returns the full named dict (cached).  Generation is deterministic (fixed
seed for texture speckle) so rendered frames are reproducible.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# Palette (original)
# ---------------------------------------------------------------------------
_OUTLINE = (34, 32, 52, 255)
_BODY = (96, 205, 188, 255)        # mint teal
_BODY_DARK = (58, 156, 142, 255)
_BELLY = (222, 246, 234, 255)
_GILL = (255, 136, 120, 255)       # coral head fins
_EYE_WHITE = (250, 250, 250, 255)
_PUPIL = (34, 32, 52, 255)
_BLUSH = (255, 170, 150, 255)
_BALL_A = (240, 82, 76, 255)       # red panels
_BALL_B = (252, 246, 236, 255)     # cream panels
_BALL_RIM = (120, 28, 24, 255)
_SKY = (132, 196, 240, 255)
_SKY_DITHER = (142, 204, 245, 255)
_MOUNT_FAR = (108, 140, 188, 255)
_MOUNT_NEAR = (84, 170, 150, 255)
_MOUNT_SNOW = (238, 246, 252, 255)
_SEA = (70, 130, 200, 255)
_SEA_LIGHT = (150, 200, 240, 255)
_GROUND_RED = (204, 100, 88, 255)
_GROUND_RED_DK = (182, 84, 74, 255)
_LINE = (246, 246, 246, 255)
_LINE_DK = (210, 214, 220, 255)
_SAND = (228, 192, 112, 255)
_SAND_DK = (208, 170, 92, 255)
_NET = (235, 235, 235, 255)
_NET_DK = (180, 184, 190, 255)
_CLOUD = (252, 252, 252, 255)
_CLOUD_SHADE = (214, 230, 246, 255)
_WAVE_BODY = (72, 134, 216, 255)
_WAVE_FOAM = (240, 250, 255, 255)
_DIGIT = (252, 252, 252, 255)
_DIGIT_EDGE = (34, 32, 52, 255)


def _canvas(w: int, h: int) -> np.ndarray:
    return np.zeros((h, w, 4), np.uint8)


def _ellipse(img, cx, cy, rx, ry, color):
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((xx - cx) / max(rx, 1e-6)) ** 2 + \
           ((yy - cy) / max(ry, 1e-6)) ** 2 <= 1.0
    img[mask] = color


def _rect(img, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    x0, x1 = max(0, int(x0)), min(w, int(x1))
    y0, y1 = max(0, int(y0)), min(h, int(y1))
    if x0 < x1 and y0 < y1:
        img[y0:y1, x0:x1] = color


def _outline(img, color=_OUTLINE):
    """1px outline around the opaque region (4-neighbour dilation)."""
    a = img[..., 3] > 0
    grow = a.copy()
    grow[1:, :] |= a[:-1, :]
    grow[:-1, :] |= a[1:, :]
    grow[:, 1:] |= a[:, :-1]
    grow[:, :-1] |= a[:, 1:]
    img[grow & ~a] = color


def _limb(img, x0, y0, x1, y1, r, color):
    """Thick line (capsule) from (x0,y0) to (x1,y1)."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    dx, dy = x1 - x0, y1 - y0
    L2 = max(dx * dx + dy * dy, 1e-6)
    t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / L2, 0.0, 1.0)
    d2 = (xx - (x0 + t * dx)) ** 2 + (yy - (y0 + t * dy)) ** 2
    img[d2 <= r * r] = color


# ---------------------------------------------------------------------------
# The critter (original character) — base art faces RIGHT like the reference
# sheet (player 2's draw path mirrors it; ``sprites.py`` flip rules).
# ---------------------------------------------------------------------------

def _critter(arm_l=200.0, arm_r=-20.0, bob=0, feet=0, eyes="open",
             mouth="smile", gills=0.0, squash=0.0, lean=0.0,
             dive=False, lying=False) -> np.ndarray:
    """One 64x64 pose.  Angles in degrees (0 = +x, CCW in screen coords);
    ``gills`` droops the head fins; ``squash`` flattens the body;
    ``lean`` shears the body horizontally (px per 10px of height)."""
    img = _canvas(64, 64)
    if lying:
        # Flat on the ground, facing up.
        _ellipse(img, 32, 50, 26, 11, _BODY)
        _ellipse(img, 32, 53, 20, 6, _BELLY)
        for gx in (16, 24):
            _limb(img, gx, 44, gx - 5, 40 + int(2 * gills), 2, _GILL)
        # dizzy X eyes
        for ex in (36, 48):
            _limb(img, ex - 2, 44, ex + 2, 48, 1, _PUPIL)
            _limb(img, ex - 2, 48, ex + 2, 44, 1, _PUPIL)
        _outline(img)
        return img

    if dive:
        # Horizontal stretch, arms forward (toward +x).
        _ellipse(img, 30, 40, 24, 13, _BODY)
        _ellipse(img, 44, 38, 12, 10, _BODY)       # head forward
        _ellipse(img, 28, 45, 17, 7, _BELLY)
        _limb(img, 52, 36, 62, 32, 3, _BODY_DARK)  # reaching arm
        _limb(img, 50, 44, 60, 46, 3, _BODY_DARK)
        _limb(img, 12, 44, 4, 40, 3, _BODY_DARK)   # trailing feet
        _limb(img, 14, 48, 6, 52, 3, _BODY_DARK)
        for i, g in enumerate((0, 1)):
            _limb(img, 40 - 2 * i, 30, 36 - 3 * i, 24 + int(3 * gills), 2,
                  _GILL)
        _ellipse(img, 50, 34, 3, 3, _EYE_WHITE)
        _ellipse(img, 51, 34, 1, 1, _PUPIL)
        _outline(img)
        return img

    cy = 38 + bob + int(squash * 6)
    ry = 17 - int(squash * 5)
    rx = 15 + int(squash * 3)
    body_cx = 32 + int(lean)

    # feet (step cycle shifts them in opposite phase)
    fy = 56 + bob // 2
    _limb(img, body_cx - 7 + feet, fy, body_cx - 9 + feet, fy + 3, 3,
          _BODY_DARK)
    _limb(img, body_cx + 7 - feet, fy, body_cx + 9 - feet, fy + 3, 3,
          _BODY_DARK)

    # tail fin (left side, since the critter faces right)
    _limb(img, body_cx - rx + 2, cy + 4, body_cx - rx - 6, cy + 8, 3,
          _BODY_DARK)

    # arms
    for ang, side in ((arm_l, -1), (arm_r, +1)):
        rad = np.deg2rad(ang)
        ax0 = body_cx + side * (rx - 4)
        ay0 = cy + 2
        ax1 = ax0 + 11 * np.cos(rad)
        ay1 = ay0 - 11 * np.sin(rad)
        _limb(img, ax0, ay0, ax1, ay1, 3, _BODY_DARK)

    # body + belly
    _ellipse(img, body_cx, cy, rx, ry, _BODY)
    _ellipse(img, body_cx + 2, cy + 5, int(rx * 0.62), int(ry * 0.55), _BELLY)

    # head fins (axolotl gills) — three coral spikes each side of the crown
    for i, dx in enumerate((-10, -4, 2)):
        top = cy - ry
        _limb(img, body_cx + dx, top + 3, body_cx + dx - 4,
              top - 4 + int(3 * gills) + i, 2, _GILL)
    for i, dx in enumerate((6, 10)):
        top = cy - ry
        _limb(img, body_cx + dx, top + 4, body_cx + dx + 4,
              top - 2 + int(3 * gills) + i, 2, _GILL)

    # face (offset right = facing direction)
    ex, ey = body_cx + 7, cy - 6
    if eyes == "open":
        _ellipse(img, ex, ey, 5, 6, _EYE_WHITE)
        _ellipse(img, ex + 2, ey, 2, 2, _PUPIL)
        img[ey - 1, ex + 1] = _EYE_WHITE  # catchlight
    elif eyes == "happy":
        _limb(img, ex - 3, ey, ex, ey - 3, 1, _PUPIL)
        _limb(img, ex, ey - 3, ex + 3, ey, 1, _PUPIL)
    elif eyes == "sad":
        _ellipse(img, ex, ey + 2, 3, 4, _EYE_WHITE)
        _ellipse(img, ex, ey + 3, 2, 2, _PUPIL)
        _limb(img, ex - 3, ey - 3, ex + 3, ey - 2, 1, _PUPIL)
    _ellipse(img, body_cx + 12, cy - 1, 3, 2, _BLUSH)
    if mouth == "smile":
        _limb(img, body_cx + 9, cy + 3, body_cx + 12, cy + 2, 1, _PUPIL)
    elif mouth == "open":
        _ellipse(img, body_cx + 10, cy + 3, 2, 3, _PUPIL)
    elif mouth == "frown":
        _limb(img, body_cx + 9, cy + 3, body_cx + 12, cy + 4, 1, _PUPIL)

    _outline(img)
    return img


def _player_poses() -> dict:
    """All 28 animation frames keyed like the reference sheet
    (``player_{state}_{frame}``; states/frames per
    ``get_frame_number_for_player_animated_sprite``)."""
    poses = {}
    # state 0: idle/walk — 5-frame step cycle with a gentle bob.
    for f in range(5):
        poses[f"player_0_{f}"] = _critter(
            arm_l=200 + 12 * np.sin(2 * np.pi * f / 5),
            arm_r=-20 - 12 * np.sin(2 * np.pi * f / 5),
            bob=(0, 1, 0, -1, 0)[f], feet=(0, 2, 0, -2, 0)[f])
    # state 1: jump — arms rise, feet tuck.
    for f in range(5):
        poses[f"player_1_{f}"] = _critter(
            arm_l=200 - 28 * f, arm_r=-20 + 28 * f, bob=-2, feet=3,
            eyes="open", mouth="open" if f >= 3 else "smile")
    # state 2: power hit — windup then overhead smash with the right arm.
    for f, ang in enumerate((-60, -10, 50, 110, 150)):
        poses[f"player_2_{f}"] = _critter(
            arm_l=210, arm_r=ang, bob=-1, lean=2,
            mouth="open" if f in (2, 3) else "smile", gills=-0.5)
    # state 3: diving (2 frames: reach, full stretch).
    poses["player_3_0"] = _critter(dive=True)
    d1 = _critter(dive=True)
    poses["player_3_1"] = np.roll(d1, 2, axis=1)  # slight forward shift
    # state 4: lying down.
    poses["player_4_0"] = _critter(lying=True)
    # state 5: win — arms up, happy eyes, bounce.
    for f in range(5):
        poses[f"player_5_{f}"] = _critter(
            arm_l=120, arm_r=60, bob=(0, -2, -3, -2, 0)[f],
            eyes="happy", mouth="open")
    # state 6: lose — slumped, droopy gills.
    for f in range(5):
        poses[f"player_6_{f}"] = _critter(
            arm_l=230, arm_r=-50, bob=(1, 2, 2, 2, 1)[f], squash=0.4,
            eyes="sad", mouth="frown", gills=1.0)
    return poses


# ---------------------------------------------------------------------------
# Ball, digits, background tiles
# ---------------------------------------------------------------------------

def _ball(rotation: int) -> np.ndarray:
    """40x40 two-tone beach ball; panels rotate 36 degrees per frame."""
    img = _canvas(40, 40)
    yy, xx = np.mgrid[0:40, 0:40]
    d2 = (xx - 19.5) ** 2 + (yy - 19.5) ** 2
    inside = d2 <= 18.0 ** 2
    theta = np.arctan2(yy - 19.5, xx - 19.5) + rotation * (np.pi / 5.0)
    sector = ((theta + np.pi) // (np.pi / 2)).astype(int) % 2
    img[inside & (sector == 0)] = _BALL_A
    img[inside & (sector == 1)] = _BALL_B
    rim = inside & (d2 >= 16.0 ** 2)
    img[rim] = _BALL_RIM
    hl = (xx - 13) ** 2 + (yy - 13) ** 2 <= 3 ** 2
    img[hl & inside] = (255, 255, 255, 255)
    _outline(img)
    return img


def _ball_hyper() -> np.ndarray:
    img = _canvas(40, 40)
    yy, xx = np.mgrid[0:40, 0:40]
    d2 = (xx - 19.5) ** 2 + (yy - 19.5) ** 2
    img[d2 <= 18 ** 2] = (255, 244, 214, 255)
    img[(d2 <= 18 ** 2) & (d2 >= 15 ** 2)] = (255, 150, 90, 255)
    # radial energy spokes
    theta = np.arctan2(yy - 19.5, xx - 19.5)
    spokes = (np.abs(np.sin(theta * 4)) > 0.93) & (d2 <= 18 ** 2) & \
        (d2 >= 8 ** 2)
    img[spokes] = (255, 214, 120, 255)
    _outline(img, (120, 60, 20, 255))
    return img


def _ball_trail() -> np.ndarray:
    img = _canvas(40, 40)
    yy, xx = np.mgrid[0:40, 0:40]
    d2 = (xx - 19.5) ** 2 + (yy - 19.5) ** 2
    img[d2 <= 15 ** 2] = (250, 160, 150, 140)
    img[d2 <= 9 ** 2] = (252, 196, 188, 170)
    return img


def _ball_punch() -> np.ndarray:
    img = _canvas(40, 40)
    yy, xx = np.mgrid[0:40, 0:40]
    d2 = (xx - 19.5) ** 2 + (yy - 19.5) ** 2
    ring = (d2 <= 18 ** 2) & (d2 >= 13 ** 2)
    img[ring] = (255, 255, 255, 220)
    theta = np.arctan2(yy - 19.5, xx - 19.5)
    burst = (np.abs(np.sin(theta * 6)) > 0.9) & (d2 <= 19 ** 2) & \
        (d2 >= 10 ** 2)
    img[burst] = (255, 240, 170, 235)
    return img


_FONT_3x5 = {
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


def _digit(d: int) -> np.ndarray:
    """32x32 scoreboard digit: 3x5 font at 6x scale, outlined."""
    img = _canvas(32, 32)
    rows = _FONT_3x5[d % 10]
    for j, row in enumerate(rows):
        for i, ch in enumerate(row):
            if ch == "1":
                _rect(img, 7 + 6 * i, 1 + 6 * j, 13 + 6 * i, 7 + 6 * j,
                      _DIGIT)
    _outline(img, _DIGIT_EDGE)
    return img


def _speckle(img, rng, color, n):
    h, w = img.shape[:2]
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    img[ys, xs] = color


def _tiles(rng) -> dict:
    t = {}
    sky = _canvas(16, 16)
    sky[:] = _SKY
    sky[::4, 1::4] = _SKY_DITHER      # tileable dither (period divides 16)
    sky[2::4, 3::4] = _SKY_DITHER
    t["sky_blue"] = sky

    red = _canvas(16, 16)
    red[:] = _GROUND_RED
    _speckle(red, rng, _GROUND_RED_DK, 24)
    red[0, :] = _GROUND_RED_DK
    t["ground_red"] = red

    line = _canvas(16, 16)
    line[:] = _LINE
    line[3::8, :] = _LINE_DK
    t["ground_line"] = line
    left = line.copy()
    left[:, :3] = _LINE_DK
    t["ground_line_leftmost"] = left
    right = line.copy()
    right[:, -3:] = _LINE_DK
    t["ground_line_rightmost"] = right

    sand = _canvas(16, 16)
    sand[:] = _SAND
    _speckle(sand, rng, _SAND_DK, 28)
    t["ground_yellow"] = sand

    pillar = _canvas(8, 8)
    pillar[:] = _NET
    pillar[:, 0] = _NET_DK
    pillar[:, 7] = _NET_DK
    pillar[3, :] = _NET_DK            # mesh hint
    t["net_pillar"] = pillar
    top = _canvas(8, 8)
    top[:] = _NET_DK
    top[:3, :] = _OUTLINE[:4]
    t["net_pillar_top"] = top
    return t


def _mountain() -> np.ndarray:
    """432x64 horizon strip — FULLY OPAQUE like the reference asset (drawn
    at y=188 it covers the gap between the sky tiles and the ground strata,
    so a transparent region would leak the uninitialized canvas)."""
    img = _canvas(432, 64)
    img[:] = _SEA               # open sea behind the ridges
    img[0:2, :] = _SEA_LIGHT    # bright horizon line
    img[5::7, ::3] = _SEA_LIGHT  # glints
    xs = np.arange(432)
    far = (34 - 22 * np.abs(np.sin(xs / 70.0))).astype(int)
    near = (58 - 34 * np.abs(np.sin(xs / 38.0 + 1.2))).astype(int)
    yy = np.mgrid[0:64, 0:432][0]
    img[yy >= far[None, :]] = _MOUNT_FAR
    img[yy >= near[None, :]] = _MOUNT_NEAR
    # snow caps on the near ridgeline
    snow = (yy >= near[None, :]) & (yy <= near[None, :] + 3) & \
        (near[None, :] < 34)
    img[snow] = _MOUNT_SNOW
    return img


def _cloud() -> np.ndarray:
    img = _canvas(48, 24)
    for cx, cy, rx, ry in ((14, 15, 11, 7), (26, 11, 12, 9), (37, 15, 9, 6)):
        _ellipse(img, cx, cy, rx, ry, _CLOUD)
    shade = img[..., 3] > 0
    yy = np.mgrid[0:24, 0:48][0]
    img[shade & (yy > 16)] = _CLOUD_SHADE
    return img


def _wave() -> np.ndarray:
    img = _canvas(16, 32)
    img[6:, :] = _WAVE_BODY
    xs = np.arange(16)
    crest = (4 + 2 * np.sin(xs * np.pi / 8)).astype(int)
    yy = np.mgrid[0:32, 0:16][0]
    img[(yy >= crest[None, :]) & (yy < crest[None, :] + 4)] = _WAVE_FOAM
    img[(yy < crest[None, :])] = (0, 0, 0, 0)
    img[10::6, ::4] = _WAVE_FOAM      # sparkle rows
    return img


def _shadow() -> np.ndarray:
    img = _canvas(32, 8)
    _ellipse(img, 16, 4, 14, 3, (30, 40, 50, 110))
    return img


@lru_cache(maxsize=1)
def build_sprites() -> dict:
    """The full named sprite dict (all (H, W, 4) uint8, reference sizes)."""
    rng = np.random.default_rng(20260820)
    sprites = {}
    sprites.update(_tiles(rng))
    sprites["mountain"] = _mountain()
    sprites["cloud"] = _cloud()
    sprites["wave"] = _wave()
    sprites["shadow"] = _shadow()
    for i in range(5):
        sprites[f"ball_{i}"] = _ball(i)
    sprites["ball_hyper"] = _ball_hyper()
    sprites["ball_trail"] = _ball_trail()
    sprites["ball_punch"] = _ball_punch()
    for i in range(10):
        sprites[f"number_{i}"] = _digit(i)
    sprites.update(_player_poses())
    return sprites
