"""Decorative cloud/wave entities (reference ``cloud_and_wave.py:1-78``).

Ten drifting clouds (periodic size pulse, random respawn row/speed at the
right edge) and a 27-column shoreline wave with a sawtooth vertical sweep and
per-column jitter.  Pure decoration — nothing here feeds physics — but in the
reference the dynamics consume random draws from the *gameplay* generator
(``cloud_and_wave_engine`` is handed ``self.np_random``,
``pikazoo_env.py:349``), so rendering perturbs subsequent physics draws.

To support both behaviors, the dynamics here are generic over a
``draw(upper) -> int`` callable:

* decoupled (default renderer mode): a private host RNG — rendering is a pure
  read of env state;
* coupled (reference-compatible mode): the env's draw-slot stream
  (``core.rng``), advancing the same counter the physics uses — production
  threefry or recorded oracle values alike.  Draw ORDER matches the reference
  exactly (per-cloud respawn pairs in cloud order, then the wave's
  conditional dip draw, then 27 per-column jitters).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

NUM_CLOUDS = 10
NUM_WAVE_COLUMNS = 432 // 16  # 27

DrawFn = Callable[[int], int]


def _zero_draw(upper: int) -> int:
    del upper
    return 0


class CloudWave:
    """Host-side cloud/wave state with reference-exact dynamics and draws."""

    def __init__(self, draw: DrawFn | None = None):
        draw = draw or _zero_draw
        self.cloud_x: List[int] = []
        self.cloud_y: List[int] = []
        self.cloud_v: List[int] = []
        self.cloud_phase: List[int] = []
        # Cloud.__init__ draw order, one cloud at a time
        # (cloud_and_wave.py:16-19): x, y, velocity, size phase.
        for _ in range(NUM_CLOUDS):
            self.cloud_x.append(-68 + draw(432 + 68))
            self.cloud_y.append(draw(152))
            self.cloud_v.append(1 + draw(2))
            self.cloud_phase.append(draw(11))
        # Wave.__init__ (cloud_and_wave.py:41-48): no draws.
        self.wave_vertical = 0
        self.wave_velocity = 2
        self.wave_y: List[int] = [314] * NUM_WAVE_COLUMNS

    def step(self, draw: DrawFn) -> None:
        """One frame of ``cloud_and_wave_engine`` (cloud_and_wave.py:53-78)."""
        for i in range(NUM_CLOUDS):
            self.cloud_x[i] += self.cloud_v[i]
            if self.cloud_x[i] > 432:
                self.cloud_x[i] = -68
                self.cloud_y[i] = draw(152)
                self.cloud_v[i] = 1 + draw(2)
            self.cloud_phase[i] = (self.cloud_phase[i] + 1) % 11

        self.wave_vertical += self.wave_velocity
        if self.wave_vertical > 32:
            self.wave_vertical = 32
            self.wave_velocity = -1
        elif self.wave_vertical < 0 and self.wave_velocity < 0:
            self.wave_velocity = 2
            self.wave_vertical = -draw(40)
        for i in range(NUM_WAVE_COLUMNS):
            self.wave_y[i] = 314 - self.wave_vertical + draw(3)

    def cloud_rects(self) -> Iterator[Tuple[int, int, int, int]]:
        """Per-cloud sprite rects (x, y, w, h) including the size pulse
        (Cloud.size_diff / sprite_* properties, cloud_and_wave.py:21-38)."""
        for x, y, ph in zip(self.cloud_x, self.cloud_y, self.cloud_phase):
            d = 5 - abs(ph - 5)
            yield (x - d, y - d, 48 + 2 * d, 24 + 2 * d)
