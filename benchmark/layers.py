"""Per-call readings of a profiled window, shared by the per-layer metrics:
each traced unit opens a ``bench.<unit>`` span and ends with a
``bench.readback`` span, so unit i runs from the start of the first to the
end of the second."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def unit_windows(profile, unit: str) -> List[Tuple[int, int]]:
    """(start, end) in ns of each traced unit."""
    starts = profile.spans_named(unit)
    ends = profile.spans_named("readback")
    return [(s, e) for (s, _), (_, e) in zip(starts, ends)]


def device_s_per_unit(profile, unit: str, kernels: Sequence[str]) -> List[float]:
    """Device seconds of the named kernels inside each traced unit."""
    return [profile.kernel_s(kernels, w) for w in unit_windows(profile, unit)]


def wall_s_per_unit(profile, unit: str) -> List[float]:
    return [(e - s) / 1e9 for s, e in unit_windows(profile, unit)]
