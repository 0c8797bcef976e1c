"""Timing shared by the probe tools: CUDA events on the card, the host's
clock on the CPU (where a time says nothing of the card), and the card's
name and power limit to print beside a time."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch


# Clock cycles (~25 ms on an H100) that the stream is held before a timed
# run, so that the host queues the whole run behind the hold and the events
# time the card's work alone, not the host's issue of many small launches.
HOLD_CYCLES = 50_000_000


def timer(device: torch.device) -> Callable[[Callable[[], object]], float]:
    """Seconds of one call of ``fn``: CUDA events on the card (the stream held
    first, see HOLD_CYCLES), the host's clock on the CPU."""
    if device.type == "cuda":
        def on_card(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return on_card

    def on_host(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return on_host


def best_of(fn, iters: int, clock) -> float:
    """The least of ``iters`` timed calls, after one untimed warm-up."""
    fn()
    return min(clock(fn) for _ in range(max(1, iters)))


def where(device: torch.device) -> str:
    """What a tool's times are: the card's name and CUDA events, or the
    host's clock."""
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)}, CUDA events"
    return "CPU, host clock"


def resolve(name: str, tool: str) -> torch.device:
    """The tool's device; a CUDA device without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool} runs on a CUDA card; pass --device cpu for the plain "
                           "versions on the CPU")
    return device


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them: every
    time on the card is printed beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
