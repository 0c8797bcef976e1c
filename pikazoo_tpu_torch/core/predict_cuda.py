"""The batched landing simulation: kernel wrapper and device dispatch.

Counterpart of ``pikazoo_tpu.core.predict_pallas.landing_sims_batched``.  A
CUDA tensor runs the hand-written Hopper kernel ``csrc/landing.cu`` (built
by ``pikazoo_tpu_torch._build`` at first use); a CPU tensor runs the plain
PyTorch version, ``core.predict.landing_sims_any``, with the same
arguments.  On CUDA the kernel launches in the mode asked for or the call
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core.predict import ALGOS, SPLITS, landing_sims_any, parse_algo

SOURCES = ("landing.cu",)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("landing", SOURCES)
    fn = lib.landing_sims_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(tensors) -> torch.device:
    device = tensors[0].device
    shape = tensors[0].shape
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"landing_sims_batched takes int32, got {t.dtype}")
        if t.dim() != 1 or t.shape != shape:
            raise ValueError("landing_sims_batched takes four (B,) tensors, got "
                             f"shapes {[tuple(u.shape) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError("landing_sims_batched takes contiguous tensors")
        if t.device != device:
            raise ValueError("landing_sims_batched inputs lie on "
                             f"{sorted({str(u.device) for u in tensors})}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"landing_sims_batched has no version for {device}")
    return device


def algo_name(algo: str) -> str:
    """The key of ``landing_sims_batched.launches_by_algo``: ``"A"`` when
    both loops are A, else ``"A,B"``."""
    algo_true, algo_cand = parse_algo(algo)
    return algo_true if algo_true == algo_cand else f"{algo_true},{algo_cand}"


def landing_sims_batched(x: torch.Tensor, y: torch.Tensor, vx: torch.Tensor,
                         vy: torch.Tensor, *, algo: str = "iter", split: str = "none",
                         unroll: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) int32 ball state -> (expected (B,), candidates (B, 6)).

    ``algo`` is the landing loop, ``"iter"`` (the frame loop, the default),
    ``"leap"``, ``"hyb"`` or ``"A,B"`` (the true ball under A, the
    candidates under B); ``split`` is ``"none"`` or ``"ydir"``; ``unroll``
    the leaps or exact iterations a trip (0: each loop's default).  Every
    mode gives the same results (``core.predict``).  On CUDA the kernel runs
    the mode's instance (``split="ydir"`` is the same launch: see
    ``csrc/landing.cu``), and the candidates come back as the ``(B, 6)`` view
    of a lane-major ``(6, B)`` buffer (``candidates.t()`` is contiguous).  The
    kernel runs on the current stream and is not synchronised.  Each launch
    adds one to ``landing_sims_batched.launches`` and to
    ``launches_by_algo[algo_name(algo)]``."""
    device = _check((x, y, vx, vy))
    algo_true, algo_cand = parse_algo(algo)
    if split not in SPLITS:
        raise ValueError(f"unknown landing split {split!r}: one of {SPLITS}")
    if unroll < 0:
        raise ValueError(f"unroll must be >= 0, got {unroll}")
    if device.type == "cpu":
        expected, candidates = landing_sims_any(x, y, vx, vy, algo=algo, split=split,
                                                unroll=unroll)
        return expected, candidates.t()
    n = x.shape[0]
    expected = torch.empty(n, dtype=torch.int32, device=device)
    candidates = torch.empty((6, n), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().landing_sims_launch(
            x.data_ptr(), y.data_ptr(), vx.data_ptr(), vy.data_ptr(),
            expected.data_ptr(), candidates.data_ptr(), n, ALGOS.index(algo_true),
            ALGOS.index(algo_cand), unroll, stream)
    if err != 0:
        raise RuntimeError(f"landing kernel launch failed: CUDA error {err}")
    landing_sims_batched.launches += 1
    landing_sims_batched.launches_by_algo[algo_name(algo)] += 1
    return expected, candidates.t()


def zero_counts() -> None:
    """Set K2's counts to 0: its launches, and by mode."""
    landing_sims_batched.launches = 0
    landing_sims_batched.launches_by_algo = {
        algo_name(f"{a},{b}"): 0 for a in ALGOS for b in ALGOS}


zero_counts()
