"""The batched landing simulation: kernel wrapper and device dispatch.

Counterpart of ``pikazoo_tpu.core.predict_pallas.landing_sims_batched``.  A
CUDA tensor runs the hand-written Hopper kernel ``csrc/landing.cu`` (built
by ``pikazoo_tpu_torch._build`` at first use); a CPU tensor runs the plain
PyTorch version, ``core.predict.landing_sims_any``.  On CUDA the kernel
launches or the call raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core.predict import landing_sims_any

SOURCES = ("landing.cu",)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("landing", SOURCES)
    fn = lib.landing_sims_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int32, ctypes.c_void_p]
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


def landing_sims_batched(x: torch.Tensor, y: torch.Tensor, vx: torch.Tensor,
                         vy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) int32 ball state -> (expected (B,), candidates (B, 6)).

    On CUDA the candidates come back as the ``(B, 6)`` view of a lane-major
    ``(6, B)`` buffer (``candidates.t()`` is contiguous).  The kernel runs on
    the current stream and is not synchronised.  Each launch adds one to
    ``landing_sims_batched.launches``."""
    device = _check((x, y, vx, vy))
    if device.type == "cpu":
        expected, candidates = landing_sims_any(x, y, vx, vy)
        return expected, candidates.t()
    n = x.shape[0]
    expected = torch.empty(n, dtype=torch.int32, device=device)
    candidates = torch.empty((6, n), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().landing_sims_launch(
            x.data_ptr(), y.data_ptr(), vx.data_ptr(), vy.data_ptr(),
            expected.data_ptr(), candidates.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"landing kernel launch failed: CUDA error {err}")
    landing_sims_batched.launches += 1
    return expected, candidates.t()


landing_sims_batched.launches = 0
