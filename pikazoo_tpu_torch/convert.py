"""Carry env state across between the JAX package and the port.

The slice has no parameters; what carries across is the state.  A JAX
``EnvState`` with numpy leaves (``jax.device_get`` of one, or any tuple with
the same nested fields) maps to the port's :class:`EnvState` on a device,
and back.  Every leaf is int32 except the JAX ``rng_key``, which is uint32:
the port keeps the same 32 bits as int32.  The round trip is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from pikazoo_tpu_torch.core.state import BallState, PlayerState
from pikazoo_tpu_torch.envs.pika_volley import EnvState

_NESTED = {"p1": PlayerState, "p2": PlayerState, "ball": BallState}


def env_state_from_numpy(state, device="cpu") -> EnvState:
    """The port's :class:`EnvState` on ``device`` from a JAX ``EnvState``
    whose leaves are numpy arrays (or anything ``np.asarray`` takes)."""
    def leaf(value) -> torch.Tensor:
        arr = np.asarray(value)
        if arr.dtype not in (np.int32, np.uint32):
            raise TypeError(f"env state leaves are int32 or uint32, got {arr.dtype}")
        return torch.tensor(np.ascontiguousarray(arr).view(np.int32),
                            device=device)

    fields = {}
    for name in EnvState._fields:
        value = getattr(state, name)
        if name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(*(leaf(getattr(value, f)) for f in cls._fields))
        else:
            fields[name] = leaf(value)
    return EnvState(**fields)


def env_state_to_numpy(state: EnvState) -> EnvState:
    """The same tuple with numpy leaves, laid out as the JAX package's:
    int32 everywhere, ``rng_key`` as uint32."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    fields = {name: (type(value)(*map(leaf, value)) if name in _NESTED
                     else leaf(value))
              for name, value in state._asdict().items()}
    fields["rng_key"] = fields["rng_key"].view(np.uint32)
    return EnvState(**fields)
