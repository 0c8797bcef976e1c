"""Carry env state and network weights across between the JAX package and
the port.

A JAX ``EnvState`` with numpy leaves (``jax.device_get`` of one, or any
tuple with the same nested fields) maps to the port's :class:`EnvState` on a
device, and back.  Every leaf is int32 except the JAX ``rng_key``, which is
uint32: the port keeps the same 32 bits as int32.

A flax ``ActorCritic`` variables tree ``{'params': {'Dense_i': {'kernel'
(in, out), 'bias' (out,)}}}`` with numpy leaves maps to the port's parameter
dict (``layers.{i}.kernel`` / ``layers.{i}.bias``, the layout of
``train.networks.ActorCritic.state_dict()``), and back.  Layers are matched
by the numeric suffix of ``Dense_i``, the order ``dense_layers`` uses.

Both round trips are exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pikazoo_tpu_torch.core.state import BallState, PlayerState
from pikazoo_tpu_torch.envs.pika_volley import EnvState
from pikazoo_tpu_torch.train.networks import dense_layers

_NESTED = {"p1": PlayerState, "p2": PlayerState, "ball": BallState}


def env_state_from_numpy(state, device="cpu") -> EnvState:
    """The port's :class:`EnvState` on ``device`` from a JAX ``EnvState``
    whose leaves are numpy arrays (or anything ``np.asarray`` takes)."""
    def leaf(value) -> torch.Tensor:
        arr = np.asarray(value)
        if arr.dtype not in (np.int32, np.uint32):
            raise TypeError(f"env state leaves are int32 or uint32, got {arr.dtype}")
        # ascontiguousarray makes a 0-d array 1-d: keep the leaf's shape.
        return torch.tensor(np.ascontiguousarray(arr).view(np.int32).reshape(arr.shape),
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


def params_from_flax(variables, device="cpu") -> Dict[str, torch.Tensor]:
    """The port's float32 parameter dict on ``device`` from a flax
    ``ActorCritic`` variables tree with numpy leaves.  Load it into a module
    with ``ActorCritic.load_state_dict``."""
    dense = variables["params"]
    names = sorted(dense, key=lambda s: int(s.rsplit("_", 1)[1]))
    out = {}
    for i, name in enumerate(names):
        for leaf in ("kernel", "bias"):
            arr = np.asarray(dense[name][leaf])
            if arr.dtype != np.float32:
                raise TypeError(f"{name}.{leaf} is {arr.dtype}, not float32")
            out[f"layers.{i}.{leaf}"] = torch.tensor(arr, device=device)
    return out


def params_to_flax(params) -> dict:
    """The flax variables tree, numpy float32 leaves, of a port parameter
    dict (or of an ``ActorCritic`` module)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    _, _, w, b = dense_layers(params)
    return {"params": {
        f"Dense_{i}": {"kernel": k.detach().cpu().numpy(),
                       "bias": v.detach().cpu().numpy()}
        for i, (k, v) in enumerate(zip(w, b))}}
