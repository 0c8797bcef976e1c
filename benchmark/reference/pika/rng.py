"""Draw-slot RNG: the counted threefry2x32 stream of ``pikazoo_tpu.core.rng``.

Each potential draw site evaluates

    value_i = threefry2x32(env_key, (counter, SITE_TAG))[0] % upper
    counter += consume_i            # masked, per environment

so the value sequence depends only on the draws actually consumed, exactly as
in the JAX package, the native C++ engine and the Pallas step kernel.

Keys are stored as int32 *bit patterns* (``(..., 2)``), so the whole env
state stays int32.  The threefry arithmetic runs in int64 masked to 32 bits,
because torch has no unsigned 32-bit add, shift or remainder.

``DrawState`` also takes an *oracle*: ``oracle[..., counter]`` supplies each
value in place of the threefry draw, with the same counter semantics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SITE_TAG = 1
FOLD_TAG = 0

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY_CONST = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """Any int tensor of 32-bit words -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & _MASK


def threefry2x32(key: torch.Tensor, c0: torch.Tensor, c1, rounds: int = 20
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, ``rounds`` rounds (20, the published cipher's; a
    multiple of 4).  ``key`` is ``(..., 2)`` of 32-bit words (any
    int dtype, int32 bit patterns included); ``c0``/``c1`` are int tensors (or
    a Python int for ``c1``) broadcastable against ``key[..., 0]``.  Returns
    the two output words as int64 tensors in [0, 2^32)."""
    k0 = _u32(key[..., 0])
    k1 = _u32(key[..., 1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY_CONST)
    x0 = (_u32(c0) + k0) & _MASK
    x1 = ((_u32(c1) if torch.is_tensor(c1) else c1 & _MASK) + k1) & _MASK
    for block in range(rounds // 4):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        inject = block + 1
        x0 = (x0 + ks[inject % 3]) & _MASK
        x1 = (x1 + ks[(inject + 1) % 3] + inject) & _MASK
    return x0, x1


def _as_i32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the same bits as int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def fold_key(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Derive sub-keys (e.g. one per environment) from a ``(2,)`` key:
    returns ``data.shape + (2,)`` int32 key bits."""
    a, b = threefry2x32(key, data, FOLD_TAG)
    return _as_i32_bits(torch.stack([a, b], dim=-1))


def key_data(key, device="cpu") -> torch.Tensor:
    """``(2,)`` int32 key bits from an int seed or 2-word key data (the
    counterpart of the JAX package's ``key_from_jax``).

    An int seed ``s`` gives ``[0, s mod 2^32]``, the key data of
    ``jax.random.key(s)`` and of the JAX package's ``key_from_jax(s)``;
    2-word data (a list, numpy array or tensor of uint32/int32/int64 words)
    is taken as is."""
    if torch.is_tensor(key):
        words = key.to(device=device, dtype=torch.int64)
    else:
        arr = np.asarray(key)
        if arr.ndim == 0:
            arr = np.asarray([0, int(arr)])
        words = torch.as_tensor(arr.astype(np.int64), device=device)
    if words.shape != (2,):
        raise ValueError(f"key must be an int seed or 2 words, got shape "
                         f"{tuple(words.shape)}")
    return _as_i32_bits(words & _MASK)


def site_value(key: torch.Tensor, counter: torch.Tensor, upper: int
               ) -> torch.Tensor:
    """Uniform int32 in [0, upper) for draw slot ``counter`` (modulo
    mapping, as in the JAX package)."""
    bits, _ = threefry2x32(key, counter, SITE_TAG)
    return (bits % upper).to(torch.int32)


class DrawState(NamedTuple):
    """The per-env stream key (``S + (2,)`` int32 bits, constant for the
    step), the masked cumulative draw counter (``S`` int32) and an optional
    oracle, ``S + (cap,)`` int32 pre-recorded draw values."""

    key: torch.Tensor
    counter: torch.Tensor
    oracle: Optional[torch.Tensor] = None


def draw(ds: DrawState, consume: torch.Tensor, upper: int
         ) -> Tuple[torch.Tensor, DrawState]:
    """One potential draw site: uniform int32 in ``[0, upper)`` where
    ``consume`` (bool) is set, 0 elsewhere; the counter advances only where
    it is set.  With an oracle the value is ``oracle[..., counter]``, the
    counter clipped to the oracle's capacity, taken on the device."""
    if ds.oracle is not None:
        index = ds.counter.clamp(0, ds.oracle.shape[-1] - 1).long().unsqueeze(-1)
        value = ds.oracle.gather(-1, index).squeeze(-1)
    else:
        value = site_value(ds.key, ds.counter, upper)
    value = torch.where(consume, value, 0)
    return value, ds._replace(counter=ds.counter + consume.to(torch.int32))
