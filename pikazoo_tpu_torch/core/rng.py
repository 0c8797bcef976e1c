"""Draw-slot RNG: the counted threefry2x32 stream of ``pikazoo_tpu.core.rng``.

Each potential draw site evaluates

    value_i = threefry2x32(env_key, (counter, SITE_TAG))[0] % upper
    counter += consume_i            # masked, per environment

so the value sequence depends only on the draws actually consumed, exactly as
in the JAX package, the native C++ engine and the Pallas step kernel.

Keys are stored as int32 *bit patterns* (``(..., 2)``), so the whole env
state stays int32; ``pikazoo_tpu_torch.convert`` maps them to and from the
JAX package's uint32 key data.  The threefry arithmetic runs in int64 masked
to 32 bits, because torch has no unsigned 32-bit add, shift or remainder.

``split``, ``fold_in`` and ``randint`` are ``jax.random``'s operations on
threefry key data, bit for bit: the wrappers and the evaluation harness derive
their keys and the random opponent's actions with them, as the JAX package
does.

For trajectory parity with a recorded stream, ``DrawState`` also takes an
*oracle*: ``oracle[..., counter]`` supplies each value in place of the
threefry draw, with the same counter semantics (the JAX package's oracle
mode).  :func:`site_value_host` is the stream on plain Python ints, for the
host draws of the coupled renderer.
"""

from __future__ import annotations

import math
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


def threefry2x32(key: torch.Tensor, c0: torch.Tensor, c1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds.  ``key`` is ``(..., 2)`` of 32-bit words (any
    int dtype, int32 bit patterns included); ``c0``/``c1`` are int tensors (or
    a Python int for ``c1``) broadcastable against ``key[..., 0]``.  Returns
    the two output words as int64 tensors in [0, 2^32)."""
    k0 = _u32(key[..., 0])
    k1 = _u32(key[..., 1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY_CONST)
    x0 = (_u32(c0) + k0) & _MASK
    x1 = ((_u32(c1) if torch.is_tensor(c1) else c1 & _MASK) + k1) & _MASK
    for block in range(5):
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


def _counter_words(key: torch.Tensor, shape: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32(key, (0, i))`` for ``i`` the flat index into ``shape``:
    the counter layout of ``jax.random`` under ``jax_threefry_partitionable``
    (the high word of a 64-bit iota first).  ``key`` is ``K + (2,)``; the
    two words come back with shape ``K + shape``."""
    index = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=key.device).reshape(shape)
    key = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    return threefry2x32(key, torch.zeros_like(index), index)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` on key words: ``K + (2,)`` -> ``K + (n,
    2)`` int32 key bits (for a ``jax.random.key(seed)``, ``key_data(seed)``)."""
    a, b = _counter_words(key, (n,))
    return _as_i32_bits(torch.stack([a, b], dim=-1))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on key words: the key hashed with
    the counter ``(0, data mod 2^32)`` (JAX casts ``data`` to uint32
    first); ``K + (2,)`` int32 bits."""
    a, b = threefry2x32(key, torch.zeros(key.shape[:-1], dtype=torch.int64,
                                         device=key.device), data & _MASK)
    return _as_i32_bits(torch.stack([a, b], dim=-1))


def _random_bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: the two threefry words of
    each counter xor-ed, as int64 in [0, 2^32)."""
    a, b = _counter_words(key, shape)
    return a ^ b


def randint(key: torch.Tensor, shape: Tuple[int, ...], lo: int, hi: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi, int32)`` on key words
    ``K + (2,)``: int32 of shape ``K + shape`` in ``[lo, hi)``.  JAX's
    algorithm: two draws of 32 bits from the key's two halves, combined
    modulo the span through the multiplier ``(2^16 mod span)^2 mod span``,
    every product and sum in uint32 arithmetic, which wraps."""
    k = split(key)
    higher = _random_bits(k[..., 0, :], shape)
    lower = _random_bits(k[..., 1, :], shape)
    span = hi - lo if hi > lo else 1
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = ((((higher % span) * multiplier) & _MASK) + lower % span) & _MASK
    return _as_i32_bits((lo + offset % span) & _MASK)


def site_value(key: torch.Tensor, counter: torch.Tensor, upper: int
               ) -> torch.Tensor:
    """Uniform int32 in [0, upper) for draw slot ``counter`` (modulo
    mapping, as in the JAX package)."""
    bits, _ = threefry2x32(key, counter, SITE_TAG)
    return (bits % upper).to(torch.int32)


def site_value_host(key_bits, counter: int, upper: int) -> int:
    """:func:`site_value` on plain Python ints, with no device work: the
    value of draw slot ``counter`` for the 2-word key ``key_bits`` (uint32
    or int32 words, any sequence or array)."""
    k0 = int(key_bits[0]) & _MASK
    k1 = int(key_bits[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY_CONST)
    x0 = (int(counter) + k0) & _MASK
    x1 = (SITE_TAG + k1) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 ^= x0
        inject = block + 1
        x0 = (x0 + ks[inject % 3]) & _MASK
        x1 = (x1 + ks[(inject + 1) % 3] + inject) & _MASK
    return x0 % upper


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
