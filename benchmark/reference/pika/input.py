"""Action decoding and edge-detected input.

The env exposes ``Discrete(18)`` actions decoded through an 18x5 key table
(reference ``pikazoo_env.py:119-141``) into (x_direction, y_direction) in
{-1,0,1} and a rising-edge power-hit bit (``PikaUserInput.get_input``,
``physics.py:59-99``).  The latch ``power_hit_key_is_down_previous`` is part
of the observation (dims 12/25) and lives in env state.

Out-of-range actions follow the JAX package's gather semantics: a negative
action counts from the end (``-1`` is 17), then the index is clamped to
[0, 17], so action 99 behaves as 17.  Torch indexing would raise instead.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .state import PlayerInput

NUM_ACTIONS = 18

# [left, right, up, down, power_hit] per discrete action 0..17.
ACTION_KEY_TABLE = (
    (0, 0, 0, 0, 0),
    (0, 0, 0, 0, 1),
    (0, 0, 1, 0, 0),
    (0, 1, 0, 0, 0),
    (1, 0, 0, 0, 0),
    (0, 0, 0, 1, 0),
    (0, 1, 1, 0, 0),
    (1, 0, 1, 0, 0),
    (0, 1, 0, 1, 0),
    (1, 0, 0, 1, 0),
    (0, 0, 1, 0, 1),
    (0, 1, 0, 0, 1),
    (1, 0, 0, 0, 1),
    (0, 0, 0, 1, 1),
    (0, 1, 1, 0, 1),
    (1, 0, 1, 0, 1),
    (0, 1, 0, 1, 1),
    (1, 0, 0, 1, 1),
)

_XD = tuple(-1 if row[0] else (1 if row[1] else 0) for row in ACTION_KEY_TABLE)
_YD = tuple(-1 if row[2] else (1 if row[3] else 0) for row in ACTION_KEY_TABLE)
_PK = tuple(row[4] for row in ACTION_KEY_TABLE)


@functools.lru_cache(maxsize=None)
def _table(device: torch.device) -> torch.Tensor:
    """(3, 18) decode table on ``device``: x direction, y direction and raw
    power key per action (built once per device, never written)."""
    return torch.tensor((_XD, _YD, _PK), dtype=torch.int32, device=device)


def _edge(power_key: torch.Tensor, latch_prev: torch.Tensor) -> torch.Tensor:
    return ((latch_prev == 0) & (power_key == 1)).to(torch.int32)


def clamp_action(action: torch.Tensor) -> torch.Tensor:
    """JAX gather index semantics: negative counts from the end, then clamp."""
    action = action.to(torch.int64)
    return torch.where(action < 0, action + NUM_ACTIONS, action).clamp(
        0, NUM_ACTIONS - 1)


def decode_action(action: torch.Tensor, latch_prev: torch.Tensor
                  ) -> Tuple[PlayerInput, torch.Tensor]:
    """Decode discrete actions (any shape) with rising-edge power-hit
    detection.  Returns the decoded :class:`PlayerInput` and the new latch
    value (= raw power key state)."""
    xd, yd, power_key = _table(action.device)[:, clamp_action(action)].unbind(0)
    return PlayerInput(xd, yd, _edge(power_key, latch_prev)), power_key


# Gather-free decode: the three 18-entry tables packed into bit fields
# (directions biased by +1, two bits each; actions 0-15 in the low word,
# 16-17 in the high word), unpacked with shifts.
def _pack2(table):
    lo = sum((v + 1) << (2 * a) for a, v in enumerate(table[:16]))
    hi = sum((v + 1) << (2 * a) for a, v in enumerate(table[16:]))
    return lo & 0xFFFFFFFF, hi & 0xFFFFFFFF


_XD_LO, _XD_HI = _pack2(_XD)
_YD_LO, _YD_HI = _pack2(_YD)
_PK_BITS = sum(v << a for a, v in enumerate(_PK))


def _unpack2(lo: int, hi: int, action: torch.Tensor) -> torch.Tensor:
    a = action.to(torch.int64)
    low = (lo >> (2 * a).clamp(0, 63)) & 3
    high = (hi >> (2 * (a - 16)).clamp(0, 63)) & 3
    return (torch.where(a < 16, low, high) - 1).to(torch.int32)


def decode_action_arith(action: torch.Tensor, latch_prev: torch.Tensor
                        ) -> Tuple[PlayerInput, torch.Tensor]:
    """Bit-arithmetic equivalent of :func:`decode_action`, the form a fused
    step kernel uses.  ``action`` must already be in [0, 18)."""
    a = action.to(torch.int64)
    xd = _unpack2(_XD_LO, _XD_HI, a)
    yd = _unpack2(_YD_LO, _YD_HI, a)
    power_key = ((_PK_BITS >> a) & 1).to(torch.int32)
    return PlayerInput(xd, yd, _edge(power_key, latch_prev)), power_key
