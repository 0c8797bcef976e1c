"""Actor-critic network for self-play PPO.

Counterpart of ``pikazoo_tpu.train.networks``: a small MLP over the 35-dim
observation (normalised to [0, 1] with the env's Box bounds), shared by both
seats.  Parameters are float32; every product runs on bf16 operands, as the
flax module's ``Dense(dtype=bfloat16)`` does.

The parameters are a flat dict, the module's ``state_dict`` layout:
``layers.{i}.kernel`` ``(in, out)`` and ``layers.{i}.bias`` ``(out,)``, the
hidden layers first, then the policy head, then the value head (flax's
``Dense_0 .. Dense_{L+1}``; ``convert.params_from_flax`` maps one onto the
other).  The functions here take such a dict, so the trainer can hand them
plain tensors, and the module's ``forward`` is the same function on its own
parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from pikazoo_tpu_torch.envs.observations import _LOW_F, _SPAN_F

BF16 = torch.bfloat16
Params = Dict[str, torch.Tensor]


def normalize_obs(obs: torch.Tensor) -> torch.Tensor:
    """``(..., 35)`` raw int observations -> float32 in [0, 1] (bar obs dim
    33, see ``envs.observations``): ``(obs - low) / span``, a true division
    by a tensor on the same device."""
    low = torch.tensor(_LOW_F, device=obs.device)
    span = torch.tensor(_SPAN_F, device=obs.device)
    return (obs.float() - low) / span


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.relu(x) if activation == "relu" else torch.tanh(x)


def dense_layers(params: Params) -> Tuple[List[str], int, List[torch.Tensor],
                                          List[torch.Tensor]]:
    """The layer-order contract, in one place: ``(names, L, kernels,
    biases)`` with the L hidden layers first in creation order, then the
    policy head (entry L) and the value head (entry L + 1), sorted by the
    numeric index of ``layers.{i}``."""
    names = sorted({k.rsplit(".", 1)[0] for k in params},
                   key=lambda s: int(s.rsplit(".", 1)[1]))
    w = [params[f"{n}.kernel"] for n in names]
    b = [params[f"{n}.bias"] for n in names]
    return names, len(names) - 2, w, b


def apply(params: Params, obs: torch.Tensor, activation: str = "tanh",
          pre_normalized: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major forward: ``(..., 35)`` -> ``(logits (..., A) f32, value
    (...,) f32)``.  Like flax's ``Dense(dtype=bfloat16)``: bf16 operands,
    product, bias add and activation, heads cast to f32 at the end.
    Differentiable in ``params``."""
    _, L, w, b = dense_layers(params)
    x = (obs if pre_normalized else normalize_obs(obs)).to(BF16)
    for l in range(L):
        x = _act(torch.matmul(x, w[l].to(BF16)) + b[l].to(BF16), activation)
    logits = torch.matmul(x, w[L].to(BF16)) + b[L].to(BF16)
    value = torch.matmul(x, w[L + 1].to(BF16)) + b[L + 1].to(BF16)
    return logits.float(), value.squeeze(-1).float()


def apply_fm(params: Params, x_fm: torch.Tensor, activation: str = "tanh"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feature-major forward: ``x_fm`` (F, N) normalised bf16 ->
    ``(logits (A, N) f32, value (N,) f32)``, every product transposed
    (``h = act(W^T x)``) with the policy and value heads merged into one
    (H, A+1) product, as ``pikazoo_tpu.train.networks.apply_fm``."""
    _, L, w, b = dense_layers(params)
    h = x_fm.to(BF16)
    for l in range(L):
        pre = torch.matmul(w[l].to(BF16).t(), h) + b[l].to(BF16)[:, None]
        h = _act(pre, activation)
    wpv = torch.cat([w[L].to(BF16), w[L + 1].to(BF16)], dim=1)
    bpv = torch.cat([b[L].to(BF16), b[L + 1].to(BF16)])
    heads = torch.matmul(wpv.t(), h) + bpv[:, None]
    return heads[:-1].float(), heads[-1].float()


class Dense(nn.Module):
    """One layer with flax's parameter layout: ``kernel`` (in, out)."""

    def __init__(self, fan_in: int, fan_out: int, gain: float,
                 generator: torch.Generator | None, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, fan_out, device=device))
        self.bias = nn.Parameter(torch.zeros(fan_out, device=device))
        nn.init.orthogonal_(self.kernel, gain=gain, generator=generator)


class ActorCritic(nn.Module):
    """The PPO policy and value MLP: ``hidden`` layers of ``activation``
    ("tanh", the PPO convention, or "relu"), a policy head of
    ``num_actions`` logits and a scalar value head.  Orthogonal init with
    gains sqrt(2) (hidden), 0.01 (policy) and 1.0 (value), zero biases,
    drawn from ``generator``."""

    def __init__(self, num_actions: int = 18, hidden: Sequence[int] = (256, 256),
                 activation: str = "tanh", obs_dim: int = 35,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be 'tanh' or 'relu', got {activation!r}")
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.activation = activation
        widths = [obs_dim, *self.hidden]
        layers = [Dense(i, o, math.sqrt(2), generator, device)
                  for i, o in zip(widths[:-1], widths[1:])]
        layers.append(Dense(widths[-1], num_actions, 0.01, generator, device))
        layers.append(Dense(widths[-1], 1, 1.0, generator, device))
        self.layers = nn.ModuleList(layers)

    def params(self) -> Params:
        """The parameters as the flat dict the functions above take."""
        return dict(self.named_parameters())

    def forward(self, obs: torch.Tensor, pre_normalized: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply(self.params(), obs, self.activation, pre_normalized)
