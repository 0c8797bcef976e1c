"""The committed trained policies, in a torch format.

Each ``<name>.pt`` holds one policy's parameters (float32, the
``ActorCritic`` state-dict layout) with ``hidden``, ``num_actions``,
``activation`` and ``learner_seats``, and loads with
``torch.load(weights_only=True)``, with no JAX:

* ``vs_ai_policy``: seat 1 trained against the rule AI (200 updates at
  B=8192, ``learner_seats="p1"``, a seat-1 specialist);
* ``selfplay_policy``: symmetric self-play, 600 updates at B=8192;
* ``selfplay_policy_xl``: symmetric self-play, 2000 updates at B=65536.

They are the JAX package's orbax artifacts (``artifacts/<name>``) carried
across once with ``convert.params_from_flax``;
``tests/test_torch_artifact.py`` holds each file equal to its artifact, bit
for bit.
"""

from __future__ import annotations

import os

import torch

from pikazoo_tpu_torch.train.networks import ActorCritic

POLICY_DIR = os.path.dirname(os.path.abspath(__file__))


def policy_path(name: str) -> str:
    """The committed file of policy ``name`` (one of those listed above)."""
    return os.path.join(POLICY_DIR, name + ".pt")


def load_policy(path: str, device="cuda") -> ActorCritic:
    """The policy in ``path`` as an ``ActorCritic`` on ``device`` (the card
    unless the caller asks for the CPU), in eval mode with its gradients
    off."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    net = ActorCritic(data["num_actions"], tuple(data["hidden"]), data["activation"])
    net.load_state_dict(data["params"])
    return net.to(device).eval().requires_grad_(False)
