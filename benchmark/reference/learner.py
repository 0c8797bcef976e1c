"""The self-play PPO learner, written plainly: the benchmark's reference for
the training cells.

The network is the (35, *hidden, 18 + 1) MLP whose products take bf16
operands and accumulate in float32, as the configuration states it (flax's
``Dense(dtype=bfloat16)``); its gradients, summed in float32, come from
autograd of the
clipped-PPO loss; the optimizer is ``clip_by_global_norm`` then Adam, as
optax computes them.  ``matmul_dtype`` swaps the products' operand type:
``torch.float8_e4m3fn`` gives the control, the same arithmetic one
precision below the configuration's; ``torch.float32`` a witness in float32
throughout.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from benchmark.reference.pika.env import raw_obs
from benchmark.reference.pika.observations import OBS_HIGH, OBS_LOW

BF16 = torch.bfloat16
Params = Dict[str, torch.Tensor]
_LOW = OBS_LOW.astype(np.float32)
_SPAN = (OBS_HIGH - OBS_LOW).astype(np.float32)


class Recipe(NamedTuple):
    """The PPO settings the reference follows."""

    num_envs: int
    rollout_length: int
    num_minibatches: int
    update_epochs: int
    hidden: Sequence[int]
    num_actions: int = 18
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5


def layer_names(params: Params) -> List[str]:
    """``layers.{i}`` in index order: the hidden layers, then the policy
    head, then the value head."""
    return sorted({k.rsplit(".", 1)[0] for k in params}, key=lambda s: int(s.rsplit(".", 1)[1]))


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """Operands in bf16, or rounded to ``dtype`` and carried as bf16 (fp8
    values are exact in bf16), so that the products run on those values.
    The rounding passes gradients straight through: the control's backward
    stays bf16, as a forward-only lower precision would."""
    if dtype == torch.float32:
        return x.float()
    x = x.to(BF16)
    if dtype == BF16:
        return x
    return x + (x.to(dtype).to(BF16) - x).detach()


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """One layer as the configuration states it: the products of bf16 (or
    ``dtype``) operands summed in float32 (a float32 product of values exact
    in float32, TF32 off), the sum rounded to bf16, the bias added in bf16.
    The bias's gradient is summed in float32."""
    acc = torch.matmul(_cast(h, dtype).float(), _cast(w, dtype).float())
    if dtype == torch.float32:  # the witness: float32 throughout
        return acc + b.float()
    return (acc.to(BF16).float() + b.to(BF16).float()).to(BF16)


def forward(params: Params, x: torch.Tensor, matmul_dtype=BF16):
    """Row-major forward of normalised observations ``(N, 35)``: ``(logits
    (N, A) f32, value (N,) f32)``: :func:`_dense` layers with tanh in bf16,
    the heads cast to f32."""
    names = layer_names(params)
    w = [params[f"{n}.kernel"] for n in names]
    b = [params[f"{n}.bias"] for n in names]
    L = len(names) - 2
    h = x.float() if matmul_dtype == torch.float32 else x.to(BF16)
    for l in range(L):
        h = torch.tanh(_dense(h, w[l], b[l], matmul_dtype))
    logits = _dense(h, w[L], b[L], matmul_dtype)
    value = _dense(h, w[L + 1], b[L + 1], matmul_dtype)
    return logits.float(), value.squeeze(-1).float()


def normalize(obs: torch.Tensor) -> torch.Tensor:
    """``(..., 35)`` raw int observations -> float32 ``(obs - low) / span``."""
    low = torch.tensor(_LOW, device=obs.device)
    span = torch.tensor(_SPAN, device=obs.device)
    return (obs.float() - low) / span


def sample_gap(logits: torch.Tensor, u: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """How far each given action lies from the one the reference's policy
    draws with its uniform: inverse-CDF sampling takes action ``a`` when
    ``cdf[a - 1] < u * total <= cdf[a]``; the gap is the distance, as a
    share of the total, by which ``u`` falls outside ``action``'s bucket
    (0 where it falls inside).  ``logits (N, A)``, ``u``, ``action`` ``(N,)``."""
    probs = torch.softmax(logits.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    total = cdf[:, -1]
    a = action.long().clamp(0, logits.shape[-1] - 1)
    hi = cdf.gather(1, a[:, None])[:, 0]
    lo = torch.where(a > 0, cdf.gather(1, (a - 1).clamp(min=0)[:, None])[:, 0],
                     torch.zeros_like(hi))
    target = u * total
    bad = (action.long() < 0) | (action.long() >= logits.shape[-1])
    gap = torch.clamp(torch.maximum(lo - target, target - hi), min=0) / total
    return torch.where(bad, torch.ones_like(gap), gap)


def gae(value, reward, done, last_value, gamma: float, lam: float):
    """GAE advantages and targets over the leading time axis."""
    not_done = 1.0 - done
    next_value = torch.cat([value[1:], last_value[None]], dim=0)
    delta = reward + gamma * next_value * not_done - value
    coef = gamma * lam * not_done
    adv = torch.empty_like(delta)
    running = torch.zeros_like(last_value)
    for t in range(value.shape[0] - 1, -1, -1):
        running = delta[t] + coef[t] * running
        adv[t] = running
    return adv, adv + value


class Adam:
    """``clip_by_global_norm(max_norm)`` then Adam (bias-corrected, epsilon
    outside the root), as optax chains them."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Params, lr: float, max_norm: float):
        self.lr, self.max_norm = lr, max_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.first_mu: Params = {}

    def step(self, params: Params, grads: Params) -> Params:
        norm = torch.sqrt(sum(torch.sum(g.double() * g.double()) for g in grads.values())).float()
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        out = {}
        for k, g in grads.items():
            g = g * scale
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            out[k] = params[k] - self.lr * ((self.mu[k] / bc1) /
                                            (torch.sqrt(self.nu[k] / bc2) + self.eps))
        if self.count == 1:
            self.first_mu = {k: v.clone() for k, v in self.mu.items()}
        return out


def update(params: Params, opt: Adam, r: Recipe, traj: Dict[str, torch.Tensor], adv, target,
           matmul_dtype=BF16, half_batch: bool = False, row_block: int = 1 << 20):
    """``update_epochs`` passes over ``num_minibatches`` consecutive slices
    of the time axis, an optimizer step each.  ``traj`` holds ``obs``
    ``(T, N, 35)`` normalised f32, and ``action``, ``log_prob``, ``value``
    ``(T, N)``.  Returns ``(params, losses (epochs * minibatches, 5))``.
    ``half_batch`` computes each gradient over the first half of the
    minibatch's rows only, the mean taken over them (a fault the check
    must catch).  Gradients are summed over blocks of ``row_block`` rows so
    that the activations fit."""
    T = traj["action"].shape[0]
    t_mb = T // r.num_minibatches
    losses = []
    for _ in range(r.update_epochs):
        for i in range(r.num_minibatches):
            sl = slice(i * t_mb, (i + 1) * t_mb)
            rows = lambda t: t[sl].reshape((-1,) + t.shape[2:])
            obs, action, logp, value = (rows(traj[k]) for k in ("obs", "action", "log_prob",
                                                                "value"))
            a, tg = rows(adv), rows(target)
            n = a.shape[0] // 2 if half_batch else a.shape[0]
            obs, action, logp, value, a, tg = (t[:n] for t in (obs, action, logp, value, a, tg))
            grads, terms = _block_grads(params, r, obs, action, logp, value, a, tg,
                                        matmul_dtype, row_block)
            params = opt.step(params, grads)
            losses.append(terms)
    return params, torch.stack(losses)


def _block_grads(params, r, obs, action, logp, value, adv, target, matmul_dtype, row_block):
    """The minibatch's loss terms and gradients, the loss's means taken over
    all its rows but the activations held a block of rows at a time: the
    advantage statistics first, then each block's share of every mean."""
    n = adv.shape[0]
    mean = adv.mean()
    std = adv.std(correction=0)
    adv_n = (adv - mean) / (std + 1e-8)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    terms = torch.zeros(5, dtype=torch.float64, device=adv.device)
    for s in range(0, n, row_block):
        e = min(n, s + row_block)
        with torch.enable_grad():
            logits, v = forward(leaves, obs[s:e], matmul_dtype)
            log_probs = torch.log_softmax(logits, dim=-1)
            lp = log_probs.gather(1, action[s:e].long()[:, None])[:, 0]
            ratio = torch.exp(lp - logp[s:e])
            a = adv_n[s:e]
            policy = -torch.minimum(ratio * a, torch.clamp(ratio, 1 - r.clip_eps,
                                                           1 + r.clip_eps) * a).sum() / n
            clipped = value[s:e] + torch.clamp(v - value[s:e], -r.clip_eps, r.clip_eps)
            vloss = 0.5 * torch.maximum((v - target[s:e]) ** 2,
                                        (clipped - target[s:e]) ** 2).sum() / n
            entropy = -(torch.exp(log_probs) * log_probs).sum(-1).sum() / n
            total = policy + r.value_coef * vloss - r.entropy_coef * entropy
            kl = ((ratio - 1) - torch.log(ratio)).sum() / n
            g = torch.autograd.grad(total, list(leaves.values()))
        for k, gk in zip(leaves, g):
            grads[k] += gk
        terms += torch.stack([total, policy, vloss, entropy, kl]).detach().double()
    return grads, terms.float()


def forward_fm(params: Params, x_fm: torch.Tensor, dtype=BF16):
    """Feature-major forward of the rollout's policy step: ``x_fm`` (35, N)
    normalised bf16 -> ``(logits (A, N) f32, value (N,) f32)``, every product
    transposed, the two heads as one (H, A + 1) product; the operands bf16,
    or rounded to ``dtype`` (see :func:`_cast`)."""
    names = layer_names(params)
    w = [_cast(params[f"{n}.kernel"], dtype) for n in names]
    b = [params[f"{n}.bias"].to(BF16) for n in names]
    L = len(names) - 2
    h = x_fm.to(BF16)
    for l in range(L):
        h = torch.tanh(torch.matmul(w[l].t(), _cast(h, dtype)) + b[l][:, None])
    heads = torch.matmul(torch.cat([w[L], w[L + 1]], dim=1).t(), _cast(h, dtype)) + \
        torch.cat([b[L], b[L + 1]])[:, None]
    return heads[:-1].float(), heads[-1].float()


def draw(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling over ``logits (A, N)`` with one uniform a column:
    the number of CDF entries below ``u`` times the column's total."""
    cdf = torch.cumsum(torch.exp(torch.log_softmax(logits, dim=0)), dim=0)
    return (cdf < u * cdf[-1:]).sum(dim=0)


class Followed(NamedTuple):
    """What the reference computed over the updates it followed."""

    losses: List[torch.Tensor]        # per update: the (5,) means of its minibatch terms
    first_terms: torch.Tensor         # the first minibatch's (5,) terms, at the seed's weights
    first_mu: Params                  # Adam's first moment after its first step
    params: Params                    # after the last update
    packed: torch.Tensor              # the env state after the last update
    sample_gaps: List[float]          # per update: the widest gap of an action taken


def follow(env_step, packed: torch.Tensor, params: Params, r: Recipe,
           uniforms: List[torch.Tensor], actions=None, matmul_dtype=BF16,
           half_batch: bool = False) -> Followed:
    """Follow ``len(uniforms)`` self-play updates from the packed env state
    ``packed`` and ``params``.  Each update rolls out ``T`` frames of
    ``env_step(packed, a1, a2) -> (packed, norm_obs_fm, reward, terminated)``
    with the given actions (``actions[k]``: ``(T, 2B)``), reads each action
    against the reference policy's own draw with ``uniforms[k][t]``
    (:func:`sample_gap`), then runs GAE and the update.  ``matmul_dtype``
    rounds the operands of every product, the rollout's and the update's;
    without ``actions`` the follower draws its own at that precision (a
    control in the program's place), still read against the bf16 policy."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the reference's float32 products need TF32 off")
    B = r.num_envs
    opt = Adam(params, r.learning_rate, r.max_grad_norm)
    losses, gaps, first_terms = [], [], None
    obs_raw = raw_obs(packed)
    norm = torch.cat([normalize(obs_raw[:, 0]).t(), normalize(obs_raw[:, 1]).t()],
                     dim=1).to(BF16)
    for k, u_k in enumerate(uniforms):
        T = u_k.shape[0]
        traj = {"obs": torch.empty((T, 2 * B, norm.shape[0]), dtype=BF16, device=norm.device)}
        for key in ("log_prob", "value", "reward", "done"):
            traj[key] = torch.empty((T, 2 * B), dtype=torch.float32, device=norm.device)
        traj["action"] = torch.empty((T, 2 * B), dtype=torch.int64, device=norm.device)
        widest = 0.0
        for t in range(T):
            u = u_k[t].reshape(-1)
            judge, value = forward_fm(params, norm)
            logits = judge
            if matmul_dtype != BF16:
                logits, value = forward_fm(params, norm, matmul_dtype)
            a = draw(logits, u) if actions is None else actions[k][t].long()
            widest = max(widest, float(sample_gap(judge.t(), u, a).max()))
            log_probs = torch.log_softmax(logits, dim=0)
            traj["log_prob"][t] = log_probs.gather(0, a.clamp(0, r.num_actions - 1)[None])[0]
            traj["value"][t] = value
            traj["obs"][t] = norm.t()
            traj["action"][t] = a
            packed, norm, reward, terminated = env_step(packed, a[:B].to(torch.int32),
                                                        a[B:].to(torch.int32))
            done = (terminated == 1).to(torch.float32)
            traj["reward"][t] = reward
            traj["done"][t] = torch.cat([done, done])
        gaps.append(widest)
        _, last_value = forward_fm(params, norm, matmul_dtype)
        adv, target = gae(traj["value"], traj["reward"], traj["done"], last_value,
                          r.gamma, r.gae_lambda)
        params, terms = update(params, opt, r, traj, adv, target, matmul_dtype, half_batch)
        losses.append(terms.mean(0))
        if first_terms is None:
            first_terms = terms[0]
        del traj
    return Followed(losses, first_terms, opt.first_mu, params, packed, gaps)
