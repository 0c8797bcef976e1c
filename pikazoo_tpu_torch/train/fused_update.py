"""The fused clipped-PPO minibatch gradient, feature-major (K1).

Counterpart of ``pikazoo_tpu.train.fused_update.fused_ppo_grads_fm``: the
forward MLP, the clipped-PPO loss, the hand-written backward, the weight and
bias gradients and the four loss sums of one minibatch, with the minibatch in
its ``(T, 2B)`` shape and the observations feature-major ``(T, F, 2B)`` bf16,
as the rollout stores them.

A CUDA minibatch runs the hand-written Hopper kernel ``csrc/fused_update.cu``
(built by ``pikazoo_tpu_torch._build`` at first use); a CPU one runs the
plain PyTorch version, :func:`fused_ppo_grads_fm_plain`.  On CUDA the kernel
launches or the call raises: there is no fallback.

The arithmetic is the TPU kernel's bf16 path: bf16 operands with f32
accumulation in every product; bias add and activation in f32, then one
round to bf16, and only that bf16 activation feeds the next layer and the
activation derivative (``1 - h*h`` on ``float(h_bf16)``); a merged (H, A+1)
head whose row A is the value; ``dheads`` and ``dpre`` rounded to bf16 for
the products while the bias gradients sum their f32 values; f32 loss sums.
The int8 / int8fwd quantised modes and the bf16 backward chain of the JAX
kernel are not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.train.networks import BF16, Params, dense_layers

SOURCES = ("fused_update.cu",)
COLS = 64        # env columns per tile of the kernel (csrc/fused_update.cu)
HEAD_PAD = 32    # the merged head's A+1 rows, padded
MAX_LAYERS = 4   # hidden layers the kernel takes
MAX_WIDTH = 256  # widest hidden layer the kernel takes
PLAIN_COLS = 16384  # columns per chunk of the plain version


def _loss_vector(sums: torch.Tensor, inv_m: float, value_coef: float,
                 entropy_coef: float) -> torch.Tensor:
    """[policy, value, entropy, kl] sums -> [total, policy, value, entropy,
    approx_kl] means, as the JAX wrapper forms them."""
    policy, value, entropy, kl = (sums * inv_m).unbind()
    total = policy + value_coef * value - entropy_coef * entropy
    return torch.stack([total, policy, value, entropy, kl])


def _grads_dict(names, dw, db, dwpv, dbpv, num_actions: int) -> Dict[str, torch.Tensor]:
    """Hidden grads plus the merged head's (H, A+1) / (A+1,) grads -> a dict
    keyed like the params, the head split back into policy and value."""
    grads = {}
    for name, w, b in zip(names, dw, db):
        grads[f"{name}.kernel"], grads[f"{name}.bias"] = w, b
    grads[f"{names[-2]}.kernel"] = dwpv[:, :num_actions]
    grads[f"{names[-2]}.bias"] = dbpv[:num_actions]
    grads[f"{names[-1]}.kernel"] = dwpv[:, num_actions:num_actions + 1]
    grads[f"{names[-1]}.bias"] = dbpv[num_actions:num_actions + 1]
    return grads


def fused_ppo_grads_fm_plain(params: Params, obs: torch.Tensor,
                             action: torch.Tensor, logp_old: torch.Tensor,
                             value_old: torch.Tensor, adv_norm: torch.Tensor,
                             target: torch.Tensor, *, num_actions: int,
                             activation: str, clip_eps: float,
                             value_coef: float, entropy_coef: float,
                             total_rows: int = 0
                             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The plain PyTorch version of :func:`fused_ppo_grads_fm`, on any
    device: the same casts and the same hand-written backward, transcribed
    from ``_fm_kernel``.  Products run in float32 on bf16-valued operands
    (exact products, f32 sums).  It walks the minibatch a frame and
    ``PLAIN_COLS`` columns at a time, so it fits on the card at full width."""
    names, L, w, b = dense_layers(params)
    f32 = torch.float32
    t_mb, n = action.shape
    inv_m = 1.0 / (total_rows or t_mb * n)
    A = num_actions
    wf = [x.to(BF16).float() for x in w[:L]]
    bf = [x.float() for x in b[:L]]
    wpv = torch.cat([w[L], w[L + 1]], dim=1).to(BF16).float()   # (H, A+1)
    bpv = torch.cat([b[L], b[L + 1]]).float()                   # (A+1,)
    rows = torch.arange(A, device=obs.device)[:, None]

    def dact(h):
        return (h > 0).to(f32) if activation == "relu" else 1.0 - h * h

    dw = [torch.zeros_like(x) for x in wf]
    db = [torch.zeros_like(x) for x in bf]
    dwpv = torch.zeros_like(wpv)
    dbpv = torch.zeros_like(bpv)
    sums = torch.zeros(4, dtype=f32, device=obs.device)
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            x = obs[t, :, cols].float()
            hs = []
            h = x
            for l in range(L):
                pre = torch.matmul(wf[l].t(), h) + bf[l][:, None]
                h = (torch.relu(pre) if activation == "relu"
                     else torch.tanh(pre)).to(BF16).float()
                hs.append(h)
            heads = torch.matmul(wpv.t(), h) + bpv[:, None]       # (A+1, C)
            logits, value = heads[:A], heads[A]
            m = logits.amax(dim=0)
            ex = torch.exp(logits - m)
            sumex = ex.sum(dim=0)
            logp_all = logits - (torch.log(sumex) + m)
            p = ex / sumex
            onehot = (rows == action[t, cols]).to(f32)
            lp_new = (logp_all * onehot).sum(dim=0)

            lpo, adv = logp_old[t, cols], adv_norm[t, cols]
            vold, tgt = value_old[t, cols], target[t, cols]
            ratio = torch.exp(lp_new - lpo)
            unclipped = ratio * adv
            clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
            entropy_row = -(p * logp_all).sum(dim=0)
            vclip = vold + torch.clamp(value - vold, -clip_eps, clip_eps)
            e1 = value - tgt
            e2 = vclip - tgt
            sums += torch.stack([
                -torch.minimum(unclipped, clipped).sum(),
                0.5 * torch.maximum(e1 * e1, e2 * e2).sum(),
                entropy_row.sum(),
                ((ratio - 1.0) - torch.log(ratio)).sum()])

            inside_r = ((ratio > 1.0 - clip_eps) & (ratio < 1.0 + clip_eps)).to(f32)
            dmin = torch.where(unclipped <= clipped, adv, adv * inside_r)
            dlp = -inv_m * dmin * ratio
            dlogits = (dlp * (onehot - p)
                       + (entropy_coef * inv_m) * p * (logp_all + entropy_row))
            inside_v = ((value - vold > -clip_eps) & (value - vold < clip_eps)).to(f32)
            dvalue = (value_coef * inv_m) * torch.where(e1 * e1 >= e2 * e2, e1,
                                                        e2 * inside_v)
            dheads = torch.cat([dlogits, dvalue[None]])              # (A+1, C)
            dheads_b = dheads.to(BF16).float()
            dwpv += torch.matmul(hs[-1], dheads_b.t())
            dbpv += dheads.sum(dim=1)
            dh = torch.matmul(wpv, dheads_b)                         # (H, C)
            for l in range(L - 1, -1, -1):
                dpre = dh * dact(hs[l])
                dpre_b = dpre.to(BF16).float()
                below = hs[l - 1] if l > 0 else x
                dw[l] += torch.matmul(below, dpre_b.t())
                db[l] += dpre.sum(dim=1)
                if l > 0:
                    dh = torch.matmul(wf[l], dpre_b)
    grads = _grads_dict(names, dw, db, dwpv, dbpv, A)
    return grads, _loss_vector(sums, inv_m, value_coef, entropy_coef)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_update", SOURCES)
    fn = lib.fused_ppo_grads_fm_launch
    fn.argtypes = ([ctypes.c_void_p] * 6            # obs and the 5 scalars
                   + [ctypes.c_void_p] * 2          # weight and bias pointer arrays
                   + [ctypes.c_void_p]              # hidden widths
                   + [ctypes.c_int] * 7             # L, F, Fp, A, relu, T, N
                   + [ctypes.c_float] * 4           # clip, -inv_m, ent, val scales
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # partial, G, stride
                   + [ctypes.c_void_p, ctypes.c_void_p])            # out, stream
    fn.restype = ctypes.c_int
    return lib


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _check(obs, scalars, action) -> torch.device:
    device = obs.device
    if obs.dim() != 3 or obs.dtype != BF16:
        raise ValueError(f"obs must be (T, F, N) bf16, got {tuple(obs.shape)} {obs.dtype}")
    t_mb, _, n = obs.shape
    if action.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"action must be int32 or int64, got {action.dtype}")
    for x in (action, *scalars):
        if x.shape != (t_mb, n):
            raise ValueError(f"per-row inputs must be ({t_mb}, {n}), got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"inputs lie on {device} and {x.device}")
    for x in scalars:
        if x.dtype != torch.float32:
            raise TypeError(f"per-row float inputs must be float32, got {x.dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ppo_grads_fm has no version for {device}")
    return device


def _launch(params: Params, obs, action, logp_old, value_old, adv_norm, target,
            num_actions: int, activation: str, clip_eps: float,
            value_coef: float, entropy_coef: float, inv_m: float):
    """Pad the weights to the kernel's tiles, launch, and unpack the reduced
    sums into a grads dict and the loss vector."""
    names, L, w, b = dense_layers(params)
    t_mb, f, n = obs.shape
    hidden = [x.shape[1] for x in w[:L]]
    A = num_actions
    if not 1 <= L <= MAX_LAYERS or any(h % 16 or h > MAX_WIDTH for h in hidden):
        raise ValueError(f"the kernel takes 1-{MAX_LAYERS} hidden layers of multiples "
                         f"of 16 up to {MAX_WIDTH} wide, got {hidden}")
    if A + 1 > HEAD_PAD or w[L].shape[1] != A:
        raise ValueError(f"the kernel takes up to {HEAD_PAD - 1} actions; the "
                         f"policy head has {w[L].shape[1]}, num_actions is {A}")
    if activation not in ("tanh", "relu"):
        raise ValueError(f"unknown activation {activation!r}")
    device = obs.device
    fp = _round16(f)
    h_top = hidden[-1]
    w0 = torch.zeros((fp, hidden[0]), dtype=BF16, device=device)
    w0[:f] = w[0].to(BF16)
    wpv = torch.zeros((h_top, HEAD_PAD), dtype=BF16, device=device)
    wpv[:, :A + 1] = torch.cat([w[L], w[L + 1]], dim=1).to(BF16)
    bpv = torch.zeros(HEAD_PAD, dtype=torch.float32, device=device)
    bpv[:A + 1] = torch.cat([b[L], b[L + 1]]).float()
    weights = [w0] + [x.to(BF16).contiguous() for x in w[1:L]] + [wpv]
    biases = [x.float().contiguous() for x in b[:L]] + [bpv]

    # Per block: every dW, then every bias grad, then the 4 loss sums.
    widths = [fp, *hidden]
    n_w = sum(i * o for i, o in zip(widths[:-1], widths[1:])) + h_top * HEAD_PAD
    n_b = sum(hidden) + HEAD_PAD
    stride = -(-(n_w + n_b + 4) // 64) * 64
    tiles = t_mb * -(-n // COLS)
    if tiles == 0:
        raise ValueError(f"empty minibatch: obs is {tuple(obs.shape)}")
    blocks = min(tiles, torch.cuda.get_device_properties(device).multi_processor_count)
    partial = torch.empty((blocks, stride), dtype=torch.float32, device=device)
    out = torch.empty(stride, dtype=torch.float32, device=device)
    act32 = action.to(torch.int32).contiguous()
    scal = [x.contiguous() for x in (logp_old, value_old, adv_norm, target)]
    obs = obs.contiguous()
    w_ptrs = (ctypes.c_void_p * len(weights))(*[x.data_ptr() for x in weights])
    b_ptrs = (ctypes.c_void_p * len(biases))(*[x.data_ptr() for x in biases])
    dims = (ctypes.c_int * L)(*hidden)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().fused_ppo_grads_fm_launch(
            obs.data_ptr(), act32.data_ptr(), *[x.data_ptr() for x in scal],
            ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(b_ptrs, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p), L, f, fp, A,
            int(activation == "relu"), t_mb, n,
            clip_eps, -inv_m, entropy_coef * inv_m, value_coef * inv_m,
            partial.data_ptr(), blocks, stride, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused PPO gradient kernel launch failed: CUDA error {err}")

    dw, pos = [], 0
    for i, o in zip(widths[:-1], widths[1:]):
        dw.append(out[pos:pos + i * o].view(i, o))
        pos += i * o
    dw[0] = dw[0][:f]
    dwpv = out[pos:pos + h_top * HEAD_PAD].view(h_top, HEAD_PAD)
    pos += h_top * HEAD_PAD
    db = []
    for h in hidden:
        db.append(out[pos:pos + h])
        pos += h
    dbpv = out[pos:pos + HEAD_PAD]
    sums = out[pos + HEAD_PAD:pos + HEAD_PAD + 4]
    grads = _grads_dict(names, dw, db, dwpv, dbpv, A)
    return grads, _loss_vector(sums, inv_m, value_coef, entropy_coef)


def fused_ppo_grads_fm(params: Params, obs: torch.Tensor, action: torch.Tensor,
                       logp_old: torch.Tensor, value_old: torch.Tensor,
                       adv_norm: torch.Tensor, target: torch.Tensor, *,
                       num_actions: int, activation: str, clip_eps: float,
                       value_coef: float, entropy_coef: float,
                       total_rows: int = 0
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Clipped-PPO gradient of one minibatch.

    ``params``: the network's parameter dict (``dense_layers`` order);
    ``obs``: (T, F, N) bf16 normalised, feature-major; ``action`` (T, N)
    int; ``logp_old``, ``value_old``, ``adv_norm`` (already normalised by
    the caller), ``target``: (T, N) float32.  Any T and N.  ``total_rows``
    sets the mean's denominator (0: T*N).

    Returns ``(grads, losses)``: f32 grads keyed like ``params`` and
    ``losses = [total, policy, value, entropy, approx_kl]`` (means).  On
    CUDA this launches ``csrc/fused_update.cu`` on the current stream
    without synchronising and adds one to ``fused_ppo_grads_fm.launches``;
    on the CPU it runs :func:`fused_ppo_grads_fm_plain`."""
    scalars = (logp_old, value_old, adv_norm, target)
    device = _check(obs, scalars, action)
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef)
    if device.type == "cpu":
        return fused_ppo_grads_fm_plain(params, obs, action, *scalars,
                                        total_rows=total_rows, **kw)
    t_mb, _, n = obs.shape
    inv_m = 1.0 / (total_rows or t_mb * n)
    result = _launch(params, obs, action, *scalars, inv_m=inv_m, **kw)
    fused_ppo_grads_fm.launches += 1
    return result


fused_ppo_grads_fm.launches = 0
