"""The fused clipped-PPO minibatch gradient: feature-major (K1) and row-major
(K4).

Counterparts of ``pikazoo_tpu.train.fused_update.fused_ppo_grads_fm`` (K1)
and ``fused_ppo_grads`` (K4): the forward MLP, the clipped-PPO loss, the
hand-written backward, the weight and bias gradients and the four loss sums
of one minibatch.  K1 takes the minibatch in its ``(T, 2B)`` shape with the
observations feature-major ``(T, F, 2B)`` bf16, as the rollout stores them;
K4 takes it flattened to rows, observations ``(M, F)`` bf16.

A CUDA minibatch runs hand-written Hopper kernels (for K1
``csrc/fused_update_bf16.cu`` in the bf16 and int8fwd modes, with or without
the bf16 backward chain, and ``csrc/fused_update_int8.cu`` in the int8 mode;
``csrc/k4_split.cu`` for K4; built by ``pikazoo_tpu_torch._build`` at first
use); a CPU one runs the plain PyTorch
version (:func:`fused_ppo_grads_fm_plain`, :func:`fused_ppo_grads_rm_plain`).
On CUDA the kernel launches or the call raises: there is no fallback.

K1's bf16 mode (``quant="none"``): bf16 operands with f32 accumulation in
every product; bias add and activation in f32, then one round to bf16, and
only that bf16 activation feeds the next layer and the activation derivative
(``1 - h*h`` on ``float(h_bf16)``); a merged (H, A+1) head whose row A is the
value; ``dheads`` and ``dpre`` rounded to bf16 for the products while the
bias gradients sum their f32 values; f32 loss sums.  On the card it runs as
two kernels over chunks of whole frames: kernel A (:func:`k1_chain`, plain
version :func:`k1_chain_plain`) walks the columns through the forward, the
loss and the backward chain and writes the dW products' bf16 operands to a
workspace (at hidden (256, 256) ``csrc/k1_wgmma.cuh``'s kernel on wgmma and
TMA, else ``csrc/k1_split.cuh``'s on mma.sync: :func:`chain_design`); kernel
B (:func:`k1_dw`, plain version :func:`k1_dw_plain`) computes each dW from
them as one product over the columns.  Its other
modes, as the JAX kernel's branches:

- ``bwd_bf16=True``: the hidden gradient chain in bf16 arithmetic
  (``dh_b = bf16(dot)``, ``dpre_b = dh_b * (1 - h*h)`` op by op in bf16, bias
  grads the f32 sums of ``dpre_b``), after the bf16 or the int8fwd forward.
  It runs as the bf16 mode's two kernels, kernel A with the bf16 chain in its
  backward epilogue and the head's ``dh`` on the CUDA cores
  (``k1_chain_plain(..., bwd_bf16=True)``).
- ``quant="int8fwd"``: the forward products in int8 (weights quantised per
  tensor from the f32 params, activations with the static scale 127), the
  bf16 of each f32 activation kept for the stock bf16 backward, which uses the
  bf16 weights.  Without ``bwd_bf16`` it runs as the bf16 mode's two kernels,
  kernel A with the int8 forward (``k1_chain_plain(..., quant="int8fwd")``).
- ``quant="int8"``: the forward as ``int8fwd`` but the int8 activations are
  kept; the two head products of the backward stay bf16, the hidden chain
  quantises ``dpre`` with a dynamic max-abs scale per frame and column cell
  (``cell_cols``), and the bias grads sum the un-quantised ``dpre``.  On the
  card it runs on the split design too: kernel A (the int8 forward, the loss,
  the head's backward) and kernel S once a hidden layer (the requantise step:
  a launch boundary is the grid-wide barrier the per-cell scale needs) write
  a workspace (:func:`k1_int8_chain`, plain version
  :func:`k1_int8_chain_plain`); kernel Q computes each hidden dW from it on
  int8 tensor cores, exact per cell, and the head's dW is kernel B of the
  bf16 mode (:func:`k1_int8_dw`, plain version :func:`k1_int8_dw_plain`).

K4 differs from K1's bf16 mode in three places: the activation derivative is
taken from the f32 activation, the policy and value heads are two products
(``dh`` is their f32 sum), and rows are tiled instead of frames x columns.
On the card it runs as K1 bf16's two kernels over chunks of rows, each chunk
one frame of columns: its own kernel A (:func:`k4_chain`, plain version
:func:`k4_chain_plain`) and K1's kernel B (:func:`k4_dw`, plain version
:func:`k1_dw_plain` on the rows transposed).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.train.networks import BF16, Params, dense_layers

SOURCES_BF16 = ("fused_update_bf16.cu",)
SOURCES_K4 = ("k4_split.cu",)
SOURCES_INT8 = ("fused_update_int8.cu",)
COLS = 64        # env columns per tile of K1's and K4's chain kernels
DW_TILE = 128    # output rows and columns of a tile of K1 bf16's dW kernel
# Workspace columns of one chunk of K1's bf16 mode (whole frames, at least
# one): ~277 MB at hidden (256, 256).
CHUNK_COLS = 131072
DW_BLOCKS_PER_SM = 2  # resident blocks of K1 bf16's dW kernel (110 KB of shared memory each)
Q_TILE_COLS = 64  # output columns of a tile of K1 int8's dW kernel (DW_TILE rows)
HEAD_PAD = 32    # K1's merged head: A+1 rows, padded
HEAD_SPLIT = 48  # K4's head: the policy rows padded to 32, then the value row
VALUE_ROW = 32
A_COMPUTE_THREADS = 512  # threads of a chain kernel that compute (K4 keeps f32 activations for each)
MAX_LAYERS = 4   # hidden layers the kernels take
MAX_WIDTH = 256  # widest hidden layer the kernels take
# K1 bf16's wgmma kernel A (chain_design): two hidden layers of this width,
# at most this many padded features.
WGMMA_WIDTH = 256
WGMMA_FEATURES = 48
PLAIN_COLS = 16384  # columns (rows for K4) per chunk of the plain versions
QUANT_MODES = ("none", "int8", "int8fwd")
CELL_COLS = 1024    # the widest column cell of the int8 mode's dynamic scale
S_IN = 1.0 / 127.0  # the static dequant scale of int8 activations
# The widest int8 cell whose integer-valued f32 products are exact:
# 1024 * 127**2 < 2**24.  Wider cells take their dW products in float64.
EXACT_F32_CELL = 1024
# The widest int8 cell whose dW products the kernel sums exactly in int32:
# 133144 * 127**2 < 2**31.
INT8_MAX_CELL = 133144


def _loss_vector(sums: torch.Tensor, inv_m: float, value_coef: float,
                 entropy_coef: float) -> torch.Tensor:
    """[policy, value, entropy, kl] sums -> [total, policy, value, entropy,
    approx_kl] means, as the JAX wrapper forms them."""
    policy, value, entropy, kl = (sums * inv_m).unbind()
    total = policy + value_coef * value - entropy_coef * entropy
    return torch.stack([total, policy, value, entropy, kl])


def _grads_dict(names, dw, db, dwp, dbp, dwv, dbv) -> Dict[str, torch.Tensor]:
    """Hidden grads plus the policy and value heads' -> a dict keyed like
    the params."""
    grads = {}
    for name, w, b in zip(names, dw, db):
        grads[f"{name}.kernel"], grads[f"{name}.bias"] = w, b
    grads[f"{names[-2]}.kernel"], grads[f"{names[-2]}.bias"] = dwp, dbp
    grads[f"{names[-1]}.kernel"], grads[f"{names[-1]}.bias"] = dwv, dbv
    return grads


def _merged_grads(names, dw, db, dwpv, dbpv, num_actions: int):
    """The merged head's (H, A+1) / (A+1,) grads split back into the policy
    and value heads."""
    A = num_actions
    return _grads_dict(names, dw, db, dwpv[:, :A], dbpv[:A],
                       dwpv[:, A:A + 1], dbpv[A:A + 1])


def pick_tile(n: int, want: int, floor: int = 8) -> int:
    """The JAX wrapper's ``_pick_tile``: halve ``want`` down to ``floor``
    until it divides ``n``; ``n`` itself when none does."""
    t = want
    while t > floor and n % t != 0:
        t //= 2
    return t if n % t == 0 else n


def cell_cols(n: int) -> int:
    """Columns of one cell of the int8 mode's dynamic scale for ``n``
    columns, as the JAX kernel's grid cuts them: 1024 at the learner's
    width, the whole ``n`` when ``n`` is not a multiple of 128."""
    return pick_tile(n, CELL_COLS, floor=128)


def check_mode(quant: str, activation: str, num_layers: int) -> None:
    """The JAX wrapper's checks of the precision mode."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}")
    if quant != "none" and activation != "tanh":
        raise ValueError("int8 quant requires activation='tanh' (the static "
                         "forward scale assumes [-1, 1] outputs)")
    if quant != "none" and num_layers + 1 > 8:
        raise ValueError(f"int8 quant supports at most 7 hidden layers "
                         f"({num_layers} given)")


def mode_name(quant: str, bwd_bf16: bool) -> str:
    """The key of ``fused_ppo_grads_fm.launches_by_mode``: the int8 mode has
    its own backward, so ``bwd_bf16`` names a mode only beside the others."""
    if quant == "int8" or not bwd_bf16:
        return quant
    return "bwd_bf16" if quant == "none" else f"{quant}+bwd_bf16"


def quantize_weights(w: List[torch.Tensor], num_layers: int):
    """Per-tensor symmetric int8 of the hidden kernels and of the merged
    (H, A+1) head, from the f32 params (not their bf16 casts):
    ``(int8 tensors, scales (L+1,) f32)`` with ``w ~ q * scale``."""
    L = num_layers

    def qw(t):
        t = t.float()
        s = torch.clamp(t.abs().max(), min=1e-30) / 127.0
        return torch.round(t / s).to(torch.int8), s

    wpv = torch.cat([w[L].float(), w[L + 1].float()], dim=1)
    qs = [qw(t) for t in [*w[:L], wpv]]
    return [q for q, _ in qs], torch.stack([s for _, s in qs])


def _q127(v: torch.Tensor) -> torch.Tensor:
    """int8 of a [-1, 1] value with the static scale 127, round half to even,
    as an integer-valued float32."""
    return torch.clamp(torch.round(v * 127.0), -127.0, 127.0)


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.relu(x) if activation == "relu" else torch.tanh(x)


def _dact(h: torch.Tensor, activation: str) -> torch.Tensor:
    """The derivative through the post-activation value, in ``h``'s type."""
    return (h > 0).to(h.dtype) if activation == "relu" else 1.0 - h * h


def _loss_and_dheads(logits, value, action, lpo, adv, vold, tgt, *, inv_m,
                     clip_eps, value_coef, entropy_coef):
    """The clipped-PPO loss of a chunk of columns, feature-major: logits
    (A, C), value / per-row inputs (C,).  Returns (the 4 loss sums,
    dlogits (A, C), dvalue (C,)), the JAX kernels' formulas."""
    f32 = torch.float32
    rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
    m = logits.amax(dim=0)
    ex = torch.exp(logits - m)
    sumex = ex.sum(dim=0)
    logp_all = logits - (torch.log(sumex) + m)
    p = ex / sumex
    onehot = (rows == action).to(f32)
    lp_new = (logp_all * onehot).sum(dim=0)
    ratio = torch.exp(lp_new - lpo)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    entropy_row = -(p * logp_all).sum(dim=0)
    vclip = vold + torch.clamp(value - vold, -clip_eps, clip_eps)
    e1 = value - tgt
    e2 = vclip - tgt
    sums = torch.stack([
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
    return sums, dlogits, dvalue


def _cell_dot(below: torch.Tensor, dp_q: torch.Tensor, scale: torch.Tensor,
              cell: int) -> torch.Tensor:
    """sum over cells j of float(below_j . dp_q_j^T) * scale[j]: the int8
    mode's dW, one exact integer product per cell (below (K, C_chunk),
    dp_q (H, C_chunk) integer-valued, C_chunk a multiple of ``cell``)."""
    k, n = below.shape
    dt = torch.float32 if cell <= EXACT_F32_CELL else torch.float64
    b = below.to(dt).reshape(k, n // cell, cell).transpose(0, 1)
    d = dp_q.to(dt).reshape(dp_q.shape[0], n // cell, cell).permute(1, 2, 0)
    prod = torch.bmm(b, d).float()                          # (cells, K, H)
    return (prod * scale[:, None, None]).sum(dim=0)


def _dpre_chain(dh: torch.Tensor, hs, wf, activation: str, bwd_bf16: bool = False):
    """The backward down the hidden layers from the head's f32 ``dh``:
    yields ``(l, dpre, dpre_b)`` for l = L-1 .. 0, with ``dpre = dh *
    act'(h_l)`` in f32, ``dpre_b`` its bf16 and ``dh_{l-1} = W_l . dpre_b``.
    With ``bwd_bf16`` the chain runs in bf16 arithmetic, op by op: ``dh_b =
    bf16(dh)``, ``dpre_b = dh_b * act'(bf16(h_l))`` with each op rounded to
    bf16, and ``dpre`` is ``dpre_b`` (the bias grads sum the rounded
    values)."""
    for l in range(len(hs) - 1, -1, -1):
        if bwd_bf16:
            dpre = dpre_b = (dh.to(BF16) * _dact(hs[l].to(BF16), activation)).float()
        else:
            dpre = dh * _dact(hs[l], activation)
            dpre_b = dpre.to(BF16).float()
        yield l, dpre, dpre_b
        if l > 0:
            dh = torch.matmul(wf[l], dpre_b)


def _forward_bf16(x, wf, bf, wpv, bpv, activation: str):
    """The bf16 forward of a chunk of columns x (F, C): returns (hs, the
    bf16(h_l) as f32; heads (A+1, C))."""
    hs, h = [], x
    for l in range(len(wf)):
        h = _act(torch.matmul(wf[l].t(), h) + bf[l][:, None], activation).to(BF16).float()
        hs.append(h)
    return hs, torch.matmul(wpv.t(), h) + bpv[:, None]


def _forward_int8fwd(x, wq, sw, bf, bpv, activation: str):
    """The int8fwd forward of a chunk of columns x (F, C): int8 products,
    the weight scale riding the bias add.  Returns (hs, each bf16(h_f) of
    the f32 activation as f32, which the stock bf16 backward takes, not the
    dequantised h_q; heads (A+1, C))."""
    hs, h_q = [], _q127(x)
    for l in range(len(bf)):
        h_f = _act(torch.matmul(wq[l].t(), h_q) * (sw[l] * S_IN) + bf[l][:, None], activation)
        h_q = _q127(h_f)
        hs.append(h_f.to(BF16).float())
    return hs, torch.matmul(wq[-1].t(), h_q) * (sw[-1] * S_IN) + bpv[:, None]


def _plain_net(w, b, L: int, quant: str, activation: str):
    """K1's weights as its plain versions take them: (the hidden kernels'
    bf16 as f32, the hidden biases, the merged (H, A+1) head's bf16 as f32,
    its (A+1,) bias, the forward of a chunk of columns in mode ``quant``)."""
    wf = [x.to(BF16).float() for x in w[:L]]
    bf = [x.float() for x in b[:L]]
    wpv = torch.cat([w[L], w[L + 1]], dim=1).to(BF16).float()   # (H, A+1)
    bpv = torch.cat([b[L], b[L + 1]]).float()                   # (A+1,)
    if quant == "int8fwd":
        wq, sw = quantize_weights(w, L)
        forward = functools.partial(_forward_int8fwd, wq=[q.float() for q in wq], sw=sw,
                                    bf=bf, bpv=bpv, activation=activation)
    else:
        forward = functools.partial(_forward_bf16, wf=wf, bf=bf, wpv=wpv, bpv=bpv,
                                    activation=activation)
    return wf, bf, wpv, bpv, forward


class K1Chain(NamedTuple):
    """What K1's bf16 and int8fwd modes (with or without the bf16 backward
    chain) and K4 compute before their dW products (kernel A of
    ``csrc/fused_update_bf16.cu`` and of ``csrc/k4_split.cu``): the
    products' operands at the function's rounding points, each (rows, T, N)
    bf16 (K4: T = 1, N = M rows), and the f32 sums.  ``hs[l]`` is bf16(h_l),
    ``dheads`` bf16(dheads) (A+1 rows: the logits', then the value's),
    ``dpres[l]`` bf16(dpre_l); ``db[l]`` and ``dbpv`` are the f32 row sums of
    the unrounded f32 ``dpre_l`` (with ``bwd_bf16``: of the bf16 ``dpre_b``
    that the chain computes) and of the f32 ``dheads``; ``sums`` the 4 loss
    sums."""
    hs: List[torch.Tensor]
    dheads: torch.Tensor
    dpres: List[torch.Tensor]
    db: List[torch.Tensor]
    dbpv: torch.Tensor
    sums: torch.Tensor


def k1_chain_plain(params: Params, obs: torch.Tensor, action: torch.Tensor,
                   logp_old: torch.Tensor, value_old: torch.Tensor,
                   adv_norm: torch.Tensor, target: torch.Tensor, *,
                   num_actions: int, activation: str, clip_eps: float,
                   value_coef: float, entropy_coef: float,
                   total_rows: int = 0, quant: str = "none",
                   bwd_bf16: bool = False) -> K1Chain:
    """The plain version of kernel A of K1's bf16 mode (``quant="none"``) or
    int8fwd mode (``quant="int8fwd"``: the int8 forward, then the same
    backward on the bf16 weights), on any device: the forward, the loss and
    ``dheads``, and the backward chain down to ``dpre_0`` (with ``bwd_bf16``
    in bf16 arithmetic, :func:`_dpre_chain`), a frame and ``PLAIN_COLS``
    columns at a time."""
    _, L, w, b = dense_layers(params)
    if quant not in ("none", "int8fwd"):
        raise ValueError(f"kernel A runs quant 'none' or 'int8fwd', not {quant!r}")
    check_mode(quant, activation, L)
    t_mb, _, n = obs.shape
    inv_m = 1.0 / (total_rows or t_mb * n)
    A = num_actions
    wf, bf, wpv, bpv, forward = _plain_net(w, b, L, quant, activation)
    loss_kw = dict(inv_m=inv_m, clip_eps=clip_eps, value_coef=value_coef,
                   entropy_coef=entropy_coef)
    new = lambda rows: torch.empty((rows, t_mb, n), dtype=BF16, device=obs.device)
    hs_out = [new(x.shape[1]) for x in wf]
    dpres_out = [new(x.shape[1]) for x in wf]
    dheads_out = new(A + 1)
    db = [torch.zeros_like(x) for x in bf]
    dbpv = torch.zeros_like(bpv)
    sums = torch.zeros(4, dtype=torch.float32, device=obs.device)
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            hs, heads = forward(obs[t, :, cols].float())        # heads (A+1, C)
            for l in range(L):
                hs_out[l][:, t, cols] = hs[l]
            chunk_sums, dlogits, dvalue = _loss_and_dheads(
                heads[:A], heads[A], action[t, cols], logp_old[t, cols],
                adv_norm[t, cols], value_old[t, cols], target[t, cols], **loss_kw)
            sums += chunk_sums
            dheads = torch.cat([dlogits, dvalue[None]])          # (A+1, C)
            dheads_b = dheads.to(BF16).float()
            dheads_out[:, t, cols] = dheads_b
            dbpv += dheads.sum(dim=1)
            for l, dpre, dpre_b in _dpre_chain(torch.matmul(wpv, dheads_b), hs, wf,
                                               activation, bwd_bf16):
                dpres_out[l][:, t, cols] = dpre_b
                db[l] += dpre.sum(dim=1)
    return K1Chain(hs_out, dheads_out, dpres_out, db, dbpv, sums)


def k1_dw_plain(chain: K1Chain, obs: torch.Tensor):
    """The plain version of kernel B of K1's bf16 mode: every dW as a sum
    over the columns of exact products of bf16 operands in f32, ``dW_l =
    below_l . bf16(dpre_l)^T`` (``below_0`` the observations) and ``dWpv =
    bf16(h_top) . bf16(dheads)^T``, a frame and ``PLAIN_COLS`` columns at a
    time.  Returns (dW list, dWpv (H, A+1))."""
    t_mb, f, n = obs.shape
    hidden = [h.shape[0] for h in chain.hs]
    dw = [torch.zeros((k, h), device=obs.device) for k, h in zip([f, *hidden[:-1]], hidden)]
    dwpv = torch.zeros((hidden[-1], chain.dheads.shape[0]), device=obs.device)
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            hs = [h[:, t, cols].float() for h in chain.hs]
            dwpv += torch.matmul(hs[-1], chain.dheads[:, t, cols].float().t())
            for l in range(len(hs) - 1, -1, -1):
                below = hs[l - 1] if l > 0 else obs[t, :, cols].float()
                dw[l] += torch.matmul(below, chain.dpres[l][:, t, cols].float().t())
    return dw, dwpv


def _plain_bf16(params: Params, obs, action, logp_old, value_old, adv_norm, target, *,
                num_actions: int, total_rows: int, **kw):
    """K1's bf16 or int8fwd mode (``kw["quant"]``, with or without
    ``kw["bwd_bf16"]``) as its two kernels compute it: the chain, then the dW
    products, a frame at a time."""
    names, L, _, _ = dense_layers(params)
    total_rows = total_rows or obs.shape[0] * obs.shape[2]
    total = None   # every dW, every bias grad, dWpv, dbpv, the loss sums
    for t in range(obs.shape[0]):
        frame = [x[t:t + 1] for x in (obs, action, logp_old, value_old, adv_norm, target)]
        chain = k1_chain_plain(params, *frame, num_actions=num_actions,
                               total_rows=total_rows, **kw)
        dw, dwpv = k1_dw_plain(chain, frame[0])
        parts = [*dw, *chain.db, dwpv, chain.dbpv, chain.sums]
        total = parts if total is None else [a + b for a, b in zip(total, parts)]
    dw, db, (dwpv, dbpv, sums) = total[:L], total[L:2 * L], total[2 * L:]
    grads = _merged_grads(names, dw, db, dwpv, dbpv, num_actions)
    return grads, _loss_vector(sums, 1.0 / total_rows, kw["value_coef"], kw["entropy_coef"])


class K1Int8Chain(NamedTuple):
    """What K1's int8 mode computes before its dW products (kernels A and S
    of ``csrc/fused_update_int8.cu``), each operand (rows, T, N) at the
    function's rounding points: ``x_q`` and ``hs[l]`` (h_q_l) the int8
    activations, ``h_top`` bf16(h_q_top * bf16(1/127)) and ``dheads``
    bf16(dheads) the head dW's bf16 operands, ``dpres[l]`` the f32 dpre_l
    that the dynamic scale quantises, ``dp_q[l]`` its int8; ``cellmax`` (L, T,
    cells) the max |dpre_l| of each frame and column cell; ``db[l]`` and
    ``dbpv`` the f32 row sums of dpre_l and of the f32 dheads; ``sums`` the 4
    loss sums."""
    x_q: torch.Tensor
    hs: List[torch.Tensor]
    h_top: torch.Tensor
    dheads: torch.Tensor
    dpres: List[torch.Tensor]
    dp_q: List[torch.Tensor]
    cellmax: torch.Tensor
    db: List[torch.Tensor]
    dbpv: torch.Tensor
    sums: torch.Tensor


def _cell_chunk(n: int) -> int:
    """Columns a chunk of the int8 plain versions: whole cells, about
    PLAIN_COLS."""
    cell = cell_cols(n)
    return cell * max(1, PLAIN_COLS // cell)


def k1_int8_chain_plain(params: Params, obs: torch.Tensor, action: torch.Tensor,
                        logp_old: torch.Tensor, value_old: torch.Tensor,
                        adv_norm: torch.Tensor, target: torch.Tensor, *,
                        num_actions: int, activation: str, clip_eps: float,
                        value_coef: float, entropy_coef: float,
                        total_rows: int = 0) -> K1Int8Chain:
    """The plain version of kernels A and S of K1's int8 mode, on any device:
    the int8 forward, the loss and ``dheads``, the head's bf16 backward and
    the int8 hidden chain down to ``dp_q_0``, a frame and whole cells at a
    time (the JAX kernel's ``quant == "full"`` branch)."""
    _, L, w, b = dense_layers(params)
    check_mode("int8", activation, L)
    t_mb, f, n = obs.shape
    device = obs.device
    inv_m = 1.0 / (total_rows or t_mb * n)
    A = num_actions
    bf = [x.float() for x in b[:L]]
    bpv = torch.cat([b[L], b[L + 1]]).float()                   # (A+1,)
    wq, sw = quantize_weights(w, L)
    wq = [q.float() for q in wq]                                # integer-valued
    hidden = [x.shape[1] for x in w[:L]]
    cell, chunk = cell_cols(n), _cell_chunk(n)
    loss_kw = dict(inv_m=inv_m, clip_eps=clip_eps, value_coef=value_coef,
                   entropy_coef=entropy_coef)
    s_in_b = torch.tensor(S_IN, dtype=BF16, device=device)
    new = lambda rows, dt: torch.empty((rows, t_mb, n), dtype=dt, device=device)
    i8 = torch.int8
    x_q_out = new(f, i8)
    hs_out, dpq_out = [new(h, i8) for h in hidden], [new(h, i8) for h in hidden]
    dpres_out = [new(h, torch.float32) for h in hidden]
    h_top_out, dheads_out = new(hidden[-1], BF16), new(A + 1, BF16)
    cellmax = torch.zeros((L, t_mb, n // cell), dtype=torch.float32, device=device)
    db = [torch.zeros_like(x) for x in bf]
    dbpv = torch.zeros_like(bpv)
    sums = torch.zeros(4, dtype=torch.float32, device=device)
    for t in range(t_mb):
        for c0 in range(0, n, chunk):
            cols = slice(c0, min(n, c0 + chunk))
            cells = slice(c0 // cell, cols.stop // cell)
            # The forward: the weight scale rides the bias add.
            x_q = h_q = _q127(obs[t, :, cols].float())
            x_q_out[:, t, cols] = x_q.to(i8)
            hs = []
            for l in range(L):
                pre = torch.matmul(wq[l].t(), h_q) * (sw[l] * S_IN) + bf[l][:, None]
                h_q = _q127(_act(pre, activation))
                hs.append(h_q)
                hs_out[l][:, t, cols] = h_q.to(i8)
            heads = torch.matmul(wq[L].t(), h_q) * (sw[L] * S_IN) + bpv[:, None]
            chunk_sums, dlogits, dvalue = _loss_and_dheads(
                heads[:A], heads[A], action[t, cols], logp_old[t, cols],
                adv_norm[t, cols], value_old[t, cols], target[t, cols], **loss_kw)
            sums += chunk_sums
            dheads = torch.cat([dlogits, dvalue[None]])          # (A+1, C)
            dheads_b = dheads.to(BF16).float()
            dheads_out[:, t, cols] = dheads_b
            dbpv += dheads.sum(dim=1)
            # The head products stay bf16; the hidden chain quantises dpre
            # per (frame, cell) with a dynamic max-abs scale.
            h_top_out[:, t, cols] = hs[-1].to(BF16) * s_in_b
            dh = torch.matmul(wq[L], dheads_b) * sw[L]           # (H, C)
            ncell = dh.shape[1] // cell
            for l in range(L - 1, -1, -1):
                dpre = dh * _dact(hs[l] * S_IN, activation)
                amax = dpre.abs().reshape(-1, ncell, cell).amax(dim=(0, 2))
                sa = torch.clamp(amax, min=1e-30)                # (cells,)
                dp_q = torch.round(dpre * (127.0 / sa).repeat_interleave(cell))
                cellmax[l, t, cells] = amax
                dpres_out[l][:, t, cols] = dpre
                dpq_out[l][:, t, cols] = dp_q.to(i8)
                db[l] += dpre.sum(dim=1)
                if l > 0:
                    k_dp = sa * S_IN
                    dh = torch.matmul(wq[l], dp_q) * (sw[l] * k_dp).repeat_interleave(cell)
    return K1Int8Chain(x_q_out, hs_out, h_top_out, dheads_out, dpres_out, dpq_out, cellmax,
                       db, dbpv, sums)


def k1_int8_dw_plain(chain: K1Int8Chain):
    """The plain version of K1 int8's dW products (kernel Q and the head's
    bf16 product): ``dW_l = sum over cells of float(below_q . dp_q_l^T) *
    (sa/127 * 1/127)`` (``below_0`` = x_q), each cell's sum exact
    (``_cell_dot``), and ``dWpv = bf16(h_top) . bf16(dheads)^T``, a frame and
    whole cells at a time.  Returns (dW list, dWpv (H, A+1))."""
    f, t_mb, n = chain.x_q.shape
    device = chain.x_q.device
    hidden = [h.shape[0] for h in chain.hs]
    cell, chunk = cell_cols(n), _cell_chunk(n)
    dw = [torch.zeros((k, h), device=device) for k, h in zip([f, *hidden[:-1]], hidden)]
    dwpv = torch.zeros((hidden[-1], chain.dheads.shape[0]), device=device)
    for t in range(t_mb):
        for c0 in range(0, n, chunk):
            cols = slice(c0, min(n, c0 + chunk))
            cells = slice(c0 // cell, cols.stop // cell)
            dwpv += torch.matmul(chain.h_top[:, t, cols].float(),
                                 chain.dheads[:, t, cols].float().t())
            scale = torch.clamp(chain.cellmax[:, t, cells], min=1e-30) * S_IN * S_IN
            for l in range(len(hidden) - 1, -1, -1):
                below = chain.hs[l - 1] if l > 0 else chain.x_q
                dw[l] += _cell_dot(below[:, t, cols].float(), chain.dp_q[l][:, t, cols].float(),
                                   scale[l], cell)
    return dw, dwpv


def _plain_int8(params: Params, obs, action, logp_old, value_old, adv_norm, target, *,
                num_actions: int, total_rows: int, **kw):
    """K1's int8 mode as its kernels compute it: the chain (A and S), then
    the dW products, a frame at a time."""
    names, L, _, _ = dense_layers(params)
    total_rows = total_rows or obs.shape[0] * obs.shape[2]
    total = None   # every dW, every bias grad, dWpv, dbpv, the loss sums
    for t in range(obs.shape[0]):
        frame = [x[t:t + 1] for x in (obs, action, logp_old, value_old, adv_norm, target)]
        chain = k1_int8_chain_plain(params, *frame, num_actions=num_actions,
                                    total_rows=total_rows, **kw)
        dw, dwpv = k1_int8_dw_plain(chain)
        parts = [*dw, *chain.db, dwpv, chain.dbpv, chain.sums]
        total = parts if total is None else [a + b for a, b in zip(total, parts)]
    dw, db, (dwpv, dbpv, sums) = total[:L], total[L:2 * L], total[2 * L:]
    grads = _merged_grads(names, dw, db, dwpv, dbpv, num_actions)
    return grads, _loss_vector(sums, 1.0 / total_rows, kw["value_coef"], kw["entropy_coef"])


def fused_ppo_grads_fm_plain(params: Params, obs: torch.Tensor,
                             action: torch.Tensor, logp_old: torch.Tensor,
                             value_old: torch.Tensor, adv_norm: torch.Tensor,
                             target: torch.Tensor, *, num_actions: int,
                             activation: str, clip_eps: float,
                             value_coef: float, entropy_coef: float,
                             total_rows: int = 0, quant: str = "none",
                             bwd_bf16: bool = False
                             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The plain PyTorch version of :func:`fused_ppo_grads_fm`, on any
    device: the same casts and the same hand-written backward, transcribed
    from ``_fm_kernel``'s branches.  Products run in float32 on bf16-valued
    or integer-valued operands (exact products, f32 sums; integer sums
    exact, see ``EXACT_F32_CELL``).  It walks the minibatch a frame and
    ``PLAIN_COLS`` columns at a time (whole cells in the int8 mode), so it
    fits on the card at full width."""
    check_mode(quant, activation, dense_layers(params)[1])
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef, total_rows=total_rows)
    if quant == "int8":
        return _plain_int8(params, obs, action, logp_old, value_old, adv_norm, target, **kw)
    # The other modes run as K1 bf16's split kernels: their stages composed.
    return _plain_bf16(params, obs, action, logp_old, value_old, adv_norm, target,
                       quant=quant, bwd_bf16=bwd_bf16, **kw)


def k4_chain_plain(params: Params, obs: torch.Tensor, action: torch.Tensor,
                   logp_old: torch.Tensor, value_old: torch.Tensor,
                   adv_norm: torch.Tensor, target: torch.Tensor, *,
                   num_actions: int, activation: str, clip_eps: float,
                   value_coef: float, entropy_coef: float,
                   total_rows: int = 0) -> K1Chain:
    """The plain version of K4's kernel A (``csrc/k4_split.cu``), on any
    device, transcribed from ``_kernel``: the rows (obs (M, F)) as one frame
    of M columns, the forward, the loss and ``dheads``, the backward chain
    down to ``dpre_0``, ``PLAIN_COLS`` rows at a time.  It differs from
    :func:`k1_chain_plain` where K4 does: the derivative takes the f32
    activation, and the backward's ``dh`` is the policy head's product plus
    the value head's, summed in f32.  Returns a :class:`K1Chain` of (rows,
    1, M) operands, which :func:`k1_dw_plain` takes with ``obs.t()[None]``."""
    _, L, w, b = dense_layers(params)
    m_rows = obs.shape[0]
    inv_m = 1.0 / (total_rows or m_rows)
    A = num_actions
    wf = [x.to(BF16).float() for x in w[:L]]
    bf = [x.float() for x in b[:L]]
    wp, wv = w[L].to(BF16).float(), w[L + 1].to(BF16).float()
    bpv = torch.cat([b[L], b[L + 1]]).float()                   # (A+1,)
    loss_kw = dict(inv_m=inv_m, clip_eps=clip_eps, value_coef=value_coef,
                   entropy_coef=entropy_coef)
    new = lambda rows: torch.empty((rows, 1, m_rows), dtype=BF16, device=obs.device)
    hs_out = [new(x.shape[1]) for x in wf]
    dpres_out = [new(x.shape[1]) for x in wf]
    dheads_out = new(A + 1)
    db = [torch.zeros_like(x) for x in bf]
    dbpv = torch.zeros_like(bpv)
    sums = torch.zeros(4, dtype=torch.float32, device=obs.device)
    for r0 in range(0, m_rows, PLAIN_COLS):
        rows = slice(r0, min(m_rows, r0 + PLAIN_COLS))
        h_b = obs[rows].float().t()                             # (F, R)
        hs = []                                                 # the f32 activations
        for l in range(L):
            h = _act(torch.matmul(wf[l].t(), h_b) + bf[l][:, None], activation)
            h_b = h.to(BF16).float()
            hs.append(h)
            hs_out[l][:, 0, rows] = h_b
        logits = torch.matmul(wp.t(), h_b) + bpv[:A, None]      # (A, R)
        value = torch.matmul(wv.t(), h_b)[0] + bpv[A]           # (R,)
        chunk_sums, dlogits, dvalue = _loss_and_dheads(
            logits, value, action[rows], logp_old[rows], adv_norm[rows], value_old[rows],
            target[rows], **loss_kw)
        sums += chunk_sums
        dheads = torch.cat([dlogits, dvalue[None]])              # (A+1, R)
        dheads_b = dheads.to(BF16).float()
        dheads_out[:, 0, rows] = dheads_b
        dbpv += dheads.sum(dim=1)
        dh = torch.matmul(wp, dheads_b[:A]) + torch.matmul(wv, dheads_b[A:])
        for l, dpre, dpre_b in _dpre_chain(dh, hs, wf, activation):
            dpres_out[l][:, 0, rows] = dpre_b
            db[l] += dpre.sum(dim=1)
    return K1Chain(hs_out, dheads_out, dpres_out, db, dbpv, sums)


def fused_ppo_grads_rm_plain(params: Params, obs: torch.Tensor,
                             action: torch.Tensor, logp_old: torch.Tensor,
                             value_old: torch.Tensor, adv_norm: torch.Tensor,
                             target: torch.Tensor, *, num_actions: int,
                             activation: str, clip_eps: float,
                             value_coef: float, entropy_coef: float,
                             total_rows: int = 0
                             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The plain PyTorch version of :func:`fused_ppo_grads` (K4), on any
    device, as its two kernels compute it: :func:`k4_chain_plain`, then
    :func:`k1_dw_plain` on the rows as one frame, ``CHUNK_COLS`` rows at a
    time."""
    names, L, _, _ = dense_layers(params)
    m_rows = obs.shape[0]
    total_rows = total_rows or m_rows
    total = None   # every dW, every bias grad, dWpv, dbpv, the loss sums
    for r0 in range(0, m_rows, CHUNK_COLS):
        chunk = [x[r0:r0 + CHUNK_COLS] for x in (obs, action, logp_old, value_old, adv_norm,
                                                 target)]
        chain = k4_chain_plain(params, *chunk, num_actions=num_actions, activation=activation,
                               clip_eps=clip_eps, value_coef=value_coef,
                               entropy_coef=entropy_coef, total_rows=total_rows)
        dw, dwpv = k1_dw_plain(chain, chunk[0].t()[None])
        parts = [*dw, *chain.db, dwpv, chain.dbpv, chain.sums]
        total = parts if total is None else [a + b for a, b in zip(total, parts)]
    dw, db, (dwpv, dbpv, sums) = total[:L], total[L:2 * L], total[2 * L:]
    grads = _merged_grads(names, dw, db, dwpv, dbpv, num_actions)
    return grads, _loss_vector(sums, 1.0 / total_rows, value_coef, entropy_coef)


# ------------------------------------------------------------------ kernels --
_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=1)
def _library_bf16() -> ctypes.CDLL:
    lib = _build.load("fused_update_bf16", SOURCES_BF16)
    fn = lib.k1_bf16_launch
    fn.argtypes = ([_PTR] * 6                       # obs and the 5 scalars
                   + [_PTR] * 2 + [_PTR]            # weights, biases, hidden widths
                   + [ctypes.c_int] * 7             # L, F, Fp, A, relu, T, N
                   + [ctypes.c_float] * 4           # clip, -inv_m, ent, val scales
                   + [_PTR, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]  # workspace
                   + [_PTR, ctypes.c_int, _PTR, ctypes.c_int]  # partials of A and B
                   + [_PTR, _PTR, ctypes.c_int]     # out, stream, stages
                   + [_PTR, _PTR]                   # int8fwd: int8 weights, scales
                   + [ctypes.c_int, ctypes.c_int])  # bwd_bf16, wgmma (chain_design)
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library_k4() -> ctypes.CDLL:
    lib = _build.load("k4_split", SOURCES_K4)
    fn = lib.k4_launch
    fn.argtypes = ([_PTR] * 6                       # obs and the 5 scalars
                   + [_PTR] * 2 + [_PTR]            # weights, biases, hidden widths
                   + [ctypes.c_int] * 5             # L, F, Fp, A, relu
                   + [ctypes.c_longlong]            # M
                   + [ctypes.c_float] * 4           # clip, -inv_m, ent, val scales
                   + [_PTR, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]  # workspace
                   + [_PTR, ctypes.c_int, _PTR, ctypes.c_int]  # partials of A and B
                   + [_PTR, _PTR, _PTR, ctypes.c_int])  # hkeep, out, stream, stages
    fn.restype = ctypes.c_int
    return lib


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _check_scalars(obs, scalars, action, rows_shape) -> torch.device:
    device = obs.device
    if action.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"action must be int32 or int64, got {action.dtype}")
    for x in (action, *scalars):
        if x.shape != rows_shape:
            raise ValueError(f"per-row inputs must be {tuple(rows_shape)}, got "
                             f"{tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"inputs lie on {device} and {x.device}")
    for x in scalars:
        if x.dtype != torch.float32:
            raise TypeError(f"per-row float inputs must be float32, got {x.dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused PPO gradient has no version for {device}")
    return device


def _check(obs, scalars, action) -> torch.device:
    if obs.dim() != 3 or obs.dtype != BF16:
        raise ValueError(f"obs must be (T, F, N) bf16, got {tuple(obs.shape)} {obs.dtype}")
    return _check_scalars(obs, scalars, action, (obs.shape[0], obs.shape[2]))


def _check_rm(obs, scalars, action) -> torch.device:
    if obs.dim() != 2 or obs.dtype != BF16:
        raise ValueError(f"obs must be (M, F) bf16, got {tuple(obs.shape)} {obs.dtype}")
    return _check_scalars(obs, scalars, action, (obs.shape[0],))


def _check_net(w, L: int, A: int, head_pad: int, activation: str) -> List[int]:
    """What the kernels take: 1-4 hidden layers of multiples of 16 up to 256
    wide, a policy head of ``num_actions`` that fits the padded head."""
    hidden = [x.shape[1] for x in w[:L]]
    if not 1 <= L <= MAX_LAYERS or any(h % 16 or h > MAX_WIDTH for h in hidden):
        raise ValueError(f"the kernel takes 1-{MAX_LAYERS} hidden layers of multiples "
                         f"of 16 up to {MAX_WIDTH} wide, got {hidden}")
    if A + 1 > head_pad or w[L].shape[1] != A:
        raise ValueError(f"the kernel takes up to {head_pad - 1} actions; the "
                         f"policy head has {w[L].shape[1]}, num_actions is {A}")
    if activation not in ("tanh", "relu"):
        raise ValueError(f"unknown activation {activation!r}")
    return hidden


def _unpack(out, widths, head_pad: int, f: int):
    """The reduced output -> (dw list, db list, head dW (H, pad), head db
    (pad,), loss sums (4,))."""
    dw, pos = [], 0
    for i, o in zip(widths[:-1], widths[1:]):
        dw.append(out[pos:pos + i * o].view(i, o))
        pos += i * o
    dw[0] = dw[0][:f]
    h_top = widths[-1]
    dwh = out[pos:pos + h_top * head_pad].view(h_top, head_pad)
    pos += h_top * head_pad
    db = []
    for h in widths[1:]:
        db.append(out[pos:pos + h])
        pos += h
    dbh = out[pos:pos + head_pad]
    return dw, db, dwh, dbh, out[pos + head_pad:pos + head_pad + 4]


def _ptr_array(tensors):
    arr = (_PTR * len(tensors))(*[x.data_ptr() for x in tensors])
    return ctypes.cast(arr, _PTR), arr


def _pad_net(bf16_w, b, L: int, f: int, A: int):
    """K1's weights and biases as its kernels take them: the first kernel
    with zero rows to ``Fp``, the merged (H, A+1) head padded to HEAD_PAD
    columns, its bias to HEAD_PAD."""
    device = bf16_w[0].device
    w0 = torch.zeros((_round16(f), bf16_w[0].shape[1]), dtype=BF16, device=device)
    w0[:f] = bf16_w[0]
    wpv = torch.zeros((bf16_w[L].shape[0], HEAD_PAD), dtype=BF16, device=device)
    wpv[:, :A + 1] = torch.cat([bf16_w[L], bf16_w[L + 1]], dim=1)
    bpv = torch.zeros(HEAD_PAD, dtype=torch.float32, device=device)
    bpv[:A + 1] = torch.cat([b[L], b[L + 1]]).float()
    weights = [w0] + [x.contiguous() for x in bf16_w[1:L]] + [wpv]
    biases = [x.float().contiguous() for x in b[:L]] + [bpv]
    return weights, biases


STAGE_CHAIN, STAGE_DW = 1, 2  # kernel A, the dW kernels (the launch's ``stages`` bits)
STAGE_REQUANT = 4  # K1 int8's kernel S, once a hidden layer
INT8_KERNELS = ("int8_chain", "int8_requant", "int8_dw", "int8_head_dw")


def _ws_rows(hidden, x_rows: int = 0):
    """Row offsets of K1 bf16's workspace: bf16(h_l), then bf16(dheads)
    (HEAD_PAD rows), then bf16(dpre_l), after ``x_rows`` rows of x^T (K4's
    workspace).  Returns (h rows, dheads row, dpre rows, total rows)."""
    row_h = [x_rows + sum(hidden[:l]) for l in range(len(hidden))]
    row_dh = x_rows + sum(hidden)
    row_dp = [row_dh + HEAD_PAD + r - x_rows for r in row_h]
    return row_h, row_dh, row_dp, x_rows + 2 * sum(hidden) + HEAD_PAD


def _npad(n: int) -> int:
    return -(-n // COLS) * COLS


def chain_design(hidden, obs_dim: int, num_actions: int, quant: str = "none",
                 bwd_bf16: bool = False) -> str:
    """Which kernel A serves K1's bf16 and int8fwd modes on the card, from the
    shapes and the mode alone: ``"wgmma"`` (``csrc/k1_wgmma.cuh``'s
    ``wgmma_chain_kernel``: wgmma and TMA, two ping-pong consumer
    warpgroups) for the bf16 mode without the bf16 backward chain at hidden
    (256, 256), at most 48 padded features and HEAD_PAD - 1 actions, tanh or
    relu; ``"mma"`` (``csrc/k1_split.cuh``'s ``chain_kernel`` on mma.sync)
    for every other call.  The wrapper passes the choice to
    ``k1_bf16_launch``, which refuses ``"wgmma"`` for a call its kernel
    cannot take (``k1w::takes``)."""
    takes = (quant == "none" and not bwd_bf16 and list(hidden) == [WGMMA_WIDTH] * 2
             and _round16(obs_dim) <= WGMMA_FEATURES and num_actions + 1 <= HEAD_PAD)
    return "wgmma" if takes else "mma"


def _bf16_call(obs, hidden, num_actions: int, ws, chunk: int, stages: int, net=None):
    """Launch K1 bf16's kernels over ``obs`` (T, F, N) through the workspace
    ``ws`` (rows, chunk * Npad) bf16, ``chunk`` frames at a time: kernel A,
    kernel B or both (``stages``).  ``net``, kernel A's inputs: (weights,
    biases, int32 action, the 4 per-column scalars, relu, the int8fwd
    forward's (int8 weights, scales) or None, bwd_bf16, clip, -1/M, entropy
    and value scales).  Kernel A is :func:`chain_design`'s.  Returns
    ``out``: every dW, then the bias grads and the 4 loss sums, as
    :func:`_unpack` reads them."""
    t_mb, f, n = obs.shape
    device = obs.device
    widths = [_round16(f), *hidden]
    shapes = list(zip(widths, [*hidden, HEAD_PAD]))          # each dW
    n_w = sum(i * o for i, o in shapes)
    n_b = sum(hidden) + HEAD_PAD
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks_a = min(chunk * _npad(n) // COLS, sms)
    tiles = sum(-(-i // DW_TILE) * -(-o // DW_TILE) for i, o in shapes)
    # DW_BLOCKS_PER_SM blocks of kernel B an SM, each over its own column range.
    ranges = max(1, min(-(-DW_BLOCKS_PER_SM * sms // tiles), chunk * _npad(n) // COLS))
    partial_a = torch.empty((blocks_a, n_b + 4), dtype=torch.float32, device=device)
    partial_b = torch.empty((ranges, n_w), dtype=torch.float32, device=device)
    out = torch.empty(n_w + n_b + 4, dtype=torch.float32, device=device)
    obs = obs.contiguous()
    dims = (ctypes.c_int * len(hidden))(*hidden)
    q_ptrs = sw = None
    if net is None:
        w_ptrs = b_ptrs = None
        ptrs, relu, bwd_bf16, scales, int8fwd = [None] * 5, 0, 0, (0.0,) * 4, None
    else:
        weights, biases, action, scalars, relu, int8fwd, bwd_bf16, *scales = net
        w_ptrs, _w = _ptr_array(weights)
        b_ptrs, _b = _ptr_array(biases)
        if int8fwd is not None:
            q_ptrs, _q = _ptr_array(int8fwd[0])
            sw = int8fwd[1].data_ptr()
        ptrs = [action.data_ptr(), *[x.data_ptr() for x in scalars]]
    wgmma = chain_design(hidden, f, num_actions, "none" if int8fwd is None else "int8fwd",
                         bool(bwd_bf16)) == "wgmma"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library_bf16().k1_bf16_launch(
            obs.data_ptr(), *ptrs, w_ptrs, b_ptrs, ctypes.cast(dims, _PTR), len(hidden), f,
            widths[0], num_actions, relu, t_mb, n, *scales, ws.data_ptr(), ws.shape[0],
            ws.shape[1], chunk, partial_a.data_ptr(), blocks_a, partial_b.data_ptr(), ranges,
            out.data_ptr(), stream, stages, q_ptrs, sw, bwd_bf16, int(wgmma))
    if err != 0:
        raise RuntimeError(f"K1 bf16 kernel launch failed: CUDA error {err}")
    _count(fused_ppo_grads_fm, stages, -(-t_mb // chunk), "bf16",
           "chain_wgmma" if wgmma else "chain")
    return out


def _count(fn, stages: int, chunks: int, prefix: str, chain: str = "chain") -> None:
    """Add a launch's kernels to ``fn.launches_by_kernel``: kernel A
    (``<prefix>_<chain>``) and kernel B (``<prefix>_dw``) once a chunk each."""
    for bit, name in ((STAGE_CHAIN, chain), (STAGE_DW, "dw")):
        if stages & bit:
            fn.launches_by_kernel[f"{prefix}_{name}"] += chunks


def _run_bf16(params: Params, obs, action, scalars, *, num_actions: int, activation: str,
              clip_eps: float, value_coef: float, entropy_coef: float, inv_m: float,
              chunk: int, stages: int, quant: str = "none", bwd_bf16: bool = False):
    """Pad the net (and for ``quant="int8fwd"`` quantise its forward),
    allocate a workspace of ``chunk`` frames and launch, kernel A with the
    bf16 backward chain if ``bwd_bf16``.  Returns (names, hidden widths,
    out, workspace)."""
    names, L, w, b = dense_layers(params)
    hidden = _check_net(w, L, num_actions, HEAD_PAD, activation)
    t_mb, f, n = obs.shape
    if t_mb * n == 0:
        raise ValueError(f"empty minibatch: obs is {tuple(obs.shape)}")
    weights, biases = _pad_net([x.to(BF16) for x in w], b, L, f, num_actions)
    int8fwd = None
    if quant == "int8fwd":
        fwd, _, sw = _int8_fwd(w, L, f, hidden)
        int8fwd = (fwd, sw)
    ws = torch.empty((_ws_rows(hidden)[-1], chunk * _npad(n)), dtype=BF16, device=obs.device)
    net = (weights, biases, action.to(torch.int32).contiguous(),
           [x.contiguous() for x in scalars], int(activation == "relu"), int8fwd,
           int(bwd_bf16), clip_eps, -inv_m, entropy_coef * inv_m, value_coef * inv_m)
    return names, hidden, _bf16_call(obs, hidden, num_actions, ws, chunk, stages, net), ws


def chunk_frames(t_mb: int, n: int) -> int:
    """Frames of one chunk of K1's bf16 mode: about CHUNK_COLS workspace
    columns, at least one frame."""
    return max(1, min(t_mb, CHUNK_COLS // _npad(n)))


def _launch_bf16(params: Params, obs, action, logp_old, value_old, adv_norm, target,
                 num_actions: int, inv_m: float, **kw):
    """K1's bf16 or int8fwd mode (``kw["quant"]``, with or without
    ``kw["bwd_bf16"]``): kernels A and B over chunks of frames, then the
    grads dict and the loss vector."""
    t_mb, f, n = obs.shape
    names, hidden, out, _ = _run_bf16(params, obs, action, (logp_old, value_old, adv_norm, target),
                                      num_actions=num_actions, inv_m=inv_m,
                                      chunk=chunk_frames(t_mb, n),
                                      stages=STAGE_CHAIN | STAGE_DW, **kw)
    dw, db, dwpv, dbpv, sums = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    grads = _merged_grads(names, dw, db, dwpv, dbpv, num_actions)
    return grads, _loss_vector(sums, inv_m, kw["value_coef"], kw["entropy_coef"])


def k1_chain(params: Params, obs: torch.Tensor, action: torch.Tensor,
             logp_old: torch.Tensor, value_old: torch.Tensor, adv_norm: torch.Tensor,
             target: torch.Tensor, *, num_actions: int, activation: str, clip_eps: float,
             value_coef: float, entropy_coef: float, total_rows: int = 0,
             quant: str = "none", bwd_bf16: bool = False) -> K1Chain:
    """Kernel A of K1's bf16 or int8fwd mode (with or without the bf16
    backward chain) alone, over the whole minibatch (its workspace holds
    every frame): the :class:`K1Chain` of :func:`k1_chain_plain`, whose
    operands are views of the workspace.  On CUDA it adds one to
    ``k1_chain.launches``; on the CPU it runs :func:`k1_chain_plain`."""
    scalars = (logp_old, value_old, adv_norm, target)
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef, quant=quant,
              bwd_bf16=bwd_bf16)
    if _check(obs, scalars, action).type == "cpu":
        return k1_chain_plain(params, obs, action, *scalars, total_rows=total_rows, **kw)
    if quant not in ("none", "int8fwd"):
        raise ValueError(f"kernel A runs quant 'none' or 'int8fwd', not {quant!r}")
    check_mode(quant, activation, dense_layers(params)[1])
    t_mb, f, n = obs.shape
    inv_m = 1.0 / (total_rows or t_mb * n)
    _, hidden, out, ws = _run_bf16(params, obs, action, scalars, inv_m=inv_m, chunk=t_mb,
                                   stages=STAGE_CHAIN, **kw)
    k1_chain.launches += 1
    _, db, _, dbpv, sums = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    row_h, row_dh, row_dp, rows = _ws_rows(hidden)
    view = ws.view(rows, t_mb, _npad(n))
    op = lambda r, k: view[r:r + k, :, :n]
    return K1Chain([op(r, h) for r, h in zip(row_h, hidden)], op(row_dh, num_actions + 1),
                   [op(r, h) for r, h in zip(row_dp, hidden)], db, dbpv[:num_actions + 1], sums)


def k1_dw(chain: K1Chain, obs: torch.Tensor):
    """Kernel B of K1's bf16 mode alone, on ``chain``'s operands (copied into
    a workspace of the whole minibatch, zero past column N): the dW of
    :func:`k1_dw_plain`.  On CUDA it adds one to ``k1_dw.launches``; on the
    CPU it runs :func:`k1_dw_plain`."""
    if obs.device.type == "cpu":
        return k1_dw_plain(chain, obs)
    t_mb, f, n = obs.shape
    hidden = [h.shape[0] for h in chain.hs]
    num_actions = chain.dheads.shape[0] - 1
    row_h, row_dh, row_dp, rows = _ws_rows(hidden)
    ws = torch.zeros((rows, t_mb * _npad(n)), dtype=BF16, device=obs.device)
    view = ws.view(rows, t_mb, _npad(n))
    for r, x in [*zip(row_h, chain.hs), (row_dh, chain.dheads), *zip(row_dp, chain.dpres)]:
        view[r:r + x.shape[0], :, :n] = x
    out = _bf16_call(obs, hidden, num_actions, ws, t_mb, STAGE_DW)
    k1_dw.launches += 1
    dw, _, dwpv, _, _ = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    return dw, dwpv[:, :num_actions + 1]


k1_chain.launches = 0
k1_dw.launches = 0


def _round32(x: int) -> int:
    return -(-x // 32) * 32


def check_int8_cells(n: int) -> None:
    """The int8 mode sums each cell's dW products in int32: a whole-frame
    cell (N no multiple of 128) wider than INT8_MAX_CELL columns could
    overflow it (the JAX kernel's i32 sum wraps there)."""
    if cell_cols(n) > INT8_MAX_CELL:
        raise ValueError(
            f"the int8 mode's dynamic-scale cell is the whole frame of {n} columns (N is no "
            f"multiple of 128), wider than {INT8_MAX_CELL}: its int32 dW sums could overflow "
            f"({INT8_MAX_CELL} x 127^2 < 2^31); use N a multiple of 128 or at most "
            f"{INT8_MAX_CELL}")


def _int8_rows(f: int, hidden):
    """Row offsets of K1 int8's int8 workspace: x_q (Fp rows), h_q_l, then
    dp_q_l.  Returns (h rows, dp_q rows, total rows)."""
    fp, total = _round16(f), sum(hidden)
    row_h = [fp + sum(hidden[:l]) for l in range(len(hidden))]
    return row_h, [r + total for r in row_h], fp + 2 * total


def _int8_cells(n: int):
    """(columns of a cell in the workspace, cells a frame): a cell of
    ``cell_cols(n)`` columns, or the padded frame."""
    cell = cell_cols(n)
    cw = _npad(n) if cell >= n else cell
    return cw, _npad(n) // cw


def _padded_int8(src, rows: int, k: int):
    out = torch.zeros((rows, k), dtype=torch.int8, device=src.device)
    out[:src.shape[0], :src.shape[1]] = src
    return out


def _int8_fwd(w, L: int, f: int, hidden):
    """The int8 forward's weights as the kernels take them (K1's int8 and
    int8fwd modes): each forward kernel transposed (out, in) with the
    contraction zero-padded to 32 (the first from Fp), the merged head
    (HEAD_PAD, H) likewise.  Returns (those, the int8 tensors of
    :func:`quantize_weights`, the L+1 scales)."""
    wq, sw = quantize_weights(w, L)
    fwd = [_padded_int8(wq[0].t(), hidden[0], _round32(_round16(f)))]
    fwd += [_padded_int8(wq[l].t(), hidden[l], _round32(hidden[l - 1])) for l in range(1, L)]
    fwd.append(_padded_int8(wq[L].t(), HEAD_PAD, _round32(hidden[-1])))
    return fwd, wq, sw.contiguous()


def _int8_net(w, b, L: int, f: int, A: int, hidden):
    """K1 int8's weights as its kernels take them: the forward's
    (:func:`_int8_fwd`); the hidden kernels (in, out) for the dh products,
    out padded to 32; the int8 head as bf16 (H, HEAD_PAD); the biases, the
    head's padded; the L+1 scales."""
    fwd, wq, sw = _int8_fwd(w, L, f, hidden)
    device = wq[0].device
    bwd = [fwd[0]] + [_padded_int8(wq[l], hidden[l - 1], _round32(hidden[l])) for l in range(1, L)]
    whb = torch.zeros((hidden[-1], HEAD_PAD), dtype=BF16, device=device)
    whb[:, :A + 1] = wq[L].to(BF16)
    bpv = torch.zeros(HEAD_PAD, dtype=torch.float32, device=device)
    bpv[:A + 1] = torch.cat([b[L], b[L + 1]]).float()
    biases = [x.float().contiguous() for x in b[:L]] + [bpv]
    return fwd, bwd, whb, biases, sw


class _Int8Workspace(NamedTuple):
    """K1 int8's workspace for ``chunk`` frames: int8 rows (``_int8_rows``),
    bf16 rows (bf16(h_top), then dheads), f32 rows (dpre_l from
    ``f_rows[l]``), and the cell maxima (L, T, cells) of the whole
    minibatch."""
    q: torch.Tensor
    b: torch.Tensor
    f: torch.Tensor
    f_rows: List[int]
    cellmax: torch.Tensor
    chunk: int


def _int8_workspace(obs, hidden, chunk: int, dpre_per_layer: bool) -> _Int8Workspace:
    """Allocate K1 int8's workspace; dpre takes one buffer for every layer
    (each S launch writes dpre_{l-1} over dpre_l) unless ``dpre_per_layer``."""
    t_mb, f, n = obs.shape
    device = obs.device
    cols = chunk * _npad(n)
    f_rows = ([sum(hidden[:l]) for l in range(len(hidden))] if dpre_per_layer
              else [0] * len(hidden))
    rows_f = sum(hidden) if dpre_per_layer else max(hidden)
    return _Int8Workspace(
        torch.empty((_int8_rows(f, hidden)[-1], cols), dtype=torch.int8, device=device),
        torch.empty((hidden[-1] + HEAD_PAD, cols), dtype=BF16, device=device),
        torch.empty((rows_f, cols), dtype=torch.float32, device=device), f_rows,
        torch.zeros((len(hidden), t_mb, _int8_cells(n)[1]), dtype=torch.float32, device=device),
        chunk)


@functools.lru_cache(maxsize=1)
def _library_int8() -> ctypes.CDLL:
    lib = _build.load("fused_update_int8", SOURCES_INT8)
    fn = lib.k1_int8_launch
    fn.argtypes = ([_PTR] * 6                       # obs and the 5 scalars
                   + [_PTR] * 5                     # fwd, bwd, bf16 head, biases, scales
                   + [_PTR] + [ctypes.c_int] * 6    # hidden widths; L, F, Fp, A, T, N
                   + [ctypes.c_float] * 4           # clip, -inv_m, ent, val scales
                   + [_PTR] * 3 + [ctypes.c_longlong, _PTR, ctypes.c_int]  # workspace
                   + [_PTR, ctypes.c_int]           # cell maxima, cell columns
                   + [_PTR, ctypes.c_int] * 4       # partials of A, S, Q, the head's dW
                   + [_PTR, _PTR, ctypes.c_int])    # out, stream, stages
    fn.restype = ctypes.c_int
    return lib


def _int8_call(obs, hidden, num_actions: int, ws: _Int8Workspace, stages: int, net=None):
    """Launch K1 int8's kernels over ``obs`` (T, F, N) through ``ws``,
    ``ws.chunk`` frames at a time: A and S, the dW kernels or all
    (``stages``).  ``net``: (the ``_int8_net`` tuple, int32 action, the 4
    per-column scalars, clip, -1/M, entropy and value scales), for A and S.
    Returns ``out``: every dW, then the bias grads and the 4 loss sums, as
    :func:`_unpack` reads them."""
    t_mb, f, n = obs.shape
    device = obs.device
    L = len(hidden)
    fp = _round16(f)
    widths = [fp, *hidden]
    n_w = sum(i * o for i, o in zip(widths, [*hidden, HEAD_PAD]))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = ws.chunk * _npad(n) // COLS
    blocks = min(tiles, sms)
    q_tiles = sum(-(-i // DW_TILE) * -(-o // Q_TILE_COLS) for i, o in zip(widths, hidden))
    cells = ws.chunk * _int8_cells(n)[1]
    ranges_q = max(1, min(-(-DW_BLOCKS_PER_SM * sms // q_tiles), cells))
    h_tiles = -(-hidden[-1] // DW_TILE)
    ranges_h = max(1, min(-(-DW_BLOCKS_PER_SM * sms // h_tiles), tiles))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    partial_a, partial_s = new(blocks, HEAD_PAD + 4), new(blocks, sum(hidden))
    partial_q = new(ranges_q, n_w - hidden[-1] * HEAD_PAD)
    partial_h = new(ranges_h, hidden[-1] * HEAD_PAD)
    out = new(n_w + sum(hidden) + HEAD_PAD + 4)
    obs = obs.contiguous()
    dims = (ctypes.c_int * L)(*hidden)
    f_rows = (ctypes.c_int * L)(*ws.f_rows)
    keep = []   # the pointer arrays, alive through the launch
    if net is None:
        ptrs, weights, scales = [None] * 5, [None] * 5, (0.0,) * 4
    else:
        (fwd, bwd, whb, biases, sw), action, scalars, *scales = net
        arrays = [_ptr_array(x) for x in (fwd, bwd, biases)]
        keep = [a for _, a in arrays]
        weights = [arrays[0][0], arrays[1][0], whb.data_ptr(), arrays[2][0], sw.data_ptr()]
        ptrs = [action.data_ptr(), *[x.data_ptr() for x in scalars]]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library_int8().k1_int8_launch(
            obs.data_ptr(), *ptrs, *weights, ctypes.cast(dims, _PTR), L, f, fp, num_actions,
            t_mb, n, *scales, ws.q.data_ptr(), ws.b.data_ptr(), ws.f.data_ptr(), ws.q.shape[1],
            ctypes.cast(f_rows, _PTR), ws.chunk, ws.cellmax.data_ptr(), cell_cols(n),
            partial_a.data_ptr(), blocks, partial_s.data_ptr(), blocks, partial_q.data_ptr(),
            ranges_q, partial_h.data_ptr(), ranges_h, out.data_ptr(), stream, stages)
    if err != 0:
        raise RuntimeError(f"K1 int8 kernel launch failed: CUDA error {err}")
    chunks = -(-t_mb // ws.chunk)
    counts = fused_ppo_grads_fm.launches_by_kernel
    for bit, names, n_each in ((STAGE_CHAIN, ["int8_chain"], 1), (STAGE_REQUANT, ["int8_requant"], L),
                               (STAGE_DW, ["int8_dw", "int8_head_dw"], 1)):
        if stages & bit:
            for name in names:
                counts[name] += chunks * n_each
    return out


def _run_int8(params: Params, obs, action, scalars, *, num_actions: int, activation: str,
              clip_eps: float, value_coef: float, entropy_coef: float, inv_m: float,
              chunk: int, stages: int, dpre_per_layer: bool = False):
    """Quantise and pad the net, allocate a workspace of ``chunk`` frames
    and launch.  Returns (names, hidden widths, out, workspace)."""
    names, L, w, b = dense_layers(params)
    hidden = _check_net(w, L, num_actions, HEAD_PAD, activation)
    t_mb, f, n = obs.shape
    if t_mb * n == 0:
        raise ValueError(f"empty minibatch: obs is {tuple(obs.shape)}")
    check_int8_cells(n)
    ws = _int8_workspace(obs, hidden, chunk, dpre_per_layer)
    net = (_int8_net(w, b, L, f, num_actions, hidden), action.to(torch.int32).contiguous(),
           [x.contiguous() for x in scalars], clip_eps, -inv_m, entropy_coef * inv_m,
           value_coef * inv_m)
    return names, hidden, _int8_call(obs, hidden, num_actions, ws, stages, net), ws


def _launch_int8(params: Params, obs, action, logp_old, value_old, adv_norm, target,
                 num_actions: int, inv_m: float, **kw):
    """K1's int8 mode: kernels A, S x L and the dW kernels over chunks of
    frames, then the grads dict and the loss vector."""
    t_mb, f, n = obs.shape
    names, hidden, out, _ = _run_int8(params, obs, action, (logp_old, value_old, adv_norm, target),
                                      num_actions=num_actions, inv_m=inv_m,
                                      chunk=chunk_frames(t_mb, n),
                                      stages=STAGE_CHAIN | STAGE_REQUANT | STAGE_DW, **kw)
    dw, db, dwpv, dbpv, sums = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    grads = _merged_grads(names, dw, db, dwpv, dbpv, num_actions)
    return grads, _loss_vector(sums, inv_m, kw["value_coef"], kw["entropy_coef"])


def k1_int8_chain(params: Params, obs: torch.Tensor, action: torch.Tensor,
                  logp_old: torch.Tensor, value_old: torch.Tensor, adv_norm: torch.Tensor,
                  target: torch.Tensor, *, num_actions: int, activation: str, clip_eps: float,
                  value_coef: float, entropy_coef: float, total_rows: int = 0) -> K1Int8Chain:
    """Kernels A and S of K1's int8 mode alone, over the whole minibatch
    (its workspace holds every frame, and dpre a buffer a layer): the
    :class:`K1Int8Chain` of :func:`k1_int8_chain_plain`, whose operands are
    views of the workspace.  On CUDA it adds one to
    ``k1_int8_chain.launches``; on the CPU it runs
    :func:`k1_int8_chain_plain`."""
    scalars = (logp_old, value_old, adv_norm, target)
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef)
    if _check(obs, scalars, action).type == "cpu":
        return k1_int8_chain_plain(params, obs, action, *scalars, total_rows=total_rows, **kw)
    check_mode("int8", activation, dense_layers(params)[1])
    t_mb, f, n = obs.shape
    inv_m = 1.0 / (total_rows or t_mb * n)
    _, hidden, out, ws = _run_int8(params, obs, action, scalars, inv_m=inv_m, chunk=t_mb,
                                   stages=STAGE_CHAIN | STAGE_REQUANT, dpre_per_layer=True, **kw)
    k1_int8_chain.launches += 1
    _, db, _, dbpv, sums = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    row_h, row_dq, _ = _int8_rows(f, hidden)
    op = lambda x, r, k: x.view(x.shape[0], t_mb, _npad(n))[r:r + k, :, :n]
    h_top = hidden[-1]
    return K1Int8Chain(op(ws.q, 0, f), [op(ws.q, r, h) for r, h in zip(row_h, hidden)],
                       op(ws.b, 0, h_top), op(ws.b, h_top, num_actions + 1),
                       [op(ws.f, r, h) for r, h in zip(ws.f_rows, hidden)],
                       [op(ws.q, r, h) for r, h in zip(row_dq, hidden)], ws.cellmax, db,
                       dbpv[:num_actions + 1], sums)


def k1_int8_dw(chain: K1Int8Chain):
    """K1 int8's dW kernels alone (kernel Q and the head's bf16 product) on
    ``chain``'s operands and cell maxima (copied into a workspace of the
    whole minibatch, zero past column N): the dW of :func:`k1_int8_dw_plain`.
    On CUDA it adds one to ``k1_int8_dw.launches``; on the CPU it runs
    :func:`k1_int8_dw_plain`."""
    if chain.x_q.device.type == "cpu":
        return k1_int8_dw_plain(chain)
    f, t_mb, n = chain.x_q.shape
    check_int8_cells(n)
    hidden = [h.shape[0] for h in chain.hs]
    num_actions = chain.dheads.shape[0] - 1
    obs = torch.empty((t_mb, f, n), dtype=BF16, device=chain.x_q.device)  # shape only
    ws = _int8_workspace(obs, hidden, t_mb, False)
    for x in (ws.q, ws.b):
        x.zero_()
    ws.cellmax.copy_(chain.cellmax)
    row_h, row_dq, _ = _int8_rows(f, hidden)
    view = lambda x: x.view(x.shape[0], t_mb, _npad(n))
    for r, x in [(0, chain.x_q), *zip(row_h, chain.hs), *zip(row_dq, chain.dp_q)]:
        view(ws.q)[r:r + x.shape[0], :, :n] = x
    view(ws.b)[:hidden[-1], :, :n] = chain.h_top
    view(ws.b)[hidden[-1]:hidden[-1] + num_actions + 1, :, :n] = chain.dheads
    out = _int8_call(obs, hidden, num_actions, ws, STAGE_DW)
    k1_int8_dw.launches += 1
    dw, _, dwpv, _, _ = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    return dw, dwpv[:, :num_actions + 1]


k1_int8_chain.launches = 0
k1_int8_dw.launches = 0


def fused_ppo_grads_fm(params: Params, obs: torch.Tensor, action: torch.Tensor,
                       logp_old: torch.Tensor, value_old: torch.Tensor,
                       adv_norm: torch.Tensor, target: torch.Tensor, *,
                       num_actions: int, activation: str, clip_eps: float,
                       value_coef: float, entropy_coef: float,
                       total_rows: int = 0, quant: str = "none",
                       bwd_bf16: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Clipped-PPO gradient of one minibatch, feature-major (K1).

    ``params``: the network's parameter dict (``dense_layers`` order);
    ``obs``: (T, F, N) bf16 normalised, feature-major; ``action`` (T, N)
    int; ``logp_old``, ``value_old``, ``adv_norm`` (already normalised by
    the caller), ``target``: (T, N) float32.  Any T and N.  ``total_rows``
    sets the mean's denominator (0: T*N).  ``quant`` ("none", "int8",
    "int8fwd") and ``bwd_bf16`` pick the precision mode (module docstring);
    the int8 modes take ``activation="tanh"`` only.

    Returns ``(grads, losses)``: f32 grads keyed like ``params`` and
    ``losses = [total, policy, value, entropy, approx_kl]`` (means).  On
    CUDA this launches ``csrc/fused_update_bf16.cu`` (the bf16 and int8fwd
    modes, with or without ``bwd_bf16``: kernels A and B over chunks of
    frames) or ``csrc/fused_update_int8.cu`` (the int8 mode: kernels A, S x
    L, Q and B over chunks of frames) on the current stream without
    synchronising and adds one to
    ``fused_ppo_grads_fm.launches`` and to
    ``launches_by_mode[mode_name(quant, bwd_bf16)]``; on the CPU it runs
    :func:`fused_ppo_grads_fm_plain`."""
    scalars = (logp_old, value_old, adv_norm, target)
    device = _check(obs, scalars, action)
    check_mode(quant, activation, dense_layers(params)[1])
    if quant == "int8":
        check_int8_cells(obs.shape[2])
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef)
    if device.type == "cpu":
        return fused_ppo_grads_fm_plain(params, obs, action, *scalars, total_rows=total_rows,
                                        quant=quant, bwd_bf16=bwd_bf16, **kw)
    t_mb, _, n = obs.shape
    inv_m = 1.0 / (total_rows or t_mb * n)
    if quant == "int8":
        result = _launch_int8(params, obs, action, *scalars, inv_m=inv_m, **kw)
    else:
        result = _launch_bf16(params, obs, action, *scalars, inv_m=inv_m, quant=quant,
                              bwd_bf16=bwd_bf16, **kw)
    fused_ppo_grads_fm.launches += 1
    fused_ppo_grads_fm.launches_by_mode[mode_name(quant, bwd_bf16)] += 1
    return result


def zero_fm_counts() -> None:
    """Set K1's and K4's counts to 0: K1's calls, by mode, and the launches
    of K1 bf16's kernels A and B (``bf16_chain`` for ``chain_kernel``,
    ``bf16_chain_wgmma`` for ``wgmma_chain_kernel``, as :func:`chain_design`
    picks, and ``bf16_dw``: the bf16 and int8fwd modes, with or without the
    bf16 backward chain) and of each int8
    kernel (``INT8_KERNELS``), a call launching each once a chunk, kernel S
    once a chunk and layer; K4's calls and its kernels' launches
    (``k4_chain``, ``k4_dw``)."""
    fused_ppo_grads_fm.launches = 0
    fused_ppo_grads_fm.launches_by_mode = {
        mode_name(q, bb): 0 for q in QUANT_MODES for bb in (False, True)}
    fused_ppo_grads_fm.launches_by_kernel = dict.fromkeys(
        ("bf16_chain", "bf16_chain_wgmma", "bf16_dw", *INT8_KERNELS), 0)
    fused_ppo_grads.launches = 0
    fused_ppo_grads.launches_by_kernel = dict.fromkeys(("k4_chain", "k4_dw"), 0)




def _k4_net(w, b, L: int, f: int, A: int):
    """K4's weights as its kernels take them: the first kernel with zero rows
    to ``Fp``, the split head (H, HEAD_SPLIT) bf16 with the policy in columns
    0..A-1 and the value in VALUE_ROW, its bias likewise."""
    device = w[0].device
    h_top = w[L].shape[0]
    w0 = torch.zeros((_round16(f), w[0].shape[1]), dtype=BF16, device=device)
    w0[:f] = w[0].to(BF16)
    wh = torch.zeros((h_top, HEAD_SPLIT), dtype=BF16, device=device)
    wh[:, :A] = w[L].to(BF16)
    wh[:, VALUE_ROW] = w[L + 1][:, 0].to(BF16)
    bh = torch.zeros(HEAD_SPLIT, dtype=torch.float32, device=device)
    bh[:A] = b[L].float()
    bh[VALUE_ROW] = b[L + 1][0].float()
    weights = [w0] + [x.to(BF16).contiguous() for x in w[1:L]] + [wh]
    biases = [x.float().contiguous() for x in b[:L]] + [bh]
    return weights, biases


def _k4_call(obs, hidden, num_actions: int, ws, chunk: int, stages: int, net=None):
    """Launch K4's kernels over ``obs`` (M, F), ``chunk`` rows at a time,
    through the workspace ``ws`` (:func:`_ws_rows` with Fp rows of x^T,
    ``chunk`` padded columns) bf16: kernel A, kernel B or both
    (``stages``).  ``net``, kernel A's inputs: (weights, biases, int32
    action, the 4 per-row scalars, relu, clip, -1/M, entropy and value
    scales).  Returns ``out`` as :func:`_unpack` reads it."""
    m_rows, f = obs.shape
    device = obs.device
    fp = _round16(f)
    shapes = list(zip([fp, *hidden], [*hidden, HEAD_PAD]))   # each dW
    n_w = sum(i * o for i, o in shapes)
    n_b = sum(hidden) + HEAD_PAD
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks_a = min(_npad(chunk) // COLS, sms)
    tiles = sum(-(-i // DW_TILE) * -(-o // DW_TILE) for i, o in shapes)
    ranges = max(1, min(-(-DW_BLOCKS_PER_SM * sms // tiles), _npad(chunk) // COLS))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    partial_a, partial_b, out = new(blocks_a, n_b + 4), new(ranges, n_w), new(n_w + n_b + 4)
    obs = obs.contiguous()
    if obs.data_ptr() % 16:   # kernel A reads a tile's rows as 16-byte pieces
        obs = obs.clone()
    dims = (ctypes.c_int * len(hidden))(*hidden)
    hkeep = None
    if net is None:
        w_ptrs = b_ptrs = None
        ptrs, relu, scales = [None] * 5, 0, (0.0,) * 4
    else:
        weights, biases, action, scalars, relu, *scales = net
        w_ptrs, _w = _ptr_array(weights)
        b_ptrs, _b = _ptr_array(biases)
        ptrs = [action.data_ptr(), *[x.data_ptr() for x in scalars]]
        if not relu:   # tanh: the f32 activations each compute thread keeps
            hkeep = new(blocks_a, len(hidden), 16, A_COMPUTE_THREADS, 2)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library_k4().k4_launch(
            obs.data_ptr(), *ptrs, w_ptrs, b_ptrs, ctypes.cast(dims, _PTR), len(hidden), f, fp,
            num_actions, relu, m_rows, *scales, ws.data_ptr(), ws.shape[0], ws.shape[1], chunk,
            partial_a.data_ptr(), blocks_a, partial_b.data_ptr(), ranges,
            None if hkeep is None else hkeep.data_ptr(), out.data_ptr(), stream, stages)
    if err != 0:
        raise RuntimeError(f"K4 kernel launch failed: CUDA error {err}")
    _count(fused_ppo_grads, stages, -(-m_rows // chunk), "k4")
    return out


def _run_k4(params: Params, obs, action, scalars, *, num_actions: int, activation: str,
            clip_eps: float, value_coef: float, entropy_coef: float, inv_m: float,
            chunk: int, stages: int):
    """Pad the net, allocate a workspace of ``chunk`` rows and launch K4.
    Returns (names, hidden widths, out, workspace)."""
    names, L, w, b = dense_layers(params)
    hidden = _check_net(w, L, num_actions, HEAD_PAD, activation)
    m_rows, f = obs.shape
    if m_rows == 0:
        raise ValueError(f"empty minibatch: obs is {tuple(obs.shape)}")
    weights, biases = _k4_net(w, b, L, f, num_actions)
    ws = torch.empty((_ws_rows(hidden, _round16(f))[-1], _npad(chunk)), dtype=BF16,
                     device=obs.device)
    net = (weights, biases, action.to(torch.int32).contiguous(),
           [x.contiguous() for x in scalars], int(activation == "relu"), clip_eps, -inv_m,
           entropy_coef * inv_m, value_coef * inv_m)
    return names, hidden, _k4_call(obs, hidden, num_actions, ws, chunk, stages, net), ws


def _launch_rm(params: Params, obs, action, logp_old, value_old, adv_norm, target,
               num_actions: int, activation: str, clip_eps: float,
               value_coef: float, entropy_coef: float, inv_m: float):
    """K4: kernels A and B over chunks of CHUNK_COLS rows, then the grads
    dict (the merged head split into the policy's and the value's) and the
    loss vector."""
    f = obs.shape[1]
    names, hidden, out, _ = _run_k4(
        params, obs, action, (logp_old, value_old, adv_norm, target), num_actions=num_actions,
        activation=activation, clip_eps=clip_eps, value_coef=value_coef,
        entropy_coef=entropy_coef, inv_m=inv_m, chunk=min(CHUNK_COLS, obs.shape[0]),
        stages=STAGE_CHAIN | STAGE_DW)
    dw, db, dwpv, dbpv, sums = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    grads = _merged_grads(names, dw, db, dwpv, dbpv, num_actions)
    return grads, _loss_vector(sums, inv_m, value_coef, entropy_coef)


def k4_chain(params: Params, obs: torch.Tensor, action: torch.Tensor,
             logp_old: torch.Tensor, value_old: torch.Tensor, adv_norm: torch.Tensor,
             target: torch.Tensor, *, num_actions: int, activation: str, clip_eps: float,
             value_coef: float, entropy_coef: float, total_rows: int = 0) -> K1Chain:
    """K4's kernel A alone, over the whole minibatch (its workspace holds
    every row): the :class:`K1Chain` of :func:`k4_chain_plain`, whose
    operands are views of the workspace.  On CUDA it adds one to
    ``k4_chain.launches``; on the CPU it runs :func:`k4_chain_plain`."""
    scalars = (logp_old, value_old, adv_norm, target)
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef)
    if _check_rm(obs, scalars, action).type == "cpu":
        return k4_chain_plain(params, obs, action, *scalars, total_rows=total_rows, **kw)
    m_rows, f = obs.shape
    inv_m = 1.0 / (total_rows or m_rows)
    _, hidden, out, ws = _run_k4(params, obs, action, scalars, inv_m=inv_m, chunk=m_rows,
                                 stages=STAGE_CHAIN, **kw)
    k4_chain.launches += 1
    _, db, _, dbpv, sums = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    row_h, row_dh, row_dp, _ = _ws_rows(hidden, _round16(f))
    op = lambda r, k: ws[r:r + k, None, :m_rows]
    return K1Chain([op(r, h) for r, h in zip(row_h, hidden)], op(row_dh, num_actions + 1),
                   [op(r, h) for r, h in zip(row_dp, hidden)], db, dbpv[:num_actions + 1], sums)


def k4_dw(chain: K1Chain, obs: torch.Tensor):
    """K4's kernel B alone, on ``chain``'s operands and x^T of ``obs`` (M,
    F) (copied into a workspace of the whole minibatch, zero past row M):
    the dW of ``k1_dw_plain(chain, obs.t()[None])``.  On CUDA it adds one to
    ``k4_dw.launches``; on the CPU it runs :func:`k1_dw_plain`."""
    if obs.device.type == "cpu":
        return k1_dw_plain(chain, obs.t()[None])
    m_rows, f = obs.shape
    hidden = [h.shape[0] for h in chain.hs]
    num_actions = chain.dheads.shape[0] - 1
    row_h, row_dh, row_dp, rows = _ws_rows(hidden, _round16(f))
    ws = torch.zeros((rows, _npad(m_rows)), dtype=BF16, device=obs.device)
    ws[:f, :m_rows] = obs.t()
    for r, x in [*zip(row_h, chain.hs), (row_dh, chain.dheads), *zip(row_dp, chain.dpres)]:
        ws[r:r + x.shape[0], :m_rows] = x[:, 0]
    out = _k4_call(obs, hidden, num_actions, ws, m_rows, STAGE_DW)
    k4_dw.launches += 1
    dw, _, dwpv, _, _ = _unpack(out, [_round16(f), *hidden], HEAD_PAD, f)
    return dw, dwpv[:, :num_actions + 1]


k4_chain.launches = 0
k4_dw.launches = 0


def fused_ppo_grads(params: Params, obs: torch.Tensor, action: torch.Tensor,
                    logp_old: torch.Tensor, value_old: torch.Tensor,
                    adv_norm: torch.Tensor, target: torch.Tensor, *,
                    num_actions: int, activation: str, clip_eps: float,
                    value_coef: float, entropy_coef: float, total_rows: int = 0
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Clipped-PPO gradient of one minibatch, row-major (K4).

    ``obs``: (M, F) bf16 normalised; ``action`` (M,) int; ``logp_old``,
    ``value_old``, ``adv_norm`` (normalised by the caller), ``target``:
    (M,) float32.  ``total_rows`` sets the mean's denominator (0: M).
    Returns ``(grads, losses)`` as :func:`fused_ppo_grads_fm`.  On CUDA this
    launches ``csrc/k4_split.cu`` (kernels A and B over chunks of rows) on
    the current stream without synchronising and adds one to
    ``fused_ppo_grads.launches``; on the CPU it runs
    :func:`fused_ppo_grads_rm_plain`."""
    scalars = (logp_old, value_old, adv_norm, target)
    device = _check_rm(obs, scalars, action)
    kw = dict(num_actions=num_actions, activation=activation, clip_eps=clip_eps,
              value_coef=value_coef, entropy_coef=entropy_coef)
    if device.type == "cpu":
        return fused_ppo_grads_rm_plain(params, obs, action, *scalars,
                                        total_rows=total_rows, **kw)
    inv_m = 1.0 / (total_rows or obs.shape[0])
    result = _launch_rm(params, obs, action, *scalars, inv_m=inv_m, **kw)
    fused_ppo_grads.launches += 1
    return result


zero_fm_counts()
