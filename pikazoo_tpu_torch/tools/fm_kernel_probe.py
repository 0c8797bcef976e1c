"""The feature-major PPO gradient prototype (split heads), on the card.

Counterpart of the JAX package's ``tools/fm_kernel_probe.py``: the fused
clipped-PPO gradient of a 2-layer tanh MLP, feature-major, with the policy
and value heads apart (:func:`fm_grads`).  Its function is not K1's
(``train.fused_update.fused_ppo_grads_fm``), though it sits close to it; it
differs where the value head is concerned:

- the value is ``sum_h f32(bf16 Wv) * f32(h2_b)``, an f32 sum, not a row of
  the head product;
- ``dh2 = Wp . bf16(dlogits) + f32(bf16 Wv) * dvalue`` with ``dvalue`` in
  f32 (K1 rounds it to bf16);
- ``dWv = sum_c f32(h2_b) * dvalue`` and ``dbv = sum_c dvalue`` in f32;
- ``dbp`` sums the f32 ``dlogits`` while ``dWp`` takes ``bf16(dlogits)``.

Fixed: clip 0.2, value coefficient 0.5, entropy coefficient 0.01, the mean
over all T*N columns, tanh, no action mask; F=35, H=256, A=18 in the tool.

On the card it runs on K1's split design (``csrc/fm_kernel_probe.cu``):
kernel A, the chain kernel of ``csrc/k1_split.cuh`` in its P3 mode
(:func:`p3_chain`, plain version :func:`p3_chain_plain`), writes the dW
products' bf16 operands to a workspace and sums the bias grads, ``dWv`` and
the loss; kernel B, K1's (:func:`p3_dw`, plain version
``train.fused_update.k1_dw_plain``), computes dW1, dW2 and dWp from it.

    python3 -m pikazoo_tpu_torch.tools.fm_kernel_probe
    python3 -m pikazoo_tpu_torch.tools.fm_kernel_probe --device cpu --frames 2 --cols 512 \\
        --steps 1 --iters 1

``--check`` (on by default) holds the loss and each gradient against
autograd of the plain forward :func:`ref_loss` (cos > 0.999 and relative L2
< 0.05, the JAX probe's gate; the autograd path differentiates the f32
activation where the kernel takes the bf16 one); ``--bench`` times
``--steps`` steps of the kernel and ``torch.optim.Adam(3e-4)``, min of
``--iters``.  On the card the times are CUDA events; with ``--device cpu``
they are the host's clock and say nothing of the card.  Nothing runs at
import.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from typing import List, NamedTuple, Sequence

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.tools._timing import resolve, timer, where
from pikazoo_tpu_torch.tools.k1_precision_probe import float64_products
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.fused_update import (HEAD_PAD, HEAD_SPLIT, PLAIN_COLS, VALUE_ROW,
                                                  _loss_and_dheads, k1_dw_plain)
from pikazoo_tpu_torch.train.networks import BF16

SOURCES = ("fm_kernel_probe.cu",)
A, F, H = 18, 35, 256
CLIP, VCOEF, ECOEF = 0.2, 0.5, 0.01
LABELS = ("dW1", "db1", "dW2", "db2", "dWp", "dbp", "dWv", "dbv")
KERNELS = ("p3_chain", "p3_dw")  # the keys of ``fm_grads.launches_by_kernel``


def _bf(v: torch.Tensor) -> torch.Tensor:
    return v.to(BF16).float()


def fm_grads_plain(params: Sequence[torch.Tensor], obs, action, lpold, vold, adv,
                   tgt) -> List[torch.Tensor]:
    """The plain version on any device, transcribed from the JAX kernel
    ``_kernel``: products in float32 on bf16-valued operands, a frame and
    ``PLAIN_COLS`` columns at a time.  Returns the JAX function's outputs:
    dW1, db1 (H1, 1), dW2, db2 (H2, 1), dWp, dbp (A, 1), dWv (H2, 1), dbv
    (1, 1) and the loss sums (1, 8) = [policy, value, entropy, kl, 0 x 4]."""
    W1, b1, W2, b2, Wp, bp, Wv, bv = params
    w1, w2, wp = _bf(W1), _bf(W2), _bf(Wp)
    wvf = _bf(Wv)[:, 0]                                      # (H2,)
    b1f, b2f, bpf, bvf = (b.float() for b in (b1, b2, bp, bv))
    t_mb, _, n = obs.shape
    inv_m = 1.0 / (t_mb * n)
    kw = dict(inv_m=inv_m, clip_eps=CLIP, value_coef=VCOEF, entropy_coef=ECOEF)
    dw1, dw2, dwp = (torch.zeros_like(w) for w in (w1, w2, wp))
    db1, db2, dbp, dwv = (torch.zeros_like(b) for b in (b1f, b2f, bpf, wvf))
    dbv = torch.zeros_like(bvf)
    sums = torch.zeros(4, dtype=torch.float32, device=obs.device)
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            x = obs[t, :, cols].float()
            h1 = _bf(torch.tanh(torch.matmul(w1.t(), x) + b1f[:, None]))
            h2 = _bf(torch.tanh(torch.matmul(w2.t(), h1) + b2f[:, None]))
            logits = torch.matmul(wp.t(), h2) + bpf[:, None]           # (A, C)
            value = (wvf[:, None] * h2).sum(dim=0) + bvf               # (C,)
            chunk_sums, dlogits, dvalue = _loss_and_dheads(
                logits, value, action[t, cols], lpold[t, cols], adv[t, cols],
                vold[t, cols], tgt[t, cols], **kw)
            sums += chunk_sums
            dlb = _bf(dlogits)
            dwp += torch.matmul(h2, dlb.t())
            dbp += dlogits.sum(dim=1)
            dwv += (h2 * dvalue).sum(dim=1)
            dbv += dvalue.sum()
            dpre2 = (torch.matmul(wp, dlb) + wvf[:, None] * dvalue) * (1.0 - h2 * h2)
            dpre2b = _bf(dpre2)
            dw2 += torch.matmul(h1, dpre2b.t())
            db2 += dpre2.sum(dim=1)
            dpre1 = torch.matmul(w2, dpre2b) * (1.0 - h1 * h1)
            dw1 += torch.matmul(x, _bf(dpre1).t())
            db1 += dpre1.sum(dim=1)
    return _outputs(dw1, dw2, dwp, db1, db2, dbp, dwv, dbv, sums)


def fm_grads_float64(params, obs, action, lpold, vold, adv, tgt) -> List[torch.Tensor]:
    """:func:`fm_grads_plain` with every product in float64 (rounded to f32):
    the reference the kernel's and the plain version's sums are measured
    against."""
    return float64_products(fm_grads_plain, params, obs, action, lpold, vold, adv, tgt)


def _outputs(dw1, dw2, dwp, db1, db2, dbp, dwv, dbv, sums) -> List[torch.Tensor]:
    loss = torch.cat([sums, torch.zeros(4, device=sums.device)])[None]
    return [dw1, db1[:, None], dw2, db2[:, None], dwp, dbp[:, None], dwv[:, None],
            dbv.reshape(1, 1), loss]


class P3Chain(NamedTuple):
    """What P3 computes before its dW products (kernel A of
    ``csrc/fm_kernel_probe.cu``): the products' operands at the function's
    rounding points, each (rows, T, N) bf16, and the f32 sums.  ``hs`` are
    bf16(h1), bf16(h2); ``dheads`` bf16(dlogits) (A rows: the value's
    gradient stays f32 and out of every product); ``dpres`` bf16(dpre1),
    bf16(dpre2); ``db`` the f32 row sums of the unrounded dpre1, dpre2;
    ``dbp`` of the f32 dlogits, ``dbv`` (1,) of dvalue; ``dwv`` (H2,) the f32
    sums of h2 * dvalue; ``sums`` the 4 loss sums.  ``hs``, ``dheads`` and
    ``dpres`` are what K1's :func:`~pikazoo_tpu_torch.train.fused_update.k1_dw_plain`
    takes."""
    hs: List[torch.Tensor]
    dheads: torch.Tensor
    dpres: List[torch.Tensor]
    db: List[torch.Tensor]
    dbp: torch.Tensor
    dbv: torch.Tensor
    dwv: torch.Tensor
    sums: torch.Tensor


def p3_chain_plain(params: Sequence[torch.Tensor], obs, action, lpold, vold, adv,
                   tgt) -> P3Chain:
    """The plain version of P3's kernel A, on any device: :func:`fm_grads_plain`'s
    forward, loss and backward chain, a frame and ``PLAIN_COLS`` columns at a
    time, keeping the dW products' operands instead of taking the products."""
    W1, b1, W2, b2, Wp, bp, Wv, bv = params
    w1, w2, wp = _bf(W1), _bf(W2), _bf(Wp)
    wvf = _bf(Wv)[:, 0]                                      # (H2,)
    b1f, b2f, bpf, bvf = (b.float() for b in (b1, b2, bp, bv))
    t_mb, _, n = obs.shape
    inv_m = 1.0 / (t_mb * n)
    kw = dict(inv_m=inv_m, clip_eps=CLIP, value_coef=VCOEF, entropy_coef=ECOEF)
    new = lambda rows: torch.empty((rows, t_mb, n), dtype=BF16, device=obs.device)
    hs = [new(w1.shape[1]), new(w2.shape[1])]
    dpres = [new(w1.shape[1]), new(w2.shape[1])]
    dheads = new(wp.shape[1])
    db = [torch.zeros_like(b1f), torch.zeros_like(b2f)]
    dbp, dwv, dbv = torch.zeros_like(bpf), torch.zeros_like(wvf), torch.zeros_like(bvf)
    sums = torch.zeros(4, dtype=torch.float32, device=obs.device)
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            x = obs[t, :, cols].float()
            h1 = _bf(torch.tanh(torch.matmul(w1.t(), x) + b1f[:, None]))
            h2 = _bf(torch.tanh(torch.matmul(w2.t(), h1) + b2f[:, None]))
            logits = torch.matmul(wp.t(), h2) + bpf[:, None]           # (A, C)
            value = (wvf[:, None] * h2).sum(dim=0) + bvf               # (C,)
            chunk_sums, dlogits, dvalue = _loss_and_dheads(
                logits, value, action[t, cols], lpold[t, cols], adv[t, cols],
                vold[t, cols], tgt[t, cols], **kw)
            sums += chunk_sums
            dlb = _bf(dlogits)
            dbp += dlogits.sum(dim=1)
            dwv += (h2 * dvalue).sum(dim=1)
            dbv += dvalue.sum()
            dpre2 = (torch.matmul(wp, dlb) + wvf[:, None] * dvalue) * (1.0 - h2 * h2)
            dpre2b = _bf(dpre2)
            dpre1 = torch.matmul(w2, dpre2b) * (1.0 - h1 * h1)
            for out, v in ((hs[0], h1), (hs[1], h2), (dheads, dlb), (dpres[0], dpre1),
                           (dpres[1], dpre2b)):
                out[:, t, cols] = v
            db[0] += dpre1.sum(dim=1)
            db[1] += dpre2.sum(dim=1)
    return P3Chain(hs, dheads, dpres, db, dbp, dbv, dwv, sums)


def compose(chain: P3Chain, dw: Sequence[torch.Tensor], dwp: torch.Tensor):
    """The function's outputs (as :func:`fm_grads_plain` returns them) from
    kernel A's sums and kernel B's dW (``k1_dw_plain``'s (dW list, dWp))."""
    return _outputs(dw[0], dw[1], dwp, *chain.db, chain.dbp, chain.dwv, chain.dbv,
                    chain.sums)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fm_kernel_probe", SOURCES)
    ptr = ctypes.c_void_p
    fn = lib.p3_launch
    fn.argtypes = ([ptr] * 6                        # obs and the 5 per-column inputs
                   + [ptr] * 3                      # weights, biases, wv
                   + [ctypes.c_int] * 7             # H1, H2, F, Fp, A, T, N
                   + [ctypes.c_float] * 4           # clip, -1/M, entropy and value scales
                   + [ptr, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]  # workspace
                   + [ptr, ctypes.c_int, ptr, ctypes.c_int]  # partials of A and B
                   + [ptr, ptr, ctypes.c_int])      # out, stream, stages
    fn.restype = ctypes.c_int
    return lib


def _check(params, obs, scalars, action) -> torch.device:
    if obs.dim() != 3 or obs.dtype != BF16:
        raise ValueError(f"obs must be (T, F, N) bf16, got {tuple(obs.shape)} {obs.dtype}")
    rows = (obs.shape[0], obs.shape[2])
    if action.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"action must be int32 or int64, got {action.dtype}")
    for x in (action, *scalars):
        if tuple(x.shape) != rows:
            raise ValueError(f"per-column inputs must be {rows}, got {tuple(x.shape)}")
    for x in scalars:
        if x.dtype != torch.float32:
            raise TypeError(f"per-column float inputs must be float32, got {x.dtype}")
    W1, b1, W2, b2, Wp, bp, Wv, bv = params
    if (W1.shape[0] != obs.shape[1] or W2.shape[0] != W1.shape[1]
            or Wp.shape[0] != W2.shape[1] or tuple(Wv.shape) != (W2.shape[1], 1)
            or b1.shape != W1.shape[1:] or b2.shape != W2.shape[1:]
            or bp.shape != Wp.shape[1:] or tuple(bv.shape) != (1,)):
        raise ValueError("params do not chain: " + ", ".join(
            str(tuple(p.shape)) for p in params))
    for x in (*params, action, *scalars):
        if x.device != obs.device:
            raise ValueError(f"inputs lie on {obs.device} and {x.device}")
    if obs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fm_grads has no version for {obs.device}")
    return obs.device


def _net(params, f: int):
    """The weights as the kernels take them: W1 with zero rows to Fp, W2, the
    split head (H2, HEAD_SPLIT) with Wp in columns 0..A-1 and Wv in
    VALUE_ROW; the biases (the head's likewise); f32(bf16 Wv)."""
    W1, b1, W2, b2, Wp, bp, Wv, bv = params
    h1, h2, a = W1.shape[1], W2.shape[1], Wp.shape[1]
    if h1 % 16 or h2 % 16 or max(h1, h2) > 256 or not 1 <= a < HEAD_PAD:
        raise ValueError(f"the kernel takes hidden widths of multiples of 16 up to 256 and "
                         f"1-{HEAD_PAD - 1} actions, got {h1}, {h2}, {a}")
    device = W1.device
    w1 = torch.zeros((fu._round16(f), h1), dtype=BF16, device=device)
    w1[:f] = W1.to(BF16)
    head = torch.zeros((h2, HEAD_SPLIT), dtype=BF16, device=device)
    head[:, :a] = Wp.to(BF16)
    head[:, VALUE_ROW] = Wv[:, 0].to(BF16)
    bh = torch.zeros(HEAD_SPLIT, dtype=torch.float32, device=device)
    bh[:a] = bp.float()
    bh[VALUE_ROW] = bv.float()[0]
    weights = [w1, W2.to(BF16).contiguous(), head]
    biases = [b1.float().contiguous(), b2.float().contiguous(), bh]
    return weights, biases, _bf(Wv)[:, 0].contiguous()


def _call(params, obs, action, scalars, ws, chunk: int, stages: int):
    """Launch P3's kernels over ``obs`` (T, F, N) through the workspace ``ws``
    (rows, chunk * Npad) bf16, ``chunk`` frames at a time: kernel A, kernel B
    or both (``stages``; kernel B alone reads only ``ws`` and ``obs``, and
    takes ``action`` None).
    Returns ``out`` (``csrc/fm_kernel_probe.cu``'s ``p3_launch``)."""
    t_mb, f, n = obs.shape
    h1, h2 = params[0].shape[1], params[2].shape[1]
    device = obs.device
    fp = fu._round16(f)
    shapes = [(fp, h1), (h1, h2), (h2, HEAD_PAD)]
    n_w = sum(i * o for i, o in shapes)
    stride_a = h1 + h2 + HEAD_PAD + 4 + h2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    npad = fu._npad(n)
    blocks_a = min(chunk * npad // fu.COLS, sms)
    tiles = sum(-(-i // fu.DW_TILE) * -(-o // fu.DW_TILE) for i, o in shapes)
    ranges = max(1, min(-(-fu.DW_BLOCKS_PER_SM * sms // tiles), chunk * npad // fu.COLS))
    partial_a = torch.empty((blocks_a, stride_a), dtype=torch.float32, device=device)
    partial_b = torch.empty((ranges, n_w), dtype=torch.float32, device=device)
    out = torch.empty(n_w + stride_a, dtype=torch.float32, device=device)
    weights, biases, wv = _net(params, f)
    w_ptrs, _w = fu._ptr_array(weights)
    b_ptrs, _b = fu._ptr_array(biases)
    keep = [] if action is None else [action.to(torch.int32).contiguous(),
                                      *[x.contiguous() for x in scalars]]
    ptrs = [x.data_ptr() for x in keep] or [None] * 5
    obs = obs.contiguous()
    inv_m = 1.0 / (t_mb * n)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().p3_launch(
            obs.data_ptr(), *ptrs, w_ptrs, b_ptrs,
            wv.data_ptr(), h1, h2, f, fp, params[4].shape[1], t_mb, n,
            CLIP, -inv_m, ECOEF * inv_m, VCOEF * inv_m, ws.data_ptr(), ws.shape[0], ws.shape[1],
            chunk, partial_a.data_ptr(), blocks_a, partial_b.data_ptr(), ranges,
            out.data_ptr(), stream, stages)
    if err != 0:
        raise RuntimeError(f"fm_grads kernel launch failed: CUDA error {err}")
    chunks = -(-t_mb // chunk)
    for bit, name in ((fu.STAGE_CHAIN, "p3_chain"), (fu.STAGE_DW, "p3_dw")):
        if stages & bit:
            fm_grads.launches_by_kernel[name] += chunks
    return out


def _unpack(out, params, f: int):
    """``out`` -> (dW1, dW2, dWp, db1, db2, dbp, dWv, dbv, loss sums)."""
    h1, h2, a = params[0].shape[1], params[2].shape[1], params[4].shape[1]
    dw, db, dwh, dbh, sums = fu._unpack(out, [fu._round16(f), h1, h2], HEAD_PAD, f)
    pos = fu._round16(f) * h1 + h1 * h2 + h2 * HEAD_PAD + h1 + h2 + HEAD_PAD + 4
    return dw[0], dw[1], dwh[:, :a], db[0], db[1], dbh[:a], out[pos:pos + h2], dbh[a:a + 1], sums


def _workspace(params, obs, frames: int) -> torch.Tensor:
    h1, h2 = params[0].shape[1], params[2].shape[1]
    rows = fu._ws_rows([h1, h2])[-1]
    return torch.empty((rows, frames * fu._npad(obs.shape[2])), dtype=BF16, device=obs.device)


def _launch(params, obs, action, lpold, vold, adv, tgt) -> List[torch.Tensor]:
    """Kernels A and B over chunks of frames (``fu.chunk_frames``)."""
    t_mb, f, n = obs.shape
    chunk = fu.chunk_frames(t_mb, n)
    out = _call(params, obs, action, (lpold, vold, adv, tgt), _workspace(params, obs, chunk),
                chunk, fu.STAGE_CHAIN | fu.STAGE_DW)
    return _outputs(*_unpack(out, params, f))


def fm_grads(params: Sequence[torch.Tensor], obs: torch.Tensor, action: torch.Tensor,
             lpold: torch.Tensor, vold: torch.Tensor, adv: torch.Tensor,
             tgt: torch.Tensor) -> List[torch.Tensor]:
    """The prototype's clipped-PPO gradient over a minibatch, feature-major.

    ``params``: (W1 (F, H1), b1 (H1,), W2 (H1, H2), b2 (H2,), Wp (H2, A),
    bp (A,), Wv (H2, 1), bv (1,)), any float type (the products take them
    in bf16, the biases in f32); ``obs`` (T, F, N) bf16; ``action`` (T, N)
    int; ``lpold``, ``vold``, ``adv`` (normalised), ``tgt``: (T, N) float32.
    Returns the JAX function's outputs, as :func:`fm_grads_plain`.  On CUDA
    this launches ``csrc/fm_kernel_probe.cu``'s kernels A and B once a chunk
    of frames each on the current stream without synchronising, adds one to
    ``fm_grads.launches`` and the chunks to ``fm_grads.launches_by_kernel``;
    on the CPU it runs :func:`fm_grads_plain`."""
    scalars = (lpold, vold, adv, tgt)
    device = _check(params, obs, scalars, action)
    if device.type == "cpu":
        return fm_grads_plain(params, obs, action, *scalars)
    result = _launch(params, obs, action, *scalars)
    fm_grads.launches += 1
    return result


def p3_chain(params: Sequence[torch.Tensor], obs, action, lpold, vold, adv, tgt) -> P3Chain:
    """P3's kernel A alone, over the whole minibatch (its workspace holds every
    frame): the :class:`P3Chain` of :func:`p3_chain_plain`, whose operands are
    views of the workspace (``p3_chain.workspace`` keeps the last one, its
    padded columns included).  On CUDA it adds one to ``p3_chain.launches``;
    on the CPU it runs :func:`p3_chain_plain`."""
    scalars = (lpold, vold, adv, tgt)
    if _check(params, obs, scalars, action).type == "cpu":
        return p3_chain_plain(params, obs, action, *scalars)
    t_mb, f, n = obs.shape
    ws = _workspace(params, obs, t_mb)
    out = _call(params, obs, action, scalars, ws, t_mb, fu.STAGE_CHAIN)
    p3_chain.launches += 1
    p3_chain.workspace = ws
    _, _, _, db1, db2, dbp, dwv, dbv, sums = _unpack(out, params, f)
    h1, h2, a = params[0].shape[1], params[2].shape[1], params[4].shape[1]
    row_h, row_dh, row_dp, rows = fu._ws_rows([h1, h2])
    view = ws.view(rows, t_mb, fu._npad(n))
    op = lambda r, k: view[r:r + k, :, :n]
    return P3Chain([op(row_h[0], h1), op(row_h[1], h2)], op(row_dh, a),
                   [op(row_dp[0], h1), op(row_dp[1], h2)], [db1, db2], dbp, dbv, dwv, sums)


def p3_dw(params: Sequence[torch.Tensor], chain: P3Chain, obs: torch.Tensor):
    """P3's kernel B (K1's) alone on ``chain``'s operands (copied into a
    workspace of the whole minibatch, zero past column N): the dW of
    ``k1_dw_plain``, ([dW1, dW2], dWp).  On CUDA it adds one to
    ``p3_dw.launches``; on the CPU it runs ``k1_dw_plain``."""
    if obs.device.type == "cpu":
        return k1_dw_plain(chain, obs)
    t_mb, f, n = obs.shape
    ws = _workspace(params, obs, t_mb).zero_()
    h1, h2, a = params[0].shape[1], params[2].shape[1], params[4].shape[1]
    row_h, row_dh, row_dp, rows = fu._ws_rows([h1, h2])
    view = ws.view(rows, t_mb, fu._npad(n))
    for r, x in [*zip(row_h, chain.hs), (row_dh, chain.dheads), *zip(row_dp, chain.dpres)]:
        view[r:r + x.shape[0], :, :n] = x
    out = _call(params, obs, None, (), ws, t_mb, fu.STAGE_DW)
    p3_dw.launches += 1
    dw1, dw2, dwp = _unpack(out, params, f)[:3]
    return [dw1, dw2], dwp


def zero_counts() -> None:
    fm_grads.launches = 0
    fm_grads.launches_by_kernel = {k: 0 for k in KERNELS}
    p3_chain.launches = 0
    p3_dw.launches = 0


zero_counts()


def ref_loss(params, obs, action, lpold, vold, adv, tgt, total: int = 0) -> torch.Tensor:
    """The plain forward and loss, differentiable in ``params``: bf16
    operands, f32 accumulation, f32 tanh rounded to bf16 between layers;
    the sum over these columns divided by ``total`` (0: their count), so a
    minibatch can be taken a chunk at a time."""
    W1, b1, W2, b2, Wp, bp, Wv, bv = params
    x = obs.float()                                         # (T, F, N)

    def dg(w, h):
        return torch.einsum("fh,tfn->thn", _bf(w), h)       # (T, H, N)

    h1 = torch.tanh(dg(W1, x) + b1[None, :, None])
    h2 = torch.tanh(dg(W2, _bf(h1)) + b2[None, :, None])
    logits = dg(Wp, _bf(h2)) + bp[None, :, None]
    value = (dg(Wv, _bf(h2)) + bv[None, :, None])[:, 0]
    logp_all = torch.log_softmax(logits, dim=1)
    lp = torch.gather(logp_all, 1, action.long()[:, None])[:, 0]
    ratio = torch.exp(lp - lpold)
    m = total or action.numel()
    pol = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - CLIP, 1 + CLIP) * adv).sum() / m
    vclip = vold + torch.clamp(value - vold, -CLIP, CLIP)
    vl = 0.5 * torch.maximum((value - tgt) ** 2, (vclip - tgt) ** 2).sum() / m
    ent = -(torch.exp(logp_all) * logp_all).sum(dim=1).sum() / m
    return pol + VCOEF * vl - ECOEF * ent


def make_inputs(frames: int, cols: int, seed: int, device):
    """The JAX probe's recipe from a seeded generator: W1, W2 ~ 0.3 N(0, 1),
    Wp ~ 0.05 N, Wv ~ 0.5 N, zero biases; obs uniform bf16, uniform
    actions, logp_old about the uniform policy's, normalised advantages."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = lambda *s: torch.randn(*s, generator=gen, device=device)
    zeros = lambda *s: torch.zeros(*s, device=device)
    params = (0.3 * normal(F, H), zeros(H), 0.3 * normal(H, H), zeros(H),
              0.05 * normal(H, A), zeros(A), 0.5 * normal(H, 1), zeros(1))
    obs = torch.rand((frames, F, cols), generator=gen, device=device).to(BF16)
    action = torch.randint(0, A, (frames, cols), generator=gen, device=device,
                           dtype=torch.int32)
    lpold = -torch.log(torch.tensor(float(A), device=device)) + 0.1 * normal(frames, cols)
    vold = normal(frames, cols)
    adv = normal(frames, cols)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    tgt = normal(frames, cols)
    return params, obs, action, lpold, vold, adv, tgt


def check(params, obs, action, lpold, vold, adv, tgt) -> bool:
    """The JAX probe's FM_CHECK: the fused loss and grads against autograd
    of :func:`ref_loss`, taken a frame at a time; prints each leaf."""
    outs = fm_grads(params, obs, action, lpold, vold, adv, tgt)
    m = action.numel()
    sums = outs[-1][0]
    total = float((sums[0] + VCOEF * sums[1] - ECOEF * sums[2]) / m)
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    ref, grads = 0.0, [torch.zeros_like(p) for p in leaves]
    for t in range(obs.shape[0]):
        frame = [x[t:t + 1] for x in (obs, action, lpold, vold, adv, tgt)]
        loss = ref_loss(leaves, *frame, total=m)
        for g, d in zip(grads, torch.autograd.grad(loss, leaves)):
            g += d
        ref += float(loss.detach())
    print(f"[1] loss fused={total:.6f} ref={ref:.6f}", flush=True)
    ok = True
    for label, g, r in zip(LABELS, outs[:8], grads):
        g, r = g.double().flatten(), r.double().flatten()
        cos = float(g @ r / (g.norm() * r.norm() + 1e-30))
        rel = float((g - r).norm() / (r.norm() + 1e-30))
        good = cos > 0.999 and rel < 0.05
        ok = ok and good
        print(f"    {label}: cos={cos:.6f} rel={rel:.4f} {'ok' if good else 'BAD'}", flush=True)
    print(f"[1] grads {'OK' if ok else 'MISMATCH'}", flush=True)
    return ok


def bench(inputs, steps: int, iters: int, clock) -> float:
    """ms a step of ``steps`` steps of the kernel and Adam(3e-4), min of
    ``iters`` timings (after one untimed run)."""
    params, *rest = inputs
    leaves = [p.detach().clone() for p in params]
    opt = torch.optim.Adam(leaves, lr=3e-4)

    def run():
        for _ in range(steps):
            outs = fm_grads(leaves, *rest)
            for p, g in zip(leaves, outs[:8]):
                p.grad = g.reshape(p.shape)
            opt.step()

    run()
    return min(clock(run) for _ in range(max(1, iters))) / steps * 1e3


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=32, help="frames T of a minibatch")
    ap.add_argument("--cols", type=int, default=2 * 65536, help="columns N (2B) a frame")
    ap.add_argument("--check", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--bench", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--steps", type=int, default=8, help="grad steps a timing")
    ap.add_argument("--iters", type=int, default=2, help="timings; the least is kept")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Returns 1 when the check finds a mismatch, else 0."""
    opts = parse(argv)
    device = resolve(opts.device, "fm_kernel_probe")
    m = opts.frames * opts.cols
    print(f"[0] M={m} columns (T={opts.frames}, N={opts.cols}) [{where(device)}]", flush=True)
    inputs = make_inputs(opts.frames, opts.cols, 0, device)
    ok = check(*inputs) if opts.check else True
    if opts.bench:
        with torch.no_grad():
            ms = bench(inputs, opts.steps, opts.iters, timer(device))
        print(f"[2] fm fused grad+adam {ms:10.3f} ms/grad-step ({m / ms / 1e3:10.1f}M rows/s)",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
