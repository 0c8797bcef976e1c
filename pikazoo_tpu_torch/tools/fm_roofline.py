"""The products-only floor of the feature-major PPO gradient kernel K1, on
the card.

Counterpart of the JAX package's ``tools/fm_roofline.py``: K1's eight
products with the loss and every elementwise step stripped to bare casts
(no bias, no activation; the upstream gradient is the rounded logits).  On
the card it runs K1's split design on Hopper's own instructions
(``csrc/fm_roofline.cu``): kernel A, the per-tile chain of the five
products on ``wgmma`` with the weights streamed by TMA (:func:`mm_chain`,
plain version :func:`mm_chain_plain`), writes x, h1, h2, dl, dh2 and dh1
to a workspace; kernel B computes the three dW as long-K ``wgmma``
products over it (:func:`mm_dw`, plain version :func:`mm_dw_plain`).  It
is the floor of K1's layout with the products alone: K1 bf16 is timed
beside it.

    python3 -m pikazoo_tpu_torch.tools.fm_roofline
    python3 -m pikazoo_tpu_torch.tools.fm_roofline --device cpu --frames 2 --cols 1024 \\
        --steps 1 --iters 1

It times, interleaved, min of ``--iters``, each a run of ``--steps`` calls:
the two variants of :func:`mm_grads` (chain: one consumer warpgroup a
block; phased: two, Hopper's ping-pong), K1 bf16
(``train.fused_update.fused_ppo_grads_fm``, tanh, zero biases, a value head
and random scalars) on the same observations and weights, and, for the
record, the same eight products as eight ``torch.matmul`` calls over all
T*N columns at once.  On the card the times are CUDA events; with
``--device cpu`` they are the host's clock and say nothing of the card.
Nothing runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.tools._timing import resolve, timer, where
from pikazoo_tpu_torch.tools.k1_precision_probe import float64_products
from pikazoo_tpu_torch.train.fused_update import PLAIN_COLS, fused_ppo_grads_fm
from pikazoo_tpu_torch.train.networks import BF16

SOURCES = ("fm_roofline.cu",)
COLS = 64         # columns a tile of kernel A
HEAD_PAD = 32     # head rows, padded (dl's rows in the workspace)
WIDTH = 256       # the kernels' hidden width: narrower layers are zero-padded to it
FEATURES = 48     # the kernels' feature rows (x's in the workspace), zero past F
A, F, H = 18, 35, 256
VARIANTS = ("chain", "phased")
KERNELS = ("mm_chain", "mm_dw")  # the keys of ``mm_grads.launches_by_kernel``
# Workspace columns of one chunk, 2,208 bytes a column at hidden (256, 256):
# one frame at the tool's width (~290 MB).  A chunk of 16384 columns (~36 MB)
# stays in the card's 50 MB L2 between kernels A and B but gives kernel B's
# blocks 16 slices each, and the call was slower (PERF.md §6, "P2's chunk").
CHUNK_COLS = 131072
# Kernel B's slices of 64 columns a fresh accumulation on the tensor cores
# before a round-to-nearest add (0: a block's whole column range).  The
# tensor cores' sums round toward zero, so the call's distance from float64
# grows with it; 1 puts the call nearest (3.0x the plain version's, past the
# 2x K1's calls are held to) at ~0.1 ms of kernel B (PERF.md §6's table).
RLEN = 1
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _bf(v: torch.Tensor) -> torch.Tensor:
    return v.to(BF16).float()


def mm_grads_plain(obs: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor,
                   Wp: torch.Tensor) -> Grads:
    """The plain version on any device: the eight products in float32 on
    bf16-valued operands (exact products, f32 sums), rounded to bf16 where
    the kernel rounds, a frame and ``PLAIN_COLS`` columns at a time.
    Returns (dW1, dW2, dWp) float32."""
    w1, w2, wp = (w.to(BF16).float() for w in (W1, W2, Wp))
    bf = lambda v: v.to(BF16).float()
    dw1, dw2, dwp = (torch.zeros_like(w) for w in (w1, w2, wp))
    t_mb, _, n = obs.shape
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            x = obs[t, :, c0:c0 + PLAIN_COLS].float()
            h1 = bf(torch.matmul(w1.t(), x))
            h2 = bf(torch.matmul(w2.t(), h1))
            dl = bf(torch.matmul(wp.t(), h2))
            dwp += torch.matmul(h2, dl.t())
            dh2 = bf(torch.matmul(wp, dl))
            dw2 += torch.matmul(h1, dh2.t())
            dh1 = bf(torch.matmul(w2, dh2))
            dw1 += torch.matmul(x, dh1.t())
    return dw1, dw2, dwp


def mm_grads_float64(obs, W1, W2, Wp) -> Grads:
    """:func:`mm_grads_plain` with every product in float64 (rounded to f32):
    the reference the kernel's and the plain version's sums are measured
    against."""
    return float64_products(mm_grads_plain, obs, W1, W2, Wp)


class MMChain(NamedTuple):
    """What kernel A computes: the dW products' operands, each (rows, T, N)
    bf16: x (F rows), bf16(h1), bf16(h2), bf16(dl) (A rows), bf16(dh2),
    bf16(dh1)."""
    x: torch.Tensor
    h1: torch.Tensor
    h2: torch.Tensor
    dl: torch.Tensor
    dh2: torch.Tensor
    dh1: torch.Tensor


def mm_chain_plain(obs: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor,
                   Wp: torch.Tensor) -> MMChain:
    """The plain version of kernel A, on any device: :func:`mm_grads_plain`'s
    five per-tile products, keeping their rounded outputs, a frame and
    ``PLAIN_COLS`` columns at a time."""
    w1, w2, wp = (_bf(w) for w in (W1, W2, Wp))
    t_mb, f, n = obs.shape
    new = lambda rows: torch.empty((rows, t_mb, n), dtype=BF16, device=obs.device)
    out = MMChain(obs.permute(1, 0, 2), new(w1.shape[1]), new(w2.shape[1]), new(wp.shape[1]),
                  new(w2.shape[1]), new(w1.shape[1]))
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            x = obs[t, :, cols].float()
            h1 = _bf(torch.matmul(w1.t(), x))
            h2 = _bf(torch.matmul(w2.t(), h1))
            dl = _bf(torch.matmul(wp.t(), h2))
            dh2 = _bf(torch.matmul(wp, dl))
            dh1 = _bf(torch.matmul(w2, dh2))
            for dst, v in zip(out[1:], (h1, h2, dl, dh2, dh1)):
                dst[:, t, cols] = v
    return out


def mm_dw_plain(chain: MMChain) -> Grads:
    """The plain version of kernel B, on any device: dW1 = x dh1^T, dW2 = h1
    dh2^T, dWp = h2 dl^T, each a sum over the columns of exact products of
    bf16 operands in f32, a frame and ``PLAIN_COLS`` columns at a time."""
    _, t_mb, n = chain.x.shape
    pairs = ((chain.x, chain.dh1), (chain.h1, chain.dh2), (chain.h2, chain.dl))
    dw = [torch.zeros((a.shape[0], b.shape[0]), device=chain.x.device) for a, b in pairs]
    for t in range(t_mb):
        for c0 in range(0, n, PLAIN_COLS):
            cols = slice(c0, min(n, c0 + PLAIN_COLS))
            for d, (a, b) in zip(dw, pairs):
                d += torch.matmul(a[:, t, cols].float(), b[:, t, cols].float().t())
    return tuple(dw)


def matmul_sequence(x: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor,
                    Wp: torch.Tensor) -> Grads:
    """The same eight products as eight ``torch.matmul`` calls on bf16
    tensors over all columns at once, ``x`` (F, T*N) bf16: a yardstick of
    time only (its dW come out in bf16, and the port never calls it)."""
    h1 = torch.matmul(W1.t(), x)
    h2 = torch.matmul(W2.t(), h1)
    dl = torch.matmul(Wp.t(), h2)
    dwp = torch.matmul(h2, dl.t())
    dh2 = torch.matmul(Wp, dl)
    dw2 = torch.matmul(h1, dh2.t())
    dh1 = torch.matmul(W2, dh2)
    dw1 = torch.matmul(x, dh1.t())
    return dw1, dw2, dwp


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fm_roofline", SOURCES)
    ptr = ctypes.c_void_p
    fn = lib.mm_grads_launch
    fn.argtypes = ([ptr] * 4                        # obs, W1, W2, Wp
                   + [ctypes.c_int] * 6             # T, F, N, phased, chunk
                   + [ptr, ctypes.c_int, ctypes.c_longlong]  # workspace
                   + [ptr, ctypes.c_int, ctypes.c_int]  # kernel B's partial, ranges, rlen
                   + [ptr, ptr, ctypes.c_int])      # out, stream, stages
    fn.restype = ctypes.c_int
    return lib


def _check(obs, W1, W2, Wp) -> torch.device:
    if obs.dim() != 3 or obs.dtype != BF16:
        raise ValueError(f"obs must be (T, F, N) bf16, got {tuple(obs.shape)} {obs.dtype}")
    f, h1 = W1.shape
    if W2.dim() != 2 or W2.shape[0] != h1 or Wp.dim() != 2 or Wp.shape[0] != W2.shape[1] \
            or f != obs.shape[1]:
        raise ValueError(f"weights {tuple(W1.shape)}, {tuple(W2.shape)}, {tuple(Wp.shape)} "
                         f"do not chain from obs {tuple(obs.shape)}")
    for w in (W1, W2, Wp):
        if w.device != obs.device:
            raise ValueError(f"inputs lie on {obs.device} and {w.device}")
    if obs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mm_grads has no version for {obs.device}")
    return obs.device


def _round(x: int, k: int) -> int:
    return -(-x // k) * k


def _widths(f: int, h1: int, h2: int, a: int):
    """(Fp, H1p, H2p): the kernels' padded widths, FEATURES and WIDTH (every
    loop around kernel A's wgmma is then a constant); raises on what they do
    not take."""
    if h1 % 16 or h2 % 16 or max(h1, h2) > WIDTH or not 1 <= a <= HEAD_PAD or f > FEATURES:
        raise ValueError(f"the kernel takes hidden widths of multiples of 16 up to {WIDTH}, "
                         f"1-{HEAD_PAD} head rows and up to {FEATURES} features, got {h1}, {h2}, "
                         f"{a}, {f}")
    return FEATURES, WIDTH, WIDTH


def _padded(W1, W2, Wp, fp: int, h1p: int, h2p: int):
    """The weights in bf16, zero-padded to (Fp, H1p), (H1p, H2p), (H2p, HEAD_PAD)."""
    out = []
    for w, shape in ((W1, (fp, h1p)), (W2, (h1p, h2p)), (Wp, (h2p, HEAD_PAD))):
        z = torch.zeros(shape, dtype=BF16, device=w.device)
        z[:w.shape[0], :w.shape[1]] = w.to(BF16)
        out.append(z)
    return out


def ws_rows(fp: int, h1p: int, h2p: int) -> Tuple[int, ...]:
    """Row offsets of the workspace: x, h1, h2, dl, dh2, dh1, and its rows."""
    rows = [0]
    for k in (fp, h1p, h2p, HEAD_PAD, h2p, h1p):
        rows.append(rows[-1] + k)
    return tuple(rows)


def _chunk(t_mb: int, n: int, chunk_cols: int) -> Tuple[int, int]:
    """(frames, columns) of a chunk of about ``chunk_cols`` columns: whole
    frames where a frame fits, else part of one."""
    if n <= chunk_cols:
        return max(1, min(t_mb, chunk_cols // _round(n, COLS))), n
    return 1, chunk_cols


def _call(obs, weights, widths, *, phased: bool, chunk: Tuple[int, int], ws, stages: int,
          rlen: int = RLEN, shape=None):
    """Launch the kernels over the chunks: kernel A, kernel B or both
    (``stages``; kernel B alone takes ``obs`` None and its (T, F, N) as
    ``shape``).  Returns ``out``: dW1 (Fp, H1p), dW2 (H1p, H2p), dWp (H2p,
    HEAD_PAD)."""
    fp, h1p, h2p = widths
    t_mb, f, n = shape or obs.shape
    device = ws.device
    n_w = fp * h1p + h1p * h2p + h2p * HEAD_PAD
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-h1p // 128) * -(-h2p // 128) + -(-h1p // 128) + -(-h2p // 128)
    ranges = max(1, sms // tiles)
    partial = torch.empty((ranges, n_w), dtype=torch.float32, device=device)
    out = torch.empty(n_w, dtype=torch.float32, device=device)
    nf, nc = chunk
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mm_grads_launch(
            None if obs is None else obs.data_ptr(), *[w.data_ptr() for w in weights], t_mb, f,
            n, int(phased), nf, _round(nc, COLS), ws.data_ptr(), ws.shape[0],
            ws.shape[1], partial.data_ptr(), ranges, rlen, out.data_ptr(), stream, stages)
    if err != 0:
        raise RuntimeError(f"mm_grads kernel launch failed: CUDA error {err}")
    chunks = -(-t_mb // nf) * -(-n // nc)
    for bit, name in ((1, "mm_chain"), (2, "mm_dw")):
        if stages & bit:
            mm_grads.launches_by_kernel[name] += chunks
    return out


def _workspace(widths, chunk, device) -> torch.Tensor:
    nf, nc = chunk
    return torch.empty((ws_rows(*widths)[-1], nf * _round(nc, COLS)), dtype=BF16, device=device)


def _unpack(out, widths, f: int, h1: int, h2: int, a: int) -> Grads:
    fp, h1p, h2p = widths
    dw1 = out[:fp * h1p].view(fp, h1p)[:f, :h1]
    pos = fp * h1p
    dw2 = out[pos:pos + h1p * h2p].view(h1p, h2p)[:h1, :h2]
    pos += h1p * h2p
    dwp = out[pos:pos + h2p * HEAD_PAD].view(h2p, HEAD_PAD)[:h2, :a]
    return dw1, dw2, dwp


def _launch(obs, W1, W2, Wp, phased: bool, chunk_cols: int = CHUNK_COLS,
            rlen: int = RLEN) -> Grads:
    """Kernels A and B over chunks of ``chunk_cols`` columns, kernel B with
    a fresh accumulation every ``rlen`` slices (:func:`rounding_table` varies
    it)."""
    t_mb, f, n = obs.shape
    h1, h2, a = W1.shape[1], W2.shape[1], Wp.shape[1]
    widths = _widths(f, h1, h2, a)
    chunk = _chunk(t_mb, n, chunk_cols)
    out = _call(obs.contiguous(), _padded(W1, W2, Wp, *widths), widths, phased=phased,
                chunk=chunk, ws=_workspace(widths, chunk, obs.device), stages=3, rlen=rlen)
    return _unpack(out, widths, f, h1, h2, a)


def mm_grads(obs: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor, Wp: torch.Tensor,
             *, phased: bool = True) -> Grads:
    """K1's eight products with no loss over ``obs`` (T, F, N) bf16: (dW1,
    dW2, dWp) float32, summed over all T*N columns (the weights are taken in
    bf16).  ``phased`` picks kernel A's variant (two consumer warpgroups a
    block, each on its own tile, against one; ``csrc/fm_roofline.cu``); the
    values do not depend on it, and the default is the faster on an H100
    (PERF.md §6).  On CUDA this launches kernels A and B of
    ``csrc/fm_roofline.cu`` once a chunk of ``CHUNK_COLS`` columns each on
    the current stream without synchronising, adds one to
    ``mm_grads.launches`` and to ``launches_by_variant`` and the chunks to
    ``launches_by_kernel``; on the CPU it runs :func:`mm_grads_plain`."""
    device = _check(obs, W1, W2, Wp)
    if device.type == "cpu":
        return mm_grads_plain(obs, W1, W2, Wp)
    result = _launch(obs, W1, W2, Wp, phased)
    mm_grads.launches += 1
    mm_grads.launches_by_variant[VARIANTS[int(phased)]] += 1
    return result


def mm_chain(obs: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor, Wp: torch.Tensor, *,
             phased: bool = True) -> MMChain:
    """Kernel A alone over the whole minibatch (its workspace holds every
    frame): the :class:`MMChain` of :func:`mm_chain_plain`, whose operands are
    views of the workspace (``mm_chain.workspace`` keeps the last one, its
    padded rows and columns included).  On CUDA it adds one to
    ``mm_chain.launches``; on the CPU it runs :func:`mm_chain_plain`."""
    if _check(obs, W1, W2, Wp).type == "cpu":
        return mm_chain_plain(obs, W1, W2, Wp)
    t_mb, f, n = obs.shape
    h1, h2, a = W1.shape[1], W2.shape[1], Wp.shape[1]
    widths = _widths(f, h1, h2, a)
    chunk = (t_mb, n)
    ws = _workspace(widths, chunk, obs.device)
    _call(obs.contiguous(), _padded(W1, W2, Wp, *widths), widths, phased=phased, chunk=chunk,
          ws=ws, stages=1)
    mm_chain.launches += 1
    mm_chain.workspace = ws
    rows = ws_rows(*widths)
    view = ws.view(rows[-1], t_mb, _round(n, COLS))
    op = lambda i, k: view[rows[i]:rows[i] + k, :, :n]
    return MMChain(op(0, f), op(1, h1), op(2, h2), op(3, a), op(4, h2), op(5, h1))


def mm_dw(chain: MMChain, *, rlen: int = RLEN) -> Grads:
    """Kernel B alone on ``chain``'s operands (copied into a workspace of the
    whole minibatch, zero past them): the dW of :func:`mm_dw_plain`.  On CUDA
    it adds one to ``mm_dw.launches``; on the CPU it runs
    :func:`mm_dw_plain`."""
    if chain.x.device.type == "cpu":
        return mm_dw_plain(chain)
    f, t_mb, n = chain.x.shape
    h1, h2, a = chain.h1.shape[0], chain.h2.shape[0], chain.dl.shape[0]
    widths = _widths(f, h1, h2, a)
    chunk = (t_mb, n)
    ws = _workspace(widths, chunk, chain.x.device).zero_()
    rows = ws_rows(*widths)
    view = ws.view(rows[-1], t_mb, _round(n, COLS))
    for i, x in enumerate(chain):
        view[rows[i]:rows[i] + x.shape[0], :, :n] = x
    weights = [torch.empty(1, device=ws.device)] * 3   # unread by kernel B
    out = _call(None, weights, widths, phased=False, chunk=chunk, ws=ws, stages=2, rlen=rlen,
                shape=(t_mb, f, n))
    mm_dw.launches += 1
    return _unpack(out, widths, f, h1, h2, a)


def zero_counts() -> None:
    mm_grads.launches = 0
    mm_grads.launches_by_variant = {v: 0 for v in VARIANTS}
    mm_grads.launches_by_kernel = {k: 0 for k in KERNELS}
    mm_chain.launches = 0
    mm_dw.launches = 0


zero_counts()


def distance(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """The worst leaf's relative L2 distance."""
    return max(float((g.double() - w.double()).norm() / w.double().norm())
               for g, w in zip(got, want))


def rounding_table(obs, W1, W2, Wp,
                   lengths=(1, 2, 4, 8, 16, 64, 256, 0)) -> Dict[int, Tuple[float, float]]:
    """For each rounding length of kernel B (slices of 64 columns a fresh
    accumulation on the tensor cores; 0: a block's whole column range), the
    worst dW's relative L2 distance from float64 of
    (a) kernel B alone, on kernel A's own operands over the whole minibatch
        (one chunk, so a block's range is the minibatch's columns over its
        ranges), from :func:`mm_dw_plain` on them in float64;
    (b) the call over the wrapper's chunks, from :func:`mm_grads_float64`,
        the distance ``chip_smoke.py`` holds K1's calls to.
    Key -1: the plain versions' (:func:`mm_dw_plain`, :func:`mm_grads_plain`)."""
    chain = mm_chain(obs, W1, W2, Wp)
    exact_b = float64_products(mm_dw_plain, chain)
    exact = mm_grads_float64(obs, W1, W2, Wp)
    table = {-1: (distance(mm_dw_plain(chain), exact_b),
                  distance(mm_grads_plain(obs, W1, W2, Wp), exact))}
    for rlen in lengths:
        call = (_launch(obs, W1, W2, Wp, phased=True, rlen=rlen) if obs.is_cuda
                else mm_grads_plain(obs, W1, W2, Wp))
        table[rlen] = (distance(mm_dw(chain, rlen=rlen), exact_b), distance(call, exact))
    return table


# ----------------------------------------------------------------- tool --
def make_inputs(frames: int, cols: int, seed: int, device):
    """The JAX probe's recipe from a seeded generator: W1, W2 ~ 0.3 N(0, 1),
    Wp ~ 0.05 N(0, 1) (f32), obs uniform in [0, 1) rounded to bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = lambda *s: torch.randn(*s, generator=gen, device=device)
    W1, W2, Wp = 0.3 * normal(F, H), 0.3 * normal(H, H), 0.05 * normal(H, A)
    obs = torch.rand((frames, F, cols), generator=gen, device=device).to(BF16)
    return obs, W1, W2, Wp


def k1_inputs(obs, W1, W2, Wp, seed: int):
    """K1's arguments on the same observations and weights: zero biases, a
    value head ~ 0.5 N(0, 1), random actions and scalars (logp_old about
    the uniform policy's, normalised advantages)."""
    device = obs.device
    t_mb, _, n = obs.shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = lambda *s: torch.randn(*s, generator=gen, device=device)
    zeros = lambda k: torch.zeros(k, device=device)
    params = {"layers.0.kernel": W1, "layers.0.bias": zeros(H),
              "layers.1.kernel": W2, "layers.1.bias": zeros(H),
              "layers.2.kernel": Wp, "layers.2.bias": zeros(A),
              "layers.3.kernel": 0.5 * normal(H, 1), "layers.3.bias": zeros(1)}
    action = torch.randint(0, A, (t_mb, n), generator=gen, device=device, dtype=torch.int32)
    logp_old = -torch.log(torch.tensor(float(A), device=device)) + 0.1 * normal(t_mb, n)
    value_old = normal(t_mb, n)
    adv = normal(t_mb, n)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    target = normal(t_mb, n)
    return params, obs, action, logp_old, value_old, adv, target


K1_KW = dict(num_actions=A, activation="tanh", clip_eps=0.2, value_coef=0.5,
             entropy_coef=0.01)


def run(opts, device, clock) -> Dict[str, float]:
    """ms a call of each timed function, min of ``opts.iters``."""
    obs, W1, W2, Wp = make_inputs(opts.frames, opts.cols, 0, device)
    k1_args = k1_inputs(obs, W1, W2, Wp, 1)
    x_all = obs.permute(1, 0, 2).reshape(F, -1)
    bw = [w.to(BF16) for w in (W1, W2, Wp)]
    steps = opts.steps

    def repeat(fn):
        return lambda: [fn() for _ in range(steps)]

    fns = {f"mm-only {v}": repeat(lambda v=v: mm_grads(obs, W1, W2, Wp, phased=v == "phased"))
           for v in VARIANTS}
    fns["K1 bf16 (fused_ppo_grads_fm)"] = repeat(lambda: fused_ppo_grads_fm(*k1_args, **K1_KW))
    fns["torch.matmul x8 (8 calls)"] = repeat(lambda: matmul_sequence(x_all, *bw))
    for fn in fns.values():  # warm up (builds, caches)
        fn()
    best = {name: float("inf") for name in fns}
    for _ in range(max(1, opts.iters)):
        for name, fn in fns.items():
            best[name] = min(best[name], clock(fn))
    m = opts.frames * opts.cols
    ms = {name: t / steps * 1e3 for name, t in best.items()}
    for name, t in ms.items():
        print(f"[1] {name:32s} {t:10.3f} ms/grad-step ({m / t / 1e3:10.1f}M rows/s)  "
              f"min of {opts.iters}", flush=True)
    k1 = ms["K1 bf16 (fused_ppo_grads_fm)"]
    floor = min(ms[f"mm-only {v}"] for v in VARIANTS)
    print(f"[2] K1 bf16 (split design) {k1:.3f} ms; the products alone in the split design "
          f"on wgmma and TMA {floor:.3f} ms ({floor / k1:.1%} of K1's time)", flush=True)
    return ms


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--frames", type=int, default=32, help="frames T of a minibatch")
    ap.add_argument("--cols", type=int, default=2 * 65536, help="columns N (2B) a frame")
    ap.add_argument("--steps", type=int, default=8, help="calls a timing")
    ap.add_argument("--iters", type=int, default=3, help="timings; the least is kept")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse(argv)
    device = resolve(opts.device, "fm_roofline")
    print(f"[0] M={opts.frames * opts.cols} columns (T={opts.frames}, N={opts.cols}) "
          f"[{where(device)}]", flush=True)
    run(opts, device, timer(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
