"""The products-only floor of the feature-major PPO gradient kernel K1, on
the card.

Counterpart of the JAX package's ``tools/fm_roofline.py``: K1's eight
products with the loss and every elementwise step stripped to bare casts
(no bias, no activation; the upstream gradient is the rounded logits), in
K1's first, one-kernel design (``csrc/fm_roofline.cu``: a 64-column tile,
WMMA products and per-block partials of every dW).  It stays a port of the
JAX tool's products floor; no mode of K1 runs that design any more (every
mode runs the split kernels of ``csrc/fused_update_bf16.cu`` or
``csrc/fused_update_int8.cu``), so it stands for none of them.  K1 bf16 is
timed beside it.

    python3 -m pikazoo_tpu_torch.tools.fm_roofline
    python3 -m pikazoo_tpu_torch.tools.fm_roofline --device cpu --frames 2 --cols 1024 \\
        --steps 1 --iters 1

It times, interleaved, min of ``--iters``, each a run of ``--steps`` calls:
the two orders of :func:`mm_grads` (chain, phased), K1 bf16
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
from typing import Dict, Tuple

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.tools._timing import resolve, timer, where
from pikazoo_tpu_torch.train.fused_update import PLAIN_COLS, fused_ppo_grads_fm
from pikazoo_tpu_torch.train.networks import BF16

SOURCES = ("fm_roofline.cu",)
COLS = 64         # columns a tile (K1's)
HEAD_PAD = 32     # head rows, padded
A, F, H = 18, 35, 256
VARIANTS = ("chain", "phased")
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
    fn = lib.mm_grads_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
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


def _launch(obs, W1, W2, Wp, phased: bool) -> Grads:
    t_mb, f, n = obs.shape
    h1, h2, a = W1.shape[1], W2.shape[1], Wp.shape[1]
    if h1 % 16 or h2 % 16 or max(h1, h2) > 256 or not 1 <= a <= HEAD_PAD:
        raise ValueError(f"the kernel takes hidden widths of multiples of 16 up to 256 and "
                         f"1-{HEAD_PAD} head rows, got {h1}, {h2}, {a}")
    device = obs.device
    fp = -(-f // 16) * 16
    w1 = torch.zeros((fp, h1), dtype=BF16, device=device)
    w1[:f] = W1.to(BF16)
    wp = torch.zeros((h2, HEAD_PAD), dtype=BF16, device=device)
    wp[:, :a] = Wp.to(BF16)
    w2 = W2.to(BF16).contiguous()
    stride = -(-(fp * h1 + h1 * h2 + h2 * HEAD_PAD) // 64) * 64
    frames_a_tile = 2 if phased else 1
    tiles = -(-t_mb // frames_a_tile) * -(-n // (COLS // frames_a_tile))
    blocks = min(tiles, torch.cuda.get_device_properties(device).multi_processor_count)
    partial = torch.empty((blocks, stride), dtype=torch.float32, device=device)
    out = torch.empty(stride, dtype=torch.float32, device=device)
    obs = obs.contiguous()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().mm_grads_launch(
            obs.data_ptr(), w1.data_ptr(), w2.data_ptr(), wp.data_ptr(), t_mb, f, fp, n,
            h1, h2, a, int(phased), partial.data_ptr(), blocks, stride, out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"mm_grads kernel launch failed: CUDA error {err}")
    dw1 = out[:fp * h1].view(fp, h1)[:f]
    dw2 = out[fp * h1:fp * h1 + h1 * h2].view(h1, h2)
    pos = fp * h1 + h1 * h2
    dwp = out[pos:pos + h2 * HEAD_PAD].view(h2, HEAD_PAD)[:, :a]
    return dw1, dw2, dwp


def mm_grads(obs: torch.Tensor, W1: torch.Tensor, W2: torch.Tensor, Wp: torch.Tensor,
             *, phased: bool = False) -> Grads:
    """K1's eight products with no loss over ``obs`` (T, F, N) bf16: (dW1,
    dW2, dWp) float32, summed over all T*N columns (the weights are taken in
    bf16).  ``phased`` picks the order in the kernel (the forwards of two
    frames before their backwards, 32 columns a frame; the module docstring
    of ``csrc/fm_roofline.cu``); the values do not depend on it.  On CUDA
    this launches ``csrc/fm_roofline.cu`` on the current stream without
    synchronising and adds one to ``mm_grads.launches`` and to
    ``launches_by_variant``; on the CPU it runs :func:`mm_grads_plain`."""
    device = _check(obs, W1, W2, Wp)
    if device.type == "cpu":
        return mm_grads_plain(obs, W1, W2, Wp)
    result = _launch(obs, W1, W2, Wp, phased)
    mm_grads.launches += 1
    mm_grads.launches_by_variant[VARIANTS[int(phased)]] += 1
    return result


def zero_counts() -> None:
    mm_grads.launches = 0
    mm_grads.launches_by_variant = {v: 0 for v in VARIANTS}


zero_counts()


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
    print(f"[2] K1 bf16 (split design) {k1:.3f} ms; the products alone in the one-kernel "
          f"design {floor:.3f} ms ({k1 / floor:.1%} of it)", flush=True)
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
