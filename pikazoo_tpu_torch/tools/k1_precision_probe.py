"""How far K1 sits from a float64 reference, mode by mode.  Needs a card and
nvcc:

    python3 -m pikazoo_tpu_torch.tools.k1_precision_probe

Every mode runs its split kernels (``SOURCES``): the bf16 and int8fwd modes,
with or without the bf16 backward chain, ``csrc/fused_update_bf16.cu``, and
the int8 mode ``csrc/fused_update_int8.cu``.  At full width (T=32 frames x
N=131072 columns, hidden (256, 256), the inputs of ``k1_inputs``, which
``chip_smoke.py``'s phases 9-11 use too)
it prints, for each mode beside its source, the worst grad leaf's relative
L2 of kernel vs plain (K-P), kernel vs the plain version with float64
products (K-D) and plain vs that (P-D).  A kernel whose sums lean one way
sits further from float64 than its plain version: in the bf16 backward
chain that was the head's ``dh`` on the tensor cores (3.9e-3 against the
plain version's 1.3e-4, measured on an H100), which is why that product
runs on the CUDA cores (``fma_slice`` in ``csrc/k1_split.cuh``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pikazoo_tpu_torch.tools._timing import card_line
from pikazoo_tpu_torch.train import fused_update as fu
from pikazoo_tpu_torch.train.networks import ActorCritic, apply_fm

# K1's minibatch recipe: the keywords, the full-width shape and the widths
# (``chip_smoke.py``'s phases 9-12 use them too).
K1_KW = dict(num_actions=18, clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)
K1_FULL = (32, 131072)  # a full-width minibatch: 32 frames x 2B = 131072 columns
HIDDEN = (256, 256)
# Each mode's keywords, keyed by ``fu.mode_name``, and its kernels' source.
MODES = {"none": {}, "int8fwd": dict(quant="int8fwd"), "bwd_bf16": dict(bwd_bf16=True),
         "int8fwd+bwd_bf16": dict(quant="int8fwd", bwd_bf16=True), "int8": dict(quant="int8")}
SOURCES = {mode: "fused_update_int8.cu" if kw.get("quant") == "int8" else "fused_update_bf16.cu"
           for mode, kw in MODES.items()}


def k1_inputs(frames: int, cols: int, activation: str, seed: int, hidden=HIDDEN):
    """A minibatch built as tests/test_fused_update.py:32-46 builds one, from
    numpy: uniform bf16 observations, uniform actions, logp_old of the
    network perturbed by 0.3 N(0, 1) so that both clip branches fire,
    normalised N(0, 1) advantages, targets = value + N(0, 1)."""
    rng = np.random.default_rng(seed)
    net = ActorCritic(18, hidden, activation,
                      generator=torch.Generator().manual_seed(seed))
    params = {k: v.detach().cuda() for k, v in net.params().items()}
    card = lambda a: torch.from_numpy(a).cuda()
    obs = card(rng.random((frames, 35, cols), dtype=np.float32)).to(torch.bfloat16)
    action = card(rng.integers(0, 18, (frames, cols)).astype(np.int32))
    logits, value = apply_fm(params, obs.permute(1, 0, 2).reshape(35, -1), activation)
    logp = torch.log_softmax(logits, 0).gather(0, action.reshape(1, -1).long())
    logp_old = logp.reshape(frames, cols) + 0.3 * card(
        rng.standard_normal((frames, cols), dtype=np.float32))
    adv = card(rng.standard_normal((frames, cols), dtype=np.float32))
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    value = value.reshape(frames, cols)
    target = value + card(rng.standard_normal((frames, cols), dtype=np.float32))
    return params, obs, action, logp_old, value, adv, target


def float64_products(fn, *args, **kw):
    """``fn(*args, **kw)`` with every ``torch.matmul`` in float64, rounded to
    f32: a plain version's float64 reference."""
    mm = torch.matmul
    torch.matmul = lambda a, b: mm(a.double(), b.double()).float()
    try:
        return fn(*args, **kw)
    finally:
        torch.matmul = mm


def float64_plain(args, kw):
    """K1's plain version with every product in float64, rounded to f32."""
    return float64_products(fu.fused_ppo_grads_fm_plain, *args, **kw)[0]


def worst(a, b) -> str:
    rel = {k: float((a[k].double() - b[k].double()).norm() / b[k].double().norm()) for k in b}
    k = max(rel, key=rel.get)
    return f"{rel[k]:.3e} ({k})"


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_precision_probe needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    tanh = dict(K1_KW, activation="tanh")
    frames, cols = K1_FULL
    args = k1_inputs(frames, cols, "tanh", 21)
    print(f"modes at T={frames} N={cols} [{card}]")
    for mode, mkw in MODES.items():
        kw = dict(tanh, **mkw)
        plain = fu.fused_ppo_grads_fm_plain(*args, **kw)[0]
        exact = float64_plain(args, kw)
        got = fu.fused_ppo_grads_fm(*args, **kw)[0]
        print(f"  {mode} ({SOURCES[mode]}): P-D {worst(plain, exact)}; K-P {worst(got, plain)} "
              f"K-D {worst(got, exact)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
