"""Where K1's bf16 mode (``csrc/fused_update_bf16.cu``: kernel A, the
per-tile chain, and kernel B, the long-K dW products) spends its time on the
card.  Needs a card and nvcc:

    python3 -m pikazoo_tpu_torch.tools.k1_split_probe

At full width (T=32 frames x N=131072 columns, hidden (256, 256), the inputs
of ``chip_smoke.k1_inputs``) it prints CUDA-event ms (min of two readings of
3-5 calls) of:

- the whole call, kernel A alone and kernel B alone over the wrapper's chunks,
  and kernel B at 1 and 3 resident blocks an SM (``DW_BLOCKS_PER_SM``);
- ``k1_split.cuh``'s ``chain_kernel`` (kernel A of every call that
  ``fused_update.chain_design`` does not give to ``k1_wgmma.cuh``'s
  ``wgmma_chain_kernel``; here the bf16 backward chain, ``bwd_bf16``, the
  full-width mode that still runs it): its time, its cycles a block by phase
  (x load, hidden forward, head forward, loss with the activations'
  copy-out, backward, the operands' copy-out), from a build with clock
  stamps, and its time with parts taken out, each a build of the source
  with one substitution (its results are wrong; only its time is read):
  ``rest`` without the weight stream and the mmas, ``notanh`` with the
  identity for tanh, ``noloss`` without ``ppo_column``.

The variants build into ``build/probe/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.train import fused_update as fu

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "probe"
PHASES = ("x load", "hidden forward", "head forward", "loss + copy h", "backward", "copy out")

STAMP = "        cy1 = clock64(); if (tid == 0) cyc[%d] += cy1 - cy0; cy0 = cy1;\n"
# (anchor, replacement) pairs of the clock-stamped build.
CYCLES = [
    ("// ----------------------------------------------------------- kernel A --",
     "__device__ long long g_cyc[4096];\n"
     "extern \"C\" int get_cyc(void* d) { return (int)cudaMemcpyFromSymbol(d, g_cyc, sizeof(g_cyc)); }\n"
     "// ----------------------------------------------------------- kernel A --"),
    ("    const int L = p.L, A = p.A;\n",
     "    const int L = p.L, A = p.A;\n    __shared__ long long cyc[6];\n"
     "    if (tid < 6) cyc[tid] = 0;\n"),
    ("        const long long wc0 = (long long)tr * p.Npad + c0;\n",
     "        const long long wc0 = (long long)tr * p.Npad + c0;\n"
     "        long long cy0 = clock64(), cy1;\n"),
    ("        // ---- forward: h_l", STAMP % 0 + "        // ---- forward: h_l"),
    ("        // ---- the merged head, before", STAMP % 1 + "        // ---- the merged head, before"),
    ("        // ---- loss and dheads, one thread",
     STAMP % 2 + "        // ---- loss and dheads, one thread"),
    ("        // ---- backward: dh_l", STAMP % 3 + "        // ---- backward: dh_l"),
    ("        // ---- dheads and dpre_l to the workspace.",
     STAMP % 4 + "        // ---- dheads and dpre_l to the workspace."),
    ("                     p.ws_cols, tid, A_THREADS);\n    }\n",
     "                     p.ws_cols, tid, A_THREADS);\n" + STAMP % 5 + "    }\n"),
    ("    float* part = p.partial + (size_t)blockIdx.x * p.stride;\n",
     "    float* part = p.partial + (size_t)blockIdx.x * p.stride;\n"
     "    if (tid < 6) g_cyc[blockIdx.x * 6 + tid] += cyc[tid];\n"),
]
VARIANTS = {
    "rest": [("            if (q + NST - 1 < q_end) load_slice<NST, KS>(p, ring, q + NST - 1);\n", ""),
             ("        if (wt.active) {\n            const bf16* w = ring",
              "        if (false) {\n            const bf16* w = ring")],
    "notanh": [("v0 = p.relu ? fmaxf(v0, 0.0f) : tanhf(v0);", "v0 = p.relu ? fmaxf(v0, 0.0f) : v0;"),
               ("v1 = p.relu ? fmaxf(v1, 0.0f) : tanhf(v1);", "v1 = p.relu ? fmaxf(v1, 0.0f) : v1;")],
    "noloss": [("            if (c < nvalid) {\n                const size_t gi",
                "            if (false) {\n                const size_t gi")],
}


def source() -> str:
    """``csrc/fused_update_bf16.cu`` with ``k1_split.cuh``, where kernel A
    lives, inlined: the text the variants substitute in."""
    src = (_build.CSRC_DIR / "fused_update_bf16.cu").read_text()
    header = (_build.CSRC_DIR / "k1_split.cuh").read_text().replace("#pragma once\n", "")
    return src.replace('#include "k1_split.cuh"\n', header, 1)


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once in fused_update_bf16.cu with "
                               f"k1_split.cuh: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str, src: str) -> ctypes.CDLL:
    path = OUT / f"fused_update_bf16_{name}.cu"
    path.write_text(src)
    so = path.with_suffix(".so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o", str(so),
           str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.k1_bf16_launch.argtypes = fu._library_bf16().k1_bf16_launch.argtypes
    lib.k1_bf16_launch.restype = ctypes.c_int
    return lib


def sm_clock_ghz() -> float:
    """The card's SM clock now (``nvidia-smi --query-gpu=clocks.sm``), GHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0]) / 1e3


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_split_probe needs a card", file=sys.stderr)
        return 1
    original = fu._library_bf16
    try:
        return run()
    finally:
        fu._library_bf16 = original
        fu.DW_BLOCKS_PER_SM = 2


def run() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # the minibatch recipe of phase 9

    card = chip_smoke.card_line()
    OUT.mkdir(parents=True, exist_ok=True)
    src = source()
    builds = {"cycles": substitute(src, CYCLES),
              **{k: substitute(src, v) for k, v in VARIANTS.items()}}
    fu._library_bf16()  # the real library first: the variants take its argtypes
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda k: build_variant(k, builds[k]), builds)))
    real = fu._library_bf16()

    kw = dict(chip_smoke.K1_KW, activation="tanh")
    args = chip_smoke.k1_inputs(*chip_smoke.K1_FULL, "tanh", 21)
    params, obs, action, *scalars = args
    t_mb, _, n = obs.shape
    chunk = fu.chunk_frames(t_mb, n)

    def stage(stages, bwd_bf16=False):
        return lambda: fu._run_bf16(params, obs, action, scalars, inv_m=1.0 / (t_mb * n),
                                    chunk=chunk, stages=stages, bwd_bf16=bwd_bf16, **kw)

    def ms(fn, reps=3):
        fn()
        return min(chip_smoke.cuda_ms(fn, reps) for _ in range(2))

    print(f"K1 bf16 split design at T={t_mb} N={n}, chunks of {chunk} frame(s) [{card}]")
    whole = ms(lambda: fu.fused_ppo_grads_fm(*args, **kw), 5)
    a_ms, b_ms = ms(stage(fu.STAGE_CHAIN)), ms(stage(fu.STAGE_DW))
    print(f"  call {whole:.3f} ms; kernel A alone {a_ms:.3f} ms, kernel B alone {b_ms:.3f} ms "
          f"({fu.DW_BLOCKS_PER_SM} blocks an SM)", flush=True)
    for blocks in (1, 3):
        fu.DW_BLOCKS_PER_SM = blocks
        print(f"  kernel B at {blocks} block(s) an SM: {ms(stage(fu.STAGE_DW)):.3f} ms", flush=True)
    fu.DW_BLOCKS_PER_SM = 2

    chain = stage(fu.STAGE_CHAIN, bwd_bf16=True)
    lib = libs["cycles"]
    fu._library_bf16 = lambda: lib
    chain()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 4096)()
    lib.get_cyc(ctypes.cast(buf, ctypes.c_void_p))
    ghz = sm_clock_ghz()
    blocks = min(chunk * fu._npad(n) // fu.COLS,
                 torch.cuda.get_device_properties(0).multi_processor_count)
    cyc = torch.tensor(buf[:blocks * 6], dtype=torch.float64).view(blocks, 6)
    total = float(cyc.sum())
    phases = ", ".join(f"{name} {float(cyc[:, i].mean()):.3e} "
                       f"({float(cyc[:, i].sum()) / total:.1%})" for i, name in enumerate(PHASES))
    print("  chain_kernel (bwd_bf16), cycles a block by phase (mean over blocks, one call): "
          + phases + f"; total {float(cyc.sum(1).mean()):.3e} = "
            f"{float(cyc.sum(1).mean()) / ghz * 1e-6:.2f} ms at the SM clock read after the "
            f"run, {ghz:.3f} GHz", flush=True)

    fu._library_bf16 = lambda: real
    times = {"kernel": ms(chain)}
    for name in VARIANTS:
        fu._library_bf16 = lambda lib=libs[name]: lib
        times[name] = ms(chain)
    fu._library_bf16 = lambda: real
    print("  chain_kernel (bwd_bf16) alone with parts taken out (ms): " +
          ", ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
