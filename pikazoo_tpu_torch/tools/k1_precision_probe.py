"""How far K1 sits from a float64 reference, mode by mode, and which of its
products puts it there.  Needs a card and nvcc:

    python3 -m pikazoo_tpu_torch.tools.k1_precision_probe [--time]

The bf16 mode runs ``csrc/fused_update_bf16.cu`` (its two kernels) and the
int8 mode ``csrc/fused_update_int8.cu`` (its split kernels), which the
variants do not touch: each one's row names its source and shows it beside
the plain version once.  The int8fwd mode (the bf16 mode's kernels with an
int8 forward) is not probed.  The modes with the bf16 backward chain run
``csrc/fused_update.cu``, and the
probe builds variants of it into ``build/probe/`` by
substituting the product calls, each with hooks that copy one tile per block
of the kernel's intermediates to device memory:

- ``kernel``: the source as it is;
- ``tensor_head``: the bf16 chain's head ``dh`` on the tensor cores (WMMA,
  as every other product), the kernel before ``head_dh``;
- ``tensor_head+cuda_hidden`` / ``tensor_head+cuda_forward``: that, with
  the hidden ``dh`` products / the forward products on the CUDA cores
  (round-to-nearest FMAs).

It prints, at full width (T=32 frames x N=131072 columns, hidden (256,
256), the inputs of ``chip_smoke.k1_inputs``), the worst grad leaf's
relative L2 of kernel vs plain (K-P), kernel vs the plain version with
float64 dots (K-D) and plain vs that (P-D); the bf16 chain at T = 1, 4, 32;
for the first tile of each block, each dot's error against a float64 dot of
the kernel's own inputs, with the share of errors that point toward zero,
and how often the chain's bf16 roundings flip; and, with ``--time``,
CUDA-event ms of ``kernel`` and ``tensor_head`` per mode of
``fused_update.cu``, interleaved.
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
from pikazoo_tpu_torch.train.networks import BF16, dense_layers

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "probe"
SLOTS = 9  # pre0, pre1, h0, h1, dheads_b, head dh, hidden dh, dpre0, dpre1

HOOKS = r'''
__device__ float* g_dbg;
__device__ void dbg_f(int slot, const float* s, int ld, int rows) {
    float* d = g_dbg + ((size_t)blockIdx.x * %(slots)d + slot) * 256 * COLS;
    for (int i = threadIdx.x; i < rows * COLS; i += blockDim.x) d[i] = s[(i / COLS) * ld + i %% COLS];
}
__device__ void dbg_b(int slot, const bf16* s, int ld, int rows) {
    float* d = g_dbg + ((size_t)blockIdx.x * %(slots)d + slot) * 256 * COLS;
    for (int i = threadIdx.x; i < rows * COLS; i += blockDim.x)
        d[i] = __bfloat162float(s[(i / COLS) * ld + i %% COLS]);
}
extern "C" int set_dbg(void* p) { return (int)cudaMemcpyToSymbol(g_dbg, &p, sizeof(p)); }
template <typename LA, typename LB>
__device__ void gemm_cc(int M, int N, int K, const bf16* A, int lda, const bf16* B, int ldb,
                        float* D, int ldd) {
    for (int i = threadIdx.x; i < M * N; i += blockDim.x) {
        const int m = i / N, n = i %% N;
        float s = 0.0f;
        for (int k = 0; k < K; ++k)
            s = __fmaf_rn(__bfloat162float(*a_at<LA>(A, m, k, lda)),
                          __bfloat162float(*a_at<LB>(B, k, n, ldb)), s);
        D[(size_t)m * ldd + n] = s;
    }
}
''' % {"slots": SLOTS}

TENSOR_FWD, CUDA_FWD = "gemm<CM, RM, false>", "gemm_cc<CM, RM>"
TENSOR_DH, CUDA_DH = "gemm<RM, RM, false>", "gemm_cc<RM, RM>"
HEAD_CUDA = "head_dh(h_top, A + 1, p.w[L], dhb, scratch)"
HEAD_TENSOR = ("gemm<RM, RM, false>(h_top, COLS, HEAD_PAD, p.w[L], HEAD_PAD, dhb, LDH, "
               "scratch, LDS)")
VARIANTS = {  # name: (forward, hidden dh, the bf16 chain's head dh)
    "kernel": (TENSOR_FWD, TENSOR_DH, HEAD_CUDA),
    "tensor_head": (TENSOR_FWD, TENSOR_DH, HEAD_TENSOR),
    "tensor_head+cuda_hidden": (TENSOR_FWD, CUDA_DH, HEAD_TENSOR),
    "tensor_head+cuda_forward": (CUDA_FWD, TENSOR_DH, HEAD_TENSOR),
}
# The modes with sources of their own, which the variants do not touch.
SPLIT = {"none": "fused_update_bf16.cu", "int8": "fused_update_int8.cu"}
# int8fwd alone runs fused_update_bf16.cu's kernels with an int8 forward,
# which the variants do not reach; it is not probed.
MODES = {"none": {}, "bwd_bf16": dict(bwd_bf16=True),
         "int8fwd+bwd_bf16": dict(quant="int8fwd", bwd_bf16=True),
         "int8": dict(quant="int8")}


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"probe anchor not found once in fused_update.cu: {old!r}")
    return src.replace(old, new)


def probe_source() -> str:
    """fused_update.cu with the dump hooks and the products behind the
    macros FWD, HIDDEN_DH and HEAD_DH."""
    s = (_build.CSRC_DIR / "fused_update.cu").read_text()
    s = _sub(s, "template <int QUANT, bool BWD_BF16>\n",
             HOOKS + "template <int QUANT, bool BWD_BF16>\n")
    s = _sub(s, "        const int nvalid = min(COLS, p.N - c0);\n",
             "        const int nvalid = min(COLS, p.N - c0);\n"
             "        const bool DBG = g_dbg != nullptr && tile == first;\n")
    s = _sub(s, "gemm<CM, RM, false>(H, COLS, kdim,", "FWD(H, COLS, kdim,")
    s = _sub(s, "gemm<CM, RM, false>(HEAD_PAD, COLS, h_top,", "FWD(HEAD_PAD, COLS, h_top,")
    s = _sub(s, "__fmul_rn(p.sw[l], S_IN), scratch, LDS);\n            __syncthreads();\n",
             "__fmul_rn(p.sw[l], S_IN), scratch, LDS);\n            __syncthreads();\n"
             "            if (DBG) dbg_f(l, scratch, LDS, H);\n")
    s = _sub(s, "            __syncthreads();\n            boff += H;\n",
             "            __syncthreads();\n"
             "            if (DBG) dbg_b(2 + l, (bf16*)(smem + p.sm_h[l]), LDH, H);\n"
             "            boff += H;\n")
    s = _sub(s, "        __syncthreads();\n        if (head_stage) {\n            row_sums",
             "        __syncthreads();\n        if (DBG) dbg_b(4, dhb, LDH, HEAD_PAD);\n"
             "        if (head_stage) {\n            row_sums")
    s = _sub(s, "                head_dh(h_top, A + 1, p.w[L], dhb, scratch);\n",
             "                HEAD_DH;\n")
    s = _sub(s, "                                    scratch, LDS);\n            __syncthreads();\n",
             "                                    scratch, LDS);\n            __syncthreads();\n"
             "            if (DBG) dbg_f(5, scratch, LDS, h_top);\n")
    s = _sub(s, "                    gemm<RM, RM, false>(K, COLS, H, p.w[l], H, h, LDH, scratch, "
             "LDS);\n                    __syncthreads();\n",
             "                    HIDDEN_DH(K, COLS, H, p.w[l], H, h, LDH, scratch, LDS);\n"
             "                    __syncthreads();\n"
             "                    if (DBG) dbg_f(6, scratch, LDS, K);\n")
    s = _sub(s, "                    h[r * LDH + c] = __float2bfloat16(d);\n                }\n"
             "                __syncthreads();\n",
             "                    h[r * LDH + c] = __float2bfloat16(d);\n                }\n"
             "                __syncthreads();\n                if (DBG) dbg_b(7 + l, h, LDH, H);\n")
    return s


def build_variant(name: str, src: str) -> ctypes.CDLL:
    fwd, hidden, head = VARIANTS[name]
    path = OUT / f"fused_update_{name.replace('+', '_')}.cu"
    path.write_text(f"#define FWD {fwd}\n#define HIDDEN_DH {hidden}\n"
                    f"#define HEAD_DH {head}\n" + src)
    so = path.with_suffix(".so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o", str(so),
           str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.fused_ppo_grads_fm_launch.argtypes = fu._library().fused_ppo_grads_fm_launch.argtypes
    lib.fused_ppo_grads_fm_launch.restype = ctypes.c_int
    lib.set_dbg.argtypes = [ctypes.c_void_p]
    return lib


def use(lib: ctypes.CDLL) -> None:
    """Route fused_ppo_grads_fm's launches to ``lib`` (main restores the
    package's own library when it returns)."""
    fu._library = lambda: lib


def float64_plain(args, kw):
    """The plain version with every product in float64, rounded to f32."""
    mm = torch.matmul
    torch.matmul = lambda a, b: mm(a.double(), b.double()).float()
    try:
        return fu.fused_ppo_grads_fm_plain(*args, **kw)[0]
    finally:
        torch.matmul = mm


def worst(a, b) -> str:
    rel = {k: float((a[k].double() - b[k].double()).norm() / b[k].double().norm()) for k in b}
    k = max(rel, key=rel.get)
    return f"{rel[k]:.3e} ({k})"


def dot_stats(name: str, got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's dot ``got`` and a cuBLAS f32 dot of the same operands,
    each against their float64 dot: relative RMS error and the share of
    nonzero errors that point toward zero (0.5 for round to nearest)."""
    exact = torch.matmul(a.double(), b.double())
    f32 = torch.matmul(a.float(), b.float()).double()
    parts = []
    for label, v in (("kernel", got.double()), ("f32", f32)):
        e = v - exact
        nz = (e != 0) & (exact != 0)
        toward = float(((e * exact.sign())[nz] < 0).double().mean())
        parts.append(f"{label} rel rms {float(e.norm() / exact.norm()):.3e}, "
                     f"toward zero {toward:.3f}")
    print(f"  {name}: " + "; ".join(parts), flush=True)
    return exact


def chain(dh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """bwd_bf16's dpre_b: bf16(dh) * (1 - h*h), op by op in bf16."""
    dh_b, hb = dh.float().to(BF16), h.to(BF16)
    return (dh_b * (1.0 - hb * hb)).float()


def dump(lib, args, kw, tiles_per_frame: int, frames: int) -> None:
    """One kernel call with the hooks on; each dot of the first tile of each
    block against float64, then the bf16 chain's flips at the top layer."""
    params, obs = args[0], args[1]
    blocks = min(frames * tiles_per_frame, torch.cuda.get_device_properties(0).multi_processor_count)
    buf = torch.zeros(blocks * SLOTS * 256 * 64, device="cuda")
    if lib.set_dbg(ctypes.c_void_p(buf.data_ptr())):
        raise RuntimeError("set_dbg failed")
    use(lib)
    fu.fused_ppo_grads_fm(*args, **kw)
    torch.cuda.synchronize()
    lib.set_dbg(ctypes.c_void_p(0))
    pre0, pre1, h0, h1, dhb, dh1, dh0, _, dpre1 = buf.view(blocks, SLOTS, 256, 64).unbind(1)
    tiles = frames * tiles_per_frame
    x = []
    for g in range(blocks):
        first = tiles * g // blocks
        t, c0 = first // tiles_per_frame, (first % tiles_per_frame) * 64
        x.append(obs[t, :, c0:c0 + 64].float())
    x = torch.stack(x)
    _, L, w, _ = dense_layers(params)
    w0, w1 = w[0].to(BF16).float(), w[1].to(BF16).float()
    wpv = torch.cat([w[L], w[L + 1]], 1).to(BF16).float()
    a = wpv.shape[1]
    dot_stats("forward, layer 0", pre0, w0.t(), x)
    dot_stats("forward, layer 1", pre1, w1.t(), h0)
    exact = dot_stats("head dh", dh1, wpv, dhb[:, :a])
    dot_stats("hidden dh", dh0, w1, dpre1)
    got, want = chain(dh1, h1), chain(exact, h1)
    flips = got != want
    d = got - want
    print(f"  bf16 chain, top layer: dpre_b flips {float(flips.double().mean()):.5f} of "
          f"entries vs the float64 dh, toward zero "
          f"{float(((d * want.sign())[flips] < 0).double().mean()):.3f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true", help="time kernel vs tensor_head per mode")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_precision_probe needs a card", file=sys.stderr)
        return 1
    original = fu._library
    try:
        return run(opts)
    finally:
        fu._library = original


def run(opts) -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # the minibatch recipe of phases 9-11

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    OUT.mkdir(parents=True, exist_ok=True)
    src = probe_source()
    fu._library()  # the real library first: the variants take its argtypes
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build_variant(n, src), VARIANTS)))
    tanh = dict(chip_smoke.K1_KW, activation="tanh")
    frames, cols = chip_smoke.K1_FULL
    args = chip_smoke.k1_inputs(frames, cols, "tanh", 21)

    print(f"modes at T={frames} N={cols} [{card}]")
    for mode, mkw in MODES.items():
        kw = dict(tanh, **mkw)
        plain = fu.fused_ppo_grads_fm_plain(*args, **kw)[0]
        exact = float64_plain(args, kw)
        line = [f"P-D {worst(plain, exact)}"]
        for name in (SPLIT[mode],) if mode in SPLIT else ("kernel", "tensor_head"):
            if mode not in SPLIT:
                use(libs[name])
            got = fu.fused_ppo_grads_fm(*args, **kw)[0]
            line.append(f"{name} K-P {worst(got, plain)} K-D {worst(got, exact)}")
        print(f"  {mode}: " + "; ".join(line), flush=True)

    chain_kw = dict(tanh, bwd_bf16=True)
    print(f"bwd_bf16, K-D by variant and frames [{card}]")
    for t in (1, 4, frames):
        sub = [x[:t] if x.dim() > 1 else x for x in args[1:]]
        sub_args = (args[0], *sub)
        exact = float64_plain(sub_args, chain_kw)
        plain = fu.fused_ppo_grads_fm_plain(*sub_args, **chain_kw)[0]
        line = [f"P-D {worst(plain, exact)}"]
        for name, lib in libs.items():
            if t != frames and name not in ("kernel", "tensor_head"):
                continue
            use(lib)
            line.append(f"{name} {worst(fu.fused_ppo_grads_fm(*sub_args, **chain_kw)[0], exact)}")
        print(f"  T={t}: " + "; ".join(line), flush=True)

    for name in ("tensor_head", "kernel"):
        print(f"dots of the first tile of each block, {name}, bwd_bf16 [{card}]")
        dump(libs[name], args, chain_kw, cols // 64, frames)

    if opts.time:
        print(f"CUDA-event ms a call, interleaved tensor_head, kernel, kernel, "
              f"tensor_head [{card}]")
        for mode, mkw in MODES.items():
            if mode in SPLIT:
                continue   # the variants are of fused_update.cu, which this mode does not run
            kw = dict(tanh, **mkw)

            def call(lib):
                use(lib)
                fu.fused_ppo_grads_fm(*args, **kw)

            old, new = libs["tensor_head"], libs["kernel"]
            t = [chip_smoke.cuda_ms(lambda lib=lib: call(lib), 5) for lib in (old, new, new, old)]
            print(f"  {mode}: tensor_head {t[0]:.3f} / {t[3]:.3f}, kernel {t[1]:.3f} / "
                  f"{t[2]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
