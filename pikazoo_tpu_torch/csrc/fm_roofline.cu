// K1's product sequence with no loss, for Hopper (sm_90a): the products-only
// floor of the feature-major PPO gradient kernel in K1's own design.
//
// Replaces the TPU kernel tools/fm_roofline.py:95 `mm_grads` (kernel body
// `_mm_kernel`, :42; pallas_call :109).  Python side and plain version:
// pikazoo_tpu_torch/tools/fm_roofline.py.
//
// What it computes, for obs (T, F, N) bf16 feature-major and bf16 weights W1
// (F, H1), W2 (H1, H2), Wp (H2, A), summed over all T*N columns, with no
// bias, no activation and no loss (the upstream gradient is the logits
// themselves, rounded):
//   h1 = bf16(W1^T x), h2 = bf16(W2^T h1), dl = bf16(Wp^T h2);
//   dWp += h2 dl^T, dh2 = bf16(Wp dl), dW2 += h1 dh2^T,
//   dh1 = bf16(W2 dh2), dW1 += x dh1^T.
// Eight products, bf16 operands, f32 sums; dW1, dW2, dWp f32.
//
// What bounds it: the tensor cores.  At F=35, H=256, A=18 the products are
// ~457 kFLOP a column, ~1.9 TFLOP a full-width call (T=32, N=131072),
// against 70 bytes of input a column: ~1.94 ms at 989 TFLOP/s.
//
// What the design does about it: nothing new, on purpose.  It is K1's
// first, one-kernel design with the loss and the elementwise work taken
// out, as the TPU tool strips the TPU kernel; that design is gone from the
// port (K1 runs the split design of fused_update_bf16.cu in every mode), so
// this kernel is the JAX tool's products floor and stands for no mode the
// port runs.  It keeps that design: the same
// 64-column tile walked by each block over a contiguous range, the same
// WMMA products with 16-product chunks added round-to-nearest
// (ppo::gemm), the activations in shared memory with the same padded row
// strides, weights read as fragments from global memory (L2), and the same
// per-block partials of every dW, read-modify-written tile after tile and
// summed over blocks in block order by a second kernel (deterministic).
//
// The two orders of the TPU probe (its tile sizes do not change the values):
// - chain (PHASED = false): a tile is 64 columns of one frame, forward then
//   backward, as K1.
// - phased (PHASED = true): the forwards of two frames run before their
//   backwards.  Two frames' activations at K1's 64 columns each take ~240 KB
//   of shared memory, more than a block has (227 KB), so each frame takes
//   32 columns: a tile holds frame 2g in its columns 0-31 and frame 2g+1 in
//   32-63, and every product runs over both frames at once, so each warp's
//   strip of four 16-column fragments issues independent mma chains of two
//   frames.  The dW products then sum both frames' columns in one
//   read-modify-write of the partials.

#include <algorithm>

#include "ppo_grads.cuh"

using namespace ppo;

#define COLS 64          // columns a tile (K1's)
#define LDH (COLS + 8)   // bf16 tiles: x, h1 / dh1, h2 / dh2, dl
#define LDS (COLS + 4)   // the f32 scratch tile
#define THREADS 512      // 16 warps
#define HEAD_PAD 32      // head rows (A), padded

struct Params {
    const bf16* obs;     // (T, F, N)
    const bf16* w1;      // (Fp, H1), rows >= F zero
    const bf16* w2;      // (H1, H2)
    const bf16* wp;      // (H2, HEAD_PAD), columns >= A zero
    int T, F, Fp, N, H1, H2;
    float* partial;      // (blocks, stride): dW1 (Fp, H1), dW2 (H1, H2), dWp (H2, HEAD_PAD)
    int stride, off_w2, off_wp;
    int sm_x, sm_h1, sm_h2, sm_dl, sm_scratch;
};

// dst (rows x COLS bf16, stride LDH) = bf16(scratch (rows x COLS f32)).
__device__ __forceinline__ void round_tile(int rows, const float* scratch, bf16* dst) {
    for (int i = threadIdx.x; i < rows * COLS; i += blockDim.x) {
        const int r = i / COLS, c = i % COLS;
        dst[r * LDH + c] = __float2bfloat16(scratch[r * LDS + c]);
    }
}

template <bool PHASED>
__global__ void __launch_bounds__(THREADS, 1) mm_grads_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = (bf16*)(smem + p.sm_x);
    bf16* h1 = (bf16*)(smem + p.sm_h1);
    bf16* h2 = (bf16*)(smem + p.sm_h2);
    bf16* dl = (bf16*)(smem + p.sm_dl);
    float* scratch = (float*)(smem + p.sm_scratch);
    const int tid = threadIdx.x;
    float* part = p.partial + (size_t)blockIdx.x * p.stride;
    for (int i = tid; i < p.stride; i += blockDim.x) part[i] = 0.0f;
    __syncthreads();

    constexpr int FPT = PHASED ? 2 : 1;       // frames a tile
    constexpr int CPF = COLS / FPT;           // columns of each frame
    const int tpf = (p.N + CPF - 1) / CPF;    // column blocks
    const long long tiles = (long long)((p.T + FPT - 1) / FPT) * tpf;
    const long long first = tiles * blockIdx.x / gridDim.x;
    const long long last = tiles * (blockIdx.x + 1) / gridDim.x;
    for (long long tile = first; tile < last; ++tile) {
        const int t0 = (int)(tile / tpf) * FPT;
        const int c0 = (int)(tile % tpf) * CPF;

        // ---- observations: (Fp, COLS), zero past F, T and N.
        const bf16 zero = __float2bfloat16(0.0f);
        for (int i = tid; i < p.Fp * COLS; i += blockDim.x) {
            const int f = i / COLS, c = i % COLS;
            const int t = t0 + c / CPF, col = c0 + c % CPF;
            xs[f * LDH + c] = (f < p.F && t < p.T && col < p.N)
                                ? p.obs[((size_t)t * p.F + f) * p.N + col] : zero;
        }
        __syncthreads();

        // ---- forward.
        gemm<CM, RM, false>(p.H1, COLS, p.Fp, p.w1, p.H1, xs, LDH, scratch, LDS);
        __syncthreads();
        round_tile(p.H1, scratch, h1);
        __syncthreads();
        gemm<CM, RM, false>(p.H2, COLS, p.H1, p.w2, p.H2, h1, LDH, scratch, LDS);
        __syncthreads();
        round_tile(p.H2, scratch, h2);
        __syncthreads();
        gemm<CM, RM, false>(HEAD_PAD, COLS, p.H2, p.wp, HEAD_PAD, h2, LDH, scratch, LDS);
        __syncthreads();
        round_tile(HEAD_PAD, scratch, dl);   // the fabricated upstream gradient
        __syncthreads();

        // ---- backward.
        gemm<RM, CM, true>(p.H2, HEAD_PAD, COLS, h2, LDH, dl, LDH, part + p.off_wp, HEAD_PAD);
        __syncthreads();
        gemm<RM, RM, false>(p.H2, COLS, HEAD_PAD, p.wp, HEAD_PAD, dl, LDH, scratch, LDS);
        __syncthreads();
        round_tile(p.H2, scratch, h2);       // h2's buffer takes bf16(dh2)
        __syncthreads();
        gemm<RM, CM, true>(p.H1, p.H2, COLS, h1, LDH, h2, LDH, part + p.off_w2, p.H2);
        __syncthreads();
        gemm<RM, RM, false>(p.H1, COLS, p.H2, p.w2, p.H2, h2, LDH, scratch, LDS);
        __syncthreads();
        round_tile(p.H1, scratch, h1);       // h1's buffer takes bf16(dh1)
        __syncthreads();
        gemm<RM, CM, true>(p.Fp, p.H1, COLS, xs, LDH, h1, LDH, part, p.H1);
        __syncthreads();
    }
}

extern "C" int mm_grads_launch(const void* obs, const void* w1, const void* w2,
                               const void* wp, int frames, int obs_dim, int obs_dim_pad,
                               int cols, int h1, int h2, int num_actions, int phased,
                               void* partial, int blocks, int stride, void* out,
                               void* stream) {
    if (frames < 1 || cols < 1 || blocks < 1 || obs_dim > obs_dim_pad || obs_dim_pad % 16 ||
        h1 % 16 || h2 % 16 || h1 <= 0 || h2 <= 0 || h1 > 256 || h2 > 256 ||
        num_actions < 1 || num_actions > HEAD_PAD)
        return (int)cudaErrorInvalidValue;
    Params p = {};
    p.obs = (const bf16*)obs;
    p.w1 = (const bf16*)w1;
    p.w2 = (const bf16*)w2;
    p.wp = (const bf16*)wp;
    p.T = frames;
    p.F = obs_dim;
    p.Fp = obs_dim_pad;
    p.N = cols;
    p.H1 = h1;
    p.H2 = h2;
    p.partial = (float*)partial;
    p.stride = stride;
    p.off_w2 = obs_dim_pad * h1;
    p.off_wp = p.off_w2 + h1 * h2;
    if (p.off_wp + h2 * HEAD_PAD > stride || stride % 64) return (int)cudaErrorInvalidValue;
    int sm = 0;
    p.sm_x = sm;
    sm = align128(sm + obs_dim_pad * LDH * 2);
    p.sm_h1 = sm;
    sm = align128(sm + h1 * LDH * 2);
    p.sm_h2 = sm;
    sm = align128(sm + h2 * LDH * 2);
    p.sm_dl = sm;
    sm = align128(sm + HEAD_PAD * LDH * 2);
    p.sm_scratch = sm;
    sm = align128(sm + std::max(std::max(h1, h2), HEAD_PAD) * LDS * 4);

    void (*kernel)(const Params) = phased ? mm_grads_kernel<true> : mm_grads_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    kernel<<<blocks, THREADS, sm, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials<<<(stride + 255) / 256, 256, 0, s>>>((const float*)partial, blocks,
                                                          stride, (float*)out);
    return (int)cudaGetLastError();
}
