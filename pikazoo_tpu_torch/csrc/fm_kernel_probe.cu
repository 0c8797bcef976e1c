// The feature-major PPO gradient prototype (the probe before K1), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tools/fm_kernel_probe.py:185 `fm_grads` (kernel
// body `_kernel`, :68; pallas_call :211).  Python side and plain version:
// pikazoo_tpu_torch/tools/fm_kernel_probe.py.
//
// What it computes: the clipped-PPO gradient of a 2-layer tanh MLP over a
// minibatch of M = T*N columns (obs (T, F, N) bf16 feature-major, per-column
// action / logp_old / value_old / adv / target), with fixed coefficients
// from the caller, no action mask, and split heads.  It is K1's bf16 mode
// as K1's first, one-kernel design computed it, but for the value head,
// which differs in four places, each transcribed from the TPU kernel:
// - value = sum_h f32(bf16 Wv[h]) * f32(h2_b[h]) + bv, an f32 sum on the
//   CUDA cores, not a head row of the tensor-core product;
// - dh2 = Wp . bf16(dlogits) + f32(bf16 Wv) * dvalue, with dvalue in f32
//   (K1 rounds it to bf16 with the policy rows);
// - dWv = sum_c f32(h2_b) * dvalue and dbv = sum_c dvalue in f32;
// - dbp sums the f32 dlogits while dWp takes bf16(dlogits) (as K1).
// The activation derivative is 1 - h*h of the bf16 activation, as K1's.
// Loss sums [policy, value, entropy, kl].
//
// What bounds it: the tensor cores, as K1: ~457 kFLOP a column at F=35,
// H=256, A=18, ~1.9 TFLOP a full-width call (T=32, N=131072), ~1.94 ms at
// 989 TFLOP/s.
//
// What the design does about it: K1's first (one-kernel) design, which K1
// no longer runs, through the WMMA products of ppo_grads.cuh: 64-column tiles walked by each block over a contiguous
// range; WMMA bf16 products with 16-product chunks added round-to-nearest
// (the tensor cores' f32 sums lean toward zero); activations in shared
// memory with padded row strides; per-block partials of every gradient
// summed over blocks in block order by a second kernel (deterministic, no
// atomics); the per-column loss (ppo_column) one thread a column, with the
// value in head row A.  The value head's sums run a thread a column (the
// forward) and a warp a row (dWv), beside the row sums.

#include <algorithm>

#include "ppo_grads.cuh"

using namespace ppo;

#define COLS 64          // columns a tile
#define LDH (COLS + 8)   // bf16 tiles: x, h1 / dpre1, h2 / dpre2, dlogits
#define LDS (COLS + 4)   // the f32 scratch tile
#define THREADS 512      // 16 warps
#define HEAD_PAD 32      // policy rows (A) and the value row A, padded

struct Params {
    const bf16* obs;         // (T, F, N)
    const int* action;       // (T, N)
    const float* logp_old;
    const float* value_old;
    const float* adv;
    const float* target;
    const bf16* w1;          // (Fp, H1), rows >= F zero
    const bf16* w2;          // (H1, H2)
    const bf16* wp;          // (H2, HEAD_PAD), columns >= A zero
    const bf16* wv;          // (H2,)
    const float* b1;         // (H1,)
    const float* b2;         // (H2,)
    const float* bpv;        // (HEAD_PAD,): bp, then bv at A, then zeros
    int T, F, Fp, N, H1, H2, A;
    float clip, neg_inv_m, ent_scale, val_scale;
    float* partial;          // (blocks, stride)
    int stride;
    // Offsets (floats) inside one block's partial: dW1 at 0, then dW2, dWp
    // (H2, HEAD_PAD), db1, db2, dbpv (HEAD_PAD), dWv (H2), the 4 loss sums.
    int off_w2, off_wp, off_b, off_wv, off_loss;
    // Shared-memory offsets (bytes).
    int sm_x, sm_h1, sm_h2, sm_dl, sm_scratch, sm_bias, sm_wv, sm_bgrad, sm_dwv, sm_loss,
        sm_dval;
};

// acc[r] += sum over the tile's columns of h[r][c] * dval[c]: a warp a row,
// products in f32, then a butterfly in a fixed order (deterministic).
__device__ __forceinline__ void value_weight_sums(const bf16* h, const float* dval, int rows,
                                                  float* acc) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
        float s = __fadd_rn(__fmul_rn(__bfloat162float(h[r * LDH + lane]), dval[lane]),
                            __fmul_rn(__bfloat162float(h[r * LDH + lane + 32]), dval[lane + 32]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) acc[r] += s;
    }
}

// h (rows x COLS bf16) = bf16(tanh(scratch + bias)), the f32 pre-activation
// in scratch.
__device__ __forceinline__ void activate(int rows, const float* scratch, const float* bias,
                                         bf16* h) {
    for (int i = threadIdx.x; i < rows * COLS; i += blockDim.x) {
        const int r = i / COLS, c = i % COLS;
        h[r * LDH + c] = __float2bfloat16(tanhf(__fadd_rn(scratch[r * LDS + c], bias[r])));
    }
}

__global__ void __launch_bounds__(THREADS, 1) fm_grads_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = (bf16*)(smem + p.sm_x);
    bf16* h1 = (bf16*)(smem + p.sm_h1);
    bf16* h2 = (bf16*)(smem + p.sm_h2);
    bf16* dl = (bf16*)(smem + p.sm_dl);
    float* scratch = (float*)(smem + p.sm_scratch);
    float* bias = (float*)(smem + p.sm_bias);      // b1, b2, bpv
    float* wv = (float*)(smem + p.sm_wv);
    float* bgrad = (float*)(smem + p.sm_bgrad);    // db1, db2, dbpv
    float* dwv = (float*)(smem + p.sm_dwv);
    float* closs = (float*)(smem + p.sm_loss);     // [4][COLS], then 4 totals
    float* lacc = closs + 4 * COLS;
    float* dval = (float*)(smem + p.sm_dval);
    const int tid = threadIdx.x;
    const int H1 = p.H1, H2 = p.H2, A = p.A;
    const int nbias = H1 + H2 + HEAD_PAD;
    float* b1 = bias;
    float* b2 = bias + H1;
    float* bpv = bias + H1 + H2;
    float* part = p.partial + (size_t)blockIdx.x * p.stride;

    for (int i = tid; i < p.stride; i += blockDim.x) part[i] = 0.0f;
    for (int i = tid; i < H1; i += blockDim.x) b1[i] = p.b1[i];
    for (int i = tid; i < H2; i += blockDim.x) {
        b2[i] = p.b2[i];
        wv[i] = __bfloat162float(p.wv[i]);
        dwv[i] = 0.0f;
    }
    for (int i = tid; i < HEAD_PAD; i += blockDim.x) bpv[i] = p.bpv[i];
    for (int i = tid; i < nbias; i += blockDim.x) bgrad[i] = 0.0f;
    if (tid < 4) lacc[tid] = 0.0f;
    __syncthreads();

    const int tpf = (p.N + COLS - 1) / COLS;
    const long long tiles = (long long)p.T * tpf;
    const long long first = tiles * blockIdx.x / gridDim.x;
    const long long last = tiles * (blockIdx.x + 1) / gridDim.x;
    for (long long tile = first; tile < last; ++tile) {
        const int t = (int)(tile / tpf);
        const int c0 = (int)(tile % tpf) * COLS;
        const int nvalid = min(COLS, p.N - c0);

        // ---- observations: (Fp, COLS), zero rows >= F and columns >= nvalid.
        const bf16 zero = __float2bfloat16(0.0f);
        for (int i = tid; i < p.Fp * COLS; i += blockDim.x) {
            const int f = i / COLS, c = i % COLS;
            xs[f * LDH + c] = (f < p.F && c < nvalid)
                                ? p.obs[((size_t)t * p.F + f) * p.N + c0 + c] : zero;
        }
        __syncthreads();

        // ---- forward: h_l = bf16(tanh(W_l^T h_{l-1} + b_l)), then the logits.
        gemm<CM, RM, false>(H1, COLS, p.Fp, p.w1, H1, xs, LDH, scratch, LDS);
        __syncthreads();
        activate(H1, scratch, b1, h1);
        __syncthreads();
        gemm<CM, RM, false>(H2, COLS, H1, p.w2, H2, h1, LDH, scratch, LDS);
        __syncthreads();
        activate(H2, scratch, b2, h2);
        __syncthreads();
        gemm<CM, RM, false>(HEAD_PAD, COLS, H2, p.wp, HEAD_PAD, h2, LDH, scratch, LDS);
        __syncthreads();

        // ---- the value (head row A), the loss, dlogits and dvalue, one
        // thread a column.
        if (tid < COLS) {
            const int c = tid;
            float dcol[HEAD_PAD];
            LossTerms lt = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) dcol[r] = 0.0f;
            if (c < nvalid) {
                float v = 0.0f;
                for (int h = 0; h < H2; ++h)
                    v = __fadd_rn(v, __fmul_rn(wv[h], __bfloat162float(h2[h * LDH + c])));
                scratch[A * LDS + c] = v;
                const size_t g = (size_t)t * p.N + c0 + c;
                lt = ppo_column(scratch + c, LDS, bpv, A, A, p.action[g], p.logp_old[g],
                                p.adv[g], p.value_old[g], p.target[g], p.clip, p.neg_inv_m,
                                p.ent_scale, p.val_scale, dcol, dcol + A);
            }
            closs[0 * COLS + c] = lt.pol;
            closs[1 * COLS + c] = lt.val;
            closs[2 * COLS + c] = lt.ent;
            closs[3 * COLS + c] = lt.kl;
            dval[c] = dcol[A];
            // scratch keeps the f32 dlogits and dvalue (row A) for the bias
            // sums; dl the bf16 dlogits alone, for the products.
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) {
                scratch[r * LDS + c] = dcol[r];
                dl[r * LDH + c] = __float2bfloat16(r < A ? dcol[r] : 0.0f);
            }
        }
        __syncthreads();
        row_sums<COLS>(scratch, LDS, HEAD_PAD, bgrad + H1 + H2);
        row_sums<COLS>(closs, COLS, 4, lacc);
        value_weight_sums(h2, dval, H2, dwv);
        // dWp += h2_b . bf16(dlogits)^T.
        gemm<RM, CM, true>(H2, HEAD_PAD, COLS, h2, LDH, dl, LDH, part + p.off_wp, HEAD_PAD);
        __syncthreads();
        // dh2 = Wp . bf16(dlogits); the value head's Wv * dvalue is added
        // below, in f32.
        gemm<RM, RM, false>(H2, COLS, HEAD_PAD, p.wp, HEAD_PAD, dl, LDH, scratch, LDS);
        __syncthreads();

        // ---- backward through the hidden layers: dpre = dh * (1 - h*h) of
        // the bf16 activation; h's buffer takes bf16(dpre).
        for (int i = tid; i < H2 * COLS; i += blockDim.x) {
            const int r = i / COLS, c = i % COLS;
            const float hf = __bfloat162float(h2[r * LDH + c]);
            const float dh = __fadd_rn(scratch[r * LDS + c], __fmul_rn(wv[r], dval[c]));
            const float d = __fmul_rn(dh, __fsub_rn(1.0f, __fmul_rn(hf, hf)));
            scratch[r * LDS + c] = d;
            h2[r * LDH + c] = __float2bfloat16(d);
        }
        __syncthreads();
        row_sums<COLS>(scratch, LDS, H2, bgrad + H1);
        gemm<RM, CM, true>(H1, H2, COLS, h1, LDH, h2, LDH, part + p.off_w2, H2);
        __syncthreads();
        gemm<RM, RM, false>(H1, COLS, H2, p.w2, H2, h2, LDH, scratch, LDS);
        __syncthreads();
        for (int i = tid; i < H1 * COLS; i += blockDim.x) {
            const int r = i / COLS, c = i % COLS;
            const float hf = __bfloat162float(h1[r * LDH + c]);
            const float d = __fmul_rn(scratch[r * LDS + c], __fsub_rn(1.0f, __fmul_rn(hf, hf)));
            scratch[r * LDS + c] = d;
            h1[r * LDH + c] = __float2bfloat16(d);
        }
        __syncthreads();
        row_sums<COLS>(scratch, LDS, H1, bgrad);
        gemm<RM, CM, true>(p.Fp, H1, COLS, xs, LDH, h1, LDH, part, H1);
        __syncthreads();
    }

    // The block's bias grads, dWv and loss sums go after its dW partials.
    for (int i = tid; i < nbias; i += blockDim.x) part[p.off_b + i] = bgrad[i];
    for (int i = tid; i < H2; i += blockDim.x) part[p.off_wv + i] = dwv[i];
    if (tid < 4) part[p.off_loss + tid] = lacc[tid];
}

extern "C" int fm_grads_launch(
    const void* obs, const void* action, const void* logp_old, const void* value_old,
    const void* adv, const void* target, const void* w1, const void* w2, const void* wp,
    const void* wv, const void* b1, const void* b2, const void* bpv, int frames,
    int obs_dim, int obs_dim_pad, int cols, int h1, int h2, int num_actions,
    float clip_eps, float neg_inv_m, float ent_scale, float val_scale, void* partial,
    int blocks, int stride, void* out, void* stream) {
    if (frames < 1 || cols < 1 || blocks < 1 || obs_dim > obs_dim_pad || obs_dim_pad % 16 ||
        h1 % 16 || h2 % 16 || h1 <= 0 || h2 <= 0 || h1 > 256 || h2 > 256 ||
        num_actions < 1 || num_actions + 1 > HEAD_PAD)
        return (int)cudaErrorInvalidValue;
    Params p = {};
    p.obs = (const bf16*)obs;
    p.action = (const int*)action;
    p.logp_old = (const float*)logp_old;
    p.value_old = (const float*)value_old;
    p.adv = (const float*)adv;
    p.target = (const float*)target;
    p.w1 = (const bf16*)w1;
    p.w2 = (const bf16*)w2;
    p.wp = (const bf16*)wp;
    p.wv = (const bf16*)wv;
    p.b1 = (const float*)b1;
    p.b2 = (const float*)b2;
    p.bpv = (const float*)bpv;
    p.T = frames;
    p.F = obs_dim;
    p.Fp = obs_dim_pad;
    p.N = cols;
    p.H1 = h1;
    p.H2 = h2;
    p.A = num_actions;
    p.clip = clip_eps;
    p.neg_inv_m = neg_inv_m;
    p.ent_scale = ent_scale;
    p.val_scale = val_scale;
    p.partial = (float*)partial;
    p.stride = stride;
    p.off_w2 = obs_dim_pad * h1;
    p.off_wp = p.off_w2 + h1 * h2;
    p.off_b = p.off_wp + h2 * HEAD_PAD;
    p.off_wv = p.off_b + h1 + h2 + HEAD_PAD;
    p.off_loss = p.off_wv + h2;
    if (p.off_loss + 4 > stride || stride % 64) return (int)cudaErrorInvalidValue;

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
    p.sm_bias = sm;
    sm = align128(sm + (h1 + h2 + HEAD_PAD) * 4);
    p.sm_wv = sm;
    sm = align128(sm + h2 * 4);
    p.sm_bgrad = sm;
    sm = align128(sm + (h1 + h2 + HEAD_PAD) * 4);
    p.sm_dwv = sm;
    sm = align128(sm + h2 * 4);
    p.sm_loss = sm;
    sm = align128(sm + (4 * COLS + 4) * 4);
    p.sm_dval = sm;
    sm = align128(sm + COLS * 4);

    cudaError_t err = cudaFuncSetAttribute(
        fm_grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    fm_grads_kernel<<<blocks, THREADS, sm, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials<<<(stride + 255) / 256, 256, 0, s>>>((const float*)partial, blocks,
                                                          stride, (float*)out);
    return (int)cudaGetLastError();
}
