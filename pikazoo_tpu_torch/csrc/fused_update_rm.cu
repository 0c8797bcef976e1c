// The fused clipped-PPO minibatch gradient, row-major (K4), for Hopper.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:651
// `fused_ppo_grads` (kernel body `_kernel`, :58; pallas_call :719).  Python
// side: pikazoo_tpu_torch/train/fused_update.py, which also holds the plain
// PyTorch version this kernel is held against.
//
// What it computes, for a minibatch of M rows (obs (M, F) bf16, per-row
// action / logp_old / value_old / adv / target): the same clipped-PPO
// gradient as K1 (fused_update.cu) with three differences, each transcribed
// from the TPU kernel:
// - the activation derivative is taken from the f32 activation h, not from
//   its bf16 round (1 - h*h; relu's h > 0 is the same either way);
// - the policy and value heads are two products: in the backward dh =
//   dlogits_b . Wp^T + dvalue_b . Wv^T, summed in f32;
// - rows are tiled, each with its own scalars.
//
// What bounds it.  The same work as K1: about 159 kFLOP forward and 300
// kFLOP backward per row at hidden (256, 256), ~1.9 TFLOP per full-width
// call (M = 4,194,304), against ~90 bytes of input per row: compute-bound.
// The floor is the tensor cores' bf16 rate, ~1.94 ms a call at 989 TFLOP/s.
//
// What the design does about it.  K1's design (see fused_update.cu): WMMA
// bf16 products with 16-product chunks added round-to-nearest, activations
// in shared memory, per-block partials of every gradient reduced in block
// order by a second kernel (no atomics: deterministic).  Rows are held
// transposed, feature-major, in shared memory, so the products, the row sums
// and the per-row loss are K1's code (ppo_grads.cuh).
// - The f32 activations are kept for the backward beside the bf16 ones:
//   2 x 64 KB more at K1's 64-column tile and hidden (256, 256), which does
//   not fit beside K1's ~160 KB.  The tile is 32 rows instead, which halves
//   every per-tile buffer; the f32 and bf16 activations of both layers, the
//   scratch tile and dheads then take ~164 KB.  Recomputing the
//   pre-activation in the backward would keep 64 rows, but it is exact only
//   if the recomputed product sums in the forward's order, and it adds a
//   product per layer.  The narrower tile costs twice as many
//   read-modify-writes of the dW partials per row (K1 spends a third of its
//   time there): expect K4 slower than K1.
// - Split heads: the head is 48 rows, the policy in rows 0..A-1 (A <= 32),
//   zeros to row 31, the value in row 32.  The dh product sums its K = 48
//   rows in 16-row chunks with a rounded add after each, so the value head's
//   chunk is added, in f32, to the finished policy product: the TPU kernel's
//   two products summed.  The forward heads and the head dW are the same
//   dot products either way.

#include "ppo_grads.cuh"

using namespace ppo;

#define ROWS 32          // rows per tile
#define LDH (ROWS + 8)   // bf16 tiles: x, h_l / dpre_l, dheads
#define LDS (ROWS + 4)   // f32 tiles: scratch, the f32 activations
#define THREADS 512      // 16 warps
#define HEAD_PAD 48      // policy rows padded to 32, then the value row
#define VALUE_ROW 32
#define MAX_LAYERS 4

struct Params {
    const bf16* obs;         // (M, F)
    const int* action;       // (M,)
    const float* logp_old;
    const float* value_old;
    const float* adv;
    const float* target;
    const bf16* w[MAX_LAYERS + 1];   // w[0] (Fp, H0) zero-padded rows; w[l] (H_{l-1}, H_l); w[L] head (H_{L-1}, 48)
    const float* b[MAX_LAYERS + 1];  // b[l] (H_l); b[L] (48)
    int hidden[MAX_LAYERS];
    int L, F, Fp, A, relu, M;
    float clip, neg_inv_m, ent_scale, val_scale;
    float* partial;          // (blocks, stride)
    int stride;
    int off_w[MAX_LAYERS + 1];
    int off_b[MAX_LAYERS + 1];
    int off_loss;
    int sm_x, sm_h[MAX_LAYERS], sm_hf[MAX_LAYERS], sm_dh, sm_scratch, sm_bias,
        sm_bgrad, sm_loss;
    int bias_total;          // sum H_l + 48
};

__global__ void __launch_bounds__(THREADS, 1) ppo_grads_rm_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = (bf16*)(smem + p.sm_x);
    bf16* dhb = (bf16*)(smem + p.sm_dh);
    float* scratch = (float*)(smem + p.sm_scratch);
    float* bias = (float*)(smem + p.sm_bias);
    float* bgrad = (float*)(smem + p.sm_bgrad);
    float* closs = (float*)(smem + p.sm_loss);        // [4][ROWS], then 4 totals
    float* lacc = closs + 4 * ROWS;
    const int tid = threadIdx.x;
    const int L = p.L, A = p.A;
    const int h_top = p.hidden[L - 1];
    float* part = p.partial + (size_t)blockIdx.x * p.stride;

    for (int i = tid; i < p.stride; i += blockDim.x) part[i] = 0.0f;
    {
        int pos = 0;
        for (int l = 0; l <= L; ++l) {
            const int n = l < L ? p.hidden[l] : HEAD_PAD;
            for (int i = tid; i < n; i += blockDim.x) bias[pos + i] = p.b[l][i];
            pos += n;
        }
        for (int i = tid; i < p.bias_total; i += blockDim.x) bgrad[i] = 0.0f;
        if (tid < 4) lacc[tid] = 0.0f;
    }
    __syncthreads();

    const long long tiles = (p.M + ROWS - 1) / ROWS;
    const long long first = tiles * blockIdx.x / gridDim.x;
    const long long last = tiles * (blockIdx.x + 1) / gridDim.x;
    for (long long tile = first; tile < last; ++tile) {
        const long long r0 = tile * ROWS;
        const int nvalid = (int)min((long long)ROWS, p.M - r0);

        // ---- observations, transposed: (Fp, ROWS), zero past F and M.
        const bf16 zero = __float2bfloat16(0.0f);
        for (int i = tid; i < p.Fp * ROWS; i += blockDim.x) {
            const int c = i / p.Fp, f = i % p.Fp;
            xs[f * LDH + c] = (f < p.F && c < nvalid)
                        ? p.obs[(size_t)(r0 + c) * p.F + f] : zero;
        }
        __syncthreads();

        // ---- forward: h_l = act(W_l^T h_{l-1} + b_l) in f32, kept, and its
        // bf16 round, which feeds the products.
        int boff = 0;
        const bf16* below = xs;
        int kdim = p.Fp;
        for (int l = 0; l < L; ++l) {
            const int H = p.hidden[l];
            gemm<CM, RM, false>(H, ROWS, kdim, p.w[l], H, below, LDH, scratch, LDS);
            __syncthreads();
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            float* hf = (float*)(smem + p.sm_hf[l]);
            for (int i = tid; i < H * ROWS; i += blockDim.x) {
                const int r = i / ROWS, c = i % ROWS;
                const float v = scratch[r * LDS + c] + bias[boff + r];
                const float a = p.relu ? fmaxf(v, 0.0f) : tanhf(v);
                hf[r * LDS + c] = a;
                h[r * LDH + c] = __float2bfloat16(a);
            }
            __syncthreads();
            boff += H;
            below = h;
            kdim = H;
        }
        const bf16* htop = below;
        const float* bh = bias + boff;
        gemm<CM, RM, false>(HEAD_PAD, ROWS, h_top, p.w[L], HEAD_PAD, htop, LDH,
                            scratch, LDS);
        __syncthreads();

        // ---- loss and dheads, one thread a row.
        if (tid < ROWS) {
            const int c = tid;
            float dcol[HEAD_PAD];
            LossTerms lt = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) dcol[r] = 0.0f;
            if (c < nvalid) {
                const size_t g = (size_t)(r0 + c);
                lt = ppo_column(scratch + c, LDS, bh, A, VALUE_ROW, p.action[g],
                                p.logp_old[g], p.adv[g], p.value_old[g], p.target[g],
                                p.clip, p.neg_inv_m, p.ent_scale, p.val_scale, dcol,
                                dcol + VALUE_ROW);
            }
            closs[0 * ROWS + c] = lt.pol;
            closs[1 * ROWS + c] = lt.val;
            closs[2 * ROWS + c] = lt.ent;
            closs[3 * ROWS + c] = lt.kl;
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) {
                scratch[r * LDS + c] = dcol[r];
                dhb[r * LDH + c] = __float2bfloat16(dcol[r]);
            }
        }
        __syncthreads();
        row_sums<ROWS>(scratch, LDS, HEAD_PAD, bgrad + boff);
        row_sums<ROWS>(closs, ROWS, 4, lacc);
        // dW of both heads += h_top . dheads_b^T, contracting the rows.
        gemm<RM, CM, true>(h_top, HEAD_PAD, ROWS, htop, LDH, dhb, LDH,
                           part + p.off_w[L], HEAD_PAD);
        __syncthreads();
        // dh = Wp . dlogits_b + Wv . dvalue_b (the 16-row chunks: policy,
        // policy, value).
        gemm<RM, RM, false>(h_top, ROWS, HEAD_PAD, p.w[L], HEAD_PAD, dhb, LDH,
                            scratch, LDS);
        __syncthreads();

        // ---- backward through the hidden layers.
        for (int l = L - 1; l >= 0; --l) {
            const int H = p.hidden[l];
            const int K = l > 0 ? p.hidden[l - 1] : p.Fp;
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            const float* hf = (const float*)(smem + p.sm_hf[l]);
            const bf16* blw = l > 0 ? (const bf16*)(smem + p.sm_h[l - 1]) : xs;
            boff -= H;
            // dpre = dh * act'(h_f32); h's bf16 buffer takes bf16(dpre).
            for (int i = tid; i < H * ROWS; i += blockDim.x) {
                const int r = i / ROWS, c = i % ROWS;
                const float a = hf[r * LDS + c];
                const float d = scratch[r * LDS + c] *
                                (p.relu ? (a > 0.0f ? 1.0f : 0.0f) : 1.0f - a * a);
                scratch[r * LDS + c] = d;
                h[r * LDH + c] = __float2bfloat16(d);
            }
            __syncthreads();
            row_sums<ROWS>(scratch, LDS, H, bgrad + boff);
            // dW_l += below . dpre_b^T.
            gemm<RM, CM, true>(K, H, ROWS, blw, LDH, h, LDH, part + p.off_w[l], H);
            __syncthreads();
            if (l > 0) {
                // dh_{l-1} = W_l . dpre_b.
                gemm<RM, RM, false>(K, ROWS, H, p.w[l], H, h, LDH, scratch, LDS);
                __syncthreads();
            }
        }
    }

    for (int i = tid; i < p.bias_total; i += blockDim.x) part[p.off_b[0] + i] = bgrad[i];
    if (tid < 4) part[p.off_loss + tid] = lacc[tid];
}

extern "C" int fused_ppo_grads_rm_launch(
    const void* obs, const void* action, const void* logp_old,
    const void* value_old, const void* adv, const void* target,
    const void* const* weights, const void* const* biases, const int* hidden,
    int num_layers, int obs_dim, int obs_dim_pad, int num_actions, int relu,
    int rows, float clip_eps, float neg_inv_m, float ent_scale, float val_scale,
    void* partial, int blocks, int stride, void* out, void* stream) {
    if (num_layers < 1 || num_layers > MAX_LAYERS || num_actions > VALUE_ROW ||
        obs_dim > obs_dim_pad || obs_dim_pad % 16 || blocks < 1 || rows < 1)
        return (int)cudaErrorInvalidValue;
    Params p = {};
    p.obs = (const bf16*)obs;
    p.action = (const int*)action;
    p.logp_old = (const float*)logp_old;
    p.value_old = (const float*)value_old;
    p.adv = (const float*)adv;
    p.target = (const float*)target;
    p.L = num_layers;
    p.F = obs_dim;
    p.Fp = obs_dim_pad;
    p.A = num_actions;
    p.relu = relu;
    p.M = rows;
    p.clip = clip_eps;
    p.neg_inv_m = neg_inv_m;
    p.ent_scale = ent_scale;
    p.val_scale = val_scale;
    p.partial = (float*)partial;
    p.stride = stride;
    int hmax = HEAD_PAD, pos = 0, prev = obs_dim_pad, sm = 0, bias_total = 0;
    for (int l = 0; l <= num_layers; ++l) {
        p.w[l] = (const bf16*)weights[l];
        p.b[l] = (const float*)biases[l];
        const int h = l < num_layers ? hidden[l] : HEAD_PAD;
        if (h % 16 || h <= 0) return (int)cudaErrorInvalidValue;
        if (l < num_layers) p.hidden[l] = h;
        p.off_w[l] = pos;
        pos += prev * h;
        prev = h;
        bias_total += h;
        if (h > hmax) hmax = h;
    }
    for (int l = 0; l <= num_layers; ++l) {
        p.off_b[l] = pos;
        pos += l < num_layers ? hidden[l] : HEAD_PAD;
    }
    p.off_loss = pos;
    p.bias_total = bias_total;
    if (pos + 4 > stride || stride % 64) return (int)cudaErrorInvalidValue;

    p.sm_x = sm;
    sm = align128(sm + obs_dim_pad * LDH * 2);
    for (int l = 0; l < num_layers; ++l) {
        p.sm_h[l] = sm;
        sm = align128(sm + hidden[l] * LDH * 2);
        p.sm_hf[l] = sm;
        sm = align128(sm + hidden[l] * LDS * 4);
    }
    p.sm_dh = sm;
    sm = align128(sm + HEAD_PAD * LDH * 2);
    p.sm_scratch = sm;
    sm = align128(sm + hmax * LDS * 4);
    p.sm_bias = sm;
    sm = align128(sm + bias_total * 4);
    p.sm_bgrad = sm;
    sm = align128(sm + bias_total * 4);
    p.sm_loss = sm;
    sm = align128(sm + (4 * ROWS + 4) * 4);

    cudaError_t err = cudaFuncSetAttribute(
        ppo_grads_rm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    ppo_grads_rm_kernel<<<blocks, THREADS, sm, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials<<<(stride + 255) / 256, 256, 0, s>>>((const float*)partial, blocks,
                                                          stride, (float*)out);
    return (int)cudaGetLastError();
}
