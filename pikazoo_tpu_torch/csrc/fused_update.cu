// The fused clipped-PPO minibatch gradient, feature-major (K1), for Hopper.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:504
// `fused_ppo_grads_fm` (kernel body `_fm_kernel`, :244; pallas_call :618),
// bf16 path.  Python side: pikazoo_tpu_torch/train/fused_update.py, which
// also holds the plain PyTorch version this kernel is held against.
//
// What it computes, for a minibatch of M = T*N columns (obs (T, F, N) bf16
// feature-major, per-column action / logp_old / value_old / adv / target):
// the MLP forward with bf16 operands and f32 accumulation, the clipped-PPO
// loss, the hand-written backward, the weight and bias gradients and the 4
// loss sums, with the TPU kernel's rounding points (see the Python module).
//
// What bounds it.  About 159 kFLOP forward and 300 kFLOP backward per column
// at hidden (256, 256), ~1.9 TFLOP per full-width call (T=32, N=131072),
// against ~90 bytes of input per column: compute-bound by a factor of
// thousands.  The floor is the tensor cores' bf16 rate (~2 ms a call at
// 989 TFLOP/s); on the CUDA cores it would be ~29 ms.
//
// What the design does about it.
// - Every product runs on the tensor cores, bf16 x bf16 -> f32, through
//   WMMA 16x16x16 fragments (the TPU kernel's MXU arithmetic).  The tensor
//   cores' f32 accumulation does not round to nearest and drifts toward
//   zero over a long sum: a fragment accumulated over K = 256 (or over the
//   whole column range) left the gradients ~1e-3 (relative L2) off a
//   float64 reference, 5x further than the plain version.  So each mma
//   sums 16 products into a fresh fragment, and the running sum takes it
//   with a round-to-nearest add (KCHUNK); the error then matches the plain
//   version's at the same speed (measured on an H100).
// - One block walks a contiguous range of 64-column tiles.  For each tile
//   the activations of every layer, the head, and the backward's dpre stay
//   in shared memory: nothing per column goes back to device memory, which
//   is what the TPU kernel buys.
// - The TPU grid runs in order and carries its accumulators in VMEM; here
//   blocks run in parallel, and the 256x256 layer's dW alone (256 KB f32)
//   is larger than a block's shared memory.  So each block owns a partial of every gradient
//   and loss sum in device memory (it stays in L2 for the most part) and
//   accumulates into it with fragment load / mma / store, tile after tile,
//   in a fixed order; a second kernel sums the partials over blocks in
//   block order.  No atomics anywhere: the result is deterministic.
// - Weights are read as fragments straight from global memory (L2): the
//   hidden weights do not fit in shared memory beside the activations.
// - Shared tiles have padded row strides (LDH, LDS) and the bias-gradient
//   row sums run a warp a row: with unpadded 64-wide rows the fragment
//   loads and the row sums hit the same banks, and the kernel took 75 ms a
//   full-width call instead of 45 (H100, interleaved A/B).
//
// Where the time goes now (cycle stamps per phase on an H100, full width,
// ~45 ms a call, ~4% of the bf16 tensor-core peak): a third in the dW
// read-modify-write of the partials, which every block does for every tile
// at once (L2 bandwidth); ~40% in the products that read their weights
// from L2; the activations, loss and row sums the rest.  Not done here
// (later work): wgmma, TMA, a pipelined, warp-specialised, persistent
// design; weights staged through shared memory; dW held across more
// columns between read-modify-writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define COLS 64          // columns per tile
// Row strides of the shared-memory tiles, padded so that the rows of a
// fragment do not all start in the same banks.
#define LDH (COLS + 8)   // bf16 tiles: x, h_l / dpre_l, dheads
#define LDS (COLS + 4)   // the f32 scratch tile
#define THREADS 512      // 16 warps
#define HEAD_PAD 32      // merged head rows (A+1), padded
#define MAX_LAYERS 4
#define KCHUNK 16        // products summed on the tensor cores before a rounded add

struct Params {
    const bf16* obs;         // (T, F, N)
    const int* action;       // (T, N)
    const float* logp_old;
    const float* value_old;
    const float* adv;
    const float* target;
    const bf16* w[MAX_LAYERS + 1];   // w[0] (Fp, H0) zero-padded rows; w[l] (H_{l-1}, H_l); w[L] merged head (H_{L-1}, 32)
    const float* b[MAX_LAYERS + 1];  // b[l] (H_l); b[L] (32)
    int hidden[MAX_LAYERS];
    int L, F, Fp, A, relu, T, N;
    float clip, neg_inv_m, ent_scale, val_scale;
    float* partial;          // (blocks, stride)
    int stride;
    // Offsets (floats) inside one block's partial.
    int off_w[MAX_LAYERS + 1];
    int off_b[MAX_LAYERS + 1];
    int off_loss;
    // Shared-memory offsets (bytes).
    int sm_x, sm_h[MAX_LAYERS], sm_dh, sm_scratch, sm_bias, sm_bgrad, sm_loss;
    int bias_total;          // sum H_l + 32
};

// ---------------------------------------------------------------------------
// D (M x N) = [D +] A (M x K) . B (K x N), bf16 operands, f32 accumulation.
// A, B in the given layouts and leading dims (either in shared or global
// memory); D row-major f32.  M, N, K multiples of 16.  A warp owns a strip of
// up to four 16x16 output tiles, so each A fragment is loaded once per strip.
template <typename LA>
__device__ __forceinline__ const bf16* a_at(const bf16* A, int r, int c, int ld) {
    return std::is_same<LA, wmma::row_major>::value ? A + (size_t)r * ld + c
                                                     : A + (size_t)c * ld + r;
}

template <typename LA, typename LB, bool ACC>
__device__ void gemm(int M, int N, int K, const bf16* A, int lda,
                     const bf16* B, int ldb, float* D, int ldd) {
    typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int mt = M >> 4, nstrips = (N + 63) >> 6;
    for (int job = warp; job < mt * nstrips; job += nwarps) {
        const int tm = job / nstrips, n0 = (job % nstrips) * 64;
        const int nt = min(4, (N - n0) >> 4);
        Acc acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < nt) {
                float* d = D + (size_t)(tm * 16) * ldd + n0 + j * 16;
                if (ACC) wmma::load_matrix_sync(acc[j], d, ldd, wmma::mem_row_major);
                else wmma::fill_fragment(acc[j], 0.0f);
            }
        }
        for (int k0 = 0; k0 < K; k0 += KCHUNK) {
            // The tensor cores' f32 accumulation does not round to nearest:
            // each chunk of products is summed into a fresh fragment and
            // added to the running sum with round-to-nearest adds.
            Acc part[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::fill_fragment(part[j], 0.0f);
            for (int k = k0; k < min(K, k0 + KCHUNK); k += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
                wmma::load_matrix_sync(a, a_at<LA>(A, tm * 16, k, lda), lda);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (j < nt) {
                        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
                        // B (k, n): row-major at k*ldb + n, col-major at n*ldb + k.
                        wmma::load_matrix_sync(b, a_at<LB>(B, k, n0 + j * 16, ldb), ldb);
                        wmma::mma_sync(part[j], a, b, part[j]);
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int i = 0; i < part[j].num_elements; ++i)
                    acc[j].x[i] = __fadd_rn(acc[j].x[i], part[j].x[i]);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < nt)
                wmma::store_matrix_sync(D + (size_t)(tm * 16) * ldd + n0 + j * 16,
                                        acc[j], ldd, wmma::mem_row_major);
        }
    }
}

typedef wmma::row_major RM;
typedef wmma::col_major CM;

// acc[r] += the sum of row r of a (rows x COLS) f32 tile with row stride ld:
// a warp a row, each lane adding two columns, then a butterfly in a fixed
// order (deterministic).
static_assert(COLS == 64, "row_sums takes two columns a lane");
__device__ __forceinline__ void row_sums(const float* tile, int ld, int rows, float* acc) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
        float s = tile[r * ld + lane] + tile[r * ld + lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) acc[r] += s;
    }
}

__global__ void __launch_bounds__(THREADS, 1) ppo_grads_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = (bf16*)(smem + p.sm_x);
    bf16* dhb = (bf16*)(smem + p.sm_dh);
    float* scratch = (float*)(smem + p.sm_scratch);
    float* bias = (float*)(smem + p.sm_bias);
    float* bgrad = (float*)(smem + p.sm_bgrad);
    float* closs = (float*)(smem + p.sm_loss);        // [4][COLS], then 4 totals
    float* lacc = closs + 4 * COLS;
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

        // ---- forward: h_l = bf16(act(W_l^T h_{l-1} + b_l)).
        int boff = 0;
        const bf16* below = xs;
        int kdim = p.Fp;
        for (int l = 0; l < L; ++l) {
            const int H = p.hidden[l];
            gemm<CM, RM, false>(H, COLS, kdim, p.w[l], H, below, LDH, scratch, LDS);
            __syncthreads();
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            for (int i = tid; i < H * COLS; i += blockDim.x) {
                const int r = i / COLS, c = i % COLS;
                const float v = scratch[r * LDS + c] + bias[boff + r];
                h[r * LDH + c] = __float2bfloat16(p.relu ? fmaxf(v, 0.0f) : tanhf(v));
            }
            __syncthreads();
            boff += H;
            below = h;
            kdim = H;
        }
        const bf16* htop = below;
        const float* bpv = bias + boff;
        gemm<CM, RM, false>(HEAD_PAD, COLS, h_top, p.w[L], HEAD_PAD, htop, LDH,
                            scratch, LDS);
        __syncthreads();

        // ---- loss and dheads, one thread a column.
        if (tid < COLS) {
            const int c = tid;
            float dcol[HEAD_PAD];
            float pol = 0.0f, val = 0.0f, ent = 0.0f, kl = 0.0f;
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) dcol[r] = 0.0f;
            if (c < nvalid) {
                const size_t g = (size_t)t * p.N + c0 + c;
                const int act = p.action[g];
                const float lpo = p.logp_old[g], adv = p.adv[g];
                const float vold = p.value_old[g], tgt = p.target[g];
                float m = -INFINITY;
                for (int r = 0; r < A; ++r)
                    m = fmaxf(m, scratch[r * LDS + c] + bpv[r]);
                float sumex = 0.0f;
                for (int r = 0; r < A; ++r)
                    sumex += expf((scratch[r * LDS + c] + bpv[r]) - m);
                const float lse = logf(sumex) + m;
                const float value = scratch[A * LDS + c] + bpv[A];
                float plogp = 0.0f, lp_new = 0.0f;
                for (int r = 0; r < A; ++r) {
                    const float z = scratch[r * LDS + c] + bpv[r];
                    const float logp = z - lse;
                    const float pr = expf(z - m) / sumex;
                    plogp += pr * logp;
                    if (r == act) lp_new = logp;
                }
                const float entropy_row = -plogp;
                const float ratio = expf(lp_new - lpo);
                const float unclipped = ratio * adv;
                const float clipped =
                    fminf(fmaxf(ratio, 1.0f - p.clip), 1.0f + p.clip) * adv;
                pol = -fminf(unclipped, clipped);
                ent = entropy_row;
                const float vclip = vold + fminf(fmaxf(value - vold, -p.clip), p.clip);
                const float e1 = value - tgt, e2 = vclip - tgt;
                val = 0.5f * fmaxf(e1 * e1, e2 * e2);
                kl = (ratio - 1.0f) - logf(ratio);

                const float inside_r =
                    (ratio > 1.0f - p.clip && ratio < 1.0f + p.clip) ? 1.0f : 0.0f;
                const float dmin = (unclipped <= clipped) ? adv : adv * inside_r;
                const float dlp = p.neg_inv_m * dmin * ratio;
                for (int r = 0; r < A; ++r) {
                    const float z = scratch[r * LDS + c] + bpv[r];
                    const float logp = z - lse;
                    const float pr = expf(z - m) / sumex;
                    const float onehot = (r == act) ? 1.0f : 0.0f;
                    dcol[r] = dlp * (onehot - pr) + p.ent_scale * pr * (logp + entropy_row);
                }
                const float inside_v =
                    (value - vold > -p.clip && value - vold < p.clip) ? 1.0f : 0.0f;
                dcol[A] = p.val_scale * ((e1 * e1 >= e2 * e2) ? e1 : e2 * inside_v);
            }
            closs[0 * COLS + c] = pol;
            closs[1 * COLS + c] = val;
            closs[2 * COLS + c] = ent;
            closs[3 * COLS + c] = kl;
            // Every thread of the loop above has read its column of scratch
            // before any writes it: each thread owns one column.
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) {
                scratch[r * LDS + c] = dcol[r];
                dhb[r * LDH + c] = __float2bfloat16(dcol[r]);
            }
        }
        __syncthreads();
        row_sums(scratch, LDS, HEAD_PAD, bgrad + boff);
        row_sums(closs, COLS, 4, lacc);
        // dWpv += h_top . dheads_b^T, contracting the columns.
        gemm<RM, CM, true>(h_top, HEAD_PAD, COLS, htop, LDH, dhb, LDH,
                           part + p.off_w[L], HEAD_PAD);
        __syncthreads();
        // dh = Wpv . dheads_b.
        gemm<RM, RM, false>(h_top, COLS, HEAD_PAD, p.w[L], HEAD_PAD, dhb, LDH,
                            scratch, LDS);
        __syncthreads();

        // ---- backward through the hidden layers.
        for (int l = L - 1; l >= 0; --l) {
            const int H = p.hidden[l];
            const int K = l > 0 ? p.hidden[l - 1] : p.Fp;
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            const bf16* blw = l > 0 ? (const bf16*)(smem + p.sm_h[l - 1]) : xs;
            boff -= H;
            // dpre = dh * act'(float(h_bf16)); h's buffer takes bf16(dpre).
            for (int i = tid; i < H * COLS; i += blockDim.x) {
                const int r = i / COLS, c = i % COLS;
                const float hf = __bfloat162float(h[r * LDH + c]);
                const float d = scratch[r * LDS + c] *
                                (p.relu ? (hf > 0.0f ? 1.0f : 0.0f) : 1.0f - hf * hf);
                scratch[r * LDS + c] = d;
                h[r * LDH + c] = __float2bfloat16(d);
            }
            __syncthreads();
            row_sums(scratch, LDS, H, bgrad + boff);
            // dW_l += below . dpre_b^T.
            gemm<RM, CM, true>(K, H, COLS, blw, LDH, h, LDH, part + p.off_w[l], H);
            __syncthreads();
            if (l > 0) {
                // dh_{l-1} = W_l . dpre_b.
                gemm<RM, RM, false>(K, COLS, H, p.w[l], H, h, LDH, scratch, LDS);
                __syncthreads();
            }
        }
    }

    // The block's bias grads and loss sums go after its dW partials.
    for (int i = tid; i < p.bias_total; i += blockDim.x) part[p.off_b[0] + i] = bgrad[i];
    if (tid < 4) part[p.off_loss + tid] = lacc[tid];
}

// out[e] = sum over blocks, in block order, of partial[block][e].
__global__ void reduce_partials(const float* __restrict__ partial, int blocks,
                                int stride, float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= stride) return;
    float s = 0.0f;
    for (int g = 0; g < blocks; ++g) s += partial[(size_t)g * stride + e];
    out[e] = s;
}

static int align128(int x) { return (x + 127) & ~127; }

extern "C" int fused_ppo_grads_fm_launch(
    const void* obs, const void* action, const void* logp_old,
    const void* value_old, const void* adv, const void* target,
    const void* const* weights, const void* const* biases, const int* hidden,
    int num_layers, int obs_dim, int obs_dim_pad, int num_actions, int relu,
    int frames, int cols, float clip_eps, float neg_inv_m, float ent_scale,
    float val_scale, void* partial, int blocks, int stride, void* out,
    void* stream) {
    if (num_layers < 1 || num_layers > MAX_LAYERS || num_actions + 1 > HEAD_PAD ||
        obs_dim > obs_dim_pad || obs_dim_pad % 16 || blocks < 1)
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
    p.T = frames;
    p.N = cols;
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
    sm = align128(sm + (4 * COLS + 4) * 4);

    cudaError_t err = cudaFuncSetAttribute(
        ppo_grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    ppo_grads_kernel<<<blocks, THREADS, sm, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials<<<(stride + 255) / 256, 256, 0, s>>>((const float*)partial, blocks,
                                                          stride, (float*)out);
    return (int)cudaGetLastError();
}
