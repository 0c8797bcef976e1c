// The fused clipped-PPO minibatch gradient, feature-major (K1), for Hopper.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:504
// `fused_ppo_grads_fm` (kernel body `_fm_kernel`, :244; pallas_call :618)
// in its modes the bf16 backward chain (`bwd_bf16`, after the bf16 or the
// int8fwd forward), and the int8 modes `int8fwd` and `int8`.  The default
// bf16 mode and int8fwd run fused_update_bf16.cu (two kernels: the per-tile
// chain and the long-K dW products); their template instances here (Q_NONE
// and Q_FWD without bwd_bf16) are no longer launched.  The int8 mode runs
// fused_update_int8.cu (the same split, with a requantise kernel a layer);
// its instance here (Q_FULL) is no longer launched either.
// Python side:
// pikazoo_tpu_torch/train/fused_update.py, which also holds the plain PyTorch
// version this kernel is held against.  Device code shared with the probe
// kernels is in ppo_grads.cuh.
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
//   version's at the same speed (measured on an H100).  In the bf16 chain
//   the head's dh, a short sum that cancels, runs on the CUDA cores
//   instead (head_dh).
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

//
// The modes are template parameters of one kernel.
// - bwd_bf16: the hidden gradient chain in bf16 arithmetic, op by op, as the
//   TPU kernel casts it (dh_b = bf16(dot); dpre_b = dh_b * (1 - h*h) in bf16).
// - int8fwd / int8: the forward products run on the int8 tensor cores
//   (mma.sync m16n8k32, exact int32 sums), weights quantised per tensor by
//   the wrapper, activations with the static scale 127.  int8fwd keeps the
//   bf16 of each f32 activation and runs the bf16 backward.
// - int8 also runs the hidden backward chain in int8, with a dynamic
//   max-abs scale of dpre per frame and column cell (1024 columns at the
//   learner's width, 16 of this kernel's tiles, in other blocks).  Every
//   tile of a cell must know the cell's maximum before it quantises, layer by
//   layer.  The kernel runs in L+1 stages, each a launch, so that a launch
//   boundary is the grid-wide barrier: stage s recomputes the forward and
//   the backward down to layer L-1-s, finalises the gradients of layer L-s
//   (stage 0: the head and the losses) with the maxima found so far, and
//   takes the maxima of layer L-1-s with an atomicMax on the float bits into
//   a per-cell array (max is order-free, so the result is deterministic).
//   The recomputation is bit-identical, so every stage sees the same dpre.
//   It costs about two single-pass calls, and spans a cell of any width.

#include "ppo_grads.cuh"

using namespace ppo;

#define COLS 64          // columns per tile
// Row strides of the shared-memory tiles, padded so that the rows of a
// fragment do not all start in the same banks.
#define LDH (COLS + 8)   // bf16 tiles: x, h_l / dpre_l, dheads
#define LDS (COLS + 4)   // the f32 scratch tile
#define LDQ (COLS + 16)  // int8 tiles (bytes): x_q, h_q, dpre_q
#define THREADS 512      // 16 warps
#define HEAD_PAD 32      // merged head rows (A+1), padded
#define MAX_LAYERS 4
#define S_IN (1.0f / 127.0f)  // static dequant scale of int8 activations

enum { Q_NONE = 0, Q_FWD = 1, Q_FULL = 2 };

struct Params {
    const bf16* obs;         // (T, F, N)
    const int* action;       // (T, N)
    const float* logp_old;
    const float* value_old;
    const float* adv;
    const float* target;
    const bf16* w[MAX_LAYERS + 1];   // w[0] (Fp, H0) zero-padded rows; w[l] (H_{l-1}, H_l); w[L] merged head (H_{L-1}, 32)
    const float* b[MAX_LAYERS + 1];  // b[l] (H_l); b[L] (32)
    const int8_t* wq[MAX_LAYERS + 1];  // int8 modes: the same layout, int8
    const float* sw;         // int8 modes: the L+1 weight scales
    float* cellmax;          // int8: (L, T, ncell) max |dpre| per frame and cell
    int hidden[MAX_LAYERS];
    int L, F, Fp, A, relu, T, N;
    int cell_cols, ncell, stage;
    float clip, neg_inv_m, ent_scale, val_scale;
    float* partial;          // (blocks, stride)
    int stride;
    // Offsets (floats) inside one block's partial.
    int off_w[MAX_LAYERS + 1];
    int off_b[MAX_LAYERS + 1];
    int off_loss;
    // Shared-memory offsets (bytes).
    int sm_x, sm_h[MAX_LAYERS], sm_dh, sm_scratch, sm_bias, sm_bgrad, sm_loss;
    int sm_xq, sm_hq[MAX_LAYERS], sm_dpq;
    int bias_total;          // sum H_l + 32
};

// The bf16 chain's dh (rows x COLS, f32, row stride LDS) = Wpv (rows x
// HEAD_PAD, bf16, row-major, global) . dheads_b (HEAD_PAD x COLS, shared),
// over the first n head rows (the rest is zero padding), on the CUDA cores
// with round-to-nearest FMAs in head-row order.  On the tensor cores this product goes wrong for the
// chain: its A+1 = 19 terms cancel (the policy part of dheads sums to ~0
// over the actions), and one mma's sum of 16 products rounds toward zero,
// by far more than an f32 ulp of the result.  The chain rounds dh to bf16
// next, and that bias flipped the roundings one way: K1 bwd_bf16 was
// 3.9e-3 (worst grad leaf, relative L2) from a float64 reference at full
// width, its plain version 1.3e-4; with this product 1.6e-4, as the bf16
// mode (measured on an H100).  The f32 chain's roundings come later and
// its grads did not move, so the other modes keep the tensor cores.
__device__ void head_dh(int rows, int n, const bf16* W, const bf16* dhb, float* D) {
    // A thread holds one row of Wpv in registers (a row is 64 bytes, four
    // 16-byte loads) and takes every groups-th pair of columns; a warp reads
    // each dheads_b pair as one broadcast from shared memory.
    const int groups = blockDim.x / rows;
    const int r = threadIdx.x % rows, g = threadIdx.x / rows;
    if (g >= groups) return;
    float w[HEAD_PAD];
    const uint4* row = reinterpret_cast<const uint4*>(W + (size_t)r * HEAD_PAD);
#pragma unroll
    for (int v = 0; v < HEAD_PAD / 8; ++v) {
        const uint4 q = row[v];
        const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(pair[j]);
            w[v * 8 + 2 * j] = f.x;
            w[v * 8 + 2 * j + 1] = f.y;
        }
    }
    for (int pc = 2 * g; pc < COLS; pc += 2 * groups) {
        float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int a = 0; a < HEAD_PAD; ++a) {
            if (a < n) {
                const float2 d = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(dhb + a * LDH + pc));
                s.x = __fmaf_rn(w[a], d.x, s.x);
                s.y = __fmaf_rn(w[a], d.y, s.y);
            }
        }
        *reinterpret_cast<float2*>(D + r * LDS + pc) = s;
    }
}

// int8 of a [-1, 1] value with the static scale 127: round half to even,
// clamped.
__device__ __forceinline__ int8_t q127(float v) {
    return (int8_t)fminf(fmaxf(rintf(__fmul_rn(v, 127.0f)), -127.0f), 127.0f);
}

template <int QUANT, bool BWD_BF16>
__global__ void __launch_bounds__(THREADS, 1) ppo_grads_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ float warp_max[THREADS / 32];
    bf16* xs = (bf16*)(smem + p.sm_x);
    bf16* dhb = (bf16*)(smem + p.sm_dh);
    float* scratch = (float*)(smem + p.sm_scratch);
    float* bias = (float*)(smem + p.sm_bias);
    float* bgrad = (float*)(smem + p.sm_bgrad);
    float* closs = (float*)(smem + p.sm_loss);        // [4][COLS], then 4 totals
    float* lacc = closs + 4 * COLS;
    int8_t* xq = (int8_t*)(smem + p.sm_xq);
    int8_t* dpq = (int8_t*)(smem + p.sm_dpq);
    const int tid = threadIdx.x;
    const int L = p.L, A = p.A;
    const int h_top = p.hidden[L - 1];
    float* part = p.partial + (size_t)blockIdx.x * p.stride;
    // int8 stage s finalises layer fin = L - s (L: the head and the losses)
    // and measures the cell maxima of layer L - 1 - s (-1: none).  The other
    // modes run once and finalise everything.
    const int fin = QUANT == Q_FULL ? L - p.stage : 0;
    const int measure = QUANT == Q_FULL ? L - 1 - p.stage : -1;
    const bool head_stage = QUANT != Q_FULL || p.stage == 0;

    if (head_stage)
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
            const bf16 v = (f < p.F && c < nvalid)
                        ? p.obs[((size_t)t * p.F + f) * p.N + c0 + c] : zero;
            xs[f * LDH + c] = v;
            if (QUANT != Q_NONE) xq[f * LDQ + c] = q127(__bfloat162float(v));
        }
        __syncthreads();

        // ---- forward: h_l = act(W_l^T h_{l-1} + b_l), kept as bf16 (bf16
        // modes and int8fwd's backward) and as int8 (int8 modes).
        int boff = 0;
        const bf16* below = xs;
        const int8_t* below_q = xq;
        int kdim = p.Fp;
        for (int l = 0; l < L; ++l) {
            const int H = p.hidden[l];
            if (QUANT == Q_NONE)
                gemm<CM, RM, false>(H, COLS, kdim, p.w[l], H, below, LDH, scratch, LDS);
            else
                gemm_s8<S8_STORE>(H, COLS, kdim, p.wq[l], 1, H, below_q, LDQ, 1,
                                  __fmul_rn(p.sw[l], S_IN), scratch, LDS);
            __syncthreads();
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            int8_t* hq = (int8_t*)(smem + p.sm_hq[l]);
            for (int i = tid; i < H * COLS; i += blockDim.x) {
                const int r = i / COLS, c = i % COLS;
                const float v = __fadd_rn(scratch[r * LDS + c], bias[boff + r]);
                const float hf = p.relu ? fmaxf(v, 0.0f) : tanhf(v);
                if (QUANT != Q_FULL) h[r * LDH + c] = __float2bfloat16(hf);
                if (QUANT != Q_NONE) hq[r * LDQ + c] = q127(hf);
            }
            __syncthreads();
            boff += H;
            below = h;
            below_q = hq;
            kdim = H;
        }
        const bf16* htop = below;
        const int8_t* htop_q = below_q;
        const float* bpv = bias + boff;
        if (QUANT == Q_NONE)
            gemm<CM, RM, false>(HEAD_PAD, COLS, h_top, p.w[L], HEAD_PAD, htop, LDH,
                                scratch, LDS);
        else
            gemm_s8<S8_STORE>(HEAD_PAD, COLS, h_top, p.wq[L], 1, HEAD_PAD, htop_q, LDQ,
                              1, __fmul_rn(p.sw[L], S_IN), scratch, LDS);
        __syncthreads();

        // ---- loss and dheads, one thread a column.
        if (tid < COLS) {
            const int c = tid;
            float dcol[HEAD_PAD];
            LossTerms lt = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) dcol[r] = 0.0f;
            if (c < nvalid) {
                const size_t g = (size_t)t * p.N + c0 + c;
                lt = ppo_column(scratch + c, LDS, bpv, A, A, p.action[g], p.logp_old[g],
                                p.adv[g], p.value_old[g], p.target[g], p.clip,
                                p.neg_inv_m, p.ent_scale, p.val_scale, dcol, dcol + A);
            }
            closs[0 * COLS + c] = lt.pol;
            closs[1 * COLS + c] = lt.val;
            closs[2 * COLS + c] = lt.ent;
            closs[3 * COLS + c] = lt.kl;
            // Every thread of the loop above has read its column of scratch
            // before any writes it: each thread owns one column.
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) {
                scratch[r * LDS + c] = dcol[r];
                dhb[r * LDH + c] = __float2bfloat16(dcol[r]);
            }
        }
        __syncthreads();
        if (head_stage) {
            row_sums<COLS>(scratch, LDS, HEAD_PAD, bgrad + boff);
            row_sums<COLS>(closs, COLS, 4, lacc);
        }

        if (QUANT != Q_FULL) {
            // dWpv += h_top . dheads_b^T, contracting the columns.
            gemm<RM, CM, true>(h_top, HEAD_PAD, COLS, htop, LDH, dhb, LDH,
                               part + p.off_w[L], HEAD_PAD);
            __syncthreads();
            // dh = Wpv . dheads_b.
            if (BWD_BF16)
                head_dh(h_top, A + 1, p.w[L], dhb, scratch);
            else
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
                    float d;
                    if (BWD_BF16) {
                        // bf16 arithmetic, each op rounded: dh_b * (1 - h*h).
                        const float dh_b = __bfloat162float(__float2bfloat16(scratch[r * LDS + c]));
                        float da = hf > 0.0f ? 1.0f : 0.0f;
                        if (!p.relu) {
                            const float hh = __bfloat162float(__float2bfloat16(__fmul_rn(hf, hf)));
                            da = __bfloat162float(__float2bfloat16(__fsub_rn(1.0f, hh)));
                        }
                        d = __bfloat162float(__float2bfloat16(__fmul_rn(dh_b, da)));
                    } else {
                        d = scratch[r * LDS + c] *
                            (p.relu ? (hf > 0.0f ? 1.0f : 0.0f) : 1.0f - hf * hf);
                    }
                    scratch[r * LDS + c] = d;
                    h[r * LDH + c] = __float2bfloat16(d);
                }
                __syncthreads();
                row_sums<COLS>(scratch, LDS, H, bgrad + boff);
                // dW_l += below . dpre_b^T.
                gemm<RM, CM, true>(K, H, COLS, blw, LDH, h, LDH, part + p.off_w[l], H);
                __syncthreads();
                if (l > 0) {
                    // dh_{l-1} = W_l . dpre_b (rounded to bf16 when read, in
                    // the bf16 chain).
                    gemm<RM, RM, false>(K, COLS, H, p.w[l], H, h, LDH, scratch, LDS);
                    __syncthreads();
                }
            }
            continue;
        }

        // ---- int8 backward.  The head products stay bf16: h_top =
        // bf16(q) * bf16(1/127) rounded to bf16, into layer L-1's bf16
        // buffer, and dh = (bf16(Wpv_q) . dheads_b) * sw_L.
        if (head_stage) {
            bf16* htb = (bf16*)(smem + p.sm_h[L - 1]);
            const float s_in_b = __bfloat162float(__float2bfloat16(S_IN));
            for (int i = tid; i < h_top * COLS; i += blockDim.x) {
                const int r = i / COLS, c = i % COLS;
                htb[r * LDH + c] =
                    __float2bfloat16(__fmul_rn((float)htop_q[r * LDQ + c], s_in_b));
            }
            __syncthreads();
            gemm<RM, CM, true>(h_top, HEAD_PAD, COLS, htb, LDH, dhb, LDH,
                               part + p.off_w[L], HEAD_PAD);
            __syncthreads();
        }
        gemm<RM, RM, false>(h_top, COLS, HEAD_PAD, p.w[L], HEAD_PAD, dhb, LDH,
                            scratch, LDS);
        __syncthreads();
        float dh_scale = p.sw[L];
        const int cell = c0 / p.cell_cols;
        for (int l = L - 1; l >= 0 && l >= measure; --l) {
            const int H = p.hidden[l];
            const int K = l > 0 ? p.hidden[l - 1] : p.Fp;
            const int8_t* hq = (const int8_t*)(smem + p.sm_hq[l]);
            const int8_t* blw_q = l > 0 ? (const int8_t*)(smem + p.sm_hq[l - 1]) : xq;
            boff -= H;
            float* cmax = p.cellmax + ((size_t)l * p.T + t) * p.ncell + cell;
            // dpre = (dh * scale) * (1 - h*h), h = float(q) / 127.
            float amax = 0.0f;
            for (int i = tid; i < H * COLS; i += blockDim.x) {
                const int r = i / COLS, c = i % COLS;
                const float hf = __fmul_rn((float)hq[r * LDQ + c], S_IN);
                const float d = __fmul_rn(__fmul_rn(scratch[r * LDS + c], dh_scale),
                                          __fsub_rn(1.0f, __fmul_rn(hf, hf)));
                scratch[r * LDS + c] = d;
                amax = fmaxf(amax, fabsf(d));
            }
            if (l == measure) {
                // This tile's share of the cell's maximum; columns past N
                // hold dpre = 0.
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
                if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
                __syncthreads();
                if (tid == 0) {
                    float m = 0.0f;
                    for (int w = 0; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
                    atomicMax((int*)cmax, __float_as_int(m));
                }
                __syncthreads();
                break;
            }
            __syncthreads();
            if (l == fin) row_sums<COLS>(scratch, LDS, H, bgrad + boff);
            // Quantise with the cell's maximum: q = rint(dpre * (127 / amax)).
            const float sa = fmaxf(*cmax, 1e-30f);
            const float inv = __fdiv_rn(127.0f, sa);
            const float k_dp = __fmul_rn(sa, S_IN);
            for (int i = tid; i < H * COLS; i += blockDim.x) {
                const int r = i / COLS, c = i % COLS;
                dpq[r * LDQ + c] = (int8_t)rintf(__fmul_rn(scratch[r * LDS + c], inv));
            }
            __syncthreads();
            if (l == fin)   // dW_l += float(below_q . dpre_q^T) * (k_dp / 127).
                gemm_s8<S8_ADD>(K, H, COLS, blw_q, LDQ, 1, dpq, 1, LDQ,
                                __fmul_rn(k_dp, S_IN), part + p.off_w[l], H);
            if (l > 0 && l - 1 >= measure) {
                // dh_{l-1} = float(W_l_q . dpre_q) * (sw_l * k_dp).
                gemm_s8<S8_STORE>(K, COLS, H, p.wq[l], H, 1, dpq, LDQ, 1,
                                  __fmul_rn(p.sw[l], k_dp), scratch, LDS);
                dh_scale = 1.0f;
            }
            __syncthreads();
        }
    }

    // The block's bias grads and loss sums go after its dW partials; an int8
    // stage writes only what it finalised.
    if (QUANT != Q_FULL) {
        for (int i = tid; i < p.bias_total; i += blockDim.x) part[p.off_b[0] + i] = bgrad[i];
    } else {
        const int lo = p.off_b[fin] - p.off_b[0];
        const int n = fin < L ? p.hidden[fin] : HEAD_PAD;
        for (int i = tid; i < n; i += blockDim.x) part[p.off_b[fin] + i] = bgrad[lo + i];
    }
    if (head_stage && tid < 4) part[p.off_loss + tid] = lacc[tid];
}

typedef void (*Kernel)(const Params);

static Kernel pick_kernel(int quant, int bwd_bf16) {
    switch (quant * 2 + (bwd_bf16 ? 1 : 0)) {
        case 0: return ppo_grads_kernel<Q_NONE, false>;
        case 1: return ppo_grads_kernel<Q_NONE, true>;
        case 2: return ppo_grads_kernel<Q_FWD, false>;
        case 3: return ppo_grads_kernel<Q_FWD, true>;
        default: return ppo_grads_kernel<Q_FULL, false>;
    }
}

extern "C" int fused_ppo_grads_fm_launch(
    const void* obs, const void* action, const void* logp_old,
    const void* value_old, const void* adv, const void* target,
    const void* const* weights, const void* const* biases, const int* hidden,
    int num_layers, int obs_dim, int obs_dim_pad, int num_actions, int relu,
    int frames, int cols, float clip_eps, float neg_inv_m, float ent_scale,
    float val_scale, void* partial, int blocks, int stride, void* out,
    void* stream, int quant, int bwd_bf16, const void* const* qweights,
    const void* scales, void* cellmax, int cell_cols) {
    if (num_layers < 1 || num_layers > MAX_LAYERS || num_actions + 1 > HEAD_PAD ||
        obs_dim > obs_dim_pad || obs_dim_pad % 16 || blocks < 1 || quant < 0 ||
        quant > Q_FULL || (quant != Q_NONE && (!qweights || !scales)))
        return (int)cudaErrorInvalidValue;
    // An int8 cell is whole tiles, or the whole frame.
    if (quant == Q_FULL && (!cellmax || cell_cols < 1 ||
                            (cell_cols % COLS && cell_cols < cols)))
        return (int)cudaErrorInvalidValue;
    Params p = {};
    p.obs = (const bf16*)obs;
    p.action = (const int*)action;
    p.logp_old = (const float*)logp_old;
    p.value_old = (const float*)value_old;
    p.adv = (const float*)adv;
    p.target = (const float*)target;
    p.sw = (const float*)scales;
    p.cellmax = (float*)cellmax;
    p.cell_cols = cell_cols;
    p.ncell = cell_cols > 0 ? (cols + cell_cols - 1) / cell_cols : 1;
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
        p.wq[l] = quant != Q_NONE ? (const int8_t*)qweights[l] : nullptr;
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
    if (quant != Q_NONE) {
        p.sm_xq = sm;
        sm = align128(sm + obs_dim_pad * LDQ);
        for (int l = 0; l < num_layers; ++l) {
            p.sm_hq[l] = sm;
            sm = align128(sm + hidden[l] * LDQ);
        }
    }
    if (quant == Q_FULL) {
        p.sm_dpq = sm;
        sm = align128(sm + hmax * LDQ);
    }

    const Kernel kernel = pick_kernel(quant, bwd_bf16);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    const int stages = quant == Q_FULL ? num_layers + 1 : 1;
    for (int stage = 0; stage < stages; ++stage) {
        p.stage = stage;
        kernel<<<blocks, THREADS, sm, s>>>(p);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    reduce_partials<<<(stride + 255) / 256, 256, 0, s>>>((const float*)partial, blocks,
                                                          stride, (float*)out);
    return (int)cudaGetLastError();
}
