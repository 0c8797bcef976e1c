// K1's int8 mode (quant="int8") for Hopper, on the split design.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:504
// `fused_ppo_grads_fm` (kernel body `_fm_kernel`, :244; pallas_call :618) in
// its int8 mode (`quant == "full"` there).  Python side:
// pikazoo_tpu_torch/train/fused_update.py (`fused_ppo_grads_fm`, and the
// stage entries `k1_int8_chain` / `k1_int8_dw`), which also holds the plain
// versions the kernels are held against: `k1_int8_chain_plain` (kernels A
// and S) and `k1_int8_dw_plain` (kernel Q and the head's dW).
//
// What it computes: the forward on int8 products (weights int8 per tensor,
// activations with the static scale 127), the clipped-PPO loss and dheads,
// the head's backward in bf16, and the hidden chain in int8 with a dynamic
// max-abs scale of dpre per frame and column cell (1024 columns at the
// learner's width, the whole frame when N is no multiple of 128).  The
// rounding points are the JAX kernel's: x_q, h_q and dp_q are its integers,
// bf16(h_q_top * bf16(1/127)) and bf16(dheads) the head products' operands,
// the f32 dpre carried between launches the value it holds before `_dyn_q`,
// and each cell's int8 dW product is an exact int32 sum.  Only the f32 order
// of the sums across cells and blocks differs.
//
// What bounds it.  ~1.0 ms a full-width call (T=32, N=131072, hidden (256,
// 256)) at the tensor cores' int8 rate.  The one-kernel design that
// preceded this one took ~113 ms: the per-cell scale needs a barrier across
// the grid between layers, which it got from L+1 launches that each
// recomputed the forward, and each block read-modified-wrote its partial of
// every dW for every 64-column tile (~34 GB of L2 traffic at stage 1 alone).
//
// What this design does about it: the launch boundary stays the barrier,
// but nothing is recomputed, and the dW products leave the tile loop.
// - Kernel A (int8_chain_kernel) walks 64-column tiles of a chunk of
//   frames: x_q, the int8 forward on mma.sync m16n8k32 (s8 -> s32, bias add,
//   tanh and q127 on the accumulators; this device code, mma_s8_add and
//   dequant_add, is k1_split.cuh's, shared with the int8fwd mode), the
//   merged head, the loss and dheads (ppo_column),
//   and the head's backward dh on bf16 mma.sync.  It writes x_q and h_q_l
//   (int8), bf16(h_top) and bf16(dheads), and the f32 dpre_{L-1} to a
//   workspace, and takes dpre_{L-1}'s cell maxima with an atomicMax on the
//   float bits (order-free for non-negative floats, so deterministic).  The
//   weights sit in shared memory where they fit (84 KB of int8 at hidden
//   (256, 256)), else they are read as fragments from L2.
// - Kernel S (requant_kernel) runs once a hidden layer l, from L-1 down: it
//   quantises f32 dpre_l with the finished cell maxima to dp_q_l, sums the
//   rows of dpre_l into the bias grad, and for l > 0 computes dh = float(Wq_l
//   . dp_q_l) * (sw_l * sa/127) on s8 mma.sync (Wq_l in shared memory), then
//   dpre_{l-1} and its cell maxima.  dpre_{l-1} takes dpre_l's place in the
//   workspace.
// - Kernel Q (dwq_kernel) computes each hidden dW_l = sum over cells of
//   float(below_q . dp_q_l^T) * (sa/127 * 1/127) as one product over the
//   workspace's columns, the layout m16n8k32 wants for both operands (no
//   8-bit transpose needed).  A block keeps a 128 x 64 output tile in
//   registers over a column range of whole cells; each cell's sum stays
//   exact in an int32 fragment (1,024 x 127^2 < 2^31; a whole-frame cell up
//   to 133,144 columns) and joins the f32 sum scaled at the cell's end.  The
//   head's dW (a bf16 product) runs through the bf16 mode's dw_kernel
//   (k1_split.cuh).
// - No 8-bit transpose in hardware: the int8 products want each operand's
//   contraction dimension contiguous.  So the tiles that feed kernel A's and
//   S's products sit [column][feature] in shared memory, the forward weights
//   come transposed ([out][in]) from the wrapper, and h_q is written twice
//   from the accumulators: [column][feature] for the next product and
//   [feature][column] for the workspace.
// - Determinism: per-block partials (A: the head's bias grad and loss sums;
//   S: the hidden bias grads; Q and the head's dW: output tiles), each added
//   to in a fixed order across chunks and summed over blocks in block order
//   by reduce_partials.  The only atomics are the order-free cell maxima.
//
// Chunks.  The wrapper runs A, S x L and the two dW kernels over chunks of
// whole frames (one frame at the learner's width); the cell maxima span the
// whole minibatch.  A frame's columns are padded to a multiple of 64 in the
// workspace; columns >= N hold dheads = dpre = dp_q = 0 (and x_q = 0), so
// they add nothing to any grad or cell maximum.
//
// Resources (nvcc -Xptxas -v, sm_90a): kernel A 126 registers at 512
// threads, a 128-byte stack (ppo_column's per-column array), 192,000 B of
// shared memory at hidden (256, 256), F=35, the weights staged (one block an
// SM); kernel S 128 registers at 512, 108,608 B; kernel Q 128 registers at
// 256, 46,080 B; no spills.  Time on an H100 at full width (chip_smoke.py
// phase 11): 26.6 ms a call, A 12.7, S 8.5 for both layers, the dW kernels
// 5.6, against the design's floor by bytes of 9.4 ms (~7.5 KB a column of
// workspace traffic).  Kernel S's loads of a tile are all issued before any
// is used: one after another, their latencies bound it.  Not done here
// (later work): the loss over more threads, a cheaper accurate tanh, kernel
// S's byte stores into the [column][feature] tile without bank conflicts,
// wgmma and TMA.

#include "k1_split.cuh"

// COLS (columns per tile of kernels A and S), LDH, LDZ, HEAD_PAD and S_IN
// are k1_split.cuh's.
#define WARPS A_WARPS       // warp_tile's warps
#define THREADS (32 * WARPS)
#define LT (COLS + 16)      // row stride (bytes) of the [feature][column] int8 staging tile
#define KPAD 16             // bytes past K in a shared int8 row: the fragment loads miss no bank twice
#define LDHB (HEAD_PAD + 8) // row stride of the head's bf16 weights (elements)
#define QB 64               // kernel Q's output tile: BT rows x QB columns
#define QLD (KB + 16)       // row stride (bytes) of kernel Q's operand slices
#define MAX_QTILES 64
#define MAX_INT8_CELL 133144  // columns of the widest cell whose int32 sums cannot overflow
#define S_LOADS (256 * (COLS / 4) / THREADS)      // float4 of dpre_l a thread and tile, at most
#define S_HB_LOADS (256 * (COLS / 16) / THREADS)  // 16-byte pieces of h_q_{l-1} a thread and tile

// ------------------------------------------------------------ helpers --
// The block's max of m (>= 0) into *slot with an atomicMax on the float
// bits.  Every thread calls it; the caller syncs before warp_max is reused.
__device__ __forceinline__ void cell_max(float m, float* warp_max, float* slot) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        float x = 0.0f;
        for (int w = 0; w < WARPS; ++w) x = fmaxf(x, warp_max[w]);
        atomicMax(reinterpret_cast<int*>(slot), __float_as_int(x));
    }
}

// rows x kp int8 (row stride kp) from global to shared memory (row stride
// kp + KPAD), 16 bytes a thread.
__device__ __forceinline__ void stage_weights(int8_t* dst, const int8_t* src, int rows, int kp) {
    const int per = kp >> 4;
    for (int i = threadIdx.x; i < rows * per; i += THREADS) {
        const int r = i / per, x = i - r * per;
        *reinterpret_cast<uint4*>(dst + r * (kp + KPAD) + x * 16) =
            *reinterpret_cast<const uint4*>(src + (size_t)r * kp + x * 16);
    }
}

// ----------------------------------------------------------- kernel A --
struct ParamsA8 {
    const bf16* obs;
    const int* action;
    const float *logp_old, *value_old, *adv, *target;
    const int8_t* wt[MAX_LAYERS + 1];  // forward weights, transposed: (rows, kp[l]); wt[L] the head
    int kp[MAX_LAYERS + 1];            // each forward product's depth (a multiple of 32)
    const bf16* whb;                   // the int8 head as bf16, (h_top, HEAD_PAD)
    const float* b[MAX_LAYERS + 1];
    const float* sw;                   // the L+1 weight scales
    int hidden[MAX_LAYERS];
    int L, F, Fp, A, N, Npad, T, t0, frames, cw, ncell;
    float clip, neg_inv_m, ent_scale, val_scale;
    int8_t* wsq;                       // int8 rows: x_q (Fp), h_q_l
    bf16* wsb;                         // bf16 rows: bf16(h_top), dheads (HEAD_PAD)
    float* wsf;                        // f32 rows: dpre_{L-1} from row off_f
    long long ws_cols, row_h[MAX_LAYERS], off_f;
    float* cellmax;                    // (L, T, ncell)
    float* partial;                    // (blocks, HEAD_PAD + 4): the head's bias grad, the loss sums
    int first, smem_w, lda, bias_total;
    int sm_act[2], sm_tq, sm_z, sm_dh, sm_loss, sm_bias, sm_bgrad, sm_wmax, sm_wh, sm_whb;
    int sm_w[MAX_LAYERS];
};

__global__ void __launch_bounds__(THREADS, 1) int8_chain_kernel(const __grid_constant__ ParamsA8 p) {
    extern __shared__ __align__(128) unsigned char smem[];
    int8_t* tq = (int8_t*)(smem + p.sm_tq);
    float* z = (float*)(smem + p.sm_z);
    bf16* dhb = (bf16*)(smem + p.sm_dh);
    float* closs = (float*)(smem + p.sm_loss);  // [4][COLS]
    float* bias = (float*)(smem + p.sm_bias);
    float* bgrad = (float*)(smem + p.sm_bgrad);  // the head's HEAD_PAD, then the 4 loss sums
    float* lacc = bgrad + HEAD_PAD;
    float* wmax = (float*)(smem + p.sm_wmax);
    const bf16* whb = (const bf16*)(smem + p.sm_whb);
    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tg = lane & 3;
    const int L = p.L, A = p.A, h_top = p.hidden[L - 1], lda = p.lda;

    stage_weights((int8_t*)(smem + p.sm_wh), p.wt[L], HEAD_PAD, p.kp[L]);
    if (p.smem_w)
        for (int l = 0; l < L; ++l)
            stage_weights((int8_t*)(smem + p.sm_w[l]), p.wt[l], p.hidden[l], p.kp[l]);
    for (int i = tid; i < h_top * (HEAD_PAD / 8); i += THREADS) {
        const int r = i / (HEAD_PAD / 8), x = (i % (HEAD_PAD / 8)) * 8;
        *reinterpret_cast<uint4*>((bf16*)whb + r * LDHB + x) =
            *reinterpret_cast<const uint4*>(p.whb + r * HEAD_PAD + x);
    }
    {
        int pos = 0;
        for (int l = 0; l <= L; ++l) {
            const int n = l < L ? p.hidden[l] : HEAD_PAD;
            for (int i = tid; i < n; i += THREADS) bias[pos + i] = p.b[l][i];
            pos += n;
        }
        if (tid < HEAD_PAD + 4) bgrad[tid] = 0.0f;
    }
    __syncthreads();

    const int tpf = p.Npad / COLS;
    const int tiles = p.frames * tpf;
    const int first = (int)((long long)tiles * blockIdx.x / gridDim.x);
    const int last = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
    const float s_in_b = __bfloat162float(__float2bfloat16(S_IN));

    for (int tile = first; tile < last; ++tile) {
        const int tr = tile / tpf, c0 = (tile - tr * tpf) * COLS;
        const int t = p.t0 + tr;
        const int nvalid = min(COLS, p.N - c0);
        const long long wc0 = (long long)tr * p.Npad + c0;

        // ---- x_q = q127(obs) (Fp, COLS): to the act tile [column][feature]
        // and to the workspace; zero at rows >= F and columns >= nvalid.
        {
            int8_t* act = (int8_t*)(smem + p.sm_act[0]);
            for (int i = tid; i < p.Fp * (COLS / 8); i += THREADS) {
                const int f = i >> 3, c = (i & 7) * 8;
                float v[8];
                const bf16* src = p.obs + ((size_t)t * p.F + f) * p.N + c0 + c;
                if ((p.N & 7) == 0) {
                    uint4 u = make_uint4(0u, 0u, 0u, 0u);
                    if (f < p.F && c < nvalid) u = *reinterpret_cast<const uint4*>(src);
                    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float2 x = __bfloat1622float2(pr[e]);
                        v[2 * e] = x.x;
                        v[2 * e + 1] = x.y;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        v[e] = (f < p.F && c + e < nvalid) ? __bfloat162float(src[e]) : 0.0f;
                }
                uint32_t word[2] = {0u, 0u};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int8_t q = q127(v[e]);
                    act[(c + e) * lda + f] = q;
                    word[e >> 2] |= (uint32_t)(uint8_t)q << (8 * (e & 3));
                }
                *reinterpret_cast<uint2*>(p.wsq + (size_t)f * p.ws_cols + wc0 + c) =
                    make_uint2(word[0], word[1]);
            }
        }
        __syncthreads();

        // ---- forward: h_q_l = q127(tanh(float(Wq_l^T h_q) * sw_l/127 + b_l)).
        int boff = 0;
        for (int l = 0; l < L; ++l) {
            const int H = p.hidden[l];
            const int8_t* in = (const int8_t*)(smem + p.sm_act[l & 1]);
            int8_t* out = (int8_t*)(smem + p.sm_act[(l + 1) & 1]);
            const WarpTile wt = warp_tile(H);
            if (wt.active) {
                int acc[8][4];
                if (p.smem_w)
                    mma_s8_tile(acc, wt, (const int8_t*)(smem + p.sm_w[l]), p.kp[l] + KPAD, in, lda,
                                p.kp[l]);
                else
                    mma_s8_tile(acc, wt, p.wt[l], p.kp[l], in, lda, p.kp[l]);
                const float scale = __fmul_rn(p.sw[l], S_IN);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= wt.nb) continue;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                        const int8_t q0 = q127(tanhf(dequant_add(acc[j][2 * hh], scale, bias[boff + r])));
                        const int8_t q1 = q127(tanhf(dequant_add(acc[j][2 * hh + 1], scale, bias[boff + r])));
                        out[c * lda + r] = q0;
                        out[(c + 1) * lda + r] = q1;
                        *reinterpret_cast<uint16_t*>(tq + r * LT + c) =
                            (uint16_t)((uint8_t)q0 | ((uint16_t)(uint8_t)q1 << 8));
                    }
                }
            }
            __syncthreads();
            // h_q_l to the workspace; for the top layer bf16(h_q * bf16(1/127)) too.
            for (int i = tid; i < H * (COLS / 16); i += THREADS) {
                const int r = i >> 2, x = (i & 3) * 16;
                *reinterpret_cast<uint4*>(p.wsq + (p.row_h[l] + r) * p.ws_cols + wc0 + x) =
                    *reinterpret_cast<const uint4*>(tq + r * LT + x);
            }
            if (l == L - 1) {
                for (int i = tid; i < H * (COLS / 8); i += THREADS) {
                    const int r = i >> 3, x = (i & 7) * 8;
                    const uint2 u = *reinterpret_cast<const uint2*>(tq + r * LT + x);
                    const int8_t* q = reinterpret_cast<const int8_t*>(&u);
                    uint4 o;
                    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        ob[e] = __floats2bfloat162_rn(__fmul_rn((float)q[2 * e], s_in_b),
                                                      __fmul_rn((float)q[2 * e + 1], s_in_b));
                    *reinterpret_cast<uint4*>(p.wsb + r * p.ws_cols + wc0 + x) = o;
                }
            }
            __syncthreads();
            boff += H;
        }
        const int8_t* top = (const int8_t*)(smem + p.sm_act[L & 1]);

        // ---- the merged head: z = float(Wq_L^T h_q_top) * sw_L/127, before its bias.
        {
            const WarpTile wt = warp_tile(HEAD_PAD);
            if (wt.active) {
                int acc[8][4];
                mma_s8_tile(acc, wt, (const int8_t*)(smem + p.sm_wh), p.kp[L] + KPAD, top, lda,
                            p.kp[L]);
                const float scale = __fmul_rn(p.sw[L], S_IN);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= wt.nb) continue;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                        *reinterpret_cast<float2*>(z + r * LDZ + c) =
                            make_float2(__fmul_rn((float)acc[j][2 * hh], scale),
                                        __fmul_rn((float)acc[j][2 * hh + 1], scale));
                    }
                }
            }
        }
        __syncthreads();

        // ---- loss and dheads, one thread a column.
        if (tid < COLS) {
            const int c = tid;
            float dcol[HEAD_PAD];
            LossTerms lt = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) dcol[r] = 0.0f;
            if (c < nvalid) {
                const size_t gi = (size_t)t * p.N + c0 + c;
                lt = ppo_column(z + c, LDZ, bias + boff, A, A, p.action[gi], p.logp_old[gi],
                                p.adv[gi], p.value_old[gi], p.target[gi], p.clip, p.neg_inv_m,
                                p.ent_scale, p.val_scale, dcol, dcol + A);
            }
            closs[0 * COLS + c] = lt.pol;
            closs[1 * COLS + c] = lt.val;
            closs[2 * COLS + c] = lt.ent;
            closs[3 * COLS + c] = lt.kl;
            // Each thread reads and writes its own column of z only.
#pragma unroll
            for (int r = 0; r < HEAD_PAD; ++r) {
                z[r * LDZ + c] = dcol[r];
                dhb[r * LDH + c] = __float2bfloat16(dcol[r]);
            }
        }
        __syncthreads();
        row_sums<COLS>(z, LDZ, HEAD_PAD, bgrad);
        row_sums<COLS>(closs, COLS, 4, lacc);
        for (int i = tid; i < HEAD_PAD * (COLS / 8); i += THREADS) {
            const int r = i >> 3, x = (i & 7) * 8;
            *reinterpret_cast<uint4*>(p.wsb + (h_top + r) * p.ws_cols + wc0 + x) =
                *reinterpret_cast<const uint4*>(dhb + r * LDH + x);
        }

        // ---- the head's backward: dh = (bf16(Wq_L) . bf16(dheads)) * sw_L on
        // bf16 mma.sync, then dpre_{L-1} = dh * (1 - hf^2), hf = h_q / 127, to
        // the workspace in f32, and its cell maximum.
        {
            const WarpTile wt = warp_tile(h_top);
            float m = 0.0f;
            if (wt.active) {
                float acc[8][4];
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
                const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
                for (int kk = 0; kk < HEAD_PAD; kk += 16) {
                    uint32_t a[4];
                    ldsm_x4(a, whb + (wt.m0 + (lane & 15)) * LDHB + kk + (lane >> 4) * 8);
#pragma unroll
                    for (int j = 0; j < 8; j += 2) {
                        if (j < wt.nb) {
                            uint32_t b[4];
                            ldsm_x4_t(b, dhb + (kk + r8 + (mi & 1) * 8) * LDH + wt.n0 +
                                             (j + (mi >> 1)) * 8);
                            mma_add(acc[j], a, b[0], b[1]);
                            mma_add(acc[j + 1], a, b[2], b[3]);
                        }
                    }
                }
                const float sw_top = p.sw[L];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= wt.nb) continue;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                        const float h0 = __fmul_rn((float)top[c * lda + r], S_IN);
                        const float h1 = __fmul_rn((float)top[(c + 1) * lda + r], S_IN);
                        const float d0 = __fmul_rn(__fmul_rn(acc[j][2 * hh], sw_top),
                                                   __fsub_rn(1.0f, __fmul_rn(h0, h0)));
                        const float d1 = __fmul_rn(__fmul_rn(acc[j][2 * hh + 1], sw_top),
                                                   __fsub_rn(1.0f, __fmul_rn(h1, h1)));
                        *reinterpret_cast<float2*>(p.wsf + (p.off_f + r) * p.ws_cols + wc0 + c) =
                            make_float2(d0, d1);
                        m = fmaxf(m, fmaxf(fabsf(d0), fabsf(d1)));
                    }
                }
            }
            cell_max(m, wmax, p.cellmax + ((size_t)(L - 1) * p.T + t) * p.ncell + c0 / p.cw);
        }
        __syncthreads();
    }
    float* part = p.partial + (size_t)blockIdx.x * (HEAD_PAD + 4);
    if (tid < HEAD_PAD + 4) part[tid] = p.first ? bgrad[tid] : __fadd_rn(part[tid], bgrad[tid]);
}

// ----------------------------------------------------------- kernel S --
struct ParamsS {
    const int8_t* wd;    // Wq_l (Hb, kp) int8, l > 0
    const float* sw;
    int l, H, Hb, kp;    // H = hidden[l], Hb = hidden[l-1], kp = H padded to 32
    int T, t0, frames, Npad, cw, ncell;
    int8_t* wsq;
    float* wsf;
    long long ws_cols, row_dq, row_hb, off_f, off_fb;  // rows: dp_q_l, h_q_{l-1}; dpre_l, dpre_{l-1}
    float* cellmax;
    float* partial;      // (blocks, stride); this layer's bias grad from boff
    int stride, boff, first;
    int sm_w, sm_dq, sm_hb, sm_bg, sm_wmax;
};

__global__ void __launch_bounds__(THREADS, 1) requant_kernel(const __grid_constant__ ParamsS p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int8_t* w = (const int8_t*)(smem + p.sm_w);
    int8_t* dq = (int8_t*)(smem + p.sm_dq);       // dp_q_l [column][feature]
    int8_t* hb = (int8_t*)(smem + p.sm_hb);       // h_q_{l-1} [feature][column]
    float* bg = (float*)(smem + p.sm_bg);
    float* wmax = (float*)(smem + p.sm_wmax);
    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tg = lane & 3;
    const int H = p.H, lda = p.kp + KPAD;
    if (p.l > 0) stage_weights((int8_t*)w, p.wd, p.Hb, p.kp);
    for (int i = tid; i < H; i += THREADS) bg[i] = 0.0f;
    __syncthreads();

    const int tpf = p.Npad / COLS;
    const int tiles = p.frames * tpf;
    const int first = (int)((long long)tiles * blockIdx.x / gridDim.x);
    const int last = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
    for (int tile = first; tile < last; ++tile) {
        const int tr = tile / tpf, c0 = (tile - tr * tpf) * COLS;
        const int t = p.t0 + tr, cell = c0 / p.cw;
        const long long wc0 = (long long)tr * p.Npad + c0;
        const float sa = fmaxf(p.cellmax[((size_t)p.l * p.T + t) * p.ncell + cell], 1e-30f);
        const float inv = __fdiv_rn(127.0f, sa);

        // ---- dp_q_l = rint(dpre_l * 127/sa): to the workspace and to dq;
        // the rows of dpre_l summed into the bias grad, a half-warp a row.
        // Every load of the tile is issued before any is used, so that their
        // latencies overlap (one after another they bound the kernel).
        float4 v[S_LOADS];
        uint4 u[S_HB_LOADS];
#pragma unroll
        for (int k = 0; k < S_LOADS; ++k) {
            const int i = tid + k * THREADS;
            if (i < H * (COLS / 4))
                v[k] = *reinterpret_cast<const float4*>(p.wsf + (p.off_f + (i >> 4)) * p.ws_cols +
                                                        wc0 + (i & 15) * 4);
        }
#pragma unroll
        for (int k = 0; k < S_HB_LOADS; ++k) {
            const int i = tid + k * THREADS;
            if (i < p.Hb * (COLS / 16))
                u[k] = *reinterpret_cast<const uint4*>(p.wsq + (p.row_hb + (i >> 2)) * p.ws_cols +
                                                       wc0 + (i & 3) * 16);
        }
#pragma unroll
        for (int k = 0; k < S_LOADS; ++k) {
            const int i = tid + k * THREADS;
            if (i >= H * (COLS / 4)) continue;   // warp-uniform: H * 16 is a multiple of 256
            const int r = i >> 4, c = (i & 15) * 4;
            const int8_t q[4] = {(int8_t)rintf(__fmul_rn(v[k].x, inv)), (int8_t)rintf(__fmul_rn(v[k].y, inv)),
                                 (int8_t)rintf(__fmul_rn(v[k].z, inv)), (int8_t)rintf(__fmul_rn(v[k].w, inv))};
            uint32_t word = 0u;
#pragma unroll
            for (int e = 0; e < 4; ++e) word |= (uint32_t)(uint8_t)q[e] << (8 * e);
            *reinterpret_cast<uint32_t*>(p.wsq + (p.row_dq + r) * p.ws_cols + wc0 + c) = word;
            if (p.l > 0) {
#pragma unroll
                for (int e = 0; e < 4; ++e) dq[(c + e) * lda + r] = q[e];
            }
            float s = ((v[k].x + v[k].y) + v[k].z) + v[k].w;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            if ((lane & 15) == 0) bg[r] += s;
        }
#pragma unroll
        for (int k = 0; k < S_HB_LOADS; ++k) {
            const int i = tid + k * THREADS;
            if (i < p.Hb * (COLS / 16)) *reinterpret_cast<uint4*>(hb + (i >> 2) * LT + (i & 3) * 16) = u[k];
        }
        // Every read of this tile's dpre_l is done before dpre_{l-1} may
        // take its place.
        __syncthreads();
        if (p.l == 0) continue;

        // ---- dh = float(Wq_l . dp_q_l) * (sw_l * sa/127), dpre_{l-1} = dh *
        // (1 - hf^2) to the workspace, and its cell maximum.
        const WarpTile wt = warp_tile(p.Hb);
        float m = 0.0f;
        if (wt.active) {
            int acc[8][4];
            mma_s8_tile(acc, wt, w, lda, dq, lda, p.kp);
            const float scale = __fmul_rn(p.sw[p.l], __fmul_rn(sa, S_IN));
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                if (j >= wt.nb) continue;
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                    const float h0 = __fmul_rn((float)hb[r * LT + c], S_IN);
                    const float h1 = __fmul_rn((float)hb[r * LT + c + 1], S_IN);
                    const float d0 = __fmul_rn(__fmul_rn((float)acc[j][2 * hh], scale),
                                               __fsub_rn(1.0f, __fmul_rn(h0, h0)));
                    const float d1 = __fmul_rn(__fmul_rn((float)acc[j][2 * hh + 1], scale),
                                               __fsub_rn(1.0f, __fmul_rn(h1, h1)));
                    *reinterpret_cast<float2*>(p.wsf + (p.off_fb + r) * p.ws_cols + wc0 + c) =
                        make_float2(d0, d1);
                    m = fmaxf(m, fmaxf(fabsf(d0), fabsf(d1)));
                }
            }
        }
        cell_max(m, wmax, p.cellmax + ((size_t)(p.l - 1) * p.T + t) * p.ncell + cell);
        __syncthreads();
    }
    float* part = p.partial + (size_t)blockIdx.x * p.stride + p.boff;
    for (int i = tid; i < H; i += THREADS) part[i] = p.first ? bg[i] : __fadd_rn(part[i], bg[i]);
}

// ----------------------------------------------------------- kernel Q --
// dW_l (M x N) = sum over cells of float(a (M x cols) . b (N x cols)^T) *
// scale(cell), both operands int8 rows of the workspace (row stride ws_cols).
struct ProdQ {
    const int8_t* a;
    const int8_t* b;
    int M, N, off, layer;
};

struct TileQ {
    int prod, m0, n0;
};

struct ParamsQ {
    ProdQ prod[MAX_LAYERS];
    TileQ tile[MAX_QTILES];
    int ntiles, ranges, first;
    const float* cellmax;  // (L, T, ncell)
    int T, t0, ncell, cells, spc;  // cells in this chunk, 64-column slices a cell
    long long ws_cols;
    float* partial;        // (ranges, stride): every hidden dW, row-major, one after another
    int stride;
};

__device__ __forceinline__ void load_q(const ProdQ& pr, const TileQ& t, int8_t* as, int8_t* bs,
                                       long long ws_cols, long long gc0) {
    const int a_n = min(BT, pr.M - t.m0), b_n = min(QB, pr.N - t.n0);
    for (int c = threadIdx.x; c < (a_n + b_n) * (KB / 16); c += B_THREADS) {
        int r = c >> 2;
        const int x = (c & 3) * 16;
        if (r < a_n) {
            cp_async16(as + r * QLD + x, pr.a + (size_t)(t.m0 + r) * ws_cols + gc0 + x);
        } else {
            r -= a_n;
            cp_async16(bs + r * QLD + x, pr.b + (size_t)(t.n0 + r) * ws_cols + gc0 + x);
        }
    }
}

__global__ void __launch_bounds__(B_THREADS) dwq_kernel(const __grid_constant__ ParamsQ p) {
    extern __shared__ __align__(128) unsigned char smem[];
    int8_t* ring = (int8_t*)smem;  // stages of [A slice (BT x QLD) | B slice (QB x QLD)]
    const int stage = (BT + QB) * QLD;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tg = lane & 3;
    // Rows that are never loaded (past an operand's rows) stay zero.
    for (int i = tid; i < B_STAGES * stage / 16; i += B_THREADS)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const TileQ t = p.tile[blockIdx.x % p.ntiles];
    const int range = blockIdx.x / p.ntiles;
    const ProdQ& pr = p.prod[t.prod];
    // A range is whole cells, so no cell's integer sum is split.
    const int cell0 = (int)((long long)p.cells * range / p.ranges);
    const int cell1 = (int)((long long)p.cells * (range + 1) / p.ranges);
    const int s0 = cell0 * p.spc, n = (cell1 - cell0) * p.spc;
#pragma unroll
    for (int i = 0; i < B_STAGES - 1; ++i) {
        if (i < n) load_q(pr, t, ring + i * stage, ring + i * stage + BT * QLD, p.ws_cols,
                          (long long)(s0 + i) * KB);
        cp_commit();
    }
    // Warp (wm, wn) owns rows m0 + wm*32 .. +32 and columns n0 + wn*32 .. +32.
    const int wm = warp >> 1, wn = warp & 1;
    const bool mv0 = t.m0 + wm * 32 < pr.M, mv1 = t.m0 + wm * 32 + 16 < pr.M;
    const int nb = max(0, min(4, (pr.N - t.n0 - wn * 32) / 8));
    int acc[2][4][4];
    float sum[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[a][j][i] = 0;
                sum[a][j][i] = 0.0f;
            }
    const int mi = lane >> 3, r8 = lane & 7;
    for (int s = 0; s < n; ++s) {
        cp_wait<B_STAGES - 2>();
        __syncthreads();
        if (s + B_STAGES - 1 < n) {
            int8_t* st = ring + ((s + B_STAGES - 1) % B_STAGES) * stage;
            load_q(pr, t, st, st + BT * QLD, p.ws_cols, (long long)(s0 + s + B_STAGES - 1) * KB);
        }
        cp_commit();
        const int8_t* as = ring + (s % B_STAGES) * stage;
        const int8_t* bs = as + BT * QLD;
#pragma unroll
        for (int kk = 0; kk < KB; kk += 32) {
            // ldmatrix moves 16-bit pairs; with 16 bytes of k a row it hands
            // each thread the 4 bytes m16n8k32's fragments want.
            uint32_t a0[4], a1[4];
            if (mv0) ldsm_x4(a0, as + (wm * 32 + (lane & 15)) * QLD + kk + (lane >> 4) * 16);
            if (mv1) ldsm_x4(a1, as + (wm * 32 + 16 + (lane & 15)) * QLD + kk + (lane >> 4) * 16);
#pragma unroll
            for (int j = 0; j < 4; j += 2) {
                if (j < nb) {
                    uint32_t b[4];  // (n j, k +0), (n j, k +16), (n j+1, k +0), (n j+1, k +16)
                    ldsm_x4(b, bs + (wn * 32 + (j + (mi >> 1)) * 8 + r8) * QLD + kk + (mi & 1) * 16);
                    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
                    if (mv0) {
                        mma_s8(acc[0][j], a0, b0);
                        mma_s8(acc[0][j + 1], a0, b1);
                    }
                    if (mv1) {
                        mma_s8(acc[1][j], a1, b0);
                        mma_s8(acc[1][j + 1], a1, b1);
                    }
                }
            }
        }
        if ((s0 + s + 1) % p.spc == 0) {
            // The cell ends: its exact sum, scaled by sa/127 * 1/127, joins
            // the running f32 sum.
            const int gc = (s0 + s) / p.spc, fr = gc / p.ncell, cell = gc - fr * p.ncell;
            const float sa =
                fmaxf(p.cellmax[((size_t)pr.layer * p.T + p.t0 + fr) * p.ncell + cell], 1e-30f);
            const float k = __fmul_rn(__fmul_rn(sa, S_IN), S_IN);
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        sum[a][j][i] = __fadd_rn(sum[a][j][i], __fmul_rn(__int2float_rn(acc[a][j][i]), k));
                        acc[a][j][i] = 0;
                    }
        }
    }
    cp_wait<0>();

    float* part = p.partial + (size_t)range * p.stride + pr.off;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        if (!(a == 0 ? mv0 : mv1)) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j >= nb) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = t.m0 + wm * 32 + a * 16 + g + 8 * hh;
                const int c = t.n0 + wn * 32 + j * 8 + 2 * tg;
                float2* dst = reinterpret_cast<float2*>(part + (size_t)r * pr.N + c);
                float2 v = make_float2(sum[a][j][2 * hh], sum[a][j][2 * hh + 1]);
                if (!p.first) {
                    const float2 old = *dst;
                    v.x = __fadd_rn(old.x, v.x);
                    v.y = __fadd_rn(old.y, v.y);
                }
                *dst = v;
            }
        }
    }
}

// ------------------------------------------------------------- launch --
static int round32(int x) { return (x + 31) / 32 * 32; }

// stages, bits: 1 kernel A (the head's bias grad, the loss sums, the
// workspace down to dpre_{L-1} and its cell maxima), 4 kernel S once a layer
// (the hidden bias grads, dp_q and the lower cell maxima), 2 the dW kernels
// (from a workspace and cell maxima that A and S filled).  The int8 workspace wsq (Fp + 2 sum(H)
// rows) holds x_q, h_q_0..h_q_{L-1}, dp_q_0..dp_q_{L-1}; the bf16 one wsb
// (H_top + HEAD_PAD rows) bf16(h_top) and dheads; the f32 one wsf dpre_l
// from row f_rows[l] (one shared buffer, or a buffer a layer).  Each has
// ws_cols >= chunk_frames * Npad columns, Npad = 64 * ceil(N / 64).
// cellmax (L, frames, ncell) is zero at the call's start.  out: every hidden
// dW, the head's dW (h_top x HEAD_PAD), the hidden bias grads, the head's,
// the 4 loss sums.
extern "C" int k1_int8_launch(
    const void* obs, const void* action, const void* logp_old, const void* value_old,
    const void* adv, const void* target, const void* const* wt, const void* const* wd,
    const void* whb, const void* const* biases, const void* sw, const int* hidden,
    int num_layers, int obs_dim, int obs_dim_pad, int num_actions, int frames, int cols,
    float clip_eps, float neg_inv_m, float ent_scale, float val_scale, void* wsq, void* wsb,
    void* wsf, long long ws_cols, const int* f_rows, int chunk_frames, void* cellmax,
    int cell_cols, void* partial_a, int blocks_a, void* partial_s, int blocks_s,
    void* partial_q, int ranges_q, void* partial_h, int ranges_h, void* out, void* stream,
    int stages) {
    const int L = num_layers;
    if (L < 1 || L > MAX_LAYERS || num_actions + 1 > HEAD_PAD || obs_dim > obs_dim_pad ||
        obs_dim_pad % 16 || frames < 1 || cols < 1 || chunk_frames < 1 || stages < 1 ||
        stages > 7 || blocks_a < 1 || blocks_s < 1 || ranges_q < 1 || ranges_h < 1 ||
        cell_cols < 1)
        return (int)cudaErrorInvalidValue;
    const int Npad = (cols + COLS - 1) / COLS * COLS;
    if (ws_cols < (long long)chunk_frames * Npad || ws_cols % 64) return (int)cudaErrorInvalidValue;
    // A cell is whole 64-column slices, or the whole frame (its N columns
    // summed in int32).
    const int cw = cell_cols >= cols ? Npad : cell_cols;
    if (cw % COLS || Npad % cw || (cw == Npad && cols > MAX_INT8_CELL))
        return (int)cudaErrorInvalidValue;
    const int ncell = Npad / cw;
    int H[MAX_LAYERS], sumH = 0, maxH = 0;
    for (int l = 0; l < L; ++l) {
        H[l] = hidden[l];
        if (H[l] <= 0 || H[l] % 16 || H[l] > 256) return (int)cudaErrorInvalidValue;
        sumH += H[l];
        maxH = max(maxH, H[l]);
    }
    const int h_top = H[L - 1];
    long long row_h[MAX_LAYERS], row_dq[MAX_LAYERS];
    for (int l = 0, row = obs_dim_pad; l < L; ++l) {
        row_h[l] = row;
        row_dq[l] = row + sumH;
        row += H[l];
    }
    int8_t* q8 = (int8_t*)wsq;
    bf16* b16 = (bf16*)wsb;
    int n_wh = 0, off_w[MAX_LAYERS];
    for (int l = 0; l < L; ++l) {
        off_w[l] = n_wh;
        n_wh += (l == 0 ? obs_dim_pad : H[l - 1]) * H[l];
    }
    const int n_w = n_wh + h_top * HEAD_PAD;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;

    ParamsA8 pa = {};
    ParamsS ps = {};
    int sm_a = 0, sm_s = 0;
    if (stages & 1) {
        pa.obs = (const bf16*)obs;
        pa.action = (const int*)action;
        pa.logp_old = (const float*)logp_old;
        pa.value_old = (const float*)value_old;
        pa.adv = (const float*)adv;
        pa.target = (const float*)target;
        pa.whb = (const bf16*)whb;
        pa.sw = (const float*)sw;
        pa.L = L;
        pa.F = obs_dim;
        pa.Fp = obs_dim_pad;
        pa.A = num_actions;
        pa.N = cols;
        pa.Npad = Npad;
        pa.T = frames;
        pa.cw = cw;
        pa.ncell = ncell;
        pa.clip = clip_eps;
        pa.neg_inv_m = neg_inv_m;
        pa.ent_scale = ent_scale;
        pa.val_scale = val_scale;
        pa.wsq = q8;
        pa.wsb = b16;
        pa.wsf = (float*)wsf;
        pa.ws_cols = ws_cols;
        pa.off_f = f_rows[L - 1];
        pa.cellmax = (float*)cellmax;
        pa.partial = (float*)partial_a;
        int kmax = 0;
        for (int l = 0; l <= L; ++l) {
            pa.wt[l] = (const int8_t*)wt[l];
            pa.b[l] = (const float*)biases[l];
            pa.kp[l] = round32(l == 0 ? obs_dim_pad : H[l - 1]);
            kmax = max(kmax, pa.kp[l]);
            if (l < L) {
                pa.hidden[l] = H[l];
                pa.row_h[l] = row_h[l];
            }
        }
        pa.lda = kmax + KPAD;
        pa.bias_total = sumH + HEAD_PAD;
        int sm = 0;
        auto take = [&](int bytes) {
            const int at = sm;
            sm = align128(sm + bytes);
            return at;
        };
        pa.sm_act[0] = take(COLS * pa.lda);
        pa.sm_act[1] = take(COLS * pa.lda);
        pa.sm_tq = take(maxH * LT);
        pa.sm_z = take(HEAD_PAD * LDZ * 4);
        pa.sm_dh = take(HEAD_PAD * LDH * 2);
        pa.sm_loss = take(4 * COLS * 4);
        pa.sm_bias = take(pa.bias_total * 4);
        pa.sm_bgrad = take((HEAD_PAD + 4) * 4);
        pa.sm_wmax = take(WARPS * 4);
        pa.sm_wh = take(HEAD_PAD * (pa.kp[L] + KPAD));
        pa.sm_whb = take(h_top * LDHB * 2);
        const int sm_base = sm;
        for (int l = 0; l < L; ++l) pa.sm_w[l] = take(H[l] * (pa.kp[l] + KPAD));
        // The hidden weights in shared memory where they fit, else read from L2.
        pa.smem_w = sm <= SMEM_LIMIT;
        sm_a = pa.smem_w ? sm : sm_base;
        err = cudaFuncSetAttribute(int8_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_a);
        if (err != cudaSuccess) return (int)err;
    }
    if (stages & 4) {
        ps.sw = (const float*)sw;
        ps.T = frames;
        ps.Npad = Npad;
        ps.cw = cw;
        ps.ncell = ncell;
        ps.wsq = q8;
        ps.wsf = (float*)wsf;
        ps.ws_cols = ws_cols;
        ps.cellmax = (float*)cellmax;
        ps.partial = (float*)partial_s;
        ps.stride = sumH;
        for (int l = 0; l < L; ++l) {
            const int kp = round32(H[l]), hb = l ? H[l - 1] : 0;
            const int need = align128(hb * (kp + KPAD)) + align128(COLS * (kp + KPAD)) +
                             align128(hb * LT) + align128(H[l] * 4) + WARPS * 4;
            sm_s = max(sm_s, need);
        }
        err = cudaFuncSetAttribute(requant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_s);
        if (err != cudaSuccess) return (int)err;
    }

    ParamsQ pq = {};
    ParamsB pb = {};
    const int sm_q = B_STAGES * (BT + QB) * QLD;
    const int sm_b = B_STAGES * 2 * BT * LDB * 2;
    if (stages & 2) {
        pq.cellmax = (const float*)cellmax;
        pq.T = frames;
        pq.ncell = ncell;
        pq.spc = cw / KB;
        pq.ws_cols = ws_cols;
        pq.partial = (float*)partial_q;
        pq.stride = n_wh;
        pq.ranges = ranges_q;
        int nt = 0;
        for (int l = 0; l < L; ++l) {
            ProdQ& pr = pq.prod[l];
            pr.a = q8 + (l == 0 ? 0 : row_h[l - 1]) * ws_cols;
            pr.b = q8 + row_dq[l] * ws_cols;
            pr.M = l == 0 ? obs_dim_pad : H[l - 1];
            pr.N = H[l];
            pr.off = off_w[l];
            pr.layer = l;
            for (int m0 = 0; m0 < pr.M; m0 += BT)
                for (int n0 = 0; n0 < pr.N; n0 += QB) {
                    if (nt == MAX_QTILES) return (int)cudaErrorInvalidValue;
                    pq.tile[nt++] = {l, m0, n0};
                }
        }
        pq.ntiles = nt;
        err = cudaFuncSetAttribute(dwq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_q);
        if (err != cudaSuccess) return (int)err;

        // The head's dW = bf16(h_top) . bf16(dheads)^T: the bf16 mode's kernel B
        // on a list of one product.
        pb.N = cols;
        pb.Npad = Npad;
        pb.ws_cols = ws_cols;
        pb.partial = (float*)partial_h;
        pb.stride = h_top * HEAD_PAD;
        pb.ranges = ranges_h;
        ProdB& hp = pb.prod[0];
        hp.a = b16;
        hp.b = b16 + (long long)h_top * ws_cols;
        hp.a_rows = hp.M = h_top;
        hp.N = HEAD_PAD;
        int nh = 0;
        for (int m0 = 0; m0 < h_top; m0 += BT) pb.tile[nh++] = {0, m0, 0};
        pb.ntiles = nh;
        err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_b);
        if (err != cudaSuccess) return (int)err;
    }

    for (int t0 = 0; t0 < frames; t0 += chunk_frames) {
        const int n_frames = min(chunk_frames, frames - t0);
        if (stages & 1) {
            pa.t0 = t0;
            pa.frames = n_frames;
            pa.first = t0 == 0;
            int8_chain_kernel<<<blocks_a, THREADS, sm_a, s>>>(pa);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        if (stages & 4) {
            for (int l = L - 1; l >= 0; --l) {
                const int kp = round32(H[l]), hb = l ? H[l - 1] : 0;
                ps.wd = l ? (const int8_t*)wd[l] : nullptr;
                ps.l = l;
                ps.H = H[l];
                ps.Hb = hb;
                ps.kp = kp;
                ps.t0 = t0;
                ps.frames = n_frames;
                ps.row_dq = row_dq[l];
                ps.row_hb = l ? row_h[l - 1] : 0;
                ps.off_f = f_rows[l];
                ps.off_fb = l ? f_rows[l - 1] : 0;
                int boff = 0;
                for (int i = 0; i < l; ++i) boff += H[i];
                ps.boff = boff;
                ps.first = t0 == 0;
                int sm = 0;
                ps.sm_w = sm;
                sm = align128(sm + hb * (kp + KPAD));
                ps.sm_dq = sm;
                sm = align128(sm + COLS * (kp + KPAD));
                ps.sm_hb = sm;
                sm = align128(sm + hb * LT);
                ps.sm_bg = sm;
                sm = align128(sm + H[l] * 4);
                ps.sm_wmax = sm;
                sm += WARPS * 4;
                requant_kernel<<<blocks_s, THREADS, sm, s>>>(ps);
                err = cudaGetLastError();
                if (err != cudaSuccess) return (int)err;
            }
        }
        if (stages & 2) {
            pq.t0 = t0;
            pq.cells = n_frames * ncell;
            pq.first = t0 == 0;
            dwq_kernel<<<pq.ntiles * ranges_q, B_THREADS, sm_q, s>>>(pq);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
            pb.t0 = t0;
            pb.cols = n_frames * Npad;
            pb.first = t0 == 0;
            dw_kernel<<<pb.ntiles * ranges_h, B_THREADS, sm_b, s>>>(pb);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    float* o = (float*)out;
    if (stages & 2) {
        reduce_partials<<<(n_wh + 255) / 256, 256, 0, s>>>((const float*)partial_q, ranges_q,
                                                           n_wh, o);
        reduce_partials<<<(h_top * HEAD_PAD + 255) / 256, 256, 0, s>>>(
            (const float*)partial_h, ranges_h, h_top * HEAD_PAD, o + n_wh);
    }
    if (stages & 4)
        reduce_partials<<<(sumH + 255) / 256, 256, 0, s>>>((const float*)partial_s, blocks_s,
                                                           sumH, o + n_w);
    if (stages & 1)
        reduce_partials<<<1, 256, 0, s>>>((const float*)partial_a, blocks_a, HEAD_PAD + 4,
                                          o + n_w + sumH);
    return (int)cudaGetLastError();
}
