// Kernel A of K1's bf16 mode at hidden (256, 256) for Hopper: the per-tile
// chain of the split design (fused_update_bf16.cu) on wgmma and TMA, with two
// ping-pong consumer warpgroups.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:504
// `fused_ppo_grads_fm`'s chain (kernel body `_fm_kernel`, :244) in the bf16
// mode at two hidden layers of 256, up to 48 padded features and 31 actions,
// tanh or relu: the flagship learner's update.  train/fused_update.py
// `chain_design` picks it there and fused_update_bf16.cu's k1_bf16_launch
// refuses it where k1w::takes below does not hold; every other call, and the
// int8fwd and bf16-backward modes, keep k1_split.cuh's chain_kernel.  It writes the
// same workspace rows, bias grads and loss sums as chain_kernel, so kernel B
// (dw_kernel), reduce_partials and the chunks are the split design's own.
//
// What bounds it.  At T=32, N=131072 (4,194,304 columns): the products are
// 159,744 MACs a column (forward 48x256 + 256x256 + 256x32, the head's dh
// 32x256, the hidden dh 256x256), 1.34 TFLOP a call, 1.36 ms at 989 TFLOP/s;
// the workspace it writes is 2,112 bytes a column and its inputs 90, 9.24 GB
// a call, 2.76 ms at 3.35 TB/s.  The bytes bound it.  It runs at 8.6-8.9 ms
// on an H100, each warpgroup's serial chain of waits and epilogues the limit
// (PERF.md §6).  chain_kernel ran at 17.8 ms:
// every product on mma.sync with ldmatrix fragments, 16 warps in lock-step
// through __syncthreads at every phase, ~319 KB of weights streamed by
// cp.async for every 64-column tile, the loss on 64 threads.
//
// The design, P2's phased kernel A (fm_roofline.cu) with K1's epilogues:
// - Two consumer warpgroups, each on a 64-column tile of its own (tiles 2u
//   and 2u+1 of the block's unit u), share one weight ring: each weight slice
//   serves 128 columns.  They meet only at the ring's mbarriers and run
//   freely, so one's epilogues overlap the other's wgmma; inside a
//   warpgroup, named barriers.  No __syncthreads spans the block inside the
//   tile loop.  (Strict turns, a named-barrier hand-over around each block's
//   wgmma, measured 1-4% slower on an H100: PERF.md §6.)
// - Inside a warpgroup the four 64-row blocks of a product are
//   software-pipelined: block b+1's first 128-deep group of wgmma runs while
//   block b's epilogue runs.
// - Every product is a wgmma on shared-memory operands, a 64-row output block
//   at a time: the activation tile [feature][column] (128-byte swizzled rows)
//   is B, MN-major; the weights are A, MN-major for the forward (W^T from W's
//   rows) and K-major for the dh products (W from W's rows), so one tensor map
//   serves W_1 and W_1^T.  The head is taken as P2 takes it: z^T = h_1^T Wpv
//   (M the tile's columns, N the 32 head rows, Wpv 64-byte swizzled), and dh_1
//   = Wpv . bf16(dheads), both from the one Wpv slice.
// - One producer warp streams the weights by TMA through a ring of 16 KB
//   stages, in P2's slice order: W_0 by column block, W_1 by column block in
//   128-row halves, Wpv whole, W_1 by row block in 128-column halves.  The
//   compute warps issue no copies.
// - The epilogues run on the accumulators in registers: the bias add, tanh or
//   relu and the bf16 round into the next product's tile; the loss on all 128
//   threads (a quad of threads holds a column's 32 head rows, 8 each); dpre =
//   dh * act'(bf16 h) with its f32 row sums, the bias grads.  TMA stores copy
//   the tiles to the workspace rows chain_kernel writes, one store a tile:
//   bf16(h_l), bf16(dheads), bf16(dpre_l).
// - The loss is ppo_column's (ppo_grads.cuh) operation for operation, except
//   that its two sums over the actions (sumex, and plogp for the entropy) are
//   taken over a thread's 8 rows and then across the quad, not in action
//   order; the maximum and the chosen action's log-probability are exact in
//   any order.  A row's exp and probability are computed once (ppo_column
//   computes them again in each loop: the same values).
// - Rounding.  The tensor cores' f32 sums round toward zero (PERF.md §6).
//   Each product's K is summed in fresh accumulations of at most 128
//   contraction rows (one ring slice, 8 k16 steps of wgmma), which the
//   running sum takes with __fadd_rn, in k order.  chain_kernel's rule is 16
//   rows (mma_add, k1_split.cuh); at 16 rows here every wgmma waits for its
//   own result, and kernel A took 17.4 ms (PERF.md §6).  At 128 rows the
//   call's worst grad leaf sat 1.08x the plain version's distance from
//   float64 (1.04x at 64, 0.80x at 16; chip_smoke.py holds it under 2x).
// - Determinism.  Bias grads in shared memory per warpgroup and loss sums in
//   registers per thread, each added to in a fixed order, both warpgroups
//   summed in order into the block's partial; reduce_partials sums the blocks
//   in order.  No float atomics.
// - Every loop around a wgmma has a constant count and no wgmma sits under a
//   condition, so ptxas issues them without serializing (its warnings C7514,
//   C7518, C7520; chip_smoke.py phase 2).
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.9): 288 threads, 155 registers
// of the 168 a thread may have (9 warps leave one scheduler 3), a 16-byte
// stack, no spills, one block an SM; shared memory 225,856 B: the ring 4 x 16,384, two tile sets of 75,776 (x 48 x
// 128, h_0 and h_1 256 x 128, dheads 32 x 128), the biases, both
// warpgroups' bias grads and row-sum scratch, 8 mbarriers.

#pragma once

#include "hopper.cuh"
#include "ppo_grads.cuh"

namespace k1w {

using namespace hopper;
using namespace ppo;

constexpr int WG = 128;             // threads a consumer warpgroup
constexpr int NCG = 2;              // consumer warpgroups
constexpr int THREADS = NCG * WG + 32;  // and the producer warp
constexpr int SBOX = 64;            // rows a TMA store of h_l or dpre_l
constexpr int TILE = 64;            // columns a tile
constexpr int FPAD = 48;            // x's rows (the features, padded)
constexpr int HID = 256;            // each hidden width
constexpr int HEADR = 32;           // the merged head's rows (HEAD_PAD)
constexpr int NST = 4;              // ring stages
constexpr int STAGE = 16384;        // bytes a stage: 128 x 64 of W_1, or Wpv
constexpr int X_BYTES = FPAD * 128, H_BYTES = HID * 128, D_BYTES = HEADR * 128;
constexpr int SET_BYTES = X_BYTES + 2 * H_BYTES + D_BYTES;
constexpr int NBIAS = 2 * HID + HEADR;  // b_0, b_1, bpv: the bias grads' layout
constexpr int SMEM = 1024 + NST * STAGE + NCG * SET_BYTES +
                     (3 * NBIAS + NCG * 4 * HEADR + NCG * 4 * 4) * 4 + 2 * NST * 8;

struct Params {
    CUtensorMap w0;   // W_0 (Fp, 256): boxes of 48 x 64, 128-byte swizzle
    CUtensorMap w1;   // W_1 (256, 256): boxes of 64 x 64
    CUtensorMap wpv;  // Wpv (256, 32): one box, 64-byte swizzle
    CUtensorMap ws;   // the workspace: boxes of SBOX rows x 64 columns
    CUtensorMap ws_d; // the workspace: boxes of HEADR rows x 64 columns (dheads)
    const bf16* obs;  // (T, F, N)
    const int* action;
    const float *logp_old, *value_old, *adv, *target;
    const float* b[3];
    float* partial;   // (blocks, NBIAS + 4): bias grads, then the 4 loss sums
    int F, A, relu, N, Npad, t0, frames, first;
    int row_h0, row_h1, row_dh, row_dp0, row_dp1;  // the workspace's rows
    float clip, neg_inv_m, ent_scale, val_scale;
};

// Whether this kernel takes a K1 call: the bf16 mode (no int8 forward, no
// bf16 backward chain), hidden (256, 256), at most FPAD padded features and
// HEADR head rows.
inline bool takes(int L, const int* hidden, int obs_dim_pad, int num_actions, bool q8,
                  bool bwd_bf16) {
    return !q8 && !bwd_bf16 && L == 2 && hidden[0] == HID && hidden[1] == HID &&
           obs_dim_pad <= FPAD && num_actions + 1 <= HEADR;
}

// The byte offset of (r, c) in a tile of 128-byte rows, 128-byte swizzled.
__device__ __forceinline__ int swz(int r, int c) {
    return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// A consumer warpgroup's side of the weight ring.
struct Ring {
    unsigned char* base;
    uint64_t *full, *empty;
    int q_take, q_free;

    __device__ __forceinline__ const unsigned char* take() {
        const int st = q_take % NST;
        mbar_wait(&full[st], (q_take / NST) & 1);
        ++q_take;
        return base + st * STAGE;
    }
    __device__ __forceinline__ void release() {
        if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[q_free % NST]);
        ++q_free;
    }
};

template <int R>
__device__ __forceinline__ void add_rn(float (&acc)[R], const float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

template <int R>
__device__ __forceinline__ void fresh(float (&acc)[R], const float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(0.0f, d[i]);
}

// A product of four 64-row output blocks, software-pipelined: the first
// group of block b+1's wgmma runs while block b's epilogue runs on its
// accumulator (a second group, if any, runs after it: holding the next
// block's sum beside this one's would take 32 more registers, past the 168 a
// thread has).  A block is G groups (1 or 2) of wgmma, each into a fresh
// accumulator (issue(d, b, g) issues and commits group g of block b; done(b,
// g) after it completed), added to the block's running sum with
// round-to-nearest adds.  epi(acc, b) is block b's epilogue.
template <int G, typename Issue, typename Done, typename Epi>
__device__ __forceinline__ void pipelined(Issue&& issue, Done&& done, Epi&& epi) {
    float acc[32], d[32];
    // Block b's groups after the first: issue, wait, add.
    auto rest = [&](int b) {
#pragma unroll
        for (int g = 1; g < G; ++g) {
            issue(d, b, g);
            wgmma_wait<0>();
            fence_regs(d);
            add_rn(acc, d);
            done(b, g);
        }
    };
    issue(d, 0, 0);
    wgmma_wait<0>();
    fence_regs(d);
    fresh(acc, d);
    done(0, 0);
    rest(0);
    // A loop, not unrolled: unrolled, the kernel's code outgrew the
    // instruction cache (PERF.md §6).  The last block's epilogue is peeled:
    // a wgmma under a condition inside the loop would be serialized (C7518).
#pragma unroll 1
    for (int b = 0; b < 3; ++b) {
        issue(d, b + 1, 0);
        epi(acc, b);
        wgmma_wait<0>();
        fence_regs(d);
        fresh(acc, d);
        done(b + 1, 0);
        rest(b + 1);
    }
    epi(acc, 3);
}

// Issue n k16 steps of a 64-row output block into the fresh accumulator d: A
// the weight slice at w (TA 1, MN-major: W^T from W's rows, 2048 bytes a
// step; 0, K-major in 64-column boxes: W from W's rows), B (right) the
// activation tile from step k0, MN-major.
template <int TA>
__device__ __forceinline__ void issue_slice(float (&d)[32], const unsigned char* w,
                                            const unsigned char* right, int k0, int n) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < n; ++k) {
        const unsigned char* a = TA ? w + k * 2048 : w + (k >> 2) * 8192 + (k & 3) * 32;
        wgmma_n64<TA, 1>(d, desc(a, SW128, 1024), desc(right + (k0 + k) * 2048, SW128, 1024),
                         k != 0);
    }
    wgmma_commit();
}

// Group g of a hidden product's block over KT k16 steps: its slice from the
// ring (8 steps a slice, one fresh accumulation), B the activation tile right.
template <int TA, int KT>
struct FromRing {
    Ring& ring;
    const unsigned char* right;

    __device__ __forceinline__ void operator()(float (&d)[32], int, int g) const {
        const unsigned char* w = ring.take();
        issue_slice<TA>(d, w, right, 8 * g, KT - 8 * g < 8 ? KT - 8 * g : 8);
    }
};

// The forward's epilogue: rows m0.. of tile = bf16(act(acc + bias)).
// Accumulator layout (hopper.cuh): d[4j + 2h + e] is row 16w + g + 8h,
// column 8j + 2t + e.
__device__ __forceinline__ void forward_out(const float (&acc)[32], unsigned char* tile, int m0,
                                            const float* bias, int relu) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // rolled, the values selected: half the code
        const int r = m0 + 16 * w + g + 8 * h;
        const float b = bias[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float v0 = __fadd_rn(h ? acc[4 * j + 2] : acc[4 * j], b);
            float v1 = __fadd_rn(h ? acc[4 * j + 3] : acc[4 * j + 1], b);
            v0 = relu ? fmaxf(v0, 0.0f) : tanhf(v0);
            v1 = relu ? fmaxf(v1, 0.0f) : tanhf(v1);
            *reinterpret_cast<__nv_bfloat162*>(tile + swz(r, 8 * j + 2 * t)) =
                __floats2bfloat162_rn(v0, v1);
        }
    }
}

// The backward's epilogue: dpre = dh * act'(h) on rows m0.. of tile, which
// holds bf16(h) and takes bf16(dpre); the f32 row sums of dpre added to
// bgrad[m0 + row] (a row's 64 columns lie in one quad of threads).
__device__ __forceinline__ void backward_out(const float (&acc)[32], unsigned char* tile, int m0,
                                             float* bgrad, int relu) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // rolled, the values selected: half the code
        const int r = m0 + 16 * w + g + 8 * h;
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(tile + swz(r, 8 * j + 2 * t));
            const float2 hf = __bfloat1622float2(*hp);
            const float da0 = relu ? (hf.x > 0.0f ? 1.0f : 0.0f) : __fsub_rn(1.0f, __fmul_rn(hf.x, hf.x));
            const float da1 = relu ? (hf.y > 0.0f ? 1.0f : 0.0f) : __fsub_rn(1.0f, __fmul_rn(hf.y, hf.y));
            const float d0 = __fmul_rn(h ? acc[4 * j + 2] : acc[4 * j], da0);
            const float d1 = __fmul_rn(h ? acc[4 * j + 3] : acc[4 * j + 1], da1);
            rs += d0;
            rs += d1;
            *hp = __floats2bfloat162_rn(d0, d1);
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (t == 0) bgrad[r] += rs;
    }
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The loss and dheads of the tile's columns from z^T (an m64n32 accumulator:
// z[4j + 2h + e] is column 16w + g + 8h, head row 8j + 2t + e) before the
// head's bias.  ppo_column's arithmetic, a quad of threads a column (see the
// note at the top for the two sums taken in another order).  Writes
// bf16(dheads) to the tile dl [head row][column], each warp's f32 row sums of
// dheads over its 16 columns to scr[warp][row], and adds the column's 4 loss
// terms to lsum (the quad's first thread; columns >= nvalid add nothing and
// have dheads 0).
__device__ __forceinline__ void loss_tile(const Params& p, const float (&z)[16], const float* bias,
                                          int t_frame, int col0, int nvalid, unsigned char* dl,
                                          float* scr, float (&lsum)[4]) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int A = p.A;
    const int va = (A >> 3) * 2 + (A & 1), vt = (A & 7) >> 1;  // the value's slot and thread
    float hs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) hs[k] = 0.0f;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // a column at a time: fewer registers live
        const int c = 16 * w + g + 8 * h;
        const bool valid = c < nvalid;
        int act = -1;
        float lpo = 0.0f, adv = 0.0f, vold = 0.0f, tgt = 0.0f;
        if (valid) {
            const size_t gi = (size_t)t_frame * p.N + col0 + c;
            act = p.action[gi];
            lpo = p.logp_old[gi];
            adv = p.adv[gi];
            vold = p.value_old[gi];
            tgt = p.target[gi];
        }
        float zr[8];
        int row[8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                row[2 * j + e] = 8 * j + 2 * t + e;
                zr[2 * j + e] = (h ? z[4 * j + 2 + e] : z[4 * j + e]) + bias[8 * j + 2 * t + e];
            }
        float m = -INFINITY;
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (row[k] < A) m = fmaxf(m, zr[k]);
        m = quad_max(m);
        float ex[8], sumex = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            ex[k] = expf(zr[k] - m);
            if (row[k] < A) sumex += ex[k];
        }
        sumex = quad_sum(sumex);
        const float lse = logf(sumex) + m;
        float mine = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (k == va) mine = zr[k];
        const float value = __shfl_sync(0xffffffffu, mine, (lane & ~3) | vt);
        float pr[8], plogp = 0.0f, lp_new = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const float logp = zr[k] - lse;
            pr[k] = ex[k] / sumex;
            if (row[k] < A) {
                plogp += pr[k] * logp;
                if (row[k] == act) lp_new = logp;
            }
        }
        plogp = quad_sum(plogp);
        lp_new = quad_sum(lp_new);  // one thread's term, zeros elsewhere: exact
        const float entropy_row = -plogp;
        const float ratio = expf(lp_new - lpo);
        const float unclipped = ratio * adv;
        const float clipped = fminf(fmaxf(ratio, 1.0f - p.clip), 1.0f + p.clip) * adv;
        const float vclip = vold + fminf(fmaxf(value - vold, -p.clip), p.clip);
        const float e1 = value - tgt, e2 = vclip - tgt;
        if (valid && t == 0) {
            lsum[0] += -fminf(unclipped, clipped);
            lsum[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
            lsum[2] += entropy_row;
            lsum[3] += (ratio - 1.0f) - logf(ratio);
        }
        const float inside_r = (ratio > 1.0f - p.clip && ratio < 1.0f + p.clip) ? 1.0f : 0.0f;
        const float dmin = (unclipped <= clipped) ? adv : adv * inside_r;
        const float dlp = p.neg_inv_m * dmin * ratio;
        const float inside_v = (value - vold > -p.clip && value - vold < p.clip) ? 1.0f : 0.0f;
        const float dvalue = p.val_scale * ((e1 * e1 >= e2 * e2) ? e1 : e2 * inside_v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float dz = 0.0f;
            if (valid && row[k] < A) {
                const float logp = zr[k] - lse;
                const float onehot = (row[k] == act) ? 1.0f : 0.0f;
                dz = dlp * (onehot - pr[k]) + p.ent_scale * pr[k] * (logp + entropy_row);
            } else if (valid && row[k] == A) {
                dz = dvalue;
            }
            hs[k] += dz;
            *reinterpret_cast<bf16*>(dl + swz(row[k], c)) = __float2bfloat16(dz);
        }
    }
    // The warp's 16 columns: across the quads (g), in a fixed order.
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float s = hs[k];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) scr[w * HEADR + 8 * (k >> 1) + 2 * t + (k & 1)] = s;
    }
}

__global__ void __launch_bounds__(THREADS, 1) wgmma_chain_kernel(const __grid_constant__ Params p) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    unsigned char* sets = ring + NST * STAGE;
    float* bias = reinterpret_cast<float*>(sets + NCG * SET_BYTES);
    float* bgrad = bias + NBIAS;               // [NCG][NBIAS]
    float* scratch = bgrad + NCG * NBIAS;      // [NCG][4 warps][HEADR]
    float* lscr = scratch + NCG * 4 * HEADR;   // [NCG][4 warps][4]
    uint64_t* full = reinterpret_cast<uint64_t*>(lscr + NCG * 4 * 4);
    uint64_t* empty = full + NST;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) {
        for (int s = 0; s < NST; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NCG);
        }
        mbar_fence_init();
    }
    for (int i = tid; i < NBIAS; i += THREADS)
        bias[i] = i < HID ? p.b[0][i] : i < 2 * HID ? p.b[1][i - HID] : p.b[2][i - 2 * HID];
    for (int i = tid; i < NCG * NBIAS; i += THREADS) bgrad[i] = 0.0f;
    __syncthreads();

    const int tpf = p.Npad / TILE, tiles = p.frames * tpf;
    const int units = (tiles + 1) / 2;
    const int first = (int)((long long)units * blockIdx.x / gridDim.x);
    const int last = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);

    if (warp == NCG * 4) {  // the producer warp: one lane issues every copy
        if (lane == 0) {
            int qi = 0;
            auto slot = [&](int bytes) {
                const int st = qi % NST;
                mbar_wait(&empty[st], ((qi / NST) & 1) ^ 1);
                mbar_expect_tx(&full[st], bytes);
                ++qi;
                return st;
            };
            // A unit's 21 slices: W_0 by column block (4), W_1 by column
            // block in 128-row halves (8), Wpv whole (1), W_1 by row block in
            // 128-column halves (8).  Rolled loops: small code.
#pragma unroll 1
            for (int u = first; u < last; ++u)
#pragma unroll 1
                for (int q = 0; q < 21; ++q) {
                    const int st = slot(q < 4 ? X_BYTES : q == 12 ? HID * HEADR * 2 : STAGE);
                    unsigned char* dst = ring + st * STAGE;
                    if (q < 4) {
                        tma_load_2d(dst, &p.w0, 64 * q, 0, &full[st]);
                    } else if (q == 12) {
                        tma_load_2d(dst, &p.wpv, 0, 0, &full[st]);
                    } else {
                        const bool fwd = q < 12;
                        const int i = fwd ? q - 4 : q - 13, b = i >> 1, hh = i & 1;
#pragma unroll 1
                        for (int r = 0; r < 2; ++r) {
                            const int k = 64 * (2 * hh + r);
                            tma_load_2d(dst + r * 8192, &p.w1, fwd ? 64 * b : k, fwd ? k : 64 * b,
                                        &full[st]);
                        }
                    }
                }
        }
        return;
    }

    // A consumer warpgroup: its tile set, bias grads and named barrier.
    const int cg = tid / WG, ct = tid % WG;
    unsigned char* xs = sets + cg * SET_BYTES;
    unsigned char* h0 = xs + X_BYTES;
    unsigned char* h1 = h0 + H_BYTES;
    unsigned char* dl = h1 + H_BYTES;
    float* bg = bgrad + cg * NBIAS;
    float* scr = scratch + cg * 4 * HEADR;
    Ring rg = {ring, full, empty, 0, 0};
    // A barrier of the warpgroup after its threads' writes to its tiles; the
    // tiles' copies to the workspace (TMA stores, issued by its first thread)
    // have read them by then, so they may be overwritten after it.
    auto sync = [&]() {
        fence_proxy_async();
        if (ct == 0) bulk_wait<true>();
        named_barrier(1 + cg, WG);
    };
    // A tile of h_l or dpre_l (HID rows) to the workspace from row row0, at
    // column wc0, in boxes of SBOX rows (16 rows: 0.7 ms slower a call; 64
    // to 256 alike; PERF.md §6).
    auto copy_out = [&](const unsigned char* tile, int row0, int wc0) {
        if (ct == 0) {
#pragma unroll 1
            for (int r = 0; r < HID; r += SBOX) tma_store_2d(&p.ws, tile + r * 128, wc0, row0 + r);
            bulk_commit();
        }
    };
    auto ring_done = [&rg](int, int) { rg.release(); };
    float lsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int u = first; u < last; ++u) {
        const int tile = 2 * u + cg;
        const bool valid = tile < tiles;
        const int fr = valid ? tile / tpf : 0, col = valid ? (tile - fr * tpf) * TILE : 0;
        const int t = p.t0 + fr, nvalid = valid ? min(TILE, p.N - col) : 0;
        const int wc0 = fr * p.Npad + col;
        const bf16* src = p.obs + (size_t)t * p.F * p.N + col;

        // ---- x (FPAD, 64): zero past F and past the frame's columns.
#pragma unroll 1
        for (int i = ct; i < FPAD * 8; i += WG) {
            const int f = i >> 3, q = i & 7;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (f < p.F && q * 8 < nvalid) {
                const bf16* s = src + (size_t)f * p.N + q * 8;
                if ((p.N & 7) == 0 && q * 8 + 8 <= nvalid) {
                    v = *reinterpret_cast<const uint4*>(s);
                } else {
                    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll 1
                    for (int k = 0; k < 8 && q * 8 + k < nvalid; ++k) e[k] = s[k];
                }
            }
            *reinterpret_cast<uint4*>(xs + f * 128 + ((q ^ (f & 7)) << 4)) = v;
        }
        sync();

        // ---- h_0 = bf16(act(W_0^T x + b_0)): W_0's column block b is A.
        pipelined<1>(FromRing<1, FPAD / 16>{rg, xs}, ring_done,
                     [&](const float(&a)[32], int b) { forward_out(a, h0, 64 * b, bias, p.relu); });
        sync();
        if (valid) copy_out(h0, p.row_h0, wc0);

        // ---- h_1 = bf16(act(W_1^T h_0 + b_1)): W_1's column block b is A.
        pipelined<2>(FromRing<1, HID / 16>{rg, h0}, ring_done,
                     [&](const float(&a)[32], int b) {
                         forward_out(a, h1, 64 * b, bias + HID, p.relu);
                     });
        sync();
        if (valid) copy_out(h1, p.row_h1, wc0);

        // ---- z^T = h_1^T Wpv (M = the tile's columns, N = the head's rows),
        // the loss and dheads; then dh_1 = Wpv . bf16(dheads) and dpre_1 into
        // h_1's tile, all from the one Wpv slice.
        const unsigned char* wp = rg.take();
        {
            float z[16];
#pragma unroll
            for (int k0 = 0; k0 < HID / 16; k0 += 8) {
                float d[16];
                wgmma_fence();
#pragma unroll
                for (int k = k0; k < k0 + 8; ++k)
                    wgmma_n32<1, 1>(d, desc(h1 + k * 2048, SW128, 1024),
                                    desc(wp + k * 1024, SW64, 512), k != k0);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(d);
                if (k0 == 0)
                    fresh(z, d);
                else
                    add_rn(z, d);
            }
            loss_tile(p, z, bias + 2 * HID, t, col, nvalid, dl, scr, lsum);
        }
        sync();  // dl complete; h_1's copy-out has read it
        if (ct < HEADR)
            bg[2 * HID + ct] +=
                ((scr[ct] + scr[HEADR + ct]) + scr[2 * HEADR + ct]) + scr[3 * HEADR + ct];
        if (valid && ct == 0) {
            tma_store_2d(&p.ws_d, dl, wc0, p.row_dh);
            bulk_commit();
        }
        pipelined<1>(
            [&](float(&d)[32], int b, int) {
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < HEADR / 16; ++k)
                    wgmma_n64<0, 1>(d, desc(wp + b * 4096 + k * 32, SW64, 512),
                                    desc(dl + k * 2048, SW128, 1024), k != 0);
                wgmma_commit();
            },
            [](int, int) {},
            [&](const float(&a)[32], int b) { backward_out(a, h1, 64 * b, bg + HID, p.relu); });
        rg.release();
        sync();
        if (valid) copy_out(h1, p.row_dp1, wc0);

        // ---- dh_0 = W_1 . bf16(dpre_1) and dpre_0 into h_0's tile: W_1's
        // row block b is A, K-major, in boxes of 64 columns.
        pipelined<2>(FromRing<0, HID / 16>{rg, h1}, ring_done,
                     [&](const float(&a)[32], int b) { backward_out(a, h0, 64 * b, bg, p.relu); });
        sync();
        if (valid) copy_out(h0, p.row_dp0, wc0);
    }
    if (ct == 0) bulk_wait<false>();

    // The loss sums over the warpgroup, then both warpgroups and the bias
    // grads into the block's partial, in a fixed order.
    const int w = ct >> 5;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float s = lsum[i];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane == 0) lscr[(cg * 4 + w) * 4 + i] = s;
    }
    named_barrier(1 + NCG, NCG * WG);
    float* part = p.partial + (size_t)blockIdx.x * (NBIAS + 4);
    for (int i = tid; i < NBIAS + 4; i += NCG * WG) {
        float v;
        if (i < NBIAS) {
            v = bgrad[i] + bgrad[NBIAS + i];
        } else {
            const int k = i - NBIAS;
            v = 0.0f;
            for (int j = 0; j < NCG * 4; ++j) v += lscr[j * 4 + k];
        }
        part[i] = p.first ? v : __fadd_rn(part[i], v);
    }
}

// The host side: Params for a launch (the chunk's t0, frames and first are
// set per launch), false if the driver refuses a tensor map.  w0 (Fp, 256),
// w1 (256, 256), wpv (256, HEADR) bf16 row-major; the workspace (ws_rows,
// ws_cols) bf16 with ws_cols a multiple of 8.
inline bool plan(Params& p, const void* w0, int obs_dim_pad, const void* w1, const void* wpv,
                 void* ws, int ws_rows, long long ws_cols) {
    if (ws_cols > INT32_MAX) return false;
    return map_2d(&p.w0, w0, obs_dim_pad, HID, HID, FPAD, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
           map_2d(&p.w1, w1, HID, HID, HID, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
           map_2d(&p.wpv, wpv, HID, HEADR, HEADR, HID, HEADR, CU_TENSOR_MAP_SWIZZLE_64B) &&
           map_2d(&p.ws, ws, ws_rows, ws_cols, ws_cols, SBOX, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
           map_2d(&p.ws_d, ws, ws_rows, ws_cols, ws_cols, HEADR, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace k1w
