// K1's bf16 mode (quant="none", bwd_bf16=False) for Hopper, as two kernels.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:504
// `fused_ppo_grads_fm` (kernel body `_fm_kernel`, :244; pallas_call :618) in
// its default mode; the other modes stay in fused_update.cu.  Python side:
// pikazoo_tpu_torch/train/fused_update.py (`fused_ppo_grads_fm`, and the
// stage entries `k1_chain` / `k1_dw`), which also holds the plain versions
// the kernels are held against: `k1_chain_plain` (kernel A) and `k1_dw_plain`
// (kernel B).  The rounding points are the function's: bf16 operands in
// every product, f32 sums; bias add and activation in f32, one round to
// bf16; dpre and dheads rounded to bf16 for the products while the bias
// grads sum their f32 values.
//
// What bounds it.  ~1.9 TFLOP a full-width call (T=32, N=131072, hidden
// (256, 256)): 1.94 ms at the tensor cores' bf16 peak.  The one-kernel design
// (fused_update.cu) ran at ~4% of that: each block read-modified-wrote a
// partial of every dW (86,016 floats) for every 64-column tile, ~45 GB of L2
// traffic a call, and every warp loaded its weight fragments from L2 itself.
//
// What this design does about it: the dW products leave the tile loop.
// - Kernel A (chain_kernel) walks 64-column tiles: the forward, the loss and
//   dheads (ppo_column), and the backward chain down to dpre_0, with the bias
//   grads and loss sums held per block in shared memory and written once.  It
//   writes the dW products' operands, bf16(h_l), bf16(dheads) and
//   bf16(dpre_l), to a workspace in device memory, and does no dW product.
//   Every product runs on mma.sync m16n8k16 (bf16 -> f32) with ldmatrix
//   fragments; the accumulators stay in registers, so the bias add, the
//   activation, the rounding to bf16 and the dpre step run on registers (no
//   f32 scratch tile; only the head's 32 x 64 block goes to shared memory for
//   the loss).  The weights stream through shared memory in K slices (64
//   deep where three stages fit, else 32), a ring filled with 16-byte
//   cp.async copies by a producer warpgroup and read by 16 compute warps;
//   the ring runs across products and tiles.  Issuing the copies stalls the
//   issuing threads (the stream is ~319 KB of weights a tile at hidden (256,
//   256), W1 and the head twice): with every warp issuing its share, the
//   compute warps spent about as long issuing copies as running mmas; one
//   producer warp could not keep up, four can (measured on an H100).
// - Kernel B (dw_kernel, in k1_split.cuh beside the PTX helpers, shared with
//   the int8 mode) computes each dW as one long-K product over the
//   chunk's columns: dW_l = below_l . bf16(dpre_l)^T (below_0 = x, read again
//   from obs), dWpv = bf16(h_top) . bf16(dheads)^T.  The grid is (column
//   range, 128 x 128 output tile) by blockIdx, tile-minor so that the blocks
//   of one column range run together and share its operands in L2; a block
//   keeps its tile in registers across its whole column range (8 warps of 32
//   x 64), streams 64-column operand slices through a 3-stage cp.async ring,
//   and writes its partial once a chunk.
// - The tensor cores' f32 accumulation does not round to nearest and drifts
//   toward zero over a long sum (PERF.md §6).  Every mma here sums 16
//   products into a fresh fragment, which the running sum takes with
//   __fadd_rn (ppo_grads.cuh's KCHUNK rule).
// - Determinism: per-block partials (A: bias grads and loss sums; B: dW
//   tiles), each added to in a fixed order across chunks and summed over
//   blocks in block order by reduce_partials.  No float atomics.
//
// Chunks.  The whole minibatch's workspace would be 2,112 bytes a column at
// hidden (256, 256) (8.9 GB at full width), so the wrapper runs A and B
// alternately over chunks of whole frames, ~131072 columns a chunk (one
// frame at the learner's width: 277 MB, 64 launches a call).  A frame's
// columns are padded to a multiple of 64 in the workspace; columns >= N
// hold dheads = dpre = 0 (and x = 0), so they add nothing to any dW.
//
// Resources (nvcc -Xptxas -v, sm_90a).  Kernel A: 640 threads, 96
// registers, no spills, a 128-byte stack (ppo_column's per-column array);
// shared memory at hidden (256, 256), F=35: x 6,912 B, h_0 and h_1 36,864
// each, dheads 4,608, the head's f32 block 9,216, loss 1,040, bias and bias
// grads 2 x 2,176, row-sum scratch 1,024, weight ring 3 x 36,864 (64-deep
// slices): 211,472 (one block an SM); at 4 layers of 256 the ring falls back
// to 2 stages of 32-deep slices.  Kernel B: 256 threads, 111 registers, no
// spills, 110,592 B of shared memory (two blocks an SM).
//
// Where the time goes (H100, full width, tools/k1_split_probe.py): kernel A
// ~70% of a call, kernel B ~30%.  In A, a third is neither the weight
// stream nor the mmas: tanh ~2 ms, the loss on two warps ~2.5 ms, the x
// load, copy-outs and barriers; the mmas and the stream the rest.  Not done
// here (later work): wgmma and TMA, kernel B's operands kept in L2 (a chunk
// small enough to stay there), the loss over more threads.

#include "k1_split.cuh"

#define COLS 64          // columns per tile of kernel A
#define LDH (COLS + 8)   // row stride of A's bf16 tiles (elements)
#define LDZ (COLS + 8)   // row stride of the head's f32 block
#define A_WARPS 16       // warps that compute
#define A_PRODUCERS 128  // threads (a warpgroup) that stream the weights
#define A_THREADS (32 * A_WARPS + A_PRODUCERS)
#define HEAD_PAD 32
#define MAX_PRODUCTS (2 * MAX_LAYERS + 2)
#define SMEM_LIMIT 232448

// ----------------------------------------------------------- kernel A --
// One product of the chain: out (M x COLS) = Wop (M x K) . act (K x COLS).
// fwd: W is (K, M) row-major and Wop = W^T (the forward products); else W is
// (M, K) row-major (the dh products).
struct Prod {
    const bf16* w;
    int ldw, M, K, fwd;
    int slice0, slices;  // first slice in the tile's stream, and the count
};

struct ParamsA {
    const bf16* obs;
    const int* action;
    const float *logp_old, *value_old, *adv, *target;
    const float* b[MAX_LAYERS + 1];
    Prod prod[MAX_PRODUCTS];
    int slices_per_tile, stage_elems;
    int hidden[MAX_LAYERS];
    int L, F, Fp, A, relu, N, Npad, t0, frames;
    float clip, neg_inv_m, ent_scale, val_scale;
    bf16* ws;                  // (rows, ws_cols) bf16
    long long ws_cols;
    long long off_h[MAX_LAYERS], off_dh, off_dp[MAX_LAYERS];  // elements
    float* partial;            // (blocks, stride): bias grads, then 4 loss sums
    int stride, first, bias_total;
    int sm_x, sm_h[MAX_LAYERS], sm_dh, sm_z, sm_loss, sm_bias, sm_bgrad, sm_rsum, sm_ring;
};

// A warp's share of an (M x COLS) output: one 16-row tile, nb 8-column
// blocks from column n0.  Up to four warps split a tile's columns when M is
// small, so that more warps work.
struct WarpTile {
    int m0, n0, nb, ng, nwg;
    bool active;
};

__device__ __forceinline__ WarpTile warp_tile(int M) {
    const int warp = threadIdx.x >> 5, mt = M >> 4;
    int nwg = 1;
    while (nwg < 4 && mt * nwg * 2 <= A_WARPS) nwg *= 2;
    WarpTile w;
    w.nwg = nwg;
    w.nb = 8 / nwg;
    w.ng = warp % nwg;
    w.m0 = (warp / nwg) * 16;
    w.n0 = w.ng * w.nb * 8;
    w.active = warp / nwg < mt;
    return w;
}

// Weight slices are KS contraction rows deep: 64 where shared memory allows
// three stages of them, else 32.  A dh product's slice is stored [m][KS + 8].
template <int NST, int KS>
__device__ __forceinline__ void load_slice(const ParamsA& p, bf16* ring, int q) {
    const int s = q % p.slices_per_tile;
    int i = 0;
    while (s >= p.prod[i].slice0 + p.prod[i].slices) ++i;
    const Prod& pr = p.prod[i];
    const int k0 = (s - pr.slice0) * KS, d = min(KS, pr.K - k0);
    bf16* dst = ring + (q % NST) * p.stage_elems;
    // fwd: rows k0..k0+d of W (K, M), stored [k][M + 8]; dh: columns
    // k0..k0+d of W (M, K), stored [m][KS + 8].  Rows of per_row 16-byte
    // pieces, which the producer threads walk without a division a piece.
    const int rows = pr.fwd ? d : pr.M, per_row = pr.fwd ? pr.M >> 3 : d >> 3;
    const int ld = pr.fwd ? pr.M + 8 : KS + 8;
    const bf16* src = pr.fwd ? pr.w + (size_t)k0 * pr.ldw : pr.w + k0;
    const int pt = threadIdx.x - 32 * A_WARPS, dr = A_PRODUCERS / per_row;
    const int dx = A_PRODUCERS - dr * per_row;
    int r = pt / per_row, x = pt - r * per_row;
    while (r < rows) {
        cp_async16(dst + r * ld + x * 8, src + (size_t)r * pr.ldw + x * 8);
        r += dr;
        x += dx;
        if (x >= per_row) {
            x -= per_row;
            ++r;
        }
    }
}

// The warp's mmas over one weight slice of depth d: act is the product's
// right operand (K x COLS, row stride LDH) in shared memory, rows k.
template <bool FWD>
__device__ __forceinline__ void mma_slice(float (&acc)[8][4], const WarpTile& wt, const bf16* w,
                                          int ldw, const bf16* act, int k0, int d) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
    for (int kk = 0; kk < d; kk += 16) {
        uint32_t a[4];
        if (FWD)   // W^T from [k][m]: matrices (k +0/+8) x (m +0/+8), transposed
            ldsm_x4_t(a, w + (kk + r + (mi >> 1) * 8) * ldw + wt.m0 + (mi & 1) * 8);
        else       // W from [m][k]
            ldsm_x4(a, w + (wt.m0 + (lane & 15)) * ldw + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
            if (j < wt.nb) {
                uint32_t b[4];  // (k +0, n j), (k +8, n j), (k +0, n j+1), (k +8, n j+1)
                ldsm_x4_t(b, act + (k0 + kk + r + (mi & 1) * 8) * LDH + wt.n0 +
                                 (j + (mi >> 1)) * 8);
                mma_add(acc[j], a, b[0], b[1]);
                mma_add(acc[j + 1], a, b[2], b[3]);
            }
        }
    }
}

// Stream the product's weight slices through the ring and run the warp's
// mmas; q is the block's running slice count.
template <int NST, int KS>
__device__ __forceinline__ void product(const ParamsA& p, const Prod& pr, bf16* ring, int& q,
                                        int q_end, const bf16* act, float (&acc)[8][4],
                                        const WarpTile& wt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    // Only the producers issue copies, so the compute warps never wait on
    // the copies' issue; the producers' own wait then the barrier publish a
    // slice to every warp.
    const bool producer = threadIdx.x >= 32 * A_WARPS;
    for (int s = 0; s < pr.slices; ++s, ++q) {
        if (producer) cp_wait<NST - 2>();  // slice q landed
        __syncthreads();  // and every warp is done with slice q-1's stage
        if (producer) {
            if (q + NST - 1 < q_end) load_slice<NST, KS>(p, ring, q + NST - 1);
            cp_commit();
        }
        if (wt.active) {
            const bf16* w = ring + (q % NST) * p.stage_elems;
            const int k0 = s * KS, d = min(KS, pr.K - k0);
            if (pr.fwd)
                mma_slice<true>(acc, wt, w, pr.M + 8, act, k0, d);
            else
                mma_slice<false>(acc, wt, w, KS + 8, act, k0, d);
        }
    }
}

// rows x COLS bf16 from shared memory (row stride LDH) to the workspace,
// 16 bytes a thread; threads t0, t0 + nt, ...
__device__ __forceinline__ void copy_out(const bf16* src, int rows, bf16* dst, long long ld,
                                         int t0, int nt) {
    for (int i = t0; i < rows * (COLS / 8); i += nt) {
        const int r = i >> 3, x = i & 7;
        *reinterpret_cast<uint4*>(dst + r * ld + x * 8) =
            *reinterpret_cast<const uint4*>(src + r * LDH + x * 8);
    }
}

template <int NST, int KS>
__global__ void __launch_bounds__(A_THREADS, 1) chain_kernel(const __grid_constant__ ParamsA p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = (bf16*)(smem + p.sm_x);
    bf16* dhb = (bf16*)(smem + p.sm_dh);
    float* z = (float*)(smem + p.sm_z);
    float* bias = (float*)(smem + p.sm_bias);
    float* bgrad = (float*)(smem + p.sm_bgrad);
    float* rsum = (float*)(smem + p.sm_rsum);
    float* closs = (float*)(smem + p.sm_loss);  // [4][COLS], then 4 totals
    float* lacc = closs + 4 * COLS;
    bf16* ring = (bf16*)(smem + p.sm_ring);
    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tg = lane & 3;
    const int L = p.L, A = p.A;

    {
        int pos = 0;
        for (int l = 0; l <= L; ++l) {
            const int n = l < L ? p.hidden[l] : HEAD_PAD;
            for (int i = tid; i < n; i += A_THREADS) bias[pos + i] = p.b[l][i];
            pos += n;
        }
        for (int i = tid; i < p.bias_total; i += A_THREADS) bgrad[i] = 0.0f;
        if (tid < 4) lacc[tid] = 0.0f;
    }

    const int tpf = p.Npad / COLS;
    const int tiles = p.frames * tpf;
    const int first = (int)((long long)tiles * blockIdx.x / gridDim.x);
    const int last = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
    const int q_end = (last - first) * p.slices_per_tile;
    if (tid >= 32 * A_WARPS) {
#pragma unroll
        for (int i = 0; i < NST - 1; ++i) {
            if (i < q_end) load_slice<NST, KS>(p, ring, i);
            cp_commit();
        }
    }
    int q = 0;
    float acc[8][4];
    const bf16 zero = __float2bfloat16(0.0f);

    for (int tile = first; tile < last; ++tile) {
        const int tr = tile / tpf, c0 = (tile - tr * tpf) * COLS;
        const int t = p.t0 + tr;
        const int nvalid = min(COLS, p.N - c0);
        const long long wc0 = (long long)tr * p.Npad + c0;

        // ---- observations (Fp, COLS): zero rows >= F and columns >= nvalid;
        // 16 bytes a thread where the rows are 16-byte aligned (N % 8 == 0).
        if ((p.N & 7) == 0) {
            for (int i = tid; i < p.Fp * (COLS / 8); i += A_THREADS) {
                const int f = i >> 3, c = (i & 7) * 8;
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (f < p.F && c < nvalid)
                    v = *reinterpret_cast<const uint4*>(p.obs + ((size_t)t * p.F + f) * p.N + c0 + c);
                *reinterpret_cast<uint4*>(xs + f * LDH + c) = v;
            }
        } else {
            for (int i = tid; i < p.Fp * COLS; i += A_THREADS) {
                const int f = i / COLS, c = i % COLS;
                xs[f * LDH + c] = (f < p.F && c < nvalid)
                                      ? p.obs[((size_t)t * p.F + f) * p.N + c0 + c] : zero;
            }
        }
        __syncthreads();

        // ---- forward: h_l = bf16(act(W_l^T h_{l-1} + b_l)), on registers.
        int boff = 0;
        const bf16* below = xs;
        for (int l = 0; l < L; ++l) {
            const Prod& pr = p.prod[l];
            const WarpTile wt = warp_tile(pr.M);
            product<NST, KS>(p, pr, ring, q, q_end, below, acc, wt);
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            if (wt.active) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= wt.nb) continue;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                        float v0 = __fadd_rn(acc[j][2 * hh], bias[boff + r]);
                        float v1 = __fadd_rn(acc[j][2 * hh + 1], bias[boff + r]);
                        v0 = p.relu ? fmaxf(v0, 0.0f) : tanhf(v0);
                        v1 = p.relu ? fmaxf(v1, 0.0f) : tanhf(v1);
                        *reinterpret_cast<__nv_bfloat162*>(h + r * LDH + c) =
                            __floats2bfloat162_rn(v0, v1);
                    }
                }
            }
            boff += pr.M;
            below = h;
        }
        // ---- the merged head, before its bias, to the f32 block z.
        {
            const Prod& pr = p.prod[L];
            const WarpTile wt = warp_tile(HEAD_PAD);
            product<NST, KS>(p, pr, ring, q, q_end, below, acc, wt);
            if (wt.active) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= wt.nb) continue;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                        *reinterpret_cast<float2*>(z + r * LDZ + c) =
                            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
                    }
                }
            }
        }
        __syncthreads();

        // ---- loss and dheads, one thread a column; the other threads copy
        // the bf16 activations to the workspace meanwhile.
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
        } else {
            for (int l = 0; l < L; ++l)
                copy_out((const bf16*)(smem + p.sm_h[l]), p.hidden[l],
                         p.ws + p.off_h[l] + wc0, p.ws_cols, tid - COLS, A_THREADS - COLS);
        }
        __syncthreads();
        row_sums<COLS>(z, LDZ, HEAD_PAD, bgrad + boff);
        row_sums<COLS>(closs, COLS, 4, lacc);

        // ---- backward: dh_l = W_{l+1} . bf16(dpre_{l+1}) (the head: Wpv .
        // bf16(dheads)), then dpre_l = dh_l * act'(float(h_l)) on registers:
        // its f32 row sums are the bias grads, bf16(dpre_l) replaces h_l.
        for (int i = L + 1, l = L - 1; l >= 0; ++i, --l) {
            const Prod& pr = p.prod[i];
            const bf16* right = i == L + 1 ? dhb : (const bf16*)(smem + p.sm_h[l + 1]);
            const WarpTile wt = warp_tile(pr.M);
            product<NST, KS>(p, pr, ring, q, q_end, right, acc, wt);
            boff -= pr.M;
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            if (wt.active) {
                float rs[2] = {0.0f, 0.0f};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= wt.nb) continue;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                        __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(h + r * LDH + c);
                        const float2 hf = __bfloat1622float2(*hp);
                        const float da0 = p.relu ? (hf.x > 0.0f ? 1.0f : 0.0f)
                                                 : __fsub_rn(1.0f, __fmul_rn(hf.x, hf.x));
                        const float da1 = p.relu ? (hf.y > 0.0f ? 1.0f : 0.0f)
                                                 : __fsub_rn(1.0f, __fmul_rn(hf.y, hf.y));
                        const float d0 = __fmul_rn(acc[j][2 * hh], da0);
                        const float d1 = __fmul_rn(acc[j][2 * hh + 1], da1);
                        rs[hh] += d0;
                        rs[hh] += d1;
                        *hp = __floats2bfloat162_rn(d0, d1);
                    }
                }
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
                    rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
                }
                if (tg == 0) {
                    rsum[wt.ng * pr.M + wt.m0 + g] = rs[0];
                    rsum[wt.ng * pr.M + wt.m0 + g + 8] = rs[1];
                }
            }
            __syncthreads();
            if (tid < pr.M) {
                float s = bgrad[boff + tid];
                for (int k = 0; k < wt.nwg; ++k) s += rsum[k * pr.M + tid];
                bgrad[boff + tid] = s;
            }
        }

        // ---- dheads and dpre_l to the workspace.
        copy_out(dhb, HEAD_PAD, p.ws + p.off_dh + wc0, p.ws_cols, tid, A_THREADS);
        for (int l = 0; l < L; ++l)
            copy_out((const bf16*)(smem + p.sm_h[l]), p.hidden[l], p.ws + p.off_dp[l] + wc0,
                     p.ws_cols, tid, A_THREADS);
    }
    if (tid >= 32 * A_WARPS) cp_wait<0>();
    __syncthreads();
    float* part = p.partial + (size_t)blockIdx.x * p.stride;
    for (int i = tid; i < p.bias_total; i += A_THREADS)
        part[i] = p.first ? bgrad[i] : __fadd_rn(part[i], bgrad[i]);
    if (tid < 4)
        part[p.bias_total + tid] =
            p.first ? lacc[tid] : __fadd_rn(part[p.bias_total + tid], lacc[tid]);
}

// ------------------------------------------------------------- launch --
// stages: 1 kernel A only (the workspace and the bias grads / loss sums),
// 2 kernel B only (the dW from a workspace kernel A filled), 3 both.  The
// workspace ws (ws_rows, ws_cols) bf16 holds, for one chunk of frames, the
// rows of bf16(h_0..h_{L-1}), bf16(dheads) (32 rows), bf16(dpre_0..dpre_{L-1}),
// each frame's columns padded to Npad = 64 * ceil(N / 64); ws_cols >=
// chunk_frames * Npad.  out: every dW (n_w floats, fused_update.cu's order),
// then the bias grads and the 4 loss sums.
extern "C" int k1_bf16_launch(
    const void* obs, const void* action, const void* logp_old, const void* value_old,
    const void* adv, const void* target, const void* const* weights,
    const void* const* biases, const int* hidden, int num_layers, int obs_dim,
    int obs_dim_pad, int num_actions, int relu, int frames, int cols, float clip_eps,
    float neg_inv_m, float ent_scale, float val_scale, void* ws, int ws_rows,
    long long ws_cols, int chunk_frames, void* partial_a, int blocks_a, void* partial_b,
    int ranges, void* out, void* stream, int stages) {
    const int L = num_layers;
    if (L < 1 || L > MAX_LAYERS || num_actions + 1 > HEAD_PAD || obs_dim > obs_dim_pad ||
        obs_dim_pad % 16 || frames < 1 || cols < 1 || chunk_frames < 1 || stages < 1 ||
        stages > 3 || ranges < 1 || blocks_a < 1)
        return (int)cudaErrorInvalidValue;
    const int Npad = (cols + COLS - 1) / COLS * COLS;
    if (ws_cols < (long long)chunk_frames * Npad || ws_cols % 8) return (int)cudaErrorInvalidValue;
    int H[MAX_LAYERS], sumH = 0;
    for (int l = 0; l < L; ++l) {
        H[l] = hidden[l];
        if (H[l] <= 0 || H[l] % 16 || H[l] > 256) return (int)cudaErrorInvalidValue;
        sumH += H[l];
    }
    if (ws_rows != 2 * sumH + HEAD_PAD) return (int)cudaErrorInvalidValue;
    const int h_top = H[L - 1];
    int off_w[MAX_LAYERS + 1], n_w = 0;
    for (int l = 0; l <= L; ++l) {
        off_w[l] = n_w;
        n_w += (l == 0 ? obs_dim_pad : H[l - 1]) * (l < L ? H[l] : HEAD_PAD);
    }
    const int bias_total = sumH + HEAD_PAD;
    bf16* wsb = (bf16*)ws;
    long long row_h[MAX_LAYERS], row_dp[MAX_LAYERS], row = 0;
    for (int l = 0; l < L; ++l) { row_h[l] = row; row += H[l]; }
    const long long row_dh = row;
    row += HEAD_PAD;
    for (int l = 0; l < L; ++l) { row_dp[l] = row; row += H[l]; }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;

    ParamsA pa = {};
    typedef void (*KernelA)(const ParamsA);
    KernelA kernel_a = nullptr;
    int sm_a = 0;
    if (stages & 1) {
        pa.obs = (const bf16*)obs;
        pa.action = (const int*)action;
        pa.logp_old = (const float*)logp_old;
        pa.value_old = (const float*)value_old;
        pa.adv = (const float*)adv;
        pa.target = (const float*)target;
        pa.L = L;
        pa.F = obs_dim;
        pa.Fp = obs_dim_pad;
        pa.A = num_actions;
        pa.relu = relu;
        pa.N = cols;
        pa.Npad = Npad;
        pa.clip = clip_eps;
        pa.neg_inv_m = neg_inv_m;
        pa.ent_scale = ent_scale;
        pa.val_scale = val_scale;
        pa.ws = wsb;
        pa.ws_cols = ws_cols;
        pa.partial = (float*)partial_a;
        pa.stride = bias_total + 4;
        pa.bias_total = bias_total;
        for (int l = 0; l < L; ++l) {
            pa.hidden[l] = H[l];
            pa.off_h[l] = row_h[l] * ws_cols;
            pa.off_dp[l] = row_dp[l] * ws_cols;
        }
        pa.off_dh = row_dh * ws_cols;
        for (int l = 0; l <= L; ++l) pa.b[l] = (const float*)biases[l];
        // The tile's products in stream order: the forward (hidden, head),
        // the head's dh, the hidden dh products down to dh_0.
        int np = 0;
        auto add = [&](const void* w, int ldw, int M, int K, int fwd) {
            Prod& pr = pa.prod[np++];
            pr.w = (const bf16*)w;
            pr.ldw = ldw;
            pr.M = M;
            pr.K = K;
            pr.fwd = fwd;
        };
        for (int l = 0; l < L; ++l) add(weights[l], H[l], H[l], l ? H[l - 1] : obs_dim_pad, 1);
        add(weights[L], HEAD_PAD, HEAD_PAD, h_top, 1);
        add(weights[L], HEAD_PAD, h_top, HEAD_PAD, 0);
        for (int l = L - 1; l >= 1; --l) add(weights[l], H[l], H[l - 1], H[l], 0);
        int sm = 0;
        pa.sm_x = sm;
        sm = align128(sm + obs_dim_pad * LDH * 2);
        for (int l = 0; l < L; ++l) {
            pa.sm_h[l] = sm;
            sm = align128(sm + H[l] * LDH * 2);
        }
        pa.sm_dh = sm;
        sm = align128(sm + HEAD_PAD * LDH * 2);
        pa.sm_z = sm;
        sm = align128(sm + HEAD_PAD * LDZ * 4);
        pa.sm_loss = sm;
        sm = align128(sm + (4 * COLS + 4) * 4);
        pa.sm_bias = sm;
        sm = align128(sm + bias_total * 4);
        pa.sm_bgrad = sm;
        sm = align128(sm + bias_total * 4);
        pa.sm_rsum = sm;
        sm = align128(sm + 256 * 4);
        pa.sm_ring = sm;
        // The deepest slices that fit three stages, else two stages of 32.
        const struct { int nst, ks; KernelA kernel; } plans[] = {
            {3, 64, chain_kernel<3, 64>}, {3, 32, chain_kernel<3, 32>}, {2, 32, chain_kernel<2, 32>}};
        for (const auto& plan : plans) {
            int stage_elems = 0;
            for (int i = 0; i < np; ++i) {
                const Prod& pr = pa.prod[i];
                stage_elems = max(stage_elems, pr.fwd ? plan.ks * (pr.M + 8) : pr.M * (plan.ks + 8));
            }
            const int stage_bytes = align128(stage_elems * 2);
            if (sm + plan.nst * stage_bytes > SMEM_LIMIT) continue;
            int slice = 0;
            for (int i = 0; i < np; ++i) {
                Prod& pr = pa.prod[i];
                pr.slice0 = slice;
                pr.slices = (pr.K + plan.ks - 1) / plan.ks;
                slice += pr.slices;
            }
            pa.slices_per_tile = slice;
            pa.stage_elems = stage_bytes / 2;
            kernel_a = plan.kernel;
            sm_a = sm + plan.nst * stage_bytes;
            break;
        }
        if (!kernel_a) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_a);
        if (err != cudaSuccess) return (int)err;
    }

    ParamsB pb = {};
    const int sm_b = B_STAGES * 2 * BT * LDB * 2;
    if (stages & 2) {
        pb.obs = (const bf16*)obs;
        pb.F = obs_dim;
        pb.N = cols;
        pb.Npad = Npad;
        pb.ws_cols = ws_cols;
        pb.partial = (float*)partial_b;
        pb.stride = n_w;
        pb.ranges = ranges;
        int nt = 0;
        for (int l = 0; l <= L; ++l) {
            ProdB& pr = pb.prod[l];
            const bool head = l == L;
            pr.from_obs = l == 0;
            pr.a = l == 0 ? nullptr : wsb + row_h[l - 1] * ws_cols;
            pr.a_rows = l == 0 ? obs_dim : H[l - 1];
            pr.M = l == 0 ? obs_dim_pad : H[l - 1];
            pr.b = wsb + (head ? row_dh : row_dp[l]) * ws_cols;
            pr.N = head ? HEAD_PAD : H[l];
            pr.off = off_w[l];
            for (int m0 = 0; m0 < pr.M; m0 += BT)
                for (int n0 = 0; n0 < pr.N; n0 += BT) {
                    if (nt == MAX_TILES) return (int)cudaErrorInvalidValue;
                    pb.tile[nt++] = {l, m0, n0};
                }
        }
        pb.ntiles = nt;
        err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_b);
        if (err != cudaSuccess) return (int)err;
    }

    for (int t0 = 0; t0 < frames; t0 += chunk_frames) {
        const int n_frames = min(chunk_frames, frames - t0);
        if (stages & 1) {
            pa.t0 = t0;
            pa.frames = n_frames;
            pa.first = t0 == 0;
            kernel_a<<<blocks_a, A_THREADS, sm_a, s>>>(pa);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        if (stages & 2) {
            pb.t0 = t0;
            pb.cols = n_frames * Npad;
            pb.first = t0 == 0;
            dw_kernel<<<pb.ntiles * ranges, B_THREADS, sm_b, s>>>(pb);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    if (stages & 2)
        reduce_partials<<<(n_w + 255) / 256, 256, 0, s>>>((const float*)partial_b, ranges, n_w,
                                                          (float*)out);
    if (stages & 1)
        reduce_partials<<<(bias_total + 4 + 255) / 256, 256, 0, s>>>(
            (const float*)partial_a, blocks_a, bias_total + 4, (float*)out + n_w);
    return (int)cudaGetLastError();
}
