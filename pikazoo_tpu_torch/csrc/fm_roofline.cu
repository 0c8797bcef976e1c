// K1's product sequence with no loss (P2), for Hopper (sm_90a): the
// products-only floor of the feature-major PPO gradient in the split design,
// on wgmma and TMA.
//
// Replaces the TPU kernel tools/fm_roofline.py:95 `mm_grads` (kernel body
// `_mm_kernel`, :42; pallas_call :109).  Python side:
// pikazoo_tpu_torch/tools/fm_roofline.py (`mm_grads`, and the stage entries
// `mm_chain` / `mm_dw`), which also holds the plain versions the kernels are
// held against: `mm_chain_plain` (kernel A) and `mm_dw_plain` (kernel B).
//
// What it computes, for obs (T, F, N) bf16 feature-major and bf16 weights W1
// (F, H1), W2 (H1, H2), Wp (H2, A), summed over all T*N columns, with no
// bias, no activation and no loss (the upstream gradient is the logits
// themselves, rounded):
//   h1 = bf16(W1^T x), h2 = bf16(W2^T h1), dl = bf16(Wp^T h2);
//   dWp += h2 dl^T, dh2 = bf16(Wp dl), dW2 += h1 dh2^T,
//   dh1 = bf16(W2 dh2), dW1 += x dh1^T.
// Eight products, bf16 operands, f32 sums; dW1, dW2, dWp f32.  The kernels
// run at hidden (256, 256) (P2_H; the wrapper zero-pads narrower layers,
// which then add nothing) and up to 48 features (P2_FP, the tool's 35
// padded), so that every loop around a wgmma has a constant count.
//
// What bounds it: the tensor cores.  At F=35, H=256, A=18 the products are
// ~457 kFLOP a column, ~1.9 TFLOP a full-width call (T=32, N=131072),
// against 70 bytes of input a column: ~1.94 ms at 989 TFLOP/s.  The split
// design adds a floor of its own: the workspace (2,208 bytes a column) is
// written once and read once, 5.6 ms a call at HBM's rate.
//
// What this design does about it: K1's split (a per-tile chain kernel and a
// long-K dW kernel) on Hopper's own instructions.
// - Kernel A (mm_chain_kernel) walks 64-column tiles.  Each consumer
//   warpgroup holds its tile's x, h1, h2 and dl in shared memory as 128-byte
//   swizzled [feature][column] tiles, and runs the five per-tile products as
//   wgmma m64nNk16 (bf16 in, f32 accumulators in registers), an output
//   block of 64 rows at a time: the activation tile is B (MN-major), the
//   weights A.  A producer warp streams the weights by TMA through a ring of
//   16 KB stages, each completing on an mbarrier: W1 by output block, W2 by
//   column block in 128-row halves for the forward (A MN-major: W2^T read
//   from W2's rows), Wp whole (64-byte swizzled: B of the dl product, taken
//   as dl^T = h2^T Wp with M the tile's columns, and A of the dh2 product),
//   W2 by row block in 128-column halves for dh1 (A K-major): the transpose
//   flags serve W2 and W2^T from the one tensor map.  A block's wgmma on one
//   slice run while the next slice is awaited.  Each block's accumulators
//   are rounded to bf16 into shared memory for the next product, and TMA
//   stores copy the tile's x, h1, h2, dl, dh2, dh1 to the workspace (2,208
//   bytes a column), which kernel B reads.
// - The two variants.  chain (NC = 1): one consumer warpgroup, its tile's
//   chain in order, the tensor cores idle while it rounds.  phased (NC = 2):
//   Hopper's ping-pong, two consumer warpgroups, each on its own tile (two
//   independent chains, as the TPU tool's phased order interleaves frames),
//   sharing the weight ring, so that one rounds while the other's wgmma run;
//   each weight slice then serves 128 columns.  The values do not depend on
//   the variant.
// - Kernel B (mm_dw_kernel) computes dW2 = h1 dh2^T, dW1^T = dh1 x^T and dWp
//   = h2 dl^T as long-K products over the chunk's columns: both operands
//   K-major workspace rows, loaded by TMA in 64-column slices with 128-byte
//   swizzle into a 4-stage ring; each block an output tile of 128 rows (two
//   consumer warpgroups of 64) by 128, 64 or 32 columns over a column range,
//   its partial written once a chunk and summed over ranges in order by
//   reduce_partials (deterministic, no atomics).
// - Rounding.  The tensor cores' f32 sums do not round to nearest (PERF.md
//   §6).  Kernel A sums each product's whole K (at most 256) on the tensor
//   cores: its outputs are rounded to bf16 at once.  Kernel B sums rlen
//   slices of 64 columns into a fresh accumulator and adds it to the running
//   sum with round-to-nearest adds (rlen 0: the whole range at once); the
//   wrapper's length (1: 64 columns) puts the call nearest float64 at ~0.1
//   ms of kernel B, yet 3.0x as far as the plain version on an H100, since
//   kernel A's sums round toward zero too (PERF.md §6's table).
// - ptxas must not serialize the wgmma, as it does when a loop around them
//   has a count known only at run time (its performance warnings C7514 /
//   C7520): chip_smoke.py phase 2 fails if ptxas reports it.
//
// Chunks.  The wrapper runs A then B over chunks of columns (one frame, or
// part of one, or several small frames), each frame's part padded to a
// multiple of 64 in the workspace; columns past N hold zeros (x = 0 there,
// and no product adds anything to a zero column).
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.9): kernel A 157 registers
// (chain) and 161 (phased), a 16-byte stack, no spills; shared memory
// 208,000 B in the chain variant (an 8-stage ring of 16 KB and one tile set of 75,776 B),
// 218,176 B phased (4 stages, two sets); kernel B 149 registers, no spills,
// 132,160 B (four 32 KB stages).  Kernel A runs one block an SM.

#include <string.h>

#include "hopper.cuh"
#include "ppo_grads.cuh"

using namespace ppo;
using namespace hopper;

#define P2_COLS 64        // columns a tile of kernel A
#define P2_H 256          // hidden width (the wrapper zero-pads narrower layers to it)
#define P2_FP 48          // features, padded (x's rows in the workspace)
#define P2_HEAD 32        // dl's rows in the workspace (A, padded)
#define P2_STAGE 16384    // bytes a ring stage: the largest slice, 128 x 64 of W2 or Wp
#define P2_WG 128         // threads a warpgroup
#define DW_STAGES 4
#define DW_MAX_TILES 16

// ----------------------------------------------------------- kernel A --
struct ParamsChain {
    CUtensorMap w1;   // W1 (P2_FP, H): boxes of P2_FP x 64
    CUtensorMap w2;   // W2 (H, H): boxes of 64 x 64
    CUtensorMap wp;   // Wp (H, 32): one box of H x 32, 64-byte swizzle
    CUtensorMap out;  // the workspace (x (Fp), h1, h2, dl (32), dh2, dh1): boxes of 16 x 64
    const bf16* obs;  // (T, F, N)
    int F, N;
    int t0, c0, nc, ncpad, tiles;  // the chunk: frames t0.., columns c0..c0+nc of each, padded
};

// Rows of a swizzled 128-byte-row tile: the byte offset of (r, c).
__device__ __forceinline__ int swz(int r, int c) {
    return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// An m64n64 accumulator, rounded to bf16, into rows m0..m0+63 of a tile.
__device__ __forceinline__ void store_block(const float (&d)[32], unsigned char* tile, int m0) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + 16 * w + g + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(tile + swz(r, 8 * j + 2 * t)) =
                __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
}

// A consumer warpgroup's side of the weight ring.
struct Ring {
    unsigned char* base;
    uint64_t *full, *empty;
    int nst, q_take, q_free;

    __device__ __forceinline__ const unsigned char* take() {
        const int st = q_take % nst;
        mbar_wait(&full[st], (q_take / nst) & 1);
        ++q_take;
        return base + st * P2_STAGE;
    }
    __device__ __forceinline__ void release() {
        if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[q_free % nst]);
        ++q_free;
    }
};

// One 64-row output block of KT k16 steps, B (right) MN-major with 2048
// bytes a step, A from the ring in slices of up to 8 steps (128 contraction
// rows): TA 1, MN-major (W^T from W's rows: the forward), 0, K-major in
// 64-column boxes (W from W's rows: dh1).  A slice's wgmma run while the
// next slice is awaited; a slice is released once its group has completed.
// Every count is a constant, so the wgmma of a slice issue back to back.
template <int TA, int KT>
__device__ __forceinline__ void block(float (&acc)[32], Ring& ring, const unsigned char* right) {
#pragma unroll
    for (int s = 0; s * 8 < KT; ++s) {
        const unsigned char* w = ring.take();
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < (KT - s * 8 < 8 ? KT - s * 8 : 8); ++k) {
            const unsigned char* a = TA ? w + k * 2048 : w + (k >> 2) * 8192 + (k & 3) * 32;
            wgmma_n64<TA, 1>(acc, desc(a, SW128, 1024),
                             desc(right + (s * 8 + k) * 2048, SW128, 1024), s | k);
        }
        wgmma_commit();
        if (s > 0) {
            wgmma_wait<1>();
            ring.release();
        }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release();
}

// Kernel A: NC consumer warpgroups, NST ring stages.
template <int NC, int NST>
__global__ void __launch_bounds__(NC * P2_WG + 32, 1)
    mm_chain_kernel(const __grid_constant__ ParamsChain p) {
    constexpr int FP = P2_FP, MB = P2_H / 64;
    constexpr int X_BYTES = FP * 128, H_BYTES = P2_H * 128;
    constexpr int SET_BYTES = X_BYTES + 2 * H_BYTES + P2_HEAD * 128;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * P2_STAGE + NC * SET_BYTES);
    uint64_t* empty = full + NST;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) {
        for (int s = 0; s < NST; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NC);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int units = NC == 1 ? p.tiles : (p.tiles + 1) / 2;
    const int first = (int)((long long)units * blockIdx.x / gridDim.x);
    const int last = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);

    if (warp == NC * 4) {  // the producer warp: one lane issues every copy
        if (lane == 0) {
            int qi = 0;
            auto slot = [&](int bytes) {
                const int st = qi % NST;
                mbar_wait(&empty[st], ((qi / NST) & 1) ^ 1);
                mbar_expect_tx(&full[st], bytes);
                ++qi;
                return st;
            };
            // W2 streams in slices of two 64 x 64 boxes: 128 contraction rows
            // of a column block for the forward, 128 contraction columns of a
            // row block for dh1.
            for (int u = first; u < last; ++u) {
                for (int b = 0; b < MB; ++b) {  // W1, a column block a slice
                    const int st = slot(X_BYTES);
                    tma_load_2d(ring + st * P2_STAGE, &p.w1, 64 * b, 0, &full[st]);
                }
                for (int b = 0; b < MB; ++b)    // W2's column block b, by rows
                    for (int h = 0; h < MB / 2; ++h) {
                        const int st = slot(2 * 8192);
                        for (int r = 0; r < 2; ++r)
                            tma_load_2d(ring + st * P2_STAGE + r * 8192, &p.w2, 64 * b,
                                        64 * (2 * h + r), &full[st]);
                    }
                {
                    const int st = slot(P2_H * 64);  // Wp whole
                    tma_load_2d(ring + st * P2_STAGE, &p.wp, 0, 0, &full[st]);
                }
                for (int b = 0; b < MB; ++b)    // W2's row block b, by columns
                    for (int h = 0; h < MB / 2; ++h) {
                        const int st = slot(2 * 8192);
                        for (int c = 0; c < 2; ++c)
                            tma_load_2d(ring + st * P2_STAGE + c * 8192, &p.w2, 64 * (2 * h + c),
                                        64 * b, &full[st]);
                    }
            }
        }
        return;
    }

    // A consumer warpgroup: its tile set, its own named barrier.
    const int cg = tid / P2_WG, ct = tid % P2_WG;
    unsigned char* xs = ring + NST * P2_STAGE + cg * SET_BYTES;
    unsigned char* h1 = xs + X_BYTES;
    unsigned char* h2 = h1 + H_BYTES;
    unsigned char* dl = h2 + H_BYTES;
    Ring rg = {ring, full, empty, NST, 0, 0};
    // A barrier of the warpgroup after its threads' writes to its tiles; the
    // tiles' copies to the workspace (TMA stores, issued by its first thread)
    // have read them by then, so they may be overwritten after it.
    auto sync = [&]() {
        fence_proxy_async();
        if (ct == 0) bulk_wait<true>();
        named_barrier(1 + cg, P2_WG);
    };
    // rows of a tile to the workspace from row row0, at the tile's columns.
    auto copy_out = [&](const unsigned char* tile, int rows, int row0, int wc0) {
        if (ct == 0) {
            for (int r = 0; r < rows; r += 16)
                tma_store_2d(&p.out, tile + r * 128, wc0, row0 + r);
            bulk_commit();
        }
    };
    constexpr int ROW_H1 = FP, ROW_H2 = ROW_H1 + P2_H, ROW_DL = ROW_H2 + P2_H;
    constexpr int ROW_DH2 = ROW_DL + P2_HEAD, ROW_DH1 = ROW_DH2 + P2_H;
    const int tpf = p.ncpad / P2_COLS;
    float acc[32];

    for (int u = first; u < last; ++u) {
        const int tile = NC == 1 ? u : 2 * u + cg;
        const bool valid = tile < p.tiles;
        const int fr = valid ? tile / tpf : 0, col = valid ? (tile - fr * tpf) * P2_COLS : 0;
        const int t = p.t0 + fr, nvalid = valid ? min(P2_COLS, p.nc - col) : 0;
        const int wc0 = fr * p.ncpad + col;
        const bf16* src = p.obs + (size_t)t * p.F * p.N + p.c0 + col;

        // ---- x (Fp, 64): zero past F and past the chunk's columns.
        for (int i = ct; i < FP * 8; i += P2_WG) {
            const int f = i >> 3, q = i & 7;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (f < p.F && q * 8 < nvalid) {
                const bf16* s = src + (size_t)f * p.N + q * 8;
                if ((p.N & 7) == 0 && ((p.c0 + col) & 7) == 0 && q * 8 + 8 <= nvalid) {
                    v = *reinterpret_cast<const uint4*>(s);
                } else {
                    bf16* e = reinterpret_cast<bf16*>(&v);
                    for (int k = 0; k < 8 && q * 8 + k < nvalid; ++k) e[k] = s[k];
                }
            }
            *reinterpret_cast<uint4*>(xs + f * 128 + ((q ^ (f & 7)) << 4)) = v;
        }
        sync();
        if (valid) copy_out(xs, FP, 0, wc0);

        // ---- h1 = bf16(W1^T x), a 64-row block a slice.
        for (int b = 0; b < MB; ++b) {
            block<1, FP / 16>(acc, rg, xs);
            store_block(acc, h1, 64 * b);
        }
        sync();
        if (valid) copy_out(h1, P2_H, ROW_H1, wc0);

        // ---- h2 = bf16(W2^T h1): W2's column block b is block b's A.
        for (int b = 0; b < MB; ++b) {
            block<1, P2_H / 16>(acc, rg, h1);
            store_block(acc, h2, 64 * b);
        }
        sync();
        if (valid) copy_out(h2, P2_H, ROW_H2, wc0);

        // ---- dl^T = h2^T Wp (M = the tile's columns, N = 32), then dh2 =
        // bf16(Wp dl) into h2's tile, both from the one Wp slice.
        {
            const unsigned char* w = rg.take();
            float d[16];
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < P2_H / 16; ++k)
                wgmma_n32<1, 1>(d, desc(h2 + k * 2048, SW128, 1024), desc(w + k * 1024, SW64, 512), k);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(d);
            {
                const int w4 = (ct >> 5) & 3, g = lane >> 2, t4 = lane & 3;
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int c = 16 * w4 + g + 8 * (i >> 1), a = 8 * j + 2 * t4 + (i & 1);
                        *reinterpret_cast<bf16*>(dl + swz(a, c)) = __float2bfloat16(d[4 * j + i]);
                    }
            }
            sync();  // dl complete; every thread is past h2's copy-out
            if (valid) copy_out(dl, P2_HEAD, ROW_DL, wc0);
            for (int b = 0; b < MB; ++b) {
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < 2; ++k)
                    wgmma_n64<0, 1>(acc, desc(w + b * 4096 + k * 32, SW64, 512),
                                    desc(dl + k * 2048, SW128, 1024), k);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(acc);
                store_block(acc, h2, 64 * b);
            }
            rg.release();
        }
        sync();
        if (valid) copy_out(h2, P2_H, ROW_DH2, wc0);

        // ---- dh1 = bf16(W2 dh2) into h1's tile: W2's row block b is block
        // b's A, K-major, in boxes of 64 columns.
        for (int b = 0; b < MB; ++b) {
            block<0, P2_H / 16>(acc, rg, h2);
            store_block(acc, h1, 64 * b);
        }
        sync();
        if (valid) copy_out(h1, P2_H, ROW_DH1, wc0);
    }
    if (ct == 0) bulk_wait<false>();
}

// ----------------------------------------------------------- kernel B --
// One output tile: D (rows a_row.. of 128, n columns) = A . B^T over the
// columns, A the workspace rows a_row.. (two 64-row blocks, one a consumer
// warpgroup), B the rows b_row.. (n of them; boxes of 64 rows).  The
// partial takes D[i][j] at off + i * ld + j (transposed: off + j * ld + i),
// for j < n_valid.
struct TileB {
    int a_row, b_row, n, n_valid, off, ld, transposed;
};

struct ParamsDW {
    CUtensorMap ws;  // the workspace, boxes of 64 rows x 64 columns
    TileB tile[DW_MAX_TILES];
    int ntiles, ranges, first, slices, rlen;  // slices: the chunk's 64-column slices
    float* partial;  // (ranges, stride)
    int stride;
};

template <int N>
__device__ __forceinline__ void wgmma_k(float (&d)[N / 2], uint64_t da, uint64_t db, int scale) {
    if constexpr (N == 128) wgmma_n128<0, 0>(d, da, db, scale);
    else if constexpr (N == 64) wgmma_n64<0, 0>(d, da, db, scale);
    else wgmma_n32<0, 0>(d, da, db, scale);
}

template <int N>
__device__ __forceinline__ void dw_tile(const ParamsDW& p, const TileB& t, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int range = blockIdx.x / p.ntiles;
    const int s0 = (int)((long long)p.slices * range / p.ranges);
    const int n = (int)((long long)p.slices * (range + 1) / p.ranges) - s0;
    constexpr int NB = N > 64 ? N / 64 : 1;  // B's boxes
    constexpr int STAGE = (2 + NB) * 8192;
    if (warp == 8) {
        if (lane == 0)
            for (int i = 0; i < n; ++i) {
                const int st = i % DW_STAGES;
                mbar_wait(&empty[st], ((i / DW_STAGES) & 1) ^ 1);
                unsigned char* dst = ring + st * STAGE;
                const int c = (s0 + i) * 64;
                mbar_expect_tx(&full[st], STAGE);
                tma_load_2d(dst, &p.ws, c, t.a_row, &full[st]);
                tma_load_2d(dst + 8192, &p.ws, c, t.a_row + 64, &full[st]);
                for (int b = 0; b < NB; ++b)
                    tma_load_2d(dst + (2 + b) * 8192, &p.ws, c, t.b_row + 64 * b, &full[st]);
            }
        return;
    }
    const int cg = tid / P2_WG;
    float run[N / 2], d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) run[i] = 0.0f;
    for (int i = 0; i < n; ++i) {
        const int st = i % DW_STAGES;
        mbar_wait(&full[st], (i / DW_STAGES) & 1);
        const unsigned char* a = ring + st * STAGE + cg * 8192;
        const unsigned char* b = ring + st * STAGE + 16384;
        const bool fresh = p.rlen ? i % p.rlen == 0 : i == 0;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
            wgmma_k<N>(d, desc(a + k * 32, SW128, 1024), desc(b + k * 32, SW128, 1024),
                       !(fresh && k == 0));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        if (lane == 0) mbar_arrive(&empty[st]);
        if (i == n - 1 || (p.rlen && (i + 1) % p.rlen == 0))
#pragma unroll
            for (int j = 0; j < N / 2; ++j) run[j] = __fadd_rn(run[j], d[j]);
    }
    // The block's tile to its partial.
    float* part = p.partial + (size_t)range * p.stride + t.off;
    const int w = warp & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = cg * 64 + 16 * w + g + 8 * (e >> 1), c = 8 * j + 2 * tq + (e & 1);
            if (c >= t.n_valid) continue;
            float* dst = part + (t.transposed ? (size_t)c * t.ld + r : (size_t)r * t.ld + c);
            const float v = run[4 * j + e];
            *dst = p.first ? v : __fadd_rn(*dst, v);
        }
}

__global__ void __launch_bounds__(2 * P2_WG + 32, 1) mm_dw_kernel(const __grid_constant__ ParamsDW p) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + DW_STAGES * 4 * 8192);
    uint64_t* empty = full + DW_STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < DW_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);
        }
        mbar_fence_init();
    }
    __syncthreads();
    const TileB& t = p.tile[blockIdx.x % p.ntiles];
    if (t.n == 128) dw_tile<128>(p, t, ring, full, empty);
    else if (t.n == 64) dw_tile<64>(p, t, ring, full, empty);
    else dw_tile<32>(p, t, ring, full, empty);
}

// ------------------------------------------------------------- launch --
// stages: 1 kernel A only, 2 kernel B only (on a workspace kernel A
// filled), 3 both.  w1 (P2_FP, H), w2 (H, H), wp (H, 32) bf16, zero past F,
// the hidden widths and A; H = P2_H.  The chunks: frames of
// chunk_frames (each all N columns) if chunk_cols >= N, else one frame's
// chunk_cols columns (a multiple of 64) at a time.  ws (ws_rows, ws_cols)
// bf16, ws_rows = P2_FP + 4 H + 32, ws_cols >= the largest chunk's frames x
// its columns padded to 64.  out: dW1 (P2_FP, H), dW2 (H, H), dWp (H, 32), f32.
// phased: kernel A's ping-pong variant.  rlen: kernel B's slices a fresh
// accumulation (0: all).
extern "C" int mm_grads_launch(const void* obs, const void* w1, const void* w2, const void* wp,
                               int frames, int obs_dim, int cols, int phased,
                               int chunk_frames, int chunk_cols, void* ws, int ws_rows,
                               long long ws_cols, void* partial, int ranges, int rlen, void* out,
                               void* stream, int stages) {
    if (frames < 1 || cols < 1 || obs_dim < 1 || obs_dim > P2_FP || chunk_frames < 1 ||
        chunk_cols < 64 || chunk_cols % 64 || ranges < 1 || rlen < 0 || stages < 1 || stages > 3 ||
        ws_cols % 8 || ws_rows != P2_FP + 4 * P2_H + P2_HEAD || ws_cols > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const bool by_frames = chunk_cols >= cols;
    const int nc_max = by_frames ? cols : chunk_cols;
    const int ncpad_max = (nc_max + P2_COLS - 1) / P2_COLS * P2_COLS;
    const int nf_max = by_frames ? chunk_frames : 1;
    if (ws_cols < (long long)nf_max * ncpad_max) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int H = P2_H;

    ParamsChain pa;
    memset(&pa, 0, sizeof(pa));
    void (*kernel_a)(const ParamsChain) = phased ? mm_chain_kernel<2, 4> : mm_chain_kernel<1, 8>;
    const int nc_a = phased ? 2 : 1, nst_a = phased ? 4 : 8;
    const int sm_a = 1024 + nst_a * P2_STAGE + nc_a * (P2_FP + 2 * H + P2_HEAD) * 128 + 2 * nst_a * 8;
    if (stages & 1) {
        if (!map_2d(&pa.w1, w1, P2_FP, H, H, P2_FP, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
            !map_2d(&pa.w2, w2, H, H, H, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
            !map_2d(&pa.wp, wp, H, P2_HEAD, P2_HEAD, H, P2_HEAD, CU_TENSOR_MAP_SWIZZLE_64B) ||
            !map_2d(&pa.out, ws, ws_rows, ws_cols, ws_cols, 16, 64, CU_TENSOR_MAP_SWIZZLE_128B))
            return (int)cudaErrorInvalidValue;
        pa.obs = (const bf16*)obs;
        pa.F = obs_dim;
        pa.N = cols;
        err = cudaFuncSetAttribute(kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_a);
        if (err != cudaSuccess) return (int)err;
    }

    ParamsDW pb;
    memset(&pb, 0, sizeof(pb));
    const int row_h1 = P2_FP, row_h2 = row_h1 + H, row_dl = row_h2 + H;
    const int row_dh2 = row_dl + P2_HEAD, row_dh1 = row_dh2 + H;
    const int off_w2 = P2_FP * H, off_wp = off_w2 + H * H;
    const int n_w = off_wp + H * P2_HEAD;
    const int sm_b = 1024 + DW_STAGES * 4 * 8192 + 2 * DW_STAGES * 8;
    if (stages & 2) {
        if (!map_2d(&pb.ws, ws, ws_rows, ws_cols, ws_cols, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))
            return (int)cudaErrorInvalidValue;
        int nt = 0;
        for (int m0 = 0; m0 < H; m0 += 128)  // dW2 = h1 dh2^T
            for (int n0 = 0; n0 < H; n0 += 128)
                pb.tile[nt++] = {row_h1 + m0, row_dh2 + n0, 128, 128, off_w2 + m0 * H + n0, H, 0};
        for (int m0 = 0; m0 < H; m0 += 128)  // dW1^T = dh1 x^T
            pb.tile[nt++] = {row_dh1 + m0, 0, 64, P2_FP, m0, H, 1};
        for (int m0 = 0; m0 < H; m0 += 128)  // dWp = h2 dl^T
            pb.tile[nt++] = {row_h2 + m0, row_dl, 32, P2_HEAD, off_wp + m0 * P2_HEAD, P2_HEAD, 0};
        pb.ntiles = nt;
        pb.ranges = ranges;
        pb.rlen = rlen;
        pb.partial = (float*)partial;
        pb.stride = n_w;
        err = cudaFuncSetAttribute(mm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_b);
        if (err != cudaSuccess) return (int)err;
    }

    bool first = true;
    for (int t0 = 0; t0 < frames; t0 += nf_max)
        for (int c0 = 0; c0 < cols; c0 += nc_max) {
            const int nf = min(nf_max, frames - t0), nc = min(nc_max, cols - c0);
            const int ncpad = (nc + P2_COLS - 1) / P2_COLS * P2_COLS;
            const int tiles = nf * ncpad / P2_COLS;
            if (stages & 1) {
                pa.t0 = t0;
                pa.c0 = c0;
                pa.nc = nc;
                pa.ncpad = ncpad;
                pa.tiles = tiles;
                const int units = phased ? (tiles + 1) / 2 : tiles;
                kernel_a<<<min(units, sms), nc_a * P2_WG + 32, sm_a, s>>>(pa);
                err = cudaGetLastError();
                if (err != cudaSuccess) return (int)err;
            }
            if (stages & 2) {
                pb.slices = nf * ncpad / 64;
                pb.first = first;
                mm_dw_kernel<<<pb.ntiles * ranges, 2 * P2_WG + 32, sm_b, s>>>(pb);
                err = cudaGetLastError();
                if (err != cudaSuccess) return (int)err;
            }
            first = false;
        }
    if (stages & 2)
        reduce_partials<<<(n_w + 255) / 256, 256, 0, s>>>((const float*)partial, ranges, n_w,
                                                          (float*)out);
    return (int)cudaGetLastError();
}
