// The split design of the clipped-PPO gradient: a per-tile chain kernel
// (kernel A) that writes the dW products' operands to a workspace, and a
// long-K dW kernel (kernel B) that computes each dW from it.  Shared by K1's
// bf16 and int8fwd modes, each with or without the bf16 backward chain
// (fused_update_bf16.cu), K1's int8 mode (fused_update_int8.cu, which runs
// kernel B for the head's dW and shares the int8 forward's device code
// below), K4 (k4_split.cu) and the feature-major prototype P3
// (fm_kernel_probe.cu).  The design is described in fused_update_bf16.cu;
// what K4, P3, int8fwd and the bf16 backward chain change in kernel A is
// described at chain_kernel.

#pragma once

#include "ppo_grads.cuh"

using namespace ppo;

#define MAX_LAYERS 4
#define B_THREADS 256
#define BT 128           // kernel B's output tile, rows and columns
#define KB 64            // columns per operand slice of kernel B
#define LDB (KB + 8)
#define B_STAGES 3
#define MAX_TILES 64
#define COLS 64          // columns per tile of a chain kernel
#define LDH (COLS + 8)   // row stride of kernel A's bf16 tiles (elements)
#define LDZ (COLS + 8)   // row stride of the head's f32 block
#define HEAD_PAD 32      // K1's merged head (A+1 rows, padded); the workspace's dheads rows
#define HEAD_SPLIT 48    // K4's and P3's head: the policy rows padded to 32, then the value row
#define VALUE_ROW 32     // the value's row of the split head
#define A_WARPS 16       // warps of kernel A that compute
#define A_PRODUCERS 128  // threads (a warpgroup) of kernel A that stream the weights
#define A_THREADS (32 * A_WARPS + A_PRODUCERS)
#define MAX_PRODUCTS (2 * MAX_LAYERS + 2)
#define SMEM_LIMIT 232448
#define S_IN (1.0f / 127.0f)  // the static dequant scale of int8 activations

// ---------------------------------------------------------------- PTX --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

// acc += a . b over 16 products: the mma sums them into a fresh fragment
// (C = 0), the running sum takes it with round-to-nearest adds.  Fragment
// layouts (PTX ISA, m16n8k16 bf16): A rows g and g+8, k pairs 2tg and 2tg+8;
// B k pairs 2tg and 2tg+8, column g; C rows g (c0, c1) and g+8 (c2, c3),
// columns 2tg and 2tg+1.
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
    float d[4];
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f), "f"(0.0f),
          "f"(0.0f), "f"(0.0f));
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// ---------------------------------------------------- the warp's tile --
// A warp's share of an (M x COLS) output of a chain kernel's 16 compute
// warps: one 16-row tile, nb 8-column blocks from column n0.  Up to four
// warps (nwg, this one the ng-th) split a tile's columns when M is small, so
// that more warps work.  A function of M alone: every product with M rows
// gives a thread the same outputs.
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

// ------------------------------------------------ the int8 forward --
// Shared by K1 int8's kernel A and the int8fwd chain: x and tanh outputs
// quantised with the static scale 127, the products on mma.sync m16n8k32
// (s8 -> s32, exact), the weight scale riding the bias add.
__device__ __forceinline__ int8_t q127(float v) {
    return (int8_t)fminf(fmaxf(rintf(__fmul_rn(v, 127.0f)), -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// The pre-activation of an int8 forward product: float(acc) * scale + bias,
// scale = sw_l / 127, each step rounded as the plain version's f32 ops.
__device__ __forceinline__ float dequant_add(int acc, float scale, float bias) {
    return __fadd_rn(__fmul_rn((float)acc, scale), bias);
}

// acc += the warp's share of w (M x K int8, row m at w + m * ldw) . act^T,
// act (COLS x K int8, column n at act + n * lda), on m16n8k32 s8 -> s32:
// exact sums.  K % 32 == 0.  Fragments (PTX ISA): A rows g and g+8, k 4tg..
// and 16+4tg..; B column g, the same k; C rows g (c0, c1) and g+8 (c2, c3),
// columns 2tg and 2tg+1.  w may lie in shared or global memory.  Row
// strides of 16 bytes past a multiple of 32 (KPAD) keep the 32-bit loads
// off each other's banks.
__device__ __forceinline__ void mma_s8_add(int (&acc)[8][4], const WarpTile& wt, const int8_t* w,
                                           int ldw, const int8_t* act, int lda, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
    const int8_t* a_lo = w + (size_t)(wt.m0 + g) * ldw + tg * 4;
    const int8_t* a_hi = a_lo + (size_t)8 * ldw;
    const int8_t* b_col = act + (wt.n0 + g) * lda + tg * 4;
    for (int k = 0; k < K; k += 32) {
        const uint32_t a[4] = {ld32(a_lo + k), ld32(a_hi + k), ld32(a_lo + k + 16),
                               ld32(a_hi + k + 16)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j < wt.nb) {
                const int8_t* bp = b_col + j * 8 * lda + k;
                const uint32_t b[2] = {ld32(bp), ld32(bp + 16)};
                mma_s8(acc[j], a, b);
            }
        }
    }
}

__device__ __forceinline__ void mma_s8_tile(int (&acc)[8][4], const WarpTile& wt, const int8_t* w,
                                            int ldw, const int8_t* act, int lda, int K) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    mma_s8_add(acc, wt, w, ldw, act, lda, K);
}

// ----------------------------------------------------------- kernel A --
// The chain kernel, in three modes:
// - CHAIN_BF16 (K1's bf16 mode): obs feature-major (T, F, N); the forward,
//   the merged head (HEAD_PAD rows, the value in row A), the loss and
//   dheads, the backward chain down to dpre_0 with the derivative from
//   bf16(h).
// - CHAIN_INT8FWD (K1's int8fwd mode): the forward on int8 products (x and
//   each h quantised with the static scale, the weights per tensor, streamed
//   through the ring as int8 slices twice as deep), keeping bf16(h_f), the
//   f32 tanh's round (not the dequantised h_q, which feeds only the next
//   product); then the bf16 mode's backward, unchanged, on the bf16 weights.
// - CHAIN_K4 (K4, row-major): a chunk of rows is one "frame" of N columns,
//   the obs and per-row pointers offset to the chunk's first row.  Each tile
//   reads its 64 rows of F bf16 (one contiguous block) and transposes them
//   in shared memory, and writes x^T to the workspace for kernel B.  The
//   head is split (HEAD_SPLIT rows: the policy in 0..A-1, the value in
//   VALUE_ROW): its dh product sums K = 48 in three 16-row chunks with a
//   rounded add after each, so the value head's product is added in f32 to
//   the finished policy product, the TPU kernel's two products summed.  The
//   derivative is taken from the f32 activation (tanh): each compute thread
//   keeps the f32 values of its own forward outputs in a per-block scratch
//   in device memory (64 KB a layer and block, rewritten every tile, so it
//   stays in L2) and reads them back in the backward, where the same warp
//   tile gives it the same outputs.  relu's derivative is the same from
//   either.  The workspace's dheads rows, the bias grads and the kernel's
//   outputs are in K1's merged layout, so kernel B and the wrapper are K1's.
// - CHAIN_P3 (P3, the feature-major prototype with split heads): K1 bf16's
//   tiles and derivative (from bf16(h)), the split head of CHAIN_K4, and the
//   TPU kernel's value path (tools/fm_kernel_probe.py:103-110, :144-162):
//   the value is the head product's row VALUE_ROW, an f32 sum of f32(bf16
//   Wv) * f32(h_top); dvalue stays f32 (the dheads rows the products read
//   hold bf16(dlogits) alone, the value's row zero), so the head's dh product
//   sums the policy rows only (K = 32) and its epilogue adds f32(Wv) *
//   dvalue in f32; dWv = sum_c h_top * dvalue and dbv = sum_c dvalue are
//   summed in f32 per block (value_weight_sums, the bias grads' row sums)
//   and written to the block's partial after the loss sums.  The workspace's
//   dheads rows are bf16(dlogits), zero from row A: kernel B's dWpv holds
//   dWp in its first A columns and nothing of the value.
// BB, orthogonal to the mode (CHAIN_BF16 or CHAIN_INT8FWD with the bf16
// backward chain, bwd_bf16): the backward's epilogue in bf16 arithmetic, op
// by op, as the JAX kernel casts it: dh_b = bf16(dh), for tanh hh =
// bf16(h*h) and da = bf16(1 - hh) (relu: da = [h > 0]), dpre_b = bf16(dh_b *
// da), the derivative from bf16(h) as the mode keeps it; the bias grads sum
// the rounded dpre_b.  The head's dh product runs on the CUDA cores
// (fma_slice) over its A+1 rows, reading Wpv from the ring stage that the
// producers fill for it as for the mma, so the stream, the ring's order, the
// barriers and the shared-memory plan are the mode's own.
enum { CHAIN_BF16 = 0, CHAIN_INT8FWD = 1, CHAIN_K4 = 2, CHAIN_P3 = 3 };

// The modes whose head is split (HEAD_SPLIT rows, the value in VALUE_ROW).
__host__ __device__ constexpr bool split_head(int mode) {
    return mode == CHAIN_K4 || mode == CHAIN_P3;
}

// A product's weights: W_FWD W (K, M) bf16 row-major, the product W^T act;
// W_DH W (M, K) bf16 row-major, W act; W_FWD8 W^T (M, K) int8 row-major, K
// a multiple of 32, the product W^T act on the s8 tensor cores.
enum { W_FWD = 0, W_DH = 1, W_FWD8 = 2 };

// One product of the chain: out (M x COLS) = Wop (M x K) . act (K x COLS).
struct Prod {
    const void* w;
    int ldw, M, K, kind;  // ldw: elements of a row of w
    int slice0, slices;   // first slice in the tile's stream, and the count
};

struct ParamsA {
    const bf16* obs;
    const int* action;
    const float *logp_old, *value_old, *adv, *target;
    const float* b[MAX_LAYERS + 1];
    const float* sw;           // int8fwd: the L+1 weight scales
    const float* wv;           // P3: f32(bf16 Wv), H_top floats
    Prod prod[MAX_PRODUCTS];
    int slices_per_tile, stage_elems;
    int hidden[MAX_LAYERS];
    int L, F, Fp, A, relu, N, Npad, t0, frames, lda;
    float clip, neg_inv_m, ent_scale, val_scale;
    bf16* ws;                  // (rows, ws_cols) bf16
    long long ws_cols;
    long long off_x, off_h[MAX_LAYERS], off_dh, off_dp[MAX_LAYERS];  // elements
    float2* hkeep;             // K4 tanh: (blocks, L, 16, 32 * A_WARPS) f32 activations
    float* partial;            // (blocks, stride): bias grads (K1's layout), 4 loss sums, P3's dWv
    int stride, first, bias_total;
    int sm_x, sm_h[MAX_LAYERS], sm_dh, sm_z, sm_loss, sm_bias, sm_bgrad, sm_rsum, sm_ring;
    int sm_wv, sm_dwv;         // P3: Wv and the block's dWv, H_top floats each
    int sm_act[2];             // int8fwd: the int8 act tiles [column][feature], lda bytes a column
};

// Weight slices are KS contraction rows deep (int8 slices 2 KS): 64 where
// shared memory allows three stages of them, else 32.  A dh product's slice
// is stored [m][KS + 8], an int8 slice [m][2 KS + 16] bytes: the same bytes.
template <int NST, int KS>
__device__ __forceinline__ void load_slice(const ParamsA& p, bf16* ring, int q) {
    const int s = q % p.slices_per_tile;
    int i = 0;
    while (s >= p.prod[i].slice0 + p.prod[i].slices) ++i;
    const Prod& pr = p.prod[i];
    const int depth = pr.kind == W_FWD8 ? 2 * KS : KS;
    const int k0 = (s - pr.slice0) * depth, d = min(depth, pr.K - k0);
    char* dst = (char*)(ring + (q % NST) * p.stage_elems);
    // fwd: rows k0..k0+d of W (K, M), stored [k][M + 8]; dh: columns
    // k0..k0+d of W (M, K), stored [m][KS + 8]; fwd8: bytes k0..k0+d of each
    // row of W^T (M, K).  Rows of per_row 16-byte pieces, which the producer
    // threads walk without a division a piece.
    int rows, per_row, ld, src_ld;
    const char* src;
    if (pr.kind == W_FWD) {
        rows = d, per_row = pr.M >> 3, ld = (pr.M + 8) * 2, src_ld = pr.ldw * 2;
        src = (const char*)((const bf16*)pr.w + (size_t)k0 * pr.ldw);
    } else if (pr.kind == W_DH) {
        rows = pr.M, per_row = d >> 3, ld = (KS + 8) * 2, src_ld = pr.ldw * 2;
        src = (const char*)((const bf16*)pr.w + k0);
    } else {
        rows = pr.M, per_row = d >> 4, ld = 2 * KS + 16, src_ld = pr.ldw;
        src = (const char*)pr.w + k0;
    }
    const int pt = threadIdx.x - 32 * A_WARPS, dr = A_PRODUCERS / per_row;
    const int dx = A_PRODUCERS - dr * per_row;
    int r = pt / per_row, x = pt - r * per_row;
    while (r < rows) {
        cp_async16(dst + r * ld + x * 16, src + (size_t)r * src_ld + x * 16);
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

// The warp's share of the same product over rows k0..k0+n of act on the CUDA
// cores: each entry the thread owns in the mma's C layout (rows m0+g and
// m0+g+8, columns n0+8j+2tg and +1) adds its products one row of act after
// another with round-to-nearest FMAs, w (M x n) bf16 [m][k] (row stride
// ldw).  The bf16 chain's head dh takes it: on the tensor cores its A+1 = 19
// terms, which cancel (the policy rows of dheads sum to ~0 over the actions),
// were summed by one mma that rounds toward zero, by far more than an f32
// ulp of the result; the chain rounds dh to bf16 next, and that bias flipped
// the roundings one way: K1 bwd_bf16 sat 3.9e-3 (worst grad leaf, relative
// L2) from a float64 reference at full width against its plain version's
// 1.3e-4, and 1.6e-4 with this product (measured on an H100 in the
// one-kernel design that preceded this one).  The f32 chain rounds later and
// its grads did not move, so it keeps the tensor cores.
__device__ __forceinline__ void fma_slice(float (&acc)[8][4], const WarpTile& wt, const bf16* w,
                                          int ldw, const bf16* act, int k0, int n) {
    const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
    const bf16* w_lo = w + (wt.m0 + g) * ldw;
    const bf16* w_hi = w_lo + 8 * ldw;
    for (int k = 0; k < n; ++k) {
        const float a0 = __bfloat162float(w_lo[k]), a1 = __bfloat162float(w_hi[k]);
        const bf16* row = act + (k0 + k) * LDH + wt.n0 + 2 * tg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j < wt.nb) {
                const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 8 * j));
                acc[j][0] = __fmaf_rn(a0, b.x, acc[j][0]);
                acc[j][1] = __fmaf_rn(a0, b.y, acc[j][1]);
                acc[j][2] = __fmaf_rn(a1, b.x, acc[j][2]);
                acc[j][3] = __fmaf_rn(a1, b.y, acc[j][3]);
            }
        }
    }
}

// Stream the product's weight slices through the ring and run the warp's
// mmas; q is the block's running slice count.  T = float: a bf16 product,
// act bf16 [k][column] (LDH); T = int: an int8 product, act int8
// [column][k] (p.lda bytes), exact int32 sums.  cuda_rows > 0: a W_DH
// product on the CUDA cores (fma_slice) over the first cuda_rows rows of act
// (the rest are zero); the weight stream is the same.
template <int NST, int KS, typename T>
__device__ __forceinline__ void product(const ParamsA& p, const Prod& pr, bf16* ring, int& q,
                                        int q_end, const void* act, T (&acc)[8][4],
                                        const WarpTile& wt, int cuda_rows = 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0;
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
            if constexpr (std::is_same<T, int>::value) {
                const int k0 = s * 2 * KS;
                mma_s8_add(acc, wt, (const int8_t*)w, 2 * KS + 16, (const int8_t*)act + k0, p.lda,
                           min(2 * KS, pr.K - k0));
            } else {
                const int k0 = s * KS, d = min(KS, pr.K - k0);
                if (cuda_rows > 0)
                    fma_slice(acc, wt, w, KS + 8, (const bf16*)act, k0, min(d, cuda_rows - k0));
                else if (pr.kind == W_FWD)
                    mma_slice<true>(acc, wt, w, pr.M + 8, (const bf16*)act, k0, d);
                else
                    mma_slice<false>(acc, wt, w, KS + 8, (const bf16*)act, k0, d);
            }
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

// K4: the tile's nvalid rows of F bf16 (one contiguous block from src,
// 16-byte aligned) transposed into xs [f][c]; columns >= nvalid zero (rows
// >= F the caller zeroed once).
__device__ __forceinline__ void load_rows(bf16* xs, const bf16* src, int F, int nvalid) {
    const int n = nvalid * F;
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i * 8 < n; i += A_THREADS) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
        if (i * 8 + 8 <= n) {
            u = *reinterpret_cast<const uint4*>(src + i * 8);
        } else {
            bf16* w = reinterpret_cast<bf16*>(&u);
            for (int e = 0; i * 8 + e < n; ++e) w[e] = src[i * 8 + e];
        }
        int r = i * 8 / F, f = i * 8 - r * F;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            if (i * 8 + e < n) xs[f * LDH + r] = v[e];
            if (++f == F) {
                f = 0;
                ++r;
            }
        }
    }
    for (int i = threadIdx.x; i < F * (COLS - nvalid); i += A_THREADS) {
        const int f = i / (COLS - nvalid), c = nvalid + i % (COLS - nvalid);
        xs[f * LDH + c] = zero;
    }
}

// P3's dWv: acc[r] += the sum over the tile's columns of h[r][c] * dval[c]
// (h bf16 with row stride LDH), a warp a row, the products in f32, then a
// butterfly in a fixed order (deterministic).
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

// BB's dpre_b of an f32 dh and the bf16 activation h (as f32).
__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float dpre_bf16(float dh, float h, int relu) {
    const float da = relu ? (h > 0.0f ? 1.0f : 0.0f)
                          : bf16_round(__fsub_rn(1.0f, bf16_round(__fmul_rn(h, h))));
    return bf16_round(__fmul_rn(bf16_round(dh), da));
}

template <int MODE, bool BB, int NST, int KS>
__global__ void __launch_bounds__(A_THREADS, 1) chain_kernel(const __grid_constant__ ParamsA p) {
    static_assert(!BB || !split_head(MODE), "K4 and P3 have no bf16 backward chain");
    constexpr int HR = split_head(MODE) ? HEAD_SPLIT : HEAD_PAD;  // the head's rows
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
    const int vrow = split_head(MODE) ? VALUE_ROW : A;
    const int hidden_total = p.bias_total - HEAD_PAD;
    const bool keep = MODE == CHAIN_K4 && !p.relu;  // the f32 activations kept for the backward
    const bf16 zero = __float2bfloat16(0.0f);

    {
        int pos = 0;
        for (int l = 0; l <= L; ++l) {
            const int n = l < L ? p.hidden[l] : HR;
            for (int i = tid; i < n; i += A_THREADS) bias[pos + i] = p.b[l][i];
            pos += n;
        }
        for (int i = tid; i < hidden_total + HR; i += A_THREADS) bgrad[i] = 0.0f;
        if (tid < 4) lacc[tid] = 0.0f;
        if (MODE == CHAIN_P3)
            for (int i = tid; i < p.hidden[L - 1]; i += A_THREADS) {
                ((float*)(smem + p.sm_wv))[i] = p.wv[i];
                ((float*)(smem + p.sm_dwv))[i] = 0.0f;
            }
        if (MODE == CHAIN_K4)
            for (int i = tid; i < (p.Fp - p.F) * COLS; i += A_THREADS)
                xs[(p.F + i / COLS) * LDH + i % COLS] = zero;
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
    float2* hk = keep ? p.hkeep + (size_t)blockIdx.x * L * 16 * (32 * A_WARPS) + tid : nullptr;

    for (int tile = first; tile < last; ++tile) {
        const int tr = tile / tpf, c0 = (tile - tr * tpf) * COLS;
        const int t = p.t0 + tr;
        const int nvalid = min(COLS, p.N - c0);
        const long long wc0 = (long long)tr * p.Npad + c0;

        // ---- observations (Fp, COLS): zero rows >= F and columns >= nvalid.
        if constexpr (MODE == CHAIN_K4) {
            load_rows(xs, p.obs + (size_t)c0 * p.F, p.F, nvalid);
        } else if constexpr (MODE == CHAIN_INT8FWD) {
            // x_q to act tile 0 [column][feature]; the last tile's dheads
            // may share its bytes (every thread is past their copy-out).
            __syncthreads();
            int8_t* act = (int8_t*)(smem + p.sm_act[0]);
            for (int i = tid; i < p.Fp * COLS; i += A_THREADS) {
                const int f = i / COLS, c = i % COLS;
                act[c * p.lda + f] = (f < p.F && c < nvalid)
                    ? q127(__bfloat162float(p.obs[((size_t)t * p.F + f) * p.N + c0 + c])) : 0;
            }
        } else if ((p.N & 7) == 0) {
            // 16 bytes a thread where the rows are 16-byte aligned.
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
            bf16* h = (bf16*)(smem + p.sm_h[l]);
            if constexpr (MODE == CHAIN_INT8FWD) {
                // h_f = tanh(float(Wq_l^T h_q) * sw_l/127 + b_l): bf16(h_f) for
                // the backward, q127(h_f) to the other act tile.
                int acc8[8][4];
                product<NST, KS>(p, pr, ring, q, q_end, smem + p.sm_act[l & 1], acc8, wt);
                int8_t* out = (int8_t*)(smem + p.sm_act[(l + 1) & 1]);
                const float scale = __fmul_rn(p.sw[l], S_IN);
                if (wt.active) {
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (j >= wt.nb) continue;
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                            const float v0 = tanhf(dequant_add(acc8[j][2 * hh], scale, bias[boff + r]));
                            const float v1 = tanhf(dequant_add(acc8[j][2 * hh + 1], scale, bias[boff + r]));
                            out[c * p.lda + r] = q127(v0);
                            out[(c + 1) * p.lda + r] = q127(v1);
                            *reinterpret_cast<__nv_bfloat162*>(h + r * LDH + c) =
                                __floats2bfloat162_rn(v0, v1);
                        }
                    }
                }
            } else {
                product<NST, KS>(p, pr, ring, q, q_end, below, acc, wt);
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
                            if (keep)
                                __stcg(hk + (l * 16 + j * 2 + hh) * (32 * A_WARPS),
                                       make_float2(v0, v1));
                        }
                    }
                }
            }
            boff += pr.M;
            below = h;
        }
        // ---- the merged head, before its bias, to the f32 block z.
        {
            const Prod& pr = p.prod[L];
            const WarpTile wt = warp_tile(HR);
            if constexpr (MODE == CHAIN_INT8FWD) {
                int acc8[8][4];
                product<NST, KS>(p, pr, ring, q, q_end, smem + p.sm_act[L & 1], acc8, wt);
                const float scale = __fmul_rn(p.sw[L], S_IN);
                if (wt.active) {
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (j >= wt.nb) continue;
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const int r = wt.m0 + g + 8 * hh, c = wt.n0 + j * 8 + 2 * tg;
                            *reinterpret_cast<float2*>(z + r * LDZ + c) =
                                make_float2(__fmul_rn((float)acc8[j][2 * hh], scale),
                                            __fmul_rn((float)acc8[j][2 * hh + 1], scale));
                        }
                    }
                }
            } else {
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
        }
        __syncthreads();

        // ---- loss and dheads, one thread a column; the other threads copy
        // the bf16 activations (and K4's x^T) to the workspace meanwhile.
        if (tid < COLS) {
            const int c = tid;
            float dcol[HR];
            LossTerms lt = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int r = 0; r < HR; ++r) dcol[r] = 0.0f;
            if (c < nvalid) {
                const size_t gi = (size_t)t * p.N + c0 + c;
                lt = ppo_column(z + c, LDZ, bias + boff, A, vrow, p.action[gi], p.logp_old[gi],
                                p.adv[gi], p.value_old[gi], p.target[gi], p.clip, p.neg_inv_m,
                                p.ent_scale, p.val_scale, dcol, dcol + vrow);
            }
            closs[0 * COLS + c] = lt.pol;
            closs[1 * COLS + c] = lt.val;
            closs[2 * COLS + c] = lt.ent;
            closs[3 * COLS + c] = lt.kl;
            // Each thread reads and writes its own column of z only.
#pragma unroll
            for (int r = 0; r < HR; ++r) {
                z[r * LDZ + c] = dcol[r];
                dhb[r * LDH + c] = __float2bfloat16(dcol[r]);
            }
        } else {
            if (MODE == CHAIN_K4)
                copy_out(xs, p.Fp, p.ws + p.off_x + wc0, p.ws_cols, tid - COLS, A_THREADS - COLS);
            for (int l = 0; l < L; ++l)
                copy_out((const bf16*)(smem + p.sm_h[l]), p.hidden[l],
                         p.ws + p.off_h[l] + wc0, p.ws_cols, tid - COLS, A_THREADS - COLS);
        }
        __syncthreads();
        row_sums<COLS>(z, LDZ, HR, bgrad + boff);
        row_sums<COLS>(closs, COLS, 4, lacc);
        if (MODE == CHAIN_P3)  // dWv, before the backward overwrites h_top
            value_weight_sums((const bf16*)(smem + p.sm_h[L - 1]), z + VALUE_ROW * LDZ,
                              p.hidden[L - 1], (float*)(smem + p.sm_dwv));

        // ---- backward: dh_l = W_{l+1} . bf16(dpre_{l+1}) (the head: Wpv .
        // bf16(dheads)), then dpre_l = dh_l * act'(h_l) on registers (BB: in
        // bf16, dpre_bf16): its f32 row sums are the bias grads,
        // bf16(dpre_l) replaces h_l.
        for (int i = L + 1, l = L - 1; l >= 0; ++i, --l) {
            const Prod& pr = p.prod[i];
            const bf16* right = i == L + 1 ? dhb : (const bf16*)(smem + p.sm_h[l + 1]);
            const WarpTile wt = warp_tile(pr.M);
            product<NST, KS>(p, pr, ring, q, q_end, right, acc, wt, BB && i == L + 1 ? A + 1 : 0);
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
                        const float2 hf = keep ? __ldcg(hk + (l * 16 + j * 2 + hh) * (32 * A_WARPS))
                                               : __bfloat1622float2(*hp);
                        if (MODE == CHAIN_P3 && i == L + 1) {
                            // dh = Wp . bf16(dlogits) + f32(Wv) * dvalue, in f32.
                            const float wv = ((const float*)(smem + p.sm_wv))[r];
                            const float* dval = z + VALUE_ROW * LDZ + c;
                            acc[j][2 * hh] = __fadd_rn(acc[j][2 * hh], __fmul_rn(wv, dval[0]));
                            acc[j][2 * hh + 1] = __fadd_rn(acc[j][2 * hh + 1], __fmul_rn(wv, dval[1]));
                        }
                        float d0, d1;
                        if constexpr (BB) {
                            d0 = dpre_bf16(acc[j][2 * hh], hf.x, p.relu);
                            d1 = dpre_bf16(acc[j][2 * hh + 1], hf.y, p.relu);
                        } else {
                            const float da0 = p.relu ? (hf.x > 0.0f ? 1.0f : 0.0f)
                                                     : __fsub_rn(1.0f, __fmul_rn(hf.x, hf.x));
                            const float da1 = p.relu ? (hf.y > 0.0f ? 1.0f : 0.0f)
                                                     : __fsub_rn(1.0f, __fmul_rn(hf.y, hf.y));
                            d0 = __fmul_rn(acc[j][2 * hh], da0);
                            d1 = __fmul_rn(acc[j][2 * hh + 1], da1);
                        }
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
        // The dheads rows in K1's layout: the policy rows, then the value.
        for (int i = tid; i < HEAD_PAD * (COLS / 8); i += A_THREADS) {
            const int r = i >> 3, x = i & 7, src = MODE == CHAIN_K4 && r == A ? VALUE_ROW : r;
            *reinterpret_cast<uint4*>(p.ws + p.off_dh + wc0 + r * p.ws_cols + x * 8) =
                *reinterpret_cast<const uint4*>(dhb + src * LDH + x * 8);
        }
        for (int l = 0; l < L; ++l)
            copy_out((const bf16*)(smem + p.sm_h[l]), p.hidden[l], p.ws + p.off_dp[l] + wc0,
                     p.ws_cols, tid, A_THREADS);
    }
    if (tid >= 32 * A_WARPS) cp_wait<0>();
    __syncthreads();
    float* part = p.partial + (size_t)blockIdx.x * p.stride;
    for (int i = tid; i < p.bias_total; i += A_THREADS) {
        const int r = i - hidden_total;
        const float v = bgrad[split_head(MODE) && r == A ? hidden_total + VALUE_ROW : i];
        part[i] = p.first ? v : __fadd_rn(part[i], v);
    }
    if (tid < 4)
        part[p.bias_total + tid] =
            p.first ? lacc[tid] : __fadd_rn(part[p.bias_total + tid], lacc[tid]);
    if (MODE == CHAIN_P3)
        for (int i = tid; i < p.hidden[L - 1]; i += A_THREADS) {
            const float v = ((const float*)(smem + p.sm_dwv))[i];
            float* dst = part + p.bias_total + 4 + i;
            *dst = p.first ? v : __fadd_rn(*dst, v);
        }
}

// ------------------------------------------------- kernel A, the host --
// Kernel A's shared memory and the ring's plan: the deepest slices that fit
// three stages, else two stages of 32.  The products (pa.prod[0..np)) and
// pa's widths are set; this sets the sm_* offsets, the slices and the stage
// size, and returns the kernel (nullptr if nothing fits) and its bytes.
// BB picks the instance with the bf16 backward chain (the same plan).
typedef void (*ChainKernel)(const ParamsA);

template <int MODE, bool BB = false>
int plan_chain(ParamsA& pa, int np, ChainKernel* kernel) {
    constexpr int HR = split_head(MODE) ? HEAD_SPLIT : HEAD_PAD;
    const int L = pa.L;
    int sm = 0;
    auto take = [&](int bytes) {
        const int at = sm;
        sm = align128(sm + bytes);
        return at;
    };
    pa.sm_x = MODE == CHAIN_INT8FWD ? 0 : take(pa.Fp * LDH * 2);
    for (int l = 0; l < L; ++l) pa.sm_h[l] = take(pa.hidden[l] * LDH * 2);
    const int dh_bytes = align128(HR * LDH * 2), z_bytes = HR * LDZ * 4;
    if (MODE == CHAIN_INT8FWD) {
        pa.sm_act[0] = take(COLS * pa.lda);
        pa.sm_act[1] = take(COLS * pa.lda);
    }
    if (MODE == CHAIN_INT8FWD && dh_bytes + z_bytes <= COLS * pa.lda) {
        // dheads and z live after the forward: in the act tile the head does
        // not read.
        pa.sm_dh = pa.sm_act[(L + 1) & 1];
        pa.sm_z = pa.sm_dh + dh_bytes;
    } else {
        pa.sm_dh = take(dh_bytes);
        pa.sm_z = take(z_bytes);
    }
    pa.sm_loss = take((4 * COLS + 4) * 4);
    pa.sm_bias = take((pa.bias_total - HEAD_PAD + HR) * 4);
    pa.sm_bgrad = take((pa.bias_total - HEAD_PAD + HR) * 4);
    pa.sm_rsum = take(256 * 4);
    if (MODE == CHAIN_P3) {
        pa.sm_wv = take(pa.hidden[L - 1] * 4);
        pa.sm_dwv = take(pa.hidden[L - 1] * 4);
    }
    pa.sm_ring = sm;
    const struct { int nst, ks; ChainKernel kernel; } plans[] = {
        {3, 64, chain_kernel<MODE, BB, 3, 64>}, {3, 32, chain_kernel<MODE, BB, 3, 32>},
        {2, 32, chain_kernel<MODE, BB, 2, 32>}};
    for (const auto& plan : plans) {
        int stage_bytes = 0;
        for (int i = 0; i < np; ++i) {
            const Prod& pr = pa.prod[i];
            stage_bytes = max(stage_bytes, pr.kind == W_FWD ? plan.ks * (pr.M + 8) * 2
                                           : pr.kind == W_DH ? pr.M * (plan.ks + 8) * 2
                                                             : pr.M * (2 * plan.ks + 16));
        }
        stage_bytes = align128(stage_bytes);
        if (sm + plan.nst * stage_bytes > SMEM_LIMIT) continue;
        int slice = 0;
        for (int i = 0; i < np; ++i) {
            Prod& pr = pa.prod[i];
            const int depth = pr.kind == W_FWD8 ? 2 * plan.ks : plan.ks;
            pr.slice0 = slice;
            pr.slices = (pr.K + depth - 1) / depth;
            slice += pr.slices;
        }
        pa.slices_per_tile = slice;
        pa.stage_elems = stage_bytes / 2;
        *kernel = plan.kernel;
        return sm + plan.nst * stage_bytes;
    }
    *kernel = nullptr;
    return 0;
}

// ----------------------------------------------------------- kernel B --
// dW (M x N) += A (M x cols) . B (N x cols)^T, both operands with the
// columns contiguous (row stride ws_cols), or A from obs (from_obs).
struct ProdB {
    const bf16* a;
    const bf16* b;
    int a_rows, M, N, off, from_obs;
};

struct TileB {
    int prod, m0, n0;
};

struct ParamsB {
    ProdB prod[MAX_LAYERS + 1];
    TileB tile[MAX_TILES];
    int ntiles, ranges, first;
    const bf16* obs;
    int F, N, Npad, t0, cols;
    long long ws_cols;
    float* partial;  // (ranges, stride): every dW, row-major, one after another
    int stride;
};

__device__ __forceinline__ void load_b(const ParamsB& p, const ProdB& pr, const TileB& t,
                                       bf16* as, bf16* bs, int gc0) {
    const int a_n = max(0, min(BT, pr.a_rows - t.m0)), b_n = min(BT, pr.N - t.n0);
    for (int c = threadIdx.x; c < (a_n + b_n) * 8; c += B_THREADS) {
        int r = c >> 3;
        const int x = c & 7;
        if (r < a_n) {
            bf16* dst = as + r * LDB + x * 8;
            if (pr.from_obs) {
                // A 64-column slice lies inside one frame (Npad % 64 == 0).
                const int fr = gc0 / p.Npad, col = gc0 - fr * p.Npad + x * 8;
                const bf16* src = p.obs + ((size_t)(p.t0 + fr) * p.F + t.m0 + r) * p.N + col;
                if ((p.N & 7) == 0 && col < p.N) {
                    cp_async16(dst, src);
                } else if ((p.N & 7) == 0) {
                    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        dst[e] = col + e < p.N ? src[e] : __float2bfloat16(0.0f);
                }
            } else {
                cp_async16(dst, pr.a + (size_t)(t.m0 + r) * p.ws_cols + gc0 + x * 8);
            }
        } else {
            r -= a_n;
            cp_async16(bs + r * LDB + x * 8, pr.b + (size_t)(t.n0 + r) * p.ws_cols + gc0 + x * 8);
        }
    }
}

__global__ void __launch_bounds__(B_THREADS) dw_kernel(const __grid_constant__ ParamsB p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* ring = (bf16*)smem;  // stages of [A slice (BT x LDB) | B slice (BT x LDB)]
    const int stage = 2 * BT * LDB;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tg = lane & 3;
    // Rows that are never loaded (past an operand's rows) stay zero.
    for (int i = tid; i < B_STAGES * stage / 8; i += B_THREADS)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const TileB t = p.tile[blockIdx.x % p.ntiles];
    const int range = blockIdx.x / p.ntiles;
    const ProdB& pr = p.prod[t.prod];
    const int slices = p.cols / KB;
    const int s0 = (int)((long long)slices * range / p.ranges);
    const int n = (int)((long long)slices * (range + 1) / p.ranges) - s0;
#pragma unroll
    for (int i = 0; i < B_STAGES - 1; ++i) {
        if (i < n) load_b(p, pr, t, ring + i * stage, ring + i * stage + BT * LDB, (s0 + i) * KB);
        cp_commit();
    }
    // Warp (wm, wn) owns rows m0 + wm*32 .. +32 and columns n0 + wn*64 .. +64.
    const int wm = warp >> 1, wn = warp & 1;
    const bool mv0 = t.m0 + wm * 32 < pr.M, mv1 = t.m0 + wm * 32 + 16 < pr.M;
    const int nb = max(0, min(8, (pr.N - t.n0 - wn * 64) / 8));
    float acc[2][8][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[a][j][i] = 0.0f;
    const int mi = lane >> 3, r8 = lane & 7;
    for (int s = 0; s < n; ++s) {
        cp_wait<B_STAGES - 2>();
        __syncthreads();
        if (s + B_STAGES - 1 < n) {
            bf16* st = ring + ((s + B_STAGES - 1) % B_STAGES) * stage;
            load_b(p, pr, t, st, st + BT * LDB, (s0 + s + B_STAGES - 1) * KB);
        }
        cp_commit();
        const bf16* as = ring + (s % B_STAGES) * stage;
        const bf16* bs = as + BT * LDB;
#pragma unroll
        for (int kk = 0; kk < KB; kk += 16) {
            uint32_t a0[4], a1[4];
            if (mv0) ldsm_x4(a0, as + (wm * 32 + (lane & 15)) * LDB + kk + (lane >> 4) * 8);
            if (mv1) ldsm_x4(a1, as + (wm * 32 + 16 + (lane & 15)) * LDB + kk + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 8; j += 2) {
                if (j < nb) {
                    uint32_t b[4];  // (n j, k +0), (n j, k +8), (n j+1, k +0), (n j+1, k +8)
                    ldsm_x4(b, bs + (wn * 64 + (j + (mi >> 1)) * 8 + r8) * LDB + kk + (mi & 1) * 8);
                    if (mv0) {
                        mma_add(acc[0][j], a0, b[0], b[1]);
                        mma_add(acc[0][j + 1], a0, b[2], b[3]);
                    }
                    if (mv1) {
                        mma_add(acc[1][j], a1, b[0], b[1]);
                        mma_add(acc[1][j + 1], a1, b[2], b[3]);
                    }
                }
            }
        }
    }
    cp_wait<0>();

    float* part = p.partial + (size_t)range * p.stride + pr.off;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        if (!(a == 0 ? mv0 : mv1)) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j >= nb) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = t.m0 + wm * 32 + a * 16 + g + 8 * hh;
                const int c = t.n0 + wn * 64 + j * 8 + 2 * tg;
                float2* dst = reinterpret_cast<float2*>(part + (size_t)r * pr.N + c);
                float2 v = make_float2(acc[a][j][2 * hh], acc[a][j][2 * hh + 1]);
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

// Kernel B's products for a chain's workspace: dW_l = below_l .
// bf16(dpre_l)^T (below_0 the observations from obs, or, with row_x >= 0,
// x^T from the workspace) and dWpv = bf16(h_top) . bf16(dheads)^T, every
// dW one after another (n_w floats: dW_0..dW_{L-1}, dWpv).  Returns false
// if the tiles do not fit.
inline bool plan_dw(ParamsB& pb, bf16* ws, long long ws_cols, const int* H, int L, int F, int Fp,
                    long long row_x, const long long* row_h, long long row_dh,
                    const long long* row_dp) {
    pb.ws_cols = ws_cols;
    int nt = 0, off = 0;
    for (int l = 0; l <= L; ++l) {
        ProdB& pr = pb.prod[l];
        const bool head = l == L;
        pr.from_obs = l == 0 && row_x < 0;
        pr.a = l == 0 ? (row_x < 0 ? nullptr : ws + row_x * ws_cols) : ws + row_h[l - 1] * ws_cols;
        pr.a_rows = l == 0 ? (row_x < 0 ? F : Fp) : H[l - 1];
        pr.M = l == 0 ? Fp : H[l - 1];
        pr.b = ws + (head ? row_dh : row_dp[l]) * ws_cols;
        pr.N = head ? HEAD_PAD : H[l];
        pr.off = off;
        off += pr.M * pr.N;
        for (int m0 = 0; m0 < pr.M; m0 += BT)
            for (int n0 = 0; n0 < pr.N; n0 += BT) {
                if (nt == MAX_TILES) return false;
                pb.tile[nt++] = {l, m0, n0};
            }
    }
    pb.ntiles = nt;
    pb.stride = off;
    return true;
}
