// K1's split design, shared by its bf16 mode (fused_update_bf16.cu) and its
// int8 mode (fused_update_int8.cu): the PTX helpers of both, and kernel B
// of the bf16 mode (dw_kernel), which computes bf16 dW products as long-K
// products over a workspace's columns.  The int8 mode runs it for the
// head's dW.  Its design is described in fused_update_bf16.cu.

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
