// Device code shared by the clipped-PPO gradient kernels: the split design
// (k1_split.cuh: K1's modes, K4 and P3, and fused_update_int8.cu) and P2
// (fm_roofline.cu).  Each holds a tile of columns (K4: of rows) in shared
// memory with the batch on the fast axis, so the bias-gradient row sums, the
// per-column loss and the partials' block-order sum are the same code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ppo {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// int8 products on the tensor cores: d += a . b on mma.sync m16n8k32, s8 x s8
// -> s32 (exact sums).  Fragment layouts (PTX ISA): A rows g and g+8, k
// 4tg.. and 16+4tg..; B column g, the same k; C rows g (d0, d1) and g+8 (d2,
// d3), columns 2tg and 2tg+1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[r] += the sum of row r of a (rows x NCOL) f32 tile with row stride ld:
// a warp a row, each lane adding NCOL/32 columns, then a butterfly in a fixed
// order (deterministic).
template <int NCOL>
__device__ __forceinline__ void row_sums(const float* tile, int ld, int rows, float* acc) {
    static_assert(NCOL == 32 || NCOL == 64, "row_sums takes 32 or 64 columns");
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
        float s = tile[r * ld + lane];
        if (NCOL == 64) s += tile[r * ld + lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) acc[r] += s;
    }
}

// ---------------------------------------------------------------------------
// The clipped-PPO loss of one column and its gradient w.r.t. the heads.
// z[r * ld] is head row r before its bias (bias[r]): rows 0..A-1 the logits,
// row vrow the value.  Writes dlogits[0..A-1] and *dvalue (already scaled
// by the coefficients and 1/M) and returns the column's 4 loss terms.
struct LossTerms {
    float pol, val, ent, kl;
};

__device__ __forceinline__ LossTerms ppo_column(
    const float* z, int ld, const float* bias, int A, int vrow, int act, float lpo,
    float adv, float vold, float tgt, float clip, float neg_inv_m, float ent_scale,
    float val_scale, float* dlogits, float* dvalue) {
    float m = -INFINITY;
    for (int r = 0; r < A; ++r) m = fmaxf(m, z[r * ld] + bias[r]);
    float sumex = 0.0f;
    for (int r = 0; r < A; ++r) sumex += expf((z[r * ld] + bias[r]) - m);
    const float lse = logf(sumex) + m;
    const float value = z[vrow * ld] + bias[vrow];
    float plogp = 0.0f, lp_new = 0.0f;
    for (int r = 0; r < A; ++r) {
        const float zr = z[r * ld] + bias[r];
        const float logp = zr - lse;
        const float pr = expf(zr - m) / sumex;
        plogp += pr * logp;
        if (r == act) lp_new = logp;
    }
    const float entropy_row = -plogp;
    const float ratio = expf(lp_new - lpo);
    const float unclipped = ratio * adv;
    const float clipped = fminf(fmaxf(ratio, 1.0f - clip), 1.0f + clip) * adv;
    LossTerms out;
    out.pol = -fminf(unclipped, clipped);
    out.ent = entropy_row;
    const float vclip = vold + fminf(fmaxf(value - vold, -clip), clip);
    const float e1 = value - tgt, e2 = vclip - tgt;
    out.val = 0.5f * fmaxf(e1 * e1, e2 * e2);
    out.kl = (ratio - 1.0f) - logf(ratio);

    const float inside_r = (ratio > 1.0f - clip && ratio < 1.0f + clip) ? 1.0f : 0.0f;
    const float dmin = (unclipped <= clipped) ? adv : adv * inside_r;
    const float dlp = neg_inv_m * dmin * ratio;
    for (int r = 0; r < A; ++r) {
        const float zr = z[r * ld] + bias[r];
        const float logp = zr - lse;
        const float pr = expf(zr - m) / sumex;
        const float onehot = (r == act) ? 1.0f : 0.0f;
        dlogits[r] = dlp * (onehot - pr) + ent_scale * pr * (logp + entropy_row);
    }
    const float inside_v = (value - vold > -clip && value - vold < clip) ? 1.0f : 0.0f;
    *dvalue = val_scale * ((e1 * e1 >= e2 * e2) ? e1 : e2 * inside_v);
    return out;
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

inline int align128(int x) { return (x + 127) & ~127; }

}  // namespace ppo
