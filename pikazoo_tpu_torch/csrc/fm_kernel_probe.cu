// The feature-major PPO gradient prototype with split heads (P3), for Hopper
// (sm_90a), on the split design of K1.
//
// Replaces the TPU kernel tools/fm_kernel_probe.py:185 `fm_grads` (kernel
// body `_kernel`, :68; pallas_call :211).  Python side:
// pikazoo_tpu_torch/tools/fm_kernel_probe.py (`fm_grads`, and the stage
// entries `p3_chain` / `p3_dw`), which also holds the plain versions the
// kernels are held against: `p3_chain_plain` (kernel A) and K1's
// `k1_dw_plain` (kernel B).
//
// What it computes: the clipped-PPO gradient of a 2-layer tanh MLP over a
// minibatch of M = T*N columns (obs (T, F, N) bf16 feature-major, per-column
// action / logp_old / value_old / adv / target), with fixed coefficients
// from the caller, no action mask, and split heads.  It is K1's bf16 mode
// but for the value head, which differs in four places, each transcribed
// from the TPU kernel:
// - value = sum_h f32(bf16 Wv[h]) * f32(h2_b[h]) + bv, an f32 sum;
// - dh2 = Wp . bf16(dlogits) + f32(bf16 Wv) * dvalue, with dvalue in f32
//   (K1 rounds it to bf16 with the policy rows);
// - dWv = sum_c f32(h2_b) * dvalue and dbv = sum_c dvalue in f32;
// - dbp sums the f32 dlogits while dWp takes bf16(dlogits) (as K1).
// The activation derivative is 1 - h*h of the bf16 activation, as K1's.
// Loss sums [policy, value, entropy, kl].
//
// What bounds it: the tensor cores, as K1: ~457 kFLOP a column at F=35,
// H=256, A=18, ~1.9 TFLOP a full-width call (T=32, N=131072), ~1.94 ms at
// 989 TFLOP/s.  The one-kernel design this replaces (WMMA products, each
// block read-modify-writing its partial of every dW after every 64-column
// tile, ~45 GB of L2 traffic a call) took 46.053 ms on an H100.
//
// What this design does about it: K1 bf16's two kernels, as K4 runs them.
// - Kernel A is k1_split.cuh's chain_kernel in its CHAIN_P3 mode: K1 bf16's
//   64-column tiles, the split head of CHAIN_K4 (48 rows, the value in row
//   32), the value path above (dvalue kept f32 in the head's f32 block, its
//   f32 product added in the dh epilogue, dWv summed per block), the loss
//   and the backward chain down to dpre_1.  It writes bf16(h1), bf16(h2),
//   bf16(dlogits), bf16(dpre1), bf16(dpre2) to a workspace in K1's
//   [row][column] layout; the bias grads (dbp and dbv in K1's merged head
//   rows), the loss sums and dWv go to per-block partials.
// - Kernel B is K1's dw_kernel, unchanged: dW1 (from obs), dW2 and dWpv as
//   long-K products over the chunk's columns.  The workspace's dheads rows
//   hold bf16(dlogits) in rows 0..A-1 and zeros from row A, so dWpv's first
//   A columns are dWp and the value's column is zero: dWv is kernel A's.
// - Determinism: per-block partials, summed in block order; no atomics.
//
// Chunks.  The workspace is 2,112 bytes a column at hidden (256, 256); the
// wrapper runs A then B over chunks of whole frames of ~131072 columns (one
// frame at the tool's width).  A frame's columns are padded to a multiple
// of 64 in the workspace; columns >= N hold dheads = dpre = 0, so they add
// nothing to any dW (h = tanh(b) there is multiplied by zeros).
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.9): kernel A
// (chain_kernel<CHAIN_P3, ...>, 640 threads) 93 registers in each of its
// three plans, a 192-byte stack (ppo_column's per-column array), no spills;
// shared memory at hidden (256, 256), F=35: K4's plan with the feature-major
// x tile, plus Wv and dWv (1,024 B each): 110,080 B of tiles and sums and
// three 64-deep ring stages of 36,864 B, 220,672 B in all.  Kernel B is K1's
// (111 registers, no spills, 110,592 B).

#include "k1_split.cuh"

// ------------------------------------------------------------- launch --
// stages: 1 kernel A only (the workspace and the bias grads / loss sums /
// dWv), 2 kernel B only (the dW from a workspace kernel A filled), 3 both.
// weights: W1 (Fp, H1) with zero rows past F, W2 (H1, H2), the split head
// (H2, HEAD_SPLIT): Wp in columns 0..A-1, Wv in VALUE_ROW; biases b1, b2 and
// the split head's (HEAD_SPLIT): bp in 0..A-1, bv in VALUE_ROW; wv: f32(bf16
// Wv), H2 floats.  The workspace ws (ws_rows, ws_cols) bf16 holds, for one
// chunk of frames, the rows of bf16(h1), bf16(h2), bf16(dlogits) (HEAD_PAD
// rows), bf16(dpre1), bf16(dpre2), each frame's columns padded to Npad = 64
// * ceil(N / 64); ws_cols >= chunk_frames * Npad.  out: dW1 (Fp, H1), dW2
// (H1, H2), dWpv (H2, HEAD_PAD), then db1, db2, the head's bias grads in K1's
// merged rows (HEAD_PAD: dbp, then dbv in row A), the 4 loss sums, dWv (H2).
extern "C" int p3_launch(
    const void* obs, const void* action, const void* logp_old, const void* value_old,
    const void* adv, const void* target, const void* const* weights,
    const void* const* biases, const void* wv, int h1, int h2, int obs_dim, int obs_dim_pad,
    int num_actions, int frames, int cols, float clip_eps, float neg_inv_m, float ent_scale,
    float val_scale, void* ws, int ws_rows, long long ws_cols, int chunk_frames,
    void* partial_a, int blocks_a, void* partial_b, int ranges, void* out, void* stream,
    int stages) {
    constexpr int L = 2;
    const int H[L] = {h1, h2};
    if (num_actions < 1 || num_actions + 1 > HEAD_PAD || obs_dim > obs_dim_pad ||
        obs_dim_pad % 16 || frames < 1 || cols < 1 || chunk_frames < 1 || stages < 1 ||
        stages > 3 || ranges < 1 || blocks_a < 1 || h1 <= 0 || h1 % 16 || h1 > 256 ||
        h2 <= 0 || h2 % 16 || h2 > 256)
        return (int)cudaErrorInvalidValue;
    const int Npad = (cols + COLS - 1) / COLS * COLS;
    if (ws_cols < (long long)chunk_frames * Npad || ws_cols % 8 ||
        ws_rows != 2 * (h1 + h2) + HEAD_PAD)
        return (int)cudaErrorInvalidValue;
    const int bias_total = h1 + h2 + HEAD_PAD;
    bf16* wsb = (bf16*)ws;
    const long long row_h[L] = {0, h1}, row_dh = h1 + h2;
    const long long row_dp[L] = {row_dh + HEAD_PAD, row_dh + HEAD_PAD + h1};
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;

    ParamsA pa = {};
    ChainKernel kernel_a = nullptr;
    int sm_a = 0;
    if (stages & 1) {
        pa.obs = (const bf16*)obs;
        pa.action = (const int*)action;
        pa.logp_old = (const float*)logp_old;
        pa.value_old = (const float*)value_old;
        pa.adv = (const float*)adv;
        pa.target = (const float*)target;
        pa.wv = (const float*)wv;
        pa.L = L;
        pa.F = obs_dim;
        pa.Fp = obs_dim_pad;
        pa.A = num_actions;
        pa.relu = 0;
        pa.N = cols;
        pa.Npad = Npad;
        pa.clip = clip_eps;
        pa.neg_inv_m = neg_inv_m;
        pa.ent_scale = ent_scale;
        pa.val_scale = val_scale;
        pa.ws = wsb;
        pa.ws_cols = ws_cols;
        pa.partial = (float*)partial_a;
        pa.stride = bias_total + 4 + h2;
        pa.bias_total = bias_total;
        for (int l = 0; l < L; ++l) {
            pa.hidden[l] = H[l];
            pa.off_h[l] = row_h[l] * ws_cols;
            pa.off_dp[l] = row_dp[l] * ws_cols;
        }
        pa.off_dh = row_dh * ws_cols;
        for (int l = 0; l <= L; ++l) pa.b[l] = (const float*)biases[l];
        // The tile's products in stream order: the forward (W1, W2, the
        // split head), the head's dh over the policy rows (K = HEAD_PAD), W2's.
        int np = 0;
        auto add = [&](const void* w, int ldw, int M, int K, int kind) {
            Prod& pr = pa.prod[np++];
            pr.w = w;
            pr.ldw = ldw;
            pr.M = M;
            pr.K = K;
            pr.kind = kind;
        };
        add(weights[0], h1, h1, obs_dim_pad, W_FWD);
        add(weights[1], h2, h2, h1, W_FWD);
        add(weights[2], HEAD_SPLIT, HEAD_SPLIT, h2, W_FWD);
        add(weights[2], HEAD_SPLIT, h2, HEAD_PAD, W_DH);
        add(weights[1], h2, h1, h2, W_DH);
        sm_a = plan_chain<CHAIN_P3>(pa, np, &kernel_a);
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
        pb.partial = (float*)partial_b;
        pb.ranges = ranges;
        if (!plan_dw(pb, wsb, ws_cols, H, L, obs_dim, obs_dim_pad, -1, row_h, row_dh, row_dp))
            return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_b);
        if (err != cudaSuccess) return (int)err;
    }
    const int n_w = obs_dim_pad * h1 + h1 * h2 + h2 * HEAD_PAD;

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
        reduce_partials<<<(pa.stride + 255) / 256, 256, 0, s>>>(
            (const float*)partial_a, blocks_a, pa.stride, (float*)out + n_w);
    return (int)cudaGetLastError();
}
