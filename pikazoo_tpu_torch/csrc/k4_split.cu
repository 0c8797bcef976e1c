// The clipped-PPO minibatch gradient, row-major (K4), for Hopper, on K1's
// split design.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:651
// `fused_ppo_grads` (kernel body `_kernel`, :58; pallas_call :719).  Python
// side: pikazoo_tpu_torch/train/fused_update.py (`fused_ppo_grads`, and the
// stage entries `k4_chain` / `k4_dw`), which also holds the plain versions
// the kernels are held against: `k4_chain_plain` (kernel A) and
// `k1_dw_plain` (kernel B, on the rows as one frame of columns).
//
// What it computes, for a minibatch of M rows (obs (M, F) bf16, per-row
// action / logp_old / value_old / adv / target): K1 bf16's gradient with
// three differences, each transcribed from the TPU kernel: the rows are
// row-major; the activation derivative is taken from the f32 activation
// (1 - h*h on h, not on its bf16 round); the policy and value heads are two
// products, so the backward's dh = dlogits_b . Wp^T + dvalue_b . Wv^T is
// summed in f32.
//
// What bounds it.  K1's work: ~1.9 TFLOP a full-width call (M = 4,194,304,
// hidden (256, 256)), 1.94 ms at the tensor cores' bf16 peak.  The
// one-kernel design this replaces read-modified-wrote every block's partial
// of every dW for every 32-row tile (it kept f32 activations beside bf16
// ones, so its tile was half K1's): 79 ms a call on an H100.
//
// What this design does about it: K1 bf16's two kernels.
// - Kernel A is k1_split.cuh's chain_kernel in its CHAIN_K4 mode: 64-row
//   tiles, each read as one contiguous block of 64 x F bf16 and transposed
//   in shared memory; the forward, the split head (48 rows, the value in
//   row 32), the loss and dheads, the backward chain down to dpre_0 with
//   the f32 derivative; it writes x^T, bf16(h_l), bf16(dheads) and
//   bf16(dpre_l) to a workspace in K1's [feature][column] layout, dheads in
//   K1's merged rows (the policy, then the value in row A).
// - Kernel B is K1's dw_kernel, unchanged: each dW as one long-K product
//   over the chunk's rows, dW_0 from the workspace's x^T.  The wrapper
//   splits the head's merged dW and bias grad into the policy's and the
//   value's.
// - The f32 activations.  Two layers of them at 64 columns (128 KB at
//   hidden (256, 256)) do not fit beside K1's tile and weight ring; a
//   recomputed pre-activation would cost a forward product a layer and two
//   live accumulator tiles (more registers than 640 threads have).  So each
//   compute thread writes the f32 values of its own forward outputs to a
//   per-block scratch in device memory (hkeep: 64 KB a layer and block,
//   rewritten every tile, so it stays in L2) and reads them back in the
//   backward, whose dh product for that layer gives it the same outputs.
//   relu's derivative is the same from the bf16 value and skips it.
// - Determinism: per-block partials, summed in block order; no atomics.
//
// Chunks.  The wrapper runs A and B over chunks of ~131072 rows (one K1
// frame's width: 289 MB of workspace at hidden (256, 256), 2,208 bytes a
// row); a chunk's rows are padded to a multiple of 64 in the workspace,
// where rows >= M hold dheads = dpre = 0 and x = 0.

#include "k1_split.cuh"

// ------------------------------------------------------------- launch --
// stages: 1 kernel A only (the workspace and the bias grads / loss sums),
// 2 kernel B only (the dW from a workspace kernel A filled), 3 both.  The
// workspace ws (ws_rows, ws_cols) bf16 holds, for one chunk of rows, x^T
// (Fp rows), bf16(h_0..h_{L-1}), bf16(dheads) (HEAD_PAD rows: the policy,
// then the value in row A), bf16(dpre_0..dpre_{L-1}); ws_cols >= the chunk
// padded to 64.  weights: W_0 (Fp, H_0) with zero rows past F, W_l
// (H_{l-1}, H_l), the split head (H_top, HEAD_SPLIT): the policy in columns
// 0..A-1, the value in VALUE_ROW; biases likewise (the head's HEAD_SPLIT).
// hkeep: (blocks_a, L, 16, 32 * A_WARPS) float2.  out: every dW and the
// bias grads in K1's order and merged head (fused_update_bf16.cu's out),
// then the 4 loss sums.
extern "C" int k4_launch(
    const void* obs, const void* action, const void* logp_old, const void* value_old,
    const void* adv, const void* target, const void* const* weights,
    const void* const* biases, const int* hidden, int num_layers, int obs_dim,
    int obs_dim_pad, int num_actions, int relu, long long rows, float clip_eps,
    float neg_inv_m, float ent_scale, float val_scale, void* ws, int ws_rows,
    long long ws_cols, long long chunk_rows, void* partial_a, int blocks_a, void* partial_b,
    int ranges, void* hkeep, void* out, void* stream, int stages) {
    const int L = num_layers;
    if (L < 1 || L > MAX_LAYERS || num_actions + 1 > HEAD_PAD || obs_dim > obs_dim_pad ||
        obs_dim_pad % 16 || rows < 1 || chunk_rows < 1 || chunk_rows > INT32_MAX - COLS ||
        (chunk_rows < rows && chunk_rows % COLS) || stages < 1 || stages > 3 || ranges < 1 ||
        blocks_a < 1 || ((stages & 1) && !relu && !hkeep) ||
        (reinterpret_cast<uintptr_t>(obs) & 15))
        return (int)cudaErrorInvalidValue;
    const long long chunk = chunk_rows < rows ? chunk_rows : rows;
    if (ws_cols < (chunk + COLS - 1) / COLS * COLS || ws_cols % 8) return (int)cudaErrorInvalidValue;
    int H[MAX_LAYERS], sumH = 0;
    for (int l = 0; l < L; ++l) {
        H[l] = hidden[l];
        if (H[l] <= 0 || H[l] % 16 || H[l] > 256) return (int)cudaErrorInvalidValue;
        sumH += H[l];
    }
    if (ws_rows != obs_dim_pad + 2 * sumH + HEAD_PAD) return (int)cudaErrorInvalidValue;
    const int h_top = H[L - 1];
    const int bias_total = sumH + HEAD_PAD;
    bf16* wsb = (bf16*)ws;
    long long row_h[MAX_LAYERS], row_dp[MAX_LAYERS], row = obs_dim_pad;
    for (int l = 0; l < L; ++l) { row_h[l] = row; row += H[l]; }
    const long long row_dh = row;
    row += HEAD_PAD;
    for (int l = 0; l < L; ++l) { row_dp[l] = row; row += H[l]; }
    const bf16* x = (const bf16*)obs;
    const int* act = (const int*)action;
    const float *lpo = (const float*)logp_old, *vold = (const float*)value_old;
    const float *adv_n = (const float*)adv, *tgt = (const float*)target;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;

    ParamsA pa = {};
    ChainKernel kernel_a = nullptr;
    int sm_a = 0;
    if (stages & 1) {
        pa.L = L;
        pa.F = obs_dim;
        pa.Fp = obs_dim_pad;
        pa.A = num_actions;
        pa.relu = relu;
        pa.t0 = 0;
        pa.frames = 1;
        pa.clip = clip_eps;
        pa.neg_inv_m = neg_inv_m;
        pa.ent_scale = ent_scale;
        pa.val_scale = val_scale;
        pa.ws = wsb;
        pa.ws_cols = ws_cols;
        pa.hkeep = (float2*)hkeep;
        pa.partial = (float*)partial_a;
        pa.stride = bias_total + 4;
        pa.bias_total = bias_total;
        pa.off_x = 0;
        for (int l = 0; l < L; ++l) {
            pa.hidden[l] = H[l];
            pa.off_h[l] = row_h[l] * ws_cols;
            pa.off_dp[l] = row_dp[l] * ws_cols;
        }
        pa.off_dh = row_dh * ws_cols;
        for (int l = 0; l <= L; ++l) pa.b[l] = (const float*)biases[l];
        // The tile's products in stream order: the forward (hidden, the
        // split head), the head's dh (K = 48: policy, policy, value), the
        // hidden dh products down to dh_0.
        int np = 0;
        auto add = [&](const void* w, int ldw, int M, int K, int kind) {
            Prod& pr = pa.prod[np++];
            pr.w = w;
            pr.ldw = ldw;
            pr.M = M;
            pr.K = K;
            pr.kind = kind;
        };
        for (int l = 0; l < L; ++l) add(weights[l], H[l], H[l], l ? H[l - 1] : obs_dim_pad, W_FWD);
        add(weights[L], HEAD_SPLIT, HEAD_SPLIT, h_top, W_FWD);
        add(weights[L], HEAD_SPLIT, h_top, HEAD_SPLIT, W_DH);
        for (int l = L - 1; l >= 1; --l) add(weights[l], H[l], H[l - 1], H[l], W_DH);
        sm_a = plan_chain<CHAIN_K4>(pa, np, &kernel_a);
        if (!kernel_a) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(kernel_a, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_a);
        if (err != cudaSuccess) return (int)err;
    }

    ParamsB pb = {};
    const int sm_b = B_STAGES * 2 * BT * LDB * 2;
    if (stages & 2) {
        pb.partial = (float*)partial_b;
        pb.ranges = ranges;
        if (!plan_dw(pb, wsb, ws_cols, H, L, obs_dim, obs_dim_pad, 0, row_h, row_dh, row_dp))
            return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_b);
        if (err != cudaSuccess) return (int)err;
    }
    int n_w = 0;  // every dW's floats
    for (int l = 0; l <= L; ++l) n_w += (l == 0 ? obs_dim_pad : H[l - 1]) * (l < L ? H[l] : HEAD_PAD);

    // A chunk of rows is one frame of n columns, the pointers offset to its
    // first row.
    for (long long r0 = 0; r0 < rows; r0 += chunk) {
        const int n = (int)(rows - r0 < chunk ? rows - r0 : chunk), npad = (n + COLS - 1) / COLS * COLS;
        if (stages & 1) {
            pa.obs = x + r0 * obs_dim;
            pa.action = act + r0;
            pa.logp_old = lpo + r0;
            pa.value_old = vold + r0;
            pa.adv = adv_n + r0;
            pa.target = tgt + r0;
            pa.N = n;
            pa.Npad = npad;
            pa.first = r0 == 0;
            kernel_a<<<blocks_a, A_THREADS, sm_a, s>>>(pa);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        if (stages & 2) {
            pb.t0 = 0;
            pb.cols = npad;
            pb.first = r0 == 0;
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
