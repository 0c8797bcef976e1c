// K1's bf16 mode (quant="none") and int8fwd mode (quant="int8fwd"), each
// with or without the bf16 backward chain (bwd_bf16), for Hopper, as two
// kernels.
//
// Replaces the TPU kernel pikazoo_tpu/train/fused_update.py:504
// `fused_ppo_grads_fm` (kernel body `_fm_kernel`, :244; pallas_call :618) in
// these modes (its int8 mode is fused_update_int8.cu).  Python side: pikazoo_tpu_torch/train/fused_update.py (`fused_ppo_grads_fm`, and
// the stage entries `k1_chain` / `k1_dw`), which also holds the plain
// versions the kernels are held against: `k1_chain_plain` (kernel A) and
// `k1_dw_plain` (kernel B).  The rounding points are the function's: bf16
// operands in every product, f32 sums; bias add and activation in f32, one
// round to bf16; dpre and dheads rounded to bf16 for the products while the
// bias grads sum their f32 values.  int8fwd's forward takes int8 products
// and keeps bf16(h_f) for the same backward (chain_kernel, k1_split.cuh).
// bwd_bf16 runs the hidden chain's elementwise steps in bf16, op by op, the
// bias grads summing the rounded dpre (the JAX kernel's :451-466), and the
// head's dh product on the CUDA cores (fma_slice, k1_split.cuh); its dW
// operands are the same kinds, so kernel B serves it unchanged.
//
// What bounds it.  ~1.9 TFLOP a full-width call (T=32, N=131072, hidden
// (256, 256)): 1.94 ms at the tensor cores' bf16 peak.  The one-kernel design
// that preceded this one (PERF.md §6) ran at ~4% of that: each block
// read-modified-wrote a partial of every dW (86,016 floats) for every
// 64-column tile, ~45 GB of L2 traffic a call, and every warp loaded its
// weight fragments from L2 itself.
//
// What this design does about it: the dW products leave the tile loop.
// - Kernel A (chain_kernel, in k1_split.cuh with the rest of the split
//   design's device code, shared with K4) walks 64-column tiles: the
//   forward, the loss and dheads (ppo_column), and the backward chain down
//   to dpre_0, with the bias grads and loss sums held per block in shared
//   memory and written once.  It
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
// - At hidden (256, 256) in the bf16 mode (the flagship learner's update),
//   kernel A is k1_wgmma.cuh's wgmma_chain_kernel instead: the same
//   workspace, bias grads and loss sums, on wgmma and TMA with two ping-pong
//   consumer warpgroups (its note says how); chain_kernel serves every other
//   call.
// - Kernel B (dw_kernel, in k1_split.cuh, shared with the int8 mode and
//   K4) computes each dW as one long-K product over the chunk's columns: dW_l = below_l . bf16(dpre_l)^T (below_0 = x, read again
//   from obs), dWpv = bf16(h_top) . bf16(dheads)^T.  The grid is (column
//   range, 128 x 128 output tile) by blockIdx, tile-minor so that the blocks
//   of one column range run together and share its operands in L2; a block
//   keeps its tile in registers across its whole column range (8 warps of 32
//   x 64), streams 64-column operand slices through a 3-stage cp.async ring,
//   and writes its partial once a chunk.
// - The tensor cores' f32 accumulation does not round to nearest and drifts
//   toward zero over a long sum (PERF.md §6).  Every mma here sums 16
//   products into a fresh fragment, which the running sum takes with
//   __fadd_rn (k1_split.cuh's mma_add).
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
// Resources (nvcc -Xptxas -v, sm_90a).  Kernel A (chain_kernel): 640 threads, 96
// registers, no spills, a 128-byte stack (ppo_column's per-column array);
// shared memory at hidden (256, 256), F=35: x 6,912 B, h_0 and h_1 36,864
// each, dheads 4,608, the head's f32 block 9,216, loss 1,040, bias and bias
// grads 2 x 2,176, row-sum scratch 1,024, weight ring 3 x 36,864 (64-deep
// slices): 211,472 (one block an SM); at 4 layers of 256 the ring falls back
// to 2 stages of 32-deep slices.  Kernel B: 256 threads, 111 registers, no
// spills, 110,592 B of shared memory (two blocks an SM).
//
// Where the time goes (H100, full width, tools/k1_split_probe.py, on
// chain_kernel): kernel A ~70% of a call, kernel B ~30%.  In A, a third is
// neither the weight stream nor the mmas: tanh ~2 ms, the loss on two warps
// ~2.5 ms, the x load, copy-outs and barriers; the mmas and the stream the
// rest.  wgmma_chain_kernel's figures are in PERF.md §6.  Not done here
// (later work): kernel B on wgmma, its operands kept in L2 (a chunk small
// enough to stay there).

#include "k1_split.cuh"
#include "k1_wgmma.cuh"

// ------------------------------------------------------------- launch --
// stages: 1 kernel A only (the workspace and the bias grads / loss sums),
// 2 kernel B only (the dW from a workspace kernel A filled), 3 both.  The
// workspace ws (ws_rows, ws_cols) bf16 holds, for one chunk of frames, the
// rows of bf16(h_0..h_{L-1}), bf16(dheads) (32 rows), bf16(dpre_0..dpre_{L-1}),
// each frame's columns padded to Npad = 64 * ceil(N / 64); ws_cols >=
// chunk_frames * Npad.  out: every dW (n_w floats: dW_0..dW_{L-1}, dWpv,
// each row-major), then the bias grads and the 4 loss sums.  qweights: null
// in the bf16 mode; in int8fwd the int8 forward weights, W_l^T (H_l, kp_l)
// and the merged head's (HEAD_PAD, kp_L), kp the contraction padded to 32,
// with their L+1 scales sw (the bf16 weights then serve the backward only).
// bwd_bf16: kernel A with the bf16 backward chain.  wgmma: kernel A is
// k1_wgmma.cuh's wgmma_chain_kernel (the caller's choice, train/
// fused_update.py `chain_design`; refused where k1w::takes does not hold: the
// bf16 mode at hidden (256, 256)), else chain_kernel.
static int round32(int x) { return (x + 31) / 32 * 32; }

extern "C" int k1_bf16_launch(
    const void* obs, const void* action, const void* logp_old, const void* value_old,
    const void* adv, const void* target, const void* const* weights,
    const void* const* biases, const int* hidden, int num_layers, int obs_dim,
    int obs_dim_pad, int num_actions, int relu, int frames, int cols, float clip_eps,
    float neg_inv_m, float ent_scale, float val_scale, void* ws, int ws_rows,
    long long ws_cols, int chunk_frames, void* partial_a, int blocks_a, void* partial_b,
    int ranges, void* out, void* stream, int stages, const void* const* qweights,
    const void* sw, int bwd_bf16, int wgmma) {
    const int L = num_layers;
    const bool q8 = qweights != nullptr;
    if (L < 1 || L > MAX_LAYERS || num_actions + 1 > HEAD_PAD || obs_dim > obs_dim_pad ||
        obs_dim_pad % 16 || frames < 1 || cols < 1 || chunk_frames < 1 || stages < 1 ||
        stages > 3 || ranges < 1 || blocks_a < 1 || (q8 && (relu || !sw)))
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
    const int bias_total = sumH + HEAD_PAD;
    bf16* wsb = (bf16*)ws;
    long long row_h[MAX_LAYERS], row_dp[MAX_LAYERS], row = 0;
    for (int l = 0; l < L; ++l) { row_h[l] = row; row += H[l]; }
    const long long row_dh = row;
    row += HEAD_PAD;
    for (int l = 0; l < L; ++l) { row_dp[l] = row; row += H[l]; }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    const bool wg = wgmma != 0;
    if (wg && !k1w::takes(L, H, obs_dim_pad, num_actions, q8, bwd_bf16))
        return (int)cudaErrorInvalidValue;

    ParamsA pa = {};
    k1w::Params pw = {};
    ChainKernel kernel_a = nullptr;
    int sm_a = 0;
    if ((stages & 1) && wg) {
        if (!k1w::plan(pw, weights[0], obs_dim_pad, weights[1], weights[2], ws, ws_rows, ws_cols))
            return (int)cudaErrorInvalidValue;
        pw.obs = (const bf16*)obs;
        pw.action = (const int*)action;
        pw.logp_old = (const float*)logp_old;
        pw.value_old = (const float*)value_old;
        pw.adv = (const float*)adv;
        pw.target = (const float*)target;
        for (int l = 0; l <= L; ++l) pw.b[l] = (const float*)biases[l];
        pw.partial = (float*)partial_a;
        pw.F = obs_dim;
        pw.A = num_actions;
        pw.relu = relu;
        pw.N = cols;
        pw.Npad = Npad;
        pw.row_h0 = (int)row_h[0];
        pw.row_h1 = (int)row_h[1];
        pw.row_dh = (int)row_dh;
        pw.row_dp0 = (int)row_dp[0];
        pw.row_dp1 = (int)row_dp[1];
        pw.clip = clip_eps;
        pw.neg_inv_m = neg_inv_m;
        pw.ent_scale = ent_scale;
        pw.val_scale = val_scale;
        sm_a = k1w::SMEM;
        err = cudaFuncSetAttribute(k1w::wgmma_chain_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, sm_a);
        if (err != cudaSuccess) return (int)err;
    } else if (stages & 1) {
        pa.obs = (const bf16*)obs;
        pa.action = (const int*)action;
        pa.logp_old = (const float*)logp_old;
        pa.value_old = (const float*)value_old;
        pa.adv = (const float*)adv;
        pa.target = (const float*)target;
        pa.sw = (const float*)sw;
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
        auto add = [&](const void* w, int ldw, int M, int K, int kind) {
            Prod& pr = pa.prod[np++];
            pr.w = w;
            pr.ldw = ldw;
            pr.M = M;
            pr.K = K;
            pr.kind = kind;
        };
        if (q8) {
            for (int l = 0; l <= L; ++l) {
                const int kp = round32(l ? H[l - 1] : obs_dim_pad);
                add(qweights[l], kp, l < L ? H[l] : HEAD_PAD, kp, W_FWD8);
                pa.lda = max(pa.lda, kp + 16);
            }
        } else {
            for (int l = 0; l < L; ++l)
                add(weights[l], H[l], H[l], l ? H[l - 1] : obs_dim_pad, W_FWD);
            add(weights[L], HEAD_PAD, HEAD_PAD, h_top, W_FWD);
        }
        add(weights[L], HEAD_PAD, h_top, HEAD_PAD, W_DH);
        for (int l = L - 1; l >= 1; --l) add(weights[l], H[l], H[l - 1], H[l], W_DH);
        if (q8)
            sm_a = bwd_bf16 ? plan_chain<CHAIN_INT8FWD, true>(pa, np, &kernel_a)
                            : plan_chain<CHAIN_INT8FWD>(pa, np, &kernel_a);
        else
            sm_a = bwd_bf16 ? plan_chain<CHAIN_BF16, true>(pa, np, &kernel_a)
                            : plan_chain<CHAIN_BF16>(pa, np, &kernel_a);
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
    int n_w = 0;  // every dW's floats
    for (int l = 0; l <= L; ++l) n_w += (l == 0 ? obs_dim_pad : H[l - 1]) * (l < L ? H[l] : HEAD_PAD);

    for (int t0 = 0; t0 < frames; t0 += chunk_frames) {
        const int n_frames = min(chunk_frames, frames - t0);
        if ((stages & 1) && wg) {
            pw.t0 = t0;
            pw.frames = n_frames;
            pw.first = t0 == 0;
            k1w::wgmma_chain_kernel<<<blocks_a, k1w::THREADS, sm_a, s>>>(pw);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        } else if (stages & 1) {
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
