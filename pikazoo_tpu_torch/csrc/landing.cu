// Batched landing simulation for the rule AI, hand-written for Hopper (sm_90a).
//
// Replaces pikazoo_tpu/core/predict_pallas.py::landing_sims_batched (the
// Pallas TPU kernel _landing_kernel).  Per env, from the ball (x, y, vx, vy):
//   expected[e]      the true ball's landing x under the full net rule
//                    (strict y < 192 top band, side push-out below it);
//   cand[k * n + e]  power-hit candidate k's landing x under the flip-only
//                    "mistake" net rule, k in canonical order "A":
//                    |x_dir| = (k < 3), y_dir = k % 3 - 1.
// The candidates are written lane-major, (6, n); the Python wrapper hands
// them out as the (n, 6) view the JAX package returns.
//
// What bounds it on this card: not bytes.  An env reads 4 words and writes
// 7 (44 bytes), so B = 65536 moves under 3 MB.  The time is the loop's
// integer instructions (~25 a frame, up to 1000 frames, typically tens to a
// couple of hundred) and warp divergence: a warp runs until its slowest lane
// has landed.
//
// What the design does about it:
//   * One thread per (lane, env), 7n threads, lane-major: a warp holds 32
//     envs of ONE lane kind, so it pays the max over 32 trajectories of the
//     same rule instead of a 1024-env block's max (the TPU kernel's tax),
//     and the short candidate loops never wait for the true ball's long
//     net-band tail.  One thread per env running all 7 loops in turn would
//     serialise them and make every warp pay the sum of its lanes' maxima.
//   * The whole state stays in registers; each thread exits its own loop.
//   * vx == 0 is the finished encoding, as in the plain version: a lane that
//     starts with vx == 0 (the net-top trap) returns its x at once.
// Faster loops (lane compaction, the closed-form "leap" loop, which integer
// multiply and divide make cheap here) are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "landing_sim.cuh"

namespace {

using pika::candidate_landing;
using pika::sim;

__global__ void landing_kernel(const int32_t* __restrict__ xs,
                               const int32_t* __restrict__ ys,
                               const int32_t* __restrict__ vxs,
                               const int32_t* __restrict__ vys,
                               int32_t* __restrict__ expected,
                               int32_t* __restrict__ cand, int32_t n) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 7 * int64_t(n)) return;
  const int32_t lane = int32_t(t / n);
  const int32_t e = int32_t(t - int64_t(lane) * n);
  const int32_t x = xs[e], y = ys[e];
  if (lane == 0) {
    expected[e] = sim(x, y, vxs[e], vys[e], true);
    return;
  }
  const int32_t k = lane - 1;
  cand[int64_t(k) * n + e] = candidate_landing(k, x, y, vys[e]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
extern "C" int landing_sims_launch(const void* x, const void* y,
                                   const void* vx, const void* vy,
                                   void* expected, void* cand, int32_t n,
                                   void* stream) {
  if (n <= 0) return int(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t total = 7 * int64_t(n);
  const unsigned blocks = unsigned((total + kThreads - 1) / kThreads);
  landing_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(vx), static_cast<const int32_t*>(vy),
      static_cast<int32_t*>(expected), static_cast<int32_t*>(cand), n);
  return int(cudaGetLastError());
}
