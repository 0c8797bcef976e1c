// The landing loop over flat lanes, one rule a launch (the compaction probe's
// kernel), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/compaction_probe.py:102 `flat_sims` (kernel
// body `_flat_kernel`, :96; pallas_call :112): `_sim_loop` of
// pikazoo_tpu/core/predict.py over n independent lanes (x, y, vx, vy) int32,
// every lane under the same net rule.  `full_rule` is a template parameter
// here, as it is a static argument there.  Python side and plain version:
// pikazoo_tpu_torch/tools/compaction_probe.py.
//
// What bounds it on this card: not bytes.  A lane reads 4 words and writes 1
// (20 bytes); the time is the loop's integer instructions (~28 an iteration,
// up to 1000 iterations) and warp divergence: a warp runs until its slowest
// lane has landed.
//
// What the design does about it.  One thread a lane, the state in
// registers, each thread leaving its own loop (pika::sim, the loop K2 runs;
// K3 runs its sim_step in a warp's pool).  The TPU kernel pads n to 1024-lane blocks with vx == 0 lanes, since
// a block runs until its slowest lane lands; here a warp of 32 lanes is that
// unit, and the tail is guarded instead of padded.  The probe measures
// whether ordering the lanes by their expected trip count (an ETA sort),
// which makes neighbouring lanes land together, is worth its sort on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "landing_sim.cuh"

namespace {

template <bool FULL_RULE>
__global__ void flat_sims_kernel(const int32_t* __restrict__ xs,
                                 const int32_t* __restrict__ ys,
                                 const int32_t* __restrict__ vxs,
                                 const int32_t* __restrict__ vys,
                                 int32_t* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = pika::sim(xs[i], ys[i], vxs[i], vys[i], FULL_RULE);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
extern "C" int flat_sims_launch(const void* x, const void* y, const void* vx,
                                const void* vy, void* out, int64_t n,
                                int full_rule, void* stream) {
  if (n <= 0) return int(cudaSuccess);
  constexpr int kThreads = 256;
  const unsigned blocks = unsigned((n + kThreads - 1) / kThreads);
  auto kernel = full_rule ? flat_sims_kernel<true> : flat_sims_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(vx), static_cast<const int32_t*>(vy),
      static_cast<int32_t*>(out), n);
  return int(cudaGetLastError());
}
