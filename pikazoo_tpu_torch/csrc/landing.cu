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
//
// Modes: the kernel is templated on the true ball's loop and the
// candidates' (landing_sim.cuh's LandingAlgo): the frame loop (iter, the
// default and the env's), the event-leaping loop (leap: a closed-form jump
// over a span proven free of events, then one exact iteration), or the
// hybrid (hyb: a jump, then `unroll` exact iterations).  The leap cuts a
// warp's longest trajectory from its frames to its events; each trip costs
// more arithmetic, in int32 here, with the integer multiply the TPU's
// vector unit lacks (the JAX package's leap carried integer-valued float32
// for that reason).  The jump is laid out for the card (landing_sim.cuh):
// no division in the loop (a multiplier for |vx| computed once a lane), at
// most one square root, selects for the net band.  All modes give the frame
// loop's results bit for bit.  The JAX package's split="ydir" (three 2-lane
// candidate loops grouped by launch y-direction, so fast lanes stop paying
// for slow ones) is this same launch: the threads are lane-major, so every
// warp already holds envs of one candidate kind and every candidate runs
// its own loop, the finest grouping there is.

#include <cstdint>

#include "landing_sim.cuh"

namespace {

using pika::candidate_landing;
using pika::kHyb;
using pika::kIter;
using pika::kLeap;
using pika::sim_any;

// The default unroll of each loop, as the JAX kernel takes them
// (predict_pallas.py:58): leaps a trip (which the card's leap loop does not
// read), or exact iterations after a jump.
int32_t resolve_unroll(int32_t algo, int32_t unroll) {
  if (unroll > 0) return unroll;
  return algo == kHyb ? 32 : 1;
}

}  // namespace

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

template <int ALGO_TRUE, int ALGO_CAND>
__global__ void landing_kernel(const int32_t* __restrict__ xs,
                               const int32_t* __restrict__ ys,
                               const int32_t* __restrict__ vxs,
                               const int32_t* __restrict__ vys,
                               int32_t* __restrict__ expected,
                               int32_t* __restrict__ cand, int32_t n,
                               int32_t unroll_true, int32_t unroll_cand) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 7 * int64_t(n)) return;
  const int32_t lane = int32_t(t / n);
  const int32_t e = int32_t(t - int64_t(lane) * n);
  const int32_t x = xs[e], y = ys[e];
  if (lane == 0) {
    expected[e] = sim_any<ALGO_TRUE>(x, y, vxs[e], vys[e], true, unroll_true);
    return;
  }
  const int32_t k = lane - 1;
  cand[int64_t(k) * n + e] =
      candidate_landing<ALGO_CAND>(k, x, y, vys[e], unroll_cand);
}

template <int ALGO_TRUE>
using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, int32_t*, int32_t*, int32_t, int32_t,
                        int32_t);

template <int ALGO_TRUE>
Kernel<ALGO_TRUE> pick(int32_t algo_cand) {
  switch (algo_cand) {
    case kLeap: return landing_kernel<ALGO_TRUE, kLeap>;
    case kHyb: return landing_kernel<ALGO_TRUE, kHyb>;
    default: return landing_kernel<ALGO_TRUE, kIter>;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// algo_true / algo_cand: 0 iter, 1 leap, 2 hyb (anything else is refused
// with cudaErrorInvalidValue); unroll 0 takes each loop's default.
extern "C" int landing_sims_launch(const void* x, const void* y,
                                   const void* vx, const void* vy,
                                   void* expected, void* cand, int32_t n,
                                   int32_t algo_true, int32_t algo_cand,
                                   int32_t unroll, void* stream) {
  if (algo_true < kIter || algo_true > kHyb || algo_cand < kIter ||
      algo_cand > kHyb || unroll < 0) {
    return int(cudaErrorInvalidValue);
  }
  if (n <= 0) return int(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t total = 7 * int64_t(n);
  const unsigned blocks = unsigned((total + kThreads - 1) / kThreads);
  const auto args = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
        static_cast<const int32_t*>(vx), static_cast<const int32_t*>(vy),
        static_cast<int32_t*>(expected), static_cast<int32_t*>(cand), n,
        resolve_unroll(algo_true, unroll), resolve_unroll(algo_cand, unroll));
  };
  switch (algo_true) {
    case kLeap: args(pick<kLeap>(algo_cand)); break;
    case kHyb: args(pick<kHyb>(algo_cand)); break;
    default: args(pick<kIter>(algo_cand)); break;
  }
  return int(cudaGetLastError());
}

#else  // !__CUDACC__

namespace {

int32_t host_sim_algo(int32_t algo, int32_t x, int32_t y, int32_t vx,
                      int32_t vy, bool full_rule, int32_t unroll) {
  switch (algo) {
    case kLeap: return sim_any<kLeap>(x, y, vx, vy, full_rule, unroll);
    case kHyb: return sim_any<kHyb>(x, y, vx, vy, full_rule, unroll);
    default: return sim_any<kIter>(x, y, vx, vy, full_rule, unroll);
  }
}

}  // namespace

// The host build's counterpart of the kernel, for the CPU tests: the same
// device code (landing_sim.cuh) over the envs in a host loop, the same
// arguments and output layout.  Returns 0, or 1 for a refused argument.
extern "C" int landing_sims_host(const int32_t* x, const int32_t* y,
                                 const int32_t* vx, const int32_t* vy,
                                 int32_t n, int32_t algo_true,
                                 int32_t algo_cand, int32_t unroll,
                                 int32_t* expected, int32_t* cand) {
  if (algo_true < kIter || algo_true > kHyb || algo_cand < kIter ||
      algo_cand > kHyb || unroll < 0) {
    return 1;
  }
  const int32_t u_true = resolve_unroll(algo_true, unroll);
  const int32_t u_cand = resolve_unroll(algo_cand, unroll);
  for (int32_t e = 0; e < n; ++e) {
    expected[e] = host_sim_algo(algo_true, x[e], y[e], vx[e], vy[e], true,
                                u_true);
    for (int32_t k = 0; k < 6; ++k) {
      int32_t cvx, cvy;
      pika::candidate_velocity(k, x[e], vy[e], cvx, cvy);
      cand[int64_t(k) * n + e] =
          host_sim_algo(algo_cand, x[e], y[e], cvx, cvy, false, u_cand);
    }
  }
  return 0;
}

// The jump's primitives for the CPU tests, element by element: quot(num,
// vx) with vx's multiplier; k_disp(avy, d) with its check loops' steps
// (down, up), the seed's square root scaled by `scale`, and k_disp_in_box
// (for avy < d) likewise; a live lane's span at count c, in the loop its
// (x, vx) start would run.  And the count of fast quotients taken outside
// their box since the last call.
extern "C" void leap_quot_host(const int32_t* num, const int32_t* vx,
                               int32_t* q, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    q[i] = pika::quot<true>(num[i], pika::iabs(vx[i]), pika::leap_lane(vx[i]));
  }
}

extern "C" void k_disp_host(const int32_t* avy, const int32_t* d, float scale,
                            int32_t* k, int32_t* down, int32_t* up, int64_t n) {
  pika::host_root_scale = scale;
  for (int64_t i = 0; i < n; ++i) {
    int32_t steps[2] = {0, 0};
    k[i] = pika::k_disp(avy[i], d[i], steps);
    down[i] = steps[0];
    up[i] = steps[1];
  }
  pika::host_root_scale = 1.0f;
}

extern "C" void k_disp_in_box_host(const int32_t* avy, const int32_t* d,
                                   float scale, int32_t* k, int64_t n) {
  pika::host_root_scale = scale;
  for (int64_t i = 0; i < n; ++i) k[i] = pika::k_disp_in_box(avy[i], d[i]);
  pika::host_root_scale = 1.0f;
}

extern "C" void leap_span_host(const int32_t* x, const int32_t* y,
                               const int32_t* vx, const int32_t* vy,
                               const int32_t* c, int32_t full_rule,
                               int32_t* k, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const pika::LeapLane lane = pika::leap_lane(vx[i]);
    const pika::LeapBound b =
        pika::leap_fast(x[i], vx[i])
            ? pika::leap_bound<true>(x[i], y[i], vx[i], vy[i], c[i],
                                     full_rule != 0, lane)
            : pika::leap_bound<false>(x[i], y[i], vx[i], vy[i], c[i],
                                      full_rule != 0, lane);
    k[i] = pika::leap_span(b, pika::iabs(vy[i]));
  }
}

extern "C" int64_t leap_quot_outside_host() {
  const int64_t n = pika::host_quot_outside;
  pika::host_quot_outside = 0;
  return n;
}

#endif  // __CUDACC__
