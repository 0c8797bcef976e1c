// Fused multi-frame rollout, hand-written for Hopper (sm_90a).
//
// Replaces pikazoo_tpu/core/fused_step.py::fused_rollout (the Pallas TPU
// kernel built by _make_kernel).  It advances every env `frames` whole
// frames in one launch, with the env's state held in registers: per frame,
// both seats' actions are sampled from the shared threefry PRF, decoded
// (decode_action_arith), and the env frame runs: lazy round / game reset
// with its draws, ball world, the rule AI with its landing simulations,
// player movement, collisions and scoring (envs/pika_volley.py::env_frame).
// The JAX modules are the authority; pikazoo_tpu/native/pika_engine.cc, a
// scalar transcription of the same frame, served as the starting text.
//
// Layout: the state is the (NFIELDS, B) int32 matrix of
// pikazoo_tpu_torch/core/fused_step.py::pack_state, one row per field in
// the order of enum Field (env_frame.cuh; the CPU tests parse it).  Keys, the
// draw counter's stream and the action keys are uint32 bit patterns in
// int32 rows; the threefry arithmetic and its remainders run on uint32.
//
// Design: one thread per env, 128 a block.  A thread loads its env's 56
// fields field-major, runs all frames with the state in registers, and
// stores the fields back in place.  HBM sees 224 bytes per env per call,
// whatever `frames` is: at B = 262144, 117 MB, some 35 us of the card's
// bandwidth.
//
// What bounds it: integer instructions and divergence, not bytes.  A frame
// is a few hundred integer operations (two threefry action draws of ~80,
// the physics, up to a few site draws), and with a computer seat the rule
// AI's landing loops: the true ball's every frame (up to 1000 iterations,
// typically tens), and, for an env whose computer seat is airborne near the
// ball, the 6 power-hit candidates'.  A warp runs until its slowest lane is
// done, so a lane running its env's loops in turn would make the warp pay,
// loop by loop, the longest of its 32 lanes, and hold 31 lanes idle while one
// searched its candidates.
//
// What the design does about it: the frame runs in three parts.  The front
// (action sampling and decode, the resets, ball_world) and the back (the AI's
// decisions, movement, collisions, scoring) run a lane an env.  Between them
// the warp pools its landing loops: each env posts its true ball, and an env
// whose computer seat asks for the candidates posts all 6, which both seats
// share (they depend only on the ball and k).  The 32 lanes then run the
// warp's job list one sim_step at a time, each idle lane taking the next job,
// and write the results to the warp's shared slice, where the back reads
// them.  The JAX kernel computes all 7 lanes every frame too; the accepted
// candidate and the draws are the same as the lazy search's, since a landing
// sim draws nothing.  The pool is warp-synchronous (full-mask ballots,
// __syncwarp where lanes hand each other shared memory; no block barrier).
// A counting instance of each AI build adds up the pool's work (enum Count)
// for chip_smoke.py and tools/k3_probe.py.  The frame and pool code lives in
// env_frame.cuh, which the learner's env step (learner_step.cu) shares.
//
// The computer flags are template parameters, so the human-only build holds
// no AI or landing code, as the static config prunes it in JAX
// (core/engine.py:53-61).  Winning score, serve mode and auto reset are
// runtime arguments.

#include <cstdint>

#include "env_frame.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace {

#if defined(__CUDACC__)

// Block size.  B is a multiple of 1024 (core/fused_step.py BLOCK_ENVS), so
// every block and every warp is full.  128 and 256 take the same time on the
// AI call at B = 65536; at 128 nvcc gives the human-only instance 80
// registers (112 at 256) and the random-action call at B = 262144 runs 7.5%
// faster (tools/k3_probe.py on an H100).
constexpr int kThreads = 128;
using Stream = cudaStream_t;

// One thread an env.  The thread loads its env's 56 fields field-major
// (field f of env e at f * n + e: a warp's 32 loads of one field are
// coalesced), runs every frame with them in registers and stores them back.
template <bool C1, bool C2, class Counts>
__global__ void __launch_bounds__(kThreads)
fused_rollout_kernel(int32_t* __restrict__ state, int32_t n, int32_t frames,
                     Config cfg, unsigned long long* counts_out) {
  __shared__ PoolSlice slices[kThreads / kWarp];
  const int64_t e = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  Lane l;
#pragma unroll
  for (int f = 0; f < NFIELDS; ++f) l.s[f] = state[f * int64_t(n) + e];
  l.job.vx = 0;
  Counts counts;
  DeviceWarp<Counts> w{l, int(threadIdx.x % kWarp), slices[threadIdx.x / kWarp],
                       counts};
  for (int32_t t = 0; t < frames; ++t)
    warp_frame<C1, C2>(w, cfg, SampledActions{});
  // The stores' base goes through an empty asm, so nvcc computes their 56
  // addresses here and does not keep the loads' live across the frames
  // (that took 112 registers more: 210-226 a thread, or 128 with ~290
  // bytes of spills).
  int32_t* out = state + e;
  asm volatile("" : "+l"(out));
#pragma unroll
  for (int f = 0; f < NFIELDS; ++f) out[f * int64_t(n)] = l.s[f];
  counts.flush(counts_out);
}

template <bool C1, bool C2, class Counts>
int rollout(int32_t* state, int32_t n, int32_t frames, const Config& cfg,
            unsigned long long* counts, Stream stream) {
  if (n % kThreads != 0) return int(cudaErrorInvalidValue);
  fused_rollout_kernel<C1, C2, Counts><<<unsigned(n / kThreads), kThreads, 0,
                                         stream>>>(state, n, frames, cfg, counts);
  return int(cudaGetLastError());
}

using Counted = LaneCounts;
using Uncounted = NoCounts;

#else  // A host build of the same frame and pool code, which the CPU tests run.

using Stream = void*;

struct Counted {};
struct Uncounted {};

// Envs in groups of 32, each group on an emulated warp.
template <bool C1, bool C2, class>
int rollout(int32_t* state, int32_t n, int32_t frames, const Config& cfg,
            unsigned long long* counts, Stream) {
  if (n % kWarp != 0) return 1;
  int64_t local[kNumCounts] = {};
  HostWarp w;
  w.counts = local;
  for (int64_t base = 0; base < n; base += kWarp) {
    for (int i = 0; i < kWarp; ++i) {
      for (int f = 0; f < NFIELDS; ++f)
        w.lanes[i].s[f] = state[f * int64_t(n) + base + i];
      w.lanes[i].job.vx = 0;
    }
    for (int32_t t = 0; t < frames; ++t)
    warp_frame<C1, C2>(w, cfg, SampledActions{});
    for (int i = 0; i < kWarp; ++i)
      for (int f = 0; f < NFIELDS; ++f)
        state[f * int64_t(n) + base + i] = w.lanes[i].s[f];
  }
  if (counts)
    for (int c = 0; c < kNumCounts; ++c) counts[c] += local[c];
  return 0;
}

#endif

template <class Counts>
int rollout_any(int32_t* s, int32_t n, int32_t frames, const Config& cfg,
                bool c1, bool c2, unsigned long long* counts, Stream st) {
  if (c1 && c2) return rollout<true, true, Counts>(s, n, frames, cfg, counts, st);
  if (c1) return rollout<true, false, Counts>(s, n, frames, cfg, counts, st);
  if (c2) return rollout<false, true, Counts>(s, n, frames, cfg, counts, st);
  return rollout<false, false, Uncounted>(s, n, frames, cfg, counts, st);
}

}  // namespace

// The number of rows the kernel takes; the wrapper checks it against
// NFIELDS at load.
extern "C" int fused_step_nfields() { return NFIELDS; }

// Advances the (NFIELDS, n) int32 state in place by `frames` frames; n a
// multiple of the block size (128).  Launches on `stream` and returns
// cudaGetLastError(); never synchronises.
extern "C" int fused_rollout_launch(void* state, int32_t n, int32_t frames,
                                    int32_t winning_score, int32_t serve_mode,
                                    int32_t p1_computer, int32_t p2_computer,
                                    int32_t auto_reset, void* stream) {
  if (n <= 0 || frames <= 0) return 0;
  const Config cfg{winning_score, serve_mode, auto_reset != 0};
  return rollout_any<Uncounted>(static_cast<int32_t*>(state), n, frames, cfg,
                                p1_computer != 0, p2_computer != 0, nullptr,
                                static_cast<Stream>(stream));
}

// The same rollout by the counting instance, which also adds the landing
// pool's counts (enum Count, kNumCounts uint64 words) to `counts`.  Without
// a computer seat there is no pool and nothing is counted.
extern "C" int fused_rollout_count_launch(void* state, int32_t n, int32_t frames,
                                          int32_t winning_score,
                                          int32_t serve_mode,
                                          int32_t p1_computer,
                                          int32_t p2_computer,
                                          int32_t auto_reset, void* counts,
                                          void* stream) {
  if (n <= 0 || frames <= 0) return 0;
  const Config cfg{winning_score, serve_mode, auto_reset != 0};
  return rollout_any<Counted>(static_cast<int32_t*>(state), n, frames, cfg,
                              p1_computer != 0, p2_computer != 0,
                              static_cast<unsigned long long*>(counts),
                              static_cast<Stream>(stream));
}

// The number of counts the counting entry adds to.
extern "C" int fused_step_num_counts() { return kNumCounts; }

#if !defined(__CUDACC__)
// The host build's landing loop alone (landing_sim.cuh's sim, over
// sim_step), for the CPU tests.
extern "C" int32_t fused_step_host_sim(int32_t x, int32_t y, int32_t vx,
                                       int32_t vy, int32_t full_rule) {
  return pika::sim(x, y, vx, vy, full_rule != 0);
}
#endif
