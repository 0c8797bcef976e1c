// The learner's env step, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package jits this step
// (pikazoo_tpu/envs/pika_volley.py::step_batch_learner_fm) and XLA fuses
// it.  Eager PyTorch ran it as ~1,380 ops a frame (envs/pika_volley.py:
// _advance, assemble_norm_obs_fm and the rewards' cat), each 10-16 us of
// host time to launch for ~1.7 us of device work, so the PPO rollout's frame
// waited on the host.  This kernel is the whole step in one launch.
//
// One thread an env reads the env's 54 state rows and both seats' actions,
// decodes the actions against the latches and runs K3's env frame
// (env_frame.cuh: the front, the warp's landing pool with a computer seat,
// the back), then writes the new state's 54 rows, both seats' normalised
// observations and both seats' rewards.  Only the action source differs
// from K3: the actions are given, not sampled.
//
// What bounds it: bytes.  At n = 65,536 it reads the state (14.2 MB) and
// the actions (0.5 MB) and writes the new state (14.2 MB), the (35, 2n)
// bf16 observations (9.2 MB) and the (2n,) float32 rewards (0.5 MB): 38.5
// MB, ~11.5 us at 3.35 TB/s.  One lane an env does one read and one write
// of each row, and a warp's 32 accesses of a row are coalesced.  A computer
// seat adds the landing pool's integer work, as in K3.
//
// Layout: each of the 54 rows, in and out, is a pointer and an element
// stride (Args), so the kernel reads an EnvState's leaves where they lie,
// with no pack, and writes the new state's leaves, views of one buffer that
// core/learner_step.py allocates.  Observation f of env e goes to obs[f * 2n
// + e] in seat 1's view and obs[f * 2n + n + e] in seat 2's (feature-major,
// seat-blocked columns); each is (float(c) - low) / span, an IEEE float32
// subtraction and division (no reciprocal), rounded once to bf16 to nearest
// even, as envs/observations.py::_norm_seats computes it.  Seat 1's reward
// is env_frame's +-1 on a scoring frame, seat 2's its float negation (-0.0
// where seat 1's is 0), as the eager step's cat gives them.
//
// Any n: blocks of 128 lanes, the last one masked.  A lane past the batch
// runs env n - 1's frame, since the warp's pool needs all 32 lanes, and
// stores nothing.

#include <cstdint>
#include <cstring>

#include "env_frame.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace {

// The EnvState's rows: every field but K3's two action-key rows.
constexpr int kRows = AKEY_LO;

// The launch's arguments.  Every member is 8 bytes, so the wrapper's ctypes
// array of int64 words lays it out alike (learner_step_args_bytes checks).
struct Args {
  const int32_t* in[kRows];  // row f of env e at in[f][e * in_stride[f]]
  int64_t in_stride[kRows];
  int32_t* out[kRows];
  int64_t out_stride[kRows];
  const int32_t* a1;  // (n,) int32 actions of seat 1 and seat 2
  const int32_t* a2;
  uint16_t* obs;      // (35, 2n) bf16 bits
  float* rewards;     // (2n,)
  int64_t n;
};

// JAX's gather index semantics (core/input.py clamp_action): a negative
// action counts from the end, then the index is clamped to [0, 17].
PIKA_HD int32_t clamp_action(int32_t a) {
  if (a < 0) a += 18;
  return a < 0 ? 0 : (a > 17 ? 17 : a);
}

// Env e's rows into s.  The action-key rows stay 0: they are not read.
PIKA_HD void load_env(int32_t* s, const Args& a, int64_t e) {
#pragma unroll
  for (int f = 0; f < kRows; ++f) s[f] = a.in[f][e * a.in_stride[f]];
  s[AKEY_LO] = 0;
  s[AKEY_HI] = 0;
}

// float32 to bf16 bits, rounded to nearest even (finite values: the
// observations are).
PIKA_HD uint16_t bf16_rne(float x) {
  uint32_t b;
#if defined(__CUDA_ARCH__)
  b = __float_as_uint(x);
#else
  std::memcpy(&b, &x, sizeof b);
#endif
  return uint16_t((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16);
}

// (float(c) - low) / span in IEEE float32 arithmetic, rounded once to bf16.
PIKA_HD uint16_t norm_bf16(int32_t c, int32_t low, int32_t high) {
#if defined(__CUDA_ARCH__)
  const float x = __fdiv_rn(__fsub_rn(__int2float_rn(c), float(low)),
                            float(high - low));
#else
  const float x = (float(c) - float(low)) / float(high - low);
#endif
  return bf16_rne(x);
}

// A player's 13 observation values (envs/observations.py _player_cols), its
// fields at offset o, each handed with its bounds (OBS_LOW, OBS_HIGH) to
// put(f0 + i, value, low, high).
template <class Put>
PIKA_HD void player_view(const int32_t* s, int o, int32_t latch, int f0,
                         const Put& put) {
  put(f0 + 0, s[P1_X + o], kPlayerHalf, kGroundWidth - kPlayerHalf);
  put(f0 + 1, s[P1_Y + o], 108, kPlayerGroundY);
  put(f0 + 2, s[P1_Y_VELOCITY + o], -15, 16);
  put(f0 + 3, s[P1_DIVING_DIRECTION + o], -1, 1);
  put(f0 + 4, s[P1_LYING_DOWN_DURATION_LEFT + o], -2, 3);
  put(f0 + 5, s[P1_FRAME_NUMBER + o], 0, 4);
  put(f0 + 6, s[P1_DELAY_BEFORE_NEXT_FRAME + o], 0, 4);
#pragma unroll
  for (int k = 0; k < 5; ++k) put(f0 + 7 + k, s[P1_STATE + o] == k ? 1 : 0, 0, 1);
  put(f0 + 12, latch, 0, 1);
}

// A seat's 35 observation values: its own player's 13, the other's 13, the
// ball's 9 (envs/observations.py _ball_cols).
template <class Put>
PIKA_HD void seat_view(const int32_t* s, bool p2, const Put& put) {
  player_view(s, p2 ? kSeat : 0, s[p2 ? LATCH2 : LATCH1], 0, put);
  player_view(s, p2 ? 0 : kSeat, s[p2 ? LATCH1 : LATCH2], 13, put);
  put(26, s[BALL_X], kBallRadius, kGroundWidth);
  put(27, s[BALL_Y], 0, kBallGroundY);
  put(28, s[BALL_PREVIOUS_X], 0, kGroundWidth);
  put(29, s[BALL_PREVIOUS_Y], 0, kBallGroundY);
  put(30, s[BALL_PREVIOUS_PREVIOUS_X], 0, kGroundWidth);
  put(31, s[BALL_PREVIOUS_PREVIOUS_Y], 0, kBallGroundY);
  put(32, s[BALL_X_VELOCITY], -20, 20);
  put(33, s[BALL_Y_VELOCITY], -124, 124);
  put(34, s[BALL_IS_POWER_HIT], 0, 1);
}

// Writes a seat's normalised values down its column.
struct PutObs {
  uint16_t* col;
  int64_t stride;
  PIKA_HD void operator()(int f, int32_t c, int32_t low, int32_t high) const {
    col[f * stride] = norm_bf16(c, low, high);
  }
};

// Env e's outputs after its frame: the new state's rows, both seats'
// observations and rewards.  game_ended_in: GAME_ENDED before the frame.
PIKA_HD void store_env(const int32_t* s, int32_t game_ended_in,
                       bool auto_reset, const Args& a, int64_t e) {
#pragma unroll
  for (int f = 0; f < kRows; ++f) a.out[f][e * a.out_stride[f]] = s[f];
  seat_view(s, false, PutObs{a.obs + e, 2 * a.n});
  seat_view(s, true, PutObs{a.obs + a.n + e, 2 * a.n});
  // env_frame's reward: +-1 for the server-to-be when the round ended in a
  // game that had not ended at the frame's entry (after an auto reset).
  const int32_t at_entry = (auto_reset && game_ended_in == 1) ? 0 : game_ended_in;
  const int32_t r = (s[ROUND_ENDED] == 1 && at_entry == 0)
                        ? (s[IS_PLAYER2_SERVE] == 1 ? -1 : 1) : 0;
  const float reward = float(r);
  a.rewards[e] = reward;
  a.rewards[a.n + e] = -reward;
}

#if defined(__CUDACC__)

constexpr int kThreads = 128;
using Stream = cudaStream_t;

// A thread's given actions, both seats' of its env.
struct GivenActions {
  int32_t a1, a2;
  __device__ __forceinline__ int32_t operator()(const Lane&, int,
                                                uint32_t seat) const {
    return seat == 0 ? a1 : a2;
  }
};

template <bool C1, bool C2>
__global__ void __launch_bounds__(kThreads)
learner_step_kernel(const Args a, Config cfg) {
  __shared__ PoolSlice slices[kThreads / kWarp];
  const int64_t e = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t src = e < a.n ? e : a.n - 1;
  Lane l;
  load_env(l.s, a, src);
  l.job.vx = 0;
  const int32_t game_ended_in = l.s[GAME_ENDED];
  const GivenActions actions{clamp_action(a.a1[src]), clamp_action(a.a2[src])};
  NoCounts counts;
  DeviceWarp<NoCounts> w{l, int(threadIdx.x % kWarp), slices[threadIdx.x / kWarp],
                         counts};
  warp_frame<C1, C2>(w, cfg, actions);
  if (e < a.n) store_env(l.s, game_ended_in, cfg.auto_reset, a, e);
}

template <bool C1, bool C2>
int step(const Args& a, const Config& cfg, Stream stream) {
  const unsigned blocks = unsigned((a.n + kThreads - 1) / kThreads);
  learner_step_kernel<C1, C2><<<blocks, kThreads, 0, stream>>>(a, cfg);
  return int(cudaGetLastError());
}

#else  // A host build of the same step, which the CPU tests run.

using Stream = void*;

// The given actions of an emulated warp's 32 lanes.
struct HostActions {
  const int32_t* a1;
  const int32_t* a2;
  int32_t operator()(const Lane&, int lane, uint32_t seat) const {
    return seat == 0 ? a1[lane] : a2[lane];
  }
};

// Envs in groups of 32, each group on an emulated warp; as on the card, a
// lane past the batch runs env n - 1's frame and stores nothing.  Returns 2
// if the pool wrote a landing result other than once.
template <bool C1, bool C2>
int step(const Args& a, const Config& cfg, Stream) {
  int64_t counts[kNumCounts] = {};
  HostWarp w;
  w.counts = counts;
  int32_t a1[kWarp], a2[kWarp], ended[kWarp];
  for (int64_t base = 0; base < a.n; base += kWarp) {
    for (int i = 0; i < kWarp; ++i) {
      const int64_t src = base + i < a.n ? base + i : a.n - 1;
      load_env(w.lanes[i].s, a, src);
      w.lanes[i].job.vx = 0;
      ended[i] = w.lanes[i].s[GAME_ENDED];
      a1[i] = clamp_action(a.a1[src]);
      a2[i] = clamp_action(a.a2[src]);
    }
    warp_frame<C1, C2>(w, cfg, HostActions{a1, a2});
    for (int i = 0; i < kWarp && base + i < a.n; ++i)
      store_env(w.lanes[i].s, ended[i], cfg.auto_reset, a, base + i);
  }
  return counts[kMisses] == 0 ? 0 : 2;
}

#endif

// Records each observation's bounds.
struct Bounds {
  int32_t* low;
  int32_t* high;
  PIKA_HD void operator()(int f, int32_t, int32_t lo, int32_t hi) const {
    low[f] = lo;
    high[f] = hi;
  }
};

}  // namespace

// The rows the kernel takes and the size of its arguments; the wrapper
// checks both at load.
extern "C" int learner_step_rows() { return kRows; }
extern "C" int learner_step_args_bytes() { return int(sizeof(Args)); }

// The 35 observations' bounds as the kernel normalises them; the wrapper
// checks them against OBS_LOW / OBS_HIGH at load.
extern "C" void learner_step_obs_bounds(int32_t* low, int32_t* high) {
  const int32_t s[NFIELDS] = {};
  seat_view(s, false, Bounds{low, high});
}

// One learner step of the n envs that `args` (an Args) describes, with the
// config's winning score, serve mode (enum ServeMode), computer seats and
// auto reset.  Launches on `stream` and returns cudaGetLastError(); never
// synchronises.  The host build steps on the calling thread.
extern "C" int learner_step_launch(const void* args, int32_t winning_score,
                                   int32_t serve_mode, int32_t p1_computer,
                                   int32_t p2_computer, int32_t auto_reset,
                                   void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.n <= 0) return 0;
  const Config cfg{winning_score, serve_mode, auto_reset != 0};
  const Stream st = static_cast<Stream>(stream);
  if (p1_computer && p2_computer) return step<true, true>(a, cfg, st);
  if (p1_computer) return step<true, false>(a, cfg, st);
  if (p2_computer) return step<false, true>(a, cfg, st);
  return step<false, false>(a, cfg, st);
}
