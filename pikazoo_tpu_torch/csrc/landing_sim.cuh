// The landing loop of the rule AI's forward simulation, shared by the
// landing kernel (landing.cu), the flat-lane probe kernel (flat_sims.cu) and
// the fused rollout kernel (fused_step.cu), so the card has one landing
// iteration: sim runs it to the end in one thread, fused_step.cu's warp pool
// one step at a time.  Beside the frame loop, the event-leaping loop
// (sim_leap) and the hybrid loop (sim_hyb) that landing.cu's modes run: both
// give the frame loop's landing x, bit for bit.
//
// PIKA_HD marks the functions that the kernels call.  Under nvcc it is
// __host__ __device__, so the same text also compiles as plain C++ (the CPU
// tests build fused_step.cu for the host with a C++ compiler and hold its
// frame code against the plain PyTorch version).

#pragma once

#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#define PIKA_HD __host__ __device__ __forceinline__
#else
#define PIKA_HD inline
#endif

namespace pika {

constexpr int32_t kBallRadius = 20;
constexpr int32_t kGroundWidth = 432;
constexpr int32_t kHalfWidth = 216;
constexpr int32_t kNetPillarHalf = 25;
constexpr int32_t kNetTopTop = 176;
constexpr int32_t kNetTopBottom = 192;
constexpr int32_t kBallGroundY = 252;
constexpr int32_t kLoopLimit = 1000;

PIKA_HD int32_t iabs(int32_t v) { return v < 0 ? -v : v; }

// One iteration of the landing loop (reference physics.py:655-685 /
// 850-870), the count-th, counting from 1, of a live lane (vx != 0).
// full_rule: the true ball's net rule (strict y < 192 top band, side
// push-out below it); otherwise the candidates' flip-only "mistake" rule.
// Returns true on the finishing iteration: the ball below the ground, or the
// iteration cap.  x is then not advanced, so it is the landing x, and vx
// becomes 0, the finished encoding of core/predict.py (a live lane's vx never
// becomes 0: the wall and net rules only negate it or take |vx|).
PIKA_HD bool sim_step(int32_t& x, int32_t& y, int32_t& vx, int32_t& vy,
                      int32_t count, bool full_rule) {
  const int32_t fx = x + vx;
  if (fx < kBallRadius || fx > kGroundWidth) vx = -vx;
  if (y + vy < 0) vy = 1;
  if (iabs(x - kHalfWidth) < kNetPillarHalf && y > kNetTopTop) {
    if (!full_rule || y < kNetTopBottom) {
      if (vy > 0) vy = -vy;
    } else {
      vx = (x < kHalfWidth) ? -iabs(vx) : iabs(vx);
    }
  }
  y += vy;
  if (y > kBallGroundY || count >= kLoopLimit) {
    vx = 0;
    return true;
  }
  x += vx;
  ++vy;
  return false;
}

// One whole landing loop: the landing x.  A lane that starts with vx == 0
// (the net-top trap) has finished where it is.
PIKA_HD int32_t sim(int32_t x, int32_t y, int32_t vx, int32_t vy,
                    bool full_rule) {
  if (vx == 0) return x;
  for (int32_t count = 1; !sim_step(x, y, vx, vy, count, full_rule); ++count) {
  }
  return x;
}

// The landing loops: the frame loop (sim), the event-leaping loop
// (sim_leap) and the hybrid loop (sim_hyb); the codes of landing.cu's modes.
enum LandingAlgo : int32_t { kIter = 0, kLeap = 1, kHyb = 2 };

PIKA_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
PIKA_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// The largest y displacement k free-flight iterations can make from a y
// velocity of magnitude avy: k*avy + k(k+1)/2 (vy grows by one a frame).
PIKA_HD int32_t displacement(int32_t k, int32_t avy) {
  return k * avy + ((k * (k + 1)) >> 1);
}

// Largest k >= 0 with displacement(k, avy) <= d; 0 when d <= avy (k = 1
// needs avy + 1 <= d).  The root of k^2 + (2 avy + 1) k - 2d = 0 is seeded
// in float (b * b passes 2^24 for |vy| above ~2000, so it is rounded) and
// then made exact by integer checks both ways, so no argument about float
// rounding is needed and the span is the longest the bound proves quiet.
// Every product stays below 3d + 2avy: int32 is enough while |y| and |vy|
// stay below 2^28 (the game's stay within a few thousand).
PIKA_HD int32_t k_disp(int32_t avy, int32_t d) {
  if (d <= avy) return 0;
  const float b = float(2 * avy + 1);
  int32_t k = int32_t((sqrtf(b * b + 8.0f * float(d)) - b) * 0.5f);
  if (k < 1) k = 1;
  while (k > 1 && displacement(k, avy) > d) --k;
  while (displacement(k + 1, avy) <= d) ++k;
  return k;
}

constexpr int32_t kNever = 1 << 20;  // a span longer than the iteration cap

// The number of iterations a live lane (vx != 0) at per-lane count c can
// advance in closed form with no event: no wall reflection, ceiling clamp,
// net interaction or landing, and below the iteration cap.  The families
// and their safety argument are those of the JAX package's
// _make_leap_step (core/predict.py:160-318) and of the plain version
// (core/predict.py::make_leap_step), in int32: the wall and band-entry
// spans are exact integer quotients, the y hazards use k_disp, and a
// quiet-OR of two conditions takes the larger of their spans (each alone
// proves quietness).  An underestimate only costs a trip.
PIKA_HD int32_t leap_span(int32_t x, int32_t y, int32_t vx, int32_t vy,
                          int32_t c, bool full_rule) {
  const bool pos = vx > 0;
  const int32_t avx = iabs(vx), avy = iabs(vy);
  // Wall: the first iteration j where x + (j+1) vx leaves [20, 432].
  const int32_t fx = x + vx;
  const int32_t k_wall =
      (pos ? fx < kBallRadius : fx > kGroundWidth)
          ? 0
          : imax(pos ? kGroundWidth - x : x - kBallRadius, 0) / avx;
  // Net: in the x-band quietness is a y / vy condition; outside it, the
  // span to band entry (a ceiling division) bounds the jump.
  constexpr int32_t lo = kHalfWidth - kNetPillarHalf + 1;  // 192
  constexpr int32_t hi = kHalfWidth + kNetPillarHalf - 1;  // 240
  int32_t k_band;
  if (x >= lo && x <= hi) {
    const int32_t k_vy = imax(-vy, 0);  // j <= -vy  =>  vy_j <= 0
    const int32_t k_176 = k_disp(avy, kNetTopTop - y);
    if (!full_rule) {
      k_band = imax(k_176, k_vy);
    } else if (x < kHalfWidth ? vx < 0 : vx > 0) {
      // Below the top band the side push-out is a no-op while vx already
      // points away from the net.
      k_band = imax(imax(k_176, k_vy), k_disp(avy, y - kNetTopBottom));
    } else {
      k_band = imax(k_176, imin(k_vy, k_disp(avy, kNetTopBottom - 1 - y)));
    }
  } else if (pos ? x < lo : x > hi) {
    k_band = (imax(pos ? lo - x : x - hi, 1) - 1) / avx + 1;
  } else {
    k_band = kNever;
  }
  // Ground, and the ceiling: for vy >= 0 the test y + vy < 0 is immediate
  // or never; for vy < 0 the displacement bound keeps it quiet while it
  // stays within y.
  const int32_t d_ceil = vy >= 0 ? (y + vy < 0 ? -1 : kNever) : y;
  const int32_t k_y = k_disp(avy, imin(kBallGroundY - y, d_ceil));
  return imin(imin(k_wall, k_band), imin(k_y, imax(kLoopLimit - 1 - c, 0)));
}

// The closed-form jump over leap_span's k iterations: x += k vx,
// y += k vy + k(k-1)/2, vy += k, c += k.  Exact integer products.
PIKA_HD void leap_jump(int32_t& x, int32_t& y, int32_t vx, int32_t& vy,
                       int32_t& c, bool full_rule) {
  const int32_t k = leap_span(x, y, vx, vy, c, full_rule);
  x += k * vx;
  y += k * vy + ((k * (k - 1)) >> 1);
  vy += k;
  c += k;
}

// One leap: a jump, then one exact iteration (sim_step with the lane's own
// count), which realises the event.  Returns true on the landing.
PIKA_HD bool leap_step(int32_t& x, int32_t& y, int32_t& vx, int32_t& vy,
                       int32_t& c, bool full_rule) {
  leap_jump(x, y, vx, vy, c, full_rule);
  return sim_step(x, y, vx, vy, ++c, full_rule);
}

// The event-leaping loop: trips of `unroll` leaps.  A thread leaves at its
// own landing, so on the card the trip's length changes nothing of a
// lane's work; it keeps the trips of the plain version's count.  An unroll
// below 1 counts as 1.
PIKA_HD int32_t sim_leap(int32_t x, int32_t y, int32_t vx, int32_t vy,
                         bool full_rule, int32_t unroll) {
  if (vx == 0) return x;
  unroll = imax(unroll, 1);
  for (int32_t c = 0;;) {
    for (int32_t u = 0; u < unroll; ++u) {
      if (leap_step(x, y, vx, vy, c, full_rule)) return x;
    }
  }
}

// The hybrid loop: each trip one jump, then up to `unroll` exact
// iterations (the cheap frame loop through event-dense stretches).  An
// unroll below 1 counts as 1.
PIKA_HD int32_t sim_hyb(int32_t x, int32_t y, int32_t vx, int32_t vy,
                        bool full_rule, int32_t unroll) {
  if (vx == 0) return x;
  unroll = imax(unroll, 1);
  for (int32_t c = 0;;) {
    leap_jump(x, y, vx, vy, c, full_rule);
    for (int32_t u = 0; u < unroll; ++u) {
      if (sim_step(x, y, vx, vy, ++c, full_rule)) return x;
    }
  }
}

// The landing x under loop ALGO (a LandingAlgo); `unroll` as sim_leap and
// sim_hyb take it, unread by the frame loop.
template <int ALGO>
PIKA_HD int32_t sim_any(int32_t x, int32_t y, int32_t vx, int32_t vy,
                        bool full_rule, int32_t unroll) {
  if constexpr (ALGO == kLeap) {
    return sim_leap(x, y, vx, vy, full_rule, unroll);
  } else if constexpr (ALGO == kHyb) {
    return sim_hyb(x, y, vx, vy, full_rule, unroll);
  } else {
    return sim(x, y, vx, vy, full_rule);
  }
}

// Power-hit candidate k's launch velocities (canonical order "A":
// |x_dir| = (k < 3), y_dir = k % 3 - 1) from a ball at x with y velocity vy
// (predict.py:468-479): toward the far side at (|x_dir| + 1) * 10, and
// |vy| * y_dir * 2.
PIKA_HD void candidate_velocity(int32_t k, int32_t x, int32_t vy,
                                int32_t& cvx, int32_t& cvy) {
  const int32_t speed = (k < 3 ? 2 : 1) * 10;
  cvx = x < kHalfWidth ? speed : -speed;
  cvy = iabs(vy) * (k % 3 - 1) * 2;
}

// Candidate k's landing x from a ball at (x, y) with y velocity vy, under
// the mistake rule and loop ALGO.
template <int ALGO = kIter>
PIKA_HD int32_t candidate_landing(int32_t k, int32_t x, int32_t y, int32_t vy,
                                  int32_t unroll = 0) {
  int32_t cvx, cvy;
  candidate_velocity(k, x, vy, cvx, cvy);
  return sim_any<ALGO>(x, y, cvx, cvy, false, unroll);
}

}  // namespace pika
