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

// The event-leaping loop, laid out for Hopper's SIMT integer pipeline: one
// thread a lane, the state in registers, as the frame loop.  A jump is a
// closed-form advance over k iterations that provably hold no event (no
// wall reflection, ceiling clamp, net interaction or landing, and below the
// iteration cap); the exact iteration after it realises the event.  The
// families of spans and their safety argument are those of the JAX
// package's _make_leap_step (core/predict.py:160-318) and of the plain
// version (core/predict.py::make_leap_step), in int32.  What a jump spends
// is set by three choices:
//   * |vx| is loop-invariant (the wall and net rules only negate vx or take
//     |vx|), so the loop divides once, for a multiplier, and each span by
//     |vx| is one multiply-high (quot), with no range check in the loop;
//   * k_disp(avy, d), the y hazards' span, is non-decreasing in d, so the
//     min / max tree of the y spans is k_disp of one distance, and a span
//     that cannot lower the jump's other bounds is never rooted: at most one
//     root a jump, none when the wall, band entry or cap binds (leap_span);
//   * the net band's cases are selects, the root's one-step checks too.

// The largest y displacement k free-flight iterations can make from a y
// velocity of magnitude avy: k*avy + k(k+1)/2 (vy grows by one a frame).
PIKA_HD int32_t displacement(int32_t k, int32_t avy) {
  return k * avy + ((k * (k + 1)) >> 1);
}

// The box of (numerator, |vx|) in which quot's multiply-high is proven
// exact: n (|vx| - 1) < 2^31 there, and tests/test_torch_leap_sim.py checks
// every pair of it.
constexpr int32_t kQuotMax = 4095;

// A lane that starts with |x| and |vx| at most kLeapBox runs its loop on
// multiply-highs alone (FAST), with no division and no range check: x then
// stays within max(|x0|, 432) + |vx| (a wall reflection turns the ball back,
// or, from beyond a wall, out by one step and back; the net's push-out
// moves it |vx| from the band), so every numerator, at most |x| + 432, is
// in the box.  Any other lane's loop divides (the game's balls never do).
constexpr int32_t kLeapBox = 1800;

// Whether |v| <= r, for any int32 v (r > 0).
PIKA_HD bool within(int32_t v, int32_t r) {
  return uint32_t(v) + uint32_t(r) <= 2u * uint32_t(r);
}

PIKA_HD bool leap_fast(int32_t x, int32_t vx) {
  return within(x, kLeapBox) && within(vx, kLeapBox);
}

// The leap's int32 arithmetic holds for a lane that starts with |x|, |y|
// at most 2^28 and |vx|, |vy| at most 2^20: before its landing x stays
// within max(|x|, 432) + |vx|, y within [min(y, 0), max(y, 252)] and |vy|
// within |vy| + kLoopLimit (one a frame, or a jump over as many), so a
// jump of at most kLoopLimit frames moves x and y by less than 1.1e9 and
// k_disp's products stay below 3d + 2avy < 2^30.  A lane outside (no game
// ball is) runs the frame loop.
constexpr int32_t kLeapPos = 1 << 28;
constexpr int32_t kLeapVel = 1 << 20;

PIKA_HD bool leap_in_range(int32_t x, int32_t y, int32_t vx, int32_t vy) {
  return within(x, kLeapPos) && within(y, kLeapPos) && within(vx, kLeapVel) &&
         within(vy, kLeapVel);
}

// A live lane's loop invariant: the multiplier ceil(2^31 / |vx|).
struct LeapLane {
  uint32_t magic;
};

PIKA_HD LeapLane leap_lane(int32_t vx) {
  return {0x7fffffffu / uint32_t(iabs(vx)) + 1u};
}

#if !defined(__CUDA_ARCH__)
// Host-build checks for the CPU tests: the fast quotients taken outside the
// box (the tests hold it at 0), and a scale on the seed's square root that
// stands for the card's MUFU.RSQ within its error (1 by default).
inline int64_t host_quot_outside = 0;
inline float host_root_scale = 1.0f;
#endif

PIKA_HD uint32_t umulhi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return uint32_t((uint64_t(a) * b) >> 32);
#endif
}

// floor(n / avx) for n >= 0, avx = |vx|.  FAST: with m avx = 2^31 + e,
// 0 <= e < avx, floor(n m / 2^31) = floor(n / avx) whenever n e < 2^31.
template <bool FAST>
PIKA_HD int32_t quot(int32_t n, int32_t avx, const LeapLane& lane) {
  if constexpr (FAST) {
#if !defined(__CUDA_ARCH__)
    host_quot_outside += n > kQuotMax;
#endif
    return int32_t(umulhi(uint32_t(n) << 1, lane.magic));
  } else {
    return n / avx;
  }
}

// sqrt(s) for the root's seed, s >= 1: on the card one MUFU.RSQ (within
// 2 ulp; s is never denormal, so flushing them costs nothing) and a product.
PIKA_HD float seed_sqrt(float s) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return s * r;
#else
  return sqrtf(s) * host_root_scale;
#endif
}

// The box of (|vy|, distance) in which the root's seed is within one of the
// root: tests/test_torch_leap_sim.py checks every pair of it, with the
// seed's square root at both ends of an envelope four times the card's
// error (the seed is monotone in it).  The leap corpus's roots lie inside
// it.
constexpr int32_t kRootAvy = 8192;
constexpr int32_t kRootD = 16384;

// The root of k^2 + (2 avy + 1) k - 2d = 0 in float, truncated, at least 1.
PIKA_HD int32_t k_seed(int32_t avy, int32_t d) {
  const float b = float(2 * avy + 1);
  return imax(int32_t((seed_sqrt(fmaf(b, b, 8.0f * float(d))) - b) * 0.5f), 1);
}

// Largest k >= 0 with displacement(k, avy) <= d; 0 when d <= avy (k = 1
// needs avy + 1 <= d).  The seed is made exact by integer checks both ways,
// so no argument about float rounding is needed for the result (`steps`,
// when given, counts the checks' steps: [0] down, [1] up).  Every product
// stays below 3d + 2avy: int32 is enough for a lane in leap_in_range's
// range (the game's |y| and |vy| stay within a few thousand).
PIKA_HD int32_t k_disp(int32_t avy, int32_t d, int32_t* steps = nullptr) {
  if (d <= avy) return 0;
  int32_t k = k_seed(avy, d);
  while (k > 1 && displacement(k, avy) > d) {
    --k;
    if (steps) ++steps[0];
  }
  while (displacement(k + 1, avy) <= d) {
    ++k;
    if (steps) ++steps[1];
  }
  return k;
}

// k_disp inside the root's box, for avy < d: each check at most one step,
// as selects, with no loop.
PIKA_HD int32_t k_disp_in_box(int32_t avy, int32_t d) {
  int32_t k = k_seed(avy, d);
  k -= k > 1 && displacement(k, avy) > d;
  return k + (displacement(k + 1, avy) <= d);
}

constexpr int32_t kNever = 1 << 20;  // a distance no jump reaches

// A live lane's jump, before its root: the lane may advance
// k = min(cap, k_disp(|vy|, dist)) iterations with no event.  `cap` holds
// the x families (the wall, band entry, each a quotient by |vx|) and the
// iteration cap; `dist` the y families as one distance.
struct LeapBound {
  int32_t cap;
  int32_t dist;
};

// The bound of a live lane (vx != 0) at per-lane count c.  Each k_disp of
// the plain version becomes its distance: min(k_disp(a), k_disp(b)) =
// k_disp(min(a, b)), max likewise, and a count j enters as the distance
// displacement(j), since k_disp(displacement(j)) = j.  The count j <= -vy
// is clamped to the loop limit first: every jump is below it, so the clamp
// changes no k.  The net band's three rules are selects, not branches.
template <bool FAST>
PIKA_HD LeapBound leap_bound(int32_t x, int32_t y, int32_t vx, int32_t vy,
                             int32_t c, bool full_rule, const LeapLane& lane) {
  // x along the motion, u = x moving right and -x moving left (s = -1), so
  // that each x family is one difference and one comparison, its bounds
  // mirrored by s: u = -x puts the walls at -432 and -20.
  constexpr int32_t lo = kHalfWidth - kNetPillarHalf + 1;  // 192
  constexpr int32_t hi = kHalfWidth + kNetPillarHalf - 1;  // 240
  const int32_t s = vx >> 31;
  const int32_t u = (x ^ s) - s, avx = (vx ^ s) - s;
  const int32_t ahead = kGroundWidth + s * (kGroundWidth + kBallRadius);
  const int32_t behind = kBallRadius + s * (kGroundWidth + kBallRadius);
  const int32_t entry = lo + s * (lo + hi);
  // Wall: the first iteration j where x + (j+1) vx leaves [20, 432]; a ball
  // past the wall behind it is reflected at once.
  const int32_t k_wall = quot<FAST>(imax(ahead - u, 0), avx, lane);
  // Net: outside the x-band, the span to band entry (a ceiling division)
  // while the ball moves toward it; in the band, y / vy conditions.
  const int32_t k_entry = quot<FAST>(imax(entry - u, 1) - 1, avx, lane) + 1;
  int32_t cap = u + avx < behind ? 0 : k_wall;
  cap = u < entry ? imin(cap, k_entry) : cap;
  cap = imin(cap, imax(kLoopLimit - 1 - c, 0));
  const bool in_band = uint32_t(x - lo) <= uint32_t(hi - lo);
  const int32_t avy = iabs(vy);
  // Ground, and the ceiling: for vy >= 0 the test y + vy < 0 is immediate
  // or never; for vy < 0 the displacement bound keeps it quiet while it
  // stays within y.
  const int32_t d_ceil = vy >= 0 ? (y + vy < 0 ? -1 : kNever) : y;
  const int32_t d_y = imin(kBallGroundY - y, d_ceil);
  // In the band: above the top, quiet while the bound stays within 176 - y,
  // or while vy <= 0 (j <= -vy); the mistake rule needs one of the two.
  // The full rule below the top band: the side push-out is a no-op while
  // vx already points away from the net (or y stays at or beyond 192);
  // moving toward it, vy <= 0 must hold with y staying below 192.
  const int32_t d_vy = displacement(imin(imax(-vy, 0), kLoopLimit), avy);
  const bool away = x < kHalfWidth ? vx < 0 : vx > 0;
  const int32_t d_rule =
      !full_rule ? d_vy
      : away     ? imax(y - kNetTopBottom, d_vy)
                 : imin(kNetTopBottom - 1 - y, d_vy);
  const int32_t d_band = imax(kNetTopTop - y, d_rule);
  return {cap, in_band ? imin(d_y, d_band) : d_y};
}

// The bound's span: the cap when the y hazards allow it (no root), else
// the root of the distance, which is then below the cap.
PIKA_HD int32_t leap_span(const LeapBound& b, int32_t avy) {
  if (displacement(b.cap, avy) <= b.dist) return b.cap;
  if (b.dist <= avy) return 0;
  return avy < kRootAvy && b.dist < kRootD ? k_disp_in_box(avy, b.dist)
                                           : k_disp(avy, b.dist);
}

// One trip's jump: x += k vx, y += k vy + k(k-1)/2, vy += k, c += k, by
// exact integer products.
template <bool FAST>
PIKA_HD void leap_jump(int32_t& x, int32_t& y, int32_t vx, int32_t& vy,
                       int32_t& c, bool full_rule, const LeapLane& lane) {
  const LeapBound b = leap_bound<FAST>(x, y, vx, vy, c, full_rule, lane);
  const int32_t avy = iabs(vy);
  const int32_t k = leap_span(b, avy);
  x += k * vx;
  y += k * vy + ((k * (k - 1)) >> 1);
  vy += k;
  c += k;
}

// The event-leaping loop: leaps, each a jump and one exact iteration
// (sim_step with the lane's own count).  A thread leaves at its own
// landing, so the plain version's trips of `unroll` leaps would change
// nothing of a lane's work here: the loop has none.
template <bool FAST>
PIKA_HD int32_t leap_loop(int32_t x, int32_t y, int32_t vx, int32_t vy,
                          bool full_rule) {
  const LeapLane lane = FAST ? leap_lane(vx) : LeapLane{0};
  for (int32_t c = 0;;) {
    leap_jump<FAST>(x, y, vx, vy, c, full_rule, lane);
    if (sim_step(x, y, vx, vy, ++c, full_rule)) return x;
  }
}

// The hybrid loop's trips: one jump, then up to `unroll` exact iterations
// (the cheap frame loop through event-dense stretches).
template <bool FAST>
PIKA_HD int32_t hyb_loop(int32_t x, int32_t y, int32_t vx, int32_t vy,
                         bool full_rule, int32_t unroll) {
  const LeapLane lane = FAST ? leap_lane(vx) : LeapLane{0};
  for (int32_t c = 0;;) {
    leap_jump<FAST>(x, y, vx, vy, c, full_rule, lane);
    for (int32_t u = 0; u < unroll; ++u) {
      if (sim_step(x, y, vx, vy, ++c, full_rule)) return x;
    }
  }
}

// The event-leaping and hybrid loops of a lane (`unroll` read by the
// hybrid alone; below 1 it counts as 1).  A finished lane, and one outside
// leap_in_range, take the frame loop.
PIKA_HD int32_t sim_leap(int32_t x, int32_t y, int32_t vx, int32_t vy,
                         bool full_rule) {
  if (vx == 0 || !leap_in_range(x, y, vx, vy)) {
    return sim(x, y, vx, vy, full_rule);
  }
  return leap_fast(x, vx) ? leap_loop<true>(x, y, vx, vy, full_rule)
                          : leap_loop<false>(x, y, vx, vy, full_rule);
}

PIKA_HD int32_t sim_hyb(int32_t x, int32_t y, int32_t vx, int32_t vy,
                        bool full_rule, int32_t unroll) {
  if (vx == 0 || !leap_in_range(x, y, vx, vy)) {
    return sim(x, y, vx, vy, full_rule);
  }
  unroll = imax(unroll, 1);
  return leap_fast(x, vx) ? hyb_loop<true>(x, y, vx, vy, full_rule, unroll)
                          : hyb_loop<false>(x, y, vx, vy, full_rule, unroll);
}

// The landing x under loop ALGO (a LandingAlgo); `unroll` as sim_hyb takes
// it, unread by the other loops.
template <int ALGO>
PIKA_HD int32_t sim_any(int32_t x, int32_t y, int32_t vx, int32_t vy,
                        bool full_rule, int32_t unroll) {
  if constexpr (ALGO == kLeap) {
    return sim_leap(x, y, vx, vy, full_rule);
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
