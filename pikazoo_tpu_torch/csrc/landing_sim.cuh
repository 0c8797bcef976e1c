// The landing loop of the rule AI's forward simulation, shared by the
// landing kernel (landing.cu), the flat-lane probe kernel (flat_sims.cu) and
// the fused rollout kernel (fused_step.cu), so the card has one landing
// iteration: sim runs it to the end in one thread, fused_step.cu's warp pool
// one step at a time.
//
// PIKA_HD marks the functions that the kernels call.  Under nvcc it is
// __host__ __device__, so the same text also compiles as plain C++ (the CPU
// tests build fused_step.cu for the host with a C++ compiler and hold its
// frame code against the plain PyTorch version).

#pragma once

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
// the mistake rule.
PIKA_HD int32_t candidate_landing(int32_t k, int32_t x, int32_t y,
                                  int32_t vy) {
  int32_t cvx, cvy;
  candidate_velocity(k, x, vy, cvx, cvy);
  return sim(x, y, cvx, cvy, false);
}

}  // namespace pika
