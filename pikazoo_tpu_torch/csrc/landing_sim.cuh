// The landing loop of the rule AI's forward simulation, shared by the
// landing kernel (landing.cu) and the fused rollout kernel (fused_step.cu),
// so the card has one landing loop.
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

// One landing loop (reference physics.py:655-685 / 850-870).  x is not
// advanced on the finishing iteration, so the x it returns is the landing x.
// full_rule: the true ball's net rule (strict y < 192 top band, side
// push-out below it); otherwise the candidates' flip-only "mistake" rule.
PIKA_HD int32_t sim(int32_t x, int32_t y, int32_t vx, int32_t vy,
                    bool full_rule) {
  if (vx == 0) return x;
  for (int32_t count = 1;; ++count) {
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
    if (y > kBallGroundY || count >= kLoopLimit) return x;
    x += vx;
    ++vy;
  }
}

// Power-hit candidate k (canonical order "A": |x_dir| = (k < 3),
// y_dir = k % 3 - 1) from a ball at (x, y) with y velocity vy: its landing
// x under the mistake rule (launch velocities as in predict.py:468-479).
PIKA_HD int32_t candidate_landing(int32_t k, int32_t x, int32_t y,
                                  int32_t vy) {
  const int32_t speed = (k < 3 ? 2 : 1) * 10;
  const int32_t vx = x < kHalfWidth ? speed : -speed;
  return sim(x, y, vx, iabs(vy) * (k % 3 - 1) * 2, false);
}

}  // namespace pika
