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
// the order of enum Field below (the CPU tests parse this enum).  Keys, the
// draw counter's stream and the action keys are uint32 bit patterns in
// int32 rows; the threefry arithmetic and its remainders run on uint32.
//
// Design: one thread per env, 256 a block.  A thread loads its env's 56
// fields field-major (field f of env e at f * B + e, so a warp's 32 loads of
// one field are contiguous and coalesced), runs all frames with the state in
// registers, and stores the fields back in place.  HBM sees 224 bytes per env per call, whatever `frames` is:
// at B = 262144, 117 MB, some 35 us of the card's bandwidth.
//
// What bounds it: integer instructions and divergence, not bytes.  A frame
// is a few hundred integer operations (two threefry action draws of ~150,
// the physics, up to a few site draws), and with a computer seat every
// thread runs the true ball's landing loop each frame (up to 1000
// iterations, typically tens to a couple of hundred), plus, for a seat that
// may smash, up to 6 candidate loops in turn.  A warp pays the slowest of
// its 32 envs in each loop, where the landing kernel (landing.cu) spreads
// the 7 loops of an env over 7 threads.  The candidates are simulated
// lazily, in the AI's search order, stopping at the first accepted one; the
// JAX kernel computes all 7 lanes every frame.  The accepted candidate is
// the same either way, since every lane is a pure function of the ball.
// Spreading the loops over threads, or compacting live lanes, is later
// work.
//
// The computer flags are template parameters, so the human-only build holds
// no AI or landing code, as the static config prunes it in JAX
// (core/engine.py:53-61).  Winning score, serve mode and auto reset are
// runtime arguments.

#include <cstdint>

#include "landing_sim.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

namespace {

using pika::iabs;
using pika::kBallGroundY;
using pika::kBallRadius;
using pika::kGroundWidth;
using pika::kHalfWidth;
using pika::kNetPillarHalf;
using pika::kNetTopBottom;
using pika::kNetTopTop;

constexpr int32_t kPlayerHalf = 32;
constexpr int32_t kPlayerLength = 64;
constexpr int32_t kPlayerGroundY = 244;

// Rows of the packed state: PlayerState fields of player 1, of player 2,
// BallState fields, then the game fields (core/fused_step.py:48-54).
enum Field {
  P1_X, P1_Y, P1_Y_VELOCITY, P1_STATE, P1_FRAME_NUMBER,
  P1_NORMAL_STATUS_ARM_SWING_DIRECTION, P1_DELAY_BEFORE_NEXT_FRAME,
  P1_DIVING_DIRECTION, P1_LYING_DOWN_DURATION_LEFT,
  P1_IS_COLLISION_WITH_BALL_HAPPENED, P1_COMPUTER_BOLDNESS,
  P1_COMPUTER_WHERE_TO_STAND_BY, P1_IS_WINNER, P1_GAME_ENDED,
  P2_X, P2_Y, P2_Y_VELOCITY, P2_STATE, P2_FRAME_NUMBER,
  P2_NORMAL_STATUS_ARM_SWING_DIRECTION, P2_DELAY_BEFORE_NEXT_FRAME,
  P2_DIVING_DIRECTION, P2_LYING_DOWN_DURATION_LEFT,
  P2_IS_COLLISION_WITH_BALL_HAPPENED, P2_COMPUTER_BOLDNESS,
  P2_COMPUTER_WHERE_TO_STAND_BY, P2_IS_WINNER, P2_GAME_ENDED,
  BALL_X, BALL_Y, BALL_X_VELOCITY, BALL_Y_VELOCITY, BALL_PREVIOUS_X,
  BALL_PREVIOUS_Y, BALL_PREVIOUS_PREVIOUS_X, BALL_PREVIOUS_PREVIOUS_Y,
  BALL_IS_POWER_HIT, BALL_EXPECTED_LANDING_POINT_X, BALL_ROTATION,
  BALL_FINE_ROTATION, BALL_PUNCH_EFFECT_X, BALL_PUNCH_EFFECT_Y,
  BALL_PUNCH_EFFECT_RADIUS,
  LATCH1, LATCH2, SCORE1, SCORE2, IS_PLAYER2_SERVE, ROUND_ENDED, GAME_ENDED,
  STEP_COUNT, DRAW_COUNTER, RNG_LO, RNG_HI, AKEY_LO, AKEY_HI,
  NFIELDS
};

// Row of player 2's field = row of player 1's + kSeat.
constexpr int kSeat = P2_X - P1_X;

enum ServeMode { kServeWinner = 0, kServeAlternate = 1, kServeRandom = 2 };

struct Config {
  int32_t winning_score;
  int32_t serve_mode;
  bool auto_reset;
};

struct Input {
  int32_t xd, yd, power;
};

// Python floor division (core/ball.py: fine_rotation += x_velocity // 2);
// C's / truncates toward zero.
PIKA_HD int32_t fdiv(int32_t a, int32_t b) {
  const int32_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// ---- threefry2x32, 20 rounds (core/rng.py:51-75) ----

PIKA_HD uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

PIKA_HD void four_rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                         int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// First output word of threefry2x32 of counter (c0, c1) under key (k0, k1).
PIKA_HD uint32_t threefry2x32_first(uint32_t k0, uint32_t k1, uint32_t c0,
                                    uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  four_rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  four_rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  four_rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  four_rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  four_rounds(x0, x1, 13, 15, 26, 6);  x0 += k2;
  return x0;
}

constexpr uint32_t kSiteTag = 1;    // core/rng.py SITE_TAG
constexpr uint32_t kActionTag = 2;  // core/fused_step.py ACTION_TAG

// A consumed draw site (core/rng.py:96-105, :141-156): uniform in
// [0, upper) from slot DRAW_COUNTER of the env's stream; the counter
// advances.  Call it only where the draw is consumed.
PIKA_HD int32_t draw(int32_t* s, uint32_t upper) {
  const uint32_t bits = threefry2x32_first(
      uint32_t(s[RNG_LO]), uint32_t(s[RNG_HI]), uint32_t(s[DRAW_COUNTER]),
      kSiteTag);
  ++s[DRAW_COUNTER];
  return int32_t(bits % upper);
}

// Seat `seat`'s action at the env's cumulative step_count
// (core/fused_step.py:81-88).
PIKA_HD int32_t sample_action(const int32_t* s, uint32_t seat) {
  const uint32_t bits = threefry2x32_first(
      uint32_t(s[AKEY_LO]), uint32_t(s[AKEY_HI]), uint32_t(s[STEP_COUNT]),
      kActionTag + seat);
  return int32_t(bits % 18u);
}

// ---- action decode (core/input.py decode_action_arith) ----

constexpr int32_t kActXd[18] = {0, 0, 0, 1, -1, 0, 1, -1, 1,
                                -1, 0, 1, -1, 0, 1, -1, 1, -1};
constexpr int32_t kActYd[18] = {0, 0, -1, 0, 0, 1, -1, -1, 1,
                                1, -1, 0, 0, 1, -1, -1, 1, 1};
constexpr int32_t kActPower[18] = {0, 1, 0, 0, 0, 0, 0, 0, 0,
                                   0, 1, 1, 1, 1, 1, 1, 1, 1};

// Directions biased by +1, two bits an action: actions 0-15 in one word,
// 16-17 in another.
constexpr uint32_t pack2(const int32_t* table, int first, int count) {
  uint32_t word = 0;
  for (int a = 0; a < count; ++a)
    word |= uint32_t(table[first + a] + 1) << (2 * a);
  return word;
}

constexpr uint32_t pack1(const int32_t* table) {
  uint32_t word = 0;
  for (int a = 0; a < 18; ++a) word |= uint32_t(table[a]) << a;
  return word;
}

constexpr uint32_t kXdLo = pack2(kActXd, 0, 16), kXdHi = pack2(kActXd, 16, 2);
constexpr uint32_t kYdLo = pack2(kActYd, 0, 16), kYdHi = pack2(kActYd, 16, 2);
constexpr uint32_t kPowerBits = pack1(kActPower);

PIKA_HD int32_t unpack2(uint32_t lo, uint32_t hi, int32_t a) {
  const uint32_t bits = a < 16 ? lo >> (2 * a) : hi >> (2 * (a - 16));
  return int32_t(bits & 3u) - 1;
}

// Decodes action a (in [0, 18)) against the seat's latch; the latch takes
// the raw power key.
PIKA_HD Input decode_action(int32_t a, int32_t& latch) {
  const int32_t power_key = int32_t((kPowerBits >> a) & 1u);
  Input in{unpack2(kXdLo, kXdHi, a), unpack2(kYdLo, kYdHi, a),
           (latch == 0 && power_key == 1) ? 1 : 0};
  latch = power_key;
  return in;
}

// ---- round init (core/state.py round_init_player / round_init_ball) ----

template <bool P2>
PIKA_HD void round_init_player(int32_t* s, int32_t boldness) {
  constexpr int o = P2 ? kSeat : 0;
  s[P1_X + o] = P2 ? kGroundWidth - 36 : 36;
  s[P1_Y + o] = kPlayerGroundY;
  s[P1_Y_VELOCITY + o] = 0;
  s[P1_IS_COLLISION_WITH_BALL_HAPPENED + o] = 0;
  s[P1_STATE + o] = 0;
  s[P1_FRAME_NUMBER + o] = 0;
  s[P1_NORMAL_STATUS_ARM_SWING_DIRECTION + o] = 1;
  s[P1_DELAY_BEFORE_NEXT_FRAME + o] = 0;
  s[P1_COMPUTER_BOLDNESS + o] = boldness;
}

PIKA_HD void round_init_ball(int32_t* s, bool player2_serves) {
  s[BALL_X] = player2_serves ? kGroundWidth - 56 : 56;
  s[BALL_Y] = 0;
  s[BALL_X_VELOCITY] = 0;
  s[BALL_Y_VELOCITY] = 1;
  s[BALL_PUNCH_EFFECT_RADIUS] = 0;
  s[BALL_IS_POWER_HIT] = 0;
}

// ---- ball world (core/ball.py) ----

// Returns touched_ground.
PIKA_HD bool ball_world(int32_t* s) {
  const int32_t x = s[BALL_X], y = s[BALL_Y];
  int32_t vx = s[BALL_X_VELOCITY], vy = s[BALL_Y_VELOCITY];

  int32_t fr = s[BALL_FINE_ROTATION] + fdiv(vx, 2);
  if (fr < 0) fr += 50; else if (fr > 50) fr -= 50;
  s[BALL_FINE_ROTATION] = fr;
  s[BALL_ROTATION] = fdiv(fr, 10);

  const int32_t future_x = x + vx;
  if (future_x < kBallRadius || future_x > kGroundWidth) vx = -vx;
  if (y + vy < 0) vy = 1;
  if (iabs(x - kHalfWidth) < kNetPillarHalf && y > kNetTopTop) {
    if (y <= kNetTopBottom) {
      if (vy > 0) vy = -vy;
    } else {
      vx = (x < kHalfWidth) ? -iabs(vx) : iabs(vx);
    }
  }

  s[BALL_PREVIOUS_PREVIOUS_X] = s[BALL_PREVIOUS_X];
  s[BALL_PREVIOUS_PREVIOUS_Y] = s[BALL_PREVIOUS_Y];
  s[BALL_PREVIOUS_X] = x;
  s[BALL_PREVIOUS_Y] = y;
  s[BALL_X_VELOCITY] = vx;
  const int32_t future_y = y + vy;
  if (future_y > kBallGroundY) {
    s[BALL_Y] = kBallGroundY;
    s[BALL_Y_VELOCITY] = -vy;
    s[BALL_PUNCH_EFFECT_X] = x;
    s[BALL_PUNCH_EFFECT_Y] = kBallGroundY + kBallRadius;
    s[BALL_PUNCH_EFFECT_RADIUS] = kBallRadius;
    return true;
  }
  s[BALL_X] = x + vx;
  s[BALL_Y] = future_y;
  s[BALL_Y_VELOCITY] = vy + 1;
  return false;
}

// ---- rule AI (core/ai.py) ----

// The first power-hit candidate, in the coin's order, whose landing x is on
// the far side and away from the other player; -1 if none is.  Order "A"
// (coin 0) is the canonical order; order "B" (coin 1) visits candidate
// p < 3 ? 2 - p : 8 - p at position p.
template <bool P2>
PIKA_HD int32_t first_accepted_candidate(const int32_t* s, int32_t coin) {
  constexpr int32_t lb = P2 ? kHalfWidth : 0;
  constexpr int32_t far_side = (P2 ? kGroundWidth : 0) + kHalfWidth;
  const int32_t other_x = s[P2 ? P1_X : P2_X];
  for (int32_t p = 0; p < 6; ++p) {
    const int32_t k = coin == 0 ? p : (p < 3 ? 2 - p : 8 - p);
    const int32_t land =
        pika::candidate_landing(k, s[BALL_X], s[BALL_Y], s[BALL_Y_VELOCITY]);
    if ((land <= lb || land >= far_side) &&
        iabs(land - other_x) > kPlayerLength)
      return k;
  }
  return -1;
}

// The computer's input for this frame; updates its where-to-stand-by and
// consumes its draws in the reference's order: the reposition coin (20)
// when not chasing, the stand-by draw (2) when that coin is 0, the smash
// coin (2) when airborne near the ball.
template <bool P2>
PIKA_HD Input computer_decide_input(int32_t* s) {
  constexpr int o = P2 ? kSeat : 0;
  constexpr int32_t lb = P2 ? kHalfWidth : 0;
  constexpr int32_t rb = P2 ? kGroundWidth : kHalfWidth;
  constexpr int32_t far_side = (P2 ? kGroundWidth : 0) + kHalfWidth;
  const int32_t px = s[P1_X + o], py = s[P1_Y + o];
  const int32_t bold = s[P1_COMPUTER_BOLDNESS + o];
  const int32_t state = s[P1_STATE + o];
  const int32_t bx = s[BALL_X], by = s[BALL_Y];
  const int32_t bvx = s[BALL_X_VELOCITY], bvy = s[BALL_Y_VELOCITY];
  const int32_t expected = s[BALL_EXPECTED_LANDING_POINT_X];
  const int32_t ball_dx = iabs(bx - px);
  const int32_t toward_ball = px < bx ? 1 : -1;

  int32_t virtual_expected = expected;
  if (ball_dx > 100 && iabs(bvx) < bold + 5 &&
      (expected <= lb || expected >= far_side) &&
      s[P1_COMPUTER_WHERE_TO_STAND_BY + o] == 0)
    virtual_expected = lb + kHalfWidth / 2;

  Input in{0, 0, 0};
  if (iabs(virtual_expected - px) > bold + 8) {
    in.xd = px < virtual_expected ? 1 : -1;
  } else if (draw(s, 20) == 0) {
    s[P1_COMPUTER_WHERE_TO_STAND_BY + o] = draw(s, 2);
  }

  if (state == 0) {
    if (iabs(bvx) < bold + 3 && ball_dx < kPlayerHalf && by > -36 &&
        by < 10 * bold + 84 && bvy > 0)
      in.yd = -1;
    if (expected > lb && expected < rb && ball_dx > bold * 5 + kPlayerLength &&
        bx > lb && bx < rb && by > 174) {
      in.power = 1;
      in.xd = toward_ball;
    }
  } else if (state == 1 || state == 2) {
    if (ball_dx > 8) in.xd = toward_ball;
    if (ball_dx < 48 && iabs(by - py) < 48) {
      const int32_t k = first_accepted_candidate<P2>(s, draw(s, 2));
      if (k >= 0) {
        in.xd = k < 3 ? 1 : 0;
        in.yd = k % 3 - 1;
        in.power = 1;
        const int32_t other_x = s[P2 ? P1_X : P2_X];
        if (iabs(other_x - px) < 80 && in.yd != -1) in.yd = -1;
      }
    }
  }
  return in;
}

// ---- player movement (core/player.py) ----

template <bool P2>
PIKA_HD void move_player(int32_t* s, const Input& in) {
  constexpr int o = P2 ? kSeat : 0;
  int32_t& state = s[P1_STATE + o];
  int32_t& frame = s[P1_FRAME_NUMBER + o];
  int32_t& delay = s[P1_DELAY_BEFORE_NEXT_FRAME + o];
  int32_t& yv = s[P1_Y_VELOCITY + o];
  int32_t& y = s[P1_Y + o];
  if (state == 4) {  // lying down: the reference returns early
    if (--s[P1_LYING_DOWN_DURATION_LEFT + o] < -1) state = 0;
    return;
  }
  int32_t vx = 0;
  if (state < 5) vx = state < 3 ? in.xd * 6 : s[P1_DIVING_DIRECTION + o] * 8;
  constexpr int32_t lo = P2 ? kHalfWidth + kPlayerHalf : kPlayerHalf;
  constexpr int32_t hi = P2 ? kGroundWidth - kPlayerHalf : kHalfWidth - kPlayerHalf;
  const int32_t future_x = s[P1_X + o] + vx;
  s[P1_X + o] = future_x < lo ? lo : (future_x > hi ? hi : future_x);

  if (state < 3 && in.yd == -1 && y == kPlayerGroundY) {  // jump
    yv = -16;
    state = 1;
    frame = 0;
  }
  const int32_t future_y = y + yv;
  y = future_y;
  if (future_y < kPlayerGroundY) {
    ++yv;
  } else if (future_y > kPlayerGroundY) {  // landing
    if (state == 3) s[P1_LYING_DOWN_DURATION_LEFT + o] = 3;
    yv = 0;
    y = kPlayerGroundY;
    frame = 0;
    state = state == 3 ? 4 : 0;
  }

  if (in.power == 1) {
    if (state == 1) {  // smash pose
      delay = 5;
      frame = 0;
      state = 2;
    } else if (state == 0 && in.xd != 0) {  // dive
      state = 3;
      frame = 0;
      s[P1_DIVING_DIRECTION + o] = in.xd;
      yv = -5;
    }
  }

  if (state == 1) {
    frame = (frame + 1) % 3;
  } else if (state == 2) {
    if (delay < 1) {
      if (++frame > 4) {
        frame = 0;
        state = 1;
      }
    } else {
      --delay;
    }
  } else if (state == 0) {
    if (++delay > 3) {
      delay = 0;
      int32_t& arm = s[P1_NORMAL_STATUS_ARM_SWING_DIRECTION + o];
      const int32_t future_frame = frame + arm;
      if (future_frame < 0 || future_frame > 4) arm = -arm;
      frame += arm;
    }
  }

  if (s[P1_GAME_ENDED + o] == 1) {  // win / lose poses
    if (state == 0) {
      state = s[P1_IS_WINNER + o] == 1 ? 5 : 6;
      delay = 0;
      frame = 0;
    }
    if (frame < 4 && ++delay > 4) {
      delay = 0;
      ++frame;
    }
  }
}

// ---- collision (core/collision.py) ----

template <bool P2>
PIKA_HD void collide(int32_t* s, const Input& in) {
  constexpr int o = P2 ? kSeat : 0;
  const int32_t px = s[P1_X + o];
  const bool overlap = iabs(s[BALL_X] - px) <= kPlayerHalf &&
                       iabs(s[BALL_Y] - s[P1_Y + o]) <= kPlayerHalf;
  if (overlap && s[P1_IS_COLLISION_WITH_BALL_HAPPENED + o] == 0) {
    const int32_t diff = s[BALL_X] - px;
    int32_t vx = s[BALL_X_VELOCITY];
    if (diff < 0) vx = -(iabs(diff) / 3);
    else if (diff > 0) vx = iabs(diff) / 3;
    if (vx == 0) vx = draw(s, 3) - 1;
    const int32_t abs_vy = iabs(s[BALL_Y_VELOCITY]);
    int32_t vy = abs_vy < 15 ? -15 : -abs_vy;
    const bool smash = s[P1_STATE + o] == 2;
    if (smash) {
      const int32_t speed = (iabs(in.xd) + 1) * 10;
      vx = s[BALL_X] < kHalfWidth ? speed : -speed;
      vy = iabs(vy) * in.yd * 2;
      s[BALL_PUNCH_EFFECT_X] = s[BALL_X];
      s[BALL_PUNCH_EFFECT_Y] = s[BALL_Y];
      s[BALL_PUNCH_EFFECT_RADIUS] = kBallRadius;
    }
    s[BALL_X_VELOCITY] = vx;
    s[BALL_Y_VELOCITY] = vy;
    s[BALL_IS_POWER_HIT] = smash ? 1 : 0;
  }
  s[P1_IS_COLLISION_WITH_BALL_HAPPENED + o] = overlap ? 1 : 0;
}

// ---- one frame (core/fused_step.py _fused_frame, envs/pika_volley.py
// env_frame, core/engine.py physics_step) ----

template <bool C1, bool C2>
PIKA_HD void fused_frame(int32_t* s, const Config& cfg) {
  // Both seats sample and decode; the latches follow the sampled actions
  // even for a computer seat, whose AI then replaces only the input.
  Input in1 = decode_action(sample_action(s, 0), s[LATCH1]);
  Input in2 = decode_action(sample_action(s, 1), s[LATCH2]);

  // Lazy round reset and auto game reset.
  const bool game_reset = cfg.auto_reset && s[GAME_ENDED] == 1;
  const bool do_init = (s[ROUND_ENDED] == 1 && s[GAME_ENDED] == 0) || game_reset;
  if (game_reset) {
    s[SCORE1] = 0;
    s[SCORE2] = 0;
    s[IS_PLAYER2_SERVE] = 0;
    s[GAME_ENDED] = 0;
    s[P1_IS_WINNER] = 0;
    s[P1_GAME_ENDED] = 0;
    s[P2_IS_WINNER] = 0;
    s[P2_GAME_ENDED] = 0;
  }
  if (do_init) {
    const int32_t bold1 = draw(s, 5);
    const int32_t bold2 = draw(s, 5);
    bool player2_serves;
    if (cfg.serve_mode == kServeWinner)
      player2_serves = s[IS_PLAYER2_SERVE] != 0;
    else if (cfg.serve_mode == kServeAlternate)
      player2_serves = (s[SCORE1] + s[SCORE2]) % 2 == 1;
    else
      player2_serves = draw(s, 2) == 0;
    round_init_player<false>(s, bold1);
    round_init_player<true>(s, bold2);
    round_init_ball(s, player2_serves);
    s[ROUND_ENDED] = 0;
  }

  const bool touched = ball_world(s);
  if (C1 || C2)
    s[BALL_EXPECTED_LANDING_POINT_X] = pika::sim(
        s[BALL_X], s[BALL_Y], s[BALL_X_VELOCITY], s[BALL_Y_VELOCITY], true);
  if (C1) in1 = computer_decide_input<false>(s);
  move_player<false>(s, in1);
  if (C2) in2 = computer_decide_input<true>(s);
  move_player<true>(s, in2);
  collide<false>(s, in1);
  collide<true>(s, in2);

  if (touched && s[ROUND_ENDED] == 0 && s[GAME_ENDED] == 0) {
    const bool p2_scored = s[BALL_PUNCH_EFFECT_X] < kHalfWidth;
    const int32_t score = p2_scored ? ++s[SCORE2] : ++s[SCORE1];
    s[IS_PLAYER2_SERVE] = p2_scored ? 1 : 0;
    if (score >= cfg.winning_score) {
      s[GAME_ENDED] = 1;
      s[P1_IS_WINNER] = p2_scored ? 0 : 1;
      s[P2_IS_WINNER] = p2_scored ? 1 : 0;
      s[P1_GAME_ENDED] = 1;
      s[P2_GAME_ENDED] = 1;
    }
    s[ROUND_ENDED] = 1;
  }
  ++s[STEP_COUNT];
}

template <bool C1, bool C2>
PIKA_HD void run_env(int32_t* state, int64_t n, int64_t e, int32_t frames,
                     const Config& cfg) {
  int32_t s[NFIELDS];
#pragma unroll
  for (int f = 0; f < NFIELDS; ++f) s[f] = state[f * n + e];
  for (int32_t t = 0; t < frames; ++t) fused_frame<C1, C2>(s, cfg);
#pragma unroll
  for (int f = 0; f < NFIELDS; ++f) state[f * n + e] = s[f];
}

#if defined(__CUDACC__)

constexpr int kThreads = 256;
using Stream = cudaStream_t;

template <bool C1, bool C2>
__global__ void __launch_bounds__(kThreads)
fused_rollout_kernel(int32_t* __restrict__ state, int32_t n, int32_t frames,
                     Config cfg) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n) run_env<C1, C2>(state, n, e, frames, cfg);
}

template <bool C1, bool C2>
int rollout(int32_t* state, int32_t n, int32_t frames, const Config& cfg,
            Stream stream) {
  const unsigned blocks = unsigned((n + kThreads - 1) / kThreads);
  fused_rollout_kernel<C1, C2><<<blocks, kThreads, 0, stream>>>(state, n,
                                                                frames, cfg);
  return int(cudaGetLastError());
}

#else  // A host build of the same frame code, which the CPU tests run.

using Stream = void*;

template <bool C1, bool C2>
int rollout(int32_t* state, int32_t n, int32_t frames, const Config& cfg,
            Stream) {
  for (int64_t e = 0; e < n; ++e) run_env<C1, C2>(state, n, e, frames, cfg);
  return 0;
}

#endif

}  // namespace

// The number of rows the kernel takes; the wrapper checks it against
// NFIELDS at load.
extern "C" int fused_step_nfields() { return NFIELDS; }

// Advances the (NFIELDS, n) int32 state in place by `frames` frames.
// Launches on `stream` and returns cudaGetLastError(); never synchronises.
extern "C" int fused_rollout_launch(void* state, int32_t n, int32_t frames,
                                    int32_t winning_score, int32_t serve_mode,
                                    int32_t p1_computer, int32_t p2_computer,
                                    int32_t auto_reset, void* stream) {
  if (n <= 0 || frames <= 0) return 0;
  const Config cfg{winning_score, serve_mode, auto_reset != 0};
  int32_t* s = static_cast<int32_t*>(state);
  const Stream st = static_cast<Stream>(stream);
  if (p1_computer && p2_computer) return rollout<true, true>(s, n, frames, cfg, st);
  if (p1_computer) return rollout<true, false>(s, n, frames, cfg, st);
  if (p2_computer) return rollout<false, true>(s, n, frames, cfg, st);
  return rollout<false, false>(s, n, frames, cfg, st);
}
