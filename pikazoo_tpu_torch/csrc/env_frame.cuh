// The env frame and the warp's landing pool, shared by the fused rollout
// (fused_step.cu, K3) and the learner's env step (learner_step.cu): the
// state fields of one env, the frame's front (actions decoded, resets,
// ball_world), the warp's landing pool, and its back (the rule AI's
// decisions, movement, collisions, scoring), all of it __host__ __device__
// (PIKA_HD), so that the CPU tests build each kernel's source for the host
// with a C++ compiler and hold its frame code against the plain PyTorch
// version.  The two kernels differ only in where a frame's actions come from
// (warp_frame's Actions): K3 samples them from each env's action key, the
// learner step is given them.  fused_step.cu's note gives the design.

#pragma once

#include <cstdint>

#include "landing_sim.cuh"


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

// Whether computer seat P2 asks for the power-hit candidates this frame: it
// is airborne within 48 px of the ball on both axes (computer_decide_input's
// smash branch).  It reads only the seat's own fields and the ball's, which
// the other seat's decision and move leave as they are, so the frame's front
// part can tell for both seats right after ball_world.
template <bool P2>
PIKA_HD bool asks_for_candidates(const int32_t* s) {
  constexpr int o = P2 ? kSeat : 0;
  const int32_t state = s[P1_STATE + o];
  return (state == 1 || state == 2) && iabs(s[BALL_X] - s[P1_X + o]) < 48 &&
         iabs(s[BALL_Y] - s[P1_Y + o]) < 48;
}

// The first power-hit candidate, in the coin's order, whose landing x
// (cand[k], computed by the warp's landing pool) is on the far side and away
// from the other player; -1 if none is.  Order "A" (coin 0) is the canonical
// order; order "B" (coin 1) visits candidate p < 3 ? 2 - p : 8 - p at
// position p.
template <bool P2>
PIKA_HD int32_t first_accepted_candidate(const int32_t* s, int32_t coin,
                                         const int32_t* cand) {
  constexpr int32_t lb = P2 ? kHalfWidth : 0;
  constexpr int32_t far_side = (P2 ? kGroundWidth : 0) + kHalfWidth;
  const int32_t other_x = s[P2 ? P1_X : P2_X];
  for (int32_t p = 0; p < 6; ++p) {
    const int32_t k = coin == 0 ? p : (p < 3 ? 2 - p : 8 - p);
    const int32_t land = cand[k];
    if ((land <= lb || land >= far_side) &&
        iabs(land - other_x) > kPlayerLength)
      return k;
  }
  return -1;
}

// The computer's input for this frame; updates its where-to-stand-by and
// consumes its draws in the reference's order: the reposition coin (20)
// when not chasing, the stand-by draw (2) when that coin is 0, the smash
// coin (2) when airborne near the ball.  cand: the 6 candidates' landing x.
template <bool P2>
PIKA_HD Input computer_decide_input(int32_t* s, const int32_t* cand) {
  constexpr int o = P2 ? kSeat : 0;
  constexpr int32_t lb = P2 ? kHalfWidth : 0;
  constexpr int32_t rb = P2 ? kGroundWidth : kHalfWidth;
  constexpr int32_t far_side = (P2 ? kGroundWidth : 0) + kHalfWidth;
  const int32_t px = s[P1_X + o];
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
    if (asks_for_candidates<P2>(s)) {
      const int32_t k = first_accepted_candidate<P2>(s, draw(s, 2), cand);
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
// env_frame, core/engine.py physics_step), in three parts: the front, the
// warp's landing pool, the back ----

// The front: both seats decode their actions a1 and a2 (the latches follow
// the actions even for a computer seat, whose AI then replaces only the
// input), the lazy round reset and auto game reset with their draws, and
// the ball's world step.  Returns whether the ball touched the ground.
PIKA_HD bool frame_front(int32_t* s, const Config& cfg, int32_t a1, int32_t a2,
                         Input& in1, Input& in2) {
  in1 = decode_action(a1, s[LATCH1]);
  in2 = decode_action(a2, s[LATCH2]);

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
  return ball_world(s);
}

// The back: the computer seats decide from the landing results (landing[0]
// the true ball's, landing[1 + k] candidate k's; null without a computer
// seat), then the players move, the ball collides with player 1 then player
// 2, and the point is scored.  The draws follow the reference's order: the
// AI's of player 1, then player 2's, then the collisions'.  The landing sims
// draw nothing, so computing them all before the decisions gives the same
// draws and the same accepted candidate as simulating them lazily.
template <bool C1, bool C2>
PIKA_HD void frame_back(int32_t* s, const Config& cfg, Input in1, Input in2,
                        bool touched, const int32_t* landing) {
  if (C1 || C2) s[BALL_EXPECTED_LANDING_POINT_X] = landing[0];
  if (C1) in1 = computer_decide_input<false>(s, landing + 1);
  move_player<false>(s, in1);
  if (C2) in2 = computer_decide_input<true>(s, landing + 1);
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

// ---- the warp's landing pool ----
//
// The code below is written once for a warp of 32 lanes, one env a lane,
// against a Warp type that supplies the collectives: on the card a thread's
// view of a real warp (DeviceWarp), in the host build an emulated warp that
// runs each lane's part in a lockstep loop over the lanes (HostWarp).  Warp
// members: each(f) calls f(lane, lane index) for the lanes it holds,
// ballot(p) is the 32-bit mask of p(lane), lane_max(p) the largest p(lane),
// sync() orders the lanes' shared memory writes before their reads,
// slice() is the warp's PoolSlice, landed(slot, x) writes a result; the
// hooks posted / steps / iterated / landed / settled count the pool's work
// where kCounting (see Count).

constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kCandidates = 6;
constexpr int kSlots = 1 + kCandidates;  // landing results an env: true ball, candidates

PIKA_HD int popc(unsigned m) {
#if defined(__CUDA_ARCH__)
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Lanes below `lane` in a mask.
PIKA_HD unsigned below(int lane) { return (1u << lane) - 1u; }

// A warp's shared memory: each lane's ball after ball_world, the lanes of
// the envs that ask for the candidates in rank order, and the landing
// results (lane * kSlots + slot): 1,536 bytes.
struct PoolSlice {
  int32_t ball[4][kWarp];  // x, y, x velocity, y velocity
  int32_t asker[kWarp];
  int32_t landing[kWarp * kSlots];
};

// One lane's landing job: the loop state of sim_step, the iteration count,
// the net rule and the result slot.  vx == 0: the lane is idle.  start: the
// count where the end run began (the counting instances only).
struct Job {
  int32_t x, y, vx, vy, count, slot, start;
  bool full_rule;
};

// Job j of the warp's list: j < 32 is lane j's true ball under the full net
// rule; 32 + 6 r + k is candidate k of the r-th env that asks, under the
// mistake rule.  Both seats of an env share its candidates: they depend only
// on the ball and k.
PIKA_HD void take_job(Job& job, int32_t j, const PoolSlice& sh) {
  int32_t owner = j, k = -1;
  if (j >= kWarp) {
    const int32_t r = (j - kWarp) / kCandidates;
    owner = sh.asker[r];
    k = j - kWarp - kCandidates * r;
  }
  job.x = sh.ball[0][owner];
  job.y = sh.ball[1][owner];
  job.count = 0;
  job.slot = owner * kSlots + 1 + k;
  job.full_rule = k < 0;
  if (k < 0) {
    job.vx = sh.ball[2][owner];
    job.vy = sh.ball[3][owner];
  } else {
    pika::candidate_velocity(k, job.x, sh.ball[3][owner], job.vx, job.vy);
  }
}

// Everything a lane holds: its env's state and the frame's carry between
// the front and the back, and its landing job.
struct Lane {
  int32_t s[NFIELDS];
  Input in1, in2;
  bool touched, asks;
  Job job;
};

#if defined(__CUDACC__)
#define PIKA_WARP __device__ __forceinline__
#else
#define PIKA_WARP inline
#endif

// Runs the warp's job list: 32 true-ball jobs, then 6 for each env in
// `asking`.  While jobs remain, every idle lane takes the next one (in lane
// order, by the popcount of the idle lanes below it) and the warp advances
// every live job one sim_step a pool step; a landed job writes its slot and
// leaves its lane idle for the next job.  Once the list is empty, each lane
// runs its last job to the end alone, with no ballot a step.  The warp so
// pays about the sum of its jobs' iterations over 32, plus the longest job,
// where one lane running its env's loops in turn pays, loop by loop, the
// longest of its 32 lanes.  A frame with no candidates assigns the 32 true
// balls at once and goes straight to the end run.
template <class Warp>
PIKA_WARP void landing_pool(Warp& w, unsigned asking) {
  PoolSlice& sh = w.slice();
  const int32_t total = kWarp + kCandidates * popc(asking);
  w.posted(kWarp, total - kWarp);
  for (int32_t next = 0;;) {
    const unsigned idle = w.ballot([](const Lane& l) { return l.job.vx == 0; });
    if (idle != 0) {
      w.each([&](Lane& l, int lane) {
        const int32_t j = next + popc(idle & below(lane));
        if ((idle >> lane & 1u) && j < total) {
          take_job(l.job, j, sh);
          if (l.job.vx == 0) w.landed(l.job.slot, l.job.x);  // the net-top trap
        }
      });
      next += popc(idle);
      if (next >= total) break;
    }
    w.steps(1);
    w.each([&](Lane& l, int) {
      Job& job = l.job;
      if (job.vx != 0) {
        w.iterated();
        if (pika::sim_step(job.x, job.y, job.vx, job.vy, ++job.count,
                           job.full_rule))
          w.landed(job.slot, job.x);
      }
    });
  }
  w.each([&](Lane& l, int) {
    Job& job = l.job;
    if (Warp::kCounting) job.start = job.count;
    if (job.vx == 0) return;
    do {
      w.iterated();
    } while (!pika::sim_step(job.x, job.y, job.vx, job.vy, ++job.count,
                             job.full_rule));
    w.landed(job.slot, job.x);
  });
  if (Warp::kCounting)
    w.steps(w.lane_max([](const Lane& l) { return l.job.count - l.job.start; }));
}

// Where K3's actions come from: seat `seat`'s action of a lane's env is
// sampled from the env's action key at its step count.  warp_frame calls an
// Actions object as actions(lane's state, lane index, seat); the learner
// step's gives the actions it was handed.
struct SampledActions {
  PIKA_HD int32_t operator()(const Lane& l, int, uint32_t seat) const {
    return sample_action(l.s, seat);
  }
};

// One frame of the warp's 32 envs, seat actions from `actions`.
template <bool C1, bool C2, class Warp, class Actions>
PIKA_WARP void warp_frame(Warp& w, const Config& cfg, const Actions& actions) {
  PoolSlice& sh = w.slice();
  w.each([&](Lane& l, int lane) {
    l.touched = frame_front(l.s, cfg, actions(l, lane, 0), actions(l, lane, 1),
                            l.in1, l.in2);
    if (C1 || C2) {
      sh.ball[0][lane] = l.s[BALL_X];
      sh.ball[1][lane] = l.s[BALL_Y];
      sh.ball[2][lane] = l.s[BALL_X_VELOCITY];
      sh.ball[3][lane] = l.s[BALL_Y_VELOCITY];
      l.asks = (C1 && asks_for_candidates<false>(l.s)) ||
               (C2 && asks_for_candidates<true>(l.s));
    }
  });
  if (C1 || C2) {
    const unsigned asking = w.ballot([](const Lane& l) { return l.asks; });
    w.each([&](Lane& l, int lane) {
      if (l.asks) sh.asker[popc(asking & below(lane))] = lane;
    });
    w.sync();
    landing_pool(w, asking);
    w.sync();
    w.settled(asking);
  }
  w.each([&](Lane& l, int lane) {
    frame_back<C1, C2>(l.s, cfg, l.in1, l.in2, l.touched,
                       (C1 || C2) ? &sh.landing[lane * kSlots] : nullptr);
  });
}

// The counts of the counting instance, summed over the launch: true-ball
// jobs posted, candidate jobs posted, jobs run (results written),
// iterations of sim_step, pool steps (warp-wide), and, in the host build
// only, results written other than once in their frame.  Lane efficiency
// is iterations / (32 * pool steps).
enum Count { kTrueJobs, kCandidateJobs, kJobsRun, kIterations, kPoolSteps,
             kMisses, kNumCounts };


#if defined(__CUDACC__)

// A lane's counts, summed over the warp and added to the output at the end.
struct LaneCounts {
  static constexpr bool kOn = true;
  unsigned long long v[kNumCounts] = {};
  __device__ void add(Count c, unsigned long long n) { v[c] += n; }
  __device__ void flush(unsigned long long* out) {
#pragma unroll
    for (int c = 0; c < kNumCounts; ++c) {
      unsigned long long sum = v[c];
#pragma unroll
      for (int d = kWarp / 2; d > 0; d /= 2)
        sum += __shfl_xor_sync(kFullWarp, sum, d);
      if (threadIdx.x % kWarp == 0 && sum != 0) atomicAdd(out + c, sum);
    }
  }
};

struct NoCounts {
  static constexpr bool kOn = false;
  __device__ void add(Count, unsigned long long) {}
  __device__ void flush(unsigned long long*) {}
};

// One thread's view of its warp.
template <class Counts>
struct DeviceWarp {
  static constexpr bool kCounting = Counts::kOn;
  Lane& l;
  const int lane;
  PoolSlice& sh;
  Counts& counts;

  template <class F>
  __device__ __forceinline__ void each(F f) { f(l, lane); }
  template <class P>
  __device__ __forceinline__ unsigned ballot(P p) {
    return __ballot_sync(kFullWarp, p(l));
  }
  template <class P>
  __device__ __forceinline__ int32_t lane_max(P p) {
    return __reduce_max_sync(kFullWarp, p(l));
  }
  __device__ __forceinline__ void sync() { __syncwarp(); }
  __device__ __forceinline__ PoolSlice& slice() { return sh; }
  __device__ __forceinline__ void posted(int32_t true_jobs, int32_t candidates) {
    if (lane == 0) {
      counts.add(kTrueJobs, true_jobs);
      counts.add(kCandidateJobs, candidates);
    }
  }
  __device__ __forceinline__ void steps(int32_t n) {
    if (lane == 0) counts.add(kPoolSteps, n);
  }
  __device__ __forceinline__ void iterated() { counts.add(kIterations, 1); }
  __device__ __forceinline__ void landed(int32_t slot, int32_t x) {
    sh.landing[slot] = x;
    counts.add(kJobsRun, 1);
  }
  __device__ __forceinline__ void settled(unsigned) {}
};

#else

// An emulated warp: 32 lanes run in lockstep, each part of a lane's code in
// a loop over the lanes; it counts always, and checks that every posted
// result was written exactly once in its frame.
struct HostWarp {
  static constexpr bool kCounting = true;
  Lane lanes[kWarp];
  PoolSlice sh;
  int64_t* counts;
  int32_t writes[kWarp * kSlots];

  template <class F>
  void each(F f) {
    for (int i = 0; i < kWarp; ++i) f(lanes[i], i);
  }
  template <class P>
  unsigned ballot(P p) {
    unsigned mask = 0;
    for (int i = 0; i < kWarp; ++i) mask |= unsigned(bool(p(lanes[i]))) << i;
    return mask;
  }
  template <class P>
  int32_t lane_max(P p) {
    int32_t m = p(lanes[0]);
    for (int i = 1; i < kWarp; ++i) m = p(lanes[i]) > m ? p(lanes[i]) : m;
    return m;
  }
  void sync() {}
  PoolSlice& slice() { return sh; }
  void posted(int32_t true_jobs, int32_t candidates) {
    counts[kTrueJobs] += true_jobs;
    counts[kCandidateJobs] += candidates;
    for (int32_t& n : writes) n = 0;
  }
  void steps(int32_t n) { counts[kPoolSteps] += n; }
  void iterated() { ++counts[kIterations]; }
  void landed(int32_t slot, int32_t x) {
    sh.landing[slot] = x;
    ++counts[kJobsRun];
    ++writes[slot];
  }
  void settled(unsigned asking) {
    for (int i = 0; i < kWarp; ++i)
      for (int j = 0; j < kSlots; ++j)
        counts[kMisses] += writes[i * kSlots + j] !=
                           (j == 0 || (asking >> i & 1u) ? 1 : 0);
  }
};

#endif

}  // namespace
