"""Landing-point forward simulation, plain PyTorch version.

Counterpart of ``pikazoo_tpu.core.predict.landing_sims_any``.  One call per
frame serves both players (see the JAX module for why that is
semantics-preserving).  Seven lanes per env:

* lane 0, the true ball under the main predictor's full net rule (strict
  ``y < 192`` top band, side push-out below it), gives
  ``expected_landing_point_x``;
* lanes 1-6, the power-hit candidates under the flip-only "mistake" net
  rule, give the landing points the AI picks its smash from.  Candidate k
  (canonical order "A") has ``|x_dir| = (k < 3)`` and ``y_dir = k % 3 - 1``.

Three loops compute a lane's landing x, all bit-identical (``algo``):

* ``iter``, the frame loop: the reference's iterations one by one.  The
  default, and the one the env runs.  With ``split="none"`` the seven lanes
  run in one loop: each lane's iteration sequence is independent of the
  others, so this gives the JAX package's results; one loop costs the
  maximum of their trip counts instead of the sum, which is what matters
  where the cost is per operation (the CPU at test sizes).
* ``leap``, the event-leaping loop: each trip jumps in closed form over a
  span proven free of wall, ceiling, net and ground events, then runs one
  reference iteration (:func:`make_leap_step`).
* ``hyb``: one jump, then ``unroll`` reference iterations a trip.

``algo="A,B"`` runs the true ball under A and the candidates under B;
``split="ydir"`` runs the candidates as three 2-lane loops grouped by launch
y-direction.  The leap carry is integer-valued float32, a transcription of
the JAX package's (which chose float32 because the TPU's vector unit has no
int32 multiply or divide), so each trip can be held against JAX's trip by
trip.

This is the version a CPU tensor takes; on a CUDA tensor
``pikazoo_tpu_torch.core.predict_cuda`` launches the hand-written kernel
``csrc/landing.cu`` (its leap in int32), which ``chip_smoke.py`` holds
against this one.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pikazoo_tpu_torch.core import constants as C

# Loop iterations between two "any lane still live?" checks.  Each check
# reads a flag back to the host; finished lanes are frozen by the masks, so
# iterating past a lane's exit changes nothing.
UNROLL = 32
# Trips between two checks of the leap loop (leaps) and exact iterations a
# trip of the hybrid loop: the JAX kernel's defaults (predict_pallas.py:58).
LEAP_UNROLL = 1
HYB_UNROLL = 32
ALGOS = ("iter", "leap", "hyb")
SPLITS = ("none", "ydir")


def _one_iteration(x, y, vx, vy, count: int, full_rule: torch.Tensor):
    # A finished lane (vx == 0) keeps vx2 == 0 below (the wall and net rules
    # only negate or take |vx|), so it needs no mask: its x and vx stay put,
    # and its y and vy, which no result reads, drift harmlessly.
    future_x = x + vx
    vx1 = torch.where((future_x < C.BALL_RADIUS) | (future_x > C.GROUND_WIDTH),
                      -vx, vx)
    vy1 = torch.where(y + vy < 0, 1, vy)
    at_net = ((x - C.GROUND_HALF_WIDTH).abs() < C.NET_PILLAR_HALF_WIDTH) & \
             (y > C.NET_PILLAR_TOP_TOP_Y_COORD)
    # Full rule: bounce off the top band (y < 192), push out sideways below.
    # Mistake rule: bounce anywhere in the net column.  A bounce makes a
    # downward vy upward: -|vy1| (a vy1 <= 0 is left as it is).
    bounce = at_net & (~full_rule | (y < C.NET_PILLAR_TOP_BOTTOM_Y_COORD))
    vy2 = torch.where(bounce, -vy1.abs(), vy1)
    side_vx = torch.where(x < C.GROUND_HALF_WIDTH, -vx1.abs(), vx1.abs())
    vx2 = torch.where(at_net & ~bounce, side_vx, vx1)
    y = y + vy2
    # Landing (y > 252) or the iteration cap finishes a lane; x is not
    # advanced on the finishing iteration.
    if count >= C.INFINITE_LOOP_LIMIT:
        vx = torch.zeros_like(vx2)
    else:
        vx = torch.where(y <= C.BALL_TOUCHING_GROUND_Y_COORD, vx2, 0)
    return x + vx, y, vx, vy2 + 1


def sim_loop(x, y, vx, vy, full_rule: torch.Tensor, unroll: int = 0) -> torch.Tensor:
    """Bounded landing loop over int32 tensors of one shape; ``full_rule``
    (bool, broadcastable) selects each lane's net rule.  Returns the landing x.

    ``vx == 0`` encodes "finished": a live lane's vx never becomes 0 (the
    wall and net rules only negate it), and x is not advanced on the
    finishing iteration, so a finished lane's frozen x IS its result.  A
    lane that starts with ``vx == 0`` never iterates (the net-top trap's fast
    exit).  Every live lane has been live since iteration 0, so one Python
    counter is every lane's iteration count (cap: 1000).  ``unroll``
    iterations run between two checks (0: :data:`UNROLL`)."""
    count = 0
    while bool((vx != 0).any()):
        for _ in range(unroll or UNROLL):
            count += 1
            x, y, vx, vy = _one_iteration(x, y, vx, vy, count, full_rule)
    return x


def make_leap_step(full_rule: bool):
    """The event-leaping primitives over the float32 carry ``(x, y, vx, vy,
    c)``, ``c`` a lane's own count of reference iterations: returns
    ``(one_leap, jump, exact_iteration)``, JAX's ``_make_leap_step``
    transcribed operation for operation (``predict.py:160-318``), so a trip
    gives JAX's carry exactly.

    ``jump`` advances each live lane in closed form over ``k`` iterations
    with no event: ``x += k*vx``, ``y += k*vy + k(k-1)/2``, ``vy += k``.
    ``k`` is the least of the spans to the wall, to the net band (or, in
    it, the span its y/vy conditions stay quiet), to the ground or ceiling,
    and to the iteration cap.  Every y hazard uses the displacement bound
    ``|y_j - y| <= j|vy| + j(j+1)/2``, monotone in ``j``, so the largest
    ``k`` whose bound stays below the distance is quiet; an underestimate
    only costs a trip.  ``exact_iteration`` is one reference iteration with
    the lane's own count; ``one_leap`` is a jump then one exact iteration,
    which realises the event.  Every value is an integer below 2^24 in
    magnitude, exact in float32, and the roots and quotients are checked
    back and lowered by one where they overshoot."""
    BR = float(C.BALL_RADIUS)
    GW = float(C.GROUND_WIDTH)
    GHW = float(C.GROUND_HALF_WIDTH)
    NPHW = float(C.NET_PILLAR_HALF_WIDTH)
    TOP = float(C.NET_PILLAR_TOP_TOP_Y_COORD)      # 176
    BOT = float(C.NET_PILLAR_TOP_BOTTOM_Y_COORD)   # 192
    GND = float(C.BALL_TOUCHING_GROUND_Y_COORD)    # 252
    CAP = float(C.INFINITE_LOOP_LIMIT)             # 1000
    BIGF = float(1 << 20)

    def k_disp(avy, d):
        """Largest k >= 0 with k*|vy| + k(k+1)/2 <= d (0 when d <= 0)."""
        b = 2.0 * avy + 1.0
        disc = b * b + 8.0 * torch.clamp(d, min=0.0)
        k = torch.floor((torch.sqrt(disc) - b) * 0.5)
        k = torch.where(k * avy + 0.5 * k * (k + 1.0) <= d, k, k - 1.0)
        return torch.clamp(k, min=0.0)

    def div_floor(a, b):
        """floor(a/b), never above it, for integer-valued a >= 0, b >= 1."""
        q = torch.floor(a / b)
        return torch.where(q * b > a, q - 1.0, q)

    def safe_jump(x, y, vx, vy, c):
        pos = vx > 0.0
        neg = ~pos
        avx = vx.abs()
        avy = vy.abs()
        # Wall: the first iteration j where x + (j+1)*vx leaves [20, 432].
        hit_near = (pos & (x + vx < BR)) | (neg & (x + vx > GW))
        wall_num = torch.where(pos, GW - x, x - BR)
        k_wall = torch.where(hit_near, 0.0, div_floor(torch.clamp(wall_num, min=0.0), avx))

        # Net: in the x-band (192 <= x <= 240) quietness is a y/vy
        # condition; outside it, the span to band entry bounds the jump.
        lo, hi = GHW - NPHW + 1.0, GHW + NPHW - 1.0
        in_band = (x >= lo) & (x <= hi)
        toward = (pos & (x < lo)) | (neg & (x > hi))
        dist = torch.where(pos, lo - x, x - hi)
        # ceil(d/b) = floor((d-1)/b) + 1 for integer d >= 1
        k_entry = torch.where(
            toward, div_floor(torch.clamp(dist, min=1.0) - 1.0, avx) + 1.0, BIGF)
        k_vy = torch.clamp(-vy, min=0.0)   # j <= -vy  =>  vy_j <= 0
        k_176 = k_disp(avy, TOP - y)
        if full_rule:
            # Below the top band the side push-out is a no-op while vx
            # already points away from the net.
            left = x < GHW
            away = (left & (vx < 0.0)) | (~left & (vx > 0.0))
            k_192 = k_disp(avy, y - BOT)
            k_under = k_disp(avy, (BOT - 1.0) - y)
            k_net_stay = torch.maximum(k_176, torch.minimum(k_vy, k_under))
            k_net_away = torch.maximum(torch.maximum(k_176, k_vy), k_192)
            k_net = torch.where(away, k_net_away, k_net_stay)
        else:
            k_net = torch.maximum(k_176, k_vy)
        k_band = torch.where(in_band, k_net, k_entry)

        # Ground (always) and ceiling: for vy >= 0 the ceiling test is
        # immediate (y + vy < 0) or never; for vy < 0 the displacement bound
        # D(k) <= y keeps it quiet.
        d_ceil = torch.where(vy >= 0.0,
                             torch.where(y + vy < 0.0, -1.0, BIGF), y)
        d = torch.minimum(GND - y, d_ceil)
        k_y = k_disp(avy, d)

        k = torch.minimum(torch.minimum(k_wall, k_band), k_y)
        return torch.minimum(k, torch.clamp((CAP - 1.0) - c, min=0.0))

    def jump(carry):
        x, y, vx, vy, c = carry
        live = vx != 0.0
        k = torch.where(live, safe_jump(x, y, vx, vy, c), 0.0)
        x = x + k * vx
        y = y + k * vy + 0.5 * k * (k - 1.0)
        return x, y, vx, vy + k, c + k

    def exact_iteration(carry):
        x, y, vx, vy, c = carry
        live = vx != 0.0
        count1 = c + 1.0
        future_x = x + vx
        vx1 = torch.where((future_x < BR) | (future_x > GW), -vx, vx)
        vy1 = torch.where(y + vy < 0.0, 1.0, vy)
        at_net = ((x - GHW).abs() < NPHW) & (y > TOP)
        if full_rule:
            on_top = y < BOT
            vy2 = torch.where(at_net & (vy1 > 0.0) & on_top, -vy1, vy1)
            side_vx = torch.where(x < GHW, -vx1.abs(), vx1.abs())
            vx2 = torch.where(at_net & ~on_top, side_vx, vx1)
        else:
            vy2 = torch.where(at_net & (vy1 > 0.0), -vy1, vy1)
            vx2 = vx1
        y1 = y + vy2
        finished = (y1 > GND) | (count1 >= CAP)
        advance = live & ~finished
        x = torch.where(advance, x + vx2, x)
        y = torch.where(live, y1, y)
        vx = torch.where(advance, vx2, 0.0)
        vy = torch.where(advance, vy2 + 1.0, vy)
        c = torch.where(live, count1, c)
        return x, y, vx, vy, c

    def one_leap(carry):
        return exact_iteration(jump(carry))

    return one_leap, jump, exact_iteration


def leap_carry(x, y, vx, vy):
    """The float32 carry of :func:`make_leap_step` from int32 state, c = 0."""
    xf = x.to(torch.float32)
    return xf, y.to(torch.float32), vx.to(torch.float32), vy.to(torch.float32), \
        torch.zeros_like(xf)


def leap_loop(x, y, vx, vy, full_rule: bool, unroll: int = 0) -> torch.Tensor:
    """The event-leaping landing loop, bit-identical to :func:`sim_loop`:
    ``unroll`` leaps (0: :data:`LEAP_UNROLL`) between two "any lane live?"
    checks (JAX's ``_leap_loop``)."""
    one_leap, _, _ = make_leap_step(full_rule)
    carry = leap_carry(x, y, vx, vy)
    while bool((carry[2] != 0.0).any()):
        for _ in range(unroll or LEAP_UNROLL):
            carry = one_leap(carry)
    return carry[0].to(torch.int32)


def hyb_loop(x, y, vx, vy, full_rule: bool, unroll: int = 0) -> torch.Tensor:
    """The hybrid landing loop, bit-identical to :func:`sim_loop`: each trip
    is one jump then ``unroll`` exact iterations (0: :data:`HYB_UNROLL`),
    JAX's ``_hyb_loop``."""
    _, jump, exact_iteration = make_leap_step(full_rule)
    carry = leap_carry(x, y, vx, vy)
    while bool((carry[2] != 0.0).any()):
        carry = jump(carry)
        for _ in range(unroll or HYB_UNROLL):
            carry = exact_iteration(carry)
    return carry[0].to(torch.int32)


def parse_algo(algo: str) -> Tuple[str, str]:
    """``"A"`` or ``"A,B"`` -> (the true ball's loop, the candidates')."""
    algo_true, _, algo_cand = algo.partition(",")
    algo_cand = algo_cand or algo_true
    for a in (algo_true, algo_cand):
        if a not in ALGOS:
            raise ValueError(f"unknown landing algo {algo!r}: each part is one of {ALGOS}")
    return algo_true, algo_cand


def _sim(x, y, vx, vy, full_rule: bool, algo: str, unroll: int) -> torch.Tensor:
    if algo == "leap":
        return leap_loop(x, y, vx, vy, full_rule, unroll)
    if algo == "hyb":
        return hyb_loop(x, y, vx, vy, full_rule, unroll)
    return sim_loop(x, y, vx, vy, torch.tensor(full_rule, device=x.device), unroll)


def candidate_velocities(x, vy, lane):
    """Candidate launch velocities (physics.py:841-845) for candidate index
    ``lane`` (canonical order "A"): toward the far side at (|x_dir| + 1) *
    10, and |vy| * y_dir * 2."""
    speed = ((lane < 3).to(torch.int32) + 1) * 10
    return (torch.where(x < C.GROUND_HALF_WIDTH, speed, -speed),
            vy.abs() * ((lane % 3) - 1) * 2)


def landing_sims_any(x: torch.Tensor, y: torch.Tensor, vx: torch.Tensor,
                     vy: torch.Tensor, *, algo: str = "iter", split: str = "none",
                     unroll: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """7-lane landing simulation over int32 tensors of shape S: returns
    ``(expected with shape S, candidates with shape (6,) + S)``.  ``algo``,
    ``split`` and ``unroll`` as in the module docstring; every choice gives
    the same results."""
    algo_true, algo_cand = parse_algo(algo)
    if split not in SPLITS:
        raise ValueError(f"unknown landing split {split!r}: one of {SPLITS}")
    ones = (1,) * x.dim()
    if algo_true == algo_cand == "iter" and split == "none":
        lane = torch.arange(7, dtype=torch.int32, device=x.device).reshape((7,) + ones)
        cvx, cvy = candidate_velocities(x, vy, lane - 1)
        lane_vx = torch.where(lane == 0, vx, cvx)
        lane_vy = torch.where(lane == 0, vy, cvy)
        shape7 = lane_vx.shape
        out = sim_loop(x.expand(shape7), y.expand(shape7), lane_vx, lane_vy,
                       full_rule=lane == 0, unroll=unroll)
        return out[0], out[1:]
    expected = _sim(x, y, vx, vy, True, algo_true, unroll)
    if split == "none":
        lane = torch.arange(6, dtype=torch.int32, device=x.device).reshape((6,) + ones)
        cvx, cvy = candidate_velocities(x, vy, lane)
        return expected, _sim(x.expand(cvx.shape), y.expand(cvx.shape), cvx, cvy, False,
                              algo_cand, unroll)
    # ydir: three 2-lane loops, one a launch y-direction (|x_dir| 1 then 0),
    # put back in canonical order: candidate k = (|x_dir| ? 0 : 3) + y_dir + 1.
    groups = []
    for ydir in range(3):
        lane = torch.tensor([ydir, 3 + ydir], dtype=torch.int32,
                            device=x.device).reshape((2,) + ones)
        cvx, cvy = candidate_velocities(x, vy, lane)
        groups.append(_sim(x.expand(cvx.shape), y.expand(cvx.shape), cvx, cvy, False,
                           algo_cand, unroll))
    return expected, torch.stack([g[a] for a in (0, 1) for g in groups])
