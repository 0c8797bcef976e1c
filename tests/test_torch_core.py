"""The port's per-frame physics == pikazoo_tpu.core, exactly, on random
states: action decoding, the ball-world step, player movement, the collision
response and the rule AI (with its draw counter)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import ai as jai
from pikazoo_tpu.core import ball as jball
from pikazoo_tpu.core import collision as jcol
from pikazoo_tpu.core import input as jinput
from pikazoo_tpu.core import player as jplayer
from pikazoo_tpu.core import rng as jrng
from pikazoo_tpu.core import state as jstate
from pikazoo_tpu_torch.core import ai as tai
from pikazoo_tpu_torch.core import ball as tball
from pikazoo_tpu_torch.core import collision as tcol
from pikazoo_tpu_torch.core import input as tinput
from pikazoo_tpu_torch.core import player as tplayer
from pikazoo_tpu_torch.core import rng as trng
from pikazoo_tpu_torch.core import state as tstate
from torch_helpers import assert_same

N = 512


def both(cls_j, cls_t, cols: dict):
    """The same numpy columns as a JAX and a torch NamedTuple."""
    return (cls_j(**{k: jnp.asarray(v) for k, v in cols.items()}),
            cls_t(**{k: torch.from_numpy(v) for k, v in cols.items()}))


def i32(a):
    return np.asarray(a, np.int32)


def random_player(rng, is_player2=False):
    lo = 216 + 32 if is_player2 else 32
    return dict(
        x=i32(rng.integers(lo - 10, lo + 170, N)),
        y=i32(rng.integers(100, 250, N)),
        y_velocity=i32(rng.integers(-16, 17, N)),
        state=i32(rng.integers(0, 7, N)),
        frame_number=i32(rng.integers(0, 5, N)),
        normal_status_arm_swing_direction=i32(rng.choice([-1, 1], N)),
        delay_before_next_frame=i32(rng.integers(0, 6, N)),
        diving_direction=i32(rng.integers(-1, 2, N)),
        lying_down_duration_left=i32(rng.integers(-2, 4, N)),
        is_collision_with_ball_happened=i32(rng.integers(0, 2, N)),
        computer_boldness=i32(rng.integers(0, 5, N)),
        computer_where_to_stand_by=i32(rng.integers(0, 2, N)),
        is_winner=i32(rng.integers(0, 2, N)),
        game_ended=i32(rng.integers(0, 2, N)),
    )


def random_ball(rng):
    return dict(
        x=i32(rng.integers(0, 440, N)),
        y=i32(rng.integers(-40, 270, N)),
        # Negative velocities reach the floor division of the rotation.
        x_velocity=i32(rng.integers(-31, 32, N)),
        y_velocity=i32(rng.integers(-60, 61, N)),
        previous_x=i32(rng.integers(0, 433, N)),
        previous_y=i32(rng.integers(0, 253, N)),
        previous_previous_x=i32(rng.integers(0, 433, N)),
        previous_previous_y=i32(rng.integers(0, 253, N)),
        is_power_hit=i32(rng.integers(0, 2, N)),
        expected_landing_point_x=i32(rng.integers(0, 433, N)),
        rotation=i32(rng.integers(0, 6, N)),
        fine_rotation=i32(rng.integers(0, 51, N)),
        punch_effect_x=i32(rng.integers(0, 433, N)),
        punch_effect_y=i32(rng.integers(0, 273, N)),
        punch_effect_radius=i32(rng.integers(0, 21, N)),
    )


def random_input(rng, power_hit=True):
    return dict(x_direction=i32(rng.integers(-1, 2, N)),
                y_direction=i32(rng.integers(-1, 2, N)),
                power_hit=i32(rng.integers(0, 2 if power_hit else 1, N)))


def random_draws(rng):
    keys = rng.integers(0, 2 ** 32, (N, 2), dtype=np.uint64).astype(np.uint32)
    counter = i32(rng.integers(0, 100, N))
    return (jrng.DrawState(jnp.asarray(keys), jnp.asarray(counter)),
            trng.DrawState(torch.from_numpy(keys.view(np.int32)),
                           torch.from_numpy(counter)))


@pytest.mark.parametrize("decode", ["decode_action", "decode_action_arith"])
def test_decode_all_actions(decode):
    actions = np.repeat(np.arange(18, dtype=np.int32), 2)
    latch = np.tile(np.array([0, 1], np.int32), 18)
    want = jax.vmap(getattr(jinput, decode))(jnp.asarray(actions),
                                              jnp.asarray(latch))
    got = getattr(tinput, decode)(torch.from_numpy(actions),
                                  torch.from_numpy(latch))
    assert_same(want, got)


def test_decode_clamps_out_of_range_actions():
    """JAX gathers count negative actions from the end and clamp: -1 is 17,
    99 is 17, -100 is 0."""
    actions = i32([-2 ** 31, -100, -19, -18, -5, -1, 18, 99, 2 ** 31 - 1])
    latch = np.zeros_like(actions)
    want = jax.vmap(jinput.decode_action)(jnp.asarray(actions), jnp.asarray(latch))
    got = tinput.decode_action(torch.from_numpy(actions), torch.from_numpy(latch))
    assert_same(want, got)


def test_ball_world_step():
    rng = np.random.default_rng(0)
    jb, tb = both(jstate.BallState, tstate.BallState, random_ball(rng))
    assert (tb.x_velocity < 0).any() and (tb.x_velocity % 2 == 1).any()
    assert_same(jax.vmap(jball.ball_world_step)(jb), tball.ball_world_step(tb))


@pytest.mark.parametrize("is_player2", [False, True])
def test_move_player(is_player2):
    rng = np.random.default_rng(1 + is_player2)
    jp, tp = both(jstate.PlayerState, tstate.PlayerState,
                  random_player(rng, is_player2))
    ji, ti = both(jstate.PlayerInput, tstate.PlayerInput, random_input(rng))
    want = jax.vmap(lambda p, i: jplayer.move_player(p, i, is_player2))(jp, ji)
    assert_same(want, tplayer.move_player(tp, ti, is_player2))


def test_collision_response():
    rng = np.random.default_rng(3)
    jb, tb = both(jstate.BallState, tstate.BallState, random_ball(rng))
    # Player x near the ball so that diff // 3 is often 0 (the kick draw).
    px = i32(np.asarray(tb.x) + rng.integers(-4, 5, N))
    ji, ti = both(jstate.PlayerInput, tstate.PlayerInput, random_input(rng))
    pstate = i32(rng.integers(0, 4, N))
    active = rng.integers(0, 2, N).astype(bool)
    jds, tds = random_draws(rng)
    want = jax.vmap(jcol.collision_response)(
        jb, jnp.asarray(px), ji, jnp.asarray(pstate), jnp.asarray(active), jds)
    got = tcol.collision_response(tb, torch.from_numpy(px), ti,
                                  torch.from_numpy(pstate),
                                  torch.from_numpy(active), tds)
    assert_same(want[:2], got[:2])
    np.testing.assert_array_equal(got[2].counter.numpy(),
                                  np.asarray(want[2].counter))
    assert (np.asarray(want[2].counter) != np.asarray(jds.counter)).any()
    overlap_j = jax.vmap(jcol.ball_player_overlap)(jb, jnp.asarray(px),
                                                   jnp.asarray(px))
    overlap_t = tcol.ball_player_overlap(tb, torch.from_numpy(px),
                                         torch.from_numpy(px))
    np.testing.assert_array_equal(overlap_t.numpy(), np.asarray(overlap_j))


@pytest.mark.parametrize("is_player2", [False, True])
def test_computer_decide_input(is_player2):
    rng = np.random.default_rng(4 + is_player2)
    jp, tp = both(jstate.PlayerState, tstate.PlayerState,
                  random_player(rng, is_player2))
    # Airborne players near the ball reach the smash-candidate selection.
    ball = random_ball(rng)
    near = rng.integers(0, 2, N).astype(bool)
    ball["x"] = np.where(near, np.asarray(jp.x) + rng.integers(-40, 41, N),
                         ball["x"]).astype(np.int32)
    ball["y"] = np.where(near, np.asarray(jp.y) + rng.integers(-40, 41, N),
                         ball["y"]).astype(np.int32)
    jb, tb = both(jstate.BallState, tstate.BallState, ball)
    jo, to = both(jstate.PlayerState, tstate.PlayerState,
                  random_player(rng, not is_player2))
    cand = i32(rng.integers(0, 433, (6, N)))
    jds, tds = random_draws(rng)
    want = jax.vmap(
        lambda p, o, b, c, ds: jai.computer_decide_input(p, o, b, c, is_player2, ds),
        in_axes=(0, 0, 0, 1, 0))(jp, jo, jb, jnp.asarray(cand), jds)
    got = tai.computer_decide_input(tp, to, tb, torch.from_numpy(cand),
                                    is_player2, tds)
    assert_same(want[:2], got[:2])
    np.testing.assert_array_equal(got[2].counter.numpy(),
                                  np.asarray(want[2].counter))
    assert np.asarray(want[0].power_hit).any()


def test_chained_smash_passes_declared_obs_high():
    """A smash doubles |y_velocity| (collision.py: |vy| * y_dir * 2), so a
    ball smashed again on its way down leaves the declared OBS_HIGH of the
    ball's y velocity (124) -- in the JAX package and in the port alike."""
    from pikazoo_tpu.envs.observations import OBS_HIGH
    cols = random_ball(np.random.default_rng(6))
    cols["y_velocity"] = i32(np.full(N, 73))
    jb, tb = both(jstate.BallState, tstate.BallState, cols)
    inp = dict(x_direction=i32(np.zeros(N)), y_direction=i32(np.ones(N)),
               power_hit=i32(np.ones(N)))
    ji, ti = both(jstate.PlayerInput, tstate.PlayerInput, inp)
    smash = i32(np.full(N, 2))
    jds, tds = random_draws(np.random.default_rng(7))
    want = jax.vmap(jcol.collision_response)(
        jb, jb.x, ji, jnp.asarray(smash), jnp.ones(N, bool), jds)
    got = tcol.collision_response(tb, tb.x, ti, torch.from_numpy(smash),
                                  torch.ones(N, dtype=torch.bool), tds)
    assert_same(want[:2], got[:2])
    assert (got[0].y_velocity.numpy() == 146).all()
    assert 146 > OBS_HIGH[33]
