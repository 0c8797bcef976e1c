"""The oracle draw mode and ``reset(carry=, counter=)`` against the JAX
package's, leaf by leaf.

Both sides take their draws from the same synthetic oracle (numpy-seeded
values in [0, 2), valid at every draw site) and the same numpy-seeded
actions.  Each seat configuration x serve mode runs 300 frames at batch
shape ``(B,)`` and, on env 0's oracle and key, at batch shape ``()``; JAX
runs once, vmapped, in a ``lax.scan``, and env 0 of its run is the
reference for the 0-d run.  The configurations with one computer seat are
in ``tests/test_torch_oracle_seat{1,2}.py``, so each file stays about a
minute on one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.core import rng as jax_rng
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from pikazoo_tpu_torch.core import rng
from pikazoo_tpu_torch.envs.pika_volley import batch_keys
from torch_helpers import assert_same, named_leaves

B, FRAMES, CAP = 8, 300, 1024
SERVES = ("winner", "alternate", "random")


def oracle_inputs(seed: int):
    """(oracle (B, CAP), actions (FRAMES, B, 2)), int32, from a numpy seed."""
    gen = np.random.default_rng(seed)
    return (gen.integers(0, 2, (B, CAP)).astype(np.int32),
            gen.integers(0, 18, (FRAMES, B, 2)).astype(np.int32))


def jax_oracle_run(cfg: JaxConfig, keys, oracle, actions):
    """JAX's vmapped oracle reset and FRAMES oracle steps in one scan:
    (reset (state, ts), stacked per-frame (state, ts)), numpy leaves."""
    env = JaxZoo(cfg)
    oracle = jnp.asarray(oracle)
    start = jax.vmap(lambda k, o: env.reset(k, oracle=o))(keys, oracle)

    def body(state, a):
        state, ts = jax.vmap(env.step)(state, a, oracle)
        return state, (state, ts)

    _, frames = jax.jit(lambda s, a: jax.lax.scan(body, s, a))(start[0], jnp.asarray(actions))
    return jax.device_get(start), jax.device_get(frames)


def stack_port(outs):
    """Per-frame port (state, ts) -> (leaf name, numpy leaf stacked on frames)."""
    per_frame = [list(named_leaves((env_state_to_numpy(s), ts))) for s, ts in outs]
    return [(leaves[0][0], np.stack([leaf for _, leaf in leaves]))
            for leaves in zip(*per_frame)]


def first_difference(want, got, label: str):
    """Every stacked leaf equal; else name the first frame and leaf that differ."""
    for (name, w), (_, g) in zip(named_leaves(want), got, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name, g.dtype, w.dtype,
                                                           g.shape, w.shape)
        if not np.array_equal(g, w):
            frame = int(np.argwhere(g != w)[0][0])
            raise AssertionError(f"{label}: {name} differs first at frame {frame}")


def check_oracle_config(p1c: bool, p2c: bool, serve: str):
    """One seat configuration and serve mode, 300 frames at (B,) and at ()."""
    kw = dict(winning_score=2, serve=serve, auto_reset=True,
              is_player1_computer=p1c, is_player2_computer=p2c)
    seed = 100 + 4 * SERVES.index(serve) + 2 * p1c + p2c
    oracle, actions = oracle_inputs(seed)
    keys = batch_keys(seed, B, "cpu")
    jax_keys = jnp.asarray(keys.numpy().view(np.uint32))
    jax_start, jax_frames = jax_oracle_run(JaxConfig(**kw), jax_keys, oracle, actions)

    env = PikaZoo(EnvConfig(**kw))
    port_oracle = torch.from_numpy(oracle)
    for shape, index in (((B,), slice(None)), ((), 0)):
        o = port_oracle[index]
        out = env._reset_from_keys(keys[index], oracle=o)
        at = lambda tree: jax.tree.map(lambda x: x[index], tree)
        assert_same(at(jax_start), (env_state_to_numpy(out[0]), out[1]), f"{shape} reset")
        outs = []
        for t in range(FRAMES):
            out = env.step(out[0], torch.from_numpy(actions[t][index]), o)
            outs.append(out)
        first_difference(jax.tree.map(lambda x: x[:, index], jax_frames), stack_port(outs),
                         f"{kw} {shape}")
    draws = np.asarray(jax_frames[0].draw_counter)[-1]
    assert (draws > 3).all(), draws  # the oracle was read past the reset's draws


@pytest.mark.parametrize("serve", SERVES)
@pytest.mark.parametrize("p1c,p2c", [(False, False), (True, True)],
                         ids=["human-human", "ai-ai"])
def test_oracle_mode_matches_jax(p1c, p2c, serve):
    check_oracle_config(p1c, p2c, serve)


def test_draw_reads_the_oracle_at_the_clipped_counter():
    """``draw`` returns ``oracle[..., clip(counter)]`` where consumed, 0
    elsewhere, and advances only consumed counters."""
    oracle = torch.stack([torch.arange(10, 20, dtype=torch.int32) + 100 * i for i in range(5)])
    counter = torch.tensor([-3, 0, 4, 9, 25], dtype=torch.int32)
    consume = torch.tensor([True, True, False, True, True])
    ds = rng.DrawState(key=torch.zeros((5, 2), dtype=torch.int32), counter=counter,
                       oracle=oracle)
    value, ds = rng.draw(ds, consume, 5)
    assert value.tolist() == [10, 110, 0, 319, 419]
    assert ds.counter.tolist() == [-2, 1, 4, 10, 26]
    value, ds = rng.draw(ds._replace(oracle=oracle[0], counter=torch.tensor(4)),
                         torch.tensor(True), 5)
    assert int(value) == 14 and int(ds.counter) == 5


@pytest.mark.parametrize("key", [[0, 5], [0xDEADBEEF, 0x80000001], [123, 2 ** 32 - 1]])
def test_site_value_host_matches_jax_package(key):
    for counter in (0, 1, 77, 2 ** 31 + 3):
        for upper in (2, 3, 5, 20, 152, 500):
            want = int(jax_rng.site_value(jnp.asarray(key, jnp.uint32),
                                          jnp.uint32(counter), upper))
            assert rng.site_value_host(key, counter, upper) == want
            assert jax_rng.site_value_host(key, counter, upper) == want


def mid_game(serve: str, steps: int):
    """A JAX state some frames into a game (production draws), with the
    port's copy of it."""
    cfg = JaxConfig(serve=serve, winning_score=2, auto_reset=False)
    env = JaxZoo(cfg)
    state, _ = env.reset(jax.random.key(3))
    step = jax.jit(env.step)
    gen = np.random.default_rng(steps)
    for _ in range(steps):
        state, _ = step(state, jnp.asarray(gen.integers(0, 18, 2), jnp.int32))
    state = jax.device_get(state)
    return cfg, state, env_state_from_numpy(state)


@pytest.mark.parametrize("serve", SERVES)
def test_reset_with_carry_and_counter_matches_jax(serve):
    """``reset(key, carry=, counter=)``, production and oracle draws, from a
    mid-game state whose players, ball and latches differ from a fresh
    construction's."""
    cfg, jax_state, state = mid_game(serve, 90)
    jax_env = JaxZoo(cfg)
    env = PikaZoo(EnvConfig(serve=serve, winning_score=2, auto_reset=False))
    oracle = np.random.default_rng(5).integers(0, 2, CAP).astype(np.int32)
    for key in (7, 2 ** 32 + 9):
        for counter, orc in ((0, None), (41, None), (17, oracle)):
            want = jax_env.reset(jax.random.key(key), counter=counter, carry=jax_state,
                                 oracle=None if orc is None else jnp.asarray(orc))
            got = env.reset(key, "cpu", counter=counter, carry=state,
                            oracle=None if orc is None else torch.from_numpy(orc))
            assert_same(jax.device_get(want), (env_state_to_numpy(got[0]), got[1]),
                        f"key {key}, counter {counter}, oracle {orc is not None}")
    fresh, _ = env.reset(7, "cpu")
    carried, _ = env.reset(7, "cpu", carry=state)
    assert not torch.equal(fresh.ball.previous_x, carried.ball.previous_x)


def test_oracle_on_the_wrong_device_or_dtype_raises():
    env = PikaZoo(EnvConfig())
    with pytest.raises(ValueError, match="int32"):
        env.reset(0, "cpu", oracle=torch.zeros(8, dtype=torch.int64))
    state, _ = env.reset(0, "cpu")
    with pytest.raises(ValueError, match="int32"):
        env.step(state, torch.zeros(2, dtype=torch.int32), torch.zeros(8))
