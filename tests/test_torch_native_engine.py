"""The port's native C++ engine (``pikazoo_tpu_torch.native``): its build, its
packing, and its frames against the port's torch env and the JAX env, in
oracle and production modes (the counterpart of
``tests/test_native_engine.py``).

The three implementations consume the same oracle draw streams, so a state
divergence over hundreds of random frames is a logic bug in one of them."""

import os
import sysconfig

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu.native import engine as jax_native
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.compat import raw_env
from pikazoo_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from pikazoo_tpu_torch.core.rng import fold_in, key_data
from pikazoo_tpu_torch.native import FIELDS, NFIELDS, NativeEngine
from pikazoo_tpu_torch.native import engine as native
from torch_helpers import assert_same

ORACLE_CAP = 1 << 13
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_envs(batch, seed=0, **cfg_kw):
    """Matching torch state + JAX state + packed native state + shared
    oracle (values in [0, 2), valid at every draw site)."""
    env = PikaZoo(EnvConfig(**cfg_kw))
    oracle = np.random.default_rng(seed).integers(0, 2, (batch, ORACLE_CAP)).astype(np.int32)
    keys = torch.stack([key_data(seed + i) for i in range(batch)])
    state, _ = env._reset_from_keys(keys, oracle=torch.from_numpy(oracle))
    jax_env = JaxZoo(JaxConfig(**cfg_kw))
    jax_state, _ = jax.vmap(lambda k, o: jax_env.reset(k, oracle=o))(
        jnp.asarray(keys.numpy().view(np.uint32)), jnp.asarray(oracle))
    assert_same(jax.device_get(jax_state), env_state_to_numpy(state), "reset")
    eng = NativeEngine(winning_score=env.config.winning_score, serve=env.config.serve,
                       is_player1_computer=env.config.is_player1_computer,
                       is_player2_computer=env.config.is_player2_computer,
                       auto_reset=env.config.auto_reset)
    packed = NativeEngine.pack(state)
    assert packed.shape == (batch, NFIELDS)
    return env, state, jax_env, jax_state, eng, packed, oracle


def assert_packed_equal(state, packed, t, label):
    repacked = NativeEngine.pack(state)
    if not np.array_equal(repacked, packed):
        bad = np.argwhere(repacked != packed)
        b, f = bad[0]
        raise AssertionError(f"{label} != native at frame {t}, env {b}, field {FIELDS[f]}: "
                             f"{repacked[b, f]} vs {packed[b, f]} ({len(bad)} mismatches)")


@pytest.mark.parametrize("cfg_kw", [
    dict(auto_reset=True),
    dict(auto_reset=True, serve="random"),
    dict(auto_reset=True, winning_score=3, is_player1_computer=True, is_player2_computer=True),
    dict(auto_reset=True, serve="alternate", is_player2_computer=True),
], ids=["human", "serve-random", "ai-ai", "human-ai-alternate"])
@pytest.mark.parametrize("mode", ["oracle", "production"])
def test_fuzz_native_vs_torch_and_jax(cfg_kw, mode):
    batch, frames = 8, 240
    env, state, jax_env, jax_state, eng, packed, oracle = make_envs(batch, 42, **cfg_kw)
    use = oracle if mode == "oracle" else None
    port_oracle = None if use is None else torch.from_numpy(use)
    jax_oracle = None if use is None else jnp.asarray(use)
    jax_step = jax.jit(jax.vmap(jax_env.step, in_axes=(0, 0, None if use is None else 0)))
    gen = np.random.default_rng(7)
    for t in range(frames):
        acts = gen.integers(0, 18, size=(batch, 2)).astype(np.int32)
        state, ts = env.step(state, torch.from_numpy(acts), port_oracle)
        jax_state, jax_ts = jax_step(jax_state, jnp.asarray(acts), jax_oracle)
        rewards, flags = eng.step(packed, acts, use)
        assert_packed_equal(state, packed, t, "torch")
        assert_packed_equal(jax.device_get(jax_state), packed, t, "JAX")
        np.testing.assert_array_equal(ts.rewards.numpy(), rewards)
        np.testing.assert_array_equal(ts.terminated.numpy(), (flags & 1).astype(np.int32))
        np.testing.assert_array_equal(ts.round_ended.numpy(), (flags >> 1 & 1).astype(np.int32))
        if t % 50 == 49:
            np.testing.assert_array_equal(eng.obs(packed), ts.obs.numpy(),
                                          err_msg=f"obs at frame {t}")


def test_run_multiframe_matches_stepwise():
    batch, frames = 8, 200
    _, _, _, _, eng, packed, oracle = make_envs(batch, 1, auto_reset=True)
    packed2 = packed.copy()
    acts = np.random.default_rng(3).integers(0, 18, (frames, batch, 2)).astype(np.int32)
    for t in range(frames):
        eng.step(packed, acts[t], oracle)
    eng.run(packed2, acts, oracle)
    np.testing.assert_array_equal(packed, packed2)


@pytest.mark.parametrize("serve", ["winner", "random"])
def test_native_reset_matches_torch_and_jax_reset_with_carry(serve):
    """``NativeEngine.reset`` == ``PikaZoo.reset(key, carry=state)`` in
    production mode, from a mid-game state, keys as int32 bits or uint32."""
    env, state, jax_env, _, eng, packed, _ = make_envs(4, 21, auto_reset=True, serve=serve)
    gen = np.random.default_rng(2)
    for _ in range(150):
        acts = gen.integers(0, 18, size=(4, 2)).astype(np.int32)
        state, _ = env.step(state, torch.from_numpy(acts))
        eng.step(packed, acts)
    keys = torch.stack([fold_in(key_data(99), i) for i in range(4)])
    rows = [env.reset(keys[i], "cpu", carry=type(state)(*[
        type(x)(*(leaf[i] for leaf in x)) if isinstance(x, tuple) else x[i] for x in state]))[0]
        for i in range(4)]
    want = np.concatenate([NativeEngine.pack(r) for r in rows])
    jax_rows = [jax_env.reset(jnp.asarray(keys[i].numpy().view(np.uint32)),
                              carry=jax.tree.map(lambda x, i=i: x[i],
                                                 env_state_to_numpy(state)))[0]
                for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(
        [NativeEngine.pack(jax.device_get(r)) for r in jax_rows]), want)
    by_bits, by_words = packed.copy(), packed.copy()
    eng.reset(by_bits, rng_key=keys.numpy())
    eng.reset(by_words, rng_key=keys.numpy().view(np.uint32))
    np.testing.assert_array_equal(by_bits, want)
    np.testing.assert_array_equal(by_words, want)


@pytest.mark.parametrize("batch", [None, 8])
def test_pack_unpack_round_trip(batch):
    """A mid-game state (keys with words >= 2^31) packs and unpacks to every
    leaf, at batch shapes () and (B,); the JAX state packs the same."""
    env = PikaZoo(EnvConfig(serve="random", is_player2_computer=True))
    if batch is None:
        state, _ = env.reset(2 ** 32 - 3, "cpu")
    else:
        state, _ = env.reset_batch(2 ** 32 - 3, batch, "cpu")
    gen = np.random.default_rng(0)
    for _ in range(40):
        state, _ = env.step(state, torch.from_numpy(
            gen.integers(0, 18, state.scores.shape).astype(np.int32)))
    packed = NativeEngine.pack(state)
    assert packed.shape == (batch or 1, NFIELDS)
    assert (state.rng_key < 0).any()
    back = NativeEngine.unpack(packed, state)
    assert_same(env_state_to_numpy(state), env_state_to_numpy(back))
    assert all(leaf.device == state.scores.device for leaf in back.p1)
    np.testing.assert_array_equal(NativeEngine.pack(env_state_to_numpy(state)), packed)
    jax_state = env_state_to_numpy(state)
    np.testing.assert_array_equal(jax_native.NativeEngine.pack(jax_state), packed)


def test_single_stepper_flags_and_views():
    _, _, _, _, eng, packed, _ = make_envs(1, 31, auto_reset=True)
    eng.auto_reset = 0
    stepper = eng.single_stepper(np.ascontiguousarray(packed))
    obs0 = stepper.observe().copy()
    assert obs0.shape == (2, 35)
    # Mirror property: my-block and opponent-block swap between the rows.
    np.testing.assert_array_equal(obs0[0, :13], obs0[1, 13:26])
    np.testing.assert_array_equal(obs0[0, 13:26], obs0[1, :13])
    gen = np.random.default_rng(1)
    terminated = False
    for _ in range(20000):
        rew, flags = stepper.step(int(gen.integers(18)), int(gen.integers(18)))
        assert rew[0] == -rew[1]
        if flags & 2:  # round ended -> scoring frame pays the zero-sum point
            assert abs(int(rew[0])) == 1
        if flags & 1:
            terminated = True
            break
    assert terminated, "random self-play should finish a 15-point game"
    with pytest.raises(ValueError):
        eng.single_stepper(np.zeros((2, NFIELDS), np.int32))


def test_fastpath_matches_plain_step():
    """The C extension's dict-level step (``fastpath.c``) returns exactly the
    dicts of its plain version, the Python assembly over
    ``SingleStepper.step_obs``, including the shared mutable
    ``infos["score"]`` list (pikazoo_env.py:573-574)."""
    e_fast = raw_env(seed=77, backend="native", winning_score=2)
    e_py = raw_env(seed=77, backend="native", winning_score=2)
    gen = np.random.default_rng(9)
    e_fast.reset()
    e_py.reset()
    infos_seen = None
    for _ in range(20000):
        acts = {"player_1": int(gen.integers(0, 18)), "player_2": int(gen.integers(0, 18))}
        o1, r1, t1, u1, i1 = e_fast.step(acts)
        o2, r2, t2, u2, i2 = e_py._step_native_plain(dict(acts))
        for a in ("player_1", "player_2"):
            np.testing.assert_array_equal(o1[a], o2[a])
            assert o1[a].dtype == np.int32
            assert (r1[a], t1[a], u1[a]) == (r2[a], t2[a], u2[a])
            assert i1[a]["score"] == i2[a]["score"]
            assert i1[a]["score"] is e_fast.scores
        assert e_fast.agents == e_py.agents
        infos_seen = i1
        if not e_fast.agents:
            break
    assert not e_fast.agents, "a 2-point game should have terminated"
    assert max(infos_seen["player_1"]["score"]) == 2


def test_fastpath_action_conversion_matches_plain_step():
    """The fast path converts actions with ``int(x)`` as the plain step does:
    floats truncate, numpy scalars pass, and the same values raise."""
    e_fast = raw_env(seed=5, backend="native", winning_score=2)
    e_py = raw_env(seed=5, backend="native", winning_score=2)
    e_fast.reset()
    e_py.reset()
    cases = [
        {"player_1": 7.9, "player_2": np.float64(3.2)},
        {"player_1": np.int64(11), "player_2": np.int32(0)},
        {"player_1": True, "player_2": 17},
        {"player_1": "3", "player_2": 0},
    ]
    for acts in cases:
        o1, r1, t1, u1, _ = e_fast.step(dict(acts))
        o2, r2, t2, u2, _ = e_py._step_native_plain(dict(acts))
        for a in ("player_1", "player_2"):
            np.testing.assert_array_equal(o1[a], o2[a])
            assert (r1[a], t1[a], u1[a]) == (r2[a], t2[a], u2[a])
    for bad, exc in (({"player_1": "x", "player_2": 0}, ValueError),
                     ({"player_1": None, "player_2": 0}, TypeError)):
        with pytest.raises(exc):
            e_fast.step(dict(bad))
        with pytest.raises(exc):
            e_py._step_native_plain(dict(bad))


def test_post_termination_rewards_match_torch():
    """Out-of-contract steps past the game's end: the torch env masks the
    terminal reward on an ended game and the engine does too, 10 frames on."""
    env = PikaZoo(EnvConfig(winning_score=1, auto_reset=False))
    state, _ = env.reset(21, "cpu")
    eng = NativeEngine(winning_score=1, auto_reset=False)
    matrix = NativeEngine.pack(state)
    gen = np.random.default_rng(4)
    post = -1
    for t in range(8000):
        acts = gen.integers(0, 18, size=2).astype(np.int32)
        state, ts = env.step(state, torch.from_numpy(acts))
        rewards, flags = eng.step(matrix, acts[None])
        np.testing.assert_array_equal(ts.rewards.numpy(), rewards[0], err_msg=f"t={t}")
        assert bool(ts.terminated) == bool(flags[0] & 1), f"t={t}"
        if post >= 0:
            assert rewards[0, 0] == 0 and rewards[0, 1] == 0
            post += 1
            if post >= 10:
                break
        elif bool(ts.terminated):
            post = 0
    assert post >= 10


def test_builds_go_to_the_ports_own_directory():
    """Both libraries live under ``build/native/`` of this checkout, named by
    a hash of their source and flags, apart from the JAX package's cache;
    the fast path steps the engine built here."""
    build_dir = os.path.join(REPO, "build", "native")
    engine_so, fastpath_so = native.engine_path(), native.fastpath_path()
    for path, stem in ((engine_so, "libpika_engine_"), (fastpath_so, "_pika_fastpath_")):
        assert str(path.parent) == build_dir and path.name.startswith(stem)
    assert fastpath_so.name.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert native._library()._name == str(engine_so)
    assert native._fastpath().__file__ == str(fastpath_so)
    assert not str(engine_so).startswith(jax_native._cache_dir())
    assert native.library_path("libpika_engine", native.NATIVE_DIR / "pika_engine.cc",
                               native.ENGINE_FLAGS + ("-g",)) != engine_so


def test_compile_atomic_success_and_failure(tmp_path, monkeypatch):
    """A build lands by rename; a failed one raises with the compiler's
    output and leaves no temporary file behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out = tmp_path / "x.so"
    native.compile_atomic(lambda dest: ["sh", "-c", f"echo hi > {dest}"], out)
    assert out.read_text() == "hi\n"
    with pytest.raises(native.NativeBuildError, match="boom"):
        native.compile_atomic(lambda dest: ["sh", "-c", "echo boom >&2; exit 1"],
                              tmp_path / "y.so")
    with pytest.raises(native.NativeBuildError, match="did not run"):
        native.compile_atomic(lambda dest: ["no-such-compiler-here", dest], tmp_path / "z.so")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["x.so"]


def test_a_failed_build_raises_in_the_adapter(monkeypatch, tmp_path):
    """``backend="native"`` raises the compiler's error: no path falls back."""
    broken = tmp_path / "pika_engine.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._library.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
            raw_env(seed=0, backend="native")
    finally:
        monkeypatch.undo()
        native._library.cache_clear()
    assert NativeEngine()._lib._name == str(native.engine_path())


def test_native_state_starts_from_the_torch_reset():
    """The adapter's episode 0 is the torch reset of ``fold_in(key, 0)``,
    packed; a JAX state carried across packs the same."""
    e = raw_env(seed=2 ** 32 + 11, backend="native", winning_score=3)
    env = PikaZoo(EnvConfig(winning_score=3, auto_reset=False))
    want, _ = env.reset(fold_in(key_data(2 ** 32 + 11), 0), "cpu")
    np.testing.assert_array_equal(e._matrix, NativeEngine.pack(want))
    assert_same(env_state_to_numpy(want),
                env_state_to_numpy(env_state_from_numpy(env_state_to_numpy(want))))
