"""The port's fused rollout == pikazoo_tpu's, exactly, on the CPU.

The JAX side runs as the JAX package's own tests run it here: the Pallas
kernel in interpret mode, and, for the rule AI (whose interpret run is
marked slow there), the scanned ``step_batch`` fed ``fused_actions``.  The
port's side is ``fused_rollout`` on CPU tensors, i.e. its plain version.

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it
against the plain version there), but its frame code is plain C++ under a
host compiler: ``csrc/fused_step.cu`` built with g++ runs the same
functions over the envs in a host loop, and these tests hold that build
against JAX too, for floor division, unsigned words, the action counter,
latches, draw order and the landing sims.  All comparisons are bit-exact
(tolerance 0)."""

import ctypes
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import fused_step as jax_fused
from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu_torch import _build, fused_rollout
from pikazoo_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from pikazoo_tpu_torch.core import fused_step
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.envs.pika_volley import SERVE_MODES
from torch_helpers import assert_same

B = fused_step.BLOCK_ENVS

# The configs of tests/test_fused_step.py:40-51: (config kwargs, frames, seed).
JAX_KERNEL_CASES = {
    "winner": (dict(winning_score=2), 80, 0),
    "serve-random": (dict(winning_score=2, serve="random"), 60, 1),
    "serve-alternate": (dict(winning_score=1, serve="alternate"), 60, 3),
}
AI_AI = dict(winning_score=2, is_player1_computer=True, is_player2_computer=True)


def configs(kw):
    kw = dict(auto_reset=True, **kw)
    return JaxConfig(**kw), EnvConfig(**kw)


@pytest.fixture(scope="module")
def host_rollout(tmp_path_factory):
    """``rollout_packed`` of a host build of ``csrc/fused_step.cu``: returns
    a new matrix."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's frame code for the host")
    lib_path = tmp_path_factory.mktemp("host") / "libfused_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(lib_path), str(_build.CSRC_DIR / "fused_step.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.fused_step_nfields.argtypes = []
    lib.fused_step_nfields.restype = ctypes.c_int
    assert lib.fused_step_nfields() == fused_step.NFIELDS
    fn = lib.fused_rollout_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(packed, cfg, frames):
        out = packed.clone()
        assert fn(out.data_ptr(), out.shape[1], frames, cfg.winning_score,
                  SERVE_MODES.index(cfg.serve), int(cfg.is_player1_computer),
                  int(cfg.is_player2_computer), int(cfg.auto_reset), None) == 0
        return out

    return run


def jax_reset(cfg, seed):
    return JaxZoo(cfg).reset_batch(jax.random.key(seed), B)[0]


def port_state(jax_state):
    return env_state_from_numpy(jax.device_get(jax_state))


def assert_state_equal(jax_state, state, where):
    assert_same(jax.device_get(jax_state), env_state_to_numpy(state), where)


@functools.lru_cache(maxsize=None)
def jax_step(jcfg):
    """One jitted ``step_batch`` per config: its compile is most of a JAX
    run's cost here."""
    return jax.jit(JaxZoo(jcfg).step_batch)


def test_pack_state_matches_jax():
    """A mid-game state (30 frames) packs to the same 56 rows; an int seed
    gives the same action keys as ``jax.random.key(seed)``."""
    jcfg, _ = configs(AI_AI)
    state = jax_reset(jcfg, 21)
    rng = np.random.default_rng(21)
    for _ in range(30):
        state, _ = jax_step(jcfg)(
            state, jnp.asarray(rng.integers(0, 18, (B, 2)), jnp.int32))
    want = np.asarray(jax_fused.pack_state(state, jax.random.key(5)))
    got = fused_step.pack_state(port_state(state), 5)
    assert got.dtype == torch.int32 and got.shape == (fused_step.NFIELDS, B)
    np.testing.assert_array_equal(got.numpy(), want)
    key_data = np.asarray(jax.random.key_data(jax.random.key(5)))
    np.testing.assert_array_equal(
        fused_step.pack_state(port_state(state), key_data).numpy(), want)


def test_unpack_inverts_pack():
    state, _ = PikaZoo(EnvConfig(serve="random")).reset_batch(3, B, device="cpu")
    back = fused_step.unpack_state(fused_step.pack_state(state, 9))
    assert_same(env_state_to_numpy(state), env_state_to_numpy(back))


@pytest.mark.parametrize("start", [0, 37])
def test_fused_actions_match_jax(start):
    want = np.asarray(jax_fused.fused_actions(jax.random.key(4), 256, 40,
                                              start=start))
    got = fused_step.fused_actions(4, 256, 40, start=start)
    assert got.dtype == torch.int32 and got.shape == (40, 256, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(JAX_KERNEL_CASES))
def test_rollout_matches_jax_kernel(case, host_rollout):
    """The port (plain version and the kernel's host build) == JAX
    ``fused_rollout`` run in interpret mode."""
    kw, frames, seed = JAX_KERNEL_CASES[case]
    jcfg, cfg = configs(kw)
    start = jax_reset(jcfg, seed)
    want = jax_fused.fused_rollout(start, jax.random.key(seed + 7), jcfg, frames,
                                   interpret=True)
    assert_state_equal(want, fused_rollout(port_state(start), seed + 7, cfg, frames),
                       f"{case} plain")
    packed = fused_step.pack_state(port_state(start), seed + 7)
    assert_state_equal(want, fused_step.unpack_state(host_rollout(packed, cfg, frames)),
                       f"{case} host build")


def scanned(jcfg, start, seed, frames):
    """JAX ``step_batch`` over ``fused_actions`` (the fused stream)."""
    actions = jax_fused.fused_actions(jax.random.key(seed), B, frames)
    state = start
    for t in range(frames):
        state, _ = jax_step(jcfg)(state, actions[t])
    return state


def test_ai_rollout_matches_jax_scanned(host_rollout):
    jcfg, cfg = configs(AI_AI)
    start = jax_reset(jcfg, 2)
    want = scanned(jcfg, start, 9, 50)
    assert_state_equal(want, fused_rollout(port_state(start), 9, cfg, 50), "plain")
    packed = fused_step.pack_state(port_state(start), 9)
    assert_state_equal(want, fused_step.unpack_state(host_rollout(packed, cfg, 50)),
                       "host build")


# Long horizons with a computer seat, so rounds and games end under the AI
# (its rallies last ~150 frames): (config kwargs, frames, seed).
HOST_AI_CASES = {
    "ai-ai": (AI_AI, 250, 31),
    "random-ai-serve-random-noauto": (dict(winning_score=2, serve="random",
                                           is_player2_computer=True,
                                           auto_reset=False), 150, 32),
}


@pytest.mark.parametrize("case", list(HOST_AI_CASES))
def test_host_build_matches_jax_with_ai(case, host_rollout):
    kw, frames, seed = HOST_AI_CASES[case]
    kw = dict(auto_reset=True, **kw) if "auto_reset" not in kw else kw
    jcfg, cfg = JaxConfig(**kw), EnvConfig(**kw)
    start = jax_reset(jcfg, seed)
    want = scanned(jcfg, start, seed, frames)
    got = fused_step.unpack_state(host_rollout(
        fused_step.pack_state(port_state(start), seed), cfg, frames))
    assert_state_equal(want, got, case)
    assert int(got.scores.sum()) > 0


def test_two_calls_continue_one(host_rollout):
    """Actions are keyed on the cumulative step_count: 2 x 30 frames == 60."""
    cfg = EnvConfig(winning_score=2)
    state, _ = PikaZoo(cfg).reset_batch(5, B, device="cpu")
    once = fused_rollout(state, 6, cfg, 60)
    twice = fused_rollout(fused_rollout(state, 6, cfg, 30), 6, cfg, 30)
    assert_same(env_state_to_numpy(once), env_state_to_numpy(twice))
    assert int(once.step_count.min()) == int(once.step_count.max()) == 60
    assert_same(env_state_to_numpy(once),
                env_state_to_numpy(fused_step.fused_rollout_plain(state, 6, cfg, 60)))
    packed = fused_step.pack_state(state, 6)
    host_twice = host_rollout(host_rollout(packed, cfg, 30), cfg, 30)
    np.testing.assert_array_equal(host_twice.numpy(),
                                  fused_step.pack_state(once, 6).numpy())


def to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    return type(tree)(*(to_device(sub, device) for sub in tree))


def test_rollout_rejects_bad_states():
    cfg = EnvConfig()
    state, _ = PikaZoo(cfg).reset_batch(0, B + 256, device="cpu")
    with pytest.raises(ValueError, match="multiple of 1024"):
        fused_rollout(state, 0, cfg, 1)
    state, _ = PikaZoo(cfg).reset_batch(0, B, device="cpu")
    with pytest.raises(ValueError, match="no version"):
        fused_rollout(to_device(state, "meta"), 0, cfg, 1)
    with pytest.raises(TypeError, match="int32"):
        fused_rollout(state._replace(step_count=state.step_count.long()), 0, cfg, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rollout(state._replace(scores=state.scores.t().contiguous().t()),
                      0, cfg, 1)
    with pytest.raises(ValueError, match="multiple of 1024"):
        fused_step.rollout_packed(torch.zeros((fused_step.NFIELDS, 512),
                                              dtype=torch.int32), cfg, 1)


def test_cpu_call_launches_nothing():
    cfg = EnvConfig(is_player1_computer=True)
    state, _ = PikaZoo(cfg).reset_batch(1, B, device="cpu")
    before = fused_rollout.launches
    out = fused_rollout(state, 2, cfg, 3)
    assert fused_rollout.launches == before
    assert int(out.step_count.min()) == 3


def test_kernel_rows_follow_pack_order():
    """The kernel's field enum names the packed rows in pack order."""
    text = (_build.CSRC_DIR / "fused_step.cu").read_text()
    body = re.search(r"enum Field \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"\w+", re.sub(r"//[^\n]*", "", body))
    want = ([f"P1_{f.upper()}" for f in fused_step._PLAYER_FIELDS] +
            [f"P2_{f.upper()}" for f in fused_step._PLAYER_FIELDS] +
            [f"BALL_{f.upper()}" for f in fused_step._BALL_FIELDS] +
            [f.upper() for f in fused_step._GAME_FIELDS] + ["NFIELDS"])
    assert names == want
    assert fused_step.NFIELDS == 56 == len(want) - 1
    assert fused_step._GAME_FIELDS == jax_fused._GAME_FIELDS
    assert fused_step._PLAYER_FIELDS == jax_fused._PLAYER_FIELDS
    assert fused_step._BALL_FIELDS == jax_fused._BALL_FIELDS


def test_library_path_follows_headers(monkeypatch, tmp_path):
    """An edit to an included header names a new library, so a stale one is
    never reused."""
    for src in _build.CSRC_DIR.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path("fused_step", fused_step.SOURCES)
    assert before == _build.library_path("fused_step", fused_step.SOURCES)
    header = tmp_path / "landing_sim.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path("fused_step", fused_step.SOURCES)
    assert after != before and after.name.startswith("libfused_step_")
