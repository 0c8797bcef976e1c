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
from pikazoo_tpu_torch.core import predict
from pikazoo_tpu_torch.tools import k3_probe
from torch_helpers import assert_same, named_leaves

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
def host_library(tmp_path_factory):
    """A host (g++) build of ``csrc/fused_step.cu``: its frame and pool code
    on emulated 32-lane warps."""
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
    counted = lib.fused_rollout_count_launch
    counted.argtypes = fn.argtypes[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
    counted.restype = ctypes.c_int
    assert lib.fused_step_num_counts() == len(fused_step.POOL_COUNTS)
    lib.fused_step_host_sim.argtypes = [ctypes.c_int32] * 5
    lib.fused_step_host_sim.restype = ctypes.c_int32
    return lib


def launch_args(packed, cfg, frames):
    return (packed.data_ptr(), packed.shape[1], frames, cfg.winning_score,
            SERVE_MODES.index(cfg.serve), int(cfg.is_player1_computer),
            int(cfg.is_player2_computer), int(cfg.auto_reset))


@pytest.fixture(scope="module")
def host_rollout(host_library):
    """``rollout_packed`` of the host build: returns a new matrix."""
    def run(packed, cfg, frames):
        out = packed.clone()
        assert host_library.fused_rollout_launch(*launch_args(out, cfg, frames),
                                                 None) == 0
        return out

    return run


@pytest.fixture(scope="module")
def host_counted(host_library):
    """The host build's counting entry: (new matrix, the landing pool's
    counts by name)."""
    def run(packed, cfg, frames):
        out = packed.clone()
        counts = np.zeros(len(fused_step.POOL_COUNTS), np.int64)
        assert host_library.fused_rollout_count_launch(
            *launch_args(out, cfg, frames), counts.ctypes.data, None) == 0
        return out, dict(zip(fused_step.POOL_COUNTS, counts.tolist()))

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


def scanned(jcfg, start, seed, frames, first=0):
    """JAX ``step_batch`` over ``fused_actions`` (the fused stream) from
    step_count ``first``."""
    actions = jax_fused.fused_actions(jax.random.key(seed), B, frames, start=first)
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


# ---- the warp's landing pool, on the host build ----

RALLY_SEED, RALLY_FRAMES, RALLY_LOOKAHEAD = 3, 90, 12


def take_envs(state, idx):
    """The envs ``idx`` of a batched EnvState, in that order."""
    if torch.is_tensor(state):
        return state[idx].contiguous()
    return type(state)(*(take_envs(sub, idx) for sub in state))


def to_jax(state):
    """A port EnvState as the JAX package's, leaf for leaf."""
    template = jax_reset(configs(AI_AI)[0], 0)
    leaves = [jnp.asarray(leaf) for _, leaf in named_leaves(env_state_to_numpy(state))]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), leaves)


@pytest.fixture(scope="module")
def rally():
    """A mid-rally AI-vs-AI state at B=1024 (32 warps): the plain version
    RALLY_FRAMES frames from a reset, its envs reordered so that those whose
    computer seats ask for the candidates most often in the next
    RALLY_LOOKAHEAD frames fill the first warps.  Returns (state, the plain
    version's landing work over those frames)."""
    _, cfg = configs(AI_AI)
    state, _ = PikaZoo(cfg).reset_batch(RALLY_SEED, B, device="cpu")
    packed = fused_step.rollout_packed_plain(fused_step.pack_state(state, RALLY_SEED),
                                             cfg, RALLY_FRAMES)
    _, work = k3_probe.landing_work(packed, cfg, RALLY_LOOKAHEAD)
    order = torch.argsort(work.asks.any(1).sum(0), descending=True, stable=True)
    state = take_envs(fused_step.unpack_state(packed), order)
    _, work = k3_probe.landing_work(fused_step.pack_state(state, RALLY_SEED), cfg,
                                    RALLY_LOOKAHEAD)
    return state, work


def hold_host_against_jax(state, frames, host_counted):
    """The host build == JAX ``fused_rollout`` (interpret) == the scanned
    ``step_batch``, leaf by leaf, ``frames`` frames from ``state`` (every
    env at one step_count).  Returns the host build's pool counts."""
    jcfg, cfg = configs(AI_AI)
    first = int(state.step_count[0])
    start = to_jax(state)
    want = jax_fused.fused_rollout(start, jax.random.key(RALLY_SEED), jcfg, frames,
                                   interpret=True)
    assert_same(jax.device_get(want),
                jax.device_get(scanned(jcfg, start, RALLY_SEED, frames, first)),
                "JAX kernel vs scanned")
    got, counts = host_counted(fused_step.pack_state(state, RALLY_SEED), cfg, frames)
    assert_state_equal(want, fused_step.unpack_state(got), "host build")
    return counts


def test_pool_refill_matches_jax(rally, host_counted):
    """(a) Many envs of one warp ask for the candidates, so its lanes take
    job after job: the host build still equals JAX bit for bit."""
    state, work = rally
    asking = work.asks.any(1).reshape(RALLY_LOOKAHEAD, -1, 32).sum(-1)
    assert int(asking[:, 0].max()) >= 16  # the first warp: many askers in one frame
    counts = hold_host_against_jax(state, RALLY_LOOKAHEAD, host_counted)
    # 16 or more askers post 96 or more candidate jobs for 32 lanes.
    assert counts["candidate_jobs"] == 6 * int(work.asks.any(1).sum())
    assert counts["jobs_run"] == B * RALLY_LOOKAHEAD + counts["candidate_jobs"]


def test_both_seats_share_candidates(rally, host_counted):
    """(b) Both computer seats airborne near the ball in one frame: the env
    posts its 6 candidates once and both seats decide from them."""
    state = rally[0]
    env = torch.arange(4)
    p1 = state.p1._replace(x=state.p1.x.index_fill(0, env, 200),
                           y=state.p1.y.index_fill(0, env, 150),
                           y_velocity=state.p1.y_velocity.index_fill(0, env, -3),
                           state=state.p1.state.index_fill(0, env, 1))
    p2 = state.p2._replace(x=state.p2.x.index_fill(0, env, 232),
                           y=state.p2.y.index_fill(0, env, 150),
                           y_velocity=state.p2.y_velocity.index_fill(0, env, -3),
                           state=state.p2.state.index_put((env,), torch.tensor([1, 2, 1, 2],
                                                                               dtype=torch.int32)))
    ball = state.ball._replace(
        x=state.ball.x.index_fill(0, env, 216),
        y=state.ball.y.index_put((env,), torch.tensor([140, 145, 150, 155], dtype=torch.int32)),
        x_velocity=state.ball.x_velocity.index_put((env,), torch.tensor([3, -3, 5, -5],
                                                                        dtype=torch.int32)),
        y_velocity=state.ball.y_velocity.index_put((env,), torch.tensor([4, -2, 6, 1],
                                                                        dtype=torch.int32)))
    state = state._replace(p1=p1, p2=p2, ball=ball,
                           round_ended=state.round_ended.index_fill(0, env, 0),
                           game_ended=state.game_ended.index_fill(0, env, 0))
    _, cfg = configs(AI_AI)
    _, work = k3_probe.landing_work(fused_step.pack_state(state, RALLY_SEED), cfg, 1)
    assert bool(work.asks[0, :, :4].all())
    _, counts = host_counted(fused_step.pack_state(state, RALLY_SEED), cfg, 1)
    assert counts["candidate_jobs"] == 6 * int(work.asks[0].any(0).sum())
    assert counts["candidate_jobs"] < 6 * int(work.asks[0].sum())
    hold_host_against_jax(state, 6, host_counted)


def test_pool_bookkeeping_each_frame(rally, host_counted):
    """(c) Each frame every warp posts its 32 true balls and 6 jobs for each
    env that asks, and runs each exactly once (the host build counts a
    result written other than once in its frame as a miss); the iterations
    are the plain version's."""
    state, work = rally
    _, cfg = configs(AI_AI)
    packed = fused_step.pack_state(state, RALLY_SEED)
    for t in range(RALLY_LOOKAHEAD):
        packed, counts = host_counted(packed, cfg, 1)
        asking = int(work.asks[t].any(0).sum())
        iterations = int(work.true_iterations[t].sum() + work.candidate_iterations[t].sum())
        assert counts == dict(true_jobs=B, candidate_jobs=6 * asking,
                              jobs_run=B + 6 * asking, iterations=iterations,
                              pool_steps=counts["pool_steps"], misses=0), t
        # A warp takes at least its longest true ball, and at least its
        # iterations over 32 lanes.
        warp_iters = (work.true_iterations[t] + work.candidate_iterations[t]).reshape(-1, 32)
        assert counts["pool_steps"] >= int(work.true_iterations[t].reshape(-1, 32).amax(1).sum())
        assert counts["pool_steps"] >= int(((warp_iters.sum(1) + 31) // 32).sum())


# Edge cases of the landing loop: (x, y, vx, vy).
SIM_EDGE_CASES = {
    "vx0-net-trap": (216, 180, 0, 1),
    "vx0-open-air": (100, 50, 0, -3),
    "cap": (216, 180, 500, 1),
    "net-y191": (216, 191, 3, 2),
    "net-y192": (216, 192, 3, 2),
    "net-y191-rising": (200, 191, -2, -1),
    "net-y192-left": (205, 192, -4, 6),
    "wall-left": (25, 100, -10, -5),
    "wall-right": (428, 200, 8, 3),
    "wall-corner-ceiling": (20, 0, -20, -60),
}


@pytest.mark.parametrize("full_rule", [True, False], ids=["full", "mistake"])
@pytest.mark.parametrize("case", list(SIM_EDGE_CASES))
def test_sim_over_sim_step_matches_plain(case, full_rule, host_library, monkeypatch):
    """(d) ``sim``, a loop over ``sim_step``, == the plain ``sim_loop``."""
    x, y, vx, vy = SIM_EDGE_CASES[case]
    live = [0]
    one_iteration = predict._one_iteration

    def counting(x_, y_, vx_, vy_, count, rule):
        live[0] += int((vx_ != 0).sum())
        return one_iteration(x_, y_, vx_, vy_, count, rule)

    monkeypatch.setattr(predict, "_one_iteration", counting)
    lane = lambda v: torch.tensor([v], dtype=torch.int32)
    want = int(predict.sim_loop(lane(x), lane(y), lane(vx), lane(vy),
                                torch.tensor(full_rule))[0])
    assert host_library.fused_step_host_sim(x, y, vx, vy, int(full_rule)) == want
    if case.startswith("vx0"):
        assert live[0] == 0
    if case == "cap" and not full_rule:
        assert live[0] == 1000  # the iteration cap ends it, not the ground


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


def test_counting_instance_is_card_only():
    cfg = EnvConfig(is_player1_computer=True, is_player2_computer=True)
    state, _ = PikaZoo(cfg).reset_batch(1, B, device="cpu")
    with pytest.raises(ValueError, match="card only"):
        fused_step.rollout_packed_counted(fused_step.pack_state(state, 2), cfg, 1)


def test_cpu_call_launches_nothing():
    cfg = EnvConfig(is_player1_computer=True)
    state, _ = PikaZoo(cfg).reset_batch(1, B, device="cpu")
    before = fused_rollout.launches
    out = fused_rollout(state, 2, cfg, 3)
    assert fused_rollout.launches == before
    assert int(out.step_count.min()) == 3


def test_kernel_rows_follow_pack_order():
    """The kernel's field enum (in the frame code it shares with the
    learner step) names the packed rows in pack order."""
    text = (_build.CSRC_DIR / "env_frame.cuh").read_text()
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
