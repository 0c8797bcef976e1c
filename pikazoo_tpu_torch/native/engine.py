"""ctypes bindings and state packing for the native C++ host engine.

``pika_engine.cc`` steps the env on the host with the same semantics as
:class:`~pikazoo_tpu_torch.envs.pika_volley.PikaZoo`, over a packed
``(B, NFIELDS)`` int32 state matrix that holds the threefry stream key too
(``rng_lo`` / ``rng_hi``).  Its draws come from the state's own key
(production mode, ``oracle=None``: bit-equal to the torch env from the same
key) or from a caller's ``(B, CAP)`` buffer indexed by the draw counter
(oracle mode, for parity replays).  ``fastpath.c`` is a CPython extension
that serves the PettingZoo adapter's whole dict-level step in one native
call.

Both build at first use with ``g++`` / ``gcc`` into ``build/native/`` at the
root of the checkout, each named by a hash of its source and flags, so a
changed source is rebuilt and an unchanged one reused; the fast path is
handed the path of the engine built here.  A failed build raises
:class:`NativeBuildError` with the compiler's output; there is no fallback.

:meth:`NativeEngine.pack` / :meth:`unpack` convert to and from the port's
:class:`~pikazoo_tpu_torch.envs.pika_volley.EnvState`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from pikazoo_tpu_torch.core.state import host_state

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "native"

# Must match enum Field in pika_engine.cc.
_PLAYER_FIELDS = ["x", "y", "y_velocity", "state", "frame_number",
                  "normal_status_arm_swing_direction",
                  "delay_before_next_frame", "diving_direction",
                  "lying_down_duration_left", "is_collision_with_ball_happened",
                  "computer_boldness", "computer_where_to_stand_by",
                  "is_winner", "game_ended"]
_BALL_FIELDS = ["x", "y", "x_velocity", "y_velocity", "previous_x",
                "previous_y", "previous_previous_x", "previous_previous_y",
                "is_power_hit", "expected_landing_point_x", "rotation",
                "fine_rotation", "punch_effect_x", "punch_effect_y",
                "punch_effect_radius"]
_GAME_FIELDS = ["key1", "key2", "score1", "score2", "is_player2_serve",
                "round_ended", "game_ended", "step_count", "draw_counter",
                "rng_lo", "rng_hi"]
FIELDS = ([f"p1.{f}" for f in _PLAYER_FIELDS] +
          [f"p2.{f}" for f in _PLAYER_FIELDS] +
          [f"ball.{f}" for f in _BALL_FIELDS] + _GAME_FIELDS)
NFIELDS = len(FIELDS)

SERVE_MODES = {"winner": 0, "alternate": 1, "random": 2}

# No OpenMP: in a process that has loaded torch, the engine shares torch's
# OpenMP runtime, and a parallel region over the adapter's one env waits on
# torch's threads for far longer than the step takes.  Batched calls run on
# one core.
ENGINE_FLAGS = ("-O3", "-shared", "-fPIC")
FASTPATH_FLAGS = ("-O2", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """The compiler is missing or refused a native source, or the library
    it built does not load."""


def library_path(stem: str, source: Path, flags, suffix: str = ".so") -> Path:
    """Where the library built from ``source`` with ``flags`` lives."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}{suffix}"


def compile_atomic(cmd_for, out: Path) -> Path:
    """Run ``cmd_for(tmp)`` to build into a private temporary file, then
    rename it to ``out``: a concurrent build or reader sees all or nothing.
    Raises :class:`NativeBuildError` with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
    os.close(fd)
    cmd = cmd_for(tmp)
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"{cmd[0]} did not run: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(f"{cmd[0]} failed ({proc.returncode}) building {out.name}:"
                                   f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def engine_path() -> Path:
    """Build ``pika_engine.cc`` unless an up-to-date library is there;
    returns its path."""
    src = NATIVE_DIR / "pika_engine.cc"
    out = library_path("libpika_engine", src, ENGINE_FLAGS)
    if not out.exists():
        compile_atomic(lambda tmp: ["g++", *ENGINE_FLAGS, str(src), "-o", tmp], out)
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path = engine_path()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"{path} does not load: {e}") from e
    if lib.pika_nfields() != NFIELDS:
        raise NativeBuildError("pika_engine.cc's state layout differs from FIELDS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.pika_step_batch.argtypes = [i32p, i32p, i32p, i32p, u8p] + [ctypes.c_int] * 7
    lib.pika_run_batch.argtypes = [i32p, i32p, i32p, i32p, u8p] + [ctypes.c_int] * 8
    lib.pika_obs_batch.argtypes = [i32p, i32p, ctypes.c_int]
    lib.pika_step_obs_batch.argtypes = [i32p, i32p, i32p, i32p, u8p, i32p] + \
        [ctypes.c_int] * 7
    lib.pika_reset_batch.argtypes = [i32p, i32p] + [ctypes.c_int] * 3
    return lib


def fastpath_path() -> Path:
    """Build ``fastpath.c`` (a CPython extension, tagged with the
    interpreter's ABI) unless an up-to-date one is there; returns its path."""
    import numpy  # noqa: PLC0415

    src = NATIVE_DIR / "fastpath.c"
    includes = (f"-I{sysconfig.get_paths()['include']}", f"-I{numpy.get_include()}")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = library_path("_pika_fastpath", src, FASTPATH_FLAGS + includes, suffix)
    if not out.exists():
        compile_atomic(lambda tmp: ["gcc", *FASTPATH_FLAGS, *includes, str(src), "-o", tmp,
                                    "-ldl"], out)
    return out


@functools.lru_cache(maxsize=1)
def _fastpath():
    """The fast path's module, loaded from its own file under the module
    name its init function carries."""
    path = str(fastpath_path())
    loader = importlib.machinery.ExtensionFileLoader("_pika_fastpath", path)
    spec = importlib.util.spec_from_loader("_pika_fastpath", loader)
    module = importlib.util.module_from_spec(spec)
    try:
        loader.exec_module(module)
    except ImportError as e:
        raise NativeBuildError(f"{path} does not load: {e}") from e
    return module


def make_fast_stepper(state: np.ndarray, scores: list, *, winning_score: int,
                      serve_mode: int, is_p1_computer: int, is_p2_computer: int,
                      auto_reset: int):
    """Native dict-level stepper bound to row 0 of ``state`` and the shared
    mutable ``scores`` list.  ``step(actions_dict)`` returns the five
    PettingZoo dicts and the flags bitmask, all built in C, stepping the
    engine library built here."""
    _library()
    return _fastpath().FastStepper(
        str(engine_path()), state, scores, winning_score, serve_mode,
        is_p1_computer, is_p2_computer, auto_reset,
        FIELDS.index("score1"), FIELDS.index("score2"))


def _key_words(rng_key, batch: int) -> np.ndarray:
    """``(batch, 2)`` int32 bits of keys given as int32 bits or uint32 words."""
    words = np.asarray(rng_key).reshape(batch, 2)
    if words.dtype != np.int32:
        words = (words.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return words


class NativeEngine:
    """Batched host engine with the torch env's exact step semantics over a
    ``(B, NFIELDS)`` int32 matrix; :meth:`pack` / :meth:`unpack` convert to
    and from the port's ``EnvState``."""

    def __init__(self, winning_score: int = 15, serve: str = "winner",
                 is_player1_computer: bool = False,
                 is_player2_computer: bool = False, auto_reset: bool = True):
        self._lib = _library()
        self.winning_score = winning_score
        self.serve_mode = SERVE_MODES[serve]
        self.p1_cpu = int(is_player1_computer)
        self.p2_cpu = int(is_player2_computer)
        self.auto_reset = int(auto_reset)

    # ---------------------------------------------------------- conversion --
    @staticmethod
    def pack(env_state) -> np.ndarray:
        """``EnvState`` (tensor leaves on any device, batch shape ``()`` or
        ``(B,)``, or numpy leaves) -> ``(B, NFIELDS)`` int32, in one copy to
        the host."""
        s = host_state(env_state)
        batch = int(np.prod(np.shape(s.round_ended)))
        col = lambda x: np.asarray(x).reshape(batch)
        pair = lambda x: np.asarray(x).reshape(batch, 2)
        latch, scores = pair(s.power_hit_key_down_prev), pair(s.scores)
        key = _key_words(s.rng_key, batch)
        cols = ([col(getattr(s.p1, f)) for f in _PLAYER_FIELDS] +
                [col(getattr(s.p2, f)) for f in _PLAYER_FIELDS] +
                [col(getattr(s.ball, f)) for f in _BALL_FIELDS] +
                [latch[:, 0], latch[:, 1], scores[:, 0], scores[:, 1],
                 col(s.is_player2_serve), col(s.round_ended), col(s.game_ended),
                 col(s.step_count), col(s.draw_counter), key[:, 0], key[:, 1]])
        return np.ascontiguousarray(np.stack(cols, axis=1).astype(np.int32))

    @staticmethod
    def unpack(matrix: np.ndarray, like):
        """``(B, NFIELDS)`` int32 -> ``EnvState`` with ``like``'s batch shape
        (``()`` takes row 0) and tensors on ``like``'s device, in one copy."""
        device = like.scores.device
        rows = torch.from_numpy(np.ascontiguousarray(matrix.T)).to(device)
        squeeze = like.round_ended.dim() == 0
        one = lambda j: rows[j, 0] if squeeze else rows[j]
        two = lambda j: (rows[j:j + 2, 0] if squeeze else rows[j:j + 2].T).contiguous()
        at = iter(range(NFIELDS))
        p1 = like.p1._make(one(next(at)) for _ in _PLAYER_FIELDS)
        p2 = like.p2._make(one(next(at)) for _ in _PLAYER_FIELDS)
        ball = like.ball._make(one(next(at)) for _ in _BALL_FIELDS)
        g = FIELDS.index("key1")
        return like._replace(
            p1=p1, p2=p2, ball=ball,
            power_hit_key_down_prev=two(g),
            scores=two(g + 2),
            is_player2_serve=one(g + 4),
            round_ended=one(g + 5),
            game_ended=one(g + 6),
            step_count=one(g + 7),
            draw_counter=one(g + 8),
            rng_key=two(g + 9),
        )

    # ----------------------------------------------------------------- run --
    @staticmethod
    def _oracle_or_production(oracle, batch):
        """``oracle=None`` selects production mode: draws from the state's
        threefry key (bit-equal to the torch env)."""
        if oracle is None:
            return np.zeros((batch, 1), np.int32), 0
        return np.ascontiguousarray(oracle, np.int32), oracle.shape[1]

    def step(self, state: np.ndarray, actions: np.ndarray,
             oracle: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One frame in place.  ``actions`` (B, 2); ``oracle`` (B, CAP) or
        None.  Returns (rewards (B, 2), flags (B,): 1 terminated | 2 round
        ended | 4 ball touched the ground)."""
        batch = state.shape[0]
        rewards = np.empty((batch, 2), np.int32)
        flags = np.empty((batch,), np.uint8)
        oracle, cap = self._oracle_or_production(oracle, batch)
        self._lib.pika_step_batch(state, np.ascontiguousarray(actions, np.int32), oracle,
                                  rewards, flags, batch, self.winning_score, self.serve_mode,
                                  self.p1_cpu, self.p2_cpu, self.auto_reset, cap)
        return rewards, flags

    def run(self, state: np.ndarray, actions: np.ndarray,
            oracle: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Many frames in place: ``actions`` (T, B, 2); the last frame's
        rewards and flags."""
        frames, batch = actions.shape[:2]
        rewards = np.empty((batch, 2), np.int32)
        flags = np.empty((batch,), np.uint8)
        oracle, cap = self._oracle_or_production(oracle, batch)
        self._lib.pika_run_batch(state, np.ascontiguousarray(actions, np.int32), oracle,
                                 rewards, flags, batch, frames, self.winning_score,
                                 self.serve_mode, self.p1_cpu, self.p2_cpu, self.auto_reset,
                                 cap)
        return rewards, flags

    def obs(self, state: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Mirrored (B, 2, 35) int32 observations (``envs.observations``)."""
        batch = state.shape[0]
        if out is None:
            out = np.empty((batch, 2, 35), np.int32)
        self._lib.pika_obs_batch(state, out, batch)
        return out

    def reset(self, state: np.ndarray, rng_key=None,
              oracle: Optional[np.ndarray] = None) -> None:
        """New-game reset in place, as ``PikaZoo.reset(key, carry=state)``:
        optionally install new stream keys (``(B, 2)`` int32 bits or uint32
        words), zero the draw counter, clear scores and flags and round-init
        with the boldness / serve draws.  The other fields carry over."""
        batch = state.shape[0]
        if rng_key is not None:
            state[:, -2:] = _key_words(rng_key, batch)
        state[:, FIELDS.index("draw_counter")] = 0
        oracle, cap = self._oracle_or_production(oracle, batch)
        self._lib.pika_reset_batch(state, oracle, batch, self.serve_mode, cap)

    def single_stepper(self, state: np.ndarray) -> "SingleStepper":
        """Interactive stepper bound to row 0 of ``state``."""
        return SingleStepper(self, state)


class SingleStepper:
    """Single-env stepper over a bound ``(1, NFIELDS)`` state.

    :meth:`NativeEngine.step` pays for ctypes' argument checks on every
    call, more than the physics costs; this binds raw pointers once (the
    state and private action / reward / flag / obs buffers) so a step is one
    unchecked foreign call.  It mutates the bound state in place and reuses
    its buffers across calls (copy what you keep).  :meth:`step_obs` is the
    plain version of the fast path's step.
    """

    def __init__(self, engine: NativeEngine, state: np.ndarray):
        if state.shape != (1, NFIELDS) or state.dtype != np.int32 \
                or not state.flags["C_CONTIGUOUS"]:
            raise ValueError(f"a single stepper binds a C-contiguous (1, {NFIELDS}) int32 "
                             f"state, got {state.shape} {state.dtype}")
        self.state = state
        self.actions = np.zeros((1, 2), np.int32)
        self.rewards = np.zeros((1, 2), np.int32)
        self.flags = np.zeros((1,), np.uint8)
        self.obs = np.zeros((1, 2, 35), np.int32)
        self._oracle = np.zeros((1, 1), np.int32)
        # A second handle on the library whose functions take no argtypes.
        raw = ctypes.CDLL(engine._lib._name)
        for fn in (raw.pika_step_batch, raw.pika_obs_batch, raw.pika_step_obs_batch):
            fn.restype = None
            fn.argtypes = None
        vp = ctypes.c_void_p
        self._p_state = vp(state.ctypes.data)
        self._p_obs = vp(self.obs.ctypes.data)
        ptrs = (self._p_state, vp(self.actions.ctypes.data), vp(self._oracle.ctypes.data),
                vp(self.rewards.ctypes.data), vp(self.flags.ctypes.data))
        config = (engine.winning_score, engine.serve_mode, engine.p1_cpu, engine.p2_cpu,
                  engine.auto_reset, 0)
        self._step_args = (*ptrs, 1, *config)
        self._step_obs_args = (*ptrs, self._p_obs, 1, *config)
        self._f_step = raw.pika_step_batch
        self._f_step_obs = raw.pika_step_obs_batch
        self._f_obs = raw.pika_obs_batch
        self._raw = raw

    def step(self, a1: int, a2: int) -> Tuple[np.ndarray, int]:
        """One frame.  Returns (rewards (2,) view, flags bitmask)."""
        self.actions[0, 0] = a1
        self.actions[0, 1] = a2
        self._f_step(*self._step_args)
        return self.rewards[0], int(self.flags[0])

    def step_obs(self, a1: int, a2: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """One frame and its observation in one foreign call.  Returns (obs
        (2, 35) view, rewards (2,) view, flags bitmask)."""
        self.actions[0, 0] = a1
        self.actions[0, 1] = a2
        self._f_step_obs(*self._step_obs_args)
        return self.obs[0], self.rewards[0], int(self.flags[0])

    def observe(self) -> np.ndarray:
        """(2, 35) mirrored observation view of the current state."""
        self._f_obs(self._p_state, self._p_obs, 1)
        return self.obs[0]
