"""The port's landing-loop algorithms == pikazoo_tpu's, exactly, on the CPU.

The event-leaping loop (``leap``), the hybrid loop (``hyb``), their ``"A,B"``
mixes and the ``split="ydir"`` candidate grouping of ``core/predict.py`` are
held against the JAX package's ``_leap_loop`` / ``_hyb_loop`` /
``landing_sims_any`` and against the frame loop, on a numpy-seeded copy of
``tests/test_leap_sim.py``'s state corpus (smaller boxes); ``one_leap`` is
held against JAX's ``_make_leap_step`` trip by trip, carry for carry.  The
kernel's modes (``csrc/landing.cu``, its leap in int32) run only on a card,
but its device code is plain C++: the ``g++`` build of its host export is
held against the plain frame loop in every mode.  Tolerance 0 throughout."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import predict as jax_predict
from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core import predict
from pikazoo_tpu_torch.core.predict_cuda import algo_name, landing_sims_batched


def state_corpus(seed: int, n: int, cap_box: bool = True):
    """tests/test_leap_sim.py's corpus: wide boxes, the net band, the walls,
    ground and ceiling, the |vy| <= 2000 cap box (``cap_box``: its balls far
    above the ceiling are clamped every frame, so the leap meets an event
    every iteration up to the 1000-iteration cap, the plain leap's slowest
    case) and the band-boundary lattice; (x, y, vx, vy) int32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def box(m, xlo, xhi, ylo, yhi, vlo, vhi, wlo, whi):
        return (rng.integers(xlo, xhi, m), rng.integers(ylo, yhi, m),
                rng.integers(vlo, vhi, m), rng.integers(wlo, whi, m))

    cases = [
        box(n, 0, 453, -300, 253, -64, 65, -128, 129),
        box(n, 180, 253, 150, 253, -6, 7, -12, 13),
        box(n // 2, 0, 45, -50, 253, -30, 31, -40, 41),
        box(n // 2, 408, 453, -50, 253, -30, 31, -40, 41),
        box(n // 2, 0, 453, 230, 260, -20, 21, -30, 31),
        box(n // 2, 0, 453, -10, 15, -20, 21, -30, 31),
    ]
    if cap_box:
        cases.append(box(n // 4, 0, 453, -10_000, 253, -64, 65, -2000, 2001))
    xs = np.tile(np.array([191, 192, 193, 215, 216, 217, 239, 240, 241]), 100)
    cases.append((xs, rng.integers(170, 200, xs.size), rng.integers(-4, 5, xs.size),
                  rng.integers(-8, 9, xs.size)))
    return tuple(np.ascontiguousarray(np.concatenate([c[i] for c in cases]).astype(np.int32))
                 for i in range(4))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain loops run thousands of ops on tensors of a few thousand
    elements: one thread each, since worker processes running side by side
    would otherwise oversubscribe the cores with torch's OpenMP threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def torch_cols(cols):
    return tuple(torch.from_numpy(c.copy()) for c in cols)


JAX_LOOPS = {"leap": jax_predict._leap_loop, "hyb": jax_predict._hyb_loop}
PORT_LOOPS = {"leap": predict.leap_loop, "hyb": predict.hyb_loop}


@pytest.mark.parametrize("full_rule", [True, False], ids=["full", "mistake"])
@pytest.mark.parametrize("algo", ["leap", "hyb"])
def test_plain_loop_matches_jax(algo, full_rule):
    """``leap_loop`` / ``hyb_loop`` == JAX's, and == JAX's frame loop."""
    cols = state_corpus(0, 2000)
    want = np.asarray(jax.jit(lambda *a: JAX_LOOPS[algo](*a, full_rule=full_rule))(*cols))
    frames = np.asarray(jax.jit(lambda *a: jax_predict._sim_loop(*a, full_rule=full_rule))(*cols))
    got = PORT_LOOPS[algo](*torch_cols(cols), full_rule=full_rule).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)


ANY_CASES = [(a, s) for a in ("iter", "leap", "hyb", "leap,iter", "iter,leap")
             for s in ("none", "ydir")]


@pytest.mark.parametrize("algo,split", ANY_CASES, ids=[f"{a}-{s}" for a, s in ANY_CASES])
def test_landing_sims_any_matches_jax(algo, split):
    """``landing_sims_any`` in every mode == JAX's in the same mode, and ==
    the port's default (the 7-lane frame loop).  The loops themselves meet
    the cap box in test_plain_loop_matches_jax."""
    cols = state_corpus(1, 500, cap_box=False)
    want_e, want_c = jax.jit(lambda *a: jax_predict.landing_sims_any(
        *a, algo=algo, split=split))(*cols)
    got_e, got_c = predict.landing_sims_any(*torch_cols(cols), algo=algo, split=split)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    base_e, base_c = predict.landing_sims_any(*torch_cols(cols))
    assert torch.equal(got_e, base_e) and torch.equal(got_c, base_c)


@pytest.mark.parametrize("full_rule", [True, False], ids=["full", "mistake"])
def test_one_leap_trip_by_trip(full_rule):
    """The float32 carry of ``one_leap`` equals JAX's after each of the first
    30 trips, and so do ``jump`` and ``exact_iteration`` alone."""
    cols = state_corpus(2, 1000)
    jax_one, jax_jump, jax_exact = (jax.jit(f) for f in jax_predict._make_leap_step(full_rule))
    one, jump, exact = predict.make_leap_step(full_rule)
    carry = predict.leap_carry(*torch_cols(cols))
    jcarry = tuple(jnp.asarray(c.numpy()) for c in carry)
    for trip in range(30):
        for port_fn, jax_fn in ((jump, jax_jump), (exact, jax_exact)):
            got, want = port_fn(carry), jax_fn(jcarry)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"trip {trip}")
        carry, jcarry = one(carry), jax_one(jcarry)
        for g, w in zip(carry, jcarry):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"trip {trip}")
    live = int((carry[2] != 0).sum())
    assert 0 < live < carry[2].numel()  # some lanes landed, some still leap


@pytest.fixture(scope="module")
def host_landing(tmp_path_factory):
    """A host (g++) build of ``csrc/landing.cu``: its ``landing_sims_host``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's device code for the host")
    lib_path = tmp_path_factory.mktemp("host") / "liblanding_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(lib_path), str(_build.CSRC_DIR / "landing.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.landing_sims_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 4 + \
        [ctypes.c_void_p] * 2
    lib.landing_sims_host.restype = ctypes.c_int

    def run(cols, algo_true: int, algo_cand: int, unroll: int):
        n = cols[0].size
        expected = np.zeros(n, np.int32)
        cand = np.zeros((6, n), np.int32)
        rc = lib.landing_sims_host(*(c.ctypes.data for c in cols), n, algo_true, algo_cand,
                                   unroll, expected.ctypes.data, cand.ctypes.data)
        return rc, expected, cand

    return run


MODES = [(t, c) for t in predict.ALGOS for c in predict.ALGOS]


@pytest.fixture(scope="module")
def corpus_iter():
    """The corpus and the plain frame loop's results on it."""
    cols = state_corpus(3, 6000)
    return cols, predict.landing_sims_any(*torch_cols(cols))


@pytest.mark.parametrize("algo_true,algo_cand", MODES, ids=[f"{t},{c}" for t, c in MODES])
def test_host_build_every_mode_matches_plain_iter(host_landing, corpus_iter, algo_true,
                                                  algo_cand):
    """The kernel's device code in every mode (int32 leap), over the whole
    corpus, == the plain frame loop; at each loop's default unroll and at
    unroll 3."""
    cols, (want_e, want_c) = corpus_iter
    codes = predict.ALGOS.index(algo_true), predict.ALGOS.index(algo_cand)
    for unroll in (0, 3):
        rc, got_e, got_c = host_landing(cols, *codes, unroll)
        assert rc == 0
        np.testing.assert_array_equal(got_e, want_e.numpy())
        np.testing.assert_array_equal(got_c, want_c.numpy())


def test_host_build_refuses_bad_codes(host_landing):
    cols = state_corpus(4, 8)
    assert host_landing(cols, 3, 0, 0)[0] == 1
    assert host_landing(cols, 0, -1, 0)[0] == 1
    assert host_landing(cols, 0, 0, -1)[0] == 1


def test_wrapper_on_cpu_takes_the_plain_modes():
    """``landing_sims_batched`` on CPU tensors: a mode of each loop, mixed
    and split, equals the default, no launch is counted, and an unknown mode
    raises."""
    cols = torch_cols(state_corpus(5, 100, cap_box=False))
    base = landing_sims_batched(*cols)
    before = dict(landing_sims_batched.launches_by_algo)
    for algo, split in (("leap", "ydir"), ("hyb,iter", "none"), ("iter,hyb", "ydir")):
        got = landing_sims_batched(*cols, algo=algo, split=split, unroll=2)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    assert landing_sims_batched.launches_by_algo == before
    assert algo_name("leap,leap") == "leap" and algo_name("iter,hyb") == "iter,hyb"
    for bad in (dict(algo="auto"), dict(algo="leap,frame"), dict(split="x"), dict(unroll=-1)):
        with pytest.raises(ValueError):
            landing_sims_batched(*cols, **bad)
