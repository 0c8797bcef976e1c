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


def build_host(tmp_path_factory, *flags):
    """A host (g++) build of ``csrc/landing.cu`` (``flags`` added): its
    ``landing_sims_host`` as ``run(cols, algo_true, algo_cand, unroll)``,
    the library as ``run.lib``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's device code for the host")
    lib_path = tmp_path_factory.mktemp("host") / "liblanding_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", *flags, "-shared", "-fPIC",
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

    run.lib = lib

    return run


@pytest.fixture(scope="module")
def host_landing(tmp_path_factory):
    """A host (g++) build of ``csrc/landing.cu``: its ``landing_sims_host``."""
    return build_host(tmp_path_factory)


@pytest.fixture(scope="module")
def host_landing_overflow_checked(tmp_path_factory):
    """The same with every signed int32 overflow reported on stderr."""
    return build_host(tmp_path_factory, "-fsanitize=signed-integer-overflow")


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


# The boxes the host tests exhaust: quot's multiply-high box (csrc/landing_sim.cuh's
# kQuotMax), and the (|vy|, distance) box of k_disp's one-step checks, which holds every
# root the leap corpus reaches (see test_corpus_roots_stay_in_the_box).  The card's
# rsqrtf is within 2 ulp, and its product with s adds half an ulp: the seed's square root
# is tried at both ends of a 2^-20 relative envelope, and the seed is monotone in it.
QUOT_MAX = 4095
LEAP_BOX = 1800
ROOT_AVY, ROOT_D = 8192, 16384
ROOT_SCALES = (1.0, 1.0 - 2.0**-20, 1.0 + 2.0**-20)


def host_fn(host_landing, name, nargs_in, nargs_out, scalar=()):
    fn = getattr(host_landing.lib, name)
    fn.argtypes = [ctypes.c_void_p] * nargs_in + list(scalar) + \
        [ctypes.c_void_p] * nargs_out + [ctypes.c_int64]
    fn.restype = None
    return fn


def test_quot_exact_over_its_box(host_landing):
    """quot(n, vx)'s multiply-high == n // |vx| for every n in [0, 4095] and
    |vx| in [1, 4095], both signs of vx."""
    quot = host_fn(host_landing, "leap_quot_host", 2, 1)
    n_all = np.arange(QUOT_MAX + 1, dtype=np.int32)
    for lo in range(1, QUOT_MAX + 1, 512):
        avx = np.arange(lo, min(lo + 512, QUOT_MAX + 1), dtype=np.int32)
        num = np.ascontiguousarray(np.broadcast_to(n_all, (avx.size, n_all.size)).ravel())
        for sign in (1, -1):
            vx = np.ascontiguousarray(np.repeat(sign * avx, n_all.size))
            got = np.empty_like(num)
            quot(num.ctypes.data, vx.ctypes.data, got.ctypes.data, num.size)
            np.testing.assert_array_equal(got, num // np.abs(vx))


def box_edge_states():
    """Lanes at and past the edges of the multiply-high loop's box (|x| and
    |vx| up to 1800): x and vx on either side of +-1800, far outside, and
    on the court, over seeded y and vy."""
    xs = np.array([-1801, -1800, -1799, 0, 20, 216, 432, 452, 1799, 1800, 1801, 5000, -5000])
    vxs = np.array([-3000, -1801, -1800, -1799, -64, -1, 1, 2, 20, 1799, 1800, 1801, 3000])
    x, vx = (a.ravel() for a in np.meshgrid(xs, vxs))
    rng = np.random.default_rng(9)
    x, vx = np.tile(x, 6), np.tile(vx, 6)
    return tuple(np.ascontiguousarray(c.astype(np.int32)) for c in
                 (x, rng.integers(-300, 253, x.size), vx, rng.integers(-128, 129, x.size)))


@pytest.mark.parametrize("algo", ["leap", "hyb"])
def test_fast_loop_quotients_stay_in_their_box(host_landing, corpus_iter, algo):
    """A loop that starts inside the box takes every quotient inside
    quot's exhausted box (the host build counts those outside: none), and
    every lane, inside the box or dividing outside it, lands where the
    frame loop does: on the corpus and on the box's edges."""
    outside = host_landing.lib.leap_quot_outside_host
    outside.restype = ctypes.c_int64
    outside()
    code = predict.ALGOS.index(algo)
    edges = box_edge_states()
    for cols, want in ((corpus_iter[0], corpus_iter[1]),
                       (edges, predict.landing_sims_any(*torch_cols(edges)))):
        rc, got_e, got_c = host_landing(cols, code, code, 0)
        assert rc == 0
        np.testing.assert_array_equal(got_e, want[0].numpy())
        np.testing.assert_array_equal(got_c, want[1].numpy())
    assert outside() == 0


@pytest.mark.parametrize("scale", ROOT_SCALES, ids=["exact", "envelope-low", "envelope-high"])
def test_k_disp_exact_and_one_step_over_its_box(host_landing, scale):
    """k_disp(avy, d) is the largest k >= 0 with k*avy + k(k+1)/2 <= d, in
    exact int64, for every avy < 8192 and d < 16384, and each of its check
    loops runs at most one step there, with the seed's square root exact or
    at either end of the card's error envelope; so k_disp_in_box, the
    checks' one step each as selects, equals it wherever avy < d."""
    k_disp = host_fn(host_landing, "k_disp_host", 2, 3, scalar=[ctypes.c_float])
    in_box = host_fn(host_landing, "k_disp_in_box_host", 2, 1, scalar=[ctypes.c_float])
    d_all = np.arange(-2, ROOT_D, dtype=np.int32)
    worst = [0, 0]
    for lo in range(0, ROOT_AVY, 256):
        avy = np.arange(lo, lo + 256, dtype=np.int32)
        a = np.ascontiguousarray(np.repeat(avy, d_all.size))
        d = np.ascontiguousarray(np.broadcast_to(d_all, (avy.size, d_all.size)).ravel())
        k, down, up = (np.empty_like(a) for _ in range(3))
        k_disp(a.ctypes.data, d.ctypes.data, scale, k.ctypes.data, down.ctypes.data,
               up.ctypes.data, a.size)
        one = np.empty_like(a)
        in_box(a.ctypes.data, d.ctypes.data, scale, one.ctypes.data, a.size)
        rooted = d > a
        np.testing.assert_array_equal(one[rooted], k[rooted])
        k64, a64, d64 = k.astype(np.int64), a.astype(np.int64), d.astype(np.int64)
        assert (k64 >= 0).all()
        assert (k64 * a64 + k64 * (k64 + 1) // 2 <= np.maximum(d64, 0)).all()
        assert ((k64 + 1) * a64 + (k64 + 1) * (k64 + 2) // 2 > d64).all()
        worst = [max(worst[0], int(down.max())), max(worst[1], int(up.max()))]
    assert max(worst) <= 1, worst


def test_corpus_roots_stay_in_the_box():
    """Every root a leap over the corpus takes lies in k_disp's exhausted box:
    along a trajectory y never falls below min(y0, 0) (the ceiling clamps vy
    to 1) and |vy| never grows past |vy0| + 1000 (one a frame, up to the
    iteration cap), and a jump's distance is at most 252 - y; a candidate
    launches at twice the ball's |vy|.  Its lanes all start inside the
    multiply-high loop's box."""
    x, y, vx, vy = state_corpus(3, 6000)
    avy_max = 2 * int(np.abs(vy).max()) + 1000
    dist_max = 252 - min(int(y.min()), 0)
    assert avy_max < ROOT_AVY and dist_max < ROOT_D
    assert np.abs(x).max() <= LEAP_BOX and np.abs(vx).max() <= LEAP_BOX


@pytest.mark.parametrize("full_rule", [True, False], ids=["full", "mistake"])
def test_leap_span_equals_the_plain_jump(host_landing, full_rule):
    """The kernel's span (one distance, one root at most, the multiplier's
    quotients, or divisions outside their box) == the plain version's jump,
    lane by lane, on the corpus and the box's edges at count 0 and at seeded
    counts up to the iteration cap."""
    span = host_fn(host_landing, "leap_span_host", 5, 1, scalar=[ctypes.c_int32])
    _, jump, _ = predict.make_leap_step(full_rule)
    cols = [np.concatenate(c) for c in zip(state_corpus(7, 3000), box_edge_states())]
    live = cols[2] != 0
    x, y, vx, vy = (np.ascontiguousarray(c[live]) for c in cols)
    rng = np.random.default_rng(8)
    for c in (np.zeros_like(x), rng.integers(0, 1001, x.size).astype(np.int32)):
        got = np.empty_like(x)
        span(*(a.ctypes.data for a in (x, y, vx, vy, c)), int(full_rule), got.ctypes.data,
             x.size)
        carry = predict.leap_carry(*torch_cols((x, y, vx, vy)))
        carry = carry[:4] + (torch.from_numpy(c.astype(np.float32)),)
        want = (jump(carry)[4] - carry[4]).numpy().astype(np.int32)
        np.testing.assert_array_equal(got, want)
        assert (got > 1).mean() > 0.2  # the corpus jumps


def range_edge_states():
    """Lanes at and past the edges of the leap's int32 range (|x|, |y| up
    to 2^28, |vx|, |vy| up to 2^20: csrc/landing_sim.cuh's leap_in_range),
    far past them (|vy| 2^22, where a displacement over the loop limit
    would leave int32), and on the court beside them."""
    pos = [-(2**29), -(2**28) - 1, -(2**28), -5000, 0, 100, 200, 2**28, 2**28 + 1, 2**29]
    vel = [-(2**22), -(2**20) - 1, -(2**20), -7, 7, 2**20, 2**20 + 1, 2**22]
    xs = [-(2**28) - 1, -(2**28), 100, 216, 2**28, 2**28 + 1]
    return tuple(np.ascontiguousarray(c.ravel().astype(np.int32))
                 for c in np.meshgrid(xs, pos, vel, vel, indexing="ij"))


@pytest.mark.parametrize("algo", predict.ALGOS)
def test_host_build_matches_plain_iter_at_the_range_edges(host_landing_overflow_checked,
                                                          capfd, algo):
    """Every loop of the kernel's device code lands where the plain frame
    loop does on lanes at the edges of the leap's int32 range and beyond
    it, the true ball and the candidates (launched at twice |vy|) alike,
    with no signed overflow on the way: inside the range the leap's
    products stay in int32, outside it the lane takes the frame loop."""
    cols = range_edge_states()
    want_e, want_c = predict.landing_sims_any(*torch_cols(cols))
    code = predict.ALGOS.index(algo)
    capfd.readouterr()
    rc, got_e, got_c = host_landing_overflow_checked(cols, code, code, 0)
    assert "runtime error" not in capfd.readouterr().err
    assert rc == 0
    np.testing.assert_array_equal(got_e, want_e.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())
