"""K2's leap modes (``csrc/landing.cu``) on the card: each build's time in
turns, the SASS of one jump, and the frame loop's code unchanged.  Needs a
card and nvcc:

    python3 -m pikazoo_tpu_torch.tools.k2_leap_probe [--parent DIR]

On the B=65536 frame-300 AI self-play states (``harvest_ball_states``, the
states of ``chip_smoke.py``'s phases 3 and 20) it prints:

- ``-Xptxas -v`` of each build's ``landing_kernel`` instances;
- the SASS of one jump, by net rule: the instructions of a kernel that
  loads a lane, runs one ``leap_jump`` and stores the lane, less those of
  the same kernel without the jump (``probe_source``), with the
  conversions, MUFU, wide or high multiplies, branches and votes among
  them (the loads of vx and, in this design, of the lane's multiplier count
  with the jump);
- with ``--parent``, whether the frame loop's code is unchanged: the SASS of
  K2's ``iter`` instance and of every kernel of ``fused_step.cu`` and
  ``flat_sims.cu``, parent against change;
- ms a launch of each leap mode of each build in turns, first to last and
  back (parent, change, change, parent), with the change's ``iter`` before
  and after, the stream held;

and holds every result bit-equal to the change's ``iter``, itself held
against the plain version.  ``--parent DIR`` is the root of a checkout (or
its ``csrc/``): unpack the parent commit with ``git archive`` under
``build/``.  Builds go into ``build/probe/k2/``.  ``--device cpu`` runs
each mode's plain version on seeded states at a small batch and checks
them equal to the frame loop (no times).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pikazoo_tpu_torch import EnvConfig, PikaZoo, _build
from pikazoo_tpu_torch.core import predict
from pikazoo_tpu_torch.tools._timing import card_line, resolve, timer

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "probe" / "k2"
MODES = ("leap", "hyb", "leap,iter", "iter,leap")
AI_BATCH = 65536  # rule-AI self-play (both seats)
HARVEST_FRAME = 300
# The SASS opcodes of a jump's costly classes, by the prefix of the opcode.
SASS_CLASSES = {
    "conversions": ("I2F", "F2I", "I2FP", "F2IP"),
    "MUFU": ("MUFU",),
    "IMAD.HI / .WIDE": ("IMAD.HI", "IMAD.WIDE"),
    "branches": ("BRA", "BSSY", "BSYNC", "WARPSYNC"),
    "votes": ("VOTE",),
}
_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_SASS_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def harvest_ball_states(device, batch: int, frames: int):
    """Ball (x, y, vx, vy) after ``frames`` frames of AI-vs-AI self-play."""
    env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(1, batch, device=device)
    actions = torch.zeros((batch, 2), dtype=torch.int32, device=device)
    for _ in range(frames):
        state, _ = env.step_batch(state, actions)
    b = state.ball
    return b.x, b.y, b.x_velocity, b.y_velocity


def csrc_of(path: str) -> Path:
    """The ``csrc/`` of a checkout root, or the directory itself."""
    p = Path(path)
    return p / "pikazoo_tpu_torch" / "csrc" if (p / "pikazoo_tpu_torch").is_dir() else p


def load_landing(name: str, csrc: Path) -> ctypes.CDLL:
    """``csrc``'s ``landing.cu`` built into ``build/kernels/`` (``name``
    names the library), its launch bound."""
    lib = ctypes.CDLL(str(_build.build(name, ("landing.cu",), csrc=csrc)))
    lib.landing_sims_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int32] * 4
                                        + [ctypes.c_void_p])
    lib.landing_sims_launch.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, balls, algo: str):
    """One launch of ``lib`` (from ``load_landing``) in mode ``algo``:
    (expected (B,), candidates (6, B))."""
    algo_true, algo_cand = predict.parse_algo(algo)
    n = balls[0].numel()
    expected = torch.empty(n, dtype=torch.int32, device=balls[0].device)
    cand = torch.empty((6, n), dtype=torch.int32, device=balls[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    args = [b.data_ptr() for b in balls] + [expected.data_ptr(), cand.data_ptr(), n,
                                            predict.ALGOS.index(algo_true),
                                            predict.ALGOS.index(algo_cand), 0]
    err = lib.landing_sims_launch(*args, stream)
    if err:
        raise RuntimeError(f"landing kernel launch failed: CUDA error {err}")
    return expected, cand


def probe_source(with_lane: bool) -> str:
    """A ``.cu`` that includes ``landing_sim.cuh`` and defines
    ``one_jump<FULL>`` (load a lane, one ``leap_jump``, store it) and
    ``no_jump`` (the same loads and stores).  ``with_lane``: this design's
    jump in the multiply-high loop, which takes the lane's loop invariant
    (loaded, as the loop keeps it in a register); else the parent's."""
    lane = ("const pika::LeapLane lane{uint32_t(s[5 * n + i])};\n"
            "  pika::leap_jump<true>(x, y, vx, vy, c, FULL, lane);"
            if with_lane else "pika::leap_jump(x, y, vx, vy, c, FULL);")
    body = """
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t x = s[i], y = s[n + i], vx = s[2 * n + i], vy = s[3 * n + i], c = s[4 * n + i];
  %s
  s[i] = x;
  s[n + i] = y;
  s[3 * n + i] = vy;
  s[4 * n + i] = c;
"""
    return ("#include <cstdint>\n#include \"landing_sim.cuh\"\n\n"
            "template <bool FULL>\n__global__ void one_jump(int32_t* s, int32_t n) {"
            + body % lane + "}\n\n"
            "template __global__ void one_jump<true>(int32_t*, int32_t);\n"
            "template __global__ void one_jump<false>(int32_t*, int32_t);\n\n"
            "__global__ void no_jump(int32_t* s, int32_t n) {" + body % "" + "}\n")


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled function: [instruction, ...]}
    (the NOPs left out)."""
    functions, current = {}, None
    for line in text.splitlines():
        if m := _SASS_FUNCTION.match(line):
            current = functions.setdefault(m.group(1), [])
        elif current is not None and (m := _SASS_INSTRUCTION.match(line)):
            if opcode(m.group(1)) != "NOP":
                current.append(m.group(1))
    return functions


def opcode(instruction: str) -> str:
    parts = instruction.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def classes(instructions) -> dict:
    """How many of ``instructions`` fall in each of SASS_CLASSES."""
    counts = Counter()
    for ins in instructions:
        op = opcode(ins)
        for name, prefixes in SASS_CLASSES.items():
            if any(op == p or op.startswith(p + ".") for p in prefixes):
                counts[name] += 1
    return {name: counts[name] for name in SASS_CLASSES}


def cubin_sass(source: Path, include: Path, out: Path) -> dict:
    """``source`` compiled with the port's flags (``include`` on the include
    path) to a cubin under ``out``, then disassembled: ``parse_sass``."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    nvcc = _build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / (source.stem + ".cubin")
    proc = subprocess.run([nvcc, *flags, "-I", str(include), "-cubin", "-o", str(cubin),
                           str(source)], capture_output=True, text=True)
    if proc.returncode:
        raise _build.KernelBuildError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True)
    cubin.with_suffix(".sass").write_text(dump.stdout)
    return parse_sass(dump.stdout)


def jump_sass(csrc: Path, name: str = "change") -> dict:
    """The SASS of one jump of ``csrc``'s header, by rule: {"full" /
    "mistake": (instructions, classes)}, each the ``one_jump`` kernel's less
    ``no_jump``'s."""
    out = OUT / f"jump_{name}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    header = (csrc / "landing_sim.cuh").read_text()
    src = out / "one_jump.cu"
    src.write_text(probe_source("struct LeapLane" in header))
    functions = cubin_sass(src, csrc, out)
    base = next(v for k, v in functions.items() if "no_jump" in k)
    result = {}
    for rule, flag in (("full", "Lb1E"), ("mistake", "Lb0E")):
        body = next(v for k, v in functions.items() if "one_jump" in k and flag in k)
        base_classes = classes(base)
        result[rule] = (len(body) - len(base),
                        {c: n - base_classes[c] for c, n in classes(body).items()})
    return result


def kernel_key(mangled: str) -> str:
    """K2's kernel name without its namespace prefix and parameter list, so
    an instance matches the parent's whatever the two trees name around
    it."""
    m = re.search(r"landing_kernelILi\d+ELi\d+EE", mangled)
    return m.group(0) if m else mangled


def same_code(parent: Path, change: Path) -> dict:
    """{source: (kernels compared, whether each one's SASS is the parent's)}:
    K2's iter instance of ``landing.cu``, every kernel of ``fused_step.cu``
    and ``flat_sims.cu``.  The kernels are matched by their code, in order:
    nvcc names a kernel in an anonymous namespace with a hash of its
    source file, which differs between two trees."""
    compared = {"landing.cu": lambda k: k == "landing_kernelILi0ELi0EE",
                "fused_step.cu": lambda k: True, "flat_sims.cu": lambda k: True}
    jobs = {}
    with ThreadPoolExecutor(max_workers=6) as pool:
        for src in compared:
            for name, csrc in (("parent", parent), ("change", change)):
                jobs[src, name] = pool.submit(cubin_sass, csrc / src, csrc,
                                              OUT / f"same_{name}" / Path(src).stem)
    verdict = {}
    for src, keep in compared.items():
        code = {name: sorted(v for k, v in jobs[src, name].result().items()
                             if keep(kernel_key(k))) for name in ("parent", "change")}
        verdict[src] = (len(code["parent"]),
                        bool(code["parent"]) and code["parent"] == code["change"])
    return verdict


def ptxas_lines(csrc: Path) -> list:
    """``-Xptxas -v`` of ``csrc``'s ``landing.cu``, a line per instance."""
    names = {str(i): a for i, a in enumerate(predict.ALGOS)}
    lines = []
    for entry, regs, stack, stores, loads in _build.resource_usage(csrc / "landing.cu"):
        m = re.search(r"landing_kernelILi(\d+)ELi(\d+)EE", entry)
        name = f"landing_kernel<{names[m.group(1)]}, {names[m.group(2)]}>" if m else entry
        lines.append(f"{name}: {regs} registers, {stack} B stack, spill stores {stores} B, "
                     f"spill loads {loads} B")
    return lines


def in_turns(calls: dict, order, reps: int) -> dict:
    """ms a launch of each of ``calls`` timed in ``order`` (names may
    repeat), the stream held: {name: [ms, ...]}."""
    clock = timer(torch.device("cuda"))
    times = {name: [] for name in calls}
    for name in order:
        fn = calls[name]

        def run():
            for _ in range(reps):
                fn()
        times[name].append(clock(run) * 1e3 / reps)
    return times


def fmt(times) -> str:
    return " / ".join(f"{t:.4f}" for t in times)


def run_card(opts, card: str, live) -> int:
    csrcs = {"change": _build.CSRC_DIR}
    if opts.parent:
        csrcs = {"parent": csrc_of(opts.parent), **csrcs}
    with ThreadPoolExecutor(max_workers=len(csrcs)) as pool:
        futures = {name: pool.submit(load_landing, f"landing_{name}", c)
                   for name, c in csrcs.items()}
        builds = {name: f.result() for name, f in futures.items()}
    with ThreadPoolExecutor(max_workers=4) as pool:
        ptxas = {name: pool.submit(ptxas_lines, c) for name, c in csrcs.items()}
        sass = {name: pool.submit(jump_sass, c, name) for name, c in csrcs.items()}
        same = pool.submit(same_code, csrcs["parent"], csrcs["change"]) if opts.parent else None
        for name in csrcs:
            for line in ptxas[name].result():
                print(f"k2_leap_probe ptxas [{name}] {line}", flush=True)
        for name in csrcs:
            for rule, (count, by_class) in sass[name].result().items():
                print(f"k2_leap_probe SASS of one jump [{name}, {rule} rule]: {count} "
                      f"instructions; {by_class}", flush=True)
        if same is not None:
            print(f"k2_leap_probe same code as the parent: {same.result()}", flush=True)

    want_e, want_c = launch(builds["change"], live, "iter")
    plain_e, plain_c = predict.landing_sims_any(*live)
    if not (torch.equal(want_e, plain_e) and torch.equal(want_c, plain_c)):
        raise AssertionError("K2 iter != the plain version on the live states")
    n = live[0].numel()

    def checked(name, algo):
        got_e, got_c = launch(builds[name], live, algo)
        if not (torch.equal(got_e, want_e) and torch.equal(got_c, want_c)):
            raise AssertionError(f"{name} {algo} != K2 iter")
        return lambda: launch(builds[name], live, algo)

    iter_call = checked("change", "iter")
    order = [*builds, *reversed(builds)]
    for algo in MODES:
        calls = {"iter": iter_call, **{name: checked(name, algo) for name in builds}}
        t = in_turns(calls, ["iter", *order, "iter"], opts.reps)
        text = ", ".join(f"{name} {fmt(t[name])}" for name in builds)
        print(f"k2_leap_probe time K2 {algo} B={n}: {text}; iter {fmt(t['iter'])} ms a launch "
              f"(stream held, in turns); bit-equal to K2 iter [{card}]", flush=True)
    return 0


def run_cpu(opts) -> int:
    rng = np.random.default_rng(0)
    cols = (rng.integers(20, 433, opts.batch), rng.integers(0, 253, opts.batch),
            rng.integers(-20, 21, opts.batch), rng.integers(-60, 61, opts.batch))
    balls = tuple(torch.tensor(c, dtype=torch.int32) for c in cols)
    want = predict.landing_sims_any(*balls)
    for algo in MODES:
        got = predict.landing_sims_any(*balls, algo=algo)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"plain {algo} != the frame loop")
    print(f"k2_leap_probe [CPU, plain versions] B={opts.batch}: {', '.join(MODES)} each "
          "bit-equal to the frame loop", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--parent", default="", help="a checkout (or its csrc/) to time beside")
    ap.add_argument("--reps", type=int, default=50, help="launches a timing")
    ap.add_argument("--batch", type=int, default=512, help="envs on the CPU")
    opts = ap.parse_args(argv)
    device = resolve(opts.device, "k2_leap_probe")
    if device.type == "cpu":
        return run_cpu(opts)
    live = harvest_ball_states(device, AI_BATCH, HARVEST_FRAME)
    return run_card(opts, card_line(), live)


if __name__ == "__main__":
    sys.exit(main())
