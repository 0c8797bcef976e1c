"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``pikazoo_tpu_torch``).  It measures on the CUDA cards of
the machine it starts on and exits with a code other than 0, printing no
result, where there are fewer than the cell asks for.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before the heavy imports

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every cache the run may fill lives at a fixed path inside the checkout.
CACHE = ROOT / "build" / "bench_cache"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="makes the inputs and weights")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="0: the end-to-end metrics; 1: the per-layer metrics")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    return harness.main(args, T0, ROOT)


if __name__ == "__main__":
    sys.exit(main())
