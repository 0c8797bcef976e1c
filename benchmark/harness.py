"""The benchmark's harness: one run of one cell.

Everything that belongs to one cell, configuration, traffic driver or
metric lives in a file of its own, found by name:

* ``BENCHMARK.json`` (the repo's root): the cells, the configurations'
  files and the metrics, with the cells each metric is read in;
* ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic
  driver and the driver's parameters;
* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<driver>.py``: a ``Session`` class that sets the cell
  up, runs one timed unit (a call, an update), profiles a few, and checks
  what the timed path produced against the reference;
* ``benchmark/metrics/<metric>.py``: ``read(run)`` returns the metric's
  value or None where there is nothing to read; an optional
  ``collect(run)`` gathers, in a traced run, what the reader needs.

A run: set-up (timed from the process's start to the first timed unit),
the window of ``--seconds`` over whole units, the peak memory, then with
``--trace 1`` the profiled units and the metrics' collections, then the
correctness check, and last the result line.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pikazoo_tpu")


class Refused(RuntimeError):
    """The run cannot measure: no card, too few cards, or a malformed cell."""


def load_module(path: Path, name: str) -> ModuleType:
    """Import a benchmark file by its path (names may hold dots)."""
    if not path.is_file():
        raise Refused(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(entry: dict, cell: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is read in ``cell``."""
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    """A cell's entries, found by name from the manifest."""

    def __init__(self, root: Path, name: str, bench_dir: Path = BENCH_DIR):
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.spec = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
        if self.spec["config"] != self.entry["config"]:
            raise Refused(f"{name}: workloads/{name}.json runs {self.spec['config']!r}, "
                          f"BENCHMARK.json {self.entry['config']!r}")
        self.driver = load_module(bench_dir / "traffic" / f"{self.spec['driver']}.py",
                                  f"benchmark_traffic_{self.spec['driver']}")
        self.end_to_end = [m for m in manifest["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if applies(m, name)]
        self.bench_dir = bench_dir

    def readers(self, trace: bool) -> Dict[str, ModuleType]:
        metrics = self.per_layer if trace else self.end_to_end
        return {m["name"]: load_module(self.bench_dir / "metrics" / f"{m['name']}.py",
                                       f"benchmark_metric_{m['name'].replace('.', '_')}")
                for m in metrics}

    def unit_of(self, metric: str, trace: bool) -> str:
        metrics = self.per_layer if trace else self.end_to_end
        return next(m["unit"] for m in metrics if m["name"] == metric)


def derive(seed: int, n: int) -> List[int]:
    """``n`` 31-bit seeds drawn from ``seed`` (any whole number)."""
    seq = np.random.SeedSequence(abs(int(seed)) + (1 << 64 if seed < 0 else 0))
    return [int(w) & 0x7FFFFFFF for w in seq.generate_state(n, dtype=np.uint32)]


class Run:
    """What one run measured: set-up, the window's units, the trace and the
    readings the metrics take."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.params = dict(cell.spec.get("params", {}))
        self.setup_s: Optional[float] = None
        self.units: List[dict] = []
        self.window_s: Optional[float] = None
        self.readings: Dict[str, object] = {}
        self.session = None
        self.profile = None

    def once(self, key: str, fn):
        """``fn()`` the first time ``key`` is asked for, its result after."""
        if key not in self.readings:
            self.readings[key] = fn()
        return self.readings[key]


def run_window(run: Run) -> None:
    """Whole units back to back until ``seconds`` have passed."""
    start = time.perf_counter()
    while True:
        run.units.append(run.session.unit())
        end = time.perf_counter()
        if end - start >= run.seconds:
            break
    run.window_s = end - start


def device_record(torch, chips: int, device) -> dict:
    """The cards the run used and the peak memory on the fullest."""
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is the JAX
    stack's or the JAX package's, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def measure(run: Run, t0: float) -> dict:
    """Set-up, window, trace, check; returns the result's fields."""
    import torch

    cell = run.cell
    run.session = cell.driver.Session(run)
    run.session.setup()
    run.setup_s = time.perf_counter() - t0
    run_window(run)
    run.session.sync()
    device = device_record(torch, cell.chips, run.device)
    readers = cell.readers(run.trace)
    if run.trace:
        run.profile = run.session.profile()
        device.update(busy_s=run.profile.busy_s, window_s=run.profile.window_s)
        for reader in readers.values():
            if hasattr(reader, "collect"):
                reader.collect(run)
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": cell.unit_of(name, run.trace)}
    checks = run.session.check()
    return {"metrics": metrics, "device": device, "checks": checks}


def main(args, t0: float, root: Path, device_type: str = "cuda") -> int:
    """The command: 0 and a result line, or another code and no result."""
    import torch

    try:
        cell = Cell(root, args.workload)
    except (Refused, KeyError, FileNotFoundError, json.JSONDecodeError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    if device_type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), found {found}; "
                  "nothing measured", file=sys.stderr)
            return 3
    run = Run(cell, args.seed, args.seconds, bool(args.trace), torch.device(device_type))
    out = measure(run, t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the JAX stack or the JAX package",
              file=sys.stderr)
        return 4
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"benchmark: {cell.name} seed {args.seed} on {power_limit()}", file=sys.stderr)
    ms = sorted(u["ms"] for u in run.units)
    print(f"units: {len(ms)} in {run.window_s:.3f} s, ms min {ms[0]:.3f} median "
          f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; first {run.units[0]['ms']:.3f}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": len(run.units), "failed": 0,
              "metrics": out["metrics"], "device": out["device"]}
    if run.profile is not None:
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0
