"""Metrics logging: stdout lines and a JSONL file, on the host.

The JAX package's ``MetricsLogger`` and its format: a header record (e.g.
the resolved dispatch), then one ``{"step": n, <metric>: float, ...,
"wall_s": s}`` object a step.  Sinks are callables ``(step, scalars)``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, print_every: int = 1):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._sinks: List[Callable[[int, Dict[str, float]], None]] = []
        self._print_every = print_every
        self._t0 = time.time()

    def add_sink(self, sink: Callable[[int, Dict[str, float]], None]) -> None:
        self._sinks.append(sink)

    def header(self, record: Dict) -> None:
        """Write one raw (non-scalar) JSONL record, e.g. the resolved
        dispatch, so a training artifact says which kernels served it."""
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        print(" ".join(f"{k}={v}" for k, v in record.items()), flush=True)

    def log(self, step: int, metrics: Dict) -> None:
        """One record of ``metrics`` (Python numbers or 0-d tensors; a
        tensor on the card is read back here)."""
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["wall_s"] = round(time.time() - self._t0, 3)
        if self._file is not None:
            self._file.write(json.dumps({"step": step, **scalars}) + "\n")
            self._file.flush()
        for sink in self._sinks:
            sink(step, scalars)
        if self._print_every and step % self._print_every == 0:
            body = " ".join(f"{k}={v:.4g}" for k, v in scalars.items())
            print(f"[{step}] {body}", flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
