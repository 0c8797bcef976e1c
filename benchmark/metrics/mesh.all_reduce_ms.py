"""mesh.all_reduce_ms: device milliseconds an update of the NCCL kernels
(``nccl*Kernel*``) in rank 0's profiled pass (``benchmark/program_spans.py``),
from each ``pikazoo.ppo.train_step`` span's start to the end of its unit's
read-back (an update's kernels run on after its host span).  An NCCL kernel
spins until its peers arrive, so this holds the waits for the slowest rank.
None where the program does not name its sums over ranks (no
``pikazoo.ppo.grad_sum`` span) or ran no NCCL kernel."""

import re

from benchmark.program_spans import profiled

NCCL = re.compile(r"nccl\w*Kernel")


def collect(run):
    profiled(run)


def read(run):
    p = profiled(run)
    if p is None or not p.named("ppo.grad_sum"):
        return None
    readbacks = [e for _, e, n in p.bench if n == "readback"]
    ns = 0
    steps = p.named("ppo.train_step")
    for start, end in steps:
        end = min([e for e in readbacks if e >= end], default=end)
        ns += sum(min(ev.end, end) - max(ev.start, start) for ev in p.device
                  if NCCL.search(ev.name) and ev.end > start and ev.start < end)
    return ns / len(steps) / 1e6 if ns else None
