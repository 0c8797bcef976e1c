"""The readings that the four-card learner cell's correctness limits are set
from, as ``benchmark/calibrate.py`` takes them for the one-card cells: the
program's compared numbers over many seeds (the lower readings), the
control's and the fault's over a few (the upper readings), at the cell's
own size and on its own cards.

    python benchmark/calibrate_mesh.py --workload learner_selfplay.ppo_mesh4 \\
        --seeds 1,2,3 --control-seeds 4

Prints one JSON line a reading: ``{"seed", "kind", <number>: value, ...}``.
Kinds: ``program`` (each of ``--seeds``); ``control_program`` (K1's
``int8fwd`` on every rank) and ``fault_drop`` (the last rank's gradient and
loss terms left out of every sum over ranks), each of ``--control-seeds``;
``fault_unchanged`` (a step that returns its state, read against the
program's own reference), each seed in both lists.  Each reading sets up a
group of its own (``benchmark/traffic/ppo_mesh_updates.py``), takes no
window, and follows the reference on rank 0's card.  The benchmark's runs do
not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _emit(out, seed, kind, values):
    line = json.dumps({"seed": seed, "kind": kind, **values})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def reading(cell, seed, device, params=None):
    """One group set up from ``seed`` (its checked updates), finished, and
    followed: ``(session, reference start, followed reference, compared
    numbers, seconds)``."""
    from benchmark import harness

    t0 = time.perf_counter()
    run = harness.Run(cell, seed, 0.0, False, device)
    run.params.update(params or {})
    s = cell.driver.Session(run)
    s.setup()
    s.finish()
    start, want = s.follow()
    return s, start, want, s.compared(start, want), time.perf_counter() - t0


def readings(cell, seeds, control_seeds, device, out="", params=None):
    """Every reading of ``cell`` on ``seeds`` (the program) and
    ``control_seeds`` (the control and the faults)."""
    import torch

    from benchmark.traffic import ppo_updates

    world = int(cell.config["mesh"]["world_size"])
    for seed in sorted(set(seeds) | set(control_seeds)):
        if seed in seeds:
            s, start, want, values, seconds = reading(cell, seed, device, params)
            _emit(out, seed, "program", dict(
                values, seconds=seconds, first_replay_off=s.first_replay_off,
                update_losses=[[round(g[0], 7), round(float(w[0]), 7)]
                               for g, w in zip(s.losses, want.losses)]))
            if seed in control_seeds:
                side = s.side()
                unchanged = side._replace(env_checked=side.start,
                                          params_checked=dict(s.params0))
                _emit(out, seed, "fault_unchanged",
                      ppo_updates.compare(unchanged, s.params0, start, want, s.recipe))
            del s, start, want
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if seed not in control_seeds:
            continue
        learner = dict((params or {}).get("learner", {}), fused_update="fm",
                       update_quant="int8fwd")
        for kind, extra in (("control_program", {"learner": learner}),
                            ("fault_drop", {"drop_gradient_rank": world - 1})):
            c, _, _, values, seconds = reading(cell, seed, device, dict(params or {}, **extra))
            _emit(out, seed, kind, dict(values, seconds=seconds))
            del c
            if device.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    device = torch.device(args.device)
    cell = harness.Cell(ROOT, args.workload)
    if device.type == "cuda" and torch.cuda.device_count() < cell.chips:
        print(f"calibrate_mesh: {cell.name} needs {cell.chips} CUDA cards", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    readings(cell, seeds, control_seeds, device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
