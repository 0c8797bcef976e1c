"""The four-rank learner cell's traffic (``traffic/ppo_mesh_updates.py``) on
the CPU: four ranks over gloo at a toy size (64 envs in all, T=8, hidden
(16, 16), K1's plain version), through the harness.  The ranks run in
lockstep and the units count the global batch; a rank killed in the window
ends the run at once with an error and leaves no process; a rank's gradient
left out of the sum, and K1's int8 forward on every rank, fail a check; the
mesh's readers read the program's spans, and nothing where a program lacks
them."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import calibrate_mesh, harness
from benchmark.program_spans import Event, HostSpan, Profiled
from benchmark.run import parse

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELL = "learner_selfplay.ppo_mesh4"
TOY = {"learner": {"num_envs": 64, "rollout_length": 8, "hidden": [16, 16],
                   "fused_update": "fm"}}
SEED = 2 ** 31 + 41


@pytest.fixture
def toy_cell(monkeypatch):
    """The cell as the harness finds it, its parameters set to the toy size
    (and to ``extra``, given through the fixture's return)."""
    extra = {}
    real = harness.Cell.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.spec = dict(self.spec, params=dict(self.spec["params"], **TOY, **extra))

    monkeypatch.setattr(harness.Cell, "__init__", init)
    return extra


def _main(capsys, trace=0, seconds=1.0):
    args = parse(["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds),
                  "--trace", str(trace)])
    assert harness.main(args, time.perf_counter(), ROOT, device_type="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_units_run_all_ranks_in_lockstep(toy_cell):
    """Every unit counts the global batch's env-steps, every rank ran as many
    units as rank 0, and the run is correct, the ranks bit-identical."""
    cell = harness.Cell(ROOT, CELL)
    run = harness.Run(cell, SEED, 1.0, False, torch.device("cpu"))
    out = harness.measure(run, time.perf_counter())
    learner = run.session.learner
    assert learner["num_envs"] == 64
    assert run.units and all(u["env_steps"] == 8 * 64 for u in run.units)
    assert run.session.rank_units == [len(run.units)] * 4
    checks = out["checks"]
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert checks["ranks_params_off"]["value"] == checks["ranks_losses_off"]["value"] == 0


@pytest.mark.parametrize("fault", [None, 3])
def test_a_dropped_gradient_fails_a_check(toy_cell, capsys, fault):
    """Through ``harness.main``: the run is correct, and with rank 3's
    gradient and loss terms left out of every sum it is not, though the
    ranks stay alike."""
    if fault is not None:
        toy_cell["drop_gradient_rank"] = fault
    result = _main(capsys)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["device"]["count"] == 4
    assert result["checks"]["ranks_params_off"]["value"] == 0


def test_traced_run_reads_the_mesh_spans(toy_cell, capsys):
    """A traced run (its host pass a second group of four) reads 49
    ``all_reduce`` spans an update; no NCCL kernel runs on the CPU."""
    result = _main(capsys, trace=1)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["mesh.all_reduce_calls"]["value"] == 49
    assert "mesh.all_reduce_ms" not in metrics
    assert {"device_idle.train", "ppo.frame_ms"} <= set(metrics)


PROBE = r"""
import sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from benchmark import harness
from benchmark.run import parse
real = harness.Cell.__init__
def init(self, *args, **kwargs):
    real(self, *args, **kwargs)
    self.spec = dict(self.spec, params=dict(self.spec["params"], learner=dict(
        num_envs=64, rollout_length=8, hidden=[16, 16], fused_update="fm")))
harness.Cell.__init__ = init
sys.exit(harness.main(parse(sys.argv[2:]), time.perf_counter(), Path(sys.argv[1]),
                      device_type="cpu"))
"""


def _children(pid: int):
    """Processes whose parent is ``pid``."""
    found = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            found.append(int(stat.parent.name))
    return found


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state != "Z"


def test_a_killed_rank_ends_the_run_at_once():
    """Rank 2 killed in the window: rank 0 exits with an error, prints no
    result, and no rank is left."""
    proc = subprocess.Popen([sys.executable, "-c", PROBE, str(ROOT), "--workload", CELL,
                             "--seed", str(SEED), "--seconds", "300"], cwd=ROOT,
                            env=dict(os.environ, OMP_NUM_THREADS="2"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while len(ranks := _children(proc.pid)) < 3 and time.monotonic() < deadline:
            time.sleep(0.5)
        assert len(ranks) == 3, ranks
        time.sleep(25)  # set-up takes about 7 s at this size: the window runs
        os.kill(sorted(ranks)[1], signal.SIGKILL)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert out.strip() == ""
    assert "before it was told to finish" in err, err[-2000:]
    time.sleep(2)
    assert not [pid for pid in ranks if _alive(pid)]


def test_control_and_fault_fail_and_the_program_passes(capsys):
    """The calibration's readings at the toy size: the program within every
    limit; K1's int8 forward on every rank, a rank's gradient left out of
    the sum, and a step returning its state each fail one."""
    cell = harness.Cell(ROOT, CELL)
    limits = cell.driver.LIMITS
    calibrate_mesh.readings(cell, [SEED], [SEED], torch.device("cpu"), params=TOY)
    readings = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                if line.startswith("{")]
    assert [r["kind"] for r in readings] == ["program", "fault_unchanged", "control_program",
                                            "fault_drop"]
    for r in readings:
        failed = [k for k in limits if k in r and r[k] > limits[k]]
        assert bool(failed) is (r["kind"] != "program"), (r["kind"], failed, r)


def _run_with(readings: dict) -> harness.Run:
    run = harness.Run(harness.Cell(ROOT, CELL), SEED, 0.0, True, torch.device("cpu"))
    run.readings.update(readings)
    return run


def test_mesh_readers_read_nothing_without_the_spans():
    """Both readers return None where the program names no sum over ranks
    (a program without ``pikazoo.ppo.grad_sum``), or ran no pass; with the
    spans they count the ``all_reduce`` spans an update and the NCCL
    kernels' time up to the unit's read-back."""
    calls = harness.load_module(BENCH / "metrics" / "mesh.all_reduce_calls.py", "mesh_calls")
    ms = harness.load_module(BENCH / "metrics" / "mesh.all_reduce_ms.py", "mesh_ms")

    def span(name, start, end, parent=-1):
        return HostSpan("pikazoo." + name, start, end, parent, 0)

    older = [span("ppo.train_step", 0, 100), span("mesh.all_reduce", 10, 11, 0),
             span("mesh.all_reduce", 90, 91, 0)]
    newer = older + [span("ppo.grad_sum", 20, 30, 0)]
    assert calls.read(_run_with({"program_host": older})) is None
    assert calls.read(_run_with({"program_host": None})) is None
    assert calls.read(_run_with({"program_host": newer})) == 2

    def event(name, on_device, start, end):
        return Event(name, on_device, start, end, 0, 0)

    older = [event("pikazoo.ppo.train_step", False, 0, 100),
             event("bench.train_step", False, 0, 100), event("bench.readback", False, 100, 150),
             event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", True, 120, 140),
             event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", True, 160, 170)]
    newer = older + [event("pikazoo.ppo.grad_sum", False, 20, 30)]
    assert ms.read(_run_with({"program_profiled": Profiled(older)})) is None
    assert ms.read(_run_with({"program_profiled": None})) is None
    assert ms.read(_run_with({"program_profiled": Profiled(newer)})) == pytest.approx(20 / 1e6)
