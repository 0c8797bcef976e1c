"""The harness itself, on the CPU: it finds new cells, configurations,
traffic drivers and metrics by their files; it refuses to measure without a
card or without the program; and a run whose timed path is broken
underneath comes out not correct, as does the control."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, harness

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TOY_DRIVER = '''
class Session:
    def __init__(self, run):
        self.run = run
    def setup(self):
        self.n = 0
    def unit(self):
        self.n += 1
        return {"ms": 1.0, "env_steps": self.run.params["work"]}
    def sync(self):
        pass
    def check(self):
        return {"units_seen": {"value": 0 if self.n else 1, "limit": 0}}
'''
TOY_METRIC = '''
def read(run):
    return len(run.units) * run.params["work"]
'''


def _copy_benchmark(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_cell_config_driver_and_metric_are_found_by_name(tmp_path):
    root = _copy_benchmark(tmp_path)
    bench = root / "benchmark"
    (bench / "configs" / "toy.json").write_text(json.dumps({"name": "toy"}))
    (bench / "workloads" / "toy.count.json").write_text(json.dumps(
        {"config": "toy", "driver": "toy_driver", "why": "a test", "params": {"work": 3}}))
    (bench / "traffic" / "toy_driver.py").write_text(TOY_DRIVER)
    (bench / "metrics" / "toy.work_done.py").write_text(TOY_METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy", "source": "a test", "reduced": [],
                                "file": "benchmark/configs/toy.json", "why": "a test"})
    manifest["workloads"].append({"name": "toy.count", "config": "toy", "traffic": "count",
                                  "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "toy.work_done", "unit": "steps", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["toy.count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell(root, "toy.count", bench_dir=bench)
    run = harness.Run(cell, 2 ** 31 + 5, 0.01, False, torch.device("cpu"))
    out = harness.measure(run, time.perf_counter())
    assert set(out["metrics"]) == {"toy.work_done", "setup_s"}
    assert out["metrics"]["toy.work_done"]["value"] == 3 * len(run.units) > 0
    assert out["checks"] == {"units_seen": {"value": 0, "limit": 0}}


def _cli(cwd: Path, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_nothing_is_measured():
    out = _cli(ROOT, "--workload", "rule_ai_selfplay.fused", "--seed", str(2 ** 31 + 9),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_nothing_is_measured(tmp_path):
    root = _copy_benchmark(tmp_path)
    probe = ("import sys, time; sys.path.insert(0, sys.argv[1]); from benchmark import harness;"
             "from benchmark.run import parse;"
             "sys.exit(harness.main(parse(sys.argv[2:]), time.perf_counter(), "
             "__import__('pathlib').Path(sys.argv[1]), device_type='cpu'))")
    out = subprocess.run([sys.executable, "-c", probe, str(root), "--workload",
                          "rule_ai_selfplay.fused", "--seed", "1", "--seconds", "1"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "pikazoo_tpu_torch" in out.stderr


# ------------------------------------------------------------ broken runs --

# The run's seed draws the window's second call (index 1) as the checked one.
FUSED = dict(batch=1024, frames=20, warmup_calls=1, check_within=2, follow_sample=64,
             trace_calls=1, count_sample=256)
PPO = {"learner": dict(num_envs=32, rollout_length=8)}


def _run(cell_name, params, seconds=0.05):
    cell = harness.Cell(ROOT, cell_name)
    run = harness.Run(cell, 2 ** 31 + 17, seconds, False, torch.device("cpu"))
    run.params.update(params)
    out = harness.measure(run, time.perf_counter())
    return all(c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]


def _splice(new, old, half):
    if torch.is_tensor(new):
        return torch.cat([new[:half], old[half:]])
    return type(new)(*[_splice(n, o, half) for n, o in zip(new, old)])


def _fused_fault(kind):
    import pikazoo_tpu_torch

    real = pikazoo_tpu_torch.fused_rollout
    calls = []

    def broken(state, key, cfg, frames):
        calls.append(1)
        if kind == "unchanged":
            return state
        if kind == "earlier":  # the window's first call only (after 1 warm-up)
            return state if len(calls) == 2 else real(state, key, cfg, frames)
        new = real(state, key, cfg, frames)
        if kind == "half":
            return _splice(new, state, new.scores.shape[0] // 2)
        scores = new.scores.clone()
        scores[0, 0] += 1
        return new._replace(scores=scores)

    return broken


@pytest.mark.parametrize("cell", ["rule_ai_selfplay.fused", "learner_selfplay.fused_random"])
def test_fused_run_is_correct(cell):
    ok, checks = _run(cell, FUSED, seconds=4.0)
    assert ok, checks


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer", "earlier"])
@pytest.mark.parametrize("cell", ["rule_ai_selfplay.fused", "learner_selfplay.fused_random"])
def test_fused_fault_is_not_correct(cell, kind, monkeypatch):
    """A fault in every call, or (``earlier``) in a call before the checked
    one, which only the sample followed from the reset can see."""
    import pikazoo_tpu_torch

    monkeypatch.setattr(pikazoo_tpu_torch, "fused_rollout", _fused_fault(kind))
    ok, checks = _run(cell, FUSED, seconds=4.0)
    assert not ok, checks
    if kind == "earlier":
        assert checks["call_envs_off"]["value"] == 0 < checks["sample_envs_off"]["value"], checks


def test_ppo_run_is_correct():
    ok, checks = _run("learner_selfplay.ppo", PPO)
    assert ok, checks


def test_ppo_step_returning_its_state_is_not_correct(monkeypatch):
    from pikazoo_tpu_torch.train import ppo

    real = ppo.make_ppo_trainer

    def make(*args, **kwargs):
        init_fn, step, net = real(*args, **kwargs)

        def unchanged(runner, uniforms=None):
            return runner, step(runner, uniforms)[1]

        unchanged.__dict__.update(step.__dict__)
        return init_fn, unchanged, net

    monkeypatch.setattr(ppo, "make_ppo_trainer", make)
    ok, checks = _run("learner_selfplay.ppo", PPO)
    assert not ok and checks["change_gap"]["value"] == pytest.approx(1.0), checks


def test_ppo_half_batch_is_not_correct(monkeypatch):
    """K1 (its plain version here) given half of each minibatch's columns:
    the mean is taken over the rest."""
    from pikazoo_tpu_torch.train import ppo

    real = ppo.fused_ppo_grads_fm

    def half(params, obs, action, log_prob, value, adv, target, **kw):
        n = action.shape[-1] // 2
        return real(params, obs[..., :n], action[..., :n], log_prob[..., :n],
                    value[..., :n], adv[..., :n], target[..., :n], **kw)

    monkeypatch.setattr(ppo, "fused_ppo_grads_fm", half)
    params = {"learner": dict(PPO["learner"], fused_update="fm")}
    ok, checks = _run("learner_selfplay.ppo", params)
    assert not ok, checks


def test_ppo_action_altered_is_not_correct(monkeypatch):
    """One env's action changed on its way from the policy's draw into the
    env step."""
    from pikazoo_tpu_torch import PikaZoo

    real = PikaZoo.step_batch_learner_fm

    def altered(self, state, a1, a2):
        a1 = a1.clone()
        a1[0] = (a1[0] + 9) % 18
        return real(self, state, a1, a2)

    monkeypatch.setattr(PikaZoo, "step_batch_learner_fm", altered)
    ok, checks = _run("learner_selfplay.ppo", PPO)
    assert not ok, checks


# ---------------------------------------------------------------- control --

def _readings(cell_name, params, capsys, seeds=(), witness=False):
    cell = harness.Cell(ROOT, cell_name)
    calibrate.readings(cell, list(seeds), [2 ** 31 + 23], torch.device("cpu"), params=params,
                       witness=witness)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("cell", ["rule_ai_selfplay.fused", "learner_selfplay.fused_random"])
def test_fused_control_is_not_correct(cell, capsys):
    readings = _readings(cell, FUSED, capsys)
    kinds = {r["kind"]: r for r in readings}
    assert set(kinds) == {"control", "fault_unchanged", "fault_half", "fault_answer"}
    for kind, r in kinds.items():
        assert r["call_envs_off"] > 0, (kind, r)


def test_ppo_control_is_not_correct(capsys):
    """The control (K1's own int8 paths, and the reference in fp8 in the
    program's place, drawing its own actions) and each fault fail a limit
    and the program passes; the witnesses (the reference in float32, and
    from weights one rounding step away) are read beside them."""
    limits = harness.load_module(BENCH / "traffic" / "ppo_updates.py", "ppo_limits").LIMITS
    readings = _readings("learner_selfplay.ppo", PPO, capsys, seeds=[2 ** 31 + 23],
                         witness=True)
    kinds = [r["kind"] for r in readings]
    assert kinds == ["program", "witness_nudged", "witness_program", "witness_reference",
                     "control", "fault_half", "fault_unchanged", "fault_answer",
                     "control_program", "control_program"], kinds
    for r in readings:
        failed = any(r[k] > limits[k] for k in r if k in limits)
        if r["kind"] == "program":
            assert not failed, r
        elif r["kind"].startswith(("control", "fault")):
            assert failed, r
