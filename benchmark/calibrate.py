"""The readings that the correctness limits are set from: the program's
compared numbers over many seeds (the lower readings), and the control's
and each fault's over a few (the upper readings), at the cell's own size.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3

Prints one JSON line a reading: ``{"seed", "kind", <number>: value, ...}``.
Kinds: ``program``; ``control`` (the reference one precision below the
configuration's in the program's place: fp8 products for a learner cell, the
cell's ``control`` parameter for a fused cell); ``control_program`` (a
learner cell's program with its own int8 forward switched on); and the
faults ``fault_unchanged`` (a step that returns its state), ``fault_half``
(half of the batch left out) and ``fault_answer`` (one action or one env's
answer altered where it is produced).  The benchmark's runs do not run this.
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


def _run(cell, seed, device, params=None):
    from benchmark import harness

    run = harness.Run(cell, seed, 0.0, False, device)
    run.params.update(params or {})
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--witness", action="store_true",
                    help="a learner cell's float32 reference beside each program reading")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    readings(cell, seeds, control_seeds, device, args.out, witness=args.witness)
    return 0


def readings(cell, seeds, control_seeds, device, out="", params=None, witness=False):
    """Every reading of ``cell`` on ``seeds`` (the program) and
    ``control_seeds`` (the control and the faults); with ``witness``, a
    learner cell's float32 witness too."""
    if cell.spec["driver"] == "ppo_updates":
        _learner_readings(cell, seeds, control_seeds, device, out, params, witness)
    else:
        _fused_readings(cell, seeds, control_seeds, device, out, params)


def _free(device):
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def leaf_norms(side, want, params0):
    """Per leaf: the norms of the params' change over the checked updates,
    the program's and the reference's."""
    import torch

    n = lambda t: round(float(torch.linalg.vector_norm(t.double())), 9)
    return {k: [n(side.params_checked[k] - params0[k]), n(want.params[k] - params0[k])]
            for k in want.params}


def first_step_readings(session, want):
    """The first step's five loss terms (the program's, the reference's),
    per leaf the norms of Adam's first moment after it (the program's, the
    reference's, their difference's), and the actions of the replayed
    rollout that differ from update 1's."""
    import torch

    side = session.side()
    n = lambda t: round(float(torch.linalg.vector_norm(t.double())), 9)
    return {"first_terms": [[round(a, 9), round(float(b), 9)]
                            for a, b in zip(side.first_terms, want.first_terms)],
            "first_leaves": {k: [n(side.first_mu[k]), n(want.first_mu[k]),
                                 n(side.first_mu[k] - want.first_mu[k])] for k in want.first_mu},
            "first_replay_off": session.first_replay_off}


def _learner_readings(cell, seeds, control_seeds, device, out, params, witness=False):
    import torch

    drv = cell.driver
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        s = drv.Session(_run(cell, seed, device, params))
        s.setup()
        s.finish()
        start, want = s.follow()
        cmp = lambda side: drv.compare(side, s.params0, start, want, s.recipe)
        if seed in seeds:
            _emit(out, seed, "program", dict(cmp(s.side()), seconds=time.perf_counter() - t0,
                                             leaves=leaf_norms(s.side(), want, s.params0),
                                             **first_step_readings(s, want),
                                             update_losses=[[round(g[0], 7), round(float(w[0]), 7)]
                                                            for g, w in zip(s.losses, want.losses)]))
        if witness:
            # the reference from weights one rounding step away: how far two
            # runs of one arithmetic part over the checked updates
            nudged = {k: v * (1 + 2 ** -23) for k, v in s.params0.items()}
            keep0 = s.params0
            s.params0 = nudged
            _, nud = s.follow()
            s.params0 = keep0
            _emit(out, seed, "witness_nudged", drv.compare(drv.followed_side(start, nud),
                                                           s.params0, start, want, s.recipe))
            del nud
            # float32 throughout in the reference's place: how far the
            # program and the bf16 reference each lie from it
            _, f32 = s.follow(matmul_dtype=torch.float32)
            wcmp = lambda side: drv.compare(side, s.params0, start, f32, s.recipe)
            _emit(out, seed, "witness_program", dict(wcmp(s.side()), leaves=leaf_norms(
                s.side(), f32, s.params0)))
            _emit(out, seed, "witness_reference", wcmp(drv.followed_side(start, want)))
            del f32
        if seed not in control_seeds:
            continue
        _, fp8 = s.follow(matmul_dtype=torch.float8_e4m3fn, own_actions=True)
        _emit(out, seed, "control", dict(cmp(drv.followed_side(start, fp8)),
                                         action_gap=fp8.sample_gaps[0],
                                         action_gap_later=max(fp8.sample_gaps[1:])))
        del fp8
        _, half = s.follow(half_batch=True)
        _emit(out, seed, "fault_half", cmp(drv.followed_side(start, half)))
        del half
        side = s.side()
        _emit(out, seed, "fault_unchanged", cmp(side._replace(
            env_checked=side.start, params_checked=dict(s.params0))))
        altered = [a.clone() for a in s.actions]
        for a in altered:  # one action a frame altered where it is drawn
            a[:, 0] = (a[:, 0].to(torch.int32) + 9).remainder(18).to(a.dtype)
        s.actions = altered
        _, alt = s.follow()
        _emit(out, seed, "fault_answer", {"action_gap": alt.sample_gaps[0],
                                          "action_gap_later": max(alt.sample_gaps[1:])})
        del alt, s
        _free(device)
        for quant in ("int8fwd", "int8"):
            prog = dict(params or {})
            prog["learner"] = dict(prog.get("learner", {}), fused_update="fm",
                                   update_quant=quant)
            c = drv.Session(_run(cell, seed, device, prog))
            c.setup()
            c.finish()
            c_start, c_want = c.follow()
            _emit(out, seed, "control_program", dict(
                drv.compare(c.side(), c.params0, c_start, c_want, c.recipe), quant=quant,
                leaves=leaf_norms(c.side(), c_want, c.params0),
                **first_step_readings(c, c_want),
                update_losses=[[round(g[0], 7), round(float(w[0]), 7)]
                               for g, w in zip(c.losses, c_want.losses)]))
            del c
            _free(device)


def _fused_readings(cell, seeds, control_seeds, device, out, params):
    import torch

    from benchmark.reference.pika import env as ref_env
    from benchmark.reference.pika import predict as ref_predict

    drv = cell.driver
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        run = _run(cell, seed, device, params)
        s = drv.Session(run)
        s.setup()
        while s.checked is None:
            s.unit()
        before, after, _ = s.checked
        before = drv._with_action_keys(drv._packed(before), s.action_key)
        after = drv._packed(after)
        values = s.check()
        if seed in seeds:
            _emit(out, seed, "program", dict({k: v["value"] for k, v in values.items()},
                                             seconds=time.perf_counter() - t0))
        if seed not in control_seeds:
            continue
        cfg = ref_env.EnvConfig(**s.env_settings)
        rows = after.shape[0]
        want = drv.reference_call(cfg, before, s.frames)[:rows]
        control = dict(run.params["control"])
        kw = {}
        if "rounds" in control:
            kw["rounds"] = int(control["rounds"])
        if "landing_cap" in control:
            cap = int(control["landing_cap"])
            kw["landing_fn"] = lambda b: ref_predict.landing_sims_any(
                b.x, b.y, b.x_velocity, b.y_velocity, cap=cap)
        got = drv.reference_call(cfg, before, s.frames, **kw)[:rows]
        _emit(out, seed, "control", {"call_envs_off": drv.envs_off(got, want), **control})
        _emit(out, seed, "fault_unchanged", {"call_envs_off": drv.envs_off(before[:rows], want)})
        half = s.batch // 2
        _emit(out, seed, "fault_half", {"call_envs_off": drv.envs_off(
            torch.cat([want[:, :half], before[:rows, half:]], dim=1), want)})
        altered = want.clone()
        altered[ref_env.FIELD_NAMES.index("score1"), 0] += 1
        _emit(out, seed, "fault_answer", {"call_envs_off": drv.envs_off(altered, want)})
        del s, before, after, want, got, altered
        _free(device)


if __name__ == "__main__":
    sys.exit(main())
