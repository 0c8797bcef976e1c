"""One rank of the meshed PPO trainer, over a real ``torch.distributed`` group.

    python -m pikazoo_tpu_torch.tools.multihost_smoke RANK WORLD PORT DEVICE MODE \\
        [IN.npz OUT.npz] [--num-envs B --rollout-length T ... --updates U]

Counterpart of the root ``tools/multihost_smoke.py``.  Launched once a rank:
each process joins a group of WORLD ranks over ``tcp://127.0.0.1:PORT``
(gloo on the CPU, and for two ranks sharing one card; nccl for ranks on
cards of their own, ``--backend``), builds ``make_env_mesh(DEVICE)`` and
runs ``make_ppo_trainer`` on it for ``--updates`` updates.  MODE is the
trainer's ``fused_update`` (``off``, ``fm``, ``on``), with ``,p1`` for
``learner_seats="p1"``.  It prints ``process {rank}: loss=... world={n} OK``.

Given ``IN.npz`` (``-`` for none; every key optional; no JAX is imported here): ``params.*``
(the port's parameter names), ``env.*`` (an ``EnvState``'s leaves by dotted
field name, global), ``last_obs`` (global) and ``uniforms`` (the first
update's global (T, 1, 2B) rows, e.g. a JAX run's) replace the seeded ones.
``--resume CKPT`` restores a checkpoint instead (any world's).  Before the
updates it rolls out the first update once on its own, with every
``torch.distributed`` collective counted (the rollout must make none), and
takes the first minibatch's gradient (summed over ranks).  It then runs the
updates, counting the learner's ``all_reduce`` calls and K1's launches, and
timing each update.  Given ``OUT.npz`` every rank writes ``OUT`` with
``.rank{r}`` before ``.npz``: the starting runner's params, env state and
last observations, gathered in rank order (``start.*``), its shard of that
first rollout's trajectory
(``traj.*``), the first minibatch gradient (``grad.*``), the final params
(``params.*``), the final runner's env state and last observations gathered
in rank order (``env.*``, ``last_obs``), the metrics of each update
(``metrics``, (U, 7)), the env state after the first update, gathered
(``first.env.*``), the counts (``all_reduce_calls``, ``all_reduce_bytes``) and
the ms of each update (``--no-traj`` leaves the trajectory out); ``--save
CKPT`` writes the final runner's checkpoint (rank 0 writes).  ``--spans``
runs the updates with the program's spans on and adds, for each span that
holds a ``pikazoo.mesh.all_reduce`` span, how many it holds
(``all_reduce_under.<name>``, the name without ``pikazoo.``).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo  # noqa: E402
from pikazoo_tpu_torch.envs.pika_volley import EnvState  # noqa: E402
from pikazoo_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from pikazoo_tpu_torch.train import PPOConfig, checkpoint, make_ppo_trainer  # noqa: E402
from pikazoo_tpu_torch.train import fused_update  # noqa: E402
from pikazoo_tpu_torch.train.networks import apply_fm  # noqa: E402
from pikazoo_tpu_torch.train.ppo import Transition, gae_associative  # noqa: E402
from pikazoo_tpu_torch.utils.profiling import take_spans, tracing  # noqa: E402

# Every collective of torch.distributed that a trainer could call.
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
               "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "gather", "scatter", "barrier", "send", "recv")


@contextlib.contextmanager
def count_collectives():
    """Count every ``torch.distributed`` collective called inside."""
    counts = {"calls": 0}
    saved = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def counting(fn):
        def wrapped(*args, **kwargs):
            counts["calls"] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in saved.items():
        setattr(dist, name, counting(fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def leaves(tree, prefix: str):
    """(dotted name, tensor) of nested (Named)tuples."""
    if torch.is_tensor(tree):
        yield prefix, tree
        return
    for name, sub in zip(tree._fields, tree):
        yield from leaves(sub, f"{prefix}.{name}")


def env_state_from(arrays: dict, like: EnvState, device) -> EnvState:
    """An ``EnvState`` from ``env.*`` arrays, in ``like``'s structure."""
    def build(tree, prefix):
        if torch.is_tensor(tree):
            return torch.from_numpy(np.ascontiguousarray(arrays[prefix])).to(device)
        return type(tree)(*[build(sub, f"{prefix}.{name}")
                            for name, sub in zip(tree._fields, tree)])
    return build(like, "env")


def as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("port", type=int)
    p.add_argument("device")
    p.add_argument("mode")
    p.add_argument("inp", nargs="?", default=None, metavar="IN.npz")
    p.add_argument("out", nargs="?", default=None, metavar="OUT.npz")
    p.add_argument("--backend", default=None,
                   help="gloo or nccl (default: gloo, the one that takes two ranks a card)")
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--rollout-length", type=int, default=16)
    p.add_argument("--minibatches", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--hidden", type=int, nargs="+", default=[32, 32])
    p.add_argument("--winning-score", type=int, default=2)
    p.add_argument("--updates", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None, help="restore this checkpoint first")
    p.add_argument("--save", default=None, help="checkpoint the final runner here")
    p.add_argument("--no-traj", action="store_true",
                   help="leave the trajectory out of OUT (it is T x 35 x 2b bf16)")
    p.add_argument("--spans", action="store_true",
                   help="run the updates with the program's spans on and count the "
                        "all_reduce spans under each parent span")
    args = p.parse_args(argv)
    if args.updates < 1:
        p.error("--updates must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    mesh_mod.init_distributed(backend=args.backend or "gloo",
                              init_method=f"tcp://127.0.0.1:{args.port}",
                              rank=args.rank, world_size=args.world, device=device)
    try:
        return run(args, device)
    finally:
        dist.destroy_process_group()


def run(args, device: torch.device) -> int:
    mesh = mesh_mod.make_env_mesh(device)
    if (mesh.rank, mesh.world_size) != (args.rank, args.world):
        raise RuntimeError(f"joined as rank {mesh.rank} of {mesh.world_size}, not "
                           f"{args.rank} of {args.world}")
    fused, _, seats = args.mode.partition(",")
    cfg = PPOConfig(num_envs=args.num_envs, rollout_length=args.rollout_length,
                    num_minibatches=args.minibatches, update_epochs=args.epochs,
                    hidden=tuple(args.hidden), fused_update=fused,
                    learner_seats=seats or "both")
    env = PikaZoo(EnvConfig(winning_score=args.winning_score))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device=device, mesh=mesh)
    runner = init_fn(args.seed)
    uniforms = None
    if args.resume:
        runner = checkpoint.restore(args.resume, runner, mesh)
    if args.inp not in (None, "", "-"):
        data = dict(np.load(args.inp))
        params = {k[len("params."):]: torch.from_numpy(v).to(device)
                  for k, v in data.items() if k.startswith("params.")}
        if params:
            tx_init, _ = train_step.tx
            runner = runner._replace(params=params, opt_state=tx_init(params))
        if any(k.startswith("env.") for k in data):
            state = env_state_from(data, runner.env_state, device)
            runner = runner._replace(env_state=mesh_mod.shard_batch(state, mesh))
        if "last_obs" in data:
            runner = runner._replace(last_obs=mesh_mod.shard_batch(
                torch.from_numpy(data["last_obs"]).to(device), mesh))
        if "uniforms" in data:
            uniforms = torch.from_numpy(data["uniforms"]).to(device)
    out = {f"start.{name}": as_numpy(t) for name, t in
           leaves(mesh_mod.gather_batch(runner.env_state, mesh), "env")}
    out["start.last_obs"] = as_numpy(mesh_mod.gather_batch(runner.last_obs, mesh))
    out.update({f"start.params.{k}": as_numpy(v) for k, v in runner.params.items()})

    # The first update's rollout alone, every collective counted, and the
    # first minibatch's gradient from it.
    local_u = (train_step.uniforms_fn(_copy(runner.key)) if uniforms is None
               else train_step.local_columns_fn(uniforms))
    with count_collectives() as rollout_counts:
        (_, last_norm), traj = train_step.rollout_fn(runner.params, runner.env_state,
                                                     runner.last_obs, local_u)
    _, last_value = apply_fm(runner.params, last_norm, cfg.activation)
    adv, targets = gae_associative(traj.value, traj.reward, traj.done, last_value,
                                   cfg.gamma, cfg.gae_lambda)
    if cfg.learner_seats == "p1":
        half = traj.action.shape[-1] // 2
        ltraj = Transition(*[leaf[..., :half] for leaf in traj])
        adv, targets = adv[..., :half], targets[..., :half]
    else:
        ltraj = traj
    t_mb = cfg.rollout_length // cfg.num_minibatches
    grads, _ = train_step.minibatch_grads_fn(
        runner.params, Transition(*[leaf[:t_mb] for leaf in ltraj]), adv[:t_mb],
        targets[:t_mb])
    if not args.no_traj:
        out.update({f"traj.{k}": as_numpy(v) for k, v in zip(Transition._fields, traj)})
    del traj, ltraj, adv, targets
    out.update({f"grad.{k}": as_numpy(v) for k, v in grads.items()})

    # The updates, counted and timed.
    mesh_mod.zero_counts()
    fused_update.zero_fm_counts()
    metrics, ms = [], []
    with count_collectives() as update_counts, tracing(args.spans):
        for update in range(args.updates):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            runner, m = train_step(runner, uniforms if update == 0 else None)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(torch.stack([x.float() for x in m[:7]]).cpu().numpy())
            # The env after the first rollout: sampled with the same params on
            # every world, so bit-equal to one rank's.
            first = runner.env_state if update == 0 else first
    out.update({f"first.{name}": as_numpy(t) for name, t in
                leaves(mesh_mod.gather_batch(first, mesh), "env")})
    out["metrics"] = np.stack(metrics)
    out["update_ms"] = np.asarray(ms)
    out["rollout_collectives"] = np.asarray(rollout_counts["calls"])
    out["update_collectives"] = np.asarray(update_counts["calls"])
    out["all_reduce_calls"] = np.asarray(mesh_mod.all_reduce_sum.calls)
    out["all_reduce_bytes"] = np.asarray(mesh_mod.all_reduce_sum.bytes)
    spans = take_spans()
    for span in spans:
        if span.name == "pikazoo.mesh.all_reduce" and span.parent >= 0:
            key = "all_reduce_under." + spans[span.parent].name[len("pikazoo."):]
            out[key] = np.asarray(int(out.get(key, 0)) + 1)
    out["k1_launches"] = np.asarray(fused_update.fused_ppo_grads_fm.launches)
    out.update({f"params.{k}": as_numpy(v) for k, v in runner.params.items()})
    out.update({name: as_numpy(t) for name, t in
                leaves(mesh_mod.gather_batch(runner.env_state, mesh), "env")})
    out["last_obs"] = as_numpy(mesh_mod.gather_batch(runner.last_obs, mesh))
    if args.save:
        checkpoint.save(args.save, runner, mesh)
    if args.out:
        stem = args.out[:-len(".npz")] if args.out.endswith(".npz") else args.out
        np.savez(f"{stem}.rank{args.rank}.npz", **out)
    loss = float(out["metrics"][-1][0])
    if rollout_counts["calls"] or not np.isfinite(loss):
        print(f"process {args.rank}: rollout collectives {rollout_counts['calls']}, "
              f"loss={loss}", flush=True)
        return 1
    print(f"process {args.rank}: loss={loss:.6f} world={mesh.world_size} "
          f"ms/update={np.mean(ms):.1f} OK", flush=True)
    return 0


def _copy(generator: torch.Generator) -> torch.Generator:
    """A generator in the same state, so the runner's is not advanced."""
    twin = torch.Generator(device=generator.device)
    twin.set_state(generator.get_state())
    return twin


if __name__ == "__main__":
    sys.exit(main())
