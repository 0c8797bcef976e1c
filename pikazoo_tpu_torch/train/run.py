"""Self-play PPO training CLI.

Usage:
    python -m pikazoo_tpu_torch.train.run --num-envs 65536 --updates 100 \\
        --checkpoint-dir ckpt --metrics out.jsonl
    torchrun --nproc-per-node N -m pikazoo_tpu_torch.train.run --distributed ...

Counterpart of ``pikazoo_tpu.train.run``, every flag included.  Runs on the
card (``--device cuda``, the default: ``cuda:{LOCAL_RANK}``) and raises when
there is none; ``--device cpu`` runs on the CPU.  ``--distributed`` joins the
process group that ``torchrun`` describes (nccl on cards, gloo on the CPU)
and shards the env batch over its ranks (``parallel.make_env_mesh``):
``--num-envs`` is global, and only rank 0 logs, writes metrics and writes
checkpoints.  ``--simplify-actions`` and ``--ball-shaping`` train
through the wrappers, which the trainer's rollout applies.  With
``--checkpoint-dir`` the run resumes from the newest checkpoint there
(``<dir>/latest``) and writes one every ``--checkpoint-every`` updates; a
resumed run equals an uninterrupted one bit for bit.  ``--metrics`` writes
the JAX CLI's JSONL: a header with the resolved dispatch and the device's
name, then one record an update.  ``--profile-dir`` traces update 3 of the
run with ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-length", type=int, default=128)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--winning-score", type=int, default=15)
    p.add_argument("--serve", default="winner",
                   choices=("winner", "alternate", "random"))
    p.add_argument("--simplify-actions", action="store_true",
                   help="train on the 13-action SimplifyAction space")
    p.add_argument("--vs-ai", action="store_true",
                   help="train seat 1 against the built-in rule AI on seat 2 "
                        "instead of symmetric self-play")
    p.add_argument("--ball-shaping", type=float, nargs=8, default=None,
                   metavar="R", help="RewardByBallPosition 8-tuple")
    p.add_argument("--fused-update", default="auto", choices=["auto", "on", "fm", "off"],
                   help="minibatch gradient: auto = the feature-major kernel K1 on "
                        "CUDA, autograd on the CPU; fm = K1; on = the row-major "
                        "kernel K4; off = autograd")
    p.add_argument("--shuffle", action="store_true",
                   help="textbook-PPO trajectory time-axis shuffle before the "
                        "minibatch split")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu on request)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of update 3 into this dir")
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun process group first and shard the env batch "
                        "over its ranks")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """``cuda`` is this rank's card, ``cuda:{LOCAL_RANK}``; a card that is
    not there raises."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is false; "
                           "pass --device cpu to train on the CPU")
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} asked for, but {torch.cuda.device_count()} card(s) "
                           "are visible")
    return device


def main(argv=None):
    """Train; returns the final ``PPORunnerState``."""
    args = parse_args(argv)
    from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
    from pikazoo_tpu_torch.parallel import barrier, init_distributed, make_env_mesh
    from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer
    from pikazoo_tpu_torch.train import checkpoint as ckpt
    from pikazoo_tpu_torch.utils import MetricsLogger, Throughput, profile_trace
    from pikazoo_tpu_torch.wrappers import RewardByBallPosition, SimplifyAction

    device = resolve_device(args.device)
    if args.distributed:
        init_distributed(backend="nccl" if device.type == "cuda" else "gloo", device=device)
    mesh = make_env_mesh(device)
    lead = mesh.rank == 0
    env = PikaZoo(EnvConfig(winning_score=args.winning_score, serve=args.serve,
                            auto_reset=True, is_player2_computer=args.vs_ai))
    if args.ball_shaping is not None:
        env = RewardByBallPosition(env, tuple(args.ball_shaping))
    if args.simplify_actions:
        env = SimplifyAction(env)
    cfg = PPOConfig(num_envs=args.num_envs, rollout_length=args.rollout_length,
                    num_actions=env.num_actions, learning_rate=args.learning_rate,
                    learner_seats="p1" if args.vs_ai else "both",
                    fused_update=args.fused_update, shuffle_minibatches=args.shuffle)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device=device, mesh=mesh)
    runner = init_fn(args.seed)
    start_update = 0
    latest = args.checkpoint_dir and os.path.join(args.checkpoint_dir, "latest")
    if latest and lead:
        ckpt.latest_restorable(latest)  # rank 0 alone promotes a stranded .new
    barrier(mesh)
    restorable = latest and ckpt.latest_restorable(latest)
    if restorable:
        runner = ckpt.restore(restorable, runner, mesh)
        start_update = runner.update_index
        if lead:
            print(f"resumed from update {start_update}", flush=True)
    if latest and lead:
        os.makedirs(args.checkpoint_dir, exist_ok=True)

    logger = MetricsLogger(args.metrics if lead else None, print_every=1 if lead else 0)
    if lead:
        logger.header({"provenance": {
            **train_step.provenance, "device": str(device),
            "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu")}})
    meter = Throughput(unit_steps=cfg.num_envs * cfg.rollout_length)
    for update in range(start_update, start_update + args.updates):
        if args.profile_dir and update == start_update + 3:
            with profile_trace(args.profile_dir):
                runner, metrics = train_step(runner)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        else:
            runner, metrics = train_step(runner)
        # One transfer of every metric; it also waits for the update to end.
        values = torch.stack([m.float() for m in metrics[:7]]).tolist()
        meter.tick()
        m = dict(zip(metrics._fields[:7], values))
        logger.log(update, {
            "loss": m["total_loss"],
            "policy_loss": m["policy_loss"],
            "value_loss": m["value_loss"],
            "entropy": m["entropy"],
            "approx_kl": m["approx_kl"],
            "episodes": m["episodes_finished"],
            "env_steps_per_s": meter.steps_per_s,
        })
        if latest and (update + 1) % args.checkpoint_every == 0:
            t0 = time.perf_counter()
            ckpt.save(latest, runner, mesh)
            if lead:
                print(f"checkpointed at update {update} "
                      f"({time.perf_counter() - t0:.3f} s)", flush=True)
    logger.close()
    if lead:
        print(f"done: {args.updates} updates, "
              f"{meter.steps_per_s:.0f} env-steps/s sustained", flush=True)
    return runner


if __name__ == "__main__":
    main()
