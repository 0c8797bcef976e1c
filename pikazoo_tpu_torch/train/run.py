"""Self-play PPO training CLI on one device.

Usage:
    python -m pikazoo_tpu_torch.train.run --num-envs 65536 --updates 100 \\
        --metrics out.jsonl

Counterpart of ``pikazoo_tpu.train.run`` without the flags whose modules are
not ported yet (checkpointing, multi-host, wrappers, profiling).  Runs on
the card (``--device cuda``, the default) and raises when there is none;
``--device cpu`` runs on the CPU.  Prints one line per update and, with
``--metrics``, writes one JSON object per update (after a header line with
the resolved dispatch).
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--vs-ai", action="store_true",
                   help="train seat 1 against the built-in rule AI on seat 2 "
                        "instead of symmetric self-play")
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
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
    from pikazoo_tpu_torch.train import PPOConfig, make_ppo_trainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is false; "
                           "pass --device cpu to train on the CPU")
    env = PikaZoo(EnvConfig(winning_score=args.winning_score, serve=args.serve,
                            auto_reset=True, is_player2_computer=args.vs_ai))
    cfg = PPOConfig(num_envs=args.num_envs, rollout_length=args.rollout_length,
                    learning_rate=args.learning_rate,
                    learner_seats="p1" if args.vs_ai else "both",
                    fused_update=args.fused_update, shuffle_minibatches=args.shuffle)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, device=device)
    runner = init_fn(args.seed)
    header = {"provenance": {**train_step.provenance, "device": str(device),
                             "device_name": (torch.cuda.get_device_name(device)
                                             if device.type == "cuda" else "cpu")}}
    print(json.dumps(header), flush=True)
    out = open(args.metrics, "w") if args.metrics else None
    if out:
        out.write(json.dumps(header) + "\n")
    steps_per_update = cfg.num_envs * cfg.rollout_length
    start = time.perf_counter()
    for update in range(args.updates):
        t0 = time.perf_counter()
        runner, metrics = train_step(runner)
        # One transfer of every metric; it also waits for the update to end.
        values = torch.stack([m.float() for m in metrics[:7]]).tolist()
        seconds = time.perf_counter() - t0
        row = dict(zip(metrics._fields[:7], values), update=update,
                   env_steps=metrics.env_steps,
                   env_steps_per_s=steps_per_update / seconds)
        print(f"update {update}: loss {row['total_loss']:.4f} entropy "
              f"{row['entropy']:.4f} kl {row['approx_kl']:.5f} episodes "
              f"{row['episodes_finished']:.0f} {row['env_steps_per_s']:.0f} "
              "env-steps/s", flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    if out:
        out.close()
    total = time.perf_counter() - start
    print(f"done: {args.updates} updates, "
          f"{args.updates * steps_per_update / total:.0f} env-steps/s sustained",
          flush=True)


if __name__ == "__main__":
    main()
