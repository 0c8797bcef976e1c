"""Evaluate the committed policies on the card: against the rule AI, head to
head, and as Elo.

Usage: python pikazoo_tpu_torch/examples/evaluate_policies.py [--device cuda]

The port's counterpart of ``examples/evaluate_policies.py``, on the
``pikazoo_tpu_torch/policies/*.pt`` files, with the JAX package's strength
gates (``tests/test_trained_artifact.py``) at their settings (16 envs,
sampled actions): each policy against the rule AI to 5 points over 8000
frames (``vs_ai_policy`` and ``selfplay_policy_xl`` must win > 0.9,
``selfplay_policy`` > 0.8); ``vs_ai_policy`` against a fresh init to 3
points over 6000 frames (> 0.75); the two self-play policies head to head in
both seat orders; Elo of the three and the rule AI, anchored at the rule AI
(1000) through the vs-AI results.  Prints a line a match, with its
milliseconds a frame, and a JSON summary as the last line; exits 1 if a
gate fails.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pikazoo_tpu_torch.policies import load_policy, policy_path  # noqa: E402
from pikazoo_tpu_torch.train import ActorCritic  # noqa: E402
from pikazoo_tpu_torch.train.evaluate import (bradley_terry_elo,  # noqa: E402
                                              evaluate_head_to_head, evaluate_vs_computer)

# name: (seed, gate) of tests/test_trained_artifact.py's vs-AI checks.
VS_AI = {"vs_ai_policy": (3, 0.9), "selfplay_policy": (31, 0.8),
         "selfplay_policy_xl": (33, 0.9)}


def timed(label, fn, frames, card):
    t0 = time.perf_counter()
    r = fn()
    games, wins = int(r.games), int(r.policy_wins)   # the read-back waits for the card
    ms = (time.perf_counter() - t0) * 1e3 / frames
    print(f"{label}: {wins}/{games} ({float(r.win_rate):.3f}), mean score diff "
          f"{float(r.mean_score_diff):+.3f}; {ms:.2f} ms a frame [{card}]", flush=True)
    return {"games": games, "wins": wins, "win_rate": float(r.win_rate),
            "mean_score_diff": float(r.mean_score_diff), "ms_per_frame": ms}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--max-frames", type=int, default=8000)
    args = p.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is false; "
                           "pass --device cpu to evaluate on the CPU")
    name_of = torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" \
        else "cpu"
    nets = {name: load_policy(policy_path(name), device) for name in VS_AI}
    n, frames = args.num_envs, args.max_frames
    results, gates = {}, {}

    # 1. Each policy against the rule AI (seat 1 against the AI's seat 2).
    for name, (seed, gate) in VS_AI.items():
        r = results[f"{name} vs rule AI"] = timed(
            f"{name} vs rule AI", lambda: evaluate_vs_computer(
                nets[name], num_envs=n, max_frames=frames, winning_score=5,
                greedy=False, seed=seed, device=device), frames, name_of)
        gates[f"{name} vs rule AI > {gate}"] = r["games"] >= 8 and r["win_rate"] > gate

    # 2. The vs-AI policy against a fresh init.
    fresh = ActorCritic(generator=torch.Generator().manual_seed(0)).to(device)
    fresh_frames = frames * 3 // 4
    r = results["vs_ai_policy vs fresh init"] = timed(
        "vs_ai_policy vs fresh init", lambda: evaluate_head_to_head(
            nets["vs_ai_policy"], fresh, num_envs=n, max_frames=fresh_frames,
            winning_score=3, greedy=False, seed=5, device=device), fresh_frames, name_of)
    gates["vs_ai_policy vs fresh init > 0.75"] = r["games"] >= 8 and r["win_rate"] > 0.75

    # 3. The self-play policies head to head, both seat orders (near peers
    #    can be seat-sensitive), and Elo anchored at the rule AI.
    members = ["selfplay_policy", "selfplay_policy_xl", "rule AI"]
    wins, games = np.zeros((3, 3)), np.zeros((3, 3))
    for a, b in ((0, 1), (1, 0)):
        label = f"{members[a]} (seat 1) vs {members[b]}"
        r = results[label] = timed(label, lambda: evaluate_head_to_head(
            nets[members[a]], nets[members[b]], num_envs=n, max_frames=frames,
            winning_score=3, greedy=False, seed=2 + a, device=device), frames, name_of)
        wins[a, b] += r["wins"]
        wins[b, a] += r["games"] - r["wins"]
        games[a, b] += r["games"]
        games[b, a] += r["games"]
    for i in (0, 1):
        r = results[f"{members[i]} vs rule AI"]
        wins[i, 2] += r["wins"]
        wins[2, i] += r["games"] - r["wins"]
        games[i, 2] += r["games"]
        games[2, i] += r["games"]
    elo = bradley_terry_elo(wins, games, anchor=2, anchor_elo=1000.0)
    print("Elo (rule AI anchored at 1000): " + ", ".join(
        f"{m} {e:.0f}" for m, e in sorted(zip(members, elo), key=lambda kv: -kv[1])))
    print(json.dumps({"device": name_of, "results": results,
                      "elo": dict(zip(members, elo.tolist())), "gates": gates}))
    return 0 if all(gates.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
