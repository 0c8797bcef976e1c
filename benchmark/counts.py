"""The yardstick's arithmetic: the card's peaks, roofline bounds, the
operation and byte counts of K1 and K3, and the rate and percentile
arithmetic of the end-to-end metrics.

Frozen here so that later changes to the program cannot move it: the
constants and the K1 count are copies of ``chip_smoke.py``'s (``bound``,
``THREEFRY_OPS``, ``LANDING_ITERATION_OPS``, ``grad_bound``), and K3's work is
counted on the benchmark's own reference (``reference/pika``), not by the
kernel's counters.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from benchmark.reference.pika import constants as C
from benchmark.reference.pika import env as ref_env
from benchmark.reference.pika import predict as ref_predict
from benchmark.reference.pika.ai import computer_decide_input
from benchmark.reference.pika.rng import site_value

# NVIDIA's published H100 SXM figures (dense, 700 W): HBM bytes/s and peak
# operations/s by type.  Integer work runs on the CUDA cores' INT32 units:
# 132 SMs x 64 units x 1.98 GHz, one operation a unit a clock.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "int32": 132 * 64 * 1.98e9}
# Integer operations of one lane's landing-loop iteration (adds, compares,
# selects, abs, negations of the reference's ``_one_iteration``).
LANDING_ITERATION_OPS = 28
# Integer operations of one threefry2x32 first word: the key schedule's two
# xors, the two counter-key adds, 20 rounds of add, rotate and xor, and five
# key injections (three operations each but the last, one).
THREEFRY_OPS = 2 + 2 + 20 * 3 + 4 * 3 + 1


def bound_s(nbytes: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of the bytes over HBM's rate
    and the operations over the peak rate of their type."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = sum(float(n) / PEAK_OPS_PER_S[t] for t, n in ops.items())
    return (ops_s, "operations") if ops_s > bytes_s else (bytes_s, "bytes")


# ------------------------------------------------------------- end to end --

def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile over all values, linear between order
    statistics (numpy's default method)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work over the time it took."""
    if seconds <= 0:
        raise ValueError(f"no time measured ({seconds} s)")
    return work / seconds


# --------------------------------------------------------------------- K1 --

def mlp_widths(hidden: Sequence[int], obs_dim: int = 35) -> list:
    return [obs_dim, *hidden]


def param_count(hidden: Sequence[int], num_actions: int = 18, obs_dim: int = 35) -> int:
    """Weights and biases of the (obs_dim, *hidden, num_actions + 1) network
    with its separate policy and value heads."""
    widths = mlp_widths(hidden, obs_dim)
    body = sum(i * o + o for i, o in zip(widths[:-1], widths[1:]))
    return body + widths[-1] * num_actions + num_actions + widths[-1] + 1


def grad_bound_s(columns: int, hidden: Sequence[int], num_actions: int = 18,
                 obs_dim: int = 35) -> Tuple[float, str]:
    """The bound of one bf16 PPO-gradient call over ``columns`` columns:
    the inputs read and the grads written once, and the products'
    operations at the bf16 rate (forward, the dW products, the dh
    products)."""
    widths = mlp_widths(hidden, obs_dim)
    body = 2 * sum(i * o for i, o in zip(widths[:-1], widths[1:]))  # one pass
    body_dh = 2 * sum(i * o for i, o in zip(widths[1:-1], widths[2:]))
    head = 2 * widths[-1] * (num_actions + 1)
    forward, backward = body + head, body + 2 * head + body_dh
    n_params = param_count(hidden, num_actions, obs_dim)
    nbytes = columns * (obs_dim * 2 + 5 * 4) + n_params * (4 + 4)
    return bound_s(nbytes, {"bf16": columns * (forward + backward)})


def update_model_flops(num_envs: int, rollout_length: int, update_epochs: int,
                       hidden: Sequence[int], num_actions: int = 18) -> float:
    """Model FLOPs of one self-play PPO update: 2 P a column for the
    rollout's forward (2B columns a frame) and for ``last_value``, and 6 P
    a column an epoch in the update, P the weights of the network."""
    p = param_count(hidden, num_actions)
    columns = rollout_length * 2 * num_envs
    return 2 * p * (columns + 2 * num_envs) + 6 * p * update_epochs * columns


# --------------------------------------------------------------------- K3 --

class K3Work:
    """The work a fused call needs, counted on the reference: threefry draws
    and landing-loop iterations.  A true ball's iterations count only in a
    frame where its trajectory changed since that env's previous frame (a
    continuing ball lands where it did); a seat's candidate iterations only
    where the seat asks, in its coin's order up to and including the first
    accepted candidate, all 6 if none is."""

    def __init__(self, batch: int, device):
        self.batch, self.device = batch, device
        self.draws = 0
        self.true_iterations = 0
        self.candidate_iterations = 0
        self.frames = 0
        self._landed_after = None
        k = torch.arange(6, device=device).reshape(6, 1)
        self._order = (k.expand(6, batch), torch.where(k < 3, 2 - k, 8 - k).expand(6, batch))

    def _landing(self, ball):
        live = torch.zeros((7, self.batch), dtype=torch.int32, device=self.device)
        x, y, vx, vy = ball.x, ball.y, ball.x_velocity, ball.y_velocity
        # The true ball after its first iteration: where next frame's ball
        # stands if it continues this trajectory.
        first = ref_predict._one_iteration(x, y, vx, vy, 1, torch.tensor(True))
        start = torch.stack([x, y, vx, vy])
        out = ref_predict.landing_sims_any(x, y, vx, vy, live=live)
        changed = torch.ones(self.batch, dtype=torch.bool, device=self.device)
        if self._landed_after is not None:
            changed = ~((start == self._landed_after[0]).all(0) & self._landed_after[1])
        self.true_iterations += int(torch.where(changed, live[0], 0).sum())
        self._landed_after = (torch.stack(first), (first[2] != 0) &
                              (live[0] < C.INFINITE_LOOP_LIMIT))
        self._live = live
        return out

    def _decide(self, p, other, ball, cand, is_player2, ds):
        out = computer_decide_input(p, other, ball, cand, is_player2, ds)
        asks = (((p.state == 1) | (p.state == 2)) & ((ball.x - p.x).abs() < 48) &
                ((ball.y - p.y).abs() < 48))
        coin = site_value(out[2].key, out[2].counter - 1, 2)  # the AI's last draw
        lb = C.GROUND_HALF_WIDTH if is_player2 else 0
        far_side = (C.GROUND_WIDTH if is_player2 else 0) + C.GROUND_HALF_WIDTH
        accepted = ((cand <= lb) | (cand >= far_side)) & ((cand - other.x).abs() > C.PLAYER_LENGTH)
        order = torch.where(coin == 0, self._order[0], self._order[1])
        acc = accepted.gather(0, order).to(torch.int32)
        iters = self._live[1:].gather(0, order)
        searching = asks & (acc.cumsum(0) - acc == 0)
        self.candidate_iterations += int(torch.where(searching, iters, 0).sum())
        return out

    def run(self, packed: torch.Tensor, cfg, frames: int) -> torch.Tensor:
        """Advance the reference ``frames`` frames from ``packed``, counting."""
        computer = cfg.is_player1_computer or cfg.is_player2_computer
        hooks = dict(landing_fn=self._landing, decide_fn=self._decide) if computer else {}
        before = ref_env.split(packed)[3]["draw_counter"].long().sum()
        p1, p2, ball, game = ref_env.split(packed)
        for _ in range(frames):
            p1, p2, ball, game = ref_env.fused_frame(cfg, p1, p2, ball, game, **hooks)
        after = game["draw_counter"].long().sum()
        self.draws += 2 * self.batch * frames + int(after - before)
        self.frames += frames
        return ref_env.join(p1, p2, ball, game)

    @property
    def landing_iterations(self) -> int:
        return self.true_iterations + self.candidate_iterations

    def ops(self) -> int:
        return self.draws * THREEFRY_OPS + self.landing_iterations * LANDING_ITERATION_OPS


def k3_call_bound_s(work: K3Work, batch: int) -> Tuple[float, str]:
    """The bound of one call over ``batch`` envs from ``work`` counted on a
    sample of ``work.batch`` envs over one call's frames, scaled to the
    batch: its operations at the int32 rate, or the packed state read and
    written once."""
    scale = batch / work.batch
    return bound_s(2 * ref_env.NFIELDS * batch * 4, {"int32": work.ops() * scale})


def k3_traced_bound(run) -> Tuple[float, str]:
    """The bound of the first traced call of a fused cell: its work counted
    on the reference over ``count_sample`` envs drawn from the seed, from
    the state the call started from, scaled to the batch.  Counted once a
    run (``run.once``)."""
    from benchmark.harness import derive
    from benchmark.traffic_common import packed_state

    def count():
        s = run.session
        sample = int(run.params["count_sample"])
        gen = torch.Generator().manual_seed(derive(run.seed, 7)[6])
        idx = torch.randperm(s.batch, generator=gen)[:sample].sort().values.to(run.device)
        rows = packed_state(s.trace_input)
        akey = ref_env.env_keys(s.action_key, s.batch, run.device)
        packed = torch.cat([rows, akey.t().to(rows.dtype)])[:, idx].contiguous()
        cfg = ref_env.EnvConfig(**s.env_settings)
        work = K3Work(sample, run.device)
        with torch.no_grad():
            work.run(packed, cfg, s.frames)
        run.readings["k3_work"] = {"draws": work.draws, "true_iterations": work.true_iterations,
                                   "candidate_iterations": work.candidate_iterations,
                                   "sample": sample}
        return k3_call_bound_s(work, s.batch)

    return run.once("k3_bound", count)
