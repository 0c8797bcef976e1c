"""Traffic: ``fused_rollout`` calls back to back, the state carried from
call to call, each call's results read back to the host.

Parameters (``benchmark/workloads/<cell>.json``): ``batch`` (envs),
``frames`` (a call's frames), ``warmup_calls`` (calls on the reset state
whose results are dropped), ``check_within`` (the checked call is drawn
from the seed among the window's first this many), ``follow_sample`` (envs,
drawn from the seed, that the reference follows from its own reset),
``trace_calls`` (calls profiled in a traced run), ``count_sample`` (envs
whose work K3's count follows).  The configuration's ``env`` block gives
the environment's settings; its computer seats decide whether the landing
pool works.

A unit is one call: from its issue until the scores summed per seat and
the count of games ended, which a user's logger reads, are on the host.
The window's calls carry the state from the reset on.  The check holds
against the reference, every field: the start (the reset), every env; one
call drawn from the seed, every env, followed from the program's own state
before it; and a sample of envs followed from the reference's own reset
through every call up to and including that one.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, trace
from benchmark.reference.pika import env as ref_env
from benchmark.traffic_common import envs_off, packed_state as _packed


def _with_action_keys(rows: torch.Tensor, action_key) -> torch.Tensor:
    akey = ref_env.env_keys(action_key, rows.shape[1], rows.device)
    return torch.cat([rows, akey.t().to(rows.dtype)])


class Session:
    def __init__(self, run):
        self.run = run
        p = run.params
        self.batch, self.frames = int(p["batch"]), int(p["frames"])
        k0, k1, k2, k3, check = harness.derive(run.seed, 5)
        self.env_key = [k0, k1]
        self.action_key = [k2, k3]
        self.check_index = check % int(p["check_within"])
        self.sample_seed = check
        self.env_settings = run.cell.config["env"]
        self.index = 0
        self.spans = False
        self.checked = None

    # ----------------------------------------------------------- set-up --
    def setup(self) -> None:
        import pikazoo_tpu_torch as program

        self.rollout = program.fused_rollout
        self.cfg = program.EnvConfig(**self.env_settings)
        env = program.PikaZoo(self.cfg)
        state, _ = env.reset_batch(self.env_key, self.batch, device=self.run.device)
        self.start = _packed(state).cpu()
        self.state = state
        for _ in range(int(self.run.params["warmup_calls"])):
            self.call(state)

    # ------------------------------------------------------------ units --
    def call(self, before):
        """One call from ``before``: the state after it, and the answers on
        the host."""
        with trace.span("fused_rollout", self.spans):
            after = self.rollout(before, self.action_key, self.cfg, self.frames)
        with trace.span("readback", self.spans):
            answers = torch.cat([after.scores.sum(0), after.game_ended.sum().reshape(1)]).tolist()
        return after, answers

    def unit(self) -> dict:
        before = self.state
        t0 = time.perf_counter()
        after, answers = self.call(before)
        t1 = time.perf_counter()
        if self.index == self.check_index:
            self.checked = (before, after, answers)
        self.index += 1
        self.state = after
        return {"ms": (t1 - t0) * 1e3, "env_steps": self.batch * self.frames,
                "start": t0, "end": t1}

    def sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    # ----------------------------------------------------------- traced --
    def profile(self) -> trace.Profile:
        """``trace_calls`` more calls under the profiler, spans on."""
        self.trace_input = self.state
        self.traced = []

        def calls():
            self.spans = True
            for _ in range(int(self.run.params["trace_calls"])):
                self.traced.append(self.unit())
            self.sync()
            self.spans = False

        return trace.profile(calls)

    # ------------------------------------------------------------ check --
    def check(self) -> dict:
        """The start, the checked call (every env) and the followed sample
        against the reference.  The program's state is freed first."""
        if self.checked is None:
            return {"checked_call_missing": {"value": 1, "limit": 0}}
        before, after, answers = self.checked
        before = _packed(before)
        after = _packed(after)
        self.state = self.checked = self.trace_input = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        cfg = ref_env.EnvConfig(**self.env_settings)
        dev = self.run.device
        start = ref_env.reset_packed(cfg, self.env_key, self.action_key, self.batch, dev)
        gen = torch.Generator().manual_seed(self.sample_seed)
        sample = torch.randperm(self.batch, generator=gen)[:int(self.run.params["follow_sample"])]
        sample = sample.sort().values.to(dev)
        followed = start[:, sample]
        for _ in range(self.check_index):
            followed = reference_call(cfg, followed, self.frames)
        # The checked call and the sample's last call in one pass.
        both = reference_call(cfg, torch.cat([_with_action_keys(before, self.action_key),
                                              followed], dim=1), self.frames)
        want, followed = both[:, :self.batch], both[:, self.batch:]
        nrows = before.shape[0]
        game = ref_env.split(want)[3]
        want_answers = [int(game["score1"].sum()), int(game["score2"].sum()),
                        int(game["game_ended"].sum())]
        return {
            "start_envs_off": {"value": envs_off(self.start.to(dev), start[:nrows]), "limit": 0},
            "call_envs_off": {"value": envs_off(after, want[:nrows]), "limit": 0},
            "sample_envs_off": {"value": envs_off(after[:, sample], followed[:nrows]),
                                "limit": 0},
            "answers_off": {"value": sum(int(a != b) for a, b in zip(answers, want_answers)),
                            "limit": 0},
        }


def reference_call(cfg, packed: torch.Tensor, frames: int, **frame_kw) -> torch.Tensor:
    """The reference's call: ``frames`` frames from a packed state."""
    with torch.no_grad():
        return ref_env.rollout_packed(packed, cfg, frames, **frame_kw)
