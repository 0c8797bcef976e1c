"""Traffic: the data-parallel self-play PPO learner, one rank a card, its
updates back to back through ``make_ppo_trainer(..., mesh=)``'s
``train_step``, as ``torchrun --nproc-per-node N -m
pikazoo_tpu_torch.train.run --distributed`` runs them.

Parameters (``benchmark/workloads/<cell>.json``): those of ``ppo_updates.py``
(``checked_updates``, ``trace_updates``, ``learner``), and, for the
calibration and the tests only, ``drop_gradient_rank``: that rank's gradient
and loss terms are left out of every sum over ranks (a fault the check must
catch).  The configuration's ``mesh`` block gives the world size and the
backend; on the CPU the ranks join over gloo.

Rank 0 is the harness's own process.  Its set-up opens a rendezvous of its
own (a ``TCPStore`` on a port the system picks, so that the host pass's
second group never meets the first), then starts ranks 1 to n-1, each a
process of this file on its own card.  Every rank joins through the
program's ``init_distributed``, builds ``make_env_mesh`` on its card and the
trainer on that mesh with the global ``num_envs``, makes the weights from
the seed, and runs the checked updates.  Each later unit of rank 0 first
tells the other ranks, on their standard input, to run one, so that all
ranks run the same updates.  A unit ends when rank 0 has the globally
reduced losses on the host: the update's last ``all_reduce`` cannot end
before every rank has reached it, so the rate is the deployment's.

The check: every rank takes its first optimizer step once more, together
(``ppo_updates.Session.first_step``: its gradient sums over ranks), then the
benchmark gathers each rank's start, env state, actions, parameters, Adam
state and last losses to rank 0 with ``torch.distributed.all_gather`` (the
program's ``gather_batch`` is under test and is not used), and the other
ranks exit.  Rank 0 frees the program's state and follows all envs with the
reference on its card, with the program's actions laid out in the order of
the global batch (each rank's seat-1 columns, then each rank's seat-2
columns) and the same uniforms, as ``ppo_updates.py`` follows one card.
``ranks_params_off`` and ``ranks_losses_off`` count the elements in which
any rank differs from rank 0.

Failing fast: rendezvous and collectives time out (``RENDEZVOUS_S``,
``COLLECTIVE_S``); rank 0 watches the other ranks and exits with an error as
soon as one ends before it was told to; a rank dies with rank 0 (the
kernel's parent-death signal); a rank that does not exit once told is
killed.
"""

from __future__ import annotations

import atexit
import ctypes
import datetime
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List

import torch
import torch.distributed as dist

from benchmark import harness
from benchmark.traffic import ppo_updates as single
from benchmark.traffic_common import packed_state

ROOT = Path(__file__).resolve().parents[2]
RENDEZVOUS_S = 300  # every rank joins the group within this
# Any one collective of the group, including the first update's, which
# waits for the slowest rank's kernel builds on a checkout's first run.
COLLECTIVE_S = 600
STOP_S = 30  # a rank that has left the group has exited within this


def _drop_gradient():
    """This rank's gradient and loss terms left out of every sum over ranks
    of them: the trainer's flat ``all_reduce`` of the gradients gets zeros
    from this rank (the advantages' statistics, one element each, and the
    episode metrics, two, pass unchanged).  Returns the undo."""
    from pikazoo_tpu_torch.train import ppo

    real = ppo.all_reduce_sum
    ppo.all_reduce_sum = lambda flat, mesh: real(
        torch.zeros_like(flat) if flat.numel() > 2 else flat, mesh)
    return lambda: setattr(ppo, "all_reduce_sum", real)


def _flat_state(runner) -> torch.Tensor:
    """Parameters, Adam's moments and its step count as one float32 row."""
    opt = runner.opt_state
    leaves = [*runner.params.values(), *opt.mu.values(), *opt.nu.values()]
    return torch.cat([v.reshape(-1).float() for v in leaves]
                     + [opt.count.reshape(1).float()])


def _build_kernels() -> None:
    """The learner's kernels built, or found built, in rank 0 before the
    other ranks start, so that they load them and do not race to build the
    same libraries."""
    from pikazoo_tpu_torch.core import learner_step
    from pikazoo_tpu_torch.train import fused_update

    learner_step._library()
    fused_update._library_bf16()


def _differing(parts: List[torch.Tensor]) -> int:
    """Elements in which any rank's float32 row differs from rank 0's, bit
    for bit."""
    bits = torch.stack(parts).view(torch.int32)
    return int((bits != bits[0]).any(0).sum())


class Session(single.Session):
    """One rank of the cell: rank 0 in the harness's process, the others in
    processes of this file (:func:`worker`)."""

    def __init__(self, run, rank: int = 0, port: int = 0):
        super().__init__(run)
        mesh = run.cell.config["mesh"]
        self.world = int(mesh["world_size"])
        self.rank, self.port = rank, port
        on_card = run.device.type == "cuda"
        self.backend = mesh["backend"] if on_card else "gloo"
        self.device = torch.device("cuda", rank) if on_card else run.device
        self.workers: List[subprocess.Popen] = []
        self.finishing = False
        self.last_losses: List[float] = []

    # ----------------------------------------------------------- set-up --
    def setup(self) -> None:
        import pikazoo_tpu_torch as program
        from pikazoo_tpu_torch.parallel import init_distributed, make_env_mesh
        from pikazoo_tpu_torch.train.ppo import PPOConfig, make_ppo_trainer

        wait = datetime.timedelta(seconds=RENDEZVOUS_S)
        if self.rank == 0:
            store = dist.TCPStore("127.0.0.1", 0, self.world, is_master=True, timeout=wait,
                                  wait_for_workers=False)
            self.port = store.port
            if self.device.type == "cuda":
                _build_kernels()
            self._spawn()
        else:
            store = dist.TCPStore("127.0.0.1", self.port, self.world, is_master=False,
                                  timeout=wait)
        init_distributed(backend=self.backend, device=self.device, store=store,
                         rank=self.rank, world_size=self.world,
                         timeout=datetime.timedelta(seconds=COLLECTIVE_S))
        mesh = make_env_mesh(self.device)
        if (mesh.rank, mesh.world_size) != (self.rank, self.world):
            raise RuntimeError(f"joined as rank {mesh.rank} of {mesh.world_size}, not "
                               f"{self.rank} of {self.world}")
        self.undo_fault = (_drop_gradient() if self.run.params.get("drop_gradient_rank")
                           == self.rank else None)
        fields = PPOConfig.__dataclass_fields__
        cfg = PPOConfig(**{k: (tuple(v) if k == "hidden" else v)
                           for k, v in self.learner.items() if k in fields})
        dev = self.device
        self.env = single.RecordingEnv(program.PikaZoo(program.EnvConfig(**self.env_settings)))
        init_fn, self.train_step, _ = make_ppo_trainer(self.env, cfg, device=dev, mesh=mesh)
        runner = init_fn(self.env_seed)
        params = single.make_weights(self.weight_seed, cfg.hidden, cfg.num_actions, dev)
        self.params0 = {k: v.clone() for k, v in params.items()}
        runner = runner._replace(
            params=params, opt_state=self.train_step.tx[0](params),
            key=torch.Generator(device=dev).manual_seed(self.uniform_seed))
        self.start = packed_state(runner.env_state)
        self.first_inputs = (single._clone(runner.env_state), runner.last_obs.clone(),
                             runner.key.get_state())
        self.losses, self.actions = [], []
        self.runner = runner
        for _ in range(self.checked_updates):  # every rank runs these on its own
            self.env.actions = []
            out = single.Session.unit(self)
            self.losses.append(out["losses"])
            self.actions.append(torch.stack(self.env.actions))
        self.env.actions = None
        self.params_checked = {n: v.clone() for n, v in self.runner.params.items()}
        self.env_checked = packed_state(self.runner.env_state)
        self.units = 0

    def _spawn(self) -> None:
        """Ranks 1 to n-1, each a process of this file, its output on this
        process's stderr; a watch on them, and their end at this process's
        exit."""
        spec = {"parent": os.getpid(), "port": self.port, "cell": self.run.cell.name,
                "config": self.run.cell.config, "params": self.run.params,
                "seed": self.run.seed, "device": self.run.device.type}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        for rank in range(1, self.world):
            self.workers.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.traffic.ppo_mesh_updates",
                 json.dumps(dict(spec, rank=rank))],
                cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=2, text=True))
        threading.Thread(target=self._watch, daemon=True).start()
        atexit.register(self._close)

    def _watch(self) -> None:
        """Exit this process, with an error, as soon as a rank ends before it
        was told to finish (it failed, or was killed): the others wait for it
        in a collective that would not return."""
        while not self.finishing:
            for rank, p in enumerate(self.workers, 1):
                code = p.poll()
                if code is not None and not self.finishing:
                    print(f"benchmark: rank {rank} of {self.world} ended (exit code {code}) "
                          "before it was told to finish; nothing measured", file=sys.stderr,
                          flush=True)
                    self._kill()
                    os._exit(1)
            time.sleep(0.2)

    def _kill(self) -> None:
        for p in self.workers:
            if p.poll() is None:
                p.kill()
                p.wait()

    def _tell(self, command: str) -> None:
        for p in self.workers:
            p.stdin.write(command + "\n")
            p.stdin.flush()

    def _close(self) -> None:
        """At exit without a finish (the host pass, a failed run): the other
        ranks killed, the group left to its destructor, which aborts it
        (leaving it in order waits for every rank, and a failed run's may be
        inside a collective)."""
        self.finishing = True
        self._kill()

    # ------------------------------------------------------------ units --
    def unit(self, spans: bool = False) -> dict:
        t0 = time.perf_counter()
        self._tell("unit")
        out = single.Session.unit(self, spans)
        self.units += 1
        self.last_losses = out["losses"]
        out["ms"] = (out["end"] - t0) * 1e3
        return out

    # ------------------------------------------------------------ check --
    def finish(self) -> None:
        """After the window, on every rank: the first optimizer step once
        more (its gradient sums over ranks), the gathers, then every rank
        leaves the group together (nccl's teardown waits for every rank) and
        the other ranks exit; the program's state freed."""
        if self.rank == 0:
            self.finishing = True
            self._tell("finish")
        self.first_step()
        self._gather()
        dist.destroy_process_group()
        if self.rank == 0:
            for p in self.workers:
                p.stdin.close()
            self._join()
        if self.undo_fault is not None:
            self.undo_fault()
        self.runner = self.train_step = self.first_inputs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _join(self) -> None:
        """The other ranks' exits: one that failed fails the run; one still
        there after ``STOP_S`` has delivered all it had to and is killed."""
        deadline = time.monotonic() + STOP_S
        codes = []
        for p in self.workers:
            try:
                codes.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._kill()
        if any(c not in (0, None) for c in codes):
            raise RuntimeError(f"ranks 1-{self.world - 1} exited with codes {codes}")
        if None in codes:
            print(f"benchmark: ranks 1-{self.world - 1} exit codes {codes}: the ranks still "
                  f"there {STOP_S} s after leaving the group were killed", file=sys.stderr)

    def _gather(self) -> None:
        """Each rank's shard of the start, of the env state after the checked
        updates and of their actions, its replayed actions that differ, its
        parameters and Adam state, its last losses and its count of loaded
        JAX modules, gathered to every rank; rank 0 joins the shards in the
        global batch's order."""
        def gather(t: torch.Tensor) -> List[torch.Tensor]:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t)
            return parts

        dev = self.device
        starts = gather(self.start)
        envs = gather(self.env_checked)
        actions = gather(torch.stack(self.actions))
        states = gather(_flat_state(self.runner))
        losses = gather(torch.tensor(self.last_losses, device=dev))
        counts = gather(torch.tensor([self.first_replay_off, self.units,
                                      len(harness.forbidden_modules())], device=dev))
        if self.rank != 0:
            return
        counts = torch.stack(counts).cpu()
        loaded = [r for r in range(self.world) if counts[r, 2]]
        if loaded:
            raise RuntimeError(f"ranks {loaded} loaded the JAX stack or the JAX package")
        self.rank_units = counts[:, 1].tolist()
        self.first_replay_off = int(counts[:, 0].sum())
        self.start = torch.cat(starts, dim=1)
        self.env_checked = torch.cat(envs, dim=1)
        b = actions[0].shape[-1] // 2
        self.actions = [torch.cat([a[k, :, :b] for a in actions]
                                  + [a[k, :, b:] for a in actions], dim=-1)
                        for k in range(self.checked_updates)]
        self.ranks_params_off = _differing(states)
        self.ranks_losses_off = _differing(losses)

    def compared(self, start, want) -> dict:
        """Every compared number: the one-card cell's, on the global batch,
        and the two checks of the mesh."""
        values = single.compare(self.side(), self.params0, start, want, self.recipe)
        values.update(ranks_params_off=self.ranks_params_off,
                      ranks_losses_off=self.ranks_losses_off)
        return values

    def check(self) -> dict:
        self.finish()
        start, want = self.follow()
        values = self.compared(start, want)
        return {name: {"value": values[name], "limit": LIMITS[name]} for name in LIMITS}


# Each compared number's limit, set from this cell's readings on four H100s
# (PERF.md gives them and their seeds): the program's largest over 16 seeds
# (the lower) and the smallest reading of the control (K1's int8fwd on every
# rank) or of a fault (one rank's gradient left out of the sum; a step
# returning its state) that reads at least 3x the lower on every seed read
# (3 seeds; 1 for the step returning its state, which always reads the same)
# (the upper), each limit between them with room on both sides.  The upper
# readings: action_gap's is the one-card cell's (the reference in fp8,
# PERF.md), since neither the control nor the fault moves update 1's draws;
# action_gap_later's, first_loss_gap's, first_grad_gap's and first_kl_gap's
# the control's; loss_gap's the dropped gradient's; change_gap's the step
# returning its state (the control reads 0.0086-0.0601 and the dropped
# gradient 0.0105-0.0336, within reach of the program's 0.0133).
LIMITS = {
    "start_envs_off": 0,
    "env_envs_off": 0,
    "action_gap": 1e-4,
    "action_gap_later": 3e-3,
    "loss_gap": 0.015,
    "change_gap": 0.03,
    "first_grad_gap": 0.05,
    "first_loss_gap": 4e-4,
    "first_kl_gap": 1e-7,
    "ranks_params_off": 0,
    "ranks_losses_off": 0,
}


# ------------------------------------------------------------ other ranks --

def _die_with(parent: int) -> None:
    """End this process when ``parent`` ends: the kernel's parent-death
    signal, set before the parent is looked at, so that no end is missed."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def worker(spec: dict) -> int:
    """Rank ``spec["rank"]``: set up as rank 0 does, then a unit for each
    ``unit`` line on the standard input, until ``finish`` (the check's part;
    exit code 0) or the input's end (rank 0 has gone; 1)."""
    _die_with(spec["parent"])
    rank = spec["rank"]
    device = torch.device("cuda", rank) if spec["device"] == "cuda" else torch.device("cpu")
    cell = SimpleNamespace(name=spec["cell"], config=spec["config"],
                           spec={"params": spec["params"]})
    session = Session(harness.Run(cell, spec["seed"], 0.0, False, device), rank, spec["port"])
    session.setup()
    for line in sys.stdin:
        command = line.strip()
        if command == "unit":
            session.unit()
        elif command == "finish":
            session.finish()
            return 0
        else:
            raise ValueError(f"rank {rank}: unknown command {command!r}")
    return 1


if __name__ == "__main__":
    sys.exit(worker(json.loads(sys.argv[1])))
