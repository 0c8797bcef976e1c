"""Traffic: self-play PPO updates back to back through ``make_ppo_trainer``'s
``train_step``, as the trainer's CLI runs them.

Parameters (``benchmark/workloads/<cell>.json``): ``checked_updates`` (the
first updates, run in set-up, that the reference follows), ``trace_updates``
(updates profiled in a traced run).  The configuration's ``env`` and
``learner`` blocks give the environment and the PPO recipe.

Set-up builds the trainer, makes the weights on the card from the seed,
hands it the benchmark's generator of the rollout's uniforms, and runs the
checked updates through ``train_step`` itself; the window continues the same
runner.  A unit is one update: from its call until its losses are on the
host.  The env the trainer steps is the program's ``PikaZoo`` seen through
:class:`RecordingEnv`, which passes every call on and, in set-up only,
keeps each frame's actions, so that the reference can follow the updates
with the program's actions and judge each action by its own policy.  After
the window the program takes its first optimizer step once more, from the
same start: update 1's rollout through ``rollout_fn`` with the same
uniforms, then ``minibatch_grads_fn`` (K1) on the first minibatch at the
seed's weights and the trainer's optimizer from its initial state, so that
the update's own precision is held before 16 steps of Adam blur it.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, NamedTuple

import torch

from benchmark import harness, trace
from benchmark.reference import learner as ref_learner
from benchmark.reference.pika import env as ref_env
from benchmark.traffic_common import envs_off, packed_state

GAINS = (math.sqrt(2), 0.01, 1.0)  # hidden layers, policy head, value head


class RecordingEnv:
    """The program's env, every call passed on.  While ``actions`` is a
    list, each learner step appends its (2B,) actions (int8); with ``spans``
    on, each step runs inside a ``bench.env_step`` span."""

    def __init__(self, env):
        self.env = env
        self.num_actions = env.num_actions
        self.config = env.config
        self.actions = None
        self.spans = False

    def reset_batch(self, *args, **kwargs):
        return self.env.reset_batch(*args, **kwargs)

    def step_batch_learner_fm(self, state, a1, a2):
        if self.actions is not None:
            self.actions.append(torch.cat([a1, a2]).to(torch.int8))
        with trace.span("env_step", self.spans):
            return self.env.step_batch_learner_fm(state, a1, a2)


def make_weights(seed: int, hidden, num_actions: int, device, obs_dim: int = 35
                 ) -> Dict[str, torch.Tensor]:
    """The network's parameters, drawn on ``device`` from ``seed`` in one
    call: each kernel normal with std gain / sqrt(fan_in), biases zero,
    float32, named as the trainer's (``layers.{i}.kernel`` / ``.bias``)."""
    widths = [obs_dim, *hidden]
    shapes = [(i, o) for i, o in zip(widths[:-1], widths[1:])]
    shapes += [(widths[-1], num_actions), (widths[-1], 1)]
    gains = [GAINS[0]] * len(hidden) + list(GAINS[1:])
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(i * o for i, o in shapes), generator=gen, device=device)
    params, start = {}, 0
    for n, ((i, o), g) in enumerate(zip(shapes, gains)):
        params[f"layers.{n}.kernel"] = flat[start:start + i * o].reshape(i, o) * (g / math.sqrt(i))
        params[f"layers.{n}.bias"] = torch.zeros(o, device=device)
        start += i * o
    return params


def recipe(learner: dict) -> ref_learner.Recipe:
    keys = ref_learner.Recipe._fields
    return ref_learner.Recipe(**{k: (tuple(v) if k == "hidden" else v)
                                 for k, v in learner.items() if k in keys})


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep: List[str]) -> float:
    """The worst leaf's gap of norms: ``| |got| - |want| |`` over the larger
    of ``|want|`` and the median leaf's ``|want|``, over the leaves ``keep``."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    median = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in keep:
        g = float(torch.linalg.vector_norm(got[k].double()))
        worst = max(worst, abs(g - norms[k]) / max(norms[k], median, 1e-30))
    return worst


def moved_leaves(mu: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient (Adam's first moment after its
    first step) is at least a thousandth of the median leaf's: the others
    move by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in mu.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= 1e-3 * median]


def loss_gap(got: List[List[float]], want: List[torch.Tensor], value_coef: float,
             entropy_coef: float) -> float:
    """The worst update's gap of the total loss (the mean over its
    minibatches), over the size of its terms in the reference."""
    worst = 0.0
    for g, w in zip(got, want):
        w = [float(x) for x in w]
        scale = abs(w[1]) + value_coef * abs(w[2]) + entropy_coef * abs(w[3])
        worst = max(worst, abs(g[0] - w[0]) / max(scale, 1e-30))
    return worst


class Side(NamedTuple):
    """What one side produced over the checked updates: the start and the
    env state after them (packed rows), each update's mean loss terms, the
    params after them, and its first step: the first minibatch's loss terms
    and Adam's first moment after that step."""

    start: torch.Tensor
    env_checked: torch.Tensor
    losses: List[List[float]]
    params_checked: Dict[str, torch.Tensor]
    first_terms: List[float]
    first_mu: Dict[str, torch.Tensor]


def followed_side(start: torch.Tensor, f: ref_learner.Followed) -> Side:
    """A followed reference as a side, to be compared in the program's place."""
    rows = start.shape[0]
    return Side(start[:rows], f.packed[:rows], [x.tolist() for x in f.losses],
                f.params, f.first_terms.tolist(), f.first_mu)


def compare(side: Side, params0, start: torch.Tensor, want: ref_learner.Followed,
            r: ref_learner.Recipe) -> dict:
    """The compared numbers of ``side`` against the followed reference
    ``want`` (from the reference's own reset ``start``)."""
    keep = moved_leaves(want.first_mu)
    delta = lambda p: {k: p[k] - params0[k] for k in p}
    rows = side.start.shape[0]
    return {
        "start_envs_off": envs_off(side.start, start[:rows]),
        "env_envs_off": envs_off(side.env_checked, want.packed[:rows]),
        "action_gap": want.sample_gaps[0],
        "action_gap_later": max(want.sample_gaps[1:], default=0.0),
        "loss_gap": loss_gap(side.losses, want.losses, r.value_coef, r.entropy_coef),
        "change_gap": leaf_gap(delta(side.params_checked), delta(want.params), keep),
        "first_grad_gap": leaf_gap(side.first_mu, want.first_mu, keep),
        "first_loss_gap": loss_gap([side.first_terms], [want.first_terms], r.value_coef,
                                   r.entropy_coef),
        "first_kl_gap": abs(side.first_terms[4] - float(want.first_terms[4])),
    }


def _clone(x):
    """A copy of a tensor or of a (named) tuple of them."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        items = [_clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class Session:
    def __init__(self, run):
        self.run = run
        self.checked_updates = int(run.params["checked_updates"])
        env_seed, weight_seed, uniform_seed = harness.derive(run.seed, 3)
        self.env_seed, self.weight_seed, self.uniform_seed = env_seed, weight_seed, uniform_seed
        self.env_settings = run.cell.config["env"]
        self.learner = dict(run.cell.config["learner"], **run.params.get("learner", {}))
        self.recipe = recipe(self.learner)

    # ----------------------------------------------------------- set-up --
    def setup(self) -> None:
        import pikazoo_tpu_torch as program
        from pikazoo_tpu_torch.train.ppo import PPOConfig, make_ppo_trainer

        fields = PPOConfig.__dataclass_fields__
        cfg = PPOConfig(**{k: (tuple(v) if k == "hidden" else v)
                           for k, v in self.learner.items() if k in fields})
        dev = self.run.device
        self.env = RecordingEnv(program.PikaZoo(program.EnvConfig(**self.env_settings)))
        init_fn, self.train_step, _ = make_ppo_trainer(self.env, cfg, device=dev)
        runner = init_fn(self.env_seed)
        params = make_weights(self.weight_seed, cfg.hidden, cfg.num_actions, dev)
        self.params0 = {k: v.clone() for k, v in params.items()}
        runner = runner._replace(
            params=params, opt_state=self.train_step.tx[0](params),
            key=torch.Generator(device=dev).manual_seed(self.uniform_seed))
        self.start = packed_state(runner.env_state)
        self.first_inputs = (_clone(runner.env_state), runner.last_obs.clone(),
                             runner.key.get_state())
        self.losses, self.actions = [], []
        self.runner = runner
        for _ in range(self.checked_updates):
            self.env.actions = []
            out = self.unit()
            self.losses.append(out["losses"])
            self.actions.append(torch.stack(self.env.actions))
        self.env.actions = None
        self.params_checked = {n: v.clone() for n, v in self.runner.params.items()}
        self.env_checked = packed_state(self.runner.env_state)

    # ------------------------------------------------------------ units --
    def unit(self, spans: bool = False) -> dict:
        t0 = time.perf_counter()
        with trace.span("train_step", spans):
            self.runner, m = self.train_step(self.runner)
        with trace.span("readback", spans):
            losses = torch.stack([m.total_loss, m.policy_loss, m.value_loss, m.entropy,
                                  m.approx_kl]).tolist()
        t1 = time.perf_counter()
        return {"ms": (t1 - t0) * 1e3, "env_steps": m.env_steps, "losses": losses,
                "start": t0, "end": t1}

    def sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    # ----------------------------------------------------------- traced --
    def profile(self) -> trace.Profile:
        """``trace_updates`` more updates under the profiler, spans on."""
        def updates():
            self.env.spans = True
            for _ in range(int(self.run.params["trace_updates"])):
                self.unit(spans=True)
            self.sync()
            self.env.spans = False

        return trace.profile(updates)

    def time_phases(self) -> Dict[str, float]:
        """CUDA-event ms of one more update driven through the trainer's
        phase attributes: the rollout, then GAE, then the update."""
        from pikazoo_tpu_torch.train.networks import apply_fm
        from pikazoo_tpu_torch.train.ppo import gae_associative

        if self.run.device.type != "cuda":
            return {}
        r, ts = self.runner, self.train_step
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        uniforms = ts.uniforms_fn(r.key)
        ev[0].record()
        (_, last_norm), traj = ts.rollout_fn(r.params, r.env_state, r.last_obs, uniforms)
        ev[1].record()
        _, last_value = apply_fm(r.params, last_norm, self.learner["activation"])
        adv, targets = gae_associative(traj.value, traj.reward, traj.done, last_value,
                                       self.recipe.gamma, self.recipe.gae_lambda)
        ev[2].record()
        ts.update_fn(r.params, r.opt_state, traj, adv, targets)
        ev[3].record()
        ev[3].synchronize()
        return {name: ev[i].elapsed_time(ev[i + 1])
                for i, name in enumerate(("rollout", "gae", "update"))}

    # ------------------------------------------------------------ check --
    def follow(self, matmul_dtype=torch.bfloat16, half_batch: bool = False,
               own_actions: bool = False):
        """The reference over the checked updates, from its own reset, with
        the program's actions (or, with ``own_actions``, its own draws)."""
        dev, r = self.run.device, self.recipe
        cfg = ref_env.EnvConfig(**self.env_settings)
        start = ref_env.reset_packed(cfg, self.env_seed, 0, r.num_envs, dev)
        gen = torch.Generator(device=dev).manual_seed(self.uniform_seed)
        uniforms = [torch.rand((r.rollout_length, 1, 2 * r.num_envs), generator=gen, device=dev)
                    for _ in range(self.checked_updates)]
        step = lambda packed, a1, a2: ref_env.learner_step(cfg, packed, a1, a2)
        with torch.no_grad():
            return start, ref_learner.follow(step, start, dict(self.params0), r, uniforms,
                                             None if own_actions else self.actions,
                                             matmul_dtype, half_batch)

    def first_step(self) -> None:
        """The program's first optimizer step once more, as ``train_step``
        took it: update 1's rollout from the same start with the same
        uniforms, GAE, ``minibatch_grads_fn`` on the first minibatch at the
        seed's weights, and the trainer's optimizer from its initial state.
        Keeps the minibatch's five loss terms, Adam's first moment after the
        step, and how many of the rollout's actions differ from update 1's."""
        from pikazoo_tpu_torch.train.networks import apply_fm
        from pikazoo_tpu_torch.train.ppo import Transition, gae_associative

        ts, params = self.train_step, self.params0
        env_state, last_obs, key_state = self.first_inputs
        gen = torch.Generator(device=self.run.device)
        gen.set_state(key_state)
        (_, last_norm), traj = ts.rollout_fn(params, env_state, last_obs, ts.uniforms_fn(gen))
        _, last_value = apply_fm(params, last_norm, self.learner["activation"])
        adv, targets = gae_associative(traj.value, traj.reward, traj.done, last_value,
                                       self.recipe.gamma, self.recipe.gae_lambda)
        self.first_replay_off = int((traj.action.to(torch.int8) != self.actions[0]).sum())
        sl = slice(0, self.recipe.rollout_length // self.recipe.num_minibatches)
        grads, terms = ts.minibatch_grads_fn(params, Transition(*[leaf[sl] for leaf in traj]),
                                             adv[sl], targets[sl])
        _, opt = ts.tx[1](grads, ts.tx[0](params))
        self.first_terms = terms.tolist()
        self.first_mu = {k: v.clone() for k, v in opt.mu.items()}

    def finish(self) -> None:
        """After the window: the program's first step once more, then its
        state freed."""
        self.first_step()
        self.runner = self.train_step = self.first_inputs = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def side(self) -> "Side":
        return Side(self.start, self.env_checked, self.losses, self.params_checked,
                    self.first_terms, self.first_mu)

    def check(self) -> dict:
        self.finish()
        start, want = self.follow()
        values = compare(self.side(), self.params0, start, want, self.recipe)
        return {name: {"value": values[name], "limit": LIMITS[name]} for name in LIMITS}


# Each compared number's limit, set between the program's readings over a
# dozen seeds and more (the lower) and the control's or a fault's (the upper);
# PERF.md gives both.  The control is the program's own int8 path of K1
# (``update_quant`` ``int8fwd`` or ``int8``), which ``first_kl_gap`` catches.
LIMITS = {
    "start_envs_off": 0,
    "env_envs_off": 0,
    "action_gap": 1e-4,
    "action_gap_later": 0.03,
    "loss_gap": 0.007,
    "change_gap": 0.15,
    "first_grad_gap": 0.05,
    "first_loss_gap": 0.005,
    "first_kl_gap": 1e-7,
}
