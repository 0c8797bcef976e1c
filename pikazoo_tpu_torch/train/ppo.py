"""Self-play PPO actor-learner on the batched env.

Counterpart of ``pikazoo_tpu.train.ppo``.  One ``train_step`` rolls out ``T``
frames on ``B`` envs (both seats share the policy; each seat contributes a
trajectory, so the learner batch is ``T x 2B``), computes GAE, and runs
several clipped-PPO epochs of minibatches over the time axis.

Learner tensors keep the JAX package's layouts: the seat dimension folded
into the batch, seat-blocked (columns [0, B) are seat 1, [B, 2B) seat 2), and
the observations feature-major ``(T, 35, 2B)`` bf16, the layout the fused
gradient kernel K1 (``train.fused_update``) consumes as it is.

PyTorch runs eagerly, so the JAX ``scan``s become Python loops: the rollout
over frames, GAE over time, the update over epochs and minibatches.  The
optimizer is ``optax.chain(clip_by_global_norm, adam)`` written out as optax
computes it.  On a CUDA device float32 products run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` stays False), which the inverse-CDF
sampling relies on; bf16 products are the network's own.

Entry points run on the card unless the caller asks for the CPU
(``make_ppo_trainer(..., device="cpu")``).

On a mesh (``parallel.make_env_mesh`` over a process group of n ranks) the
step follows the JAX trainer under ``shard_map``: each rank steps its
``b = num_envs / n`` envs, draws the global uniforms from the replicated
generator and samples with its own columns of them (bit-identical to one
rank), and rolls out with no collective; every minibatch takes its
advantage statistics from two sums over ranks and its gradient from K1 (or
K4, or autograd) over the local columns with the global row count, the
grads and the five loss terms summed over ranks in one ``all_reduce``; Adam
then runs alike on every rank.  The one-rank mesh is ``mesh=None``, bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pikazoo_tpu_torch.envs.observations import assemble_obs
from pikazoo_tpu_torch.envs.pika_volley import EnvState, PikaZoo
from pikazoo_tpu_torch.parallel.mesh import EnvMesh, all_reduce_sum, local_rows, shard_batch
from pikazoo_tpu_torch.train.fused_update import (check_int8_cells, check_mode,
                                                  fused_ppo_grads, fused_ppo_grads_fm)
from pikazoo_tpu_torch.train.networks import (BF16, ActorCritic, Params, apply,
                                              apply_fm, normalize_obs)
from pikazoo_tpu_torch.utils.profiling import trace_annotation


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX ``PPOConfig``: same fields, same defaults."""

    num_envs: int = 4096
    rollout_length: int = 128
    num_actions: int = 18
    learning_rate: float = 3e-4
    anneal_updates: Optional[int] = None  # linear LR anneal to 0 over this many updates
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    update_epochs: int = 4
    num_minibatches: int = 4  # splits the time axis
    hidden: Tuple[int, ...] = (256, 256)
    activation: str = "tanh"
    # "both": symmetric self-play; "p1": only seat 1's trajectory trains
    # (against the rule AI on seat 2: pass is_player2_computer=True).
    learner_seats: str = "both"
    # Minibatch gradients: "auto" = K1 on a CUDA device, autograd on the CPU;
    # "fm" = K1 (its plain version on the CPU); "on" = the row-major kernel
    # K4 (likewise); "off" = autograd of loss_fn.
    fused_update: str = "auto"
    # K1's precision: "none" (bf16), "int8fwd" (int8 forward products, bf16
    # backward) or "int8" (the heavy backward products int8 too, dynamic
    # scales); the int8 modes need K1 and activation="tanh".
    update_quant: str = "none"
    # K1's hidden gradient chain in bf16 arithmetic: the trainer's one route
    # to fused_ppo_grads_fm(bwd_bf16=True).  It is the counterpart of the JAX
    # kernel's PIKAZOO_FM_BWD_BF16 environment knob, which the port does not
    # read.
    update_bwd_bf16: bool = False
    # Permute the trajectory's time axis (one permutation an update) before
    # the minibatch split: textbook-PPO epochs.
    shuffle_minibatches: bool = False


class Transition(NamedTuple):
    """The trajectory, leaves stacked over the T frames, seat-blocked."""

    obs: torch.Tensor       # (T, 35, 2B) normalised bf16, feature-major
    action: torch.Tensor    # (T, 2B) int32
    log_prob: torch.Tensor  # (T, 2B) float32
    value: torch.Tensor     # (T, 2B) float32
    reward: torch.Tensor    # (T, 2B) float32
    done: torch.Tensor      # (T, 2B) float32, the episode end repeated per seat


class AdamState(NamedTuple):
    """optax's chain state, flattened: ``count`` is both adam's step count
    and the LR schedule's (they advance together), ``mu`` and ``nu`` are
    keyed like the params."""

    count: torch.Tensor  # () int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class PPORunnerState(NamedTuple):
    params: Params
    opt_state: AdamState
    env_state: EnvState     # on a mesh, this rank's b envs
    last_obs: torch.Tensor  # (B, 2, 35) int32; on a mesh (b, 2, 35)
    key: torch.Generator    # draws the rollout's uniforms, on the device
    update_index: int


class TrainMetrics(NamedTuple):
    total_loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    mean_reward: torch.Tensor
    episodes_finished: torch.Tensor
    env_steps: int


def gae_associative(value: torch.Tensor, reward: torch.Tensor,
                    done: torch.Tensor, last_value: torch.Tensor,
                    gamma: float, lam: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE advantages and targets over the leading time axis T.

    The recurrence ``gae_t = delta_t + (gamma * lam * not_done_t) *
    gae_{t+1}``, written here as the sequential suffix scan (T steps over
    the (2B,) batch) where the JAX package uses an associative scan; the two
    differ at rounding level only."""
    not_done = 1.0 - done
    next_value = torch.cat([value[1:], last_value[None]], dim=0)
    delta = reward + gamma * next_value * not_done - value
    coef = gamma * lam * not_done
    advantages = torch.empty_like(delta)
    gae = torch.zeros_like(last_value)
    for t in range(value.shape[0] - 1, -1, -1):
        gae = delta[t] + coef[t] * gae
        advantages[t] = gae
    return advantages, advantages + value


def make_optimizer(cfg: PPOConfig):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` with
    ``optax.linear_schedule(lr, 0, anneal_updates * epochs * minibatches)``
    as the LR when ``anneal_updates`` is set: ``(init, update)``, where
    ``update(grads, state) -> (updates, state)`` and the caller adds the
    updates to the params.  The clip divides by the global norm itself (no
    epsilon, unlike ``torch.nn.utils.clip_grad_norm_``); Adam has bias
    correction and its epsilon outside the square root."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    max_norm = cfg.max_grad_norm
    steps = (cfg.anneal_updates * cfg.update_epochs * cfg.num_minibatches
             if cfg.anneal_updates else None)

    def init(params: Params) -> AdamState:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        count = torch.zeros((), dtype=torch.int32,
                            device=next(iter(params.values())).device)
        return AdamState(count, zeros, {k: v.clone() for k, v in zeros.items()})

    def update(grads: Dict[str, torch.Tensor], state: AdamState):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < max_norm
        grads = {k: torch.where(keep, g, (g / g_norm) * max_norm)
                 for k, g in grads.items()}
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        c = count.float()
        bc1 = 1 - torch.tensor(b1, device=c.device) ** c
        bc2 = 1 - torch.tensor(b2, device=c.device) ** c
        if steps:
            done = torch.clamp(state.count, 0, steps).float()
            lr = cfg.learning_rate * (1 - done / steps)  # linear_schedule(lr, 0, steps)
            step = -lr
        else:
            step = -cfg.learning_rate
        updates = {k: step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
                   for k in grads}
        return updates, AdamState(count, mu, nu)

    return init, update


def make_ppo_trainer(env: PikaZoo, cfg: PPOConfig = PPOConfig(), device="cuda",
                     mesh: Optional[EnvMesh] = None):
    """Build ``(init_fn, train_step, network)``.

    ``env`` is a :class:`PikaZoo` or a stack of the wrappers that transform
    the learner step (``wrappers.SimplifyAction``,
    ``wrappers.RewardByBallPosition``); ``cfg.num_actions`` must be the
    env's.  ``init_fn(seed) -> PPORunnerState`` and ``train_step(runner) ->
    (runner, TrainMetrics)``, everything on ``device`` (the card unless the
    caller asks for the CPU).  ``train_step``
    carries the phases as attributes, as the JAX trainer does:
    ``rollout_fn(params, env_state, last_obs, uniforms)``,
    ``policy_sample_fn(params, norm_obs_fm, u)``,
    ``minibatch_grads_fn(params, mtraj, madv, mtarget)``,
    ``update_fn(params, opt_state, traj, advantages, targets)``, ``tx``
    (the optimizer's ``(init, update)``), ``shuffle_fn(batch, generator)``,
    ``uniforms_fn(generator)`` (this rank's (T, 1, 2b) columns of the
    update's uniforms), ``local_columns_fn(rows)`` (this rank's columns of
    global (T, 1, 2B) rows) and ``provenance``.

    ``mesh`` (an :class:`EnvMesh`) runs the step data-parallel (module
    docstring): ``cfg.num_envs`` is global, each rank holds ``num_envs /
    world_size`` envs on the mesh's device, and a ``device`` of another type
    raises."""
    device = torch.device(device)
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh's tensors lie on {mesh.device}, not {device}")
        device = mesh.device
        if cfg.num_envs % mesh.world_size:
            raise ValueError(f"num_envs={cfg.num_envs} does not split over the mesh's "
                             f"{mesh.world_size} ranks")
    meshed = mesh is not None and mesh.distributed
    world = mesh.world_size if mesh is not None else 1
    if cfg.fused_update not in ("auto", "fm", "on", "off"):
        raise ValueError(f"unknown fused_update {cfg.fused_update!r}")
    if cfg.learner_seats not in ("both", "p1"):
        raise ValueError(f"unknown learner_seats {cfg.learner_seats!r}")
    if cfg.rollout_length % cfg.num_minibatches:
        raise ValueError("num_minibatches must divide rollout_length")
    # The rollout steps the env through step_batch_learner_fm: every layer of
    # a wrapper stack must apply its transform there, or it would be skipped.
    layer = env
    while layer is not None:
        if not hasattr(layer, "step_batch_learner_fm"):
            raise ValueError(f"{type(layer).__name__} has no learner step "
                             "(step_batch_learner_fm): the rollout would bypass it")
        layer = getattr(layer, "env", None)
    if cfg.num_actions != env.num_actions:
        raise ValueError(f"num_actions={cfg.num_actions}, but the env takes "
                         f"{env.num_actions} actions")
    if cfg.fused_update == "on":
        resolved = "row"
    elif cfg.fused_update == "fm" or (cfg.fused_update == "auto" and device.type == "cuda"):
        resolved = "fm"
    else:
        resolved = "autograd"
    if (cfg.update_quant != "none" or cfg.update_bwd_bf16) and resolved != "fm":
        # The precision modes exist only in K1; running bf16 instead would
        # corrupt any A/B the user believes they are running.
        raise ValueError(
            f"update_quant={cfg.update_quant!r} / update_bwd_bf16="
            f"{cfg.update_bwd_bf16} require the feature-major fused kernel, but "
            f"fused_update={cfg.fused_update!r} resolved to {resolved!r} on "
            f"{device.type}; set fused_update='fm'")
    B = cfg.num_envs
    b = B // world                  # this rank's envs
    if resolved == "fm":
        check_mode(cfg.update_quant, cfg.activation, len(cfg.hidden))
        if cfg.update_quant == "int8":
            # K1's columns on this rank: both seats, or seat 1's.
            check_int8_cells(2 * b if cfg.learner_seats == "both" else b)
    network = ActorCritic(cfg.num_actions, cfg.hidden, cfg.activation,
                          device=device)
    tx_init, tx_update = make_optimizer(cfg)

    # ---------------------------------------------------------------- init --
    def init_fn(seed: int) -> PPORunnerState:
        """Params from a CPU generator seeded with ``seed`` (the same on any
        device), envs from ``reset_batch(seed)``, and the rollout's generator
        on the device, seeded with ``seed``.  On a mesh every rank builds the
        global runner and keeps its rows, so any world starts alike."""
        init_gen = torch.Generator().manual_seed(seed)
        net = ActorCritic(cfg.num_actions, cfg.hidden, cfg.activation,
                          generator=init_gen)
        params = {k: v.detach().to(device) for k, v in net.params().items()}
        env_state, ts = env.reset_batch(seed, B, device=device)
        key = torch.Generator(device=device).manual_seed(seed)
        obs = ts.obs
        if meshed:
            env_state, obs = shard_batch((env_state, obs), mesh)
        return PPORunnerState(params, tx_init(params), env_state, obs, key, 0)

    # ------------------------------------------------------------- rollout --
    @torch.no_grad()
    def policy_sample(params: Params, norm_obs_fm: torch.Tensor, u: torch.Tensor):
        """Feature-major policy step: (35, 2B) bf16 obs and the (1, 2B)
        uniform row -> (action (2B,) int32, log_prob, value).  Inverse-CDF
        sampling with one uniform per column: the action is the number of
        CDF entries below ``u`` times the column total (~1, so bf16 rounding
        in the logits can never push ``u`` past the last bucket).  The CDF
        is an f32 ``cumsum`` where the JAX package multiplies by a
        triangular matrix."""
        logits, value = apply_fm(params, norm_obs_fm, cfg.activation)
        log_probs = torch.log_softmax(logits, dim=0)
        cdf = torch.cumsum(torch.exp(log_probs), dim=0)
        action = (cdf < u * cdf[-1:]).sum(dim=0)
        log_prob = torch.gather(log_probs, 0, action[None])[0]
        return action.to(torch.int32), log_prob, value

    @torch.no_grad()
    def rollout(params: Params, env_state: EnvState, obs: torch.Tensor,
                uniforms: torch.Tensor):
        """``T = uniforms.shape[0]`` frames of ``step_batch_learner_fm``
        from raw observations ``obs`` (B, 2, 35), one (1, 2B) uniform row a
        frame.  Returns ``((env_state, last_norm_obs), Transition)``."""
        n = obs.shape[0]
        norm = torch.cat([normalize_obs(obs[:, 0]).t(), normalize_obs(obs[:, 1]).t()],
                         dim=1).to(BF16)                           # (35, 2B)
        T = uniforms.shape[0]
        f32 = torch.float32
        traj = Transition(
            obs=torch.empty((T, *norm.shape), dtype=BF16, device=device),
            action=torch.empty((T, 2 * n), dtype=torch.int32, device=device),
            log_prob=torch.empty((T, 2 * n), dtype=f32, device=device),
            value=torch.empty((T, 2 * n), dtype=f32, device=device),
            reward=torch.empty((T, 2 * n), dtype=f32, device=device),
            done=torch.empty((T, 2 * n), dtype=f32, device=device))
        for t in range(T):
            with trace_annotation("ppo.frame"):
                with trace_annotation("ppo.policy"):
                    action, log_prob, value = policy_sample(params, norm, uniforms[t])
                env_state, next_norm, reward, terminated = env.step_batch_learner_fm(
                    env_state, action[:n], action[n:])
                done = (terminated == 1).to(f32)
                traj.obs[t] = norm
                traj.action[t] = action
                traj.log_prob[t] = log_prob
                traj.value[t] = value
                traj.reward[t] = reward
                traj.done[t] = torch.cat([done, done])
                norm = next_norm
        return (env_state, norm), traj

    def local_columns(u: torch.Tensor) -> torch.Tensor:
        """This rank's columns of global (T, 1, 2B) rows: ``[i*b, (i+1)*b)``
        of each seat block (all of them off a mesh)."""
        if not meshed:
            return u
        rows = local_rows(B, mesh)
        return torch.cat([u[..., rows], u[..., B + rows.start:B + rows.stop]], dim=-1)

    def draw_uniforms(generator: torch.Generator) -> torch.Tensor:
        """This rank's columns of the update's (T, 1, 2B) uniform rows, drawn
        whole from ``generator`` on every rank."""
        return local_columns(torch.rand((cfg.rollout_length, 1, 2 * B), generator=generator,
                                        device=device))

    # ----------------------------------------------------------- collectives --
    def adv_stats(madv: torch.Tensor):
        """The global mean and population std of the minibatch's advantages,
        from the sum and then the sum of squared deviations over ranks (two
        ``all_reduce`` in the span ``pikazoo.ppo.adv_stats``)."""
        count = madv.numel() * world
        with trace_annotation("ppo.adv_stats"):
            mean = all_reduce_sum(madv.sum().reshape(1), mesh)[0] / count
            var = all_reduce_sum(((madv - mean) ** 2).sum().reshape(1), mesh)[0] / count
        return mean, torch.sqrt(var)

    def sum_over_ranks(grads: Dict[str, torch.Tensor], losses: torch.Tensor):
        """Grads and the five loss terms summed over ranks in one flat
        ``all_reduce`` (in the span ``pikazoo.ppo.grad_sum``)."""
        with trace_annotation("ppo.grad_sum"):
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads.values()]
                                            + [losses]), mesh)
        out, start = {}, 0
        for k, g in grads.items():
            out[k] = flat[start:start + g.numel()].reshape(g.shape)
            start += g.numel()
        return out, flat[start:]

    # ---------------------------------------------------------------- loss --
    def loss_fn(params: Params, batch: Transition, advantages: torch.Tensor,
                targets: torch.Tensor, stats=None, total_rows: int = 0):
        """The clipped-PPO loss of the JAX ``loss_fn``, differentiable:
        ``(total, (policy, value, entropy, approx_kl))``.  On a mesh,
        ``stats`` are the global advantage mean and std and each mean is
        this rank's sum over ``total_rows``, the global count: the ranks'
        losses (and grads) then sum to the global ones."""
        logits, value = apply(params, batch.obs.transpose(-2, -1), cfg.activation,
                              pre_normalized=True)
        log_probs = torch.log_softmax(logits, dim=-1)
        one_hot = torch.nn.functional.one_hot(batch.action.long(), cfg.num_actions)
        log_prob = (log_probs * one_hot.to(log_probs.dtype)).sum(-1)
        ratio = torch.exp(log_prob - batch.log_prob)
        if stats is None:
            # Population std (ddof 0), as jnp.std.
            adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
            mean = torch.mean
        else:
            adv = (advantages - stats[0]) / (stats[1] + 1e-8)
            mean = lambda v: v.sum() / total_rows
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        policy_loss = -mean(torch.minimum(unclipped, clipped))
        value_clipped = batch.value + torch.clamp(value - batch.value,
                                                  -cfg.clip_eps, cfg.clip_eps)
        value_loss = 0.5 * mean(torch.maximum((value - targets) ** 2,
                                              (value_clipped - targets) ** 2))
        entropy = -mean((torch.exp(log_probs) * log_probs).sum(-1))
        total = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy
        approx_kl = mean((ratio - 1) - torch.log(ratio))
        return total, (policy_loss, value_loss, entropy, approx_kl)

    # ------------------------------------------------------ update dispatch --
    def minibatch_grads(params: Params, mtraj: Transition, madv: torch.Tensor,
                        mtarget: torch.Tensor):
        """The minibatch gradient train_step runs: K1 (its plain version on
        the CPU), K4 on the minibatch flattened to rows, or autograd of
        ``loss_fn``.  Returns ``(grads, losses[5])``; on a mesh, this rank's
        columns of the minibatch in, the global grads and losses out, alike
        on every rank."""
        stats = adv_stats(madv) if meshed else None
        total_rows = madv.numel() * world if meshed else 0
        if resolved != "autograd":
            if meshed:
                adv_n = (madv - stats[0]) / (stats[1] + 1e-8)
            else:
                adv_n = (madv - madv.mean()) / (madv.std(correction=0) + 1e-8)
            kw = dict(num_actions=cfg.num_actions, activation=cfg.activation,
                      clip_eps=cfg.clip_eps, value_coef=cfg.value_coef,
                      entropy_coef=cfg.entropy_coef, total_rows=total_rows)
            data = (mtraj.action, mtraj.log_prob, mtraj.value, adv_n, mtarget)
            if resolved == "fm":
                grads, losses = fused_ppo_grads_fm(params, mtraj.obs, *data,
                                                   quant=cfg.update_quant,
                                                   bwd_bf16=cfg.update_bwd_bf16, **kw)
            else:
                # (T_mb, F, 2B) -> (T_mb * 2B, F) rows and (T_mb, 2B) ->
                # (T_mb * 2B,), as the JAX trainer's rm_flat.
                obs = mtraj.obs.transpose(1, 2).reshape(-1, mtraj.obs.shape[1])
                grads, losses = fused_ppo_grads(params, obs, *[x.reshape(-1) for x in data],
                                                **kw)
        else:
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            with torch.enable_grad():
                total, aux = loss_fn(leaves, mtraj, madv, mtarget, stats, total_rows)
                grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
            losses = torch.stack([total, *aux]).detach()
        return sum_over_ranks(grads, losses) if meshed else (grads, losses)

    @torch.no_grad()
    def update(params: Params, opt_state: AdamState, traj: Transition,
               advantages: torch.Tensor, targets: torch.Tensor):
        """``update_epochs`` passes over ``num_minibatches`` consecutive
        slices of the time axis, an optimizer step each.  Returns
        ``(params, opt_state, losses (epochs, minibatches, 5))``."""
        t_mb = traj.action.shape[0] // cfg.num_minibatches
        losses = []
        for _ in range(cfg.update_epochs):
            for i in range(cfg.num_minibatches):
                sl = slice(i * t_mb, (i + 1) * t_mb)
                mtraj = Transition(*[leaf[sl] for leaf in traj])
                grads, mb_losses = minibatch_grads(params, mtraj, advantages[sl],
                                                   targets[sl])
                updates, opt_state = tx_update(grads, opt_state)
                params = {k: v + updates[k] for k, v in params.items()}
                losses.append(mb_losses)
        shape = (cfg.update_epochs, cfg.num_minibatches, 5)
        return params, opt_state, torch.stack(losses).reshape(shape)

    def shuffle(batch, generator: torch.Generator):
        """``batch`` (a tuple of time-major leaves and tuples of them)
        permuted along the time axis by one ``torch.randperm`` drawn from
        ``generator``."""
        perm = torch.randperm(cfg.rollout_length, generator=generator, device=device)
        return tuple(type(x)(*[leaf[perm] for leaf in x]) if isinstance(x, tuple)
                     else x[perm] for x in batch)

    # ---------------------------------------------------------- train step --
    @torch.no_grad()
    def train_step(runner: PPORunnerState, uniforms: Optional[torch.Tensor] = None
                   ) -> Tuple[PPORunnerState, TrainMetrics]:
        """One update.  ``uniforms``, if given, are the update's global
        (T, 1, 2B) rows to sample with in place of the generator's draws
        (another framework's, in a cross-check); the generator is then not
        advanced by them.  Its spans' unit is ``runner.update_index``."""
        with trace_annotation("ppo.train_step", unit=runner.update_index):
            uniforms = (draw_uniforms(runner.key) if uniforms is None
                        else local_columns(uniforms.to(device)))
            with trace_annotation("ppo.rollout"):
                (env_state, last_norm), traj = rollout(runner.params, runner.env_state,
                                                       runner.last_obs, uniforms)
            with trace_annotation("ppo.gae"):
                last_obs = assemble_obs(env_state.p1, env_state.p2, env_state.ball,
                                        env_state.power_hit_key_down_prev)
                _, last_value = apply_fm(runner.params, last_norm, cfg.activation)
                advantages, targets = gae_associative(traj.value, traj.reward, traj.done,
                                                      last_value, cfg.gamma, cfg.gae_lambda)
            if cfg.learner_seats == "p1":
                # Seat 1 is the first half of the (last) env axis of every leaf
                # (of this rank's columns, on a mesh).
                traj = Transition(*[leaf[..., :b] for leaf in traj])
                advantages, targets = advantages[..., :b], targets[..., :b]
            if cfg.shuffle_minibatches:
                traj, advantages, targets = shuffle((traj, advantages, targets), runner.key)
            with trace_annotation("ppo.update"):
                params, opt_state, losses = update(runner.params, runner.opt_state, traj,
                                                   advantages, targets)
            total, policy_loss, value_loss, entropy, approx_kl = losses.mean(dim=(0, 1))
            if meshed:
                sums = all_reduce_sum(torch.stack([traj.reward.sum(), traj.done.sum()]), mesh)
                mean_reward, done_sum = sums[0] / (traj.reward.numel() * world), sums[1]
            else:
                mean_reward, done_sum = traj.reward.mean(), traj.done.sum()
            metrics = TrainMetrics(
                total_loss=total, policy_loss=policy_loss, value_loss=value_loss,
                entropy=entropy, approx_kl=approx_kl, mean_reward=mean_reward,
                # done is stored once per (env, seat); episodes are per env.
                episodes_finished=done_sum / (2 if cfg.learner_seats == "both" else 1),
                env_steps=cfg.rollout_length * B)
            runner = PPORunnerState(params, opt_state, env_state, last_obs, runner.key,
                                    runner.update_index + 1)
            return runner, metrics

    train_step.rollout_fn = rollout
    train_step.policy_sample_fn = policy_sample
    train_step.minibatch_grads_fn = minibatch_grads
    train_step.update_fn = update
    train_step.tx = (tx_init, tx_update)
    train_step.shuffle_fn = shuffle
    train_step.uniforms_fn = draw_uniforms
    train_step.local_columns_fn = local_columns
    train_step.provenance = {
        "fused_update": resolved,
        "configured": cfg.fused_update,
        "update_quant": cfg.update_quant,
        "update_bwd_bf16": cfg.update_bwd_bf16,
        "shuffle_minibatches": cfg.shuffle_minibatches,
        "backend": device.type,
        "world_size": world,
    }
    return init_fn, train_step, network
