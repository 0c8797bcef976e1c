"""pikazoo_tpu_torch — the PyTorch / CUDA port of ``pikazoo_tpu``.

The batched, bit-exact Pikachu Volleyball environment on int32 tensors, with
human or rule-AI seats, and the self-play PPO learner that trains on it.  It
imports ``torch`` and never ``jax``; module names mirror ``pikazoo_tpu`` so
each counterpart is easy to find.  On a CUDA device the rule AI's landing
simulation runs as a hand-written Hopper kernel (``csrc/landing.cu``),
``fused_rollout`` advances a batch many frames in one launch of another
(``csrc/fused_step.cu``), the learner's env step is one launch of a third
(``csrc/learner_step.cu``, the same frame code), and the learner's minibatch
gradient runs in others: feature-major as two kernels in its bf16 and
int8fwd modes, with or without the bf16 backward chain
(``csrc/fused_update_bf16.cu``), as four in its int8 mode
(``csrc/fused_update_int8.cu``), or row-major as two
(``csrc/k4_split.cu``); all are built with ``nvcc`` at first use into
``build/kernels/``.  On the CPU they run as plain PyTorch.  The entry
points (``PikaZoo.reset`` / ``reset_batch``, ``make_ppo_trainer``,
``load_policy``, the evaluation functions, the ``train.run`` CLI, the
PettingZoo drop-in ``pikazoo_v0.env``) run on the card unless the caller asks
for the CPU.

Layers (bottom up):
  core/      physics of one frame: ball, players, collisions, landing
             simulation, rule AI, draw-slot RNG; the fused rollout
  envs/      the environment: ``PikaZoo.reset_batch`` / ``step_batch``, and
             the learner's ``step_batch_learner{,_fm}``
  wrappers/  the six wrappers, batch-shaped; the learner path runs through
             ``SimplifyAction`` and ``RewardByBallPosition``
  train/     the learner: ``ActorCritic``, the fused minibatch gradient,
             ``make_ppo_trainer``, checkpoint / resume, the evaluation
             harness, the ``train.run`` CLI
  policies/  the committed trained policies as ``.pt`` files, ``load_policy``
  utils/     metrics logging, throughput, ``torch.profiler`` traces, state
             validation
  render/    the host renderer (pixel-art sprites, or a flat style)
  native/    the C++ host engine and its CPython fast path, built with
             g++ / gcc at first use into ``build/native/``
  compat/    the PettingZoo ``ParallelEnv`` adapter (torch or native
             backend) and its dict-level wrappers; ``pikazoo_v0`` names it
  parity/    record the reference env; replay a trace in oracle mode
  convert    EnvState and network weights to and from the JAX package's
             numpy leaves
"""

from pikazoo_tpu_torch.core.fused_step import fused_rollout
from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo, TimeStep

__all__ = ["EnvConfig", "PikaZoo", "TimeStep", "fused_rollout"]
