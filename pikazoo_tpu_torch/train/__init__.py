"""Self-play PPO learner (counterpart of ``pikazoo_tpu.train``)."""

from pikazoo_tpu_torch.train.networks import ActorCritic, apply_fm, normalize_obs
from pikazoo_tpu_torch.train.ppo import (PPOConfig, PPORunnerState, TrainMetrics,
                                         Transition, make_ppo_trainer)

__all__ = ["ActorCritic", "apply_fm", "normalize_obs", "PPOConfig",
           "PPORunnerState", "TrainMetrics", "Transition", "make_ppo_trainer"]
