from pikazoo_tpu_torch.envs.pika_volley import (EnvConfig, EnvState, PikaZoo,
                                                TimeStep)
from pikazoo_tpu_torch.envs.observations import (NUM_ACTIONS, OBS_DIM, OBS_HIGH,
                                                 OBS_LOW)

__all__ = [
    "EnvConfig",
    "EnvState",
    "PikaZoo",
    "TimeStep",
    "OBS_DIM",
    "OBS_LOW",
    "OBS_HIGH",
    "NUM_ACTIONS",
]
