"""The wrapper suite (counterpart of ``pikazoo_tpu.wrappers``)."""

from pikazoo_tpu_torch.wrappers.transforms import (SIMPLIFY_P1, SIMPLIFY_P2,
                                                   ConvertSingleAgent,
                                                   NormalizeObservation,
                                                   RecordEpisodeStatistics,
                                                   RewardByBallPosition,
                                                   RewardInNormalState,
                                                   SimplifyAction)

__all__ = [
    "SIMPLIFY_P1",
    "SIMPLIFY_P2",
    "SimplifyAction",
    "RewardByBallPosition",
    "RewardInNormalState",
    "NormalizeObservation",
    "RecordEpisodeStatistics",
    "ConvertSingleAgent",
]
