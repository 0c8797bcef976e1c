from pikazoo_tpu_torch.parity.harness import (ReferenceTrace, SpyGenerator,
                                              record_reference_trace,
                                              reference_available)
from pikazoo_tpu_torch.parity.replay import (ORACLE_CAPACITY, pad_oracle,
                                             replay_and_compare)

__all__ = [
    "ReferenceTrace",
    "SpyGenerator",
    "record_reference_trace",
    "reference_available",
    "ORACLE_CAPACITY",
    "pad_oracle",
    "replay_and_compare",
]
