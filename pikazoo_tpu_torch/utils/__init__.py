"""Logging, profiling and state validation (counterpart of
``pikazoo_tpu.utils``)."""

from pikazoo_tpu_torch.utils.logging import MetricsLogger
from pikazoo_tpu_torch.utils.profiling import Throughput, profile_trace, trace_annotation
from pikazoo_tpu_torch.utils.validation import validate_state

__all__ = ["Throughput", "trace_annotation", "profile_trace", "MetricsLogger",
           "validate_state"]
