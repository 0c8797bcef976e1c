"""Logging, profiling and state validation (counterpart of
``pikazoo_tpu.utils``)."""

from pikazoo_tpu_torch.utils.logging import MetricsLogger
from pikazoo_tpu_torch.utils.profiling import (Span, Throughput, profile_trace, take_spans,
                                               trace_annotation, tracing)
from pikazoo_tpu_torch.utils.validation import validate_state

__all__ = ["Throughput", "trace_annotation", "tracing", "take_spans", "Span", "profile_trace",
           "MetricsLogger", "validate_state"]
