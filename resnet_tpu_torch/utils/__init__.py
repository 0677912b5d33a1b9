"""Debugging, logging and profiling helpers: the port of resnet_tpu.utils."""

from .debug import check_state_finite, debug_print_tensor, nonfinite_report
from .logging import MetricsLogger
from .profiling import trace_context

__all__ = [
    "check_state_finite",
    "debug_print_tensor",
    "nonfinite_report",
    "MetricsLogger",
    "trace_context",
]
