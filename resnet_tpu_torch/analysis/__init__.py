"""The fidelity harness: activation dumps and their numpy analysis, the
port of resnet_tpu.analysis."""

from .analyze import activation_ranges, crosscheck_dump, scan_divergence, tensor_ranges
from .dump import dump_activations, load_activation_dump

__all__ = [
    "dump_activations",
    "load_activation_dump",
    "activation_ranges",
    "crosscheck_dump",
    "scan_divergence",
    "tensor_ranges",
]
