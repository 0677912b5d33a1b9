"""Input data of the port; ``synthetic`` is a copy of the JAX package's."""

from .synthetic import SyntheticDataset

__all__ = ["SyntheticDataset"]
