"""Input data of the port: the exports of resnet_tpu.data. The readers are
copies of the JAX package's (numpy only, the same bytes and cursors for
the same inputs); ``prefetch`` is rewritten for CUDA. ``NativeShardIterator``
and ``native_available`` are reached through ``data.native``, as in JAX."""

from .jpeg import JpegDataset
from .metadata import ClassMetadata, load_class_metadata
from .prefetch import DevicePrefetcher, prefetch_to_device
from .shards import ShardCursor, ShardDataset, ShardIterator, write_shard
from .synthetic import SyntheticDataset

__all__ = [
    "ClassMetadata",
    "load_class_metadata",
    "ShardCursor",
    "ShardDataset",
    "ShardIterator",
    "write_shard",
    "SyntheticDataset",
    "JpegDataset",
    "DevicePrefetcher",
    "prefetch_to_device",
]
