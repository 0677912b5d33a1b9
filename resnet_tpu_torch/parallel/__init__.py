"""Data and tensor parallelism on torch.distributed: the port of
resnet_tpu.parallel.

One process drives one device; the ranks form the data group
(``make_mesh``), each training on its rows of the global batch
(``shard_batch``). The 'auto' step (``train.make_train_step`` with a mesh)
is the global-batch step, BN statistics summed over the ranks on every
engine; ``make_shard_map_train_step`` the explicit-sum step with local BN;
``zero_shardings`` the ZeRO plan. ``make_mesh_2d`` is the data x model grid
and ``composite_shardings`` its plan, the FC head split over the model
group (``tensor_parallel``), for ``train.make_train_step(cfg, mesh,
state_shardings=plan)``. ``make_mesh_2d(data, spatial, axes=("data",
"spatial"))`` is the data x spatial grid, ``spatial_shard_batch`` a rank's
rows and slice of the images' height, and ``spatial`` the row plan, the
halo exchange and the partitioned conv and pools that the spatial step runs
(``train.make_train_step(cfg, grid)``).
"""

from . import spatial
from .data_parallel import make_shard_map_train_step
from .distributed import host_batch_slice, initialize_distributed
from .mesh import (
    composite_shardings,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
    spatial_batch_specs,
    spatial_shard_batch,
    zero_shardings,
)

__all__ = [
    "composite_shardings",
    "make_mesh",
    "make_mesh_2d",
    "replicate",
    "shard_batch",
    "spatial_batch_specs",
    "spatial_shard_batch",
    "zero_shardings",
    "spatial",
    "make_shard_map_train_step",
    "initialize_distributed",
    "host_batch_slice",
]
