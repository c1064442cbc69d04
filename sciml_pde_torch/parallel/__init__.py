"""Data and tensor parallelism over ``torch.distributed`` (port of
``sciml_pde_tpu/parallel``): the process group, the ('data', 'model')
mesh over its ranks and the sharding helpers the trainers use; the model
axis's column-parallel FNO2d is ``parallel/tp.py``."""

from sciml_pde_torch.parallel.distributed import distributed_init, host_local_array
from sciml_pde_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshAxes,
    batch_sharding,
    data_parallel,
    local_batch_size,
    make_mesh,
    mean_over_ranks,
    replicate,
    replicated_sharding,
    shard_batch,
    trajectory_sharding,
)

__all__ = [
    "AXES",
    "Mesh",
    "MeshAxes",
    "distributed_init",
    "host_local_array",
    "make_mesh",
    "batch_sharding",
    "data_parallel",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "trajectory_sharding",
    "local_batch_size",
    "mean_over_ranks",
]
