"""Parallelism layer: meshes, shardings, collectives, sequence
parallelism.  The JAX package's `parallel/` over `torch.distributed`;
its expert (MoE) and pipeline names wait for ROADMAP.md queue 1 item 6
and are not exported yet."""

from ray_tpu_torch.parallel.mesh import (
    AXES,
    MeshSpec,
    batch_axes,
    data_sharding,
    local_batch_size,
    mesh_from_devices,
    replicated,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    optimizer_shardings,
    shard_params,
    sharding_from_logical,
    spec_from_logical,
    tree_shardings,
)

__all__ = [
    "AXES",
    "DEFAULT_RULES",
    "MeshSpec",
    "batch_axes",
    "data_sharding",
    "local_batch_size",
    "mesh_from_devices",
    "optimizer_shardings",
    "replicated",
    "shard_params",
    "sharding_from_logical",
    "spec_from_logical",
    "tree_shardings",
]
