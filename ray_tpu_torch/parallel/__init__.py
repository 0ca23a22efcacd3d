"""Parallelism layer: meshes, shardings, collectives, sequence/pipeline/
expert parallelism.  The JAX package's `parallel/` over
`torch.distributed`.  The expert and pipeline names load their modules
on first use (`__getattr__`), so importing the package, as the
runtime's daemons and workers do, imports no torch."""

import importlib

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

# name -> its module, imported when the name is first read
_LAZY = {
    "MoEConfig": "moe", "init_moe": "moe", "moe_forward": "moe",
    "pipeline_apply": "pipeline", "stage_sharding": "pipeline",
    "CompiledPipeline": "pipeline_dag", "bubble_fraction": "pipeline_dag",
    "compile_pipeline": "pipeline_dag", "one_f1b_schedule": "pipeline_dag",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


__all__ = [
    "AXES",
    "CompiledPipeline",
    "DEFAULT_RULES",
    "MeshSpec",
    "MoEConfig",
    "batch_axes",
    "bubble_fraction",
    "compile_pipeline",
    "one_f1b_schedule",
    "data_sharding",
    "init_moe",
    "local_batch_size",
    "mesh_from_devices",
    "moe_forward",
    "optimizer_shardings",
    "pipeline_apply",
    "replicated",
    "shard_params",
    "sharding_from_logical",
    "stage_sharding",
    "spec_from_logical",
    "tree_shardings",
]
