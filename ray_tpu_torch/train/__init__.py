"""ray_tpu_torch.train — distributed training orchestration.

Reference surface: `ray.train` (SURVEY §2.4 Ray Train) — trainers,
worker groups, in-loop session API, checkpoints, failure handling —
the JAX package's plane on the port's runtime, with `CudaTrainer` /
`CudaConfig` for its `JaxTrainer` / `JaxConfig` and `cuda_utils` for its
`jax_utils`; meshes come from the ScalingConfig.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig, CudaBackend, CudaConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    ElasticWorkerLost,
    TrainingWorkerError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import (
    CheckpointManager,
    validate_checkpoint,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.sharded_checkpoint import load_sharded, save_sharded
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    CudaTrainer,
    DataParallelTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "Backend",
    "BackendConfig",
    "BackendExecutor",
    "BaseTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "CudaBackend",
    "CudaConfig",
    "CudaTrainer",
    "DataParallelTrainer",
    "ElasticWorkerLost",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchConfig",
    "TorchTrainer",
    "TrainContext",
    "TrainingFailedError",
    "TrainingWorkerError",
    "WorkerGroup",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "load_sharded",
    "report",
    "save_sharded",
    "validate_checkpoint",
]
