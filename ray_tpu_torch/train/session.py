"""Per-worker training session.

Reference: `train/_internal/session.py` — the user's train loop runs in
a session thread inside each worker actor; `report()` hands
(metrics, checkpoint) to the actor's result queue, which the
BackendExecutor polls.  `get_context()` exposes rank/world info
(reference `train/context.py:26`); addition: `get_mesh()` builds a
`DeviceMesh` over the workers' process group from the ScalingConfig.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class _TrainingResult:
    """One unit handed from session thread -> actor -> executor."""

    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    done: bool = False
    error: Optional[BaseException] = None


@dataclass
class TrainContext:
    """Reference: `train/context.py` TrainContext."""

    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    experiment_name: str = ""
    trial_name: str = ""
    trial_id: str = ""
    mesh_shape: Optional[Dict[str, int]] = None
    storage_path: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id

    def get_target_world_size(self) -> int:
        """The ScalingConfig's requested width.  Under an elastic
        shrink (`FailureConfig(elastic=True)`) `get_world_size()` may
        be smaller; the difference tells the loop it is running
        degraded and will be re-grown when capacity returns."""
        return int(self.extra.get("target_world_size", self.world_size))

    def is_elastic(self) -> bool:
        return bool(self.extra.get("elastic", False))

    def get_mesh(self):
        """Build a `DeviceMesh` over the workers' process group
        (`CudaConfig(distributed_mode="torch_distributed")`) per the
        ScalingConfig's ``mesh_shape`` (all ranks on dp if unset; an
        ``"n"`` entry takes the first n ranks), on the backend's device
        ("cuda" unless the config asked for "cpu").

        Elastic runs re-form at a smaller width, so the requested
        shape may no longer match the world size — then the spec is
        re-fit via `MeshSpec.fit_to`: model axes preserved, data axes
        (dp first) shrunk to cover the surviving ranks."""
        import os

        import torch.distributed as dist

        from ray_tpu_torch.parallel import MeshSpec

        shape = dict(self.mesh_shape or {})
        n = shape.pop("n", None)
        world = dist.get_world_size()
        ranks = list(range(world))[: n or world]
        if not shape:
            shape = {"dp": len(ranks)}
        device_type = os.environ.get("RTT_TRAIN_DEVICE", "cuda")
        spec = MeshSpec(**shape)
        try:
            return spec.build(ranks, device_type=device_type)
        except ValueError:
            if not self.is_elastic():
                raise
            return spec.fit_to(len(ranks)).build(ranks,
                                                 device_type=device_type)


class _Session:
    """Holds the queue between the user loop thread and the actor."""

    def __init__(
        self,
        context: TrainContext,
        checkpoint: Optional[Checkpoint],
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.context = context
        self.result_queue: "queue.Queue[_TrainingResult]" = queue.Queue(maxsize=1)
        self.loaded_checkpoint = checkpoint
        self.datasets = datasets or {}
        # stop: unwind at the NEXT step barrier, after delivering the
        # current result (graceful — the executor keeps consuming).
        # abandoned: the executor has stopped consuming (elastic drain,
        # teardown); skip delivery entirely so nothing blocks on the
        # 1-deep queue.
        self.stop_requested = threading.Event()
        self.abandoned = threading.Event()
        self.iteration = 0

    def report(self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint]):
        self.iteration += 1
        # An ABANDONED session's results have no consumer: skip the put
        # (it could block forever on the 1-deep queue) and unwind at
        # the step barrier now.  A graceful stop still DELIVERS this
        # round — dropping it would hand the trainer a partial round
        # and a partial (invalid) checkpoint commit.
        if self.abandoned.is_set():
            raise StopIteration("training session abandoned")
        # Blocks when the executor is behind — natural backpressure, the
        # same semantics as the reference's result queue.
        self.result_queue.put(_TrainingResult(metrics=metrics, checkpoint=checkpoint))
        if self.stop_requested.is_set():
            raise StopIteration("training stop requested")


_session_local = threading.local()


def _set_session(s: Optional[_Session]):
    _session_local.value = s


def _get_session() -> Optional[_Session]:
    return getattr(_session_local, "value", None)


# ---------------------------------------------------------------------
# public in-loop API (reference: `train/_internal/session.py:403,667,754`)
# ---------------------------------------------------------------------
def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None):
    s = _get_session()
    if s is None:
        raise RuntimeError(
            "train.report() called outside a training session"
        )
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    if s is None:
        raise RuntimeError("get_checkpoint() called outside a training session")
    return s.loaded_checkpoint


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        # Outside a session: a degenerate single-worker context, so the
        # same train loop runs standalone (reference behaves likewise).
        return TrainContext()
    return s.context


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    if s is None:
        raise RuntimeError("get_dataset_shard() called outside a training session")
    return s.datasets.get(name)
