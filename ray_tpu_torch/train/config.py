"""Train configuration dataclasses.

Surface mirrors the reference's `air/config.py` (`ScalingConfig`,
`RunConfig`, `FailureConfig`, `CheckpointConfig`) so reference users find
the same knobs.  The JAX package's `ScalingConfig` speaks TPU chips and
ICI topology; here it speaks GPUs (`use_gpu`, upstream Ray's name), and
the ICI sub-mesh request (`topology`) has no counterpart on a GPU host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class ScalingConfig:
    """How many workers and what each gets.

    Reference: `air/config.py` ScalingConfig (num_workers, use_gpu,
    resources_per_worker, placement_strategy), plus:

    - ``mesh_shape``: logical mesh axes the workers' process group
      builds its `DeviceMesh` over, e.g. ``{"dp": 2, "sp": 2}``.

    A fractional ``resources_per_worker={"GPU": 0.5}`` places two
    workers on one card (no isolation: both see the same cards).
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    mesh_shape: Optional[Dict[str, int]] = None
    trainer_resources: Optional[Dict[str, float]] = None

    def _resources_per_worker_not_none(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            res = dict(self.resources_per_worker)
        else:
            res = {"CPU": 1.0}
            if self.use_gpu:
                res["GPU"] = 1.0
        return res

    @property
    def num_gpus_per_worker(self) -> float:
        return self._resources_per_worker_not_none().get("GPU", 0.0)


@dataclass
class FailureConfig:
    """Reference: `air/config.py` FailureConfig(max_failures), extended
    with the elastic-training contract (ROADMAP item 4: preemption-
    tolerant worker groups).

    - ``max_failures``: restarts granted for failures raised BY the
      user's train loop (unchanged semantics; -1 = unlimited).
    - ``elastic``: when True, a LOST worker (preempted host, SIGKILLed
      process, tripped circuit breaker) does not consume the
      ``max_failures`` budget and does not require full capacity to
      recover: the group re-forms at the widest placeable width in
      ``[min_workers, num_workers]``, restores from the latest atomic
      checkpoint (resharding as needed), and re-grows to full width
      when capacity returns.
    - ``min_workers``: smallest world size worth training at (default
      1).  Below it the trainer waits — with jittered backoff — up to
      ``reform_deadline_s`` before failing the run.
    - ``detect_poll_s``: executor-side polling granularity while
      waiting on worker results; bounds how long a hung ``execute``
      can mask a death signalled by the health plane.
    - ``drain_timeout_s``: how long surviving ranks get to reach the
      step barrier (their next ``report()``) before being torn down
      anyway — a survivor wedged inside a collective with a dead peer
      must not stall recovery.
    - ``reform_timeout_s``: per-width placement-group wait while
      re-forming (the shrink ladder tries num_workers, then
      num_workers-1, ... min_workers, each bounded by this).
    - ``reform_deadline_s``: total budget for capacity below
      ``min_workers`` before the run fails.
    - ``regrow_interval_s``: how often a degraded group probes for the
      missing capacity; a successful probe pauses ranks at the next
      step barrier and re-forms at full width.
    """

    max_failures: int = 0
    elastic: bool = False
    min_workers: int = 1
    detect_poll_s: float = 0.5
    drain_timeout_s: float = 5.0
    reform_timeout_s: float = 10.0
    reform_deadline_s: float = 300.0
    regrow_interval_s: float = 10.0
    max_failovers: int = -1  # elastic failovers allowed (-1 = unlimited)

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        for knob in ("detect_poll_s", "drain_timeout_s",
                     "reform_timeout_s", "reform_deadline_s",
                     "regrow_interval_s"):
            if getattr(self, knob) <= 0:
                raise ValueError(f"{knob} must be positive")

    @property
    def retries_enabled(self) -> bool:
        return self.max_failures != 0


@dataclass
class CheckpointConfig:
    """Reference: `air/config.py` CheckpointConfig — top-K retention by
    a score attribute."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


def _default_storage_path() -> str:
    return os.environ.get(
        "RTT_STORAGE_PATH", os.path.expanduser("~/ray_tpu_results")
    )


@dataclass
class RunConfig:
    """Reference: `air/config.py` RunConfig."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = _default_storage_path()
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()
