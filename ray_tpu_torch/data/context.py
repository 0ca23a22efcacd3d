"""Execution context for Data pipelines.

Reference: `data/context.py` DataContext + the execution resource
manager / backpressure policies
(`_internal/execution/resource_manager.py:25`,
`backpressure_policy/`).  One process-wide current context, overridable
per call the way the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class DataContext:
    #: max in-flight tasks per streaming stage (count-based pressure)
    window: int = 8
    #: max estimated bytes being processed per stage at once
    #: (byte-based pressure; estimated from input-block metadata when
    #: the upstream task has completed)
    max_stage_inflight_bytes: int = 256 * 1024 * 1024
    #: pipelined calls per actor in actor-pool map stages
    actor_pool_pipeline_depth: int = 2
    #: retries for every data-plane task (read/map/shuffle map+reduce):
    #: a SIGKILLed worker retries through the core worker-died path and
    #: lost output blocks re-derive via lineage reconstruction, so one
    #: dead worker never costs an epoch
    data_task_max_retries: int = 4
    #: hard bound on how long an admission point may block making zero
    #: progress before surfacing a typed BackPressureError (never an
    #: unbounded queue, never a silent hang)
    backpressure_timeout_s: float = 120.0
    #: rows sampled per input block when a shuffle needs range
    #: boundaries (sort / groupby)
    shuffle_sample_rows: int = 64
    #: fraction of the node's object-store budget a stage may hold
    #: in flight (pinned inputs + outputs of running tasks).  The
    #: effective per-stage byte cap is
    #: min(max_stage_inflight_bytes, fraction * store_capacity) — the
    #: reference resource manager budgets operator memory against the
    #: store the same way, which is what lets an over-memory shuffle
    #: complete via spilling instead of wedging on pinned bytes
    store_memory_fraction: float = 0.25
    #: override the reduce-partition count for shuffles (None: one
    #: partition per input block; repartition always uses its target)
    shuffle_partitions: Optional[int] = None

    @staticmethod
    def get_current() -> "DataContext":
        global _current_context
        if _current_context is None:
            _current_context = DataContext()
        return _current_context


_current_context: Optional[DataContext] = None


@dataclasses.dataclass
class ActorPoolStrategy:
    """compute= strategy for `map_batches` with a class UDF: a pool of
    actors holding one constructed UDF instance each, autoscaled
    between min_size and max_size by queue pressure (reference:
    `actor_pool_map_operator.py` + `execution/autoscaler/`)."""

    size: Optional[int] = None  # fixed size shorthand
    min_size: int = 1
    max_size: Optional[int] = None

    def __post_init__(self):
        if self.size is not None:
            self.min_size = self.max_size = self.size
        if self.max_size is None:
            self.max_size = max(self.min_size, 4)
        if self.min_size < 1 or self.max_size < self.min_size:
            raise ValueError(
                f"invalid actor pool bounds [{self.min_size}, {self.max_size}]"
            )
