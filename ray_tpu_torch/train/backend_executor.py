"""BackendExecutor: drives the worker group through a training run.

Reference: `train/_internal/backend_executor.py:68` — start the
WorkerGroup, run Backend hooks, kick off training on every worker, poll
per-iteration results, surface worker failures as TrainingWorkerError
so the trainer can restart the group (reference FailureConfig path).

Elastic path (ROADMAP item 4): instead of discovering a dead rank via a
hung `execute`, the executor subscribes the WorkerGroup to the health
plane (actor_state/node_dead pubsub + circuit-breaker transitions) and
polls results with a bounded timeout.  On loss it pauses surviving
ranks at a step barrier (request_stop → their next report() unwinds),
drains them within a bounded window, tears the group down, and raises
`ElasticWorkerLost` so the trainer can re-form at a smaller width and
restore from the latest atomic checkpoint.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import FailureConfig, ScalingConfig
from ray_tpu_torch.train.session import TrainContext, _TrainingResult
from ray_tpu_torch.train.worker_group import WorkerGroup
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)

logger = logging.getLogger(__name__)


class TrainingWorkerError(Exception):
    """A worker failed mid-training; the group must be restarted."""


class ElasticWorkerLost(TrainingWorkerError):
    """A rank was lost while `FailureConfig(elastic=True)`: the group
    was drained and torn down; the trainer re-forms it (possibly
    narrower) and resumes from the latest atomic checkpoint."""

    def __init__(self, lost_ranks: Dict[int, str], width: int,
                 detected_at: float):
        self.lost_ranks = dict(lost_ranks)
        self.width = width
        self.detected_at = detected_at  # wall clock of first detection
        causes = ", ".join(
            f"rank {r}: {c}" for r, c in sorted(self.lost_ranks.items())
        )
        super().__init__(
            f"lost {len(self.lost_ranks)}/{width} training worker(s) "
            f"({causes})"
        )


def _split_datasets(
    datasets: Optional[Dict[str, Any]], n: int, *, elastic: bool = False
) -> List[Dict[str, Any]]:
    """Per-worker dataset shards.  `Dataset`s split via streaming_split
    (reference `train/_internal/data_config.py`); lists shard
    round-robin; everything else is replicated.

    Elastic runs split with ``elastic=True``: the split coordinator is
    cached on the dataset, so a re-form after a mesh shrink/re-grow
    RESHARDS the in-progress epoch to the new width — in-flight blocks
    of lost ranks are redelivered to survivors, consumed blocks are
    never replayed (exactly-once ingest across the transition).  The
    reshard rides the same loss signals the WorkerGroup monitor uses:
    re-formation is only ever initiated by that detection plane."""
    shards: List[Dict[str, Any]] = [{} for _ in range(n)]
    for name, ds in (datasets or {}).items():
        if hasattr(ds, "streaming_split"):
            for i, shard in enumerate(ds.streaming_split(n, elastic=elastic)):
                shards[i][name] = shard
        elif isinstance(ds, (list, tuple)):
            for i in range(n):
                shards[i][name] = list(ds[i::n])
        else:
            for i in range(n):
                shards[i][name] = ds
    return shards


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        experiment_name: str = "",
        trial_id: str = "",
        storage_path: str = "",
        failure_config: Optional[FailureConfig] = None,
    ):
        self._backend_config = backend_config
        self._backend: Backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._experiment_name = experiment_name
        self._trial_id = trial_id
        self._storage_path = storage_path
        self._failure_config = failure_config or FailureConfig()
        self.worker_group: Optional[WorkerGroup] = None
        self._training_started = False
        self._lost_event = threading.Event()
        self._lost_detected_wall: Optional[float] = None

    @property
    def elastic(self) -> bool:
        return self._failure_config.elastic

    def start(self, reform: bool = False):
        fc = self._failure_config
        kwargs: Dict[str, Any] = {}
        if fc.elastic:
            kwargs = dict(
                # a floor above the requested width is a contradiction,
                # not a capacity condition: clamp it so the reserve
                # ladder is never empty (which would redial for the
                # whole reform_deadline_s with a misleading error)
                min_workers=min(fc.min_workers,
                                self._scaling.num_workers),
                # re-forms probe the full width briefly before walking
                # down; the first start keeps the generous default
                reserve_timeout_s=(
                    fc.reform_timeout_s if reform else 60.0
                ),
                fallback_timeout_s=fc.reform_timeout_s,
            )
        self.worker_group = WorkerGroup(
            num_workers=self._scaling.num_workers,
            resources_per_worker=self._scaling._resources_per_worker_not_none(),
            placement_strategy=self._scaling.placement_strategy,
            **kwargs,
        )
        if fc.elastic:
            self.worker_group.start_monitor(self._on_worker_lost)
        try:
            self._backend.on_start(self.worker_group, self._backend_config)
        except Exception as e:
            self._abort_if_elastic(e)
            raise

    def _on_worker_lost(self, rank: int, cause: str) -> None:
        """Health-plane callback (monitor/notifier thread): stamp the
        detection time, then pause survivors at the step barrier
        immediately — the sooner stop_requested is set, the sooner
        their next report() unwinds instead of entering a collective
        with a dead peer."""
        if self._lost_detected_wall is None:
            self._lost_detected_wall = time.time()
        self._lost_event.set()
        wg = self.worker_group
        if wg is not None and self._training_started:
            # a loss means the executor is about to abandon this
            # round's results: drain so no survivor stays parked in a
            # backpressure put
            wg.request_stop_all(drain=True)

    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict[str, Any]],
        checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        assert self.worker_group is not None, "call start() first"
        try:
            # the rendezvous (collective group / jax.distributed init)
            # and the session kick-off both block on worker RPCs: a
            # rank preempted DURING formation — exactly when a
            # preemption wave is still in progress — must fail over,
            # not abort fit() with a raw worker-died error
            self._backend.on_training_start(
                self.worker_group, self._backend_config
            )
            n = len(self.worker_group)
            shards = _split_datasets(
                datasets, n, elastic=self._failure_config.elastic
            )
            refs = []
            for rank, worker in enumerate(self.worker_group.workers):
                ctx = TrainContext(
                    world_size=n,
                    world_rank=rank,
                    local_rank=rank,  # single-host group so far
                    local_world_size=n,
                    experiment_name=self._experiment_name,
                    trial_id=self._trial_id,
                    mesh_shape=self._scaling.mesh_shape,
                    storage_path=self._storage_path,
                )
                if self._failure_config.elastic:
                    ctx.extra["elastic"] = True
                    ctx.extra["target_world_size"] = self._scaling.num_workers
                refs.append(
                    worker.start_training.remote(
                        train_fn, config, ctx, checkpoint, shards[rank]
                    )
                )
            rt.get(refs)
        except Exception as e:
            self._abort_if_elastic(e)
            raise
        self._training_started = True
        self._done = [False] * n

    def _abort_if_elastic(self, e: Exception) -> None:
        """Route a formation-window failure into the elastic failover
        path (raises ElasticWorkerLost) when elastic is on AND the
        failure is death-shaped (a rank/host went away) — a
        deterministic config/backend error must surface as itself, not
        loop as failovers forever."""
        if not self._failure_config.elastic or self.worker_group is None:
            return
        death_like = isinstance(e, (
            rt.exceptions.ActorDiedError,
            rt.exceptions.WorkerCrashedError,
            rt.exceptions.NodeDiedError,
        )) or any(s in str(e).lower() for s in (
            "died", "is dead", "worker_died", "connection lost",
            "disconnected",
        ))
        if not (self.worker_group.lost_ranks() or death_like):
            return
        if not self.worker_group.lost_ranks():
            self.worker_group.mark_lost(-1, f"group formation failed: {e}")
        self._elastic_abort()

    def get_next_results(self) -> Optional[List[_TrainingResult]]:
        """One result per still-running worker; None once all finished.
        All workers report in lockstep (same number of report() calls),
        as the reference requires.

        Elastic runs poll with `detect_poll_s` granularity so a rank
        lost mid-collective surfaces within a bounded window via the
        health plane instead of hanging this call forever."""
        assert self._training_started
        wg = self.worker_group
        live = [i for i, d in enumerate(self._done) if not d]
        if not live:
            return None
        refs = [wg.workers[i].get_next_result.remote() for i in live]
        elastic = self._failure_config.elastic
        while True:
            if elastic and (self._lost_event.is_set() or wg.lost_ranks()):
                self._elastic_abort()
            try:
                results: List[_TrainingResult] = rt.get(
                    refs,
                    timeout=(
                        self._failure_config.detect_poll_s
                        if elastic else None
                    ),
                )
                break
            except rt.exceptions.GetTimeoutError:
                continue
            except Exception as e:
                if elastic:
                    # the death surfaced through the call path before
                    # the health plane published it: attribute it to
                    # the exact rank(s) whose result refs are poisoned
                    for i, ref in zip(live, refs):
                        try:
                            rt.get([ref], timeout=0.05)
                        except rt.exceptions.GetTimeoutError:
                            continue
                        except Exception as pe:
                            # not swallowed: recorded as the loss cause
                            logger.debug("rank %d ref poisoned: %s", i, pe)
                            wg.mark_lost(i, f"worker call failed: {pe}")
                    if not wg.lost_ranks():
                        wg.mark_lost(-1, f"worker call failed: {e}")
                    self._elastic_abort()
                raise TrainingWorkerError(f"training worker died: {e}") from e
        out: List[_TrainingResult] = []
        for i, res in zip(live, results):
            if res.error is not None:
                raise TrainingWorkerError(
                    f"worker {i} failed: {res.error!r}\n"
                    + getattr(res.error, "_rt_traceback", "")
                ) from res.error
            if res.done:
                self._done[i] = True
            else:
                out.append(res)
        if not out and all(self._done):
            return None
        return out if out else self.get_next_results()

    def _elastic_abort(self):
        """Shrink entry point: pause survivors at the step barrier,
        drain them within `drain_timeout_s` (a survivor wedged in a
        collective with the dead peer is torn down anyway), then raise
        `ElasticWorkerLost` for the trainer's re-form loop."""
        wg = self.worker_group
        lost = wg.lost_ranks()
        width = len(wg)
        detected = self._lost_detected_wall or time.time()
        try:
            wg.finish(
                timeout_s=self._failure_config.drain_timeout_s,
                raise_on_error=False,
            )
        except Exception as e:
            logger.debug("elastic drain failed: %s", e)
        self.shutdown()
        raise ElasticWorkerLost(lost or {-1: "worker lost"}, width, detected)

    def request_stop_all(self) -> None:
        if self.worker_group is not None:
            self.worker_group.request_stop_all()

    def probe_regrow(self, timeout_s: float = 2.0) -> bool:
        """Can the missing capacity be placed right now?  Probes with a
        placement group for the DELTA only (the group's own bundles are
        released at re-form time, so delta + held == full width); the
        probe PG is always removed — it must never squat on capacity."""
        wg = self.worker_group
        if wg is None:
            return False
        delta = wg.requested_workers - len(wg)
        if delta <= 0:
            return False
        res = self._scaling._resources_per_worker_not_none()
        pg = placement_group(
            [dict(res) for _ in range(delta)],
            strategy=self._scaling.placement_strategy,
        )
        try:
            ok = pg.ready(timeout=timeout_s)
        finally:
            try:
                remove_placement_group(pg)
            except Exception as e:
                logger.debug("regrow probe PG removal failed: %s", e)
        return ok

    def shutdown(self):
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group, self._backend_config)
            except Exception as e:
                logger.debug("backend on_shutdown failed: %s", e)
            self.worker_group.shutdown()
            self.worker_group = None
        self._training_started = False
