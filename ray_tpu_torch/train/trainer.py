"""Trainers: fit() orchestration over the BackendExecutor.

Reference: `train/base_trainer.py:111` BaseTrainer.fit,
`train/data_parallel_trainer.py:25` DataParallelTrainer.  Differences
by design: fit() drives the executor directly (the reference detours
through Tune — our Tune-equivalent wraps trainers via
`as_trainable()` the same way, see `ray_tpu_torch/tune`).
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.retry import backoff_delay_s
from ray_tpu_torch.metrics import metric_defs as _mdefs
from ray_tpu_torch.train.backend import BackendConfig, CudaConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    ElasticWorkerLost,
    TrainingWorkerError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import (
    CheckpointCommitError,
    CheckpointManager,
    sweep_staging,
)
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.result import Result

logger = logging.getLogger(__name__)


class TrainingFailedError(RuntimeError):
    """Raised by fit() when training fails beyond FailureConfig limits."""


def _is_capacity_error(e: BaseException) -> bool:
    """Start failures worth waiting out: the cluster momentarily lacks
    the bundles/workers (preempted capacity routinely returns), as
    opposed to deterministic config/backend failures."""
    msg = str(e)
    return any(s in msg for s in (
        "could not reserve",
        "no node can host actor",
        "resources no longer available",
        "no idle worker",
    ))


class BaseTrainer:
    # per-iteration hook (metrics, persisted_checkpoint|None) used by the
    # Tune integration to forward reports to the trial (reference: the
    # trainable wrapper re-reporting, base_trainer.py:819)
    _result_callback = None

    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap into a Tune Trainable (reference `base_trainer.py:819`);
        imported lazily to keep train usable without tune."""
        from ray_tpu_torch.tune.trainable import wrap_trainer

        return wrap_trainer(self)


class DataParallelTrainer(BaseTrainer):
    """SPMD training: the same train_loop_per_worker on N workers.

    Reference: `train/data_parallel_trainer.py:25,428`.  The loop calls
    `ray_tpu_torch.train.report(metrics, checkpoint=...)` each iteration; rank
    0's metrics become the run's reported metrics.
    """

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.backend_config = backend_config or self._default_backend_config

    # -- storage layout ------------------------------------------------
    def _run_dir(self) -> str:
        name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        d = os.path.join(self.run_config.storage_path, name)
        os.makedirs(d, exist_ok=True)
        return d

    def _should_stop(self, metrics: Dict[str, Any]) -> bool:
        stop = self.run_config.stop
        if not stop:
            return False
        for k, v in stop.items():
            if k == "training_iteration":
                if metrics.get("training_iteration", 0) >= v:
                    return True
            elif k in metrics and metrics[k] >= v:
                return True
        return False

    def fit(self) -> Result:
        from ray_tpu_torch.util.usage_stats import record_library_usage

        record_library_usage("train")
        run_dir = self._run_dir()
        sweep_staging(run_dir)
        ckpt_manager = CheckpointManager(self.run_config.checkpoint_config)
        fc = self.run_config.failure_config
        max_failures = fc.max_failures
        failures = 0
        failovers = 0
        latest_checkpoint = self.resume_from_checkpoint
        history = []
        last_metrics: Optional[Dict[str, Any]] = None
        error: Optional[BaseException] = None
        iteration = 0
        reform = False
        # elastic lifecycle log — {"kind": "shrink"|"reform"|"regrow",
        # ...} — consumed by the MTTR harness (`perf.py
        # --elastic-recovery`) and the chaos tests' deterministic
        # assertions
        self._elastic_events: List[Dict[str, Any]] = []

        while True:
            executor = BackendExecutor(
                self.backend_config,
                self.scaling_config,
                experiment_name=os.path.basename(run_dir),
                trial_id=uuid.uuid4().hex[:8],
                storage_path=run_dir,
                failure_config=fc,
            )
            try:
                self._start_with_capacity_wait(executor, reform)
                width = len(executor.worker_group)
                if reform:
                    _mdefs.inc("rt_train_elastic_events_total",
                               tags={"kind": "reform"})
                    self._elastic_events.append({
                        "kind": "reform", "width": width,
                        "target": self.scaling_config.num_workers,
                        "iteration": iteration, "wall": time.time(),
                    })
                executor.start_training(
                    self.train_loop_per_worker,
                    self.train_loop_config,
                    checkpoint=latest_checkpoint,
                    datasets=self.datasets,
                )
                stop_requested = False
                pause_for_regrow = False
                regrow_last_probe = time.monotonic()
                t_last_round = time.monotonic()
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    # wall time between delivered rounds — the driver's
                    # view of step time, including report/backpressure
                    _mdefs.observe(
                        "rt_train_step_seconds",
                        time.monotonic() - t_last_round,
                    )
                    t_last_round = time.monotonic()
                    iteration += 1
                    rank0 = results[0]
                    metrics = dict(rank0.metrics or {})
                    metrics.setdefault("training_iteration", iteration)
                    metrics.setdefault("timestamp", time.time())
                    history.append(metrics)
                    last_metrics = metrics
                    reported = [r.checkpoint for r in results if r.checkpoint]
                    persisted = None
                    if reported:
                        try:
                            persisted = ckpt_manager.commit(
                                reported, run_dir, iteration, metrics
                            )
                            latest_checkpoint = persisted
                        except CheckpointCommitError as ce:
                            # e.g. a stop-boundary round where only a
                            # subset of writer ranks reported: the
                            # previous checkpoint stays `latest`
                            logger.warning(
                                "iteration %d checkpoint not published"
                                " (%s); keeping the previous one",
                                iteration, ce,
                            )
                    if self._result_callback is not None:
                        self._result_callback(metrics, persisted)
                    if not stop_requested and self._should_stop(metrics):
                        stop_requested = True
                        executor.request_stop_all()
                    # re-grow: a degraded elastic group periodically
                    # probes for its missing capacity; on success the
                    # ranks pause at the next step barrier and the
                    # group re-forms at full width
                    if (
                        fc.elastic
                        and not stop_requested
                        and not pause_for_regrow
                        and width < self.scaling_config.num_workers
                        and time.monotonic() - regrow_last_probe
                        >= fc.regrow_interval_s
                    ):
                        regrow_last_probe = time.monotonic()
                        if executor.probe_regrow():
                            pause_for_regrow = True
                            executor.request_stop_all()
                if pause_for_regrow:
                    _mdefs.inc("rt_train_elastic_events_total",
                               tags={"kind": "regrow"})
                    self._elastic_events.append({
                        "kind": "regrow", "width_from": width,
                        "iteration": iteration, "wall": time.time(),
                    })
                    executor.shutdown()
                    latest_checkpoint = (
                        ckpt_manager.latest_valid or latest_checkpoint
                    )
                    reform = True
                    continue
                error = None
                break
            except ElasticWorkerLost as e:
                failovers += 1
                _mdefs.inc("rt_train_elastic_events_total",
                           tags={"kind": "shrink"})
                self._elastic_events.append({
                    "kind": "shrink", "lost_ranks": dict(e.lost_ranks),
                    "width": e.width, "iteration": iteration,
                    "detected_wall": e.detected_at, "wall": time.time(),
                })
                logger.warning(
                    "elastic failover %d: %s — re-forming from latest "
                    "valid checkpoint", failovers, e,
                )
                if 0 <= fc.max_failovers < failovers:
                    error = TrainingFailedError(
                        f"training failed after {failovers} elastic "
                        f"failover(s): {e}"
                    )
                    break
                latest_checkpoint = (
                    ckpt_manager.latest_valid or latest_checkpoint
                )
                reform = True
            except TrainingWorkerError as e:
                failures += 1
                if max_failures >= 0 and failures > max_failures:
                    error = TrainingFailedError(
                        f"training failed after {failures} failure(s): {e}"
                    )
                    break
                latest_checkpoint = (
                    ckpt_manager.latest_valid or latest_checkpoint
                    if fc.elastic
                    else ckpt_manager.latest or latest_checkpoint
                )
            finally:
                executor.shutdown()

        return Result(
            metrics=last_metrics,
            checkpoint=ckpt_manager.best or latest_checkpoint,
            error=error,
            path=run_dir,
            metrics_history=history,
            best_checkpoints=ckpt_manager.best_checkpoints,
        )

    def _start_with_capacity_wait(self, executor: BackendExecutor,
                                  reform: bool) -> None:
        """Start the executor; an elastic run whose cluster momentarily
        cannot place even ``min_workers`` waits with jittered backoff
        (never a constant-sleep redial loop) up to
        ``reform_deadline_s`` — preempted capacity routinely comes
        back within minutes."""
        fc = self.run_config.failure_config
        if not fc.elastic:
            executor.start()
            return
        deadline = time.monotonic() + fc.reform_deadline_s
        attempt = 0
        while True:
            try:
                executor.start(reform=reform)
                return
            except Exception as e:
                executor.shutdown()
                if not _is_capacity_error(e):
                    # deterministic failures (bad config, backend bug)
                    # must surface immediately with their real cause,
                    # not after reform_deadline_s of futile redialing
                    raise
                if time.monotonic() >= deadline:
                    raise TrainingFailedError(
                        f"cluster stayed below min_workers="
                        f"{fc.min_workers} for {fc.reform_deadline_s:.0f}s: "
                        f"{e}"
                    ) from e
                delay = backoff_delay_s(
                    attempt, base_s=0.5, cap_s=15.0,
                )
                logger.info(
                    "elastic start attempt %d failed (%s); retrying in "
                    "%.1fs", attempt + 1, e, delay,
                )
                time.sleep(delay)
                attempt += 1


class CudaTrainer(DataParallelTrainer):
    """The flagship trainer: one train loop a worker on its card,
    wired by `CudaConfig` (the JAX package's `JaxTrainer`)."""

    _default_backend_config = CudaConfig()

    def __init__(self, train_loop_per_worker, *,
                 cuda_config: Optional[CudaConfig] = None, **kwargs):
        kwargs.setdefault("backend_config", cuda_config or CudaConfig())
        super().__init__(train_loop_per_worker, **kwargs)
