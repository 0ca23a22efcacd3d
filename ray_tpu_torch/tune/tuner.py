"""Tuner: the public HPO entry point.

Reference: `tune/tuner.py:44` Tuner(trainable, param_space, tune_config,
run_config).fit() -> ResultGrid; `Tuner.restore` resumes an interrupted
experiment from its saved state (`tune/impl/tuner_internal.py`).
"""

from __future__ import annotations

import json
import os
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.tune.controller import (
    ERROR,
    PENDING,
    TERMINATED,
    Trial,
    TuneController,
    new_trial_id,
)
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import Trainable, wrap_trainer


@dataclass
class TuneConfig:
    """Reference: `tune/tune_config.py` TuneConfig."""

    num_samples: int = 1
    metric: Optional[str] = None
    mode: str = "max"
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None
    max_concurrent_trials: int = 4
    seed: Optional[int] = None
    resources_per_trial: Optional[Dict[str, float]] = None
    checkpoint_frequency: int = 0


class ResultGrid:
    """Reference: `tune/result_grid.py`."""

    def __init__(self, results: List[Result], experiment_path: str):
        self._results = results
        self.experiment_path = experiment_path

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: str = "max") -> Result:
        metric = metric or getattr(self, "_default_metric", None)
        if metric is None:
            raise ValueError("metric required")
        sign = 1 if mode == "max" else -1
        best = None
        for r in self._results:
            if r.metrics and metric in r.metrics:
                score = sign * float(r.metrics[metric])
                if best is None or score > best[0]:
                    best = (score, r)
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return best[1]

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable, type, Any],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restore_path: Optional[str] = None,
    ):
        self._trainable_def = _normalize_trainable(trainable)
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_path = _restore_path

    @classmethod
    def restore(cls, path: str, trainable) -> "Tuner":
        """Resume an interrupted experiment (reference `Tuner.restore`)."""
        return cls(trainable, _restore_path=path)

    def _experiment_dir(self) -> str:
        if self._restore_path:
            return self._restore_path
        name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        d = os.path.join(self.run_config.storage_path, name)
        os.makedirs(d, exist_ok=True)
        return d

    def _build_trials(self, experiment_dir: str) -> List[Trial]:
        if self._restore_path:
            state_file = os.path.join(experiment_dir, "experiment_state.json")
            with open(state_file) as f:
                state = json.load(f)
            trials = []
            for ts in state["trials"]:
                t = Trial(
                    trial_id=ts["trial_id"],
                    config=ts["config"],
                    status=ts["status"] if ts["status"] == TERMINATED else PENDING,
                    last_result=ts["last_result"],
                    metrics_history=ts.get("metrics_history") or [],
                    checkpoint_path=ts["checkpoint_path"],
                    trial_dir=ts["trial_dir"],
                )
                if t.status == PENDING and t.checkpoint_path:
                    t.restore_from = t.checkpoint_path
                trials.append(t)
            return trials
        searcher = self.tune_config.search_alg
        if searcher is not None and getattr(searcher, "adaptive", False):
            return []  # the controller pulls configs as results arrive
        searcher = searcher or BasicVariantGenerator(
            self.param_space, self.tune_config.num_samples, self.tune_config.seed
        )
        trials = []
        while True:
            tid = new_trial_id()
            cfg = searcher.suggest(tid)
            if cfg is None:
                break
            trials.append(Trial(trial_id=tid, config=cfg))
        if not trials:
            trials = [Trial(trial_id=new_trial_id(), config={})]
        return trials

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.util.usage_stats import record_library_usage

        record_library_usage("tune")
        experiment_dir = self._experiment_dir()
        trials = self._build_trials(experiment_dir)
        controller = TuneController(
            self._trainable_def,
            trials,
            experiment_dir,
            scheduler=self.tune_config.scheduler,
            stop=self.run_config.stop,
            max_concurrent=self.tune_config.max_concurrent_trials,
            checkpoint_frequency=self.tune_config.checkpoint_frequency,
            max_failures=self.run_config.failure_config.max_failures,
            resources_per_trial=self.tune_config.resources_per_trial,
            metric=self.tune_config.metric,
            mode=self.tune_config.mode,
            # non-adaptive searchers enumerated their trials up front
            # but still receive result/complete feedback (the seam's
            # documented contract); the controller gates SUGGESTING on
            # the adaptive flag itself
            searcher=self.tune_config.search_alg,
        )
        controller.run()
        controller.save_experiment_state()
        results = []
        for t in trials:
            err = None
            if t.status == ERROR:
                err = RuntimeError(t.error or "trial failed")
            metrics = dict(t.last_result or {})
            metrics["config"] = t.config
            results.append(
                Result(
                    metrics=metrics,
                    checkpoint=(
                        Checkpoint(t.checkpoint_path) if t.checkpoint_path else None
                    ),
                    error=err,
                    path=t.trial_dir,
                    metrics_history=t.metrics_history,
                )
            )
        grid = ResultGrid(results, experiment_dir)
        grid._default_metric = self.tune_config.metric
        return grid


def _normalize_trainable(trainable):
    from ray_tpu_torch.train.trainer import BaseTrainer

    if isinstance(trainable, BaseTrainer):
        return ("function", wrap_trainer(trainable))
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return ("class", trainable)
    if callable(trainable):
        return ("function", trainable)
    raise TypeError(f"unsupported trainable: {trainable!r}")
