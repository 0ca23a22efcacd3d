"""TuneController: the trial-driving event loop.

Reference: `tune/execution/tune_controller.py:68` — manages trial
actors (`_schedule_trial_train:1470`, save `:1691`, restore `:1791`),
applies scheduler decisions, checkpoints experiment state for resume.
Trials run as actors; one in-flight step() call per running trial,
collected with rt.wait — the same actor-event-driven shape, without the
reference's separate actor-manager layer.
"""

from __future__ import annotations

import json
import os
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

import ray_tpu_torch as rt
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.trainable import FunctionTrainable, Trainable

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class _TrialActor:
    """Actor hosting one trainable instance."""

    def __init__(self, trainable_def, config: Dict[str, Any], trial_dir: str,
                 restore_from: Optional[str] = None):
        kind, obj = trainable_def
        os.makedirs(trial_dir, exist_ok=True)
        ckpt = Checkpoint(restore_from) if restore_from else None
        if kind == "function":
            self._t = FunctionTrainable(obj, config, trial_dir, checkpoint=ckpt)
        else:
            self._t = obj(config, trial_dir)
            if ckpt is not None:
                state = None
                try:
                    state = ckpt.to_dict()
                except Exception:
                    pass
                self._t.load_checkpoint(state if state is not None else ckpt.path)
        if restore_from:
            # training_iteration continues from where the checkpoint was
            # taken (reference: Trainable.restore replays _iteration
            # from the checkpoint metadata) — otherwise stop criteria,
            # checkpoint numbering, and ASHA rungs would run backwards
            # after fault-tolerance restore
            meta = os.path.join(restore_from, ".tune_metadata")
            try:
                with open(meta) as f:
                    self._t.iteration = json.load(f).get("iteration", 0)
            except (OSError, ValueError):
                # missing or corrupt metadata degrades to a reset
                # counter — never to a failed restore
                pass

    def step(self) -> Dict[str, Any]:
        return self._t.train()

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state = self._t.save_checkpoint(checkpoint_dir)
        if state is not None:
            Checkpoint.from_dict(state).to_directory(checkpoint_dir)
        meta = os.path.join(checkpoint_dir, ".tune_metadata")
        with open(meta + ".tmp", "w") as f:
            json.dump({"iteration": self._t.checkpoint_iteration}, f)
        os.replace(meta + ".tmp", meta)
        return checkpoint_dir

    def cleanup(self):
        try:
            self._t.cleanup()
        except Exception:
            pass
        return True


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    last_result: Optional[Dict[str, Any]] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    rungs_passed: Set[int] = field(default_factory=set)
    rung_values: Dict[int, float] = field(default_factory=dict)
    restore_from: Optional[str] = None
    actor: Any = None
    inflight: Any = None
    trial_dir: str = ""
    failures: int = 0
    start_retries: int = 0  # resource-wait retries; distinct from the
    # fault-tolerance failure budget

    def runnable(self) -> bool:
        return self.status == PENDING


class TuneController:
    def __init__(
        self,
        trainable_def,
        trials: List[Trial],
        experiment_dir: str,
        *,
        scheduler: Optional[TrialScheduler] = None,
        stop: Optional[Dict[str, Any]] = None,
        max_concurrent: int = 4,
        checkpoint_frequency: int = 0,
        max_failures: int = 0,
        resources_per_trial: Optional[Dict[str, float]] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        on_result: Optional[Callable[[Trial, Dict], None]] = None,
        searcher=None,
    ):
        # an adaptive searcher supplies new trial configs lazily as
        # results arrive (reference: SearchGenerator feeding
        # TuneController); a pre-generated trial list leaves it None
        self.searcher = searcher
        # exhausted searchers stop SUGGESTING but keep receiving
        # result/complete feedback for their still-running trials.
        # Non-adaptive searchers were fully enumerated by the Tuner
        # already — feedback only, never pulled.
        self._search_exhausted = not getattr(searcher, "adaptive", False)
        self.trainable_def = trainable_def
        self.trials = trials
        self.experiment_dir = experiment_dir
        self.scheduler = scheduler or FIFOScheduler()
        self.stop_criteria = stop or {}
        self.max_concurrent = max_concurrent
        self.checkpoint_frequency = checkpoint_frequency
        self.max_failures = max_failures
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.metric = metric
        self.mode = mode
        self.on_result = on_result
        os.makedirs(experiment_dir, exist_ok=True)

    # ---- trial lifecycle --------------------------------------------
    def _start_trial(self, trial: Trial):
        res = dict(self.resources)
        opts = {
            "num_cpus": res.pop("CPU", 1.0),
            "num_gpus": res.pop("GPU", 0.0),
            "max_concurrency": 2,
        }
        if res:
            opts["resources"] = res
        trial.trial_dir = trial.trial_dir or os.path.join(
            self.experiment_dir, trial.trial_id
        )
        trial.actor = rt.remote(_TrialActor).options(**opts).remote(
            self.trainable_def, trial.config, trial.trial_dir, trial.restore_from
        )
        trial.status = RUNNING
        trial.inflight = trial.actor.step.remote()

    def _stop_trial(self, trial: Trial, status: str, error: Optional[str] = None):
        trial.status = status
        trial.error = error
        trial.inflight = None
        if trial.actor is not None:
            actor = trial.actor
            trial.actor = None
            try:
                actor.cleanup.remote()
                rt.kill(actor)
            except Exception:
                pass

    def _save_trial_checkpoint(self, trial: Trial) -> Optional[str]:
        it = (trial.last_result or {}).get("training_iteration", 0)
        dest = os.path.join(trial.trial_dir, f"checkpoint_{it:06d}")
        try:
            path = rt.get(trial.actor.save.remote(dest))
            trial.checkpoint_path = path
            return path
        except Exception:
            return None

    def _should_stop_result(self, result: Dict[str, Any]) -> bool:
        for k, v in self.stop_criteria.items():
            if k in result and result[k] >= v:
                return True
        return False

    # ---- PBT exploit/explore ----------------------------------------
    def _maybe_exploit(self, trial: Trial) -> bool:
        donor = self.scheduler.choose_exploit(
            trial, [t for t in self.trials if t.status == RUNNING]
        )
        if donor is None or donor is trial or donor.actor is None:
            return False
        donor_ckpt = self._save_trial_checkpoint_for(donor)
        if donor_ckpt is None:
            return False
        new_config = self.scheduler.explore(donor.config)
        self._stop_trial(trial, PENDING)
        trial.config = new_config
        trial.restore_from = donor_ckpt
        trial.rungs_passed = set()
        trial.rung_values = {}
        return True

    def _save_trial_checkpoint_for(self, donor: Trial) -> Optional[str]:
        it = (donor.last_result or {}).get("training_iteration", 0)
        dest = os.path.join(donor.trial_dir, f"checkpoint_{it:06d}")
        try:
            return rt.get(donor.actor.save.remote(dest))
        except Exception:
            return None

    # ---- experiment state (resume) ----------------------------------
    def save_experiment_state(self):
        state = [
            {
                "trial_id": t.trial_id,
                "config": _jsonable(t.config),
                "status": t.status,
                "last_result": _jsonable(t.last_result),
                "metrics_history": _jsonable(t.metrics_history),
                "checkpoint_path": t.checkpoint_path,
                "error": t.error,
                "trial_dir": t.trial_dir,
            }
            for t in self.trials
        ]
        tmp = os.path.join(self.experiment_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump({"trials": state, "timestamp": time.time()}, f)
        os.replace(tmp, os.path.join(self.experiment_dir, "experiment_state.json"))

    # ---- event loop --------------------------------------------------
    def run(self):
        while True:
            running = [t for t in self.trials if t.status == RUNNING]
            pending = [t for t in self.trials if t.status == PENDING]
            # adaptive search: pull fresh configs once capacity frees
            while (
                self.searcher is not None
                and not self._search_exhausted
                and len(running) + len(pending) < self.max_concurrent
            ):
                tid = new_trial_id()
                cfg = self.searcher.suggest(tid)
                if cfg is None:
                    self._search_exhausted = True
                    break
                t = Trial(trial_id=tid, config=cfg)
                self.trials.append(t)
                pending.append(t)
            if not running and not pending:
                break
            while pending and len(running) < self.max_concurrent:
                t = pending.pop(0)
                try:
                    self._start_trial(t)
                    t.start_retries = 0  # budget is per start attempt
                    running.append(t)
                except Exception as e:
                    if any(m in str(e) for m in (
                        "insufficient resources",
                        "resources no longer available",
                        "no idle worker",
                        "infeasible",
                    )):
                        # resources from just-killed trial actors free
                        # asynchronously: stay PENDING and retry for a
                        # bounded window before declaring the request
                        # genuinely unsatisfiable (separate counter: the
                        # user's max_failures budget is for real crashes)
                        t.start_retries += 1
                        if t.start_retries <= 150:  # ~30s of 0.2s passes
                            t.status = PENDING
                            time.sleep(0.2)
                            break
                    self._stop_trial(t, ERROR, f"failed to start: {e}")
                    if self.searcher is not None:
                        self.searcher.on_trial_complete(
                            t.trial_id, None, error=True
                        )
            refs = [t.inflight for t in running if t.inflight is not None]
            if not refs:
                time.sleep(0.01)
                continue
            ready, _ = rt.wait(refs, num_returns=1, timeout=5.0)
            for ref in ready:
                trial = next(t for t in running if t.inflight is ref)
                self._process_trial_step(trial)
            self.save_experiment_state()

    def _process_trial_step(self, trial: Trial):
        try:
            result = rt.get(trial.inflight)
        except Exception as e:
            trial.failures += 1
            tb = traceback.format_exc()
            if trial.failures <= self.max_failures:
                self._stop_trial(trial, PENDING)
                trial.restore_from = trial.checkpoint_path
            else:
                self._stop_trial(trial, ERROR, f"{e}\n{tb}")
                self.scheduler.on_trial_complete(trial, None)
                if self.searcher is not None:
                    self.searcher.on_trial_complete(
                        trial.trial_id, None, error=True
                    )
            return
        if result.get("done"):
            if trial.checkpoint_path is None or self.checkpoint_frequency:
                self._save_trial_checkpoint(trial)
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial, trial.last_result)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, trial.last_result)
            return
        trial.last_result = result
        trial.metrics_history.append(result)
        if self.searcher is not None:
            # intermediate feedback for multi-fidelity searchers (BOHB
            # fits its model on the largest budget with enough points)
            try:
                self.searcher.on_trial_result(trial.trial_id, result)
            except Exception:
                # a broken feedback channel silently degrades a
                # model-based search to random — warn once, loudly
                if not getattr(self, "_searcher_feedback_warned", False):
                    self._searcher_feedback_warned = True
                    import traceback as _tb

                    print("WARNING: searcher.on_trial_result raised; "
                          "search feedback disabled for this error:\n"
                          + _tb.format_exc())
        if self.on_result is not None:
            self.on_result(trial, result)
        it = result.get("training_iteration", 0)
        if self.checkpoint_frequency and it % self.checkpoint_frequency == 0:
            self._save_trial_checkpoint(trial)
        if self._should_stop_result(result):
            self._save_trial_checkpoint(trial)
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial, result)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, result)
            return
        decision = self.scheduler.on_trial_result(trial, result)
        if decision == STOP:
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial, result)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, result)
            return
        if self._maybe_exploit(trial):
            return  # back to PENDING with new config + donor checkpoint
        trial.inflight = trial.actor.step.remote()


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        if isinstance(x, dict):
            return {k: _jsonable(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [_jsonable(v) for v in x]
        return repr(x)


def new_trial_id() -> str:
    return uuid.uuid4().hex[:8]
