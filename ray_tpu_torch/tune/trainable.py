"""Trainable: the unit a trial runs.

Reference: `tune/trainable/trainable.py:58` (class API: setup/step/
save_checkpoint/load_checkpoint) and `tune/trainable/function_trainable.py`
(function API reporting via the session).  `wrap_trainer` is the
reference's `BaseTrainer.as_trainable` (`train/base_trainer.py:819`):
a JaxTrainer runs inside a trial as a function trainable whose inner
worker group does the real SPMD work.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import _Session, _set_session, _TrainingResult, TrainContext


class Trainable:
    """Class API: subclass and override setup/step/save/load."""

    def __init__(self, config: Dict[str, Any], trial_dir: str = ""):
        self.config = config
        self.trial_dir = trial_dir
        self.iteration = 0
        self.setup(config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        """One training call: runs step() and maintains the iteration
        counter (reference: `trainable.py:290` Trainable.train)."""
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("done", False)
        return result

    @property
    def checkpoint_iteration(self) -> int:
        """Iteration the next save_checkpoint() reflects — for the class
        API that is the live counter (checkpoints snapshot live state)."""
        return self.iteration

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return None

    def load_checkpoint(self, checkpoint: Optional[Dict]) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        return False  # not resettable by default -> actor recreated


class FunctionTrainable:
    """Runs `fn(config)` in a session thread; step() pulls reports.

    The same queue discipline as the Train worker session
    (`train/_internal/session.py` in the reference).
    """

    def __init__(self, fn: Callable, config: Dict[str, Any], trial_dir: str,
                 checkpoint: Optional[Checkpoint] = None):
        self.config = config
        self.trial_dir = trial_dir
        self.iteration = 0
        self._session = _Session(TrainContext(trial_name=os.path.basename(trial_dir)),
                                 checkpoint)
        self._last_checkpoint: Optional[Checkpoint] = checkpoint
        self._last_checkpoint_iteration = 0
        self._fn = fn
        self._thread: Optional[threading.Thread] = None

    def _ensure_started(self):
        if self._thread is not None:
            return

        def _run():
            _set_session(self._session)
            try:
                self._fn(self.config)
                self._session.result_queue.put(_TrainingResult(done=True))
            except StopIteration:
                self._session.result_queue.put(_TrainingResult(done=True))
            except BaseException as e:  # noqa: BLE001
                import traceback

                e._rt_traceback = traceback.format_exc()  # type: ignore
                self._session.result_queue.put(_TrainingResult(done=True, error=e))
            finally:
                _set_session(None)

        self._thread = threading.Thread(target=_run, daemon=True, name="tune_fn")
        self._thread.start()

    def step(self) -> Dict[str, Any]:
        self._ensure_started()
        res = self._session.result_queue.get()
        if res.error is not None:
            raise res.error
        if res.done:
            return {"done": True}
        self.iteration += 1
        if res.checkpoint is not None:
            self._last_checkpoint = res.checkpoint
            self._last_checkpoint_iteration = self.iteration
        out = dict(res.metrics or {})
        out.setdefault("done", False)
        return out

    def train(self) -> Dict[str, Any]:
        # unlike Trainable.train(), no increment here: step() already
        # advanced the counter when it pulled the session report
        out = self.step()
        out.setdefault("training_iteration", self.iteration)
        return out

    @property
    def checkpoint_iteration(self) -> int:
        """Iteration of the checkpoint save_checkpoint() will persist —
        the last one the user fn attached, NOT the live counter (the fn
        may report several iterations between checkpoints)."""
        return self._last_checkpoint_iteration

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        if self._last_checkpoint is not None:
            self._last_checkpoint.to_directory(checkpoint_dir)
        return None

    def load_checkpoint(self, checkpoint) -> None:
        pass  # function trainables restore via session.get_checkpoint

    def stop(self):
        self._session.stop_requested.set()

    def cleanup(self):
        self.stop()


def wrap_trainer(trainer) -> Callable:
    """Reference `base_trainer.py:819` as_trainable: run the trainer's
    fit loop inside a trial, forwarding per-iteration reports.  The
    param_space entry `train_loop_config` overrides the trainer's."""
    from ray_tpu_torch.train import session as train_session

    def _trainable(config: Dict[str, Any]):
        import copy

        t = copy.copy(trainer)
        if "train_loop_config" in config:
            t.train_loop_config = config["train_loop_config"]
        elif config:
            merged = dict(t.train_loop_config or {})
            merged.update(config)
            t.train_loop_config = merged
        # re-report each inner iteration to the trial as it happens
        def _forward(metrics: Dict[str, Any], persisted: Optional[Checkpoint]):
            ck = Checkpoint(persisted.path) if persisted is not None else None
            train_session.report(dict(metrics), checkpoint=ck)

        t._result_callback = _forward
        result = t.fit()
        if result.error is not None:
            raise result.error

    _trainable.__name__ = type(trainer).__name__
    return _trainable
