"""HuggingFace Transformers integration for TorchTrainer.

Reference: `python/ray/train/huggingface/transformers/` — the modern
shape (`_transformers_utils.py`): the user builds a normal
`transformers.Trainer` inside `train_loop_per_worker`, calls
:func:`prepare_trainer` on it, and adds :class:`RayTrainReportCallback`;
training then runs under the framework's distributed worker group
(torch gloo here) with metrics/checkpoints flowing through
`train.report`.

    def train_loop(config):
        trainer = transformers.Trainer(model, args, ...)
        trainer.add_callback(RayTrainReportCallback())
        trainer = prepare_trainer(trainer)
        trainer.train()

    TorchTrainer(train_loop, scaling_config=ScalingConfig(num_workers=2)).fit()
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

from ray_tpu_torch.train import session as _session
from ray_tpu_torch.train.checkpoint import Checkpoint


class RayTrainReportCallback:
    """`transformers.TrainerCallback` that forwards HF log/save events
    into `train.report` (reference: `RayTrainReportCallback` in
    `train/huggingface/transformers/_transformers_utils.py`).

    Implemented duck-typed (the callback protocol is plain methods), so
    importing this module never requires transformers.
    """

    def __init__(self):
        self._latest_metrics: Dict[str, Any] = {}

    # -- transformers.TrainerCallback protocol (subset) ----------------
    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs:
            self._latest_metrics.update(logs)
            self._latest_metrics["step"] = state.global_step
            self._latest_metrics["epoch"] = state.epoch

    def on_save(self, args, state, control, **kwargs):
        # the checkpoint HF just wrote becomes a framework Checkpoint
        ckpt_dir = os.path.join(
            args.output_dir, f"checkpoint-{state.global_step}"
        )
        checkpoint = (
            Checkpoint.from_directory(ckpt_dir)
            if os.path.isdir(ckpt_dir) else None
        )
        _session.report(dict(self._latest_metrics), checkpoint=checkpoint)

    def on_train_end(self, args, state, control, **kwargs):
        if self._latest_metrics:
            _session.report(dict(self._latest_metrics))

    # unused protocol hooks -------------------------------------------
    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)


def prepare_trainer(trainer):
    """Adapt a `transformers.Trainer` to the distributed worker group:
    pin no-cuda/world-size args to the session's environment and make
    sure a report callback is attached (reference: `prepare_trainer`).
    """
    ctx = _session.get_context()
    args = trainer.args
    # The gloo worker group is CPU; HF resolved device placement when
    # the Trainer was CONSTRUCTED, so flipping use_cpu alone is too
    # late — force the resolved device count to zero and move the
    # model back, or two workers would contend for cuda:0
    if hasattr(args, "use_cpu"):
        args.use_cpu = True
    if hasattr(args, "_n_gpu"):
        args._n_gpu = 0
    model = getattr(trainer, "model", None)
    if model is not None and hasattr(model, "to"):
        try:
            trainer.model = model.to("cpu")
        except Exception:
            pass
    # HF reads the torch.distributed env set up by our backend; make
    # sure per-worker output dirs don't collide — neither across ranks
    # on shared filesystems nor across concurrent runs on one machine
    if ctx.world_size > 1 and ctx.world_rank != 0:
        args.output_dir = tempfile.mkdtemp(
            prefix=f"hf_worker_{ctx.world_rank}_"
        )
    handler = getattr(trainer, "callback_handler", None)
    has_report = handler is not None and any(
        isinstance(cb, RayTrainReportCallback) for cb in handler.callbacks
    )
    if not has_report:
        trainer.add_callback(RayTrainReportCallback())
    return trainer
