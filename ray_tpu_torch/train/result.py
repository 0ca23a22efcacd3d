"""Result of a training/tuning run (reference: `air/result.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: str = ""
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    best_checkpoints: List[Any] = field(default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")

    def __repr__(self):
        err = f", error={type(self.error).__name__}" if self.error else ""
        return f"Result(metrics={self.metrics}{err}, path={self.path!r})"
