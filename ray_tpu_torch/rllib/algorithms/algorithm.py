"""Algorithm: the outer training loop object.

Reference: `rllib/algorithms/algorithm.py` (`step():881`) — an Algorithm
is a Tune Trainable whose step() runs one training iteration (sample →
learn → sync), and which checkpoints its learner + config state
(reference: `Checkpointable`, `rllib/utils/checkpoints.py`).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.tune.trainable import Trainable


class Algorithm(Trainable):
    """Subclasses implement setup_components() and training_step()."""

    config: AlgorithmConfig

    def __init__(self, config: AlgorithmConfig, trial_dir: str = ""):
        self._algo_config = config
        self._recent_returns: List[float] = []
        # Trainable.__init__ calls self.setup(...)
        super().__init__({}, trial_dir or "/tmp/ray_tpu_rllib")

    def setup(self, _config: Dict[str, Any]):
        self.config = self._algo_config
        self.setup_components()

    def setup_components(self):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- Trainable contract -------------------------------------------
    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step()
        result.setdefault("time_this_iter_s", time.time() - t0)
        return result

    def train(self) -> Dict[str, Any]:
        return super().train()

    def _track_episode_metrics(self, episodes: List[Dict[str, float]],
                               result: Dict[str, Any]):
        for ep in episodes:
            self._recent_returns.append(ep["episode_return"])
        self._recent_returns = self._recent_returns[-100:]
        if self._recent_returns:
            result["episode_return_mean"] = float(
                np.mean(self._recent_returns)
            )
            result["num_episodes"] = len(episodes)

    # -- checkpointing (reference: Checkpointable mixin) ---------------
    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        state = self.get_state()
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)
        return None

    def load_checkpoint(self, checkpoint) -> None:
        path = checkpoint if isinstance(checkpoint, str) else None
        if path is None:
            return
        from ray_tpu_torch.core import serialization

        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            # local checkpoint, but decode still routes through the
            # audited unpickle chokepoint
            self.set_state(serialization.loads(f.read()))

    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]):
        raise NotImplementedError

    def stop(self):
        pass

    def cleanup(self):
        self.stop()
