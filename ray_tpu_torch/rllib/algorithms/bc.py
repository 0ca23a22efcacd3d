"""BC: behavior cloning from offline data (the offline-RL entry point).

Reference: `rllib/algorithms/bc/` (`bc.py`, `bc_learner.py`,
`bc_torch_learner.py`) atop the offline-data pipeline
(`rllib/offline/`) — supervised negative-log-likelihood of the logged
actions, no environment interaction during training.

Offline input shapes accepted (the `rllib/offline/` reader surface,
reduced):
- a dict of arrays {"obs": [N, obs], "actions": [N]},
- a list of such dicts (episode batches are concatenated),
- a `ray_tpu_torch.data.Dataset` of row-dicts {"obs": ..., "action(s)": ...}.

Evaluation (episode-return tracking) runs the cloned policy in the
configured env with a small runner group, mirroring the reference's
`evaluation_interval` behavior.

The loss is torch on the learner's device, its terms row means (the
gang's equal shards give the whole batch's update).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    MLPModule, require_discrete_actions, require_flat_obs,
)


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.input_: Any = None  # offline data (see module docstring)
        self.minibatch_size = 256
        self.num_updates_per_iter: int = 32
        self.evaluation_interval: int = 0  # 0 = no env evaluation
        self.num_env_runners = 1

    def offline_data(self, *, input_: Any = None, **kwargs) -> "BCConfig":
        """Fluent section (reference: `AlgorithmConfig.offline_data`)."""
        if input_ is not None:
            self.input_ = input_
        self._apply(kwargs)
        return self

    @property
    def algo_class(self):
        return BC


def bc_loss(module, params, batch):
    """NLL of logged actions (reference: `bc_learner.py` — the policy
    head trained as a classifier; the value tower is unused)."""
    import torch

    logits, _ = module.forward_train(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    actions = batch["actions"].long()
    logp = logp_all.gather(-1, actions[:, None])[:, 0]
    loss = -torch.mean(logp)
    accuracy = torch.mean(
        (torch.argmax(logits, dim=-1) == actions).to(torch.float32)
    )
    return loss, {"bc_loss": loss, "action_accuracy": accuracy}


def _coerce_offline(input_: Any) -> Dict[str, np.ndarray]:
    if input_ is None:
        raise ValueError("BC requires config.offline_data(input_=...)")
    if isinstance(input_, dict):
        batches = [input_]
    elif isinstance(input_, list) and input_ and isinstance(input_[0], dict) \
            and "obs" in input_[0] and np.ndim(input_[0]["obs"]) >= 2:
        batches = input_
    else:
        # Dataset (or iterable) of row-dicts
        rows = input_.take_all() if hasattr(input_, "take_all") else list(input_)
        obs = np.asarray([r["obs"] for r in rows], np.float32)
        act_key = "actions" if "actions" in rows[0] else "action"
        actions = np.asarray([r[act_key] for r in rows])
        batches = [{"obs": obs, "actions": actions}]
    obs = np.concatenate([np.asarray(b["obs"], np.float32) for b in batches])
    actions = np.concatenate([np.asarray(b["actions"]) for b in batches])
    if obs.shape[0] != actions.shape[0]:
        raise ValueError("offline obs/actions length mismatch")
    return {"obs": obs, "actions": actions.astype(np.int32)}


class BC(Algorithm):
    # subclass hooks (MARWIL swaps both without rebuilding the learner)
    def _loss_fn(self):
        return bc_loss

    def _prepare_dataset(self):
        return _coerce_offline(self.config.input_)

    def setup_components(self):
        cfg = self.config
        self.dataset = self._prepare_dataset()
        obs_dim = self.dataset["obs"].shape[1]
        num_actions = int(self.dataset["actions"].max()) + 1
        self.env_runner_group = None
        if cfg.evaluation_interval > 0:
            from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup

            self.env_runner_group = EnvRunnerGroup(
                cfg.env, cfg.num_env_runners, cfg.num_envs_per_env_runner,
                cfg.rollout_fragment_length, seed=cfg.seed,
                env_kwargs=cfg.env_kwargs,
                connector=cfg.env_to_module_connector,
            )
            spec = self.env_runner_group.env_spec()
            require_flat_obs(spec, "BC/MARWIL")
            require_discrete_actions(spec, "BC/MARWIL")
            obs_dim = spec["observation_size"]
            num_actions = max(num_actions, spec["num_actions"])
        self.module = MLPModule(
            obs_dim, num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        self.learner_group = LearnerGroup(
            self.module, self._loss_fn(), num_learners=cfg.num_learners,
            lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            device=cfg.learner_device,
        )
        self._rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = self.dataset["obs"].shape[0]
        mb = min(cfg.minibatch_size, n)
        metrics_acc: List[Dict[str, float]] = []
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, n, mb)
            metrics_acc.append(self.learner_group.update_minibatch({
                "obs": self.dataset["obs"][idx],
                "actions": self.dataset["actions"][idx],
            }))
        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in metrics_acc[0]
        }
        result["num_offline_steps_trained"] = mb * cfg.num_updates_per_iter
        if (
            self.env_runner_group is not None
            and (self.iteration + 1) % cfg.evaluation_interval == 0
        ):
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights_numpy()
            )
            self.env_runner_group.sample(self.module)
            self._track_episode_metrics(
                self.env_runner_group.pop_metrics(), result
            )
        return result

    def get_state(self) -> Dict[str, Any]:
        state = {
            "learner": self.learner_group.get_state(),
            "rng": self._rng,
            "iteration": self.iteration,
        }
        if self.env_runner_group is not None:
            # a restored offline run must keep its obs-filter statistics
            # (MeanStdObsFilter): losing them silently changes the
            # policy's effective inputs at evaluation time
            state["connector"] = self.env_runner_group.connector_state()
        return state

    def set_state(self, state: Dict[str, Any]):
        self.learner_group.set_state(state["learner"])
        if "rng" in state:
            self._rng = state["rng"]
        if self.env_runner_group is not None:
            self.env_runner_group.restore_connector_state(
                state.get("connector")
            )
        self.iteration = state.get("iteration", self.iteration)

    def stop(self):
        if self.env_runner_group is not None:
            self.env_runner_group.stop()
        self.learner_group.stop()
