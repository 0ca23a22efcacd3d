"""CQL: conservative Q-learning from OFFLINE data (discrete).

Reference: `rllib/algorithms/cql/` + the offline-RL input pipeline
(`rllib/offline/`).  No env runners: the algorithm trains purely from a
logged transition dataset — double-DQN TD learning plus the CQL
regularizer `E[logsumexp_a Q(s,a) - Q(s, a_data)]`, which pushes Q down
on actions the behavior policy never took (the out-of-distribution
overestimation offline RL must suppress).

Dataset format (numpy arrays or an .npz path):
    obs [N, D] f32, actions [N] int, rewards [N] f32,
    next_obs [N, D] f32, terminated [N] bool
Evaluation (optional, `evaluation_env`): greedy rollouts in a real env
report `evaluation_return_mean` — the offline metric that matters.

The loss is torch on the learner's device (`jax.scipy.special.logsumexp`
is `torch.logsumexp`); every term is a row mean, the conservatism gap
included (the mean over rows of each row's logsumexp less its logged
Q), so the gang's equal shards give the whole batch's update.  The
double-DQN targets come from DQN's eager no-grad forward against the
target params kept on the device (`dqn.TargetNetwork`).  One departure:
a dataset of image observations fails at setup (`require_flat_obs`, as
DQN and SAC fail), where the reference's QMLPModule would take the
image's height for its input width and fail in the first update.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import (
    QMLPModule,
    TargetNetwork,
    no_grad_f32,
)
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import require_flat_obs


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.cql_alpha: float = 1.0  # conservatism weight
        self.learn_batch_size: int = 256
        self.num_updates_per_iter: int = 64
        self.target_update_freq: int = 1
        self.input_: Any = None  # dict of arrays or .npz path
        self.evaluation_env: Any = None
        self.evaluation_episodes: int = 5
        self.evaluation_interval: int = 1  # iterations between evals

    def offline_data(self, *, input_: Any = None, **kwargs) -> "CQLConfig":
        """Fluent section, same surface as BCConfig.offline_data
        (reference: `AlgorithmConfig.offline_data`)."""
        if input_ is not None:
            self.input_ = input_
        self._apply(kwargs)
        return self

    def evaluation(self, *, evaluation_env=None, evaluation_episodes=None,
                   evaluation_interval=None, **kwargs) -> "CQLConfig":
        if evaluation_env is not None:
            self.evaluation_env = evaluation_env
        if evaluation_episodes is not None:
            self.evaluation_episodes = evaluation_episodes
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        self._apply(kwargs)
        return self

    @property
    def algo_class(self):
        return CQL


def make_cql_loss(cql_alpha: float):
    def cql_loss(module, params, batch):
        import torch

        q, _ = module.forward_train(params, batch["obs"])
        actions = batch["actions"].long()
        qa = q.gather(-1, actions[:, None])[:, 0]
        td = torch.mean((qa - batch["td_target"]) ** 2)
        # conservatism: push down the soft-max over ALL actions, hold
        # up the logged action
        conservative = torch.mean(torch.logsumexp(q, dim=-1) - qa)
        total = td + cql_alpha * conservative
        return total, {
            "td_loss": td,
            "cql_gap": conservative,
            "q_data_mean": torch.mean(qa),
        }

    return cql_loss


def _load_dataset(input_data) -> Dict[str, np.ndarray]:
    import os

    if isinstance(input_data, (str, bytes, os.PathLike)):
        with np.load(input_data) as z:
            data = {k: z[k] for k in z.files}
    else:
        data = dict(input_data)
    need = {"obs", "actions", "rewards", "next_obs", "terminated"}
    missing = need - set(data)
    if missing:
        raise ValueError(f"offline dataset missing fields {sorted(missing)}")
    return data


class CQL(TargetNetwork, Algorithm):
    def setup_components(self):
        cfg = self.config
        if cfg.input_ is None:
            raise ValueError("CQL needs config.offline_data(input_=...)")
        self.dataset = _load_dataset(cfg.input_)
        require_flat_obs({"observation_shape": self.dataset["obs"].shape[1:],
                          "observation_size": None}, "CQL")
        obs_dim = self.dataset["obs"].shape[1]
        num_actions = int(self.dataset["actions"].max()) + 1
        self._eval_env = None
        if cfg.evaluation_env is not None:
            # the env is authoritative on the action space: a dataset
            # whose behavior policy never logged the top action must
            # not truncate the Q-head (same guard as BC)
            from ray_tpu_torch.rllib.env.envs import make_vector_env

            self._eval_env = make_vector_env(
                cfg.evaluation_env, 1, seed=cfg.seed + 999
            )
            num_actions = max(num_actions, self._eval_env.num_actions)
        self.module = QMLPModule(
            obs_dim, num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        self.learner_group = LearnerGroup(
            self.module, make_cql_loss(cfg.cql_alpha),
            num_learners=cfg.num_learners, lr=cfg.lr,
            grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            device=cfg.learner_device,
        )
        self.target_params = self.learner_group.get_weights_numpy()
        self._rng = np.random.default_rng(cfg.seed)
        self._q = lambda p, o: self.module.forward_train(p, o)[0]

    def _td_targets(self, idx, online) -> np.ndarray:
        """`online`: the online tree on the learner's device
        (`training_step` uploads it once an iteration)."""
        cfg = self.config
        next_obs = self._upload(self.dataset["next_obs"][idx])
        with no_grad_f32():
            q_next_t = self._q(self._target_dev, next_obs)
            q_next_o = self._q(online, next_obs)
            best = q_next_o.argmax(dim=-1)
            q_next = q_next_t.gather(-1, best[:, None])[:, 0]
        q_next = q_next.cpu().numpy()
        nonterminal = 1.0 - self.dataset["terminated"][idx].astype(np.float32)
        return (
            self.dataset["rewards"][idx] + cfg.gamma * q_next * nonterminal
        ).astype(np.float32)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self.dataset["actions"])
        metrics_acc: List[Dict[str, float]] = []
        online = self._on_learner_device(
            self.learner_group.get_weights_numpy())
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, n, cfg.learn_batch_size)
            batch = {
                "obs": self.dataset["obs"][idx],
                "actions": self.dataset["actions"][idx],
                "td_target": self._td_targets(idx, online),
            }
            metrics_acc.append(self.learner_group.update_minibatch(batch))
        if (self.iteration + 1) % cfg.target_update_freq == 0:
            self.target_params = self.learner_group.get_weights_numpy()
        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in metrics_acc[0]
        }
        result["num_train_steps"] = (
            cfg.num_updates_per_iter * cfg.learn_batch_size
        )
        if (
            self._eval_env is not None
            and cfg.evaluation_interval > 0
            and (self.iteration + 1) % cfg.evaluation_interval == 0
        ):
            result["evaluation_return_mean"] = self.evaluate()
        return result

    def evaluate(self) -> float:
        """Greedy rollouts in the (setup-time) evaluation env."""
        cfg = self.config
        env = self._eval_env
        weights = self.learner_group.get_weights_numpy()
        returns = []
        for _ in range(cfg.evaluation_episodes):
            obs = env.reset()
            total, done = 0.0, False
            for _step in range(1000):
                q, _ = self.module.forward_numpy(weights, obs)
                a = q.argmax(axis=-1).astype(np.int32)
                obs, r, term, trunc, _ = env.step(a)
                total += float(r[0])
                if bool(term[0] or trunc[0]):
                    break
            returns.append(total)
        return float(np.mean(returns))

    def get_state(self) -> Dict[str, Any]:
        return {
            "learner": self.learner_group.get_state(),
            "target_params": self.target_params,
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]):
        self.learner_group.set_state(state["learner"])
        self.target_params = state["target_params"]
        self.iteration = state.get("iteration", self.iteration)

    def stop(self):
        self.learner_group.stop()
