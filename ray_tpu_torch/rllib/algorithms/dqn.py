"""DQN on the new API stack (off-policy, replay buffer, target network).

Reference: `rllib/algorithms/dqn/` (`dqn.py`, `dqn_rainbow_learner.py`)
— reduced to the double-DQN core: epsilon-greedy rollouts feed a uniform
replay buffer; each training iteration runs K gradient steps on replayed
minibatches against a periodically-synced target network.

TD targets are computed OUTSIDE the learner with a target-network
forward (the reference's `jax.jit`, here an eager forward under
`torch.no_grad()` on the learner's device): the learner's update then
depends only on (obs, actions, td_target), which keeps the same
Learner/LearnerGroup machinery as PPO working unchanged (including DDP
sharding — targets are per-row data, not parameters).

The forward runs once or twice an update, 32-64 updates an iteration,
so the port keeps the target params on the device (`TargetNetwork`):
the numpy tree the reference keeps (`target_params`, in the state) is
uploaded only when it is assigned, where the reference re-syncs it,
and the online params once an iteration.  Each update then moves
`next_obs` up and the bootstrap values down.  The loss is a row mean
(the gang's equal shards give the whole batch's update).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    MLPModule, require_discrete_actions, require_flat_obs,
)


class QMLPModule(MLPModule):
    """Q-network: the 'pi' tower outputs Q-values per action (the value
    tower is unused).  Epsilon-greedy exploration lives here so env
    runners stay generic (env_runner.py select_actions_numpy hook)."""

    def select_actions_numpy(self, params_np, obs: np.ndarray, rng,
                             explore) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        q, _ = self.forward_numpy(params_np, obs)
        greedy = q.argmax(axis=-1)
        eps = float(explore or 0.0)
        B = obs.shape[0]
        random_a = rng.integers(0, self.num_actions, B)
        take_random = rng.random(B) < eps
        actions = np.where(take_random, random_a, greedy)
        zeros = np.zeros(B, np.float32)
        return actions, zeros, zeros


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 50_000
        self.learn_batch_size: int = 64
        self.num_updates_per_iter: int = 32
        self.target_update_freq: int = 2  # iterations between target syncs
        self.epsilon_start: float = 1.0
        self.epsilon_end: float = 0.05
        self.epsilon_decay_iters: int = 30
        self.double_q: bool = True
        self.num_env_runners = 1
        self.rollout_fragment_length = 32

    @property
    def algo_class(self):
        return DQN


def make_dqn_loss():
    """Huber TD loss against precomputed targets."""

    def dqn_loss(module, params, batch):
        import torch

        q, _ = module.forward_train(params, batch["obs"])
        qa = q.gather(-1, batch["actions"].long()[:, None])[:, 0]
        err = qa - batch["td_target"]
        huber = torch.where(
            torch.abs(err) <= 1.0, 0.5 * err**2, torch.abs(err) - 0.5
        )
        loss = torch.mean(huber)
        return loss, {"td_error_mean": torch.mean(torch.abs(err)),
                      "q_mean": torch.mean(qa)}

    return dqn_loss


@contextlib.contextmanager
def no_grad_f32():
    """The scope of a target forward: no autograd, and TF32 off as in
    the learner's own forward (the reference computes in f32)."""
    import torch

    from ray_tpu_torch.rllib.core.learner import _full_f32

    with torch.no_grad(), _full_f32():
        yield


class TargetNetwork:
    """Mixin: the target network's params as the reference keeps them
    (a numpy tree, `target_params`, which `get_state` and `set_state`
    carry), with a copy on the learner's device (`_target_dev`) that
    every assignment refreshes.  The target forwards read the copy."""

    @property
    def target_params(self):
        return self._target_np

    @target_params.setter
    def target_params(self, tree):
        self._target_np = tree
        self._target_dev = self._on_learner_device(tree)

    def _on_learner_device(self, tree):
        """A numpy tree as tensors on the learner's device."""
        from ray_tpu_torch.models.bridge import params_from_numpy

        return params_from_numpy(tree, self.learner_group.device)

    def _upload(self, array: np.ndarray):
        import torch

        return torch.from_numpy(np.asarray(array)).to(
            self.learner_group.device)


class ReplayBuffer:
    """Uniform ring buffer of transitions (reference:
    `rllib/utils/replay_buffers/`)."""

    def __init__(self, capacity: int, obs_dim: int, *,
                 action_shape: tuple = (), action_dtype=np.int32):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, *action_shape), action_dtype)
        self.rewards = np.zeros(capacity, np.float32)
        self.terminated = np.zeros(capacity, np.bool_)
        self._next = 0
        self._size = 0

    def __len__(self):
        return self._size

    def add_batch(self, obs, actions, rewards, next_obs, terminated):
        n = obs.shape[0]
        idx = (self._next + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.terminated[idx] = terminated
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, n: int, rng) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self._size, n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "terminated": self.terminated[idx],
        }


def _transitions(sample: Dict[str, np.ndarray]):
    """Rollout [T, B] arrays -> flat (s, a, r, s', term) transitions.
    s' at the rollout edge comes from final_obs; transitions that ended
    in auto-reset still carry terminated correctly (s' unused when
    terminal).  Truncated steps are treated as terminal (standard DQN
    simplification; the Q bootstrap error is bounded by gamma*Qmax)."""
    T, B = sample["actions"].shape[:2]  # [T,B] or [T,B,A] (continuous)
    obs = sample["obs"]
    next_obs = np.concatenate(
        [obs[1:], sample["final_obs"][None]], axis=0
    )
    done = sample["terminated"] | sample["truncated"]
    flat = lambda x: x.reshape(T * B, *x.shape[2:])
    return (
        flat(obs), flat(sample["actions"]), flat(sample["rewards"]),
        flat(next_obs), flat(done),
    )


class DQN(TargetNetwork, Algorithm):
    def setup_components(self):
        from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup

        cfg = self.config
        self.env_runner_group = EnvRunnerGroup(
            cfg.env, cfg.num_env_runners, cfg.num_envs_per_env_runner,
            cfg.rollout_fragment_length, seed=cfg.seed,
            env_kwargs=cfg.env_kwargs,
            connector=cfg.env_to_module_connector,
        )
        spec = self.env_runner_group.env_spec()
        require_flat_obs(spec, "DQN")
        require_discrete_actions(spec, "DQN")
        self.module = QMLPModule(
            spec["observation_size"], spec["num_actions"],
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        self.learner_group = LearnerGroup(
            self.module, make_dqn_loss(), num_learners=cfg.num_learners,
            lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            device=cfg.learner_device,
        )
        self.buffer = ReplayBuffer(cfg.buffer_size, spec["observation_size"])
        self.target_params = self.learner_group.get_weights_numpy()
        self._rng = np.random.default_rng(cfg.seed)
        self._target_q = lambda p, o: self.module.forward_train(p, o)[0]
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def _td_targets(self, batch: Dict[str, np.ndarray],
                    online_params=None) -> np.ndarray:
        """`online_params`: the online tree on the learner's device
        (`training_step` uploads it once an iteration); None reads the
        learner's weights now."""
        cfg = self.config
        next_obs = self._upload(batch["next_obs"])
        with no_grad_f32():
            q_next_target = self._target_q(self._target_dev, next_obs)
            if cfg.double_q:
                online = (
                    online_params
                    if online_params is not None
                    else self._on_learner_device(
                        self.learner_group.get_weights_numpy())
                )
                q_next_online = self._target_q(online, next_obs)
                best = q_next_online.argmax(dim=-1)
                q_next = q_next_target.gather(-1, best[:, None])[:, 0]
            else:
                q_next = q_next_target.max(dim=-1).values
        q_next = q_next.cpu().numpy()
        nonterminal = 1.0 - batch["terminated"].astype(np.float32)
        return (batch["rewards"] + cfg.gamma * q_next * nonterminal).astype(
            np.float32
        )

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        samples = self.env_runner_group.sample(self.module, explore=eps)
        steps = 0
        for s in samples:
            obs, actions, rewards, next_obs, done = _transitions(s)
            self.buffer.add_batch(obs, actions, rewards, next_obs, done)
            steps += len(actions)

        metrics_acc: List[Dict[str, float]] = []
        if len(self.buffer) >= cfg.learn_batch_size:
            # one online-weights fetch per iteration: double-Q argmax
            # tolerates that staleness (same as the runner sync), and
            # per-minibatch fetches would serialize full-weight
            # transfers in the DDP path
            online = self._on_learner_device(
                self.learner_group.get_weights_numpy())
            for _ in range(cfg.num_updates_per_iter):
                replay = self.buffer.sample(cfg.learn_batch_size, self._rng)
                batch = {
                    "obs": replay["obs"],
                    "actions": replay["actions"],
                    "td_target": self._td_targets(replay, online),
                }
                metrics_acc.append(self.learner_group.update_minibatch(batch))
        if (self.iteration + 1) % cfg.target_update_freq == 0:
            self.target_params = self.learner_group.get_weights_numpy()
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )
        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in (metrics_acc[0] if metrics_acc else {})
        }
        result["epsilon"] = eps
        result["num_env_steps_sampled"] = steps
        result["replay_buffer_size"] = len(self.buffer)
        self._track_episode_metrics(
            self.env_runner_group.pop_metrics(), result
        )
        return result

    def get_state(self) -> Dict[str, Any]:
        return {
            "learner": self.learner_group.get_state(),
            "connector": self.env_runner_group.connector_state(),
            "target_params": self.target_params,
            "buffer": self.buffer,
            "rng": self._rng,
            "recent_returns": list(self._recent_returns),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]):
        self.learner_group.set_state(state["learner"])
        self.env_runner_group.restore_connector_state(
            state.get("connector")
        )
        self.target_params = state["target_params"]
        if "buffer" in state:
            self.buffer = state["buffer"]
        if "rng" in state:
            self._rng = state["rng"]
        self._recent_returns = list(state.get("recent_returns", []))
        self.iteration = state.get("iteration", self.iteration)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )

    def stop(self):
        self.env_runner_group.stop()
        self.learner_group.stop()
