"""SAC for discrete AND continuous action spaces (new API stack).

Reference: `rllib/algorithms/sac/` (`sac.py`, `sac_learner.py`).
Both variants share the recipe: twin Q networks with a polyak-free
periodic target sync, automatically-tuned entropy temperature
(log_alpha is a learned parameter in the same tree, so the single
learner update covers actor + critics + alpha).  Discrete
envs get the standard discrete-SAC variant (expected Q under the full
softmax policy); continuous envs (`VectorEnv.continuous`) get the
original SAC: tanh-squashed reparameterized Gaussian actor and
Q(s, a) critics (`ContinuousSACModule`).

TD targets are computed OUTSIDE the learner with target-network
forwards (the DQN pattern here: eager, under `torch.no_grad()`, on the
learner's device, the target params kept there by `TargetNetwork`):
the update depends only on (obs, actions, td_target), keeping
Learner/LearnerGroup unchanged.  The reparameterisation noise is drawn
from the driver's numpy `rng` and rides in the batch (`noise`), as in
the reference.  The reference's `stop_gradient`s are `.detach()` at
the same places; the actor's critics read a detached copy of the whole
tree.  Every term of both losses is a row mean (`log_alpha` is one
scalar leaf), so the gang's equal shards give the whole batch's
update.

Inits cannot match the reference's (`jax.random.split` three ways
against one `torch.Generator`, drawn pi, q1, q2 in turn): parity tests
start from bridged params.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import (
    ReplayBuffer,
    TargetNetwork,
    _transitions,
    no_grad_f32,
)
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import MLPModule, require_flat_obs


class SACModule(MLPModule):
    """pi tower = policy logits; twin critics q1/q2 (one Q per action);
    log_alpha rides the pytree so one optimizer updates everything."""

    def init_params(self, generator) -> Dict[str, Any]:
        import torch

        return {
            "pi": self.init_tower(generator, self.num_actions),
            "q1": self.init_tower(generator, self.num_actions),
            "q2": self.init_tower(generator, self.num_actions),
            "log_alpha": torch.zeros(()),
        }

    def forward_train(self, params, obs):
        import torch

        from ray_tpu_torch.rllib.core.rl_module import tower_torch

        return tower_torch(params["pi"], obs), torch.zeros(
            obs.shape[0], device=obs.device)

    def q_values(self, params, obs):
        from ray_tpu_torch.rllib.core.rl_module import tower_torch

        return tower_torch(params["q1"], obs), tower_torch(params["q2"], obs)

    def forward_numpy(self, params_np, obs: np.ndarray):
        from ray_tpu_torch.rllib.core.rl_module import tower_numpy

        return (tower_numpy(params_np["pi"], obs),
                np.zeros(obs.shape[0], np.float32))


LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class ContinuousSACModule(MLPModule):
    """Squashed-Gaussian actor + twin state-action critics (reference:
    `rllib/algorithms/sac/sac_learner.py` continuous path, matching the
    original SAC: tanh-squashed reparameterized policy, Q(s, a) MLPs).

    Actions live in [-1, 1]^A at the module boundary; the EnvRunner
    rescales to the env's bounds.  The pi tower outputs (mu, log_std);
    q towers take concat(obs, action).
    """

    def __init__(self, observation_size: int, action_dim: int,
                 hidden=(64, 64)):
        # num_actions doubles as the pi tower's output size (mu+logstd)
        super().__init__(observation_size, 2 * action_dim, hidden=hidden)
        self.action_dim = action_dim

    def init_params(self, generator) -> Dict[str, Any]:
        import torch

        q_in = self.observation_size + self.action_dim
        q_tower = MLPModule(q_in, 1, hidden=self.hidden)
        return {
            "pi": self.init_tower(generator, 2 * self.action_dim),
            "q1": q_tower.init_tower(generator, 1),
            "q2": q_tower.init_tower(generator, 1),
            "log_alpha": torch.zeros(()),
        }

    # -- torch ---------------------------------------------------------
    def actor(self, params, obs):
        import torch

        from ray_tpu_torch.rllib.core.rl_module import tower_torch

        out = tower_torch(params["pi"], obs)
        mu, log_std = torch.chunk(out, 2, dim=-1)
        return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def q_values(self, params, obs, actions):
        import torch

        from ray_tpu_torch.rllib.core.rl_module import tower_torch

        sa = torch.cat([obs, actions], dim=-1)
        return (tower_torch(params["q1"], sa)[..., 0],
                tower_torch(params["q2"], sa)[..., 0])

    def sample_squashed(self, params, obs, noise):
        """Reparameterized tanh-Gaussian sample + its log-prob (the
        noise is standard normal, drawn OUTSIDE the loss so the update
        stays a function of the batch)."""
        import math

        import torch

        mu, log_std = self.actor(params, obs)
        std = torch.exp(log_std)
        pre = mu + std * noise
        a = torch.tanh(pre)
        logp = torch.sum(
            -0.5 * noise**2 - log_std - 0.5 * math.log(2 * math.pi)
            - torch.log(1.0 - a**2 + 1e-6),
            dim=-1,
        )
        return a, logp

    def forward_train(self, params, obs):
        import torch

        mu, _ = self.actor(params, obs)
        return mu, torch.zeros(obs.shape[0], device=obs.device)

    # -- numpy (env runners) ------------------------------------------
    def select_actions_numpy(self, params_np, obs, rng, explore):
        from ray_tpu_torch.rllib.core.rl_module import tower_numpy

        out = tower_numpy(params_np["pi"], obs)
        mu, log_std = np.split(out, 2, axis=-1)
        if explore is False:
            a = np.tanh(mu)
            logp = np.zeros(a.shape[0], np.float32)
        else:
            log_std = np.clip(log_std, LOG_STD_MIN, LOG_STD_MAX)
            std = np.exp(log_std)
            noise = rng.standard_normal(mu.shape).astype(np.float32)
            pre = mu + std * noise
            a = np.tanh(pre)
            logp = np.sum(
                -0.5 * noise**2 - log_std - 0.5 * np.log(2 * np.pi)
                - np.log(1.0 - a**2 + 1e-6),
                axis=-1,
            ).astype(np.float32)
        return (a.astype(np.float32), logp,
                np.zeros(a.shape[0], np.float32))

    def forward_numpy(self, params_np, obs: np.ndarray):
        from ray_tpu_torch.rllib.core.rl_module import tower_numpy

        out = tower_numpy(params_np["pi"], obs)
        mu, _ = np.split(out, 2, axis=-1)
        return mu, np.zeros(obs.shape[0], np.float32)


def make_continuous_sac_loss(target_entropy: float):
    """Joint actor + twin-critic + temperature loss, continuous SAC.
    `batch["noise"]` carries the reparameterization draw."""

    def sac_loss(module, params, batch):
        import torch

        from ray_tpu_torch.models.bridge import tree_map

        obs = batch["obs"]
        alpha = torch.exp(params["log_alpha"])

        # critics toward externally computed TD targets
        q1_a, q2_a = module.q_values(params, obs, batch["actions"])
        y = batch["td_target"]
        critic_loss = (torch.mean((q1_a - y) ** 2)
                       + torch.mean((q2_a - y) ** 2))

        # actor: reparameterized sample, critics detached
        a_pi, logp = module.sample_squashed(params, obs, batch["noise"])
        q1_pi, q2_pi = module.q_values(
            tree_map(lambda t: t.detach(), params), obs, a_pi
        )
        min_q = torch.minimum(q1_pi, q2_pi)
        actor_loss = torch.mean(alpha.detach() * logp - min_q)

        # temperature toward the entropy target (policy detached)
        logp_sg = logp.detach()
        alpha_loss = torch.mean(
            params["log_alpha"] * (-logp_sg - target_entropy)
        )

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha": alpha,
            "entropy": -torch.mean(logp_sg),
        }

    return sac_loss


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-3
        self.buffer_size: int = 50_000
        self.learn_batch_size: int = 128
        self.num_updates_per_iter: int = 32
        self.target_update_freq: int = 1
        #: None -> auto: 0.5 * log(num_actions) (discrete-SAC default)
        self.target_entropy: float = None  # type: ignore[assignment]
        self.num_env_runners = 1
        self.rollout_fragment_length = 32

    @property
    def algo_class(self):
        return SAC


def make_sac_loss(target_entropy: float):
    """Joint actor + twin-critic + temperature loss (discrete SAC)."""

    def sac_loss(module, params, batch):
        import torch

        obs = batch["obs"]
        actions = batch["actions"].long()
        logits, _ = module.forward_train(params, obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        probs = torch.exp(logp_all)
        alpha = torch.exp(params["log_alpha"])

        q1, q2 = module.q_values(params, obs)
        q1_a = q1.gather(-1, actions[:, None])[:, 0]
        q2_a = q2.gather(-1, actions[:, None])[:, 0]
        y = batch["td_target"]
        critic_loss = (torch.mean((q1_a - y) ** 2)
                       + torch.mean((q2_a - y) ** 2))

        # actor: minimize E_pi[alpha*logpi - minQ] (critics detached)
        min_q = torch.minimum(q1, q2).detach()
        actor_loss = torch.mean(torch.sum(
            probs * (alpha.detach() * logp_all - min_q),
            dim=-1,
        ))

        # temperature: entropy toward the target (policy detached)
        entropy = -torch.sum((probs * logp_all).detach(), dim=-1)
        alpha_loss = torch.mean(
            params["log_alpha"] * (entropy - target_entropy)
        )

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha": alpha,
            "entropy": torch.mean(entropy),
        }

    return sac_loss


def sac_target_terms(module, continuous: bool, target_p, online_p,
                     next_obs, noise=None):
    """The bootstrap value of `next_obs` (tensors on one device): the
    reference's jitted `_target_terms`, run eagerly (the caller holds
    `no_grad_f32`).  Continuous: min twin target Q at the online
    policy's squashed sample minus alpha * its log-prob; discrete: the
    expectation of that under the online softmax."""
    import torch

    alpha = torch.exp(online_p["log_alpha"])
    if continuous:
        a2, logp2 = module.sample_squashed(online_p, next_obs, noise)
        tq1, tq2 = module.q_values(target_p, next_obs, a2)
        return torch.minimum(tq1, tq2) - alpha * logp2
    logits, _ = module.forward_train(online_p, next_obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp_all)
    tq1, tq2 = module.q_values(target_p, next_obs)
    min_q = torch.minimum(tq1, tq2)
    return torch.sum(probs * (min_q - alpha * logp_all), dim=-1)


class SAC(TargetNetwork, Algorithm):
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
        require_flat_obs(spec, "SAC")
        self._continuous = spec["continuous"]
        hidden = tuple(cfg.model.get("hidden", (64, 64)))
        if self._continuous:
            action_dim = spec["action_dim"]
            self.module = ContinuousSACModule(
                spec["observation_size"], action_dim, hidden=hidden
            )
            if cfg.target_entropy is None:
                # the continuous-SAC convention: -|A|
                cfg.target_entropy = -float(action_dim)
            loss = make_continuous_sac_loss(cfg.target_entropy)
            self.buffer = ReplayBuffer(
                cfg.buffer_size, spec["observation_size"],
                action_shape=(action_dim,), action_dtype=np.float32,
            )
        else:
            self.module = SACModule(
                spec["observation_size"], spec["num_actions"],
                hidden=hidden,
            )
            if cfg.target_entropy is None:
                cfg.target_entropy = 0.5 * float(
                    np.log(spec["num_actions"])
                )
            loss = make_sac_loss(cfg.target_entropy)
            self.buffer = ReplayBuffer(
                cfg.buffer_size, spec["observation_size"]
            )
        self.learner_group = LearnerGroup(
            self.module, loss,
            num_learners=cfg.num_learners, lr=cfg.lr,
            grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            device=cfg.learner_device,
        )
        self.target_params = self.learner_group.get_weights_numpy()
        self._rng = np.random.default_rng(cfg.seed)

        self._target_terms = functools.partial(
            sac_target_terms, self.module, self._continuous)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )

    def _td_targets(self, replay, online) -> np.ndarray:
        """`online`: the online tree on the learner's device
        (`training_step` uploads it once an iteration)."""
        cfg = self.config
        next_obs = self._upload(replay["next_obs"])
        with no_grad_f32():
            if self._continuous:
                noise = self._rng.standard_normal(
                    replay["actions"].shape
                ).astype(np.float32)
                v_next = self._target_terms(
                    self._target_dev, online, next_obs, self._upload(noise)
                )
            else:
                v_next = self._target_terms(
                    self._target_dev, online, next_obs
                )
        v_next = v_next.cpu().numpy()
        nonterminal = 1.0 - replay["terminated"].astype(np.float32)
        return (replay["rewards"] + cfg.gamma * v_next * nonterminal).astype(
            np.float32
        )

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        samples = self.env_runner_group.sample(self.module)
        steps = 0
        for s in samples:
            obs, actions, rewards, next_obs, done = _transitions(s)
            self.buffer.add_batch(obs, actions, rewards, next_obs, done)
            steps += len(actions)

        metrics_acc: List[Dict[str, float]] = []
        if len(self.buffer) >= cfg.learn_batch_size:
            online = self._on_learner_device(
                self.learner_group.get_weights_numpy())
            for _ in range(cfg.num_updates_per_iter):
                replay = self.buffer.sample(cfg.learn_batch_size, self._rng)
                batch = {
                    "obs": replay["obs"],
                    "actions": replay["actions"],
                    "td_target": self._td_targets(replay, online),
                }
                if self._continuous:
                    batch["noise"] = self._rng.standard_normal(
                        replay["actions"].shape
                    ).astype(np.float32)
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
            "recent_returns": list(self._recent_returns),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]):
        self.learner_group.set_state(state["learner"])
        self.env_runner_group.restore_connector_state(
            state.get("connector")
        )
        self.target_params = state["target_params"]
        self._recent_returns = list(state.get("recent_returns", []))
        self.iteration = state.get("iteration", self.iteration)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )

    def stop(self):
        self.env_runner_group.stop()
        self.learner_group.stop()
