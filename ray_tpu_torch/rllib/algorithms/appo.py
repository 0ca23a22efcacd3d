"""APPO: asynchronous PPO with V-trace off-policy correction.

Reference: `rllib/algorithms/appo/` (`appo.py`, `appo_learner.py`) and
the IMPALA V-trace math it builds on (`rllib/algorithms/impala/`,
vtrace_* in the learner).  The decisive difference from PPO: rollouts
may be stale relative to the learner (async sampling / many runners),
so advantages are computed with V-trace — importance-weighted TD
corrections with clipped rho/c — instead of GAE against on-policy
values, and the surrogate clips the importance ratio against the
V-trace advantages.

The split mirrors PPO here: rollout inference is numpy on CPU actors,
and so is V-trace on the driver (`compute_vtrace`, against the current
weights' numpy forward); the learner's update is an eager torch loss on
the learner's device (the card unless the caller asks for the CPU), a
gang of mesh devices or DDP actors via LearnerGroup.  Every term of the
loss is a row mean, so the gang's equal shards give the whole batch's
update.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import make_default_module
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.clip_param: float = 0.3
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.minibatch_size = 256
        self.num_epochs = 1  # APPO default: one pass, fresh data faster
        # V-trace clippings (reference: vtrace rho/c thresholds)
        self.vtrace_clip_rho_threshold: float = 1.0
        self.vtrace_clip_c_threshold: float = 1.0
        # circuit breaker on catastrophic staleness
        self.target_update_frequency: int = 1

    @property
    def algo_class(self):
        return APPO


def make_appo_loss(clip_param: float, vf_loss_coeff: float,
                   entropy_coeff: float):
    """Importance-clipped surrogate against precomputed V-trace
    advantages/targets (reference: `appo_learner.py` surrogate with
    vtrace-adjusted advantages), on tensors on the learner's device."""

    def appo_loss(module, params, batch):
        import torch

        logits, values = module.forward_train(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch["actions"].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - batch["behavior_logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv,
        )
        policy_loss = -torch.mean(surrogate)
        vf_loss = torch.mean((values - batch["value_targets"]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_is_ratio": torch.mean(ratio),
        }

    return appo_loss


def compute_vtrace(
    behavior_logp: np.ndarray,  # [T, B] logp of taken actions (rollout)
    target_logp: np.ndarray,  # [T, B] logp under CURRENT policy
    rewards: np.ndarray,  # [T, B]
    values: np.ndarray,  # [T, B] V under current policy at s_t
    final_value: np.ndarray,  # [B] V at s_{T} (bootstrap)
    terminated: np.ndarray,  # [T, B]
    truncated: np.ndarray,  # [T, B]
    bootstrap_values: np.ndarray,  # [T, B] V(final_obs) for truncation
    gamma: float,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy V-trace (Espeholt et al. 2018, the math the reference's
    vtrace implements): backward recursion

      vs_t = V(s_t) + dt + gamma * c_t * (vs_{t+1} - V(s_{t+1}))
      dt   = rho_t * (r_t + gamma * V(s_{t+1}) - V(s_t))

    with rho/c the clipped importance ratios.  Termination zeroes the
    bootstrap; truncation bootstraps from V(final_obs) and cuts the
    recursion the same way GAE does in the PPO path.
    Returns (pg_advantages, vs_targets), both [T, B].
    """
    T, B = rewards.shape
    rho = np.minimum(np.exp(target_logp - behavior_logp), clip_rho)
    c = np.minimum(np.exp(target_logp - behavior_logp), clip_c)
    vs = np.zeros((T, B), np.float32)
    next_vs_minus_v = np.zeros(B, np.float32)
    next_value = final_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - terminated[t].astype(np.float32)
        chain = nonterminal * (1.0 - truncated[t].astype(np.float32))
        next_v = np.where(truncated[t], bootstrap_values[t], next_value)
        delta = rho[t] * (rewards[t] + gamma * next_v * nonterminal - values[t])
        vs_minus_v = delta + gamma * c[t] * chain * next_vs_minus_v
        vs[t] = values[t] + vs_minus_v
        next_vs_minus_v = vs_minus_v
        next_value = values[t]
    # pg advantage: rho * (r + gamma * vs_{t+1} - V(s_t))
    vs_next = np.concatenate([vs[1:], final_value[None]], axis=0)
    nonterminal = 1.0 - terminated.astype(np.float32)
    vs_next = np.where(truncated, bootstrap_values, vs_next)
    pg_adv = rho * (rewards + gamma * vs_next * nonterminal - values)
    return pg_adv.astype(np.float32), vs.astype(np.float32)


class APPO(Algorithm):
    def setup_components(self):
        cfg = self.config
        self.env_runner_group = EnvRunnerGroup(
            cfg.env, cfg.num_env_runners, cfg.num_envs_per_env_runner,
            cfg.rollout_fragment_length, seed=cfg.seed,
            env_kwargs=cfg.env_kwargs,
            connector=cfg.env_to_module_connector,
        )
        spec = self.env_runner_group.env_spec()
        self.module = make_default_module(spec, cfg.model)
        loss = make_appo_loss(
            cfg.clip_param, cfg.vf_loss_coeff, cfg.entropy_coeff
        )
        self.learner_group = LearnerGroup(
            self.module, loss, num_learners=cfg.num_learners,
            lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            device=cfg.learner_device,
        )
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )

    def _current_forward(self, weights, obs_tb: np.ndarray):
        """Current-policy logits/values over a [T, B, obs] rollout —
        numpy MLP math, same fast path the runners use."""
        T, B = obs_tb.shape[:2]
        flat = obs_tb.reshape(T * B, *obs_tb.shape[2:])
        logits, values = self.module.forward_numpy(weights, flat)
        return (
            logits.reshape(T, B, -1),
            values.reshape(T, B).astype(np.float32),
        )

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        samples = self.env_runner_group.sample(self.module)
        weights = self.learner_group.get_weights_numpy()

        obs_l, act_l, blogp_l, adv_l, tgt_l = [], [], [], [], []
        for s in samples:
            logits, values = self._current_forward(weights, s["obs"])
            logp_all = logits - _logsumexp(logits)
            tgt_logp = np.take_along_axis(
                logp_all, s["actions"][..., None].astype(np.int64), axis=-1
            )[..., 0]
            _, final_v = self.module.forward_numpy(weights, s["final_obs"])
            pg_adv, vs = compute_vtrace(
                behavior_logp=s["logp"],
                target_logp=tgt_logp,
                rewards=s["rewards"],
                values=values,
                final_value=final_v.astype(np.float32),
                terminated=s["terminated"],
                truncated=s["truncated"],
                bootstrap_values=s["bootstrap_values"],
                gamma=cfg.gamma,
                clip_rho=cfg.vtrace_clip_rho_threshold,
                clip_c=cfg.vtrace_clip_c_threshold,
            )
            T, B = s["actions"].shape
            obs_l.append(s["obs"].reshape(T * B, *s["obs"].shape[2:]))
            act_l.append(s["actions"].reshape(-1))
            blogp_l.append(s["logp"].reshape(-1))
            adv_l.append(pg_adv.reshape(-1))
            tgt_l.append(vs.reshape(-1))
        obs = np.concatenate(obs_l)
        actions = np.concatenate(act_l)
        behavior_logp = np.concatenate(blogp_l)
        advantages = np.concatenate(adv_l)
        targets = np.concatenate(tgt_l)
        advantages = (advantages - advantages.mean()) / (
            advantages.std() + 1e-8
        )

        n = obs.shape[0]
        mb = min(cfg.minibatch_size, n)
        n_even = (n // mb) * mb
        rng = np.random.default_rng(cfg.seed + self.iteration)
        metrics_acc: List[Dict[str, float]] = []
        for _epoch in range(cfg.num_epochs):
            perm = rng.permutation(n)[:n_even]
            for start in range(0, n_even, mb):
                idx = perm[start:start + mb]
                metrics_acc.append(self.learner_group.update_minibatch({
                    "obs": obs[idx],
                    "actions": actions[idx],
                    "behavior_logp": behavior_logp[idx],
                    "advantages": advantages[idx],
                    "value_targets": targets[idx],
                }))

        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )
        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in metrics_acc[0]
        }
        result["num_env_steps_sampled"] = n
        self._track_episode_metrics(
            self.env_runner_group.pop_metrics(), result
        )
        return result

    def get_state(self) -> Dict[str, Any]:
        return {
            "learner": self.learner_group.get_state(),
            "connector": self.env_runner_group.connector_state(),
            "recent_returns": list(self._recent_returns),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]):
        self.learner_group.set_state(state["learner"])
        self.env_runner_group.restore_connector_state(
            state.get("connector")
        )
        self._recent_returns = list(state.get("recent_returns", []))
        self.iteration = state.get("iteration", self.iteration)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )

    def stop(self):
        self.env_runner_group.stop()
        self.learner_group.stop()


def _logsumexp(logits: np.ndarray) -> np.ndarray:
    m = logits.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(logits - m).sum(axis=-1, keepdims=True))
