"""Multi-agent PPO: per-policy modules/learners over dict-keyed envs.

Reference: the multi-agent path of the new API stack —
`AlgorithmConfig.multi_agent(policies=..., policy_mapping_fn=...)`,
`MultiAgentEpisode` collection, and the Learner-per-module update in
`learner_group.py`.  Agents map to MODULES via the policy mapping;
agents sharing a module share one batch and one learner (parameter
sharing), distinct modules train independently on their own agents'
experience.

The port's one change: each module's learner group takes the learner's
device (`learners(device=...)`, the card unless the caller asks for the
CPU), as PPO's does; the runners, the GAE and the minibatching are the
reference's numpy.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt

logger = logging.getLogger(__name__)
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import MLPModule
from ray_tpu_torch.rllib.env.multi_agent import (
    MultiAgentEnvRunner,
    make_multi_agent_env,
    multi_agent_gae,
)


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = "coordination"
        self.clip_param: float = 0.2
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.gae_lambda: float = 0.95
        self.num_epochs = 4
        self.policies: Optional[List[str]] = None  # module ids
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None

    def multi_agent(self, *, policies: Optional[List[str]] = None,
                    policy_mapping_fn: Optional[Callable] = None,
                    **kwargs) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        self._apply(kwargs)
        return self

    @property
    def algo_class(self):
        return MultiAgentPPO


class MultiAgentPPO(Algorithm):
    def setup_components(self):
        cfg = self.config
        probe = make_multi_agent_env(cfg.env, **cfg.env_kwargs)
        agent_ids = list(probe.agent_ids)
        mapping_fn = cfg.policy_mapping_fn or (lambda aid: "shared")
        self._policy_mapping = {a: mapping_fn(a) for a in agent_ids}
        module_ids = cfg.policies or sorted(set(self._policy_mapping.values()))
        unknown = set(self._policy_mapping.values()) - set(module_ids)
        if unknown:
            raise ValueError(
                f"policy_mapping_fn produced module ids {sorted(unknown)} "
                f"not in policies={module_ids}"
            )

        self.modules: Dict[str, MLPModule] = {
            mid: MLPModule(
                probe.observation_size, probe.num_actions,
                hidden=tuple(cfg.model.get("hidden", (64, 64))),
            )
            for mid in module_ids
        }
        loss = make_ppo_loss(cfg.clip_param, vf_loss_coeff=cfg.vf_loss_coeff,
                             entropy_coeff=cfg.entropy_coeff)
        self.learners: Dict[str, LearnerGroup] = {
            mid: LearnerGroup(
                self.modules[mid], loss, num_learners=cfg.num_learners,
                lr=cfg.lr, grad_clip=cfg.grad_clip,
                seed=cfg.seed + i, mesh=cfg.mesh, device=cfg.learner_device,
            )
            for i, mid in enumerate(module_ids)
        }
        Runner = rt.remote(MultiAgentEnvRunner).options(num_cpus=1)
        self._runners = [
            Runner.remote(cfg.env, cfg.rollout_fragment_length,
                          self._policy_mapping,
                          seed=cfg.seed + i * 10_000,
                          env_kwargs=cfg.env_kwargs)
            for i in range(cfg.num_env_runners)
        ]
        self._sync_weights()

    def _weights(self) -> Dict[str, Any]:
        return {
            mid: lg.get_weights_numpy() for mid, lg in self.learners.items()
        }

    def _sync_weights(self):
        w = self._weights()
        self._weights_version = getattr(self, "_weights_version", 0) + 1
        refs = [r.set_weights.remote(w, self._weights_version)
                for r in self._runners]
        rt.wait(refs, num_returns=len(refs), timeout=30)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        refs = [r.sample.remote(self.modules) for r in self._runners]
        per_module: Dict[str, List[Dict[str, np.ndarray]]] = {
            mid: [] for mid in self.modules
        }
        for ref in refs:
            sample = rt.get(ref, timeout=120)
            for mid, batch in sample.items():
                if len(batch["actions"]):
                    per_module[mid].append(batch)

        result: Dict[str, Any] = {}
        total_steps = 0
        rng = np.random.default_rng(cfg.seed + self.iteration)
        for mid, batches in per_module.items():
            if not batches:
                continue
            adv_l, tgt_l = [], []
            for b in batches:
                adv, tgt = multi_agent_gae(b, cfg.gamma, cfg.gae_lambda)
                adv_l.append(adv)
                tgt_l.append(tgt)
            obs = np.concatenate([b["obs"] for b in batches])
            actions = np.concatenate([b["actions"] for b in batches])
            logp = np.concatenate([b["logp"] for b in batches])
            adv = np.concatenate(adv_l)
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
            targets = np.concatenate(tgt_l)
            n = len(obs)
            total_steps += n
            mb = min(cfg.minibatch_size, n)
            n_even = (n // mb) * mb
            metrics_acc = []
            for _epoch in range(cfg.num_epochs):
                perm = rng.permutation(n)[:n_even]
                for start in range(0, n_even, mb):
                    idx = perm[start:start + mb]
                    metrics_acc.append(
                        self.learners[mid].update_minibatch({
                            "obs": obs[idx],
                            "actions": actions[idx],
                            "logp": logp[idx],
                            "advantages": adv[idx],
                            "value_targets": targets[idx],
                        })
                    )
            for k in metrics_acc[0]:
                result[f"{mid}/{k}"] = float(
                    np.mean([m[k] for m in metrics_acc])
                )
        self._sync_weights()
        result["num_env_steps_sampled"] = total_steps

        episodes: List[Dict[str, float]] = []
        for r in self._runners:
            try:
                episodes.extend(rt.get(r.pop_metrics.remote(), timeout=30))
            except Exception as e:
                logger.debug("episode metrics fetch failed: %s", e)
        self._track_episode_metrics(episodes, result)
        return result

    def get_state(self) -> Dict[str, Any]:
        return {
            "learners": {m: lg.get_state() for m, lg in self.learners.items()},
            "recent_returns": list(self._recent_returns),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]):
        for mid, st in state.get("learners", {}).items():
            if mid in self.learners:
                self.learners[mid].set_state(st)
        self._recent_returns = list(state.get("recent_returns", []))
        self.iteration = state.get("iteration", self.iteration)
        self._sync_weights()

    def stop(self):
        for r in self._runners:
            try:
                rt.kill(r)
            except Exception as e:
                logger.debug("runner kill on stop failed: %s", e)
        for lg in self.learners.values():
            lg.stop()
