"""IMPALA: importance-weighted actor-learner architecture.

Reference: `rllib/algorithms/impala/impala.py` (+ the V-trace math in
its learner, Espeholt et al. 2018).  The architectural point — and what
separates this from the sync PPO/APPO loops here — is ASYNC sampling:
env runners sample continuously with pipelined in-flight rollouts; the
learner consumes whatever batches are ready and never blocks on the
slowest runner.  Weight broadcasts are non-blocking, so rollouts are
systematically stale — V-trace's clipped importance weighting is what
makes learning from them sound.

The split as elsewhere: rollouts and V-trace are numpy (CPU actors,
the driver); the update is an eager torch loss on the learner's device
(LearnerGroup: a gang of mesh devices or DDP actors).  Every term of
the loss is a row mean, so the gang's equal shards give the whole
batch's update.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import compute_vtrace, _logsumexp
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import make_default_module
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.minibatch_size = 256
        self.vtrace_clip_rho_threshold: float = 1.0
        self.vtrace_clip_c_threshold: float = 1.0
        # inflight_rollouts_per_runner comes from the base config
        #: max ready batches consumed per training_step
        self.max_batches_per_step: int = 4

    @property
    def algo_class(self):
        return IMPALA


def make_impala_loss(vf_loss_coeff: float, entropy_coeff: float):
    """Canonical IMPALA loss: plain policy gradient against V-trace
    advantages (no ratio clip — rho clipping already happened inside
    the V-trace targets), baseline MSE, entropy bonus (reference:
    the IMPALA learner's pg/baseline/entropy triple), on tensors on the
    learner's device."""

    def impala_loss(module, params, batch):
        import torch

        logits, values = module.forward_train(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch["actions"].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        policy_loss = -torch.mean(logp * batch["advantages"])
        vf_loss = torch.mean((values - batch["value_targets"]) ** 2)
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }

    return impala_loss


class IMPALA(Algorithm):
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
        loss = make_impala_loss(cfg.vf_loss_coeff, cfg.entropy_coeff)
        self.learner_group = LearnerGroup(
            self.module, loss, num_learners=cfg.num_learners,
            lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            device=cfg.learner_device,
        )
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )
        self._sampling_started = False

    def _vtrace_batch(self, samples: List[Dict[str, np.ndarray]],
                      weights) -> Dict[str, np.ndarray]:
        obs_l, act_l, adv_l, tgt_l = [], [], [], []
        for s in samples:
            T, B = s["actions"].shape
            flat = s["obs"].reshape(T * B, *s["obs"].shape[2:])
            logits, values = self.module.forward_numpy(weights, flat)
            logits = logits.reshape(T, B, -1)
            values = values.reshape(T, B).astype(np.float32)
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
                gamma=self.config.gamma,
                clip_rho=self.config.vtrace_clip_rho_threshold,
                clip_c=self.config.vtrace_clip_c_threshold,
            )
            obs_l.append(s["obs"].reshape(T * B, *s["obs"].shape[2:]))
            act_l.append(s["actions"].reshape(-1))
            adv_l.append(pg_adv.reshape(-1))
            tgt_l.append(vs.reshape(-1))
        adv = np.concatenate(adv_l)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        return {
            "obs": np.concatenate(obs_l),
            "actions": np.concatenate(act_l),
            "advantages": adv,
            "value_targets": np.concatenate(tgt_l),
        }

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        if not self._sampling_started:
            self.env_runner_group.start_async_sampling(
                self.module,
                inflight_per_runner=cfg.inflight_rollouts_per_runner,
            )
            self._sampling_started = True
        samples = self.env_runner_group.get_ready_samples(
            max_batches=cfg.max_batches_per_step
        )
        if not samples:
            return {"num_env_steps_sampled": 0}
        weights = self.learner_group.get_weights_numpy()
        batch = self._vtrace_batch(samples, weights)

        n = batch["obs"].shape[0]
        mb = min(cfg.minibatch_size, n)
        n_even = (n // mb) * mb
        rng = np.random.default_rng(cfg.seed + self.iteration)
        perm = rng.permutation(n)[:n_even]
        metrics_acc: List[Dict[str, float]] = []
        for start in range(0, n_even, mb):
            idx = perm[start:start + mb]
            metrics_acc.append(self.learner_group.update_minibatch({
                k: v[idx] for k, v in batch.items()
            }))

        # non-blocking broadcast: in-flight rollouts stay stale by
        # design; V-trace corrects them
        self.env_runner_group.sync_weights_async(
            self.learner_group.get_weights_numpy()
        )
        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in (metrics_acc[0] if metrics_acc else {})
        }
        result["num_env_steps_sampled"] = n
        result["num_async_batches"] = len(samples)
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
