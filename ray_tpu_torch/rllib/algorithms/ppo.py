"""PPO on the new API stack.

Reference: `rllib/algorithms/ppo/ppo.py` (`training_step:402`) +
`ppo/torch/ppo_torch_learner.py` (clipped surrogate + value clip +
entropy bonus) — re-expressed as a torch loss on the learner's device
(the JAX package's loss, term for term).  GAE
(`rllib/evaluation/postprocessing.py` in the old stack, connectors in
the new) runs as vectorized numpy on the driver: it is O(T·B)
pointer-chasing, not matrix work.

Production scale (`config.sample_train_overlap=True`): the EnvRunner
fleet streams rollouts as object-plane references while the learner
updates on the PREVIOUS train batch — sampling wall-time
hides behind the update, weights broadcast back non-blocking by
reference (one staleness version, absorbed by the ratio clip).  The
per-iteration result reports the measured overlap
(`sample_busy_s`/`sample_wait_s`/`overlap_ratio`) and the exactly-once
ledger keeps env-step accounting exact through runner failures.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.metrics import metric_defs as _mdefs
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import make_default_module
from ray_tpu_torch.rllib.env.env_runner_group import (
    DuplicateSampleError,
    EnvRunnerGroup,
)

logger = logging.getLogger(__name__)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_: float = 0.95
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.lr = 3e-4

    @property
    def algo_class(self):
        return PPO


def make_ppo_loss(clip_param: float = 0.2, vf_clip_param: float = 10.0,
                  vf_loss_coeff: float = 0.5, entropy_coeff: float = 0.01):
    """Clipped-surrogate PPO loss with hyperparameters bound as
    constants (they never change after config build, so they ride in
    the closure instead of every batch).  `batch` holds tensors on the
    learner's device; every term is a row mean, which the learner gang
    relies on."""

    def ppo_loss(module, params, batch):
        import torch

        logits, values = module.forward_train(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch["actions"].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv,
        )
        policy_loss = -torch.mean(surrogate)

        # value loss, clipped to stabilize (reference vf_clip_param)
        vf_err = torch.clamp(
            values - batch["value_targets"], -vf_clip_param, vf_clip_param
        )
        vf_loss = torch.mean(vf_err**2)

        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = policy_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy
        metrics = {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": torch.mean(batch["logp"] - logp),
        }
        return total, metrics

    return ppo_loss


ppo_loss = make_ppo_loss()  # default-hyperparameter loss (tests, docs)


def compute_gae(sample: Dict[str, np.ndarray], gamma: float,
                lambda_: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized GAE over a time-major rollout [T, B].

    Termination zeroes the bootstrap; truncation bootstraps from
    V(final_obs) (`bootstrap_values`) and resets the lambda chain —
    time limits are not failures (reference: the new stack's GAE
    connector bootstraps truncated episodes the same way).
    """
    rewards, values = sample["rewards"], sample["values"]
    terminated = sample["terminated"].astype(np.float32)
    truncated = sample["truncated"].astype(np.float32)
    boot = sample["bootstrap_values"]
    T, B = rewards.shape
    adv = np.zeros((T, B), np.float32)
    next_value = sample["final_value"]
    gae = np.zeros(B, np.float32)
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - terminated[t]
        chain = nonterminal * (1.0 - truncated[t])
        next_v = np.where(truncated[t] > 0, boot[t], next_value)
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        gae = delta + gamma * lambda_ * chain * gae
        adv[t] = gae
        next_value = values[t]
    targets = adv + values
    return adv, targets


class PPO(Algorithm):
    def setup_components(self):
        cfg = self.config
        self.env_runner_group = EnvRunnerGroup(
            cfg.env, cfg.num_env_runners, cfg.num_envs_per_env_runner,
            cfg.rollout_fragment_length, seed=cfg.seed,
            env_kwargs=cfg.env_kwargs,
            connector=cfg.env_to_module_connector,
            deterministic_replay=cfg.deterministic_replacement,
        )
        spec = self.env_runner_group.env_spec()
        # conv encoder for image obs, fcnet otherwise
        self.module = make_default_module(spec, cfg.model)
        if cfg.num_epochs < 1:
            raise ValueError("num_epochs must be >= 1")
        loss = make_ppo_loss(
            cfg.clip_param, cfg.vf_clip_param, cfg.vf_loss_coeff,
            cfg.entropy_coeff,
        )
        self.learner_group = LearnerGroup(
            self.module, loss, num_learners=cfg.num_learners,
            lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed, mesh=cfg.mesh,
            gang_devices=cfg.num_learner_devices, device=cfg.learner_device,
        )
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )
        self._stream_started = False

    # -- shared postprocessing: GAE per rollout, flatten to [N, ...] ---
    def _postprocess(self, samples: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
        cfg = self.config
        obs, actions, logp, adv_l, tgt_l = [], [], [], [], []
        for s in samples:
            a, tg = compute_gae(s, cfg.gamma, cfg.lambda_)
            T, B = s["actions"].shape
            obs.append(s["obs"].reshape(T * B, *s["obs"].shape[2:]))
            actions.append(s["actions"].reshape(-1))
            logp.append(s["logp"].reshape(-1))
            adv_l.append(a.reshape(-1))
            tgt_l.append(tg.reshape(-1))
        advantages = np.concatenate(adv_l)
        advantages = (advantages - advantages.mean()) / (
            advantages.std() + 1e-8
        )
        return {
            "obs": np.concatenate(obs),
            "actions": np.concatenate(actions),
            "logp": np.concatenate(logp),
            "advantages": advantages,
            "value_targets": np.concatenate(tgt_l),
        }

    def _update_epochs(self, batch: Dict[str, np.ndarray],
                       device_metrics: bool = False
                       ) -> Tuple[List[Dict[str, Any]], float]:
        """Minibatch epochs over one flat train batch; returns (metric
        dicts, update wall seconds).  `device_metrics` defers the host
        sync to the end of the pass (the overlap path — the driver gets
        back to collecting envelopes while XLA executes)."""
        cfg = self.config
        n = batch["obs"].shape[0]
        mb = min(cfg.minibatch_size, n)
        n_even = (n // mb) * mb  # static minibatch shape → one compile
        rng = np.random.default_rng(cfg.seed + self.iteration)
        update = (self.learner_group.update_minibatch_device
                  if device_metrics else self.learner_group.update_minibatch)
        acc: List[Dict[str, Any]] = []
        t0 = time.perf_counter()
        for _epoch in range(cfg.num_epochs):
            perm = rng.permutation(n)[:n_even]
            for start in range(0, n_even, mb):
                idx = perm[start:start + mb]
                acc.append(update({k: v[idx] for k, v in batch.items()}))
        if device_metrics:
            acc = [{k: float(v) for k, v in m.items()} for m in acc]
        update_s = time.perf_counter() - t0
        _mdefs.observe("rt_rllib_learner_update_seconds", update_s)
        return acc, update_s

    def training_step(self) -> Dict[str, Any]:
        if self.config.sample_train_overlap:
            return self._training_step_overlap()
        cfg = self.config
        samples = self.env_runner_group.sample(self.module)
        batch = self._postprocess(samples)
        metrics_acc, _update_s = self._update_epochs(batch)

        self.env_runner_group.sync_weights(
            self.learner_group.get_weights_numpy()
        )
        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in metrics_acc[0]
        }
        result["num_env_steps_sampled"] = batch["obs"].shape[0]
        result["num_learner_updates"] = len(metrics_acc)
        self._track_episode_metrics(
            self.env_runner_group.pop_metrics(), result
        )
        return result

    def _collect_pairs(self, block: bool) -> List[Any]:
        """One collection pass -> list of (meta, batch) pairs, on
        whichever plane the config selected: compiled-DAG tensor
        channels (`use_compiled_dag`) or the object-plane ref stream.
        Both record every consumed batch in the exactly-once ledger."""
        group = self.env_runner_group
        cap = 4 * group.num_runners
        if self.config.use_compiled_dag:
            if block:
                return group.collect_channel(max_batches=cap, timeout=120.0)
            return group.collect_channel(max_batches=cap, block=False)
        envelopes = (group.collect(max_batches=cap, timeout=120.0) if block
                     else group.collect(max_batches=cap, block=False))
        pairs = []
        for env in envelopes:
            try:
                pairs.append(group.fetch(env))
            except DuplicateSampleError:
                raise  # accounting bug, not a runner death
            except Exception:
                logger.debug(
                    "overlap payload fetch failed; producer died — "
                    "its replacement resamples", exc_info=True,
                )
        return pairs

    def _training_step_overlap(self) -> Dict[str, Any]:
        """Async sample/train overlap: consume whatever the fleet
        produced during the previous update, top up to train_batch_size
        env steps, update, broadcast non-blocking.  The fleet keeps
        sampling the NEXT epoch the whole time — `sample_wait_s` is the
        only sampling wall-time the learner ever sees.

        With `use_compiled_dag=True` the sample hop and the weights
        broadcast ride shm tensor channels into RESIDENT runner loops —
        zero actor RPCs on the learner round's hot path."""
        cfg = self.config
        group = self.env_runner_group
        if not self._stream_started:
            if cfg.use_compiled_dag:
                group.start_channel_stream(self.module)
            else:
                group.start_ref_stream(
                    self.module,
                    inflight_per_runner=cfg.inflight_rollouts_per_runner,
                )
            self._stream_started = True

        need = cfg.train_batch_size
        metas: List[Dict[str, Any]] = []
        samples: List[Dict[str, np.ndarray]] = []
        steps = 0
        wait_s = 0.0
        # bounded collection: dead producers are replaced in place, but
        # a fleet that is alive-yet-wedged (hung env.step) returns
        # nothing forever — surface that as a failure instead of
        # hanging training_step silently
        deadline = time.monotonic() + 600.0
        # free sweep first: batches that landed while the learner ran
        pairs = self._collect_pairs(block=False)
        while True:
            for meta, b in pairs:
                metas.append(meta)
                samples.append(b)
                steps += int(meta["env_steps"])
            if steps >= need:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"overlap sample collection stalled: {steps}/{need} "
                    f"env steps after 600s — the runner fleet is alive "
                    "but not producing (hung envs?)"
                )
            t_w = time.perf_counter()
            pairs = self._collect_pairs(block=True)
            wait_s += time.perf_counter() - t_w

        batch = self._postprocess(samples)
        metrics_acc, update_s = self._update_epochs(
            batch, device_metrics=True
        )
        # non-blocking broadcast: in-flight rollouts stay one version
        # stale; the ratio clip absorbs it
        if cfg.use_compiled_dag:
            group.sync_weights_channel(
                self.learner_group.get_weights_numpy()
            )
        else:
            group.sync_weights_async(
                self.learner_group.get_weights_numpy()
            )

        result: Dict[str, Any] = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in metrics_acc[0]
        }
        sample_busy_s = float(sum(m["sample_s"] for m in metas))
        hidden_s = max(0.0, sample_busy_s - wait_s)
        version = group.weights_version
        result.update({
            "num_env_steps_sampled": steps,
            "num_learner_updates": len(metrics_acc),
            "num_async_batches": len(samples),
            "update_s": update_s,
            "sample_busy_s": sample_busy_s,
            "sample_wait_s": wait_s,
            "overlap_ratio": (hidden_s / sample_busy_s
                              if sample_busy_s > 0 else 0.0),
            "weights_staleness_mean": float(np.mean(
                [version - m["weights_version"] for m in metas]
            )),
        })
        if cfg.use_compiled_dag:
            # episode metrics rode the channel metas (the resident
            # loops occupy the actors; pop_metrics RPCs would queue)
            episodes = [e for m in metas for e in m.get("episodes", [])]
            self._track_episode_metrics(episodes, result)
        else:
            self._track_episode_metrics(group.pop_metrics(), result)
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
