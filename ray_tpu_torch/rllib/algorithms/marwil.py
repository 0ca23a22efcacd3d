"""MARWIL: monotonic advantage re-weighted imitation learning.

Reference: `rllib/algorithms/marwil/` (`marwil.py`,
`marwil_torch_learner.py`) — offline RL between BC and full RL: the
policy is cloned from logged actions, but each sample's log-likelihood
is weighted by `exp(beta * advantage)`, so better-than-baseline actions
are imitated harder.  `beta = 0` reduces exactly to BC.  A value head
is trained on the empirical discounted returns to supply the baseline.

Departure from the reference: the advantage normalizer is the batch RMS
rather than the reference's persistent moving average
(`update_averaged_weight` in `marwil_torch_learner.py`) — stateless, so
the loss stays a pure function of (params, batch); at MARWIL's offline
batch sizes the two estimates converge to the same scale.

The loss is torch on the learner's device.  The normaliser is the one
term that is not a row mean: over the whole minibatch it is not the
mean of the shards' own.  The loss therefore carries it as a
whole-batch statistic (`marwil_loss.batch_stats`): a gang of learner
devices computes it once over the minibatch and hands it to every
shard (`batch["adv_norm"]`), which gives the reference's one-program
update; a whole batch on one device computes it inside the loss.  DDP
learner actors, as the reference's, normalise by their own shard.

Offline input: BC's shapes plus per-step `rewards` and episode
boundaries (`dones`/`terminateds`), from which discounted returns are
computed once at setup.  Precomputed `returns` are accepted as-is.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig, _coerce_offline


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0  # 0 => plain BC
        self.vf_coeff = 1.0
        self.gamma = 0.99
        # exp-weight clip guard (reference clips the weight to avoid
        # a few high-advantage samples dominating the batch)
        self.max_weight = 20.0

    def training(self, *, beta: float = None, vf_coeff: float = None,
                 max_weight: float = None, **kwargs) -> "MARWILConfig":
        if beta is not None:
            self.beta = beta
        if vf_coeff is not None:
            self.vf_coeff = vf_coeff
        if max_weight is not None:
            self.max_weight = max_weight
        return super().training(**kwargs)

    @property
    def algo_class(self):
        return MARWIL


def _adv_norm(adv):
    """The advantage normaliser: the root mean square over the rows."""
    import torch

    return torch.sqrt(torch.mean(adv ** 2) + 1e-8)


def make_marwil_loss(beta: float, vf_coeff: float, max_weight: float):
    """Loss factory (hyperparameters close over the loss)."""

    def marwil_loss(module, params, batch):
        import math

        import torch

        logits, values = module.forward_train(params, batch["obs"])
        values = values.reshape(-1)
        returns = batch["returns"]
        adv = returns - values
        # value head regresses the empirical returns
        vf_loss = torch.mean(adv ** 2)
        # policy: advantage-weighted NLL; the weight is a constant from
        # the policy's perspective (stop_gradient, as in the reference)
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch["actions"].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        if beta == 0.0:
            weight = torch.ones_like(logp)
        else:
            norm = (batch["adv_norm"] if "adv_norm" in batch
                    else _adv_norm(adv))
            weight = torch.exp(
                torch.clamp(beta * adv / norm, max=math.log(max_weight))
            )
            weight = weight.detach()
        policy_loss = -torch.mean(weight * logp)
        loss = policy_loss + vf_coeff * vf_loss
        accuracy = torch.mean(
            (torch.argmax(logits, dim=-1) == actions).to(torch.float32)
        )
        return loss, {
            "marwil_loss": loss,
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "mean_weight": torch.mean(weight),
            "mean_advantage": torch.mean(adv),
            "action_accuracy": accuracy,
        }

    def batch_stats(module, params, batch):
        """The whole minibatch's normaliser, for a gang's shards."""
        _, values = module.forward_train(params, batch["obs"])
        return {"adv_norm": _adv_norm(batch["returns"] - values.reshape(-1))}

    marwil_loss.batch_stats = batch_stats
    return marwil_loss


def discounted_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float) -> np.ndarray:
    """Per-episode reverse discounted cumsum (the reference computes
    these in its offline pre-learner connector)."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = float(rewards[i]) + gamma * acc
        out[i] = acc
    return out


def _coerce_offline_marwil(input_: Any, gamma: float) -> Dict[str, np.ndarray]:
    base = _coerce_offline(input_)
    # pull rewards/dones/returns through the same shapes BC accepts
    if isinstance(input_, dict):
        batches = [input_]
    elif isinstance(input_, list) and input_ and isinstance(input_[0], dict) \
            and "obs" in input_[0] and np.ndim(input_[0]["obs"]) >= 2:
        batches = input_
    else:
        rows = input_.take_all() if hasattr(input_, "take_all") else list(input_)
        batches = [{
            k: np.asarray([r[k] for r in rows])
            for k in rows[0]
        }]

    def _col(b, names):
        hit = next((n for n in names if n in b), None)
        return None if hit is None else np.asarray(b[hit])

    # returns are computed PER BATCH: a list of batch dicts is a list of
    # independent trajectories, so discounting must never bleed from one
    # into the previous (each batch's tail is always a boundary)
    per_batch_returns = []
    for b in batches:
        returns = _col(b, ["returns"])
        if returns is None:
            rewards = _col(b, ["rewards", "reward"])
            if rewards is None:
                raise ValueError(
                    "MARWIL needs per-step 'rewards' (+ 'dones') or "
                    "precomputed 'returns' in the offline data"
                )
            rewards = np.asarray(rewards, np.float32)
            dones = _col(b, ["dones", "terminateds", "done"])
            if dones is None:
                dones = np.zeros(len(rewards))
            if len(dones) != len(rewards):
                raise ValueError("rewards/dones length mismatch")
            dones = np.asarray(dones).astype(bool).copy()
            dones[-1] = True
            returns = discounted_returns(rewards, dones, gamma)
        per_batch_returns.append(np.asarray(returns, np.float32))
    base["returns"] = np.concatenate(per_batch_returns)
    if base["returns"].shape[0] != base["obs"].shape[0]:
        raise ValueError("returns/obs length mismatch")
    return base


class MARWIL(BC):
    def _loss_fn(self):
        cfg = self.config
        return make_marwil_loss(cfg.beta, cfg.vf_coeff, cfg.max_weight)

    def _prepare_dataset(self):
        return _coerce_offline_marwil(self.config.input_, self.config.gamma)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = self.dataset["obs"].shape[0]
        mb = min(cfg.minibatch_size, n)
        metrics_acc = []
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, n, mb)
            metrics_acc.append(self.learner_group.update_minibatch({
                "obs": self.dataset["obs"][idx],
                "actions": self.dataset["actions"][idx],
                "returns": self.dataset["returns"][idx],
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
