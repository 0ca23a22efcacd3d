"""EnvRunner: CPU sampling actors.

Reference: `rllib/env/single_agent_env_runner.py:61` (`sample():131`) —
each runner steps a vectorized env with the current policy and returns
fixed-shape rollout batches.  TPU-native split: runners are numpy-only
(see rl_module.py); fixed rollout length T keeps downstream learner
batch shapes static so the PPO update compiles once.

Batch layout (time-major): obs[T,B,D], actions[T,B], logp[T,B],
values[T,B], rewards[T,B], dones[T,B], final_obs[B] for bootstrap.

Production shape (the reference's EnvRunnerGroup fleet): `sample_ref`
ships the rollout through the OBJECT PLANE — the batch is `rt.put`
inside the actor and only a small envelope (ref + accounting metadata)
travels back on the actor-call completion path, so a fleet of hundreds
of runners fans references, not megabytes, into the driver's owner
shards.  Weights travel the other way by reference too
(`set_weights_ref`): the learner puts one weights object per version
and every runner pulls it from the store at most once per version.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env.envs import make_vector_env


def _softmax(x: np.ndarray) -> np.ndarray:
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def flatten_tree(tree: Any):
    """Flatten a dict/list/tuple pytree of arrays to (template, leaves)
    — the template mirrors the structure with leaf INDICES at the
    leaves.  Pure python: the channel weights broadcast uses it so
    runner workers stay numpy-only (no jax import for unflattening)."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        leaves.append(t)
        return len(leaves) - 1

    return walk(tree), leaves


def unflatten_tree(template: Any, leaves: List[Any]):
    if isinstance(template, dict):
        return {k: unflatten_tree(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [unflatten_tree(v, leaves) for v in template]
        return out if isinstance(template, list) else tuple(out)
    return leaves[template]


class EnvRunner:
    """One sampling actor (hosts the vector env + numpy policy copy)."""

    def __init__(self, env: Any, num_envs: int, rollout_length: int,
                 seed: int = 0, env_kwargs: Optional[Dict] = None,
                 connector: Any = None, slot: int = 0,
                 incarnation: int = 0):
        self._env = make_vector_env(env, num_envs, seed=seed,
                                    **(env_kwargs or {}))
        self._T = rollout_length
        self._rng = np.random.default_rng(seed + 1)
        self._obs = self._env.reset(seed=seed)
        self._params: Any = None
        self._weights_version = -1
        # fleet identity for exactly-once sample accounting: `slot` is
        # the stable position in the group, `incarnation` bumps on every
        # replacement, `seq` numbers this incarnation's rollouts — the
        # ledger key (slot, incarnation, seq) can never collide between
        # a dead runner's in-flight batches and its replacement's
        self._slot = slot
        self._incarnation = incarnation
        self._seq = 0
        # env<->module transform pipeline (reference: rllib/connectors/
        # ConnectorV2); a factory callable lets the spec ship by value
        self._connector = connector() if callable(connector) else connector
        # end-of-rollout transformed obs, reused by the next sample()
        self._cached_transformed_obs: Optional[np.ndarray] = None
        # per-sub-env running episode accounting for metrics
        self._ep_return = np.zeros(self._env.num_envs, dtype=np.float64)
        self._ep_len = np.zeros(self._env.num_envs, dtype=np.int64)
        self._completed: List[Dict[str, float]] = []

    # -- control ------------------------------------------------------
    def set_weights(self, params_np: Any, version: int) -> bool:
        self._params = params_np
        self._weights_version = version
        return True

    def get_weights_version(self) -> int:
        return self._weights_version

    def env_spec(self) -> Dict[str, Any]:
        raw_shape = self._env.observation_shape
        # what the MODULE sees: the connector's static shape mapping
        # applied to the raw env shape (reference: connectors recompute
        # the module spec's observation space)
        shape = (
            tuple(self._connector.transformed_observation_shape(raw_shape))
            if self._connector is not None else tuple(raw_shape)
        )
        return {
            "observation_size": int(np.prod(shape)),
            "observation_shape": shape,
            "raw_observation_shape": tuple(raw_shape),
            "num_actions": self._env.num_actions,
            "num_envs": self._env.num_envs,
            "continuous": bool(getattr(self._env, "continuous", False)),
            "action_dim": int(getattr(self._env, "action_dim", 0)),
            "action_low": float(getattr(self._env, "action_low", -1.0)),
            "action_high": float(getattr(self._env, "action_high", 1.0)),
        }

    # -- sampling (HOT LOOP of the RL stack) --------------------------
    def sample(self, module_def, explore=None) -> Dict[str, np.ndarray]:
        assert self._params is not None, "set_weights before sample"
        T, B = self._T, self._env.num_envs
        spec = self.env_spec()
        shape = spec["observation_shape"]
        continuous = spec["continuous"]
        obs_buf = np.empty((T, B, *shape), np.float32)
        # continuous actions are [-1, 1]^A module outputs, rescaled to
        # the env's bounds only at the step boundary — the learner
        # trains on exactly what the policy emitted
        act_buf = (
            np.empty((T, B, spec["action_dim"]), np.float32)
            if continuous else np.empty((T, B), np.int32)
        )
        lo, hi = spec["action_low"], spec["action_high"]
        logp_buf = np.empty((T, B), np.float32)
        val_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        term_buf = np.empty((T, B), np.bool_)
        trunc_buf = np.empty((T, B), np.bool_)
        # V(final_obs) where an episode was truncated this step — the
        # bootstrap GAE uses instead of zero (truncation is not failure)
        boot_buf = np.zeros((T, B), np.float32)

        select = getattr(module_def, "select_actions_numpy", None)
        conn = self._connector
        obs = self._obs
        for t in range(T):
            if conn is not None:
                # the TRANSFORMED observation is what the policy acts on
                # AND what the rollout stores — learner and actor see
                # the same features (no train/act skew).  The previous
                # rollout already transformed (and ingested) its final
                # obs for the bootstrap value: reuse that result so the
                # boundary row is neither double-counted in running
                # stats nor normalized differently than its bootstrap.
                if t == 0 and self._cached_transformed_obs is not None:
                    obs = self._cached_transformed_obs
                    self._cached_transformed_obs = None
                else:
                    obs = conn.on_observations(obs)
            if select is not None:
                # module-defined exploration (epsilon-greedy DQN,
                # squashed-Gaussian sampling for continuous SAC)
                actions, logp, value = select(
                    self._params, obs, self._rng, explore
                )
                actions = (
                    actions.astype(np.float32) if continuous
                    else actions.astype(np.int32)
                )
            else:
                logits, value = module_def.forward_numpy(self._params, obs)
                probs = _softmax(logits)
                u = self._rng.random((B, 1))
                actions = (probs.cumsum(axis=-1) > u).argmax(axis=-1).astype(np.int32)
                logp = np.log(np.take_along_axis(
                    probs, actions[:, None], axis=-1
                )[:, 0] + 1e-10)
            env_actions = (
                conn.on_actions(actions) if conn is not None else actions
            )
            if continuous:
                # linear map [-1, 1] -> [low, high]
                env_actions = lo + (env_actions + 1.0) * 0.5 * (hi - lo)
            next_obs, rewards, terminated, truncated, info = self._env.step(
                env_actions
            )
            done = terminated | truncated
            obs_buf[t], act_buf[t] = obs, actions
            logp_buf[t], val_buf[t] = logp, value
            # the buffer stores transformed rewards (clip/scale); the
            # episode metrics below keep the RAW return
            rew_buf[t] = (
                conn.on_rewards(rewards) if conn is not None else rewards
            )
            term_buf[t], trunc_buf[t] = terminated, truncated
            if truncated.any():
                final = info["final_observation"][truncated]
                if conn is not None:
                    # subset path: temporal connectors (frame stack)
                    # read their per-env state without advancing it
                    final = conn.on_final_observations(
                        final, np.flatnonzero(truncated)
                    )
                _, fv = module_def.forward_numpy(self._params, final)
                boot_buf[t, truncated] = fv
            if conn is not None and done.any():
                conn.on_episode_boundaries(done)
            # episode metrics
            self._ep_return += rewards
            self._ep_len += 1
            if done.any():
                for i in np.flatnonzero(done):
                    self._completed.append({
                        "episode_return": float(self._ep_return[i]),
                        "episode_len": float(self._ep_len[i]),
                    })
                self._ep_return[done] = 0.0
                self._ep_len[done] = 0
            obs = next_obs
        self._obs = obs
        if conn is not None:
            obs = conn.on_observations(obs)
            self._cached_transformed_obs = obs
        _, final_value = module_def.forward_numpy(self._params, obs)
        return {
            "final_obs": obs.copy(),
            "obs": obs_buf,
            "actions": act_buf,
            "logp": logp_buf,
            "values": val_buf,
            "rewards": rew_buf,
            "terminated": term_buf,
            "truncated": trunc_buf,
            "bootstrap_values": boot_buf,
            "final_value": final_value.astype(np.float32),
        }

    # -- object-plane sampling (production path) ----------------------
    def sample_ref(self, module_def, explore=None) -> Dict[str, Any]:
        """One rollout shipped as an object-plane reference.

        Returns a small ENVELOPE — `{"batch": ObjectRef, "meta": {...}}`
        — instead of the multi-megabyte batch: the rollout is `rt.put`
        into this worker's shm store and the learner side fetches it
        zero-copy.  `meta` carries the exactly-once ledger key and the
        sampling wall time (the overlap-ratio numerator)."""
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        batch = self.sample(module_def, explore)
        sample_s = time.perf_counter() - t0
        ref = rt.put(batch)
        env_steps = int(self._T * self._env.num_envs)
        nbytes = int(sum(
            v.nbytes for v in batch.values() if hasattr(v, "nbytes")
        ))
        meta = {
            "slot": self._slot,
            "incarnation": self._incarnation,
            "seq": self._seq,
            "env_steps": env_steps,
            "weights_version": self._weights_version,
            "sample_s": sample_s,
            "bytes": nbytes,
            "done_t": time.time(),
        }
        self._seq += 1
        return {"batch": ref, "meta": meta}

    def set_weights_ref(self, boxed: Dict[str, Any], version: int) -> bool:
        """Adopt a weights version published once to the object plane
        (`boxed = {"ref": ObjectRef}` — boxed so the ref is NOT
        materialized as a task arg).  Pull-once-per-version: a stale or
        duplicate broadcast is a no-op."""
        if version <= self._weights_version:
            return False
        import ray_tpu_torch as rt

        self._params = rt.get(boxed["ref"])
        self._weights_version = version
        return True

    def replay(self, module_def, weight_refs: List[Dict[str, Any]],
               explore=None) -> int:
        """Deterministically rebuild this runner's state by replaying
        the rollout history of a dead predecessor: step through the
        SAME weights sequence the dead incarnation sampled with (env,
        action-rng and connector state are pure functions of the seed
        and that sequence).  Episode metrics generated during replay
        are dropped — the predecessor already reported them.  Returns
        the number of rollouts replayed."""
        import ray_tpu_torch as rt

        for i, boxed in enumerate(weight_refs):
            self.set_weights_ref(boxed, i + 1)
            self.sample(module_def, explore)
        self._completed = []
        self._seq = len(weight_refs)
        return len(weight_refs)

    def pop_metrics(self) -> List[Dict[str, float]]:
        out, self._completed = self._completed, []
        return out

    # -- compiled-DAG fast plane (use_compiled_dag=True) ---------------
    def run_sample_channel_loop(self, plan: Dict[str, Any]) -> int:
        """Resident sampling loop over shm tensor channels — the
        compiled-DAG fast plane.  Rollout batches ride a tensor channel
        straight to the learner (raw array bytes + a small meta blob,
        ONE slot publication per rollout, no actor-RPC machinery);
        weights versions arrive over a reverse channel, adopted
        newest-wins between rollouts.  Exits (returning the rollout
        count) when the driver closes the weights channel."""
        from ray_tpu_torch.dag.channel import (
            Channel,
            ChannelClosed,
            ChannelPollTimeout,
        )

        sample_ch = Channel(*plan["sample_chan"],
                            ring_slots=plan.get("sample_ring_slots"))
        weights_ch = Channel(*plan["weights_chan"],
                             ring_slots=plan.get("weights_ring_slots"))
        module_def = plan["module"]
        explore = plan.get("explore")
        template = plan["weights_template"]
        rollouts = 0
        try:
            while True:
                # adopt the newest published weights; block only while
                # this incarnation has none at all
                while True:
                    try:
                        leaves, extra = weights_ch.read_tensors(
                            timeout_s=None if self._params is None else 0.001
                        )
                    except ChannelPollTimeout:
                        break
                    version = int(extra["version"])
                    if version > self._weights_version:
                        self._params = unflatten_tree(template,
                                                      list(leaves))
                        self._weights_version = version
                t0 = time.perf_counter()
                batch = self.sample(module_def, explore)
                sample_s = time.perf_counter() - t0
                meta = {
                    "slot": self._slot,
                    "incarnation": self._incarnation,
                    "seq": self._seq,
                    "env_steps": int(self._T * self._env.num_envs),
                    "weights_version": self._weights_version,
                    "sample_s": sample_s,
                    "bytes": int(sum(
                        v.nbytes for v in batch.values()
                        if hasattr(v, "nbytes")
                    )),
                    "done_t": time.time(),
                    # the resident loop occupies this actor, so episode
                    # metrics ride the channel instead of pop_metrics()
                    # RPCs that would queue behind the loop forever
                    "episodes": self.pop_metrics(),
                }
                sample_ch.write_tensors(batch, extra=meta)
                self._seq += 1
                rollouts += 1
        except ChannelClosed:
            # teardown: tell the learner side this producer is done
            try:
                sample_ch.close()
            except Exception:  # rtlint: disable=RT005 — teardown race:
                pass  # the driver may have destroyed the ring already
            return rollouts

    def ping(self) -> bool:
        return True

    # -- connector state (reference: connector aggregation across
    # EnvRunners) ------------------------------------------------------
    def get_connector_state(self):
        return (
            self._connector.get_state() if self._connector is not None
            else {}
        )

    def set_connector_state(self, state) -> bool:
        if self._connector is not None and state:
            self._connector.set_state(state)
        return True
