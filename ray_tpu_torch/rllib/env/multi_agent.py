"""Multi-agent environments + episode collection.

Reference: `rllib/env/multi_agent_env.py` (the dict-keyed env
contract), `rllib/env/multi_agent_episode.py` (per-agent trajectory
bookkeeping inside one env episode), and the policy-mapping mechanism
(`AlgorithmConfig.multi_agent(policies=..., policy_mapping_fn=...)`).

The env steps DICTS: every agent currently alive maps to an
observation/action/reward; `terminateds["__all__"]` ends the episode.
The runner demultiplexes transitions by `policy_mapping_fn` into one
time-major batch per MODULE (policy), which is what the multi-agent
learner consumes — agents sharing a policy share its batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class MultiAgentEnv:
    """Contract (reference: `multi_agent_env.py`):

    reset(seed)  -> (obs: {agent: np.ndarray}, info)
    step(actions: {agent: int}) ->
        (obs, rewards, terminateds, truncateds, info) — all dicts keyed
        by agent id; terminateds/truncateds carry the "__all__" key.
    """

    agent_ids: Tuple[str, ...] = ()
    observation_size: int = 0
    num_actions: int = 0

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        raise NotImplementedError


class CoordinationGame(MultiAgentEnv):
    """Tiny cooperative matrix game for tests: each episode is
    `episode_len` repeated rounds; both agents receive +1 when they
    pick the SAME action, 0 otherwise.  Optimal joint policy earns
    `episode_len` per agent per episode; independent uniform play earns
    ~episode_len / num_actions — easy to verify learning against."""

    def __init__(self, num_actions: int = 2, episode_len: int = 10):
        self.agent_ids = ("agent_0", "agent_1")
        self.num_actions = num_actions
        self.observation_size = 2  # [t/episode_len, 1]
        self._len = episode_len
        self._t = 0

    def _obs(self):
        o = np.array([self._t / self._len, 1.0], np.float32)
        return {a: o.copy() for a in self.agent_ids}

    def reset(self, seed: Optional[int] = None):
        self._t = 0
        return self._obs(), {}

    def step(self, actions: Dict[str, int]):
        self._t += 1
        same = actions["agent_0"] == actions["agent_1"]
        r = 1.0 if same else 0.0
        rewards = {a: r for a in self.agent_ids}
        done = self._t >= self._len
        term = {a: done for a in self.agent_ids}
        term["__all__"] = done
        trunc = {a: False for a in self.agent_ids}
        trunc["__all__"] = False
        return self._obs(), rewards, term, trunc, {}


_MULTI_AGENT_ENVS = {"coordination": CoordinationGame}


def make_multi_agent_env(env: Any, **kwargs) -> MultiAgentEnv:
    if isinstance(env, str):
        try:
            return _MULTI_AGENT_ENVS[env](**kwargs)
        except KeyError:
            raise ValueError(
                f"unknown multi-agent env {env!r}; "
                f"registered: {sorted(_MULTI_AGENT_ENVS)}"
            ) from None
    if isinstance(env, type):
        return env(**kwargs)
    return env


class MultiAgentEnvRunner:
    """Sampling actor for multi-agent envs (reference:
    `multi_agent_env_runner.py` + MultiAgentEpisode): steps one env,
    demultiplexes per-agent transitions into per-MODULE trajectories
    via policy_mapping_fn.  Output per module: time-major arrays with a
    trailing done flag per step so the learner can compute GAE across
    the concatenated steps of many (episode, agent) lanes."""

    def __init__(self, env: Any, rollout_length: int,
                 policy_mapping: Dict[str, str],
                 seed: int = 0, env_kwargs: Optional[Dict] = None):
        self._env = make_multi_agent_env(env, **(env_kwargs or {}))
        self._T = rollout_length
        self._map = dict(policy_mapping)  # agent_id -> module_id
        # Per-module lane index for each agent: rows of agents sharing a
        # module interleave per env step, so GAE must recurse per lane.
        self._lane: Dict[str, int] = {}
        lanes_per_mod: Dict[str, int] = {}
        for agent in sorted(self._map):
            mid = self._map[agent]
            self._lane[agent] = lanes_per_mod.get(mid, 0)
            lanes_per_mod[mid] = self._lane[agent] + 1
        self._rng = np.random.default_rng(seed + 1)
        self._obs, _ = self._env.reset(seed=seed)
        self._params: Dict[str, Any] = {}
        self._weights_version = -1
        self._ep_return = 0.0
        self._completed: List[Dict[str, float]] = []

    def env_spec(self) -> Dict[str, Any]:
        return {
            "observation_size": self._env.observation_size,
            "num_actions": self._env.num_actions,
            "agent_ids": list(self._env.agent_ids),
            "module_ids": sorted(set(self._map.values())),
        }

    def set_weights(self, params_by_module: Dict[str, Any], version: int):
        self._params = params_by_module
        self._weights_version = version
        return True

    def sample(self, modules: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
        """Rollout T env steps; returns {module_id: batch} where batch
        rows are the module's agents' transitions in step order, with
        per-row `dones` separating trajectory lanes for GAE."""
        assert self._params, "set_weights before sample"
        traj: Dict[str, Dict[str, list]] = {
            m: {"obs": [], "actions": [], "logp": [], "values": [],
                "rewards": [], "dones": [], "agent_lane": []}
            for m in set(self._map.values())
        }
        obs = self._obs
        for _ in range(self._T):
            actions: Dict[str, int] = {}
            step_records = []  # (module, agent, obs, act, logp, value)
            for agent, o in obs.items():
                mid = self._map[agent]
                module = modules[mid]
                logits, value = module.forward_numpy(
                    self._params[mid], o[None]
                )
                z = logits[0] - logits[0].max()
                probs = np.exp(z) / np.exp(z).sum()
                a = int(self._rng.choice(len(probs), p=probs))
                actions[agent] = a
                step_records.append(
                    (mid, agent, o, a, float(np.log(probs[a] + 1e-10)),
                     float(value[0]))
                )
            next_obs, rewards, term, trunc, _ = self._env.step(actions)
            done = bool(term.get("__all__")) or bool(trunc.get("__all__"))
            for mid, agent, o, a, logp, value in step_records:
                t = traj[mid]
                t["obs"].append(o)
                t["actions"].append(a)
                t["logp"].append(logp)
                t["values"].append(value)
                t["rewards"].append(float(rewards.get(agent, 0.0)))
                t["dones"].append(
                    done or bool(term.get(agent)) or bool(trunc.get(agent))
                )
                t["agent_lane"].append(self._lane[agent])
            self._ep_return += float(np.mean(list(rewards.values())))
            if done:
                self._completed.append({
                    "episode_return": self._ep_return,
                    "episode_len": 0.0,
                })
                self._ep_return = 0.0
                obs, _ = self._env.reset()
            else:
                obs = next_obs
        self._obs = obs
        out = {}
        for mid, t in traj.items():
            out[mid] = {
                "obs": np.asarray(t["obs"], np.float32),
                "actions": np.asarray(t["actions"], np.int32),
                "logp": np.asarray(t["logp"], np.float32),
                "values": np.asarray(t["values"], np.float32),
                "rewards": np.asarray(t["rewards"], np.float32),
                "dones": np.asarray(t["dones"], np.bool_),
                "agent_lane": np.asarray(t["agent_lane"], np.int32),
            }
        return out

    def pop_metrics(self) -> List[Dict[str, float]]:
        out, self._completed = self._completed, []
        return out

    def ping(self) -> bool:
        return True


def multi_agent_gae(batch: Dict[str, np.ndarray], gamma: float,
                    lambda_: float) -> Tuple[np.ndarray, np.ndarray]:
    """GAE over a per-module batch whose rows interleave agents per env
    step.  `agent_lane` (when present) segments rows into per-agent
    lanes so the recursion only chains an agent's own transitions;
    within a lane, `dones` cut episodes.  The tail of an unfinished
    trajectory bootstraps with V=0 — acceptable bias for short-episode
    benchmarks; reference episodes carry their own bootstrap values.
    Advantages are returned in the original row order."""
    rewards, values = batch["rewards"], batch["values"]
    dones = batch["dones"].astype(np.float32)
    lanes = batch.get("agent_lane")
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    if lanes is None:
        lane_rows = [range(n - 1, -1, -1)]
    else:
        lane_rows = [np.nonzero(lanes == lane)[0][::-1]
                     for lane in np.unique(lanes)]
    for rows in lane_rows:
        gae = 0.0
        next_value = 0.0
        for t in rows:
            nonterminal = 1.0 - dones[t]
            delta = rewards[t] + gamma * next_value * nonterminal - values[t]
            gae = delta + gamma * lambda_ * nonterminal * gae
            adv[t] = gae
            next_value = values[t]
    return adv, adv + values
