"""Connector pipelines: composable transforms on the env<->module path.

Reference: `rllib/connectors/` ConnectorV2 — pluggable pieces that
transform observations before the module sees them (env-to-module),
actions before the env sees them (module-to-env), and rewards before
they land in the train batch.  TPU-native shape: connectors run inside
the numpy EnvRunner actor (the CPU side), and the TRANSFORMED
observations are what the rollout batch stores, so the compiled learner
trains on exactly what the policy acted on — no recompute and no
train/act skew.

Stateful connectors (the running mean/std filter) expose
`get_state`/`set_state`; the EnvRunnerGroup merges per-runner states
periodically (reference: connector state aggregation across
EnvRunners) so every runner normalizes with the fleet-wide statistics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ConnectorV2:
    """One transform stage.  Override any hook; defaults pass through.

    Hooks run per vector-env step on numpy arrays:
    - `on_observations(obs[B, D])` before the module forward (and on
      truncation-bootstrap/final observations),
    - `on_actions(actions[B])` before `env.step`,
    - `on_rewards(rewards[B])` before the rollout buffer.
    """

    def on_observations(self, obs: np.ndarray) -> np.ndarray:
        return obs

    def on_actions(self, actions: np.ndarray) -> np.ndarray:
        return actions

    def on_rewards(self, rewards: np.ndarray) -> np.ndarray:
        return rewards

    def transformed_observation_shape(
        self, shape: Sequence[int],
    ) -> Sequence[int]:
        """Static shape mapping of `on_observations` (no state touched):
        lets module construction know the post-connector obs shape
        without running a sample (reference: connectors recompute the
        observation space for the module spec)."""
        return tuple(shape)

    def on_episode_boundaries(self, done_mask: np.ndarray) -> None:
        """Called by the EnvRunner after env.step with the per-sub-env
        done mask, so temporal connectors (frame stacking) reset their
        per-env state at episode boundaries."""
        pass

    def on_final_observations(self, obs: np.ndarray,
                              env_indices: np.ndarray) -> np.ndarray:
        """Transform final/bootstrap observations of a SUBSET of
        sub-envs (truncation value bootstrap).  Temporal connectors
        override this to read their per-env state without advancing
        it; stateless/statistical connectors treat it as a normal
        observation batch."""
        return self.on_observations(obs)

    def get_state(self) -> Dict[str, Any]:
        """Report-and-reset: return the state accumulated since the
        last call (stateful connectors POP their delta here — see
        MeanStdObsFilter) so fleet merges never double-count."""
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        """Adopt merged fleet state as the new base (must not clear
        locally accumulated-but-unreported state)."""
        pass

    @staticmethod
    def merge_states(states: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Combine per-runner states into the fleet state; default:
        first non-empty wins (stateless connectors don't care)."""
        for s in states:
            if s:
                return s
        return {}


class ConnectorPipeline(ConnectorV2):
    """Ordered composition (reference: ConnectorPipelineV2)."""

    def __init__(self, connectors: Sequence[ConnectorV2] = ()):
        self.connectors = list(connectors)

    def on_observations(self, obs):
        for c in self.connectors:
            obs = c.on_observations(obs)
        return obs

    def on_actions(self, actions):
        for c in self.connectors:
            actions = c.on_actions(actions)
        return actions

    def on_rewards(self, rewards):
        for c in self.connectors:
            rewards = c.on_rewards(rewards)
        return rewards

    def transformed_observation_shape(self, shape):
        for c in self.connectors:
            shape = c.transformed_observation_shape(shape)
        return tuple(shape)

    def on_episode_boundaries(self, done_mask):
        for c in self.connectors:
            c.on_episode_boundaries(done_mask)

    def on_final_observations(self, obs, env_indices):
        for c in self.connectors:
            obs = c.on_final_observations(obs, env_indices)
        return obs

    def get_state(self):
        return {str(i): c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])

    def merge_states(self, states):  # type: ignore[override]
        out = {}
        for i, c in enumerate(self.connectors):
            key = str(i)
            out[key] = c.merge_states([s.get(key, {}) for s in states])
        return out


def _welford_add(count, mean, m2, flat):
    n = flat.shape[0]
    if n == 0:
        return count, mean, m2
    batch_mean = flat.mean(axis=0)
    batch_m2 = ((flat - batch_mean) ** 2).sum(axis=0)
    delta = batch_mean - mean
    total = count + n
    mean = mean + delta * n / total
    m2 = m2 + batch_m2 + delta ** 2 * count * n / total
    return total, mean, m2


def _welford_combine(a, b):
    """Parallel-variance combination of two (count, mean, m2) stats."""
    ca, ma, m2a = a
    cb, mb, m2b = b
    if cb <= 0:
        return a
    if ca <= 0:
        return b
    delta = mb - ma
    total = ca + cb
    return (
        total,
        ma + delta * cb / total,
        m2a + m2b + delta ** 2 * ca * cb / total,
    )


class MeanStdObsFilter(ConnectorV2):
    """Running observation normalization (reference:
    `connectors/env_to_module/mean_std_filter.py`): Welford-style
    running mean/var per feature, observations standardized and
    clipped.

    Fleet protocol: the filter keeps a synced BASE (set by
    `set_state` with the merged fleet stats) and a local DELTA of
    samples seen since; `get_state` reports the delta only, and the
    merge combines base + one delta per runner — runners never
    re-contribute history they already reported (a full-state merge
    would double shared history N-fold per sync and freeze the
    normalizer on early statistics)."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._base = None  # (count, mean, m2) merged fleet stats
        self._delta = None  # (count, mean, m2) local since last sync

    def _ensure(self, dim):
        if self._delta is None:
            zero = (0.0, np.zeros(dim, np.float64), np.zeros(dim, np.float64))
            self._delta = zero
        if self._base is None:
            self._base = (
                0.0, np.zeros(dim, np.float64), np.zeros(dim, np.float64)
            )

    def on_observations(self, obs):
        obs = np.asarray(obs, np.float32)
        self._ensure(obs.shape[-1])
        flat = obs.reshape(-1, obs.shape[-1]).astype(np.float64)
        self._delta = _welford_add(*self._delta, flat)
        count, mean, m2 = _welford_combine(self._base, self._delta)
        std = np.sqrt(m2 / max(count, 1.0)) + self.eps
        out = (obs - mean.astype(np.float32)) / std.astype(np.float32)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def get_state(self):
        """POP the delta to contribute to the next fleet merge: the
        report itself resets local accumulation, so samples arriving
        between this pop and the later `set_state` land in a FRESH
        delta instead of being zeroed (async rollouts execute in that
        window), and a lost `set_state` push can never double-report —
        the popped samples already live in the merged base."""
        if self._delta is None:
            return {}
        c, m, m2 = self._delta
        dim = m.shape[0]
        self._delta = (
            0.0, np.zeros(dim, np.float64), np.zeros(dim, np.float64)
        )
        return {"count": c, "mean": m, "m2": m2}

    def set_state(self, state):
        """Adopt merged fleet stats as the new base.  The local delta
        is NOT touched: it only holds samples not yet reported (see
        get_state's pop semantics)."""
        if not state:
            return
        self._base = (
            state["count"], np.array(state["mean"]), np.array(state["m2"])
        )

    @staticmethod
    def merge_states(states):
        live = [s for s in states if s and s.get("mean") is not None]
        if not live:
            return {}
        acc = (0.0, np.zeros_like(np.asarray(live[0]["mean"])),
               np.zeros_like(np.asarray(live[0]["m2"])))
        for s in live:
            acc = _welford_combine(
                acc, (s["count"], np.asarray(s["mean"]), np.asarray(s["m2"]))
            )
        return {"count": acc[0], "mean": acc[1], "m2": acc[2]}


class RewardClip(ConnectorV2):
    """Clip rewards to [-bound, bound] (the Atari-style stabilizer)."""

    def __init__(self, bound: float = 1.0):
        self.bound = bound

    def on_rewards(self, rewards):
        return np.clip(rewards, -self.bound, self.bound)


class ObsClip(ConnectorV2):
    def __init__(self, bound: float = 10.0):
        self.bound = bound

    def on_observations(self, obs):
        return np.clip(obs, -self.bound, self.bound)


class ImagePreprocess(ConnectorV2):
    """Atari-style image pipeline: grayscale + nearest-neighbor resize
    + scale to [0, 1] (reference: `atari_wrappers.py` WarpFrame /
    `wrap_atari_for_new_api_stack:324`), in vectorized numpy on
    [B, H, W, C] frames."""

    def __init__(self, size: int = 84, grayscale: bool = True,
                 scale: float = 1.0 / 255.0):
        self.size = size
        self.grayscale = grayscale
        self.scale = scale

    def transformed_observation_shape(self, shape):
        h, w, c = shape
        return (self.size, self.size, 1 if self.grayscale else c)

    def on_observations(self, obs):
        obs = np.asarray(obs, np.float32)
        if self.grayscale and obs.shape[-1] != 1:
            if obs.shape[-1] == 3:
                # ITU-R 601 luma (what cv2.cvtColor uses in the ref)
                obs = (obs @ np.array([0.299, 0.587, 0.114],
                                      np.float32))[..., None]
            else:
                # keep the 1-channel shape contract for any input
                # channel count (e.g. RGBA renders): plain mean
                obs = obs.mean(axis=-1, keepdims=True)
        h, w = obs.shape[1], obs.shape[2]
        if (h, w) != (self.size, self.size):
            ri = (np.arange(self.size) * h // self.size).clip(0, h - 1)
            ci = (np.arange(self.size) * w // self.size).clip(0, w - 1)
            obs = obs[:, ri[:, None], ci[None, :], :]
        if self.scale != 1.0:
            obs = obs * self.scale
        return obs.astype(np.float32)


class FrameStack(ConnectorV2):
    """Stack the last `k` frames along the channel axis (reference:
    `atari_wrappers.py` FrameStackEnv / the frame-stacking connector in
    `wrap_atari_for_new_api_stack`).  Per-sub-env buffers reset at
    episode boundaries via `on_episode_boundaries`; bootstrap/final
    observations (recognized by batch size != num live buffers only
    when the runner passes a subset) are stacked against the current
    buffers WITHOUT advancing them."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames = None  # [B, H, W, C*k] rolling buffer
        self._pending_reset = None  # done mask applied on next obs

    def transformed_observation_shape(self, shape):
        h, w, c = shape
        return (h, w, c * self.k)

    def on_observations(self, obs):
        obs = np.asarray(obs, np.float32)
        b, h, w, c = obs.shape
        if self._frames is None or self._frames.shape[0] != b:
            # first batch (or a bootstrap subset before any full batch):
            # initialize by repeating the frame k times
            stacked = np.tile(obs, (1, 1, 1, self.k))
            if self._frames is None and b > 0:
                self._frames = stacked.copy()
            return stacked
        if self._pending_reset is not None:
            # sub-envs that finished last step start a fresh stack with
            # their reset frame repeated
            m = self._pending_reset
            self._frames[m] = np.tile(obs[m], (1, 1, 1, self.k))
            self._pending_reset = None
            keep = ~m
        else:
            keep = np.ones(b, np.bool_)
        # shift one frame: drop oldest channels, append the new frame
        self._frames[keep] = np.concatenate(
            [self._frames[keep][..., c:], obs[keep]], axis=-1
        )
        return self._frames.copy()

    def on_final_observations(self, final_obs: np.ndarray,
                              env_indices: np.ndarray) -> np.ndarray:
        """Stack final/bootstrap observations against the CURRENT
        per-env buffers without advancing them."""
        final_obs = np.asarray(final_obs, np.float32)
        c = final_obs.shape[-1]
        if self._frames is None:
            return np.tile(final_obs, (1, 1, 1, self.k))
        cur = self._frames[env_indices]
        return np.concatenate([cur[..., c:], final_obs], axis=-1)

    def on_episode_boundaries(self, done_mask):
        done_mask = np.asarray(done_mask, np.bool_)
        if done_mask.any():
            self._pending_reset = done_mask.copy()


def wrap_atari_connectors(size: int = 84, grayscale: bool = True,
                          frame_stack: int = 4,
                          clip_rewards: bool = True) -> ConnectorPipeline:
    """The standard Atari pixel pipeline as one connector stack
    (reference: `atari_wrappers.py:324` wrap_atari_for_new_api_stack:
    warp + scale + frame-stack + reward clip)."""
    stages: List[ConnectorV2] = [
        ImagePreprocess(size=size, grayscale=grayscale),
        FrameStack(frame_stack),
    ]
    if clip_rewards:
        stages.append(RewardClip(1.0))
    return ConnectorPipeline(stages)
