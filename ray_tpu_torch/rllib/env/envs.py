"""Vectorized environments for env runners.

Reference: the new API stack samples with gymnasium *vector* envs inside
`SingleAgentEnvRunner` (`rllib/env/single_agent_env_runner.py:61`).
Env runners here are pure-numpy CPU actors — rollout workers never touch
jax or the TPU; all compiled numeric work lives in the Learner.  A
built-in vectorized CartPole (classic Barto-Sutton-Anderson dynamics,
matching gymnasium's CartPole-v1 constants) keeps the stack
self-contained; any gymnasium env id works through `GymnasiumVectorEnv`
when the package is installed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class VectorEnv:
    """Batch-of-envs interface with same-step auto-reset:
    reset() -> obs[B, ...];
    step(actions[B]) -> (obs, rewards, terminated, truncated, info).
    For sub-envs that finished this step, `obs` is the RESET observation
    and info["final_observation"][i] carries the true last observation —
    the value-bootstrap source for truncated episodes."""

    num_envs: int
    observation_size: int
    num_actions: int
    # image/structured envs expose the true per-env obs shape; flat
    # envs inherit (observation_size,) via the property below
    _observation_shape: Optional[Tuple[int, ...]] = None
    # continuous-action envs set these; actions arrive as float arrays
    # [B, action_dim] in the env's native [action_low, action_high]
    continuous: bool = False
    action_dim: int = 0
    action_low: float = -1.0
    action_high: float = 1.0

    @property
    def observation_shape(self) -> Tuple[int, ...]:
        return self._observation_shape or (self.observation_size,)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """Vectorized CartPole-v1 with auto-reset on termination."""

    MAX_STEPS = 500

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self.observation_size = 4
        self.num_actions = 2
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), dtype=np.float64)
        self._steps = np.zeros(num_envs, dtype=np.int64)
        # physics constants (gymnasium cartpole.py)
        self._gravity = 9.8
        self._masscart = 1.0
        self._masspole = 0.1
        self._length = 0.5
        self._force_mag = 10.0
        self._tau = 0.02
        self._theta_limit = 12 * 2 * np.pi / 360
        self._x_limit = 2.4

    def _sample_state(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, size=(n, 4))

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._sample_state(self.num_envs)
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self._force_mag, -self._force_mag)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self._masscart + self._masspole
        polemass_length = self._masspole * self._length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self._gravity * sintheta - costheta * temp) / (
            self._length * (4.0 / 3.0 - self._masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self._tau * x_dot
        x_dot = x_dot + self._tau * xacc
        theta = theta + self._tau * theta_dot
        theta_dot = theta_dot + self._tau * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1

        terminated = (
            (np.abs(x) > self._x_limit) | (np.abs(theta) > self._theta_limit)
        )
        truncated = (self._steps >= self.MAX_STEPS) & ~terminated
        rewards = np.ones(self.num_envs, dtype=np.float32)
        done = terminated | truncated
        info: Dict[str, Any] = {}
        if done.any():  # same-step auto-reset of finished sub-envs
            info["final_observation"] = self._state.astype(np.float32)
            self._state[done] = self._sample_state(int(done.sum()))
            self._steps[done] = 0
        return (
            self._state.astype(np.float32),
            rewards,
            terminated,
            truncated,
            info,
        )


class CatchPixelEnv(VectorEnv):
    """Vectorized pixel Catch (bsuite-style): a ball falls down an
    H x W grid, the agent moves a paddle on the bottom row (left /
    stay / right) and is rewarded +1 for catching, -1 for missing.
    Observations are (H, W, 1) float32 images — the procedural stand-in
    for ALE in this image-free environment (reference pixel pipeline:
    `rllib/env/wrappers/atari_wrappers.py:324`); PPO with a small CNN
    solves it in a few thousand steps."""

    def __init__(self, num_envs: int = 8, seed: int = 0,
                 rows: int = 10, cols: int = 5):
        self.num_envs = num_envs
        self.rows = rows
        self.cols = cols
        self._observation_shape = (rows, cols, 1)
        self.observation_size = rows * cols
        self.num_actions = 3
        self._rng = np.random.default_rng(seed)
        self._ball_r = np.zeros(num_envs, np.int64)
        self._ball_c = np.zeros(num_envs, np.int64)
        self._paddle = np.zeros(num_envs, np.int64)

    def _spawn(self, idx: np.ndarray):
        n = len(idx)
        self._ball_r[idx] = 0
        self._ball_c[idx] = self._rng.integers(0, self.cols, n)
        self._paddle[idx] = self.cols // 2

    def _render(self) -> np.ndarray:
        obs = np.zeros(
            (self.num_envs, self.rows, self.cols, 1), np.float32
        )
        b = np.arange(self.num_envs)
        obs[b, self._ball_r, self._ball_c, 0] = 1.0
        obs[b, self.rows - 1, self._paddle, 0] = 1.0
        return obs

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._spawn(np.arange(self.num_envs))
        return self._render()

    def step(self, actions: np.ndarray):
        move = np.asarray(actions, np.int64) - 1  # {0,1,2} -> {-1,0,1}
        self._paddle = np.clip(self._paddle + move, 0, self.cols - 1)
        self._ball_r += 1
        at_bottom = self._ball_r >= self.rows - 1
        caught = at_bottom & (self._ball_c == self._paddle)
        rewards = np.where(
            at_bottom, np.where(caught, 1.0, -1.0), 0.0
        ).astype(np.float32)
        terminated = at_bottom.copy()
        truncated = np.zeros(self.num_envs, np.bool_)
        info: Dict[str, Any] = {}
        if at_bottom.any():
            info["final_observation"] = self._render()
            self._spawn(np.flatnonzero(at_bottom))
        return self._render(), rewards, terminated, truncated, info


class PendulumVectorEnv(VectorEnv):
    """Vectorized Pendulum-v1 (gymnasium classic-control dynamics):
    1-D torque in [-2, 2], obs (cos th, sin th, th_dot), 200-step
    truncation.  The standard continuous-control convergence target
    for SAC (reference: `rllib/algorithms/sac/` tunes Pendulum)."""

    MAX_STEPS = 200

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self.observation_size = 3
        self.num_actions = 0
        self.continuous = True
        self.action_dim = 1
        self.action_low = -2.0
        self.action_high = 2.0
        self._rng = np.random.default_rng(seed)
        self._th = np.zeros(num_envs)
        self._thdot = np.zeros(num_envs)
        self._steps = np.zeros(num_envs, np.int64)
        self._g, self._m, self._l, self._dt = 10.0, 1.0, 1.0, 0.05

    def _obs(self) -> np.ndarray:
        return np.stack(
            [np.cos(self._th), np.sin(self._th), self._thdot], axis=1
        ).astype(np.float32)

    def _sample(self, idx):
        n = len(idx)
        self._th[idx] = self._rng.uniform(-np.pi, np.pi, n)
        self._thdot[idx] = self._rng.uniform(-1.0, 1.0, n)
        self._steps[idx] = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._sample(np.arange(self.num_envs))
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(
            self.num_envs), self.action_low, self.action_high)
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3.0 * self._g / (2 * self._l) * np.sin(th)
            + 3.0 / (self._m * self._l**2) * u
        ) * self._dt
        thdot = np.clip(thdot, -8.0, 8.0)
        self._th = th + thdot * self._dt
        self._thdot = thdot
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        terminated = np.zeros(self.num_envs, np.bool_)
        info: Dict[str, Any] = {}
        if truncated.any():
            info["final_observation"] = self._obs()
            self._sample(np.flatnonzero(truncated))
        return (self._obs(), (-costs).astype(np.float32), terminated,
                truncated, info)


class ContinuousTargetEnv(VectorEnv):
    """One-step continuous regression env: obs x ~ U[-1,1]^d, reward
    -||x - a||^2, episode ends.  The optimal policy is a = x, so a
    working continuous actor drives return -> 0 within a few hundred
    updates — the fast deterministic convergence probe for SAC."""

    def __init__(self, num_envs: int = 8, seed: int = 0, dim: int = 2):
        self.num_envs = num_envs
        self.observation_size = dim
        self.num_actions = 0
        self.continuous = True
        self.action_dim = dim
        self.action_low = -1.0
        self.action_high = 1.0
        self._rng = np.random.default_rng(seed)
        self._x = np.zeros((num_envs, dim), np.float32)

    def _sample(self):
        self._x = self._rng.uniform(
            -1, 1, (self.num_envs, self.action_dim)
        ).astype(np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._sample()
        return self._x.copy()

    def step(self, actions: np.ndarray):
        a = np.asarray(actions, np.float32).reshape(self._x.shape)
        rewards = -np.sum((self._x - a) ** 2, axis=-1).astype(np.float32)
        terminated = np.ones(self.num_envs, np.bool_)
        info = {"final_observation": self._x.copy()}
        self._sample()
        return (self._x.copy(), rewards, terminated,
                np.zeros(self.num_envs, np.bool_), info)


class GymnasiumVectorEnv(VectorEnv):
    """Vectorization over N single gymnasium envs, owned here rather
    than via `gym.make_vec`: gymnasium's vector autoreset modes changed
    semantics across versions (next-step autoreset inserts a no-op
    transition after terminals), while rollout batches need same-step
    autoreset with the true final observation exposed."""

    def __init__(self, env_id: str, num_envs: int = 8, seed: int = 0, **kwargs):
        import gymnasium as gym

        self._envs = [gym.make(env_id, **kwargs) for _ in range(num_envs)]
        self.num_envs = num_envs
        space = self._envs[0].observation_space
        self.observation_size = int(np.prod(space.shape))
        # images and other structured obs keep their true shape; 1-D
        # obs flow through the historical flat layout
        if len(space.shape) >= 2:
            self._observation_shape = tuple(space.shape)
        self.num_actions = int(self._envs[0].action_space.n)
        self._seed = seed

    def _shape(self) -> Tuple[int, ...]:
        return self.observation_shape

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        base = seed if seed is not None else self._seed
        obs = [e.reset(seed=base + i)[0] for i, e in enumerate(self._envs)]
        return (np.stack(obs).reshape(self.num_envs, *self._shape())
                .astype(np.float32))

    def step(self, actions: np.ndarray):
        B = self.num_envs
        shape = self._shape()
        obs = np.empty((B, *shape), np.float32)
        rewards = np.empty(B, np.float32)
        terminated = np.zeros(B, np.bool_)
        truncated = np.zeros(B, np.bool_)
        final_obs = None
        for i, e in enumerate(self._envs):
            o, r, term, trunc, _ = e.step(int(actions[i]))
            rewards[i], terminated[i], truncated[i] = r, term, trunc
            if term or trunc:
                if final_obs is None:
                    final_obs = np.zeros((B, *shape), np.float32)
                final_obs[i] = np.asarray(o, np.float32).reshape(shape)
                o = e.reset()[0]  # same-step autoreset
            obs[i] = np.asarray(o, np.float32).reshape(shape)
        info: Dict[str, Any] = {}
        if final_obs is not None:
            info["final_observation"] = final_obs
        return obs, rewards, terminated, truncated, info


_BUILTIN = {
    "CartPole-v1": CartPoleVectorEnv,
    "Catch-v0": CatchPixelEnv,
    "Pendulum-v1": PendulumVectorEnv,
}


def make_vector_env(env: Any, num_envs: int, seed: int = 0, **kwargs) -> VectorEnv:
    """env may be a builtin id, a gymnasium id, or a VectorEnv factory."""
    if callable(env):
        return env(num_envs=num_envs, seed=seed, **kwargs)
    if env in _BUILTIN:
        return _BUILTIN[env](num_envs=num_envs, seed=seed)
    return GymnasiumVectorEnv(env, num_envs=num_envs, seed=seed, **kwargs)
