"""RLModule: the neural-network abstraction of the new API stack.

Reference: `rllib/core/rl_module/rl_module.py` — one object owning the
policy/value networks with three forward modes (exploration, inference,
train).  The port's split is the JAX package's: parameters are a tree
of torch tensors owned by the Learner, in the JAX package's tree and
layouts (`{"pi": [{"w": [in, out], "b"}...], "vf": [...]}`, conv
weights HWIO), so bridged parameters, checkpoints and the runners'
numpy copies read the same everywhere.  Env runners receive *numpy*
copies and run `forward_numpy` (rollout inference is tiny MLP math on
CPU actors — no torch in a runner process).

torch is imported inside the functions that compute: a runner actor
unpickles a module object and must not pay for torch to do it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


class RLModule:
    """Interface: subclass for custom architectures."""

    def init_params(self, generator) -> Dict[str, Any]:
        """A tree of f32 CPU tensors drawn from `generator` (a
        `torch.Generator`); the Learner moves it onto its device."""
        raise NotImplementedError

    def forward_train(self, params, obs):
        """torch path (inside the learner's loss): returns
        (logits, value) tensors."""
        raise NotImplementedError

    def forward_numpy(self, params_np, obs: np.ndarray):
        """numpy path (env runners): returns (logits, value)."""
        raise NotImplementedError


def _normal(generator, shape, scale: float):
    import torch

    return torch.randn(shape, generator=generator,
                       dtype=torch.float32) * scale


class MLPModule(RLModule):
    """Separate policy and value MLP towers (reference default:
    `rllib/core/rl_module/default_model_config.py` fcnet)."""

    def __init__(self, observation_size: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64)):
        self.observation_size = observation_size
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def _tower_dims(self, out_dim: int) -> List[Tuple[int, int]]:
        dims = [self.observation_size, *self.hidden, out_dim]
        return list(zip(dims[:-1], dims[1:]))

    def init_tower(self, generator, out_dim: int) -> List[Dict[str, Any]]:
        """One MLP tower's layers (shared by every module family so a
        layout change happens exactly once)."""
        import torch

        layers = []
        for i, (m, n) in enumerate(self._tower_dims(out_dim)):
            scale = float(np.sqrt(2.0 / m)) if i < len(self.hidden) else 0.01
            layers.append({
                "w": _normal(generator, (m, n), scale),
                "b": torch.zeros((n,), dtype=torch.float32),
            })
        return layers

    def init_params(self, generator) -> Dict[str, Any]:
        return {
            "pi": self.init_tower(generator, self.num_actions),
            "vf": self.init_tower(generator, 1),
        }

    def forward_train(self, params, obs):
        logits = tower_torch(params["pi"], obs)
        value = tower_torch(params["vf"], obs)[..., 0]
        return logits, value

    def forward_numpy(self, params_np, obs: np.ndarray):
        logits = tower_numpy(params_np["pi"], obs)
        value = tower_numpy(params_np["vf"], obs)[..., 0]
        return logits, value


def conv_out_dims(h: int, w: int,
                  conv_filters) -> List[Tuple[int, int]]:
    """Per-layer output spatial dims of a SAME-padded strided conv
    stack (XLA's ceil-division semantics), input dims first."""
    dims = [(h, w)]
    for _c, _k, s in conv_filters:
        h, w = -(-h // s), -(-w // s)
        dims.append((h, w))
    return dims


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim, (lo, hi): the total
    `max((ceil(n/s) - 1)*s + k - n, 0)`, its floor half before and the
    rest after (asymmetric for even totals' odd halves: k 4, s 2 on 84
    pads (1, 2)).  `F.conv2d(padding="same")` refuses stride > 1."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_stack_init(generator, in_channels: int, conv_filters):
    """He-initialized HWIO conv weights for one stack (shared by every
    conv-using module family so layout changes happen exactly once)."""
    import torch

    layers = []
    c_in = in_channels
    for c_out, k, _s in conv_filters:
        layers.append({
            "w": _normal(generator, (k, k, c_in, c_out),
                         float(np.sqrt(2.0 / (k * k * c_in)))),
            "b": torch.zeros((c_out,), dtype=torch.float32),
        })
        c_in = c_out
    return layers


def conv_stack_apply(conv_params, x, conv_filters, activation):
    """SAME-padded strided conv stack on NHWC tensors, `activation`
    applied after every layer.  The weights stay HWIO (the stored
    layout) and are permuted to OIHW inside the call, so autograd
    carries their gradient back in the stored layout; the activations
    run NCHW for `conv2d` and come back NHWC, as the caller flattens
    them in the JAX package's order."""
    import torch.nn.functional as F

    x = x.permute(0, 3, 1, 2)
    for lyr, (_c, k, s) in zip(conv_params, conv_filters):
        h_lo, h_hi = same_pad(x.shape[2], k, s)
        w_lo, w_hi = same_pad(x.shape[3], k, s)
        x = F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)),
                     lyr["w"].permute(3, 2, 0, 1), lyr["b"], stride=s)
        x = activation(x)
    return x.permute(0, 2, 3, 1)


class CNNModule(RLModule):
    """Conv encoder + MLP heads for image observations.

    Reference: `rllib/core/models/configs.py:653` (`CNNEncoderConfig`)
    and `rllib/core/models/torch/encoder.py:107` (`TorchCNNEncoder`) —
    a conv stack shared by the pi and vf heads.  The torch path runs
    `conv2d` (NCHW inside `conv_stack_apply`, NHWC at its edges); the
    numpy mirror (env runners) uses im2col + one matmul per layer so
    CPU rollouts stay vectorized.

    `conv_filters`: sequence of (out_channels, kernel, stride) — the
    reference's default_model_config conv_filters shape.
    """

    def __init__(self, observation_shape: Tuple[int, int, int],
                 num_actions: int,
                 conv_filters: Tuple[Tuple[int, int, int], ...] = (
                     (16, 4, 2), (32, 4, 2), (64, 3, 2),
                 ),
                 hidden: Tuple[int, ...] = (256,)):
        if len(observation_shape) != 3:
            raise ValueError(
                f"CNNModule needs (H, W, C) observations, got "
                f"{observation_shape}"
            )
        self.observation_shape = tuple(observation_shape)
        self.num_actions = num_actions
        self.conv_filters = tuple(tuple(f) for f in conv_filters)
        self.hidden = tuple(hidden)
        h, w = conv_out_dims(observation_shape[0], observation_shape[1],
                             self.conv_filters)[-1]
        self._flat = h * w * self.conv_filters[-1][0]

    # -- init ----------------------------------------------------------
    def init_params(self, generator) -> Dict[str, Any]:
        import torch

        params: Dict[str, Any] = {
            "conv": conv_stack_init(
                generator, self.observation_shape[-1], self.conv_filters
            ),
            "dense": [],
        }
        dims = [self._flat, *self.hidden]
        for m, n in zip(dims[:-1], dims[1:]):
            params["dense"].append({
                "w": _normal(generator, (m, n), float(np.sqrt(2.0 / m))),
                "b": torch.zeros((n,), dtype=torch.float32),
            })
        feat = dims[-1]
        params["pi"] = {
            "w": _normal(generator, (feat, self.num_actions), 0.01),
            "b": torch.zeros((self.num_actions,), dtype=torch.float32),
        }
        params["vf"] = {
            "w": _normal(generator, (feat, 1), 0.01),
            "b": torch.zeros((1,), dtype=torch.float32),
        }
        return params

    # -- forward -------------------------------------------------------
    def _encode_torch(self, params, x):
        import torch

        x = conv_stack_apply(params["conv"], x.to(torch.float32),
                             self.conv_filters, torch.relu)
        x = x.reshape(x.shape[0], -1)
        for lyr in params["dense"]:
            x = torch.relu(x @ lyr["w"] + lyr["b"])
        return x

    def forward_train(self, params, obs):
        feat = self._encode_torch(params, obs)
        logits = feat @ params["pi"]["w"] + params["pi"]["b"]
        value = (feat @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
        return logits, value

    def _encode_numpy(self, params_np, x):
        x = np.asarray(x, np.float32)
        for lyr, (_c, k, s) in zip(params_np["conv"], self.conv_filters):
            x = _conv2d_numpy(x, lyr["w"], lyr["b"], k, s)
            np.maximum(x, 0.0, out=x)
        x = x.reshape(x.shape[0], -1)
        for lyr in params_np["dense"]:
            x = np.maximum(x @ lyr["w"] + lyr["b"], 0.0)
        return x

    def forward_numpy(self, params_np, obs: np.ndarray):
        feat = self._encode_numpy(params_np, obs)
        logits = feat @ params_np["pi"]["w"] + params_np["pi"]["b"]
        value = (feat @ params_np["vf"]["w"] + params_np["vf"]["b"])[..., 0]
        return logits, value


def _conv2d_numpy(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                  k: int, s: int) -> np.ndarray:
    """SAME-padded strided conv, NHWC x HWIO -> NHWC, via im2col +
    one matmul (the numpy mirror of the jax path above)."""
    n, h, win, c_in = x.shape
    h_out = -(-h // s)
    w_out = -(-win // s)
    # SAME padding totals (mirrors XLA's computation)
    pad_h = max((h_out - 1) * s + k - h, 0)
    pad_w = max((w_out - 1) * s + k - win, 0)
    x = np.pad(x, ((0, 0), (pad_h // 2, pad_h - pad_h // 2),
                   (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
    sN, sH, sW, sC = x.strides
    cols = np.lib.stride_tricks.as_strided(
        x,
        shape=(n, h_out, w_out, k, k, c_in),
        strides=(sN, sH * s, sW * s, sH, sW, sC),
        writeable=False,
    ).reshape(n * h_out * w_out, k * k * c_in)
    out = cols @ w.reshape(k * k * c_in, -1) + b
    return out.reshape(n, h_out, w_out, -1)


def tower_torch(layers, x):
    """The MLP tower forward — ONE definition for torch (and mirrored
    in tower_numpy); matmul+tanh layout changes happen here only."""
    import torch

    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def tower_numpy(layers, x):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = np.tanh(x)
    return x


def make_default_module(spec: Dict[str, Any],
                        model_cfg: Dict[str, Any]) -> RLModule:
    """Pick the default architecture from the env spec (reference:
    `rllib/core/rl_module/default_model_config.py` — conv encoder for
    image spaces, fcnet otherwise).  `spec` is an EnvRunner env_spec;
    `model_cfg` is AlgorithmConfig.model."""
    require_discrete_actions(spec, "the default policy-gradient module")
    obs_shape = tuple(
        spec.get("observation_shape", (spec["observation_size"],))
    )
    if len(obs_shape) == 3 or "conv_filters" in model_cfg:
        return CNNModule(
            obs_shape, spec["num_actions"],
            conv_filters=tuple(
                model_cfg.get(
                    "conv_filters", ((16, 4, 2), (32, 4, 2), (64, 3, 2))
                )
            ),
            hidden=tuple(model_cfg.get("hidden", (256,))),
        )
    return MLPModule(
        spec["observation_size"], spec["num_actions"],
        hidden=tuple(model_cfg.get("hidden", (64, 64))),
    )


def require_flat_obs(spec: Dict[str, Any], algo_name: str) -> None:
    """Fail fast (at setup, with a clear message) for algorithms whose
    module/replay path is MLP-only: without this, an image env dies
    with an opaque matmul shape error inside a runner actor that the
    fault-tolerant sample loop then masks as 'all env runners
    failed'."""
    shape = tuple(spec.get("observation_shape",
                           (spec["observation_size"],)))
    if len(shape) != 1:
        raise ValueError(
            f"{algo_name} supports flat observations only (got "
            f"observation_shape={shape}); for pixel envs use "
            "PPO/APPO/IMPALA (CNN encoder) or DreamerV3 (conv world "
            "model), or flatten with a connector"
        )


def require_discrete_actions(spec: Dict[str, Any],
                             algo_name: str) -> None:
    """Fail fast for discrete-only algorithms on continuous-action
    envs: without this, num_actions=0 builds a zero-width policy head
    that dies with an opaque reduction error inside a runner actor."""
    if spec.get("continuous"):
        raise ValueError(
            f"{algo_name} supports discrete action spaces only (env "
            f"reports continuous action_dim={spec.get('action_dim')}); "
            "use SAC for continuous control"
        )


def params_to_numpy(params) -> Any:
    """The learner's tensors -> a numpy tree of the same structure, each
    leaf a copy of its own (the learner updates its leaves in place, so
    a view of a CPU leaf would change under the caller)."""
    from ray_tpu_torch.models import bridge

    return bridge.params_to_numpy(bridge.tree_map(
        lambda t: t.detach().clone() if t.device.type == "cpu" else t,
        params))
