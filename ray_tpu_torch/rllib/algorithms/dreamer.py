"""DreamerV3 (compact): model-based RL with an RSSM world model and an
actor-critic trained purely in imagination.

Reference: `rllib/algorithms/dreamerv3/` (`dreamerv3.py`,
`torch/dreamerv3_torch_learner.py`, `utils/summaries.py`) — the
DreamerV3 recipe (Hafner et al. 2023).  This is a faithful-but-compact
implementation of its core mechanics, supporting both vector and
pixel observations (conv encoder + deconv decoder, see DreamerModel):

- **RSSM**: deterministic GRU core + categorical stochastic latent
  (straight-through gradients), posterior from (h, obs embedding),
  prior from h alone, unrolled step by step in eager PyTorch on the
  learner's device (the JAX package's `lax.scan`);
- **symlog predictions** for reconstruction and reward (DreamerV3's
  scale-free regression trick);
- **KL balancing with free bits** between prior and posterior;
- **imagination training**: H-step latent rollouts from posterior
  states, lambda-returns over imagined rewards/continues, actor loss =
  reinforce-on-lambda-return + entropy, critic regresses symlog
  lambda-returns with an EMA target critic.

Deliberate reductions vs the full reference stack (documented, not
hidden): reinforce actor gradient only (no dynamics backprop mixing),
percentile return normalization reduced to EMA std scaling, no twohot
critic bins.

The port, against the JAX package's module:
- params are the JAX package's trees (dicts of lists of `{"w", "b"}`,
  conv and deconv weights HWIO) of torch tensors on the learner's
  device (`learners(device=...)`, the card unless the caller asks for
  the CPU), drawn from one `torch.Generator`;
- the two jitted updates are two eager updates (`_wm_update`,
  `_ac_update`) under the learner's TF32-off scope, each of the three
  optax Adams the learner's `AdamW` (no clip, no weight decay);
- every categorical draw is `argmax(logits + Gumbel noise)`, as
  `jax.random.categorical` draws: the noise is an optional argument of
  the draws' shape (`_sample_categorical`, `rssm_observe`, `imagine`),
  drawn from the algorithm's generator on the device when not given,
  so a test can inject the noise of JAX's own keys;
- the decoder's transposed convolution is `jax.lax.conv_transpose`'s
  (SAME padding, kernel not flipped): `conv_transpose_same`;
- each `stop_gradient` is a `.detach()` at its place; the imagination
  rollout, the imagined rewards and continues and the target critic
  take no gradient in the reference's updates, so they run without
  autograd here.
The replay, the runners' numpy policy (`_DreamerPolicy`) and the
config are the reference's.  torch is imported inside the functions
that compute: runner actors unpickle `_DreamerPolicy`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup


# ----------------------------------------------------------------------
# numerics
# ----------------------------------------------------------------------
def symlog(x):
    import torch

    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    import torch

    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def gumbel(shape, generator, device):
    """Gumbel noise as `jax.random.gumbel` draws it: -log(-log(u)), u
    uniform clamped into [tiny, 1) so every draw is finite."""
    import torch

    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2.0**-24)))


def conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """`jax.lax.conv_transpose`'s SAME pads of one spatial dim (its
    `_conv_transpose_padding`): on the stride-dilated input, `pad_len =
    k + s - 2`, `k - 1` before it when `s > k - 1`, else the ceiling
    half; the rest after (k 4, s 2: (2, 2); k 3, s 2: (2, 1))."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


def conv_transpose_same(x, w, s: int):
    """`jax.lax.conv_transpose(x, w, (s, s), "SAME", dimension_numbers=
    ("NHWC", "HWIO", "NHWC"))`: the input dilated by the stride, padded
    (`conv_transpose_padding`) and cross-correlated with the HWIO kernel
    as it is (not flipped), so the output is s times the input a side.

    Written as `conv_transpose2d` (a scatter of every input pixel
    through the kernel) with the kernel flipped: its full output is the
    correlation padded (k - 1, k - 1), so JAX's window starts k - 1 -
    pad_a in, and `output_padding` extends the end where pad_b reaches
    past k - 1 (s > k).  NHWC at the edges, NCHW inside."""
    import torch.nn.functional as F

    k = w.shape[0]
    pad_a, _ = conv_transpose_padding(k, s)
    x = x.permute(0, 3, 1, 2)
    h, wd = x.shape[2] * s, x.shape[3] * s
    y = F.conv_transpose2d(x, w.flip(0, 1).permute(2, 3, 0, 1), stride=s,
                           output_padding=max(0, s - 1 - pad_a))
    off = k - 1 - pad_a
    return y[:, :, off:off + h, off:off + wd].permute(0, 2, 3, 1)


class DreamerConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.actor_lr = 8e-5
        self.critic_lr = 8e-5
        # RSSM sizes (compact: 8 categoricals x 8 classes)
        self.deter_size = 128
        self.stoch_groups = 8
        self.stoch_classes = 8
        self.embed_hidden = (128,)
        self.head_hidden = (128,)
        # pixel-obs mode (image envs): conv encoder + deconv decoder
        # (reference: dreamerv3 CNN encoder/decoder for Atari/DMC)
        self.conv_filters = ((16, 4, 2), (32, 4, 2))
        # world-model training
        self.batch_length = 16
        self.batch_segments = 16
        self.free_bits = 1.0
        self.kl_balance = 0.8
        self.replay_capacity = 100_000
        # imagination
        self.horizon = 15
        self.gamma = 0.997
        self.lambda_ = 0.95
        self.entropy_coeff = 3e-3
        self.critic_ema = 0.98
        self.num_updates_per_iter = 8

    @property
    def algo_class(self):
        return Dreamer


# ----------------------------------------------------------------------
# parameter init helpers
# ----------------------------------------------------------------------
def _mlp_init(generator, dims: List[int], out_scale: float = 1.0):
    """The reference's layers (`w` normal scaled by He's sqrt(2 / in),
    0.01 on the last, `b` zero), drawn from `generator` on the CPU."""
    import torch

    layers = []
    for i, (m, n) in enumerate(zip(dims[:-1], dims[1:])):
        last = i == len(dims) - 2
        scale = 0.01 * out_scale if last else float(np.sqrt(2.0 / m))
        layers.append({
            "w": torch.randn((m, n), generator=generator,
                             dtype=torch.float32) * scale,
            "b": torch.zeros((n,), dtype=torch.float32),
        })
    return layers


def _mlp(layers, x, act_last=False):
    import torch.nn.functional as F

    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if act_last or i < len(layers) - 1:
            x = F.silu(x)
    return x


class DreamerModel:
    """Pure-function world model + actor + critic (params as pytrees).

    `obs_shape` of length 3 switches to pixel mode: conv encoder +
    deconv decoder (reference: dreamerv3's CNN encoder/decoder for
    Atari/DMC); otherwise MLP encoder/decoder over flat vectors."""

    def __init__(self, cfg: DreamerConfig, obs_dim: int, num_actions: int,
                 obs_shape: Optional[Tuple[int, ...]] = None):
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.obs_shape = tuple(obs_shape or (obs_dim,))
        self.pixel = len(self.obs_shape) == 3
        self.num_actions = num_actions
        self.stoch_size = cfg.stoch_groups * cfg.stoch_classes
        self.feat_size = cfg.deter_size + self.stoch_size
        if self.pixel:
            from ray_tpu_torch.rllib.core.rl_module import conv_out_dims

            # per-conv-layer output spatial dims (SAME padding, ceil)
            self.conv_dims = conv_out_dims(
                self.obs_shape[0], self.obs_shape[1], cfg.conv_filters
            )
            h, w = self.conv_dims[-1]
            self._conv_flat = h * w * cfg.conv_filters[-1][0]


    # -- init ----------------------------------------------------------
    def _init_conv_encoder(self, generator):
        from ray_tpu_torch.rllib.core.rl_module import conv_stack_init

        cfg = self.cfg
        return {
            "conv": conv_stack_init(
                generator, self.obs_shape[-1], cfg.conv_filters
            ),
            "dense": _mlp_init(
                generator, [self._conv_flat, *cfg.embed_hidden]
            ),
        }

    def _init_deconv_decoder(self, generator):
        import torch

        cfg = self.cfg
        h0, w0 = self.conv_dims[-1]
        c0 = cfg.conv_filters[-1][0]
        dense = _mlp_init(generator, [self.feat_size, h0 * w0 * c0])
        deconv = []
        # mirror the encoder stack in reverse; the last deconv emits
        # the obs channels with a small-scale linear output
        chans = [c for c, _k, _s in cfg.conv_filters]
        in_chans = chans[::-1]
        out_chans = chans[-2::-1] + [self.obs_shape[-1]]
        kernels = [k for _c, k, _s in cfg.conv_filters][::-1]
        strides = [s for _c, _k, s in cfg.conv_filters][::-1]
        for i, (ci, co, k, _s) in enumerate(
            zip(in_chans, out_chans, kernels, strides)
        ):
            last = i == len(in_chans) - 1
            scale = 0.01 if last else float(np.sqrt(2.0 / (k * k * ci)))
            deconv.append({
                "w": torch.randn((k, k, ci, co), generator=generator,
                                 dtype=torch.float32) * scale,
                "b": torch.zeros((co,), dtype=torch.float32),
            })
        return {"dense": dense, "deconv": deconv}

    def init_params(self, generator):
        """The world model's tree of f32 CPU tensors, drawn from
        `generator` (a `torch.Generator`) in the reference's key order:
        encoder, gru, prior, posterior, decoder, reward, cont."""
        cfg = self.cfg
        D, S, A = cfg.deter_size, self.stoch_size, self.num_actions
        E = cfg.embed_hidden[-1]
        if self.pixel:
            encoder = self._init_conv_encoder(generator)
        else:
            encoder = _mlp_init(generator, [self.obs_dim, *cfg.embed_hidden])
        # GRU: input = [stoch + action_onehot] -> 3 gates over deter
        gru = _mlp_init(generator, [S + A + D, 3 * D])
        prior = _mlp_init(generator, [D, *cfg.head_hidden, S])
        posterior = _mlp_init(generator, [D + E, *cfg.head_hidden, S])
        if self.pixel:
            decoder = self._init_deconv_decoder(generator)
        else:
            decoder = _mlp_init(generator, [self.feat_size, *cfg.head_hidden,
                                            self.obs_dim])
        return {
            "encoder": encoder,
            "gru": gru,
            "prior": prior,
            "posterior": posterior,
            "decoder": decoder,
            "reward": _mlp_init(generator,
                                [self.feat_size, *cfg.head_hidden, 1]),
            "cont": _mlp_init(generator,
                              [self.feat_size, *cfg.head_hidden, 1]),
        }

    # -- encoder/decoder (pixel or vector) -----------------------------
    def encode(self, params, obs_seq):
        """obs_seq [L, B, *obs_shape] -> embeddings [L, B, E]."""
        import torch.nn.functional as F

        if not self.pixel:
            return _mlp(params["encoder"], symlog(obs_seq), act_last=True)
        from ray_tpu_torch.rllib.core.rl_module import conv_stack_apply

        enc = params["encoder"]
        L, B = obs_seq.shape[:2]
        x = obs_seq.reshape(L * B, *self.obs_shape)
        x = conv_stack_apply(
            x=x, conv_params=enc["conv"],
            conv_filters=self.cfg.conv_filters, activation=F.silu,
        )
        x = x.reshape(L * B, -1)
        x = _mlp(enc["dense"], x, act_last=True)
        return x.reshape(L, B, -1)

    def decode(self, params, feats):
        """feats [L, B, F] -> reconstruction [L, B, *obs_shape] (pixel)
        or [L, B, obs_dim] symlog-space (vector)."""
        import torch.nn.functional as F

        if not self.pixel:
            return _mlp(params["decoder"], feats)
        dec = params["decoder"]
        L, B = feats.shape[:2]
        h0, w0 = self.conv_dims[-1]
        c0 = self.cfg.conv_filters[-1][0]
        x = _mlp(dec["dense"], feats.reshape(L * B, -1), act_last=True)
        x = x.reshape(L * B, h0, w0, c0)
        strides = [s for _c, _k, s in self.cfg.conv_filters][::-1]
        targets = self.conv_dims[-2::-1]  # spatial dims to restore
        for i, (lyr, s, (th, tw)) in enumerate(
            zip(dec["deconv"], strides, targets)
        ):
            x = conv_transpose_same(x, lyr["w"], s) + lyr["b"]
            x = x[:, :th, :tw, :]  # crop ceil-division overshoot
            if i < len(dec["deconv"]) - 1:
                x = F.silu(x)
        return x.reshape(L, B, *self.obs_shape)

    def init_actor_critic(self, generator):
        cfg = self.cfg
        return (
            _mlp_init(generator, [self.feat_size, *cfg.head_hidden,
                                  self.num_actions]),
            _mlp_init(generator, [self.feat_size, *cfg.head_hidden, 1]),
        )

    # -- RSSM ----------------------------------------------------------
    def _sample_categorical(self, logits, noise):
        """Straight-through categorical sample over grouped classes.
        logits [..., G*C] -> one-hot sample [..., G*C] with gradients
        flowing through the softmax probabilities (DreamerV3's
        straight-through estimator) + 1% uniform mix for exploration.
        `noise` [..., G, C] is the draw's Gumbel noise: the sample is
        `argmax(log(probs) + noise)`, `jax.random.categorical`'s."""
        import torch
        import torch.nn.functional as F

        cfg = self.cfg
        shape = logits.shape[:-1]
        lg = logits.reshape(*shape, cfg.stoch_groups, cfg.stoch_classes)
        probs = 0.99 * torch.softmax(lg, dim=-1) + 0.01 / cfg.stoch_classes
        idx = torch.argmax(noise + torch.log(probs), dim=-1)
        onehot = F.one_hot(idx, cfg.stoch_classes).to(probs.dtype)
        st = onehot + probs - probs.detach()
        return st.reshape(*shape, -1), torch.log(probs)

    def _noise(self, noise, shape, generator, device):
        return noise if noise is not None else gumbel(shape, generator,
                                                      device)

    def rssm_observe(self, params, obs_seq, action_seq, first_h=None,
                     noise=None, generator=None):
        """Posterior rollout over an observed segment.

        obs_seq [L, B, obs], action_seq [L, B] (action taken at t-1,
        one-hot'ed inside) -> (feats [L, B, F], prior/post logits, h).
        `noise` [L, B, G, C] is the posterior draws' Gumbel noise (one
        step a row); without it, `generator` draws it.
        """
        import torch
        import torch.nn.functional as F

        cfg = self.cfg
        L, B = action_seq.shape
        embed = self.encode(params, obs_seq)
        a_onehot = F.one_hot(action_seq.long(), self.num_actions).to(
            embed.dtype)
        h = (
            first_h if first_h is not None
            else torch.zeros((B, cfg.deter_size), dtype=torch.float32,
                             device=embed.device)
        )
        z = torch.zeros((B, self.stoch_size), dtype=torch.float32,
                        device=embed.device)
        noise = self._noise(noise, (L, B, cfg.stoch_groups,
                                    cfg.stoch_classes), generator,
                            embed.device)
        feats, priors, posts, hs = [], [], [], []
        for t in range(L):
            h = self._gru_step(params, h, z, a_onehot[t])
            prior_logits = _mlp(params["prior"], h)
            post_logits = _mlp(
                params["posterior"], torch.cat([h, embed[t]], dim=-1)
            )
            z, _ = self._sample_categorical(post_logits, noise[t])
            feats.append(torch.cat([h, z], dim=-1))
            priors.append(prior_logits)
            posts.append(post_logits)
            hs.append(h)
        return (torch.stack(feats), torch.stack(priors), torch.stack(posts),
                torch.stack(hs))

    def _gru_step(self, params, h, stoch, a_onehot):
        """Standard GRU cell over the deterministic state."""
        import torch

        x = torch.cat([stoch, a_onehot, h], dim=-1)
        gates = _mlp(params["gru"], x)
        r, u, c = torch.chunk(gates, 3, dim=-1)
        r = torch.sigmoid(r)
        u = torch.sigmoid(u)
        c = torch.tanh(r * c)
        return u * c + (1.0 - u) * h

    # -- losses --------------------------------------------------------
    def world_model_loss(self, params, batch, noise=None, generator=None):
        """`batch`: tensors on the params' device.  Returns (loss,
        (metrics, posterior h, feats)), the last two detached."""
        import torch

        cfg = self.cfg
        obs = batch["obs"]            # [L, B, obs]
        actions = batch["prev_actions"]  # [L, B]
        rewards = batch["rewards"]    # [L, B]
        cont = 1.0 - batch["terminated"].to(torch.float32)

        feats, priors, posts, hs = self.rssm_observe(
            params, obs, actions, noise=noise, generator=generator
        )
        recon = self.decode(params, feats)
        if self.pixel:
            # pixel decoder is a unit-variance Gaussian on [0,1] frames
            # (reference: dreamerv3 MSE image loss, summed over pixels)
            recon_loss = torch.mean(torch.sum(
                (recon - obs) ** 2,
                dim=tuple(range(2, recon.ndim)),
            ))
        else:
            recon_loss = torch.mean(torch.sum(
                (recon - symlog(obs)) ** 2, dim=-1
            ))
        rew_pred = _mlp(params["reward"], feats)[..., 0]
        reward_loss = torch.mean((rew_pred - symlog(rewards)) ** 2)
        cont_logit = _mlp(params["cont"], feats)[..., 0]
        cont_loss = torch.mean(
            torch.clamp(cont_logit, min=0) - cont_logit * cont
            + torch.log1p(torch.exp(-torch.abs(cont_logit)))
        )

        # KL balance with free bits (DreamerV3 sec. 3): the posterior
        # is pulled toward the prior weakly, the prior toward the
        # posterior strongly
        def kl(p_logits, q_logits):
            G, C = cfg.stoch_groups, cfg.stoch_classes
            p = torch.log_softmax(
                p_logits.reshape(*p_logits.shape[:-1], G, C), dim=-1)
            q = torch.log_softmax(
                q_logits.reshape(*q_logits.shape[:-1], G, C), dim=-1)
            return torch.sum(torch.exp(p) * (p - q), dim=(-1, -2))

        dyn = torch.clamp(
            kl(posts.detach(), priors), min=cfg.free_bits
        ).mean()
        rep = torch.clamp(
            kl(posts, priors.detach()), min=cfg.free_bits
        ).mean()
        kl_loss = cfg.kl_balance * dyn + (1 - cfg.kl_balance) * rep

        loss = recon_loss + reward_loss + cont_loss + kl_loss
        metrics = {
            "wm_loss": loss,
            "recon_loss": recon_loss,
            "reward_loss": reward_loss,
            "cont_loss": cont_loss,
            "kl_loss": kl_loss,
        }
        # posterior states ride out as imagination start states so the
        # caller never re-runs the RSSM rollout
        aux = (metrics, hs.detach(), feats.detach())
        return loss, aux

    # -- imagination ---------------------------------------------------
    def imagine(self, params, actor, start_h, start_z, noise=None,
                generator=None):
        """H-step latent rollout following the actor; returns feats
        [H+1, N, F], actions [H, N], logps [H, N].  `noise` is the
        draws' Gumbel noise, (actions [H, N, A], latents [H, N, G, C]);
        without it, `generator` draws it."""
        import torch
        import torch.nn.functional as F

        cfg = self.cfg
        H, N = cfg.horizon, start_h.shape[0]
        dev = start_h.device
        noise_a, noise_z = noise if noise is not None else (None, None)
        noise_a = self._noise(noise_a, (H, N, self.num_actions), generator,
                              dev)
        noise_z = self._noise(noise_z, (H, N, cfg.stoch_groups,
                                        cfg.stoch_classes), generator, dev)
        h, z = start_h, start_z
        feats, actions, logps = [], [], []
        for t in range(H):
            feat = torch.cat([h, z], dim=-1)
            logits = _mlp(actor, feat.detach())
            action = torch.argmax(logits + noise_a[t], dim=-1)
            logp = torch.gather(
                torch.log_softmax(logits, dim=-1), -1, action[:, None]
            )[:, 0]
            a_onehot = F.one_hot(action, self.num_actions).to(feat.dtype)
            h = self._gru_step(params, h, z, a_onehot)
            prior_logits = _mlp(params["prior"], h)
            z, _ = self._sample_categorical(prior_logits, noise_z[t])
            feats.append(feat)
            actions.append(action)
            logps.append(logp)
        last = torch.cat([h, z], dim=-1)
        feats.append(last)
        return torch.stack(feats), torch.stack(actions), torch.stack(logps)


def lambda_returns(rewards, conts, values, last_value, gamma, lambda_):
    """Bootstrapped lambda-returns over imagined trajectories [H, N],
    the recursion run backwards from `last_value`."""
    import torch

    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    rets = [None] * rewards.shape[0]
    next_ret = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        next_ret = rewards[t] + gamma * conts[t] * (
            (1 - lambda_) * v_next[t] + lambda_ * next_ret
        )
        rets[t] = next_ret
    return torch.stack(rets)


class Dreamer(Algorithm):
    """Compact DreamerV3 (reference: `rllib/algorithms/dreamerv3/`)."""

    def setup_components(self):
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models.bridge import tree_map
        from ray_tpu_torch.models.gpt2 import AdamW

        cfg = self.config
        # the learner's device first: without a card this raises before
        # any runner starts
        self.device = resolve_device(cfg.learner_device)
        self.env_runner_group = EnvRunnerGroup(
            cfg.env, cfg.num_env_runners, cfg.num_envs_per_env_runner,
            cfg.rollout_fragment_length, seed=cfg.seed,
            env_kwargs=cfg.env_kwargs,
            connector=cfg.env_to_module_connector,
        )
        spec = self.env_runner_group.env_spec()
        from ray_tpu_torch.rllib.core.rl_module import require_discrete_actions

        require_discrete_actions(spec, "DreamerV3")
        self.model = DreamerModel(
            cfg, spec["observation_size"], spec["num_actions"],
            obs_shape=spec.get("observation_shape"),
        )
        gen = torch.Generator().manual_seed(cfg.seed)
        self.wm_params = self._trainable(self.model.init_params(gen))
        actor, critic = self.model.init_actor_critic(gen)
        self.actor_params = self._trainable(actor)
        self.critic_params = self._trainable(critic)
        self.target_critic = tree_map(lambda t: t.detach().clone(),
                                      self.critic_params)
        # the Gumbel noise of every draw, on the learner's device
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

        def adam(lr):
            return AdamW(lambda _count: lr, max_norm=math.inf, b1=0.9,
                         b2=0.999, eps=1e-8, weight_decay=0.0)

        self.wm_opt = adam(cfg.lr)
        self.actor_opt = adam(cfg.actor_lr)
        self.critic_opt = adam(cfg.critic_lr)
        self.wm_opt_state = self.wm_opt.init(self.wm_params)
        self.actor_opt_state = self.actor_opt.init(self.actor_params)
        self.critic_opt_state = self.critic_opt.init(self.critic_params)
        self._replay: List[Dict[str, np.ndarray]] = []
        self._replay_rows = 0
        self._ret_std = 1.0  # EMA return-scale normalizer
        self._np_rng = np.random.default_rng(cfg.seed)
        # the rollout policy: actor over posterior features, computed
        # with a tiny numpy RSSM mirror is complex — instead runners
        # sample with the actor over a feature proxy.  Simpler and
        # faithful enough for vector envs: run rollouts DIRECTLY with
        # the actor on (h=0, z from posterior of a 1-step observe).
        self._policy_module = _DreamerPolicy(self)
        self.env_runner_group.sync_weights(self._policy_weights())

    def _trainable(self, tree):
        from ray_tpu_torch.models.bridge import tree_map

        return tree_map(
            lambda t: t.detach().to(self.device).requires_grad_(True), tree)

    # -- the two updates -----------------------------------------------
    def _wm_update(self, batch: Dict[str, np.ndarray], noise=None):
        """One world-model step on the learner's device (the reference's
        jitted `wm_update`): the loss's gradient, Adam on `wm_params` in
        place.  `noise` [L, B, G, C]: the posterior draws' Gumbel noise
        (the generator's when None).  Returns (metrics as 0-d tensors,
        start_h [L*B, D], start_z [L*B, S]), the last two detached."""
        import torch

        from ray_tpu_torch.models.bridge import tree_leaves
        from ray_tpu_torch.rllib.core.learner import _full_f32

        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                 for k, v in batch.items()}
        with _full_f32():
            loss, (metrics, hs, feats) = self.model.world_model_loss(
                self.wm_params, batch, noise, self._gen)
            grads = torch.autograd.grad(loss, tree_leaves(self.wm_params))
        self.wm_opt_state, _ = self.wm_opt.update(
            list(grads), self.wm_opt_state, self.wm_params)
        D = self.config.deter_size
        start_h = hs.reshape(-1, D)
        start_z = feats.reshape(-1, feats.shape[-1])[:, D:]
        return ({k: v.detach() for k, v in metrics.items()}, start_h,
                start_z)

    def _ac_update(self, start_h, start_z, ret_scale: float, noise=None):
        """One actor and one critic step in imagination (the reference's
        jitted `ac_update`), the target critic's EMA after them.
        `noise`: (actions [H, N, A], latents [H, N, G, C]) Gumbel noise
        (the generator's when None).  Returns (metrics as 0-d tensors,
        the imagined returns' population std as a 0-d tensor)."""
        import torch

        from ray_tpu_torch.models.bridge import tree_leaves
        from ray_tpu_torch.rllib.core.learner import _full_f32

        model, cfg = self.model, self.config
        wm, actor = self.wm_params, self.actor_params
        critic, target = self.critic_params, self.target_critic
        with _full_f32():
            with torch.no_grad():
                feats, actions, _logps = model.imagine(
                    wm, actor, start_h, start_z, noise, self._gen)
                rewards = symexp(_mlp(wm["reward"], feats[:-1])[..., 0])
                conts = torch.sigmoid(_mlp(wm["cont"], feats)[..., 0])
                values = symexp(_mlp(critic, feats)[..., 0])
                tvalues = symexp(_mlp(target, feats)[..., 0])
                rets = lambda_returns(
                    rewards, conts[:-1], tvalues[:-1], tvalues[-1],
                    cfg.gamma, cfg.lambda_,
                )
                values = values[:-1]
                adv = (rets - values) / max(ret_scale, 1.0)
                # discount weights: imagined steps past a predicted
                # episode end contribute less
                w = torch.cumprod(
                    torch.cat([torch.ones_like(conts[:1]),
                               conts[:-2] * cfg.gamma], dim=0),
                    dim=0,
                )

            pred = _mlp(critic, feats[:-1])[..., 0]
            closs = torch.mean((pred - symlog(rets)) ** 2)
            cgrads = torch.autograd.grad(closs, tree_leaves(critic))

            logits = _mlp(actor, feats[:-1])
            logp_all = torch.log_softmax(logits, dim=-1)
            lp = torch.gather(logp_all, -1, actions[..., None])[..., 0]
            ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all,
                                        dim=-1))
            aloss = -torch.mean(w * lp * adv) - cfg.entropy_coeff * ent
            agrads = torch.autograd.grad(aloss, tree_leaves(actor))
        self.critic_opt_state, _ = self.critic_opt.update(
            list(cgrads), self.critic_opt_state, critic)
        self.actor_opt_state, _ = self.actor_opt.update(
            list(agrads), self.actor_opt_state, actor)
        with torch.no_grad():
            ema = cfg.critic_ema
            for t, c in zip(tree_leaves(target), tree_leaves(critic)):
                t.copy_(ema * t + (1 - ema) * c)
        return ({
            "actor_loss": aloss.detach(),
            "critic_loss": closs.detach(),
            "actor_entropy": ent.detach(),
            "imagined_return_mean": torch.mean(rets),
        }, rets.std(correction=0))

    # -- rollout policy ------------------------------------------------
    def _policy_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import params_to_numpy

        return {
            "wm": params_to_numpy(self.wm_params),
            "actor": params_to_numpy(self.actor_params),
        }

    # -- replay --------------------------------------------------------
    def _add_to_replay(self, samples: List[Dict[str, np.ndarray]]):
        for s in samples:
            T, B = s["actions"].shape
            seg = {
                "obs": s["obs"],
                # action that LED to obs[t] (shifted; a_{-1}=0)
                "prev_actions": np.concatenate(
                    [np.zeros((1, B), np.int32), s["actions"][:-1]], axis=0
                ),
                "rewards": s["rewards"],
                "terminated": s["terminated"],
            }
            self._replay.append(seg)
            self._replay_rows += T * B
        cap = self.config.replay_capacity
        while self._replay_rows > cap and len(self._replay) > 1:
            old = self._replay.pop(0)
            self._replay_rows -= (
                old["rewards"].shape[0] * old["rewards"].shape[1]
            )

    def _sample_segments(self):
        cfg = self.config
        L, S = cfg.batch_length, cfg.batch_segments
        obs_l, act_l, rew_l, term_l = [], [], [], []
        for _ in range(S):
            seg = self._replay[self._np_rng.integers(len(self._replay))]
            T, B = seg["rewards"].shape
            b = self._np_rng.integers(B)
            t0 = self._np_rng.integers(max(T - L, 0) + 1)
            sl = slice(t0, t0 + L)

            def pad(x):
                out = x[sl, b]
                if out.shape[0] < L:
                    reps = [out[-1:]] * (L - out.shape[0])
                    out = np.concatenate([out, *reps], axis=0)
                return out

            obs_l.append(pad(seg["obs"]))
            act_l.append(pad(seg["prev_actions"]))
            rew_l.append(pad(seg["rewards"]))
            term_l.append(pad(seg["terminated"]))
        return {
            "obs": np.stack(obs_l, axis=1).astype(np.float32),
            "prev_actions": np.stack(act_l, axis=1).astype(np.int32),
            "rewards": np.stack(rew_l, axis=1).astype(np.float32),
            "terminated": np.stack(term_l, axis=1),
        }

    # -- train ---------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        samples = self.env_runner_group.sample(self._policy_module)
        self._add_to_replay(samples)

        metrics_acc: List[Dict[str, float]] = []
        for _ in range(cfg.num_updates_per_iter):
            batch = self._sample_segments()
            wm_metrics, start_h, start_z = self._wm_update(batch)
            ac_metrics, ret_std = self._ac_update(start_h, start_z,
                                                  self._ret_std)
            # the updates' one host sync each: the return scale and the
            # metrics come back as floats, as the reference reads them
            self._ret_std = 0.99 * self._ret_std + 0.01 * float(ret_std)
            metrics_acc.append({
                **{k: float(v) for k, v in wm_metrics.items()},
                **{k: float(v) for k, v in ac_metrics.items()},
            })

        self.env_runner_group.sync_weights(self._policy_weights())
        result = {
            k: float(np.mean([m[k] for m in metrics_acc]))
            for k in metrics_acc[0]
        }
        result["replay_rows"] = self._replay_rows
        self._track_episode_metrics(
            self.env_runner_group.pop_metrics(), result
        )
        return result

    def get_state(self) -> Dict[str, Any]:
        """numpy: the four trees, each optimizer's state in optax's
        Adam layout (`count`, `mu`, `nu` shaped like its params)."""
        from ray_tpu_torch.models.bridge import adam_state_to_numpy
        from ray_tpu_torch.rllib.core.rl_module import params_to_numpy

        return {
            "wm": params_to_numpy(self.wm_params),
            "actor": params_to_numpy(self.actor_params),
            "critic": params_to_numpy(self.critic_params),
            "target_critic": params_to_numpy(self.target_critic),
            "wm_opt": adam_state_to_numpy(self.wm_opt_state,
                                          self.wm_params),
            "actor_opt": adam_state_to_numpy(self.actor_opt_state,
                                             self.actor_params),
            "critic_opt": adam_state_to_numpy(self.critic_opt_state,
                                              self.critic_params),
            "ret_std": self._ret_std,
            "connector": self.env_runner_group.connector_state(),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]):
        from ray_tpu_torch.models.bridge import (
            adam_state_from_numpy,
            params_from_numpy,
        )

        def tree(key):
            return params_from_numpy(state[key], self.device)

        self.wm_params = self._trainable(tree("wm"))
        self.actor_params = self._trainable(tree("actor"))
        self.critic_params = self._trainable(tree("critic"))
        self.target_critic = tree("target_critic")
        for key, attr in (("wm_opt", "wm_opt_state"),
                          ("actor_opt", "actor_opt_state"),
                          ("critic_opt", "critic_opt_state")):
            if key in state:
                opt = state[key]
                setattr(self, attr, adam_state_from_numpy(
                    opt["count"], opt["mu"], opt["nu"], self.device))
        self._ret_std = state.get("ret_std", self._ret_std)
        self.env_runner_group.restore_connector_state(
            state.get("connector")
        )
        self.iteration = state.get("iteration", self.iteration)
        # the FIRST post-restore rollout must use the restored policy,
        # not the random init shipped at setup
        self.env_runner_group.sync_weights(self._policy_weights())

    def stop(self):
        self.env_runner_group.stop()


class _DreamerPolicy:
    """Numpy rollout policy shipped to EnvRunners: a 1-step posterior
    (h=0) turns the observation into latent features, the actor picks.
    Matches the training-time feature construction for fresh episodes;
    cheap enough for CPU sampling actors."""

    def __init__(self, algo: Dreamer):
        self._cfg_sizes = (
            algo.model.cfg.deter_size,
            algo.model.cfg.stoch_groups,
            algo.model.cfg.stoch_classes,
        )
        self._num_actions = algo.model.num_actions
        self._pixel = algo.model.pixel
        self._conv_filters = tuple(algo.model.cfg.conv_filters)

    @staticmethod
    def _np_mlp(layers, x, act_last=False):
        for i, l in enumerate(layers):
            x = x @ np.asarray(l["w"]) + np.asarray(l["b"])
            if act_last or i < len(layers) - 1:
                x = x * (1.0 / (1.0 + np.exp(-x)))  # silu
        return x

    def _np_encode(self, enc, obs):
        if not self._pixel:
            x = np.sign(obs) * np.log1p(np.abs(obs))
            return self._np_mlp(enc, x, act_last=True)
        from ray_tpu_torch.rllib.core.rl_module import _conv2d_numpy

        x = np.asarray(obs, np.float32)
        for lyr, (_c, k, s) in zip(enc["conv"], self._conv_filters):
            x = _conv2d_numpy(x, np.asarray(lyr["w"]),
                              np.asarray(lyr["b"]), k, s)
            x = x * (1.0 / (1.0 + np.exp(-x)))  # silu
        return self._np_mlp(enc["dense"], x.reshape(x.shape[0], -1),
                            act_last=True)

    def forward_numpy(self, params, obs):
        D, G, C = self._cfg_sizes
        wm, actor = params["wm"], params["actor"]
        emb = self._np_encode(wm["encoder"], obs)
        B = obs.shape[0]
        h = np.zeros((B, D), np.float32)
        post = self._np_mlp(
            wm["posterior"], np.concatenate([h, emb], axis=-1)
        )
        lg = post.reshape(B, G, C)
        e = np.exp(lg - lg.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        z = probs.reshape(B, G * C)  # expected value (deterministic)
        feat = np.concatenate([h, z], axis=-1)
        logits = self._np_mlp(actor, feat)
        value = np.zeros(B, np.float32)  # runners don't need values here
        return logits, value
