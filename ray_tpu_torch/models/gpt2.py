"""GPT-2 family in PyTorch: the training path of the JAX package's
`models/gpt2.py`.

Plain functions over a dict of tensors in the JAX layout (stacked
`[L, ...]` block leaves, `[in, out]` weights), so the weight bridge
(`models/bridge.py`) carries params across unchanged and every function
keeps its reference's name and `(cfg, params, ...)` signature.  The
layer `lax.scan` becomes a Python loop over the stacked leaves (a view
per layer); `jax.checkpoint` becomes `torch.utils.checkpoint`
(`use_reentrant=False`) per remat policy; the optax chain becomes
`AdamW`, the same arithmetic written out.

Sharded training: on DTensor params every rank gathers its blocks over
the data axes, splits the heads, the MLP and the vocabulary over tp
(`parallel.sharding.LocalShards`), and the step keeps the DTensors as
storage (see `make_train_step`).

Numerics follow the reference: f32 master weights cast to `cfg.dtype`
inside each layer (so remat replays the casts), LayerNorm with the
population variance, tanh GELU (`jax.nn.gelu`'s default), the weight-tied
lm-head, and the lse-form loss over logits in `cfg.logits_dtype` with
the logsumexp and the target gather in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.bridge import tree_leaves
from ray_tpu_torch.parallel import sharding as _sh
from ray_tpu_torch.parallel.ring_attention import select_attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0  # pretraining default; the reference applies none
    dtype: torch.dtype = torch.bfloat16  # compute dtype (params stay f32)
    attention: str = "dense"  # dense | flash | ring | ulysses (no mesh: dense)
    remat: bool = True
    # lm-head logits dtype for the LOSS path (float32 or bfloat16);
    # `forward()` always returns f32 logits
    logits_dtype: torch.dtype = torch.float32
    # kept for config parity with the reference's layer scan; an eager
    # Python loop has nothing to unroll
    scan_unroll: int = 1
    # "full": checkpoint every block; "dots": save matmul outputs,
    # recompute the rest; "names": checkpoint only the attention call
    # (the reference saves every tagged activation but the attention
    # internals: the same set); "half": checkpoint the first block of
    # each pair
    remat_policy: str = "full"
    # the last `remat_skip` blocks run without checkpointing ("full" only)
    remat_skip: int = 0

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots", "names", "half"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                "expected 'full', 'dots', 'names', or 'half'"
            )
        if self.remat_policy == "half" and self.n_layer % 2:
            raise ValueError("remat_policy='half' needs an even n_layer")
        if self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        if not 0 <= self.remat_skip <= self.n_layer:
            raise ValueError(
                f"remat_skip must be in [0, n_layer], got {self.remat_skip}"
            )
        if self.remat_skip and self.remat_policy != "full":
            raise ValueError(
                "remat_skip composes with remat_policy='full' only"
            )

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "GPT2Config":
        return GPT2Config(
            vocab_size=vocab_size, n_positions=128, n_embd=64, n_layer=2,
            n_head=4,
        )


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(cfg: GPT2Config,
                generator: Union[int, torch.Generator] = 0,
                device=None) -> Dict:
    """Random f32 params in the JAX layout, drawn from `generator` (a
    seed or a `torch.Generator` on `device`).  The draws differ from
    `jax.random`'s: to compare with the JAX package, copy its params
    across with `models.bridge.params_from_numpy`."""
    device = resolve_device(device)
    if isinstance(generator, int):
        gen = torch.Generator(device=device)
        gen.manual_seed(generator)
    else:
        gen = generator
    std = 0.02
    L, E, H = cfg.n_layer, cfg.n_embd, 4 * cfg.n_embd
    proj_std = std / math.sqrt(2 * cfg.n_layer)

    def n(shape, s=std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(s)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        "wte": n((cfg.vocab_size, E)),
        "wpe": n((cfg.n_positions, E), 0.01),
        "blocks": {
            "ln1_g": ones(L, E),
            "ln1_b": zeros(L, E),
            "attn_qkv_w": n((L, E, 3 * E)),
            "attn_qkv_b": zeros(L, 3 * E),
            "attn_out_w": n((L, E, E), proj_std),
            "attn_out_b": zeros(L, E),
            "ln2_g": ones(L, E),
            "ln2_b": zeros(L, E),
            "mlp_fc_w": n((L, E, H)),
            "mlp_fc_b": zeros(L, H),
            "mlp_out_w": n((L, H, E), proj_std),
            "mlp_out_b": zeros(L, E),
        },
        "lnf_g": ones(E),
        "lnf_b": zeros(E),
    }


def logical_axes(cfg: GPT2Config) -> Dict:
    """Logical-axis tree matching init_params (leading None = stacked
    layer dim), as data for a sharding rule table."""
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1_g": (None, "embed"),
            "ln1_b": (None, "embed"),
            "attn_qkv_w": (None, "embed", "heads"),
            "attn_qkv_b": (None, "heads"),
            "attn_out_w": (None, "heads", "embed"),
            "attn_out_b": (None, "embed"),
            "ln2_g": (None, "embed"),
            "ln2_b": (None, "embed"),
            "mlp_fc_w": (None, "embed", "mlp"),
            "mlp_fc_b": (None, "mlp"),
            "mlp_out_w": (None, "mlp", "embed"),
            "mlp_out_b": (None, "embed"),
        },
        "lnf_g": ("embed",),
        "lnf_b": ("embed",),
    }


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
_LAYER_KEYS = ("ln1_g", "ln1_b", "attn_qkv_w", "attn_qkv_b", "attn_out_w",
               "attn_out_b", "ln2_g", "ln2_b", "mlp_fc_w", "mlp_fc_b",
               "mlp_out_w", "mlp_out_b")

# remat_policy="dots": the reference's dots_with_no_batch_dims_saveable
# saves the projections' outputs (an `x @ w` reaches aten.mm / addmm)
# and recomputes the batched attention products (bmm)
_SAVEABLE_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVEABLE_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _block(cfg: GPT2Config, mesh, shards, remat_attention: bool, x,
           *weights):
    """One transformer block; `weights` are one layer's leaves in
    `_LAYER_KEYS` order, cast to the compute dtype here.  Under a
    sharded step (`shards`) they are this rank's tp blocks: the heads and
    the MLP's columns split over tp, `enter` before the column-parallel
    products, `exit` after the row-parallel ones."""
    p = dict(zip(_LAYER_KEYS, weights))
    dt = cfg.dtype
    B, T, _ = x.shape
    h = _layer_norm(x, p["ln1_g"].to(dt), p["ln1_b"].to(dt))
    qkv = shards.enter(h) @ p["attn_qkv_w"].to(dt) + p["attn_qkv_b"].to(dt)
    q, k, v = (t.reshape(B, T, -1, cfg.head_dim)
               for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
    if remat_attention:
        o = checkpoint(select_attention, cfg.attention, q, k, v, mesh, True,
                       use_reentrant=False)
    else:
        o = select_attention(cfg.attention, q, k, v, mesh, causal=True)
    x1 = x + (shards.exit(o.reshape(B, T, -1) @ p["attn_out_w"].to(dt))
              + p["attn_out_b"].to(dt))
    h2 = _layer_norm(x1, p["ln2_g"].to(dt), p["ln2_b"].to(dt))
    h2 = shards.enter(h2) @ p["mlp_fc_w"].to(dt) + p["mlp_fc_b"].to(dt)
    h2 = F.gelu(h2, approximate="tanh")
    h2 = shards.exit(h2 @ p["mlp_out_w"].to(dt)) + p["mlp_out_b"].to(dt)
    return x1 + h2


def _run_block(cfg: GPT2Config, mesh, shards, i: int, x, weights):
    """Block i under the config's remat policy."""
    if not cfg.remat:
        return _block(cfg, mesh, shards, False, x, *weights)
    policy = cfg.remat_policy
    if policy == "names":
        return _block(cfg, mesh, shards, True, x, *weights)
    if policy == "half" and i % 2:
        return _block(cfg, mesh, shards, False, x, *weights)
    if policy == "full" and i >= cfg.n_layer - cfg.remat_skip:
        return _block(cfg, mesh, shards, False, x, *weights)
    extra = {"context_fn": _dots_context} if policy == "dots" else {}
    return checkpoint(_block, cfg, mesh, shards, False, x, *weights,
                      use_reentrant=False, **extra)


def _qkv_columns(w, tp: int, rank: int):
    """This tp rank's columns of the fused [.., 3E] qkv leaf (its heads of
    q, of k and of v), from the whole leaf."""
    E = w.shape[-1] // 3
    n = E // tp
    return torch.cat([w[..., s * E + rank * n: s * E + (rank + 1) * n]
                      for s in range(3)], dim=-1)


def _localize(cfg: GPT2Config, params: Dict, tokens):
    """(shards, params, tokens) for the arithmetic: plain params as they
    are; DTensor params as this rank's compute blocks (gathered over the
    data axes, the fused qkv over tp too and cut to this rank's heads)
    and this rank's rows of the batch."""
    shards = _sh.local_shards(params)
    if shards is _sh.UNSHARDED:
        return shards, params, tokens
    if cfg.n_head % shards.tp:
        raise ValueError(f"{cfg.n_head} heads do not split over tp "
                         f"{shards.tp}")
    local = _sh.unshard_tree(shards, params,
                             over_tp=("attn_qkv_w", "attn_qkv_b"))
    blocks = dict(local["blocks"])
    for key in ("attn_qkv_w", "attn_qkv_b"):
        blocks[key] = _qkv_columns(blocks[key], shards.tp, shards.tp_rank)
    return shards, {**local, "blocks": blocks}, shards.rows(tokens)


def _backbone(cfg: GPT2Config, params: Dict, tokens, mesh, shards):
    T = tokens.shape[1]
    dt = cfg.dtype
    tokens = tokens.long()
    x = (_sh.embed(shards, params["wte"].to(dt), tokens, cfg.vocab_size)
         + params["wpe"].to(dt)[:T])
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        x = _run_block(cfg, mesh, shards, i, x,
                       [blocks[k][i] for k in _LAYER_KEYS])
    return _layer_norm(x, params["lnf_g"].to(dt), params["lnf_b"].to(dt))


def backbone(cfg: GPT2Config, params: Dict, tokens: torch.Tensor,
             mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> final hidden states [B, T, embd] (compute
    dtype), i.e. everything up to (not including) the lm-head matmul.
    With DTensor params (`shard_params`), this rank's rows of them."""
    shards, params, tokens = _localize(cfg, params, tokens)
    return _backbone(cfg, params, tokens, mesh, shards)


def lm_head(cfg: GPT2Config, params: Dict, x: torch.Tensor,
            out_dtype: torch.dtype = torch.float32,
            shards=_sh.UNSHARDED) -> torch.Tensor:
    """Weight-tied projection to vocab logits: the one definition the
    training loss and inference share (under a sharded step, this tp
    rank's block of the vocabulary)."""
    return (shards.enter(x) @ params["wte"].to(cfg.dtype).T).to(out_dtype)


def forward(cfg: GPT2Config, params: Dict, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (f32); with DTensor
    params, this rank's rows and block of the vocabulary."""
    shards, params, tokens = _localize(cfg, params, tokens)
    return lm_head(cfg, params, _backbone(cfg, params, tokens, mesh, shards),
                   shards=shards)


def loss_fn(cfg: GPT2Config, params: Dict, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy; tokens [B, T+1] (shift done here).  The
    lse form: logits in `cfg.logits_dtype`, logsumexp and the target
    gather in f32.  Eager PyTorch materialises the f32 upcast of the
    logits, which the reference's fused XLA reduction does not.  With
    DTensor params each rank computes the mean over its rows, with the
    vocabulary split over tp, and the loss is their mean over the data
    axes (the same value on every rank)."""
    shards, params, tokens = _localize(cfg, params, tokens)
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = _backbone(cfg, params, inputs, mesh, shards)
    logits = lm_head(cfg, params, x, out_dtype=cfg.logits_dtype,
                     shards=shards)
    lse, tgt = _sh.lse_and_target(shards, logits, targets, cfg.vocab_size)
    loss = (lse - tgt).mean()
    return loss if shards is _sh.UNSHARDED else shards.data_mean(loss)


def _leaves(params: Dict) -> List[torch.Tensor]:
    """Leaves in sorted-key order (lists in order), as `jax.tree.leaves`
    lists them."""
    return tree_leaves(params)


def num_params(params: Dict) -> int:
    return sum(p.numel() for p in _leaves(params))


# ----------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------
def make_train_step(cfg: GPT2Config, optimizer: "AdamW", mesh=None):
    """Returns step(params, opt_state, tokens) -> (params, opt_state,
    metrics) with metrics {"loss", "grad_norm"} (the pre-clip global
    norm, f32).  Unlike the reference, which returns new arrays, the
    params are leaf tensors updated IN PLACE (with the optimizer state),
    and the same dict comes back.  The sharded step is this one on
    DTensor params (`shard_params`), moments placed by
    `optimizer_shardings` and the batch by `prepare_batch`: each rank
    computes on its blocks (`parallel.sharding.LocalShards`) and
    updates them; the loss and the norm are the global ones."""

    def step(params, opt_state, tokens):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(cfg, params, tokens, mesh)
        grads = torch.autograd.grad(loss, leaves)
        opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name: linear from `init_value` to
    `peak_value` over `warmup_steps`, then cosine decay to `end_value`
    at `decay_steps` (which counts the warm-up), read at a step count."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1,
    b2, eps, weight_decay))`, written out: clip by the global norm only
    when it reaches `max_norm` (g / norm * max_norm, no epsilon), Adam
    moments with bias correction, decoupled weight decay on every leaf
    (no mask), then the step `-schedule(count)` read at the count BEFORE
    its increment (step 0 has lr = schedule(0)).  `update` changes the
    params and the state in place, and returns the state with the
    pre-clip global norm."""

    def __init__(self, schedule: Callable[[int], float], max_norm=1.0,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        self.schedule = schedule
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict) -> Dict[str, Any]:
        leaves = _leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves]}

    @torch.no_grad()
    def update(self, grads, state: Dict[str, Any],
               params: Dict) -> Tuple[Dict[str, Any], torch.Tensor]:
        """`grads`: one per leaf of `params`, in `_leaves` order."""
        norm = _sh.global_norm(grads)
        keep = norm < self.max_norm
        count = state["count"] + 1
        # bias corrections in f32, as optax computes decay ** count
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        step = -self.schedule(state["count"])
        for p, g, mu, nu in zip(_leaves(params), grads, state["mu"],
                                state["nu"]):
            # DTensor leaves: each rank updates its own blocks (the
            # moments and the gradient split as their parameter)
            p, g, mu, nu = _same_blocks(p, g, mu, nu)
            g = torch.where(keep, g, g / norm * self.max_norm)
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = (u + self.weight_decay * p) * step
            p.add_(u)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}, norm


def _same_blocks(*ts):
    """The local blocks of DTensors of one layout (tensors as they
    are)."""
    DTensor = _sh.dtensor().DTensor
    if not isinstance(ts[0], DTensor):
        return ts
    for t in ts[1:]:
        if not isinstance(t, DTensor) or t.placements != ts[0].placements:
            raise ValueError(
                "a DTensor parameter's gradient and moments must be split "
                f"as it is ({ts[0].placements}); got "
                f"{getattr(t, 'placements', 'a plain tensor')}")
    return tuple(t.to_local() for t in ts)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10_000) -> AdamW:
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    return AdamW(sched, max_norm=1.0, b1=0.9, b2=0.95,
                 weight_decay=weight_decay)
