"""Mixtral-style sparse-MoE transformer in PyTorch: the port of the JAX
package's `models/mixtral.py`.

The Llama lineage (RMSNorm, RoPE, GQA attention — `_apply`,
`_rms_norm` and `_rope` reused from `models/llama.py`, as the
reference reuses its llama's) with the dense SwiGLU MLP replaced by a
top-k routed mixture of experts (`parallel/moe.py`: capacity-slot
dispatch, Switch-style load-balance aux loss, all_to_all over the `ep`
mesh axis).

Plain functions over a dict of tensors in the JAX layout (stacked
`[L, ...]` blocks, `[in, out]` weights; the MoE leaves as
`moe_router` / `moe_w_in` / `moe_w_out`), so params cross between the
packages with `models/bridge.py`.  The reference's layer `lax.scan`
becomes a loop over the stacked leaves, each block under
`torch.utils.checkpoint` with `cfg.remat` while gradients are
recorded, as `llama.forward`.  GQA repeats each kv head
(`repeat_interleave` on the head dim).  The optimizer is the caller's
(`gpt2.AdamW` where the reference takes optax); params update in place.

On DTensor params (`shard_params` with `logical_axes`, a sharded step
over dp / fsdp / ep / sp / tp) each rank computes on its compute
blocks, as `llama.py` does (`parallel.sharding.LocalShards`): the heads
and the vocabulary split over tp (`_apply` places the tp collectives,
`lse_and_target` reads the loss), RoPE from the rank's sequence offset,
and the MoE layer on the rank's ep chunk of the batch with its resident
experts (`moe.moe_forward(..., shards=)`).  The loss is the mean over
the ranks of each one's CE plus the aux coefficient times its chunk's
load-balance loss: the reference's CE over the batch plus the mean over
the ep chunks of each chunk's aux value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt2 import _leaves
from ray_tpu_torch.models.llama import _apply, _layers, _rms_norm, _rope
from ray_tpu_torch.parallel import sharding as _sh
from ray_tpu_torch.parallel.moe import MoEConfig, init_moe, moe_forward
from ray_tpu_torch.parallel.ring_attention import select_attention


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    intermediate: int = 14336  # per-expert hidden
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    router_aux_coef: float = 0.02  # load-balance loss weight
    dtype: torch.dtype = torch.bfloat16
    attention: str = "dense"  # dense | flash | ring | ulysses
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(
            dim=self.dim, hidden=self.intermediate,
            num_experts=self.num_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor, dtype=self.dtype,
        )

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "MixtralConfig":
        return MixtralConfig(
            vocab_size=vocab_size, max_seq_len=128, dim=64, n_layers=2,
            n_heads=4, n_kv_heads=2, intermediate=96, num_experts=4,
            top_k=2,
        )


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(cfg: MixtralConfig,
                generator: Union[int, torch.Generator] = 0,
                device=None) -> Dict:
    """f32 params in the JAX layout, drawn from `generator` (a seed or a
    `torch.Generator` on `device`), one layer at a time.  The draws
    differ from `jax.random`'s: to compare with the JAX package, copy
    its params across with `models.bridge.params_from_numpy`."""
    device = resolve_device(device)
    if isinstance(generator, int):
        gen = torch.Generator(device=device)
        gen.manual_seed(generator)
    else:
        gen = generator
    L, E = cfg.n_layers, cfg.dim
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    std = 0.02
    proj_std = std / (2 * L) ** 0.5

    def n(shape, s=std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(s)

    def ones(*shape):
        return torch.ones(shape, device=device)

    moe_layers = [init_moe(cfg.moe, gen, device) for _ in range(L)]
    moe_stacked = {k: torch.stack([m[k] for m in moe_layers])
                   for k in moe_layers[0]}
    del moe_layers
    return {
        "tok_emb": n((cfg.vocab_size, E)),
        "blocks": {
            "attn_norm": ones(L, E),
            "wq": n((L, E, H * hd)),
            "wk": n((L, E, KV * hd)),
            "wv": n((L, E, KV * hd)),
            "wo": n((L, H * hd, E), proj_std),
            "moe_norm": ones(L, E),
            **{f"moe_{k}": v for k, v in moe_stacked.items()},
        },
        "final_norm": ones(E),
        "lm_head": n((E, cfg.vocab_size)),
    }


def logical_axes(cfg: MixtralConfig) -> Dict:
    return {
        "tok_emb": ("vocab", "embed"),
        "blocks": {
            "attn_norm": (None, "embed"),
            "wq": (None, "embed", "heads"),
            "wk": (None, "embed", "heads"),
            "wv": (None, "embed", "heads"),
            "wo": (None, "heads", "embed"),
            "moe_norm": (None, "embed"),
            # expert axis shards over `ep` (rule table maps it)
            "moe_router": (None, "embed", None),
            "moe_w_in": (None, "expert", "embed", "mlp"),
            "moe_w_out": (None, "expert", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def _block(cfg: MixtralConfig, layer: Dict, x: torch.Tensor, mesh=None,
           shards=_sh.UNSHARDED):
    """One block over x [B, T, dim]: (x out, the layer's aux loss); under
    a sharded step, this tp rank's heads and this rank's rows and
    sequence chunk."""
    B, T, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    group = H // KV
    t0 = shards.seq_offset(T)  # this rank's chunk of the sequence
    h = _rms_norm(x, layer["attn_norm"].to(cfg.dtype), cfg.norm_eps)
    q, k, v = (_apply(h, layer[n], cfg.dtype, name=n, shards=shards)
               for n in ("wq", "wk", "wv"))
    q = _rope(q.reshape(B, T, -1, hd), cfg.rope_theta, t0)
    k = _rope(k.reshape(B, T, -1, hd), cfg.rope_theta, t0)
    v = v.reshape(B, T, -1, hd)
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    o = select_attention(cfg.attention, q, k, v, mesh, causal=True,
                         shards=shards)
    x1 = x + _apply(o.reshape(B, T, -1), layer["wo"], cfg.dtype, name="wo",
                    shards=shards)
    h2 = _rms_norm(x1, layer["moe_norm"].to(cfg.dtype), cfg.norm_eps)
    moe_params = {"router": layer["moe_router"], "w_in": layer["moe_w_in"],
                  "w_out": layer["moe_w_out"]}
    moe_out, aux = moe_forward(cfg.moe, moe_params, h2, mesh, shards=shards)
    return x1 + moe_out, aux["load_balance_loss"]


def _localize(cfg: MixtralConfig, params: Dict, tokens):
    """(shards, params, tokens) for the arithmetic: plain params as they
    are; DTensor params as this rank's compute blocks (gathered over the
    data axes; tp's blocks and ep's experts kept) and this rank's rows
    of the batch, whole over the sequence (the caller cuts its sp
    chunk)."""
    shards = _sh.local_shards(params)
    if shards is _sh.UNSHARDED:
        return shards, params, tokens
    if cfg.n_kv_heads % shards.tp:
        raise ValueError(f"{cfg.n_kv_heads} kv heads do not split over tp "
                         f"{shards.tp}")
    return shards, _sh.unshard_tree(shards, params), shards.rows(tokens)


def _forward(cfg: MixtralConfig, params: Dict, tokens, mesh, shards):
    """(logits [B, T, vocab] f32, the layers' mean aux loss) over this
    rank's tokens: under a sharded step its rows, sequence chunk and tp
    block of the vocabulary, and its ep chunk's aux loss."""
    x = _sh.embed(shards, params["tok_emb"], tokens.long(),
                  cfg.vocab_size).to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_losses = []
    for layer in _layers(params):
        if remat:
            x, aux = checkpoint(_block, cfg, layer, x, mesh, shards,
                                use_reentrant=False)
        else:
            x, aux = _block(cfg, layer, x, mesh, shards)
        aux_losses.append(aux)
    x = _rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    logits = (shards.enter(x) @ params["lm_head"].to(cfg.dtype)).float()
    return logits, torch.stack(aux_losses).mean()


def forward(cfg: MixtralConfig, params: Dict, tokens: torch.Tensor,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """tokens [B, T] int -> (logits [B, T, vocab] f32,
    aux {load_balance_loss} averaged over layers).  `mesh` (a
    `DeviceMesh`, every rank passing the same tokens) reaches the
    attention and the experts: with an `ep` axis the experts run
    expert-parallel.  With DTensor params (`shard_params`) the logits
    are this rank's rows, sequence chunk and tp block of the vocabulary,
    and the aux loss the global one."""
    shards, params, tokens = _localize(cfg, params, tokens)
    logits, aux = _forward(cfg, params, shards.seq_chunk(tokens), mesh,
                           shards)
    if shards is not _sh.UNSHARDED:
        aux = shards.data_mean(aux)
    return logits, {"load_balance_loss": aux}


def loss_fn(cfg: MixtralConfig, params: Dict, tokens: torch.Tensor,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE + router load-balance aux (the reference's lse
    form); tokens [B, T+1].  With DTensor params each rank takes the CE
    over its rows and sequence chunk (cut after the shift) and its ep
    chunk's aux value, and both are averaged over the ranks (the same
    values on every rank)."""
    shards, params, tokens = _localize(cfg, params, tokens)
    tokens = tokens.long()
    inputs = shards.seq_chunk(tokens[:, :-1])
    targets = shards.seq_chunk(tokens[:, 1:])
    logits, aux = _forward(cfg, params, inputs, mesh, shards)
    lse, tgt = _sh.lse_and_target(shards, logits, targets, cfg.vocab_size)
    ce = (lse - tgt).mean()
    if shards is not _sh.UNSHARDED:
        ce, aux = shards.data_mean(ce), shards.data_mean(aux)
    total = ce + cfg.router_aux_coef * aux
    return total, {"ce_loss": ce, "load_balance_loss": aux}


def num_params(params: Dict) -> int:
    return sum(p.numel() for p in _leaves(params))


def active_params_per_token(cfg: MixtralConfig, params: Dict) -> int:
    """Parameters touched per token (the MoE efficiency headline): all
    non-expert weights + top_k experts' FFNs."""
    total = num_params(params)
    expert_ffn = (
        cfg.n_layers * cfg.num_experts * 2 * cfg.dim * cfg.intermediate
    )
    active_ffn = (
        cfg.n_layers * cfg.top_k * 2 * cfg.dim * cfg.intermediate
    )
    return total - expert_ffn + active_ffn


# ----------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------
def make_train_step(cfg: MixtralConfig, optimizer, mesh=None):
    """step(params, opt_state, tokens) -> (params, opt_state, {"loss",
    "ce_loss", "load_balance_loss", "grad_norm"}), the last the pre-clip
    global norm.  `optimizer` is a `gpt2.AdamW` (or anything with its
    `init` / `update`); unlike the reference, which returns new arrays,
    the params are updated IN PLACE and the same dict comes back.  The
    sharded step is this one on DTensor params (`shard_params`), moments
    placed by `optimizer_shardings` and the batch by `prepare_batch`."""

    def step(params, opt_state, tokens):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(cfg, params, tokens, mesh)
        grads = torch.autograd.grad(loss, leaves)
        opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()},
            "grad_norm": gnorm}

    return step
