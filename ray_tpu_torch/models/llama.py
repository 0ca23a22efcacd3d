"""Llama family in PyTorch: the port of the JAX package's
`models/llama.py`, serving and training.

Plain functions over a dict of tensors in the JAX layout: stacked
`[L, ...]` block leaves and `[in, out]` weights, so the weight bridge
(`models/bridge.py`) is a straight copy and every function here keeps
its reference's name and `(cfg, params, ...)` signature.  The layer
`lax.scan` of the reference becomes a Python loop over the stacked
leaves (a view per layer, no copy).

Architecture (Llama-2/3 lineage): RMSNorm, rotary position embeddings,
grouped-query attention, SwiGLU MLP, untied LM head.  Int8 serving
weights (`quantize_weights_int8`) ride sibling `<name>_scale` leaves.

Numerics follow the reference at each step: RMSNorm's rsqrt in f32 cast
to x's dtype before the multiply; half-split RoPE with cos/sin computed
in f32 and cast to x's dtype; `x @ w.to(dtype)` with the per-output
scale after the matmul; an f32 lm-head; decode attention with f32
scores, a -1e30 mask, f32 softmax, weights cast to the compute dtype
and f32 P.V accumulation.

Training: LoRA is a separate adapter tree (`init_lora`), and the
forward computes `x @ W + (x @ A) @ B * scale` without merging; the
LoRA train step differentiates the adapter tree only.  With
`cfg.remat` each block runs under `torch.utils.checkpoint`
(`use_reentrant=False`) while gradients are recorded, as the
reference's `jax.checkpoint`.  `loss_fn` keeps the reference's lse
form.  On DTensor params (a sharded step) each rank computes on its
blocks, the heads, the MLP and the vocabulary split over tp
(`parallel.sharding.LocalShards`; `_apply` places the tp collectives).
The optimizer is the caller's (`gpt2.AdamW` where the reference takes
optax); the params are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt2 import _leaves
from ray_tpu_torch.ops import paged_attention as _pa
from ray_tpu_torch.parallel import sharding as _sh
from ray_tpu_torch.parallel.ring_attention import select_attention

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32  # < n_heads => grouped-query attention
    intermediate: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attention: str = "dense"  # dense | flash | ring | ulysses (no mesh: dense)
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, max_seq_len=8192, dim=4096, n_layers=32,
            n_heads=32, n_kv_heads=8, intermediate=14336, rope_theta=500000.0,
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, max_seq_len=128, dim=64, n_layers=2,
            n_heads=4, n_kv_heads=2, intermediate=128,
        )


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(cfg: LlamaConfig,
                generator: Union[int, torch.Generator] = 0,
                device=None, dtype: torch.dtype = torch.float32) -> Dict:
    """Random params in the JAX layout, drawn from `generator` (a seed
    or a `torch.Generator` on `device`).  Each leaf is drawn in f32 and
    cast to `dtype` as it is made, stacked leaves one layer at a time,
    so peak memory stays near the total at `dtype`.  The draws differ
    from `jax.random`'s: to compare with the JAX package, copy its
    params across with `models.bridge.params_from_numpy`."""
    device = resolve_device(device)
    if isinstance(generator, int):
        gen = torch.Generator(device=device)
        gen.manual_seed(generator)
    else:
        gen = generator
    L, E = cfg.n_layers, cfg.dim
    hd, H, KV, I = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.intermediate
    std = 0.02
    proj_std = std / (2 * L) ** 0.5

    def normal(shape, s=std):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            dst.copy_(torch.randn(dst.shape, generator=gen, device=device,
                                  dtype=torch.float32).mul_(s))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "tok_emb": normal((cfg.vocab_size, E)),
        "blocks": {
            "attn_norm": ones((L, E)),
            "wq": normal((L, E, H * hd)),
            "wk": normal((L, E, KV * hd)),
            "wv": normal((L, E, KV * hd)),
            "wo": normal((L, H * hd, E), proj_std),
            "mlp_norm": ones((L, E)),
            "w_gate": normal((L, E, I)),
            "w_up": normal((L, E, I)),
            "w_down": normal((L, I, E), proj_std),
        },
        "final_norm": ones((E,)),
        "lm_head": normal((E, cfg.vocab_size)),
    }


def logical_axes(cfg: LlamaConfig) -> Dict:
    return {
        "tok_emb": ("vocab", "embed"),
        "blocks": {
            "attn_norm": (None, "embed"),
            "wq": (None, "embed", "heads"),
            "wk": (None, "embed", "heads"),
            "wv": (None, "embed", "heads"),
            "wo": (None, "heads", "embed"),
            "mlp_norm": (None, "embed"),
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


# ----------------------------------------------------------------------
# LoRA adapters
# ----------------------------------------------------------------------
LORA_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(cfg: LlamaConfig, generator: Union[int, torch.Generator] = 0,
              rank: int = 8, alpha: float = 16.0,
              targets: Tuple[str, ...] = LORA_TARGETS, device=None) -> Dict:
    """Adapter tree: per target, A [L, in, r] (gaussian / sqrt(in)) and
    B [L, r, out] (zeros: adapters start as identity), all f32, and
    `scale` = alpha / rank as a 0-d f32 tensor.  Draws come from
    `generator` (a seed or a `torch.Generator` on `device`) and differ
    from `jax.random`'s: bridge the JAX tree to compare."""
    device = resolve_device(device)
    if isinstance(generator, int):
        gen = torch.Generator(device=device)
        gen.manual_seed(generator)
    else:
        gen = generator
    L = cfg.n_layers
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dims = {
        "wq": (cfg.dim, H * hd),
        "wk": (cfg.dim, KV * hd),
        "wv": (cfg.dim, KV * hd),
        "wo": (H * hd, cfg.dim),
        "w_gate": (cfg.dim, cfg.intermediate),
        "w_up": (cfg.dim, cfg.intermediate),
        "w_down": (cfg.intermediate, cfg.dim),
    }
    blocks = {}
    for t in targets:
        din, dout = dims[t]
        blocks[f"{t}_a"] = torch.randn(
            (L, din, rank), generator=gen, device=device,
            dtype=torch.float32) / math.sqrt(din)
        blocks[f"{t}_b"] = torch.zeros((L, rank, dout), dtype=torch.float32,
                                       device=device)
    return {"blocks": blocks,
            "scale": torch.tensor(alpha / rank, dtype=torch.float32,
                                  device=device)}


def lora_logical_axes(cfg: LlamaConfig, lora: Dict) -> Dict:
    """A: input dim sharded like the base input ('embed'/'heads'/'mlp');
    r replicated.  B: r replicated; output like the base output."""
    in_ax = {"wq": "embed", "wk": "embed", "wv": "embed", "wo": "heads",
             "w_gate": "embed", "w_up": "embed", "w_down": "mlp"}
    out_ax = {"wq": "heads", "wk": "heads", "wv": "heads", "wo": "embed",
              "w_gate": "mlp", "w_up": "mlp", "w_down": "embed"}
    blocks = {}
    for name in lora["blocks"]:
        t, kind = name.rsplit("_", 1)
        if kind == "a":
            blocks[name] = (None, in_ax[t], None)
        else:
            blocks[name] = (None, None, out_ax[t])
    return {"blocks": blocks, "scale": ()}


def _layers(params: Dict) -> Iterator[Dict[str, torch.Tensor]]:
    """Per-layer views of the stacked block leaves."""
    blocks = params["blocks"]
    n = next(iter(blocks.values())).shape[0]
    for i in range(n):
        yield {k: v[i] for k, v in blocks.items()}


# the products whose weight splits its OUTPUT over tp (column-parallel);
# the others (wo, w_down) split their input (row-parallel)
_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")


def _apply(x, w, dtype, scale=None, lora_layer=None, name: str = "",
           shards=_sh.UNSHARDED):
    """x @ w on an `[in, out]` weight, with an optional low-rank delta
    `((x @ A) @ B) * lora_scale` from `lora_layer` (one layer's adapter
    leaves plus "__scale__"), all cast to `dtype` as the reference
    casts them.  `scale` (per-OUTPUT-channel, from
    `quantize_weights_int8`) dequantizes int8 weights after the matmul:
    (x @ q) * scale == x @ (q * scale) because the scale is constant
    along the contraction.  Under a sharded step (`shards`) `w` and B
    are this tp rank's columns of a column-parallel product (A whole),
    or `w` and A its rows of a row-parallel one (B whole), and the tp
    collectives sit where each gradient or sum needs them."""
    col = name in _COLUMN
    out = (shards.enter(x) if col else x) @ w.to(dtype)
    if not col:
        out = shards.exit(out)
    if scale is not None:
        out = out * scale.to(dtype)
    if lora_layer is not None and f"{name}_a" in lora_layer:
        a = lora_layer[f"{name}_a"].to(dtype)
        b = lora_layer[f"{name}_b"].to(dtype)
        s = lora_layer["__scale__"].to(dtype)
        if col:
            # A and the scale are whole on every tp rank, but their
            # products meet this rank's columns only: `enter` sums their
            # gradients over tp
            out = out + (shards.enter(x @ a) @ b) * shards.enter(s)
        else:
            out = out + (shards.exit(x @ a) @ b) * s
    return out


def _lm_head(x, params, dtype, shards=_sh.UNSHARDED):
    """Final projection to vocab logits in f32, int8-aware (under a
    sharded step, this tp rank's block of the vocabulary)."""
    logits = shards.enter(x) @ params["lm_head"].to(dtype)
    scale = params.get("lm_head_scale")
    if scale is not None:
        logits = logits * scale.to(dtype)
    return logits.float()


# weights the serve path quantizes; norms and the embedding lookup stay
# in their original dtype
QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weights_int8(params: Dict) -> Dict:
    """Symmetric per-output-channel int8 weights for serving: every
    matmul weight becomes an int8 payload with a sibling `<name>_scale`
    f32 leaf (`[L, out]` for blocks, `[vocab]` for the head), which
    `_apply` / `_lm_head` multiply back in after the matmul."""
    out = dict(params)
    blocks = dict(out["blocks"])
    for name in QUANT_TARGETS:
        q, s = _pa.quantize_int8(blocks[name], axis=1)  # [L,in,out]->[L,out]
        blocks[name] = q
        blocks[name + "_scale"] = s
    out["blocks"] = blocks
    q, s = _pa.quantize_int8(out["lm_head"], axis=0)  # [E,vocab]->[vocab]
    out["lm_head"] = q
    out["lm_head_scale"] = s
    return out


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def _rms_norm(x, g, eps):
    ms = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps).to(x.dtype)) * g


def _freqs(theta: float, half: int, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope(x, theta: float, t0=0):
    """Rotary embedding over the last dim; x [B, T, H, hd]; positions
    t0 .. t0 + T - 1 (t0 an int or a 0-d tensor on x's device, which
    stays there: a CUDA graph can capture it)."""
    _, T, _, hd = x.shape
    freqs = _freqs(theta, hd // 2, x.device)
    pos = torch.arange(T, dtype=torch.float32, device=x.device) + t0
    ang = pos[:, None] * freqs[None, :]  # [T, half]
    cos = ang.cos()[None, :, None, :].to(x.dtype)
    sin = ang.sin()[None, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


def _rope_at(x, theta: float, pos_b):
    """Rotary embedding for ONE decode step at PER-ROW positions:
    x [B, 1, H, hd], pos_b [B] int (continuous batching)."""
    freqs = _freqs(theta, x.shape[-1] // 2, x.device)
    ang = pos_b.float()[:, None] * freqs[None, :]  # [B, half]
    cos = ang.cos()[:, None, None, :].to(x.dtype)
    sin = ang.sin()[:, None, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


def _proj(cfg: LlamaConfig, layer, lora_layer, name: str, x,
          shards=_sh.UNSHARDED):
    """One of the block's projections, int8- and LoRA-aware."""
    return _apply(x, layer[name], cfg.dtype, layer.get(f"{name}_scale"),
                  lora_layer, name, shards)


def _mlp(cfg: LlamaConfig, layer, x1, lora_layer=None,
         shards=_sh.UNSHARDED):
    h2 = _rms_norm(x1, layer["mlp_norm"].to(cfg.dtype), cfg.norm_eps)
    gate = _proj(cfg, layer, lora_layer, "w_gate", h2, shards)
    up = _proj(cfg, layer, lora_layer, "w_up", h2, shards)
    return x1 + _proj(cfg, layer, lora_layer, "w_down", F.silu(gate) * up,
                      shards)


def _qkv(cfg: LlamaConfig, layer, x, lora_layer=None, shards=_sh.UNSHARDED):
    h = _rms_norm(x, layer["attn_norm"].to(cfg.dtype), cfg.norm_eps)
    return (_proj(cfg, layer, lora_layer, "wq", h, shards),
            _proj(cfg, layer, lora_layer, "wk", h, shards),
            _proj(cfg, layer, lora_layer, "wv", h, shards))


def _embed(cfg: LlamaConfig, params, tokens, shards=_sh.UNSHARDED):
    # gather, then cast: equal to the reference's cast-then-gather
    return _sh.embed(shards, params["tok_emb"], tokens.long(),
                     cfg.vocab_size).to(cfg.dtype)


def _finish(cfg: LlamaConfig, params, x, shards=_sh.UNSHARDED):
    x = _rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _lm_head(x, params, cfg.dtype, shards)


def _block(cfg: LlamaConfig, layer, lora_layer, x, mesh=None,
           shards=_sh.UNSHARDED):
    """One transformer block over x [B, T, dim]: (x out, post-RoPE K,
    V [B, T, KV, hd]); under a sharded step, this tp rank's heads."""
    B, T, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    group = H // KV
    q, k, v = _qkv(cfg, layer, x, lora_layer, shards)
    q = _rope(q.reshape(B, T, -1, hd), cfg.rope_theta)
    k_kv = _rope(k.reshape(B, T, -1, hd), cfg.rope_theta)
    v_kv = v.reshape(B, T, -1, hd)
    k, v = k_kv, v_kv
    if group > 1:  # GQA: each kv head serves `group` query heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    o = select_attention(cfg.attention, q, k, v, mesh, causal=True)
    x1 = x + _proj(cfg, layer, lora_layer, "wo", o.reshape(B, T, -1),
                   shards)
    return _mlp(cfg, layer, x1, lora_layer, shards), k_kv, v_kv


def _lora_layers(lora: Dict, n: int) -> Iterator[Dict[str, torch.Tensor]]:
    """Per-layer views of the adapter leaves, each with "__scale__"."""
    for i in range(n):
        layer = {k: v[i] for k, v in lora["blocks"].items()}
        layer["__scale__"] = lora["scale"]
        yield layer


def _localize(cfg: LlamaConfig, params: Dict, lora: Optional[Dict],
              tokens):
    """(shards, params, lora, tokens) for the arithmetic: plain trees as
    they are; DTensor trees (`shard_params`) as this rank's compute
    blocks (gathered over the data axes) and its rows of the batch."""
    shards = _sh.local_shards(params)
    if shards is _sh.UNSHARDED:
        return shards, params, lora, tokens
    if cfg.n_kv_heads % shards.tp:
        raise ValueError(f"{cfg.n_kv_heads} kv heads do not split over tp "
                         f"{shards.tp}")
    if lora is not None:
        lora = _sh.unshard_tree(shards, lora)
    return (shards, _sh.unshard_tree(shards, params), lora,
            shards.rows(tokens))


def _forward(cfg: LlamaConfig, params: Dict, tokens, mesh, lora,
             return_kv: bool, shards):
    x = _embed(cfg, params, tokens, shards)
    L = params["blocks"]["wq"].shape[0]
    lora_layers = (_lora_layers(lora, L) if lora is not None
                   else (None for _ in range(L)))
    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for layer, lora_layer in zip(_layers(params), lora_layers):
        if remat:
            x, k_kv, v_kv = checkpoint(_block, cfg, layer, lora_layer, x,
                                       mesh, shards, use_reentrant=False)
        else:
            x, k_kv, v_kv = _block(cfg, layer, lora_layer, x, mesh, shards)
        if return_kv:
            ks.append(k_kv)
            vs.append(v_kv)
    logits = _finish(cfg, params, x, shards)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def forward(cfg: LlamaConfig, params: Dict, tokens: torch.Tensor,
            mesh=None, lora: Optional[Dict] = None,
            return_kv: bool = False):
    """tokens [B, T] int -> logits [B, T, vocab] (f32), with the
    reference's argument order.

    `lora` adds the adapters' low-rank deltas (`init_lora`).  With
    return_kv=True also returns the per-layer post-RoPE K/V
    ([L, B, T, KV, hd] each): the prefill path of KV-cached decoding.
    With `cfg.remat`, while gradients are recorded, each block runs
    under `torch.utils.checkpoint`; under `torch.no_grad()` nothing is
    recomputed.  `mesh` (a `DeviceMesh`, every rank passing the same
    inputs) reaches `select_attention`, as in the reference: with
    `attention="ring"` or `"ulysses"` the sequence splits over its `sp`
    axis.  With DTensor params (`shard_params`) the result is this
    rank's rows and its tp block of the vocabulary (no KV)."""
    shards, params, lora, tokens = _localize(cfg, params, lora, tokens)
    if return_kv and shards is not _sh.UNSHARDED:
        raise ValueError("return_kv takes unsharded params")
    return _forward(cfg, params, tokens, mesh, lora, return_kv, shards)


def loss_fn(cfg: LlamaConfig, params: Dict, tokens: torch.Tensor,
            mesh=None, lora: Optional[Dict] = None) -> torch.Tensor:
    """Next-token cross entropy; tokens [B, T+1] (shift done here).  The
    reference's lse form over the f32 logits: lse - target logit.  With
    DTensor params each rank computes the mean over its rows, with the
    vocabulary split over tp, and the loss is their mean over the data
    axes (the same value on every rank)."""
    shards, params, lora, tokens = _localize(cfg, params, lora, tokens)
    tokens = tokens.long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = _forward(cfg, params, inputs, mesh, lora, False, shards)
    lse, tgt = _sh.lse_and_target(shards, logits, targets, cfg.vocab_size)
    loss = (lse - tgt).mean()
    return loss if shards is _sh.UNSHARDED else shards.data_mean(loss)


def num_params(params: Dict) -> int:
    return sum(p.numel() for p in _leaves(params))


# ----------------------------------------------------------------------
# train steps
# ----------------------------------------------------------------------
def make_train_step(cfg: LlamaConfig, optimizer, mesh=None):
    """Full fine-tune / pretrain step: step(params, opt_state, tokens)
    -> (params, opt_state, {"loss": loss}).  `optimizer` is a
    `gpt2.AdamW` (or anything with its `init` / `update`); unlike the
    reference, which returns new arrays, the params are updated IN
    PLACE and the same dict comes back."""

    def step(params, opt_state, tokens):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(cfg, params, tokens, mesh)
        grads = torch.autograd.grad(loss, leaves)
        opt_state, _ = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return step


def make_lora_train_step(cfg: LlamaConfig, optimizer, mesh=None):
    """LoRA step: step(base_params, lora_params, opt_state, tokens) ->
    (lora_params, opt_state, {"loss": loss}).  The base is frozen:
    gradients flow only into the adapter tree (every leaf of it, its
    `scale` included, as the reference differentiates the whole tree),
    which is updated IN PLACE.  Sharded: a DTensor base and adapters
    (`shard_params` with `logical_axes` / `lora_logical_axes`), as
    `gpt2.make_train_step` takes them."""

    def step(base_params, lora_params, opt_state, tokens):
        leaves = _leaves(lora_params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(cfg, base_params, tokens, mesh, lora=lora_params)
        grads = torch.autograd.grad(loss, leaves)
        opt_state, _ = optimizer.update(grads, opt_state, lora_params)
        return lora_params, opt_state, {"loss": loss.detach()}

    return step


def merge_lora(cfg: LlamaConfig, params: Dict, lora: Dict) -> Dict:
    """Bake the adapters into the base weights (for serving without the
    adapter matmuls): a new tree; the targets become
    W + einsum(A, B) * scale, promoted as the reference promotes."""
    out = dict(params)
    blocks = dict(out["blocks"])
    scale = lora["scale"]
    with torch.no_grad():
        for name, a in lora["blocks"].items():
            t, kind = name.rsplit("_", 1)
            if kind != "a":
                continue
            b = lora["blocks"][f"{t}_b"]
            blocks[t] = blocks[t] + torch.einsum("lir,lro->lio", a,
                                                 b) * scale
    out["blocks"] = blocks
    return out


# ----------------------------------------------------------------------
# KV-cached decoding (the serving inference path)
# ----------------------------------------------------------------------
def forward_with_prefix(cfg: LlamaConfig, params: Dict, tokens: torch.Tensor,
                        prefix_kv, prefix_len):
    """Suffix forward over an existing prefix KV cache (the paged
    engine's radix-hit prefill).

    `tokens` [B, S] is the prompt SUFFIX at absolute positions
    `prefix_len` .. `prefix_len + S - 1`; `prefix_kv` = (k, v), each
    [L, B, Pmax, KV, hd], the gathered (possibly padded) prefix KV —
    columns at or beyond `prefix_len` are masked out.  `prefix_len` is
    an int or a 0-d tensor on the tokens' device: the engine passes a
    tensor, so one CUDA graph of a padded width serves every length
    under it.  Returns
    (suffix logits [B, S, vocab] f32, (k_suf, v_suf) each
    [L, B, S, KV, hd]).  Numerics mirror `forward`'s dense path (same
    einsum forms, -1e30 mask, softmax in the compute dtype), so a
    prefix-cached prefill gives the full prefill's greedy tokens."""
    pk, pv = prefix_kv
    B, S = tokens.shape
    Pmax = pk.shape[2]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    group = H // KV
    scale = hd ** -0.5
    dev = tokens.device

    # column validity over the concatenated [Pmax + S] axis: live
    # prefix columns, then causal self-attention within the suffix
    cols = torch.arange(Pmax + S, device=dev)
    prefix_ok = (cols < prefix_len) & (cols < Pmax)
    suffix_causal = ((cols[None, :] >= Pmax)
                     & ((cols[None, :] - Pmax)
                        <= torch.arange(S, device=dev)[:, None]))
    mask = (prefix_ok[None, :] | suffix_causal)[None, None]  # [1,1,S,P+S]

    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for li, layer in enumerate(_layers(params)):
        q, k, v = _qkv(cfg, layer, x)
        q = _rope(q.reshape(B, S, H, hd), cfg.rope_theta, t0=prefix_len)
        k_suf = _rope(k.reshape(B, S, KV, hd), cfg.rope_theta, t0=prefix_len)
        v_suf = v.reshape(B, S, KV, hd)
        kk = torch.cat([pk[li].to(cfg.dtype), k_suf], dim=1)
        vv = torch.cat([pv[li].to(cfg.dtype), v_suf], dim=1)
        if group > 1:
            kk = kk.repeat_interleave(group, dim=2)
            vv = vv.repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
        s = torch.where(mask, s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(B, S, H * hd)
        x1 = x + _proj(cfg, layer, None, "wo", o)
        x = _mlp(cfg, layer, x1)
        ks.append(k_suf)
        vs.append(v_suf)
    return _finish(cfg, params, x), (torch.stack(ks), torch.stack(vs))


def prefill(cfg: LlamaConfig, params: Dict, tokens: torch.Tensor,
            max_len: int):
    """Process the prompt in one pass and build the KV cache.

    tokens [B, T] -> (last-position logits [B, vocab],
    cache = (k [L, B, max_len, KV, hd], v [...]))."""
    B, T = tokens.shape
    logits, (ks, vs) = forward(cfg, params, tokens, return_kv=True)
    shape = (ks.shape[0], B, max_len) + tuple(ks.shape[3:])
    k_cache = ks.new_zeros(shape)
    v_cache = vs.new_zeros(shape)
    k_cache[:, :, :T] = ks
    v_cache[:, :, :T] = vs
    return logits[:, -1, :], (k_cache, v_cache)


def _cache_attention(cfg: LlamaConfig, q, kc, vc, valid):
    """Decode attention of q [B, 1, H, hd] over a dense cache
    kc/vc [B, M, KV, hd] with `valid` [B or 1, M]: f32 scores times
    1/sqrt(hd), -1e30 mask, f32 softmax, weights cast to the compute
    dtype, f32 P.V.  GQA groups the query heads of one kv head instead
    of repeating K/V (the same products)."""
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                          device=q.device))
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgd,bmkd->bkgm", qg, kc.float()) * scale
    s = torch.where(valid[:, None, None, :], s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgm,bmkd->bkgd", w.to(cfg.dtype).float(), vc.float())
    return o.to(cfg.dtype).reshape(B, 1, H * hd)


def decode_step(cfg: LlamaConfig, params: Dict, token: torch.Tensor,
                cache, pos: int):
    """One token of autoregressive decoding against the KV cache.

    token [B] int, pos int (current sequence length) -> (logits
    [B, vocab] f32, cache).  The cache (k, v) [L, B, M, KV, hd] is
    updated IN PLACE at `pos` and returned.  Same math as
    `decode_step_vec` at equal positions."""
    k_cache, v_cache = cache
    B = token.shape[0]
    M = k_cache.shape[2]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    valid = (torch.arange(M, device=token.device) <= pos)[None, :]
    x = _embed(cfg, params, token)[:, None, :]  # [B, 1, d]
    for li, layer in enumerate(_layers(params)):
        q, k, v = _qkv(cfg, layer, x)
        q = _rope(q.reshape(B, 1, H, hd), cfg.rope_theta, t0=pos)
        k_new = _rope(k.reshape(B, 1, KV, hd), cfg.rope_theta, t0=pos)
        kc, vc = k_cache[li], v_cache[li]
        kc[:, pos] = k_new[:, 0].to(kc.dtype)
        vc[:, pos] = v.reshape(B, KV, hd).to(vc.dtype)
        o = _cache_attention(cfg, q, kc, vc, valid)
        x1 = x + _proj(cfg, layer, None, "wo", o)
        x = _mlp(cfg, layer, x1)
    return _finish(cfg, params, x[:, 0, :]), (k_cache, v_cache)


def decode_step_vec(cfg: LlamaConfig, params: Dict, token: torch.Tensor,
                    cache, pos: torch.Tensor):
    """One decode step with PER-ROW positions (continuous batching:
    every slot advances at its own length).

    token [B] int, pos [B] int (current length per row) -> (logits
    [B, vocab] f32, cache), the cache updated IN PLACE.  A row whose
    position lies past the cache (pos >= M) writes nothing, as the
    reference's masked select; rows are independent, so a slot's tokens
    are what a dedicated `generate` would produce."""
    k_cache, v_cache = cache
    B = token.shape[0]
    M = k_cache.shape[2]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dev = token.device
    rows = torch.arange(B, device=dev)
    p = pos.long()
    valid = torch.arange(M, device=dev)[None, :] <= p[:, None]  # [B, M]
    inside = (p < M)[:, None, None]
    at = p.clamp(max=M - 1)
    x = _embed(cfg, params, token)[:, None, :]
    for li, layer in enumerate(_layers(params)):
        q, k, v = _qkv(cfg, layer, x)
        q = _rope_at(q.reshape(B, 1, H, hd), cfg.rope_theta, pos)
        k_new = _rope_at(k.reshape(B, 1, KV, hd), cfg.rope_theta, pos)
        kc, vc = k_cache[li], v_cache[li]
        kc[rows, at] = torch.where(inside, k_new[:, 0].to(kc.dtype),
                                   kc[rows, at])
        vc[rows, at] = torch.where(inside, v.reshape(B, KV, hd).to(vc.dtype),
                                   vc[rows, at])
        o = _cache_attention(cfg, q, kc, vc, valid)
        x1 = x + _proj(cfg, layer, None, "wo", o)
        x = _mlp(cfg, layer, x1)
    return _finish(cfg, params, x[:, 0, :]), (k_cache, v_cache)


def decode_step_paged(cfg: LlamaConfig, params: Dict, token: torch.Tensor,
                      k_pool, v_pool, tables, pos, *,
                      kv_scales: Optional[Tuple] = None):
    """One decode step with PER-ROW positions straight off the paged
    KV pool: `decode_step_vec` with the dense gather/scatter replaced
    by the kernels in `ops/paged_attention.py`.

    token [B] int; k_pool/v_pool [L, NB, BS, KV, hd] (passed WHOLE —
    the layer index rides the kernels as a scalar); tables [B, W]
    int32 (scratch-block padded); pos [B] int32.  Per layer, one
    `paged_append_decode_attention` writes the new KV row and walks
    each row's blocks (`paged_kv_append` then `paged_decode_attention`
    as one op; on the card, one kernel launch).  Int8 pools quantize
    the new row here first, as the reference does outside its kernels.
    The pools (and, for int8 pools, the `kv_scales` = (k_scale,
    v_scale) sidecar) are updated IN PLACE.  Returns (logits [B, vocab]
    f32, k_pool, v_pool) plus (k_scale, v_scale) when `kv_scales` is
    given."""
    B = token.shape[0]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    x = _embed(cfg, params, token)[:, None, :]
    for li, layer in enumerate(_layers(params)):
        q, k, v = _qkv(cfg, layer, x)
        q = _rope_at(q.reshape(B, 1, H, hd), cfg.rope_theta, pos)
        k_new = _rope_at(k.reshape(B, 1, KV, hd), cfg.rope_theta, pos)[:, 0]
        v_new = v.reshape(B, KV, hd)
        if ks is not None:
            kq, k_sc = _pa.quantize_int8(k_new)
            vq, v_sc = _pa.quantize_int8(v_new)
            o = _pa.paged_append_decode_attention(
                q[:, 0], k_pool, v_pool, kq, vq, tables, pos, li,
                k_scale=ks, v_scale=vs, k_new_scale=k_sc, v_new_scale=v_sc)
        else:
            o = _pa.paged_append_decode_attention(
                q[:, 0], k_pool, v_pool, k_new.to(k_pool.dtype),
                v_new.to(v_pool.dtype), tables, pos, li)
        o = o.to(cfg.dtype).reshape(B, 1, H * hd)
        x1 = x + _proj(cfg, layer, None, "wo", o)
        x = _mlp(cfg, layer, x1)
    logits = _finish(cfg, params, x[:, 0, :])
    if kv_scales is not None:
        return logits, k_pool, v_pool, ks, vs
    return logits, k_pool, v_pool


def generate(cfg: LlamaConfig, params: Dict, prompt, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """Autoregressive generation: prefill + KV-cached decode loop.

    prompt [B, T] int -> generated [B, max_new_tokens] int32 on
    `device` (default: the CUDA device; the params must live there).
    temperature 0 = greedy; otherwise softmax sampling from
    `generator` (a `torch.Generator` on `device`, seeded 0 when None)."""
    device = resolve_device(device)
    if params["tok_emb"].device != device:
        raise ValueError(f"params live on {params['tok_emb'].device}, "
                         f"not {device}")
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    greedy = temperature <= 0.0
    if not greedy and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def pick(logits):
        if greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    T = prompt.shape[1]
    with torch.inference_mode():
        logits, cache = prefill(cfg, params, prompt, T + max_new_tokens)
        toks = [pick(logits)]
        for i in range(1, max_new_tokens):
            logits, cache = decode_step(cfg, params, toks[-1], cache,
                                        T + i - 1)
            toks.append(pick(logits))
    return torch.stack(toks, dim=1)
