"""A Llama-style decoder (Mistral-7B's equations: RMSNorm, rotary
embeddings on the two halves of each head, grouped-query attention,
SwiGLU MLP, untied output head), forward only, in float32.

Weights come in the layout the benchmark makes them (`weights.py`:
stacked `[L, ...]` blocks, `[in, out]` matrices), in any dtype: each
layer's weights are cast to f32 as it is reached.  Every sequence runs
whole and causal, one layer at a time across the batch of sequences,
so the pass fits beside the weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

from port_bench.reference.lowp import f32_mm

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., T, H, hd] rotated at positions 0 .. T - 1: the pair
    (i, i + hd / 2) turns by pos * theta ** (-2 i / hd)."""
    t, hd = x.shape[-3], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().to(x.dtype)[:, None, :]
    sin = ang.sin().to(x.dtype)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mm: Mm = f32_mm) -> torch.Tensor:
    """q [T, H, hd], k / v [T, KV, hd] -> [T, H * hd]; query head h reads
    kv head h // (H / KV)."""
    t, h, hd = q.shape
    group = h // k.shape[1]
    qh = q.transpose(0, 1)                                     # [H, T, hd]
    kh = k.repeat_interleave(group, dim=1).permute(1, 2, 0)    # [H, hd, T]
    vh = v.repeat_interleave(group, dim=1).transpose(0, 1)     # [H, T, hd]
    s = mm(qh, kh) / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return mm(p, vh).transpose(0, 1).reshape(t, h * hd)


def _layer(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
           mm: Mm) -> torch.Tensor:
    e, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or e // h
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    t = x.shape[0]
    a = rms_norm(x, w["attn_norm"], eps)
    q = rope(mm(a, w["wq"]).reshape(t, h, hd), theta)
    k = rope(mm(a, w["wk"]).reshape(t, kv, hd), theta)
    v = mm(a, w["wv"]).reshape(t, kv, hd)
    x = x + mm(causal_attention(q, k, v, mm), w["wo"])
    m = rms_norm(x, w["mlp_norm"], eps)
    gate = torch.nn.functional.silu(mm(m, w["w_gate"]))
    return x + mm(gate * mm(m, w["w_up"]), w["w_down"])


@torch.no_grad()
def logits_at(cfg: Dict, params: Dict, seqs: Sequence[torch.Tensor],
              starts: Sequence[int], mm: Mm = f32_mm) -> List[torch.Tensor]:
    """For each token sequence seqs[i] ([T_i] ids on the weights'
    device), the f32 logits [T_i - starts[i], vocab] at positions
    starts[i] .. T_i - 1 (each predicts the token after it)."""
    blocks = params["blocks"]
    xs = [params["tok_emb"][s.long()].float() for s in seqs]
    for li in range(cfg["num_hidden_layers"]):
        w = {k: v[li].float() for k, v in blocks.items()}
        xs = [_layer(cfg, w, x, mm) for x in xs]
        del w
    g = params["final_norm"].float()
    head = params["lm_head"].float()
    out = []
    for x, s0 in zip(xs, starts):
        out.append(mm(rms_norm(x[s0:], g, cfg["rms_norm_eps"]), head))
    return out


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best: [n]."""
    return logits.max(dim=-1).values - logits.gather(
        1, tokens.long()[:, None])[:, 0]
