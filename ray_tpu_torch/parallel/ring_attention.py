"""Attention backends behind one dispatch point.

The port of the JAX package's `parallel/ring_attention.py`, so far its
single-device paths: `plain_attention`, and the `select_attention`
dispatch to it or to `ops.attention.flash_attention` (kernels K1-K4).
The sequence-parallel backends raise until their ROADMAP.md queue-1
item lands.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30

_NOT_PORTED = {
    "ring": "ring attention waits for the parallel slice (queue 1: "
            "sequence parallelism + collectives)",
    "ulysses": "Ulysses attention waits for the parallel slice (queue 1: "
               "sequence parallelism + collectives)",
}


def select_attention(kind: str, q, k, v, mesh=None, causal: bool = True):
    """One dispatch point for the attention backends shared by all
    model families: "dense" runs `plain_attention`; "flash" runs
    `flash_attention`; "ring" and "ulysses" raise NotImplementedError
    naming their ROADMAP item."""
    if kind == "flash":
        from ray_tpu_torch.ops.attention import flash_attention

        return flash_attention(q, k, v, causal)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"attention={kind!r} is not ported yet: {_NOT_PORTED[kind]} "
            "(ROADMAP.md)"
        )
    if kind != "dense":
        raise ValueError(f"unknown attention kind {kind!r}")
    return plain_attention(q, k, v, causal=causal)


def plain_attention(q, k, v, *, causal=True, scale=None):
    """Dense attention over [B, T, H, D] q/k/v: scores, mask and
    softmax in the compute dtype, as the JAX reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T, S = s.shape[-2], s.shape[-1]
        mask = (torch.arange(T, device=s.device)[:, None]
                >= torch.arange(S, device=s.device)[None, :])
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
