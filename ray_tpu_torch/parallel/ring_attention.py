"""Attention backends behind one dispatch point.

The port of the JAX package's `parallel/ring_attention.py`, so far its
single-device paths: `plain_attention`, and the `select_attention`
dispatch to it or to `ops.attention.flash_attention` (kernels K1-K4).
As in the reference, "ring", "ulysses" and any other kind run
`plain_attention` when no mesh is given; with a mesh the
sequence-parallel backends raise until their ROADMAP.md queue-1 item
(item 3) lands.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30

_NOT_PORTED = {
    "ring": "ring attention waits for the parallel slice (queue 1 item "
            "3: sequence parallelism + collectives)",
    "ulysses": "Ulysses attention waits for the parallel slice (queue 1 "
               "item 3: sequence parallelism + collectives)",
}


def select_attention(kind: str, q, k, v, mesh=None, causal: bool = True):
    """One dispatch point for the attention backends shared by all
    model families: "flash" runs `flash_attention`; "ring" and
    "ulysses" with a mesh raise NotImplementedError naming their
    ROADMAP item; everything else, those two without a mesh included,
    runs `plain_attention`, as the reference does."""
    if kind == "flash":
        from ray_tpu_torch.ops.attention import flash_attention

        return flash_attention(q, k, v, causal)
    if kind in _NOT_PORTED and mesh is not None:
        raise NotImplementedError(
            f"attention={kind!r} over a mesh is not ported yet: "
            f"{_NOT_PORTED[kind]} (ROADMAP.md)"
        )
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
