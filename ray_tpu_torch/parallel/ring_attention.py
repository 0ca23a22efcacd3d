"""Ring attention: sequence/context parallelism over the `sp` mesh axis.

The port of the JAX package's `parallel/ring_attention.py`.  q/k/v are
split over the sequence axis; each rank keeps its Q block resident and
passes its K/V block around the ring with `collectives.ppermute`,
folding each visiting block into a running flash-style online softmax.
Also Ulysses-style all-to-all attention: scatter heads / gather
sequence with `collectives.all_to_all`, run full-sequence attention per
head group, invert.

Where the reference's `shard_map` takes global arrays and places them
by its in/out specs, here every rank of the mesh passes the same global
[B, T, H, D] tensors: each takes its block (batch over (dp, fsdp),
sequence over the axis, heads over tp), runs the per-rank body over the
axis's process group, and the blocks are gathered back into the global
output on every rank.  The split and the gather are differentiable
under that replicated convention (the gradient of the gather is this
rank's block, that of the split the gather of every rank's block), so
`torch.autograd` through `ring_attention` gives every rank the full
gradient, as `jax.grad` through the reference does.  The per-rank
arithmetic is the reference's: einsums and the online merge in the
compute dtype, with the running max and sum held in q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import batch_axes, dtensor

_NEG_INF = -1e30


def on_local_blocks(fn, q, k, v):
    """`fn(q, k, v)` for [B, T, H, D] q / k / v.  Plain tensors go
    straight to `fn`.  DTensors (a sharded training step's) are first
    laid out with the batch split over the mesh's (dp, fsdp) dims and
    the heads over tp, replicated over any other dim; `fn` then runs on
    each rank's local blocks and the output is the DTensor of their
    blocks.  Attention is computed per (batch row, head), so this is
    the same function as on the whole tensors.  The layout costs no
    traffic when q / k / v already hold it (a replicated dim is cut
    locally); the gradients return through the same redistribution."""
    DTensor = dtensor().DTensor
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    Replicate, Shard = dtensor().Replicate, dtensor().Shard
    mesh = q.device_mesh
    places = tuple(Shard(0) if n in batch_axes() else
                   Shard(2) if n == "tp" else Replicate()
                   for n in mesh.mesh_dim_names)
    q, k, v = (t.redistribute(mesh, places) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local()).contiguous()
    return DTensor.from_local(out, mesh, places, run_check=False,
                              shape=q.shape,
                              stride=_contiguous_stride(q.shape))


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for s in reversed(shape):
        stride.append(n)
        n *= s
    return tuple(reversed(stride))


def select_attention(kind: str, q, k, v, mesh=None, causal: bool = True):
    """One dispatch point for the attention backends (dense | flash |
    ring | ulysses) shared by all model families; "ring" and
    "ulysses" without a mesh run `plain_attention`, as in the
    reference."""
    if kind == "flash":
        from ray_tpu_torch.ops.attention import flash_attention

        return flash_attention(q, k, v, causal)
    if kind == "ring" and mesh is not None:
        return ring_attention(q, k, v, mesh, causal=causal)
    if kind == "ulysses" and mesh is not None:
        return ulysses_attention(q, k, v, mesh, causal=causal)
    return plain_attention(q, k, v, causal=causal)


def _block_attn(q, k, v, bias, scale):
    """One q-block x kv-block attention with streaming-softmax stats.

    Returns (unnormalized_out, row_max, row_sumexp)."""
    # q: [B, Tq, H, D], k/v: [B, Tk, H, D]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = torch.amax(s, dim=-1)  # [B, H, Tq]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)  # [B, H, Tq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, l


def _causal_bias(row0: int, Tq: int, col0: int, Tk: int, dtype, device):
    """0 where global row >= global col, else -1e30, in `dtype` (the
    reference's weakly typed bias adds in the scores' dtype)."""
    rows = row0 + torch.arange(Tq, device=device)[:, None]
    cols = col0 + torch.arange(Tk, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.full((), _NEG_INF, dtype=dtype, device=device)
    return torch.where(rows >= cols, zero, neg)[None, None, :, :]


def _ring_attention_local(q, k, v, axis_name, causal: bool, scale: float,
                          mesh=None):
    """Per-rank body; the sequence dim is this rank's block."""
    group = collectives._group(axis_name, mesh)
    import torch.distributed as dist

    axis_size = dist.get_world_size(group)
    my_idx = dist.get_rank(group)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    perm = [(j, (j + 1) % axis_size) for j in range(axis_size)]
    o_acc = torch.zeros_like(q)
    m_acc = torch.full((B, H, Tq), _NEG_INF, dtype=q.dtype, device=q.device)
    l_acc = torch.zeros((B, H, Tq), dtype=q.dtype, device=q.device)
    k_cur, v_cur = k, v
    for step_i in range(axis_size):
        kv_idx = (my_idx - step_i) % axis_size
        bias = (_causal_bias(my_idx * Tq, Tq, kv_idx * Tk, Tk, q.dtype,
                             q.device) if causal else None)
        o_b, m_b, l_b = _block_attn(q, k_cur, v_cur, bias, scale)
        # online softmax merge (flash-attention style)
        m_new = torch.maximum(m_acc, m_b)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m_b - m_new)
        l_acc = l_acc * alpha + l_b * beta
        o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                 + o_b * beta.transpose(1, 2)[..., None])
        m_acc = m_new
        # rotate k/v to the next ring neighbour; the reference's scan
        # also rotates after the last step, whose result nothing reads
        if step_i + 1 < axis_size:
            k_cur = collectives.ppermute(k_cur, group, perm)
            v_cur = collectives.ppermute(v_cur, group, perm)
    l_acc = torch.clamp_min(l_acc, 1e-20)
    return o_acc / l_acc.transpose(1, 2)[..., None]


class _Split(torch.autograd.Function):
    """This rank's block of a replicated tensor along `dim`; the
    gradient is every rank's block gathered (the full gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split "
                             f"over {n} ranks")
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return collectives.all_gather(g, ctx.group, axis=ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every rank's block gathered along `dim` into the replicated
    whole; the gradient is this rank's block of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return collectives.all_gather(x, group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _Replicated(torch.autograd.Function):
    """A replicated tensor that every rank's block of the work reads
    whole (the reference's unmapped `P()` input): the identity, whose
    gradient is the sum over the group of every rank's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.psum(g, ctx.group), None


def _layout(mesh, axis_name: str):
    """(tensor dim, mesh axis group) in split order for the reference's
    P(("dp", "fsdp"), axis_name, "tp", None); axes of size 1 skipped."""
    names = list(mesh.mesh_dim_names)
    out = []
    for dim, axes in ((0, ("dp", "fsdp")), (1, (axis_name,)), (2, ("tp",))):
        for a in axes:
            if mesh.size(names.index(a)) > 1:
                out.append((dim, mesh.get_group(a)))
    return out


def _spmd(body, in_layouts, out_layouts, *xs):
    """The replicated convention's `shard_map`: split each global tensor
    into this rank's block by its layout, a list of (dim, group) (empty
    for an input read whole), run `body` on the blocks, and gather each
    output back into the global tensor by its layout.  `body` returns
    one tensor for one layout, or a tuple for a tuple of layouts."""
    local = []
    for x, layout in zip(xs, in_layouts):
        for dim, group in layout:
            x = _Split.apply(x, group, dim)
        local.append(x)
    out = body(*local)
    single = not isinstance(out, tuple)
    outs, layouts = ((out,), (out_layouts,)) if single else (out, out_layouts)
    gathered = []
    for o, layout in zip(outs, layouts):
        for dim, group in reversed(layout):
            o = _Gather.apply(o, group, dim)
        gathered.append(o)
    return gathered[0] if single else tuple(gathered)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over [B, T, H, D] q/k/v with the sequence split over
    `axis_name`.  T is the GLOBAL sequence length: every rank passes
    the global tensors and gets the global output.  Batch splits over
    (dp, fsdp), heads over tp."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    layout = _layout(mesh, axis_name)
    return _spmd(
        lambda q, k, v: _ring_attention_local(
            q, k, v, axis_name, causal, scale, mesh),
        [layout] * 3, layout, q, k, v)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ulysses/DeepSpeed-style SP: all_to_all so each rank holds the
    FULL sequence for a subset of heads, then dense attention, then the
    inverse all_to_all.  Requires H % sp == 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def local(q, k, v):
        # local shapes: [b, t_local, h, d]; scatter heads, gather seq
        def a2a(x):
            return collectives.all_to_all(x, axis_name, split_axis=2,
                                          concat_axis=1, tiled=True,
                                          mesh=mesh)

        def a2a_inv(x):
            return collectives.all_to_all(x, axis_name, split_axis=1,
                                          concat_axis=2, tiled=True,
                                          mesh=mesh)

        qg, kg, vg = a2a(q), a2a(k), a2a(v)  # [b, T, h/sp, d]
        T = qg.shape[1]
        bias = (_causal_bias(0, T, 0, T, qg.dtype, qg.device)
                if causal else None)
        o, m, l = _block_attn(qg, kg, vg, bias, scale)
        o = o / torch.clamp_min(l, 1e-20).transpose(1, 2)[..., None]
        return a2a_inv(o)

    layout = _layout(mesh, axis_name)
    return _spmd(local, [layout] * 3, layout, q, k, v)


def plain_attention(q, k, v, *, causal=True, scale=None):
    """Reference (unsharded) attention: scores, mask and softmax in the
    compute dtype, as the JAX reference.  DTensor inputs run on each
    rank's local blocks (`on_local_blocks`)."""
    return on_local_blocks(
        lambda q, k, v: _plain_attention(q, k, v, causal, scale), q, k, v)


def _plain_attention(q, k, v, causal, scale):
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
