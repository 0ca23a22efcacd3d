"""Pipeline parallelism over the `pp` mesh axis.

The port of the JAX package's `parallel/pipeline.py`: stage parameters
are stacked on a leading stage dim, split over `pp` (`stage_sharding`),
and a GPipe microbatch schedule runs on every rank of the axis — each
step every rank computes its resident stage and hands its activation to
the next stage with `collectives.ppermute`.  The bubble is the standard
(S-1)/(M+S-1) fraction.

Where the reference's `shard_map` takes global arrays, here every rank
of the mesh passes the same global stage params and batch (the
replicated convention of `parallel/ring_attention.py`): each rank takes
its stage's slice of the params, and the last stage's outputs reach
every rank through a masked sum over the axis, as in the reference.
`torch.autograd` through `pipeline_apply` gives every rank the serial
gradients: the params' split gathers every stage's gradient, the batch
(read by stage 0) has its gradient summed over the axis, and the
closing sum passes each rank its output's gradient unchanged (every
rank holds the same loss, so summing would count it S times).  Every
rank builds the same graph (the stage-0 feed and the last stage's
outputs are selected by masks, as in the reference's SPMD program), so
the backward's collectives run in the same order on each.

For cross-host pipelines where stages cannot share a program, the
actor-level alternative is `parallel/pipeline_dag.py` over the compiled
graphs' channels — same schedule family, channels instead of
ppermute.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import axis_size, placements
from ray_tpu_torch.parallel.ring_attention import _Replicated, _Split


def stage_sharding(mesh) -> tuple:
    """Placements for stage-stacked params (leading dim = num stages):
    `Shard(0)` over `pp`."""
    return placements(mesh, ("pp",))


class _SumLast(torch.autograd.Function):
    """The closing masked sum: every rank gets the sum of the ranks'
    contributions (only the last stage's are non-zero); the gradient is
    the rank's own output gradient, since every rank holds the same
    replicated loss."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    mesh,
    num_microbatches: int,
):
    """Run x [B, ...] through S pipeline stages.

    stage_params: pytree whose leaves have leading dim S (split over
    `pp`); stage_fn(params_slice, microbatch) -> microbatch-shaped
    output (stages must preserve the activation shape, the usual
    transformer-block contract).  Every rank of the mesh passes the
    same global params and x and gets the global output.

    B must divide into num_microbatches equal microbatches.
    """
    S = axis_size(mesh, "pp")
    leaves, spec = pytree.tree_flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != S:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} must equal the "
                f"mesh's pp size {S} — a mismatch would silently drop "
                "stages after sharding"
            )
    B = x.shape[0]
    M = num_microbatches
    assert B % M == 0, f"num_microbatches {M} must divide batch {B}"
    mb = B // M
    group = mesh.get_group("pp")
    idx = group.rank()
    # this rank's stage: one split of all the leaves flattened side by
    # side, so the backward gathers every stage's gradient in one call
    flat = torch.cat([p.reshape(S, -1) for p in leaves], dim=1)
    mine = _Split.apply(flat, group, 0)[0]
    sizes = [p[0].numel() for p in leaves]
    params_local = pytree.tree_unflatten(
        [c.reshape(p.shape[1:]) for c, p in zip(mine.split(sizes), leaves)],
        spec)
    xs = _Replicated.apply(x.reshape(M, mb, *x.shape[1:]), group)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == S - 1, device=x.device)
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    T = M + S - 1  # schedule length incl. pipeline bubble
    recv = torch.zeros_like(xs[0])
    outs = []
    for t in range(T):
        # stage 0 consumes microbatch t while t < M; later stages
        # consume what arrived from the previous stage
        x_in = torch.where(first, xs[min(t, M - 1)], recv)
        y = stage_fn(params_local, x_in)
        # the last stage banks its result for microbatch t - (S - 1)
        if t >= S - 1:
            outs.append(y)
        # the reference also sends after the last step; nothing reads it
        if t + 1 < T:
            recv = collectives.ppermute(y, group, fwd_perm)
    contrib = torch.where(last, torch.stack(outs), 0)
    out = _SumLast.apply(contrib, group)
    return out.reshape(B, *x.shape[1:])
