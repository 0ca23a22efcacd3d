"""Mixture-of-experts with expert parallelism over the `ep` mesh axis.

The port of the JAX package's `parallel/moe.py`.  Top-k token routing
with a capacity factor: each (token, k) pair takes the next free slot
of its expert's fixed-capacity list (pairs past the capacity drop and
pass through the residual), every expert runs its FFN as one batched
product over its slots, and the results combine weighted by the
router's probabilities.  The arithmetic is the reference's step by
step: the router's softmax in f32, a Switch-style load-balance loss on
the top-1 column, slot positions from a cumsum over an int32 one-hot,
dropped pairs scatter-added as zeros into slot [0, 0]
(`index_put(..., accumulate=True)`), GELU in its tanh form (JAX's
default), expert products in the compute dtype.

With an `ep` axis of more than one rank, the reference's `shard_map`
becomes the replicated convention of `parallel/ring_attention.py`:
every rank passes the global tensors, takes its block of the batch and
of the experts (`P("ep")` on both; the router is read whole and its
gradient summed over the axis), routes its tokens, exchanges the slots
with `collectives.all_to_all(..., tiled=False)` there and back, and the
blocks are gathered into the global output; the aux loss is the mean of
the ranks' values.

Inside a sharded step (`moe_forward(..., shards=)`, the params this
rank's compute blocks from `sharding.LocalShards`) the layer computes
the reference's function on the step's own layout.  The reference's
`shard_map` routes chunk k of the global batch (B / ep contiguous rows,
the whole sequence) on ep rank k with that chunk's capacity, whatever
the data axes did to the rows.  The step splits the rows over ep
outermost (`LocalShards.rows`), so the ranks of one ep rank hold that
chunk between them: each gathers it over sp and the data axes
(`moe_chunk`), routes it, exchanges the slots over the ep group with
`collectives.all_to_all`, runs its resident experts, exchanges back,
combines and keeps its own rows and sequence chunk (`moe_rows`).  The
data ranks of one chunk compute it alike, each carrying the gradient of
its own rows, so the gather's backward is a reduce-scatter and the
router's and the experts' gradients are summed over the data axes like
any other leaf's (and the router's over ep too).  Over tp the experts
split Megatron's way: `w_in` by its hidden columns, `w_out` by its
hidden rows, `enter` before the first product and `exit` (the sum over
tp) after the second.  GELU is elementwise over the hidden units, so
this is the reference's function, and it spares the gather over tp of
each rank's experts (0.94 GB of f32 a layer at Mixtral-8x7B's widths)
that the reference's way (the experts whole inside `shard_map`) takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel import sharding as _sh
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.ring_attention import _Replicated, _spmd


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int
    hidden: int
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def init_moe(cfg: MoEConfig, generator: Union[int, torch.Generator] = 0,
             device=None) -> Dict:
    """f32 params drawn from `generator` (a seed or a `torch.Generator`
    on `device`).  The draws differ from `jax.random`'s: to compare with
    the JAX package, copy its params across with
    `models.bridge.params_from_numpy`."""
    device = resolve_device(device)
    if isinstance(generator, int):
        gen = torch.Generator(device=device)
        gen.manual_seed(generator)
    else:
        gen = generator
    E, Dm, Dh = cfg.num_experts, cfg.dim, cfg.hidden
    std = 0.02

    def n(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)

    return {"router": n((Dm, E)), "w_in": n((E, Dm, Dh)),
            "w_out": n((E, Dh, Dm))}


def moe_logical_axes(cfg: MoEConfig) -> Dict:
    return {
        "router": ("embed", None),
        "w_in": ("expert", "embed", "mlp"),
        "w_out": ("expert", "mlp", "embed"),
    }


def _capacity(tokens_per_device: int, cfg: MoEConfig, ep: int) -> int:
    cap = int(cfg.capacity_factor * tokens_per_device * cfg.top_k
              / cfg.num_experts)
    return max(cap, 4)


def moe_forward(cfg: MoEConfig, params: Dict, x: torch.Tensor,
                mesh=None, shards=None) -> Tuple[torch.Tensor, Dict]:
    """x [B, T, D] -> (out [B, T, D], aux {load_balance_loss}).

    Without a mesh (or ep=1) this is the single-device dense-dispatch
    path; with an `ep` axis (a `DeviceMesh` every rank passes with the
    same global x) the same math runs per rank with all_to_all token
    exchange.  Inside a sharded step (`shards` a `LocalShards`, `params`
    its compute blocks, x this rank's rows and sequence chunk) the
    layer of the module's docstring; the aux loss is then this rank's
    ep chunk's.
    """
    if isinstance(shards, _sh.LocalShards):
        return _moe_forward_sharded(cfg, params, x, shards)
    if (mesh is not None and "ep" in (mesh.mesh_dim_names or ())
            and axis_size(mesh, "ep") > 1):
        return _moe_forward_ep(cfg, params, x, mesh)
    return _moe_forward_local(cfg, params, x)


def _route(cfg: MoEConfig, router_w, x2d):
    """Top-k routing; returns (probs [N, k], idx [N, k], aux loss)."""
    probs = _router_probs(router_w, x2d)
    return _gate(cfg, probs, torch.topk(probs, cfg.top_k, dim=-1)[1])


def _router_probs(router_w, x2d):
    """The router's softmax over the experts, in f32: [N, E]."""
    return torch.softmax(x2d.float() @ router_w, dim=-1)


def _gate(cfg: MoEConfig, probs, top_i):
    """The routing at the chosen experts `top_i` [N, k]: (their probs
    renormalised to sum to 1, top_i, the load-balance loss)."""
    top_p = probs.gather(-1, top_i)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: frac of tokens per expert x mean prob
    me = probs.mean(dim=0)
    ce = F.one_hot(top_i[:, 0], cfg.num_experts).float().mean(dim=0)
    aux = cfg.num_experts * (me * ce).sum()
    return top_p, top_i, aux


def _expert_ffn(cfg: MoEConfig, w_in, w_out, slots, shards=_sh.UNSHARDED):
    """slots [E_local, C, D] -> [E_local, C, D]; one batched matmul per
    projection (under a sharded step, this tp rank's hidden units of
    each expert, the second product summed over tp)."""
    h = torch.bmm(shards.enter(slots.to(cfg.dtype)), w_in.to(cfg.dtype))
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    return shards.exit(torch.bmm(h, w_out.to(cfg.dtype)))


def _dispatch(cfg: MoEConfig, x2d, top_p, top_i, capacity: int):
    """Build fixed-capacity expert slots.  Returns (slots [E, C, D],
    slot_pos [N, k], keep [N, k]); combine weights come from the router
    probs in _combine."""
    N = x2d.shape[0]
    E, C = cfg.num_experts, capacity
    # position of each (token, k) within its expert's slot list
    flat_i = top_i.reshape(-1)  # [N*k]
    one_hot = F.one_hot(flat_i, E).to(torch.int32)  # [N*k, E]
    pos_in_expert = torch.cumsum(one_hot, dim=0, dtype=torch.int32) - one_hot
    slot = (pos_in_expert * one_hot).sum(dim=-1)  # [N*k]
    keep = slot < C
    flat_tok = torch.arange(N, device=x2d.device).repeat_interleave(
        cfg.top_k)
    zero = torch.zeros_like(flat_i)
    vals = torch.where(keep[:, None], x2d[flat_tok], 0)
    slots = torch.zeros((E, C, x2d.shape[1]), dtype=x2d.dtype,
                        device=x2d.device).index_put(
        (torch.where(keep, flat_i, zero), torch.where(keep, slot, zero)),
        vals, accumulate=True)
    return slots, slot.reshape(N, cfg.top_k), keep.reshape(N, cfg.top_k)


def _combine(cfg: MoEConfig, out_slots, top_p, top_i, slot_pos, keep, N):
    flat_i = top_i.reshape(-1)
    # a dropped pair's position lies past the capacity: clamp it, as the
    # reference's gather does (its value is masked out below)
    flat_s = slot_pos.reshape(-1).clamp(max=out_slots.shape[1] - 1)
    flat_keep = keep.reshape(-1)
    gathered = out_slots[flat_i, flat_s]  # [N*k, D]
    gathered = torch.where(flat_keep[:, None], gathered, 0)
    weighted = gathered * top_p.reshape(-1)[:, None].to(gathered.dtype)
    return weighted.reshape(N, cfg.top_k, -1).sum(dim=1)


def _routed(cfg: MoEConfig, router_w, w_in, w_out, xs, group=None,
            shards=_sh.UNSHARDED):
    """xs [b, T, D], the tokens routed together with their own capacity
    -> (out [b, T, D] in xs's dtype, the load-balance loss).  Over an ep
    `group` (w_in / w_out this rank's experts) slot block j goes to rank
    j and back with `collectives.all_to_all`; `shards` splits the
    experts' hidden units over tp."""
    b, T, D = xs.shape
    x2d = xs.reshape(b * T, D)
    top_p, top_i, aux = _route(cfg, router_w, x2d)
    ep = 1 if group is None else group.size()
    cap = _capacity(b * T, cfg, ep)
    slots, slot_pos, keep = _dispatch(cfg, x2d, top_p, top_i, cap)
    if ep > 1:
        # slots [E, C, D] -> [ep, e_local, C, D]: block j goes to rank j,
        # and what arrives stacks on a new leading axis of peers; each
        # resident expert runs ONE matmul over peer*C rows (the peer dim
        # folded into capacity) — no weight replication
        e_local = cfg.num_experts // ep
        recv = collectives.all_to_all(slots.reshape(ep, e_local, cap, D),
                                      group, split_axis=0, concat_axis=0,
                                      tiled=False)
        slots = recv.transpose(0, 1).reshape(e_local, ep * cap, D)
    out = _expert_ffn(cfg, w_in, w_out, slots, shards)
    if ep > 1:
        # return to owners: inverse all_to_all
        out = out.reshape(e_local, ep, cap, D).transpose(0, 1)
        out = collectives.all_to_all(out.contiguous(), group, split_axis=0,
                                     concat_axis=0, tiled=False).reshape(
            cfg.num_experts, cap, D)
    combined = _combine(cfg, out, top_p, top_i, slot_pos, keep, b * T)
    return combined.reshape(b, T, D).to(xs.dtype), aux


def _moe_forward_local(cfg: MoEConfig, params: Dict, x: torch.Tensor):
    out, aux = _routed(cfg, params["router"], params["w_in"],
                       params["w_out"], x)
    return out, {"load_balance_loss": aux}


def _moe_forward_ep(cfg: MoEConfig, params: Dict, x: torch.Tensor, mesh):
    group = mesh.get_group("ep")
    ep = group.size()
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts {cfg.num_experts} must divide over "
                         f"ep {ep}")

    def body(router_w, w_in, w_out, xs):
        # xs: this rank's token shard [b, T, D]
        out, aux = _routed(cfg, router_w, w_in, w_out, xs, group)
        return out, aux.reshape(1)

    shard = [(0, group)]  # P("ep"): experts, and the batch
    router = _Replicated.apply(params["router"], group)  # P()
    out, aux = _spmd(body, [[], shard, shard, shard], (shard, shard),
                     router, params["w_in"], params["w_out"], x)
    return out, {"load_balance_loss": aux.mean()}


def _moe_forward_sharded(cfg: MoEConfig, params: Dict, x: torch.Tensor,
                         shards):
    ep, E = shards.ep, cfg.num_experts
    if E % ep or params["w_in"].shape[0] != E // ep:
        raise ValueError(f"{E} experts split over ep {ep} leave "
                         f"{params['w_in'].shape[0]} on this rank")
    # chunk ep_rank of the batch [B / ep, T, D], routed with its capacity
    y, aux = _routed(cfg, params["router"], params["w_in"],
                     params["w_out"], shards.moe_chunk(x),
                     shards.ep_group if ep > 1 else None, shards)
    return shards.moe_rows(y), {"load_balance_loss": aux}
