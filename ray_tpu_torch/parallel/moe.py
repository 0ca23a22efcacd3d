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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel import collectives
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
                mesh=None) -> Tuple[torch.Tensor, Dict]:
    """x [B, T, D] -> (out [B, T, D], aux {load_balance_loss}).

    Without a mesh (or ep=1) this is the single-device dense-dispatch
    path; with an `ep` axis (a `DeviceMesh` every rank passes with the
    same global x) the same math runs per rank with all_to_all token
    exchange.
    """
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


def _expert_ffn(cfg: MoEConfig, w_in, w_out, slots):
    """slots [E_local, C, D] -> [E_local, C, D]; one batched matmul per
    projection."""
    h = torch.bmm(slots.to(cfg.dtype), w_in.to(cfg.dtype))
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    return torch.bmm(h, w_out.to(cfg.dtype))


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


def _moe_forward_local(cfg: MoEConfig, params: Dict, x: torch.Tensor):
    B, T, D = x.shape
    x2d = x.reshape(B * T, D)
    top_p, top_i, aux = _route(cfg, params["router"], x2d)
    cap = _capacity(B * T, cfg, ep=1)
    slots, slot_pos, keep = _dispatch(cfg, x2d, top_p, top_i, cap)
    out_slots = _expert_ffn(cfg, params["w_in"], params["w_out"], slots)
    out = _combine(cfg, out_slots, top_p, top_i, slot_pos, keep, B * T)
    return out.reshape(B, T, D).to(x.dtype), {"load_balance_loss": aux}


def _moe_forward_ep(cfg: MoEConfig, params: Dict, x: torch.Tensor, mesh):
    group = mesh.get_group("ep")
    ep = group.size()
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts {cfg.num_experts} must divide over "
                         f"ep {ep}")
    e_local = cfg.num_experts // ep

    def body(router_w, w_in, w_out, xs):
        # xs: this rank's token shard [b, T, D]
        b, T, D = xs.shape
        x2d = xs.reshape(b * T, D)
        top_p, top_i, aux = _route(cfg, router_w, x2d)
        cap = _capacity(b * T, cfg, ep)
        slots, slot_pos, keep = _dispatch(cfg, x2d, top_p, top_i, cap)
        # slots [E, C, D] -> [ep, e_local, C, D]: block j goes to rank j,
        # and what arrives stacks on a new leading axis of peers
        slots = slots.reshape(ep, e_local, cap, D)
        recv = collectives.all_to_all(slots, group, split_axis=0,
                                      concat_axis=0, tiled=False)
        # run resident experts over all peers' tokens: fold the peer dim
        # into capacity so each resident expert runs ONE matmul over
        # peer*C rows — no weight replication
        peer, el = recv.shape[0], recv.shape[1]
        stacked = recv.transpose(0, 1).reshape(el, peer * cap, D)
        out = _expert_ffn(cfg, w_in, w_out, stacked)
        out = out.reshape(el, peer, cap, D).transpose(0, 1)
        # return to owners: inverse all_to_all
        back = collectives.all_to_all(out.contiguous(), group, split_axis=0,
                                      concat_axis=0, tiled=False)
        out_slots = back.reshape(cfg.num_experts, cap, D)
        combined = _combine(cfg, out_slots, top_p, top_i, slot_pos, keep,
                            b * T)
        return combined.reshape(b, T, D).to(xs.dtype), aux.reshape(1)

    shard = [(0, group)]  # P("ep"): experts, and the batch
    router = _Replicated.apply(params["router"], group)  # P()
    out, aux = _spmd(body, [[], shard, shard, shard], (shard, shard),
                     router, params["w_in"], params["w_out"], x)
    return out, {"load_balance_loss": aux.mean()}
