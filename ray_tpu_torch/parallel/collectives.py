"""Collective communication.

Two tiers, per SURVEY §5.8:

1. **In-program collectives** — `psum`, `pmean`, `all_gather`,
   `reduce_scatter`, `ppermute` and `all_to_all` over the
   `torch.distributed` group of one mesh axis (a `DeviceMesh` dimension
   name, or a process group), with the arguments of their `jax.lax`
   namesakes (`axis`, `tiled`, `perm`, `split_axis` / `concat_axis`)
   and JAX's meaning for each.  Every rank calls them with its own
   local value, as each device does inside `shard_map`.  `ppermute` and
   `all_to_all` are differentiable, as JAX differentiates them (the
   backward is the inverse permutation, or the inverse all-to-all);
   the other four return values without a gradient.  NCCL moves CUDA
   tensors on the card; any other backend (gloo) is given CUDA tensors
   through an explicit copy to the host and back, counted in
   `TRANSPORTS` by (op, backend, "device" | "host"), never a silent
   fallback.  On every backend `all_to_all` is one send / recv pair a
   peer and `reduce_scatter` an all-reduce cut to this member's block
   (gloo has no alltoall in the card's torch build).

2. **Host-level actor-group collectives** — the surface of the
   reference's `ray.util.collective` (`util/collective/collective.py:120`
   init_collective_group, `:258-615` allreduce/allgather/...), on numpy
   host arrays.  Where the reference backs this with NCCL (cupy) or
   Gloo, here the rendezvous and data movement ride the framework's own
   object plane (a named rendezvous actor + shm objects).  This tier is
   the JAX package's own, copied over the port's runtime.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict, List

import numpy as np

# ---- tier 1: in-program (torch imported lazily to keep core torch-free)

# (op, backend, "device" | "host") -> calls: how each collective's bytes
# travelled (a gloo group given CUDA tensors copies them to the host);
# the same key -> the input bytes, and the ms from staging to the result
TRANSPORTS: Counter = Counter()
TRANSPORT_BYTES: Counter = Counter()
TRANSPORT_MS: Counter = Counter()


def _group(axis_name, mesh):
    """The process group of `axis_name`: a mesh dimension's name, or a
    group given directly."""
    if isinstance(axis_name, str):
        if mesh is None:
            raise ValueError(
                f"axis {axis_name!r} names a mesh dimension: pass mesh=")
        return mesh.get_group(axis_name)
    return axis_name


def _stage(x, group, op: str):
    """`x` as the group's backend takes it: CUDA tensors go to the host
    for any backend but NCCL.  Returns (tensor, where to return it: the
    device or None, with the op's key and start for `_back`)."""
    import torch.distributed as dist

    backend = str(dist.get_backend(group))
    host = x.is_cuda and backend != "nccl"
    key = (op, backend, "host" if host else "device")
    TRANSPORTS[key] += 1
    TRANSPORT_BYTES[key] += x.numel() * x.element_size()
    where = (x.device if host else None, key, time.perf_counter())
    if host:
        return x.detach().cpu().contiguous(), where
    return x.detach().contiguous(), where


def _back(out, where):
    device, key, t0 = where
    out = out if device is None else out.to(device)
    # the host wall of the op from its staging on (a host route's copy
    # back from pageable memory returns once it is done)
    TRANSPORT_MS[key] += (time.perf_counter() - t0) * 1e3
    return out


def _size_rank(group):
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


def psum(x, axis_name, *, mesh=None):
    """Sum of `x` over the axis, on every member."""
    import torch.distributed as dist

    g = _group(axis_name, mesh)
    t, where = _stage(x, g, "psum")
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return _back(t, where)


def pmean(x, axis_name, *, mesh=None):
    n, _ = _size_rank(_group(axis_name, mesh))
    return psum(x, axis_name, mesh=mesh) / n


def all_gather(x, axis_name, axis=0, tiled=True, *, mesh=None):
    """Every member's `x`, concatenated along `axis` (tiled) or stacked
    on a new axis at `axis`, in member order."""
    import torch
    import torch.distributed as dist

    g = _group(axis_name, mesh)
    n, _ = _size_rank(g)
    t, where = _stage(x, g, "all_gather")
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=g)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
    return _back(out, where)


def reduce_scatter(x, axis_name, scatter_dimension=0, tiled=True, *,
                   mesh=None):
    """`psum` then this member's block along `scatter_dimension` (JAX's
    `psum_scatter`): a block of size/n (tiled), or the index itself
    with the dimension dropped (untiled: its size must be n)."""
    import torch.distributed as dist

    g = _group(axis_name, mesh)
    n, r = _size_rank(g)
    if x.shape[scatter_dimension] % n:
        raise ValueError(
            f"dimension {scatter_dimension} ({x.shape[scatter_dimension]}) "
            f"does not split over {n} members")
    if not tiled and x.shape[scatter_dimension] != n:
        raise ValueError("untiled reduce_scatter needs the dimension to "
                         f"equal the axis size {n}")
    t, where = _stage(x, g, "reduce_scatter")
    # the whole sum, then this member's block: one path for every backend
    full = t.clone()
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=g)
    out = full.chunk(n, dim=scatter_dimension)[r].contiguous()
    if not tiled:
        out = out.squeeze(scatter_dimension)
    return _back(out, where)


def _ppermute(x, group, perm):
    import torch
    import torch.distributed as dist

    _, r = _size_rank(group)
    t, where = _stage(x, group, "ppermute")
    out = torch.zeros_like(t)
    ops = []
    for src, dst in perm:
        if src == r and dst == r:
            out.copy_(t)
        elif src == r:
            ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(
                group, dst), group))
        elif dst == r:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(out, where)


def _check_perm(perm, n: int):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {perm} repeats a source or destination")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"perm {perm} names a member outside 0..{n - 1}")


def _all_to_all(x, group, split_axis, concat_axis, tiled):
    import torch
    import torch.distributed as dist

    n, r = _size_rank(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} ({x.shape[split_axis]}) "
                         f"does not split over {n} members")
    if not tiled and x.shape[split_axis] != n:
        raise ValueError("untiled all_to_all needs the split dimension to "
                         f"equal the axis size {n}")
    t, where = _stage(x, group, "all_to_all")
    send = [c.contiguous() for c in t.chunk(n, dim=split_axis)]
    recv = [torch.empty_like(c) for c in send]
    # one send / recv pair a peer, on every backend (gloo has no
    # alltoall in the card's torch build)
    recv[r].copy_(send[r])
    ops = []
    for j in range(n):
        if j != r:
            peer = dist.get_global_rank(group, j)
            ops.append(dist.P2POp(dist.isend, send[j], peer, group))
            ops.append(dist.P2POp(dist.irecv, recv[j], peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if tiled:
        out = torch.cat(recv, dim=concat_axis)
    else:
        out = torch.stack([c.squeeze(split_axis) for c in recv],
                          dim=concat_axis)
    return _back(out, where)


def _autograd():
    """The two differentiable collectives, built on first use (torch is
    not imported with this module)."""
    global _PPermute, _AllToAll
    if _PPermute is not None:
        return
    import torch

    class PPermute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, perm):
            ctx.group, ctx.perm = group, perm
            return _ppermute(x, group, perm)

        @staticmethod
        def backward(ctx, g):
            inv = [(d, s) for s, d in ctx.perm]
            return _ppermute(g, ctx.group, inv), None, None

    class AllToAll(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, split_axis, concat_axis, tiled):
            ctx.args = (group, split_axis, concat_axis, tiled)
            return _all_to_all(x, group, split_axis, concat_axis, tiled)

        @staticmethod
        def backward(ctx, g):
            group, split_axis, concat_axis, tiled = ctx.args
            # the inverse exchange swaps the two axes (untiled: split
            # where the forward stacked, stack where it split)
            back = _all_to_all(g, group, concat_axis, split_axis, tiled)
            return back, None, None, None, None

    _PPermute, _AllToAll = PPermute, AllToAll


_PPermute = _AllToAll = None


def ppermute(x, axis_name, perm, *, mesh=None):
    """Send `x` from member `src` to member `dst` for each pair of
    `perm`; a member no pair sends to gets zeros.  The gradient runs the
    inverse permutation."""
    g = _group(axis_name, mesh)
    _check_perm(perm, _size_rank(g)[0])
    _autograd()
    return _PPermute.apply(x, g, [tuple(p) for p in perm])


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True, *,
               mesh=None):
    """Split `x` along `split_axis` into one block a member, send block
    j to member j, and join what arrives along `concat_axis` (tiled),
    or stack it there with `split_axis` dropped (untiled, as JAX).  The
    gradient runs the inverse all-to-all."""
    g = _group(axis_name, mesh)
    _autograd()
    return _AllToAll.apply(x, g, split_axis, concat_axis, tiled)


# ---- tier 2: host-level actor-group collectives ----------------------

_REDUCERS = {
    "sum": lambda xs: sum(xs[1:], start=xs[0]),
    "mean": lambda xs: sum(xs[1:], start=xs[0]) / len(xs),
    "max": lambda xs: np.maximum.reduce(xs),
    "min": lambda xs: np.minimum.reduce(xs),
}

_PAIR_REDUCERS = {
    "sum": np.add,
    "mean": np.add,  # divided by world size at the end
    "max": np.maximum,
    "min": np.minimum,
}

# arrays at least this big take the ring path (bandwidth-optimal);
# below it the one-shot rendezvous exchange wins on latency
_RING_MIN_BYTES = 1 << 20


class _Rendezvous:
    """Named actor coordinating one collective group (the reference uses
    a named store actor for rendezvous the same way —
    `collective_group/nccl_collective_group.py` Rendezvous)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: Dict[int, Dict[int, Any]] = {}
        self.results: Dict[int, Any] = {}
        self.barrier_count: Dict[int, int] = {}
        self.mailbox: Dict[tuple, Any] = {}  # p2p: (seq, src, dst) -> value

    def contribute(self, round_id: int, rank: int, value, op: str):
        slot = self.rounds.setdefault(round_id, {})
        slot[rank] = value
        if len(slot) == self.world_size:
            xs = [slot[r] for r in range(self.world_size)]
            if op == "gather":
                self.results[round_id] = xs
            else:
                self.results[round_id] = _REDUCERS[op](xs)
            del self.rounds[round_id]
        return True

    def fetch(self, round_id: int):
        return self.results.get(round_id, _PENDING)

    def finish(self, round_id: int, rank: int):
        # last fetcher clears the slot
        c = self.barrier_count.get(round_id, 0) + 1
        if c >= self.world_size:
            self.results.pop(round_id, None)
            self.barrier_count.pop(round_id, None)
        else:
            self.barrier_count[round_id] = c

    def p2p_put(self, key: tuple, value):
        self.mailbox[key] = value
        return True

    def p2p_take(self, key: tuple):
        # pop-on-read: each (seq, src, dst) message is consumed once
        return self.mailbox.pop(key, _PENDING)


_PENDING = "__rt_pending__"


class CollectiveGroup:
    """Handle held by each member process/actor."""

    def __init__(self, group_name: str, world_size: int, rank: int):
        import ray_tpu_torch as rt

        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._round = 0
        name = f"__rt_collective__{group_name}"
        if rank == 0:
            self._rdv = rt.remote(_Rendezvous).options(
                name=name, num_cpus=0, max_concurrency=16
            ).remote(world_size)
        else:
            deadline = time.time() + 60
            while True:
                try:
                    self._rdv = rt.get_actor(name)
                    break
                except ValueError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)

    # -- ops (reference surface: collective.py:258-615) ---------------
    def _exchange(self, value, op: str):
        import ray_tpu_torch as rt

        round_id = self._round
        self._round += 1
        rt.get(self._rdv.contribute.remote(round_id, self.rank, value, op))
        while True:
            out = rt.get(self._rdv.fetch.remote(round_id))
            if not (isinstance(out, str) and out == _PENDING):
                break
            time.sleep(0.002)
        self._rdv.finish.remote(round_id, self.rank)
        return out

    def allreduce(self, array, op: str = "sum"):
        arr = np.asarray(array)
        if (
            arr.nbytes >= _RING_MIN_BYTES
            and self.world_size > 1
            and op in _PAIR_REDUCERS
        ):
            return self._ring_allreduce(arr, op)
        return self._exchange(arr, op)

    def _ring_allreduce(self, arr, op: str):
        """Bandwidth-optimal ring allreduce (reduce-scatter +
        allgather; the NCCL algorithm the reference's collective group
        gets from `nccl_collective_group.py:175`).  Only CHUNK REFS
        travel through the rendezvous mailbox — the payloads move
        peer-to-peer over the object plane (shm + chunked daemon
        transfer), so per-rank traffic is 2·size·(N-1)/N instead of
        every byte funneling through one actor process."""
        import ray_tpu_torch as rt

        n = self.world_size
        r = self.rank
        shape, dtype = arr.shape, arr.dtype
        flat = np.ascontiguousarray(arr).reshape(-1)
        acc = [c.astype(np.float64) if op == "mean" else c.copy()
               for c in np.array_split(flat, n)]
        right = (r + 1) % n
        left = (r - 1) % n
        reduce_pair = _PAIR_REDUCERS[op]

        held = []  # sender-side anchors: a chunk must outlive its
        # in-flight window (receiver's borrow registers asynchronously);
        # released after the closing barrier proves every recv landed

        def _send_chunk(chunk):
            # ship the REF (wrapped in a list: a bare ref as an
            # actor-call arg would materialize in the rendezvous);
            # payload stays in the object plane.  Bypasses send()'s
            # np.asarray coercion.
            ref = rt.put(chunk)
            held.append(ref)
            seq = self._p2p_next(r, right)
            rt.get(self._rdv.p2p_put.remote((seq, r, right), [ref]))

        def _recv_chunk():
            [ref] = self.recv(left)
            return rt.get(ref)

        # reduce-scatter: after n-1 steps rank r holds the fully
        # reduced chunk (r+1) mod n.  The reduce writes IN PLACE into
        # the accumulator chunk (acc entries are private copies): the
        # out-of-place form allocated + wrote a fresh chunk per step,
        # doubling memory traffic on the host tier's scarcest resource
        # (all ranks time-slice the same cores)
        # (safe unconditionally: every acc entry is a fresh writable
        # copy/astype, and all ranks run the identical dtype pipeline,
        # so received chunks always match the accumulator's dtype)
        for step in range(n - 1):
            _send_chunk(acc[(r - step) % n])
            recv_idx = (r - step - 1) % n
            tgt = acc[recv_idx]
            reduce_pair(tgt, _recv_chunk(), out=tgt)
        # allgather: circulate the reduced chunks
        for step in range(n - 1):
            _send_chunk(acc[(r - step + 1) % n])
            recv_idx = (r - step) % n
            acc[recv_idx] = _recv_chunk()
        out = np.concatenate(acc)
        self.barrier()  # every rank received: safe to drop `held`
        del held
        if op == "mean":
            out = out / n
            # float inputs keep their dtype (as the small path does);
            # integer means stay float so they never truncate
            if np.issubdtype(dtype, np.floating):
                out = out.astype(dtype, copy=False)
            return out.reshape(shape)
        return out.astype(dtype, copy=False).reshape(shape)

    def allgather(self, array) -> List:
        return self._exchange(np.asarray(array), "gather")

    def broadcast(self, array, src_rank: int = 0):
        out = self._exchange(np.asarray(array) if self.rank == src_rank else None,
                             "gather")
        return out[src_rank]

    def reducescatter(self, array, op: str = "sum"):
        full = self._exchange(np.asarray(array), op)
        chunks = np.array_split(full, self.world_size)
        return chunks[self.rank]

    def barrier(self):
        self._exchange(0, "sum")

    # -- p2p (reference surface: collective.py send:531 / recv:594) ---
    def _p2p_next(self, src: int, dst: int) -> int:
        seqs = getattr(self, "_p2p_seq", None)
        if seqs is None:
            seqs = self._p2p_seq = {}
        n = seqs.get((src, dst), 0)
        seqs[(src, dst)] = n + 1
        return n

    def send(self, array, dst_rank: int):
        """Post one array to dst_rank; pairs with its recv in program
        order per (src, dst) channel — both sides keep a pairwise
        sequence counter, so interleaved sends to different peers don't
        cross."""
        import ray_tpu_torch as rt

        seq = self._p2p_next(self.rank, dst_rank)
        rt.get(self._rdv.p2p_put.remote(
            (seq, self.rank, dst_rank), np.asarray(array)
        ))

    def recv(self, src_rank: int, timeout_s: float = 60.0):
        """Blocking receive of the next message from src_rank.  The
        pairwise sequence advances only on success: a timed-out recv
        leaves the channel aligned, so a retry picks up the message the
        sender eventually posts."""
        import ray_tpu_torch as rt

        seqs = getattr(self, "_p2p_seq", None)
        if seqs is None:
            seqs = self._p2p_seq = {}
        seq = seqs.get((src_rank, self.rank), 0)
        deadline = time.time() + timeout_s
        while True:
            out = rt.get(self._rdv.p2p_take.remote(
                (seq, src_rank, self.rank)
            ))
            if not (isinstance(out, str) and out == _PENDING):
                seqs[(src_rank, self.rank)] = seq + 1
                return out
            if time.time() > deadline:
                raise TimeoutError(
                    f"recv from rank {src_rank} timed out after {timeout_s}s"
                )
            time.sleep(0.002)


_groups: Dict[str, CollectiveGroup] = {}


def init_collective_group(
    world_size: int, rank: int, group_name: str = "default"
) -> CollectiveGroup:
    """Reference: `ray.util.collective.init_collective_group`
    (`collective.py:120`)."""
    g = CollectiveGroup(group_name, world_size, rank)
    _groups[group_name] = g
    return g


def get_group(group_name: str = "default") -> CollectiveGroup:
    return _groups[group_name]


def allreduce(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(array, op)


def allgather(array, group_name: str = "default"):
    return get_group(group_name).allgather(array)


def broadcast(array, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank)


def reducescatter(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(array, op)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


def send(array, dst_rank: int, group_name: str = "default"):
    get_group(group_name).send(array, dst_rank)


def recv(src_rank: int, group_name: str = "default", timeout_s: float = 60.0):
    return get_group(group_name).recv(src_rank, timeout_s)


def destroy_collective_group(group_name: str = "default"):
    g = _groups.pop(group_name, None)
    if g is not None and g.rank == 0:
        import ray_tpu_torch as rt

        try:
            rt.kill(g._rdv)
        except Exception:
            pass
