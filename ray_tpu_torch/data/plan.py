"""Logical plan: lazy operator chain with map fusion.

Reference: Ray Data's logical plan + optimizer
(`data/_internal/logical/`, planner `_internal/planner/`).  The
capability kept: datasets are lazy; chained row/batch transforms fuse
into single tasks (the reference's MapFusion rule); all-to-all ops
(shuffle/sort/repartition/groupby) are explicit barrier stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.data import block as B


@dataclass
class ReadOp:
    """Source: a list of zero-arg callables, each returning a list of
    blocks (one read task per callable)."""

    read_tasks: List[Callable[[], List[B.Block]]]
    name: str = "Read"


@dataclass
class MapOp:
    """Per-block transform: Block -> List[Block].  map/map_batches/
    filter/flat_map/limit all lower to this shape."""

    fn: Callable[[B.Block], List[B.Block]]
    name: str = "Map"


@dataclass
class ActorMapOp:
    """Per-block transform executed on a pool of UDF-holding actors
    (reference: `actor_pool_map_operator.py`).  Never fused: the UDF
    instance carries state that must live in the actor."""

    cls: Any
    args: tuple
    kwargs: Dict[str, Any]
    batch_size: Optional[int]
    batch_format: str
    strategy: Any  # ActorPoolStrategy
    name: str = "ActorMap"


@dataclass
class ShuffleOp:
    """Distributed map-partition -> reduce-partition exchange
    (repartition, random_shuffle, sort, groupby) — the reference's
    push-based shuffle (`data/_internal/planner/exchange/`).  Replaces
    the old single-task AllToAll barrier: every map task partitions one
    input block into `num_partitions` pieces returned as separate
    lineage-backed objects, and every reduce task merges one
    partition's pieces, so a lost worker re-derives only its own
    blocks and an over-memory exchange spills through the object
    store instead of OOMing a gather task.

    `map_fn(block, block_index, num_partitions, aux) -> [P pieces]`;
    `reduce_fn(pieces, partition_index, aux) -> block`.  `aux` is the
    small plan-level payload (range boundaries, block offsets) built
    by `aux_fn(samples, metas, P)` after the optional `sample_fn` pass
    over input blocks.  Both fns MUST be deterministic: lineage
    reconstruction re-runs them to rebuild lost blocks mid-stream.
    """

    map_fn: Callable[[B.Block, int, int, Any], List[B.Block]]
    reduce_fn: Callable[[List[B.Block], int, Any], B.Block]
    num_partitions: Optional[int] = None
    sample_fn: Optional[Callable[[B.Block], Any]] = None
    aux_fn: Optional[Callable[[List[Any], List[Dict[str, Any]], int], Any]] = None
    name: str = "Shuffle"


@dataclass
class LimitOp:
    limit: int
    name: str = "Limit"


Op = Any  # ReadOp | MapOp | ShuffleOp | LimitOp


@dataclass
class LogicalPlan:
    ops: List[Op] = field(default_factory=list)

    def with_op(self, op: Op) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def optimized(self) -> "LogicalPlan":
        """Fuse consecutive MapOps, then fold a leading Map into the
        Read tasks (reference MapFusion incl. read fusion) — one remote
        task reads AND transforms, halving task count and object-plane
        traffic for the common read->map_batches pipeline."""
        fused: List[Op] = []
        for op in self.ops:
            if (
                isinstance(op, MapOp)
                and fused
                and isinstance(fused[-1], MapOp)
            ):
                prev = fused.pop()
                fused.append(_fuse(prev, op))
            elif (
                isinstance(op, MapOp)
                and fused
                and isinstance(fused[-1], ReadOp)
            ):
                prev = fused.pop()
                fused.append(_fuse_read(prev, op))
            else:
                fused.append(op)
        return LogicalPlan(fused)

    def describe(self) -> str:
        return " -> ".join(op.name for op in self.ops)


def _fuse(a: MapOp, b: MapOp) -> MapOp:
    fa, fb = a.fn, b.fn

    def fused(block: B.Block) -> List[B.Block]:
        out: List[B.Block] = []
        for mid in fa(block):
            out.extend(fb(mid))
        return out

    return MapOp(fn=fused, name=f"{a.name}->{b.name}")


def _fuse_read(r: ReadOp, m: MapOp) -> ReadOp:
    fm = m.fn

    def make(task):
        def read_and_map() -> List[B.Block]:
            out: List[B.Block] = []
            for blk in task():
                out.extend(fm(blk))
            return out

        return read_and_map

    return ReadOp(
        read_tasks=[make(t) for t in r.read_tasks],
        name=f"{r.name}->{m.name}",
    )
