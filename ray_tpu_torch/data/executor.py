"""Streaming executor: runs a LogicalPlan as a pipelined stream of
remote tasks over block refs.

Reference: `data/_internal/execution/streaming_executor.py:48` — a
pull-based operator pipeline with bounded in-flight work per stage
(backpressure) instead of stage-by-stage materialization.  Here each
stage is a generator over (block_ref, meta_ref) pairs; map stages keep
a sliding window of submitted tasks, so at any moment at most
`window` tasks per stage are in flight and blocks stream through the
object plane without ever being gathered on the driver.  Every task
returns (block, metadata) as two objects, so the driver reads row
counts without fetching payloads (the reference's Block/BlockMetadata
split, `data/block.py`).

Fault model: every data-plane task is submitted with
`DataContext.data_task_max_retries`, so a worker SIGKILLed mid-epoch
retries through the core worker-died path, and a block evicted/lost
AFTER its task completed re-derives via lineage reconstruction when a
consumer pulls it — the epoch keeps streaming either way.
Unrecoverable losses (retries exhausted, lineage gone) surface as the
core plane's typed errors (`WorkerCrashedError`, `ObjectLostError`,
`ObjectReconstructionFailedError`) at the consuming `rt.get`, never as
a hang.  Shuffles run as a distributed map/reduce exchange
(`data/shuffle.py`), not a single gather task.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.plan import (
    ActorMapOp,
    LimitOp,
    LogicalPlan,
    MapOp,
    ReadOp,
    ShuffleOp,
)

logger = logging.getLogger(__name__)

# (block_ref, meta_ref-or-value)
RefPair = Tuple[Any, Any]


def resolve_metas(metas: List[Any]) -> List[Dict[str, Any]]:
    """Materialize a list of metadata entries with ONE batched
    `rt.get` for the unresolved refs (dicts pass through).  The old
    per-block blocking `rt.get` serialized the whole stream on
    driver-side metadata fetches; batching lets metadata reads ride
    the pipeline."""
    refs, slots = [], []
    out: List[Any] = list(metas)
    for i, m in enumerate(out):
        if not isinstance(m, dict):
            refs.append(m)
            slots.append(i)
    if refs:
        for i, v in zip(slots, rt.get(refs)):
            out[i] = v
    return out


def resolve_pairs(pairs: List[RefPair]) -> List[RefPair]:
    """(ref, meta_ref) pairs -> (ref, meta_dict) pairs, metadata
    fetched in one batch."""
    metas = resolve_metas([m for _, m in pairs])
    return [(ref, m) for (ref, _), m in zip(pairs, metas)]


def _run_read_task(read_task: Callable[[], List[B.Block]]):
    blocks = read_task()
    out = B.concat(blocks) if len(blocks) != 1 else blocks[0]
    return out, {"num_rows": B.num_rows(out), "size_bytes": B.size_bytes(out)}


def _run_map_task(fn: Callable[[B.Block], List[B.Block]], blk: B.Block):
    outs = fn(blk)
    out = B.concat(outs) if len(outs) != 1 else outs[0]
    return out, {"num_rows": B.num_rows(out), "size_bytes": B.size_bytes(out)}


class _BatchMapWorker:
    """Pool actor for ActorMapOp: constructs the UDF once, maps blocks
    batch-by-batch (reference: `actor_pool_map_operator.py` worker)."""

    def __init__(self, cls, args, kwargs, batch_size, batch_format):
        self._udf = cls(*args, **kwargs)
        self._batch_size = batch_size
        self._fmt = batch_format

    def map_block(self, blk: B.Block):
        from ray_tpu_torch.data.dataset import _coerce_batch

        out: List[B.Block] = []
        n = B.num_rows(blk)
        size = self._batch_size or n or 1
        for s in range(0, max(n, 1), size):
            piece = B.slice_block(blk, s, min(s + size, n))
            res = self._udf(B.format_batch(piece, self._fmt))
            out.append(_coerce_batch(res))
        merged = B.concat(out) if len(out) != 1 else out[0]
        return merged, {
            "num_rows": B.num_rows(merged),
            "size_bytes": B.size_bytes(merged),
        }


def _slice_task(blk: B.Block, end: int):
    out = B.slice_block(blk, 0, end)
    return out, {"num_rows": B.num_rows(out), "size_bytes": B.size_bytes(out)}


class StreamingExecutor:
    def __init__(self, plan: LogicalPlan, *, window: Optional[int] = None,
                 num_cpus: float = 1.0):
        ctx = DataContext.get_current()
        self.ctx = ctx
        self.plan = plan.optimized()
        self.window = window if window is not None else ctx.window
        self.max_stage_bytes = ctx.max_stage_inflight_bytes
        # budget in-flight bytes against the node's object store: a
        # running task PINS its inputs and outputs, and pinned bytes
        # can neither spill nor evict — unbounded in-flight pins on a
        # small store wedge every create.  (The 2x in the shuffle
        # admission below accounts input + output per task.)
        cap = self._store_capacity()
        if cap > 0:
            self.max_stage_bytes = min(
                self.max_stage_bytes,
                max(1, int(cap * ctx.store_memory_fraction)),
            )
        self._actor_depth = ctx.actor_pool_pipeline_depth
        self.task_num_cpus = num_cpus
        self._remote_opts = {
            "num_cpus": num_cpus,
            "num_returns": 2,
            # worker death mid-epoch retries instead of killing the
            # stream; lineage reconstruction rides the same budget
            "max_retries": ctx.data_task_max_retries,
        }
        self._meta_sizes: Dict[bytes, int] = {}
        self.stats: Dict[str, Any] = {"stages": self.plan.describe(), "tasks": 0}

    @staticmethod
    def _store_capacity() -> int:
        try:
            from ray_tpu_torch.core.runtime import get_runtime, is_initialized

            if is_initialized():
                return int(getattr(get_runtime().store, "capacity", 0) or 0)
        except Exception as e:
            logger.debug("object-store capacity probe failed: %s", e)
        return 0

    # -- metadata ------------------------------------------------------
    def resolve_metas(self, metas: List[Any]) -> List[Dict[str, Any]]:
        return resolve_metas(metas)

    def resolve_pairs(self, pairs: List[RefPair]) -> List[RefPair]:
        return resolve_pairs(pairs)

    def _resolved_meta_stream(self, stream: Iterator[RefPair]
                              ) -> Iterator[RefPair]:
        """Stream adapter: yields (ref, meta_dict) with metadata
        resolved in window-sized batches — a bounded lookahead instead
        of one blocking driver get per block."""
        buf: List[RefPair] = []
        for pair in stream:
            buf.append(pair)
            if len(buf) >= self.window:
                yield from self.resolve_pairs(buf)
                buf = []
        if buf:
            yield from self.resolve_pairs(buf)

    # -- stage generators ---------------------------------------------
    def _read_stream(self, op: ReadOp) -> Iterator[RefPair]:
        read_remote = rt.remote(_run_read_task).options(**self._remote_opts)
        inflight: deque = deque()
        for task in op.read_tasks:
            while len(inflight) >= self.window:
                yield inflight.popleft()
            inflight.append(tuple(read_remote.remote(task)))
            self.stats["tasks"] += 1
        while inflight:
            yield inflight.popleft()

    def _input_size(self, meta) -> int:
        """Estimated bytes of an input block, WITHOUT stalling the
        pipeline: metadata is consulted only when already materialized
        (a dict, or a completed task's ready ref) — else 0 (unknown,
        count-based pressure still applies).  Resolved sizes are cached
        by ref so multi-stage pipelines probe the runtime once per
        block, not once per stage (the per-block probe the round-2
        review flagged)."""
        if isinstance(meta, dict):
            return int(meta.get("size_bytes", 0))
        cache = self._meta_sizes
        try:
            key = meta.binary()
        except AttributeError:
            key = None  # plain value, not a ref — no cache slot
        if key is not None and key in cache:
            return cache[key]
        try:
            done, _ = rt.wait([meta], timeout=0)
            if done:
                size = int(rt.get(meta).get("size_bytes", 0))
                if key is not None:
                    if len(cache) > 4096:
                        cache.clear()
                    cache[key] = size
                return size
        except Exception as e:
            # best-effort probe: fall through to "unknown size" but
            # keep the cause visible for the next incident
            logger.debug("in-flight size probe failed: %s", e)
        return 0

    def _map_stream(self, stream: Iterator[RefPair], op: MapOp) -> Iterator[RefPair]:
        """Task-based map with count- AND byte-based backpressure
        (reference: ConcurrencyCapBackpressurePolicy + the resource
        manager's per-operator memory budgets)."""
        map_remote = rt.remote(_run_map_task).options(**self._remote_opts)
        inflight: deque = deque()  # (pair, est_bytes)
        inflight_bytes = 0
        for block_ref, meta in stream:
            sz = self._input_size(meta)
            while len(inflight) >= self.window or (
                inflight and inflight_bytes + sz > self.max_stage_bytes
            ):
                pair, psz = inflight.popleft()
                inflight_bytes -= psz
                yield pair
            inflight.append(
                (tuple(map_remote.remote(op.fn, block_ref)), sz)
            )
            inflight_bytes += sz
            self.stats["tasks"] += 1
        while inflight:
            yield inflight.popleft()[0]

    def _actor_map_stream(self, stream: Iterator[RefPair],
                          op: ActorMapOp) -> Iterator[RefPair]:
        """Actor-pool map (reference: `actor_pool_map_operator.py` +
        pool autoscaler): blocks route to the least-loaded actor with
        `actor_pool_pipeline_depth` pipelining; the pool grows toward
        strategy.max_size while saturated and is torn down when the
        stream ends."""
        strat = op.strategy
        Worker = rt.remote(num_cpus=self._remote_opts["num_cpus"])(
            _BatchMapWorker
        )

        def spawn():
            return Worker.remote(op.cls, op.args, op.kwargs,
                                 op.batch_size, op.batch_format)

        actors = [spawn() for _ in range(strat.min_size)]
        load = [0] * len(actors)
        outstanding: Dict[Any, int] = {}  # meta_ref -> actor index
        inflight: deque = deque()  # pairs in submission order

        def reap(block: bool):
            if not outstanding:
                return
            done, _ = rt.wait(
                list(outstanding),
                num_returns=1 if block else len(outstanding),
                timeout=None if block else 0,
            )
            for m in done:
                load[outstanding.pop(m)] -= 1

        try:
            for block_ref, _meta in stream:
                reap(block=False)
                while True:
                    i = min(range(len(actors)), key=load.__getitem__)
                    if load[i] < self._actor_depth:
                        break
                    if len(actors) < strat.max_size:
                        actors.append(spawn())
                        load.append(0)
                        i = len(actors) - 1
                        break
                    # saturated at max_size: hand completed work
                    # downstream, then wait for a slot
                    if inflight:
                        yield inflight.popleft()
                    reap(block=True)
                method = actors[i].map_block.options(num_returns=2)
                b, m = method.remote(block_ref)
                load[i] += 1
                outstanding[m] = i
                inflight.append((b, m))
                self.stats["tasks"] += 1
            while inflight:
                yield inflight.popleft()
        finally:
            for a in actors:
                try:
                    rt.kill(a)
                except Exception as e:
                    # pool teardown is best-effort: the actor may
                    # already be gone (its worker died mid-stream)
                    logger.debug("actor pool teardown kill failed: %s", e)

    def _shuffle_stream(self, stream: Iterator[RefPair],
                        op: ShuffleOp) -> Iterator[RefPair]:
        """Distributed map-partition -> reduce-partition exchange; the
        single-task AllToAll gather barrier this replaced is gone —
        see `data/shuffle.py` for the fault/memory model."""
        from ray_tpu_torch.data import shuffle as _shuffle

        yield from _shuffle.run_shuffle(self, stream, op)

    def _limit_stream(self, stream: Iterator[RefPair], op: LimitOp) -> Iterator[RefPair]:
        remaining = op.limit
        slice_remote = rt.remote(_slice_task).options(**self._remote_opts)
        # metadata resolves in window-sized batches (bounded lookahead)
        # so the row-count reads ride the pipeline instead of issuing
        # one blocking driver-side get per block
        for block_ref, meta in self._resolved_meta_stream(stream):
            if remaining <= 0:
                break
            n = meta["num_rows"]
            if n <= remaining:
                remaining -= n
                yield block_ref, meta
            else:
                self.stats["tasks"] += 1
                yield tuple(slice_remote.remote(block_ref, remaining))
                remaining = 0

    # -- public --------------------------------------------------------
    def execute(self) -> Iterator[RefPair]:
        ops = self.plan.ops
        if not ops or not isinstance(ops[0], ReadOp):
            raise ValueError(f"plan must start with a ReadOp: {self.plan.describe()}")
        stream: Iterator[RefPair] = self._read_stream(ops[0])
        for op in ops[1:]:
            if isinstance(op, MapOp):
                stream = self._map_stream(stream, op)
            elif isinstance(op, ActorMapOp):
                stream = self._actor_map_stream(stream, op)
            elif isinstance(op, ShuffleOp):
                stream = self._shuffle_stream(stream, op)
            elif isinstance(op, LimitOp):
                stream = self._limit_stream(stream, op)
            else:
                raise TypeError(f"unknown op: {op}")
        return stream

    def execute_to_refs(self) -> List[RefPair]:
        return list(self.execute())
