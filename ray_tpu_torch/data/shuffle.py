"""Distributed push-based shuffle for the streaming executor.

Reference: `data/_internal/planner/exchange/` — the map-partition ->
reduce-partition exchange behind repartition/random_shuffle/sort/
groupby.  The old executor ran every all-to-all as ONE remote task
that gathered the whole dataset (an OOM barrier and a single point of
failure); here each input block is partitioned by its own map task
into P pieces returned as separate objects, and each of the P reduce
tasks merges one partition — so:

- **failure isolation**: map/reduce tasks carry
  `DataContext.data_task_max_retries`, so a SIGKILLed worker retries
  through the core worker-died path; a lost piece re-derives via
  lineage reconstruction, and a lost reducer re-pulls only its own
  partition;
- **memory**: no task ever holds more than one block (map) or one
  partition (reduce); the full exchange lives in the object store,
  which spills past the high watermark — a shuffle of a dataset
  larger than the store completes (`tests/test_spilling.py` plane);
- **backpressure**: map admission is count- AND byte-bounded; when an
  admission point can make no progress within
  `backpressure_timeout_s` it raises a typed
  :class:`~ray_tpu_torch.exceptions.BackPressureError` instead of queueing
  unboundedly or hanging.

Every map/reduce closure built here is DETERMINISTIC (seeds are baked
at plan time) — lineage reconstruction re-runs them to rebuild lost
blocks mid-stream, and a nondeterministic re-run would silently
drop/duplicate rows across the recovery boundary.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data import block as B
from ray_tpu_torch.exceptions import BackPressureError
from ray_tpu_torch.metrics import metric_defs as _mdefs
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# remote task bodies
# ----------------------------------------------------------------------
def _sample_task(sample_fn, blk: B.Block):
    return sample_fn(blk)


def _shuffle_map_task(map_fn, block_index: int, num_partitions: int, aux,
                      blk: B.Block):
    """One input block -> P partition pieces + a small accounting meta.
    Returned as P+1 separate objects so each piece is an independently
    lineage-reconstructable unit."""
    pieces = map_fn(blk, block_index, num_partitions, aux)
    assert len(pieces) == num_partitions, (
        f"map_fn returned {len(pieces)} pieces for {num_partitions} "
        "partitions"
    )
    meta = {
        "rows": [B.num_rows(p) for p in pieces],
        "bytes": [B.size_bytes(p) for p in pieces],
    }
    return (*pieces, meta)


def _shuffle_reduce_task(reduce_fn, partition_index: int, aux, *pieces):
    out = reduce_fn(list(pieces), partition_index, aux)
    return out, {"num_rows": B.num_rows(out), "size_bytes": B.size_bytes(out)}


# ----------------------------------------------------------------------
# the exchange driver (called by StreamingExecutor._shuffle_stream)
# ----------------------------------------------------------------------
def run_shuffle(executor, stream: Iterator[Tuple[Any, Any]], op
                ) -> Iterator[Tuple[Any, Any]]:
    """Drive one ShuffleOp: drain the upstream stream (refs only — the
    upstream stages keep their own windows; payloads never touch the
    driver), optionally sample, then map-partition and reduce with
    bounded in-flight work.  Yields (block_ref, meta_ref) pairs in
    partition order as reducers are admitted, so a slow downstream
    consumer paces reduce submission."""
    import ray_tpu_torch as rt

    ctx_window = executor.window
    max_bytes = executor.max_stage_bytes
    ctx = executor.ctx
    retries = ctx.data_task_max_retries
    bp_timeout = ctx.backpressure_timeout_s

    # 1. collect input refs (drives the upstream pipeline; a metadata
    # barrier over refs, never a data barrier on the driver)
    pairs = list(stream)
    if not pairs:
        return
    metas = executor.resolve_metas([m for _, m in pairs])
    n_in = len(pairs)
    P = op.num_partitions or ctx.shuffle_partitions
    if not P:
        # memory-adaptive partition count: size partitions so one
        # in-flight reducer (pinned pieces + merged output, the 2x
        # below) fits in HALF the stage budget — leaving the other
        # half for the downstream consumer's pinned batches.  This is
        # what lets a shuffle of a dataset far larger than the object
        # store stream through it (reference: target-block-size
        # splitting in the exchange planner).
        total_bytes = sum(int(m.get("size_bytes", 0)) for m in metas)
        P = max(n_in, -(-4 * total_bytes // max(1, max_bytes)))
        P = min(P, 4096, max(1, sum(
            int(m.get("num_rows", 0)) for m in metas
        )))

    # 2. optional sample pass (sort/groupby range boundaries): small
    # per-block samples gathered on the driver — the only values a
    # shuffle ever pulls locally
    samples: Optional[List[Any]] = None
    if op.sample_fn is not None:
        sample_remote = rt.remote(_sample_task).options(
            num_cpus=executor.task_num_cpus, max_retries=retries
        )
        sample_refs = []
        for ref, _ in pairs:
            sample_refs.append(sample_remote.remote(op.sample_fn, ref))
            executor.stats["tasks"] += 1
        samples = rt.get(sample_refs)
    aux = op.aux_fn(samples, metas, P) if op.aux_fn is not None else None

    # umbrella span for the whole exchange: every map/reduce/sample
    # task submitted below nests under it, so the map→reduce lineage of
    # one shuffle shares ONE trace id in the collected timeline.
    # Explicit (not a `with` block): this function is a generator, and
    # a context manager across yields would leak the ambient trace
    # context into the consumer (see util/tracing.py).
    ex_span = _tracing.start_span(op.name, kind="SHUFFLE")
    ex_ctx = _tracing.ctx_of(ex_span)

    # 3. map phase: count- and byte-bounded admission.  The byte cost
    # of a running map task is ~2x its input (pinned input + created
    # pieces); pinned bytes can neither spill nor evict, so the sum of
    # in-flight costs must stay under the store-aware stage budget or
    # an over-memory shuffle wedges every create.
    # completion ref -> (est task bytes, admit instant, phase)
    outstanding: Dict[Any, tuple] = {}
    inflight_bytes = 0

    def _drain_one(where: str) -> None:
        """Reap at least one completed task or raise the typed
        backpressure error (bounded queue, never a hang)."""
        nonlocal inflight_bytes
        done, _ = rt.wait(
            list(outstanding), num_returns=1, timeout=bp_timeout,
        )
        if not done:
            phase = where.split()[0]
            _mdefs.inc("rt_shuffle_backpressure_total",
                       tags={"phase": phase})
            _tracing.record_instant(
                f"backpressure:{op.name}", ex_ctx, kind="BACKPRESSURE",
                where=where,
            )
            raise BackPressureError(
                f"shuffle {where} made no progress for "
                f"{bp_timeout:.0f}s at {len(outstanding)} in-flight "
                f"tasks / {inflight_bytes} bytes "
                f"(stage budget {max_bytes} bytes)",
                retry_after_s=bp_timeout,
            )
        now = time.monotonic()
        for m in done:
            cost, t_admit, phase = outstanding.pop(m)
            inflight_bytes -= cost
            _mdefs.observe("rt_shuffle_partition_seconds", now - t_admit,
                           tags={"phase": phase})

    def _admit(cost: int, where: str) -> None:
        while len(outstanding) >= ctx_window or (
            outstanding and inflight_bytes + cost > max_bytes
        ):
            _drain_one(where)

    map_remote = rt.remote(_shuffle_map_task).options(
        num_cpus=executor.task_num_cpus,
        num_returns=P + 1,
        max_retries=retries,
    )
    map_outs: List[Optional[List[Any]]] = [None] * n_in
    map_meta_refs: List[Any] = []
    rows_in = 0
    try:
        for i, (ref, _) in enumerate(pairs):
            cost = 2 * int(metas[i].get("size_bytes", 0))
            rows_in += int(metas[i].get("num_rows", 0))
            _admit(cost, "map admission")
            with _tracing.use_context(ex_ctx):
                rets = map_remote.remote(op.map_fn, i, P, aux, ref)
            executor.stats["tasks"] += 1
            map_outs[i] = list(rets[:P])
            map_meta_refs.append(rets[P])
            outstanding[rets[P]] = (cost, time.monotonic(), "map")
            inflight_bytes += cost
        while outstanding:
            _drain_one("map drain")
        _mdefs.inc("rt_shuffle_rows_total", float(rows_in))

        # per-partition sizes from the map metas (one batched get):
        # exact row accounting + byte-accounted reduce admission
        map_metas = rt.get(map_meta_refs)
        part_rows = [0] * P
        part_bytes = [0] * P
        for m in map_metas:
            for r in range(P):
                part_rows[r] += int(m["rows"][r])
                part_bytes[r] += int(m["bytes"][r])
        executor.stats.setdefault("shuffle", []).append(
            {"op": op.name, "inputs": n_in, "partitions": P,
             "rows_in": rows_in, "rows_mapped": sum(part_rows)}
        )

        # 4. reduce phase: byte-accounted bounded in-flight partitions,
        # streamed downstream in partition order as they are admitted
        red_remote = rt.remote(_shuffle_reduce_task).options(
            num_cpus=executor.task_num_cpus,
            num_returns=2,
            max_retries=retries,
        )
        for r in range(P):
            cost = 2 * part_bytes[r]  # pinned pieces + merged output
            _admit(cost, f"reduce admission (partition {r})")
            pieces = [map_outs[i][r] for i in range(n_in)]
            with _tracing.use_context(ex_ctx):
                block_ref, meta_ref = red_remote.remote(
                    op.reduce_fn, r, aux, *pieces
                )
            executor.stats["tasks"] += 1
            outstanding[meta_ref] = (cost, time.monotonic(), "reduce")
            inflight_bytes += cost
            for i in range(n_in):  # release pieces as they are consumed
                map_outs[i][r] = None
            yield block_ref, meta_ref
    finally:
        # runs at exhaustion AND at abandonment (generator close), so
        # the umbrella span always lands in the trace with its real
        # duration
        _tracing.finish_span(ex_span)


# ----------------------------------------------------------------------
# op factories (used by Dataset)
# ----------------------------------------------------------------------
def _bake_seed(seed: Optional[int]) -> int:
    """A concrete seed even for seed=None: map/reduce closures must be
    deterministic so lineage reconstruction re-derives identical
    blocks — an unseeded rng re-run after a worker loss would
    silently drop/duplicate rows across the recovery boundary."""
    if seed is not None:
        return int(seed)
    return int(np.random.SeedSequence().entropy) % (2**31)


def repartition_op(num_blocks: int):
    """Exact contiguous repartition: aux carries global row offsets
    (from input metadata), each map task slices its rows into the
    global target ranges, reducers concat pieces in block order — so
    row order is preserved end to end."""
    from ray_tpu_torch.data.plan import ShuffleOp

    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")

    def aux_fn(_samples, metas, P):
        rows = [int(m.get("num_rows", 0)) for m in metas]
        offsets = np.concatenate([[0], np.cumsum(rows)])
        bounds = np.linspace(0, int(offsets[-1]), P + 1, dtype=np.int64)
        return {"offsets": offsets.tolist(), "bounds": bounds.tolist()}

    def map_fn(blk, i, P, aux):
        start = aux["offsets"][i]
        n = B.num_rows(blk)
        bounds = np.asarray(aux["bounds"], dtype=np.int64)
        cut = np.clip(bounds - start, 0, n)
        return [B.slice_block(blk, int(cut[r]), int(cut[r + 1]))
                for r in range(P)]

    def reduce_fn(pieces, _r, _aux):
        return B.concat(pieces)

    return ShuffleOp(
        map_fn=map_fn, reduce_fn=reduce_fn, num_partitions=num_blocks,
        aux_fn=aux_fn, name=f"Shuffle(repartition[{num_blocks}])",
    )


def random_shuffle_op(seed: Optional[int]):
    """Seeded two-level shuffle: map scatters each row to a uniform
    partition, reduce permutes within its partition.  Streams are
    derived from (seed, role, index) so re-derivation after a loss is
    bit-identical."""
    from ray_tpu_torch.data.plan import ShuffleOp

    baked = _bake_seed(seed)

    def map_fn(blk, i, P, _aux):
        rng = np.random.default_rng((baked, 0x5EED, i))
        assign = rng.integers(0, P, B.num_rows(blk))
        return [B.take_indices(blk, np.nonzero(assign == r)[0])
                for r in range(P)]

    def reduce_fn(pieces, r, _aux):
        full = B.concat(pieces)
        rng = np.random.default_rng((baked, 0xD00D, r))
        return B.take_indices(full, rng.permutation(B.num_rows(full)))

    return ShuffleOp(
        map_fn=map_fn, reduce_fn=reduce_fn,
        name="Shuffle(random_shuffle)",
    )


def _key_sample_fn(key: str, sample_rows: int):
    def sample(blk):
        keys = np.asarray(B.column_numpy(blk, key))
        n = len(keys)
        if n <= sample_rows:
            return keys
        idx = np.linspace(0, n - 1, sample_rows).astype(np.int64)
        return keys[idx]

    return sample


def _range_boundaries(samples: List[Any], P: int) -> np.ndarray:
    """P-1 boundary keys from the per-block samples: equal-count
    quantiles of the pooled (sorted) sample."""
    pool = np.sort(np.concatenate([np.asarray(s) for s in samples]))
    if P <= 1 or len(pool) == 0:
        return pool[:0]
    idx = [min(len(pool) - 1, (len(pool) * r) // P) for r in range(1, P)]
    return pool[idx]


def _range_partition(blk, P: int, boundaries: np.ndarray, key: str,
                     descending: bool = False) -> List[B.Block]:
    keys = np.asarray(B.column_numpy(blk, key))
    part = np.searchsorted(boundaries, keys, side="right")
    if descending:
        part = (P - 1) - part
    return [B.take_indices(blk, np.nonzero(part == r)[0]) for r in range(P)]


def sort_op(key: str, descending: bool = False, *, sample_rows: int = 64):
    """Range-partitioned sort: sample -> boundaries -> partition ->
    per-partition stable sort.  Partition order IS global order."""
    from ray_tpu_torch.data.plan import ShuffleOp

    def aux_fn(samples, _metas, P):
        return _range_boundaries(samples, P)

    def map_fn(blk, _i, P, aux):
        return _range_partition(blk, P, aux, key, descending=descending)

    def reduce_fn(pieces, _r, _aux):
        full = B.concat(pieces)
        if not B.num_rows(full):
            return full
        order = np.argsort(np.asarray(B.column_numpy(full, key)),
                           kind="stable")
        if descending:
            order = order[::-1]
        return B.take_indices(full, order)

    return ShuffleOp(
        map_fn=map_fn, reduce_fn=reduce_fn,
        sample_fn=_key_sample_fn(key, sample_rows), aux_fn=aux_fn,
        name=f"Shuffle(sort[{key}{' desc' if descending else ''}])",
    )


def groupby_aggregate_op(key: str, aggs: tuple, *, sample_rows: int = 64):
    """Range-partitioned groupby: equal keys land in exactly one
    partition (searchsorted is deterministic per key value), each
    reducer aggregates its complete groups and emits rows in key
    order — globally ordered output like the sort."""
    from ray_tpu_torch.data.plan import ShuffleOp

    def aux_fn(samples, _metas, P):
        return _range_boundaries(samples, P)

    def map_fn(blk, _i, P, aux):
        return _range_partition(blk, P, aux, key)

    def reduce_fn(pieces, _r, _aux):
        groups: Dict[Any, List[Any]] = {}
        for blk in pieces:
            if not B.num_rows(blk):
                continue
            keys = np.asarray(B.column_numpy(blk, key))
            for g in np.unique(keys):
                idx = np.nonzero(keys == g)[0]
                sub = B.ensure_numpy(B.take_indices(blk, idx))
                gk = g.item() if hasattr(g, "item") else g
                st = groups.setdefault(gk, [a.init() for a in aggs])
                for ai, a in enumerate(aggs):
                    col = sub[a.on] if a.on else np.empty(B.num_rows(sub))
                    st[ai] = a.accumulate_block(st[ai], col)
        rows = []
        for gk in sorted(groups):
            row = {key: gk}
            for a, s in zip(aggs, groups[gk]):
                row[a.name] = a.finalize(s)
            rows.append(row)
        return B.from_rows(rows)

    return ShuffleOp(
        map_fn=map_fn, reduce_fn=reduce_fn,
        sample_fn=_key_sample_fn(key, sample_rows), aux_fn=aux_fn,
        name=f"Shuffle(groupby[{key}])",
    )


def map_groups_op(key: str, fn: Callable[[B.Block], Any], *,
                  sample_rows: int = 64):
    from ray_tpu_torch.data.plan import ShuffleOp

    def aux_fn(samples, _metas, P):
        return _range_boundaries(samples, P)

    def map_fn(blk, _i, P, aux):
        return _range_partition(blk, P, aux, key)

    def reduce_fn(pieces, _r, _aux):
        from ray_tpu_torch.data.dataset import _coerce_batch

        full = B.concat(pieces)
        if not B.num_rows(full):
            return full
        keys = np.asarray(B.column_numpy(full, key))
        out: List[B.Block] = []
        for g in np.unique(keys):
            sub = B.ensure_numpy(
                B.take_indices(full, np.nonzero(keys == g)[0])
            )
            out.append(_coerce_batch(fn(sub)))
        return B.concat(out)

    return ShuffleOp(
        map_fn=map_fn, reduce_fn=reduce_fn,
        sample_fn=_key_sample_fn(key, sample_rows), aux_fn=aux_fn,
        name=f"Shuffle(map_groups[{key}])",
    )
