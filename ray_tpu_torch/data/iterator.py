"""DataIterator + streaming split.

Reference: `data/iterator.py` DataIterator and
`Dataset.streaming_split` — N concurrent consumers (Train workers)
each pull blocks from one shared streaming execution.  A coordinator
actor owns the execution generator; shards pull blocks
first-come-first-served, which load-balances uneven consumers (the
reference's output-splitter operator behaves the same way for
equal=False).

Delivery protocol (elastic ingest, ROADMAP item 1): every delivered
block carries a sequence number and stays "outstanding" until the
consumer ACKNOWLEDGES it.  Acks are ROW-EXACT and flushed once per
emitted batch, immediately before the batch is yielded: blocks whose
rows have fully left the rebatcher commit as consumed, and the
straddling block commits a row offset — so a consumer that unwinds
cleanly at a batch boundary (the elastic drain) has exactly its
emitted rows committed for ANY batch_size, and redelivery resumes
MID-block past the committed offset.  When the training mesh
shrinks/re-grows mid-epoch, `reshard(m)` requeues every outstanding
block (at its committed offset) for redelivery, bumps a generation
token that fences stale consumers, and resizes the shard set WITHOUT
restarting the epoch: committed rows are never redelivered and
uncommitted rows are never dropped — exactly-once ingest across the
transition.  A generator failure (e.g. a read task out of retries) is
recorded and re-raised to EVERY shard — unrecoverable loss is a typed
error at each consumer, never a silent partial epoch or a hang.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.data import block as B

logger = logging.getLogger(__name__)


def rebatch(
    blocks: Iterator[B.Block],
    *,
    batch_size: Optional[int],
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator[Any]:
    carry: Optional[B.Block] = None
    for blk in blocks:
        carry = blk if carry is None else B.concat([carry, blk])
        if batch_size is None:
            if B.num_rows(carry):
                yield B.format_batch(carry, batch_format)
            carry = None
            continue
        while carry is not None and B.num_rows(carry) >= batch_size:
            yield B.format_batch(B.slice_block(carry, 0, batch_size), batch_format)
            rest = B.slice_block(carry, batch_size, B.num_rows(carry))
            carry = rest if B.num_rows(rest) else None
    if carry is not None and B.num_rows(carry) and not drop_last:
        yield B.format_batch(carry, batch_format)


def shuffle_buffer(
    blocks: Iterator[B.Block], buffer_size: int, seed: Optional[int] = None
) -> Iterator[B.Block]:
    """Moving-window shuffle: accumulate rows into a buffer; once it
    holds >= buffer_size rows, emit a random half and keep refilling —
    rows mix ACROSS block boundaries up to the buffer size (reference:
    iter_batches local_shuffle_buffer_size semantics)."""
    rng = np.random.default_rng(seed)
    buf: Optional[B.Block] = None
    for blk in blocks:
        buf = blk if buf is None else B.concat([buf, blk])
        n = B.num_rows(buf)
        while n >= buffer_size:
            perm = rng.permutation(n)
            emit = max(1, n - buffer_size // 2)
            yield B.take_indices(buf, perm[:emit])
            buf = B.take_indices(buf, perm[emit:])
            n = B.num_rows(buf)
    if buf is not None and B.num_rows(buf):
        yield B.take_indices(buf, rng.permutation(B.num_rows(buf)))


class _SplitCoordinator:
    """Owns one streaming execution per epoch; shards pull blocks.

    The generator is only replaced once the current one is EXHAUSTED —
    a shard asks for epoch N+1 only after it drained epoch N (got None),
    and None implies exhaustion, so a fast shard looping around can
    never truncate a slow shard's in-progress epoch.  "Exhausted" means
    the generator is done AND the redelivery queue is drained: blocks
    requeued by a reshard are still owed to the epoch.
    """

    def __init__(self, dataset, n: int, equal: bool = False,
                 data_context=None):
        import threading
        from collections import deque as _dq

        if data_context is not None:
            # the driver's DataContext (retry depth, backpressure
            # budgets) governs the execution it coordinates, not the
            # defaults of whatever worker process this actor landed in
            # (reference: DataContext propagation to execution workers)
            from ray_tpu_torch.data import context as _ctx_mod

            _ctx_mod._current_context = data_context
        self._dataset = dataset
        self._n = n
        self._equal = equal
        self._epoch = -1
        self._gen = None
        self._done = True
        self._error: Optional[BaseException] = None
        # SYNC methods + threading primitives: methods run in executor
        # threads (max_concurrency sizes the pool), where blocking
        # rt.get/rt.put are safe — an async coordinator would run on the
        # runtime's io loop and deadlock on them.  ONE reentrant mutex
        # backs both the lock and the condition: epoch rollover mutates
        # several fields, and readers must never observe a half-applied
        # transition (nor can two lock orders deadlock).
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queues = [_dq() for _ in range(n)]  # equal-mode shards
        self._carry = None  # remainder rows carried between blocks
        #: equal-mode backpressure: a shard pulling new blocks waits
        #: while any sibling's queue is this deep (the reference output
        #: splitter blocks when a consumer lags)
        self._max_queued = 16
        # -- exactly-once delivery state --------------------------------
        self._seq = 0  # next delivery sequence number
        #: reshard generation: bumped on every reshard; pulls/acks from
        #: iterators of an older generation are fenced (stale consumers
        #: stop cleanly instead of racing the new shard set)
        self._gen_id = 0
        #: seq -> [pair, base_offset, rows_consumed]: delivered but not
        #: fully acknowledged.  base_offset is how many rows of the
        #: underlying block were consumed BEFORE this delivery (a
        #: redelivered block resumes mid-block); rows_consumed advances
        #: with partial acks as the consumer emits batches.  Requeued on
        #: reshard at (base_offset + rows_consumed).
        self._outstanding: Dict[int, list] = {}
        #: (orig_seq, pair, offset) owed to the CURRENT epoch after a
        #: reshard; orig_seq lets a late in-flight ack retract an entry
        #: before it is redelivered
        self._redeliver = _dq()

    # -- lifecycle -----------------------------------------------------
    def attach(self):
        """State snapshot for late-joining consumers (elastic re-form):
        (current_epoch, in_progress, generation).  `in_progress` counts
        undelivered redelivery/queue debt: a generator that exhausted
        with blocks still owed is NOT a finished epoch."""
        with self._lock:
            in_progress = (
                not self._done
                or bool(self._redeliver)
                or any(self._queues)
            )
            return self._epoch, in_progress, self._gen_id

    def reshard(self, n: int):
        """Re-shard the in-progress epoch to `n` consumers (mesh
        shrink/re-grow).  Delivered-but-unacked blocks — in flight to
        consumers that may be dead — are requeued for redelivery;
        acked blocks are gone for good; queued equal-mode sub-blocks
        are folded back into the redelivery pool.  The epoch itself is
        NOT restarted."""
        from collections import deque as _dq

        with self._cond:
            self._gen_id += 1  # fence pulls/acks from prior consumers
            requeued = 0
            for seq in sorted(self._outstanding):
                pair, base, used = self._outstanding[seq]
                self._redeliver.append((seq, pair, base, used))
                requeued += 1
            self._outstanding.clear()
            for q in self._queues:
                while q:
                    self._redeliver.append((-1, q.popleft(), 0, 0))
                    requeued += 1
            self._n = n
            self._queues = [_dq() for _ in range(n)]
            self._cond.notify_all()
            logger.info(
                "split coordinator resharded to %d shards "
                "(requeued %d in-flight blocks, epoch %d, gen %d)",
                n, requeued, self._epoch, self._gen_id,
            )
            return {"epoch": self._epoch, "requeued": requeued,
                    "gen": self._gen_id}

    def ack(self, shard: int, epoch: int, gen: int, full_seqs,
            partial=None) -> bool:
        """Consumption commit, flushed once per emitted batch:
        `full_seqs` blocks are fully consumed (never redelivered);
        `partial` is (seq, rows) — the straddling block's consumed-row
        offset, so redelivery after a loss resumes MID-block and the
        exactly-once ledger is row-exact for any batch_size.  An ack
        from a pre-reshard generation retracts the matching entries
        from the redelivery queue when they have not been handed out
        yet (the in-flight-ack race closes in the consumer's favor)."""
        with self._cond:
            if epoch != self._epoch:
                return True
            if gen == self._gen_id or gen is None:
                for seq in full_seqs:
                    self._outstanding.pop(seq, None)
                if partial is not None:
                    ent = self._outstanding.get(partial[0])
                    if ent is not None:
                        ent[2] = max(ent[2], int(partial[1]))
            else:
                # partial[1] is relative to the DELIVERED view (rows
                # past the entry's base offset) — compose with base,
                # never clobber it, or a twice-resharded block loses
                # its first redelivery's committed rows
                retract = set(full_seqs)
                keep = type(self._redeliver)()
                for oseq, pair, base, used in self._redeliver:
                    if oseq in retract:
                        continue
                    if partial is not None and oseq == partial[0]:
                        used = max(used, int(partial[1]))
                    keep.append((oseq, pair, base, used))
                self._redeliver = keep
            self._cond.notify_all()
        return True

    def start_epoch(self, shard: int, epoch: int) -> bool:
        with self._cond:
            if epoch <= self._epoch:
                return True
            # wait for exhaustion (only reachable if a caller skips
            # ahead without draining; normal iterators never wait here)
            self._cond.wait_for(
                lambda: self._done
                and not self._redeliver
                and all(not q for q in self._queues)
            )
            if epoch > self._epoch:
                self._epoch = epoch
                self._gen = self._dataset._pairs()
                self._done = False
                self._error = None
                self._queues = [type(self._queues[0])() for _ in range(self._n)]
                self._carry = None
                # epoch rollover: delivered-but-unacked debt from the
                # PREVIOUS epoch is void (that epoch's consumers are
                # gone; the new epoch redelivers everything anyway)
                self._outstanding.clear()
                self._redeliver.clear()
        return True

    def _next_upstream(self):
        """One (pair, offset) from the redelivery pool or the generator
        (callers hold the lock).  Raises the recorded generator error,
        marks done on exhaustion (returns None)."""
        if self._redeliver:
            _oseq, pair, base, used = self._redeliver.popleft()
            return pair, base + used
        if self._error is not None:
            raise self._error
        if self._done:
            return None
        try:
            return next(self._gen), 0
        except StopIteration:
            self._mark_done()
            return None
        except Exception as e:
            # an unrecoverable upstream loss (task out of retries,
            # lineage gone): record it so EVERY shard surfaces the
            # same typed error instead of a silent partial epoch
            self._error = e
            self._mark_done()
            raise

    def _deliver(self, pair, offset=0):
        """Stamp a delivery sequence number and track it until acked."""
        seq = self._seq
        self._seq += 1
        self._outstanding[seq] = [pair, offset, 0]
        return (seq, pair, offset)

    def next_block(self, shard: int, epoch: int, gen: int = None):
        if epoch != self._epoch:
            return None
        if not self._equal:
            with self._lock:
                # re-check under the lock: a shard parked here across
                # an epoch rollover must not pull from the NEW epoch's
                # generator for its stale epoch-N call; a pre-reshard
                # iterator (stale generation) sees a clean end instead
                # of racing the new shard set for the generator
                if epoch != self._epoch or (
                    gen is not None and gen != self._gen_id
                ):
                    return None
                item = self._next_upstream()
                if item is None:
                    return None
                return self._deliver(*item)
        # equal=True: every shard receives exactly the same row count
        # (reference: the output splitter's equal mode).  Each upstream
        # block (plus carried remainder) splits into n equal sub-blocks
        # pushed one per shard queue; remainder rows carry into the next
        # block and only the final < n rows are dropped at exhaustion.
        import ray_tpu_torch as rt

        with self._lock:
            if epoch != self._epoch or (
                gen is not None and gen != self._gen_id
            ):  # rolled over / resharded while parked at the lock
                return None
            while not self._queues[shard]:
                if self._error is not None:
                    # surface the recorded upstream failure to EVERY
                    # shard, not just the one that tripped it
                    raise self._error
                if self._done and not self._redeliver:
                    return None
                # soft backpressure: while a lagging sibling's queue is
                # deep, this shard pauses driving the upstream generator
                # — but boundedly, so a shard whose consumer drains the
                # split sequentially (no concurrent siblings) still
                # progresses instead of deadlocking
                waited = 0.0
                while (
                    any(len(q) >= self._max_queued for q in self._queues)
                    and waited < 5.0
                    and not self._done
                ):
                    self._cond.wait(timeout=0.5)
                    waited += 0.5
                    if epoch != self._epoch or (
                        gen is not None and gen != self._gen_id
                    ):  # rolled over / resharded while parked
                        return None
                if self._done and not self._redeliver:
                    continue  # loop re-checks queue/done/error
                item = self._next_upstream()
                if item is None:
                    continue
                (block_ref, _meta), up_off = item
                try:
                    blk = rt.get(block_ref)
                    if up_off:
                        # redelivered block: resume past committed rows
                        blk = B.slice_block(blk, up_off, B.num_rows(blk))
                    if self._carry is not None:
                        blk = B.concat([self._carry, blk])
                        self._carry = None
                    rows = B.num_rows(blk)
                    per = rows // self._n
                    if per == 0:
                        self._carry = blk
                        continue
                    for i in range(self._n):
                        piece = B.slice_block(blk, i * per, (i + 1) * per)
                        meta = {
                            "num_rows": per,
                            "size_bytes": B.size_bytes(piece),
                        }
                        self._queues[i].append((rt.put(piece), meta))
                    rem = rows - per * self._n
                    if rem:
                        self._carry = B.slice_block(blk, rows - rem, rows)
                except Exception as e:
                    # a block value this split could not fetch/split
                    # (reconstruction exhausted, store loss): record it
                    # so every OTHER shard raises too instead of ending
                    # a silently short epoch
                    self._error = e
                    self._mark_done()
                    raise
            out = self._deliver(self._queues[shard].popleft())
            # wake backpressured pullers and epoch-restart waiters (the
            # condition shares this lock, so this is race-free here)
            self._cond.notify_all()
            return out

    def _mark_done(self):
        with self._cond:
            self._done = True
            self._cond.notify_all()


def _batch_rows(batch) -> int:
    """Row count of a formatted batch (numpy dict / arrow / pandas)."""
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return len(batch)
    except ImportError:
        pass
    return B.num_rows(batch)


class DataIterator:
    """Per-shard handle (reference: `data/iterator.py` DataIterator)."""

    def __init__(self, coordinator, index: int, world: int,
                 start_epoch: int = 0, gen: int = 0):
        self._coord = coordinator
        self._index = index
        self._world = world
        self._gen = gen  # reshard generation this iterator belongs to
        # first iter_batches() call runs `start_epoch`: an iterator
        # attached to an in-progress epoch (elastic re-form) CONTINUES
        # it instead of truncating/restarting it
        self._epoch = start_epoch - 1

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        **_kwargs,
    ) -> Iterator[Any]:
        import ray_tpu_torch as rt

        self._epoch += 1
        epoch = self._epoch
        gen = self._gen
        rt.get(self._coord.start_epoch.remote(self._index, epoch))

        # Row-exact consumption ledger: pulled blocks queue here until
        # their rows have been EMITTED as batches; one ack RPC flushes
        # per batch, committing fully-emitted blocks plus the
        # straddling block's row offset.  The flush runs BEFORE each
        # yield, so a consumer that unwinds cleanly at a batch
        # boundary (the elastic drain: report() raises at the step
        # barrier) has exactly its emitted rows committed — rebatch's
        # carry rows stay uncommitted and are redelivered, mid-block
        # if necessary.  A consumer SIGKILLed between flush and
        # processing loses at most the one in-flight batch.
        pulled: List[list] = []  # [seq, rows] in delivery order
        acked_rows = 0
        emitted = 0

        def blocks() -> Iterator[B.Block]:
            while True:
                item = rt.get(self._coord.next_block.remote(
                    self._index, epoch, gen
                ))
                if item is None:
                    return
                seq, (block_ref, _meta), off = item
                blk = rt.get(block_ref)
                n = B.num_rows(blk)
                if off:
                    # redelivered block: resume past its committed rows
                    blk = B.slice_block(blk, off, n)
                    n -= off
                if n <= 0:
                    rt.get(self._coord.ack.remote(
                        self._index, epoch, gen, [seq], None
                    ))
                    continue
                pulled.append([seq, n])
                yield blk

        def flush():
            nonlocal acked_rows
            full = []
            while pulled and acked_rows + pulled[0][1] <= emitted:
                seq, n = pulled.pop(0)
                acked_rows += n
                full.append(seq)
            partial = None
            if pulled and emitted > acked_rows:
                partial = (pulled[0][0], emitted - acked_rows)
            if full or partial:
                rt.get(self._coord.ack.remote(
                    self._index, epoch, gen, full, partial
                ))

        for batch in rebatch(
            blocks(),
            batch_size=batch_size,
            batch_format=batch_format,
            drop_last=drop_last,
        ):
            emitted += _batch_rows(batch)
            flush()
            yield batch

    def iter_rows(self) -> Iterator[Dict]:
        for batch in self.iter_batches(batch_size=None):
            yield from B.iter_rows(batch)

    def iter_cuda_batches(self, *, batch_size: int = 256, sharding=None,
                          dtype=None, drop_last: bool = True,
                          device=None) -> Iterator[Any]:
        """This shard's batches as tensors on the card (`cuda_batches`;
        the JAX package's `iter_jax_batches`)."""
        return cuda_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            sharding=sharding, dtype=dtype, device=device)


# the dtypes `jnp.asarray` gives with 64-bit types off, as the JAX
# package runs: its batches keep those dtypes here
_X32 = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
        np.dtype(np.float64): np.float32,
        np.dtype(np.complex128): np.complex64}


def cuda_batches(batches: Iterator[Dict[str, np.ndarray]], *, sharding=None,
                 dtype=None, device=None) -> Iterator[Any]:
    """Numpy batches as dicts of tensors on `resolve_device(device)`,
    one a column: the feed path of `iter_jax_batches`, with its dtypes
    (64-bit columns become 32-bit), `dtype=` a torch dtype every column
    is cast to from its own, and `sharding=` a `(DeviceMesh, placements)` pair each
    tensor is `distribute_tensor`-ed over (the mesh's device unless
    `device` is given; every rank passes the same global batch, as the
    reference's one controller does).  The device resolves here, so a
    call without a card raises at once.  Each column is copied off the
    block (an object-store array may be a read-only view of shared
    memory), then moved by a synchronous `.to(device)`."""
    import torch

    from ray_tpu_torch import resolve_device

    if sharding is not None and device is None:
        device = sharding[0].device_type
    device = resolve_device(device)
    if sharding is not None:
        from ray_tpu_torch.parallel.mesh import dtensor

        distribute = dtensor().distribute_tensor

    def gen():
        for batch in batches:
            out = {}
            for k, v in batch.items():
                v = np.asarray(v)
                t = torch.from_numpy(np.array(
                    v, dtype=v.dtype if dtype else _X32.get(v.dtype, v.dtype)))
                t = t.to(device=device, dtype=dtype)
                if sharding is not None:
                    t = distribute(t, sharding[0], list(sharding[1]))
                out[k] = t
            yield out

    return gen()

def make_streaming_split(dataset, n: int, *, equal: bool = False,
                         elastic: bool = False) -> List[DataIterator]:
    import ray_tpu_torch as rt

    if elastic:
        cached = getattr(dataset, "_split_coord", None)
        if cached is not None:
            coord, c_equal = cached
            if c_equal == equal:
                try:
                    state = rt.get(coord.reshard.remote(n))
                    epoch, in_progress, gen = rt.get(coord.attach.remote())
                    start = epoch if in_progress else epoch + 1
                    return [DataIterator(coord, i, n, start_epoch=start,
                                         gen=state["gen"])
                            for i in range(n)]
                except Exception as e:
                    # coordinator actor died (its host was lost): fall
                    # through to a fresh one — the epoch restarts, which
                    # is the best recoverable outcome without its state
                    logger.warning(
                        "elastic split coordinator unreachable (%s); "
                        "starting a fresh one", e,
                    )
            dataset._split_coord = None

    from ray_tpu_torch.data.context import DataContext

    coord = rt.remote(_SplitCoordinator).options(
        num_cpus=0, max_concurrency=max(4, 2 * n + 1)
    ).remote(dataset, n, equal, DataContext.get_current())
    if elastic:
        dataset._split_coord = (coord, equal)
    return [DataIterator(coord, i, n) for i in range(n)]
