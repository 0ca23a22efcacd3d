"""The port's distributed shuffle and elastic split protocol on the CPU:
the JAX package's `tests/test_data_shuffle.py` on the port's runtime,
and the shuffle's partition and reduce functions (`data/shuffle.py`)
held to the JAX package's on the same seeded blocks (RT008).

One module-scoped cluster of the port's runtime serves every case.  Its
object store is the JAX file's over-memory one (12 MB): the 2x-store
sort must spill to complete, and the other cases' datasets are a few KB.
"""

import glob
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu.data import aggregate as jagg
from ray_tpu.data import block as JB
from ray_tpu.data import shuffle as jsh
from ray_tpu_torch.data import aggregate as tagg
from ray_tpu_torch.data import block as TB
from ray_tpu_torch.data import shuffle as tsh
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.exceptions import BackPressureError


@pytest.fixture(scope="module")
def cluster():
    # 12 MB store; the 2x-store case's dataset is ~24 MB — that exchange
    # can only complete if blocks spill to disk and restore on demand
    rt.init(num_workers=2, num_cpus=4,
            object_store_memory=12 * 1024 * 1024,
            ignore_reinit_error=True)
    yield rt
    rt.shutdown()


def test_repartition_preserves_order_exactly(cluster):
    ds = rd.range(101, parallelism=7).repartition(3)
    assert ds.num_blocks() == 3
    assert [r["id"] for r in ds.take_all()] == list(range(101))
    # more target blocks than rows: empty partitions are still blocks
    tiny = rd.range(3, parallelism=2).repartition(8)
    assert tiny.num_blocks() == 8
    assert tiny.count() == 3


def test_unseeded_shuffle_is_plan_deterministic(cluster):
    """seed=None bakes a concrete seed at plan time: re-executing the
    same plan (what lineage reconstruction does for a lost block) yields
    identical output."""
    ds = rd.range(200, parallelism=4).random_shuffle()
    first = [r["id"] for r in ds.take_all()]
    second = [r["id"] for r in ds.take_all()]
    assert first == second
    assert sorted(first) == list(range(200))


def test_sort_string_keys_and_duplicates(cluster):
    words = ["pear", "apple", "fig", "apple", "date", "fig", "cherry",
             "banana", "apple", "kiwi", "lime", "mango"]
    ds = rd.from_items([{"w": w, "i": i} for i, w in enumerate(words)],
                       parallelism=4)
    out = [r["w"] for r in ds.sort("w").take_all()]
    assert out == sorted(words)
    desc = [r["w"] for r in ds.sort("w", descending=True).take_all()]
    assert desc == sorted(words, reverse=True)


def test_groupby_is_complete_and_globally_ordered(cluster):
    ds = rd.from_items(
        [{"k": i % 7, "v": float(i)} for i in range(140)], parallelism=5
    )
    rows = ds.groupby("k").aggregate(rd.Count(), rd.Sum("v")).take_all()
    # every key exactly once, globally ordered by key
    assert [r["k"] for r in rows] == list(range(7))
    for r in rows:
        assert r["count()"] == 20
        assert r["sum(v)"] == sum(v for v in range(140) if v % 7 == r["k"])


def test_shuffle_backpressure_typed_error(cluster):
    """A shuffle whose map admission can make no progress within
    backpressure_timeout_s raises a typed BackPressureError."""
    from ray_tpu_torch.data.dataset import Dataset
    from ray_tpu_torch.data.plan import ShuffleOp

    ctx = DataContext.get_current()
    old = (ctx.window, ctx.backpressure_timeout_s)
    ctx.window, ctx.backpressure_timeout_s = 1, 0.3
    try:
        def stalled_map(blk, i, P, aux):
            time.sleep(15)
            return [blk] * P

        base = rd.range(40, parallelism=4)
        stalled = Dataset(base._plan.with_op(ShuffleOp(
            map_fn=stalled_map,
            reduce_fn=lambda pieces, r, aux: pieces[0],
            name="Shuffle(stalled)",
        )))
        with pytest.raises(BackPressureError) as ei:
            stalled.take_all()
        assert ei.value.retry_after_s > 0
    finally:
        ctx.window, ctx.backpressure_timeout_s = old


def test_repartition_sort_2x_store_budget_spills_and_completes(cluster):
    import ray_tpu_torch.api as api

    n = 3_000_000  # int64 ids -> ~24 MB, 2x the 12 MB store
    ds = rd.range(n, parallelism=12).repartition(8).sort(
        "id", descending=True
    )
    total = 0
    prev = None
    checksum = 0
    for batch in ds.iter_batches(batch_size=200_000):
        ids = batch["id"]
        total += len(ids)
        checksum += int(ids.sum())
        assert np.all(np.diff(ids) <= 0), "not globally descending"
        if prev is not None:
            assert ids[0] <= prev, "partition boundary out of order"
        prev = int(ids[-1])
    # exact row accounting across the over-memory exchange
    assert total == n
    assert checksum == n * (n - 1) // 2
    sd = api._session.get("session_dir")
    spilled = glob.glob(f"{sd}/spilled/*.bin")
    assert spilled, (
        "a 2x-store shuffle completed without spilling: the store "
        "budget was not exceeded and this proved nothing"
    )


# ----------------------------------------------------------------------
# elastic split protocol
# ----------------------------------------------------------------------
def test_split_reshard_redelivers_unacked_never_replays_acked(cluster):
    ds = rd.range(40, parallelism=4)
    its = ds.streaming_split(2, elastic=True)
    coord = its[0]._coord

    # consume (and therefore ack) one block on shard 0
    gen = its[0].iter_batches(batch_size=None)
    acked = next(gen)["id"].tolist()
    # deliver one block to shard 1 but never ack it (the consumer "dies")
    rt.get(coord.start_epoch.remote(1, 0))
    item = rt.get(coord.next_block.remote(1, 0))
    seq, (ref, _meta), off = item
    assert off == 0
    unacked = rt.get(ref)["id"].tolist()

    # mesh shrinks 2 -> 1: reshard requeues the unacked block only
    survivors = ds.streaming_split(1, elastic=True)
    got = []
    for batch in survivors[0].iter_batches(batch_size=None):
        got.extend(batch["id"].tolist())
    assert sorted(got + acked) == list(range(40)), (
        "rows lost or duplicated across the reshard"
    )
    assert set(unacked) <= set(got), "unacked block was not redelivered"
    assert not (set(acked) & set(got)), "acked block was replayed"


def test_split_reshard_row_exact_across_batch_boundaries(cluster):
    """Acks are row-exact for batch sizes that straddle blocks: after a
    partial consumption a reshard resumes mid-block."""
    ds = rd.range(100, parallelism=10)  # 10-row blocks
    its = ds.streaming_split(1, elastic=True)
    gen = its[0].iter_batches(batch_size=24)  # 2.4 blocks per batch
    consumed = []
    consumed.extend(next(gen)["id"].tolist())
    consumed.extend(next(gen)["id"].tolist())
    assert len(consumed) == 48  # 4 full blocks + 8 rows of the 5th

    # consumer set is replaced mid-epoch; the epoch continues
    regrown = ds.streaming_split(2, elastic=True)
    for it in regrown:
        for batch in it.iter_batches(batch_size=7):
            consumed.extend(batch["id"].tolist())
    assert sorted(consumed) == list(range(100)), (
        "rows lost or duplicated across a mid-block reshard"
    )


def test_split_elastic_regrow_continues_epoch(cluster):
    """Re-growing 1 -> 3 mid-epoch also continues the same epoch with no
    loss or duplication."""
    ds = rd.range(60, parallelism=6)
    one = ds.streaming_split(1, elastic=True)
    gen = one[0].iter_batches(batch_size=None)
    consumed = next(gen)["id"].tolist()  # partial consumption

    grown = ds.streaming_split(3, elastic=True)
    got = list(consumed)
    for it in grown:
        for batch in it.iter_batches(batch_size=None):
            got.extend(batch["id"].tolist())
    assert sorted(got) == list(range(60))

    # the next epoch starts clean at full width
    second = []
    for it in grown:
        for batch in it.iter_batches(batch_size=None):
            second.extend(batch["id"].tolist())
    assert sorted(second) == list(range(60))


def test_split_generator_failure_is_typed_not_a_hang(cluster):
    """An unrecoverable upstream failure (a UDF that raises) surfaces as
    a typed error at every consumer, never a silent partial epoch."""

    def boom(batch):
        raise RuntimeError("poisoned block")

    ds = rd.range(40, parallelism=4).map_batches(boom)
    it0, it1 = ds.streaming_split(2)
    with pytest.raises(Exception, match="poisoned block"):
        list(it0.iter_batches(batch_size=None))
    with pytest.raises(Exception, match="poisoned block"):
        list(it1.iter_batches(batch_size=None))

    eq0, eq1 = ds.streaming_split(2, equal=True)
    with pytest.raises(Exception, match="poisoned block"):
        list(eq0.iter_batches(batch_size=None))
    with pytest.raises(Exception, match="poisoned block"):
        list(eq1.iter_batches(batch_size=None))


# ----------------------------------------------------------------------
# the shuffle's partition and reduce functions against the JAX package's
# ----------------------------------------------------------------------
P = 5


def _blocks(seed=0):
    """Four seeded blocks of 11-40 rows: int keys with duplicates, a
    float column, a token matrix, and a string key."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (11, 40, 23, 17):
        out.append({"k": rng.integers(0, 9, n).astype(np.int64),
                    "v": rng.standard_normal(n),
                    "t": rng.integers(0, 32000, (n, 3)).astype(np.int32),
                    "w": np.asarray([f"s{x}" for x in
                                     rng.integers(0, 6, n)])})
    return out


def _run_op(op, B):
    """The op's sample -> aux -> map -> reduce, in one process, over the
    seeded blocks: what `run_shuffle` schedules as tasks."""
    blocks = _blocks()
    metas = [{"num_rows": B.num_rows(b)} for b in blocks]
    n_out = op.num_partitions or len(blocks)
    samples = ([op.sample_fn(b) for b in blocks] if op.sample_fn else [])
    aux = op.aux_fn(samples, metas, n_out) if op.aux_fn else None
    parts = [op.map_fn(b, i, n_out, aux) for i, b in enumerate(blocks)]
    return aux, [op.reduce_fn([p[r] for p in parts], r, aux)
                 for r in range(n_out)]


def _same_blocks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = TB.ensure_numpy(x), JB.ensure_numpy(y)
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


_OPS = {
    "repartition": lambda m, agg: m.repartition_op(P),
    "random_shuffle": lambda m, agg: m.random_shuffle_op(1),
    "sort": lambda m, agg: m.sort_op("k"),
    "sort_desc": lambda m, agg: m.sort_op("k", descending=True),
    "sort_strings": lambda m, agg: m.sort_op("w", sample_rows=4),
    "groupby_aggregate": lambda m, agg: m.groupby_aggregate_op(
        "k", (agg.Count(), agg.Sum("v"), agg.Std("v"))),
    "map_groups": lambda m, agg: m.map_groups_op(
        "w", lambda g: {"w": g["w"][:1], "n": np.asarray([len(g["w"])])}),
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_shuffle_functions_match_jax(name):
    """Each shuffle op's sample, aux (offsets or range boundaries), map
    (partitions) and reduce functions give the JAX package's blocks."""
    got_aux, got = _run_op(_OPS[name](tsh, tagg), TB)
    want_aux, want = _run_op(_OPS[name](jsh, jagg), JB)
    if isinstance(want_aux, np.ndarray):
        np.testing.assert_array_equal(got_aux, want_aux)
    else:
        assert got_aux == want_aux
    _same_blocks(got, want)


def test_range_partition_matches_jax():
    """`_range_boundaries` over seeded samples and `_range_partition`
    of a block by them, ascending and descending."""
    blk = _blocks(3)[1]
    samples = [b["k"] for b in _blocks(4)]
    tb, jb = (tsh._range_boundaries(samples, P),
              jsh._range_boundaries(samples, P))
    np.testing.assert_array_equal(tb, jb)
    for desc in (False, True):
        _same_blocks(tsh._range_partition(blk, P, tb, "k", descending=desc),
                     jsh._range_partition(blk, P, jb, "k", descending=desc))
