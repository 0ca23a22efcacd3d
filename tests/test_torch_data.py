"""The port's data library (`ray_tpu_torch.data`) on the CPU: the JAX
package's `tests/test_data.py` on the port's runtime, the pure block
functions (`block.py`, `aggregate.py`, `tfrecord.py`, `avro.py`) held to
the JAX package's output on the same seeded inputs (RT008), and one
pipeline run through both packages.

One module-scoped cluster of the port's runtime serves every case (the
JAX file starts one a test); the parity pipeline also starts the JAX
package's runtime (`rt_start`) beside it.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.data import aggregate as jagg
from ray_tpu.data import avro as javro
from ray_tpu.data import block as JB
from ray_tpu.data import tfrecord as jtfr
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import aggregate as tagg
from ray_tpu_torch.data import avro as tavro
from ray_tpu_torch.data import block as TB
from ray_tpu_torch.data import tfrecord as ttfr
from test_data import _write_avro_manually


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    yield rt
    rt.shutdown()


@pytest.fixture
def idle(cluster):
    """The shared cluster with every CPU free again: an earlier case's
    actors (a map pool, train workers) give theirs back after the kill
    returns."""
    import time

    total = cluster.cluster_resources()["CPU"]
    deadline = time.time() + 30
    while cluster.available_resources().get("CPU", 0) < total:
        assert time.time() < deadline, cluster.available_resources()
        time.sleep(0.05)
    return cluster


# ----------------------------------------------------------------------
# the JAX package's tests/test_data.py, on the port
# ----------------------------------------------------------------------
def test_range_count_take(cluster):
    ds = rd.range(100, parallelism=4)
    assert ds.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    assert ds.num_blocks() == 4


def test_map_filter_fusion(cluster):
    ds = (
        rd.range(50, parallelism=2)
        .map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
        .filter(lambda r: r["id"] % 2 == 0)
    )
    from ray_tpu_torch.data.executor import StreamingExecutor

    ex = StreamingExecutor(ds._plan)
    # maps fuse together AND fold into the read tasks (read fusion)
    assert len(ex.plan.ops) == 1
    rows = ds.take_all()
    assert len(rows) == 25
    assert rows[3] == {"id": 6, "sq": 36}


def test_map_batches_and_flat_map(cluster):
    ds = rd.range(10, parallelism=2).map_batches(
        lambda b: {"id": b["id"], "neg": -b["id"]}, batch_size=3
    )
    assert ds.take(2) == [{"id": 0, "neg": 0}, {"id": 1, "neg": -1}]
    fm = rd.from_items([1, 2]).flat_map(
        lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}]
    )
    assert sorted(r["v"] for r in fm.take_all()) == [1, 2, 10, 20]


def test_limit_streaming(cluster):
    ds = rd.range(1000, parallelism=8).limit(17)
    assert ds.count() == 17
    assert [r["id"] for r in ds.take_all()] == list(range(17))


def test_repartition_shuffle_sort(cluster):
    ds = rd.range(40, parallelism=4).repartition(10)
    assert ds.num_blocks() == 10
    assert ds.count() == 40

    sh = rd.range(30, parallelism=3).random_shuffle(seed=7)
    ids = [r["id"] for r in sh.take_all()]
    assert sorted(ids) == list(range(30))
    assert ids != list(range(30))

    st = sh.sort("id")
    assert [r["id"] for r in st.take_all()] == list(range(30))
    sd = sh.sort("id", descending=True)
    assert [r["id"] for r in sd.take_all()] == list(range(29, -1, -1))


def test_groupby_aggregate(cluster):
    ds = rd.from_items(
        [{"k": i % 3, "v": float(i)} for i in range(12)], parallelism=3
    )
    out = ds.groupby("k").aggregate(rd.Count(), rd.Sum("v"), rd.Mean("v"))
    rows = out.take_all()
    assert len(rows) == 3
    g0 = next(r for r in rows if r["k"] == 0)
    assert g0["count()"] == 4
    assert g0["sum(v)"] == 0 + 3 + 6 + 9
    assert g0["mean(v)"] == pytest.approx(4.5)


def test_global_aggregates(cluster):
    ds = rd.range(10, parallelism=2)
    assert ds.sum("id") == 45
    assert ds.min("id") == 0
    assert ds.max("id") == 9
    assert ds.mean("id") == pytest.approx(4.5)
    assert ds.std("id") == pytest.approx(np.std(np.arange(10), ddof=1))


def test_iter_batches_formats(cluster):
    ds = rd.range(10, parallelism=2)
    batches = list(ds.iter_batches(batch_size=4))
    assert [len(b["id"]) for b in batches] == [4, 4, 2]
    batches = list(ds.iter_batches(batch_size=4, drop_last=True))
    assert [len(b["id"]) for b in batches] == [4, 4]
    df = next(iter(ds.iter_batches(batch_size=5, batch_format="pandas")))
    assert list(df.columns) == ["id"] and len(df) == 5


def test_parquet_csv_json_roundtrip(cluster, tmp_path):
    ds = rd.from_items([{"a": i, "b": f"s{i}"} for i in range(20)],
                       parallelism=2)
    n = ds.write_parquet(str(tmp_path / "pq"))
    assert n == 20
    back = rd.read_parquet(str(tmp_path / "pq"))
    assert back.count() == 20
    assert sorted(r["a"] for r in back.take_all()) == list(range(20))

    ds.write_csv(str(tmp_path / "csv"))
    assert rd.read_csv(str(tmp_path / "csv")).count() == 20
    ds.write_json(str(tmp_path / "js"))
    back = rd.read_json(str(tmp_path / "js"))
    assert back.count() == 20
    assert {r["b"] for r in back.take_all()} == {f"s{i}" for i in range(20)}


def test_from_pandas_numpy_zip_union(cluster):
    import pandas as pd

    df = pd.DataFrame({"x": [1, 2, 3]})
    ds = rd.from_pandas(df)
    assert ds.take_all() == [{"x": 1}, {"x": 2}, {"x": 3}]

    dn = rd.from_numpy(np.arange(6), column="v", parallelism=2)
    assert dn.count() == 6

    z = rd.from_items([{"a": 1}, {"a": 2}]).zip(
        rd.from_items([{"b": 3}, {"b": 4}]))
    assert z.take_all() == [{"a": 1, "b": 3}, {"a": 2, "b": 4}]

    u = rd.from_items([{"a": 1}]).union(rd.from_items([{"a": 2}]))
    assert sorted(r["a"] for r in u.take_all()) == [1, 2]


def test_schema_and_columns(cluster):
    ds = rd.from_items([{"a": 1, "b": 2.0}])
    s = ds.schema()
    assert set(s.keys()) == {"a", "b"}
    assert ds.columns() == ["a", "b"]


def test_materialize_and_split(cluster):
    ds = rd.range(40, parallelism=4).materialize()
    assert ds.count() == 40
    parts = ds.split(2)
    assert sum(p.count() for p in parts) == 40


def test_streaming_split_two_consumers(cluster):
    ds = rd.range(60, parallelism=6)
    it0, it1 = ds.streaming_split(2)

    # epoch 0: consumer 0 may grab any subset; consumer 1 gets the rest
    seen0 = [r["id"] for b in it0.iter_batches(batch_size=None)
             for r in TB.iter_rows(b)]
    seen1 = [r["id"] for b in it1.iter_batches(batch_size=None)
             for r in TB.iter_rows(b)]
    assert sorted(seen0 + seen1) == list(range(60))

    # epoch 1: restartable
    again0 = [r["id"] for b in it0.iter_batches(batch_size=None)
              for r in TB.iter_rows(b)]
    again1 = [r["id"] for b in it1.iter_batches(batch_size=None)
              for r in TB.iter_rows(b)]
    assert sorted(again0 + again1) == list(range(60))


def test_streaming_split_in_train_workers(idle, tmp_path):
    """The Train integration: dataset shards feed `CudaTrainer` workers
    through get_dataset_shard, and both shards together cover the
    dataset exactly once."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (CudaConfig, CudaTrainer, RunConfig,
                                     ScalingConfig)

    ds = rd.range(80, parallelism=4)

    def loop(config):
        import numpy as np

        from ray_tpu_torch.parallel import collectives

        shard = train.get_dataset_shard("train")
        total = 0
        for batch in shard.iter_batches(batch_size=10):
            total += int(batch["id"].sum())
        world_total = collectives.get_group("train").allreduce(
            np.asarray([total], np.int64), op="sum"
        )
        train.report({"world_total": int(world_total[0]), "mine": total})

    result = CudaTrainer(
        loop, cuda_config=CudaConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="data", storage_path=str(tmp_path)),
        datasets={"train": ds},
    ).fit()
    assert result.error is None
    assert result.metrics["world_total"] == sum(range(80))


def test_iter_torch_batches(cluster):
    import torch

    ds = rd.range(100).map(lambda r: {"id": r["id"],
                                      "x": float(r["id"]) * 2})
    seen = 0
    for batch in ds.iter_torch_batches(batch_size=25):
        assert isinstance(batch["id"], torch.Tensor)
        assert batch["x"].shape == (25,)
        seen += batch["id"].shape[0]
    assert seen == 100


def test_random_sample_unique_train_test_split(cluster):
    ds = rd.range(1000, parallelism=4)
    frac = ds.random_sample(0.3, seed=7)
    n = frac.count()
    assert 200 < n < 400  # ~300 expected
    # deterministic under the same seed
    assert ds.random_sample(0.3, seed=7).count() == n

    vals = rd.from_items([1, 2, 2, 3, 3, 3]).unique("item")
    assert sorted(vals) == [1, 2, 3]

    tr, te = rd.range(100).train_test_split(0.2, seed=0)
    assert tr.count() == 80 and te.count() == 20
    all_ids = sorted(
        [r["id"] for r in tr.take_all()] + [r["id"] for r in te.take_all()]
    )
    assert all_ids == list(range(100))


# ----------------------------------------------------------------------
# actor-pool map operator + backpressure + equal split
# ----------------------------------------------------------------------
class _AddTag:
    """Stateful class UDF: each pool actor constructs one instance."""

    def __init__(self, offset=0):
        import os
        import uuid

        self.tag = uuid.uuid4().hex
        self.offset = offset
        self.pid = os.getpid()

    def __call__(self, batch):
        batch["id"] = batch["id"] + self.offset
        batch["tag"] = np.array([self.tag] * len(batch["id"]))
        return batch


def test_map_batches_actor_pool(idle):
    from ray_tpu_torch.data import ActorPoolStrategy

    ds = rd.range(40, parallelism=8).map_batches(
        _AddTag,
        compute=ActorPoolStrategy(size=2),
        fn_constructor_kwargs={"offset": 100},
    )
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == [100 + i for i in range(40)]
    # at most 2 UDF instances did all the work
    assert len({r["tag"] for r in rows}) <= 2


def test_map_batches_actor_pool_autoscales(idle):
    from ray_tpu_torch.data import ActorPoolStrategy

    ds = rd.range(60, parallelism=12).map_batches(
        _AddTag, compute=ActorPoolStrategy(min_size=1, max_size=3)
    )
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(60))
    tags = {r["tag"] for r in rows}
    assert 1 <= len(tags) <= 3


def test_map_batches_class_requires_actor_compute(idle):
    # a class UDF without compute= defaults to an actor pool
    ds = rd.range(8, parallelism=2).map_batches(_AddTag)
    assert sorted(r["id"] for r in ds.take_all()) == list(range(8))


def _touch_marker(d):
    import os
    import time as _t
    import uuid

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, uuid.uuid4().hex), "w") as f:
        f.write(str(_t.time()))


def test_slow_consumer_bounds_producer(cluster, tmp_path):
    """Backpressure: with window=2, a stalled consumer must cap how many
    upstream map tasks ever run."""
    import time

    from ray_tpu_torch.data.context import DataContext

    marker = str(tmp_path / "ran")
    ctx = DataContext.get_current()
    old = ctx.window
    ctx.window = 2
    try:
        def tag(batch, marker=marker):
            _touch_marker(marker)
            return batch

        ds = rd.range(120, parallelism=12).map_batches(tag, batch_size=None)
        it = iter(ds.iter_batches(batch_size=None))
        next(it)  # consume ONE batch, then stall
        time.sleep(1.0)  # give any runaway production time to show
        ran = len(os.listdir(marker))
        # window tasks in flight + the consumed one (+1 slack for the
        # pipelined pull): far below the 12 blocks of an unbounded run
        assert ran <= 6, f"{ran} map tasks ran despite stalled consumer"
        del it
    finally:
        ctx.window = old


def test_streaming_split_equal(cluster):
    ds = rd.range(103, parallelism=5)
    its = ds.streaming_split(4, equal=True)

    counts = []
    ids = []
    for it in its:
        rows = [r["id"] for b in it.iter_batches(batch_size=None)
                for r in TB.iter_rows(b)]
        counts.append(len(rows))
        ids.extend(rows)
    assert len(set(counts)) == 1, f"unequal shard sizes: {counts}"
    assert counts[0] >= 100 // 4  # at most n-1 rows dropped overall
    assert len(ids) == len(set(ids))  # no duplication


# ----------------------------------------------------------------------
# datasources + read->map fusion
# ----------------------------------------------------------------------
def test_read_numpy_npy_and_npz(cluster, tmp_path):
    np.save(tmp_path / "a.npy", np.arange(6))
    np.savez(tmp_path / "b.npz", x=np.ones(3), y=np.zeros(3))
    ds = rd.read_numpy(str(tmp_path / "a.npy"))
    rows = ds.take_all()
    assert [r["data"] for r in rows] == list(range(6))
    ds2 = rd.read_numpy(str(tmp_path / "b.npz"))
    rows2 = ds2.take_all()
    assert len(rows2) == 3 and rows2[0]["x"] == 1.0 and rows2[0]["y"] == 0.0


def test_write_then_read_numpy_roundtrip(cluster, tmp_path):
    out = str(tmp_path / "npy_out")
    n = rd.range(10).map_batches(
        lambda b: {"data": b["id"] * 2}
    ).write_numpy(out)
    assert n == 10
    back = rd.read_numpy(out + "/*.npy")
    vals = sorted(r["data"] for r in back.take_all())
    assert vals == [i * 2 for i in range(10)]


def test_read_binary_files(cluster, tmp_path):
    (tmp_path / "one.bin").write_bytes(b"\x01\x02\x03")
    (tmp_path / "two.bin").write_bytes(b"hello")
    ds = rd.read_binary_files(str(tmp_path) + "/*.bin")
    rows = sorted(ds.take_all(), key=lambda r: r["path"])
    assert rows[0]["bytes"] == b"\x01\x02\x03"
    assert rows[1]["bytes"] == b"hello"
    assert rows[0]["path"].endswith("one.bin")


def test_read_images_resized_stack(cluster, tmp_path):
    from PIL import Image

    for i, color in enumerate([(255, 0, 0), (0, 255, 0)]):
        Image.new("RGB", (8 + i * 4, 6), color).save(tmp_path / f"im{i}.png")
    ds = rd.read_images(str(tmp_path) + "/*.png", size=(16, 16), mode="RGB")
    rows = ds.take_all()
    assert len(rows) == 2
    for r in rows:
        assert r["image"].shape == (16, 16, 3)
        assert r["image"].dtype == np.uint8
    # dominant channels survived the resize
    sums = sorted(tuple(int(r["image"][..., c].sum() > 0) for c in range(3))
                  for r in rows)
    assert sums == [(0, 1, 0), (1, 0, 0)]


def test_read_map_fusion_single_task_per_file(cluster, tmp_path):
    """A leading map folds into the read tasks: one remote task per
    file does read AND transform."""
    for i in range(3):
        np.save(tmp_path / f"p{i}.npy", np.full(4, i))
    ds = rd.read_numpy(str(tmp_path) + "/*.npy").map_batches(
        lambda b: {"data": b["data"] + 100}
    )
    from ray_tpu_torch.data.executor import StreamingExecutor

    ex = StreamingExecutor(ds._plan)
    assert "Read(numpy)->" in ex.plan.describe()
    vals = sorted(r["data"] for r in ds.take_all())
    assert vals[:4] == [100] * 4 and len(vals) == 12


def test_arrow_carrier_for_string_columns(cluster, tmp_path):
    """IO-origin blocks with string columns stay Arrow through
    slice/concat; compute ops and numpy formatting still work."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pa.table({
        "name": ["c", "a", "b", "a"] * 25,
        "x": list(range(100)),
    })
    path = str(tmp_path / "strings.parquet")
    pq.write_table(table, path)

    blk = TB.from_arrow(table)
    assert TB.is_arrow_block(blk)
    assert TB.num_rows(blk) == 100
    sl = TB.slice_block(blk, 10, 30)
    assert TB.is_arrow_block(sl) and TB.num_rows(sl) == 20
    cc = TB.concat([sl, TB.slice_block(blk, 0, 5)])
    assert TB.is_arrow_block(cc) and TB.num_rows(cc) == 25
    # purely-numeric tables take the numpy fast path
    assert not TB.is_arrow_block(TB.from_arrow(pa.table({"x": [1, 2]})))
    out = TB.format_batch(blk, "numpy")
    assert out["x"].dtype.kind == "i"

    ds = rd.read_parquet(path)
    first = ds.sort("name").take(1)[0]
    assert first["name"] == "a"
    counts = {r["name"]: r["count()"]
              for r in ds.groupby("name").count().take_all()}
    assert counts == {"a": 50, "b": 25, "c": 25}
    assert sorted(ds.unique("name")) == ["a", "b", "c"]
    batch = next(iter(ds.iter_batches(batch_size=10,
                                      batch_format="pyarrow")))
    assert isinstance(batch, pa.Table)


# ----------------------------------------------------------------------
# TFRecord / Avro / SQL datasources
# ----------------------------------------------------------------------
def test_tfrecord_roundtrip_e2e(cluster, tmp_path):
    ds = rd.range(50, parallelism=2).map(
        lambda r: {"id": r["id"], "name": f"row{r['id']}".encode(),
                   "score": float(r["id"]) / 2}
    )
    n = ds.write_tfrecords(str(tmp_path / "tfr"))
    assert n == 50
    back = rd.read_tfrecords(str(tmp_path / "tfr"))
    rows = sorted(back.take_all(), key=lambda r: r["id"])
    assert len(rows) == 50
    assert rows[10]["id"] == 10
    assert rows[10]["name"] == b"row10"
    assert rows[10]["score"] == 5.0


def test_tfrecord_raw_records(cluster, tmp_path):
    p = str(tmp_path / "raw.tfrecord")
    ttfr.write_records(p, [b"alpha", b"beta"])
    rows = rd.read_tfrecords(p, parse_example=False).take_all()
    assert [r["data"] for r in rows] == [b"alpha", b"beta"]


@pytest.mark.parametrize("codec", [b"null", b"deflate"])
def test_avro_reader(cluster, tmp_path, codec):
    p = str(tmp_path / "t.avro")
    _write_avro_manually(p, codec)
    rows = rd.read_avro(p).take_all()
    assert len(rows) == 3
    assert rows[0] == {"id": 1, "name": "a", "score": 0.5, "tag": None}
    assert rows[1]["tag"] == "x"
    assert rows[2]["id"] == -3


def test_read_sql(cluster, tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE users (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO users VALUES (?, ?)",
                     [(1, "ann"), (2, "bob")])
    conn.commit()
    conn.close()
    rows = rd.read_sql(
        "SELECT id, name FROM users ORDER BY id",
        lambda: __import__("sqlite3").connect(db),
    ).take_all()
    assert rows == [{"id": 1, "name": "ann"}, {"id": 2, "name": "bob"}]


def test_tfrecord_malformed_example_falls_back_to_raw(cluster, tmp_path):
    """Records that look like an Example prefix but are truncated
    surface as raw bytes, not a crashed read task."""
    p = str(tmp_path / "weird.tfrecord")
    ttfr.write_records(p, [b"\n\x80", b"plain"])
    rows = rd.read_tfrecords(p).take_all()
    assert rows[0]["data"] == b"\n\x80"
    assert rows[1]["data"] == b"plain"


# ----------------------------------------------------------------------
# the pure block functions against the JAX package's, same inputs
# ----------------------------------------------------------------------
def _seeded_block(seed=0, n=37):
    rng = np.random.default_rng(seed)
    return {"i": rng.integers(-50, 50, n).astype(np.int64),
            "f": rng.standard_normal(n).astype(np.float32),
            "t": rng.integers(0, 32000, (n, 5)).astype(np.int32),
            "s": np.asarray([f"w{v}" for v in rng.integers(0, 9, n)])}


def _same(a, b):
    """Equal values of equal types, through dicts, lists and arrays."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


_BLOCK_CASES = {
    "from_rows": lambda B, blk: B.from_rows(
        [{"a": i, "b": float(i) / 3} for i in range(7)]),
    "from_items": lambda B, blk: B.from_items([3, 1, 2]),
    "from_items_dicts": lambda B, blk: B.from_items([{"x": 1}, {"x": 2}]),
    "num_rows": lambda B, blk: B.num_rows(blk),
    "size_bytes": lambda B, blk: B.size_bytes(blk),
    "slice_block": lambda B, blk: B.slice_block(blk, 5, 19),
    "take_indices": lambda B, blk: B.take_indices(
        blk, np.random.default_rng(1).permutation(B.num_rows(blk))[:11]),
    "concat": lambda B, blk: B.concat(
        [B.slice_block(blk, 0, 4), B.slice_block(blk, 30, 37), blk]),
    "iter_rows": lambda B, blk: list(B.iter_rows(B.slice_block(blk, 0, 6))),
    "schema": lambda B, blk: {k: str(v) for k, v in B.schema(blk).items()},
    "column_numpy": lambda B, blk: B.column_numpy(blk, "t"),
    "ensure_numpy": lambda B, blk: B.ensure_numpy(blk),
    "format_batch_numpy": lambda B, blk: B.format_batch(blk, "numpy"),
    "format_batch_pandas": lambda B, blk: B.ensure_numpy(B.from_pandas(
        B.format_batch({k: v for k, v in blk.items() if k != "t"},
                       "pandas"))),
    "arrow_round_trip": lambda B, blk: B.format_batch(
        B.from_arrow(B.to_arrow({k: v for k, v in blk.items() if k != "t"}),
                     keep_arrow=True), "numpy"),
}


@pytest.mark.parametrize("case", sorted(_BLOCK_CASES))
def test_block_functions_match_jax(case):
    fn = _BLOCK_CASES[case]
    _same(fn(TB, _seeded_block()), fn(JB, _seeded_block()))


_AGGS = ("Count", "Sum", "Min", "Max", "Mean", "Std")


@pytest.mark.parametrize("name", _AGGS)
def test_aggregates_match_jax(name):
    """Each aggregate accumulated over seeded blocks in two halves,
    merged and finalized, as the groupby reducer and the global
    aggregates run them."""
    rng = np.random.default_rng(5)
    cols = [rng.standard_normal(n) * 10 for n in (13, 0, 29, 1)]

    def run(mod):
        a = getattr(mod, name)() if name == "Count" else getattr(mod, name)(
            "v")
        halves = []
        for part in (cols[:2], cols[2:]):
            st = a.init()
            for c in part:
                st = a.accumulate_block(st, c)
            halves.append(st)
        return a.name, a.on, a.finalize(a.merge(*halves))

    _same(run(tagg), run(jagg))


def test_tfrecord_encode_decode_match_jax(tmp_path):
    """crc32c, `encode_example`, the record framing and `decode_example`
    give the JAX package's bytes and values on the same seeded rows."""
    rng = np.random.default_rng(11)
    rows = [{"id": int(rng.integers(-2**40, 2**40)),
             "score": float(rng.standard_normal()),
             "vec": rng.standard_normal(4).astype(np.float32),
             "ids": rng.integers(0, 100, 3).astype(np.int64),
             "name": f"row{i}".encode()} for i in range(6)]
    for r in rows:
        enc = ttfr.encode_example(r)
        assert enc == jtfr.encode_example(r)
        assert ttfr.crc32c(enc) == jtfr.crc32c(enc)
        _same(ttfr.decode_example(enc), jtfr.decode_example(enc))
    recs = [ttfr.encode_example(r) for r in rows] + [b"raw", b""]
    ttfr.write_records(str(tmp_path / "t.tfr"), recs)
    jtfr.write_records(str(tmp_path / "j.tfr"), recs)
    assert ((tmp_path / "t.tfr").read_bytes()
            == (tmp_path / "j.tfr").read_bytes())
    assert (list(ttfr.read_records(str(tmp_path / "j.tfr")))
            == list(jtfr.read_records(str(tmp_path / "t.tfr"))) == recs)
    _same(ttfr.read_tfrecords_rows(str(tmp_path / "t.tfr")),
          jtfr.read_tfrecords_rows(str(tmp_path / "t.tfr")))


@pytest.mark.parametrize("codec", [b"null", b"deflate"])
def test_avro_decode_matches_jax(tmp_path, codec):
    p = str(tmp_path / "t.avro")
    _write_avro_manually(p, codec)
    _same(tavro.read_avro_rows(p), javro.read_avro_rows(p))


# ----------------------------------------------------------------------
# one pipeline through both packages
# ----------------------------------------------------------------------
def _write_pipeline_files(d, files=4, rows=48):
    rng = np.random.default_rng(21)
    for f in range(files):
        np.savez(os.path.join(d, f"part{f:02d}.npz"),
                 row_id=np.arange(f * rows, (f + 1) * rows, dtype=np.int64),
                 tokens=rng.integers(0, 1000, (rows, 9)).astype(np.int32),
                 k=rng.integers(0, 6, rows).astype(np.int64))


def _pipeline(rdm, path):
    def fn(b):
        t = np.ascontiguousarray(b["tokens"], dtype=np.int32)
        return {"row_id": b["row_id"], "k": b["k"], "tokens": t,
                "v": t.astype(np.int64).sum(-1)}

    shuffled = rdm.read_numpy(path).map_batches(fn, batch_size=16
                                                ).random_shuffle(seed=1)
    return (shuffled.sort("k").take_all(),
            shuffled.groupby("k").sum("v").take_all())


def test_pipeline_rows_match_jax(cluster, rt_start, tmp_path):
    """`read_numpy` -> `map_batches` -> `random_shuffle(seed=1)` ->
    `sort` and `groupby(...).sum` in both packages: the same rows in the
    same order after the sort (equal keys keep the shuffle's order, so
    the shuffle's permutation is held too), and the same groups."""
    import ray_tpu.data as jrd

    _write_pipeline_files(str(tmp_path))
    path = str(tmp_path / "*.npz")
    got_sorted, got_groups = _pipeline(rd, path)
    want_sorted, want_groups = _pipeline(jrd, path)
    assert len(got_sorted) == 4 * 48
    assert sorted(r["row_id"] for r in got_sorted) == list(range(4 * 48))
    _same(got_sorted, want_sorted)
    _same(got_groups, want_groups)
    assert [r["k"] for r in got_groups] == list(range(6))
