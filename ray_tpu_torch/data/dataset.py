"""Dataset: lazy, streaming, distributed datasets.

Reference surface: `python/ray/data/dataset.py` (`Dataset`) — the same
transform/consume contract, executed by `ray_tpu_torch.data.executor`'s
streaming pipeline over this framework's tasks + object plane.
Port addition: `iter_cuda_batches` (the JAX package's
`iter_jax_batches`) moves batches onto the card, with an optional
`(DeviceMesh, placements)` sharding so a data-parallel mesh consumes
host data without an extra hop.
"""

from __future__ import annotations

import builtins
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from ray_tpu_torch.data import aggregate as agg_mod
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data import datasource as ds_mod
from ray_tpu_torch.data.executor import StreamingExecutor
from ray_tpu_torch.data.plan import LimitOp, LogicalPlan, MapOp, ReadOp

DEFAULT_PARALLELISM = 8


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan
        self._cached_pairs: Optional[List] = None  # materialized (ref, meta)
        # cached elastic split coordinator: (actor_handle, equal) — set
        # by streaming_split(elastic=True) so ingest reshards with the
        # training mesh instead of restarting the epoch
        self._split_coord = None

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _with_op(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def _pairs(self) -> Iterator:
        if self._cached_pairs is not None:
            return iter(self._cached_pairs)
        return StreamingExecutor(self._plan).execute()

    def _iter_blocks(self) -> Iterator[B.Block]:
        import ray_tpu_torch as rt

        for block_ref, _ in self._pairs():
            yield rt.get(block_ref)

    # ------------------------------------------------------------------
    # transforms (lazy)
    # ------------------------------------------------------------------
    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            return [B.from_rows([fn(r) for r in B.iter_rows(blk)])]

        return self._with_op(MapOp(op, name="Map(map)"))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute=None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[Dict] = None,
        **_kwargs,
    ) -> "Dataset":
        if compute is not None or isinstance(fn, type):
            from ray_tpu_torch.data.context import ActorPoolStrategy
            from ray_tpu_torch.data.plan import ActorMapOp

            if compute == "actors" or compute is None:
                compute = ActorPoolStrategy()
            if not isinstance(compute, ActorPoolStrategy):
                raise TypeError(
                    "compute= must be 'actors' or an ActorPoolStrategy"
                )
            if not isinstance(fn, type):
                raise TypeError(
                    "actor compute needs a class UDF (constructed once "
                    "per pool actor, called per batch)"
                )
            return self._with_op(ActorMapOp(
                cls=fn,
                args=tuple(fn_constructor_args),
                kwargs=dict(fn_constructor_kwargs or {}),
                batch_size=batch_size,
                batch_format=batch_format,
                strategy=compute,
                name=f"ActorMap({fn.__name__})",
            ))

        def op(blk: B.Block) -> List[B.Block]:
            out: List[B.Block] = []
            n = B.num_rows(blk)
            size = batch_size or n or 1
            for s in builtins.range(0, max(n, 1), size):
                piece = B.slice_block(blk, s, min(s + size, n))
                res = fn(B.format_batch(piece, batch_format))
                out.append(_coerce_batch(res))
            return out

        return self._with_op(MapOp(op, name="Map(map_batches)"))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            rows: List[Dict] = []
            for r in B.iter_rows(blk):
                rows.extend(fn(r))
            return [B.from_rows(rows)]

        return self._with_op(MapOp(op, name="Map(flat_map)"))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            mask = np.fromiter(
                (bool(fn(r)) for r in B.iter_rows(blk)),
                dtype=bool,
                count=B.num_rows(blk),
            )
            return [B.take_indices(blk, np.nonzero(mask)[0])]

        return self._with_op(MapOp(op, name="Map(filter)"))

    def add_column(self, name: str, fn: Callable[[B.Block], np.ndarray]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            blk = B.ensure_numpy(blk)
            out = dict(blk)
            out[name] = np.asarray(fn(blk))
            return [out]

        return self._with_op(MapOp(op, name="Map(add_column)"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            if B.is_arrow_block(blk):
                return [blk.drop_columns([c for c in cols
                                          if c in blk.column_names])]
            return [{k: v for k, v in blk.items() if k not in cols}]

        return self._with_op(MapOp(op, name="Map(drop_columns)"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            if B.is_arrow_block(blk):
                return [blk.select(cols)]
            return [{k: blk[k] for k in cols}]

        return self._with_op(MapOp(op, name="Map(select_columns)"))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def op(blk: B.Block) -> List[B.Block]:
            if B.is_arrow_block(blk):
                return [blk.rename_columns(
                    [mapping.get(c, c) for c in blk.column_names])]
            return [{mapping.get(k, k): v for k, v in blk.items()}]

        return self._with_op(MapOp(op, name="Map(rename_columns)"))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(LimitOp(n))

    def random_sample(self, fraction: float, *,
                      seed: Optional[int] = None) -> "Dataset":
        """Keep each row independently with probability `fraction`
        (reference: `Dataset.random_sample`)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        # per-block streams: with a fixed seed, derive the block's
        # stream from (seed, first-row content) so the same data always
        # samples identically while distinct blocks stay decorrelated
        import zlib

        def op(blk: B.Block) -> List[B.Block]:
            n = B.num_rows(blk)
            if seed is None:
                rng = np.random.default_rng()
            else:
                first = next(B.iter_rows(blk), None)
                h = zlib.crc32(repr((n, first)).encode())
                rng = np.random.default_rng((seed, h))
            keep = np.nonzero(rng.random(n) < fraction)[0]
            return [B.take_indices(blk, keep)]

        return self._with_op(MapOp(op, name=f"RandomSample({fraction})"))

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (reference: `Dataset.unique`)."""
        seen = []
        seen_set = set()
        for blk in self._iter_blocks():
            for v in np.asarray(B.column_numpy(blk, column)).tolist():
                k = v if not isinstance(v, list) else tuple(v)
                if k not in seen_set:
                    seen_set.add(k)
                    seen.append(v)
        return seen

    def train_test_split(self, test_size: float, *, shuffle: bool = True,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        """Split into (train, test) datasets (reference:
        `Dataset.train_test_split`)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        import ray_tpu_torch as rt

        ds = (self.random_shuffle(seed=seed) if shuffle else self
              ).materialize()
        pairs = ds._cached_pairs
        n = builtins.sum(int(m["num_rows"]) for _, m in pairs)
        n_test = max(1, int(n * test_size))
        n_train = n - n_test
        # split at the row boundary WITHOUT pulling blocks to the
        # driver: whole blocks keep their refs; only the boundary block
        # is sliced, remotely
        train_pairs, test_pairs = [], []
        cum = 0
        for ref, meta in pairs:
            rows = int(meta["num_rows"])
            if cum + rows <= n_train:
                train_pairs.append((ref, meta))
            elif cum >= n_train:
                test_pairs.append((ref, meta))
            else:
                k = n_train - cum
                left_ref, right_ref = rt.remote(_split_block).options(
                    num_returns=2, num_cpus=1
                ).remote(ref, k)
                train_pairs.append(
                    (left_ref, {"num_rows": k,
                                "size_bytes": meta.get("size_bytes", 0)})
                )
                test_pairs.append(
                    (right_ref, {"num_rows": rows - k,
                                 "size_bytes": meta.get("size_bytes", 0)})
                )
            cum += rows
        train = Dataset(LogicalPlan([ReadOp([], name="TrainSplit")]))
        test = Dataset(LogicalPlan([ReadOp([], name="TestSplit")]))
        train._cached_pairs = train_pairs
        test._cached_pairs = test_pairs
        return train, test

    # ---- all-to-all (distributed shuffle, `data/shuffle.py`) ---------
    def repartition(self, num_blocks: int) -> "Dataset":
        from ray_tpu_torch.data.shuffle import repartition_op

        return self._with_op(repartition_op(num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        from ray_tpu_torch.data.shuffle import random_shuffle_op

        return self._with_op(random_shuffle_op(seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.shuffle import sort_op

        return self._with_op(sort_op(
            key, descending,
            sample_rows=DataContext.get_current().shuffle_sample_rows,
        ))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        # pure metadata concat: block refs stay where they are
        pairs = list(self.materialize()._cached_pairs)
        for o in others:
            pairs.extend(o.materialize()._cached_pairs)
        out = Dataset(LogicalPlan([ReadOp([], name="Union")]))
        out._cached_pairs = pairs
        return out

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-concatenate two datasets row-aligned.  Runs as one
        remote task over block REFS — payloads never touch the driver."""
        import ray_tpu_torch as rt

        left = [p[0] for p in self.materialize()._cached_pairs]
        right = [p[0] for p in other.materialize()._cached_pairs]
        zip_remote = rt.remote(_zip_task).options(num_cpus=1)
        pairs = rt.get(zip_remote.remote(len(left), *left, *right))
        out = Dataset(LogicalPlan([ReadOp([], name="Zip")]))
        out._cached_pairs = pairs
        return out

    # ------------------------------------------------------------------
    # consumption
    # ------------------------------------------------------------------
    def iter_rows(self) -> Iterator[Dict]:
        for blk in self._iter_blocks():
            yield from B.iter_rows(blk)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import rebatch, shuffle_buffer

        blocks = self._iter_blocks()
        if local_shuffle_buffer_size:
            blocks = shuffle_buffer(
                blocks, local_shuffle_buffer_size, local_shuffle_seed
            )
        yield from rebatch(
            blocks,
            batch_size=batch_size,
            batch_format=batch_format,
            drop_last=drop_last,
        )

    def iter_cuda_batches(
        self,
        *,
        batch_size: int = 256,
        sharding=None,
        dtype=None,
        drop_last: bool = True,
        device=None,
    ) -> Iterator[Any]:
        """Batches as tensors on the card (the JAX package's TPU feed
        path, `iter_jax_batches`); see `iterator.cuda_batches`."""
        from ray_tpu_torch.data.iterator import cuda_batches

        return cuda_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            sharding=sharding, dtype=dtype, device=device)

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        dtypes=None,
        drop_last: bool = False,
    ) -> Iterator[Any]:
        """Batches as torch tensors (reference:
        `data/iterator.py` iter_torch_batches); dtypes maps column ->
        torch dtype."""
        import torch

        for batch in self.iter_batches(batch_size=batch_size, drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                t = torch.as_tensor(np.ascontiguousarray(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t
            yield out

    def take(self, n: int = 20) -> List[Dict]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Dict]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        from ray_tpu_torch.data.executor import resolve_metas

        # one batched metadata get, not one blocking get per block
        return builtins.sum(
            m["num_rows"]
            for m in resolve_metas([meta for _, meta in self._pairs()])
        )

    def schema(self) -> Optional[Dict[str, np.dtype]]:
        for blk in self._iter_blocks():
            s = B.schema(blk)
            if s:
                return s
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.keys()) if s else []

    def num_blocks(self) -> int:
        return sum(1 for _ in self._pairs())

    def size_bytes(self) -> int:
        from ray_tpu_torch.data.executor import resolve_metas

        return builtins.sum(
            m.get("size_bytes", 0)
            for m in resolve_metas([meta for _, meta in self._pairs()])
        )

    def to_pandas(self):
        return B.to_pandas(B.concat(list(self._iter_blocks())))

    def materialize(self) -> "Dataset":
        """Execute now; the result holds block refs (reference:
        `Dataset.materialize` -> MaterializedDataset)."""
        from ray_tpu_torch.data.executor import resolve_pairs

        out = Dataset(LogicalPlan([ReadOp([], name="Materialized")]))
        out._cached_pairs = resolve_pairs(list(self._pairs()))
        return out

    def stats(self) -> str:
        ex = StreamingExecutor(self._plan)
        return f"plan: {ex.plan.describe()}"

    # ---- splits -------------------------------------------------------
    def split(self, n: int) -> List["Dataset"]:
        import ray_tpu_torch as rt

        pairs = self.materialize()._cached_pairs
        out = []
        for i in builtins.range(n):
            d = Dataset(LogicalPlan([ReadOp([], name="Split")]))
            d._cached_pairs = pairs[i::n]
            out.append(d)
        return out

    def streaming_split(self, n: int, *, equal: bool = False,
                        elastic: bool = False) -> List["DataIterator"]:
        """N concurrent consumers over ONE shared streaming execution.

        With ``elastic=True`` the split coordinator is cached on this
        dataset and survives consumer re-formation: a later
        ``streaming_split(m, elastic=True)`` RESHARDS the in-progress
        epoch to ``m`` consumers instead of restarting it — delivered-
        but-unacknowledged blocks are requeued, acknowledged blocks are
        never redelivered, so every block is consumed exactly once
        across a mesh shrink/re-grow (the elastic-training ingest
        path, `train/backend_executor.py`)."""
        from ray_tpu_torch.data.iterator import make_streaming_split

        return make_streaming_split(self, n, equal=equal, elastic=elastic)

    # ---- writes -------------------------------------------------------
    def _write(self, write_factory, path: str) -> int:
        results = self._with_op(
            MapOp(write_factory(path), name="Map(write)")
        ).take_all()
        return builtins.sum(int(r["num_rows"]) for r in results)

    def write_parquet(self, path: str) -> int:
        return self._write(ds_mod.write_parquet_block, path)

    def write_csv(self, path: str) -> int:
        return self._write(ds_mod.write_csv_block, path)

    def write_json(self, path: str) -> int:
        return self._write(ds_mod.write_json_block, path)

    def write_numpy(self, path: str, column: str = "data") -> int:
        return self._write(
            lambda p: ds_mod.write_numpy_block(p, column), path
        )

    def write_tfrecords(self, path: str) -> int:
        return self._write(ds_mod.write_tfrecords_block, path)

    # ---- global aggregates -------------------------------------------
    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Dict[str, Any]:
        states = [a.init() for a in aggs]
        for blk in self._iter_blocks():
            n = B.num_rows(blk)
            for i, a in enumerate(aggs):
                col = blk[a.on] if a.on else np.empty(n)
                states[i] = a.accumulate_block(states[i], col)
        return {a.name: a.finalize(s) for a, s in zip(aggs, states)}

    def sum(self, on: str):
        return self.aggregate(agg_mod.Sum(on))[f"sum({on})"]

    def min(self, on: str):
        return self.aggregate(agg_mod.Min(on))[f"min({on})"]

    def max(self, on: str):
        return self.aggregate(agg_mod.Max(on))[f"max({on})"]

    def mean(self, on: str):
        return self.aggregate(agg_mod.Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof))[f"std({on})"]

    def __repr__(self):
        return f"Dataset(plan={self._plan.describe()})"


class GroupedData:
    """Reference: `data/grouped_data.py` — partial per-block aggregation
    merged in an all-to-all reduce."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Dataset:
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.shuffle import groupby_aggregate_op

        return self._ds._with_op(groupby_aggregate_op(
            self._key, tuple(aggs),
            sample_rows=DataContext.get_current().shuffle_sample_rows,
        ))

    def count(self) -> Dataset:
        return self.aggregate(agg_mod.Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Sum(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Mean(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Max(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        return self.aggregate(agg_mod.Std(on, ddof))

    def map_groups(self, fn: Callable[[B.Block], Any]) -> Dataset:
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data.shuffle import map_groups_op

        return self._ds._with_op(map_groups_op(
            self._key, fn,
            sample_rows=DataContext.get_current().shuffle_sample_rows,
        ))


def _zip_task(n_left: int, *blocks):
    """Remote: zip left/right block lists; returns (ref, meta) pairs."""
    import ray_tpu_torch as rt

    left = B.ensure_numpy(B.concat(list(blocks[:n_left])))
    right = B.ensure_numpy(B.concat(list(blocks[n_left:])))
    if B.num_rows(left) != B.num_rows(right):
        raise ValueError("zip requires equal row counts")
    merged = dict(left)
    for k, v in right.items():
        merged[k if k not in merged else f"{k}_1"] = v
    ref = rt.put(merged)
    return [(ref, {"num_rows": B.num_rows(merged), "size_bytes": B.size_bytes(merged)})]


def _split_block(blk: B.Block, k: int):
    """Remote boundary-block split for train_test_split."""
    return B.slice_block(blk, 0, k), B.slice_block(blk, k, B.num_rows(blk))


def _coerce_batch(res) -> B.Block:
    if isinstance(res, dict):
        return {k: np.asarray(v) for k, v in res.items()}
    try:
        import pandas as pd

        if isinstance(res, pd.DataFrame):
            return B.from_pandas(res)
    except ImportError:
        pass
    try:
        import pyarrow as pa

        if isinstance(res, pa.Table):
            return B.from_arrow(res)
    except ImportError:
        pass
    raise TypeError(
        f"map_batches fn must return dict/DataFrame/Table, got {type(res)}"
    )


# ---------------------------------------------------------------------
# read API (reference: `ray.data.read_*` / `from_*` in data/read_api.py)
# ---------------------------------------------------------------------
def _read_ds(tasks, name) -> Dataset:
    from ray_tpu_torch.util.usage_stats import record_library_usage

    record_library_usage("data")
    return Dataset(LogicalPlan([ReadOp(tasks, name=name)]))


def range(n: int, *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:  # noqa: A001
    return _read_ds(ds_mod.range_tasks(n, parallelism), f"Read(range[{n}])")


def from_items(items: List[Any], *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return _read_ds(ds_mod.items_tasks(list(items), parallelism), "Read(items)")


def from_blocks(blocks: List[B.Block]) -> Dataset:
    return _read_ds(ds_mod.blocks_tasks(blocks), "Read(blocks)")


def from_numpy(arr: np.ndarray, column: str = "data",
               *, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    chunks = np.array_split(arr, max(1, min(parallelism, len(arr))))
    return from_blocks([{column: c} for c in chunks if len(c)])


def from_pandas(df) -> Dataset:
    return from_blocks([B.from_pandas(df)])


def from_arrow(table) -> Dataset:
    return from_blocks([B.from_arrow(table)])


def read_parquet(paths) -> Dataset:
    return _read_ds(ds_mod.parquet_tasks(paths), "Read(parquet)")


def read_csv(paths, **kwargs) -> Dataset:
    return _read_ds(ds_mod.csv_tasks(paths, **kwargs), "Read(csv)")


def read_json(paths) -> Dataset:
    return _read_ds(ds_mod.json_tasks(paths), "Read(json)")


def read_text(paths) -> Dataset:
    return _read_ds(ds_mod.text_tasks(paths), "Read(text)")


def read_numpy(paths) -> Dataset:
    return _read_ds(ds_mod.numpy_tasks(paths), "Read(numpy)")


def read_binary_files(paths, include_paths: bool = True) -> Dataset:
    return _read_ds(
        ds_mod.binary_tasks(paths, include_paths=include_paths),
        "Read(binary)",
    )


def read_images(paths, size=None, mode=None,
                include_paths: bool = False) -> Dataset:
    return _read_ds(
        ds_mod.images_tasks(paths, size=size, mode=mode,
                            include_paths=include_paths),
        "Read(images)",
    )


def read_tfrecords(paths, *, parse_example: bool = True,
                   verify: bool = True) -> Dataset:
    return _read_ds(
        ds_mod.tfrecord_tasks(paths, parse_example=parse_example,
                              verify=verify),
        "Read(tfrecords)",
    )


def read_avro(paths) -> Dataset:
    return _read_ds(ds_mod.avro_tasks(paths), "Read(avro)")


def read_sql(sql: str, connection_factory) -> Dataset:
    return _read_ds(ds_mod.sql_tasks(sql, connection_factory), "Read(sql)")
