"""Datasources: read-task factories and write helpers.

Reference: `data/datasource/` + `_internal/datasource/` (parquet/csv/
json/numpy/range datasources).  A datasource here is simply a list of
zero-arg callables, each producing blocks — the executor turns each
into one remote read task (the reference's ReadTask contract).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import block as B


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")
            ))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched: {paths}")
    return out


def range_tasks(n: int, parallelism: int) -> List[Callable[[], List[B.Block]]]:
    parallelism = max(1, min(parallelism, n) if n else 1)
    bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)

    def make(lo: int, hi: int):
        return lambda: [{"id": np.arange(lo, hi, dtype=np.int64)}]

    return [make(int(bounds[i]), int(bounds[i + 1])) for i in range(parallelism)]


def items_tasks(items: List[Any], parallelism: int) -> List[Callable[[], List[B.Block]]]:
    n = len(items)
    parallelism = max(1, min(parallelism, n) if n else 1)
    bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)

    def make(chunk: List[Any]):
        return lambda: [B.from_items(chunk)]

    return [
        make(items[int(bounds[i]): int(bounds[i + 1])])
        for i in range(parallelism)
    ]


def blocks_tasks(blocks: List[B.Block]) -> List[Callable[[], List[B.Block]]]:
    def make(b: B.Block):
        return lambda: [b]

    return [make(b) for b in blocks]


def parquet_tasks(paths) -> List[Callable[[], List[B.Block]]]:
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            import pyarrow.parquet as pq

            return [B.from_arrow(pq.read_table(f))]

        return read

    return [make(f) for f in files]


def csv_tasks(paths, **read_kwargs) -> List[Callable[[], List[B.Block]]]:
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            import pyarrow.csv as pacsv

            return [B.from_arrow(pacsv.read_csv(f, **read_kwargs))]

        return read

    return [make(f) for f in files]


def json_tasks(paths) -> List[Callable[[], List[B.Block]]]:
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            import json

            with open(f) as fh:
                first = fh.read(1)
                fh.seek(0)
                if first == "[":
                    rows = json.load(fh)
                else:  # JSONL
                    rows = [json.loads(line) for line in fh if line.strip()]
            return [B.from_rows(rows)]

        return read

    return [make(f) for f in files]


def text_tasks(paths) -> List[Callable[[], List[B.Block]]]:
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            with open(f) as fh:
                lines = [ln.rstrip("\n") for ln in fh]
            return [{"text": np.asarray(lines, dtype=np.str_)}]

        return read

    return [make(f) for f in files]


def numpy_tasks(paths) -> List[Callable[[], List[B.Block]]]:
    """.npy (one `data` column) and .npz (one column per array) files
    (reference: `_internal/datasource/numpy_datasource.py`)."""
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            if f.endswith(".npz"):
                with np.load(f) as z:
                    return [{k: z[k] for k in z.files}]
            return [{"data": np.load(f)}]

        return read

    return [make(f) for f in files]


def binary_tasks(paths, include_paths: bool = True) -> List[Callable[[], List[B.Block]]]:
    """Raw file bytes, one row per file (reference:
    `_internal/datasource/binary_datasource.py`).  Bytes land in an
    object-dtype column (ragged payloads)."""
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            with open(f, "rb") as fh:
                data = fh.read()
            blk: B.Block = {
                "bytes": np.asarray([data], dtype=object),
            }
            if include_paths:
                blk["path"] = np.asarray([f])
            return [blk]

        return read

    return [make(f) for f in files]


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp")


def images_tasks(paths, size: Optional[tuple] = None,
                 mode: Optional[str] = None,
                 include_paths: bool = False) -> List[Callable[[], List[B.Block]]]:
    """Decoded images as HWC uint8 arrays — the TPU-training input
    format (reference: `_internal/datasource/image_datasource.py`,
    which also decodes eagerly into numpy).  `size=(h, w)` resizes so
    rows stack into one dense `image` tensor; without it, mixed
    dimensions fall back to an object column."""
    # directories filter to image extensions (a labels.csv next to the
    # images must not poison the read); explicitly named files pass
    # through untouched
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.lower().endswith(_IMAGE_EXTS)
            ))
        else:
            files.extend(
                f for f in _expand_paths(p)
                if f.lower().endswith(_IMAGE_EXTS) or f == p
            )
    if not files:
        raise FileNotFoundError(f"no image files matched: {paths}")

    def make(f: str):
        def read():
            from PIL import Image

            with Image.open(f) as im:
                if mode:
                    im = im.convert(mode)
                if size is not None:
                    im = im.resize((size[1], size[0]))
                arr = np.asarray(im)
            if size is not None:
                col = arr[None]  # stackable: (1, h, w[, c])
            else:
                col = np.empty(1, dtype=object)
                col[0] = arr
            blk: B.Block = {"image": col}
            if include_paths:
                blk["path"] = np.asarray([f])
            return [blk]

        return read

    return [make(f) for f in files]


# ---- writers (run as map tasks) --------------------------------------
def write_numpy_block(path_dir: str, column: str = "data"):
    def write(blk: B.Block) -> List[B.Block]:
        import uuid

        arr = np.asarray(blk[column])
        if arr.dtype == object:
            # np.save would pickle these, and read_numpy (rightly)
            # loads with allow_pickle=False — fail loudly at write time
            raise ValueError(
                f"write_numpy: column {column!r} has object dtype "
                f"(ragged rows); convert to a dense dtype first"
            )
        os.makedirs(path_dir, exist_ok=True)
        f = os.path.join(path_dir, f"part-{uuid.uuid4().hex[:12]}.npy")
        np.save(f, arr, allow_pickle=False)
        return [{"path": np.asarray([f]),
                 "num_rows": np.asarray([B.num_rows(blk)])}]

    return write



def write_parquet_block(path_dir: str):
    def write(blk: B.Block) -> List[B.Block]:
        import uuid

        import pyarrow.parquet as pq

        os.makedirs(path_dir, exist_ok=True)
        f = os.path.join(path_dir, f"part-{uuid.uuid4().hex[:12]}.parquet")
        pq.write_table(B.to_arrow(blk), f)
        return [{"path": np.asarray([f]), "num_rows": np.asarray([B.num_rows(blk)])}]

    return write


def write_csv_block(path_dir: str):
    def write(blk: B.Block) -> List[B.Block]:
        import uuid

        os.makedirs(path_dir, exist_ok=True)
        f = os.path.join(path_dir, f"part-{uuid.uuid4().hex[:12]}.csv")
        B.to_pandas(blk).to_csv(f, index=False)
        return [{"path": np.asarray([f]), "num_rows": np.asarray([B.num_rows(blk)])}]

    return write


def write_json_block(path_dir: str):
    def write(blk: B.Block) -> List[B.Block]:
        import uuid

        os.makedirs(path_dir, exist_ok=True)
        f = os.path.join(path_dir, f"part-{uuid.uuid4().hex[:12]}.json")
        B.to_pandas(blk).to_json(f, orient="records", lines=True)
        return [{"path": np.asarray([f]), "num_rows": np.asarray([B.num_rows(blk)])}]

    return write


def tfrecord_tasks(paths, *, parse_example: bool = True,
                   verify: bool = True) -> List[Callable[[], List[B.Block]]]:
    """One read task per TFRecord file (reference:
    `_internal/datasource/tfrecords_datasource.py` — there TF-backed;
    here `data/tfrecord.py`'s native framing + tf.Example codec)."""
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            from ray_tpu_torch.data.tfrecord import read_tfrecords_rows

            return [B.from_rows(
                read_tfrecords_rows(f, parse_example=parse_example,
                                    verify=verify)
            )]

        return read

    return [make(f) for f in files]


def write_tfrecords_block(path_dir: str):
    """Write helper: each block becomes one .tfrecord file of
    tf.Examples (columns -> features)."""

    def write(blk: B.Block) -> List[B.Block]:
        import uuid

        from ray_tpu_torch.data.tfrecord import encode_example, write_records

        os.makedirs(path_dir, exist_ok=True)
        f = os.path.join(path_dir, f"part-{uuid.uuid4().hex[:12]}.tfrecord")
        write_records(f, [
            encode_example(row) for row in B.iter_rows(blk)
        ])
        return [{"path": np.asarray([f]),
                 "num_rows": np.asarray([B.num_rows(blk)])}]

    return write


def avro_tasks(paths) -> List[Callable[[], List[B.Block]]]:
    """Avro object-container files (reference:
    `_internal/datasource/avro_datasource.py`); `data/avro.py` is a
    native reader for null/deflate codecs."""
    files = _expand_paths(paths)

    def make(f: str):
        def read():
            from ray_tpu_torch.data.avro import read_avro_rows

            return [B.from_rows(read_avro_rows(f))]

        return read

    return [make(f) for f in files]


def sql_tasks(sql: str, connection_factory) -> List[Callable[[], List[B.Block]]]:
    """One read task running `sql` through a DB-API connection from
    `connection_factory` (reference: `_internal/datasource/
    sql_datasource.py` — same contract: the factory must be
    serializable, the connection is made ON the worker)."""

    def read():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
        finally:
            conn.close()
        return [B.from_rows(rows)]

    return [read]
