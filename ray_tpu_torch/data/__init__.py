"""ray_tpu_torch.data — lazy, streaming, distributed datasets.

Reference surface: `ray.data` (SURVEY §2.4 Ray Data): Dataset over
blocks with a lazy logical plan, map fusion, a streaming executor with
bounded in-flight work, and per-consumer streaming splits for Train.
"""

from ray_tpu_torch.data import aggregate
from ray_tpu_torch.data.aggregate import Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.context import ActorPoolStrategy, DataContext
from ray_tpu_torch.data.dataset import (
    Dataset,
    GroupedData,
    from_arrow,
    from_blocks,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_avro,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
)
from ray_tpu_torch.data.iterator import DataIterator

__all__ = [
    "ActorPoolStrategy",
    "Count",
    "DataContext",
    "DataIterator",
    "Dataset",
    "GroupedData",
    "Max",
    "Mean",
    "Min",
    "Std",
    "Sum",
    "aggregate",
    "from_arrow",
    "from_blocks",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_avro",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
]
