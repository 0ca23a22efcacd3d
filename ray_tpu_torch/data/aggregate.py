"""Aggregations for groupby/global aggregate.

Reference: `data/aggregate.py` (AggregateFn: Count/Sum/Min/Max/Mean/Std)
— each aggregation is (init, accumulate_block, merge, finalize) so maps
compute per-block partials and a reduce merges them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np


@dataclass
class AggregateFn:
    init: Callable[[], Any]
    accumulate_block: Callable[[Any, np.ndarray], Any]
    merge: Callable[[Any, Any], Any]
    finalize: Callable[[Any], Any]
    name: str
    on: Optional[str] = None


def Count() -> AggregateFn:
    return AggregateFn(
        init=lambda: 0,
        accumulate_block=lambda a, col: a + len(col),
        merge=lambda a, b: a + b,
        finalize=lambda a: a,
        name="count()",
        on=None,
    )


def Sum(on: str) -> AggregateFn:
    return AggregateFn(
        init=lambda: 0.0,
        accumulate_block=lambda a, col: a + float(np.sum(col)),
        merge=lambda a, b: a + b,
        finalize=lambda a: a,
        name=f"sum({on})",
        on=on,
    )


def Min(on: str) -> AggregateFn:
    return AggregateFn(
        init=lambda: float("inf"),
        accumulate_block=lambda a, col: min(a, float(np.min(col))) if len(col) else a,
        merge=min,
        finalize=lambda a: a,
        name=f"min({on})",
        on=on,
    )


def Max(on: str) -> AggregateFn:
    return AggregateFn(
        init=lambda: float("-inf"),
        accumulate_block=lambda a, col: max(a, float(np.max(col))) if len(col) else a,
        merge=max,
        finalize=lambda a: a,
        name=f"max({on})",
        on=on,
    )


def Mean(on: str) -> AggregateFn:
    return AggregateFn(
        init=lambda: (0.0, 0),
        accumulate_block=lambda a, col: (a[0] + float(np.sum(col)), a[1] + len(col)),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda a: a[0] / a[1] if a[1] else float("nan"),
        name=f"mean({on})",
        on=on,
    )


def Std(on: str, ddof: int = 1) -> AggregateFn:
    # Welford-style mergeable (sum, sum_sq, n)
    return AggregateFn(
        init=lambda: (0.0, 0.0, 0),
        accumulate_block=lambda a, col: (
            a[0] + float(np.sum(col)),
            a[1] + float(np.sum(np.square(col, dtype=np.float64))),
            a[2] + len(col),
        ),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2]),
        finalize=lambda a: (
            float("nan")
            if a[2] <= ddof
            else float(np.sqrt(max(0.0, (a[1] - a[0] ** 2 / a[2]) / (a[2] - ddof))))
        ),
        name=f"std({on})",
        on=on,
    )
