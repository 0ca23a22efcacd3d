"""One driver a kind of cell: `run(cell, seed, seconds, trace, device)`
builds the system under test from the seed, warms it, measures for
`seconds`, checks the timed path's outputs against the reference, and
returns an `Observed`."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Observed:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int
    info: Dict[str, Any]
    trace: Optional[Any] = None
    # what the per-layer readers read, by driver
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": float(value), "limit": float(limit)}
