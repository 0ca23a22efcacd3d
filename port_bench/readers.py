"""What the per-layer readers (`metrics/<name>.py`) share: percentiles,
and the work of the serve cells' traced graph replays, counted from
shapes with `counts.py`.

A reader returns None where its run holds nothing for it to read, and
the harness then leaves its metric out of the result line."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from port_bench import counts


def pct(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if whole > 0 else None


def launches(obs, kind: str, tied: bool = False) -> List[Dict]:
    """The traced sub-window's graph replays of `kind` ("chunk",
    "prefill", "write") that ran wholly inside it; with `tied`, only
    the prefills tied to their request."""
    tr = obs.trace
    if tr is None or "launches" not in obs.data:
        return []
    return [la for la in obs.data["launches"]
            if la["kind"] == kind and tr.inside(la["ops"])
            and (not tied or la.get("request") is not None)]


def ops_named(la: Dict, part: str):
    return [o for o in la["ops"] if part in o.name]


def span_s(ops) -> float:
    return (max(o.ts + o.dur for o in ops) - min(o.ts for o in ops)) / 1e6


def bucket(obs, t: int) -> int:
    """The prefill bucket a prompt of `t` tokens is padded to: the next
    power of two, capped below the engine's `max_len`."""
    return min(1 << max(0, t - 1).bit_length(), obs.data["engine"]["max_len"] - 1)


def chunk_work(obs, la: Dict) -> Tuple[int, float]:
    """(decode rows, KV columns they read) of one chunk launch over its
    `chunk` steps, from the tickets at the launch's host time: every
    request whose prefill was dispatched before it and whose last token
    was not yet handed over holds a row; a row that has been handed k
    tokens (by the even spread `output_tokens_per_s` counts, at least
    the first) reads prompt + k columns at the chunk's first step, one
    more at each next."""
    t = obs.trace.to_host(la["rt"].ts)
    steps = obs.data["engine"]["chunk"]
    n, cols = 0, 0.0
    for r in obs.data["submitted"]:
        if (r.t_prefill is None or r.t_done is None or not r.tokens
                or r.ttft_s is None or not r.t_prefill <= t < r.t_done):
            continue
        n += 1
        cols += steps * (len(r.prompt) + max(r.tokens_by(t), 1.0))
    return steps * n, cols + n * steps * (steps - 1) / 2


def k5k6_bound_s(cfg: Dict, engine: Dict, rows: int,
                 cols: float) -> float:
    """The least time for the fused K5 + K6 launches of `rows` decode
    rows reading `cols` KV columns, through every layer."""
    n_bytes, flops = counts.k5k6_work(
        rows, cols, cols / engine["block_size"] + rows,
        cfg["num_attention_heads"], cfg["num_key_value_heads"],
        counts.head_dim(cfg))
    return cfg["num_hidden_layers"] * counts.bound_s(n_bytes, flops)[0]
