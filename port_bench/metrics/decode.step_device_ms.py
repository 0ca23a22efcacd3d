"""Device time of the traced sub-window's decode-chunk replays (each
first kernel's start to last kernel's end) over the decode steps they
ran."""

from __future__ import annotations

LAYER = "decode chunk (models/llama.py paged decode, chunk graphs)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "tpot_p95_ms"

from port_bench.readers import launches, span_s


def read(obs):
    chunks = launches(obs, "chunk")
    if not chunks:
        return None
    steps = obs.data["engine"]["chunk"] * len(chunks)
    return sum(span_s(la["ops"]) for la in chunks) * 1e3 / steps
