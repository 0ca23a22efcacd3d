"""Median device time of a prefill graph's replay in the traced
sub-window (first kernel's start to last kernel's end)."""

from __future__ import annotations

LAYER = "prefill families (serve/llm_engine.py, models/llama.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"

from port_bench.readers import launches, pct, span_s


def read(obs):
    return pct([span_s(la["ops"]) * 1e3
                for la in launches(obs, "prefill")], 50)
