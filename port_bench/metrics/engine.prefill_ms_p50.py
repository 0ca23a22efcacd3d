"""Median of the window's requests' admission to prefill-dispatched
stamps (`EngineTicket`): the host's time to hand the prefill and its
block write to the card, which a replayed graph returns from before
the card has run it (`prefill.device_ms_p50` is the card's)."""

from __future__ import annotations

LAYER = "prefill families (serve/llm_engine.py, models/llama.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p95_ms"

from port_bench.readers import pct


def read(obs):
    reqs = obs.data.get("requests") or []
    return pct([(r.t_prefill - r.t_admit) * 1e3 for r in reqs
                if r.t_prefill is not None and r.t_admit is not None], 50)
