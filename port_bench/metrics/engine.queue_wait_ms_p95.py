"""95th percentile of the window's requests' wait in the engine's queue:
the ticket's submit to admission stamps (`EngineTicket`)."""

from __future__ import annotations

LAYER = "engine admission (serve/llm_engine.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p95_ms"

from port_bench.readers import pct


def read(obs):
    reqs = obs.data.get("requests") or []
    return pct([(r.t_admit - r.t_submit) * 1e3 for r in reqs
                if r.t_admit is not None], 95)
