"""The engine's share of the card's bf16 peak over the whole traced
sub-window: matmul and attention operations of the prompt tokens of the
prefills that ran in it (each tied to its request by the ticket's
stamps) and of the rows of its decode chunks (`readers.chunk_work`), by
`counts.prefill_flops` and `counts.decode_flops` (bucket padding, idle
slots and recompute not counted), over the sub-window's length at
989 TFLOP/s."""

from __future__ import annotations

LAYER = "engine step (serve/llm_engine.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tokens_per_s"

from port_bench import counts
from port_bench.readers import chunk_work, launches, share


def read(obs):
    cfg = obs.data.get("cfg")
    flops = sum(counts.prefill_flops(cfg, len(la["request"].prompt))
                for la in launches(obs, "prefill", tied=True))
    flops += sum(counts.decode_flops(cfg, *chunk_work(obs, la))
                 for la in launches(obs, "chunk"))
    if not flops:
        return None
    return share(flops, obs.trace.window_s * counts.PEAK_BF16_FLOPS)
