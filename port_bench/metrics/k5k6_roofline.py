"""The fused K5 + K6 launch's share of its roofline in the traced decode
chunks: the least time the card needs for each chunk's rows (their live
KV columns read once, their new K and V written once: `counts.
k5k6_work`, bytes-bound; rows and columns from the tickets at the
chunk's launch, `readers.chunk_work`) over the device time of the
chunks' `decode_attention` kernels."""

from __future__ import annotations

LAYER = "fused K5 + K6 (ops/paged_attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tokens_per_s"

from port_bench.readers import (chunk_work, k5k6_bound_s, launches,
                                ops_named, share)


def read(obs):
    bound = busy = 0.0
    for la in launches(obs, "chunk"):
        bound += k5k6_bound_s(obs.data["cfg"], obs.data["engine"],
                              *chunk_work(obs, la))
        busy += sum(o.dur for o in ops_named(la, "decode_attention")) / 1e6
    return share(bound, busy) if bound else None
