"""K1's share of its roofline in the traced prefills: the least time
for each tied prefill's causal attention at its bucket (`counts.
flash_bound_s`, once a layer) over its K1 launches' device time.
Buckets that K1 does not take (not a multiple of its blocks) launch
none and do not count."""

from __future__ import annotations

LAYER = "flash attention K1 (ops/attention.py)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"

from port_bench import counts
from port_bench.readers import bucket, launches, ops_named, share


def read(obs):
    if obs.data.get("prefix_hits_in_window"):
        return None
    cfg = obs.data["cfg"]
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    bound = busy = 0.0
    for la in launches(obs, "prefill", tied=True):
        ops = ops_named(la, "flash_fwd")
        if len(ops) != L:
            continue
        t = bucket(obs, len(la["request"].prompt))
        bound += L * counts.flash_bound_s("k1", H, t, counts.head_dim(cfg))
        busy += sum(o.dur for o in ops) / 1e6
    return share(bound, busy)
