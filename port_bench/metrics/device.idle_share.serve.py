"""The share of the traced sub-window in which no operation ran on the
card."""

from __future__ import annotations

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tokens_per_s"

from port_bench.readers import share


def read(obs):
    tr = obs.trace
    if tr is None or tr.window_s <= 0:
        return None
    return share(tr.window_s - tr.busy_s(), tr.window_s)
