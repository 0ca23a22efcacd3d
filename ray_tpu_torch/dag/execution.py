"""Resident exec loops for compiled DAGs (runs inside actor workers).

Reference: `python/ray/dag/compiled_dag_node.py` (`do_exec_tasks:92`,
`ExecutableTask:281`) — after compilation each participating actor runs
one long-lived loop: read input channels, run the bound methods in local
topological order, write output channels.  The per-call submit/lease/
ownership machinery is bypassed entirely; only channel ops remain on the
hot path.  Array-valued step outputs (and tuples/lists/dicts of arrays
— a multi-output step) ride the tensor fast path: one slot publication
per consumer, no pickle on the array bytes (channel.py KIND_TENSOR).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from ray_tpu_torch.dag.channel import (
    KIND_DATA,
    Channel,
    ChannelClosed,
)
from ray_tpu_torch.metrics import metric_defs as _mdefs

logger = logging.getLogger(__name__)

# arg-source tags in the compiled plan
SRC_CONST = "const"
SRC_LOCAL = "local"  # upstream node output on the same actor
SRC_CHAN = "chan"  # read from a channel (cross-actor edge)
SRC_INPUT = "input"  # the per-execution driver input


def dag_exec_loop(instance: Any, plan: Dict) -> int:
    """plan = {
        "input_channel": (name, location) | None,
        "steps": [
            {"node_id", "method", "args": [(src, payload), ...],
             "kwargs": {k: (src, payload)},
             "out_channels": [(name, location)]},  # cross-actor edges
        ],
    }
    Channel refs are (name, ring-location-node); rings live on their
    reader's node, so reads here are always local and writes relay
    through the daemons when the consumer is on another node.
    Returns the number of completed executions (after teardown)."""
    input_chan = (
        Channel(*plan["input_channel"]) if plan.get("input_channel") else None
    )
    chans: Dict[str, Channel] = {}

    def chan(ref) -> Channel:
        name, loc = ref
        c = chans.get(name)
        if c is None:
            c = chans[name] = Channel(name, loc)
        return c

    executions = 0
    while True:
        try:
            locals_: Dict[int, Any] = {}
            input_value = None
            have_input = False
            if input_chan is not None:
                input_value = input_chan.read()
                have_input = True

            def resolve(src_payload):
                src, payload = src_payload
                if src == SRC_CONST:
                    return payload
                if src == SRC_LOCAL:
                    v = locals_[payload]
                    if isinstance(v, _Poison):
                        raise v.err  # upstream error poisons this step
                    return v
                if src == SRC_CHAN:
                    return chan(payload).read()
                if src == SRC_INPUT:
                    if not have_input:
                        raise RuntimeError("plan uses input but none wired")
                    return input_value
                raise ValueError(src)

            for step in plan["steps"]:
                try:
                    args = [resolve(a) for a in step["args"]]
                    kwargs = {k: resolve(v) for k, v in step["kwargs"].items()}
                    out = getattr(instance, step["method"])(*args, **kwargs)
                except ChannelClosed:
                    raise
                except BaseException as e:  # noqa: BLE001 — error propagates
                    # through the graph, poisoning downstream stages
                    logger.debug("DAG step %s failed; poisoning "
                                 "downstream: %s", step["method"], e)
                    locals_[step["node_id"]] = _Poison(e)
                    for name in step["out_channels"]:
                        chan(name).write_error(e)
                    continue
                locals_[step["node_id"]] = out
                for name in step["out_channels"]:
                    chan(name).write(out, kind=KIND_DATA)
            executions += 1
            _mdefs.inc("rt_dag_execs_total")
        except ChannelClosed:
            # teardown: forward the sentinel so downstream loops exit too
            for step in plan["steps"]:
                for name in step["out_channels"]:
                    chan(name).close()
            return executions
        except BaseException:
            # channel-level failure (writer timeout, store error): the
            # loop cannot continue coherently — unblock downstream with
            # sentinels, then surface the error on the loop task itself
            for step in plan["steps"]:
                for name in step["out_channels"]:
                    chan(name).close()
            raise


class _Poison:
    """Marks a local value as an upstream error."""

    def __init__(self, err: BaseException):
        self.err = err

    def __repr__(self):
        return f"_Poison({self.err!r})"
