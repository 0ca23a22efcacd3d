"""State API: programmatic cluster introspection.

Reference: `python/ray/util/state/api.py` (`StateApiClient:110`,
`list_tasks:1008`) — list/summarize tasks, actors, nodes, placement
groups, jobs; data aggregated by the controller (the GCS-task-manager
equivalent fed by every runtime's task-event buffer).
"""

from __future__ import annotations

import json
import time
from collections import Counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.runtime import get_runtime


def list_tasks(name: Optional[str] = None, state: Optional[str] = None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    """Latest task state transitions (newest last)."""
    return get_runtime().controller_call(
        "list_task_events", {"name": name, "state": state, "limit": limit}
    )


def list_actors() -> List[Dict[str, Any]]:
    return get_runtime().controller_call("list_actors")


def list_nodes() -> List[Dict[str, Any]]:
    return get_runtime().controller_call("get_nodes")


def list_placement_groups() -> List[Dict[str, Any]]:
    return get_runtime().controller_call("list_placement_groups")


def list_jobs() -> List[Dict[str, Any]]:
    rt = get_runtime()
    out = rt.controller_call("list_jobs")
    return out if out is not None else []


def list_workers() -> List[Dict[str, Any]]:
    """Pool workers across alive nodes (reference: `ray list workers`):
    id, pid, kind, hosted actor, idleness, node."""
    rt = get_runtime()
    # fast path: the per-node reporter pushes worker inventories to the
    # controller every second — one RPC, no per-node fan-out (reference:
    # reporter agents feeding the state aggregator)
    try:
        snap = rt.controller_call("get_worker_snapshot", timeout=10)
        if snap is not None:
            return snap
    except Exception:
        pass
    out: List[Dict[str, Any]] = []
    for n in rt.controller_call("get_nodes") or []:
        if not n.get("alive"):
            continue
        try:
            # bounded: a node that blackholes connections must cost one
            # timeout, not a kernel TCP connect stall per dead node
            ws = rt.noded_call(
                "route_node",
                {"node_id": n["node_id"], "method": "list_workers"},
                timeout=15,
            )
        except Exception:
            ws = None  # node died between listing and the call
        out.extend(ws or [])
    return out


_STATE_RANK = {"SUBMITTED": 0, "RUNNING": 1, "FINISHED": 2, "FAILED": 2}


def summarize_tasks() -> Dict[str, int]:
    """state -> count over the retained event window (the latest event
    per task wins, mirroring `ray summary tasks`).  Events from
    different processes land in the ring in arbitrary order, so 'latest'
    is decided by timestamp with terminal states breaking ties."""
    latest: Dict[str, tuple] = {}
    for ev in list_tasks(limit=50_000):
        tid = ev.get("task_id")
        if not tid:
            continue
        key = (ev["ts"], _STATE_RANK.get(ev["state"], 0))
        if tid not in latest or key >= latest[tid][0]:
            latest[tid] = (key, ev["state"])
    return dict(Counter(state for _, state in latest.values()))


def cluster_status() -> Dict[str, Any]:
    """`ray status`-shaped summary."""
    nodes = list_nodes()
    actors = list_actors()
    state = get_runtime().controller_call("get_autoscaler_state")
    return {
        "nodes_alive": sum(1 for n in nodes if n["alive"]),
        "nodes_dead": sum(1 for n in nodes if not n["alive"]),
        "total_resources": _sum_resources(nodes),
        "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
        "pending_demands": state["pending_demands"],
        "task_summary": summarize_tasks(),
    }


def _sum_resources(nodes) -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes:
        if n["alive"]:
            for k, v in n["resources"].items():
                total[k] = total.get(k, 0.0) + v
    return total


def timeline(filename: Optional[str] = None,
             trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-tracing events from the task event log MERGED with the
    cluster-collected trace spans (reference: `ray.timeline()` —
    `_private/state.py:948` chrome_tracing_dump, plus the otel span
    view the reference splits across tools).  One builder feeds this
    and `GET /api/timeline` (`dashboard/timeline.py`), so the two
    surfaces can never drift.  Load the output in chrome://tracing or
    Perfetto; `trace_id` narrows the span set to one request's
    lineage."""
    from ray_tpu_torch.dashboard.timeline import build_chrome_trace

    data = get_runtime().controller_call(
        "timeline_data", {"trace_id": trace_id}
    ) or {}
    doc = build_chrome_trace(
        data.get("events", []),
        data.get("spans", []),
        events_truncated=data.get("events_truncated", False),
        spans_truncated=data.get("spans_truncated", False),
    )
    trace = doc["traceEvents"]
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


__all__ = [
    "cluster_status",
    "list_actors",
    "list_jobs",
    "list_nodes",
    "list_placement_groups",
    "list_tasks",
    "list_workers",
    "summarize_tasks",
    "timeline",
]


def memory_summary() -> List[Dict[str, Any]]:
    """Per-node object-memory tables (reference: `ray memory` —
    `python/ray/_private/internal_api.py:34` + `scripts.py:1955`):
    every runtime's reference table (kind, counts, size, residence,
    opt-in creation callsite via RTT_RECORD_REF_CREATION_SITES=1) plus
    each daemon's store occupancy and spilled primaries.  This is the
    tool that answers "what is pinning my object store"."""
    rt = get_runtime()
    out = []
    for n in rt.controller_call("get_nodes") or []:
        if not n.get("alive"):
            continue
        try:
            t = rt.noded_call(
                "route_node",
                {"node_id": n["node_id"], "method": "memory_table"},
                timeout=20,
            )
        except Exception:
            continue  # node died between listing and the call
        if t:
            out.append(t)
    return out


def list_objects(kind: Optional[str] = None,
                 min_size: int = 0) -> List[Dict[str, Any]]:
    """Flattened object-reference rows across the cluster (reference:
    `ray list objects`).  One row per (process, object) hold; filter by
    `kind` (owned/borrowed/pending) or minimum value size."""
    rows: List[Dict[str, Any]] = []
    for node in memory_summary():
        for proc in node.get("processes", []):
            for r in proc.get("refs", []):
                if kind and r["kind"] != kind:
                    continue
                if min_size and (r.get("size") or 0) < min_size:
                    continue
                rows.append({
                    **r,
                    "process": proc.get("mode"),
                    "pid": proc.get("pid"),
                    "node_id_host": node.get("node_id"),
                })
    return rows


def list_cluster_events(severity: Optional[str] = None,
                        event_type: Optional[str] = None,
                        limit: int = 200) -> List[Dict[str, Any]]:
    """Structured cluster event log (reference: `ray list
    cluster-events` over `dashboard/modules/event/`)."""
    return get_runtime().controller_call(
        "list_cluster_events",
        {"severity": severity, "event_type": event_type, "limit": limit},
    )


def watch_cluster_events(timeout: Optional[float] = None):
    """Generator of live cluster events via the controller's pubsub
    channel (reference: the GCS event pubsub feeding dashboard
    watchers).  Yields until `timeout` passes with no event."""
    import queue as _q

    sub = get_runtime().subscribe("cluster_events")
    try:
        while True:
            try:
                yield sub.next_message(timeout=timeout)
            except _q.Empty:
                return
    finally:
        sub.close()
