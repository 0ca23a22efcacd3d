"""Whole-run distributed timeline: task events + collected spans →
one Chrome-trace document.

Reference: `ray.timeline()` (`_private/state.py:948`
chrome_tracing_dump) merged with the otel span view the reference
splits across tools.  One builder feeds both surfaces —
`GET /api/timeline` on the dashboard head and `rt.timeline()` — so the
browser view and the programmatic dump can never drift.

Event mapping:

- FINISHED/FAILED task events with a duration → complete (`ph:"X"`)
  slices, one lane per worker, exactly the pre-existing view;
- tasks whose LATEST state in the window is SUBMITTED/RUNNING →
  begin (`ph:"B"`) events, so in-flight work is VISIBLE instead of
  silently dropped (Perfetto renders an unclosed B to the end of the
  trace — which is the truth: it hasn't finished);
- collected spans (driver submit/retry, daemon sched hops, worker
  run spans) → `cat:"span"` slices laned by reporting process, with
  `trace_id`/`span_id`/`parent_id` in `args` so one logical request is
  correlated across every process that touched it;
- the document carries a `truncated` flag whenever either source
  window clipped (ring eviction or query limit) — the old endpoint
  capped at 50k events with no signal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

_TERMINAL = ("FINISHED", "FAILED")
_LIVE = ("SUBMITTED", "RUNNING")


def _task_trace_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    # latest state per task decides whether it gets a B event; terminal
    # events break timestamp ties (events from different processes land
    # in the ring in arbitrary order)
    latest: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        tid = ev.get("task_id")
        state = ev.get("state")
        if not tid or state is None:
            continue
        if state in _TERMINAL and ev.get("duration"):
            dur_us = ev["duration"] * 1e6
            out.append({
                "name": ev.get("name", "task"),
                "cat": "task",
                "ph": "X",
                "ts": ev["ts"] * 1e6 - dur_us,
                "dur": dur_us,
                "pid": ev.get("node_id", "cluster"),
                "tid": ev.get("worker_id", tid[:8]),
                "args": {"task_id": tid, "state": state},
            })
        cur = latest.get(tid)
        rank = 1 if state in _TERMINAL else 0
        key = (ev.get("ts", 0.0), rank)
        if cur is None or key >= cur["_key"]:
            latest[tid] = {**ev, "_key": key}
    for tid, ev in latest.items():
        if ev.get("state") not in _LIVE:
            continue
        out.append({
            "name": ev.get("name", "task"),
            "cat": "task",
            "ph": "B",
            "ts": ev["ts"] * 1e6,
            "pid": ev.get("node_id", "cluster"),
            "tid": ev.get("worker_id", tid[:8]),
            "args": {"task_id": tid, "state": ev.get("state")},
        })
    return out


def _span_trace_events(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out = []
    for s in spans:
        start = s.get("start")
        if start is None:
            continue
        end = s.get("end", start)
        args = {
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "parent_id": s.get("parent_id"),
            "kind": s.get("kind"),
        }
        if s.get("error"):
            args["error"] = s["error"]
        if s.get("attrs"):
            args.update(s["attrs"])
        out.append({
            "name": s.get("name", "span"),
            "cat": "span",
            "ph": "X",
            "ts": start * 1e6,
            "dur": max(1.0, (end - start) * 1e6),
            "pid": s.get("node", "cluster"),
            "tid": s.get("proc", "?"),
            "args": args,
        })
    return out


def build_chrome_trace(events: List[Dict[str, Any]],
                       spans: Optional[List[Dict[str, Any]]] = None,
                       *,
                       events_truncated: bool = False,
                       spans_truncated: bool = False) -> Dict[str, Any]:
    """The merged timeline document: `{"traceEvents": [...],
    "truncated": bool, ...}` — the Chrome trace 'object format', loads
    directly in chrome://tracing and Perfetto."""
    trace = _task_trace_events(events)
    trace.extend(_span_trace_events(spans or []))
    trace.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": trace,
        "truncated": bool(events_truncated or spans_truncated),
        "events_truncated": bool(events_truncated),
        "spans_truncated": bool(spans_truncated),
    }
