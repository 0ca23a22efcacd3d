"""Grafana dashboard factory + built-in cluster metrics.

Reference: `dashboard/modules/metrics/grafana_dashboard_factory.py` —
Grafana dashboard JSON generated from declarative panel configs over the
metrics the cluster exports, so operators import one file instead of
hand-building boards.  `rt grafana-dashboard --out d/` and
`GET /api/grafana_dashboard` both emit it.

The built-in gauges mirror the reference's core `ray_*` series
(`src/ray/stats/metric_defs.h:46-120` — nodes/actors/scheduler/object
store) and are refreshed from controller state at scrape time by the
dashboard's `/metrics` handler.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util.metrics import Gauge

logger = logging.getLogger(__name__)

# -- built-in cluster metrics -------------------------------------------
_builtin: Dict[str, Gauge] = {}


def _gauge(name: str, desc: str, tag_keys=()) -> Gauge:
    g = _builtin.get(name)
    if g is None:
        g = _builtin[name] = Gauge(name, desc, tag_keys=tag_keys)
    return g


async def update_builtin_metrics(ctl):
    """Refresh cluster gauges from controller state; `ctl(method,
    payload=None)` is the dashboard's controller-call coroutine."""
    nodes = await ctl("get_nodes") or []
    _gauge("rt_nodes", "cluster nodes by liveness", ("state",)).set(
        float(sum(1 for n in nodes if n["alive"])), {"state": "alive"}
    )
    _gauge("rt_nodes", "cluster nodes by liveness", ("state",)).set(
        float(sum(1 for n in nodes if not n["alive"])), {"state": "dead"}
    )
    actors = await ctl("list_actors") or []
    by_state: Dict[str, int] = {}
    for a in actors:
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    g = _gauge("rt_actors", "actors by state", ("state",))
    g.clear()  # states with zero actors must stop exporting old counts
    for state, count in by_state.items():
        g.set(float(count), {"state": state})
    auto = await ctl("get_autoscaler_state") or {}
    _gauge("rt_pending_demands", "unscheduled resource demands").set(
        float(len(auto.get("pending_demands", [])))
    )
    _gauge("rt_pending_gangs", "unplaced placement groups").set(
        float(len(auto.get("pending_gangs", [])))
    )
    snap = await ctl("get_worker_snapshot")
    if snap is not None:
        _gauge("rt_workers", "live worker processes").set(float(len(snap)))
    # serve replica targets vs running, per (app, deployment)
    try:
        from ray_tpu_torch.serve.api import _get_controller_async
        from ray_tpu_torch.core.runtime import get_runtime

        controller = await _get_controller_async()
        ref = controller.get_serve_status.remote()
        status = await get_runtime()._get_one(ref)
    except Exception:
        status = {}
    g = _gauge("rt_serve_replicas", "serve replicas",
               ("app", "deployment", "kind"))
    g.clear()  # deleted apps/deployments must not export stale series
    req = _gauge("rt_serve_requests_total",
                 "completed serve requests (monotonic)",
                 ("app", "deployment"))
    lat = _gauge("rt_serve_latency_seconds_sum",
                 "summed serve request latency (monotonic)",
                 ("app", "deployment"))
    req.clear()
    lat.clear()
    # LLM-engine panel bridge: the per-replica stats() piggyback the
    # controller already collects (queue depth, pool occupancy, radix
    # hit rate, shed/reject counters) re-exported under the CATALOGED
    # names (`ray_tpu_torch/metrics/metric_defs.py`) — the registry view and
    # /api/serve stay one source of truth, nothing is double-polled
    from ray_tpu_torch.metrics import metric_defs as _mdefs

    _ENGINE_BRIDGE = {
        "rt_serve_engine_queue_depth": "queue_depth",
        "rt_serve_engine_block_occupancy": "block_occupancy",
        "rt_serve_engine_prefix_hit_rate": "prefix_hit_rate",
        "rt_serve_engine_ttft_ema_seconds": "ttft_ema_s",
        "rt_serve_engine_ttft_p90_seconds": "ttft_p90_s",
        "rt_serve_engine_rejected_total": "rejected_total",
        "rt_serve_engine_shed_total": "shed_total",
        "rt_serve_kv_pool_bytes": "kv_pool_bytes",
        "rt_serve_decode_kernel_total": "decode_kernel_dispatch_total",
    }
    eng_gauges = {name: _mdefs.metric(name) for name in _ENGINE_BRIDGE}
    for eg in eng_gauges.values():
        eg.clear()  # dead replicas must not export stale series
    for app, deployments in (status or {}).items():
        for dep, info in deployments.items():
            tags = {"app": app, "deployment": dep}
            g.set(float(info.get("running", 0)), {**tags, "kind": "running"})
            g.set(float(info.get("target_replicas", 0)),
                  {**tags, "kind": "target"})
            req.set(float(info.get("completed", 0.0)), tags)
            lat.set(float(info.get("latency_sum_s", 0.0)), tags)
            for rid, rinfo in (info.get("replicas") or {}).items():
                engine = rinfo.get("engine")
                if not isinstance(engine, dict):
                    continue
                rtags = {**tags, "replica": rid}
                for mname, skey in _ENGINE_BRIDGE.items():
                    try:
                        eng_gauges[mname].set(float(engine.get(skey, 0.0)),
                                              rtags)
                    except (TypeError, ValueError):
                        logger.debug("engine stat %s=%r not numeric",
                                     skey, engine.get(skey))
    # per-replica series (reference: `serve/metrics.py` replica-tagged
    # request counter / queue gauge / latency histogram) so autoscaling
    # decisions are auditable from /metrics
    try:
        ref = controller.get_replica_metrics.remote()
        per_replica = await get_runtime()._get_one(ref)
    except Exception:
        per_replica = {}
    rep_tags = ("app", "deployment", "replica")
    rr = _gauge("rt_serve_replica_requests_total",
                "completed requests per replica (monotonic)", rep_tags)
    rq = _gauge("rt_serve_replica_queue_depth",
                "in-flight requests per replica", rep_tags)
    rls = _gauge("rt_serve_replica_latency_seconds_sum",
                 "summed request latency per replica", rep_tags)
    rlb = _gauge("rt_serve_replica_latency_seconds_bucket",
                 "request latency histogram per replica",
                 rep_tags + ("le",))
    for m in (rr, rq, rls, rlb):
        m.clear()  # dead replicas must not export stale series
    from ray_tpu_torch.serve.replica import LATENCY_BOUNDARIES

    for app, deployments in (per_replica or {}).items():
        for dep, replicas in deployments.items():
            for rid, m in replicas.items():
                tags = {"app": app, "deployment": dep, "replica": rid}
                # COMPLETED requests: the histogram count basis (the
                # started-count would put phantom in-flight mass in the
                # +Inf bucket and wreck histogram_quantile)
                completed = float(m.get("completed", m.get("total", 0)))
                rr.set(completed, tags)
                rq.set(float(m.get("ongoing", 0)), tags)
                rls.set(float(m.get("latency_sum_s", 0.0)), tags)
                buckets = m.get("latency_buckets") or []
                cum = 0.0
                for bound, n in zip(LATENCY_BOUNDARIES, buckets):
                    cum += n
                    rlb.set(cum, {**tags, "le": str(bound)})
                rlb.set(completed, {**tags, "le": "+Inf"})


# -- dashboard generation -----------------------------------------------
@dataclass
class Target:
    expr: str
    legend: str = ""


@dataclass
class Panel:
    title: str
    unit: str = "short"
    targets: List[Target] = field(default_factory=list)
    description: str = ""


DEFAULT_PANELS: List[Panel] = [
    Panel("Alive nodes", targets=[Target('rt_nodes{state="alive"}', "alive"),
                                  Target('rt_nodes{state="dead"}', "dead")]),
    Panel("Actors by state",
          targets=[Target("rt_actors", "{{state}}")]),
    Panel("Live workers", targets=[Target("rt_workers", "workers")]),
    Panel("Pending resource demands",
          targets=[Target("rt_pending_demands", "demands"),
                   Target("rt_pending_gangs", "gangs")],
          description="nonzero sustained = cluster needs to scale up"),
    Panel("Serve replicas: running vs target",
          targets=[Target('rt_serve_replicas{kind="running"}',
                          "{{app}}/{{deployment}} running"),
                   Target('rt_serve_replicas{kind="target"}',
                          "{{app}}/{{deployment}} target")],
          description="running < target sustained = replicas failing "
                      "to start"),
    Panel("Serve request rate", unit="reqps",
          targets=[Target("rate(rt_serve_requests_total[1m])",
                          "{{app}}/{{deployment}}")]),
    Panel("Serve mean latency", unit="s",
          targets=[Target(
              "rate(rt_serve_latency_seconds_sum[5m]) / "
              "rate(rt_serve_requests_total[5m])",
              "{{app}}/{{deployment}}")]),
    # ---- unified observability plane (ray_tpu_torch/metrics catalog) ------
    Panel("Task throughput", unit="ops",
          targets=[Target(
              "sum by (shard) (rate(rt_owner_tasks_completed_total[1m]))",
              "shard {{shard}}")],
          description="owner-plane completions/s per shard "
                      "(RTT_METRICS_ENABLED=1)"),
    Panel("Task latency p99", unit="s",
          targets=[Target(
              "histogram_quantile(0.99, sum by (le) "
              "(rate(rt_owner_task_latency_seconds_bucket[5m])))",
              "p99")],
          description="submit to final completion, owner-side"),
    Panel("Object store occupancy", unit="bytes",
          targets=[Target("rt_object_store_used_bytes", "{{node}} used"),
                   Target("rt_object_store_capacity_bytes",
                          "{{node}} capacity")]),
    Panel("Spill / restore rate", unit="Bps",
          targets=[Target("rate(rt_object_spill_bytes_total[5m])",
                          "{{node}} spill"),
                   Target("rate(rt_object_restore_bytes_total[5m])",
                          "{{node}} restore")]),
    Panel("Object integrity + storage faults",
          targets=[Target("rate(rt_object_integrity_errors_total[5m])",
                          "checksum failures {{path}}"),
                   Target("rate(rt_object_quarantined_total[5m])",
                          "quarantined spill files"),
                   Target("rate(rt_spill_disk_full_total[5m])",
                          "spill disk full"),
                   Target("rate(rt_spill_errors_total[5m])",
                          "disk I/O errors {{op}}")],
          description="any nonzero = a disk is corrupting or refusing "
                      "data; jobs survive via quarantine + lineage, "
                      "but the device needs attention"),
    Panel("Shuffle backpressure + reconstructions",
          targets=[Target("rate(rt_shuffle_backpressure_total[5m])",
                          "backpressure {{phase}}"),
                   Target("rate(rt_object_reconstructions_total[5m])",
                          "lineage reconstructions")],
          description="sustained nonzero = store budget or partition "
                      "count needs tuning"),
    # ---- serve request ledger (serve/request_ledger.py) -------------
    Panel("Serve request latency", unit="s",
          targets=[Target(
              "histogram_quantile(0.9, sum by (le, app, deployment) "
              "(rate(rt_serve_ttft_seconds_bucket[5m])))",
              "ttft p90 {{app}}/{{deployment}}"),
              Target(
              "histogram_quantile(0.9, sum by (le, app, deployment) "
              "(rate(rt_serve_e2e_seconds_bucket[5m])))",
              "e2e p90 {{app}}/{{deployment}}"),
              Target(
              "histogram_quantile(0.9, sum by (le, app, deployment) "
              "(rate(rt_serve_queue_wait_seconds_bucket[5m])))",
              "queue wait p90 {{app}}/{{deployment}}")],
          description="per-request ledger phases (windowed histograms, "
                      "not EMAs): TTFT, end-to-end, and router queue "
                      "wait; pair with /api/slo burn rates"),
    Panel("Serve decode cadence", unit="s",
          targets=[Target(
              "histogram_quantile(0.5, sum by (le, app, deployment) "
              "(rate(rt_serve_tpot_seconds_bucket[5m])))",
              "tpot p50 {{app}}/{{deployment}}"),
              Target(
              "histogram_quantile(0.9, sum by (le, app, deployment) "
              "(rate(rt_serve_prefill_seconds_bucket[5m])))",
              "prefill p90 {{app}}/{{deployment}}")],
          description="time-per-output-token and prefill from the "
                      "engine tickets on the request ledger"),
    Panel("Engine queue depth",
          targets=[Target("rt_serve_engine_queue_depth",
                          "{{app}}/{{deployment}}/{{replica}}")],
          description="bridged from the replicas' stats() piggyback"),
    Panel("Engine KV pool + decode kernel", unit="bytes",
          targets=[Target("rt_serve_kv_pool_bytes",
                          "pool {{app}}/{{deployment}}/{{replica}}"),
                   Target("rate(rt_serve_decode_kernel_total[5m])",
                          "kernel ticks/s "
                          "{{app}}/{{deployment}}/{{replica}}")],
          description="int8 pools sit at half the fp16 payload bytes; "
                      "a zero kernel rate on the card means the engine fell "
                      "back to the gather decode route"),
    Panel("Train step time p50", unit="s",
          targets=[Target(
              "histogram_quantile(0.5, sum by (le) "
              "(rate(rt_train_step_seconds_bucket[5m])))", "p50")]),
    Panel("RLlib fleet throughput",
          targets=[Target("rate(rt_rllib_env_steps_total[1m])",
                          "env steps/s"),
                   Target("rate(rt_rllib_sample_batch_bytes_total[1m])",
                          "sample bytes/s"),
                   Target("rt_rllib_env_runners", "env runners")],
          description="EnvRunner fleet → learner gang: consumed env "
                      "steps (exactly-once ledger), object-plane "
                      "sample bytes, and fleet size (dips = runner "
                      "replacements in progress)"),
    Panel("RLlib learner update p50", unit="s",
          targets=[Target(
              "histogram_quantile(0.5, sum by (le) "
              "(rate(rt_rllib_learner_update_seconds_bucket[5m])))",
              "p50")],
          description="full epochs pass over one train batch; compare "
                      "against sample_busy_s for the overlap budget"),
    Panel("Compiled-DAG fast plane",
          targets=[Target("rate(rt_dag_execs_total[1m])",
                          "exec-loop executions/s"),
                   Target("rate(rt_dag_channel_ring_full_total[5m])",
                          "ring-full writes"),
                   Target(
                       "histogram_quantile(0.99, sum by (le) "
                       "(rate(rt_dag_channel_write_seconds_bucket[5m])))",
                       "channel write p99")],
          description="resident exec loops + shm tensor channels; "
                      "sustained ring-full = a reader is the "
                      "bottleneck (raise RTT_DAG_RING_SLOTS or fix the "
                      "slow stage)"),
    Panel("Dropped task events",
          targets=[Target("rate(rt_task_events_dropped_total[5m])",
                          "{{proc}}")],
          description="nonzero = the event flush cannot keep up; "
                      "raise RTT_TASK_EVENTS_BUFFER_SIZE"),
]


def _panel_json(p: Panel, panel_id: int, x: int, y: int) -> Dict[str, Any]:
    return {
        "id": panel_id,
        "title": p.title,
        "description": p.description,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "fieldConfig": {"defaults": {"unit": p.unit}, "overrides": []},
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "targets": [
            {
                "expr": t.expr,
                "legendFormat": t.legend,
                "refId": chr(ord("A") + i),
            }
            for i, t in enumerate(p.targets)
        ],
    }


def dashboard_json(title: str = "ray_tpu_torch cluster",
                   panels: Optional[List[Panel]] = None,
                   uid: str = "ray-tpu-default") -> Dict[str, Any]:
    """A complete importable Grafana dashboard document."""
    panels = DEFAULT_PANELS if panels is None else panels
    out_panels = []
    for i, p in enumerate(panels):
        x = (i % 2) * 12
        y = (i // 2) * 8
        out_panels.append(_panel_json(p, i + 1, x, y))
    return {
        "uid": uid,
        "title": title,
        "tags": ["ray_tpu_torch", "generated"],
        "timezone": "browser",
        "refresh": "15s",
        "schemaVersion": 39,
        "templating": {"list": [{
            "name": "datasource",
            "type": "datasource",
            "query": "prometheus",
        }]},
        "time": {"from": "now-1h", "to": "now"},
        "panels": out_panels,
    }


def default_dashboard() -> Dict[str, Any]:
    return dashboard_json()


def write_dashboards(out_dir: str) -> List[str]:
    """Write the generated dashboard files (the factory's CLI shape)."""
    import json
    import os

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ray_tpu_default_dashboard.json")
    with open(path, "w") as f:
        json.dump(default_dashboard(), f, indent=2)
    return [path]
