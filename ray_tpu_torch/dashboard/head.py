"""DashboardHead actor.

Reference: `dashboard/head.py:61` DashboardHead + module routes
(`dashboard/modules/{node,actor,job,serve,metrics}`).  Async actor: the
listen socket and all handlers live on the worker's io loop, state is
fetched from the controller with async calls (never blocking the loop).
"""

from __future__ import annotations

import asyncio
import json
import logging
import tempfile
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.serve.request import Request
from ray_tpu_torch.util import httpd

logger = logging.getLogger(__name__)

_SPA_CACHE: Optional[str] = None


def _load_spa() -> str:
    """The buildless single-file SPA (app.html, served at `/`) —
    capability parity with the reference's React client
    (`dashboard/client/src/App.tsx`: live task/actor/node/job tables
    with filters, inline timeline, metric sparklines, log tail)
    without any npm pipeline.  Read once and cached — handlers run on
    the actor's io loop and must not do per-request disk I/O.  Falls
    back to the minimal inline page if the file is missing."""
    global _SPA_CACHE
    if _SPA_CACHE is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "app.html")
        try:
            # read-once, cached for the process lifetime (the module
            # docstring's no-per-request-disk-IO contract)
            with open(path, encoding="utf-8") as f:  # rtlint: disable=RT009
                _SPA_CACHE = f.read()
        except OSError:
            _SPA_CACHE = _FALLBACK_PAGE
    return _SPA_CACHE


_FALLBACK_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; background: #111; color: #eee; }
 h1 { font-size: 1.2em; } h2 { font-size: 1em; margin-top: 1.5em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #444; padding: 4px 8px; text-align: left; }
 a { color: #8cf; }
</style></head>
<body>
<h1>ray_tpu_torch dashboard</h1>
<div id="status"></div>
<h2>nodes</h2><div id="nodes"></div>
<h2>actors</h2><div id="actors"></div>
<h2>jobs</h2><div id="jobs"></div>
<h2>recent tasks</h2><div id="tasks"></div>
<script>
function table(rows) {
  if (!rows || !rows.length) return "<i>none</i>";
  const cols = Object.keys(rows[0]);
  let h = "<table><tr>" + cols.map(c => "<th>"+c+"</th>").join("") + "</tr>";
  for (const r of rows)
    h += "<tr>" + cols.map(c => "<td>"+JSON.stringify(r[c])+"</td>").join("") + "</tr>";
  return h + "</table>";
}
async function refresh() {
  const s = await (await fetch("api/cluster_status")).json();
  document.getElementById("status").innerHTML = "<pre>"+JSON.stringify(s, null, 1)+"</pre>";
  for (const [id, url] of [["nodes","api/nodes"],["actors","api/actors"],
                           ["jobs","api/jobs"],["tasks","api/tasks?limit=25"]]) {
    document.getElementById(id).innerHTML = table(await (await fetch(url)).json());
  }
}
refresh(); setInterval(refresh, 5000);
</script></body></html>"""


class DashboardHead:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._server = None

    async def start(self) -> int:
        self._server, self._port = await httpd.serve_http(
            self._host, self._port, self._dispatch
        )
        return self._port

    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    async def stop(self) -> bool:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        return True

    # -- routing ------------------------------------------------------
    async def _ctl(self, method: str, payload: Optional[Dict] = None):
        from ray_tpu_torch.core.runtime import get_runtime

        return await get_runtime().controller.call(method, payload)

    async def _dispatch(self, req: Request) -> Tuple[int, str, bytes]:
        path = req.path.rstrip("/") or "/"
        if path == "/":
            return 200, "text/html; charset=utf-8", _load_spa().encode()
        if path == "/api/cluster_status":
            nodes = await self._ctl("get_nodes")
            actors = await self._ctl("list_actors")
            auto = await self._ctl("get_autoscaler_state")
            # controller-side reduction with a TTL cache: no 50k-event
            # RPC per poll (the SPA hits this every 2 s)
            summary = await self._ctl("task_state_summary") or {}
            return httpd.json_response({
                "nodes_alive": sum(1 for n in nodes if n["alive"]),
                "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
                "pending_demands": auto["pending_demands"],
                "task_summary": summary,
            })
        if path == "/api/nodes":
            return httpd.json_response(await self._ctl("get_nodes"))
        if path == "/api/actors":
            return httpd.json_response(await self._ctl("list_actors"))
        if path == "/api/placement_groups":
            return httpd.json_response(await self._ctl("list_placement_groups"))
        if path == "/api/jobs" and req.method == "POST":
            # REST job submission (reference: `dashboard/modules/job/
            # job_head.py:329` POST /api/jobs/): body {entrypoint,
            # submission_id?, env?, working_dir?, metadata?}
            try:
                body = req.json()
                entrypoint = body["entrypoint"]
            except Exception as e:
                logger.debug("malformed job submission body: %s", e)
                return httpd.json_response(
                    {"error": "body must be JSON with 'entrypoint'"},
                    status=400,
                )
            loop = asyncio.get_running_loop()

            def _submit():
                from ray_tpu_torch.job import api as job_api

                return job_api.submit_job(
                    entrypoint,
                    submission_id=body.get("submission_id"),
                    env=body.get("env"),
                    working_dir=body.get("working_dir"),
                    metadata=body.get("metadata"),
                )

            try:
                job_id = await loop.run_in_executor(None, _submit)
            except ValueError as e:  # duplicate submission_id etc.
                return httpd.json_response({"error": str(e)}, status=400)
            return httpd.json_response(
                {"job_id": job_id, "submission_id": job_id}
            )
        if path.startswith("/api/jobs/"):
            parts = path.split("/")  # ['', 'api', 'jobs', <id>, (verb)]
            job_id = parts[3]
            verb = parts[4] if len(parts) > 4 else None
            loop = asyncio.get_running_loop()
            from ray_tpu_torch.job import api as job_api

            try:
                if verb is None and req.method == "GET":
                    info = await loop.run_in_executor(
                        None, job_api.get_job_info, job_id
                    )
                    return httpd.json_response(info)
                if verb == "logs" and req.method == "GET":
                    logs = await loop.run_in_executor(
                        None, job_api.get_job_logs, job_id
                    )
                    return 200, "text/plain; charset=utf-8", logs.encode()
                if verb == "stop" and req.method == "POST":
                    stopped = await loop.run_in_executor(
                        None, job_api.stop_job, job_id
                    )
                    return httpd.json_response({"stopped": bool(stopped)})
            except ValueError as e:  # unknown job id
                return httpd.json_response({"error": str(e)}, status=404)
            return httpd.json_response({"error": "unsupported"}, status=405)
        if path == "/api/jobs":
            jobs = await self._ctl("list_jobs") or []
            # submitted (supervised) jobs live in the KV
            keys = await self._ctl("kv_keys", {"prefix": "job:"}) or []
            from ray_tpu_torch.core.runtime import get_runtime

            rt_ = get_runtime()
            for key in keys:
                raw = await rt_.controller.call("kv_get", {"key": key})
                if raw:
                    jobs.append(json.loads(raw))
            return httpd.json_response(jobs)
        if path == "/api/workers":
            snap = await self._ctl("get_worker_snapshot")
            return httpd.json_response(snap or [])
        if path == "/api/memory":
            # object-ref memory debugging (reference: `ray memory` —
            # `_private/internal_api.py:34`): per-node reference tables
            # + store occupancy, aggregated over live nodes
            from ray_tpu_torch.core.runtime import get_runtime

            rt_ = get_runtime()
            tables = []
            for n in (await self._ctl("get_nodes")) or []:
                if not n.get("alive"):
                    continue
                try:
                    t = await rt_.noded.call("route_node", {
                        "node_id": n["node_id"],
                        "method": "memory_table",
                    }, timeout=20)
                except Exception as e:
                    # node died between listing and the call
                    logger.debug("memory_table from %s failed: %s",
                                 n["node_id"][:8], e)
                    continue
                if t:
                    tables.append(t)
            return httpd.json_response(tables)
        if path == "/api/profile":
            # on-demand worker stack profile (reference: py-spy via
            # `modules/reporter/profile_manager.py:78`)
            node_id = req.query_params.get("node_id")
            worker_id = req.query_params.get("worker_id")
            if not node_id or not worker_id:
                return httpd.json_response(
                    {"error": "node_id and worker_id query params required"},
                    status=400,
                )
            from ray_tpu_torch.core.runtime import get_runtime

            mode = req.query_params.get("mode", "stacks")
            duration = min(
                float(req.query_params.get("duration", "5")), 60.0
            )
            reply = await get_runtime().noded.call(
                "route_node",
                {"node_id": node_id, "method": "profile_worker",
                 "payload": {
                     "worker_id": worker_id,
                     "native": req.query_params.get("native") == "1",
                     "mode": mode,
                     "duration_s": duration,
                 }},
                timeout=duration + 40,
            )
            if mode == "flamegraph" and isinstance(reply, dict) \
                    and "stacks" in reply:
                # folded stacks as plain text: paste straight into
                # speedscope / flamegraph.pl
                return (200, "text/plain; charset=utf-8",
                        str(reply["stacks"]).encode())
            return httpd.json_response(reply)
        if path == "/api/tasks":
            limit = int(req.query_params.get("limit", "100"))
            events = await self._ctl("list_task_events", {"limit": limit})
            return httpd.json_response(events)
        if path == "/api/cluster_events":
            # structured event log (reference: `dashboard/modules/event/`)
            events = await self._ctl("list_cluster_events", {
                "limit": int(req.query_params.get("limit", "200")),
                "severity": req.query_params.get("severity"),
                "event_type": req.query_params.get("event_type"),
            })
            return httpd.json_response(events or [])
        if path == "/api/grafana_dashboard":
            from ray_tpu_torch.dashboard.grafana import default_dashboard

            return httpd.json_response(default_dashboard())
        if path == "/api/timeline":
            # whole-run merged timeline (dashboard/timeline.py): task
            # events + collected spans in one Chrome-trace document,
            # with honest truncation flags.  ?trace_id= narrows the
            # span set to one logical request's lineage.
            from ray_tpu_torch.dashboard.timeline import build_chrome_trace

            limit = int(req.query_params.get("limit", "50000"))
            data = await self._ctl("timeline_data", {
                "trace_id": req.query_params.get("trace_id"),
                "limit_events": limit,
                "limit_spans": limit,
            }) or {}
            return httpd.json_response(build_chrome_trace(
                data.get("events", []),
                data.get("spans", []),
                events_truncated=data.get("events_truncated", False),
                spans_truncated=data.get("spans_truncated", False),
            ))
        if path == "/api/serve":
            try:
                from ray_tpu_torch.serve.api import _get_controller_async
                from ray_tpu_torch.core.runtime import get_runtime

                controller = await _get_controller_async()
                ref = controller.get_serve_status.remote()
                status = await get_runtime()._get_one(ref)
                return httpd.json_response(status)
            except Exception as e:
                # no serve controller deployed yet: an empty status is
                # the correct answer, not an error page
                logger.debug("serve status unavailable: %s", e)
                return httpd.json_response({})
        if path == "/api/slo":
            # per-deployment SLO burn rates (serve/slo.py): configured
            # targets + multi-window burn rates + ok verdict, folded
            # by the controller from the replicas' ledger counters
            try:
                from ray_tpu_torch.serve.api import _get_controller_async
                from ray_tpu_torch.core.runtime import get_runtime

                controller = await _get_controller_async()
                ref = controller.get_slo_status.remote()
                status = await get_runtime()._get_one(ref)
                return httpd.json_response(status)
            except Exception as e:
                logger.debug("slo status unavailable: %s", e)
                return httpd.json_response({})
        if path == "/api/serve/applications":
            # REST deploy (reference: `dashboard/modules/serve/` REST API
            # + `serve/schema.py` app config): PUT deploys an app whose
            # bound graph is named by import_path "module:variable"
            if req.method == "PUT":
                body = req.json()
                loop = asyncio.get_running_loop()

                def _deploy():
                    from ray_tpu_torch.serve import schema as serve_schema

                    # reference-shaped multi-app document
                    # (`serve/schema.py` ServeDeploySchema) or the
                    # single-app shorthand {import_path, name, ...}
                    doc = (
                        body if "applications" in body
                        else {"applications": [body]}
                    )
                    return serve_schema.deploy_from_schema(doc)

                try:
                    deployed = await loop.run_in_executor(None, _deploy)
                except Exception as e:  # validation errors -> 400
                    return httpd.json_response(
                        {"error": str(e)}, status=400
                    )
                return httpd.json_response(
                    {"ok": True, "applications": deployed}
                )
            return httpd.json_response(
                {"error": "use PUT with a ServeDeploySchema document "
                          "{applications: [{import_path, name, ...}]}"},
                status=405,
            )
        if path.startswith("/api/serve/applications/") and req.method == "DELETE":
            name = path.rsplit("/", 1)[1]
            loop = asyncio.get_running_loop()

            def _delete():
                from ray_tpu_torch import serve

                serve.delete(name)

            await loop.run_in_executor(None, _delete)
            return httpd.json_response({"ok": True})
        if path == "/api/logs":
            # session log browser (reference: `dashboard/modules/log/`);
            # filesystem walks/reads run off the loop like every other
            # blocking handler here
            loop = asyncio.get_running_loop()
            file = req.query_params.get("file")
            if file:
                def _tail():
                    import os

                    base = os.environ.get("RTT_TMPDIR", os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
                    # constrain to the session tree — no path escapes
                    full = os.path.realpath(os.path.join(base, file))
                    if not full.startswith(os.path.realpath(base) + os.sep):
                        return None
                    try:
                        with open(full, "rb") as f:
                            f.seek(0, os.SEEK_END)
                            size = f.tell()
                            f.seek(max(0, size - 64 * 1024))
                            return f.read()
                    except OSError:
                        return None

                data = await loop.run_in_executor(None, _tail)
                if data is None:
                    return 404, "text/plain", b"not found"
                return 200, "text/plain; charset=utf-8", data

            def _list():
                import glob
                import os

                base = os.environ.get("RTT_TMPDIR", os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
                return sorted(
                    os.path.relpath(p, base)
                    for p in glob.glob(base + "/**/*", recursive=True)
                    if os.path.isfile(p)
                    and (p.endswith(".out") or p.endswith(".log"))
                )

            return httpd.json_response(
                await loop.run_in_executor(None, _list)
            )
        if path == "/metrics":
            from ray_tpu_torch.metrics.registry import render_exposition, snapshot

            # refresh the built-in cluster gauges at scrape time so the
            # Prometheus view (and the generated Grafana dashboard)
            # reflects controller state without a push pipeline
            try:
                from ray_tpu_torch.dashboard.grafana import update_builtin_metrics

                await update_builtin_metrics(self._ctl)
            except Exception as e:
                logger.debug("builtin gauge refresh failed: %s", e)
            # one scrape serves the whole cluster: this process's
            # registry (builtin gauges, serve bridge) merged with the
            # controller sink's collected per-process snapshots, every
            # sample origin-tagged node/proc so series stay distinct.
            # The sink also holds THIS process's reporter (the obs
            # frame loop ships it) — filter that copy out, or every
            # local series would export twice and double any
            # sum()/rate() aggregation over it
            import os as _os

            from ray_tpu_torch.core.runtime import get_runtime

            rt_ = get_runtime()
            me = {"node": (rt_.node_id or "")[:8],
                  "proc": f"{rt_.mode}:{_os.getpid()}"}
            merged = snapshot(extra_tags=me)
            try:
                cluster = await self._ctl("cluster_metrics", {}) or {}
                for m in cluster.get("metrics", []):
                    samples = [
                        s for s in m.get("samples", ())
                        if not ((s[0] or {}).get("proc") == me["proc"]
                                and (s[0] or {}).get("node") == me["node"])
                    ]
                    if samples:
                        merged.append({**m, "samples": samples})
            except Exception as e:
                # local exposition still serves (degraded, not down)
                logger.debug("cluster metrics fetch failed: %s", e)
            return (200, "text/plain; version=0.0.4",
                    render_exposition(merged).encode())
        return 404, "text/plain", b"not found"


def start_dashboard(host: str = "127.0.0.1", port: int = 0):
    """Launch the dashboard actor; returns (handle, (host, port))."""
    import ray_tpu_torch as rt

    head = (
        rt.remote(DashboardHead)
        .options(name="DASHBOARD_HEAD", max_concurrency=8, num_cpus=0)
        .remote(host, port)
    )
    bound = rt.get(head.start.remote())
    return head, (host, bound)
