"""The port's dashboard (`ray_tpu_torch.dashboard`) on the CPU: the JAX
package's `tests/test_dashboard.py` over real HTTP against the port's
dashboard actor, the SPA's JS syntax gate on the port's `app.html`
(the port's own `lint.jscheck`), and
`tests/test_events.py::test_grafana_dashboard_generation` on the port.

One module-scoped cluster of the port's runtime and one dashboard
serve every case.  The tasks and deployments the cases run are defined
inside them.
"""

import json
import logging
import os
import sys
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.dashboard import start_dashboard
from test_torch_waits import within

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dash():
    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    head, (host, port) = start_dashboard()
    yield f"http://{host}:{port}"
    try:
        rt.get(head.stop.remote(), timeout=5)
        rt.kill(head)
    except Exception as e:  # the runtime's shutdown below reaps it
        logging.getLogger(__name__).debug("dashboard teardown: %s", e)
    rt.shutdown()


def _get(url, timeout=15):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_index_and_status(dash):
    status, body = _get(dash + "/")
    assert status == 200 and b"ray_tpu_torch dashboard" in body
    status, body = _get(dash + "/api/cluster_status")
    payload = json.loads(body)
    assert payload["nodes_alive"] >= 1


def test_api_endpoints(dash):
    @rt.remote
    def noop(x):
        return x

    rt.get([noop.remote(i) for i in range(3)], timeout=60)

    status, body = _get(dash + "/api/nodes")
    assert status == 200 and json.loads(body)[0]["alive"]

    deadline = time.time() + 10
    while time.time() < deadline:
        _, body = _get(dash + "/api/tasks?limit=1000")
        if any(e["name"] == "noop" for e in json.loads(body)):
            break
        time.sleep(0.3)
    assert any(e["name"] == "noop" for e in json.loads(body))

    status, body = _get(dash + "/api/timeline")
    assert status == 200
    doc = json.loads(body)
    # object format: merged trace document with honest truncation flags
    assert isinstance(doc["traceEvents"], list)
    assert doc["truncated"] is False  # tiny run: nothing clipped

    status, body = _get(dash + "/metrics")
    assert status == 200

    status, _ = _get(dash + "/api/placement_groups")
    assert status == 200


def test_jobs_endpoint_includes_submitted(dash):
    from ray_tpu_torch import job

    jid = job.submit_job(f"{sys.executable} -c \"print('dash job')\"")
    job.wait_job(jid, timeout=60)
    _, body = _get(dash + "/api/jobs")
    jobs = json.loads(body)
    assert any(j.get("job_id") == jid for j in jobs)


def test_404(dash):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(dash + "/nope")
    assert e.value.code == 404


def test_serve_rest_deploy(dash, tmp_path):
    # an importable module holding a bound application
    mod_dir = str(tmp_path)
    with open(f"{mod_dir}/rest_app_mod_torch.py", "w") as f:
        f.write(
            "from ray_tpu_torch import serve\n"
            "@serve.deployment\n"
            "class Hello:\n"
            "    def __call__(self, request):\n"
            "        return {'hello': request.query_params.get('who', 'x')}\n"
            "app = Hello.bind()\n"
        )
    sys.path.insert(0, mod_dir)
    from ray_tpu_torch import serve

    try:
        req = urllib.request.Request(
            dash + "/api/serve/applications",
            data=json.dumps({
                "import_path": "rest_app_mod_torch:app",
                "import_dirs": [mod_dir],
                "name": "restapp",
                "route_prefix": "/rest",
            }).encode(),
            method="PUT",
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["ok"]
        host, port = serve.http_address()
        status, body = _get(f"http://{host}:{port}/rest?who=world")
        assert json.loads(body) == {"hello": "world"}
        # status visible over REST
        _, body = _get(dash + "/api/serve")
        assert "restapp" in json.loads(body)
        # DELETE removes it
        dreq = urllib.request.Request(
            dash + "/api/serve/applications/restapp", method="DELETE")
        with urllib.request.urlopen(dreq, timeout=60) as r:
            assert json.loads(r.read())["ok"]
    finally:
        serve.shutdown()
        sys.path.remove(mod_dir)


def test_logs_endpoint(dash):
    """The session log browser serves this session's `noded.out`, under
    the port's own session base, once the daemon wrote its boot line."""
    from ray_tpu_torch.api import _session

    session_dir = _session.get("session_dir")
    assert session_dir, "dash fixture owns its cluster"
    base = os.environ.get("RTT_TMPDIR", os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch"))
    target = os.path.relpath(os.path.join(session_dir, "noded.out"), base)

    deadline = time.time() + 30
    files, body = [], b""
    while time.time() < deadline:
        _, listing = _get(dash + "/api/logs")
        files = json.loads(listing)
        if target in files:
            status, body = _get(
                dash + "/api/logs?file=" + urllib.parse.quote(target)
            )
            if status == 200 and b"noded" in body:
                break
        time.sleep(0.5)
    assert target in files, files[:5]
    assert b"noded" in body
    # traversal is rejected
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(dash + "/api/logs?file=../../etc/hostname")
    assert e.value.code == 404


def _workers(dash, seconds=15.0):
    """The reporter's worker snapshot, once it has warmed."""
    deadline = time.time() + seconds
    workers = []
    while time.time() < deadline:
        _, body = _get(dash + "/api/workers")
        workers = json.loads(body)
        if workers:
            break
        time.sleep(0.5)
    assert workers, "reporter snapshot never arrived"
    return workers


def test_worker_snapshot_and_profile(dash):
    """Per-node reporter cache and on-demand stack profiling."""
    w = _workers(dash)[0]
    assert {"worker_id", "pid", "node_id", "kind"} <= set(w)
    status, body = _get(
        dash + f"/api/profile?node_id={w['node_id']}"
        f"&worker_id={w['worker_id']}", timeout=60)
    prof = json.loads(body)
    assert status == 200 and "stacks" in prof, prof
    assert "thread" in prof["stacks"]
    assert prof["pid"] == w["pid"]


def test_state_list_workers_uses_snapshot(dash):
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.util import state

    deadline = time.time() + 10
    snap = None
    while time.time() < deadline:
        snap = get_runtime().controller_call("get_worker_snapshot")
        if snap:
            break
        time.sleep(0.5)
    assert snap, "controller never cached a worker snapshot"
    listed = state.list_workers()
    assert len(listed) >= len([w for w in snap if w["kind"] == "worker"])


def test_profile_flamegraph_and_memory(dash):
    """Sampled CPU flamegraph (folded stacks) and a tracemalloc heap
    window of the worker running a hot loop: the task worker the
    reporter's snapshot shows busy (no actor) while the loop runs is the
    one profiled."""

    @rt.remote
    def busy(sec):
        import time as _t

        end = _t.time() + sec
        acc = 0
        while _t.time() < end:
            acc += sum(range(200))
        return acc

    budget = 12.0
    ref = busy.remote(budget)
    deadline = time.time() + budget / 2
    target = None
    while target is None:
        assert time.time() < deadline, "no worker ever showed busy"
        _, body = _get(dash + "/api/workers")
        target = next((w for w in json.loads(body)
                       if w.get("kind") == "worker" and w.get("worker_id")
                       and not w.get("idle") and not w.get("actor_id")),
                      None)
        time.sleep(0.2)
    url = (dash + f"/api/profile?node_id={target['node_id']}"
           f"&worker_id={target['worker_id']}")
    with urllib.request.urlopen(f"{url}&mode=flamegraph&duration=1.5",
                                timeout=45) as r:
        folded = r.read().decode()
    lines = [ln for ln in folded.splitlines() if ln.strip()]
    hot = [ln for ln in lines if "busy" in ln]
    # folded-stack format: "frame;frame;... N" lines
    assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
    assert any(";" in ln for ln in lines)
    # the sampler caught the hot loop
    assert hot, lines[:5]
    with urllib.request.urlopen(f"{url}&mode=memory&duration=1",
                                timeout=45) as r:
        mem = json.loads(r.read())
    assert "stacks" in mem and mem["mode"] == "memory"
    rt.get(ref, timeout=budget + 30)


def test_spa_served_with_live_features(dash):
    """`/` serves the package's single-file SPA, not the inline
    fallback page: tables with state filters, the inline timeline
    renderer, sparklines, the log tail."""
    status, body = _get(dash + "/")
    assert status == 200
    page = body.decode()
    for marker in ("drawTimeline", "taskState", "sp-rate", "api/memory",
                   "loglist"):
        assert marker in page, f"SPA missing {marker}"
    assert page == (REPO / "ray_tpu_torch" / "dashboard"
                    / "app.html").read_text()


def test_cluster_status_includes_task_summary(dash):
    status, body = _get(dash + "/api/cluster_status")
    assert status == 200
    doc = json.loads(body)
    assert "task_summary" in doc and isinstance(doc["task_summary"], dict)


def test_timeline_endpoint_equals_timeline(dash):
    """`GET /api/timeline` and `ray_tpu_torch.timeline()` both come from
    `build_chrome_trace`: over a window with no new task events they
    give the same `traceEvents`."""

    @rt.remote
    def step(x):
        return x * 2

    rt.get([step.remote(i) for i in range(4)], timeout=60)

    def settled():
        deadline = time.time() + 20
        while time.time() < deadline:
            _, body = _get(dash + "/api/timeline")
            doc = json.loads(body)
            names = [e["name"] for e in doc["traceEvents"]
                     if e.get("cat") == "task" and e["ph"] == "X"]
            if names.count("step") >= 4 and doc["traceEvents"] == \
                    rt.timeline():
                return doc
            time.sleep(0.3)
        raise AssertionError("the timeline never settled")

    doc = within(60.0, settled)
    assert all(e["dur"] > 0 for e in doc["traceEvents"] if e["ph"] == "X")


# ----------------------------------------------------------------------
# the SPA's JS syntax gate and the generated Grafana dashboard
# ----------------------------------------------------------------------
def _app_html():
    return (REPO / "ray_tpu_torch" / "dashboard" / "app.html").read_text()


def test_spa_js_passes_syntax_gate():
    from ray_tpu_torch.lint.jscheck import check_js, extract_scripts

    scripts = extract_scripts(_app_html())
    assert scripts, "app.html lost its inline <script> block"
    for start_line, src in scripts:
        errs = check_js(src)
        assert not errs, (
            f"<script> at app.html:{start_line} has syntax errors "
            f"(line numbers are script-relative): {errs}"
        )


def test_js_gate_catches_typo_classes():
    """The gate fails on the breakage it exists for."""
    from ray_tpu_torch.lint.jscheck import check_js, extract_scripts

    _start, src = extract_scripts(_app_html())[0]
    for mutation, expect in [
        (src + "\nfunction broken() { if (x) {\n", "unclosed"),
        (src + "\nconst t = `oops ${1+2;\n", "unclosed"),
        (src + "\nconst s = 'unterminated;\nlet x = 1;", "unterminated"),
        (src.replace("{", "[", 1), "mismatched"),
    ]:
        errs = check_js(mutation)
        assert errs and any(expect in e for e in errs), (expect, errs[:3])


def test_grafana_dashboard_generation(tmp_path):
    from ray_tpu_torch.dashboard import grafana

    doc = grafana.default_dashboard()
    assert doc["panels"], "dashboard must have panels"
    ids = [p["id"] for p in doc["panels"]]
    assert len(ids) == len(set(ids))
    for p in doc["panels"]:
        assert p["targets"], f"panel {p['title']} has no queries"
        for t in p["targets"]:
            assert t["expr"].strip()
    # the written file is valid importable JSON
    [path] = grafana.write_dashboards(str(tmp_path))
    with open(path) as f:
        loaded = json.load(f)
    assert loaded["uid"] == doc["uid"]


def test_grafana_speaks_of_the_card():
    """The port's one panel text change: the kernel-rate panel speaks of
    the card; every other panel is the JAX package's after the copies'
    namespace rewrite."""
    from ray_tpu.dashboard import grafana as jg
    from ray_tpu_torch.dashboard import grafana as tg
    from test_torch_copies import rewrite

    jd = json.loads(rewrite(json.dumps(jg.default_dashboard())))
    td = tg.default_dashboard()
    assert len(jd["panels"]) == len(td["panels"])
    changed = [(j, t) for j, t in zip(jd["panels"], td["panels"]) if j != t]
    assert len(changed) == 1
    j, t = changed[0]
    assert "on TPU" in j["description"]
    assert "on the card" in t["description"] and "TPU" not in t["description"]
    assert {k: v for k, v in j.items() if k != "description"} == \
        {k: v for k, v in t.items() if k != "description"}
