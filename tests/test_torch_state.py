"""The port's state API (`ray_tpu_torch.util.state`, `timeline()`) on the
CPU: the JAX package's `tests/test_state.py` on the port's runtime
(without `test_cli_status`, which waits for `scripts/cli.py`), and
`build_chrome_trace` of both packages on the same seeded events and
spans.

One module-scoped cluster of the port's runtime serves every case; the
tasks the cases run are defined inside them, so workers import nothing
of this module.
"""

import json
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import state
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, export_text


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    yield
    rt.shutdown()


def _traced():
    @rt.remote
    def traced_task(x):
        import time as _t

        _t.sleep(0.02)
        return x + 1

    return traced_task


def _wait_for_events(pred, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        events = state.list_tasks(limit=10_000)
        if pred(events):
            return events
        time.sleep(0.3)
    raise AssertionError("task events never appeared")


def test_task_events_and_summary(cluster):
    traced_task = _traced()
    refs = [traced_task.remote(i) for i in range(5)]
    assert rt.get(refs, timeout=60) == [i + 1 for i in range(5)]
    events = _wait_for_events(
        lambda evs: sum(
            1 for e in evs
            if e["name"] == "traced_task" and e["state"] == "FINISHED"
        ) >= 5
    )
    finished = [e for e in events if e["state"] == "FINISHED"
                and e["name"] == "traced_task"]
    assert all(e.get("duration", 0) > 0 for e in finished)
    summary = state.summarize_tasks()
    assert summary.get("FINISHED", 0) >= 5


def test_failed_task_event(cluster):
    @rt.remote
    def failing_task():
        raise ValueError("boom")

    ref = failing_task.remote()
    with pytest.raises(Exception, match="boom"):
        rt.get(ref, timeout=60)
    _wait_for_events(
        lambda evs: any(
            e["name"] == "failing_task" and e["state"] == "FAILED"
            for e in evs
        )
    )


def test_list_actors_nodes_jobs(cluster):
    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    assert rt.get(a.ping.remote(), timeout=60) == 1
    actors = state.list_actors()
    assert any(x["state"] == "ALIVE" for x in actors)
    nodes = state.list_nodes()
    assert sum(1 for n in nodes if n["alive"]) >= 1
    jobs = state.list_jobs()
    assert len(jobs) >= 1
    status = state.cluster_status()
    assert status["nodes_alive"] >= 1
    rt.kill(a)


def test_timeline_chrome_trace(cluster, tmp_path):
    traced_task = _traced()
    rt.get([traced_task.remote(i) for i in range(3)], timeout=60)
    _wait_for_events(
        lambda evs: sum(1 for e in evs if e["state"] == "FINISHED") >= 3
    )
    out = str(tmp_path / "trace.json")
    events = rt.timeline(out)
    assert len(events) >= 3
    with open(out) as f:
        loaded = json.load(f)
    ev = loaded[0]
    assert ev["ph"] == "X" and ev["dur"] > 0 and "name" in ev


def test_metrics_export():
    c = Counter("test_requests_total", "requests", ("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2, tags={"route": "/a"})
    g = Gauge("test_queue_len")
    g.set(7)
    h = Histogram("test_latency_s", boundaries=[0.1, 1.0])
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    text = export_text()
    assert 'test_requests_total{route="/a"} 3.0' in text
    assert "test_queue_len 7.0" in text
    assert 'test_latency_s_bucket{le="0.1"} 1.0' in text
    assert 'test_latency_s_bucket{le="+Inf"} 3.0' in text
    assert "test_latency_s_sum" in text


def test_list_workers_cluster_wide(cluster):
    """`list workers` covers every alive node."""
    ws = state.list_workers()
    assert ws and all("pid" in w and "node_id" in w for w in ws)
    assert any(w["kind"] == "worker" for w in ws)


def _watch_cycle(tag, report):
    got = []
    ready = threading.Event()

    def watcher():
        gen = state.watch_cluster_events(timeout=20)
        ready.set()
        for ev in gen:
            got.append(ev)
            if ev.get("event_type") == f"DONE_{tag}":
                return

    t = threading.Thread(target=watcher, daemon=True)
    t.start()
    assert ready.wait(10)
    time.sleep(0.3)  # let the subscribe RPC land before publishing
    report(f"PING_{tag}", "x")
    report(f"DONE_{tag}", "sentinel")
    t.join(timeout=30)
    assert not t.is_alive(), "watcher never saw the sentinel"
    return [e["event_type"] for e in got]


def test_watch_cluster_events_live_stream(cluster):
    """A subscriber sees events published after it subscribed, and the
    ring keeps them for late readers."""
    from ray_tpu_torch.util import events as ev_mod

    types = _watch_cycle("A", ev_mod.report_event)
    assert "PING_A" in types and types[-1] == "DONE_A"
    listed = state.list_cluster_events(event_type="PING_A")
    assert len(listed) == 1


def test_watch_cluster_events_no_duplicates_on_rewatch(cluster):
    """A second watch cycle does not double-deliver."""
    from ray_tpu_torch.util import events as ev_mod

    _watch_cycle("B", ev_mod.report_event)
    types = _watch_cycle("C", ev_mod.report_event)
    assert types.count("PING_C") == 1, types
    assert types.count("DONE_C") == 1, types


# ----------------------------------------------------------------------
# build_chrome_trace against the JAX package's
# ----------------------------------------------------------------------
def _seeded_events_and_spans(seed):
    rng = np.random.default_rng(seed)
    states = ("SUBMITTED", "RUNNING", "FINISHED", "FAILED")
    events, spans = [], []
    for i in range(40):
        tid = f"{rng.integers(0, 12):08x}" + "ab" * 8
        ev = {"task_id": tid, "name": f"task_{i % 5}",
              "state": states[int(rng.integers(0, 4))],
              "ts": 1000.0 + float(rng.uniform(0, 50)),
              "node_id": f"node{int(rng.integers(0, 3))}",
              "worker_id": f"w{int(rng.integers(0, 4))}"}
        if ev["state"] in ("FINISHED", "FAILED") and rng.uniform() < 0.8:
            ev["duration"] = float(rng.uniform(0.001, 2.0))
        if rng.uniform() < 0.1:
            del ev["worker_id"]
        events.append(ev)
    for i in range(25):
        start = 1000.0 + float(rng.uniform(0, 50))
        sp = {"name": f"span_{i % 4}", "start": start,
              "end": start + float(rng.uniform(0, 1e-6 if i % 7 == 0 else 1)),
              "trace_id": f"t{int(rng.integers(0, 3))}",
              "span_id": f"s{i}", "parent_id": f"s{i - 1}" if i else None,
              "kind": "internal", "node": "node0", "proc": f"p{i % 3}"}
        if i % 5 == 0:
            sp["error"] = "boom"
        if i % 3 == 0:
            sp["attrs"] = {"k": i}
        if i == 24:
            del sp["start"]
        spans.append(sp)
    return events, spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_matches_the_jax_package(seed):
    from ray_tpu.dashboard.timeline import build_chrome_trace as jbuild
    from ray_tpu_torch.dashboard.timeline import build_chrome_trace as tbuild

    events, spans = _seeded_events_and_spans(seed)
    for flags in ({}, {"events_truncated": True},
                  {"spans_truncated": True}):
        want = jbuild(events, spans, **flags)
        got = tbuild(events, spans, **flags)
        assert got == want
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)
    assert tbuild(events) == jbuild(events)


def test_package_exports_match_the_jax_packages():
    """`timeline` is exported, and with it the package's `__all__` is the
    JAX package's plus the port's own `resolve_device`; the operations
    plane's packages export what the reference's do."""
    import importlib

    import ray_tpu as jrt

    assert set(rt.__all__) ^ set(jrt.__all__) == {"resolve_device"}
    for sub in ("autoscaler", "dashboard", "job", "workflow", "util.state"):
        port = importlib.import_module(f"ray_tpu_torch.{sub}")
        ref = importlib.import_module(f"ray_tpu.{sub}")
        assert port.__all__ == ref.__all__, sub
