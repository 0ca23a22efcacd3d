"""The port's command line (`python -m ray_tpu_torch.scripts.cli`) on the
CPU: the JAX package's `tests/test_state.py::test_cli_status` on a port
cluster, then the commands an operator runs against it (`list`,
`events`, `timeline`, `memory`, `job ...`, `grafana-dashboard`), each
in a fresh interpreter as from a shell, and `render_memory_table`
against the reference's on the same seeded tables (the counterpart of
`tests/test_memory_api.py`'s rendering check).

One module-scoped cluster of the port's runtime serves every case; the
tasks the cases run are defined inside them, so workers import nothing
of this module.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt
from test_torch_waits import within

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def address():
    rt.init(num_workers=2, num_cpus=4, num_gpus=0, ignore_reinit_error=True)
    import ray_tpu_torch.api as api

    yield os.path.join(api._session["session_dir"], "ready.json")
    rt.shutdown()


def cli(address, *args, timeout=120):
    """One CLI command in a fresh interpreter, as an operator runs it;
    returns its standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
         "--address", address, *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
    )
    assert proc.returncode == 0, (args, proc.stdout, proc.stderr[-3000:])
    return proc.stdout


def test_cli_status(address):
    payload = json.loads(cli(address, "status"))
    assert payload["nodes_alive"] >= 1
    assert payload["total_resources"]["CPU"] == 4.0


@pytest.mark.parametrize("what,key", [
    ("nodes", "node_id"), ("workers", "worker_id"), ("tasks", "task_id"),
    ("actors", None), ("jobs", None), ("placement-groups", None),
])
def test_cli_list(address, what, key):
    @rt.remote
    def listed(x):
        return x + 1

    assert rt.get(listed.remote(1), timeout=60) == 2
    rows = json.loads(cli(address, "list", what, "--limit", "50"))
    assert isinstance(rows, list)
    if key is not None:
        assert rows and all(key in r for r in rows), rows
    if what == "workers":
        assert {r["kind"] for r in rows} >= {"driver", "worker"}


def test_cli_events(address):
    events = json.loads(cli(address, "events", "--limit", "20"))
    assert any(e["event_type"] == "NODE_ADDED" for e in events), events
    info = json.loads(cli(address, "events", "--severity", "INFO"))
    assert info and all(e["severity"] == "INFO" for e in info)


def test_cli_timeline_holds_the_tasks(address, tmp_path):
    @rt.remote
    def on_the_timeline(x):
        return x * 2

    assert rt.get([on_the_timeline.remote(i) for i in range(3)],
                  timeout=60) == [0, 2, 4]
    out = tmp_path / "timeline.json"

    def settled():
        for _ in range(60):
            text = cli(address, "timeline", "--output", str(out))
            events = json.loads(out.read_text())
            done = [e for e in events if e.get("ph") == "X"
                    and e.get("name") == "on_the_timeline"]
            if len(done) >= 3:
                return text, events
        raise AssertionError("the tasks never reached the timeline")

    text, events = within(60, settled)
    assert text.startswith(f"wrote {len(events)} events to ")


def test_cli_memory_shows_the_drivers_object(address):
    big = rt.put(np.ones(3 << 20, dtype=np.uint8))
    tables = json.loads(cli(address, "memory", "--json"))
    rows = [r for node in tables for proc in node["processes"]
            if proc.get("mode") == "driver" for r in proc["refs"]]
    mine = [r for r in rows if r["object_id"] == big.hex()]
    assert mine and mine[0]["kind"] == "owned"
    assert mine[0]["size"] >= 3 << 20
    flat = json.loads(cli(address, "memory", "--json", "--kind", "owned",
                          "--min-size", str(1 << 20)))
    assert big.hex() in {r["object_id"] for r in flat}
    assert all(r["kind"] == "owned" and r["size"] >= 1 << 20 for r in flat)
    text = cli(address, "memory")
    assert big.hex()[:16] in text and "owned" in text and "store" in text
    del big


def test_cli_job_submit_status_logs_list(address):
    out = cli(address, "job", "submit", "--wait",
              f"{sys.executable} -c 'print(6 * 7)'").split()
    jid, status = out[0], out[-1]
    assert status == "SUCCEEDED"
    assert cli(address, "job", "status", jid).strip() == "SUCCEEDED"
    assert "42" in cli(address, "job", "logs", jid)
    assert "42" in cli(address, "job", "logs", "-f", jid)
    jobs = json.loads(cli(address, "job", "list"))
    assert jid in {j["job_id"] for j in jobs}


def test_cli_job_stop(address):
    jid = cli(address, "job", "submit",
              f"{sys.executable} -c 'import time; time.sleep(600)'").strip()
    cli(address, "job", "stop", jid)

    def stopped():
        for _ in range(60):
            status = cli(address, "job", "status", jid).strip()
            if status == "STOPPED":
                return status
        return status

    assert within(60, stopped) == "STOPPED"


def test_cli_grafana_dashboard_needs_no_cluster(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
         "grafana-dashboard", "--out", str(tmp_path / "dash")],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr
    paths = proc.stdout.split()
    assert paths and all(Path(p).is_file() for p in paths)
    for p in paths:
        assert json.loads(Path(p).read_text())["panels"]


def _seeded_tables(seed: int):
    """Per-node memory tables in `state.memory_summary()`'s shape."""
    rng = np.random.default_rng(seed)
    kinds = ("owned", "borrowed", "pending")
    tables = []
    for n in range(2):
        procs = []
        for p in range(int(rng.integers(1, 4))):
            refs = []
            for r in range(int(rng.integers(0, 6))):
                size = (None if rng.random() < 0.2
                        else int(rng.integers(0, 3 << 30)))
                refs.append({
                    "object_id": rng.bytes(14).hex(),
                    "kind": kinds[int(rng.integers(0, 3))],
                    "where": (None, "shm", "inline")[int(rng.integers(0, 3))],
                    "size": size,
                    "local": int(rng.integers(0, 4)),
                    "submitted": int(rng.integers(0, 3)),
                    "borrowers": int(rng.integers(0, 3)),
                    "contained": int(rng.integers(0, 2)),
                    "transit": int(rng.integers(0, 2)),
                    "lineage_pinned": bool(rng.random() < 0.5),
                    "callsite": (None if rng.random() < 0.3
                                 else f"driver.py:{int(rng.integers(1, 99))}"),
                })
            procs.append({"mode": ("driver", "worker")[p > 0],
                          "pid": int(rng.integers(100, 99999)),
                          "held_pins": int(rng.integers(0, 3)),
                          "refs": refs})
        tables.append({
            "node_id": rng.bytes(14).hex(),
            "store": {"used": int(rng.integers(0, 1 << 34)),
                      "capacity": int(rng.integers(1 << 34, 1 << 36))},
            "spilled": ["x"] * int(rng.integers(0, 3)),
            "processes": procs,
        })
    return tables


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind,min_size", [
    (None, 0), ("owned", 0), ("borrowed", 0), (None, 1 << 20),
])
def test_render_memory_table_matches_the_reference(seed, kind, min_size):
    from ray_tpu.scripts.cli import render_memory_table as ref_render
    from ray_tpu_torch.scripts.cli import render_memory_table

    tables = _seeded_tables(seed)
    text = render_memory_table(tables, kind=kind, min_size=min_size)
    assert text == ref_render(tables, kind=kind, min_size=min_size)
    assert text.count("\n  ") >= 2
    assert render_memory_table([]) == ref_render([]) == "(no nodes)"
