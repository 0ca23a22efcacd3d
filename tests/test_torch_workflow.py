"""The port's durable workflows (`ray_tpu_torch.workflow`) on the CPU:
the JAX package's `tests/test_workflow.py` on the port's runtime, one
DAG of numpy steps through both packages with equal outputs and step
metadata, the port's own storage root, and a step's host tensor read
back by a process that never booted the runtime.

One module-scoped cluster of the port's runtime serves every case; the
parity case also starts the JAX package's runtime (`rt_start`) beside
it.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from test_torch_waits import within

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    yield
    rt.shutdown()


@pytest.fixture()
def wf_storage(cluster, tmp_path):
    workflow.init_storage(str(tmp_path / "wf"))
    yield str(tmp_path / "wf")


def test_run_dag_and_output(wf_storage):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def mul(a, b):
        return a * b

    dag = mul.bind(add.bind(1, 2), add.bind(3, 4))
    out = within(60.0, lambda: workflow.run(dag, workflow_id="w1"))
    assert out == 21
    assert workflow.get_status("w1") == workflow.WorkflowStatus.SUCCESSFUL
    assert workflow.get_output("w1") == 21
    assert ("w1", "SUCCESSFUL") in workflow.list_all()


def test_failure_then_resume_skips_completed(wf_storage, tmp_path):
    marker = str(tmp_path / "count.txt")
    flag = str(tmp_path / "fail.flag")
    with open(flag, "w") as f:
        f.write("1")

    @rt.remote
    def counted(x, marker_path):
        # side-effect counter proves how many times this task ran
        n = 0
        if os.path.exists(marker_path):
            with open(marker_path) as f:
                n = int(f.read())
        with open(marker_path, "w") as f:
            f.write(str(n + 1))
        return x * 2

    @rt.remote
    def flaky(x, flag_path):
        if os.path.exists(flag_path):
            raise RuntimeError("injected failure")
        return x + 1

    dag = flaky.bind(counted.bind(10, marker), flag)
    with pytest.raises(Exception, match="injected failure"):
        within(60.0, lambda: workflow.run(dag, workflow_id="w2"))
    assert workflow.get_status("w2") == workflow.WorkflowStatus.FAILED
    with open(marker) as f:
        assert f.read() == "1"  # counted ran once

    os.remove(flag)  # clear the failure condition
    out = within(60.0, lambda: workflow.resume("w2"))
    assert out == 21
    with open(marker) as f:
        assert f.read() == "1"  # counted was NOT re-run on resume
    assert workflow.get_status("w2") == workflow.WorkflowStatus.SUCCESSFUL


def test_resume_completed_returns_output(wf_storage):
    @rt.remote
    def one():
        return 1

    within(60.0, lambda: workflow.run(one.bind(), workflow_id="w3"))
    assert workflow.resume("w3") == 1


def test_delete(wf_storage):
    @rt.remote
    def one():
        return 1

    within(60.0, lambda: workflow.run(one.bind(), workflow_id="w4"))
    workflow.delete("w4")
    with pytest.raises(ValueError):
        workflow.get_status("w4")


def test_continuation_extends_dag(wf_storage):
    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def plan(x):
        # dynamically extend: the task's result IS a new sub-DAG
        return workflow.continuation(double.bind(double.bind(x)))

    assert within(60.0, lambda: workflow.run(plan.bind(5),
                                             workflow_id="wc1")) == 20
    assert workflow.get_status("wc1") == workflow.WorkflowStatus.SUCCESSFUL
    # the continuation DAG was durably persisted
    meta = workflow.get_metadata("wc1")
    assert any(s.get("continuation") for s in meta["steps"].values())


def test_nested_continuations(wf_storage):
    @rt.remote
    def add1(x):
        return x + 1

    @rt.remote
    def inner(x):
        return workflow.continuation(add1.bind(x))

    @rt.remote
    def outer(x):
        return workflow.continuation(inner.bind(x))

    assert within(60.0, lambda: workflow.run(outer.bind(10),
                                             workflow_id="wc2")) == 11


def test_continuation_survives_kill_restart(wf_storage, tmp_path):
    """A workflow killed mid-continuation resumes from storage: the
    producing task is not re-run (its continuation was persisted
    first), and only the unfinished continuation tasks execute."""
    store = wf_storage
    marker = str(tmp_path / "ran_marker")
    block = str(tmp_path / "block")
    driver = textwrap.dedent(f"""
        import os, time
        import ray_tpu_torch as rt
        from ray_tpu_torch import workflow

        rt.init(num_workers=2, num_cpus=4)
        workflow.init_storage({store!r})

        @rt.remote
        def plan(x):
            with open({marker!r}, "a") as f:
                f.write("plan\\n")
            return workflow.continuation(slow_add.bind(x))

        @rt.remote
        def slow_add(x):
            # the first run blocks (the driver is killed here)
            while not os.path.exists({block!r}):
                time.sleep(0.1)
            return x + 1

        workflow.run(plan.bind(41), workflow_id="wkill")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.Popen([sys.executable, "-c", driver], env=env)
    try:
        deadline = time.time() + 60
        cont_seen = False
        while time.time() < deadline and not cont_seen:
            for _root, _dirs, files in os.walk(os.path.join(store, "wkill")):
                if any(f.endswith(".cont.pkl") for f in files):
                    cont_seen = True
            time.sleep(0.2)
        assert cont_seen, "continuation never persisted"
    finally:
        p.kill()
        p.wait(timeout=30)
    assert workflow.get_status("wkill") == workflow.WorkflowStatus.RESUMABLE
    with open(block, "w") as f:
        f.write("go")  # unblock the continuation task for the resume
    assert within(60.0, lambda: workflow.resume("wkill")) == 42
    # the producing task ran exactly once
    with open(marker) as f:
        assert f.read().count("plan") == 1


def test_wait_for_event_blocks_then_delivers(wf_storage):
    @rt.remote
    def combine(payload, y):
        return (payload, y)

    @rt.remote
    def seven():
        return 7

    dag = combine.bind(workflow.wait_for_event("go", timeout_s=60),
                       seven.bind())

    def deliver():
        time.sleep(0.5)
        workflow.send_event("wev1", "go", {"user": "alice"})

    t = threading.Thread(target=deliver, daemon=True)
    t.start()
    out = within(90.0, lambda: workflow.run(dag, workflow_id="wev1"))
    assert out == ({"user": "alice"}, 7)
    t.join(timeout=10)


def test_event_is_durable_across_resume(wf_storage):
    @rt.remote
    def identity(x):
        return x

    dag = identity.bind(workflow.wait_for_event("sig", timeout_s=0.2))
    with pytest.raises(Exception):
        within(60.0, lambda: workflow.run(dag, workflow_id="wev2"))
    workflow.send_event("wev2", "sig", 99)
    # the event persisted in storage
    assert within(60.0, lambda: workflow.resume("wev2")) == 99


def test_step_metadata_recorded(wf_storage):
    @rt.remote
    def a():
        return 1

    @rt.remote
    def b(x):
        return x + 1

    within(60.0, lambda: workflow.run(b.bind(a.bind()), workflow_id="wmeta"))
    meta = workflow.get_metadata("wmeta")
    assert meta["status"] == workflow.WorkflowStatus.SUCCESSFUL
    assert len(meta["steps"]) == 2
    for step in meta["steps"].values():
        assert step["status"] == "SUCCESSFUL"
        assert step["end_ts"] >= step["start_ts"]
        assert step["kind"] == "task"


# ----------------------------------------------------------------------
# the port against the JAX package, its storage root, host tensors
# ----------------------------------------------------------------------
def test_numpy_dag_matches_the_jax_package(wf_storage, rt_start, tmp_path):
    """The same DAG of numpy steps (a seeded batch, a projection, a
    reduction that fails once, then resume) through both packages'
    `workflow.run`: equal outputs, equal step keys, equal metadata
    fields and statuses, and on resume only the failed step reruns in
    each."""
    import ray_tpu as jrt
    from ray_tpu import workflow as jwf

    def build(mod, flag, log):
        @mod.remote
        def make_batch(seed):
            with open(log, "a") as f:
                f.write("make_batch\n")
            return np.random.default_rng(seed).standard_normal(
                (8, 16)).astype(np.float32)

        @mod.remote
        def project(x, seed):
            w = np.random.default_rng(seed + 1).standard_normal(
                (16, 4)).astype(np.float32)
            return x @ w

        @mod.remote
        def report(y, flag_path):
            if os.path.exists(flag_path):
                raise RuntimeError("injected failure")
            return {"sum": float(y.sum()), "rows": y.shape[0],
                    "y": y}

        return report.bind(project.bind(make_batch.bind(3), 3), flag)

    outs, metas, logs = {}, {}, {}
    for name, mod, wf in (("jax", jrt, jwf), ("port", rt, workflow)):
        wf.init_storage(str(tmp_path / name / "wf"))
        flag = tmp_path / name / "fail.flag"
        flag.write_text("1")
        log = str(tmp_path / name / "log.txt")
        dag = build(mod, str(flag), log)
        with pytest.raises(Exception, match="injected failure"):
            within(60.0, lambda: wf.run(dag, workflow_id="par"))
        assert wf.get_status("par") == "FAILED"
        flag.unlink()
        outs[name] = within(60.0, lambda: wf.resume("par"))
        metas[name] = wf.get_metadata("par")
        logs[name] = Path(log).read_text()
    assert outs["jax"]["sum"] == outs["port"]["sum"]
    assert outs["jax"]["rows"] == outs["port"]["rows"]
    np.testing.assert_array_equal(outs["jax"]["y"], outs["port"]["y"])
    mj, mp = metas["jax"], metas["port"]
    assert (mj["status"], mj["error"]) == (mp["status"], mp["error"])
    assert sorted(mj["steps"]) == sorted(mp["steps"])
    for key in mj["steps"]:
        sj, sp = mj["steps"][key], mp["steps"][key]
        assert sorted(sj) == sorted(sp), key
        for field in ("name", "kind", "status"):
            assert sj[field] == sp[field], (key, field)
    assert logs["jax"] == logs["port"] == "make_batch\n"


def test_storage_root_is_not_the_jax_packages(monkeypatch, tmp_path):
    """The port reads `RTT_WORKFLOW_STORAGE`, else `workflows/` under its
    session base; the JAX package's variable and directory never reach
    it, and the two defaults differ."""
    from ray_tpu.workflow import api as japi
    from ray_tpu_torch.workflow import api as tapi

    for var in ("RAY_TPU_WORKFLOW_STORAGE", "RTT_WORKFLOW_STORAGE",
                "RTT_TMPDIR", "RT_TMPDIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tapi, "_storage_dir", None)
    monkeypatch.setattr(japi, "_storage_dir", None)
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    port_default = tapi._store()
    assert port_default == str(tmp_path / "ray_tpu_torch" / "workflows")
    jax_default = japi._store()
    assert jax_default == "/tmp/ray_tpu/workflows"
    assert port_default != jax_default

    # the JAX package's variable is ignored; the port's own is read
    monkeypatch.setattr(tapi, "_storage_dir", None)
    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", str(tmp_path / "jax"))
    assert tapi._store() == port_default
    monkeypatch.setattr(tapi, "_storage_dir", None)
    monkeypatch.setenv("RTT_WORKFLOW_STORAGE", str(tmp_path / "port"))
    assert tapi._store() == str(tmp_path / "port")
    # and RTT_TMPDIR moves the default with the session base
    monkeypatch.delenv("RTT_WORKFLOW_STORAGE")
    monkeypatch.setattr(tapi, "_storage_dir", None)
    monkeypatch.setenv("RTT_TMPDIR", str(tmp_path / "base"))
    assert tapi._store() == str(tmp_path / "base" / "workflows")


def test_host_tensor_output_loads_in_a_fresh_cpu_process(wf_storage):
    """A step returning a host tensor: `get_output` in a new process
    that never boots the runtime and sees no card loads it equal."""

    @rt.remote
    def make(seed):
        import torch as _torch

        g = _torch.Generator().manual_seed(seed)
        return {"w": _torch.randn(4, 8, generator=g), "step": 3}

    got = within(60.0, lambda: workflow.run(make.bind(5), workflow_id="wt"))
    want = torch.randn(4, 8, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got["w"], want) and got["w"].device.type == "cpu"
    code = textwrap.dedent(f"""
        import json
        import torch
        from ray_tpu_torch import workflow
        workflow.init_storage({wf_storage!r})
        out = workflow.get_output("wt")
        assert not torch.cuda.is_available()
        assert out["w"].device.type == "cpu", out["w"].device
        assert out["step"] == 3
        print(json.dumps(out["w"].flatten().tolist()))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == want.flatten().tolist()
