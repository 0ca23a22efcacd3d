"""The port's runtime (`ray_tpu_torch.core`): tasks, actors, objects,
GPU isolation, and a namespace of its own beside the JAX package's
runtime.

One module-scoped cluster, booted with a 2-GPU override (`RTT_GPUS`),
serves the in-process tests; the namespace tests run in subprocesses so
the environment they plant never reaches this process.  Every blocking
call carries its own timeout.
"""

import asyncio
import json
import logging
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.core import accelerators, noded
from ray_tpu_torch.core.runtime import Runtime
from ray_tpu_torch.core.task_spec import Resources

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get("RTT_GPUS")
    os.environ["RTT_GPUS"] = "2"
    try:
        rt.init(num_workers=4, num_cpus=16, ignore_reinit_error=True)
    finally:
        if old is None:
            os.environ.pop("RTT_GPUS", None)
        else:
            os.environ["RTT_GPUS"] = old
    yield rt
    rt.shutdown()


@rt.remote
def _double(x):
    return 2 * x


@rt.remote
def _total(arr):
    return float(arr.sum())


@rt.remote
def _fail(msg):
    raise KeyError(msg)


@rt.remote
class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n


@rt.remote(num_gpus=1)
class _GpuHolder:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_tasks_actors_and_objects(cluster):
    refs = [_double.remote(i) for i in range(8)]
    ready, rest = rt.wait(refs, num_returns=8, timeout=60)
    assert len(ready) == 8 and not rest
    assert rt.get(refs, timeout=60) == [2 * i for i in range(8)]
    c = _Counter.remote(10)
    assert rt.get([c.add.remote(1), c.add.remote(2)], timeout=60) == [11, 13]
    assert rt.get(rt.put({"a": [1, 2]}), timeout=60) == {"a": [1, 2]}
    rt.kill(c)


def test_large_object_goes_through_shm(cluster):
    """An 8 MB array is stored out of band in the shared-memory store
    and read back bit-equal, in the driver and in a task."""
    arr = np.random.default_rng(0).standard_normal(1 << 20)
    ref = rt.put(arr)
    np.testing.assert_array_equal(rt.get(ref, timeout=60), arr)
    assert rt.get(_total.remote(ref), timeout=60) == pytest.approx(
        float(arr.sum()))


def test_task_error_keeps_its_type(cluster):
    """A task's exception comes back as a TaskError naming the cause's
    type and carrying the remote traceback."""
    with pytest.raises(exc.TaskError, match="missing-key") as info:
        rt.get(_fail.remote("missing-key"), timeout=60)
    assert info.value.cause_type == "KeyError"
    assert "raise KeyError(msg)" in info.value.remote_traceback


def test_gpu_actors_get_distinct_cards(cluster):
    """With 2 GPUs detected, two `num_gpus=1` actors are pinned to
    different cards through CUDA_VISIBLE_DEVICES; a third waits."""
    assert rt.cluster_resources().get("GPU") == 2.0
    a, b = _GpuHolder.remote(), _GpuHolder.remote()
    seen = rt.get([a.visible.remote(), b.visible.remote()], timeout=120)
    assert sorted(seen) == ["0", "1"], seen
    rt.kill(a)
    rt.kill(b)


def test_strict_pack_reserves_one_node(cluster):
    """A STRICT_PACK group reserves all its bundles on one node and
    gives them back when removed."""
    from ray_tpu_torch.util import (placement_group, placement_group_table,
                                    remove_placement_group)

    # an earlier test's killed actors give their CPUs back
    # asynchronously: wait until the count is back at the cluster's
    # total before taking it as the baseline
    total = rt.cluster_resources().get("CPU")
    deadline = time.monotonic() + 30
    while rt.available_resources().get("CPU") != total:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.05)
    before = rt.available_resources().get("CPU")
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    assert pg.ready(timeout=60)
    entry = next(e for e in placement_group_table()
                 if e["pg_id"] == pg.id.hex())
    assert len(set(entry["bundle_nodes"])) == 1
    remove_placement_group(pg)
    deadline = time.monotonic() + 30
    while rt.available_resources().get("CPU") != before:
        assert time.monotonic() < deadline
        time.sleep(0.05)


class _Node(types.SimpleNamespace):
    alive = True


def _plans(mgr_cls, nodes, bundles):
    from ray_tpu_torch.core.placement import PlacementGroupInfo

    ctrl = types.SimpleNamespace(
        nodes={n.node_id: n for n in nodes}, _mark_dirty=lambda: None)
    mgr = mgr_cls(ctrl)
    return {s: mgr._plan(PlacementGroupInfo(b"x", bundles, s))
            for s in ("PACK", "STRICT_PACK", "SPREAD", "STRICT_SPREAD")}


@pytest.mark.parametrize("seed", range(4))
def test_placement_plans_match_jax_on_unlabelled_nodes(seed):
    """On nodes with no slice label, each strategy places a seeded
    group where the JAX package's manager places it."""
    from ray_tpu.core.placement import PlacementGroupManager as JaxMgr
    from ray_tpu_torch.core.placement import PlacementGroupManager

    rng = np.random.default_rng(seed)
    nodes = [_Node(node_id=f"n{i}", labels={},
                   resources={"CPU": float(rng.integers(1, 5)),
                              "GPU": float(rng.integers(0, 3))})
             for i in range(int(rng.integers(1, 4)))]
    bundles = [{"CPU": 1.0, "GPU": float(rng.integers(0, 2))}
               for _ in range(int(rng.integers(1, 5)))]
    assert _plans(PlacementGroupManager, nodes, bundles) == \
        _plans(JaxMgr, nodes, bundles)


def test_strict_pack_ignores_tpu_slice_labels():
    """The port has no slice domain: STRICT_PACK of four 2-GPU bundles
    fits no 4-GPU host, so it stays unplaced where the JAX package packs
    it into one two-host `tpu-slice`; and `ray_tpu_torch.util` exports
    no slice-gang API."""
    from ray_tpu.core.placement import PlacementGroupManager as JaxMgr
    from ray_tpu_torch import util
    from ray_tpu_torch.core.placement import PlacementGroupManager

    nodes = [_Node(node_id=f"n{i}", labels={"tpu-slice": "s"},
                   resources={"CPU": 4.0, "GPU": 4.0}) for i in range(2)]
    bundles = [{"CPU": 1.0, "GPU": 2.0}] * 4
    assert _plans(PlacementGroupManager, nodes, bundles)["STRICT_PACK"] \
        is None
    assert _plans(JaxMgr, nodes, bundles)["STRICT_PACK"] == \
        ["n0", "n0", "n1", "n1"]
    assert not hasattr(util, "multislice_placement_groups")
    assert "multislice_placement_groups" not in util.__all__


def test_node_label_strategy_matches_jax():
    """Label expressions build the same hard / soft terms as the JAX
    package's."""
    from ray_tpu.util import scheduling_strategies as jss
    from ray_tpu_torch.util import scheduling_strategies as tss

    def build(m):
        return m.NodeLabelSchedulingStrategy(
            {"gpu-type": m.In("H100"), "zone": m.Exists()},
            soft={"region": m.NotIn("us-east1")})

    a, b = build(tss), build(jss)
    assert (a.hard, a.soft) == (b.hard, b.soft)


def test_gpu_resources_validate_like_chips():
    """`num_gpus` is Ray's "GPU" resource; whole requests must be
    integers, fractions below one share a card without isolation."""
    assert Resources.from_options({"num_gpus": 2}).as_dict() == {
        "CPU": 1.0, "GPU": 2}
    assert Resources.from_options(
        {"num_cpus": 0, "resources": {"GPU": 1.0}}).as_dict() == {"GPU": 1.0}
    assert Resources.from_options({"num_gpus": 0.5}).num_gpus == 0.5
    with pytest.raises(ValueError, match="whole number"):
        Resources.from_options({"num_gpus": 1.5})


def test_gpu_detection_prefers_the_drivers_count(monkeypatch):
    """NVML's count wins over device nodes, which overcount in a
    container (one visible H100 with /dev/nvidia0 and /dev/nvidia7);
    the nodes count where NVML is absent; the daemon's own
    CUDA_VISIBLE_DEVICES caps either."""
    monkeypatch.delenv("RTT_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    nodes = ["/dev/nvidia0", "/dev/nvidia7", "/dev/nvidiactl",
             "/dev/nvidia-uvm"]
    monkeypatch.setattr(accelerators.glob, "glob", lambda pat: nodes)
    monkeypatch.setattr(accelerators, "_nvml_count", lambda: 1)
    assert accelerators.detect_num_chips() == 1
    monkeypatch.setattr(accelerators, "_nvml_count", lambda: None)
    assert accelerators.detect_num_chips() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert accelerators.detect_num_chips() == 1


def test_gpu_detection_and_isolation_env(monkeypatch):
    monkeypatch.setenv("RTT_GPUS", "3")
    assert accelerators.detect_num_chips() == 3
    monkeypatch.setenv("RTT_GPUS", "3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6")
    # an override wins; the isolation env maps through the parent's list
    assert accelerators.detect_num_chips() == 3
    assert accelerators.chip_isolation_env([1], 2) == {
        "CUDA_VISIBLE_DEVICES": "6"}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert accelerators.chip_isolation_env([0, 1], 2) == {
        "CUDA_VISIBLE_DEVICES": "0,1"}
    pool = accelerators.ChipPool(2)
    assert pool.assign("w1", 1) == (0,) and pool.assign("w2", 1) == (1,)
    assert pool.assign("w3", 1) is None
    pool.release_worker("w1")
    assert pool.assign("w3", 1) == (0,)


def test_accel_env_warns_after_cuda_init(monkeypatch, caplog):
    """The lease-time env push warns when torch has already initialised
    CUDA in the worker (the new visibility cannot take effect), and
    stays quiet when it has not."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    fake = types.SimpleNamespace(
        cuda=types.SimpleNamespace(is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", fake)
    with caplog.at_level(logging.WARNING):
        out = asyncio.run(Runtime._h_set_accel_env(
            None, {"CUDA_VISIBLE_DEVICES": "1"}, None))
    assert out == {"ok": True}
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
    assert "after torch initialised CUDA" in caplog.text
    caplog.clear()
    fake.cuda.is_initialized = lambda: False
    with caplog.at_level(logging.WARNING):
        asyncio.run(Runtime._h_set_accel_env(
            None, {"CUDA_VISIBLE_DEVICES": ""}, None))
    assert "CUDA_VISIBLE_DEVICES" not in os.environ
    assert not caplog.text


def test_function_export_outrun_by_its_tasks_still_loads(cluster,
                                                         monkeypatch):
    """A function's blob reaches the controller's KV by a one-way put
    from the driver; delayed by 0.5 s, the put is overtaken by the
    function's later tasks (which carry only its id) on other workers.
    Each of 16 tasks of a fresh function still runs: an executor polls
    the KV for a bounded time before it reports the function missing."""
    from ray_tpu_torch.core.runtime import get_runtime

    ctrl = get_runtime().controller
    send = ctrl.send_threadsafe
    timers = []

    def delayed(method, *args, **kwargs):
        if method != "kv_put_oneway":
            return send(method, *args, **kwargs)
        t = threading.Timer(0.5, send, (method, *args), kwargs)
        timers.append(t)
        t.start()
        return None

    monkeypatch.setattr(ctrl, "send_threadsafe", delayed)

    @rt.remote
    def fresh(i):
        time.sleep(0.05)
        return i * i

    try:
        got = rt.get([fresh.remote(i) for i in range(16)], timeout=60)
    finally:
        for t in timers:
            t.join(timeout=5)
    assert timers, "the export did not go through the delayed put"
    assert got == [i * i for i in range(16)]


def test_dag_bind_names_the_roadmap(cluster):
    """The compiled-graph plane is ported (ROADMAP.md queue 1 item 5):
    `.bind()` on a remote function builds the port's own `FunctionNode`,
    which runs on the port's runtime, and reaches nothing of the JAX
    package."""
    from ray_tpu_torch.dag.dag_node import FunctionNode

    node = _double.bind(_double.bind(3))
    assert type(node) is FunctionNode
    assert type(node).__module__ == "ray_tpu_torch.dag.dag_node"
    assert node.execute() == 12


def _run(code: str, env_extra: dict, tmp_path: Path) -> str:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env.update(env_extra)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def _sock_dir_for(session: str) -> str:
    """Where the daemon of `session` keeps its sockets: the session dir,
    unless AF_UNIX's limit sends them to a short dir of their own."""
    if len(session.encode()) + 1 + noded._SOCK_NAME_MAX <= noded._SUN_PATH_MAX:
        return session
    return "/tmp/rtt_sock_"


_INIT_AND_REPORT = """
    import json
    import ray_tpu_torch as rt
    from ray_tpu_torch import api
    info = rt.init(num_workers=1, num_cpus=2)
    try:
        @rt.remote
        def f():
            import os
            return os.environ.get("RTT_CONTROLLER")
        ctrl = rt.get(f.remote(), timeout=60)
        session = api._session["session_dir"]
    finally:
        rt.shutdown()
    print(json.dumps({"socket": info["socket_path"],
                      "shm": info["shm_name"], "ctrl": ctrl,
                      "session": session}))
"""


def test_port_cluster_ignores_the_jax_packages_env(tmp_path):
    """A driver whose env points at a JAX-package cluster (bogus
    RT_CONTROLLER / RT_NODE_SOCKET / RT_TMPDIR) boots the port's own
    cluster under `ray_tpu_torch` in the process's temp dir, with an
    `rtt_` store."""
    got = json.loads(_run(_INIT_AND_REPORT, {
        "RT_CONTROLLER": "127.0.0.1:1", "RT_NODE_SOCKET": "/nonexistent",
        "RT_TMPDIR": str(tmp_path / "jax_tmp")}, tmp_path))
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    assert got["session"].startswith(os.path.join(base, "session_"))
    assert got["socket"].startswith(_sock_dir_for(got["session"]))
    assert got["shm"].startswith("/rtt_session_")
    assert got["ctrl"] and got["ctrl"] != "127.0.0.1:1"
    assert not (tmp_path / "jax_tmp").exists()


def test_session_base_follows_tmpdir_past_the_socket_limit(tmp_path):
    """Under a TMPDIR too long for AF_UNIX socket paths in the session
    dir, the session still lives there and the sockets move to a short
    dir of their own, which shutdown removes."""
    tmp = tmp_path / ("d" * 80)
    tmp.mkdir()
    got = json.loads(_run(_INIT_AND_REPORT, {"TMPDIR": str(tmp)},
                          tmp_path))
    assert got["session"].startswith(str(tmp / "ray_tpu_torch" / "session_"))
    assert got["socket"].startswith("/tmp/rtt_sock_")
    assert len(got["socket"].encode()) <= noded._SUN_PATH_MAX
    assert got["ctrl"]
    assert not os.path.exists(os.path.dirname(got["socket"]))


def test_auto_joins_only_a_session_under_its_own_tmpdir(tmp_path):
    """`address="auto"` finds a live session under its own temp dir and
    never one that a process with another TMPDIR started."""
    mine, other = tmp_path / "a", tmp_path / "b"
    mine.mkdir()
    other.mkdir()
    join = """
        import json
        import ray_tpu_torch as rt
        try:
            rt.init(address="auto")
        except Exception as e:
            print(json.dumps({"joined": False, "err": type(e).__name__}))
        else:
            try:
                @rt.remote
                def f(x):
                    return x * 3
                out = rt.get(f.remote(2), timeout=60)
            finally:
                rt.shutdown()
            print(json.dumps({"joined": True, "out": out}))
    """
    out = _run(f"""
        import json, os, subprocess, sys, textwrap
        import ray_tpu_torch as rt
        rt.init(num_workers=1, num_cpus=2)
        try:
            res = {{}}
            for name, tmp in (("other", {str(other)!r}),
                              ("mine", {str(mine)!r})):
                env = dict(os.environ, TMPDIR=tmp)
                p = subprocess.run(
                    [sys.executable, "-c", textwrap.dedent({join!r})],
                    env=env, capture_output=True, text=True, timeout=90)
                res[name] = json.loads(p.stdout.strip().splitlines()[-1])
        finally:
            rt.shutdown()
        print(json.dumps(res))
    """, {"TMPDIR": str(mine)}, tmp_path)
    got = json.loads(out)
    assert got["other"]["joined"] is False, got
    assert got["mine"] == {"joined": True, "out": 6}, got
    assert list((mine / "ray_tpu_torch").glob("session_*"))
    assert not (other / "ray_tpu_torch").exists() or not list(
        (other / "ray_tpu_torch").glob("session_*"))


def test_both_runtimes_run_side_by_side(tmp_path):
    """One driver boots the JAX package's cluster and the port's: each
    keeps its session base and store prefix, and each runs its own
    tasks."""
    out = _run("""
        import json
        import ray_tpu
        import ray_tpu_torch
        a = ray_tpu.init(num_workers=1, num_cpus=2)
        b = ray_tpu_torch.init(num_workers=1, num_cpus=2)
        try:
            @ray_tpu.remote
            def fa(x):
                return x + 1

            @ray_tpu_torch.remote
            def fb(x):
                return x + 2

            res = [ray_tpu.get(fa.remote(1), timeout=60),
                   ray_tpu_torch.get(fb.remote(1), timeout=60)]
            session = ray_tpu_torch.api._session["session_dir"]
        finally:
            ray_tpu_torch.shutdown()
            ray_tpu.shutdown()
        print(json.dumps({"a": [a["socket_path"], a["shm_name"]],
                          "b": [b["socket_path"], b["shm_name"]],
                          "res": res, "session": session}))
    """, {}, tmp_path)
    got = json.loads(out)
    assert got["res"] == [2, 3]
    assert got["a"][0].startswith("/tmp/ray_tpu/session_")
    assert got["a"][1].startswith("/rt_session_")
    assert got["session"].startswith(os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "session_"))
    assert got["b"][0].startswith(_sock_dir_for(got["session"]))
    assert got["b"][1].startswith("/rtt_session_")


def test_port_sweep_leaves_the_jax_packages_segments(tmp_path):
    """The port's stale-segment sweep judges only `rtt_` names: a dead
    owner's `rt_` segment is the JAX package's to reap."""
    from ray_tpu_torch.shm import sweep_stale_segments

    dead = 2 ** 22 + 12345  # above pid_max's default: never alive
    (tmp_path / f"rt_session_x_0000.{dead}").write_bytes(b"")
    (tmp_path / f"rtt_session_x_0000.{dead}").write_bytes(b"")
    removed = sweep_stale_segments(shm_dir=str(tmp_path))
    assert [os.path.basename(r) for r in removed] == [
        f"rtt_session_x_0000.{dead}"]
    assert (tmp_path / f"rt_session_x_0000.{dead}").exists()
