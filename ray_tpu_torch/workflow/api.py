"""Workflow public API + executor.

Reference surface: `ray.workflow.run/run_async/resume/get_output/
get_status/list_all/delete` (`python/ray/workflow/api.py`).

Execution model (reference: `workflow_executor.py`): topological walk of
the FunctionNode DAG; ready tasks run as ordinary remote tasks, results
are durably written (atomic rename) before dependents are released, and
a workflow-level status file tracks RUNNING/SUCCESSFUL/FAILED.  Resume
reloads the pickled DAG from storage and skips every task with a
persisted result — user code is not needed to resume.

The store root is `RTT_WORKFLOW_STORAGE`, else `workflows/` under the
port's session base (`RTT_TMPDIR`, else `ray_tpu_torch` in the temp
dir), so the JAX package's store is never shared.  Step outputs are
pickled with their devices: a step that returns host values (CPU
tensors, numpy) can be read back by a process without a card.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

import ray_tpu_torch as rt
from ray_tpu_torch.dag.dag_node import DAGNode, FunctionNode

_storage_dir: Optional[str] = None
_lock = threading.Lock()


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"


class Continuation:
    """Returned BY a workflow task to dynamically extend the workflow
    (reference: `workflow.continuation` — a task returning a DAG makes
    the executor run it durably and use its output as the task's own
    result).  Continuations nest: a continuation task may itself return
    another Continuation."""

    def __init__(self, dag: "FunctionNode"):
        if not isinstance(dag, FunctionNode):
            raise TypeError(
                "workflow.continuation expects fn.bind(...) "
                "(a FunctionNode)"
            )
        self.dag = dag


def continuation(dag: "FunctionNode") -> Continuation:
    """Wrap a bound DAG as a task's dynamic continuation."""
    return Continuation(dag)


class EventNode(FunctionNode):
    """A durable wait-point in the DAG (reference:
    `workflow.wait_for_event` + the event listener protocol): the
    executor blocks this step until `send_event(workflow_id, name)`
    writes the payload into storage; once written, the event is durable
    — resumes see it immediately."""

    def __init__(self, name: str, timeout_s: Optional[float] = None):
        def _event_placeholder():  # pragma: no cover — never executed
            raise RuntimeError("EventNode executes via the event path")

        _event_placeholder.__name__ = f"event_{name}"
        super().__init__(_event_placeholder, (), {})
        self.event_name = name
        self.timeout_s = timeout_s


def wait_for_event(name: str,
                   timeout_s: Optional[float] = None) -> EventNode:
    """A DAG node resolving to the payload of a named workflow event."""
    return EventNode(name, timeout_s)


def send_event(workflow_id: str, name: str, payload: Any = None):
    """Deliver an event to a (possibly running, possibly interrupted)
    workflow; durable once written.  Raises for an unknown workflow id
    so a typo'd id can't silently swallow the event."""
    wf = _wf_dir(workflow_id)
    if not os.path.isdir(wf):
        raise ValueError(f"no workflow {workflow_id!r} in storage")
    events = os.path.join(wf, "events")
    os.makedirs(events, exist_ok=True)
    _atomic_write(os.path.join(events, f"{name}.pkl"),
                  cloudpickle.dumps(payload))


def init_storage(path: str):
    """Set the workflow store root (reference: `workflow.init`)."""
    global _storage_dir
    _storage_dir = path
    os.makedirs(path, exist_ok=True)


def _store() -> str:
    global _storage_dir
    if _storage_dir is None:
        # the port's own variable and directory, under its session
        # base: the JAX package's `RAY_TPU_WORKFLOW_STORAGE` and
        # `/tmp/ray_tpu/workflows` are never read or written here
        _storage_dir = os.environ.get(
            "RTT_WORKFLOW_STORAGE",
            os.path.join(
                os.environ.get("RTT_TMPDIR", os.path.join(
                    tempfile.gettempdir(), "ray_tpu_torch")),
                "workflows",
            ),
        )
        os.makedirs(_storage_dir, exist_ok=True)
    return _storage_dir


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_store(), workflow_id)


def _atomic_write(path: str, data: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_status(workflow_id: str, status: str, error: str = ""):
    _atomic_write(
        os.path.join(_wf_dir(workflow_id), "status.json"),
        json.dumps({"status": status, "error": error,
                    "ts": time.time()}).encode(),
    )


# ----------------------------------------------------------------------
# executor
# ----------------------------------------------------------------------
def _topo(root: FunctionNode) -> List[FunctionNode]:
    order: List[FunctionNode] = []
    seen = set()

    def visit(n: DAGNode):
        if n._id in seen:
            return
        seen.add(n._id)
        for u in n._upstream():
            visit(u)
        if isinstance(n, FunctionNode):
            order.append(n)

    visit(root)
    return order


def _task_key(idx: int, node: FunctionNode) -> str:
    name = getattr(node.remote_fn, "__name__", "task")
    return f"{idx:04d}_{name}"


def _write_meta(tasks_dir: str, key: str, **fields):
    """Per-step durable metadata (reference: workflow step metadata in
    storage — `workflow.get_metadata`): merged, atomic."""
    path = os.path.join(tasks_dir, key + ".meta.json")
    meta = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                meta = json.load(f)
        except Exception:
            meta = {}
    meta.update(fields)
    _atomic_write(path, json.dumps(meta).encode())


def _wait_event(workflow_id: str, node: EventNode) -> Any:
    events_dir = os.path.join(_wf_dir(workflow_id), "events")
    path = os.path.join(events_dir, f"{node.event_name}.pkl")
    deadline = (
        time.monotonic() + node.timeout_s
        if node.timeout_s is not None else None
    )
    while not os.path.exists(path):
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"workflow event {node.event_name!r} not delivered "
                f"within {node.timeout_s}s"
            )
        time.sleep(0.05)
    with open(path, "rb") as f:
        return cloudpickle.load(f)


def _execute_dag(workflow_id: str, root: FunctionNode,
                 tasks_dir: Optional[str] = None) -> Any:
    """Topological durable execution.  Dynamic workflows: a task that
    returns `workflow.continuation(dag)` extends the run — the
    continuation DAG is persisted BEFORE it executes (a kill-restart
    resumes the continuation without re-running the task that produced
    it) and runs in its own nested task directory; its output becomes
    the task's result.  EventNodes block durably on `send_event`."""
    wf = _wf_dir(workflow_id)
    if tasks_dir is None:
        tasks_dir = os.path.join(wf, "tasks")
    os.makedirs(tasks_dir, exist_ok=True)
    order = _topo(root)
    keys = {n._id: _task_key(i, n) for i, n in enumerate(order)}
    results: Dict[int, Any] = {}

    # load already-persisted results (resume path)
    for n in order:
        path = os.path.join(tasks_dir, keys[n._id] + ".pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[n._id] = cloudpickle.load(f)

    def resolve(v):
        if isinstance(v, FunctionNode):
            return results[v._id]
        return v

    def run_continuation(key: str, cont_dag: FunctionNode) -> Any:
        sub_dir = os.path.join(tasks_dir, key + "_cont")
        value = _execute_dag(workflow_id, cont_dag, tasks_dir=sub_dir)
        if isinstance(value, Continuation):
            # the continuation's own root returned a continuation: the
            # nested DAG was persisted by the recursive call; unwrap
            # happens there, so this is unreachable — guard anyway
            raise RuntimeError("unresolved nested continuation")
        return value

    for n in order:
        if n._id in results:
            continue  # durably completed in a previous run
        key = keys[n._id]
        cont_path = os.path.join(tasks_dir, key + ".cont.pkl")
        if os.path.exists(cont_path):
            # interrupted mid-continuation: resume the persisted
            # continuation DAG, do NOT re-run the producing task
            with open(cont_path, "rb") as f:
                cont_dag = cloudpickle.load(f)
            value = run_continuation(key, cont_dag)
            _write_meta(tasks_dir, key, end_ts=time.time(),
                        status="SUCCESSFUL")
        elif isinstance(n, EventNode):
            _write_meta(tasks_dir, key, name=n.event_name, kind="event",
                        start_ts=time.time(), status="WAITING")
            try:
                value = _wait_event(workflow_id, n)
            except BaseException as e:
                _write_meta(tasks_dir, key, end_ts=time.time(),
                            status="FAILED", error=repr(e))
                raise
            _write_meta(tasks_dir, key, end_ts=time.time(),
                        status="SUCCESSFUL")
        else:
            args = [resolve(a) for a in n.args]
            kwargs = {k: resolve(v) for k, v in n.kwargs.items()}
            _write_meta(
                tasks_dir, key,
                name=getattr(n.remote_fn, "__name__", "task"),
                kind="task", start_ts=time.time(), status="RUNNING",
            )
            try:
                value = rt.get(n.remote_fn.remote(*args, **kwargs))
            except BaseException as e:
                _write_meta(tasks_dir, key, end_ts=time.time(),
                            status="FAILED", error=repr(e))
                raise
            if isinstance(value, Continuation):
                # durable-first: persist the continuation DAG before
                # executing it, then run it as a nested sub-workflow
                _atomic_write(cont_path, cloudpickle.dumps(value.dag))
                _write_meta(tasks_dir, key, continuation=True)
                value = run_continuation(key, value.dag)
            _write_meta(tasks_dir, key, end_ts=time.time(),
                        status="SUCCESSFUL")
        _atomic_write(
            os.path.join(tasks_dir, key + ".pkl"),
            cloudpickle.dumps(value),
        )
        results[n._id] = value
    return results[root._id]


def _run_to_completion(workflow_id: str, root: FunctionNode) -> Any:
    _write_status(workflow_id, WorkflowStatus.RUNNING)
    # liveness marker: lets get_status distinguish RUNNING (executor
    # alive) from RESUMABLE (interrupted) — reference keeps this in the
    # cluster's workflow manager actor
    _atomic_write(
        os.path.join(_wf_dir(workflow_id), "executor.json"),
        json.dumps({"pid": os.getpid()}).encode(),
    )
    try:
        out = _execute_dag(workflow_id, root)
    except BaseException as e:
        _write_status(workflow_id, WorkflowStatus.FAILED, error=repr(e))
        raise
    _atomic_write(
        os.path.join(_wf_dir(workflow_id), "output.pkl"),
        cloudpickle.dumps(out),
    )
    _write_status(workflow_id, WorkflowStatus.SUCCESSFUL)
    return out


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def run(dag: FunctionNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a bound task DAG durably; returns the final output
    (reference: `workflow.run`)."""
    if not isinstance(dag, FunctionNode):
        raise TypeError("workflow.run expects fn.bind(...) (a FunctionNode)")
    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"
    wf = _wf_dir(workflow_id)
    os.makedirs(wf, exist_ok=True)
    # persist the DAG so resume() works without user code
    _atomic_write(os.path.join(wf, "dag.pkl"), cloudpickle.dumps(dag))
    return _run_to_completion(workflow_id, dag)


_async_executor = None


def run_async(dag: FunctionNode, *, workflow_id: Optional[str] = None):
    """Submit and return a concurrent.futures.Future."""
    import concurrent.futures

    global _async_executor
    with _lock:
        if _async_executor is None:
            _async_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="workflow"
            )
    return _async_executor.submit(run, dag, workflow_id=workflow_id)


def resume(workflow_id: str) -> Any:
    """Re-run an interrupted workflow; completed tasks are skipped
    (reference: `workflow.resume` + `workflow_state_from_storage.py`)."""
    wf = _wf_dir(workflow_id)
    dag_path = os.path.join(wf, "dag.pkl")
    if not os.path.exists(dag_path):
        raise ValueError(f"no workflow {workflow_id!r} in storage")
    out_path = os.path.join(wf, "output.pkl")
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            return cloudpickle.load(f)
    with open(dag_path, "rb") as f:
        dag = cloudpickle.load(f)
    return _run_to_completion(workflow_id, dag)


def get_output(workflow_id: str) -> Any:
    out_path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(out_path):
        raise ValueError(f"workflow {workflow_id!r} has no output yet")
    with open(out_path, "rb") as f:
        return cloudpickle.load(f)


def get_status(workflow_id: str) -> str:
    path = os.path.join(_wf_dir(workflow_id), "status.json")
    if not os.path.exists(path):
        raise ValueError(f"no workflow {workflow_id!r}")
    with open(path) as f:
        status = json.load(f)["status"]
    if status == WorkflowStatus.RUNNING:
        # RUNNING with a live executor process stays RUNNING; without
        # one the run was interrupted and is RESUMABLE (reference:
        # WorkflowStatus.RESUMABLE)
        exec_path = os.path.join(_wf_dir(workflow_id), "executor.json")
        try:
            with open(exec_path) as f:
                pid = json.load(f)["pid"]
            os.kill(pid, 0)
            return WorkflowStatus.RUNNING
        except (OSError, ValueError, KeyError):
            return WorkflowStatus.RESUMABLE
    return status


def list_all(status_filter: Optional[str] = None) -> List[Tuple[str, str]]:
    out = []
    root = _store()
    for wid in sorted(os.listdir(root)):
        try:
            s = get_status(wid)
        except ValueError:
            continue
        if status_filter is None or s == status_filter:
            out.append((wid, s))
    return out


def get_metadata(workflow_id: str) -> Dict[str, Any]:
    """Workflow + per-step durable metadata (reference:
    `workflow.get_metadata`): status, and for each step its name, kind
    (task/event), timestamps, status, and whether it spawned a
    continuation.  Nested continuation steps appear under their parent
    step's key with a '/'-joined path."""
    wf = _wf_dir(workflow_id)
    status_path = os.path.join(wf, "status.json")
    if not os.path.exists(status_path):
        raise ValueError(f"no workflow {workflow_id!r}")
    with open(status_path) as f:
        info = json.load(f)
    steps: Dict[str, Any] = {}

    def scan(tasks_dir: str, prefix: str):
        if not os.path.isdir(tasks_dir):
            return
        for fn in sorted(os.listdir(tasks_dir)):
            full = os.path.join(tasks_dir, fn)
            if fn.endswith(".meta.json"):
                key = prefix + fn[: -len(".meta.json")]
                try:
                    with open(full) as f:
                        steps[key] = json.load(f)
                except Exception:
                    continue
            elif fn.endswith("_cont") and os.path.isdir(full):
                scan(full, prefix + fn[: -len("_cont")] + "/")

    scan(os.path.join(wf, "tasks"), "")
    return {"workflow_id": workflow_id, "status": info.get("status"),
            "error": info.get("error", ""), "steps": steps}


def delete(workflow_id: str):
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
