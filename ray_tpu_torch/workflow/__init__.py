"""Durable workflows: task DAGs with storage-backed resume.

Reference: `python/ray/workflow/` — `workflow_executor.py` (DAG
execution), `workflow_storage.py` (every task result durably logged),
`workflow_state_from_storage.py` (resume skips completed tasks) — the
same contract on a directory-per-workflow store: the bound DAG is
persisted at submission, each task's result is written before the
workflow advances, and `resume()` replays only what never finished.
"""

from ray_tpu_torch.workflow.api import (
    Continuation,
    WorkflowStatus,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_status,
    init_storage,
    list_all,
    resume,
    run,
    run_async,
    send_event,
    wait_for_event,
)

__all__ = [
    "Continuation",
    "WorkflowStatus",
    "continuation",
    "delete",
    "get_metadata",
    "send_event",
    "wait_for_event",
    "get_output",
    "get_status",
    "init_storage",
    "list_all",
    "resume",
    "run",
    "run_async",
]
