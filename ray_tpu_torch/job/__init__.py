"""Job submission: run entrypoint commands under cluster supervision.

Reference: `python/ray/dashboard/modules/job/job_manager.py` (`JobManager:58`,
`submit_job:421`) — each submitted job gets a `JobSupervisor` actor that
runs the entrypoint shell command, streams its output to a log file, and
publishes status transitions (PENDING → RUNNING → SUCCEEDED/FAILED/
STOPPED) through the control plane's KV store.
"""

from ray_tpu_torch.job.api import (
    JobStatus,
    get_job_info,
    follow_job_logs,
    get_job_logs,
    get_job_status,
    list_jobs,
    stop_job,
    submit_job,
    wait_job,
)

__all__ = [
    "JobStatus",
    "get_job_info",
    "follow_job_logs",
    "get_job_logs",
    "get_job_status",
    "list_jobs",
    "stop_job",
    "submit_job",
    "wait_job",
]
