"""Cluster dashboard: HTTP observability endpoint.

Reference: `python/ray/dashboard/` (`DashboardHead`, `dashboard/head.py:61`,
module plugins under `dashboard/modules/`).  One dashboard actor serves
JSON APIs over the controller's state (nodes/actors/tasks/jobs/PGs/
autoscaler/serve), Prometheus metrics, a chrome-trace timeline, and a
small self-contained HTML page — the React client's job, minus the
build system.
"""

from ray_tpu_torch.dashboard.head import DashboardHead, start_dashboard

__all__ = ["DashboardHead", "start_dashboard"]
