"""StandardAutoscaler: the reconcile loop.

Reference: `autoscaler/_private/autoscaler.py` `StandardAutoscaler.update()`
(`:172,374`) — each update: read cluster state (nodes + pending resource
demand, here from the controller's autoscaler-state endpoint, the
equivalent of `gcs_autoscaler_state_manager.h`), bin-pack unmet demand
onto configured node types and launch what is missing
(`resource_demand_scheduler.py`), and terminate nodes idle past the
timeout, respecting min/max worker counts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.core.task_spec import fits as _fits


@dataclass
class NodeTypeConfig:
    num_cpus: float = 4
    resources: Dict[str, float] = field(default_factory=dict)
    num_workers: int = 2
    max_count: int = 8

    def provides(self) -> Dict[str, float]:
        return {"CPU": self.num_cpus, **self.resources}


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    min_workers: int = 0
    max_workers: int = 8
    idle_timeout_s: float = 30.0


class StandardAutoscaler:
    ABSORB_MAX_S = 60.0  # safety valve: a launch absorbs matching demand
    # until demand clears, but never longer than this (stuck demand that
    # genuinely needs more nodes gets another chance)

    def __init__(self, provider: NodeProvider, config: AutoscalerConfig):
        self.provider = provider
        self.config = config
        # provider_id -> (node_type, last time it was needed)
        self._managed: Dict[str, List] = {}
        self._recent_launches: List = []  # (ts, provides dict)

    # -- state ---------------------------------------------------------
    def _cluster_state(self) -> Dict[str, Any]:
        return get_runtime().controller_call("get_autoscaler_state")

    def _launch(self, type_name: str, count: int = 1):
        cfg = self.config.node_types[type_name]
        ids = self.provider.create_node(
            {
                "num_cpus": cfg.num_cpus,
                "resources": cfg.resources,
                "num_workers": cfg.num_workers,
            },
            count,
        )
        now = time.time()
        for pid in ids:
            self._managed[pid] = [type_name, now]

    def num_managed(self) -> int:
        return len([
            p for p in self._managed if p in self.provider.non_terminated_nodes()
        ])

    # -- the loop body -------------------------------------------------
    def update(self):
        """One reconcile pass (call periodically)."""
        state = self._cluster_state()
        live = set(self.provider.non_terminated_nodes())
        self._managed = {
            p: v for p, v in self._managed.items() if p in live
        }
        now = time.time()

        # 1. scale up for unmet demand: demand is pending because no
        # node fits it.  Launched nodes absorb demand via bin-packing —
        # each recent launch's capacity is consumed by the demands it
        # can serve, and only the remainder triggers new launches.  The
        # demand signature stays "pending" in controller state until the
        # work is actually scheduled, so launches keep absorbing until
        # the demand list clears (not a fixed cooldown, which double-
        # launches whenever node startup + scheduling outlasts it).
        demands: List[Dict[str, float]] = state["pending_demands"]
        if not demands:
            self._recent_launches = []
        else:
            self._recent_launches = [
                (ts, prov) for ts, prov in self._recent_launches
                if now - ts < self.ABSORB_MAX_S
            ]
        counts: Dict[str, int] = {}
        for p, (tname, _) in self._managed.items():
            counts[tname] = counts.get(tname, 0) + 1
        # remaining capacity of launches still absorbing demand
        spare: List[Dict[str, float]] = [
            dict(prov) for _, prov in self._recent_launches
        ]
        for demand in demands:
            absorbed = False
            for cap in spare:
                if _fits(demand, cap):
                    for k, v in demand.items():
                        cap[k] = cap.get(k, 0.0) - v
                    absorbed = True
                    break
            if absorbed:
                continue
            if self.num_managed() >= self.config.max_workers:
                break
            for tname, tcfg in self.config.node_types.items():
                if not _fits(demand, tcfg.provides()):
                    continue
                if counts.get(tname, 0) >= tcfg.max_count:
                    continue
                self._launch(tname)
                self._recent_launches.append((now, tcfg.provides()))
                cap = tcfg.provides()
                for k, v in demand.items():
                    cap[k] = cap.get(k, 0.0) - v
                spare.append(cap)
                counts[tname] = counts.get(tname, 0) + 1
                break
        if demands:
            for v in self._managed.values():
                v[1] = now  # demand exists: nothing is idle

        # a managed node reported busy (running tasks/actors or a
        # non-empty queue) is not idle, demand or no demand
        busy_ids = {
            n["node_id"] for n in state["nodes"] if n.get("busy")
        }
        rt_id = getattr(self.provider, "runtime_node_id", None)
        if rt_id is not None:
            for pid, v in self._managed.items():
                try:
                    if rt_id(pid) in busy_ids:
                        v[1] = now
                except KeyError:
                    pass

        # 2. min_workers floor
        while self.num_managed() < self.config.min_workers:
            tname = next(iter(self.config.node_types))
            self._launch(tname)

        # 3. scale down idle managed nodes past the timeout
        if not demands:
            for pid, (tname, last_needed) in list(self._managed.items()):
                if self.num_managed() <= self.config.min_workers:
                    break
                if now - last_needed > self.config.idle_timeout_s:
                    self.provider.terminate_node(pid)
                    del self._managed[pid]

    def run(self, interval_s: float = 2.0, stop_event=None):
        """Loop forever (the head-node monitor process shape,
        reference: `_private/monitor.py`)."""
        while stop_event is None or not stop_event.is_set():
            try:
                self.update()
            except Exception:
                import traceback

                traceback.print_exc()
            time.sleep(interval_s)
