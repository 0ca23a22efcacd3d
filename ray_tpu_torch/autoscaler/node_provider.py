"""Node providers: pluggable backends that create/terminate nodes.

Reference: `python/ray/autoscaler/node_provider.py` NodeProvider
interface; `LocalNodeProvider` plays the role of
`FakeMultiNodeProvider` (`_private/fake_multi_node/node_provider.py:236`,
`RAY_FAKE_CLUSTER=1`) — real node daemons as local processes, which is
also the single-host "cluster" story.  A cloud provider (GKE/TPU-VM)
implements the same three methods against its API.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional


class NodeProvider:
    def create_node(self, node_config: Dict[str, Any], count: int = 1) -> List[str]:
        """Launch nodes; returns provider node ids."""
        raise NotImplementedError

    def create_slice(self, node_config: Dict[str, Any], hosts: int) -> List[str]:
        """Provision `hosts` ICI-connected hosts as ONE unit (a TPU
        slice).  Default: per-host creation — the v2 autoscaler rolls
        the whole set back on partial failure, giving all-or-nothing
        semantics on top.  Cloud providers that can allocate a slice in
        a single API call (one multi-host TPU VM node) override this.
        """
        out: List[str] = []
        try:
            for _ in range(hosts):
                out.extend(self.create_node(node_config, 1))
        except Exception:
            for pid in out:
                try:
                    self.terminate_node(pid)
                except Exception:
                    pass
            raise
        return out

    def terminate_node(self, provider_id: str):
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_is_ready(self, provider_id: str) -> bool:
        """True when the node has actually booted (GCP TPU state READY,
        GKE pod phase Running).  The v2 autoscaler gates REQUESTED ->
        RUNNING promotion on this for providers that cannot map provider
        ids to runtime nodes — without it a Pending pod/VM would be
        promoted on sight, disabling the slice ready-timeout reaper and
        double-launching slices while one is still booting.  Default
        True: providers whose listing already implies liveness."""
        return True

    def node_resources(self, provider_id: str) -> Dict[str, float]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Spawns real node daemons joined to an existing head."""

    def __init__(self, controller_addr, base_dir: Optional[str] = None):
        self._controller_addr = tuple(controller_addr)
        self._base = base_dir or os.path.join(
            os.environ.get("RTT_TMPDIR", os.path.join(tempfile.gettempdir(), "ray_tpu_torch")),
            f"autoscaler_{os.getpid()}",
        )
        os.makedirs(self._base, exist_ok=True)
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._next = 0

    def create_node(self, node_config: Dict[str, Any], count: int = 1) -> List[str]:
        from ray_tpu_torch.core.node_launcher import launch_noded

        out = []
        for _ in range(count):
            idx = self._next
            self._next += 1
            resources = dict(node_config.get("resources", {}))
            num_cpus = float(node_config.get("num_cpus", 4))
            proc, ready = launch_noded(
                os.path.join(self._base, f"node_{idx}"),
                controller_addr=self._controller_addr,
                num_cpus=num_cpus,
                resources=resources,
                labels=dict(node_config.get("labels", {})) or None,
                num_workers=int(node_config.get("num_workers", 2)),
            )
            pid = f"local-{idx}"
            self._nodes[pid] = {
                "proc": proc,
                "node_id": ready["node_id"],
                "resources": {"CPU": num_cpus, **resources},
                "launched_at": time.time(),
            }
            out.append(pid)
        return out

    def terminate_node(self, provider_id: str):
        info = self._nodes.pop(provider_id, None)
        if info is None:
            return
        proc = info["proc"]
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()

    def non_terminated_nodes(self) -> List[str]:
        return [
            pid for pid, info in self._nodes.items()
            if info["proc"].poll() is None
        ]

    def node_resources(self, provider_id: str) -> Dict[str, float]:
        return dict(self._nodes[provider_id]["resources"])

    def runtime_node_id(self, provider_id: str) -> str:
        return self._nodes[provider_id]["node_id"]
