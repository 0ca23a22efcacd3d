"""Multi-node-without-a-cluster test harness.

Reference: `python/ray/cluster_utils.py:135` `Cluster` — starts multiple
node daemons **as separate processes on one host** (`add_node:201`,
`remove_node:282`); the workhorse for distributed core tests (node
death, actor restart across nodes, multi-node scheduling) without
hardware.
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import exceptions as exc


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, session_dir: str,
                 ready: Dict[str, Any], is_head: bool):
        self.proc = proc
        self.session_dir = session_dir
        self.node_id: str = ready["node_id"]
        self.ready = ready
        self.is_head = is_head

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def __repr__(self):
        return f"NodeHandle({self.node_id[:8]}, head={self.is_head})"


class Cluster:
    """Reference: `cluster_utils.Cluster` — `add_node` spawns a node
    daemon; the first one is the head (hosts the controller)."""

    def __init__(self, initialize_head: bool = False, head_node_args:
                 Optional[Dict] = None):
        self._base = os.path.join(
            os.environ.get("RTT_TMPDIR", os.path.join(tempfile.gettempdir(), "ray_tpu_torch")),
            f"cluster_{int(time.time() * 1000):x}_{os.getpid()}",
        )
        os.makedirs(self._base, exist_ok=True)
        self._nodes: List[NodeHandle] = []
        self._next_idx = 0
        self._connected = False
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def head_node(self) -> Optional[NodeHandle]:
        for n in self._nodes:
            if n.is_head and n.alive:
                return n
        return None

    @property
    def address(self) -> Optional[str]:
        """Head ready-file path — pass to `ray_tpu_torch.init(address=...)`."""
        head = self.head_node
        return os.path.join(head.session_dir, "ready.json") if head else None

    def add_node(self, *, num_cpus: float = 4, num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 num_workers: int = 2, wait: bool = True) -> NodeHandle:
        """Reference: `cluster_utils.py:201` add_node."""
        from ray_tpu_torch.core.node_launcher import launch_noded

        idx = self._next_idx
        self._next_idx += 1
        is_head = not any(n.is_head for n in self._nodes)
        session_dir = os.path.join(self._base, f"node_{idx}")
        controller_addr = None
        if not is_head:
            head = self.head_node
            if head is None:
                raise exc.RayTpuError("head node died; cannot add workers")
            controller_addr = tuple(head.ready["controller_addr"])
        proc, ready = launch_noded(
            session_dir,
            head=is_head,
            controller_addr=controller_addr,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            labels=labels,
            num_workers=num_workers,
        )
        node = NodeHandle(proc, session_dir, ready, is_head)
        self._nodes.append(node)
        if wait and self._connected:
            self.wait_for_nodes()
        return node

    def remove_node(self, node: NodeHandle, *, graceful: bool = True,
                    allow_graceful: Optional[bool] = None):
        """Reference: `cluster_utils.py:282` remove_node.  graceful=False
        is the node-failure injection path (SIGKILL, no cleanup)."""
        if allow_graceful is not None:
            graceful = allow_graceful
        if node.alive:
            node.proc.send_signal(
                signal.SIGTERM if graceful else signal.SIGKILL
            )
            try:
                node.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                node.proc.kill()
                node.proc.wait(timeout=5)
        # a SIGKILL'd (or kill-injected) daemon never unlinks its shm
        # store; /dev/shm is a shared host resource, so reap it here —
        # tmpfs segments leaked per killed node otherwise accumulate
        # across test runs until the host's shm fills
        shm_name = (node.ready or {}).get("shm_name")
        if shm_name:
            try:
                from ray_tpu_torch.shm import ShmStore

                ShmStore.unlink(shm_name)
            except Exception:
                pass
        self._nodes = [n for n in self._nodes if n is not node]

    def connect(self, **init_kwargs):
        """ray_tpu_torch.init against this cluster's head."""
        import ray_tpu_torch as rt

        if self.address is None:
            raise exc.RayTpuError("no live head node")
        info = rt.init(address=self.address, **init_kwargs)
        self._connected = True
        return info

    def wait_for_nodes(self, timeout: float = 30.0):
        """Block until the controller sees every live daemon as ALIVE."""
        import ray_tpu_torch as rt

        want = {n.node_id for n in self._nodes if n.alive}
        alive: set = set()
        deadline = time.time() + timeout
        while time.time() < deadline:
            alive = {n["node_id"] for n in rt.nodes() if n["alive"]}
            if want <= alive:
                return
            time.sleep(0.1)
        raise exc.RayTpuError(
            f"nodes never became ALIVE: {want - alive}"
        )

    def shutdown(self):
        import ray_tpu_torch as rt

        if self._connected:
            try:
                rt.shutdown()
            except Exception:
                pass
            self._connected = False
        for n in list(self._nodes):
            self.remove_node(n, graceful=True)
