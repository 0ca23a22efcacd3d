"""Node daemon: the per-node runtime (raylet equivalent).

One per node (reference: `src/ray/raylet/node_manager.h:119`).  Owns:

- the worker pool: prestart, spawn-on-demand, death detection
  (reference: `worker_pool.h:174`),
- the local scheduler: FIFO-with-window dispatch against node resources,
  worker leases with in-lease pipelining, spillback to other nodes via
  the controller (reference: `cluster_task_manager.h:42`,
  `local_task_manager.h:58`, lease pipelining in
  `normal_task_submitter.h:75`),
- message routing between workers/drivers across nodes (the owner
  protocol rides this),
- node-to-node object transfer in/out of the shm store (reference:
  `object_manager.h:117` chunked push/pull),
- the shm store segment lifecycle for the node.

The head daemon also hosts the Controller service on its TCP port
(the reference colocates GCS on the head node).
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

from ray_tpu_torch.core import accelerators, diskio as _diskio, rpc
from ray_tpu_torch.core import integrity as _integrity
from ray_tpu_torch.core.config import Config, get_config
from ray_tpu_torch.metrics import metric_defs as _md
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.task_spec import ActorCreationSpec, Resources, SchedulingStrategy, TaskResult, TaskSpec, fits as _fits, match_labels
from ray_tpu_torch.shm import ObjectExistsError, ShmStore

logger = logging.getLogger(__name__)

_PIPELINE_DEPTH = 4  # tasks pushed to one leased worker ahead of completion


def _fault_metric(name: str, tags=None, value: float = 1.0):
    """Integrity/storage-fault counters bypass the metrics_enabled
    gate: they record rare failure events, not hot-path samples, and
    the chaos acceptance tests read them with instrumentation off."""
    try:
        _md.metric(name).inc(value, tags=tags)
    except Exception:  # metrics must never break a fault path
        logger.debug("fault metric %s failed", name, exc_info=True)


@dataclass
class _SpillEntry:
    """One disk-spilled primary copy: where it lives and the checksum
    its bytes carried when they left the shm store (the spill
    manifest; reference: `local_object_manager.h:41` url_with_offset
    records).  A JSON sidecar (`<path>.meta`) mirrors this entry for
    diagnostics and for verification after the in-memory index is
    gone."""

    path: str
    size: int
    crc: Optional[int] = None
    algo: Optional[str] = None


@dataclass
class WorkerState:
    worker_id: str
    pid: int
    conn: Optional[rpc.Connection] = None
    kind: str = "worker"  # worker | driver
    socket_path: Optional[str] = None  # worker's own server socket
    actor_id: Optional[bytes] = None
    lease: Optional[Dict[str, float]] = None  # charged resources
    leased_to: Optional[str] = None  # worker_id of the lease holder
    in_flight: Dict[bytes, TaskSpec] = field(default_factory=dict)
    proc: Optional[subprocess.Popen] = None
    busy_since: Optional[float] = None  # OOM victim ordering (LIFO)
    oom_killed_at: Optional[float] = None  # SIGKILL sent; awaiting reap
    # runtime-env dedication: once a worker applies an env it serves
    # ONLY that env hash (reference: worker-pool runtime-env matching);
    # clean tasks never run on a tainted worker
    env_hash: Optional[str] = None
    # mid-task get() is parked on an unavailable object: its lease
    # CPUs are RELEASED back to the node (reference: blocked-worker
    # accounting in the raylet — `node_manager.cc` HandleTaskBlocked)
    # so dependency-producing work can run.  Without this, lineage
    # reconstruction deadlocks the moment every worker slot holds a
    # consumer blocked on an object only a queued task can re-derive.
    blocked: bool = False

    @property
    def idle(self):
        return (
            not self.in_flight
            and self.actor_id is None
            and self.leased_to is None
        )


class NodeDaemon:
    def __init__(self, session_dir: str, is_head: bool, controller_addr=None,
                 num_cpus: Optional[float] = None, num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 num_workers: int = 0, node_name: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.cfg: Config = get_config()
        self.session_dir = session_dir
        self.is_head = is_head
        self.node_id = NodeID.random().hex()
        self.node_name = node_name or self.node_id[:8]
        # the ".<pid>" suffix marks this daemon as the segment's owner
        # so a later boot can reap it if we die without unlinking
        # (shm.sweep_stale_segments)
        self.shm_name = (
            f"/rtt_{os.path.basename(session_dir)}_{self.node_id[:8]}"
            f".{os.getpid()}"
        )
        self.socket_path = _socket_path(session_dir, f"noded_{self.node_id[:8]}.sock")

        ncpu = num_cpus if num_cpus is not None else float(os.cpu_count() or 4)
        self.total_resources: Dict[str, float] = {"CPU": ncpu}
        if num_gpus is None:
            # autodetect local GPUs (reference: accelerator managers
            # run at node start, `_private/accelerators/nvidia_gpu.py`)
            detected = accelerators.detect_num_chips()
            if detected:
                num_gpus = float(detected)
        if num_gpus:
            self.total_resources["GPU"] = float(num_gpus)
        self.node_labels: Dict[str, str] = dict(labels or {})
        self._chip_pool: Optional[accelerators.ChipPool] = None
        if num_gpus and num_gpus >= 1 and float(num_gpus).is_integer():
            self._chip_pool = accelerators.ChipPool(int(num_gpus))
        self.total_resources.update(resources or {})
        self.available = dict(self.total_resources)

        self.num_workers = num_workers or int(ncpu)
        self.store: Optional[ShmStore] = None
        self.workers: Dict[str, WorkerState] = {}  # worker_id -> state
        self._booting_tokens: set = set()  # spawn tokens not yet registered
        self._conn_worker: Dict[rpc.Connection, str] = {}
        # actor_id -> (ActorCreationSpec, worker_id) for actors this
        # node hosts — re-reported to a restarted controller so the
        # registry heals (re-adoption)
        self._hosted_actors: Dict[bytes, Tuple[Any, str]] = {}
        self.task_queue: Deque[TaskSpec] = deque()
        self.controller_addr = controller_addr
        self.controller_conn: Optional[rpc.Connection] = None
        self.controller = None  # Controller object when head
        self._node_conns: Dict[str, rpc.Connection] = {}  # node_id -> conn
        self._node_addrs: Dict[str, Tuple[str, int]] = {}
        self._pulls: Dict[bytes, asyncio.Future] = {}
        # inbound-transfer admission (reference: pull_manager.h:92)
        self._inflight_pull_bytes = 0
        self._pull_cv: Optional[asyncio.Condition] = None
        self._chan_pool = None  # dedicated pool for blocking ring writes
        # disk-spilled primary copies: id -> _SpillEntry (reference:
        # `local_object_manager.h:41` spilling/restoring)
        self._spilled: Dict[bytes, _SpillEntry] = {}
        self._spill_dir = os.path.join(session_dir, "spilled")
        self._quarantine_dir = os.path.join(self._spill_dir, "quarantine")
        # low-disk latch: set when the spill filesystem is below the
        # free-bytes watermark (or a write hit real ENOSPC); spill_now
        # replies carry it so producers clamp with a typed
        # BackPressureError instead of spinning against a full disk
        self._spill_disk_full = False
        import threading as _threading

        # spill/restore mutate the store + index from the executor
        # thread (file IO must not stall the io loop — the reference
        # uses dedicated IO workers the same way)
        # REENTRANT: a restore under pressure force-spills other
        # objects while already holding the lock
        self._spill_lock = _threading.RLock()
        self._actor_locations: Dict[bytes, Tuple[str, str]] = {}
        self.unix_server: Optional[rpc.Server] = None
        self.tcp_server: Optional[rpc.Server] = None
        self.tcp_port: int = 0
        self.controller_port: int = 0
        # Prometheus /metrics listener (cfg.metrics_http_port); the
        # bound port is advertised in node registration
        self._metrics_server = None
        self.metrics_http_port: int = 0

    # ------------------------------------------------------------------
    # startup
    # ------------------------------------------------------------------
    async def start(self):
        # daemon boot doubles as the host's janitor: segments owned by
        # hard-killed sessions would otherwise eat /dev/shm forever
        from ray_tpu_torch import shm as _shm

        _shm.sweep_stale_segments()
        cap = self.cfg.object_store_memory
        if cap <= 0:
            cap = _default_store_capacity()
        self.store = ShmStore(self.shm_name, capacity=cap, create=True)

        self.unix_server = rpc.Server(self, name=f"noded-{self.node_name}-unix")
        await self.unix_server.start_unix(self.socket_path)
        self.tcp_server = rpc.Server(self, name=f"noded-{self.node_name}-tcp")
        bind = self.cfg.bind_host or "127.0.0.1"
        self._advertise = self.cfg.advertise_host or (
            _primary_ip() if bind == "0.0.0.0" else bind
        )
        self.tcp_port = await self.tcp_server.start_tcp(bind, 0)

        if self.is_head:
            from ray_tpu_torch.core.controller import Controller
            from ray_tpu_torch.core.placement import PlacementGroupManager

            # operators pick the durability tier via the store URL
            # (sqlite:///..., memory://, a file path); default = a
            # session-local file (reference: in-memory vs Redis
            # StoreClient choice at GCS boot)
            self.controller = Controller(
                persist_path=self.cfg.controller_store_url or os.path.join(
                    self.session_dir, "controller_state.json"
                )
            )
            self.controller.load_persisted()
            self.controller._pg_manager = PlacementGroupManager(self.controller)
            ctl_server = rpc.Server(self.controller, name="controller")
            self.controller_port = await ctl_server.start_tcp(
                bind, self.cfg.controller_port
            )
            self._ctl_server = ctl_server
            self.controller.start_health_checks()
            self.controller_addr = (self._advertise, self.controller_port)

        if self.cfg.metrics_http_port != 0:
            await self._start_metrics_http(bind)

        # register with the controller like any node
        await self._connect_controller()
        for _ in range(self.num_workers):
            self._spawn_worker()
        asyncio.ensure_future(self._retry_queue_loop())
        asyncio.ensure_future(self._obs_report_loop())
        if self.cfg.memory_monitor_refresh_ms > 0:
            asyncio.ensure_future(self._memory_monitor_loop())
        logger.info(
            "noded %s up: %d workers, resources=%s",
            self.node_name,
            self.num_workers,
            self.total_resources,
        )

    async def _connect_controller(self):
        """Connect + register with the controller; arms the reconnect
        handler so a worker daemon survives a head/controller restart
        (reference: raylets reconnect to a restarted GCS and the
        cluster keeps running through the downtime,
        `gcs_redis_failure_detector.h` + test_gcs_fault_tolerance)."""
        self.controller_conn = await rpc.connect_tcp(
            *self.controller_addr, handler=self._ctl_push,
            name="noded->controller",
        )
        if not self.is_head:
            self.controller_conn.on_close = self._on_controller_lost
        await self.controller_conn.call(
            "register_node",
            {
                "node_id": self.node_id,
                "addr": (self._advertise, self.tcp_port),
                "resources": dict(self.total_resources),
                "is_head": self.is_head,
                "labels": dict(self.node_labels),
                "metrics_port": self.metrics_http_port,
            },
        )
        # re-adopt: tell the (possibly restarted) controller which
        # actors this node already hosts, so the registry and named
        # lookups heal without restarting user state
        for aid, (aspec, worker_id) in list(self._hosted_actors.items()):
            if worker_id in self.workers:
                try:
                    reply = await self.controller_conn.call(
                        "readopt_actor",
                        {"spec": aspec, "node_id": self.node_id,
                         "worker_id": worker_id},
                    )
                except Exception:
                    logger.exception("actor re-adoption failed")
                    continue
                if not reply.get("ok") and reply.get("action") == "kill":
                    # the controller failed this actor over during the
                    # disconnect — this copy is stale and must not keep
                    # running beside its replacement
                    logger.warning(
                        "killing stale actor copy %s (superseded during "
                        "controller disconnect)", aspec.actor_id.hex()[:8],
                    )
                    self._hosted_actors.pop(aid, None)
                    w = self.workers.get(worker_id)
                    if w is not None:
                        # unlink the actor BEFORE the kill: the exit
                        # handler must not report an actor death for a
                        # copy the controller already replaced
                        w.actor_id = None
                        try:
                            os.kill(w.pid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
        # force the next load report to be a FULL snapshot: the new
        # controller has no delta base
        self._last_load_report = None

    def _on_controller_lost(self, conn):
        if self._draining:
            return
        logger.warning("controller connection lost; reconnecting")
        asyncio.ensure_future(self._reconnect_controller())

    async def _reconnect_controller(self):
        deadline = time.monotonic() + self.cfg.controller_reconnect_timeout_s
        while time.monotonic() < deadline:
            if self._draining:
                return
            try:
                await self._connect_controller()
                logger.info("reconnected to controller")
                return
            except Exception as e:
                logger.debug("controller reconnect attempt failed: %s", e)
                await asyncio.sleep(1.0)
        logger.error(
            "controller unreachable for %.0fs; daemon shutting down",
            self.cfg.controller_reconnect_timeout_s,
        )
        os.kill(os.getpid(), signal.SIGTERM)

    async def _ctl_push(self, method, payload, conn):
        if method == "ping":
            return "pong"
        if method == "host_actor":
            return await self.handle_host_actor(payload, conn)
        if method == "kill_worker":
            return await self.handle_kill_worker(payload, conn)
        raise rpc.RpcError(f"noded: unexpected controller push {method!r}")

    def write_ready_file(self, path: str):
        with open(path + ".tmp", "w") as f:
            json.dump(
                {
                    "node_id": self.node_id,
                    "socket_path": self.socket_path,
                    "controller_addr": list(self.controller_addr),
                    "tcp_port": self.tcp_port,
                    "shm_name": self.shm_name,
                },
                f,
            )
        os.replace(path + ".tmp", path)

    # ------------------------------------------------------------------
    # worker pool (reference: worker_pool.h:174)
    # ------------------------------------------------------------------
    _pending_spawns = 0

    def _spawn_worker(self, container: Optional[tuple] = None) -> None:
        """`container=(env_hash, spec)` spawns the worker INSIDE the
        image via the injectable container runtime (reference:
        `runtime_env/image_uri.py:106` — the worker command wrapped in
        `podman run` with session dir and networking shared); such
        workers register pre-dedicated to their env hash."""
        from ray_tpu_torch.core.env_utils import worker_env

        if logger.isEnabledFor(logging.DEBUG):
            import traceback

            caller = traceback.extract_stack(limit=2)[0]
            logger.debug(
                "spawn_worker pending=%d pool=%d from %s:%d",
                self._pending_spawns, len(self.workers),
                caller.name, caller.lineno,
            )
        self._pending_spawns += 1
        env = worker_env()
        env.update(self.cfg.to_env())
        env["RTT_NODE_SOCKET"] = self.socket_path
        env["RTT_CONTROLLER"] = f"{self.controller_addr[0]}:{self.controller_addr[1]}"
        # spawn tokens (not pids) key the boot accounting: a container
        # worker's registering pid is NOT the Popen pid (that's the
        # podman client), and pid reuse could misattribute anyway
        token = os.urandom(8).hex()
        env["RTT_SPAWN_TOKEN"] = token
        argv = [sys.executable, "-m", "ray_tpu_torch.core.worker_main"]
        if container is not None:
            env_hash, cspec = container
            env["RTT_ENV_HASH"] = env_hash
            from ray_tpu_torch.core.container import get_container_runtime

            import ray_tpu_torch as _pkg

            pkg_root = os.path.dirname(
                os.path.dirname(os.path.abspath(_pkg.__file__))
            )
            mounts = sorted({
                os.environ.get("RTT_TMPDIR", os.path.join(
                    tempfile.gettempdir(), "ray_tpu_torch")),
                self.session_dir, os.path.dirname(self.socket_path),
                pkg_root, "/dev/shm",
            })
            try:
                # the WHOLE worker env crosses the boundary — a
                # container worker with default-config RTT_* settings
                # would silently diverge from every host worker
                argv = get_container_runtime().synthesize(
                    cspec, argv,
                    {k: v for k, v in env.items() if v is not None},
                    mounts,
                )
            except Exception:
                # e.g. no podman/docker on this host: release the
                # pending-spawn slot or on-demand spawning wedges
                # forever for ALL tasks on this node
                self._pending_spawns -= 1
                logger.exception(
                    "container worker spawn failed for image %r",
                    cspec.get("image"),
                )
                raise
        proc = subprocess.Popen(
            argv,
            env=env,
            # worker spawn is deliberately synchronous on the daemon
            # loop (lease-grant ordering); the log-file open is a
            # bounded local create dwarfed by the fork+exec beside it,
            # and spawns are rare
            stdout=open(os.path.join(self.session_dir, "logs", f"worker-{time.time():.0f}-{os.urandom(2).hex()}.out"), "wb"),  # rtlint: disable=RT009
            stderr=subprocess.STDOUT,
        )
        # booting = spawned but not yet registered; token membership
        # (not pid presence in self.workers) decides who releases the
        # pending-spawn slot, so a registered worker's later death can
        # never double-release it
        self._booting_tokens.add(token)
        # the worker introduces itself via `register`; we just remember
        # the proc so we can reap/replace it
        asyncio.ensure_future(self._watch_proc(proc, token))

    async def _watch_proc(self, proc: subprocess.Popen, token: str):
        # a boot that HANGS (rather than crashes) would otherwise hold
        # its pending-spawn slot forever and wedge the pool at size 0 —
        # kill it past the deadline so the crash path releases the slot
        # and the next schedule pass can spawn a fresh worker
        boot_deadline = time.monotonic() + float(
            os.environ.get("RTT_WORKER_BOOT_TIMEOUT_S", "120")
        )
        boot_killed = False
        while proc.poll() is None:
            if (not boot_killed and token in self._booting_tokens
                    and time.monotonic() > boot_deadline):
                logger.warning(
                    "worker pid %d still booting after deadline: killing",
                    proc.pid,
                )
                boot_killed = True  # once; an unkillable proc must not re-warn 5x/s
                try:
                    # containerized boots: the client SIGKILL below
                    # strands the container — kill it by name too
                    from ray_tpu_torch.core.container import (
                        get_container_runtime,
                    )

                    get_container_runtime().kill_booting(token)
                except Exception as e:
                    logger.debug("kill_booting(%s) failed: %s", token, e)
                proc.kill()
            await asyncio.sleep(0.2)
        if token in self._booting_tokens:
            # died before registering: release the pending-spawn slot
            # so on-demand spawning doesn't deadlock on a boot-crashing
            # worker
            self._booting_tokens.discard(token)
            if self._pending_spawns > 0:
                self._pending_spawns -= 1
            logger.warning(
                "worker pid %d exited with %s before registering",
                proc.pid,
                proc.returncode,
            )
            return
        # registered at some point: normal death path (a racing
        # connection-close may have handled it already — then the pid
        # is no longer in self.workers and this is a no-op)
        for w in list(self.workers.values()):
            if w.pid == proc.pid:
                self._on_worker_dead(w, f"process exited with {proc.returncode}")
                return

    def on_connect(self, conn: rpc.Connection):
        conn.on_close = self._on_conn_close

    def _on_conn_close(self, conn: rpc.Connection):
        wid = self._conn_worker.pop(conn, None)
        if wid is None:
            return
        w = self.workers.get(wid)
        if w is not None and w.conn is conn:
            self._on_worker_dead(w, "connection lost")

    def _on_worker_dead(self, w: WorkerState, reason: str):
        if w.worker_id not in self.workers:
            return
        del self.workers[w.worker_id]
        logger.warning("worker %s died: %s", w.worker_id[:8], reason)
        if self._chip_pool is not None:
            self._chip_pool.release_worker(w.worker_id)
        if self.store is not None:
            self.store.reap_creator(w.pid)
        # fail in-flight tasks back to their owners
        for spec in w.in_flight.values():
            result = TaskResult(task_id=spec.task_id, status="worker_died")
            asyncio.ensure_future(self._route_to_owner(spec.owner, "task_result", result))
        # the tasks are dead with the worker: clear them BEFORE the
        # lease release, whose not-in-flight guard would otherwise skip
        # the resource refund forever (the worker is about to become
        # unreachable)
        w.in_flight = {}
        self._release_lease(w)
        if w.actor_id is not None:
            self._hosted_actors.pop(w.actor_id, None)
            if self.controller_conn:
                self.controller_conn.send(
                    "actor_worker_died",
                    {"actor_id": w.actor_id, "cause": reason,
                     "node_id": self.node_id},
                )
        if w.kind == "worker" and not self._draining:
            self._spawn_worker()
        self._schedule()

    _draining = False

    # ------------------------------------------------------------------
    # local registration
    # ------------------------------------------------------------------
    async def handle_register(self, payload, conn):
        w = WorkerState(
            worker_id=payload["worker_id"],
            pid=payload["pid"],
            conn=conn,
            kind=payload["kind"],
        )
        tok = payload.get("spawn_token")
        if tok and tok in self._booting_tokens:
            self._booting_tokens.discard(tok)
            if self._pending_spawns > 0:
                self._pending_spawns -= 1
        if payload.get("env_hash"):
            # spawned inside a container image: dedicated from birth
            w.env_hash = payload["env_hash"]
        w.socket_path = payload.get("socket_path")
        self.workers[w.worker_id] = w
        self._conn_worker[conn] = w.worker_id
        self._schedule()
        return {
            "node_id": self.node_id,
            "shm_name": self.shm_name,
            "controller_addr": list(self.controller_addr),
        }

    async def handle_ping(self, payload, conn):
        return "pong"

    # ------------------------------------------------------------------
    # scheduling (reference: local_task_manager.cc:122 dispatch loop)
    # ------------------------------------------------------------------
    async def handle_submit_task(self, spec: TaskSpec, conn):
        # the daemon's hop in a trace: tasks routed through the node
        # scheduler (spread/affinity/pg/labels, lease-infeasible
        # spillback) appear as an instant `sched:` span so the merged
        # timeline shows WHERE a task waited (driver vs daemon vs
        # worker).  Guarded by the spec carrying a context at all —
        # costs one attribute test when tracing is off.
        if spec.trace_ctx is not None:
            from ray_tpu_torch.util import tracing as _tracing

            _tracing.record_instant(
                f"sched:{spec.name}", spec.trace_ctx, kind="INTERNAL",
                node=self.node_id[:8],
            )
        strat = spec.strategy
        if strat.kind == "placement_group" and strat.pg_id is not None:
            target = await self.controller_conn.call(
                "pg_node_for_bundle",
                {"pg_id": strat.pg_id, "bundle_index": strat.pg_bundle_index},
            )
            if target is not None and target != self.node_id:
                (await self._node_conn(target)).send("submit_task", spec)
                return
        elif strat.kind == "node_affinity" and strat.node_id:
            if strat.node_id != self.node_id:
                try:
                    (await self._node_conn(strat.node_id)).send("submit_task", spec)
                    return
                except Exception as e:
                    logger.debug("forward to node %s failed: %s",
                                 strat.node_id[:8], e)
                    if not strat.soft:
                        result = TaskResult(task_id=spec.task_id, status="worker_died")
                        await self._route_to_owner(spec.owner, "task_result", result)
                        return
        elif strat.kind == "node_labels":
            # a daemon with a local HARD match may host the task
            # outright (soft is only a preference); otherwise — local
            # hard miss, or a soft-only strategy that must see the
            # cluster-wide soft candidates — the controller picks via
            # filter_by_labels.  `label_routed` marks an already-routed
            # forward so the receiving daemon queues in one hop, while
            # the constraints stay attached for label-aware spillback.
            if strat.label_routed or (
                strat.label_hard
                and match_labels(strat.label_hard, self.node_labels)
            ):
                target = self.node_id
            else:
                target = await self.controller_conn.call(
                    "find_node_for",
                    {"resources": spec.resources.as_dict(), "exclude": [],
                     "label_hard": strat.label_hard,
                     "label_soft": strat.label_soft},
                )
            if target is None:
                from ray_tpu_torch.core import serialization as ser

                result = TaskResult(
                    task_id=spec.task_id, status="infeasible",
                    error=ser.serialize_to_bytes(ValueError(
                        "no node matches NodeLabelSchedulingStrategy hard "
                        f"expressions {strat.label_hard}"),
                        tag=ser.TAG_ERROR),
                )
                await self._route_to_owner(spec.owner, "task_result", result)
                return
            if target != self.node_id:
                spec.strategy.label_routed = True
                (await self._node_conn(target)).send("submit_task", spec)
                return
        elif strat.kind == "spread":
            target = await self.controller_conn.call(
                "find_node_for",
                {"resources": spec.resources.as_dict(), "exclude": [],
                 "spread": True},
            )
            if target is not None and target != self.node_id:
                # the choice is made exactly once: the receiving daemon
                # must queue locally, not re-roll the round-robin (which
                # would ping-pong the task between nodes forever)
                spec.strategy = SchedulingStrategy()
                (await self._node_conn(target)).send("submit_task", spec)
                return
        self.task_queue.append(spec)
        self._schedule()

    def _schedule(self):
        """Dispatch as many queued tasks as possible.  Scans a bounded
        window past the head to avoid head-of-line blocking by an
        infeasible task (reference behavior: separate infeasible queue);
        each dispatch is O(window), keeping the 10k-tasks-queued case
        linear overall."""
        q = self.task_queue
        while q:
            dispatched = False
            for i in range(min(len(q), 64)):
                spec = q[i]
                w = self._find_worker_for(spec)
                if w is not None:
                    del q[i]
                    self._dispatch(w, spec)
                    dispatched = True
                    break
            if not dispatched:
                asyncio.ensure_future(self._maybe_spill(q[0]))
                break
        # spawn extra workers if queue is deep and the pool is small.
        # Workers still BOOTING (spawned, not yet registered) count
        # against the pool — without that, every schedule pass during a
        # slow boot (jax import takes seconds; worse when the core is
        # contended) spawns another worker, and each new boot slows the
        # others further: a spawn storm (reference: starting-worker
        # accounting in `worker_pool.cc` MaybeStartNewWorker)
        head = self._spec_container(q[0]) if q else None
        if head is not None and not _fits(
            q[0].resources.as_dict(), self.available
        ):
            # a saturated node must not boot dedicated container
            # workers it cannot lease — they can never serve plain
            # tasks and each boot costs seconds and memory
            head = None
        # blocked workers (parked mid-task on an unavailable object)
        # don't count toward the pool: when every slot holds a blocked
        # consumer, the queued producer tasks need a fresh worker or
        # the node deadlocks on its own lineage reconstruction
        unblocked = sum(
            1 for ws in self.workers.values() if not ws.blocked
        )
        if q and (
            unblocked + self._pending_spawns < self.num_workers
            or (head is not None and self._pending_spawns == 0
                and len(self.workers) <= self.num_workers * 2)
        ):
            # container demands need a DEDICATED image-spawned worker:
            # the pre-spawned host pool can never serve them, so the
            # pool-full gate alone would starve queued container tasks
            try:
                self._spawn_worker(
                    container=((q[0].env_hash, head) if head else None)
                )
            except Exception as e:
                logger.debug("worker spawn for env failed: %s", e)
                # the env cannot be materialized on this host (no
                # podman/docker, bad image): fail the queued tasks of
                # that env with the cause — retrying every tick would
                # hang them forever while spamming the log (the lease
                # path returns env_error for the same contract)
                from ray_tpu_torch.core import serialization as ser

                bad_env = q[0].env_hash
                doomed = [s for s in q
                          if s.env_hash == bad_env
                          and self._spec_container(s) is not None]
                for s in doomed:
                    q.remove(s)
                    result = TaskResult(
                        task_id=s.task_id, status="error",
                        error=ser.serialize_to_bytes(RuntimeError(
                            "runtime_env setup failed: container "
                            f"worker spawn failed: {e}"),
                            tag=ser.TAG_ERROR),
                    )
                    asyncio.ensure_future(self._route_to_owner(
                        s.owner, "task_result", result
                    ))

    @staticmethod
    def _spec_container(spec) -> Optional[Dict]:
        """Container section of a spec's runtime env (daemon-routed
        tasks carry the full env in the spec).  env_hash-gated: specs
        with no runtime env (the overwhelmingly common case — this
        runs inside the scheduling scan) exit without touching the
        env dict."""
        if getattr(spec, "env_hash", None) is None:
            return None
        try:
            from ray_tpu_torch.core.container import container_section

            return container_section(getattr(spec, "runtime_env", None))
        except Exception as e:
            logger.debug("resolving container section failed: %s", e)
            return None

    def _find_worker_for(self, spec: TaskSpec) -> Optional[WorkerState]:
        demand = spec.resources.as_dict()
        # 1) pipeline onto a worker already leased with identical
        # demand AND runtime env
        for w in self.workers.values():
            if (
                w.kind == "worker"
                and w.actor_id is None
                and w.leased_to is None
                and not w.blocked  # parked mid-get: don't stack work
                and w.lease is not None
                and w.lease == demand
                and w.env_hash == spec.env_hash
                and len(w.in_flight) < _PIPELINE_DEPTH
            ):
                return w
        # 2) idle worker + available resources (chip/env-pinning aware)
        if _fits(demand, self.available):
            gpu_n = self._gpus_needed(demand)
            w = self._pick_idle_worker(
                gpu_n, require_no_lease=True, env_hash=spec.env_hash,
                require_exact_env=self._spec_container(spec) is not None,
            )
            if w is None:
                # idle workers may be pinned to the wrong chip count or
                # env; retire one so the queued task can't starve
                self._reclaim_idle_pinned(gpu_n, spec.env_hash)
                return None
            if gpu_n and not self._assign_chips(w, gpu_n):
                self._reclaim_idle_pinned(gpu_n, spec.env_hash)
                return None
            if spec.env_hash is not None:
                w.env_hash = spec.env_hash
            return w
        return None

    def _dispatch(self, w: WorkerState, spec: TaskSpec):
        demand = spec.resources.as_dict()
        if w.lease is None:
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) - v
            w.lease = demand
        if w.busy_since is None:
            w.busy_since = time.time()
        w.in_flight[spec.task_id.binary()] = spec
        w.conn.send("execute_task", spec)

    def _release_lease(self, w: WorkerState):
        if w.lease is not None and not w.in_flight:
            if not w.blocked:
                # a blocked worker's lease resources were already
                # returned at block time; re-adding them here would
                # mint resources out of thin air
                for k, v in w.lease.items():
                    self.available[k] = self.available.get(k, 0.0) + v
            w.blocked = False
            w.lease = None
        if w.idle:
            w.busy_since = None

    async def _memory_monitor_loop(self):
        """Poll node memory; kill a busy task worker when over the
        threshold (reference: `memory_monitor.h:52` driving
        `worker_killing_policy.h:34` in the raylet).  The killed
        worker's tasks fail back to their owners as worker_died —
        retriable work retries (possibly elsewhere), and the node
        survives instead of the kernel OOM killer taking the daemon."""
        from ray_tpu_torch.core.memory_monitor import MemoryMonitor, pick_oom_victim

        monitor = MemoryMonitor(self.cfg.memory_usage_threshold)
        period = self.cfg.memory_monitor_refresh_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                if not monitor.is_usage_above_threshold():
                    continue
                victim = pick_oom_victim(
                    list(self.workers.values()),
                    self.cfg.worker_killing_policy,
                )
                if victim is None:
                    continue
                used, total = monitor.get_memory_usage()
                logger.warning(
                    "memory usage %.1f%% above threshold %.1f%%: killing "
                    "worker %s (policy=%s) to free memory",
                    100 * used / max(total, 1),
                    100 * self.cfg.memory_usage_threshold,
                    victim.worker_id[:8],
                    self.cfg.worker_killing_policy,
                )
                victim.oom_killed_at = time.time()
                monitor.reset()  # one kill per sustained breach
                try:
                    os.kill(victim.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            except Exception:
                logger.exception("memory monitor pass failed")

    async def _retry_queue_loop(self):
        """Periodic housekeeping: re-attempt queued-but-infeasible tasks
        (cluster membership changes arrive asynchronously and nothing
        else re-triggers the scan) and report load to the controller
        (the RaySyncer-style resource gossip the autoscaler's idle
        detection reads — reference: `ray_syncer.h:88`)."""
        while True:
            await asyncio.sleep(1.0)
            if self.task_queue:
                self._schedule()
            try:
                if self.store.used > self.SPILL_HIGH * self.store.capacity:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._maybe_spill_objects
                    )
            except Exception:
                logger.exception("object spill pass failed")
            try:
                used = {
                    k: self.total_resources.get(k, 0.0) - v
                    for k, v in self.available.items()
                    if self.total_resources.get(k, 0.0) - v > 0
                }
                busy = bool(used) or bool(self.task_queue) or any(
                    w.in_flight or w.actor_id is not None
                    for w in self.workers.values()
                )
                # per-node reporter (reference: `dashboard/agent.py:25` +
                # reporter_agent.py): worker inventory + host stats ride
                # the load report, so the state API's list_workers reads
                # ONE controller snapshot instead of fanning out an RPC
                # per node per call
                from ray_tpu_torch.core.memory_monitor import _system_memory

                mem_used, mem_total = _system_memory()
                try:
                    load1 = os.getloadavg()[0]
                except OSError:
                    load1 = 0.0
                report = {
                    "used": used, "busy": busy,
                    "queued": len(self.task_queue),
                    "workers": self._worker_inventory(),
                    "host": {
                        "load1": load1,
                        "mem_used": mem_used,
                        "mem_total": mem_total,
                    },
                }
                self.controller_conn.send(
                    "report_node_load", self._load_sync_payload(report)
                )
            except Exception as e:
                logger.debug("load report dropped: %s", e)

    # RaySyncer-style delta sync (reference: `ray_syncer.h:88`): send
    # only fields that changed since the last report, a bare-version
    # heartbeat when nothing did, and a full snapshot every
    # LOAD_FULL_EVERY ticks so a restarted/diverged controller
    # resynchronizes without a handshake.
    LOAD_FULL_EVERY = 10

    def _load_sync_payload(self, report: Dict[str, Any]) -> Dict[str, Any]:
        tick = self._load_tick = getattr(self, "_load_tick", 0) + 1
        last = getattr(self, "_last_load_report", None)
        v = getattr(self, "_load_v", 0)
        if last is None or tick % self.LOAD_FULL_EVERY == 0:
            self._load_v = v = v + 1
            payload = {"node_id": self.node_id, "v": v, "full": report}
        else:
            delta = {
                k: val for k, val in report.items() if last.get(k) != val
            }
            if delta:
                self._load_v = v = v + 1
                payload = {"node_id": self.node_id, "v": v,
                           "base": v - 1, "delta": delta}
            else:
                payload = {"node_id": self.node_id, "v": v}  # heartbeat
        self._last_load_report = report
        return payload

    # ------------------------------------------------------------------
    # object spilling (reference: LocalObjectManager, SpillObjects
    # `local_object_manager.h:110`): above the high watermark, persist
    # LRU sealed objects to disk and delete them from shm; restore on
    # demand.  Distinct from eviction: spilled primaries survive without
    # lineage recomputation.
    # ------------------------------------------------------------------
    SPILL_HIGH = 0.80
    SPILL_LOW = 0.60

    def _maybe_spill_objects(self, force: bool = False,
                             drain: bool = False):
        """Runs on an executor thread (sync file IO); serialized by
        _spill_lock against concurrent urgent-spill requests.

        All file I/O rides the `core/diskio.py` chokepoint (atomic
        tmp+rename, DiskChaos-injectable).  Failure discipline: a
        write that fails UN-ELECTS its object — the bytes were never
        deleted from shm and the atomic write left no partial file —
        so a flaky disk degrades spill throughput, never data.  Real
        or injected ENOSPC latches `_spill_disk_full` and ends the
        pass; the low-disk watermark stops *electing* spills before
        the disk is actually full."""
        import errno as _errno

        with self._spill_lock:
            cap = self.store.capacity
            if cap <= 0:
                return 0
            if not force and self.store.used <= self.SPILL_HIGH * cap:
                return 0
            # a DRAINING forced spill evicts EVERY unpinned object: the
            # blocked create needs a contiguous region, and free bytes
            # above the LOW watermark may be too fragmented to satisfy
            # it — stopping at the watermark can wedge an
            # allocator-fragmented store forever at 60% used.  Callers
            # escalate to drain only after watermark-target passes
            # failed, so brief pressure doesn't dump the working set.
            target = 0 if (force and drain) else int(self.SPILL_LOW * cap)
            os.makedirs(self._spill_dir, exist_ok=True)
            if (_diskio.free_bytes(self._spill_dir)
                    < self.cfg.spill_disk_min_free_bytes):
                if not self._spill_disk_full:
                    logger.warning(
                        "spill disk below the free-space watermark "
                        "(%d MB): not electing new spills",
                        self.cfg.spill_disk_min_free_bytes >> 20,
                    )
                self._spill_disk_full = True
                _fault_metric("rt_spill_disk_full_total")
                return 0
            self._spill_disk_full = False
            spilled = 0
            spilled_bytes = 0
            for id_bytes in self.store.spill_candidates(64):
                if self.store.used <= target:
                    break
                try:
                    view = self.store.get(id_bytes, timeout_ms=0)
                except Exception as e:
                    logger.debug("spill candidate %s not gettable: %s",
                                 id_bytes.hex()[:12], e)
                    continue
                try:
                    data = bytes(view)
                finally:
                    del view
                    self.store.release(id_bytes)
                crc = (_integrity.checksum(data)
                       if self.cfg.object_integrity else None)
                path = os.path.join(self._spill_dir, id_bytes.hex() + ".bin")
                try:
                    _diskio.write_file(path, data)
                except OSError as e:
                    # un-elected: still resident in shm, no partial file
                    if e.errno == _errno.ENOSPC:
                        self._spill_disk_full = True
                        _fault_metric("rt_spill_disk_full_total")
                        logger.warning("spill hit ENOSPC; disk full — "
                                       "ending the pass")
                        break
                    _fault_metric("rt_spill_errors_total",
                                  tags={"op": "spill"})
                    logger.warning("spill write of %s failed: %s",
                                   id_bytes.hex()[:12], e)
                    continue
                if crc is not None:
                    try:  # diagnostics sidecar; the in-memory manifest
                        # entry is authoritative for verification
                        _diskio.write_file(path + ".meta", json.dumps({
                            "size": len(data), "crc": crc,
                            "algo": _integrity.ALGO,
                        }).encode())
                    except OSError as e:
                        logger.debug("spill meta for %s not written: %s",
                                     id_bytes.hex()[:12], e)
                if not self.store.delete(id_bytes):
                    # pinned between candidate scan and delete: the
                    # bytes stay resident, the file is garbage
                    self._remove_spill_files(path)
                    continue
                self._spilled[id_bytes] = _SpillEntry(
                    path, len(data), crc, _integrity.ALGO
                )
                spilled += 1
                spilled_bytes += len(data)
            if spilled:
                _md.inc("rt_object_spill_bytes_total", float(spilled_bytes))
                logger.info("spilled %d objects to disk (store %.0f%% full)",
                            spilled, 100 * self.store.used / cap)
            return spilled

    @staticmethod
    def _remove_spill_files(path: str):
        for p in (path, path + ".meta"):
            try:
                os.remove(p)
            except OSError:
                pass

    def _quarantine_spilled(self, id_bytes: bytes, ent: _SpillEntry,
                            reason: str):
        """A spilled file failed verification: move it (and its
        sidecar) aside for post-mortem instead of deleting the
        evidence, count the event, and drop the manifest entry so the
        caller falls through to lineage reconstruction."""
        os.makedirs(self._quarantine_dir, exist_ok=True)
        for p in (ent.path, ent.path + ".meta"):
            try:
                os.replace(p, os.path.join(self._quarantine_dir,
                                           os.path.basename(p)))
            except OSError:
                pass
        self._spilled.pop(id_bytes, None)
        _fault_metric("rt_object_integrity_errors_total",
                      tags={"path": "restore"})
        _fault_metric("rt_object_quarantined_total")
        logger.error(
            "spilled object %s failed verification (%s): quarantined to "
            "%s; the object is treated as lost and re-derives via "
            "lineage where retained",
            id_bytes.hex()[:12], reason, self._quarantine_dir,
        )

    def _restore_spilled(self, id_bytes: bytes) -> bool:
        import errno as _errno

        from ray_tpu_torch.core.retry import backoff_delay_s as _backoff

        with self._spill_lock:
            ent = self._spilled.get(id_bytes)
            if ent is None:
                return False
            # EIO is often transient (a device resetting): retry the
            # read through the jittered backoff schedule before
            # charging the caller a full lineage re-derivation
            data = None
            attempts = max(1, self.cfg.disk_io_retries)
            for attempt in range(attempts):
                try:
                    data = _diskio.read_file(ent.path)
                    break
                except OSError as e:
                    _fault_metric("rt_spill_errors_total",
                                  tags={"op": "restore"})
                    if (attempt + 1 >= attempts
                            or e.errno not in (_errno.EIO, _errno.EAGAIN)):
                        logger.warning(
                            "restore read of %s failed after %d "
                            "attempt(s): %s", id_bytes.hex()[:12],
                            attempt + 1, e,
                        )
                        self._spilled.pop(id_bytes, None)
                        self._remove_spill_files(ent.path)
                        return False
                    time.sleep(_backoff(attempt, base_s=0.02, cap_s=0.25))
            if len(data) != ent.size:
                self._quarantine_spilled(
                    id_bytes, ent,
                    f"size {len(data)} != recorded {ent.size}",
                )
                return False
            if (self.cfg.object_integrity
                    and not _integrity.verify(data, ent.crc, ent.algo)):
                self._quarantine_spilled(
                    id_bytes, ent,
                    f"checksum mismatch ({ent.algo} "
                    f"{_integrity.checksum(data):#x} != recorded "
                    f"{(ent.crc or 0):#x})",
                )
                return False
            if not self.store.contains(id_bytes):
                if not self._restore_into_store(id_bytes, data):
                    return False
            self._spilled.pop(id_bytes, None)
            self._remove_spill_files(ent.path)
            _md.inc("rt_object_restore_bytes_total", float(len(data)))
            return True

    def _restore_into_store(self, id_bytes: bytes, data: bytes) -> bool:
        """Create+copy+seal with the partial allocation released on ANY
        failure — an unsealed create would otherwise hold store bytes
        until a creator-death reap that never comes (the daemon is the
        creator and it is alive)."""
        for attempt in (0, 1):
            try:
                dest = self.store.create(id_bytes, len(data),
                                         allow_evict=False)
            except ObjectExistsError:
                return True  # raced another restore path
            except Exception as e:
                if attempt:
                    # still pressured; caller retries after the
                    # next spill pass frees room
                    logger.debug("restore of %s blocked: %s",
                                 id_bytes.hex()[:12], e)
                    return False
                # make room by force-spilling OTHER unpinned
                # objects (full drain: the restore needs a
                # contiguous region NOW), then retry once — a
                # restore that fails here costs the borrower a
                # full lineage re-derivation (_spill_lock is
                # reentrant)
                self._maybe_spill_objects(force=True, drain=True)
                continue
            try:
                dest[:] = data
                self.store.seal(id_bytes)
                return True
            except Exception:
                logger.exception("restore copy/seal of %s failed; "
                                 "releasing the partial allocation",
                                 id_bytes.hex()[:12])
                try:
                    del dest
                    # abort, not delete: the unsealed create holds its
                    # creator pin, which a bare delete refuses to free
                    self.store.abort(id_bytes)
                except Exception as de:
                    logger.debug("partial-restore abort failed: %s", de)
                return False
        return False

    # ------------------------------------------------------------------
    # observability plane: /metrics HTTP + batched obs frames
    # ------------------------------------------------------------------
    async def _start_metrics_http(self, bind: str):
        """Prometheus text exposition for THIS daemon's registry
        (reference: the per-node metrics agent's scrape endpoint).  A
        positive cfg port is taken literally only by the head daemon —
        worker daemons on the same host bind ephemeral ports — and a
        bind failure degrades to ephemeral instead of killing boot."""
        from ray_tpu_torch.util import httpd

        want = self.cfg.metrics_http_port
        port = want if (want > 0 and self.is_head) else 0
        try:
            self._metrics_server, self.metrics_http_port = (
                await httpd.serve_http(bind, port, self._metrics_dispatch)
            )
        except OSError as e:
            if port == 0:
                logger.warning("metrics HTTP listener failed: %s", e)
                return
            logger.warning(
                "metrics port %d unavailable (%s); using ephemeral",
                port, e,
            )
            self._metrics_server, self.metrics_http_port = (
                await httpd.serve_http(bind, 0, self._metrics_dispatch)
            )
        logger.info("noded %s /metrics on %s:%d",
                    self.node_name, bind, self.metrics_http_port)

    async def _metrics_dispatch(self, req):
        from ray_tpu_torch.metrics.registry import export_text

        if req.path.rstrip("/") == "/metrics":
            self._refresh_store_gauges()
            return 200, "text/plain; version=0.0.4", export_text().encode()
        return 404, "text/plain", b"not found"

    def _refresh_store_gauges(self):
        """Object-plane level gauges, recomputed at scrape/report time
        (no hot-path cost; bypasses the metrics_enabled gate the same
        way the dashboard's builtin gauges do)."""
        from ray_tpu_torch.metrics import metric_defs as _mdefs

        if self.store is None:
            return
        _mdefs.metric("rt_object_store_used_bytes").set(
            float(self.store.used))
        _mdefs.metric("rt_object_store_capacity_bytes").set(
            float(self.store.capacity))
        _mdefs.metric("rt_object_store_objects").set(
            float(self.store.count))
        _mdefs.metric("rt_object_spilled_objects").set(
            float(len(self._spilled)))

    async def _obs_report_loop(self):
        """One batched `report_obs` frame per interval on the existing
        controller connection: this daemon's metrics snapshot plus any
        scheduling spans recorded since the last flush.  Mirrors the
        runtime-side flush loop (`core/runtime.py`); never a
        per-sample RPC."""
        from ray_tpu_torch.metrics import exporter as _mexp

        period_s = max(0.5, self.cfg.metrics_report_interval_ms / 1000.0)
        while True:
            await asyncio.sleep(period_s)
            conn = self.controller_conn
            if conn is None or conn.closed:
                # reconnect loop restores it; spans stay in the bounded
                # export queue meanwhile (overflow there is COUNTED —
                # draining before this check would discard them silently)
                continue
            payload = _mexp.build_obs_payload(
                self.node_id, "noded", os.getpid(),
                refresh=self._refresh_store_gauges,
            )
            if payload is None:
                continue
            try:
                conn.send("report_obs", payload)
            except Exception as e:
                logger.debug("daemon obs frame dropped: %s", e)

    async def handle_cancel_task(self, payload, conn):
        """Drop a still-queued task (reference:
        CancelTask on the raylet for unleased tasks)."""
        task_id = payload["task_id"]
        for i, spec in enumerate(self.task_queue):
            if spec.task_id.binary() == task_id:
                del self.task_queue[i]
                from ray_tpu_torch.core import serialization as ser
                from ray_tpu_torch import exceptions as exc

                envelope = ser.serialize_to_bytes(
                    exc.TaskCancelledError(task_id=spec.task_id),
                    tag=ser.TAG_ERROR,
                )
                await self._route_to_owner(
                    spec.owner, "task_result",
                    TaskResult(task_id=spec.task_id, status="error",
                               error=envelope),
                )
                return {"cancelled": True}
        # dispatched already: forward to the worker running it (its
        # runtime delivers the mid-execution interrupt), then try the
        # other daemons once — daemon-routed tasks may run anywhere
        for w in list(self.workers.values()):
            if task_id in w.in_flight and w.conn and not w.conn.closed:
                try:
                    return await w.conn.call(
                        "cancel_task", {"task_id": task_id}, timeout=10
                    )
                except Exception as e:
                    logger.debug("cancel_task relay failed: %s", e)
                    return {"cancelled": False}
        if not payload.get("forwarded"):
            reply = await self._fanout_once(
                "cancel_task", {"task_id": task_id},
                done=lambda r: r and r.get("cancelled"),
            )
            if reply:
                return reply
        return {"cancelled": False}

    async def handle_restore_object(self, payload, conn):
        ok = await asyncio.get_running_loop().run_in_executor(
            None, self._restore_spilled, payload["id"]
        )
        return {"ok": ok}

    async def handle_spill_now(self, payload, conn):
        """Urgent spill on create-backpressure (the reference's create
        queue triggering spilling, `create_request_queue.h`).  The
        caller escalates `drain` after watermark-target passes failed
        to unblock its create (fragmentation)."""
        drain = bool(payload and payload.get("drain"))
        try:
            n = await asyncio.get_running_loop().run_in_executor(
                None, self._maybe_spill_objects, True, drain
            )
        except Exception:
            logger.exception("urgent spill failed")
            n = 0
        # disk_full tells the blocked producer to clamp with a typed
        # BackPressureError instead of spinning out its create deadline
        # against a disk that cannot absorb another spill
        return {"spilled": n, "disk_full": self._spill_disk_full}

    async def _maybe_spill(self, spec: TaskSpec):
        """Spillback: if this node can never or not-soon run the task,
        hand it to another node (reference: cluster_task_manager.cc:44).
        Hard label constraints ride along — spillback must never move a
        task onto a node its NodeLabelSchedulingStrategy excludes."""
        demand = spec.resources.as_dict()
        if _fits(demand, self.total_resources):
            return  # feasible here, just busy: keep queued
        if self.controller_conn is None:
            return
        query = {"resources": demand, "exclude": [self.node_id]}
        if spec.strategy.kind == "node_labels":
            query["label_hard"] = spec.strategy.label_hard
            query["label_soft"] = spec.strategy.label_soft
        target = await self.controller_conn.call("find_node_for", query)
        if target is None:
            # unschedulable cluster-wide: feed the autoscaler's demand
            # ledger (reference: pending demand in LoadMetrics driving
            # resource_demand_scheduler.py)
            try:
                self.controller_conn.send(
                    "report_pending_demand", {"resources": demand}
                )
            except Exception as e:
                logger.debug("pending-demand report dropped: %s", e)
            return  # stays queued
        for i, s in enumerate(self.task_queue):
            if s is spec:
                del self.task_queue[i]
                break
        else:
            return  # already dispatched elsewhere
        conn = await self._node_conn(target)
        conn.send("submit_task", spec)

    # ------------------------------------------------------------------
    # worker leasing: direct-push protocol (reference two-level
    # scheduling — leases granted here, tasks pushed caller->worker)
    # ------------------------------------------------------------------
    # -- GPU isolation (see core/accelerators.py) ----------------------
    def _gpus_needed(self, demand: Dict[str, float]) -> float:
        """The GPU lease a demand pins: a whole count, or a fraction of
        one card (0 < n < 1); 0 pins nothing."""
        t = float(demand.get("GPU", 0.0))
        if 0 < t < 1:
            return t
        return int(t) if t >= 1 and t.is_integer() else 0

    def _assign_chips(self, w: WorkerState, n: float) -> bool:
        """Pin `n` chips to worker `w` (no-op match if already pinned to
        exactly n) and push the isolation env over its conn.  Safe for
        the daemon-dispatch path: the env rides the same ordered stream
        as the execute_task push that follows.  The direct-push lease
        path must use `_assign_chips_acked` instead — there the task
        arrives on a different conn (caller -> worker) and nothing else
        orders the two streams."""
        if self._chip_pool is None:
            return True
        chips = self._chip_pool.assign(w.worker_id, n)
        if chips is None:
            return False
        env = accelerators.chip_isolation_env(
            list(chips), self._chip_pool.num_chips
        )
        try:
            w.conn.send("set_accel_env", env)
        except Exception as e:
            logger.debug("set_accel_env send to %s failed: %s",
                         w.worker_id[:8], e)
            return False
        return True

    async def _assign_chips_acked(self, w: WorkerState, n: float) -> bool:
        """Like `_assign_chips` but waits for the worker to acknowledge
        the env before returning, so a lease reply cannot race the
        caller's first direct task push past the isolation setup."""
        if self._chip_pool is None:
            return True
        chips = self._chip_pool.assign(w.worker_id, n)
        if chips is None:
            return False
        env = accelerators.chip_isolation_env(
            list(chips), self._chip_pool.num_chips
        )
        try:
            await w.conn.call("set_accel_env", env, timeout=10)
        except Exception as e:
            logger.debug("set_accel_env call to %s failed: %s",
                         w.worker_id[:8], e)
            return False
        return True

    def _pick_idle_worker(
        self, gpu_n: float, require_no_lease: bool = False,
        env_hash: Optional[str] = None, require_exact_env: bool = False,
    ) -> Optional[WorkerState]:
        """Idle-worker choice, chip- and env-pinning aware: an n-chip
        demand prefers a worker already pinned to n chips (its runtime
        is initialized against them), then an unpinned one.  Env
        matching is STRICT: a tainted worker serves only its own env
        hash, a clean demand only clean workers — a demand with an env
        may also take a clean worker (which becomes dedicated)."""
        pinned_match = unpinned = any_idle = None
        for w in self.workers.values():
            if not (w.kind == "worker" and w.idle and w.conn and w.socket_path):
                continue
            if require_no_lease and w.lease is not None:
                continue
            if w.env_hash is not None and w.env_hash != env_hash:
                continue  # tainted with a different env: never reuse
            if require_exact_env and w.env_hash != env_hash:
                # container envs: a plain worker cannot enter an image
                # from inside a running process — only a worker spawned
                # IN the image (pre-dedicated) may serve this demand
                continue
            # env_ready: this worker already applied the demanded env
            # (a clean worker serving an env demand is acceptable but a
            # same-env worker is better); for clean demands both are
            # equal (only clean workers reach here)
            env_ready = w.env_hash == env_hash
            held = (
                self._chip_pool.pinned(w.worker_id)
                if self._chip_pool is not None
                else None
            )
            if held is None and env_ready:
                unpinned = unpinned or w
            elif (gpu_n and held is not None
                  and self._chip_pool.shape(w.worker_id) == gpu_n):
                pinned_match = pinned_match or w
            else:
                # chip-pinned worker for a CPU demand, or a clean
                # worker for an env demand: usable fallback
                any_idle = any_idle or w
        if gpu_n:
            return pinned_match or unpinned or any_idle
        return unpinned or any_idle

    def _reclaim_idle_pinned(self, gpu_n: float,
                             env_hash: Optional[str] = None) -> None:
        """Pinning fragmentation: the demand can't be served because
        idle workers are pinned to the wrong chip shape or dedicated to
        a different runtime env.  Retire one such worker (its death
        releases chips, frees a pool slot, and respawns clean)."""
        chips_short = (
            gpu_n and self._chip_pool is not None
            and not self._chip_pool.fits(gpu_n)
        )
        for w in self.workers.values():
            if not (w.kind == "worker" and w.idle):
                continue
            held = (
                self._chip_pool.pinned(w.worker_id)
                if self._chip_pool is not None else None
            )
            chip_mismatch = (chips_short and held
                             and self._chip_pool.shape(w.worker_id) != gpu_n)
            env_mismatch = (
                w.env_hash is not None and w.env_hash != env_hash
            )
            if chip_mismatch or env_mismatch:
                try:
                    os.kill(w.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError) as e:
                    logger.debug("killing mismatched worker %d: %s",
                                 w.pid, e)
                return

    async def handle_request_lease(self, payload, conn):
        """Grant leased worker(s) to a caller (reference:
        `HandleRequestWorkerLease` node_manager.cc:1797).

        With `count` in the payload (the batched negotiation of the
        sharded owner plane) the reply is `{"grants": [(worker_id,
        socket_path), ...]}` — up to `count` grants from ONE daemon
        pass, so a submission burst amortizes lease RPCs instead of
        paying one round trip per worker.  Without `count` the legacy
        single-grant shapes are preserved: (worker_id, socket_path),
        None, {"infeasible": True}, or {"env_error": ...}."""
        demand = payload["resources"]
        holder = self._conn_worker.get(conn, "remote")
        batched = "count" in payload
        want = max(1, int(payload.get("count", 1)))
        if not _fits(demand, self.total_resources):
            # never feasible on this node: tell the caller to reroute
            # through the queue path, which spills to a feasible node
            # (reference: spillback in cluster_task_manager.cc:44)
            return {"infeasible": True}
        env_hash = payload.get("env_hash")
        container = payload.get("container")
        grants = []
        err = None
        for _ in range(want):
            grant = await self._grant_one_lease(
                demand, env_hash, container, holder
            )
            if isinstance(grant, dict):  # env_error from a spawn attempt
                err = grant
                break
            if grant is None:
                break
            grants.append(grant)
        if batched:
            if not grants and err is not None:
                return err
            return {"grants": grants}
        if grants:
            return grants[0]
        return err  # None or {"env_error": ...}

    async def _grant_one_lease(self, demand, env_hash, container, holder):
        """One grant attempt: (worker_id, socket_path) on success, None
        when nothing is available right now (spawn-on-demand may have
        been kicked), or {"env_error": ...} when the env can never
        materialize here."""
        if not _fits(demand, self.available):
            return None
        gpu_n = self._gpus_needed(demand)
        w = self._pick_idle_worker(
            gpu_n, env_hash=env_hash,
            require_exact_env=container is not None,
        )
        if w is not None:
            # reserve BEFORE any await: a concurrent lease request must
            # see these resources as taken or the node oversubscribes
            # (same reserve-then-wait shape as handle_host_actor)
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) - v
            ok = True
            if gpu_n:
                ok = await self._assign_chips_acked(w, gpu_n)
            if ok and not w.idle:
                # the env ack yielded the loop: somebody else took this
                # worker meanwhile
                ok = False
            if not ok:
                for k, v in demand.items():
                    self.available[k] = self.available.get(k, 0.0) + v
                w = None
        if w is not None:
            if env_hash is not None:
                # dedicate only on a SUCCESSFUL grant: a worker must
                # never be marked with an env it never applied
                w.env_hash = env_hash
            w.lease = dict(demand)
            w.leased_to = holder
            w.busy_since = time.time()
            return (w.worker_id, w.socket_path)
        self._reclaim_idle_pinned(gpu_n, env_hash)
        # blocked workers don't count toward the spawn cap (reference:
        # blocked workers are excluded from the pool-size accounting,
        # which is how Ray runs more workers than cores while gets are
        # parked): when every slot holds a consumer blocked on an
        # object only a queued producer can re-derive, the producer
        # needs a fresh worker or the node deadlocks
        unblocked = sum(
            1 for ws in self.workers.values() if not ws.blocked
        )
        if self._pending_spawns == 0 and unblocked <= self.num_workers * 2:
            try:
                self._spawn_worker(
                    container=((env_hash, container) if container else None)
                )
            except Exception as e:
                logger.debug("worker spawn failed: %s", e)
                # surface spawn failures (no podman on host, bad image)
                # to the caller: the driver fails the queued tasks with
                # a runtime-env error instead of retrying forever
                return {"env_error": f"container worker spawn failed: {e}"}
        return None

    # ------------------------------------------------------------------
    # blocked-worker CPU release (reference: raylet HandleTaskBlocked /
    # HandleTaskUnblocked): a worker whose in-task get() parks on an
    # unavailable object hands its lease resources back so the work
    # that PRODUCES the object (spill restores are daemon-side, but
    # lineage re-derivation needs a worker slot) can be scheduled —
    # possibly on a freshly spawned worker when the whole pool is
    # blocked.  Unblock re-charges the resources; the node may run
    # transiently oversubscribed, exactly like the reference.
    # ------------------------------------------------------------------
    async def handle_worker_blocked(self, payload, conn):
        wid = self._conn_worker.get(conn)
        w = self.workers.get(wid) if wid else None
        if w is None or w.blocked or w.lease is None:
            return {"ok": False}
        w.blocked = True
        for k, v in w.lease.items():
            self.available[k] = self.available.get(k, 0.0) + v
        self._schedule()
        return {"ok": True}

    async def handle_worker_unblocked(self, payload, conn):
        wid = self._conn_worker.get(conn)
        w = self.workers.get(wid) if wid else None
        if w is None or not w.blocked:
            return {"ok": False}
        w.blocked = False
        if w.lease is not None:
            for k, v in w.lease.items():
                self.available[k] = self.available.get(k, 0.0) - v
        return {"ok": True}

    async def handle_return_lease(self, payload, conn):
        w = self.workers.get(payload["worker_id"])
        if w is None or w.leased_to is None:
            return {"ok": False}
        w.leased_to = None
        w.in_flight.clear()
        self._release_lease(w)
        self._schedule()
        return {"ok": True}

    async def handle_resolve_worker_socket(self, payload, conn):
        node_id = payload.get("node_id", self.node_id)
        if node_id != self.node_id:
            try:
                c = await self._node_conn(node_id)
                return await c.call(
                    "resolve_worker_socket",
                    {"node_id": node_id, "worker_id": payload["worker_id"]},
                )
            except Exception as e:
                logger.debug("resolve_worker_socket relay failed: %s", e)
                return None
        w = self.workers.get(payload["worker_id"])
        return w.socket_path if w else None

    # ------------------------------------------------------------------
    # task completion (noded-dispatched tasks only; direct pushes reply
    # straight to the owner)
    # ------------------------------------------------------------------
    async def handle_task_done(self, payload, conn):
        result: TaskResult = payload["result"]
        owner = payload["owner"]
        wid = self._conn_worker.get(conn)
        w = self.workers.get(wid) if wid else None
        if w is not None:
            w.in_flight.pop(result.task_id.binary(), None)
            self._release_lease(w)
        await self._route_to_owner(owner, "task_result", result)
        self._schedule()

    # worker replies arrive as task_result on its registration conn for
    # tasks this daemon dispatched (spillback / relayed actor tasks)
    handle_task_result = handle_task_done

    async def handle_task_result_batch(self, payload, conn):
        """Coalesced completion frame from a worker (daemon-dispatched
        tasks reply on the registration conn): per-result lease
        bookkeeping, then ONE routed frame to the owner for the whole
        batch — the daemon's relay cost stays O(#frames)."""
        results = list(payload.results)
        owner = tuple(payload.owner)
        wid = self._conn_worker.get(conn)
        w = self.workers.get(wid) if wid else None
        if w is not None:
            for r in results:
                w.in_flight.pop(r.task_id.binary(), None)
            self._release_lease(w)
        await self._route_to_owner(owner, "task_result_batch", payload)
        self._schedule()

    async def handle_task_stream(self, payload, conn):
        """Relay one streaming-generator item to the task's owner (used
        when the executor's direct conn to the owner is gone, and for
        daemon-dispatched tasks whose items arrive on the worker's
        registration conn)."""
        await self._route_to_owner(payload["owner"], "stream_item", payload)

    handle_stream_item = handle_task_stream

    async def handle_route_node(self, payload, conn):
        """Forward a daemon method call to another node's daemon (the
        state API's cross-node fan-out rides this)."""
        node_id = payload["node_id"]
        method = payload["method"]
        if node_id == self.node_id:
            handler = getattr(self, "handle_" + method)
            return await handler(payload.get("payload"), conn)
        c = await self._node_conn(node_id)
        return await c.call(method, payload.get("payload"), timeout=10)

    def _worker_inventory(self):
        return [
            {
                "worker_id": w.worker_id,
                "pid": w.pid,
                "kind": w.kind,
                "actor_id": w.actor_id.hex() if w.actor_id else None,
                "idle": w.idle,
                "node_id": self.node_id,
            }
            for w in self.workers.values()
        ]

    async def handle_list_workers(self, payload, conn):
        """Worker inventory for the state API and fault-injection
        harnesses (reference: worker listing via the dashboard state
        aggregator + `_private/test_utils.py` killer actors)."""
        return self._worker_inventory()

    async def handle_memory_table(self, payload, conn):
        """Node-level object-memory table for `rt memory` (reference:
        `ray memory` / `internal_api.py:34`): every local runtime's
        reference table plus this daemon's store occupancy and spilled
        primaries."""
        async def _one(w):
            try:
                s = await w.conn.call("memory_summary", {}, timeout=5)
            except Exception as e:
                # process died/hung mid-listing
                logger.debug("memory_summary from %s failed: %s",
                             w.worker_id[:8], e)
                return None
            s["worker_id"] = w.worker_id
            s["worker_kind"] = w.kind
            return s

        # concurrent polls: one wedged worker costs the slowest single
        # timeout, not N of them — `rt memory` gets run exactly when a
        # worker IS wedged, and the sick node must stay in the report
        live = [w for w in self.workers.values()
                if w.conn is not None and not w.conn.closed]
        procs = [
            s for s in await asyncio.gather(*[_one(w) for w in live])
            if s is not None
        ]
        with self._spill_lock:
            spilled = [i.hex() for i in self._spilled]
        store = {}
        try:
            store = {
                "used": self.store.used,
                "capacity": self.store.capacity,
            }
        except Exception as e:
            logger.debug("store stats unavailable: %s", e)
        return {
            "node_id": self.node_id,
            "store": store,
            "spilled": spilled,
            "processes": procs,
        }

    async def handle_profile_worker(self, payload, conn):
        """On-demand stack profile of one local worker (reference:
        `modules/reporter/profile_manager.py:78` py-spy dumps; here a
        pure-Python all-thread stack dump served by the worker runtime,
        with py-spy used instead when installed)."""
        w = self.workers.get(payload["worker_id"])
        if w is None:
            return {"error": "no such worker"}
        import shutil

        if payload.get("native") and shutil.which("py-spy") \
                and payload.get("mode", "stacks") == "stacks":
            # py-spy covers the one-shot dump only; flamegraph/memory
            # modes always use the in-process profilers
            proc = await asyncio.create_subprocess_exec(
                "py-spy", "dump", "--pid", str(w.pid),
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.STDOUT,
            )
            out, _ = await proc.communicate()
            return {"stacks": out.decode(errors="replace"), "pid": w.pid}
        if w.conn is None or w.conn.closed:
            return {"error": "worker not connected"}
        # mode: stacks (default, one-shot) | flamegraph (sampled CPU,
        # folded-stack output) | memory (tracemalloc window) —
        # reference: py-spy dump/record + memray in profile_manager.py
        mode = payload.get("mode", "stacks")
        duration = float(payload.get("duration_s", 5.0))
        try:
            if mode == "flamegraph":
                out = await w.conn.call(
                    "profile_cpu", {"duration_s": duration,
                                    "hz": payload.get("hz", 99.0)},
                    timeout=duration + 30,
                )
            elif mode == "memory":
                out = await w.conn.call(
                    "profile_memory", {"duration_s": duration,
                                       "top": payload.get("top", 30)},
                    timeout=duration + 30,
                )
            else:
                out = await w.conn.call("dump_stacks", None, timeout=10)
        except Exception as e:
            logger.debug("profile of %s failed: %s", w.worker_id[:8], e)
            return {"error": str(e)}
        return {"stacks": out, "pid": w.pid, "mode": mode}

    async def _fanout_once(self, method: str, payload: Dict[str, Any],
                           done=None, timeout: float = 10.0,
                           wait_reply: bool = True):
        """One-hop broadcast of a daemon method to every other alive
        daemon (with forwarded=True so peers don't re-broadcast).
        With wait_reply, stops early when `done(reply)` is truthy and
        returns that reply; otherwise fire-and-forget to all."""
        try:
            nodes = await self.controller_conn.call("get_nodes", None)
        except Exception as e:
            logger.debug("fanout get_nodes failed: %s", e)
            return None
        payload = {**payload, "forwarded": True}
        for n in nodes or []:
            if not n.get("alive") or n["node_id"] == self.node_id:
                continue
            try:
                c = await self._node_conn(n["node_id"])
                if not wait_reply:
                    c.send(method, payload)
                    continue
                reply = await c.call(method, payload, timeout=timeout)
                if done is not None and done(reply):
                    return reply
            except Exception as e:
                logger.debug("fanout %s to a peer failed: %s", method, e)
        return None

    async def handle_force_cancel_task(self, payload, conn):
        """Force-cancel: SIGKILL the worker running the task (reference:
        CancelTask force_kill).  The task's owner sees worker_died ->
        WorkerCrashedError.  Daemon-routed tasks may run anywhere:
        search locally, then forward one hop cluster-wide."""
        tid = payload["task_id"]
        for w in list(self.workers.values()):
            if tid in w.in_flight:
                try:
                    os.kill(w.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                return {"killed": True}
        if payload.get("forwarded"):
            return {"killed": False}
        reply = await self._fanout_once(
            "force_cancel_task", {"task_id": tid},
            done=lambda r: r and r.get("killed"),
        )
        return reply or {"killed": False}

    async def handle_stream_cancel(self, payload, conn):
        """Abandoned-stream stop signal for a daemon-dispatched task.
        The owner doesn't know where it runs: target the local worker
        whose in-flight set has it; if none, forward once to the other
        daemons (spillback may have moved it cluster-wide)."""
        tid = payload["task_id"]
        for w in list(self.workers.values()):
            if tid in w.in_flight and w.conn and not w.conn.closed:
                try:
                    w.conn.send("stream_cancel", {"task_id": tid})
                except Exception as e:
                    logger.debug("stream_cancel to worker failed: %s", e)
                return
        if payload.get("forwarded"):
            return  # one hop only: every daemon has now checked locally
        await self._fanout_once(
            "stream_cancel", {"task_id": tid}, wait_reply=False
        )

    async def _route_to_owner(self, owner: Tuple[str, str], method: str, payload):
        node_id, worker_id = owner
        if node_id == self.node_id:
            w = self.workers.get(worker_id)
            if w is not None and w.conn and not w.conn.closed:
                w.conn.send(method, payload)
            return
        try:
            conn = await self._node_conn(node_id)
            conn.send("route", {
                "target": owner, "method": method, "payload": payload,
                "want_reply": False,
            })
        except Exception:
            logger.warning("could not route %s to %s", method, owner)

    # ------------------------------------------------------------------
    # generic routing (owner protocol, borrows, value fetch)
    # ------------------------------------------------------------------
    async def handle_route(self, payload, conn):
        target = payload["target"]
        node_id, worker_id = target
        if node_id != self.node_id:
            c = await self._node_conn(node_id)
            if payload.get("want_reply"):
                return await c.call("route", payload)
            c.send("route", payload)
            return None
        w = self.workers.get(worker_id)
        if w is None or w.conn is None or w.conn.closed:
            if payload.get("want_reply"):
                return ("gone",)
            return None
        if payload.get("want_reply"):
            return await w.conn.call(payload["method"], payload["payload"])
        w.conn.send(payload["method"], payload["payload"])
        return None

    async def _node_conn(self, node_id: str) -> rpc.Connection:
        conn = self._node_conns.get(node_id)
        if conn is not None and not conn.closed:
            return conn
        addr = self._node_addrs.get(node_id)
        if addr is None:
            addr = await self.controller_conn.call("get_node_addr", {"node_id": node_id})
            if addr is None:
                raise rpc.RpcError(f"unknown node {node_id}")
            self._node_addrs[node_id] = tuple(addr)
        conn = await rpc.connect_tcp(
            *self._node_addrs[node_id], handler=self._handle_peer, name=f"noded->{node_id[:8]}"
        )
        self._node_conns[node_id] = conn
        return conn

    async def _handle_peer(self, method, payload, conn):
        fn = getattr(self, "handle_" + method, None)
        if fn is None:
            raise rpc.RpcError(f"noded: no handler {method!r}")
        return await fn(payload, conn)

    # ------------------------------------------------------------------
    # object plane: transfer + free (reference: object_manager.h)
    # ------------------------------------------------------------------
    async def handle_pull_object(self, payload, conn):
        """Pull an object from a remote node into the local store,
        chunked and admission-controlled (reference: `ObjectManager`
        chunked transfer, `object_manager.h:206`; memory-bounded pull
        admission, `pull_manager.h:92`).  Concurrent pulls of the same
        object dedup onto one future; large objects stream in
        `object_transfer_chunk_bytes` pieces written straight into a
        pre-created shm buffer, so daemon RSS stays O(chunk), not
        O(object)."""
        id_bytes, node_id = payload["id"], payload["node_id"]
        if self.store.contains(id_bytes):
            return {"ok": True}
        fut = self._pulls.get(id_bytes)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._pulls[id_bytes] = fut
            try:
                await self._pull_into_store(id_bytes, node_id)
                fut.set_result(True)
            except Exception as e:
                logger.debug("pull of %s failed: %s", id_bytes.hex()[:12], e)
                fut.set_exception(e)
            finally:
                self._pulls.pop(id_bytes, None)
        await fut
        return {"ok": True}

    async def _pull_into_store(self, id_bytes: bytes, node_id: str):
        """One attempt re-fetches on checksum mismatch — a transient
        transfer corruption costs one round trip; a SECOND mismatch
        means the source's copy itself is bad, and the object is
        treated as lost (`ObjectCorruptionError` rides the error reply
        back to the owner, whose lineage path re-derives it)."""
        from ray_tpu_torch.exceptions import ObjectCorruptionError

        c = await self._node_conn(node_id)
        chunk = self.cfg.object_transfer_chunk_bytes
        for attempt in (0, 1):
            # single round trip for the common small case: fetch_object
            # returns ("obj", bytes, crc, algo), or ("too_large", size,
            # crc, algo) when the object needs the chunked path
            reply = await c.call(
                "fetch_object", {"id": id_bytes, "max_bytes": chunk},
                timeout=120,
            )
            if reply is None:
                raise rpc.RpcError("object not on remote node")
            if isinstance(reply, tuple) and reply[0] == "too_large":
                size, crc, algo = reply[1], reply[2], reply[3]
                if await self._pull_chunked(c, id_bytes, size, crc, algo):
                    return
            else:
                data, crc, algo = (
                    reply[1:4] if isinstance(reply, tuple) else (reply, None, None)
                )
                ok = (not self.cfg.object_integrity
                      or _integrity.verify(data, crc, algo))
                if ok:
                    if not self.store.contains(id_bytes):
                        self.store.put(id_bytes, data)
                    return
            _fault_metric("rt_object_integrity_errors_total",
                          tags={"path": "transfer"})
            logger.warning(
                "object %s failed checksum on receive from %s "
                "(attempt %d)%s", id_bytes.hex()[:12], node_id[:8],
                attempt + 1, "" if attempt == 0 else "; treating as lost",
            )
        raise ObjectCorruptionError(
            f"object {id_bytes.hex()} failed checksum verification on "
            f"node-to-node receive twice; the source copy is corrupt",
        )

    async def _pull_chunked(self, c, id_bytes: bytes, size: int,
                            crc, algo) -> bool:
        """Chunked pull into a pre-created shm buffer; verifies the
        assembled object against the source's checksum BEFORE sealing.
        Returns False on checksum mismatch (buffer discarded, caller
        may retry); raises on transfer errors."""
        await self._admit_pull(size)
        try:
            try:
                dest = self.store.create(id_bytes, size)
            except ObjectExistsError:
                return True  # raced another path that materialized it
            sealed = False
            nxt = None
            chunk = self.cfg.object_transfer_chunk_bytes
            try:
                # one-ahead prefetch: the next chunk's network round
                # trip overlaps this chunk's shm memcpy
                nxt = asyncio.ensure_future(c.call(
                    "fetch_chunk",
                    {"id": id_bytes, "offset": 0, "len": chunk},
                    timeout=60,
                ))
                for off in range(0, size, chunk):
                    data = await nxt
                    nxt = None
                    next_off = off + chunk
                    if next_off < size:
                        nxt = asyncio.ensure_future(c.call(
                            "fetch_chunk",
                            {"id": id_bytes, "offset": next_off,
                             "len": min(chunk, size - next_off)},
                            timeout=60,
                        ))
                    if data is None:
                        raise rpc.RpcError(
                            "remote dropped object mid-transfer"
                        )
                    dest[off:off + len(data)] = data
                del data
                if (self.cfg.object_integrity
                        and not _integrity.verify(dest, crc, algo)):
                    return False  # finally-block discards the buffer
                self.store.seal(id_bytes)
                sealed = True
            finally:
                if nxt is not None:  # error path: reap the prefetch
                    nxt.cancel()
                del dest
                if not sealed:
                    try:
                        # abort releases the creator pin a bare delete
                        # refuses, so the partial allocation frees NOW
                        self.store.abort(id_bytes)
                    except Exception as e:
                        logger.debug("dropping unsealed %s: %s",
                                     id_bytes.hex()[:12], e)
            return True
        finally:
            self._release_pull(size)

    async def _admit_pull(self, size: int):
        """Bound total bytes of concurrent inbound transfers by what
        the store can hold (reference: pull_manager.h:92
        UpdatePullsBasedOnAvailableMemory).  At least one pull always
        proceeds so a single object larger than the budget still
        transfers (and hits the store's own create backpressure)."""
        budget = max(
            self.cfg.object_transfer_chunk_bytes,
            int(self.store.capacity * 0.5),
        )
        if self._pull_cv is None:
            self._pull_cv = asyncio.Condition()
        async with self._pull_cv:
            await self._pull_cv.wait_for(
                lambda: self._inflight_pull_bytes == 0
                or self._inflight_pull_bytes + size <= budget
            )
            self._inflight_pull_bytes += size

    def _release_pull(self, size: int):
        self._inflight_pull_bytes -= size
        if self._pull_cv is None:
            return

        async def _notify():
            async with self._pull_cv:
                self._pull_cv.notify_all()

        asyncio.ensure_future(_notify())

    async def handle_object_info(self, payload, conn):
        """Size lookup for a local object, restoring spilled primaries
        so subsequent chunk fetches can be served."""
        id_bytes = payload["id"]
        for attempt in (0, 1):
            try:
                buf = self.store.get(id_bytes, timeout_ms=0)
                try:
                    return {"size": buf.nbytes}
                finally:
                    self.store.release(id_bytes)
            except Exception as e:
                logger.debug("object %s not in store (%s); trying "
                             "spilled copy", id_bytes.hex()[:12], e)
                if attempt or not await asyncio.get_running_loop().run_in_executor(
                    None, self._restore_spilled, id_bytes
                ):
                    return None

    async def handle_fetch_chunk(self, payload, conn):
        id_bytes, off, ln = payload["id"], payload["offset"], payload["len"]
        for attempt in (0, 1):
            try:
                buf = self.store.get(id_bytes, timeout_ms=0)
            except Exception as e:
                # the object may have been spilled mid-transfer (it is
                # unpinned between chunk fetches): restore and retry
                logger.debug("chunk source %s not pinned (%s); "
                             "restoring", id_bytes.hex()[:12], e)
                if attempt or not await asyncio.get_running_loop(
                ).run_in_executor(None, self._restore_spilled, id_bytes):
                    return None
                continue
            try:
                return bytes(buf[off:off + ln])
            finally:
                self.store.release(id_bytes)
        return None

    # ------------------------------------------------------------------
    # cross-node DAG channels (reference: remote mutable objects,
    # `experimental_mutable_object_provider.h`) — the ring lives on the
    # reader's node; remote writers relay through the daemons.  The
    # blocking ring ops run in worker threads so a full ring stalls the
    # writer's pending reply, not this daemon's event loop.
    # ------------------------------------------------------------------
    async def handle_chan_remote_write(self, payload, conn):
        node_id = payload["node_id"]
        if node_id != self.node_id:
            c = await self._node_conn(node_id)
            timeout_s = payload.get("timeout_ms", 120000) / 1000.0
            return await c.call(
                "chan_remote_write", payload, timeout=timeout_s + 15
            )
        # dedicated pool: a write blocks up to its timeout while the
        # reader's ring is full — parking those on the loop's shared
        # default executor would starve every other run_in_executor
        # user (spill restores, the close that would unblock them, ...)
        if self._chan_pool is None:
            import concurrent.futures

            self._chan_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="noded-chan"
            )
        return await asyncio.get_running_loop().run_in_executor(
            self._chan_pool, self._chan_write_local, payload
        )

    def _chan_write_local(self, payload) -> Dict[str, Any]:
        from ray_tpu_torch.dag.channel import SPILL_KIND, ring_geometry
        from ray_tpu_torch.shm import ChannelClosedError

        chan_h = payload["chan"]
        data = payload["payload"]
        kind = payload["kind"]
        spill_key = payload.get("spill_key")
        timeout_ms = payload.get("timeout_ms", 120000)
        # the writer ships its channel geometry so a relay that races
        # the reader's open still creates the ring with the right shape
        nslots, slot_size = ring_geometry(
            payload.get("ring_slots"), payload.get("slot_bytes")
        )
        try:
            # returns False when the ring already exists (idempotent)
            self.store.chan_create(chan_h, nslots=nslots,
                                   slot_size=slot_size)
            if spill_key is None:
                self.store.chan_write(chan_h, data, kind=kind,
                                      timeout_ms=timeout_ms)
            else:
                if self.store.contains(spill_key):
                    self.store.delete(spill_key)
                self.store.put(spill_key, data)
                try:
                    self.store.chan_write(chan_h, spill_key,
                                          kind=SPILL_KIND.get(kind, kind),
                                          timeout_ms=timeout_ms)
                except Exception:
                    self.store.delete(spill_key)
                    raise
            return {"status": "ok"}
        except ChannelClosedError:
            return {"status": "closed"}
        except TimeoutError:
            return {"status": "timeout"}
        except Exception as e:
            logger.debug("channel write failed: %s", e)
            return {"status": "error", "error": str(e)}

    async def handle_chan_remote_close(self, payload, conn):
        return await self._chan_ring_op(payload, close_only=True)

    async def handle_chan_remote_destroy(self, payload, conn):
        return await self._chan_ring_op(payload, close_only=False)

    async def _chan_ring_op(self, payload, close_only: bool):
        node_id = payload["node_id"]
        if node_id != self.node_id:
            c = await self._node_conn(node_id)
            method = "chan_remote_close" if close_only else "chan_remote_destroy"
            return await c.call(method, payload, timeout=30)

        # close/delete are non-blocking C calls (brief mutex hold): run
        # inline so they can never queue behind stalled ring writes
        try:
            self.store.chan_close(payload["chan"])
        except Exception as e:
            logger.debug("chan_close failed: %s", e)
        if not close_only:
            try:
                self.store.chan_delete(payload["chan"])
            except Exception as e:
                logger.debug("chan_delete failed: %s", e)
        return {"status": "ok"}

    async def handle_fetch_object(self, payload, conn):
        id_bytes = payload["id"]
        try:
            buf = self.store.get(id_bytes, timeout_ms=0)
        except Exception as e:
            logger.debug("meta source %s not in store (%s); trying "
                         "spilled copy", id_bytes.hex()[:12], e)
            restored = await asyncio.get_running_loop().run_in_executor(
                None, self._restore_spilled, id_bytes
            )
            if not restored:
                return None
            try:
                buf = self.store.get(id_bytes, timeout_ms=0)
            except Exception as e:
                logger.debug("restored %s still not gettable: %s",
                             id_bytes.hex()[:12], e)
                return None
        try:
            # the transfer checksum is computed fresh per fetch (never
            # cached by id: a reconstructed object can reuse its id
            # with byte-different content, and a stale cached crc
            # would poison every later transfer as "corrupt")
            crc = (_integrity.checksum(buf)
                   if self.cfg.object_integrity else None)
            algo = _integrity.ALGO if crc is not None else None
            max_bytes = payload.get("max_bytes")
            if max_bytes is not None and buf.nbytes > max_bytes:
                # chunked-transfer handshake: size + checksum, no payload
                return ("too_large", buf.nbytes, crc, algo)
            return ("obj", bytes(buf), crc, algo)
        finally:
            self.store.release(id_bytes)

    async def handle_free_object(self, payload, conn):
        self.store.delete(payload["id"])
        ent = self._spilled.pop(payload["id"], None)
        if ent is not None:
            self._remove_spill_files(ent.path)

    async def handle_free_remote(self, payload, conn):
        node_id = payload["node_id"]
        if node_id == self.node_id:
            self.store.delete(payload["id"])
            return
        try:
            c = await self._node_conn(node_id)
            c.send("free_object", {"id": payload["id"]})
        except Exception as e:
            logger.debug("free_object forward to %s failed: %s",
                         node_id[:8], e)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    async def handle_host_actor(self, aspec: ActorCreationSpec, conn):
        """Controller asks this node to host an actor: dedicate a worker
        (reference: actor creation runs as a special task on a leased
        worker, gcs_actor_scheduler.h)."""
        demand = aspec.resources.as_dict()
        if not _fits(demand, self.available):
            return {"ok": False, "error": "resources no longer available"}
        # reserve BEFORE the wait loop so concurrent host_actor requests
        # cannot both pass the feasibility check and oversubscribe
        for k, v in demand.items():
            self.available[k] = self.available.get(k, 0.0) - v
        gpu_n = self._gpus_needed(demand)
        from ray_tpu_torch.core.runtime_env import runtime_env_hash as _reh

        actor_env_hash = _reh(aspec.runtime_env)
        # NOT _spec_container: its env_hash fast-gate is for TaskSpecs;
        # ActorCreationSpec carries runtime_env without an env_hash
        from ray_tpu_torch.core.container import container_section

        actor_container = container_section(aspec.runtime_env)
        target = None
        # generous: a fresh worker's first boot imports torch and
        # initialises CUDA (seconds a worker, multiplied under CPU
        # contention); 60s raced that boot and spuriously failed actor
        # creation on loaded hosts
        deadline = time.monotonic() + 240
        while target is None:
            target = self._pick_idle_worker(
                gpu_n, require_no_lease=True, env_hash=actor_env_hash,
                require_exact_env=actor_container is not None,
            )
            if target is not None and gpu_n and not self._assign_chips(
                target, gpu_n
            ):
                target = None
                self._reclaim_idle_pinned(gpu_n, actor_env_hash)
            if target is None:
                if time.monotonic() > deadline:
                    for k, v in demand.items():
                        self.available[k] = self.available.get(k, 0.0) + v
                    return {"ok": False, "error": "no idle worker"}
                if self._pending_spawns == 0:
                    try:
                        self._spawn_worker(container=(
                            (actor_env_hash, actor_container)
                            if actor_container else None
                        ))
                    except Exception as e:
                        logger.debug("actor worker spawn failed: %s", e)
                        for k, v in demand.items():
                            self.available[k] = (
                                self.available.get(k, 0.0) + v
                            )
                        return {"ok": False,
                                "error": f"worker spawn failed: {e}"}
                await asyncio.sleep(0.02)
        if actor_env_hash is not None:
            # even if __init__ fails and the worker returns to the
            # pool, its process already applied this env: tainted
            target.env_hash = actor_env_hash
        target.actor_id = aspec.actor_id.binary()
        target.lease = demand
        try:
            reply = await target.conn.call("create_actor_instance", aspec, timeout=300)
        except rpc.RemoteError as e:
            # user __init__ raised: the worker is alive — return it to
            # the pool instead of declaring it dead
            target.actor_id = None
            target.lease = None
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) + v
            return {"ok": False, "error": f"actor __init__ failed: {e}"}
        except Exception as e:
            logger.debug("actor __init__ crashed on %s: %s",
                         target.worker_id[:8], e)
            self._on_worker_dead(target, f"actor init crashed: {e}")
            return {"ok": False, "error": f"actor __init__ failed: {e}"}
        if not reply.get("ok"):
            target.actor_id = None
            target.lease = None
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) + v
            return {"ok": False, "error": reply.get("error", "init failed")}
        self._hosted_actors[aspec.actor_id.binary()] = (
            aspec, target.worker_id
        )
        # replace the consumed pool worker (booting spawns count: see
        # the spawn-storm note in _schedule)
        free = sum(1 for w in self.workers.values()
                   if w.kind == "worker" and w.actor_id is None)
        if free + self._pending_spawns < self.num_workers:
            self._spawn_worker()
        return {"ok": True, "worker_id": target.worker_id}

    async def handle_submit_actor_task(self, payload, conn):
        spec: TaskSpec = payload["spec"]
        actor_addr = payload["actor_addr"]
        node_id, worker_id = actor_addr
        if node_id == self.node_id:
            w = self.workers.get(worker_id)
            if w is None or w.conn is None or w.conn.closed:
                result = TaskResult(task_id=spec.task_id, status="worker_died")
                await self._route_to_owner(spec.owner, "task_result", result)
                return
            w.in_flight[spec.task_id.binary()] = spec
            w.conn.send("execute_task", spec)
        else:
            c = await self._node_conn(node_id)
            c.send("submit_actor_task", payload)

    async def handle_kill_worker(self, payload, conn):
        w = self.workers.get(payload["worker_id"])
        if w is None:
            return {"ok": False}
        try:
            os.kill(w.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return {"ok": True}

    # ------------------------------------------------------------------
    # introspection / state API
    # ------------------------------------------------------------------
    async def handle_node_stats(self, payload, conn):
        return {
            "node_id": self.node_id,
            "total_resources": self.total_resources,
            "available_resources": self.available,
            "num_workers": len([w for w in self.workers.values() if w.kind == "worker"]),
            "queued_tasks": len(self.task_queue),
            "in_flight": sum(len(w.in_flight) for w in self.workers.values()),
            "store_used": self.store.used if self.store else 0,
            "store_capacity": self.store.capacity if self.store else 0,
            "store_objects": self.store.count if self.store else 0,
            "metrics_port": self.metrics_http_port,
            # per-worker lease/blocked detail (`rt status` debugging of
            # a wedged node: WHO holds the CPUs and who is parked)
            "workers": [
                {
                    "id": w.worker_id[:8], "kind": w.kind,
                    "blocked": w.blocked, "lease": w.lease,
                    "leased_to": w.leased_to,
                    "in_flight": len(w.in_flight),
                    "actor": w.actor_id is not None,
                }
                for w in self.workers.values()
            ],
        }

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    async def shutdown(self):
        try:
            os.remove(self.socket_path)  # 'auto' discovery hygiene
        except OSError:
            pass
        if self.controller is not None:
            self.controller.flush_snapshot()
        self._draining = True
        for w in self.workers.values():
            if w.proc is not None or w.kind == "worker":
                try:
                    os.kill(w.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError) as e:
                    logger.debug("killing worker %d at shutdown: %s",
                                 w.pid, e)
        if self.unix_server:
            await self.unix_server.stop()
        if self.tcp_server:
            await self.tcp_server.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
            await self._metrics_server.wait_closed()
        if self.store:
            self.store.close()
            ShmStore.unlink(self.shm_name)
        sock_dir = os.path.dirname(self.socket_path)
        if sock_dir != self.session_dir:  # a short dir of _socket_path's
            import shutil

            shutil.rmtree(sock_dir, ignore_errors=True)



# sun_path holds 108 bytes with its NUL; the workers' sockets
# (`w_<12 hex>.sock`) sit beside the daemon's
_SUN_PATH_MAX = 107
_SOCK_NAME_MAX = 24


def _socket_path(session_dir: str, name: str) -> str:
    """`name` in the session dir, or, where a socket path there would
    pass AF_UNIX's limit (a long TMPDIR), in a directory of its own
    under /tmp named by a hash of the session dir, so no two sessions
    share one."""
    if len(session_dir.encode()) + 1 + _SOCK_NAME_MAX <= _SUN_PATH_MAX:
        return os.path.join(session_dir, name)
    h = hashlib.sha1(os.path.abspath(session_dir).encode()).hexdigest()
    d = os.path.join("/tmp", f"rtt_sock_{h[:16]}")
    os.makedirs(d, mode=0o700, exist_ok=True)
    return os.path.join(d, name)


def _default_store_capacity() -> int:
    try:
        import shutil

        free = shutil.disk_usage("/dev/shm").free
        return max(256 * 1024 * 1024, int(free * 0.3))
    except Exception as e:
        logger.debug("sizing /dev/shm failed (%s); using 1GiB default", e)
        return 1024 * 1024 * 1024


# ----------------------------------------------------------------------
# process entry
# ----------------------------------------------------------------------
async def _amain(args):
    logging.basicConfig(
        level=os.environ.get("RTT_LOG_LEVEL", "INFO").upper(),
        format="%(asctime)s noded %(levelname)s %(message)s",
    )
    daemon = NodeDaemon(
        session_dir=args.session_dir,
        is_head=args.head,
        controller_addr=tuple(args.controller.split(":")) if args.controller else None,
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources=json.loads(args.resources) if args.resources else None,
        num_workers=args.num_workers,
        labels=json.loads(args.labels) if args.labels else None,
    )
    if daemon.controller_addr and not args.head:
        host, port = daemon.controller_addr
        daemon.controller_addr = (host, int(port))
    await daemon.start()
    if args.ready_file:
        daemon.write_ready_file(args.ready_file)

    stop = asyncio.Event()

    def _sig(*_a):
        stop.set()

    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGTERM, _sig)
    loop.add_signal_handler(signal.SIGINT, _sig)
    # exit if our parent (the driver) disappears
    ppid = os.getppid()

    async def _parent_watch():
        while True:
            await asyncio.sleep(1)
            if os.getppid() != ppid:
                stop.set()
                return

    asyncio.ensure_future(_parent_watch())
    await stop.wait()
    await daemon.shutdown()


def _primary_ip() -> str:
    """Primary interface IP (what peers on other hosts can reach when
    binding 0.0.0.0).  The UDP connect never sends a packet; it only
    asks the kernel which source address routes outward."""
    import socket

    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


def main():
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    p = argparse.ArgumentParser()
    p.add_argument("--session-dir", required=True)
    p.add_argument("--head", action="store_true")
    p.add_argument("--controller", default=None, help="host:port when joining")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default=None, help="json dict")
    p.add_argument("--labels", default=None, help="json dict of node labels")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--ready-file", default=None)
    args = p.parse_args()
    os.makedirs(os.path.join(args.session_dir, "logs"), exist_ok=True)
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
