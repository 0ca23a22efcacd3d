"""Per-process runtime: the CoreWorker equivalent.

Embedded in every driver and worker process (reference:
`src/ray/core_worker/core_worker.h:295`).  Owns:

- the io thread running the asyncio control plane (connections to the
  local node daemon, the controller, and leased/peer workers),
- the in-process store for small/direct-return objects (reference:
  `store_provider/memory_store/`) and the node's shm store client,
- the reference counter (owner-side local/submitted/borrower counts —
  reference: `reference_count.h:64`),
- the task manager (pending tasks, retries, lineage for reconstruction —
  reference: `task_manager.h:208`); the completion state machine lives
  in `core/completion.py`,
- the SHARDED lease-based submitter (`core/owner_shard.py`): workers
  are leased from the node daemon (batched grants), then tasks are
  pushed DIRECTLY to the leased worker over its socket, pipelined,
  bypassing the daemon on the hot path (reference two-level scheduling:
  `normal_task_submitter.h:75`, lease pipelining, and `SubmitActorTask`
  direct pushes `actor_task_submitter.h:75`).  With `owner_shards` > 1
  the submission/completion lanes run on N event loops keyed by task
  id (docs/control_plane.md),
- task execution when running as a worker (reference:
  `core_worker.cc:2908` ExecuteTask), with per-caller ordered actor
  queues (`transport/actor_scheduling_queue.h`) and per-tick coalesced
  `task_result_batch` replies (`core/completion.py`).

Submission runs entirely on the calling thread (spec build, state
registration under a lock, frame pickling) and hands the owning
shard's loop only a batched flush — this is what makes >10k tasks/s
feasible in Python.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import os
import random
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeoutError
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.core import completion as _completion
from ray_tpu_torch.core import rpc, serialization as ser
from ray_tpu_torch.core.config import Config, get_config
from ray_tpu_torch.core.owner_shard import (
    PIPELINE_DEPTH,
    OwnerShard,
    shard_index,
)
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.retry import RetryBudget, backoff_delay_s
from ray_tpu_torch.metrics import metric_defs as _mdefs
from ray_tpu_torch.core.task_spec import (
    STREAMING,
    ActorCreationSpec,
    ArgRef,
    Resources,
    SchedulingStrategy,
    TaskResult,
    TaskSpec,
    function_id_of,
)
from ray_tpu_torch.shm import ObjectNotFoundError, ShmStore
from ray_tpu_torch.util import sanitizer as _sanitizer

logger = logging.getLogger(__name__)

# `rt memory` callsite column, opt-in like the reference's
# RAY_record_ref_creation_sites (stack capture per ref is too costly to
# leave on by default)
_RECORD_CALLSITES = os.environ.get(
    "RTT_RECORD_REF_CREATION_SITES", ""
) not in ("", "0")


import sysconfig as _sysconfig

_STDLIB_PREFIX = _sysconfig.get_paths().get("stdlib", "/nonexistent")
# the installed package directory, NOT a name substring — a user
# checkout whose path merely contains "ray_tpu_torch" must still get
# callsites
_PKG_PREFIX = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _creation_site() -> str:
    """First stack frame outside the ray_tpu_torch package AND the stdlib,
    as 'file:line in fn' — the user frame that created the ref."""
    for f in reversed(traceback.extract_stack(limit=16)[:-2]):
        fn = f.filename or ""
        if not fn.startswith(_PKG_PREFIX) and not fn.startswith(
                _STDLIB_PREFIX):
            return f"{fn}:{f.lineno} in {f.name}"
    return ""

# Ambient end-to-end deadline of the task currently executing in this
# context: a ContextVar (not a thread-local) because async actors
# interleave many tasks on ONE io-loop thread — each asyncio task gets
# its own context copy, so a nested `.remote()` inherits exactly its
# parent's budget and never a concurrent neighbor's.  Pool threads set
# it at task start (overwrite, even to None), so reuse can't leak one.
_ambient_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "rt_ambient_deadline", default=None
)


def remaining_deadline_s():
    """The executing task's remaining end-to-end budget in seconds, or
    None when no deadline is in force.  Read-only view of the ambient
    deadline for code that wants to PROPAGATE the budget into a
    non-task queue (e.g. the serve LLM engine's admission queue, so
    queued requests can be shed once their caller must have given up)
    rather than spawn nested tasks."""
    deadline = _ambient_deadline.get()
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


def _wake_nudge():
    """No-op callback: waking the selector is the entire point."""


_INLINE = "inline"
_SHM = "shm"
# sentinel for "not resolved by the fast arg-pin pass" (_try_pin_args)
_UNRESOLVED = object()
# pipelining depth lives with the lease machinery now
# (core/owner_shard.py); the alias keeps the exec-pool sizing below
# reading naturally
_PIPELINE_DEPTH = PIPELINE_DEPTH

# how long an executor polls the controller's KV for a function blob
# that its task refers to by id before it gives up: the driver's put is
# one-way, so a later task of the same function can land on another
# worker before the first task's blob reached the KV
_FUNCTION_EXPORT_WAIT_S = 5.0


@dataclass
class _ObjectState:
    """Owner-side record of one owned object."""

    ready: asyncio.Event
    where: Optional[str] = None  # "inline" | "shm"
    value: Optional[bytes] = None  # serialized envelope when inline
    node_id: Optional[str] = None  # location when in shm
    size: int = 0
    error: Optional[bytes] = None  # serialized error envelope
    #: seal-time checksum for the opt-in local-get verifier
    #: (object_integrity_verify_get); None = not recorded
    checksum: Optional[int] = None


@dataclass
class _StreamState:
    """Owner-side record of one streaming-generator task.

    Reference: the streaming-generator refs the TaskManager tracks
    (`src/ray/core_worker/task_manager.h:208` — generator returns are
    dynamically appended as the executor yields).  Items arrive as
    `stream_item` messages ahead of the final `task_result`; each item
    becomes an owned object (inline or shm) addressable by
    `ObjectID.for_return(task_id, index)`.
    """

    event: asyncio.Event
    # yield-index -> item ref: keyed (not appended) so delivery-path
    # switches mid-stream (direct conn -> daemon relay) or retry replays
    # can never reorder consumption — the consumer always takes index
    # consumed+1
    items: Dict[int, "ObjectRef"] = field(default_factory=dict)
    consumed: int = 0
    total: Optional[int] = None  # set by the final ok task_result
    error: Optional[bytes] = None  # error envelope ends the stream
    # set once when the producing task finishes (ok or error) — for
    # completion watchers that must not race the consumer's `event`
    done: asyncio.Event = field(default_factory=asyncio.Event)


@dataclass
class _RefCount:
    local: int = 0
    submitted: int = 0
    borrowers: int = 0
    # Binary pin: 1 while an owned ref sits inside some serialized
    # container (task return / put) that no consumer has registered yet;
    # released by the first borrow registration or local deserialization.
    contained: int = 0
    # In-flight protection for FOREIGN-owned refs this process forwards
    # inside serialized messages (task args / returns): while transit>0
    # the entry survives local drops, so our borrow stays registered at
    # the owner until the receiver has registered ITS borrow — closing
    # the forwarded-ref window of the reference's borrower protocol
    # (`reference_count.h:64` + WaitForRefRemoved; here the receiver's
    # registration is acknowledged before the carrying task's result).
    transit: int = 0
    # True while this process holds a registered borrow at the ref's
    # owner (drives exactly-one add_borrow/remove_borrow per entry
    # lifetime regardless of how local/transit counts interleave).
    registered: bool = False
    # owner address for borrowed entries, so EVERY deletion path
    # (_maybe_free) can send the final remove_borrow
    owner_addr: Optional[tuple] = None
    # owner-side borrower identity ledger: address -> count (reference:
    # the owner tracks WHICH workers borrow, `reference_count.h:64`)
    borrower_addrs: Dict[tuple, int] = field(default_factory=dict)
    # Lineage pins (reference: `reference_count.h` lineage reachability):
    # +1 per DOWNSTREAM return object whose retained lineage names this
    # ref as a task argument.  While > 0 the entry (and its lineage
    # entry, if owned) survives user drops, so reconstructing a lost
    # downstream object can re-derive its inputs — without this, a
    # multi-stage pipeline that drops intermediate refs for memory
    # (the shuffle exchange) loses reconstructability mid-chain.
    # Released when the downstream object's own lineage entry is popped
    # at ITS free (cascading the release up the chain).
    lineage: int = 0
    # creation callsite ("file:line in fn"), recorded only under
    # RTT_RECORD_REF_CREATION_SITES=1 (reference:
    # RAY_record_ref_creation_sites + `ray memory` callsite column)
    callsite: str = ""

    def total(self):
        return (self.local + self.submitted + self.borrowers
                + self.contained + self.transit + self.lineage)


@dataclass
class _PendingTask:
    spec: TaskSpec
    retries_left: int
    # (inner_id, owner) pairs: foreign refs serialized into this task's
    # args, transit-pinned until the task's FINAL completion
    transit: List[Tuple[bytes, tuple]] = field(default_factory=list)
    # retries already granted for this task (drives the backoff
    # exponent and the failure message's attempt accounting)
    attempts: int = 0
    # owner-side deadline watchdog (asyncio TimerHandle), cancelled at
    # FINAL completion so the loop doesn't hold a live timer for the
    # full timeout_s of every already-finished call; survives retries
    # (the deadline covers the whole lineage)
    deadline_timer: Optional[object] = None
    # registration instant: basis of the submit->final-completion
    # latency histogram (`rt_owner_task_latency_seconds`); always
    # stamped (one clock read), only OBSERVED when metrics are on
    t_submit: float = field(default_factory=time.monotonic)


# Process-wide per-actor sequence numbers: every caller path (handles,
# lineage reconstruction) draws from the same counter so the executor's
# in-order delivery sees one consistent stream per caller process.
_actor_seq_counters: Dict[Tuple[bytes, Optional[str]], int] = {}
_actor_seq_lock = threading.Lock()


def next_actor_seq(aid: bytes, group: Optional[str] = None) -> int:
    """Per-(actor, concurrency-group) sequence counter: each group is
    its own ordered stream, so a gap in one lane never stalls another
    (reference: per-group scheduling queues in
    `concurrency_group_manager.h`)."""
    with _actor_seq_lock:
        key = (aid, group)
        n = _actor_seq_counters.get(key, 0)
        _actor_seq_counters[key] = n + 1
        return n


class Runtime:
    """One per process; `driver` or `worker` mode."""

    def __init__(self, mode: str):
        self.mode = mode
        self.cfg: Config = get_config()
        self.job_id = JobID.random()
        self.worker_id = WorkerID.random()
        self.node_id: str = ""
        self.loop = asyncio.new_event_loop()
        _sanitizer.register_loop(self.loop, "rt-io", audit_timers=False)
        self._io_thread = threading.Thread(
            target=self._run_loop, name="rt-io", daemon=True
        )
        self.noded: Optional[rpc.Connection] = None
        self.controller: Optional[rpc.Connection] = None
        self.store: Optional[ShmStore] = None
        self.my_socket: Optional[str] = None
        self._server: Optional[rpc.Server] = None

        # owner-side state; _state_lock guards dict mutation from the
        # submitting thread; the io thread holds it in result handlers
        self._state_lock = _sanitizer.wrap_lock(
            threading.RLock(), "runtime._state_lock",
            _sanitizer.RUNTIME_STATE_LOCK,
        )
        self.objects: Dict[bytes, _ObjectState] = {}
        self.refs: Dict[bytes, _RefCount] = {}
        self.pending_tasks: Dict[bytes, _PendingTask] = {}
        self.lineage: Dict[bytes, TaskSpec] = {}  # return id -> creating spec
        self._streams: Dict[bytes, _StreamState] = {}  # task id -> stream

        # lease-based submission is owner-sharded: each shard owns its
        # lease pools, its worker connections, and (shards > 1) its own
        # event loop + node-daemon connection (core/owner_shard.py).
        # Shard 0 with owner_shards == 1 shares this runtime's io loop —
        # the classic single-owner plane.
        self._shards: List[OwnerShard] = []
        # actor submission: direct conns to actor workers
        self._actor_conns: Dict[bytes, rpc.Connection] = {}
        self._actor_queue: Dict[bytes, deque] = {}
        self._actor_assigned: Dict[rpc.Connection, Dict[bytes, TaskSpec]] = {}
        self._actor_connecting: set = set()
        self._actor_addr: Dict[bytes, Tuple[str, str]] = {}

        # function export cache: id(fn) -> (fid, blob, pinned fn)
        self._fn_export: Dict[int, Tuple[bytes, bytes, Any]] = {}
        self._exported_fids: set = set()
        self._fn_cache: Dict[bytes, Any] = {}

        # executor-side state; pool width >= _PIPELINE_DEPTH so pushed
        # tasks always find a thread (see _PIPELINE_DEPTH comment)
        self._exec_pool = ThreadPoolExecutor(
            max_workers=max(8, _PIPELINE_DEPTH), thread_name_prefix="rt-exec"
        )
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self._actor_aspec: Optional[ActorCreationSpec] = None
        # keyed by (caller_worker_id, concurrency_group): one ordered
        # delivery stream per lane
        self._actor_seq_expect: Dict[tuple, int] = {}
        self._actor_seq_buffer: Dict[tuple, Dict[int, TaskSpec]] = {}
        self._actor_drain_lock: Optional[asyncio.Lock] = None
        # executor-side duplicate-delivery fence: task id -> the
        # serial of the conn it was dispatched from, bounded FIFO (a
        # SERIAL, not id(): a recycled object address must never make
        # a reconnect retry look like a replay).  A stale-seq arrival
        # whose task id is in here ON THE SAME CONNECTION is a
        # transport REPLAY (dropped — its original reply rides the
        # same live stream); the same task id on a NEW connection is a
        # reconnect retry whose original result died with the old
        # conn, and must re-execute — see _exec_actor_ordered.
        self._actor_dispatched: Dict[bytes, int] = {}
        self._actor_dispatched_order: deque = deque()
        # per-(caller, group) gap timers: advance past sequence numbers
        # that never arrive (consumed by a previous actor incarnation)
        self._actor_seq_timers: Dict[tuple, object] = {}
        self._put_counter = 0
        self._task_local = threading.local()
        # parked-operation count behind the blocked-worker protocol
        # (get()/arg-materialize stalls; see _notify_blocked)
        self._blocked_ops = 0
        self._blocked_ops_lock = threading.Lock()
        # shm objects this process has materialized via get: the pin is
        # held for the process lifetime because deserialized numpy/jax
        # values are zero-copy views into the segment (the reference
        # pins plasma buffers the same way while Python buffers exist)
        self._held_pins: set = set()
        # container object id -> borrows/pins it holds on inner refs
        self._contained_in: Dict[bytes, list] = {}
        # object id -> threading.Events set when _maybe_free retires
        # the entry (wait_freed: event-driven lifetime assertions for
        # tests/tools instead of wall-clock contains() polling)
        self._free_waiters: Dict[bytes, list] = {}
        # executor side: task id -> transit pins on foreign refs that
        # rode out in that task's returns (released by transit_release)
        self._return_transit: Dict[bytes, list] = {}
        # owner side: task id -> registration-ack futures for contained
        # borrows arriving in STREAM items (awaited with the final
        # result's acks before transit_release)
        self._stream_reg_acks: Dict[bytes, list] = {}
        # borrow-registration ACKs outstanding in this worker; awaited
        # before any task result is sent (see on_ref_deserialized)
        self._pending_borrow_acks: list = []
        # driver side: recent worker log lines (name, pid, stream, line)
        # received via worker_log — tests and tooling read this; the
        # lines are also echoed to stderr (core/log_stream.py)
        self._worker_log_lines: deque = deque(maxlen=2000)
        # pubsub: channel -> list of local subscriber queues; channels
        # registered with the controller (re-sent after a reconnect)
        self._pubsub_queues: Dict[str, list] = {}
        self._pubsub_registered: set = set()
        # channels whose last (un)subscribe RPC outcome is unknown
        # (timeout / cancelled mid-RPC); resolved by the reconciler
        self._pubsub_uncertain: set = set()
        # single-writer reconciler serializes all (un)subscribe RPCs on
        # the io loop (see _pubsub_reconcile); binds to the loop on
        # first acquisition
        self._pubsub_async_lock = asyncio.Lock()
        # coalesced ref-event channel (reference: `src/ray/pubsub/` —
        # WaitForRefRemoved rides a per-worker-pair channel so borrow
        # traffic is O(#counterparts), not O(#objects)): un-ACK'd
        # add/remove borrow events queue per owner address and flush as
        # ONE routed frame per counterpart per flush window
        self._ref_event_lock = threading.Lock()
        self._ref_event_queues: Dict[tuple, list] = {}
        self._ref_event_flush_scheduled = False
        # bulk-resolved owner replies awaiting their per-ref consumer
        # (io-loop only; see _prime_borrowed)
        self._primed_replies: Dict[bytes, object] = {}
        # executing normal tasks: task_id -> thread ident (cancellation)
        self._task_threads: Dict[bytes, int] = {}
        # runtime-env dedication (worker mode): hash applied, if any
        self._applied_env_hash: Optional[str] = None
        self._shutdown = False
        # retry pacing: one budget per runtime (retries spend, successes
        # refill — core/retry.py) and a seeded jitter rng so chaos tests
        # replay deterministically under a fixed RTT_RETRY_JITTER_SEED
        self._retry_budget = RetryBudget(
            cap=self.cfg.task_retry_budget_cap,
            refill=self.cfg.task_retry_budget_refill,
        )
        _seed = os.environ.get("RTT_RETRY_JITTER_SEED")
        self._retry_rng = random.Random(int(_seed) if _seed else None)
        # actor-reconnect backoff state: aid -> consecutive dial failures
        self._actor_connect_attempts: Dict[bytes, int] = {}
        from ray_tpu_torch.core.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer(
            max_buffer=self.cfg.task_events_buffer_size
        )
        # config can enable core-path metrics without the env flag
        # (init(_system_config={"metrics_enabled": True})); set_enabled
        # mirrors it into the env so spawned children inherit
        if self.cfg.metrics_enabled:
            from ray_tpu_torch.metrics import metric_defs as _md

            _md.set_enabled(True)
        # executor-side completion coalescing (core/completion.py):
        # results for one owner ship as one frame per loop tick
        self._result_coalescer = _completion.ResultCoalescer(self)

    # ------------------------------------------------------------------
    # bootstrap
    # ------------------------------------------------------------------
    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        # /proc-readable identity for the per-plane CPU accounting
        # (perf.py --owner-shards reports per-shard us/task)
        self._io_native_tid = threading.get_native_id()
        self.loop.run_forever()

    def start(self, node_socket: str, controller_addr: Tuple[str, int],
              serve_dir: Optional[str] = None):
        self._io_thread.start()
        fut = asyncio.run_coroutine_threadsafe(
            self._connect(node_socket, controller_addr, serve_dir), self.loop
        )
        fut.result(timeout=self.cfg.rpc_connect_timeout_s)
        # owner shards: drivers honor cfg.owner_shards; workers always
        # run the shared single-shard plane (their nested submissions
        # are a side channel, not the bottleneck)
        n = (max(1, int(self.cfg.owner_shards))
             if self.mode == "driver" else 1)
        self._shards = [OwnerShard(self, i, shared=(n == 1))
                        for i in range(n)]
        for s in self._shards:
            s.start(node_socket)

    def _shard_for(self, task_id_bytes: bytes) -> OwnerShard:
        return self._shards[shard_index(task_id_bytes, len(self._shards))]

    def _find_lease(self, conn):
        """-> (shard, pool, lease) owning `conn`, or None."""
        for shard in self._shards:
            entry = shard.conn_lease.get(conn)
            if entry is not None:
                return (shard, *entry)
        return None

    def owner_shard_stats(self) -> List[Dict]:
        """Per-shard accounting for tests and perf.py: submitted /
        completed / lease + queue depth / CPU seconds per shard."""
        return [s.stats() for s in self._shards]

    def _wake_main_loop(self):
        """Wake this runtime's io loop after an off-thread completion:
        ready-Event waiter callbacks queued with plain `call_soon` from
        a shard/submitter thread never wake a selector sleeping in
        `run_forever` — a `call_soon_threadsafe` no-op writes the
        self-pipe and the loop drains everything queued.  Called by
        completion.complete_task's finally block."""
        if threading.current_thread() is self._io_thread:
            return  # in-loop completion: call_soon already suffices
        try:
            self.loop.call_soon_threadsafe(_wake_nudge)
        except RuntimeError:
            pass  # loop closed mid-teardown

    async def _connect(self, node_socket, controller_addr, serve_dir):
        if serve_dir is not None:
            # workers serve a socket so owners push tasks directly
            self.my_socket = os.path.join(
                serve_dir, f"w_{self.worker_id.hex()[:12]}.sock"
            )
            self._server = rpc.Server(
                self, name=f"worker-{self.worker_id.hex()[:8]}", handler=self._handle
            )
            await self._server.start_unix(self.my_socket)
        self.noded = await rpc.connect_unix(
            node_socket, handler=self._handle, name="noded"
        )
        self._flush_task = asyncio.ensure_future(
            self._flush_task_events_loop()
        )
        self._controller_addr = tuple(controller_addr)
        self.controller = await rpc.connect_tcp(
            *controller_addr, handler=self._handle, name="controller"
        )
        self.controller.on_close = self._on_controller_lost
        info = await self.noded.call(
            "register",
            {
                "kind": self.mode,
                "worker_id": self.worker_id.hex(),
                "pid": os.getpid(),
                "job_id": self.job_id.hex(),
                "socket_path": self.my_socket,
                # spawn-token boot accounting + container pre-dedication
                # (set by the daemon's _spawn_worker; absent for drivers)
                "spawn_token": os.environ.get("RTT_SPAWN_TOKEN"),
                "env_hash": os.environ.get("RTT_ENV_HASH"),
            },
        )
        self.node_id = info["node_id"]
        self.store = ShmStore(info["shm_name"])

    # -- controller reconnect (mirrors the daemon-side loop; reference:
    # drivers reconnect to a restarted GCS at its known address and the
    # job continues, `gcs_redis_failure_detector.h`) -------------------
    def _on_controller_lost(self, conn):
        if self._shutdown:
            return
        logger.warning("driver lost controller connection; reconnecting")
        asyncio.ensure_future(self._reconnect_controller())

    async def _reconnect_controller(self):
        deadline = time.monotonic() + self.cfg.controller_reconnect_timeout_s
        while time.monotonic() < deadline and not self._shutdown:
            try:
                conn = await rpc.connect_tcp(
                    *self._controller_addr, handler=self._handle,
                    name="controller",
                )
            except Exception as e:
                logger.debug("controller connect failed: %s", e)
                await asyncio.sleep(1.0)
                continue
            conn.on_close = self._on_controller_lost
            self.controller = conn
            # the restarted controller marked this incarnation's jobs
            # DEAD (drivers of the previous life are presumed gone):
            # re-register so job status reflects the live driver —
            # mirrors the daemon loop's register_node
            if self.mode == "driver":
                try:
                    await conn.call("register_job", {
                        "job_id": self.job_id.hex(), "pid": os.getpid(),
                    })
                except Exception:
                    logger.exception("job re-registration failed")
            # durable resubscribe: the restarted controller has no
            # memory of this connection's pubsub registrations — reset
            # the registered view and let the reconciler re-drive it
            # from desired state (serialized with any concurrent
            # subscribe/close, so a just-closed channel can't be
            # resurrected here)
            with self._state_lock:
                self._pubsub_registered.clear()
                self._pubsub_uncertain.clear()
            task = asyncio.ensure_future(self._pubsub_reconcile())
            task.add_done_callback(lambda t: t.cancelled() or t.exception())
            logger.info("driver reconnected to controller")
            return
        if not self._shutdown:
            logger.error("controller unreachable; driver calls will fail")

    @property
    def address(self) -> Tuple[str, str]:
        return (self.node_id, self.worker_id.hex())

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        # own-loop owner shards close their lease/noded conns on their
        # OWN loops (Task.cancel is loop-affine), then stop those loops
        for s in self._shards:
            if not s.shared:
                s.stop()

        async def _close():
            flush = getattr(self, "_flush_task", None)
            if flush is not None:
                flush.cancel()
            # push any queued borrow releases out before the routes die
            # (best-effort: owners also clean up on connection loss)
            try:
                await self._flush_ref_events(immediate=True)
            except Exception as e:
                logger.debug("final ref-event flush failed: %s", e)
            # final task-event drain so the last flush period's events
            # reach the controller before the connection dies
            events = self.task_events.drain()
            if events and self.controller is not None:
                try:
                    self.controller.send("report_task_events", {"events": events})
                    await asyncio.sleep(0.05)  # let the write flush
                except Exception as e:
                    logger.debug("final task-event report dropped: %s", e)
            # ... and the last obs frame (spans/metrics of a short-lived
            # process would otherwise never reach the collector)
            if self._ship_obs_frame():
                await asyncio.sleep(0.05)
            if self._server:
                await self._server.stop()
            for s in self._shards:
                if s.shared:
                    await s.close_shared()
            for conn in list(self._actor_conns.values()):
                await conn.close()
            if self.noded:
                await self.noded.close()
            if self.controller:
                await self.controller.close()

        try:
            asyncio.run_coroutine_threadsafe(_close(), self.loop).result(timeout=5)
        except Exception as e:
            logger.debug("io-loop close incomplete: %s", e)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._io_thread.join(timeout=5)
        self._exec_pool.shutdown(wait=False)
        for pool in getattr(self, "_group_pools", {}).values():
            pool.shutdown(wait=False)
        if self.store:
            for id_bytes in self._held_pins:
                try:
                    self.store.release(id_bytes)
                except Exception as e:
                    logger.debug("releasing pin at shutdown: %s", e)
            self._held_pins.clear()
            self.store.close()

    # ------------------------------------------------------------------
    # helpers bridging threads
    # ------------------------------------------------------------------
    def _run(self, coro, timeout=None, block_grace=None):
        try:
            fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        except BaseException:
            # loop already closed (teardown race): the coroutine object
            # must be closed or CPython warns 'never awaited' at GC
            coro.close()
            raise
        notified = False
        remaining = timeout
        if block_grace is not None and (timeout is None
                                        or timeout > block_grace):
            # blocked-worker protocol (reference: raylet
            # HandleTaskBlocked): an in-task get that outlives the
            # grace window reports this worker as parked, releasing
            # its lease CPUs so the tasks that PRODUCE the awaited
            # objects (lineage re-derivation) can be scheduled — on a
            # freshly spawned worker when the whole pool is blocked.
            # Skipped entirely for timeouts at or under the grace: a
            # short-timeout poll must expire on ITS schedule.
            try:
                return fut.result(block_grace)
            except (TimeoutError, _FutureTimeoutError):
                if not fut.done():
                    notified = self._notify_blocked()
            if remaining is not None:
                remaining = max(0.0, remaining - block_grace)
        try:
            return fut.result(remaining)
        except (TimeoutError, _FutureTimeoutError) as e:
            # both spellings: before 3.11 concurrent.futures.TimeoutError
            # is NOT the builtin TimeoutError.  When the CORO itself
            # raised a timeout-flavored error (DeadlineExceeded on a ref,
            # user TimeoutError), surface it untouched; only an expired
            # WAIT becomes GetTimeoutError.  `fut.done()` alone can't
            # distinguish the two — the coro may complete in the window
            # between the wait expiring and this handler running — so
            # check whether `e` is actually the future's outcome.
            if fut.done():
                coro_err = fut.exception()
                if coro_err is e:
                    raise
                if coro_err is not None:
                    raise coro_err
                return fut.result()  # completed during the race window
            fut.cancel()
            raise exc.GetTimeoutError(
                f"timed out after {timeout}s", timeout_s=timeout
            )
        finally:
            if notified:
                self._notify_unblocked()

    async def _await_blocking_aware(self, coro, grace: float = 0.05):
        """Await `coro` on the io loop; when it outlives `grace`,
        report this worker blocked to the daemon (releasing its lease
        CPUs) until it completes — the async-path twin of the
        `block_grace` handling in `_run`."""
        if self.mode != "worker" or self.noded is None:
            return await coro
        task = asyncio.ensure_future(coro)
        done, _ = await asyncio.wait({task}, timeout=grace)
        if done:
            return task.result()
        notified = self._notify_blocked()
        try:
            return await task
        finally:
            if notified:
                self._notify_unblocked()

    def _notify_blocked(self) -> bool:
        """Count one parked operation; the daemon hears about the
        0 -> 1 transition only.  Several tasks can be parked on one
        worker concurrently (pipelined pushes, actor concurrency) —
        a per-operation send would let the FIRST task to resume mark
        the whole worker unblocked while its siblings still wait."""
        with self._blocked_ops_lock:
            self._blocked_ops += 1
            first = self._blocked_ops == 1
        if first:
            try:
                self.noded.send_threadsafe("worker_blocked", {})
            except Exception as e:
                logger.debug("worker_blocked notify failed: %s", e)
        return True

    def _notify_unblocked(self) -> None:
        with self._blocked_ops_lock:
            self._blocked_ops -= 1
            last = self._blocked_ops == 0
        if last:
            try:
                self.noded.send_threadsafe("worker_unblocked", {})
            except Exception as e:
                logger.debug("worker_unblocked notify failed: %s", e)

    # ------------------------------------------------------------------
    # cancellation (reference: CoreWorker::CancelTask + the executor's
    # cancellation wrapper `_raylet.pyx:2055`)
    # ------------------------------------------------------------------
    def cancel(self, ref: ObjectRef, force: bool = False):
        """Cancel the task that creates `ref` (reference: CancelTask +
        the Cython cancellation wrapper, `_raylet.pyx:2055`).

        Non-force: queued tasks are dropped; pushed-but-unstarted tasks
        are skipped by the executor; RUNNING normal tasks get
        TaskCancelledError raised asynchronously in their executing
        thread (lands at the next Python bytecode boundary — C-blocking
        calls finish first, same caveat as the reference's
        KeyboardInterrupt delivery).  force=True SIGKILLs the executing
        worker: the ref then fails with WorkerCrashedError, matching
        reference semantics; actor tasks reject force (killing the
        worker is `rt.kill(actor)`)."""
        task_id = ref.id.task_id().binary()
        with self._state_lock:
            pt = self.pending_tasks.get(task_id)
            if pt is None:
                return False  # finished or never ours
            if force and pt.spec.actor_id is not None:
                raise ValueError(
                    "force=True is not allowed for actor tasks; use "
                    "rt.kill(actor) to terminate the actor process"
                )
            pt.retries_left = 0  # a cancelled task never retries
            spec = pt.spec
            # 1. still in a local lease-pool queue: drop it here.
            # shard.lock nests inside _state_lock (documented order);
            # released before _fail_cancelled so the completion path's
            # own shard.lock acquisition can't self-deadlock
            dropped = False
            for shard in self._shards:
                with shard.lock:
                    for pool in shard.pools.values():
                        for queued in list(pool.queue):
                            if queued.task_id.binary() == task_id:
                                pool.queue.remove(queued)
                                dropped = True
                                break
                        if dropped:
                            break
                if dropped:
                    break
            if dropped:
                self._fail_cancelled(task_id, spec)
                return True
            # 1b. actor tasks are NEVER dropped owner-side: per-caller
            # seq_nos were assigned at submit and the executor's ordered
            # queue would wait forever on a gap — instead the cancel
            # rides the normal path and the executor replies
            # TaskCancelledError without running the method (seq chain
            # intact)
        # 2. pushed (or routed via noded): ask the execution side —
        # asynchronously (best-effort, like the reference): the caller
        # must not block while an actor connection establishes
        asyncio.run_coroutine_threadsafe(
            self._cancel_remote(task_id, spec, force), self.loop
        )
        return True

    async def _cancel_remote(self, task_id: bytes, spec: TaskSpec,
                             force: bool = False):
        conns = []
        lease_worker = None
        for shard in self._shards:
            with shard.lock:
                for pool, lease in shard.conn_lease.values():
                    if task_id in lease.assigned:
                        conns.append(lease.conn)
                        lease_worker = lease.worker_id
        if spec.actor_id is not None:
            with self._state_lock:
                c = self._actor_conns.get(spec.actor_id.binary())
            if c is not None:
                conns.append(c)
        if force:
            # reference force-cancel: kill the executing worker; the
            # pending task fails with worker_died -> WorkerCrashedError
            try:
                if lease_worker is not None:
                    await self.noded.call(
                        "kill_worker", {"worker_id": lease_worker},
                        timeout=10,
                    )
                    return
                # routed through a daemon (spillback/strategy): the
                # daemons find and kill the hosting worker
                reply = await self.noded.call(
                    "force_cancel_task", {"task_id": task_id},
                    timeout=10,
                )
                if reply and reply.get("killed"):
                    return
                # nobody is RUNNING it: it may still sit in a daemon
                # queue — fall through to the drop path below
            except Exception as e:
                logger.debug("cancel probe failed: %s", e)
                return
        if spec.actor_id is not None and not conns:
            # connection still being established: wait briefly so the
            # cancel can land on the executor before the task starts
            for _ in range(50):
                await asyncio.sleep(0.1)
                with self._state_lock:
                    c = self._actor_conns.get(spec.actor_id.binary())
                if c is not None:
                    conns.append(c)
                    break
        for conn in conns:
            try:
                # lease conns live on shard loops with owner_shards > 1:
                # call via the conn's own loop (rpc.call_on_conn_loop)
                reply = await rpc.call_on_conn_loop(
                    conn, "cancel_task", {"task_id": task_id}, timeout=5
                )
                if reply and reply.get("cancelled"):
                    return
            except Exception as e:
                logger.debug("cancel_task on executor failed: %s", e)
        # not found on any executor (e.g. queued in noded): best-effort
        try:
            await self.noded.call("cancel_task", {"task_id": task_id})
        except Exception as e:
            logger.debug("cancel_task via noded failed: %s", e)

    def _fail_cancelled(self, task_id: bytes, spec: TaskSpec):
        envelope = ser.serialize_to_bytes(
            exc.TaskCancelledError(task_id=spec.task_id),
            tag=ser.TAG_ERROR,
        )
        self._complete_task(TaskResult(
            task_id=spec.task_id, status="error", error=envelope,
        ))

    async def _h_cancel_task(self, payload, conn):
        """Executor side: drop the task if it has not started; if it IS
        running (normal tasks only), raise TaskCancelledError in its
        executing thread (reference: the Cython wrapper delivering
        KeyboardInterrupt into the running task, `_raylet.pyx:2055`).
        The exception lands at the next bytecode boundary."""
        task_id = payload["task_id"]
        started = getattr(self, "_started_tasks", None)
        if started is None:
            started = self._started_tasks = set()
        if task_id in started:
            # check-and-raise under _state_lock: _call registers/pops
            # its thread ident under the same lock, so the ident cannot
            # be recycled onto a DIFFERENT task between our lookup and
            # the raise (the pending exception lands while the victim
            # thread is still inside its own _call frame)
            import ctypes

            with self._state_lock:
                tid = self._task_threads.get(task_id)
                if tid is not None:
                    n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(tid),
                        ctypes.py_object(exc.TaskCancelledError),
                    )
                    if n == 1:
                        return {"cancelled": True, "interrupted": True}
                    if n > 1:  # raced a thread swap: undo, never poison
                        ctypes.pythonapi.PyThreadState_SetAsyncExc(
                            ctypes.c_ulong(tid), None
                        )
            return {"cancelled": False}  # already executing
        cancelled = self._cancelled_tasks = getattr(
            self, "_cancelled_tasks", set()
        )
        cancelled.add(task_id)
        return {"cancelled": True}

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------
    def put(self, value: Any, *, inline: Optional[bool] = None) -> ObjectRef:
        """`inline=None` (default) picks by size: small objects stay
        in the owner's memory and every borrower fetch is an owner RPC.
        `inline=False` forces the shm path regardless of size — the
        BROADCAST shape: one write, then every node-local borrower
        reads zero-copy and remote nodes pull once per node instead of
        once per borrower (an N-runner weight broadcast was N owner
        round-trips per version through the daemon's route path;
        measured in PERF.md's rllib section)."""
        self._put_counter += 1
        scope = getattr(self._task_local, "task_id", None) or TaskID.for_job(self.job_id)
        oid = ObjectID.for_put(scope, self._put_counter)
        chunks, total, captured = ser.serialize(value)
        if captured:
            # tie borrows to THIS container so they release when the
            # put object is freed, not at job exit.  Self-owned refs go
            # through the counted selfborrow path too (a boolean pin
            # clobbers when one inner sits in two containers).
            with self._state_lock:
                self._register_contained(oid.binary(), [
                    (r.binary(), tuple(r.owner))
                    for r in captured
                    if r.owner is not None
                ])
        st = _ObjectState(ready=asyncio.Event())
        if (total <= self.cfg.max_direct_call_object_size
                and inline is not False):
            buf = bytearray(total)
            ser.write_chunks(chunks, memoryview(buf))
            st.where, st.value, st.size = _INLINE, bytes(buf), total
        else:
            from ray_tpu_torch.shm import StoreFullError

            deadline = time.time() + 30.0
            attempts = 0
            disk_full_streak = 0
            while True:
                try:
                    dest = self.store.create(
                        oid.binary(), total, allow_evict=False
                    )
                    break
                except StoreFullError:
                    if time.time() > deadline:
                        raise
                    reply = None
                    try:
                        # watermark spills first, full drain once the
                        # create stays blocked (fragmentation)
                        reply = self.noded_call(
                            "spill_now", {"drain": attempts >= 2},
                            timeout=10,
                        )
                    except Exception as e:
                        logger.debug("spill_now nudge failed: %s", e)
                    disk_full_streak = _spill_clamp_streak(
                        reply, disk_full_streak
                    )
                    attempts += 1
                    time.sleep(0.05)
            ser.write_chunks(chunks, dest)
            if self.cfg.object_integrity_verify_get:
                # seal-time checksum for the opt-in local-get verifier,
                # computed over the write buffer BEFORE sealing — a
                # re-get after seal could race the spill pass (the
                # freshly sealed, unpinned object is a spill candidate)
                # and fail a put that actually succeeded
                from ray_tpu_torch.core import integrity as _integrity

                st.checksum = _integrity.checksum(dest)
            del dest
            self.store.seal(oid.binary())
            st.where, st.node_id, st.size = _SHM, self.node_id, total
        st.ready.set()
        with self._state_lock:
            self.objects[oid.binary()] = st
            self._add_local_ref(oid.binary())
        return ObjectRef(oid, self.address, st.size, _register=True)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]

        # Fast path: owned objects that are already ready and inline
        # deserialize in the calling thread — no event-loop round trip
        # (reference: in-process memory store hits skip the plasma
        # path the same way).  Event.is_set() is a thread-safe read.
        # A partial hit keeps the prefix and round-trips only the rest.
        vals = []
        for r in refs:
            st = self.objects.get(r.binary())
            if (
                st is not None
                and st.ready.is_set()
                and st.error is None
                and st.where == _INLINE
                and st.value is not None
            ):
                tag, val = ser.deserialize(memoryview(st.value))
                vals.append(_unwrap(tag, val))
            else:
                break
        if len(vals) == len(refs):
            return vals[0] if single else vals
        rest = refs[len(vals):]

        async def _get_all():
            primed = await self._prime_borrowed(rest)
            try:
                return await asyncio.gather(
                    *[self._get_one(r) for r in rest]
                )
            finally:
                for b in primed:  # drop unconsumed entries (cancel/error)
                    self._primed_replies.pop(b, None)

        # in-task gets report blocked-worker state past a short grace
        # window, so a worker parked on a not-yet-derivable object
        # frees its CPUs for the producing tasks (never for driver
        # gets — the driver holds no lease)
        block_grace = (
            0.05 if (self.mode == "worker" and self.noded is not None
                     and getattr(self._task_local, "task_id", None)
                     is not None)
            else None
        )
        try:
            vals.extend(self._run(_get_all(), timeout=timeout,
                                  block_grace=block_grace))
        except exc.GetTimeoutError as e:
            if e.object_id is None:
                # attach the first still-pending ref: the one the
                # caller was actually stuck on
                for r in rest:
                    st = self.objects.get(r.binary())
                    if st is None or not st.ready.is_set():
                        e.object_id = r.id
                        break
            raise
        return vals[0] if single else vals

    def wait(self, refs: List[ObjectRef], num_returns=1, timeout=None,
             fetch_local=True):
        return self._run(self._wait(refs, num_returns, timeout))

    # ------------------------------------------------------------------
    # normal task submission — thread-side fast path
    # ------------------------------------------------------------------
    def submit_task(self, fn, args, kwargs, **options) -> List[ObjectRef]:
        renv = options.get("runtime_env")
        env_hash = None
        if renv:
            # tasks with a runtime env run on DEDICATED workers keyed
            # by env hash (reference: worker-pool runtime-env matching)
            from ray_tpu_torch.core.runtime_env import (
                runtime_env_hash,
                validate_runtime_env,
            )

            validate_runtime_env(renv)

            renv = self._run(self._prepare_runtime_env(dict(renv)))
            env_hash = runtime_env_hash(renv)
        fid, blob = self._export_function(fn)
        task_id = TaskID.for_job(self.job_id)
        num_returns = options.get("num_returns", 1)
        if num_returns == "streaming":
            num_returns = STREAMING
        transit: list = []
        resolved, kwargs = self._resolve_args_kwargs(args, kwargs, transit)
        spec = TaskSpec(
            task_id=task_id,
            function_id=fid,
            function_blob=blob,
            args=resolved,
            kwargs=kwargs,
            num_returns=num_returns,
            owner=self.address,
            resources=Resources.from_options(options),
            max_retries=options.get("max_retries", self.cfg.task_max_retries),
            retry_exceptions=options.get("retry_exceptions", False),
            strategy=_strategy_from_options(options),
            name=options.get("name", getattr(fn, "__name__", "task")),
            runtime_env=renv,
            env_hash=env_hash,
            deadline_s=self._effective_deadline(options),
        )
        from ray_tpu_torch.util import tracing as _tracing

        spec.trace_ctx = _tracing.make_submit_ctx(spec.name)
        refs = []
        with self._state_lock:
            for oid in spec.return_ids():
                self.objects[oid.binary()] = _ObjectState(ready=asyncio.Event())
                self.lineage[oid.binary()] = spec
                self._add_local_ref(oid.binary())
                refs.append(ObjectRef(oid, self.address, _register=True))
            if num_returns == STREAMING:
                self._streams[spec.task_id.binary()] = _StreamState(
                    event=asyncio.Event()
                )
            self.pending_tasks[spec.task_id.binary()] = _PendingTask(
                spec, spec.max_retries, transit
            )
            n_lineage = len(refs)  # one retained lineage entry per return
            for a in spec.args:
                if isinstance(a, ArgRef):
                    rc = self.refs.get(a.id_bytes)
                    if rc:
                        rc.submitted += 1
                        rc.lineage += n_lineage
        self.task_events.record(spec.task_id.binary(), spec.name, "SUBMITTED")
        # per-shard accounting (normal tasks): pairs with the completed
        # bump at the exactly-once pop in completion.complete_task
        shard = self._shard_for(spec.task_id.binary())
        with shard.lock:
            shard.submitted += 1
        _mdefs.inc("rt_owner_tasks_submitted_total",
                   tags={"shard": str(shard.index)})
        if spec.deadline_s is not None:
            self._arm_deadline(spec)
        self._push_or_queue(spec)
        if num_returns == STREAMING:
            return ObjectRefGenerator(spec.task_id.binary(), self)
        return refs

    # ------------------------------------------------------------------
    # end-to-end deadlines (`.options(timeout_s=...)`)
    # ------------------------------------------------------------------
    def _effective_deadline(self, options) -> Optional[float]:
        """Absolute monotonic deadline for a new submission: the
        caller's explicit timeout_s combined (min) with the AMBIENT
        deadline of the task currently executing in this thread — so
        nested `.remote()` calls inherit the shrinking budget of their
        parent (gRPC-style deadline propagation)."""
        deadline = None
        timeout_s = options.get("timeout_s")
        if timeout_s is not None:
            timeout_s = float(timeout_s)
            if timeout_s <= 0:
                raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
            deadline = time.monotonic() + timeout_s
        ambient = _ambient_deadline.get()
        if ambient is not None:
            deadline = ambient if deadline is None else min(deadline, ambient)
        return deadline

    def _arm_deadline(self, spec: TaskSpec):
        """Owner-side watchdog: when the deadline passes with the task
        still pending, fail it with DeadlineExceededError — the caller
        gets an answer even when the executor side is partitioned away
        and no failure result will ever arrive."""
        tid = spec.task_id.binary()
        deadline = spec.deadline_s

        def _arm():
            handle = self.loop.call_later(
                max(0.0, deadline - time.monotonic()),
                self._deadline_fire, tid,
            )
            with self._state_lock:
                pt = self.pending_tasks.get(tid)
            if pt is None:
                handle.cancel()  # completed before the watchdog armed
            else:
                pt.deadline_timer = handle

        try:
            self.loop.call_soon_threadsafe(_arm)
        except RuntimeError:
            pass  # loop closed (teardown race)

    def _deadline_fire(self, tid: bytes):
        with self._state_lock:
            pt = self.pending_tasks.get(tid)
            if pt is None:
                return  # completed in time
            dl = pt.spec.deadline_s
            if dl is None or time.monotonic() < dl:
                return
            pt.retries_left = 0  # an expired task never retries
            attempts = pt.attempts
            spec = pt.spec
        err = exc.DeadlineExceededError(
            f"task {spec.name!r} exceeded its deadline "
            f"(timeout_s elapsed; {attempts} retries were attempted); "
            f"the caller gave up, so the task will not be resubmitted",
        )
        envelope = ser.serialize_to_bytes(err, tag=ser.TAG_ERROR)
        self._complete_task(TaskResult(
            task_id=spec.task_id, status="error", error=envelope,
        ))
        # best-effort: tell whoever holds the work to stop running it
        task = asyncio.ensure_future(self._cancel_remote(tid, spec, False))
        task.add_done_callback(lambda t: t.cancelled() or t.exception())

    def _export_function(self, fn) -> Tuple[bytes, Optional[bytes]]:
        # keyed by id(fn) with the FUNCTION PINNED in the entry AND an
        # identity check on hit: without both, a GC'd function's address
        # can be reused by a brand-new function, which would silently
        # inherit the old export and run the WRONG code on the executor.
        # Growth is bounded by distinct exported functions — the same
        # lifetime _fn_cache (fid -> fn) already has, mirroring the
        # reference's per-job function table.
        cached = self._fn_export.get(id(fn))
        if cached is not None and cached[2] is fn:
            fid, _blob, _pin = cached
            return fid, None  # executors kv_get on miss
        blob = ser.dumps_oob(fn)
        fid = function_id_of(blob)
        self._fn_export[id(fn)] = (fid, blob, fn)
        self._fn_cache[fid] = fn
        if fid not in self._exported_fids:
            self._exported_fids.add(fid)
            key = "fn:" + fid.hex()
            self.controller.send_threadsafe("kv_put_oneway", {"key": key, "value": blob})
        return fid, blob

    def _resolve_args_sync(self, args, transit=None) -> Optional[List[Any]]:
        """Fast path: all ObjectRef args already ready.  Returns None if
        a pending ref forces the async path."""
        out = []
        for a in args:
            if isinstance(a, ObjectRef):
                st = self.objects.get(a.binary())
                if st is None:
                    out.append(ArgRef(a.binary(), a.owner))
                elif st.ready.is_set():
                    if st.error is not None:
                        raise _error_from_envelope(st.error)
                    if st.where == _INLINE:
                        out.append(("__rt_inline__", st.value))
                    else:
                        out.append(ArgRef(a.binary(), a.owner))
                else:
                    return None
            else:
                out.append(self._inline_value_arg(a, transit))
        return out

    async def _resolve_args_async(self, args, transit=None) -> List[Any]:
        """Dependency resolution (reference: `dependency_resolver.h`)."""
        out = []
        for a in args:
            if isinstance(a, ObjectRef):
                st = self.objects.get(a.binary())
                if st is not None:
                    await st.ready.wait()
                    if st.error is not None:
                        raise _error_from_envelope(st.error)
                    if st.where == _INLINE:
                        out.append(("__rt_inline__", st.value))
                    else:
                        out.append(ArgRef(a.binary(), a.owner))
                else:
                    out.append(ArgRef(a.binary(), a.owner))
            else:
                out.append(self._inline_value_arg(a, transit))
        return out

    def _resolve_args_kwargs(self, args, kwargs, transit=None):
        """Resolve positional args AND kwarg values together (top-level
        ObjectRefs in either position resolve before execution, like the
        reference).  Returns (resolved_args, resolved_kwargs)."""
        keys = list(kwargs)
        combined = list(args) + [kwargs[k] for k in keys]
        resolved = self._resolve_args_sync(combined, transit)
        if resolved is None:
            resolved = self._run(self._resolve_args_async(combined, transit))
        return (
            resolved[: len(args)],
            dict(zip(keys, resolved[len(args):])),
        )

    def _inline_value_arg(self, v, transit=None) -> Tuple[str, bytes]:
        """Serialize a plain (non-ref) argument into an inline envelope
        at submission time.  The spec then carries only bytes + ids, so
        every relaying daemon can deserialize the FRAME even when the
        value references modules only driver/executor import, and a
        value that fails to deserialize on the executor surfaces as
        that task's error, not a poisoned connection (reference: args
        travel as serialized buffers, materialized by the executor —
        `dependency_resolver.h` / plasma args)."""
        chunks, total, captured = ser.serialize(v)
        if captured:
            self._pin_contained(captured)
            if transit is not None:
                self._pin_transit(captured, transit)
        buf = bytearray(total)
        ser.write_chunks(chunks, memoryview(buf))
        return ("__rt_inline__", bytes(buf))

    def _pin_transit(self, captured_refs, transit: list):
        """Transit-pin FOREIGN-owned refs being forwarded inside a
        serialized message: our registered borrow at the owner must
        outlive the message, or the owner could free the object while
        it is in flight (the forwarded-ref window of the reference's
        borrower protocol).  Pins release at the carrying task's final
        completion (`_complete_task`)."""
        with self._state_lock:
            for r in captured_refs:
                if r.owner is None or tuple(r.owner) == self.address:
                    continue
                rc = self.refs.setdefault(r.binary(), _RefCount())
                rc.transit += 1
                rc.owner_addr = rc.owner_addr or tuple(r.owner)
                transit.append((r.binary(), tuple(r.owner)))

    def _release_transit(self, entries):
        """Drop transit pins; caller holds `_state_lock`."""
        for inner_id, owner in entries:
            rc = self.refs.get(inner_id)
            if rc is None:
                continue
            rc.transit -= 1
            rc.owner_addr = rc.owner_addr or tuple(owner)
            self._maybe_free(inner_id)

    # ref-event channel tuning: a flush window long enough to coalesce
    # a churn burst, short enough to be latency-invisible next to the
    # object-free paths it feeds
    _REF_EVENT_FLUSH_S = 0.005
    _REF_EVENT_MAX_BATCH = 1024
    # bulk location/value lookup chunk (see _prime_borrowed)
    _BULK_GET_CHUNK = 512

    def _send_remove_borrow(self, inner_id: bytes, owner):
        self._queue_ref_event(
            tuple(owner), "remove_borrow",
            {"id": inner_id, "borrower": self.address},
        )

    def _queue_ref_event(self, owner: tuple, method: str, payload: dict):
        """Queue an un-ACK'd borrow event for the coalesced per-owner
        channel (reference: `src/ray/pubsub/README.md` — the fan-in
        argument: O(#subscribers) messages instead of O(#objects);
        `reference_count.h:64` WaitForRefRemoved).  Events to one owner
        preserve queue order; ACK'd registrations stay direct RPCs (the
        ACK future is awaited individually) and always precede any
        queued remove for the same ref causally."""
        if self.noded is None:
            return
        with self._ref_event_lock:
            q = self._ref_event_queues.setdefault(owner, [])
            q.append((method, payload))
            # boundary transition only: a burst past MAX must not spawn
            # one no-op flush coroutine per further event
            full = len(q) % self._REF_EVENT_MAX_BATCH == 0
            schedule = not self._ref_event_flush_scheduled
            if schedule:
                self._ref_event_flush_scheduled = True
        if schedule or full:
            try:
                asyncio.run_coroutine_threadsafe(
                    self._flush_ref_events(immediate=full), self.loop
                ).add_done_callback(
                    lambda f: f.exception() if not f.cancelled() else None
                )
            except Exception as e:
                logger.debug("scheduling ref-event flush failed: %s", e)
                with self._ref_event_lock:
                    self._ref_event_flush_scheduled = False

    async def _flush_ref_events(self, immediate: bool = False):
        if not immediate:
            await asyncio.sleep(self._REF_EVENT_FLUSH_S)
        while True:
            with self._ref_event_lock:
                batches = self._ref_event_queues
                self._ref_event_queues = {}
                if not batches:
                    self._ref_event_flush_scheduled = False
                    return
            for owner, events in batches.items():
                for i in range(0, len(events), self._REF_EVENT_MAX_BATCH):
                    try:
                        self.noded.send_threadsafe("route", {
                            "target": owner,
                            "method": "ref_events",
                            "payload": {
                                "events": events[
                                    i:i + self._REF_EVENT_MAX_BATCH
                                ],
                            },
                            "want_reply": False,
                        })
                    except Exception as e:
                        # daemon gone: owner cleanup handles it
                        logger.debug("ref-event batch dropped: %s", e)
                        break

    # args at least this big make their node the preferred executor
    # (reference: locality-aware lease policy, `lease_policy.h` — pull
    # the task to the data, not the data to the task)
    _LOCALITY_MIN_ARG_BYTES = 1024 * 1024

    def _locality_node(self, spec: TaskSpec) -> Optional[str]:
        """Node holding the largest shm-resident arg above the locality
        threshold, if it isn't this node."""
        best_node, best_size = None, self._LOCALITY_MIN_ARG_BYTES
        for a in [*spec.args, *spec.kwargs.values()]:
            if not isinstance(a, ArgRef):
                continue
            st = self.objects.get(a.id_bytes)
            if (
                st is not None
                and st.where == _SHM
                and st.node_id
                and st.node_id != self.node_id
                and (st.size or 0) >= best_size
            ):
                best_node, best_size = st.node_id, st.size
        return best_node

    def _push_or_queue(self, spec: TaskSpec):
        if spec.strategy.kind != "default":
            # placement-constrained tasks go through the node daemon,
            # which consults the controller for PG bundles / affinity /
            # spread targets (reference: lease policy + spillback)
            try:
                self.noded.send_threadsafe("submit_task", spec)
            except rpc.ConnectionLost:
                pass
            return
        locality = self._locality_node(spec)
        if locality is not None:
            # route to the data's node (soft: falls back if it's gone)
            spec.strategy = SchedulingStrategy(
                kind="node_affinity", node_id=locality, soft=True
            )
            try:
                self.noded.send_threadsafe("submit_task", spec)
            except rpc.ConnectionLost:
                pass
            return
        # default strategy: the shard keyed by this task id owns the
        # push (its lease pools, its loop, its daemon connection)
        self._shard_for(spec.task_id.binary()).push(spec)

    # ------------------------------------------------------------------
    # actor creation + actor task submission
    # ------------------------------------------------------------------
    def create_actor(self, cls, args, kwargs, **options):
        return self._run(self._create_actor(cls, args, kwargs, options))

    async def _prepare_runtime_env(self, renv):
        """Driver-side prep shared by actors AND tasks: package local
        py_modules, ship once via KV; the spec carries only (name, key)
        pairs (reference: runtime_env packaging uploads to the GCS,
        `runtime_env/packaging.py`)."""
        if not (renv and renv.get("py_modules")):
            return renv
        from ray_tpu_torch.core.runtime_env import (
            _module_root,
            module_stat_sig,
            package_py_modules,
        )

        uploaded = getattr(self, "_pymod_uploaded", None)
        if uploaded is None:
            uploaded = self._pymod_uploaded = set()
        pkg_cache = getattr(self, "_pymod_pkg_cache", None)
        if pkg_cache is None:
            pkg_cache = self._pymod_pkg_cache = {}
        entries = []
        for mod in renv["py_modules"]:
            # repeat creations (actor fleets) skip BOTH the re-zip
            # and the re-upload: a stat-walk signature detects
            # unchanged trees far cheaper than deflate
            root = _module_root(mod)
            sig = module_stat_sig(root)
            cached = pkg_cache.get(root)
            if cached is not None and cached[0] == sig:
                entries.append((cached[1], cached[2]))
                continue
            # deflate over a whole module tree takes long enough to
            # stall every task on the loop — zip off-loop
            [(name, key, pkg_blob)] = await self.loop.run_in_executor(
                None, package_py_modules, [root]
            )
            if key not in uploaded and not await self.controller.call(
                "kv_exists", {"key": key}
            ):
                await self.controller.call(
                    "kv_put", {"key": key, "value": pkg_blob}
                )
            uploaded.add(key)
            pkg_cache[root] = (sig, name, key)
            entries.append((name, key))
        renv = dict(renv)
        renv["py_modules"] = entries
        return renv

    async def _create_actor(self, cls, args, kwargs, options):
        renv = options.get("runtime_env")
        if renv:
            from ray_tpu_torch.core.runtime_env import validate_runtime_env

            validate_runtime_env(renv)
        if renv and renv.get("py_modules"):
            options = dict(options)
            options["runtime_env"] = await self._prepare_runtime_env(renv)
        blob = ser.dumps_oob(cls)
        cid = function_id_of(blob)
        actor_id = ActorID.of(self.job_id)
        is_async = any(
            asyncio.iscoroutinefunction(getattr(cls, m, None))
            for m in dir(cls)
            if not m.startswith("__")
        )
        import inspect as _inspect

        streaming_methods = tuple(
            m for m in dir(cls)
            if not m.startswith("_")
            and (_inspect.isgeneratorfunction(getattr(cls, m, None))
                 or _inspect.isasyncgenfunction(getattr(cls, m, None)))
        )
        # @rt.method(concurrency_group=...) defaults, recorded in the
        # spec so get_actor-rebuilt handles route the same lanes
        method_groups = {
            m: getattr(cls, m).__rt_method_options__["concurrency_group"]
            for m in dir(cls)
            if not m.startswith("_")
            and getattr(getattr(cls, m, None),
                        "__rt_method_options__", {}).get("concurrency_group")
        }
        concurrency_groups = dict(options.get("concurrency_groups") or {})
        for name, limit in concurrency_groups.items():
            if not isinstance(limit, int) or limit < 1:
                raise ValueError(
                    f"concurrency_groups[{name!r}] must be a positive "
                    f"int, got {limit!r}"
                )
        for m, g in method_groups.items():
            if g not in concurrency_groups:
                raise ValueError(
                    f"@method(concurrency_group={g!r}) on {m!r} names an "
                    f"undeclared group; declare it in concurrency_groups"
                )
        init_transit: list = []
        spec = ActorCreationSpec(
            actor_id=actor_id,
            class_id=cid,
            class_blob=blob,
            init_args=await self._resolve_args_async(args, init_transit),
            init_kwargs={
                k: (await self._resolve_args_async([v], init_transit))[0]
                for k, v in kwargs.items()
            },
            owner=self.address,
            resources=Resources.from_options(options),
            max_restarts=options.get("max_restarts", self.cfg.actor_max_restarts),
            max_task_retries=options.get("max_task_retries", 0),
            max_concurrency=options.get("max_concurrency", 1),
            # groups imply concurrent lanes -> event-loop dispatch
            is_async=(is_async or options.get("max_concurrency", 1) > 1
                      or bool(concurrency_groups)),
            name=options.get("name"),
            namespace=options.get("namespace", "default"),
            streaming_methods=streaming_methods,
            strategy=_strategy_from_options(options),
            lifetime=options.get("lifetime"),
            runtime_env=options.get("runtime_env"),
            concurrency_groups=concurrency_groups or None,
            method_groups=method_groups or None,
            allow_out_of_order=bool(
                options.get("allow_out_of_order_execution", False)
            ),
            has_async_methods=is_async,
        )
        try:
            reply = await self.controller.call("create_actor", spec)
        finally:
            # forwarded foreign refs in init args stay transit-pinned
            # until the create reply — by then the actor worker has
            # deserialized them and registered its own borrows
            with self._state_lock:
                self._release_transit(init_transit)
        if not reply.get("ok"):
            raise exc.RayTpuError(reply.get("error", "actor creation failed"))
        self._actor_addr[actor_id.binary()] = tuple(reply["address"])
        return actor_id, reply["address"], streaming_methods, method_groups

    def submit_actor_task(self, handle, method_name, args, kwargs, **options):
        aid = handle._actor_id.binary()
        task_id = TaskID.for_actor_task(handle._actor_id)
        num_returns = options.get("num_returns", 1)
        if num_returns == "streaming":
            num_returns = STREAMING
        transit: list = []
        resolved, kwargs = self._resolve_args_kwargs(args, kwargs, transit)
        kwargs["__rt_method__"] = method_name
        # per-call lane, or the @rt.method default recorded on the
        # handle; rides a reserved kwarg so the TaskSpec wire schema
        # stays unchanged.  An EXPLICIT concurrency_group=None routes
        # to the default lane even when the method declares a default.
        if "concurrency_group" in options:
            group = options["concurrency_group"]
        else:
            group = getattr(handle, "_method_groups", {}).get(method_name)
        if group is not None:
            kwargs["__rt_group__"] = group
        spec = TaskSpec(
            task_id=task_id,
            function_id=b"",
            function_blob=None,
            args=resolved,
            kwargs=kwargs,
            num_returns=num_returns,
            owner=self.address,
            resources=Resources(num_cpus=0),
            max_retries=options.get("max_retries", handle._max_task_retries),
            strategy=SchedulingStrategy(),
            name=f"{handle._class_name}.{method_name}",
            actor_id=handle._actor_id,
            seq_no=handle._next_seq(group),
            deadline_s=self._effective_deadline(options),
        )
        from ray_tpu_torch.util import tracing as _tracing

        spec.trace_ctx = _tracing.make_submit_ctx(spec.name)
        refs = []
        with self._state_lock:
            for oid in spec.return_ids():
                self.objects[oid.binary()] = _ObjectState(ready=asyncio.Event())
                # actor-task returns reconstruct by re-executing the
                # method on the (live) actor — but ONLY when the call
                # opted into retries: re-running a non-idempotent method
                # behind the user's back can double-apply side effects
                # (reference: actor outputs are reconstructable only
                # with max_task_retries > 0, `task_manager.h` lineage)
                if spec.max_retries > 0:
                    self.lineage[oid.binary()] = spec
                self._add_local_ref(oid.binary())
                refs.append(ObjectRef(oid, self.address, _register=True))
            if num_returns == STREAMING:
                self._streams[spec.task_id.binary()] = _StreamState(
                    event=asyncio.Event()
                )
            self.pending_tasks[spec.task_id.binary()] = _PendingTask(
                spec, spec.max_retries, transit
            )
            # lineage entries exist only for retry-opted calls (above)
            n_lineage = len(refs) if spec.max_retries > 0 else 0
            for a in spec.args:
                if isinstance(a, ArgRef):
                    rc = self.refs.get(a.id_bytes)
                    if rc:
                        rc.submitted += 1
                        rc.lineage += n_lineage
            if handle._address is not None:
                self._actor_addr.setdefault(aid, tuple(handle._address))
        self.task_events.record(spec.task_id.binary(), spec.name, "SUBMITTED")
        _mdefs.inc("rt_owner_tasks_submitted_total", tags={"shard": "actor"})
        if spec.deadline_s is not None:
            self._arm_deadline(spec)
        self._push_actor_task(aid, spec)
        if num_returns == STREAMING:
            return ObjectRefGenerator(spec.task_id.binary(), self)
        return refs

    def _push_actor_task(self, aid: bytes, spec: TaskSpec):
        with self._state_lock:
            conn = self._actor_conns.get(aid)
            if conn is not None and not conn.closed:
                self._actor_assigned.setdefault(conn, {})[spec.task_id.binary()] = spec
            else:
                self._actor_queue.setdefault(aid, deque()).append(spec)
                need_connect = aid not in self._actor_connecting
                if need_connect:
                    self._actor_connecting.add(aid)
                conn = None
        if conn is not None:
            try:
                conn.send_threadsafe("execute_task", spec)
            except rpc.ConnectionLost:
                pass  # teardown fails/retries via _on_actor_conn_closed
        elif need_connect:
            self.loop.call_soon_threadsafe(
                lambda: asyncio.ensure_future(self._connect_actor(aid))
            )

    async def _connect_actor(self, aid: bytes):
        try:
            addr = self._actor_addr.get(aid)
            # resolve (and refresh after restart) via the controller
            info = await self.controller.call("get_actor", {"actor_id": aid})
            if info is None or info["state"] == "DEAD":
                self._fail_actor_queue(aid, info)
                return
            if info["state"] != "ALIVE":
                for _ in range(600):
                    await asyncio.sleep(0.1)
                    info = await self.controller.call("get_actor", {"actor_id": aid})
                    if info is None or info["state"] in ("ALIVE", "DEAD"):
                        break
                if info is None or info["state"] != "ALIVE":
                    self._fail_actor_queue(aid, info)
                    return
            old_addr = addr
            addr = tuple(info["address"])
            self._actor_addr[aid] = addr
            if old_addr is not None and tuple(old_addr) != addr:
                # restarted actor landed on a new worker: the retired
                # address never comes back, so evict its breaker
                rpc.drop_breaker(f"actor:{old_addr[0]}:{old_addr[1]}")
            breaker = rpc.breaker_for(f"actor:{addr[0]}:{addr[1]}")
            if not breaker.allow():
                # breaker open: don't even dial — the backoff path below
                # retries after the half-open cooldown
                raise rpc.ConnectionLost(
                    f"circuit breaker open for actor address {addr}"
                )
            sock = await self.noded.call(
                "resolve_worker_socket",
                {"node_id": addr[0], "worker_id": addr[1]},
            )
            if sock is None:
                # remote node without reachable socket: relay via noded
                self._drain_actor_queue_via_noded(aid, addr)
                return
            try:
                conn = await rpc.connect_unix(
                    sock, handler=self._handle, name=f"actor-{aid.hex()[:8]}"
                )
            except Exception:
                breaker.record_failure()
                raise
            breaker.record_success()
            with self._state_lock:
                self._actor_connect_attempts.pop(aid, None)
            conn.on_close = lambda c: self._on_actor_conn_closed(aid, c)
            with self._state_lock:
                self._actor_conns[aid] = conn
                q = self._actor_queue.get(aid)
                specs = list(q) if q else []
                if q:
                    q.clear()
                assigned = self._actor_assigned.setdefault(conn, {})
                for s in specs:
                    assigned[s.task_id.binary()] = s
            for s in specs:
                conn.send_threadsafe("execute_task", s)
        except Exception as e:
            logger.debug("actor task push failed: %s", e)
            # stale address or races with restart: retry while callers
            # still have queued work — through the capped jittered
            # backoff schedule, NOT a fixed-delay redial loop (a dead
            # address would otherwise be hammered at 5 Hz forever)
            with self._state_lock:
                attempts = self._actor_connect_attempts.get(aid, 0)
                self._actor_connect_attempts[aid] = attempts + 1
            await asyncio.sleep(backoff_delay_s(
                attempts,
                base_s=self.cfg.task_retry_backoff_base_ms / 1000.0,
                cap_s=self.cfg.task_retry_backoff_max_ms / 1000.0,
                floor_s=0.2,  # the historical fixed redial delay
                rng=self._retry_rng,
            ))
            with self._state_lock:
                retry = bool(self._actor_queue.get(aid))
            if retry and not self._shutdown:
                asyncio.ensure_future(self._retry_connect_actor(aid))
        finally:
            self._actor_connecting.discard(aid)

    async def _retry_connect_actor(self, aid: bytes):
        with self._state_lock:
            if aid in self._actor_connecting:
                return
            self._actor_connecting.add(aid)
        await self._connect_actor(aid)

    def _drain_actor_queue_via_noded(self, aid: bytes, addr):
        with self._state_lock:
            q = self._actor_queue.get(aid)
            specs = list(q) if q else []
            if q:
                q.clear()
        for s in specs:
            self.noded.send("submit_actor_task", {"spec": s, "actor_addr": addr})

    def _fail_actor_queue(self, aid: bytes, info):
        cause = (info or {}).get("death_cause", "actor not found")
        envelope = ser.serialize_to_bytes(
            exc.ActorDiedError(f"actor is dead: {cause}"), tag=ser.TAG_ERROR
        )
        with self._state_lock:
            q = self._actor_queue.pop(aid, None)
            specs = list(q) if q else []
            dead_addr = self._actor_addr.pop(aid, None)
        if dead_addr is not None:
            # terminal death: the address is retired with the actor
            rpc.drop_breaker(f"actor:{dead_addr[0]}:{dead_addr[1]}")
        for s in specs:
            self._complete_task(
                TaskResult(task_id=s.task_id, status="error", error=envelope)
            )

    def _on_actor_conn_closed(self, aid: bytes, conn: rpc.Connection):
        with self._state_lock:
            if self._actor_conns.get(aid) is conn:
                del self._actor_conns[aid]
            assigned = self._actor_assigned.pop(conn, {})
        for spec in assigned.values():
            self._complete_task(
                TaskResult(task_id=spec.task_id, status="worker_died")
            )

    # ------------------------------------------------------------------
    # task completion (io thread)
    # ------------------------------------------------------------------
    async def _flush_task_events_loop(self):
        """Batched flush to the controller (reference:
        `task_event_buffer.h:220` periodic flush — never the hot path).
        The same loop carries the observability plane's frames: every
        `metrics_report_interval_ms` it ships ONE `report_obs` frame
        holding this process's metrics-registry snapshot and the spans
        finished since the last flush — batched like the task events,
        never a per-sample RPC."""
        from ray_tpu_torch.core.task_events import FLUSH_PERIOD_S

        obs_period_s = max(
            FLUSH_PERIOD_S, self.cfg.metrics_report_interval_ms / 1000.0
        )
        last_obs = 0.0
        while not self._shutdown:
            await asyncio.sleep(FLUSH_PERIOD_S)
            events = self.task_events.drain()
            if events and self.controller is not None:
                try:
                    self.controller.send(
                        "report_task_events", {"events": events}
                    )
                except Exception as e:
                    logger.debug("task-event report dropped: %s", e)
            now = time.monotonic()
            if now - last_obs >= obs_period_s:
                last_obs = now
                self._ship_obs_frame()

    def _ship_obs_frame(self) -> bool:
        """Send one batched obs frame (metrics snapshot + drained
        spans) to the controller; a no-op when both planes are off or
        there is nothing to report.  Returns True when a frame went
        out."""
        from ray_tpu_torch.metrics import exporter as _mexp
        from ray_tpu_torch.metrics import metric_defs as _md

        if self.controller is None or self.controller.closed:
            # reconnect restores it; spans stay in the bounded export
            # queue (overflow there is counted), not drained into a
            # frame that can never be sent
            return False
        payload = _mexp.build_obs_payload(
            self.node_id or "", self.mode, os.getpid()
        )
        if payload is None:
            return False
        try:
            self.controller.send("report_obs", payload)
            _md.inc("rt_obs_frames_sent_total")
        except Exception as e:
            logger.debug("obs frame dropped: %s", e)
            return False
        return True

    def _complete_task(self, result: TaskResult) -> list:
        """Owner-side exactly-once completion (moved to
        core/completion.py with the owner-shard split); returns the
        pending contained-borrow ACK futures the batch ingester awaits
        before confirming `transit_release`."""
        return _completion.complete_task(self, result)

    # ------------------------------------------------------------------
    # get / wait internals (io thread)
    # ------------------------------------------------------------------
    async def _get_one(self, ref: ObjectRef):
        st = self.objects.get(ref.binary())
        if st is not None:
            await st.ready.wait()
            if st.error is not None:
                raise _error_from_envelope(st.error)
            if st.where == _INLINE:
                tag, val = ser.deserialize(memoryview(st.value))
                return _unwrap(tag, val)
            return await self._read_shm(ref, st.node_id)
        return await self._get_borrowed(ref)

    def _deser_pinned(self, id_bytes: bytes, buf):
        """Deserialize a shm buffer; the get's pin is held while the
        value lives.  EVERY get keeps its own store pin: a per-get
        finalizer releases exactly that pin when the arrays over the
        buffer are garbage-collected — on each array's view root
        (`_view_root`), the array every view derived from it keeps
        alive, since numpy collapses a view's base past intermediate
        views: a finalizer on the returned array itself fired while a
        slice of it still read the buffer, and the store then spilled
        and reused the memory under the slice (rows lost or duplicated
        in `scripts/perf.py`'s storage-faults epoch).  The reference
        releases plasma buffers on value GC the same way.  Non-array
        values may leak extracted views past their container's death,
        so their pin is held for the process lifetime (released at
        shutdown)."""
        import weakref

        import numpy as _np

        tag, val = ser.deserialize(buf)
        out = _unwrap(tag, val)
        if isinstance(out, _np.ndarray):
            weakref.finalize(_view_root(out), self._release_pin, id_bytes)
        elif (isinstance(out, dict) and out
              and all(isinstance(v, _np.ndarray) for v in out.values())):
            # a column block (dict of arrays, each possibly a zero-copy
            # view into this buffer): release the pin when the LAST
            # array root is collected.  The former process-lifetime pin
            # here made every fetched block permanently unspillable,
            # which wedged any shuffle larger than the object store.
            roots = list({id(r): r for r in map(_view_root, out.values())
                          }.values())
            release = self._release_pin
            remaining = [len(roots)]

            def _dec(remaining=remaining, release=release,
                     id_bytes=id_bytes):
                remaining[0] -= 1
                if remaining[0] == 0:
                    release(id_bytes)

            for r in roots:
                weakref.finalize(r, _dec)
        else:
            self._held_pins.add(id_bytes)  # process-lifetime pin
        return out

    def _release_pin(self, id_bytes: bytes):
        if not self._shutdown:
            try:
                self.store.release(id_bytes)
            except Exception as e:
                logger.debug("pin release failed: %s", e)

    def _maybe_verify_local(self, ref: ObjectRef, buf):
        """Opt-in local shm-get verification
        (`object_integrity_verify_get`): compare the buffer against the
        seal-time checksum when one was recorded (driver-put objects).
        Returns the buffer, or None after dropping a corrupt copy so
        the caller treats it as lost.  Off by default — a sealed shm
        segment is not a storage fault domain, and this pays a full
        CRC pass per get."""
        if not self.cfg.object_integrity_verify_get:
            return buf
        st = self.objects.get(ref.binary())
        expected = st.checksum if st is not None else None
        if expected is None:
            return buf
        from ray_tpu_torch.core import integrity as _integrity

        if _integrity.checksum(buf) == expected:
            return buf
        _mdefs.metric("rt_object_integrity_errors_total").inc(
            tags={"path": "get"}
        )
        logger.error(
            "local shm copy of %s failed seal-time checksum; dropping "
            "it and re-deriving", ref.hex()[:12],
        )
        del buf
        self.store.release(ref.binary())
        self.store.delete(ref.binary())
        return None

    async def _read_shm(self, ref: ObjectRef, node_id: Optional[str]):
        try:
            buf = self.store.get(ref.binary(), timeout_ms=0)
            buf = self._maybe_verify_local(ref, buf)
            if buf is None:  # corrupt local copy: treat as lost
                return await self._reconstruct_and_get(ref)
        except ObjectNotFoundError:
            buf = None
            if node_id is not None and node_id != self.node_id:
                try:
                    await self.noded.call(
                        "pull_object",
                        {"id": ref.binary(), "node_id": node_id},
                    )
                    # non-blocking read — a 30s blocking shm wait here
                    # would freeze this whole event loop; if the pulled
                    # copy was re-spilled before we pinned it, the
                    # restore loop below recovers it
                    buf = self.store.get(ref.binary(), timeout_ms=0)
                except (rpc.RemoteError, rpc.RpcError) as e:
                    # a failed pull — source gone, or the copy failed
                    # checksum twice (ObjectCorruptionError) — is
                    # treat-as-lost: re-derive via lineage when this
                    # owner retained it, else surface the failure
                    if ref.binary() not in self.lineage:
                        raise
                    logger.warning(
                        "pull of %s from %s failed (%s); re-deriving "
                        "via lineage", ref.hex()[:12], node_id[:8], e,
                    )
                    return await self._reconstruct_and_get(ref)
                except ObjectNotFoundError:
                    pass  # re-spilled under us: restore loop below
            if buf is None:
                # spilled-to-disk primaries restore without recompute;
                # a restored object can be re-evicted/re-spilled before
                # we read it under sustained pressure, so retry a few
                # times before falling back to lineage reconstruction
                for _attempt in range(3):
                    reply = await self.noded.call(
                        "restore_object", {"id": ref.binary()}
                    )
                    if not (reply and reply.get("ok")):
                        break
                    try:
                        buf = self.store.get(ref.binary(), timeout_ms=0)
                        break
                    except ObjectNotFoundError:
                        await asyncio.sleep(0.1)
                if buf is None:
                    return await self._reconstruct_and_get(ref)
        return self._deser_pinned(ref.binary(), buf)

    async def _prime_borrowed(self, refs):
        """Bulk-resolve foreign-owned refs before the per-ref gather:
        one `get_object_values` frame per owner per 512 refs instead of
        one routed RPC per ref (the object-location fan-in channel —
        `src/ray/pubsub/README.md`).  Failures degrade silently to the
        per-ref path.  Returns the primed ids so the caller can prune
        entries its gather never consumed."""
        groups: Dict[tuple, list] = {}
        primed: list = []
        for r in refs:
            b = r.binary()
            if (r.owner is not None and tuple(r.owner) != self.address
                    and b not in self.objects
                    and b not in self._primed_replies
                    and not self.store.contains(b)):
                groups.setdefault(tuple(r.owner), []).append(b)

        async def _one_chunk(owner, chunk):
            try:
                replies = await self.noded.call("route", {
                    "target": owner,
                    "method": "get_object_values",
                    "payload": {"ids": chunk},
                    "want_reply": True,
                })
            except Exception as e:
                # degraded: per-ref path covers this chunk
                logger.debug("batched owner fetch failed: %s", e)
                return
            for id_b, rep in zip(chunk, replies):
                # not-yet-ready objects come back "pending" so one slow
                # producer can't hold its chunk's reply hostage; the
                # per-ref path (which awaits readiness) handles them
                if rep and rep[0] != "pending":
                    self._primed_replies[id_b] = rep
                    primed.append(id_b)

        chunks = []
        for owner, ids in groups.items():
            if len(ids) < 4:
                continue  # a couple of refs aren't worth a bulk frame
            for i in range(0, len(ids), self._BULK_GET_CHUNK):
                chunks.append(
                    _one_chunk(owner, ids[i:i + self._BULK_GET_CHUNK])
                )
        if chunks:  # all owners, all chunks resolve concurrently
            await asyncio.gather(*chunks)
        return primed

    async def _get_borrowed(self, ref: ObjectRef):
        """Fetch a foreign-owned value.  Loops rather than trusting one
        location answer: between the owner's reply and our read, the
        primary can be re-spilled (and, under storage faults, its disk
        copy quarantined) — each round tries the local store, then a
        daemon restore, then RE-ASKS the owner, whose verify path
        restores or re-derives via lineage before handing out a
        location.  The old single-shot 30s blocking shm wait both froze
        this event loop and hung on primaries nobody would restore."""
        if self.store.contains(ref.binary()):
            buf = self.store.get(ref.binary(), timeout_ms=0)
            return self._deser_pinned(ref.binary(), buf)
        if ref.owner is None:
            raise exc.ObjectLostError(object_id=ref.id)
        reply = self._primed_replies.pop(ref.binary(), None)
        for attempt in range(8):
            if reply is None:
                reply = await self.noded.call(
                    "route",
                    {
                        "target": tuple(ref.owner),
                        "method": "get_object_value",
                        "payload": {"id": ref.binary()},
                        "want_reply": True,
                    },
                )
            kind = reply[0]
            if kind == "inline":
                tag, val = ser.deserialize(memoryview(reply[1]))
                return _unwrap(tag, val)
            if kind == "error":
                raise _error_from_envelope(reply[1])
            if kind != "shm":
                raise exc.ObjectLostError(object_id=ref.id)
            node_id = reply[1]
            reply = None  # a failed round re-asks the owner
            try:
                if (node_id != self.node_id
                        and not self.store.contains(ref.binary())):
                    await self.noded.call(
                        "pull_object",
                        {"id": ref.binary(), "node_id": node_id},
                    )
                buf = self.store.get(ref.binary(), timeout_ms=0)
                return self._deser_pinned(ref.binary(), buf)
            except (ObjectNotFoundError, rpc.RemoteError, rpc.RpcError) as e:
                if node_id == self.node_id:
                    # spilled primary on this node: restore in place.
                    # A restore RPC that itself fails (daemon handler
                    # error, flapping conn — exactly the fault regime
                    # this loop exists for) is a failed ROUND, not an
                    # escape from the retry contract.
                    try:
                        r2 = await self.noded.call(
                            "restore_object", {"id": ref.binary()}
                        )
                    except (rpc.RemoteError, rpc.RpcError) as re2:
                        logger.debug("restore of borrowed %s failed: %s",
                                     ref.hex()[:12], re2)
                        r2 = None
                    if r2 and r2.get("ok"):
                        try:
                            buf = self.store.get(ref.binary(), timeout_ms=0)
                            return self._deser_pinned(ref.binary(), buf)
                        except ObjectNotFoundError:
                            pass  # re-spilled already: next round
                logger.debug(
                    "borrowed %s unavailable at %s (attempt %d): %s",
                    ref.hex()[:12], str(node_id)[:8], attempt + 1, e,
                )
                await asyncio.sleep(
                    backoff_delay_s(attempt, base_s=0.05, cap_s=1.0,
                                    rng=self._retry_rng)
                )
        raise exc.ObjectLostError(
            f"object {ref.hex()} unavailable after 8 fetch rounds "
            "(primary kept vanishing: re-spilled/corrupt faster than "
            "it could be restored or re-derived)",
            object_id=ref.id,
        )

    async def _reconstruct_object(self, ref: ObjectRef):
        """Lineage reconstruction (reference:
        `object_recovery_manager.h:90`): resubmit the creating task and
        wait for the object to exist again (no value read)."""
        spec = self.lineage.get(ref.binary())
        if spec is None:
            raise exc.ObjectLostError(
                f"object {ref.hex()} lost and no lineage retained",
                object_id=ref.id,
            )
        with self._state_lock:
            st = self.objects[ref.binary()]
            # Dedup on the creating task: concurrent reconstructions of
            # this ref (two borrowers racing) or of SIBLING returns of
            # the same task must not double-resubmit.  Worse than the
            # wasted execution: a second resubmit would replace
            # st.ready with a fresh event AFTER the first waiter parked
            # on the old one — completion sets only the current event
            # and the first waiter hangs forever (the bit-flip chaos
            # storm found exactly this wedge).
            already = spec.task_id.binary() in self.pending_tasks
            if st.ready.is_set():
                st.ready = asyncio.Event()
                st.where = None
            # capture under the lock: THIS is the event completion sets
            wait_ev = st.ready
            if not already:
                # the resubmit keeps the spec's retry budget: a worker
                # killed DURING re-derivation (chaos mid-epoch) must
                # retry like any other attempt, not permanently fail
                # the object — the budget still bounds total attempts
                # per resubmission
                self.pending_tasks[spec.task_id.binary()] = _PendingTask(
                    spec, spec.max_retries
                )
                if spec.actor_id is None:
                    # lineage resubmits count as submissions so
                    # per-shard submitted/completed stay balanced
                    # (shard.lock nests inside _state_lock by the
                    # documented order)
                    shard = self._shard_for(spec.task_id.binary())
                    with shard.lock:
                        shard.submitted += 1
                # completion decrements submitted refs again, so
                # re-pin args
                for a in spec.args:
                    if isinstance(a, ArgRef):
                        rc = self.refs.get(a.id_bytes)
                        if rc:
                            rc.submitted += 1
        if not already:
            logger.info("reconstructing %s via lineage resubmit",
                        ref.hex())
            _mdefs.inc("rt_object_reconstructions_total")
            if spec.actor_id is not None:
                # actor-task returns re-execute ON the actor: route
                # through the ordered actor queue with a fresh sequence
                # number (the original seq was consumed; replaying it
                # would wedge the executor's in-order delivery)
                spec.seq_no = next_actor_seq(
                    spec.actor_id.binary(), spec.kwargs.get("__rt_group__")
                )
                self._push_actor_task(spec.actor_id.binary(), spec)
            else:
                self._push_or_queue(spec)
        await wait_ev.wait()
        if st.error is not None:
            raise _error_from_envelope(st.error)
        return st

    async def _reconstruct_and_get(self, ref: ObjectRef):
        st = await self._reconstruct_object(ref)
        if st.where == _INLINE:
            tag, val = ser.deserialize(memoryview(st.value))
            return _unwrap(tag, val)
        return await self._read_shm(ref, st.node_id)

    async def _wait(self, refs, num_returns, timeout):
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        done_flags = [False] * len(refs)

        # Synchronous readiness scan FIRST: already-ready refs (and the
        # `wait(timeout=0)` poll controllers issue every tick) cost zero
        # task allocations.  Without this, a 1k-ref drain loop
        # (`done, pending = wait(pending, 1)`) re-arms a coroutine per
        # ref per call — O(n^2) task churn across the drain.
        pending_idx: List[int] = []
        for i, r in enumerate(refs):
            st = self.objects.get(r.binary())
            if st is not None:
                if st.ready.is_set():
                    done_flags[i] = True
                else:
                    pending_idx.append(i)
            elif self.store.contains(r.binary()):
                done_flags[i] = True
            else:
                pending_idx.append(i)

        async def _one(i, r):
            st = self.objects.get(r.binary())
            if st is not None:
                await st.ready.wait()
            elif self.store.contains(r.binary()):
                pass
            elif r.owner is not None:
                # borrowed ref: the owner's get_object_value blocks until
                # the object is ready (covers inline objects that never
                # touch the shm store)
                await self.noded.call(
                    "route",
                    {
                        "target": tuple(r.owner),
                        "method": "get_object_value",
                        "payload": {"id": r.binary()},
                        "want_reply": True,
                    },
                )
            else:
                while not self.store.contains(r.binary()):
                    await asyncio.sleep(0.005)
            done_flags[i] = True

        tasks: List[asyncio.Task] = []
        if sum(done_flags) < num_returns and (timeout is None or timeout > 0):
            # waiters only for the refs the scan saw as pending
            tasks = [
                asyncio.create_task(_one(i, refs[i])) for i in pending_idx
            ]
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            while tasks and sum(done_flags) < num_returns:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                done, pending = await asyncio.wait(
                    tasks, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
                )
                tasks = list(pending)
                if not tasks:
                    break
        finally:
            for t in tasks:
                t.cancel()
        ready = [r for i, r in enumerate(refs) if done_flags[i]]
        not_ready = [r for i, r in enumerate(refs) if not done_flags[i]]
        # the reference's ray.wait contract: done never exceeds
        # num_returns — extra already-ready refs stay in the second list
        # so `done, pending = wait(pending, num_returns=1)` loops
        # consume every result exactly once
        if len(ready) > num_returns:
            not_ready = ready[num_returns:] + not_ready
            ready = ready[:num_returns]
        return ready, not_ready

    # ------------------------------------------------------------------
    # reference counting (reference: reference_count.h:64)
    # ------------------------------------------------------------------
    def _pin_contained(self, captured_refs):
        """Pin owned refs captured inside a serialized value until a
        consumer's borrow registration converts the pin."""
        if not captured_refs:
            return
        with self._state_lock:
            for r in captured_refs:
                if r.owner is not None and tuple(r.owner) == self.address:
                    self.refs.setdefault(r.binary(), _RefCount()).contained = 1

    def _register_contained(self, container_id: bytes, entries, acks=None):
        """The container object `container_id` (a task return we own, or
        a local put) holds references to the listed inner objects.  We
        register a borrow per inner ref on its owner so the inner can't
        be freed while the container lives, and release those borrows
        when the container itself is freed (`_maybe_free`).  Caller
        holds `_state_lock`.  With `acks` (a list), foreign
        registrations become want_reply calls whose futures land there —
        the executor's transit_release must not be sent until the inner
        owners have these borrows on the books."""
        if not entries:
            return
        recorded = []
        foreign: Dict[tuple, list] = {}
        for inner_id, owner in entries:
            owner = tuple(owner)
            if owner == self.address:
                rc = self.refs.setdefault(inner_id, _RefCount())
                # NOTE: rc.contained (the in-flight inline-arg pin) is
                # deliberately untouched — it has its own consumption
                # events (_h_add_borrow / owner deserialization); a
                # container registration is an additional holder, not a
                # consumer
                rc.borrowers += 1
                recorded.append(("selfborrow", inner_id, None))
            else:
                foreign.setdefault(owner, []).append(inner_id)
                recorded.append(("borrow", inner_id, owner))
        # one frame per (owner, 1024-chunk), NOT per inner ref: a task
        # result carrying 10k refs registers in ~10 frames (reference:
        # `src/ray/pubsub/README.md` fan-in argument).  On the ACK'd
        # path one want_reply future covers its whole chunk — the owner
        # replies after processing every event in it.
        for owner, ids in foreign.items():
            for i in range(0, len(ids), self._REF_EVENT_MAX_BATCH):
                chunk = [
                    ("add_borrow", {"id": x, "borrower": self.address})
                    for x in ids[i:i + self._REF_EVENT_MAX_BATCH]
                ]
                try:
                    if acks is not None:
                        acks.append(asyncio.run_coroutine_threadsafe(
                            self.noded.call("route", {
                                "target": owner,
                                "method": "ref_events",
                                "payload": {"events": chunk},
                                "want_reply": True,
                            }), self.loop
                        ))
                    else:
                        for method, p in chunk:
                            self._queue_ref_event(owner, method, p)
                except Exception as e:
                    logger.debug("borrow registration dropped: %s", e)
        if recorded:
            self._contained_in.setdefault(container_id, []).extend(recorded)

    def _release_contained(self, container_id: bytes):
        """Container freed: drop the borrows it held on inner refs.
        Caller holds `_state_lock`."""
        entries = self._contained_in.pop(container_id, None)
        if not entries:
            return
        for kind, inner_id, owner in entries:
            if kind == "selfborrow":
                rc = self.refs.get(inner_id)
                if rc:
                    rc.borrowers -= 1
                    self._maybe_free(inner_id)
            else:
                self._send_remove_borrow(inner_id, owner)

    def _add_local_ref(self, id_bytes: bytes):
        rc = self.refs.setdefault(id_bytes, _RefCount())
        rc.local += 1
        if _RECORD_CALLSITES and not rc.callsite:
            rc.callsite = _creation_site()

    def _maybe_free(self, id_bytes: bytes):
        rc = self.refs.get(id_bytes)
        if rc is None or rc.total() > 0:
            return
        del self.refs[id_bytes]
        # the single deletion point also closes out a registered borrow:
        # every count decrement funnels here, so a borrowed entry can
        # never vanish without its remove_borrow reaching the owner
        if rc.registered and rc.owner_addr:
            self._send_remove_borrow(id_bytes, rc.owner_addr)
        st = self.objects.pop(id_bytes, None)
        spec = self.lineage.pop(id_bytes, None)
        if spec is not None:
            # this object's lineage no longer needs its inputs: release
            # the lineage pins it held on the spec's args (cascades up
            # the chain — freeing a shuffle output unpins its pieces,
            # which unpin the read blocks)
            for a in spec.args:
                if isinstance(a, ArgRef):
                    arc = self.refs.get(a.id_bytes)
                    if arc and arc.lineage > 0:
                        arc.lineage -= 1
                        self._maybe_free(a.id_bytes)
        self._release_contained(id_bytes)
        if st is None:
            self._notify_freed(id_bytes)
            return
        if st.where == _SHM:
            if st.node_id == self.node_id:
                try:
                    self.store.delete(id_bytes)
                except Exception as e:
                    logger.debug("freeing local object: %s", e)
            else:
                try:
                    self.noded.send_threadsafe(
                        "free_remote", {"id": id_bytes, "node_id": st.node_id}
                    )
                except Exception as e:
                    logger.debug("free_remote dropped: %s", e)
        self._notify_freed(id_bytes)

    def _notify_freed(self, id_bytes: bytes):
        """Wake wait_freed() waiters — called at the single deletion
        point (after the local store copy, if any, is gone)."""
        for ev in self._free_waiters.pop(id_bytes, ()):
            ev.set()

    def wait_freed(self, id_bytes: bytes,
                   timeout: Optional[float] = None) -> bool:
        """Event-driven lifetime assertion: block until this process's
        refcount entry for `id_bytes` is retired (and its local shm
        copy deleted), or `timeout` elapses.  Returns True when freed.
        Already-free ids return immediately — tests use this instead of
        wall-clock contains() polling (suite-load deflake).

        When this process holds NO refs entry but the node-shared
        store still has a copy, the deletion will come from ANOTHER
        process's _maybe_free (the owner's) — no local event will ever
        fire, so that case polls the store at a short interval instead
        of registering a dead waiter."""
        import threading as _threading

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._state_lock:
            if id_bytes not in self.refs:
                if not self.store.contains(id_bytes):
                    return True
                ev = None  # foreign-owned copy: poll below
            else:
                ev = _threading.Event()
                self._free_waiters.setdefault(id_bytes, []).append(ev)
        if ev is None:
            while self.store.contains(id_bytes):
                if deadline is not None and time.monotonic() > deadline:
                    return False
                time.sleep(0.02)
            return True
        freed = ev.wait(timeout)
        if not freed:
            with self._state_lock:
                waiters = self._free_waiters.get(id_bytes)
                if waiters and ev in waiters:
                    waiters.remove(ev)
                    if not waiters:
                        del self._free_waiters[id_bytes]
        return freed

    # ------------------------------------------------------------------
    # kv / controller passthroughs
    # ------------------------------------------------------------------
    def kv_put(self, key: str, value: bytes):
        return self._run(self.controller.call("kv_put", {"key": key, "value": value}))

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._run(self.controller.call("kv_get", {"key": key}))

    def kv_del(self, key: str):
        return self._run(self.controller.call("kv_del", {"key": key}))

    def controller_call(self, method: str, payload=None, timeout=None):
        return self._run(self.controller.call(method, payload), timeout=timeout)

    def noded_call(self, method: str, payload=None, timeout=None):
        return self._run(self.noded.call(method, payload), timeout=timeout)

    # ------------------------------------------------------------------
    # inbound handlers (io thread)
    # ------------------------------------------------------------------
    async def _handle(self, method, payload, conn):
        fn = getattr(self, "_h_" + method, None)
        if fn is None:
            raise rpc.RpcError(f"runtime: no handler {method!r}")
        return await fn(payload, conn)

    async def _h_publish(self, payload, conn):
        """Pubsub delivery from the controller (reference:
        `src/ray/pubsub/` long-poll push): fan the message out to every
        local queue subscribed to its channel."""
        channel = payload.get("channel")
        with self._state_lock:
            queues = list(self._pubsub_queues.get(channel, []))
        for q in queues:
            q.put_nowait(payload.get("msg"))
        return {"ok": True}

    def subscribe(self, channel: str):
        """Subscribe to a controller pubsub channel; returns an
        `asyncio.Queue`-backed iterator handle usable from any thread
        via `next_message(timeout)` (reference: `GcsSubscriber` —
        typed channel subscription with queued delivery)."""
        import queue as _q

        q = _q.Queue()
        if self._shutdown:
            raise RuntimeError("runtime is shut down")
        with self._state_lock:
            self._pubsub_queues.setdefault(channel, []).append(q)
        cancelled = None
        try:
            self._run(self._pubsub_reconcile(), timeout=30)
        except asyncio.CancelledError as e:
            # loop shutdown racing this subscribe: still run the
            # cleanup below (the queue must not stay 'desired'), then
            # surface the cancellation
            cancelled = e
        except Exception as e:
            # judged below by whether registration actually landed
            logger.debug("subscribe attempt errored: %s", e)
        with self._state_lock:
            registered = (
                cancelled is None and channel in self._pubsub_registered
            )
        if not registered:
            with self._state_lock:
                lst = self._pubsub_queues.get(channel, [])
                if q in lst:
                    lst.remove(q)
                if not lst:
                    self._pubsub_queues.pop(channel, None)
            # the RPC may have landed despite the failure (uncertain):
            # a follow-up reconcile unsubscribes anything undesired
            self._spawn_pubsub_reconcile()
            if cancelled is not None:
                raise cancelled
            raise RuntimeError(
                f"pubsub subscribe failed for channel {channel!r}"
            )

        class _Subscription:
            def __init__(self, runtime):
                self._rt = runtime

            def next_message(self, timeout=None):
                return q.get(timeout=timeout)

            def close(self):
                with self._rt._state_lock:
                    lst = self._rt._pubsub_queues.get(channel, [])
                    if q in lst:
                        lst.remove(q)
                    if not lst:
                        # last local watcher gone: desired state no
                        # longer includes the channel; the reconciler
                        # unregisters it at the controller
                        self._rt._pubsub_queues.pop(channel, None)
                # fire-and-forget: close() must not block on a wedged
                # controller, and the reconciler serializes against any
                # concurrent subscribe()
                self._rt._spawn_pubsub_reconcile()

        return _Subscription(self)

    def _spawn_pubsub_reconcile(self) -> None:
        """Fire-and-forget a reconcile pass on the io loop.  The
        coroutine is created INSIDE the loop-thread callback, never
        handed across threads: `run_coroutine_threadsafe` parks the
        coroutine in a callback that silently never runs when the loop
        stops first — abandoning it un-awaited (CPython warns at GC).
        With this shape, a stopped loop simply never creates it."""
        def _cb():
            if self._shutdown:
                return
            task = asyncio.ensure_future(self._pubsub_reconcile())
            task.add_done_callback(
                lambda t: t.cancelled() or t.exception()
            )

        try:
            self.loop.call_soon_threadsafe(_cb)
        except Exception as e:
            # loop closed: nothing to reconcile against anymore
            logger.debug("pubsub reconcile not scheduled: %s", e)

    async def _pubsub_reconcile(self) -> bool:
        """Single-writer pubsub registration reconciler: drives the
        controller-side registration set toward the desired state
        (channels with live local queues).  Every (un)subscribe RPC in
        the process flows through here, serialized by one asyncio lock
        on the io loop — so a close()'s trailing unsubscribe can never
        sever a concurrent subscribe(), and the reconnect path's durable
        resubscribe can't resurrect a channel whose last watcher closed
        (reference: `GcsSubscriber` keeps one registration per channel
        per connection).

        A channel whose RPC outcome is unknown (timeout, or this task
        cancelled mid-RPC — the frame may already be at the controller)
        goes into `_pubsub_uncertain`; the next pass resolves it by
        re-subscribing (idempotent at the controller) when desired or
        unsubscribing (harmless no-op) when not, so a cancelled
        subscribe() can't leave an orphan server-side registration
        pushing into a queueless connection forever.  Failures are
        per-channel: one bad channel never blocks the others.  Returns
        False if any subscribe RPC failed this pass."""
        async with self._pubsub_async_lock:
            failed: set = set()
            while True:
                with self._state_lock:
                    desired = set(self._pubsub_queues)
                    registered = set(self._pubsub_registered)
                    uncertain = set(self._pubsub_uncertain)
                to_add = desired - registered - failed
                to_del = (registered | uncertain) - desired - failed
                if not to_add and not to_del:
                    return not failed
                for ch in sorted(to_add):
                    try:
                        await asyncio.wait_for(
                            self.controller.call(
                                "subscribe", {"channel": ch}
                            ),
                            10,
                        )
                    except asyncio.CancelledError:
                        with self._state_lock:
                            self._pubsub_uncertain.add(ch)
                        raise
                    except Exception:
                        logger.warning(
                            "pubsub subscribe RPC failed for %r", ch,
                            exc_info=True,
                        )
                        with self._state_lock:
                            self._pubsub_uncertain.add(ch)
                        failed.add(ch)
                        continue
                    with self._state_lock:
                        self._pubsub_registered.add(ch)
                        self._pubsub_uncertain.discard(ch)
                for ch in sorted(to_del):
                    # deregister locally FIRST: if a subscribe() lands
                    # mid-RPC the next loop pass re-subscribes, and the
                    # same-connection RPC ordering keeps it after this
                    with self._state_lock:
                        self._pubsub_registered.discard(ch)
                    try:
                        await asyncio.wait_for(
                            self.controller.call(
                                "unsubscribe", {"channel": ch}
                            ),
                            10,
                        )
                    except asyncio.CancelledError:
                        with self._state_lock:
                            self._pubsub_uncertain.add(ch)
                        raise
                    except Exception as e:
                        # best-effort; closed conns get pruned
                        logger.debug("unsubscribe failed: %s", e)
                    # one attempt resolves the uncertainty either way:
                    # a failed unsubscribe on a live conn is rare, and
                    # retrying it forever would spin this pass
                    with self._state_lock:
                        self._pubsub_uncertain.discard(ch)

    async def _h_task_result(self, payload, conn):
        """A task we own finished on a worker (legacy single-result
        frame: daemon relays, worker_died routes) or was routed back via
        the daemons.  Direct executor pushes arrive coalesced as
        `task_result_batch`; both funnel into the same ingestion path
        (core/completion.py)."""
        result: TaskResult = (
            payload["result"] if isinstance(payload, dict) else payload
        )
        await _completion.ingest_results(self, [result], conn)

    async def _h_task_result_batch(self, payload, conn):
        """Coalesced completion frame: every result one executor
        produced for this owner within one connection tick (reference
        analog: the owner-side fan-in that keeps completion dispatch
        O(#frames), not O(#tasks); see docs/control_plane.md)."""
        results = list(payload.results)
        await _completion.ingest_results(self, results, conn)

    async def _h_stream_item(self, payload, conn):
        """One yielded item of a streaming-generator task we own arrived
        (ahead of the final task_result).  Duplicate indices (task retry
        replaying the stream) are dropped — item object ids are
        deterministic in (task_id, index)."""
        tid = payload["task_id"].binary()
        index = payload["index"]
        ret = payload["item"]
        oid = ObjectID.for_return(payload["task_id"], index)
        with self._state_lock:
            stream = self._streams.get(tid)
            if stream is None or oid.binary() in self.objects:
                return
            st = _ObjectState(ready=asyncio.Event())
            if ret[0] == _INLINE:
                st.where, st.value, st.size = _INLINE, ret[1], len(ret[1])
                contained = ret[2] if len(ret) > 2 else None
            else:
                st.where, st.node_id, st.size = _SHM, ret[1], ret[2]
                contained = ret[3] if len(ret) > 3 else None
            if contained:
                # acks parked per task: _h_task_result awaits them before
                # confirming transit_release, so streamed items get the
                # same registered-before-release guarantee as returns
                acks = self._stream_reg_acks.setdefault(tid, [])
                self._register_contained(oid.binary(), contained, acks)
            st.ready.set()
            self.objects[oid.binary()] = st
            self._add_local_ref(oid.binary())
            stream.items[index] = ObjectRef(oid, self.address, _register=True)
        stream.event.set()

    def stream_next(self, task_id_bytes: bytes, timeout: Optional[float] = None):
        """Next item ObjectRef of a streaming task, blocking.  Returns
        None when the stream is exhausted; raises the task's error at
        the position it occurred."""
        return self._run(
            self._stream_next_async(task_id_bytes), timeout=timeout
        )

    async def stream_wait_done(self, tid: bytes, trace_ctx=None):
        """Await completion of a streaming task (ok or error); used by
        watchers (e.g. serve's router queue-len tracking) that must not
        race the consumer.  Returns the stream's terminal error envelope
        (None on clean completion) — read off the held stream object, so
        a consumer popping the stream can't hide the error from the
        watcher (the router's breaker classification depends on it).

        `trace_ctx` is the watched request's trace context: the
        stream's terminal event is recorded into THAT trace, so a
        streaming request's lifecycle stays one trace id end to end
        instead of fragmenting at the watcher."""
        with self._state_lock:
            stream = self._streams.get(tid)
        if stream is None:
            return None
        await stream.done.wait()
        if trace_ctx is not None:
            from ray_tpu_torch.util import tracing as _tracing

            if stream.error is not None:
                _tracing.record_instant("stream_done", trace_ctx,
                                        error=True)
            else:
                _tracing.record_instant("stream_done", trace_ctx)
        return stream.error

    async def _stream_next_async(self, tid: bytes):
        while True:
            with self._state_lock:
                stream = self._streams.get(tid)
                if stream is None:
                    return None
                nxt = stream.items.pop(stream.consumed + 1, None)
                if nxt is not None:
                    stream.consumed += 1
                    return nxt
                if stream.total is not None and stream.consumed >= stream.total:
                    self._streams.pop(tid, None)
                    return None
                if stream.error is not None:
                    # the next in-order item will never arrive: surface
                    # the error (delivered items were consumed above)
                    self._streams.pop(tid, None)
                    raise _error_from_envelope(stream.error)
                stream.event.clear()
            await stream.event.wait()

    def stream_release(self, tid: bytes):
        """Drop a stream's owner-side state (abandoned consumer).
        Unconsumed item refs are released by their ObjectRefs' GC; items
        still arriving find no stream and are ignored.  Completion
        watchers (stream_wait_done) are woken — the stream is finished
        as far as this owner is concerned.  If the producer is still
        running, it is told to stop (an unbounded generator must not
        keep pinning its worker and sealing orphaned items into shm)."""
        with self._state_lock:
            stream = self._streams.pop(tid, None)
            pt = self.pending_tasks.get(tid)
        if stream is None or self._shutdown:
            return
        try:
            self.loop.call_soon_threadsafe(stream.done.set)
            if pt is not None:
                asyncio.run_coroutine_threadsafe(
                    self._stream_cancel_remote(tid, pt.spec), self.loop
                )
        except RuntimeError:
            pass

    async def _stream_cancel_remote(self, task_id: bytes, spec: TaskSpec):
        """Best-effort 'stop producing' to wherever the streaming task
        runs (same transport walk as _cancel_remote)."""
        conns = []
        for shard in self._shards:
            with shard.lock:
                for pool, lease in shard.conn_lease.values():
                    if task_id in lease.assigned:
                        conns.append(lease.conn)
        if spec.actor_id is not None:
            with self._state_lock:
                c = self._actor_conns.get(spec.actor_id.binary())
            if c is not None:
                conns.append(c)
        for conn in conns:
            try:
                # threadsafe variant: the conn may live on a shard loop
                conn.send_threadsafe("stream_cancel", {"task_id": task_id})
                return
            except Exception as e:
                logger.debug("stream_cancel to executor failed: %s", e)
        try:
            self.noded.send("stream_cancel", {"task_id": task_id})
        except Exception as e:
            logger.debug("stream_cancel via noded failed: %s", e)

    async def _h_stream_cancel(self, payload, conn):
        """Executor side: mark the stream abandoned; _stream_out stops
        at the next yield boundary and closes the user generator."""
        cancelled = self._cancelled_streams = getattr(
            self, "_cancelled_streams", set()
        )
        cancelled.add(payload["task_id"])

    async def _verify_shm_primary(self, id_bytes: bytes, st):
        """A borrower is about to be pointed at our shm primary: make
        sure it still exists.  Evicted/lost primaries restore from
        spill or rebuild via lineage BEFORE the location is handed out —
        this is what makes chained reconstruction work (rebuilding task
        B pulls arg A through this path, and A may itself be gone)."""
        if st.node_id != self.node_id or self.store.contains(id_bytes):
            return st
        ref = ObjectRef(ObjectID(id_bytes), self.address)
        try:
            # restore from spill, else rebuild via lineage — WITHOUT
            # deserializing the value (no get-pin, no wasted decode)
            reply = await self.noded.call("restore_object", {"id": id_bytes})
            if not (
                reply and reply.get("ok") and self.store.contains(id_bytes)
            ):
                await self._reconstruct_object(ref)
        except Exception as e:
            logger.warning("could not restore %s for borrower: %r",
                           ref.hex(), e, exc_info=True)
        return self.objects.get(id_bytes) or st

    async def _h_get_object_value(self, payload, conn):
        st = self.objects.get(payload["id"])
        if st is None:
            return ("gone",)
        await st.ready.wait()
        if st.error is not None:
            return ("error", st.error)
        if st.where == _INLINE:
            return ("inline", st.value)
        st = await self._verify_shm_primary(payload["id"], st)
        if st.error is not None:
            return ("error", st.error)
        if st.where == _INLINE:  # reconstruction may have inlined it
            return ("inline", st.value)
        return ("shm", st.node_id)

    async def _h_get_object_values(self, payload, conn):
        """Bulk location/value lookup: one routed frame resolves a whole
        batch of this owner's objects for a borrower's multi-ref get
        (reference: the object-location pubsub channel's fan-in
        argument, `src/ray/pubsub/README.md` — a 10k-ref get must not
        be 10k waiting RPCs)."""
        out = []
        for i in payload["ids"]:
            st = self.objects.get(i)
            if st is None or not st.ready.is_set():
                # don't hold the whole batch for one slow producer —
                # the caller's per-ref path awaits readiness itself
                out.append(("pending",))
            else:
                out.append(await self._h_get_object_value({"id": i}, conn))
        return out

    async def _h_add_borrow(self, payload, conn):
        """Owner side: a borrower registered (reference: the owner's
        borrower set, `reference_count.h:64`).  The reply doubles as the
        registration ACK workers await before sending a task result that
        forwards the ref onward."""
        with self._state_lock:
            rc = self.refs.setdefault(payload["id"], _RefCount())
            rc.borrowers += 1
            b = payload.get("borrower")
            if b is not None:
                b = tuple(b)
                rc.borrower_addrs[b] = rc.borrower_addrs.get(b, 0) + 1
            rc.contained = 0  # pin transfers to the borrower
        return {"ok": True}

    async def _h_ref_events(self, payload, conn):
        """Owner side of the coalesced ref-event channel: one frame
        carries a whole batch of borrow registrations/releases from one
        counterpart (reference: `src/ray/pubsub/README.md` — reducing
        O(#objects) waiting RPCs to O(#subscribers))."""
        for method, p in payload["events"]:
            if method == "add_borrow":
                await self._h_add_borrow(p, conn)
            elif method == "remove_borrow":
                await self._h_remove_borrow(p, conn)

    async def _h_remove_borrow(self, payload, conn):
        with self._state_lock:
            rc = self.refs.get(payload["id"])
            if rc:
                b = payload.get("borrower")
                if b is not None:
                    b = tuple(b)
                    n = rc.borrower_addrs.get(b, 0)
                    if n <= 0:
                        # no matching registration from this borrower (its
                        # add_borrow was lost en route): rejecting the
                        # unmatched remove keeps the count from going
                        # negative and freeing under live borrowers
                        return
                    if n == 1:
                        rc.borrower_addrs.pop(b, None)
                    else:
                        rc.borrower_addrs[b] = n - 1
                rc.borrowers -= 1
                self._maybe_free(payload["id"])

    async def _h_worker_log(self, payload, conn):
        """Driver side: task/actor print lines from a worker (reference:
        `log_monitor.py:103` republishing worker logs to the driver)."""
        if not self.cfg.log_to_driver:
            return
        name = payload.get("name", "?")
        pid = payload.get("pid", 0)
        stream = payload.get("stream", "out")
        out = sys.stderr
        for line in payload.get("lines") or ():
            self._worker_log_lines.append((name, pid, stream, line))
            try:
                out.write(f"({name} pid={pid}) {line}\n")
            except (OSError, ValueError):
                return  # driver stdout closed/redirected away
        try:
            out.flush()
        except (OSError, ValueError):
            pass  # driver stdout closed/redirected away

    async def _h_transit_release(self, payload, conn):
        """The owner of a task's returns has registered its contained
        borrows with every inner owner: this executor's transit pins on
        the forwarded refs can drop."""
        entries = self._return_transit.pop(payload["task_id"], None)
        if entries:
            with self._state_lock:
                self._release_transit(entries)

    async def _h_memory_summary(self, payload, conn):
        """This process's object-reference table for `rt memory`
        (reference: `ray memory` — `_private/internal_api.py:34`
        memory_summary over every worker's reference table +
        `scripts.py:1955`).  One row per live ref entry: what kind of
        hold this process has, the value's residence, and (opt-in) the
        creation callsite."""
        rows = []
        with self._state_lock:
            for id_b, rc in self.refs.items():
                st = self.objects.get(id_b)
                if st is not None:
                    kind = "owned"
                elif rc.registered:
                    kind = "borrowed"
                else:
                    kind = "pending"  # counted but neither owned nor
                    #                   registered (e.g. pure transit)
                rows.append({
                    "object_id": id_b.hex(),
                    "kind": kind,
                    "local": rc.local,
                    "submitted": rc.submitted,
                    "borrowers": rc.borrowers,
                    "contained": rc.contained,
                    "transit": rc.transit,
                    "lineage_pinned": id_b in self.lineage,
                    "size": st.size if st else None,
                    "where": st.where if st else None,
                    "node_id": st.node_id if st else None,
                    "owner": ("self" if kind == "owned" else
                              list(rc.owner_addr) if rc.owner_addr
                              else None),
                    "borrower_addrs": [
                        [list(a), n] for a, n in rc.borrower_addrs.items()
                    ],
                    "callsite": rc.callsite,
                })
            held_pins = len(self._held_pins)
        return {
            "address": list(self.address),
            "mode": self.mode,
            "pid": os.getpid(),
            "held_pins": held_pins,
            "refs": rows,
        }

    async def _h_ping(self, payload, conn):
        return "pong"

    async def _h_dump_stacks(self, payload, conn):
        """All-thread stack dump for the on-demand profiler (reference:
        py-spy dump via `profile_manager.py:78`; this is the in-process
        fallback that needs no native tooling)."""
        from ray_tpu_torch.util.profiling import dump_all_stacks

        return dump_all_stacks()

    async def _h_profile_cpu(self, payload, conn):
        """Sampled CPU flamegraph of this worker (reference: py-spy
        record --format flamegraph): folded stacks over a window, run
        off-loop so sampling never blocks task execution."""
        from ray_tpu_torch.util.profiling import sample_flamegraph

        duration = min(float((payload or {}).get("duration_s", 5.0)), 60.0)
        hz = min(float((payload or {}).get("hz", 99.0)), 500.0)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: sample_flamegraph(duration, hz)
        )

    async def _h_profile_memory(self, payload, conn):
        """Windowed allocation profile (reference: memray heap
        profiles): stdlib tracemalloc diff over a window, off-loop."""
        from ray_tpu_torch.util.profiling import memory_profile

        duration = min(float((payload or {}).get("duration_s", 5.0)), 60.0)
        top = int((payload or {}).get("top", 30))
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: memory_profile(duration, top)
        )

    async def _h_set_accel_env(self, payload, conn):
        """Daemon push at lease-grant time: accelerator isolation env
        (CUDA_VISIBLE_DEVICES — `core/accelerators.py`).  Must land
        before user code first initializes CUDA; the daemon sends it on
        the same ordered stream as the task push.  An empty string
        unsets the variable.
        """
        import sys as _sys

        changed = False
        for k, v in (payload or {}).items():
            if v == "":
                if k in os.environ:
                    del os.environ[k]
                    changed = True
            elif os.environ.get(k) != v:
                os.environ[k] = v
                changed = True
        torch = _sys.modules.get("torch")
        if changed and torch is not None and torch.cuda.is_initialized():
            logger.warning(
                "accelerator env changed after torch initialised CUDA; "
                "the new GPU visibility takes effect only in a fresh "
                "worker"
            )
        return {"ok": True}

    # ---- executor side ----------------------------------------------
    async def _h_execute_task(self, spec: TaskSpec, conn):
        if spec.actor_id is not None:
            await self._exec_actor_ordered(spec, conn)
        else:
            asyncio.ensure_future(self._exec_task(spec, conn))

    async def _h_create_actor_instance(self, aspec: ActorCreationSpec, conn):
        if aspec.runtime_env:
            # plugin-ordered application (env_vars, working_dir,
            # py_modules, pip, custom) BEFORE the class blob
            # deserializes — the pickle may import shipped modules
            from ray_tpu_torch.core.runtime_env import apply_runtime_env

            await apply_runtime_env(aspec.runtime_env, self)
        cls = ser.loads(aspec.class_blob)
        self.actor_id = aspec.actor_id
        self._actor_aspec = aspec
        groups = dict(aspec.concurrency_groups or {})
        # per-group execution lanes (reference:
        # `concurrency_group_manager.h`): each named group gets its OWN
        # thread pool (sync methods) and a concurrency cap enforced by
        # a single-consumer lane queue — dedicated pools mean a flooded
        # default lane can never starve a group lane's threads, and the
        # one-acquirer-per-lane queue gives FIFO start order without
        # depending on asyncio.Semaphore waiter fairness.
        self._group_limits: Dict[Optional[str], int] = dict(groups)
        self._group_pools = {
            g: ThreadPoolExecutor(max_workers=n) for g, n in groups.items()
        }
        # default-lane limit: SYNC actors keep max_concurrency even in
        # out-of-order mode (order relaxed, concurrency kept).  Truly
        # async actors keep the historical unbounded default lane —
        # capping it at max_concurrency=1 would introduce exactly the
        # head-of-line blocking these modes exist to remove.
        if (groups or aspec.allow_out_of_order) \
                and not aspec.has_async_methods:
            self._group_limits[None] = aspec.max_concurrency
        self._lane_queues: Dict[Optional[str], asyncio.Queue] = {}
        if aspec.max_concurrency > 1:
            self._exec_pool = ThreadPoolExecutor(
                max_workers=aspec.max_concurrency
            )
        args = [await self._materialize_arg(a) for a in aspec.init_args]
        kwargs = {
            k: await self._materialize_arg(v) for k, v in aspec.init_kwargs.items()
        }
        loop = asyncio.get_running_loop()

        def _make():
            inst = cls.__new__(cls)
            if hasattr(inst, "__init__"):
                inst.__init__(*args, **kwargs)
            return inst

        self.actor_instance = await loop.run_in_executor(self._exec_pool, _make)
        # borrows registered while deserializing init args must be ACKed
        # before this reply: the driver's create-reply releases its
        # init-arg transit pins (same ordering guarantee as task results)
        await self._await_borrow_acks()
        return {"ok": True}

    async def _exec_actor_ordered(self, spec: TaskSpec, conn):
        group = spec.kwargs.get("__rt_group__")
        limits = getattr(self, "_group_limits", None) or {}
        if group is not None and group not in limits:
            envelope = ser.serialize_to_bytes(
                ValueError(
                    f"actor declares no concurrency group {group!r}"
                ),
                tag=ser.TAG_ERROR,
            )
            conn.send("task_result", {
                "result": TaskResult(task_id=spec.task_id, status="error",
                                     error=envelope),
                "owner": spec.owner,
            })
            return
        aspec = self._actor_aspec
        if aspec is not None and aspec.allow_out_of_order:
            # opt-in unordered mode (reference:
            # `out_of_order_actor_scheduling_queue.h:37`): execute as
            # delivered — no seq buffer, so a slow earlier call can
            # never delay a later one
            self._lane_dispatch(group, spec, conn)
            return
        # per-(caller, group) ordered streams: each group is its own
        # sequence lane, so a blocked "io" call never stalls "compute"
        caller = spec.owner[1]
        key = (caller, group)
        # Baseline 0 (a fresh handle's first seq), NOT first-arrival:
        # under transport reordering the first frame to ARRIVE can be a
        # later seq, and a first-arrival baseline would misread the
        # earlier seqs as stale retries and run them out of order
        # (reference: `actor_scheduling_queue.cc` buffers out-of-order
        # arrivals by seq_no for exactly this reason).  Sequence numbers
        # consumed by a PREVIOUS actor incarnation never arrive; the gap
        # timer in _drain_actor_seq skips past them after a bounded wait.
        expect = self._actor_seq_expect.setdefault(key, 0)
        if spec.seq_no < expect:
            if (self._actor_dispatched.get(spec.task_id.binary())
                    == getattr(conn, "serial", None)):
                # duplicate DELIVERY of a call already dispatched from
                # THIS connection (an at-least-once transport replaying
                # a frame): executing it again would repeat its side
                # effects — e.g. pop a second block from a split
                # coordinator that is then never acked.  Drop it; the
                # original's reply rides this same live stream.  The
                # same task id arriving on a NEW conn is a reconnect
                # retry (the original result died with the old conn)
                # and falls through to re-execution.
                logger.debug("dropping duplicate actor call %s (seq %d)",
                             spec.task_id.hex()[:12], spec.seq_no)
                return
            # late retry of an already-superseded sequence number:
            # execute out-of-band (restart relaxes exactly-once ordering,
            # same as the reference with max_task_retries > 0)
            self._record_dispatched(spec, conn)
            self._lane_dispatch(group, spec, conn)
            return
        buf = self._actor_seq_buffer.setdefault(key, {})
        buf[spec.seq_no] = (spec, conn)
        await self._drain_actor_seq(key, group)

    # How long a sequence gap may stall a lane before it is declared a
    # previous-incarnation hole and skipped (transport reorder fills
    # gaps in milliseconds; only restart holes persist this long).
    # Tunable via RTT_ACTOR_SEQ_GAP_S: on links whose delays can exceed
    # it, raise the window — a skip on a merely-slow frame relaxes the
    # lane to out-of-order delivery for that frame (logged when it
    # happens).
    _ACTOR_SEQ_GAP_S = float(os.environ.get("RTT_ACTOR_SEQ_GAP_S", "1.0"))

    async def _drain_actor_seq(self, key: tuple, group: Optional[str]):
        aspec = self._actor_aspec
        buf = self._actor_seq_buffer.get(key, {})
        if self._actor_drain_lock is None:
            self._actor_drain_lock = asyncio.Lock()
        async with self._actor_drain_lock:
            while self._actor_seq_expect[key] in buf:
                s, c = buf.pop(self._actor_seq_expect[key])
                self._actor_seq_expect[key] += 1
                self._record_dispatched(s, c)
                if aspec is not None and aspec.is_async:
                    self._lane_dispatch(group, s, c)
                else:
                    await self._exec_task(s, c)
        if not buf:
            return
        snapshot = self._actor_seq_expect[key]
        existing = self._actor_seq_timers.get(key)
        if existing is not None:
            if existing[1] == snapshot:
                return  # an up-to-date timer is already pending
            existing[0].cancel()  # stale window: restart it at the new expect

        def _gap_fire():
            self._actor_seq_timers.pop(key, None)
            b = self._actor_seq_buffer.get(key)
            if b and self._actor_seq_expect.get(key) == snapshot:
                # nothing filled the gap within the window: those
                # seqs were consumed by a previous incarnation
                logger.warning(
                    "actor seq lane %s: skipping gap %d->%d after "
                    "%.1fs (previous-incarnation hole, or a frame "
                    "delayed past RTT_ACTOR_SEQ_GAP_S)",
                    key, snapshot, min(b), self._ACTOR_SEQ_GAP_S,
                )
                self._actor_seq_expect[key] = min(b)
                asyncio.ensure_future(
                    self._drain_actor_seq(key, group)
                )

        self._actor_seq_timers[key] = (
            self.loop.call_later(self._ACTOR_SEQ_GAP_S, _gap_fire),
            snapshot,
        )

    _DISPATCHED_FENCE_CAP = 8192

    def _record_dispatched(self, spec: TaskSpec, conn):
        """Remember a dispatched actor task id and its origin conn
        (bounded FIFO) so a replayed delivery of the same frame on the
        same connection can be recognized and dropped instead of
        re-executed (duplicate side effects)."""
        tid = spec.task_id.binary()
        if tid not in self._actor_dispatched:
            self._actor_dispatched_order.append(tid)
        self._actor_dispatched[tid] = getattr(conn, "serial", None)
        while len(self._actor_dispatched_order) > self._DISPATCHED_FENCE_CAP:
            self._actor_dispatched.pop(
                self._actor_dispatched_order.popleft(), None
            )

    def _lane_dispatch(self, group: Optional[str], spec: TaskSpec, conn):
        """Enqueue one actor task on its lane.  Each lane has a single
        consumer coroutine, so starts are FIFO in enqueue order and the
        lane's concurrency cap needs no fair semaphore.  A lane with no
        limit (the async default lane) dispatches straight through —
        the historical unbounded path."""
        limits = getattr(self, "_group_limits", None) or {}
        limit = limits.get(group)
        if limit is None:
            asyncio.ensure_future(self._exec_task(spec, conn))
            return
        q = self._lane_queues.get(group)
        if q is None:
            q = self._lane_queues[group] = asyncio.Queue()
            asyncio.ensure_future(self._lane_worker(group, q, limit))
        q.put_nowait((spec, conn))

    async def _lane_worker(self, group: Optional[str], q: asyncio.Queue,
                           limit: int):
        """Single consumer of one lane's queue: admits up to `limit`
        concurrent tasks, in FIFO order."""
        slots = asyncio.Semaphore(limit)
        while True:
            spec, conn = await q.get()
            # only this coroutine acquires, so no barging is possible
            await slots.acquire()
            task = asyncio.ensure_future(self._exec_task(spec, conn))
            task.add_done_callback(lambda _t: slots.release())

    async def _adopt_driver_sys_path(self) -> bool:
        """Extend sys.path from the KV-published driver path (set by
        joining drivers whose spawn-env never reached this worker);
        True when anything new was added — the caller retries its
        deserialization once."""
        import json as _json

        from ray_tpu_torch.core.env_utils import adopt_sys_path

        try:
            blob = await self.controller.call(
                "kv_get", {"key": "driver:sys_path"}
            )
        except Exception as e:
            logger.debug("driver sys_path fetch failed: %s", e)
            return False
        if not blob:
            return False
        return adopt_sys_path(_json.loads(blob))

    def _try_pin_args(self, entries):
        """Phase 2 fast pass: pin every store-resident ArgRef in one
        atomic sweep.  Returns a value list (store-backed args
        deserialized, everything else `_UNRESOLVED` for the caller to
        resolve through `_materialize_arg`), or None when any needed
        object is not immediately pinnable — in which case every pin
        taken this round has been released and the caller re-runs
        phase 1."""
        pinned = []  # (index, id_bytes, buf)
        out = [_UNRESOLVED] * len(entries)

        def _release_all():
            for _i, b, buf in pinned:
                del buf
                try:
                    self.store.release(b)
                except Exception as e:
                    logger.debug("fast-pass pin release failed: %s", e)
            del pinned[:]

        try:
            for i, a in enumerate(entries):
                if not isinstance(a, ArgRef):
                    continue
                b = a.id_bytes
                st = self.objects.get(b)
                if st is not None:
                    if not st.ready.is_set():
                        _release_all()
                        return None
                    if st.error is not None:
                        raise _error_from_envelope(st.error)
                    if st.where == _INLINE:
                        continue  # _materialize_arg: no store access
                else:
                    reply = self._primed_replies.get(b)
                    if reply is not None and reply[0] == "error":
                        raise _error_from_envelope(reply[1])
                    if reply is not None and reply[0] == "inline":
                        continue
                try:
                    buf = self.store.get(b, timeout_ms=0)
                except ObjectNotFoundError:  # not resident right now
                    _release_all()
                    return None
                if st is not None:
                    ref = ObjectRef(ObjectID(b), a.owner)
                    buf = self._maybe_verify_local(ref, buf)
                    if buf is None:  # corrupt copy dropped: re-derive
                        _release_all()
                        return None
                pinned.append((i, b, buf))
        except BaseException:
            _release_all()
            raise
        for i, b, buf in pinned:
            out[i] = self._deser_pinned(b, buf)
        return out

    async def _prefetch_arg(self, a):
        """Phase 1 of task-arg materialization: make the arg's bytes
        LOCAL without taking a store pin (reference: the pull manager
        stages dependencies into plasma unpinned; pinning happens at
        execution).  A task parked here — waiting for a restore or a
        lineage re-derivation of one arg — holds ZERO pins, so its
        other args stay spillable and producers can always write their
        returns.  The old single-phase materialize pinned args as it
        went: under storage faults, a store full of parked consumers'
        pins deadlocked the very re-derivations they waited on."""
        if not isinstance(a, ArgRef):
            return
        ref = ObjectRef(ObjectID(a.id_bytes), a.owner)
        b = ref.binary()
        st = self.objects.get(b)
        if st is not None:  # owned object
            await st.ready.wait()
            if st.error is not None or st.where == _INLINE:
                return
            if self.store.contains(b):
                return
            if st.node_id is not None and st.node_id != self.node_id:
                try:
                    await self.noded.call(
                        "pull_object", {"id": b, "node_id": st.node_id}
                    )
                    return
                except (rpc.RemoteError, rpc.RpcError) as e:
                    logger.debug("prefetch pull of %s failed: %s",
                                 ref.hex()[:12], e)
            reply = await self.noded.call("restore_object", {"id": b})
            if not (reply and reply.get("ok")):
                # lost: re-derive now (no value read) so phase 2 finds
                # it resident
                await self._reconstruct_object(ref)
            return
        # borrowed: ask the owner (whose verify path restores or
        # re-derives before handing out a location), then localize
        if self.store.contains(b):
            return
        if ref.owner is None:
            return  # phase 2 raises the typed error
        for attempt in range(4):
            reply = self._primed_replies.pop(b, None)
            if reply is None:
                reply = await self.noded.call("route", {
                    "target": tuple(ref.owner),
                    "method": "get_object_value",
                    "payload": {"id": b},
                    "want_reply": True,
                })
            kind = reply[0]
            if kind in ("inline", "error"):
                # stash for phase 2 (no bytes in the store to localize)
                self._primed_replies[b] = reply
                return
            if kind != "shm":
                return
            node_id = reply[1]
            if node_id != self.node_id:
                try:
                    await self.noded.call(
                        "pull_object", {"id": b, "node_id": node_id}
                    )
                except (rpc.RemoteError, rpc.RpcError) as e:
                    logger.debug("prefetch pull of borrowed %s: %s",
                                 ref.hex()[:12], e)
            if self.store.contains(b):
                return
            r2 = await self.noded.call("restore_object", {"id": b})
            if r2 and r2.get("ok") and self.store.contains(b):
                return
            await asyncio.sleep(
                backoff_delay_s(attempt, base_s=0.05, cap_s=0.5,
                                rng=self._retry_rng)
            )
        return  # phase 2's own retry loop takes it from here

    async def _materialize_arg(self, a):
        if isinstance(a, tuple) and len(a) == 2 and a[0] == "__rt_inline__":
            try:
                tag, val = ser.deserialize(memoryview(a[1]))
            except ModuleNotFoundError:
                if not await self._adopt_driver_sys_path():
                    raise
                tag, val = ser.deserialize(memoryview(a[1]))
            return _unwrap(tag, val)
        if isinstance(a, ArgRef):
            ref = ObjectRef(ObjectID(a.id_bytes), a.owner)
            return await self._get_one(ref)
        return a

    async def _exec_task(self, spec: TaskSpec, conn):
        t0 = time.time()
        tid = spec.task_id.binary()
        cancelled = getattr(self, "_cancelled_tasks", None)
        if cancelled and tid in cancelled:
            cancelled.discard(tid)
            envelope = ser.serialize_to_bytes(
                exc.TaskCancelledError(task_id=spec.task_id),
                tag=ser.TAG_ERROR,
            )
            conn.send("task_result", {
                "result": TaskResult(task_id=spec.task_id, status="error",
                                     error=envelope),
                "owner": spec.owner,
            })
            return
        if spec.deadline_expired():
            # the caller's budget is spent (the wire re-anchored the
            # remaining budget to this clock): reply the typed error
            # without running work nobody is waiting for
            envelope = ser.serialize_to_bytes(
                exc.DeadlineExceededError(
                    f"task {spec.name!r} deadline expired before execution"
                ),
                tag=ser.TAG_ERROR,
            )
            conn.send("task_result", {
                "result": TaskResult(task_id=spec.task_id, status="error",
                                     error=envelope),
                "owner": spec.owner,
            })
            return
        started = getattr(self, "_started_tasks", None)
        if started is None:
            started = self._started_tasks = set()
        started.add(tid)
        # (discarded in the finally below — the set only guards the
        # not-yet-started window against late cancellation)
        self.task_events.record(
            spec.task_id.binary(), spec.name, "RUNNING",
            node_id=self.node_id, worker_id=self.worker_id.hex(),
        )
        try:
            if spec.runtime_env:
                # applied once; the daemon dedicates this worker to the
                # env hash so a mismatch means a scheduling bug
                if self._applied_env_hash is None:
                    from ray_tpu_torch.core.runtime_env import apply_runtime_env

                    await apply_runtime_env(spec.runtime_env, self)
                    self._applied_env_hash = spec.env_hash
                elif self._applied_env_hash != spec.env_hash:
                    raise exc.RayTpuError(
                        "worker already dedicated to a different "
                        "runtime_env (scheduling bug)"
                    )
            fn = await self._load_function(spec)

            async def _materialize_all():
                # Two-phase, all-or-nothing materialization.  Phase 1
                # localizes every arg WITHOUT pinning; phase 2 pins the
                # whole set atomically — a round that finds any arg
                # missing releases every pin it took and goes back to
                # phase 1.  A task waiting on a restore or a lineage
                # re-derivation therefore holds ZERO pins: its sibling
                # args stay spillable and producers can always write.
                # (Pinning as-you-go deadlocked under storage faults:
                # parked consumers' pins filled the store against the
                # very re-derivations they waited on.)
                kw_items = [(k, v) for k, v in spec.kwargs.items()
                            if not k.startswith("__rt_")]
                entries = list(spec.args) + [v for _, v in kw_items]
                vals = None
                for round_ in range(6):
                    for a in entries:
                        await self._prefetch_arg(a)
                    vals = self._try_pin_args(entries)
                    if vals is not None:
                        break
                    await asyncio.sleep(
                        backoff_delay_s(round_, base_s=0.02, cap_s=0.2,
                                        rng=self._retry_rng)
                    )
                if vals is None:
                    # liveness fallback: the store is churning faster
                    # than a fast pass can pin — take the original
                    # blocking path (pins as it goes)
                    vals = [await self._materialize_arg(a)
                            for a in entries]
                else:
                    # non-pinned entries (inline blobs, plain values,
                    # primed replies) resolve through the normal path —
                    # none of these can stall on the store
                    for i, v in enumerate(vals):
                        if v is _UNRESOLVED:
                            vals[i] = await self._materialize_arg(
                                entries[i]
                            )
                args = vals[: len(spec.args)]
                kwargs = {
                    k: v for (k, _), v in zip(kw_items,
                                              vals[len(spec.args):])
                }
                return args, kwargs

            # blocked-aware: arg resolution stalled on an object that
            # must be restored/re-derived first releases this worker's
            # lease CPUs (same protocol as a parked in-task get) —
            # otherwise every slot can fill with tasks waiting on
            # objects only QUEUED tasks can produce, and lineage
            # reconstruction deadlocks against its own consumers
            args, kwargs = await self._await_blocking_aware(
                _materialize_all()
            )
            loop = asyncio.get_running_loop()
            self._task_local.task_id = spec.task_id
            # ambient deadline: nested .remote() calls made by the user
            # code inherit the parent's remaining budget.  Overwrite by
            # design — every task sets it at start (even to None), so a
            # reset token would only restore a NEIGHBOR's budget.
            _ambient_deadline.set(spec.deadline_s)  # rtlint: disable=RT006

            from ray_tpu_torch.util import tracing as _tracing

            trace_ctx = getattr(spec, "trace_ctx", None)
            if spec.actor_id is not None:
                mname = spec.kwargs["__rt_method__"]
                if mname == "__rt_dag_exec_loop__":
                    # framework-reserved: resident exec loop of a
                    # compiled DAG (dag/execution.py) hosted by this
                    # actor — not a method of the user class
                    import functools

                    from ray_tpu_torch.dag.execution import dag_exec_loop

                    method = functools.partial(
                        dag_exec_loop, self.actor_instance
                    )
                else:
                    method = getattr(self.actor_instance, mname)
                if asyncio.iscoroutinefunction(method):
                    from ray_tpu_torch.core.log_stream import log_ctx_var

                    _log_tok = log_ctx_var.set((spec.owner, spec.name))
                    try:
                        with _tracing.execution_span(spec.name, trace_ctx):
                            value = await method(*args, **kwargs)
                    finally:
                        try:
                            sys.stdout.flush()
                            sys.stderr.flush()
                        except (OSError, ValueError):
                            pass  # stream closed mid-teardown
                        log_ctx_var.reset(_log_tok)
                else:

                    def _call_method():
                        from ray_tpu_torch.core.log_stream import log_ctx_var

                        self._task_local.task_id = spec.task_id
                        # overwrite-by-design: see the async path above
                        _ambient_deadline.set(spec.deadline_s)  # rtlint: disable=RT006
                        _log_tok = log_ctx_var.set((spec.owner, spec.name))
                        try:
                            with _tracing.execution_span(spec.name, trace_ctx):
                                return method(*args, **kwargs)
                        finally:
                            # flush BEFORE clearing: a partial line left
                            # in the tee's thread buffer would otherwise
                            # prepend itself to the NEXT task's output
                            try:
                                sys.stdout.flush()
                                sys.stderr.flush()
                            except (OSError, ValueError):
                                pass  # stream closed mid-teardown
                            log_ctx_var.reset(_log_tok)

                    # sync methods of a named group run on that group's
                    # dedicated pool: a flooded default lane can never
                    # hold a group lane's threads
                    _pool = getattr(self, "_group_pools", {}).get(
                        spec.kwargs.get("__rt_group__"), self._exec_pool
                    )
                    value = await loop.run_in_executor(_pool, _call_method)
            else:

                def _call():
                    from ray_tpu_torch.core.log_stream import log_ctx_var

                    self._task_local.task_id = spec.task_id
                    # overwrite-by-design: see the async path above
                    _ambient_deadline.set(spec.deadline_s)  # rtlint: disable=RT006
                    _log_tok = log_ctx_var.set((spec.owner, spec.name))
                    # registered for mid-execution cancellation
                    # (_h_cancel_task async-raises into this thread);
                    # register/pop under _state_lock so a cancel can
                    # never target a recycled pool thread running a
                    # different task
                    with self._state_lock:
                        self._task_threads[tid] = threading.get_ident()
                    committed = False
                    value = None
                    try:
                        try:
                            with _tracing.execution_span(spec.name, trace_ctx):
                                value = fn(*args, **kwargs)
                                committed = True
                            return value
                        finally:
                            # partial printed lines ship before the
                            # context clears
                            try:
                                sys.stdout.flush()
                                sys.stderr.flush()
                            except (OSError, ValueError):
                                pass  # stream closed mid-teardown
                            log_ctx_var.reset(_log_tok)
                            # after this pop no NEW cancel can be
                            # delivered (raise and pop share the lock)
                            with self._state_lock:
                                self._task_threads.pop(tid, None)
                    except exc.TaskCancelledError:
                        # async-raised cancels land at an arbitrary later
                        # bytecode boundary: one delivered anywhere after
                        # fn() completed (span exit, the pop above) must
                        # not turn the finished task into a cancellation.
                        # A residual window remains between fn returning
                        # and `committed = True` — the raise cannot be
                        # made atomic with the call's last bytecode.
                        with self._state_lock:
                            # the cancel may have aborted the finally
                            # BETWEEN lock acquire and pop: re-pop so no
                            # stale tid->ident mapping survives
                            self._task_threads.pop(tid, None)
                        if committed:
                            return value
                        raise

                value = await loop.run_in_executor(self._exec_pool, _call)
            # the function has returned: drop the executor's own
            # references to the (possibly shm-pinned) args BEFORE
            # packaging the returns.  Packaging may have to wait for
            # store space, and an input pin held across that wait is
            # space the spiller can never free — with several producers
            # packaging at once, inputs-pinned-against-outputs
            # deadlocked the store under storage-fault rework storms.
            # (Args whose values the RESULT still references stay alive
            # through the result, exactly as they should.)
            del args, kwargs
            if spec.is_streaming:
                try:
                    n_items = await self._stream_out(spec, value, conn)
                finally:
                    # cancel marks are per-execution: never leak into a
                    # retry of the same task id
                    getattr(self, "_cancelled_streams", set()).discard(tid)
                result = TaskResult(
                    task_id=spec.task_id,
                    status="ok",
                    returns=[],
                    execution_info={"duration": time.time() - t0,
                                    "num_items": n_items},
                )
            else:
                returns = await self._package_returns(spec, value)
                result = TaskResult(
                    task_id=spec.task_id,
                    status="ok",
                    returns=returns,
                    execution_info={"duration": time.time() - t0},
                )
        except Exception as e:  # noqa: BLE001 - user exception boundary
            tb = traceback.format_exc()
            if isinstance(e, exc.TaskCancelledError):
                # preserve the type: callers match on TaskCancelledError
                # (the async-raised mid-execution interrupt lands here)
                err: Exception = exc.TaskCancelledError(task_id=spec.task_id)
            else:
                err = exc.TaskError(
                    str(e), remote_traceback=tb, cause_type=type(e).__name__
                )
            envelope = ser.serialize_to_bytes(err, tag=ser.TAG_ERROR)
            result = TaskResult(task_id=spec.task_id, status="error", error=envelope)
        self._started_tasks.discard(tid)
        # any borrows this task registered while deserializing its args
        # must be ACKed by their owners before the result releases the
        # caller's transit pins (the forwarded-ref ordering guarantee)
        await self._await_borrow_acks()
        # coalesced reply: results for this owner produced within the
        # same loop tick ship as ONE task_result_batch frame (the
        # coalescer handles the origin-gone fallback via the daemon)
        self._result_coalescer.enqueue(conn, spec.owner, result)

    async def _await_borrow_acks(self, timeout: float = 10.0):
        # SNAPSHOT, don't drain: with concurrent tasks in one worker
        # (async actors, max_concurrency>1) a swap would let task A
        # steal task B's outstanding ack, so B's result could outrun
        # B's borrow registration.  Completed futures are pruned after.
        with self._state_lock:
            acks = list(self._pending_borrow_acks)
        for f in acks:
            try:
                await asyncio.wait_for(asyncio.wrap_future(f), timeout)
            except Exception as e:
                # owner unreachable: proceed — the caller-side pin falls
                # back to the (pre-existing) unprotected window
                logger.debug("borrow ACK not confirmed: %s", e)
        with self._state_lock:
            self._pending_borrow_acks = [
                f for f in self._pending_borrow_acks if not f.done()
            ]

    async def _stream_out(self, spec: TaskSpec, value, conn) -> int:
        """Drive a streaming-generator task's iteration: each yielded
        item is packaged like a return value and pushed to the owner as
        a `stream_item` ahead of the final task_result (reference:
        streaming generators, `task_manager.h:208`).  A non-generator
        return value becomes a single-item stream."""
        import inspect

        from ray_tpu_torch.util import tracing as _tracing

        loop = asyncio.get_running_loop()
        _END = object()
        index = 0
        tid = spec.task_id.binary()
        # the execution_span that wrapped generator CREATION has already
        # exited by the time the body runs here — re-install the task's
        # trace context around iteration so spans opened inside the
        # generator (engine ticks, nested submits) join the request's
        # trace instead of fragmenting.  A stream span wraps the whole
        # drive; its context is what generator frames see.
        trace_ctx = getattr(spec, "trace_ctx", None)
        stream_span = None
        stream_ctx = None
        if trace_ctx is not None:
            with _tracing.use_context(trace_ctx):
                stream_span = _tracing.start_span(f"stream:{spec.name}",
                                                  kind="CONSUMER")
            stream_ctx = _tracing.ctx_of(stream_span)

        def _abandoned() -> bool:
            cancelled = getattr(self, "_cancelled_streams", None)
            if cancelled and tid in cancelled:
                cancelled.discard(tid)
                return True
            return False

        async def _send(item):
            nonlocal index
            index += 1
            oid = ObjectID.for_return(spec.task_id, index)
            ret = await self._package_value(oid, item)
            payload = {"task_id": spec.task_id, "index": index, "item": ret,
                       "owner": spec.owner}
            try:
                conn.send("stream_item", payload)
            except Exception as e:
                # origin conn gone: route via the node daemon
                logger.debug("direct stream_item failed (%s); routing "
                             "via noded", e)
                self.noded.send("task_stream", payload)

        try:
            if inspect.isasyncgen(value):
                with _tracing.use_context(stream_ctx):
                    async for item in value:
                        await _send(item)
                        if _abandoned():
                            # user generator's finally runs
                            await value.aclose()
                            break
            elif inspect.isgenerator(value):

                def _next():
                    # run_in_executor does not propagate contextvars:
                    # re-install the stream context on the pool thread
                    # so the generator body's spans/submits stay in the
                    # request's trace
                    with _tracing.use_context(stream_ctx):
                        try:
                            return next(value)
                        except StopIteration:
                            return _END

                # a grouped streaming method iterates on its group's pool
                # (same isolation rule as _exec_task's sync-method path)
                _pool = getattr(self, "_group_pools", {}).get(
                    spec.kwargs.get("__rt_group__"), self._exec_pool
                )
                while True:
                    item = await loop.run_in_executor(_pool, _next)
                    if item is _END:
                        break
                    await _send(item)
                    if _abandoned():
                        await loop.run_in_executor(_pool, value.close)
                        break
            else:
                await _send(value)
        except BaseException as e:
            _tracing.finish_span(stream_span, error=type(e).__name__)
            raise
        _tracing.finish_span(stream_span)
        return index

    async def _create_with_backpressure(self, id_bytes: bytes, total: int,
                                        timeout_s: float = 60.0):
        """Blocking-create semantics (reference: plasma's
        create_request_queue.h — creates wait under memory pressure
        instead of failing): on a full store, ask the node daemon to
        spill urgently and retry until the deadline.

        Returns None when a SEALED copy already exists: a prior attempt
        of this task (a retry after a mid-packaging failure, or a
        lineage resubmit racing a concurrent restore) already produced
        this return — task bodies on this plane are deterministic, so
        the existing bytes ARE this attempt's value and the caller
        skips the write.  An UNSEALED collision is a dead attempt's
        partial write: delete it and recreate."""
        from ray_tpu_torch.shm import ObjectExistsError, StoreFullError

        deadline = time.time() + timeout_s
        attempts = 0
        disk_full_streak = 0
        while True:
            try:
                # no destructive eviction: pressure resolves by spilling
                # (primaries survive on disk) rather than data loss
                return self.store.create(id_bytes, total, allow_evict=False)
            except ObjectExistsError:
                if self.store.contains(id_bytes):  # sealed: reuse
                    return None
                self.store.delete(id_bytes)
                if time.time() > deadline:
                    raise
                # the collision may be an unsealed entry pinned by a
                # live writer (e.g. a concurrent restore): yield the
                # loop instead of spinning hot until it seals or dies
                await asyncio.sleep(0.05)  # rtlint: disable=RT006 - local store-state poll, not a networked retry storm
            except StoreFullError:
                if time.time() > deadline:
                    raise
                reply = None
                try:
                    # escalate: watermark-target spills first; if the
                    # create is still blocked after a few passes (free
                    # bytes too fragmented for a contiguous region),
                    # drain every unpinned object
                    reply = await self.noded.call(
                        "spill_now", {"drain": attempts >= 2}, timeout=10
                    )
                except Exception as e:
                    logger.debug("spill_now nudge failed: %s", e)
                disk_full_streak = _spill_clamp_streak(
                    reply, disk_full_streak
                )
                attempts += 1
                await asyncio.sleep(0.05)

    async def _package_returns(self, spec: TaskSpec, value) -> List[Tuple]:
        import inspect as _inspect

        if _inspect.isgenerator(value) or _inspect.isasyncgen(value):
            raise TypeError(
                f"task {spec.name!r} returned a generator but was not "
                "submitted as streaming — call it with "
                "num_returns=\"streaming\" (generator functions and "
                "public generator actor methods stream automatically)"
            )
        if spec.num_returns == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task declared num_returns={spec.num_returns} but returned "
                    f"{len(values)} values"
                )
        out = []
        for i, v in enumerate(values):
            oid = ObjectID.for_return(spec.task_id, i + 1)
            out.append(await self._package_value(oid, v))
        return out

    async def _package_value(self, oid: ObjectID, v) -> Tuple:
        """Serialize one return value: inline bytes when small, sealed
        into the local shm store when large.  Refs captured inside the
        value ride along as `(id, owner)` pairs so the receiving owner
        can register borrows keyed to the container — that converts this
        executor's transient contained-pin and lets the pins release
        when the container is freed instead of at job exit (closing the
        leak the round-1 design documented; reference:
        `reference_count.h:64` contained-refs edges).  Foreign-owned
        refs forwarded in the value additionally get transit pins (see
        `_pin_transit`) keyed to the task, released when the result's
        owner confirms it registered the contained borrows
        (`transit_release`)."""
        chunks, total, captured = ser.serialize(v)
        self._pin_contained(captured)
        ret_transit: list = []
        self._pin_transit(captured, ret_transit)
        if ret_transit:
            tid = oid.task_id().binary()
            self._return_transit.setdefault(tid, []).extend(ret_transit)
        contained = [
            (r.binary(), tuple(r.owner))
            for r in captured
            if r.owner is not None
        ]
        if total <= self.cfg.max_direct_call_object_size:
            buf = bytearray(total)
            ser.write_chunks(chunks, memoryview(buf))
            return (_INLINE, bytes(buf), contained)
        dest = await self._create_with_backpressure(oid.binary(), total)
        if dest is not None:  # None: a prior attempt's sealed copy stands
            ser.write_chunks(chunks, dest)
            del dest
            self.store.seal(oid.binary())
        return (_SHM, self.node_id, total, contained)

    async def _kv_get_exported(self, function_id: bytes) -> bytes:
        """The blob a driver exported for `function_id`, polled with a
        short backoff for up to `_FUNCTION_EXPORT_WAIT_S`: the export is
        a one-way put (`_export_function`), which a task carrying only
        the id can overtake."""
        key = "fn:" + function_id.hex()
        deadline = time.monotonic() + _FUNCTION_EXPORT_WAIT_S
        delay = 0.005
        while True:
            blob = await self.controller.call("kv_get", {"key": key})
            if blob is not None:
                return blob
            if time.monotonic() >= deadline:
                raise exc.RayTpuError(
                    f"function {function_id.hex()} not found"
                )
            await asyncio.sleep(delay)
            delay = min(2 * delay, 0.1)

    async def _load_function(self, spec: TaskSpec):
        if spec.actor_id is not None:
            return None
        fn = self._fn_cache.get(spec.function_id)
        if fn is None:
            blob = spec.function_blob
            if blob is None:
                blob = await self._kv_get_exported(spec.function_id)
            try:
                fn = ser.loads(blob)
            except ModuleNotFoundError:
                if not await self._adopt_driver_sys_path():
                    raise
                fn = ser.loads(blob)
            self._fn_cache[spec.function_id] = fn
        return fn


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming-generator task
    (`num_returns="streaming"`).  Reference: `ObjectRefGenerator` in
    `_raylet.pyx` — each `next()` blocks until the executor yields the
    next item and returns that item's ObjectRef; a mid-stream exception
    in the generator body raises at the position it occurred.
    """

    def __init__(self, task_id_bytes: bytes, runtime: "Runtime"):
        self._tid = task_id_bytes
        self._rt = runtime

    @property
    def task_id(self) -> bytes:
        return self._tid

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        ref = self._rt.stream_next(self._tid)
        if ref is None:
            raise StopIteration
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        loop = asyncio.get_running_loop()
        if loop is self._rt.loop:
            # on the runtime's io loop (async actors, serve proxy):
            # await natively — no thread blocked per waiting stream
            ref = await self._rt._stream_next_async(self._tid)
        else:
            ref = await loop.run_in_executor(
                None, self._rt.stream_next, self._tid
            )
        if ref is None:
            raise StopAsyncIteration
        return ref

    def __del__(self):
        # abandoned before exhaustion: drop the owner-side stream state
        # (exhausted streams already popped it — this is a no-op then)
        try:
            self._rt.stream_release(self._tid)
        except Exception:  # rtlint: disable=RT005
            # __del__ during interpreter teardown: logging itself may
            # already be torn down
            pass

    def __repr__(self):
        return f"ObjectRefGenerator({self._tid.hex()})"


# ----------------------------------------------------------------------
# module-level runtime + hooks used by ObjectRef
# ----------------------------------------------------------------------
_runtime: Optional[Runtime] = None


def _strategy_from_options(options):
    from ray_tpu_torch.util.scheduling_strategies import pg_id_bytes, to_internal

    s = options.get("scheduling_strategy")
    if s is None:
        pg = options.get("placement_group")
        if pg is not None:
            return SchedulingStrategy(
                kind="placement_group",
                pg_id=pg_id_bytes(pg),
                pg_bundle_index=options.get("placement_group_bundle_index", -1),
            )
        return SchedulingStrategy()
    return to_internal(s)


def get_runtime() -> Runtime:
    if _runtime is None:
        raise exc.RayTpuError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() first"
        )
    return _runtime


def set_runtime(rt: Optional[Runtime]):
    global _runtime
    _runtime = rt


def is_initialized() -> bool:
    return _runtime is not None


def on_ref_deserialized(ref: ObjectRef):
    rt = _runtime
    if rt is None or rt._shutdown:
        return
    with rt._state_lock:
        rc = rt.refs.setdefault(ref.binary(), _RefCount())
        rc.local += 1
        if _RECORD_CALLSITES and not rc.callsite:
            rc.callsite = _creation_site()
        if ref.owner is not None and tuple(ref.owner) == rt.address:
            rc.contained = 0  # owner consumed its own container: pin -> local
        # `registered` (not a local==1 heuristic) drives exactly one
        # add/remove pair per entry lifetime: transit pins can hold the
        # entry across local 1->0->1 cycles, where re-counting would
        # double-register at the owner
        is_new_borrow = (
            not rc.registered
            and ref.binary() not in rt.objects
            and ref.owner is not None
            and tuple(ref.owner) != rt.address
        )
        if is_new_borrow:
            rc.registered = True
            rc.owner_addr = tuple(ref.owner)
    if is_new_borrow and rt.noded is not None:
        payload = {
            "target": tuple(ref.owner),
            "method": "add_borrow",
            "payload": {"id": ref.binary(), "borrower": rt.address},
        }
        if rt.mode == "worker":
            # workers forward refs onward in their RESULTS: the owner
            # must have this registration on the books before our task
            # result lets the caller drop ITS protection, so ride a
            # want_reply call whose ack the executor awaits before
            # sending any task result
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    rt.noded.call("route", {**payload, "want_reply": True}),
                    rt.loop,
                )
                with rt._state_lock:
                    # under the lock: _await_borrow_acks rebuilds this
                    # list during its prune, and a bare append could be
                    # lost to that assignment
                    rt._pending_borrow_acks.append(fut)
            except Exception as e:
                logger.debug("borrow ACK registration failed: %s", e)
        else:
            # drivers don't forward refs in results: the registration
            # needs no ACK, so it rides the coalesced channel (a 10k-ref
            # get registers in ~10 frames, not 10k)
            rt._queue_ref_event(
                tuple(ref.owner), "add_borrow",
                {"id": ref.binary(), "borrower": rt.address},
            )


def on_ref_deleted(ref: ObjectRef):
    rt = _runtime
    if rt is None or rt._shutdown:
        return
    with rt._state_lock:
        rc = rt.refs.get(ref.binary())
        if rc is None:
            return
        rc.local -= 1
        if rc.owner_addr is None and ref.owner is not None:
            rc.owner_addr = tuple(ref.owner)
        # _maybe_free sends the final remove_borrow when the entry dies
        rt._maybe_free(ref.binary())


async def async_get(ref: ObjectRef):
    return await get_runtime()._get_one(ref)


def as_future(ref: ObjectRef):
    rt = get_runtime()
    return asyncio.run_coroutine_threadsafe(rt._get_one(ref), rt.loop)


def _unwrap(tag: int, value):
    if tag == ser.TAG_ERROR:
        raise value
    return value


def _view_root(a):
    """The array that every view derived from `a` references: numpy sets
    a new view's base to the last array of `a`'s base chain (here the one
    over the deserialized buffer), not to `a`, so only that root's
    lifetime covers them all."""
    import numpy as _np

    while isinstance(a.base, _np.ndarray):
        a = a.base
    return a


def _spill_clamp_streak(reply, streak: int) -> int:
    """Shared disk-full admission clamp for the blocked-create loops
    (driver put and worker return packaging).  Counts CONSECUTIVE
    spill_now replies that reported a full spill disk with nothing
    spilled — one such reply can be a transient ENOSPC burst — and at
    three in a row raises typed `BackPressureError` (the PR 10/11
    admission-clamp convention): the store is full AND the disk keeps
    refusing bytes, so no amount of waiting unblocks the create."""
    if reply and reply.get("disk_full") and not reply.get("spilled"):
        streak += 1
    else:
        streak = 0
    if streak >= 3:
        raise exc.BackPressureError(
            "object store is full and the spill disk is out of "
            "space; shed load or free disk",
            retry_after_s=5.0,
        )
    return streak


def _error_from_envelope(envelope: bytes) -> BaseException:
    tag, err = ser.deserialize(memoryview(envelope))
    if isinstance(err, BaseException):
        return err
    return exc.RayTpuError(str(err))
