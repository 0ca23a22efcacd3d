"""WorkerGroup: a gang of training worker actors.

Reference: `train/_internal/worker_group.py:102` — N actors created with
per-worker resources, placed by a placement group, with `execute` /
`execute_async` / `execute_single` RPC helpers.  The TrainWorker actor
additionally hosts the training session thread (reference
`_internal/session.py` `_StartTraining` + result queue).

Elastic extensions (ROADMAP item 4):

- **widest-fit reserve**: with ``min_workers`` set, the placement-group
  reservation walks num_workers → min_workers and takes the widest
  width the cluster can place within a bounded wait — a preempted host
  shrinks the gang instead of failing it.
- **health monitor**: the group subscribes to the runtime's health
  plane — the controller's ``actor_state``/``node_dead`` pubsub
  channels and `core/rpc.py`'s circuit-breaker transition hook — so a
  lost rank is reported within a bounded window instead of being
  discovered via a hung ``execute``.
- **hardened finish/shutdown**: ``request_stop`` is propagated to ALL
  ranks before any join, every join is bounded, and the first worker
  exception is surfaced instead of a generic timeout.
"""

from __future__ import annotations

import logging
import os
import queue as _queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch as rt
from ray_tpu_torch.core import rpc
from ray_tpu_torch.train import session as _session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _Session, _TrainingResult
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)

logger = logging.getLogger(__name__)


def _put_final(sess: _Session, res: _TrainingResult) -> None:
    """Deliver the session thread's TERMINAL result.  On the normal
    path (including a graceful stop) this is a plain blocking put —
    the executor is still consuming in lockstep.  When the session is
    ABANDONED there is no consumer: stale entries are dropped so the
    final done/error result can never deadlock against a full queue."""
    if not sess.abandoned.is_set():
        sess.result_queue.put(res)
        return
    while True:
        try:
            sess.result_queue.put_nowait(res)
            return
        except _queue.Full:
            try:
                sess.result_queue.get_nowait()
            except _queue.Empty:
                logger.debug("final-result queue race; retrying put")


class TrainWorker:
    """Actor hosting one training session."""

    def __init__(self, env_vars: Optional[Dict[str, str]] = None):
        for k, v in (env_vars or {}).items():
            os.environ[k] = v
        self._session: Optional[_Session] = None
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[str] = None

    # -- generic RPC ---------------------------------------------------
    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def set_env(self, env_vars: Dict[str, str]):
        os.environ.update(env_vars)

    def node_info(self):
        return {"pid": os.getpid(), "hostname": os.uname().nodename}

    # -- training session ----------------------------------------------
    def start_training(
        self,
        train_fn: Callable,
        config: Optional[Dict[str, Any]],
        context: TrainContext,
        checkpoint: Optional[Checkpoint],
        datasets: Optional[Dict[str, Any]] = None,
    ):
        assert self._thread is None or not self._thread.is_alive(), (
            "training already running"
        )
        sess = _Session(context, checkpoint, datasets)
        self._session = sess
        self._last_error = None

        import inspect

        try:
            takes_config = len(inspect.signature(train_fn).parameters) >= 1
        except (TypeError, ValueError):
            takes_config = True

        def _run():
            _session_mod._set_session(sess)
            try:
                if takes_config:
                    train_fn(config if config is not None else {})
                else:
                    train_fn()
                _put_final(sess, _TrainingResult(done=True))
            except StopIteration:
                _put_final(sess, _TrainingResult(done=True))
            except BaseException as e:  # noqa: BLE001 - forwarded to driver
                e._rt_traceback = traceback.format_exc()  # type: ignore[attr-defined]
                self._last_error = f"{type(e).__name__}: {e}"
                _put_final(sess, _TrainingResult(done=True, error=e))
            finally:
                _session_mod._set_session(None)

        self._thread = threading.Thread(target=_run, daemon=True, name="train_loop")
        self._thread.start()
        return True

    def get_next_result(self) -> _TrainingResult:
        assert self._session is not None, "no training session"
        return self._session.result_queue.get()

    def request_stop(self, drain: bool = False):
        """Graceful (default): the loop unwinds at its next report()
        AFTER delivering that round — the executor keeps consuming, so
        rounds stay complete and committed checkpoints stay whole.

        ``drain=True`` additionally marks the session ABANDONED (the
        executor stopped consuming: elastic drain, teardown) and
        unblocks a session thread parked in report()'s backpressure
        put by discarding the stale per-step result.  A TERMINAL
        result (done/error) is re-queued, never swallowed — a loop
        that finished naturally just as the stop landed has nothing
        further to put, and discarding its done would hang the
        driver's next get_next_result forever."""
        sess = self._session
        if sess is None:
            return
        sess.stop_requested.set()
        if not drain:
            return
        sess.abandoned.set()
        try:
            item = sess.result_queue.get_nowait()
        except _queue.Empty:
            return
        if item.done or item.error is not None:
            try:
                sess.result_queue.put_nowait(item)
            except _queue.Full:
                # only possible if a newer terminal result landed in
                # the gap; equivalent signal, drop this one
                logger.debug("terminal result superseded during "
                             "request_stop")

    def finish(self, timeout: float = 10.0) -> Dict[str, Any]:
        """Bounded join of the session thread.  Returns
        ``{"clean": bool, "error": str|None}`` so the driver can
        surface the loop's actual exception instead of a generic
        timeout."""
        clean = True
        if self._thread is not None:
            self._thread.join(timeout)
            clean = not self._thread.is_alive()
        return {"clean": clean, "error": self._last_error}


@dataclass
class WorkerMetadata:
    rank: int
    node_id: Optional[str]
    pid: int


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
        placement_strategy: str = "PACK",
        env_vars: Optional[Dict[str, str]] = None,
        min_workers: Optional[int] = None,
        reserve_timeout_s: float = 60.0,
        fallback_timeout_s: float = 10.0,
    ):
        res = dict(resources_per_worker or {"CPU": 1.0})
        self._pg, width = self._reserve(
            num_workers, min_workers, res, placement_strategy,
            reserve_timeout_s, fallback_timeout_s,
        )
        self.num_workers = width
        self.requested_workers = num_workers
        opts = dict(
            num_cpus=res.pop("CPU", 0.0),
            num_gpus=res.pop("GPU", 0.0),
            resources=res or None,
            max_concurrency=2,  # get_next_result blocks while the loop runs
        )
        cls = rt.remote(TrainWorker)
        self.workers: List[rt.ActorHandle] = []
        try:
            for i in range(width):
                self.workers.append(self._create_worker(
                    cls, opts, i, env_vars
                ))
        except BaseException:
            # a half-built gang must release everything it holds: a
            # leaked CREATED placement group would permanently starve
            # every later (elastic re-form) reservation attempt
            for w in self.workers:
                try:
                    rt.kill(w)
                except Exception as e:
                    logger.debug("cleanup kill failed: %s", e)
            self.workers = []
            try:
                remove_placement_group(self._pg)
            except Exception as e:
                logger.debug("cleanup PG removal failed: %s", e)
            raise
        # -- health-monitor state (idle until start_monitor) ----------
        self._lost: Dict[int, str] = {}
        self._lost_lock = threading.Lock()
        self._on_lost: Optional[Callable[[int, str], None]] = None
        self._monitor_stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None

    def _create_worker(self, cls, opts: Dict[str, Any], bundle_index: int,
                       env_vars: Optional[Dict[str, str]]):
        """Create one rank's actor inside its reserved bundle.
        Transient placement refusals ("resources no longer available",
        "no idle worker") are expected right after a previous gang's
        teardown — the daemon refunds a killed worker's resources
        asynchronously — and the bundle GUARANTEES the capacity
        exists, so they are retried with jittered backoff instead of
        failing the (re-)form."""
        from ray_tpu_torch.core.retry import backoff_delay_s

        attempt = 0
        while True:
            try:
                return cls.options(
                    **opts,
                    placement_group=self._pg,
                    placement_group_bundle_index=bundle_index,
                ).remote(env_vars)
            except rt.exceptions.RayTpuError as e:
                transient = ("resources no longer available" in str(e)
                             or "no idle worker" in str(e))
                if not transient or attempt >= 6:
                    raise
                delay = backoff_delay_s(attempt, base_s=0.2, cap_s=2.0)
                logger.debug(
                    "worker %d creation rejected (%s); retrying in "
                    "%.2fs", bundle_index, e, delay,
                )
                time.sleep(delay)
                attempt += 1

    @staticmethod
    def _reserve(
        num_workers: int,
        min_workers: Optional[int],
        res: Dict[str, float],
        strategy: str,
        reserve_timeout_s: float,
        fallback_timeout_s: float,
    ) -> Tuple[PlacementGroup, int]:
        """Widest-fit gang reservation: try full width first (with the
        generous first-attempt timeout), then walk down to
        ``min_workers`` with the shorter fallback timeout per width.
        Every failed attempt removes its pending placement group so an
        unplaceable request cannot squat on capacity."""
        floor = num_workers if min_workers is None else max(1, min_workers)
        timeout = reserve_timeout_s
        for width in range(num_workers, floor - 1, -1):
            pg = placement_group(
                [dict(res) for _ in range(width)], strategy=strategy
            )
            if pg.ready(timeout=timeout):
                if width < num_workers:
                    logger.warning(
                        "worker group degraded: reserved %d/%d bundles of "
                        "%s", width, num_workers, res,
                    )
                return pg, width
            remove_placement_group(pg)
            timeout = fallback_timeout_s
        raise rt.exceptions.RayTpuError(
            f"could not reserve even {floor} x {res} worker bundles "
            f"(requested {num_workers})"
        )

    # ------------------------------------------------------------------
    # health monitor: bounded-window loss detection
    # ------------------------------------------------------------------
    def start_monitor(self, on_lost: Callable[[int, str], None]) -> None:
        """Report lost ranks via `on_lost(rank, cause)` (each rank at
        most once), fed by three independent signals:

        - controller ``actor_state`` pubsub: a worker actor marked
          DEAD/RESTARTING (missed actor heartbeat, worker SIGKILL);
        - controller ``node_dead`` pubsub: the host carrying a rank
          left the cluster (preemption) — the fastest signal;
        - `rpc.add_breaker_listener`: the rank's circuit breaker
          tripped OPEN (black-holed peer that never cleanly died).

        The callback runs on the monitor/notifier thread and must be
        fast and non-blocking."""
        if self._monitor_thread is not None and self._monitor_thread.is_alive():
            return
        self._on_lost = on_lost
        self._monitor_stop.clear()
        rpc.add_breaker_listener(self._breaker_event)
        self._monitor_thread = threading.Thread(
            target=self._monitor_main, daemon=True, name="train-wg-monitor"
        )
        self._monitor_thread.start()

    def stop_monitor(self, timeout_s: float = 5.0) -> None:
        rpc.remove_breaker_listener(self._breaker_event)
        self._monitor_stop.set()
        t = self._monitor_thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
        self._monitor_thread = None

    def lost_ranks(self) -> Dict[int, str]:
        with self._lost_lock:
            return dict(self._lost)

    def mark_lost(self, rank: int, cause: str) -> None:
        """Idempotent: the first signal for a rank wins; later signals
        (a breaker trip racing the DEAD publish) are no-ops."""
        with self._lost_lock:
            if rank in self._lost or rank >= len(self.workers):
                return
            self._lost[rank] = cause
        logger.warning("train worker rank %d lost: %s", rank, cause)
        cb = self._on_lost
        if cb is not None:
            try:
                cb(rank, cause)
            except Exception:
                logger.exception("on_lost callback failed for rank %d", rank)

    def _actor_rank_map(self) -> Dict[bytes, int]:
        return {
            w._actor_id.binary(): i for i, w in enumerate(self.workers)
        }

    def _worker_addresses(self) -> Dict[int, Tuple[str, str]]:
        """rank -> (node_id, worker_id), best-effort from the runtime's
        actor-address table (populated at actor creation)."""
        try:
            from ray_tpu_torch.core.runtime import get_runtime

            table = get_runtime()._actor_addr
        except Exception as e:
            logger.debug("actor address table unavailable: %s", e)
            return {}
        out: Dict[int, Tuple[str, str]] = {}
        for i, w in enumerate(self.workers):
            addr = table.get(w._actor_id.binary())
            if addr is not None:
                out[i] = tuple(addr)
        return out

    def _breaker_event(self, address: str, old: str, new: str) -> None:
        if new != rpc.CircuitBreaker.OPEN or not address.startswith("actor:"):
            return
        for rank, (node_id, worker_id) in self._worker_addresses().items():
            if address == f"actor:{node_id}:{worker_id}":
                self.mark_lost(rank, f"circuit breaker open ({address})")
                return

    def _monitor_main(self) -> None:
        from ray_tpu_torch.core.runtime import get_runtime

        subs = []
        try:
            for channel in ("actor_state", "node_dead"):
                subs.append((channel, get_runtime().subscribe(channel)))
        except Exception as e:
            # pubsub unavailable (runtime tearing down): breaker events
            # still flow through the listener hook
            logger.debug("worker-group health subscribe failed: %s", e)
        try:
            while not self._monitor_stop.is_set():
                if not subs:
                    self._monitor_stop.wait(0.2)
                    continue
                for channel, sub in subs:
                    try:
                        msg = sub.next_message(timeout=0.2)
                    except _queue.Empty:
                        continue
                    except Exception as e:
                        logger.debug("health subscription broke: %s", e)
                        self._monitor_stop.wait(0.2)
                        continue
                    self._handle_health_msg(channel, msg)
        finally:
            for _, sub in subs:
                try:
                    sub.close()
                except Exception as e:
                    logger.debug("closing health subscription: %s", e)

    def _handle_health_msg(self, channel: str, msg) -> None:
        if not isinstance(msg, dict):
            return
        if channel == "actor_state":
            state = msg.get("state")
            if state not in ("DEAD", "RESTARTING"):
                return
            rank = self._actor_rank_map().get(msg.get("actor_id"))
            if rank is not None:
                cause = msg.get("cause", "actor heartbeat missed")
                self.mark_lost(rank, f"actor {state}: {cause}")
        elif channel == "node_dead":
            node_id = msg.get("node_id")
            for rank, (nid, _wid) in self._worker_addresses().items():
                if nid == node_id:
                    self.mark_lost(
                        rank, f"node {str(node_id)[:8]} died: "
                        f"{msg.get('reason', '?')}"
                    )

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return rt.get(self.execute_async(fn, *args, **kwargs))

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return rt.get(self.workers[rank].execute.remote(fn, *args, **kwargs))

    def __len__(self):
        return self.num_workers

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def request_stop_all(self, drain: bool = False) -> None:
        """Fire-and-forget stop to every rank — the step barrier: each
        surviving loop unwinds at its next report().  ``drain=True``
        marks the sessions abandoned (no consumer remains); see
        TrainWorker.request_stop."""
        for i, w in enumerate(self.workers):
            try:
                w.request_stop.remote(drain)
            except Exception as e:
                logger.debug("request_stop to rank %d failed: %s", i, e)

    def finish(self, timeout_s: float = 30.0, raise_on_error: bool = True
               ) -> List[Dict[str, Any]]:
        """Stop and join every rank: `request_stop` is propagated to
        ALL ranks before any join, every join is bounded by the shared
        `timeout_s` deadline, and (with `raise_on_error`) the FIRST
        worker exception is raised instead of a generic timeout.
        Returns the per-rank ``{"clean", "error"}`` statuses."""
        if not self.workers:
            return []
        # finish abandons the sessions: nothing consumes results past
        # this point, so blocked reporters must be drained loose
        self.request_stop_all(drain=True)
        # one shared grace over the in-actor join, NOT per rank: total
        # wall time stays ~timeout_s regardless of group width (the
        # joins themselves run concurrently server-side; only the
        # result fetches are sequential, each bounded by what is left
        # of the shared deadline)
        deadline = time.monotonic() + timeout_s + 2.0
        join_s = max(0.5, timeout_s * 0.8)
        refs = []
        for w in self.workers:
            try:
                refs.append(w.finish.remote(join_s))
            except Exception as e:
                # not swallowed: carried into the rank's status below
                logger.debug("finish submit failed: %s", e)
                refs.append(e)
        statuses: List[Dict[str, Any]] = []
        first_error: Optional[Tuple[int, str]] = None
        for rank, ref in enumerate(refs):
            if isinstance(ref, Exception):
                st = {"clean": False,
                      "error": f"{type(ref).__name__}: {ref}"}
            else:
                remaining = max(0.1, deadline - time.monotonic())
                try:
                    st = rt.get(ref, timeout=remaining)
                except Exception as e:
                    # not swallowed: becomes the rank's reported error
                    logger.debug("finish join for rank %d: %s", rank, e)
                    st = {"clean": False,
                          "error": f"{type(e).__name__}: {e}"}
            statuses.append(st)
            if first_error is None and st.get("error"):
                first_error = (rank, st["error"])
        if raise_on_error and first_error is not None:
            raise rt.exceptions.RayTpuError(
                f"worker rank {first_error[0]} failed during finish: "
                f"{first_error[1]}"
            )
        return statuses

    def shutdown(self):
        self.stop_monitor()
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception as e:
                logger.debug("kill of train worker failed: %s", e)
        self.workers = []
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception as e:
                logger.debug("placement group removal failed: %s", e)
            self._pg = None
