"""DAG compilation and driver-side execution.

Reference: `python/ray/dag/compiled_dag_node.py` (CompiledDAG) and
`python/ray/experimental/compiled_dag_ref.py` (CompiledDAGRef).

Compilation walks the bound graph, groups nodes by actor, allocates a
channel per cross-actor edge, and launches one resident exec loop per
actor (execution.py).  execute() writes the input channels and returns a
CompiledDAGRef that reads the output channels — per-execution cost is
channel ops only.  Ring-buffered channels bound pipelined in-flight
executions the way the reference's buffered channels do.

Failure model: channels cannot observe a SIGKILLed peer, so the driver
watches the resident loop TASKS — when one fails (actor death, channel
wedge), the dead actor's outgoing channels are poisoned with the typed
error, which the surviving downstream loops propagate stage-to-stage
until it reaches every consumer and the driver's CompiledDAGRef.
"""

from __future__ import annotations

import itertools
import logging
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.dag import execution as ex
from ray_tpu_torch.dag.channel import Channel, ChannelClosed, ChannelPollTimeout
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
)

logger = logging.getLogger(__name__)

_exec_counter = itertools.count()

# slice width for blocking output reads: long waits are chopped so the
# driver notices a dead stage (loop-task failure) instead of blocking
# the full timeout against a ring nobody will ever write
_POLL_SLICE_S = 0.25


class _Expired(Exception):
    """Internal: the collect deadline passed with NOTHING consumed —
    distinct from a user TimeoutError payload read off the channel."""


def reap_failed_loop_tasks(loop_refs, reaped: set):
    """Poll resident-loop task refs (non-blocking) and return
    [(ref, error)] for loops that finished WITH a failure — the shared
    dead-stage detector behind CompiledDAG, the 1F1B pipeline, and the
    rllib channel plane (channels cannot observe a SIGKILLed peer; the
    loop TASK failing is the signal).  Clean exits (teardown: the loop
    returns its execution count) are just marked reaped."""
    import ray_tpu_torch as rt

    candidates = [r for r in loop_refs if r not in reaped]
    if not candidates:
        return []
    try:
        done, _ = rt.wait(candidates, num_returns=len(candidates),
                          timeout=0)
    except Exception as e:
        logger.debug("loop-ref poll failed: %s", e)
        return []
    out = []
    for ref in done:
        reaped.add(ref)
        try:
            rt.get(ref, timeout=5)
        except BaseException as e:  # rtlint: disable=RT005 — not
            # swallowed: returned for the caller to surface (poison /
            # raise / replace)
            out.append((ref, e))
    return out


def resolve_actor_node(handle) -> str:
    """The node currently hosting an actor.  Always refreshed via the
    controller: a handle caches its creation-time address, and an actor
    restarted on another node would otherwise get channel rings placed
    on the old node.  Shared by CompiledDAG, the 1F1B pipeline, and the
    rllib channel plane."""
    from ray_tpu_torch.core.runtime import get_runtime

    aid = handle._actor_id.binary()
    addr = None
    try:
        info = get_runtime().controller_call("get_actor", {"actor_id": aid})
        if info and info.get("address"):
            addr = tuple(info["address"])
    except Exception as e:
        logger.debug("actor %s address refresh failed (%s); using the "
                     "handle's cached address", aid.hex()[:12], e)
    if addr is None:
        addr = handle._address
    if addr is None:
        raise RuntimeError(
            f"actor {aid.hex()[:12]} has no known address (still "
            "scheduling?)"
        )
    return addr[0]


class CompiledDAGRef:
    """Future for one execute() call (reference:
    `experimental/compiled_dag_ref.py`); get() may be called once per
    execution, in order.

    get() honors the ambient end-to-end deadline (PR 1 plumbing): when
    the executing task's `remaining_deadline_s()` is narrower than the
    requested timeout, the wait is clamped to it and expiry raises the
    typed `DeadlineExceededError` the rest of the stack speaks."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def get(self, timeout: Optional[float] = 30.0):
        from ray_tpu_torch.core.runtime import remaining_deadline_s

        deadline_bound = False
        rem = remaining_deadline_s()
        if rem is not None and (timeout is None or rem < timeout):
            timeout, deadline_bound = rem, True
        if not self._done:
            self._dag._collect_until(self._idx, timeout, deadline_bound)
        if self._error is not None:
            raise self._error
        return self._value


class CompiledDAG:
    def __init__(self, root: DAGNode, max_inflight: int = 4):
        self._id = uuid.uuid4().hex[:8]
        self._max_inflight = max_inflight
        self._torn_down = False
        self._next_exec = 0
        self._next_collect = 0
        self._pending: Dict[int, CompiledDAGRef] = {}
        self._partial: List[Any] = []  # outputs read so far for the
        # execution currently being collected (resume after timeout)
        self._loops_reaped: set = set()  # loop refs already diagnosed
        self._poisoned: set = set()  # actor ids whose failure was injected

        if isinstance(root, MultiOutputNode):
            self._outputs: List[DAGNode] = root.outputs
            self._multi = True
        else:
            self._outputs = [root]
            self._multi = False
        for o in self._outputs:
            if not isinstance(o, ClassMethodNode):
                raise TypeError("DAG leaves must be actor method nodes")

        self._compile()

    # -- compilation ---------------------------------------------------
    def _chan_name(self, producer: int, consumer: str) -> str:
        return f"dag{self._id}_e{producer}_{consumer}"

    def _compile(self):
        # topological order over the method nodes
        order: List[ClassMethodNode] = []
        seen = set()

        def visit(n: DAGNode):
            if n._id in seen:
                return
            seen.add(n._id)
            for u in n._upstream():
                visit(u)
            if isinstance(n, ClassMethodNode):
                order.append(n)

        for o in self._outputs:
            visit(o)
        self._order = order

        by_actor: Dict[bytes, List[ClassMethodNode]] = {}
        actor_handles: Dict[bytes, Any] = {}
        node_actor: Dict[int, bytes] = {}
        for n in order:
            aid = n.actor._actor_id.binary()
            by_actor.setdefault(aid, []).append(n)
            actor_handles[aid] = n.actor
            node_actor[n._id] = aid

        # each channel's ring lives on its READER's node; writers on
        # other nodes relay through the daemons (channel.py) — so the
        # graph may span nodes freely (reference: cross-node mutable
        # objects, `experimental_mutable_object_provider.h`)
        from ray_tpu_torch.core.runtime import get_runtime

        driver_node = get_runtime().node_id
        actor_node: Dict[bytes, str] = {
            aid: resolve_actor_node(h) for aid, h in actor_handles.items()
        }

        # consumers per produced node, to know which edges cross actors
        plans: Dict[bytes, Dict] = {
            aid: {"input_channel": None, "steps": []} for aid in by_actor
        }
        self._input_channels: List[Channel] = []
        self._mid_channels: List[Tuple[str, str]] = []

        def arg_source(consumer: ClassMethodNode, arg) -> Tuple[str, Any]:
            if isinstance(arg, InputNode):
                aid = node_actor[consumer._id]
                if plans[aid]["input_channel"] is None:
                    # full actor id: ids embed a shared job prefix, so a
                    # short prefix collides across actors
                    name = f"dag{self._id}_in_{aid.hex()}"
                    loc = actor_node[aid]  # ring on the reading actor
                    plans[aid]["input_channel"] = (name, loc)
                    self._input_channels.append(Channel(name, loc))
                return (ex.SRC_INPUT, None)
            if isinstance(arg, ClassMethodNode):
                if node_actor[arg._id] == node_actor[consumer._id]:
                    return (ex.SRC_LOCAL, arg._id)
                name = self._chan_name(arg._id, f"n{consumer._id}")
                loc = actor_node[node_actor[consumer._id]]  # reader side
                # register the edge on the producer's step
                producer_step[arg._id]["out_channels"].append((name, loc))
                self._mid_channels.append((name, loc))
                return (ex.SRC_CHAN, (name, loc))
            if isinstance(arg, DAGNode):
                raise TypeError(f"unsupported node type {type(arg)}")
            return (ex.SRC_CONST, arg)

        producer_step: Dict[int, Dict] = {}
        for n in order:
            step = {
                "node_id": n._id,
                "method": n.method_name,
                "args": [],
                "kwargs": {},
                "out_channels": [],
            }
            producer_step[n._id] = step
            plans[node_actor[n._id]]["steps"].append(step)
        for n in order:
            step = producer_step[n._id]
            step["args"] = [arg_source(n, a) for a in n.args]
            step["kwargs"] = {k: arg_source(n, v) for k, v in n.kwargs.items()}

        # output channels: leaves -> driver (rings on the driver's node)
        self._output_channels: List[Channel] = []
        for i, o in enumerate(self._outputs):
            name = self._chan_name(o._id, f"out{i}")
            producer_step[o._id]["out_channels"].append((name, driver_node))
            self._output_channels.append(Channel(name, driver_node))

        # launch one resident loop per actor (framework-reserved method;
        # the runtime routes it to execution.dag_exec_loop)
        for aid, plan in plans.items():
            if plan["input_channel"] is None and not any(
                src == ex.SRC_CHAN
                for step in plan["steps"]
                for src, _ in [*step["args"], *step["kwargs"].values()]
            ):
                raise ValueError(
                    "every actor in a compiled DAG must be driven by the "
                    "InputNode or an upstream channel (unbounded source "
                    "loops are not allowed)"
                )

        from ray_tpu_torch.api import ActorMethod

        self._loop_refs = []
        self._loop_owner: Dict[Any, bytes] = {}  # loop ref -> actor id
        self._plans = plans
        self._actors = list(actor_handles.values())
        for aid, plan in plans.items():
            h = actor_handles[aid]
            ref = ActorMethod(h, "__rt_dag_exec_loop__").remote(plan)
            self._loop_refs.append(ref)
            self._loop_owner[ref] = aid

    # -- execution -----------------------------------------------------
    def execute(self, *args) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if len(self._pending) >= self._max_inflight:
            self._collect_until(self._next_collect, timeout=120.0)
        if self._input_channels:
            if len(args) != 1:
                raise TypeError(
                    "execute() takes exactly one input (the InputNode value)"
                )
            for ch in self._input_channels:
                ch.write(args[0])
        elif args:
            raise TypeError("this DAG has no InputNode; execute() takes no args")
        idx = self._next_exec
        self._next_exec += 1
        ref = CompiledDAGRef(self, idx)
        self._pending[idx] = ref
        return ref

    # -- failure detection --------------------------------------------
    def _check_loops(self):
        """Reap failed resident-loop tasks and inject their error into
        the dead actor's outgoing channels.  Only called from the slow
        path (an output read slice timed out): a healthy DAG never pays
        for this."""
        for ref, e in reap_failed_loop_tasks(self._loop_refs,
                                             self._loops_reaped):
            self._poison_actor(self._loop_owner.get(ref), e)

    def _poison_actor(self, aid: Optional[bytes], cause: BaseException):
        """Write the typed failure into every channel the dead actor
        feeds, so each downstream stage (and the driver) unblocks with
        the error instead of hanging on a ring nobody will write."""
        if aid is None or aid in self._poisoned:
            return
        self._poisoned.add(aid)
        err = exc.ActorDiedError(
            f"compiled-DAG stage actor {aid.hex()[:12]} died "
            f"mid-execution: {cause!r}"
        )
        for step in self._plans[aid]["steps"]:
            for name, loc in step["out_channels"]:
                ch = Channel(name, loc)
                try:
                    ch.write_error(err)
                except Exception as e:
                    # full ring or torn-down region: the close below
                    # still unblocks the reader (as ChannelClosed)
                    logger.debug("poison write to %s failed (%s); "
                                 "relying on close", name, e)
                # then the teardown sentinel: downstream loops consume
                # the error, forward it, and exit instead of re-parking
                # on a ring the dead stage will never write again
                ch.close()

    def _collect_until(self, idx: int, timeout: Optional[float],
                       deadline_bound: bool = False):
        """Reads results in execution order up to and including idx.

        A read timeout leaves collection state untouched (the channel
        read_seq only advances on success, and `_partial` resumes where
        it left off), so a slow execution can be re-polled without
        shifting later results by one.  Blocking reads are sliced so a
        SIGKILLed stage is detected (its loop task fails) and its typed
        error injected, instead of blocking the full timeout.
        """
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        while self._next_collect <= idx:
            ref = self._pending.get(self._next_collect)
            error = None
            while len(self._partial) < len(self._output_channels):
                ch = self._output_channels[len(self._partial)]
                try:
                    self._partial.append(self._read_sliced(ch, deadline))
                except ChannelClosed:
                    self._partial.append(None)
                    error = RuntimeError("DAG torn down mid-execution")
                except _Expired:
                    # caller may retry; nothing was consumed (a USER
                    # TimeoutError payload is consumed before raising
                    # and takes the branch below instead)
                    self._raise_expired(deadline_bound)
                except BaseException as e:  # rtlint: disable=RT005 — not
                    # swallowed: stored and re-raised by ref.get()
                    self._partial.append(None)
                    error = e
            values, self._partial = self._partial, []
            self._pending.pop(self._next_collect, None)
            self._next_collect += 1
            if ref is not None:
                ref._done = True
                ref._error = error
                ref._value = (
                    values if self._multi else (values[0] if values else None)
                )

    def _read_sliced(self, ch: Channel, deadline: Optional[float]):
        while True:
            if deadline is None:
                step = _POLL_SLICE_S
            else:
                # even a spent deadline gets one minimal poll: get(0)
                # must return an ALREADY-published result, not time out
                step = min(_POLL_SLICE_S,
                           max(0.001, deadline - time.monotonic()))
            try:
                return ch.read(timeout_s=step)
            except ChannelPollTimeout:
                # slow path only: notice dead stages, then keep waiting
                self._check_loops()
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise _Expired() from None

    def _raise_expired(self, deadline_bound: bool):
        if deadline_bound:
            raise exc.DeadlineExceededError(
                "ambient deadline expired while waiting for DAG output"
            ) from None
        raise TimeoutError("timed out waiting for DAG output") from None

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        import ray_tpu_torch as rt

        for ch in self._input_channels:
            ch.close()
        # loops forward the sentinel; wait for them to exit
        try:
            _, still_running = rt.wait(
                self._loop_refs, num_returns=len(self._loop_refs),
                timeout=10,
            )
        except Exception as e:
            logger.debug("teardown loop wait failed: %s", e)
            still_running = list(self._loop_refs)
        if still_running:
            # a loop that never saw the sentinel (its upstream died, or
            # it is blocked writing into a dead reader's full ring):
            # close every edge so blocked reads AND writes unwedge
            for name, loc in getattr(self, "_mid_channels", ()):
                Channel(name, loc).close()
            for ch in self._output_channels:
                ch.close()
            try:
                rt.wait(still_running, num_returns=len(still_running),
                        timeout=5)
            except Exception as e:
                logger.debug("teardown second loop wait failed: %s", e)
        # free every channel region: they are pinned + non-evictable,
        # so skipping this would leak arena on every compile/teardown
        for ch in [*self._input_channels, *self._output_channels]:
            ch.destroy()
        for name, loc in getattr(self, "_mid_channels", ()):  # actor-to-
            Channel(name, loc).destroy()  # actor edges (exec-loop opened)

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # rtlint: disable=RT005 — interpreter-teardown
            pass  # destructor; logging machinery may already be gone
