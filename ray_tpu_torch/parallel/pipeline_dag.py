"""First-class 1F1B pipeline parallelism across stage actors.

The port of the JAX package's `parallel/pipeline_dag.py`: stage actors
(each on its own worker, on the card with `stage_options`
`{"num_gpus": ...}`) are connected by compiled-DAG tensor channels
(`dag/channel.py` KIND_TENSOR — raw activation bytes, no pickle; a
CUDA activation lands on the reading stage's card), and a 1F1B
microbatch schedule is compiled into each stage's resident exec-loop
plan:

- warmup: stage s runs min(S-1-s, M) forwards before its first
  backward (filling the pipe);
- steady: strict 1F1B alternation — one forward, one backward — which
  caps live activations at S-s instead of GPipe's M;
- cooldown: the remaining backwards drain the pipe.

Forward activations flow over per-edge channels ring-buffered with 2
slots (double buffering: microbatch m's transfer overlaps microbatch
m+1's compute); backward activation-gradients flow over reverse
channels the same way.  Each stage accumulates its parameter grads
across microbatches locally; data-parallel replicas of a stage close
the accumulation with the existing collectives (`parallel/collectives`)
exactly like any other grad.

The in-program alternative (same math, `collectives.ppermute` over a
process group instead of channels) is `parallel/pipeline.py`.

Where the reference takes `jax.vjp` of a stage, a stage here runs its
forward with its params' leaves requiring grad and keeps the graph; the
backward is `torch.autograd.grad` of the stage's outputs with respect
to its leaves and its input, given the output gradient.  The last stage
takes the loss's gradient with respect to its output alone, as the
reference's `jax.value_and_grad(loss_fn)`.  Trees are flattened with
`torch.utils._pytree`.  Each stage's accumulated gradients reach the
driver as host tensors.

Bubble accounting matches the standard model the in-program schedule
tests use: with equal unit F and B costs the schedule spans
``2*(M + S - 1)`` unit slots, i.e. a bubble fraction of
``(S-1)/(M+S-1)``.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import (
    Channel,
    ChannelClosed,
    ChannelPollTimeout,
)

logger = logging.getLogger(__name__)


# -- schedule ----------------------------------------------------------
def one_f1b_schedule(stage: int, num_stages: int, num_microbatches: int
                     ) -> List[Tuple[str, int]]:
    """The op sequence stage `stage` executes per batch: ("F", mb) /
    ("B", mb) in warmup -> steady(1F1B) -> cooldown order."""
    S, M, s = num_stages, num_microbatches, stage
    warmup = min(S - 1 - s, M)
    ops: List[Tuple[str, int]] = [("F", m) for m in range(warmup)]
    f, b = warmup, 0
    while f < M:
        ops.append(("F", f))
        f += 1
        ops.append(("B", b))
        b += 1
    while b < M:
        ops.append(("B", b))
        b += 1
    return ops


def schedule_phases(stage: int, num_stages: int, num_microbatches: int
                    ) -> Dict[str, int]:
    """Warmup/steady/cooldown op counts for one stage (introspection
    for tests and docs)."""
    warmup = min(num_stages - 1 - stage, num_microbatches)
    steady = 2 * (num_microbatches - warmup)
    cooldown = 2 * num_microbatches - warmup - steady
    return {"warmup": warmup, "steady": steady, "cooldown": cooldown}


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the schedule: (S-1)/(M+S-1) — identical to the
    in-program GPipe schedule's model (`parallel/pipeline.py`)."""
    S, M = num_stages, num_microbatches
    return (S - 1) / (M + S - 1)


def schedule_makespan_units(num_stages: int, num_microbatches: int) -> int:
    """Simulated makespan of the 1F1B schedule in unit slots (F and B
    each cost 1, transfers free): dependency-driven event simulation
    over every stage's op list.  With equal F/B this is
    ``2*(M + S - 1)``, matching the bubble model above."""
    S, M = num_stages, num_microbatches
    ops = {s: one_f1b_schedule(s, S, M) for s in range(S)}
    pos = {s: 0 for s in range(S)}
    free = {s: 0 for s in range(S)}  # stage available time
    fin_f: Dict[Tuple[int, int], int] = {}
    fin_b: Dict[Tuple[int, int], int] = {}
    remaining = sum(len(v) for v in ops.values())
    while remaining:
        progressed = False
        for s in range(S):
            if pos[s] >= len(ops[s]):
                continue
            kind, m = ops[s][pos[s]]
            if kind == "F":
                dep = fin_f.get((s - 1, m), 0) if s > 0 else 0
                if s > 0 and (s - 1, m) not in fin_f:
                    continue
                start = max(free[s], dep)
                fin_f[(s, m)] = start + 1
            else:
                if s < S - 1 and (s + 1, m) not in fin_b:
                    continue
                dep = fin_b.get((s + 1, m), 0) if s < S - 1 else (
                    fin_f[(s, m)]
                )
                start = max(free[s], dep, fin_f[(s, m)])
                fin_b[(s, m)] = start + 1
            free[s] = start + 1
            pos[s] += 1
            remaining -= 1
            progressed = True
        if not progressed:
            raise RuntimeError("1F1B schedule deadlocked (model bug)")
    return max(free.values())


# -- stage actor -------------------------------------------------------
class _PipelineStage:
    """One pipeline stage: holds its parameter shard and runs the
    compiled 1F1B plan as a resident loop (launched like a compiled-DAG
    exec loop: one long-lived actor task, torn down by channel close).
    The stage computes where its params live: activations and output
    gradients arriving from the host are moved there.
    """

    def __init__(self, stage_fn: Callable, params: Any, stage: int,
                 num_stages: int, loss_fn: Optional[Callable] = None):
        from torch.utils import _pytree as pytree

        self._stage_fn = stage_fn
        leaves, self._spec = pytree.tree_flatten(params)
        self._leaves = [p.detach().requires_grad_(p.is_floating_point())
                        for p in leaves]
        self._params = pytree.tree_unflatten(self._leaves, self._spec)
        self._device = leaves[0].device if leaves else None
        self._s = stage
        self._S = num_stages
        self._loss_fn = loss_fn

    def ping(self) -> bool:
        return True

    def _on_device(self, tree):
        from torch.utils import _pytree as pytree

        if self._device is None:
            return tree
        return pytree.tree_map(lambda t: t.to(self._device), tree)

    def _forward(self, x):
        """(output, its leaves, the input leaf) with the graph kept."""
        import torch
        from torch.utils import _pytree as pytree

        x = x.detach().requires_grad_(self._s > 0)
        with torch.enable_grad():
            y = self._stage_fn(self._params, x)
        return y, pytree.tree_flatten(y)[0], x

    def _loss_and_grad(self, y):
        """`jax.value_and_grad(loss_fn)` at the stage's output."""
        import torch
        from torch.utils import _pytree as pytree

        leaves, spec = pytree.tree_flatten(y)
        free = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            loss = self._loss_fn(pytree.tree_unflatten(free, spec))
        grads = torch.autograd.grad(loss, free)
        return loss.detach(), pytree.tree_unflatten(list(grads), spec)

    def _backward(self, saved, gy):
        """(param grads, input grad) of one microbatch's forward."""
        import torch
        from torch.utils import _pytree as pytree

        y_leaves, x = saved
        gy_leaves = pytree.tree_flatten(gy)[0]
        wrt = [p for p in self._leaves if p.requires_grad]
        if self._s > 0:
            wrt.append(x)
        got = iter(torch.autograd.grad(y_leaves, wrt, gy_leaves,
                                       allow_unused=True))
        gp = []
        for p in self._leaves:
            g = next(got) if p.requires_grad else None
            gp.append(torch.zeros_like(p) if g is None else g)
        gx = next(got) if self._s > 0 else None
        return gp, gx

    def run(self, plan: Dict) -> int:
        """Resident 1F1B loop.  Per batch execution: run the op
        schedule, then publish this stage's accumulated grads (and, on
        the last stage, the mean microbatch loss) to the driver.
        Returns the number of completed batch executions at teardown.
        """
        from torch.utils import _pytree as pytree

        s, S, M = self._s, self._S, plan["num_microbatches"]
        rs = plan.get("ring_slots", 2)
        chans: Dict[str, Channel] = {}

        def chan(key) -> Optional[Channel]:
            ref = plan.get(key)
            if ref is None:
                return None
            c = chans.get(key)
            if c is None:
                if key == "in_chan":
                    # MUST match the driver's sizing: whichever endpoint
                    # opens the ring first creates it, and creator wins
                    slots = plan.get("in_ring_slots")
                elif key == "result":
                    slots = None
                else:
                    slots = rs
                c = chans[key] = Channel(ref[0], ref[1], ring_slots=slots)
            return c

        in_chan = chan("in_chan")
        fwd_in, fwd_out = chan("fwd_in"), chan("fwd_out")
        bwd_in, bwd_out = chan("bwd_in"), chan("bwd_out")
        result = chan("result")
        ops = one_f1b_schedule(s, S, M)
        inv_m = 1.0 / float(M)
        executions = 0
        try:
            while True:
                saved: Dict[int, Any] = {}
                pending_gy: Dict[int, Any] = {}
                grads = None
                loss_sum = 0.0
                for kind, m in ops:
                    if kind == "F":
                        src = in_chan if s == 0 else fwd_in
                        x = self._on_device(src.read())
                        y, y_leaves, x = self._forward(x)
                        saved[m] = (y_leaves, x)
                        if s == S - 1:
                            # last stage closes the loss: grad wrt its
                            # own output, scaled by 1/M so the summed
                            # accumulation equals the full-batch mean
                            loss_m, gy = self._loss_and_grad(y)
                            loss_sum += float(loss_m)
                            pending_gy[m] = pytree.tree_map(
                                lambda g: g * inv_m, gy
                            )
                        else:
                            fwd_out.write(pytree.tree_map(
                                lambda t: t.detach(), y
                            ))
                    else:
                        gy = (pending_gy.pop(m) if s == S - 1
                              else self._on_device(bwd_in.read()))
                        gp, gx = self._backward(saved.pop(m), gy)
                        grads = gp if grads is None else [
                            a + b for a, b in zip(grads, gp)
                        ]
                        if s > 0:
                            bwd_out.write(gx)
                leaves = [g.detach().cpu() for g in grads]
                extra = {"stage": s}
                if s == S - 1:
                    extra["loss"] = loss_sum * inv_m
                result.write_tensors(leaves, extra=extra)
                executions += 1
        except ChannelClosed:
            # teardown (or a neighbor's failure closed an edge):
            # forward the close so the rest of the pipe unwedges
            for c in chans.values():
                if c is not None:
                    c.close()
            return executions
        except BaseException as e:  # rtlint: disable=RT005 — not
            # swallowed: surfaced to the driver as a typed result-
            # channel payload, then re-raised on the loop task
            logger.debug("pipeline stage %d failed: %s", s, e)
            if result is not None:
                try:
                    result.write_error(e)
                except Exception as e2:
                    logger.debug("stage %d error publish failed: %s", s, e2)
            for c in chans.values():
                if c is not None:
                    c.close()
            raise


class PipelineRef:
    """Future for one pipeline execute(); get() in execution order."""

    def __init__(self, pipe: "CompiledPipeline", idx: int):
        self._pipe = pipe
        self._idx = idx
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def get(self, timeout: Optional[float] = 120.0):
        if not self._done:
            self._pipe._collect_until(self._idx, timeout)
        if self._error is not None:
            raise self._error
        return self._value


class CompiledPipeline:
    """S stage actors + channel mesh + resident 1F1B loops.

    ``execute(x)`` splits x (a tensor, or an array) into M
    microbatches along axis 0, drives the pipe, and the returned ref's
    ``get()`` yields ``{"loss": float, "grads": [per-stage grad pytree
    of host tensors]}`` — numerically equal (rtol 1e-5) to serial
    application + autograd, and to the in-program
    `parallel.pipeline_apply` schedule.
    """

    def __init__(self, stage_fn: Callable, stage_params: List[Any],
                 loss_fn: Callable, num_microbatches: int, *,
                 ring_slots: int = 2, max_inflight: int = 2,
                 stage_options: Optional[List[Dict]] = None):
        import ray_tpu_torch as rt

        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        self._S = len(stage_params)
        if self._S < 2:
            raise ValueError("a pipeline needs >= 2 stages")
        self._M = num_microbatches
        self._ring_slots = ring_slots
        self._max_inflight = max_inflight
        self._torn_down = False
        self._next_exec = 0
        self._next_collect = 0
        self._pending: Dict[int, PipelineRef] = {}
        # per-stage results read so far for the execution currently
        # being collected — a timeout resumes HERE instead of
        # re-reading stage 0 (which would desynchronize the channels)
        self._partial: List[Any] = []
        self._partial_loss: Optional[float] = None
        self._partial_error: Optional[BaseException] = None
        self._id = uuid.uuid4().hex[:8]

        from torch.utils import _pytree as pytree

        self._treedefs = [pytree.tree_flatten(p)[1] for p in stage_params]

        Stage = rt.remote(_PipelineStage)
        self._actors = []
        for s in range(self._S):
            opts = (stage_options[s] if stage_options else {}) or {}
            cls = Stage.options(**opts) if opts else Stage
            self._actors.append(cls.remote(
                stage_fn, stage_params[s], s, self._S,
                loss_fn if s == self._S - 1 else None,
            ))
        # force placement before resolving ring locations
        rt.get([a.ping.remote() for a in self._actors], timeout=120)

        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.dag.compiled_dag import resolve_actor_node

        driver = get_runtime().node_id
        nodes = [resolve_actor_node(a) for a in self._actors]

        def cname(tag: str) -> str:
            return f"pp{self._id}_{tag}"

        # input ring sized for a full batch of microbatches so
        # execute() rarely blocks mid-feed; the same size ships in
        # every stage plan (stage 0 may open — and thus create — the
        # ring first, and the creator's geometry wins)
        in_ring_slots = max(8, min(num_microbatches, 64))
        self._in_chan = Channel(cname("in"), nodes[0],
                                ring_slots=in_ring_slots)
        self._result_chans = [
            Channel(cname(f"r{s}"), driver) for s in range(self._S)
        ]
        plans = []
        for s in range(self._S):
            plan: Dict[str, Any] = {
                "num_microbatches": num_microbatches,
                "ring_slots": ring_slots,
                "in_ring_slots": in_ring_slots,
                "result": (cname(f"r{s}"), driver),
            }
            if s == 0:
                plan["in_chan"] = (cname("in"), nodes[0])
            else:
                plan["fwd_in"] = (cname(f"f{s - 1}"), nodes[s])
                plan["bwd_out"] = (cname(f"b{s - 1}"), nodes[s - 1])
            if s < self._S - 1:
                plan["fwd_out"] = (cname(f"f{s}"), nodes[s + 1])
                plan["bwd_in"] = (cname(f"b{s}"), nodes[s])
            plans.append(plan)
        self._edge_channels = []
        for s in range(self._S - 1):
            self._edge_channels.append((cname(f"f{s}"), nodes[s + 1]))
            self._edge_channels.append((cname(f"b{s}"), nodes[s]))
        self._loop_refs = [
            a.run.remote(p) for a, p in zip(self._actors, plans)
        ]
        self._loops_reaped: set = set()

    # -- execution -----------------------------------------------------
    def execute(self, x) -> PipelineRef:
        import numpy as np
        import torch

        if self._torn_down:
            raise RuntimeError("pipeline was torn down")
        if len(self._pending) >= self._max_inflight:
            self._collect_until(self._next_collect, timeout=300.0)
        B = x.shape[0]
        if B % self._M:
            raise ValueError(
                f"batch {B} must divide into {self._M} microbatches"
            )
        mb = B // self._M
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        for m in range(self._M):
            self._in_chan.write(x[m * mb:(m + 1) * mb])
        idx = self._next_exec
        self._next_exec += 1
        ref = PipelineRef(self, idx)
        self._pending[idx] = ref
        return ref

    def _check_loops(self):
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch.dag.compiled_dag import reap_failed_loop_tasks

        for _ref, e in reap_failed_loop_tasks(self._loop_refs,
                                              self._loops_reaped):
            return exc.ActorDiedError(
                f"pipeline stage actor died mid-schedule: {e!r}"
            )
        return None

    def _read_result(self, ch: Channel, deadline: Optional[float]):
        while True:
            # a spent deadline still gets one minimal poll so get(0)
            # returns an already-published result instead of timing out
            step = 0.25 if deadline is None else min(
                0.25, max(0.001, deadline - time.monotonic())
            )
            try:
                return ch.read_tensors(timeout_s=step)
            except ChannelPollTimeout:
                dead = self._check_loops()
                if dead is not None:
                    raise dead from None
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise TimeoutError(
                        "timed out waiting for pipeline result"
                    ) from None

    def _collect_until(self, idx: int, timeout: Optional[float]):
        from torch.utils import _pytree as pytree

        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        while self._next_collect <= idx:
            ref = self._pending.get(self._next_collect)
            while (self._partial_error is None
                   and len(self._partial) < self._S):
                s = len(self._partial)
                try:
                    leaves, extra = self._read_result(
                        self._result_chans[s], deadline
                    )
                except TimeoutError:
                    raise  # nothing lost: `_partial` resumes at stage s
                except ChannelClosed:
                    self._partial_error = RuntimeError(
                        "pipeline torn down mid-execution"
                    )
                    break  # a failed stage never publishes; don't hang
                except BaseException as e:  # rtlint: disable=RT005 — not
                    # swallowed: stored and re-raised by ref.get()
                    self._partial_error = e
                    break
                self._partial.append(pytree.tree_unflatten(
                    list(leaves), self._treedefs[s]
                ))
                if extra and "loss" in extra:
                    self._partial_loss = float(extra["loss"])
            grads, loss, error = (
                self._partial, self._partial_loss, self._partial_error
            )
            self._partial, self._partial_loss, self._partial_error = (
                [], None, None
            )
            self._pending.pop(self._next_collect, None)
            self._next_collect += 1
            if ref is not None:
                ref._done = True
                ref._error = error
                ref._value = (None if error is not None
                              else {"loss": loss, "grads": grads})

    # -- lifecycle -----------------------------------------------------
    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        import ray_tpu_torch as rt

        self._in_chan.close()
        try:
            _, still = rt.wait(self._loop_refs,
                               num_returns=len(self._loop_refs), timeout=10)
        except Exception as e:
            logger.debug("pipeline teardown wait failed: %s", e)
            still = list(self._loop_refs)
        if still:
            for name, loc in self._edge_channels:
                Channel(name, loc).close()
            for ch in self._result_chans:
                ch.close()
            try:
                rt.wait(still, num_returns=len(still), timeout=5)
            except Exception as e:
                logger.debug("pipeline second teardown wait failed: %s", e)
        for ch in [self._in_chan, *self._result_chans]:
            ch.destroy()
        for name, loc in self._edge_channels:
            Channel(name, loc).destroy()

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # rtlint: disable=RT005 — interpreter-teardown
            pass  # destructor; logging machinery may already be gone


def compile_pipeline(stage_fn: Callable, stage_params: List[Any],
                     loss_fn: Callable, num_microbatches: int,
                     **kwargs) -> CompiledPipeline:
    """Build + launch a 1F1B pipeline (see CompiledPipeline)."""
    return CompiledPipeline(stage_fn, stage_params, loss_fn,
                            num_microbatches, **kwargs)
