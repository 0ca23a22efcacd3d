"""Continuous-batching LLM engine: step-level scheduling over a PAGED
KV cache with radix prefix reuse, in PyTorch on the card.

The port of the JAX package's `serve/llm_engine.py`, with the same
constructor knobs, admission, shedding, prefix-cache, eviction and
harvest logic.  New requests join a RESIDENT decode batch mid-flight;
the KV cache is one fixed block pool `[L, num_blocks, block_size, KV,
hd]` allocated once.

- FUSED DECODE ROUTE (`decode_kernel="kernel"`, what "auto" resolves
  to): `llama.decode_step_paged` reads and writes the pool IN PLACE
  through the block tables with the hand-written CUDA kernels of
  `ops/paged_attention.py` (K5 append, K6 attention).  A kernel that
  fails to build or launch raises; the engine does not fall back.
  With `kv_dtype="int8"` the pool stores per-row-scaled int8 K/V with
  an f32 scale sidecar and the attention kernel fuses the dequant.
- GATHER ROUTE (`decode_kernel="gather"`), the explicit reference:
  every chunk gathers each slot's live blocks into a dense
  `[L, slots, W*block_size, ...]` view, runs `llama.decode_step_vec`
  on it and scatters the blocks back (int8: requantizing only the rows
  the chunk wrote, so stored KV never drifts).
- RADIX PREFIX CACHE: a request whose prompt prefix is cached pins
  those blocks and prefills only the suffix over the gathered prefix
  KV (`llama.forward_with_prefix`).  Completed requests donate their
  full prompt blocks; unpinned nodes are LRU-evicted when the pool
  runs low.
- CHUNKED stepping with ONE host read per chunk: one chunk stepper per
  gather width W, kept in an LRU of `chunk_cache_cap` entries
  (`_chunk_step_for`; the reference's compiled `jax.jit` + `lax.scan`
  programs).  On the card's kernel route a stepper is a `ChunkGraph`:
  the whole chunk (`chunk` decode steps, the argmax, the position
  clamp, the stacked token rows) captured as ONE CUDA graph after its
  first, eager, run, then replayed.  On the CPU and on the gather route
  it is the eager loop of asynchronous launches.  The chunk's token
  rows are copied into pinned host memory without blocking, and an
  event recorded behind the copy is waited on at the NEXT tick's
  harvest, so the read of chunk N overlaps chunk N+1's compute.  Host
  inputs (prompts, block tables) go up through pinned memory too, so
  no tick synchronises with the card except at that event (and at a
  width's first use, whose capture synchronises once).

The JAX engine donates the pool buffers to each compiled dispatch;
here the pools (and scale sidecars) are updated in place.  Greedy
outputs equal a dedicated `llama.generate` for the same prompt, with
the prefix cache on or off, on either route.  Each submit takes the
serve plane's request-ledger ticket (`request_ledger.engine_ticket`),
stamped at admission, prefill, first token and completion, or refused
with the shed reason, as the JAX engine stamps it.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time as _time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.exceptions import BackPressureError, DeadlineExceededError
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import paged_attention as _pa
from ray_tpu_torch.serve import request_ledger as _rl
from ray_tpu_torch.serve.kv_cache import BlockPool, RadixCache

logger = logging.getLogger(__name__)

# the kernel wrappers whose `launches` a captured chunk keeps true: a
# capture runs their Python without launching, a replay launches
# without running it
_COUNTED = (_pa.paged_append_decode_attention, _pa.paged_kv_append,
            _pa.paged_decode_attention)


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rss_bytes() -> int:
    """This process's resident host memory (Linux), 0 where unknown."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        return 0


class ChunkGraph:
    """A decode chunk as one CUDA graph: the counterpart of the
    reference's compiled `jax.jit` of a `lax.scan` over a chunk's steps.

    `run(tables)` is the eager chunk: it reads and updates IN PLACE
    device state that outlives the graph (pools, tokens, positions) and
    returns the chunk's token rows.  The first call runs it eagerly (its
    tokens are real, and it loads what a capture cannot: kernel
    libraries, library handles), then captures it over a static copy of
    `tables`.  Later calls copy their tables into that buffer and replay
    the graph on the current stream; they return the same static output
    tensor, which the next replay overwrites, so a caller reads it on
    that stream before its next call.  `capture_ms` (split into
    `capture_phases_ms`: "prepare", the device sync, collection and
    cache release before capturing; "record", the chunk's Python walked
    under capture; "instantiate", the graph built), `graph_bytes`
    (device memory the capture reserved), `capture_host_bytes` (the
    process's resident host memory it added) and `capture_cpu_s` (the
    process's CPU seconds meanwhile) say what the capture cost;
    `replays` counts the calls that replayed.

    The capture runs with `capture_error_mode="thread_local"`: the
    serving runtime's other threads may touch the card meanwhile.  The
    cyclic garbage collector is off during it: an unreachable graph it
    destroyed there (an old engine's) would invalidate the capture.
    Capturing records the launches without running them and a replay
    runs them without Python, so the `launches` counters of `_COUNTED`
    move by nothing at capture and by the capture's own count (measured,
    in `launches`) at each replay.  K6's workspace must not grow during
    a capture: the caller sizes it first
    (`paged_attention.reserve_workspace`), and the graph keeps the
    workspace it captured alive.  `pool` lets the graphs of one engine
    share a memory pool: they replay one at a time on one stream, and
    each replay's rows are consumed before the next."""

    def __init__(self, run, pool=None):
        self._run = run
        self._pool = pool
        self._graph = None
        self.capture_ms: Optional[float] = None
        self.capture_phases_ms: Dict[str, float] = {}
        self.graph_bytes: Optional[int] = None
        self.capture_host_bytes: Optional[int] = None
        self.capture_cpu_s: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, tables: torch.Tensor) -> torch.Tensor:
        if self._graph is None:
            out = self._run(tables)
            self._capture(tables)
            return out
        self._tables.copy_(tables, non_blocking=True)
        self._graph.replay()
        self.replays += 1
        for fn in _COUNTED:
            fn.launches += self.launches[fn.__name__]
        return self._out

    def _capture(self, tables: torch.Tensor) -> None:
        dev = tables.device
        rss, cpu = _rss_bytes(), _time.process_time()
        t0 = _time.perf_counter()
        self._tables = tables.clone()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        ws = _pa.workspace_of(dev)
        before = {fn: fn.launches for fn in _COUNTED}
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()  # `torch.cuda.graph` collects just before capturing
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                # the clock times the record phase itself, which runs
                # once, at capture; no replay needs it
                t1 = _time.perf_counter()  # rtlint: disable=RT007
                out = self._run(self._tables)
                t2 = _time.perf_counter()  # rtlint: disable=RT007
        finally:
            if gc_on:
                gc.enable()
            for fn in _COUNTED:  # the capture launched nothing
                self.launches[fn.__name__] = fn.launches - before[fn]
                fn.launches = before[fn]
        t3 = _time.perf_counter()
        self.capture_ms = (t3 - t0) * 1e3
        self.capture_phases_ms = {"prepare": (t1 - t0) * 1e3,
                                  "record": (t2 - t1) * 1e3,
                                  "instantiate": (t3 - t2) * 1e3}
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_host_bytes = _rss_bytes() - rss
        self.capture_cpu_s = _time.process_time() - cpu
        after = _pa.workspace_of(dev)
        if ws is None or after[0] is not ws[0] or after[1] is not ws[1]:
            raise RuntimeError(
                "K6's workspace grew during a chunk capture, so the graph "
                "would hold a freed pointer: size it before capturing "
                "(paged_attention.reserve_workspace)")
        self._ws = after
        self._graph, self._out = graph, out


class LlamaEngine:
    """Resident continuous-batching decode engine over a paged KV pool.

    submit() is thread-safe and returns a `concurrent.futures.Future`
    resolving to the generated token ids (greedy — identical to what a
    dedicated `llama.generate` would produce for the same prompt).

    `max_len` caps one sequence (prompt + generation); `kv_blocks`
    sizes the SHARED pool (default: every slot at max_len).
    `prefix_cache=False` disables radix reuse.  `chunk_cache_cap`
    bounds the LRU of chunk steppers, one per gather width (on the
    card's kernel route each holds a CUDA graph of the whole chunk).
    `device` defaults to the CUDA device (raising without a card);
    `params` must live on it.

    Env knobs, read at construction: `RTT_SERVE_TTFT_WINDOW_S` (the TTFT
    window of the shed predictor and `ttft_p50_s` / `ttft_p90_s`,
    default 10), `RTT_ENGINE_TICK_RING` (records kept in
    `stats()["tick_ring"]`, default 32) and `RTT_LLM_ENGINE_TRACE` (a
    per-tick phase line on stdout when set and not "0")."""

    def __init__(self, cfg, params, *, slots: int = 32,
                 max_len: Optional[int] = None, chunk: int = 8,
                 block_size: int = 16, kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_queued: Optional[int] = None,
                 decode_kernel: str = "auto", kv_dtype: str = "model",
                 chunk_cache_cap: int = 8, device=None):
        self.device = resolve_device(device)
        if params["tok_emb"].device != self.device:
            raise ValueError(f"params live on {params['tok_emb'].device}, "
                             f"not on the engine's device {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = int(max_len or cfg.max_seq_len)
        self.chunk = chunk
        self.block_size = int(block_size)
        # blocks a maximal sequence needs (highest touched index is
        # max_len - 1)
        self._max_seq_blocks = _cdiv(self.max_len, self.block_size)
        budget = (int(kv_blocks) if kv_blocks is not None
                  else slots * self._max_seq_blocks)
        if budget < self._max_seq_blocks:
            raise ValueError(
                f"kv_blocks={budget} cannot hold one max_len sequence "
                f"({self._max_seq_blocks} blocks of {self.block_size})"
            )
        # +1: reserved scratch block.  kv_dtype is validated by the pool
        self._pool = BlockPool(budget + 1, kv_dtype=kv_dtype)
        self._kv_int8 = self._pool.kv_dtype == "int8"
        if decode_kernel not in ("auto", "kernel", "gather"):
            raise ValueError(
                f"decode_kernel={decode_kernel!r} not in "
                "('auto', 'kernel', 'gather')"
            )
        self._decode_kernel = ("gather" if decode_kernel == "gather"
                               else "kernel")
        self._radix: Optional[RadixCache] = (
            RadixCache(self.block_size, self._pool) if prefix_cache
            else None
        )
        # chunk steppers, one per gather width, LRU-bounded: on the
        # card's kernel route each holds a CUDA graph (device memory),
        # and a long-lived replica sweeping many widths would otherwise
        # grow the cache without bound
        self._chunk_cache: "OrderedDict[int, object]" = OrderedDict()
        self._chunk_cache_cap = max(1, int(chunk_cache_cap))
        self._chunk_cache_evictions = 0
        self._graphs = (self.device.type == "cuda"
                        and self._decode_kernel == "kernel")
        self._graph_pool = None  # shared by the cached graphs
        self._alloc_device_state()
        if self._graphs:
            # K6's workspace sized once for the widest table, so no
            # capture grows it
            _pa.reserve_workspace(self.device, slots, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.head_dim,
                                  self.block_size, self._max_seq_blocks)
        self._warm_chunk()

        self._decode_kernel_dispatches = 0   # fused-kernel chunk ticks
        self._decode_fallback_dispatches = 0  # gather-route chunk ticks

        self._lock = threading.Lock()
        # the submit queue lives under its OWN condition/lock: the
        # engine thread holds `_lock` across admission prefills, and
        # submit() must never wait those out
        self._wake = threading.Condition(threading.Lock())
        self._queue: deque = deque()
        self._free: List[int] = list(range(slots))
        # slot -> dict(fut, out, want, since, pos_host, blocks, ...)
        self._active: Dict[int, Dict] = {}
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        self._running = True
        # the exception of the latest tick, None once a tick succeeds
        # (check_health reports it)
        self._tick_error: Optional[BaseException] = None
        self._pending_toks = None  # deferred-harvest chunk (see _loop)
        # requests popped from the queue but not yet admitted (plain
        # int: GIL-atomic updates); queue_depth keeps counting them
        self._pending_admissions = 0
        self._chunk_seq = 0  # dispatch counter: requests are tagged
        # with the first chunk that can contain their tokens, so the
        # deferred harvest of an OLDER chunk never credits a slot's
        # new occupant with its previous occupant's tokens

        self._hit_tokens = 0          # prefix tokens served from cache
        self._prefill_tokens = 0      # tokens actually prefilled
        self._prefill_calls = 0       # prefill dispatches (full+suffix)
        # overload plane: bound the admission queue and shed queued
        # requests whose caller has (or must have) given up BEFORE
        # they burn prefill compute
        self.max_queued = None if max_queued is None else int(max_queued)
        if self.max_queued is not None and self.max_queued < 0:
            raise ValueError(f"max_queued={max_queued} must be >= 0")
        self._rejected_total = 0      # queue-full submit() rejections
        self._shed_expired = 0        # queued past their deadline
        self._shed_predicted = 0      # predicted TTFT > remaining budget
        self._draining = False        # begin_drain(): reject new work
        self._ttft_ema_s = 0.0
        # windowed TTFT samples (monotonic ts, ttft): the shed
        # predictor reads the p90 over the window, which decays as
        # samples age out.  Touched only on the engine thread.
        self._ttft_window_s = float(
            os.environ.get("RTT_SERVE_TTFT_WINDOW_S", "10") or 10
        )
        self._ttft_samples: deque = deque(maxlen=256)
        self._tick_ring: deque = deque(maxlen=max(1, int(
            os.environ.get("RTT_ENGINE_TICK_RING", "32") or 32
        )))
        # per-tick phase timing to stdout
        self._trace = os.environ.get("RTT_LLM_ENGINE_TRACE", "") not in (
            "", "0")
        self._tick_ema_s = 0.0
        self._last_gather_blocks = 0  # W of the latest chunk dispatch
        # last computed stats() dict, served when the engine lock is
        # busy — whole-dict swaps only
        self._stats_snapshot: Dict[str, object] = self._stats_locked()

        self._thread = threading.Thread(
            target=self._loop, name="llm-engine", daemon=True
        )
        self._thread.start()

    def _alloc_device_state(self) -> None:
        """Zeroed pools (+ int8 scale sidecars) and per-slot pos/tok."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, self._pool.num_blocks, self.block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        pool_dtype = torch.int8 if self._kv_int8 else cfg.dtype
        self._k_pool = torch.zeros(shape, dtype=pool_dtype, device=dev)
        self._v_pool = torch.zeros_like(self._k_pool)
        self._k_scale = self._v_scale = None
        if self._kv_int8:
            self._k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=dev)
            self._v_scale = torch.zeros_like(self._k_scale)
        self._pos = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._tok = torch.zeros(self.slots, dtype=torch.int32, device=dev)

    def _warm_chunk(self) -> None:
        """One decode chunk of the idle slots (every table on scratch
        block 0), waited for, before the engine serves: a kernel that
        cannot build or launch fails the constructor, and so a replica's
        deploy, rather than its first request."""
        with torch.no_grad():
            self._run_chunk(torch.zeros((self.slots, 1), dtype=torch.int32,
                                        device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._tok.zero_()
        self._pos.zero_()

    def check_health(self) -> None:
        """Raise if the engine has stopped or its latest tick failed."""
        if not self._running:
            raise RuntimeError("llm engine stopped")
        err = self._tick_error
        if err is not None:
            raise RuntimeError(f"llm engine's latest tick failed: {err!r}")

    def _upload(self, values, dtype=torch.int64) -> torch.Tensor:
        """Host values -> device tensor without a host sync: on CUDA
        through pinned memory with a non-blocking copy."""
        t = torch.as_tensor(np.asarray(values), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- public surface ------------------------------------------------
    def retry_after_hint_s(self) -> float:
        """When a rejected caller should retry: the estimated time for
        the current backlog to drain one admission wave (ticks needed
        at the ≤16-per-tick admission budget, priced at the tick EMA),
        floored and capped."""
        backlog = len(self._queue) + self._pending_admissions
        per_tick = float(max(1, min(16, self.slots)))
        est = self._tick_ema_s * max(1.0, backlog / per_tick)
        if est <= 0.0:
            est = 1.0  # no tick has completed yet: default hint
        return max(0.05, min(30.0, est))

    def begin_drain(self) -> None:
        """Graceful scale-down entry: stop ADMITTING new requests
        (submit() rejects with BackPressureError) while live sequences
        decode to completion."""
        self._draining = True

    def submit(self, prompt_ids: List[int], max_new_tokens: int,
               timeout_s: Optional[float] = None) -> Future:
        """`timeout_s` is the caller's remaining end-to-end budget: the
        admission loop sheds the request BEFORE prefill once its
        deadline has passed (or predictably must pass)."""
        limit = self.max_len - 1
        if not prompt_ids or len(prompt_ids) >= limit:
            f: Future = Future()
            f.set_exception(ValueError(
                f"prompt length must be in [1, {limit - 1}]"
            ))
            return f
        n_new = max(1, min(int(max_new_tokens), limit - len(prompt_ids)))
        # engine slice of the request's latency ledger: None (zero
        # allocations) unless an ambient ledger or sampled trace exists
        tk = _rl.engine_ticket()
        now = _time.monotonic()
        deadline = None if timeout_s is None else now + max(0.0, timeout_s)
        fut: Future = Future()
        with self._wake:
            if not self._running:
                if tk is not None:
                    tk.refused("shutdown")
                fut.set_exception(RuntimeError("engine is shut down"))
                return fut
            if self._draining:
                self._rejected_total += 1
                if tk is not None:
                    tk.refused("draining")
                fut.set_exception(BackPressureError(
                    "engine is draining (replica scaling down)",
                    retry_after_s=self.retry_after_hint_s(),
                ))
                return fut
            if (self.max_queued is not None
                    and len(self._queue) + self._pending_admissions
                    >= self.max_queued + len(self._free)):
                # bounded queue: free slots extend the bound, so
                # max_queued=0 means "serve when capacity is free,
                # never queue"
                self._rejected_total += 1
                if tk is not None:
                    tk.refused("queue_full")
                fut.set_exception(BackPressureError(
                    f"engine queue full (max_queued={self.max_queued})",
                    retry_after_s=self.retry_after_hint_s(),
                ))
                return fut
            if deadline is not None and now >= deadline:
                self._shed_expired += 1
                if tk is not None:
                    tk.refused("expired_at_submit")
                fut.set_exception(DeadlineExceededError(
                    "request budget already spent at submission",
                    timeout_s=timeout_s,
                ))
                return fut
            self._queue.append(
                (list(prompt_ids), n_new, fut, now, deadline, tk)
            )
            self._wake.notify()
        return fut

    def stats(self) -> Dict[str, object]:
        """Engine load/health signals, NON-BLOCKING: when the lock is
        not free within a bounded wait (an admission prefill holds it)
        this returns the last per-tick snapshot."""
        if not self._lock.acquire(timeout=0.25):
            return dict(self._stats_snapshot)
        try:
            snap = self._stats_snapshot = self._stats_locked()
        finally:
            self._lock.release()
        return dict(snap)

    def _ttft_quantile(self, q: float) -> float:
        """TTFT quantile over the trailing window — 0.0 once every
        sample has aged out."""
        cutoff = _time.monotonic() - self._ttft_window_s
        live = sorted(v for ts, v in self._ttft_samples if ts >= cutoff)
        if not live:
            return 0.0
        return live[min(len(live) - 1, int(len(live) * q))]

    def _stats_locked(self) -> Dict[str, object]:
        served = self._hit_tokens + self._prefill_tokens
        cached = self._radix.cached_blocks if self._radix else 0
        return {
            "active": len(self._active),
            "queued": len(self._queue),
            "free_slots": len(self._free),
            "queue_depth": (len(self._active) + len(self._queue)
                            + self._pending_admissions),
            "live_tokens": sum(r["pos_host"] for r in self._active.values()),
            "blocks_total": self._pool.capacity,
            "blocks_free": self._pool.free_blocks,
            "blocks_cached": cached,
            "block_occupancy": (
                1.0 - self._pool.free_blocks / self._pool.capacity
            ),
            "prefix_hit_tokens": self._hit_tokens,
            "prefill_tokens": self._prefill_tokens,
            "prefix_hit_rate": self._hit_tokens / served if served else 0.0,
            "prefill_calls": self._prefill_calls,
            "gather_blocks": self._last_gather_blocks,
            # which route the chunk dispatches take and what the pool
            # costs (payload and int8 scale sidecar reported apart)
            "decode_kernel": self._decode_kernel,
            "kv_dtype": self._pool.kv_dtype,
            "kv_pool_bytes": self._k_pool.nbytes + self._v_pool.nbytes,
            "kv_scale_bytes": (
                (self._k_scale.nbytes + self._v_scale.nbytes)
                if self._kv_int8 else 0
            ),
            "decode_kernel_dispatch_total": self._decode_kernel_dispatches,
            "decode_fallback_dispatch_total":
                self._decode_fallback_dispatches,
            "chunk_cache_size": len(self._chunk_cache),
            "chunk_cache_evictions": self._chunk_cache_evictions,
            "ttft_ema_s": self._ttft_ema_s,
            "ttft_p50_s": self._ttft_quantile(0.5),
            "ttft_p90_s": self._ttft_quantile(0.9),
            "ttft_window_s": self._ttft_window_s,
            "tick_ema_s": self._tick_ema_s,
            "ticks": self._chunk_seq,
            "tick_ring": list(self._tick_ring),
            "max_queued": (-1 if self.max_queued is None
                           else self.max_queued),
            "rejected_total": self._rejected_total,
            "shed_expired": self._shed_expired,
            "shed_predicted": self._shed_predicted,
            "shed_total": self._shed_expired + self._shed_predicted,
            "draining": 1.0 if self._draining else 0.0,
        }

    def shutdown(self):
        with self._wake:
            self._running = False
            self._wake.notify()
        self._thread.join(timeout=10)
        if not self._thread.is_alive():
            # the graphs' device memory goes now, not whenever the
            # cyclic collector reaches this engine
            self._chunk_cache.clear()
        with self._lock:
            for req in list(self._active.values()):
                if not req["fut"].done():
                    req["fut"].cancel()
            self._active.clear()
        with self._wake:
            for item in self._queue:
                if not item[2].done():
                    item[2].cancel()
            self._queue.clear()

    # -- device work ---------------------------------------------------
    def _chunk_step_for(self, W: int):
        """Chunk stepper for gather width W: called with the block
        tables [slots, W], it runs `_run_chunk` and returns its token
        rows.  On the card's kernel route it is a `ChunkGraph` (the
        chunk captured after its first, eager, run, then replayed); on
        the CPU and on the gather route, the eager chunk itself.

        Entries are LRU-bounded at `chunk_cache_cap`; an evicted width
        is captured again on its next use (degradation, not growth).
        `_fail_tick` empties the cache without counting evictions: the
        graphs hold the pools it replaces."""
        fn = self._chunk_cache.get(W)
        if fn is not None:
            self._chunk_cache.move_to_end(W)
            return fn
        while len(self._chunk_cache) >= self._chunk_cache_cap:
            old_w = next(iter(self._chunk_cache))
            del self._chunk_cache[old_w]
            self._chunk_cache_evictions += 1
            logger.info(
                "chunk-program cache evicted W=%d (cap=%d, evictions=%d)",
                old_w, self._chunk_cache_cap, self._chunk_cache_evictions,
            )
        if self._graphs:
            if not any(isinstance(s, ChunkGraph) and s.captured
                       for s in self._chunk_cache.values()):
                # no cached graph holds the shared pool any more, and a
                # pool that every graph released cannot be captured
                # into again: start a new one
                self._graph_pool = torch.cuda.graph_pool_handle()
            fn = ChunkGraph(self._run_chunk, self._graph_pool)
        else:
            def fn(tables):
                return self._run_chunk(tables)
        self._chunk_cache[W] = fn
        return fn

    def _run_chunk(self, tables: torch.Tensor) -> torch.Tensor:
        """`chunk` greedy decode steps for every slot; returns the
        token rows [1 + chunk, slots] (row 0 = pre-chunk tokens, so a
        freshly admitted slot's prefill token rides along and admission
        never reads the device).  Idle and finished slots step too,
        with positions clamped below max_len.  `_tok` and `_pos` are
        updated in place, never rebound: admission writes them in
        place, and a captured chunk reads and writes those buffers."""
        if self._decode_kernel == "gather":
            return self._run_chunk_gather(tables)
        cfg, params = self.cfg, self.params
        scales = (self._k_scale, self._v_scale) if self._kv_int8 else None
        tok, pos = self._tok, self._pos
        rows = [tok]
        for _ in range(self.chunk):
            logits = llama.decode_step_paged(
                cfg, params, tok, self._k_pool, self._v_pool, tables, pos,
                kv_scales=scales,
            )[0]
            tok = logits.argmax(dim=-1).to(torch.int32)
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
            rows.append(tok)
        out = torch.stack(rows)
        self._tok.copy_(tok)
        self._pos.copy_(pos)
        return out

    def _run_chunk_gather(self, tables: torch.Tensor) -> torch.Tensor:
        """The reference route: gather every slot's W blocks into a
        dense view, step `decode_step_vec` on it, scatter back.  Shared
        prefix blocks scatter identical, unmodified values from every
        sharer and padding targets the scratch block, so duplicate
        indices are benign."""
        cfg, params = self.cfg, self.params
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        S, W, bs = self.slots, tables.shape[1], self.block_size
        t = tables.long()
        k = self._k_pool[:, t].reshape(L, S, W * bs, KV, hd)
        v = self._v_pool[:, t].reshape(L, S, W * bs, KV, hd)
        if self._kv_int8:
            kq, vq = k, v
            ks = self._k_scale[:, t].reshape(L, S, W * bs, KV)
            vs = self._v_scale[:, t].reshape(L, S, W * bs, KV)
            k = _pa.dequantize_int8(kq, ks, cfg.dtype)
            v = _pa.dequantize_int8(vq, vs, cfg.dtype)
        tok, pos = self._tok, self._pos
        pos0 = pos
        rows = [tok]
        for _ in range(self.chunk):
            logits, (k, v) = llama.decode_step_vec(cfg, params, tok, (k, v),
                                                   pos)
            tok = logits.argmax(dim=-1).to(torch.int32)
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
            rows.append(tok)
        if self._kv_int8:
            # requantize ONLY the rows this chunk wrote; untouched rows
            # keep their stored payload + scale bit-exactly
            idx = torch.arange(W * bs, device=self.device)[None, :]
            touched = ((idx >= pos0[:, None])
                       & (idx < pos0[:, None] + self.chunk))  # [S, M]
            kq2, ks2 = _pa.quantize_int8(k)
            vq2, vs2 = _pa.quantize_int8(v)
            t_p = touched[None, :, :, None, None]
            t_s = touched[None, :, :, None]
            k = torch.where(t_p, kq2, kq)
            v = torch.where(t_p, vq2, vq)
            self._k_scale[:, t] = torch.where(t_s, ks2, ks).reshape(
                L, S, W, bs, KV)
            self._v_scale[:, t] = torch.where(t_s, vs2, vs).reshape(
                L, S, W, bs, KV)
        self._k_pool[:, t] = k.reshape(L, S, W, bs, KV, hd)
        self._v_pool[:, t] = v.reshape(L, S, W, bs, KV, hd)
        out = torch.stack(rows)
        self._tok.copy_(tok)
        self._pos.copy_(pos)
        return out

    def _write_blocks(self, k1: torch.Tensor, v1: torch.Tensor,
                      ids: List[int]) -> None:
        """Write freshly prefilled KV (k1/v1 [L, 1, t, KV, hd], t rows
        from a block boundary) into pool blocks `ids`; the tail of the
        last block is zero-padded (masked by pos until decode writes
        it)."""
        L, _, t, KV, hd = k1.shape
        nb, bs = len(ids), self.block_size
        idx = self._upload(ids)
        k = k1.new_zeros((L, nb * bs, KV, hd))
        v = v1.new_zeros((L, nb * bs, KV, hd))
        k[:, :t] = k1[:, 0]
        v[:, :t] = v1[:, 0]
        if self._kv_int8:
            kq, ksc = _pa.quantize_int8(k)
            vq, vsc = _pa.quantize_int8(v)
            self._k_pool[:, idx] = kq.reshape(L, nb, bs, KV, hd)
            self._v_pool[:, idx] = vq.reshape(L, nb, bs, KV, hd)
            self._k_scale[:, idx] = ksc.reshape(L, nb, bs, KV)
            self._v_scale[:, idx] = vsc.reshape(L, nb, bs, KV)
        else:
            self._k_pool[:, idx] = k.to(self._k_pool.dtype).reshape(
                L, nb, bs, KV, hd)
            self._v_pool[:, idx] = v.to(self._v_pool.dtype).reshape(
                L, nb, bs, KV, hd)

    def _prefix_kv(self, shared: List[int]):
        """The matched prefix blocks gathered dense: (k, v) each
        [L, 1, len(shared) * block_size, KV, hd] in the compute dtype."""
        cfg = self.cfg
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shape = (L, 1, len(shared) * self.block_size, KV, hd)
        idx = self._upload(shared)
        pk, pv = self._k_pool[:, idx], self._v_pool[:, idx]
        if self._kv_int8:
            pk = _pa.dequantize_int8(pk, self._k_scale[:, idx], cfg.dtype)
            pv = _pa.dequantize_int8(pv, self._v_scale[:, idx], cfg.dtype)
        return pk.reshape(shape), pv.reshape(shape)

    # -- admission -----------------------------------------------------
    def _maybe_shed(self, fut: Future, deadline: Optional[float],
                    tk=None) -> bool:
        """Deadline-aware load shedding when a request is popped for
        admission — the last instant before it costs a prefill.  Sheds
        when the deadline has passed, or when the windowed TTFT p90
        says it must overrun the remaining budget."""
        if deadline is None or fut.done():
            return False
        now = _time.monotonic()
        pred = self._ttft_quantile(0.9)
        if now >= deadline:
            self._shed_expired += 1
            why = "deadline already expired in queue"
            reason = "shed_expired"
        elif pred > 0.0 and now + pred >= deadline:
            self._shed_predicted += 1
            why = (f"predicted TTFT ({pred * 1e3:.0f} ms windowed p90) "
                   "exceeds the remaining budget")
            reason = "shed_predicted"
        else:
            return False
        if tk is not None:
            tk.refused(reason)
        fut.set_exception(DeadlineExceededError(
            f"shed before prefill: {why}",
            timeout_s=max(0.0, deadline - now),
        ))
        return True

    def _alloc_or_evict(self, n: int) -> Optional[List[int]]:
        own = self._pool.alloc(n)
        if own is None and self._radix is not None:
            self._radix.evict(n - self._pool.free_blocks)
            own = self._pool.alloc(n)
        return own

    def _admit(self, prompt: List[int], n_new: int, fut: Future,
               t_submit: float, tk=None) -> bool:
        """Returns False (without consuming anything) when the pool
        cannot cover the request right now — the caller requeues it."""
        bs = self.block_size
        T = len(prompt)
        # highest KV index a WANTED token's step touches is T+n_new-2
        total_blocks = _cdiv(T + n_new - 1, bs)

        shared: List[int] = []
        path: List = []
        if self._radix is not None:
            shared, path = self._radix.match(prompt)
        P = len(shared) * bs
        own = self._alloc_or_evict(total_blocks - len(shared))
        if own is None:
            if self._radix is not None:
                self._radix.release(path)
            return False
        if tk is not None:
            # queue wait ends here: the request holds a slot and its
            # blocks; everything after is prefill dispatch
            tk.admitted(_time.time())

        slot = self._free.pop()
        if P > 0:
            # PREFIX HIT: prefill only the suffix, attending over the
            # gathered prefix blocks
            S = T - P
            suffix = self._upload([prompt[P:]])
            logits, (k1, v1) = llama.forward_with_prefix(
                self.cfg, self.params, suffix, self._prefix_kv(shared), P
            )
            self._hit_tokens += P
            self._prefill_tokens += S
        else:
            S = T
            logits, (k1, v1) = llama.forward(
                self.cfg, self.params, self._upload([prompt]),
                return_kv=True,
            )
            self._prefill_tokens += T
        self._prefill_calls += 1
        # suffix KV starts exactly at block boundary P // bs; the first
        # generated token comes from the LAST prompt position and STAYS
        # on the device — the next chunk emits it in its pre-chunk row
        self._write_blocks(k1, v1, own[:_cdiv(S, bs)])
        self._pos[slot] = T
        self._tok[slot] = logits[0, S - 1].argmax()

        # donate this prompt's full blocks to the radix cache (pinned
        # until completion); blocks the trie adopts stop being
        # request-owned so completion doesn't double-free them
        own_set = list(own)
        if self._radix is not None:
            donatable = own[: max(0, (T - 1) // bs - len(shared))]
            path, adopted = self._radix.insert(prompt, path, donatable)
            if adopted:
                adopted_set = set(adopted)
                own_set = [b for b in own_set if b not in adopted_set]

        self._slot_blocks[slot] = shared + own
        if tk is not None:
            # host-side dispatch timestamp: the prefill computes async
            # on the device, but the ledger phases are wall-clock anyway
            tk.prefilled(_time.time())
        self._active[slot] = {
            "fut": fut, "out": [], "want": n_new,
            "since": self._chunk_seq + 1,  # first chunk with its steps
            "pos_host": T, "own_blocks": own_set, "tree_path": path,
            "t_submit": t_submit, "first_tok": False, "tk": tk,
        }
        return True

    def _release(self, slot: int, req: Dict):
        self._slot_blocks[slot] = []
        self._free.append(slot)
        if self._radix is not None and req["tree_path"]:
            self._radix.release(req["tree_path"])
        self._pool.free(req["own_blocks"])

    # -- engine loop ---------------------------------------------------
    def _gather_width(self) -> int:
        """Blocks per slot the next chunk must see: covers every active
        slot's highest touched index, capped per slot at its own
        allocation (overshoot past a finished budget reads scratch
        garbage that only ever lands in truncated surplus tokens)."""
        need = 1
        for slot, req in self._active.items():
            hi = min(req["pos_host"] + self.chunk - 1, self.max_len - 1)
            w = min(hi // self.block_size + 1,
                    len(self._slot_blocks[slot]))
            need = max(need, w)
        return min(_next_pow2(need), self._max_seq_blocks)

    def _to_host(self, toks: torch.Tensor):
        """Start the device->host copy of a chunk's tokens: (host
        tensor, event to wait on before reading it, or None on CPU)."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(toks.device))
        return host, event

    def _harvest(self, toks_host: np.ndarray, seq: int):
        """toks_host [1 + chunk, slots] from dispatch `seq` (row 0 =
        pre-chunk tokens): append per active slot, finish those that
        reached their budget.  Slots admitted after `seq` was
        dispatched are skipped; a request's FIRST chunk contributes
        from row 0 (its prefill token rode along), later ones from
        row 1."""
        now = _time.monotonic()
        wall = _time.time()
        done = []
        for slot, req in self._active.items():
            if req["since"] > seq:
                continue
            start = 0 if req["since"] == seq else 1
            need = req["want"] - len(req["out"])
            if need > 0:
                req["out"].extend(
                    int(t) for t in toks_host[start:start + need, slot]
                )
            if req["out"] and not req["first_tok"]:
                req["first_tok"] = True
                ttft = now - req["t_submit"]
                self._ttft_ema_s = (
                    ttft if self._ttft_ema_s == 0.0
                    else 0.8 * self._ttft_ema_s + 0.2 * ttft
                )
                self._ttft_samples.append((now, ttft))
                if req["tk"] is not None:
                    req["tk"].first_token(wall)
            if len(req["out"]) >= req["want"]:
                done.append(slot)
        for slot in done:
            req = self._active.pop(slot)
            self._release(slot, req)
            if req["tk"] is not None:
                req["tk"].done(len(req["out"][:req["want"]]), wall)
            if not req["fut"].done():
                req["fut"].set_result(req["out"][:req["want"]])

    def _loop(self):
        with torch.no_grad():
            while self._tick():
                pass

    def _tick(self) -> bool:
        """One engine tick: admit, dispatch a chunk, harvest the
        previous chunk.  Returns False once the engine stops."""
        with self._wake:
            while (self._running and not self._active
                   and not (self._queue and self._free)):
                self._wake.wait()
            if not self._running:
                # the engine thread sweeps its own state on exit:
                # shutdown()'s sweep runs after a BOUNDED join
                for item in self._queue:
                    if not item[2].done():
                        item[2].cancel()
                self._queue.clear()
                with self._lock:
                    for req in self._active.values():
                        if not req["fut"].done():
                            req["fut"].cancel()
                    self._active.clear()
                return False
            admissions = []
            # bound by the FREE SLOTS, not just the cap: _admit consumes
            # a slot per entry after this loop
            budget = min(16, len(self._free))
            while self._queue and len(admissions) < budget:
                admissions.append(self._queue.popleft())
            self._pending_admissions = len(admissions)
        try:
            t0 = _time.perf_counter()
            requeue = []
            for i, (prompt, n_new, fut, ts, dl, tk) in \
                    enumerate(admissions):
                # shed BEFORE the prefill: an expired request consumes
                # neither a slot nor a KV block
                if self._maybe_shed(fut, dl, tk):
                    self._pending_admissions -= 1
                    continue
                with self._lock:
                    if not self._admit(prompt, n_new, fut, ts, tk):
                        # pool exhausted by LIVE sequences: wait for
                        # completions, preserving arrival order
                        requeue = admissions[i:]
                        break
                    self._pending_admissions -= 1
            if requeue:
                with self._wake:
                    self._queue.extendleft(reversed(requeue))
                    self._pending_admissions = 0
                admissions = admissions[:len(admissions) - len(requeue)]
            else:
                self._pending_admissions = 0
            t1 = _time.perf_counter()
            with self._lock:
                have_active = bool(self._active)
                W = self._gather_width() if have_active else 0
                if have_active:
                    tables = np.zeros((self.slots, W), np.int32)
                    for slot in self._active:
                        blocks = self._slot_blocks[slot][:W]
                        tables[slot, :len(blocks)] = blocks
            pending = None
            if have_active:
                self._last_gather_blocks = W
                toks = self._chunk_step_for(W)(
                    self._upload(tables, torch.int32))
                if self._decode_kernel == "kernel":
                    self._decode_kernel_dispatches += 1
                else:
                    self._decode_fallback_dispatches += 1
                self._chunk_seq += 1
                pending = (self._to_host(toks), self._chunk_seq)
                with self._lock:
                    for req in self._active.values():
                        req["pos_host"] = min(req["pos_host"] + self.chunk,
                                              self.max_len - 1)
            # OVERLAP: harvest the PREVIOUS chunk's tokens while the
            # current chunk computes.  Cost: finish detection lags one
            # chunk.
            t2 = _time.perf_counter()
            if self._pending_toks is not None:
                (host, event), p_seq = self._pending_toks
                if event is not None:
                    event.synchronize()
                with self._lock:
                    self._harvest(host.numpy(), p_seq)
            self._pending_toks = pending
            t3 = _time.perf_counter()
            self._tick_ema_s = (
                (t3 - t0) if self._tick_ema_s == 0.0
                else 0.8 * self._tick_ema_s + 0.2 * (t3 - t0)
            )
            with self._lock:
                self._tick_ring.append({
                    "seq": self._chunk_seq,
                    "admitted": len(admissions),
                    "active": len(self._active),
                    "queued": len(self._queue),
                    "free_slots": len(self._free),
                    "live_tokens": sum(
                        r["pos_host"] for r in self._active.values()
                    ),
                    "gather_blocks": W,
                    "kernel": self._decode_kernel,
                    "admit_s": t1 - t0,
                    "dispatch_s": t2 - t1,
                    "harvest_s": t3 - t2,
                    "shed_expired": self._shed_expired,
                    "shed_predicted": self._shed_predicted,
                    "rejected_total": self._rejected_total,
                })
                self._stats_snapshot = self._stats_locked()
            if self._trace:
                with self._lock:
                    na, nf = len(self._active), len(self._free)
                    bf = self._pool.free_blocks
                print(f"tick adm={len(admissions)} "
                      f"admit={1e3*(t1-t0):.0f} "
                      f"dispatch={1e3*(t2-t1):.0f} "
                      f"read+harvest={1e3*(t3-t2):.0f}ms "
                      f"W={W} blkfree={bf} "
                      f"active={na} free={nf}", flush=True)
            self._tick_error = None
        except Exception as e:  # engine must not die silently
            logger.exception("llm engine tick failed; failing %d active "
                             "request(s)", len(self._active))
            self._fail_tick(e, admissions)
        return True

    def _fail_tick(self, exc: Exception, admissions) -> None:
        """A failed tick fails every live and popped request with the
        exception and restarts host bookkeeping and device state from
        scratch (the failed chunk may have half-written the pools).
        The chunk steppers go too, uncounted as evictions: a captured
        graph holds the pools that are replaced here."""
        self._tick_error = exc
        self._pending_toks = None
        self._chunk_cache.clear()
        with self._lock:
            for req in self._active.values():
                if not req["fut"].done():
                    req["fut"].set_exception(exc)
            # admissions popped from the queue but not (yet) registered
            # in _active would otherwise hang their callers forever
            for _p, _n, fut, _ts, _dl, _tk in admissions:
                if not fut.done():
                    fut.set_exception(exc)
            self._active.clear()
            self._free = list(range(self.slots))
            self._slot_blocks = [[] for _ in range(self.slots)]
            self._pending_admissions = 0
            self._pool = BlockPool(self._pool.num_blocks,
                                   kv_dtype=self._pool.kv_dtype)
            if self._radix is not None:
                self._radix = RadixCache(self.block_size, self._pool)
        try:
            self._alloc_device_state()
        except Exception:
            # e.g. a sticky CUDA error: the device is unusable, so stop
            # the engine (later submits are refused, queued ones cancel)
            logger.exception("llm engine cannot rebuild its device "
                             "state; stopping")
            with self._wake:
                self._running = False
