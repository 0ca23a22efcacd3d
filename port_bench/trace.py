"""A traced sub-window: `torch.profiler` (CPU + CUDA) over a few seconds
of steady state, reduced to the events the per-layer readers need.

The profiler's Chrome trace is written to a temporary file under
`TMPDIR`, read once and deleted.  What is kept:

- the device's operations (kernels, copies, sets), each with its start,
  duration and the correlation id of the host call that launched it:
  for a CUDA graph's replay, every kernel of the graph carries the id
  of its `cudaGraphLaunch`;
- the CUDA runtime calls (any thread), with their ids;
- the harness's own markers: `pb.window` spans the traced sub-window,
  and `pb.sync` ties the profiler's clock to `time.time()`, the clock
  the engine's request stamps use.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class Op(NamedTuple):
    name: str
    ts: float     # us, profiler clock
    dur: float    # us
    corr: int


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[Op] = []
        self.runtime: List[Op] = []
        marks: Dict[str, Tuple[float, float]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append(Op(e["name"], float(e["ts"]),
                                      float(e.get("dur", 0.0)),
                                      int(args.get("correlation", -1))))
            elif cat in RUNTIME_CATS:
                self.runtime.append(Op(e["name"], float(e["ts"]),
                                       float(e.get("dur", 0.0)),
                                       int(args.get("correlation", -1))))
            elif e.get("name", "").startswith("pb."):
                marks[e["name"]] = (float(e["ts"]), float(e.get("dur", 0.0)))
        self.device.sort(key=lambda o: o.ts)
        self.runtime.sort(key=lambda o: o.ts)
        if "pb.window" not in marks or "pb.sync" not in marks:
            raise RuntimeError("the trace holds no pb.window / pb.sync "
                               "marker")
        w0, wd = marks["pb.window"]
        self.t0, self.t1 = w0, w0 + wd
        self._sync_ts = marks["pb.sync"][0] + marks["pb.sync"][1] / 2
        self.host_sync: Optional[float] = None  # set by `window()`

    # -- clocks ---------------------------------------------------------
    def to_host(self, ts_us: float) -> float:
        """A profiler timestamp as `time.time()` seconds."""
        return self.host_sync + (ts_us - self._sync_ts) / 1e6

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    # -- device time ----------------------------------------------------
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran."""
        busy, end = 0.0, self.t0
        for op in self.device:
            s, e = max(op.ts, end), min(op.ts + op.dur, self.t1)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for op in self.device:
            d = min(op.ts + op.dur, self.t1) - max(op.ts, self.t0)
            if d > 0:
                by[op.name] += d / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest spans with no device operation inside the window,
        each named by the runtime call the host was in at its middle
        ("host: no CUDA call" where it was in none)."""
        gaps, end = [], self.t0
        for op in self.device:
            if op.ts > end:
                gaps.append((end, min(op.ts, self.t1)))
            end = max(end, op.ts + op.dur)
            if end >= self.t1:
                break
        if end < self.t1:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            name = "host: no CUDA call"
            for op in self.runtime:
                if op.ts > mid:
                    break
                if op.ts + op.dur >= mid:
                    name = f"host: {op.name}"
            out.append([name, (e - s) / 1e6])
        return out

    # -- graph launches -------------------------------------------------
    def graph_launches(self) -> List[Tuple[Op, List[Op]]]:
        """Every `cudaGraphLaunch` in the window's trace, in order, with
        the device operations it ran."""
        by_corr = defaultdict(list)
        for op in self.device:
            by_corr[op.corr].append(op)
        return [(rt, by_corr.get(rt.corr, [])) for rt in self.runtime
                if rt.name in ("cudaGraphLaunch", "cudaGraphLaunch_v10000",
                               "cuGraphLaunch")]

    def inside(self, ops: List[Op]) -> bool:
        return bool(ops) and ops[0].ts >= self.t0 and \
            ops[-1].ts + ops[-1].dur <= self.t1


@contextlib.contextmanager
def window(quiet=contextlib.nullcontext, settle_s: float = 0.0):
    """Profile the body; yields a holder whose `trace` is set (parsed)
    by `holder.parse()` once the caller chooses (parsing takes seconds,
    so a caller parses after its measured window).

    The profiler starts and stops under `quiet()`: a caller whose other
    threads launch work on the card holds them still there, since the
    profiler's stop beside a CUDA graph launch on another thread hung
    both, for good, in 2 of 5 traced serve runs on an H100.  The body
    opens `settle_s` after the start, once those threads run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = _Holder()
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    with quiet():
        prof.start()
    try:
        time.sleep(settle_s)
        h0 = time.time()
        with record_function("pb.sync"):
            pass
        holder.host_sync = (h0 + time.time()) / 2
        with record_function("pb.window"):
            yield holder
    finally:
        with quiet():
            torch.cuda.synchronize()
            prof.stop()
    holder.prof = prof


class _Holder:
    prof = None
    host_sync: Optional[float] = None
    trace: Optional[Trace] = None

    def parse(self) -> Trace:
        if self.trace is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    data = json.load(f)
            finally:
                os.unlink(path)
            self.prof = None
            events = data.get("traceEvents", data) if isinstance(data, dict) \
                else data
            self.trace = Trace(events)
            self.trace.host_sync = self.host_sync
        return self.trace
