"""Runtime-plane microbenchmarks (reference capability:
`python/ray/_private/ray_perf.py` — `ray microbenchmark` — and
`release/benchmarks/`; numbers table in BASELINE.md).

Measures the task/actor/object-plane hot paths end-to-end against a
real local cluster:

    python -m ray_tpu_torch.scripts.perf [--filter pat] [--json out.json]
           [--rounds N] [--round-sec S]

Each benchmark reports ops/s (mean ± sd over rounds).  The matrix
mirrors the reference's microbenchmark names so BASELINE.md rows are
directly comparable (hardware caveats apply — record machine specs
next to any saved run).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def timeit(name: str, fn: Callable[[], None], multiplier: float = 1.0,
           rounds: int = 3, round_sec: float = 1.0,
           warmup_sec: float = 0.5) -> Tuple[str, float, float]:
    """Run `fn` repeatedly; returns (name, ops/s mean, sd)."""
    start = time.perf_counter()
    count = 0
    while time.perf_counter() - start < warmup_sec:
        fn()
        count += 1
    step = max(1, count // 5)
    stats = []
    for _ in range(rounds):
        start = time.perf_counter()
        count = 0
        while time.perf_counter() - start < round_sec:
            for _ in range(step):
                fn()
            count += step
        stats.append(multiplier * count / (time.perf_counter() - start))
    mean = statistics.fmean(stats)
    sd = statistics.stdev(stats) if len(stats) > 1 else 0.0
    print(f"{name}: {mean:,.2f} +- {sd:,.2f} per second", flush=True)
    return (name, mean, sd)


# ---------------------------------------------------------------------
# benchmark bodies (module-level so tasks pickle by reference)
# ---------------------------------------------------------------------
def _small_value():
    return 0


def _put_small_batch(rt_mod, n=100):
    import ray_tpu_torch as rt

    for _ in range(n):
        rt.put(0)
    return 0


class _PerfActor:
    def small_value(self):
        return 0

    def small_value_batch(self, n):
        return [0] * n

    def submit_task_batch(self, n):
        """Acts as an independent client: submits n tasks of its own
        (the reference's multi-client benchmark shape)."""
        import ray_tpu_torch as rt

        fn = rt.remote(num_cpus=0)(_small_value)
        return len(rt.get([fn.remote() for _ in range(n)]))


class _AsyncPerfActor:
    async def small_value(self):
        return 0


def build_matrix(rt, args):
    """(name, factory, ops-multiplier) triples.  Each factory returns
    (body, cleanup); actors are created lazily inside the factory and
    killed by cleanup so earlier rows aren't polluted by the background
    load of processes later rows need (matters on small hosts)."""
    small_value = rt.remote(num_cpus=0)(_small_value)
    put_batch = rt.remote(num_cpus=0)(_put_small_batch)
    Actor = rt.remote(num_cpus=0)(_PerfActor)
    AsyncActor = rt.remote(num_cpus=0)(_AsyncPerfActor)
    _none = lambda: None  # noqa: E731

    def get_small_f():
        value_ref = rt.put(0)
        return (lambda: rt.get(value_ref)), _none

    def put_small_f():
        return (lambda: rt.put(0)), _none

    def put_large_f():
        arr = np.zeros(100 * 1024 * 1024 // 8, dtype=np.int64)  # 100 MB
        return (lambda: rt.put(arr)), _none

    def multi_client_put_f():
        body = lambda: rt.get(  # noqa: E731
            [put_batch.remote(None) for _ in range(4)]
        )
        return body, _none

    def task_sync_f():
        return (lambda: rt.get(small_value.remote())), _none

    def tasks_async_f():
        body = lambda: rt.get(  # noqa: E731
            [small_value.remote() for _ in range(1000)]
        )
        return body, _none

    def multi_client_tasks_f():
        # each actor is an independent client submitting its own tasks
        actors = [Actor.remote() for _ in range(4)]
        rt.get([a.small_value.remote() for a in actors])
        body = lambda: rt.get(  # noqa: E731
            [a.submit_task_batch.remote(250) for a in actors]
        )
        return body, lambda: [rt.kill(a) for a in actors]

    def actor_sync_f():
        a = Actor.remote()
        rt.get(a.small_value.remote())
        return (lambda: rt.get(a.small_value.remote())), lambda: rt.kill(a)

    def actor_async_f():
        a = Actor.remote()
        rt.get(a.small_value.remote())
        body = lambda: rt.get(  # noqa: E731
            [a.small_value.remote() for _ in range(1000)]
        )
        return body, lambda: rt.kill(a)

    def async_actor_f():
        a = AsyncActor.remote()
        rt.get(a.small_value.remote())
        body = lambda: rt.get(  # noqa: E731
            [a.small_value.remote() for _ in range(1000)]
        )
        return body, lambda: rt.kill(a)

    def n_n_actors_f():
        actors = [Actor.remote() for _ in range(4)]
        rt.get([a.small_value.remote() for a in actors])

        def body():
            refs = []
            for a in actors:
                refs.extend(a.small_value.remote() for _ in range(250))
            rt.get(refs)

        return body, lambda: [rt.kill(a) for a in actors]

    def wait_1k_f():
        def body():
            not_ready = [small_value.remote() for _ in range(1000)]
            while not_ready:
                _ready, not_ready = rt.wait(not_ready)

        return body, _none

    def pg_f():
        from ray_tpu_torch.util import placement_group, remove_placement_group

        def body():
            pg = placement_group([{"CPU": 0.01}])
            pg.ready(timeout=10)
            remove_placement_group(pg)

        return body, _none

    return [
        ("single client get calls (shm store)", get_small_f, 1),
        ("single client put calls (shm store)", put_small_f, 1),
        ("single client put gigabytes", put_large_f, 0.1),
        ("multi client put calls (shm store)", multi_client_put_f, 400),
        ("single client tasks sync", task_sync_f, 1),
        ("single client tasks async", tasks_async_f, 1000),
        ("multi client tasks async", multi_client_tasks_f, 1000),
        ("1:1 actor calls sync", actor_sync_f, 1),
        ("1:1 actor calls async", actor_async_f, 1000),
        ("1:1 async-actor calls async", async_actor_f, 1000),
        ("n:n actor calls async", n_n_actors_f, 1000),
        ("single client wait 1k refs", wait_1k_f, 1),
        ("placement group create/removal", pg_f, 1),
    ]


def _shard_snapshot() -> List[Dict]:
    from ray_tpu_torch.core.runtime import get_runtime

    return get_runtime().owner_shard_stats()


def owner_shard_report(before: List[Dict], after: List[Dict]) -> List[Dict]:
    """Per-shard delta rows for one measured run: tasks completed on
    each shard and the shard thread's CPU us per task — the accounting
    that proves shard scaling is flat even when the host lacks the
    cores to show a wall-clock win (PERF.md cost model)."""
    rows = []
    for b, a in zip(before, after):
        done = a["completed"] - b["completed"]
        cpu = a["cpu_s"] - b["cpu_s"]
        rows.append({
            "shard": a["shard"],
            "submitted": a["submitted"] - b["submitted"],
            "completed": done,
            "cpu_s": round(cpu, 3),
            "us_per_task": round(cpu * 1e6 / done, 1) if done else 0.0,
        })
    return rows


def measure_task_storm(rt, n: int = 1000) -> Dict[str, float]:
    """Submit `n` no-op tasks at once and track each completion time —
    the per-task latency distribution under a full queue bounds the
    runtime's scheduling throughput at depth (VERDICT r2: the 1-vCPU
    microbench rows leave it unmeasured; reference analog: the
    1M-tasks-queued single-node scalability case)."""
    import time as _t

    @rt.remote
    def _noop():
        return 0

    rt.get(_noop.remote())  # warm a lease
    t0 = _t.perf_counter()
    refs = [_noop.remote() for _ in range(n)]
    submit_s = _t.perf_counter() - t0
    lat: List[float] = []
    pending = refs
    while pending:
        done, pending = rt.wait(pending, num_returns=1)
        lat.append(_t.perf_counter() - t0)
        for d in done:
            rt.get(d)
    lat_arr = np.asarray(lat)
    return {
        "submit_s": submit_s,
        "drain_s": float(lat_arr[-1]),
        "p50_s": float(np.percentile(lat_arr, 50)),
        "p95_s": float(np.percentile(lat_arr, 95)),
        "p100_s": float(lat_arr.max()),
        "tasks_per_s": n / float(lat_arr.max()),
    }


# ----------------------------------------------------------------------
# control-plane core scaling (VERDICT r3 #4: the asyncio-control-plane
# bet is validated per-core only — measure where CPU time goes and what
# dedicated cores buy)
# ----------------------------------------------------------------------
def _proc_tree_cpu() -> Dict[int, Dict[str, object]]:
    """pid -> {ppid, role, ticks} for this process and its descendants
    (driver, node daemon, workers), from /proc — no psutil dependency."""
    procs: Dict[int, Dict[str, object]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().replace(b"\0", b" ").decode(
                    errors="replace")
        except OSError:
            continue
        # comm may contain spaces/parens: split after the LAST ')'
        rest = stat.rsplit(")", 1)[1].split()
        ppid = int(rest[1])      # field 4
        utime = int(rest[11])    # field 14
        stime = int(rest[12])    # field 15
        procs[pid] = {"ppid": ppid, "cmdline": cmdline,
                      "ticks": utime + stime}
    me = os.getpid()
    keep: Dict[int, Dict[str, object]] = {}
    children: Dict[int, List[int]] = {}
    for pid, info in procs.items():
        children.setdefault(info["ppid"], []).append(pid)
    stack = [me]
    while stack:
        pid = stack.pop()
        if pid not in procs:
            continue
        keep[pid] = procs[pid]
        stack.extend(children.get(pid, []))
    for pid, info in keep.items():
        cmd = info["cmdline"]
        if pid == me:
            info["role"] = "driver"
        elif "noded" in cmd:
            info["role"] = "noded"
        elif "worker_main" in cmd:
            info["role"] = "worker"
        else:
            info["role"] = "other"
    return keep


def measure_core_split(rt, n: int = 1000) -> Dict[str, float]:
    """Task-storm with per-component CPU accounting: how many CPU
    microseconds each plane (driver runtime, node daemon, workers)
    burns per task.  On a 1-core box throughput ~= 1e6 / SUM(us); with
    each plane on its own core the pipeline bound is 1e6 / MAX(us) —
    the analytic multi-core projection PERF.md records.  On multi-core
    rigs combine with --pin-cores for the measured curve."""
    # warm-up storm: spawn/prestart every worker BEFORE the snapshot,
    # or their multi-second import cost pollutes the per-task delta
    measure_task_storm(rt, n=min(200, n))
    before = _proc_tree_cpu()
    dist = measure_task_storm(rt, n=n)
    after = _proc_tree_cpu()
    tick = os.sysconf("SC_CLK_TCK")
    split_us = {r: 0.0 for r in ("driver", "noded", "worker", "other")}
    steady_workers = 0
    for pid, info in after.items():
        prev = before.get(pid)
        if prev is None:
            continue  # spawned mid-storm: startup cost, not task cost
        if info["role"] == "worker":
            steady_workers += 1
        delta = (info["ticks"] - prev["ticks"]) / tick
        split_us[info["role"]] += delta * 1e6 / n
    total_us = sum(v for v in split_us.values() if v > 0)
    # the worker plane is a POOL: its cost spreads over num_workers
    # cores; driver and daemon are single event loops (one core each).
    # Only workers present for the WHOLE storm count — their CPU is
    # what the deltas above summed.
    n_workers = max(1, steady_workers)
    plane_us = {
        "driver": split_us["driver"],
        "noded": split_us["noded"],
        "worker_pool": split_us["worker"] / n_workers,
    }
    bottleneck = max(plane_us, key=plane_us.get)
    # every delta can round to zero ticks on tiny storms
    # (SC_CLK_TCK=100 -> 10 ms granularity): report, don't divide
    projected = (
        round(1e6 / plane_us[bottleneck], 1)
        if plane_us[bottleneck] > 0 else 0.0
    )
    return {
        **{f"{k}_us_per_task": round(v, 1) for k, v in split_us.items()},
        "num_workers": float(n_workers),
        "total_us_per_task": round(total_us, 1),
        "measured_tasks_per_s": round(dist["tasks_per_s"], 1),
        "projected_pipelined_tasks_per_s": projected,
        "bottleneck": bottleneck,
    }


def apply_core_pinning(cores: int) -> Dict[str, List[int]]:
    """Pin each plane to its own core(s): driver -> 0, node daemon ->
    1, workers round-robin over the rest (reference analog: the
    release-test rigs isolate raylet/worker CPU).  Requires a box with
    >= `cores` cores; returns the placement actually applied.

    Pinning covers processes alive NOW: workers respawned later
    inherit the daemon's single-core affinity — warm the worker pool
    first (main() runs a warm-up storm before pinning) and re-apply
    after any worker churn."""
    avail = sorted(os.sched_getaffinity(0))
    if len(avail) < cores:
        raise RuntimeError(
            f"--pin-cores {cores} needs {cores} cores; this box exposes "
            f"{len(avail)} ({avail})"
        )
    use = avail[:cores]
    placement: Dict[str, List[int]] = {}
    for pid, info in _proc_tree_cpu().items():
        role = info["role"]
        if role == "driver":
            core = use[0]
        elif role == "noded":
            core = use[1 % len(use)]
        else:  # workers + other spread over the remaining cores
            rest = use[2:] or use
            core = rest[pid % len(rest)]
        try:
            os.sched_setaffinity(pid, {core})
            placement.setdefault(role, []).append(core)
        except OSError:
            pass
    return placement


class _BusbwMember:
    def __init__(self, rank, world, size_mb):
        from ray_tpu_torch.parallel import collectives as col

        self.g = col.init_collective_group(world, rank,
                                           group_name="perf_busbw")
        self.world = world
        self.arr = np.random.default_rng(rank).standard_normal(
            size_mb * 1024 * 1024 // 8
        )

    def run(self, iters):
        import time as _t

        self.g.barrier()
        t0 = _t.perf_counter()
        for _ in range(iters):
            self.g.allreduce(self.arr)
        dt = _t.perf_counter() - t0
        # ring algorithm bus bandwidth convention (NCCL tests):
        # busbw = 2*(n-1)/n * size / time
        n = self.world
        return (2 * (n - 1) / n) * self.arr.nbytes * iters / dt / 1e9


def measure_allreduce_busbw(rt, world: int = 2, size_mb: int = 16,
                            iters: int = 3) -> float:
    """Host-tier ring-allreduce bus bandwidth in GB/s (the BASELINE
    north-star metric the reference measures with nccl-tests against
    `util.collective`)."""
    Member = rt.remote(num_cpus=0)(_BusbwMember)
    members = [Member.remote(i, world, size_mb) for i in range(world)]
    vals = rt.get([m.run.remote(iters) for m in members], timeout=600)
    for m in members:
        rt.kill(m)
    try:  # the named rendezvous must not survive into a rerun
        rt.kill(rt.get_actor("__rt_collective__perf_busbw"))
    except Exception:
        pass
    return float(min(vals))


# ----------------------------------------------------------------------
# scalability envelope (reference:
# `release/benchmarks/single_node/test_single_node.py:12-53` and
# `release/benchmarks/object_store/test_object_store.py` — the published
# envelope BASELINE.md carries: 10k args to one task, 3k returns,
# 10k-ref get, 1M queued tasks, 100 GiB objects, 1 GiB broadcast)
# ----------------------------------------------------------------------
def _count_args(*args):
    return len(args)


def _envelope_checksum(arr):
    return int(arr[0]), int(arr[-1]), int(arr.nbytes)


def _rss_gb(pid: int = 0) -> float:
    try:
        with open(f"/proc/{pid or os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return 0.0


def _warm_sleep(sec):
    time.sleep(sec)
    return 0


def measure_envelope(rt, *, args_n: int = 10_000, returns_n: int = 3_000,
                     get_n: int = 10_000, queue_n: int = 100_000,
                     large_gb: float = 50.0, num_workers: int = 4,
                     rows: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Single-node envelope rows (the broadcast row needs a multi-node
    cluster — `measure_envelope_broadcast`).  Each row returns measured
    seconds; a row that raises records the failure instead of killing
    the run, so one cliff doesn't hide the others."""
    rows = rows or ["args", "returns", "get", "queue", "large"]
    out: Dict[str, Dict] = {}

    def _row(name, fn):
        if name not in rows:
            return
        try:
            out[name] = fn()
            print(f"envelope[{name}]: " + ", ".join(
                f"{k}={v}" for k, v in out[name].items()), flush=True)
        except Exception as e:  # record the cliff, keep going
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"envelope[{name}] FAILED: {e}", flush=True)

    count_args = rt.remote(num_cpus=0)(_count_args)
    # boot the whole worker pool before timing anything: a cold worker
    # pays seconds of interpreter+jax import, which is boot latency,
    # not envelope capacity.  The sleeps overlap, so the tasks cannot
    # all pipeline onto the first worker to register — every pool slot
    # must boot to drain this batch
    warm = rt.remote(num_cpus=1)(_warm_sleep)
    rt.get([warm.remote(0.5) for _ in range(2 * num_workers)])

    def row_args():
        t0 = time.perf_counter()
        refs = [rt.put(0) for _ in range(args_n)]
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = rt.get(count_args.remote(*refs))
        call_s = time.perf_counter() - t0
        assert got == args_n, got
        return {"n": args_n, "put_s": round(put_s, 2),
                "call_s": round(call_s, 2),
                "total_s": round(put_s + call_s, 2)}

    def row_returns():
        many = rt.remote(num_cpus=0, num_returns=returns_n)(
            lambda: tuple(range(returns_n))
        )
        t0 = time.perf_counter()
        refs = many.remote()
        vals = rt.get(list(refs))
        dt = time.perf_counter() - t0
        assert vals[0] == 0 and vals[-1] == returns_n - 1
        return {"n": returns_n, "total_s": round(dt, 2)}

    def row_get():
        refs = [rt.put(i) for i in range(get_n)]
        t0 = time.perf_counter()
        vals = rt.get(refs)
        dt = time.perf_counter() - t0
        assert vals[-1] == get_n - 1
        return {"n": get_n, "get_s": round(dt, 2)}

    def row_queue():
        noop = rt.remote(num_cpus=0.001)(_small_value)
        shards_before = _shard_snapshot()
        t0 = time.perf_counter()
        refs = [noop.remote() for _ in range(queue_n)]
        submit_s = time.perf_counter() - t0
        rss_peak = _rss_gb()
        t0 = time.perf_counter()
        step = 10_000
        for i in range(0, queue_n, step):
            rt.get(refs[i:i + step])
        drain_s = time.perf_counter() - t0
        out = {"n": queue_n, "submit_s": round(submit_s, 2),
               "submit_per_s": round(queue_n / submit_s, 1),
               "drain_s": round(drain_s, 2),
               "tasks_per_s": round(queue_n / (submit_s + drain_s), 1),
               "driver_rss_gb": round(rss_peak, 2)}
        shard_rows = owner_shard_report(shards_before, _shard_snapshot())
        if len(shard_rows) > 1 or shard_rows[0]["completed"]:
            out["owner_shards"] = shard_rows
        return out

    def row_large():
        n = int(large_gb * (1 << 30))
        # zeros: source pages stay the kernel zero page until written,
        # so the numpy side costs ~nothing — the shm copy is the cost
        arr = np.zeros(n, dtype=np.uint8)
        arr[0], arr[-1] = 7, 9  # corners prove round-trip integrity
        t0 = time.perf_counter()
        ref = rt.put(arr)
        put_s = time.perf_counter() - t0
        del arr
        t0 = time.perf_counter()
        got = rt.get(ref)
        get_s = time.perf_counter() - t0
        assert got[0] == 7 and got[-1] == 9 and got.nbytes == n
        del got, ref
        return {"gib": large_gb, "put_s": round(put_s, 2),
                "get_s": round(get_s, 2),
                "put_gb_per_s": round(large_gb / put_s, 2),
                "get_gb_per_s": round(large_gb / max(get_s, 1e-9), 2)}

    _row("args", row_args)
    _row("returns", row_returns)
    _row("get", row_get)
    _row("queue", row_queue)
    _row("large", row_large)
    return out


def measure_envelope_broadcast(n_nodes: int = 4, size_gb: float = 1.0,
                               workers_per_node: int = 1) -> Dict[str, float]:
    """1 GiB object broadcast to every node of a local multi-node
    cluster (reference: `object_store.json` 1 GiB x 50 nodes over the
    network; here the nodes share a host, so this measures the chunked
    daemon-to-daemon transfer path, fan-out dedup included).  Owns its
    cluster: call with no runtime initialized."""
    import ray_tpu_torch as rt_mod
    from ray_tpu_torch.cluster_utils import Cluster

    if rt_mod.is_initialized():
        raise RuntimeError(
            "envelope broadcast owns its cluster: call with no "
            "runtime initialized"
        )
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2, "num_workers": 1})
    c.connect()
    try:
        for i in range(n_nodes):
            c.add_node(num_cpus=2, resources={f"bn{i}": 1},
                       num_workers=workers_per_node)
        c.wait_for_nodes()
        checksum = rt_mod.remote(num_cpus=0)(_envelope_checksum)
        n = int(size_gb * (1 << 30))
        arr = np.zeros(n, dtype=np.uint8)
        arr[0], arr[-1] = 3, 5
        ref = rt_mod.put(arr)
        del arr
        t0 = time.perf_counter()
        outs = rt_mod.get([
            checksum.options(resources={f"bn{i}": 1}).remote(ref)
            for i in range(n_nodes)
        ])
        dt = time.perf_counter() - t0
        assert all(o == (3, 5, n) for o in outs), outs
        return {"nodes": n_nodes, "gib": size_gb,
                "broadcast_s": round(dt, 2),
                "aggregate_gb_per_s": round(n_nodes * size_gb / dt, 2)}
    finally:
        c.shutdown()


# ----------------------------------------------------------------------
# serve LLM engine: paged-KV tick trace + CB smoke (tiny model)
# ----------------------------------------------------------------------
def _engine_run(eng, prompts, n_new: int) -> Dict[str, float]:
    """Drive one engine through a closed workload; returns tok/s plus
    the engine's per-tick counters — as DELTAS over the engine's state
    at entry, so a warm-up run's work never inflates a measured row."""
    base = eng.stats()
    futs = [eng.submit(p, n_new) for p in prompts]
    t0 = time.perf_counter()
    for f in futs:
        f.result(timeout=600)
    wall = time.perf_counter() - t0
    s = eng.stats()
    hit = s["prefix_hit_tokens"] - base["prefix_hit_tokens"]
    filled = s["prefill_tokens"] - base["prefill_tokens"]
    return {
        "tokens_per_sec": round(len(prompts) * n_new / wall, 1),
        "wall_s": round(wall, 3),
        "ticks": s["ticks"] - base["ticks"],
        "tick_ema_ms": round(s["tick_ema_s"] * 1e3, 2),
        "gather_blocks": s["gather_blocks"],
        "prefill_calls": s["prefill_calls"] - base["prefill_calls"],
        "prefill_tokens": filled,
        "prefix_hit_tokens": hit,
        "prefix_hit_rate": round(
            hit / (hit + filled) if hit + filled else 0.0, 3
        ),
        "ttft_ema_ms": round(s["ttft_ema_s"] * 1e3, 1),
    }


def measure_engine_trace(*, requests: int = 24, n_new: int = 8,
                         seed: int = 0, device=None
                         ) -> Dict[str, Dict[str, float]]:
    """Paged-KV acceptance rows on the tiny model (the per-chip
    claims, measured without the serve stack in the way), its engines
    on `device` (None: the card):

    - `sized` vs `overprovisioned`: the same workload on a
      workload-sized KV budget vs a ~1024-token budget.  With the old
      per-slot ring, over-provisioning was a ~20x per-step tax
      (PERF.md); with paged blocks the gather width tracks LIVE tokens,
      so the two rows must run the same compiled programs (equal
      `gather_blocks`) at near-equal throughput.
    - `prefix_on` vs `prefix_off`: a shared-system-prompt workload with
      the radix cache on/off — cached requests skip the shared
      prefill, visible as fewer prefilled tokens and a lower TTFT.
    - `serve_llm_cb_smoke`: the continuous-batching hot path's tok/s —
      the tier-1 regression canary (`tests/test_perf_harness.py`).
    """
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=256)
    params = llama.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, float]] = {}

    # -- pool-budget invariance (prompt 24 + 8 new = 32 live tokens) --
    bs = 8  # engine block_size for every row below
    prompts = [
        [int(x) for x in rng.integers(1, cfg.vocab_size, size=24)]
        for _ in range(requests)
    ]
    for name, kw in (
        ("sized", dict(max_len=48, kv_blocks=4 * 48 // bs)),
        ("overprovisioned", dict(max_len=120, kv_blocks=1024 // bs)),
    ):
        eng = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=bs,
                          prefix_cache=False, device=device, **kw)
        try:
            _engine_run(eng, prompts[:4], n_new)  # warm compiles
            out[name] = _engine_run(eng, prompts, n_new)
            out[name]["kv_budget_tokens"] = kw["kv_blocks"] * bs
        finally:
            eng.shutdown()
        print(f"engine[{name}]: " + ", ".join(
            f"{k}={v}" for k, v in out[name].items()), flush=True)

    # -- radix prefix reuse (shared 16-token system prompt) -----------
    system = [int(x) for x in rng.integers(1, cfg.vocab_size, size=16)]
    shared_prompts = [
        system + [int(x) for x in rng.integers(1, cfg.vocab_size, size=6)]
        for _ in range(requests)
    ]
    for name, pc in (("prefix_on", True), ("prefix_off", False)):
        eng = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=bs,
                          max_len=48, prefix_cache=pc, device=device)
        try:
            _engine_run(eng, shared_prompts[:2], n_new)  # warm compiles
            out[name] = _engine_run(eng, shared_prompts, n_new)
        finally:
            eng.shutdown()
        print(f"engine[{name}]: " + ", ".join(
            f"{k}={v}" for k, v in out[name].items()), flush=True)

    # -- CB smoke: the default-config hot path, one number ------------
    eng = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=bs,
                      max_len=48, device=device)
    try:
        # warm both prefill paths: the repeated prompt takes the radix
        # suffix-prefill route, so its compile stays out of the timing
        _engine_run(eng, prompts[:4] + prompts[:1], n_new)
        out["serve_llm_cb_smoke"] = _engine_run(eng, prompts, n_new)
    finally:
        eng.shutdown()
    print("engine[serve_llm_cb_smoke]: " + ", ".join(
        f"{k}={v}" for k, v in out["serve_llm_cb_smoke"].items()),
        flush=True)
    return out


def measure_decode_kernel(*, batches=(16, 32, 64), n_new: int = 8,
                          seed: int = 0, device=None
                          ) -> Dict[str, Dict[str, float]]:
    """Bare-decode rows for the fused paged-attention kernel
    (`ops/paged_attention.py`) vs the gather+`decode_step_vec`
    reference route, plus the int8 pool-occupancy row.

    - `decode_b{B}_{kernel,gather}`: the same short-prompt workload at
      batch B through each decode route; the dispatch counters prove
      which plane actually ran (kernel rows must show zero fallback
      ticks and `gather_blocks == 0` growth on the decode hot loop).
    - `kv_pool_occupancy`: payload bytes of an int8 pool vs the bf16
      pool at the SAME block budget — the int8 row must sit at half,
      with the f32 scale sidecar priced separately.

    The engines run on `device` (None: the card).  On the CPU the
    kernel route dispatches the kernels' plain PyTorch versions, so CPU
    tok/s compares two eager routes — the rows are structural evidence
    (kernel route dispatched, gather plane dead), not a speed claim.
    On the card the kernel route launches the fused K5 + K6 op from
    the chunk's CUDA graph, and the same rows are the perf claim.
    """
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=256)
    params = llama.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, float]] = {}
    bs = 8   # engine block_size
    plen = 8  # short prompts: decode ticks dominate the trace
    for b in batches:
        prompts = [
            [int(x) for x in rng.integers(1, cfg.vocab_size, size=plen)]
            for _ in range(b)
        ]
        for mode in ("kernel", "gather"):
            eng = LlamaEngine(cfg, params, slots=b, chunk=4,
                              block_size=bs, max_len=plen + n_new + 2,
                              prefix_cache=False, decode_kernel=mode,
                              device=device)
            name = f"decode_b{b}_{mode}"
            try:
                _engine_run(eng, prompts[: max(1, b // 4)], n_new)
                out[name] = _engine_run(eng, prompts, n_new)
                s = eng.stats()
                out[name]["decode_kernel"] = s["decode_kernel"]
                out[name]["kernel_ticks"] = (
                    s["decode_kernel_dispatch_total"])
                out[name]["fallback_ticks"] = (
                    s["decode_fallback_dispatch_total"])
            finally:
                eng.shutdown()
            print(f"decode[{name}]: " + ", ".join(
                f"{k}={v}" for k, v in out[name].items()), flush=True)

    # -- int8 vs bf16 pool occupancy at equal block budget ------------
    occ: Dict[str, float] = {}
    for name, kvd in (("fp", "model"), ("int8", "int8")):
        eng = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=bs,
                          max_len=plen + n_new + 2, kv_blocks=64,
                          prefix_cache=False, kv_dtype=kvd, device=device)
        try:
            s = eng.stats()
            occ[f"kv_pool_bytes_{name}"] = s["kv_pool_bytes"]
            occ[f"kv_scale_bytes_{name}"] = s["kv_scale_bytes"]
        finally:
            eng.shutdown()
    occ["int8_payload_ratio"] = round(
        occ["kv_pool_bytes_int8"] / occ["kv_pool_bytes_fp"], 3)
    out["kv_pool_occupancy"] = occ
    print("decode[kv_pool_occupancy]: " + ", ".join(
        f"{k}={v}" for k, v in occ.items()), flush=True)
    return out


def measure_overload(*, overflow: int = 12, seed: int = 0, device=None
                     ) -> Dict[str, Dict[str, float]]:
    """Overload-plane acceptance rows on the tiny engine, on `device`
    (None: the card) (admission control + deadline shedding, no serve
    stack in the way):

    - `overload_storm`: one bounded-queue engine (4 slots, queue cap
      8) saturated with long decodes, then hit with an expired-budget
      wave (must SHED before prefill) and an overflow wave (must be
      REJECTED with a retry-after hint).  Accounting is exact:
      offered == admitted + rejected + shed, the queue never exceeds
      its cap, and the block pool returns to its pre-storm free count.
    - `overload_ttft`: closed-loop 2x overload (2*slots in flight,
      n_new=1 so completion == first token): TTFT p50/p99 under
      sustained queueing.
    """
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=256)
    params = llama.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    slots, queue_cap, bs = 4, 8, 8
    out: Dict[str, Dict[str, float]] = {}

    def _prompt():
        return [int(x) for x in rng.integers(1, cfg.vocab_size, size=24)]

    eng = LlamaEngine(cfg, params, slots=slots, chunk=4, block_size=bs,
                      max_len=48, prefix_cache=False,
                      max_queued=queue_cap, device=device)
    try:
        # warm both compiled families (prefill bucket, chunk width)
        for f in [eng.submit(_prompt(), 8) for _ in range(slots)]:
            f.result(timeout=600)
        base = eng.stats()
        free0 = base["blocks_free"]
        t0 = time.perf_counter()
        # phase 1 — saturate every slot with a LONG decode (>= 6 chunk
        # dispatches), so nothing else can be admitted until they end
        long_futs = [eng.submit(_prompt(), 20) for _ in range(slots)]
        deadline = time.monotonic() + 60
        while eng.stats()["free_slots"] > 0:
            if time.monotonic() > deadline:
                raise RuntimeError("engine never saturated")
            time.sleep(0.001)
        # phase 2 — a wave with a ~zero budget: it QUEUES (the cap has
        # room) but every slot is busy for many chunk walls, so by pop
        # time the deadline is long past -> shed before prefill
        shed_futs = [eng.submit(_prompt(), 8, timeout_s=0.001)
                     for _ in range(6)]
        # phase 3 — overflow: more work than the queue cap can hold
        over_futs = [eng.submit(_prompt(), 8) for _ in range(overflow)]
        queue_peak = 0.0
        waves = long_futs + shed_futs + over_futs
        while not all(f.done() for f in waves):
            queue_peak = max(queue_peak, eng.stats()["queued"])
            time.sleep(0.002)
        wall = time.perf_counter() - t0
        admitted = rejected = shed = 0
        admitted_tokens = 0
        for f in waves:
            try:
                admitted_tokens += len(f.result(timeout=60))
                admitted += 1
            except exc.BackPressureError as e:
                assert e.retry_after_s > 0
                rejected += 1
            except exc.DeadlineExceededError:
                shed += 1
        s = eng.stats()
        out["overload_storm"] = {
            "offered": float(len(waves)),
            "admitted": float(admitted),
            "rejected": float(rejected),
            "shed": float(shed),
            "shed_expired": s["shed_expired"] - base["shed_expired"],
            "shed_predicted": (s["shed_predicted"]
                               - base["shed_predicted"]),
            "queue_cap": float(queue_cap),
            "queue_peak": queue_peak,
            "blocks_free_delta": float(s["blocks_free"] - free0),
            "prefill_calls": s["prefill_calls"] - base["prefill_calls"],
            "wall_s": round(wall, 3),
            "admitted_tok_s": round(admitted_tokens / wall, 1),
        }
        print("overload[storm]: " + ", ".join(
            f"{k}={v}" for k, v in out["overload_storm"].items()),
            flush=True)

        # -- TTFT under sustained 2x overload -------------------------
        target, conc = 32, 2 * slots
        lat: List[float] = []
        inflight: List[tuple] = []
        submitted = 0
        t0 = time.perf_counter()
        while len(lat) < target:
            while submitted < target and len(inflight) < conc:
                inflight.append((time.perf_counter(),
                                 eng.submit(_prompt(), 1)))
                submitted += 1
            t_s, f = inflight.pop(0)
            f.result(timeout=600)
            lat.append(time.perf_counter() - t_s)
        wall = time.perf_counter() - t0
        out["overload_ttft"] = {
            "requests": float(target),
            "concurrency": float(conc),
            "ttft_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
            "ttft_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
            "tok_s": round(target / wall, 1),
        }
        print("overload[ttft]: " + ", ".join(
            f"{k}={v}" for k, v in out["overload_ttft"].items()),
            flush=True)
    finally:
        eng.shutdown()
    return out


def _elastic_mttr_loop(config):
    """Per-worker loop for `--elastic-recovery`: pure control-plane
    (no torch) so the measured MTTR is detection + re-form + restore,
    not model compile time.  Rank 1 SIGKILLs itself mid-step on the
    first attempt, recording the kill instant for the driver."""
    import os as _os
    import signal as _signal

    from ray_tpu_torch import train as rtrain
    from ray_tpu_torch.train.checkpoint import Checkpoint as _Ck

    ctx = rtrain.get_context()
    ck = rtrain.get_checkpoint()
    start = ck.to_dict()["step"] + 1 if ck is not None else 0
    for step in range(start, config["num_steps"]):
        if (ck is None and step == config["kill_at"]
                and ctx.get_world_rank() == 1):
            with open(config["kill_marker"], "w") as f:
                f.write(repr(time.time()))
            _os.kill(_os.getpid(), _signal.SIGKILL)
        c = (_Ck.from_dict({"step": step})
             if ctx.get_world_rank() == 0 else None)
        rtrain.report({"step": step, "world": ctx.get_world_size()},
                      checkpoint=c)


def measure_elastic_recovery(*, num_workers: int = 2, num_steps: int = 12,
                             kill_at: int = 4) -> Dict[str, Dict[str, float]]:
    """MTTR for elastic preemption recovery (docs/elastic_training.md):
    SIGKILL one training rank mid-step and measure, on the wall clock,

    - `detect_s`: kill → the health plane marking the rank lost;
    - `mttr_s`:   kill → the FIRST post-recovery step reported by the
      re-formed group (detection + drain + re-reserve + actor boot +
      checkpoint restore);
    - `resume_step` == the checkpointed step (no lost progress beyond
      the in-flight step).

    The structural shape of these rows is tier-1-gated
    (`tests/test_perf_harness.py`); the measured numbers live in
    PERF.md."""
    import tempfile

    from ray_tpu_torch.train import (
        CudaConfig, CudaTrainer, FailureConfig, RunConfig, ScalingConfig,
    )

    workdir = tempfile.mkdtemp(prefix="rt_elastic_mttr_")
    kill_marker = os.path.join(workdir, "kill_ts")
    reports: List[Dict[str, float]] = []
    trainer = CudaTrainer(
        _elastic_mttr_loop,
        train_loop_config={
            "num_steps": num_steps, "kill_at": kill_at,
            "kill_marker": kill_marker,
        },
        cuda_config=CudaConfig(distributed_mode="none"),
        scaling_config=ScalingConfig(num_workers=num_workers),
        run_config=RunConfig(
            storage_path=workdir, name="elastic_mttr",
            failure_config=FailureConfig(
                elastic=True, min_workers=1, detect_poll_s=0.2,
                drain_timeout_s=3.0, reform_timeout_s=10.0,
            ),
        ),
    )
    trainer._result_callback = lambda m, ck: reports.append(
        {"step": m["step"], "wall": time.time()}
    )
    if num_workers < 2:
        raise ValueError(
            "--elastic-workers must be >= 2: the harness SIGKILLs "
            "rank 1, which does not exist in a 1-worker group"
        )
    result = trainer.fit()
    if result.error is not None:
        raise RuntimeError(f"elastic recovery run failed: {result.error}")
    shrinks = [e for e in trainer._elastic_events if e["kind"] == "shrink"]
    reforms = [e for e in trainer._elastic_events if e["kind"] == "reform"]
    if not shrinks or not reforms or not os.path.exists(kill_marker):
        raise RuntimeError(
            "elastic recovery run exercised no failover (events: "
            f"{trainer._elastic_events}) — nothing to measure"
        )
    with open(kill_marker) as f:
        kill_wall = float(f.read())
    shrink, reform = shrinks[0], reforms[0]
    # the resumed step re-reports the checkpointed step + 1: the first
    # report after the reform event is the first post-recovery step
    post = [r for r in reports if r["wall"] >= reform["wall"]]
    resume_step = post[0]["step"] if post else -1
    row = {
        "detect_s": round(shrink["detected_wall"] - kill_wall, 3),
        "mttr_s": round(post[0]["wall"] - kill_wall, 3) if post else -1.0,
        "reform_s": round(reform["wall"] - shrink["detected_wall"], 3),
        "kill_step": float(kill_at),
        "resume_step": float(resume_step),
        "final_step": float(result.metrics["step"]),
        "failovers": float(sum(1 for e in trainer._elastic_events
                               if e["kind"] == "shrink")),
        "reform_width": float(reform["width"]),
    }
    print("elastic_recovery: " + ", ".join(
        f"{k}={v}" for k, v in row.items()), flush=True)
    return {"elastic_recovery": row}


class _DagPerfWorker:
    """Module-level so the actor class pickles by reference."""

    def double(self, x):
        return 2 * x


def measure_dag_calls(*, n: int = 2000, tensor_mb: float = 4.0,
                      num_workers: int = 2
                      ) -> Dict[str, Dict[str, float]]:
    """`--config dag_calls`: the compiled-DAG fast plane vs the 1:1
    actor-call plane, measured head-to-head in one cluster:

    - actor_us_per_call: rt.get(actor.method.remote(x)) round trip —
      the full submit/lease/complete machinery per call;
    - dag_us_per_call: compiled execute(x).get() round trip — channel
      ops only (the resident exec loop bypasses the RPC plane);
    - tensor_inline_mb_s / tensor_spill_mb_s: one-way tensor-channel
      bandwidth for a slot-sized array and a spill-path array (raw
      buffer bytes, no pickle).

    Structural shape tier-1-gated in tests/test_perf_harness.py;
    measured numbers live in PERF.md."""
    import numpy as np

    import ray_tpu_torch as rt

    if rt.is_initialized():
        raise RuntimeError(
            "--config dag_calls boots its own cluster: run with no "
            "runtime initialized"
        )
    rt.init(num_workers=num_workers, num_cpus=8)
    try:
        from ray_tpu_torch.dag import InputNode
        from ray_tpu_torch.dag.channel import Channel

        w = rt.remote(_DagPerfWorker).remote()
        rt.get(w.double.remote(0))  # warm the lease + worker
        t0 = time.perf_counter()
        for i in range(n):
            rt.get(w.double.remote(i))
        actor_s = time.perf_counter() - t0

        with InputNode() as inp:
            dag = w.double.bind(inp)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(1).get() == 2  # warm the channels
            t0 = time.perf_counter()
            for i in range(n):
                compiled.execute(i).get()
            dag_s = time.perf_counter() - t0
        finally:
            compiled.teardown()

        def chan_bw(name: str, arr) -> float:
            ch = Channel(name)
            reps = max(4, int(64 * 1024 * 1024 / max(1, arr.nbytes)))
            ch.write(arr)
            assert ch.read(timeout_s=30).shape == arr.shape  # warm
            t0 = time.perf_counter()
            for _ in range(reps):
                ch.write(arr)
                ch.read(timeout_s=30)
            wall = time.perf_counter() - t0
            ch.destroy()
            return (reps * arr.nbytes) / wall / 1e6

        inline = np.zeros(64 * 1024 // 4, np.float32)  # fits one slot
        spill = np.zeros(int(tensor_mb * 1024 * 1024 / 4), np.float32)
        row = {
            "calls": float(n),
            "actor_us_per_call": 1e6 * actor_s / n,
            "dag_us_per_call": 1e6 * dag_s / n,
            "speedup": actor_s / dag_s,
            "tensor_inline_mb_s": chan_bw("perf_dag_inline", inline),
            "tensor_spill_mb_s": chan_bw("perf_dag_spill", spill),
        }
        print(
            f"dag_calls: actor {row['actor_us_per_call']:.1f} us/call, "
            f"compiled {row['dag_us_per_call']:.1f} us/call "
            f"({row['speedup']:.1f}x), tensor chan "
            f"{row['tensor_inline_mb_s']:.0f} MB/s inline / "
            f"{row['tensor_spill_mb_s']:.0f} MB/s spill",
            flush=True,
        )
        return {"dag_calls": row}
    finally:
        rt.shutdown()


def measure_data_shuffle(*, rows: int = 3_200_000,
                         store_mb: int = 12,
                         integrity: str = "on"
                         ) -> Dict[str, Dict[str, float]]:
    """`--config data_shuffle`: throughput of a repartition+sort
    exchange over a dataset ~2x the object-store budget — the
    distributed shuffle must complete THROUGH the spilling plane
    (pinned in-flight bytes bounded by the store-aware stage budget,
    `data/shuffle.py`), with exact row accounting.  Structural shape
    tier-1-gated in `tests/test_perf_harness.py`; measured numbers
    live in PERF.md.

    `integrity` gates the object-plane checksum plane (spill-time CRC
    + verify-on-restore, `core/integrity.py`): "on" (the default) or
    "off" — run both and compare to measure the spill-path checksum
    overhead honestly (the ≤5% budget claim in PERF.md)."""
    import glob

    import numpy as np

    import ray_tpu_torch as rt
    import ray_tpu_torch.api as api
    import ray_tpu_torch.data as rd

    if rt.is_initialized():
        raise RuntimeError(
            "--config data_shuffle sizes its own object store: run "
            "with no runtime initialized"
        )
    store_bytes = store_mb * 1024 * 1024
    dataset_bytes = rows * 8  # one int64 column
    # the spill path lives in the DAEMON: the knob must ride the env
    prior_integrity = os.environ.get("RTT_OBJECT_INTEGRITY")
    os.environ["RTT_OBJECT_INTEGRITY"] = (
        "1" if integrity != "off" else "0"
    )
    rt.init(num_workers=2, num_cpus=4, object_store_memory=store_bytes)
    try:
        ds = rd.range(rows, parallelism=12).repartition(8).sort(
            "id", descending=True
        )
        t0 = time.perf_counter()
        total = 0
        checksum = 0
        ordered = True
        prev = None
        for batch in ds.iter_batches(batch_size=200_000):
            ids = batch["id"]
            total += len(ids)
            checksum += int(ids.sum())
            if np.any(np.diff(ids) > 0) or (
                prev is not None and ids[0] > prev
            ):
                ordered = False
            prev = int(ids[-1])
        elapsed = time.perf_counter() - t0
        sd = api._session.get("session_dir")
        spill_bytes = sum(
            os.path.getsize(f) for f in glob.glob(f"{sd}/spilled/*.bin")
        )
        row = {
            "rows": float(rows),
            "rows_per_s": round(total / elapsed, 1),
            "elapsed_s": round(elapsed, 3),
            "dataset_bytes": float(dataset_bytes),
            "store_bytes": float(store_bytes),
            "store_ratio": round(dataset_bytes / store_bytes, 2),
            "spill_bytes": float(spill_bytes),
            "rows_out": float(total),
            "rows_exact": float(
                total == rows and checksum == rows * (rows - 1) // 2
            ),
            "globally_sorted": float(ordered),
            "integrity_on": float(integrity != "off"),
        }
    finally:
        rt.shutdown()
        if prior_integrity is None:
            os.environ.pop("RTT_OBJECT_INTEGRITY", None)
        else:
            os.environ["RTT_OBJECT_INTEGRITY"] = prior_integrity
    key = ("data_shuffle" if integrity != "off"
           else "data_shuffle_integrity_off")
    print(f"{key}: " + ", ".join(
        f"{k}={v}" for k, v in row.items()), flush=True)
    return {key: row}


def measure_storage_faults(*, rows: int = 2_000_000, store_mb: int = 8,
                           seed: int = 1313
                           ) -> Dict[str, Dict[str, float]]:
    """`--config storage_faults`: the chaos-matrix row — a seeded
    schedule of bit-flip + ENOSPC + EIO disk faults injected at the
    `core/diskio.py` chokepoint under a repartition+sort epoch of a
    dataset ~2x the object store.  The epoch must complete with EXACT
    row accounting despite corrupt spilled files (quarantine + lineage
    re-derivation) and intermittently refused/failing spill I/O
    (un-election + restore retries + typed backpressure clamps).

    The fault schedule is fully determined by `seed` (replay a failure
    with `--storage-faults-seed <seed>` — the seed is printed on every
    run and embedded in the assertion message on failure).  Structural
    shape tier-1-gated in `tests/test_perf_harness.py`."""
    import urllib.request

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd

    if rt.is_initialized():
        raise RuntimeError(
            "--config storage_faults sizes its own object store and "
            "fault schedule: run with no runtime initialized"
        )
    chaos = {
        # every ~2nd spilled file silently corrupted; restores verify,
        # quarantine, and fall through to lineage
        "bit_flip_prob": 0.5,
        # transient device errors on the spill plane (reads retry
        # through the backoff schedule; writes un-elect)
        "eio_prob": 0.25,
        # occasional disk-full refusals (pass aborts + latch clears
        # when a later free-bytes check passes)
        "enospc_prob": 0.1,
        "match": "spilled",
        "seed": int(seed),
    }
    print(f"storage_faults: seed={seed} chaos={chaos}", flush=True)
    prior = os.environ.get("RTT_DISK_CHAOS")
    os.environ["RTT_DISK_CHAOS"] = json.dumps(chaos)
    from ray_tpu_torch.core import diskio as _diskio

    _diskio.set_disk_chaos(None)
    _diskio._chaos_env_checked = False
    store_bytes = store_mb * 1024 * 1024
    try:
        rt.init(num_workers=2, num_cpus=4,
                object_store_memory=store_bytes,
                _system_config={"metrics_http_port": -1})
        t0 = time.perf_counter()
        ds = rd.range(rows, parallelism=10).repartition(6).sort(
            "id", descending=True
        )
        total = 0
        checksum = 0
        for batch in ds.iter_batches(batch_size=250_000):
            ids = batch["id"]
            total += len(ids)
            checksum += int(ids.sum())
        elapsed = time.perf_counter() - t0
        # fault evidence from the daemon's /metrics (fault counters
        # bypass the metrics_enabled gate)
        counters: Dict[str, float] = {}
        from ray_tpu_torch.core.runtime import get_runtime

        for n in get_runtime().controller_call("get_nodes"):
            port = n.get("metrics_port")
            if not n.get("alive") or not port:
                continue
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=15
            ) as r:
                for line in r.read().decode().splitlines():
                    for m in ("rt_object_integrity_errors_total",
                              "rt_object_quarantined_total",
                              "rt_spill_disk_full_total",
                              "rt_spill_errors_total"):
                        if line.startswith(m):
                            counters[m] = counters.get(m, 0.0) + float(
                                line.rsplit(" ", 1)[1]
                            )
        rows_exact = (total == rows
                      and checksum == rows * (rows - 1) // 2)
        assert rows_exact, (
            f"storage_faults row accounting broke under the fault "
            f"schedule: rows_out={total} (expected {rows}); replay "
            f"with --storage-faults-seed {seed}"
        )
        row = {
            "rows": float(rows),
            "rows_per_s": round(total / elapsed, 1),
            "elapsed_s": round(elapsed, 3),
            "store_ratio": round(rows * 8 / store_bytes, 2),
            "rows_exact": 1.0,
            "seed": float(seed),
            "integrity_errors": counters.get(
                "rt_object_integrity_errors_total", 0.0),
            "quarantined": counters.get(
                "rt_object_quarantined_total", 0.0),
            "spill_disk_full": counters.get(
                "rt_spill_disk_full_total", 0.0),
            "spill_io_errors": counters.get(
                "rt_spill_errors_total", 0.0),
        }
    finally:
        rt.shutdown()
        if prior is None:
            os.environ.pop("RTT_DISK_CHAOS", None)
        else:
            os.environ["RTT_DISK_CHAOS"] = prior
        _diskio.set_disk_chaos(None)
    print("storage_faults: " + ", ".join(
        f"{k}={v}" for k, v in row.items()), flush=True)
    return {"storage_faults": row}


def _abba(rounds: int) -> List[bool]:
    """The 'on' flags of `rounds` off/on rounds in ABBA order (off, on,
    on, off, ...): a load that drifts across the rounds weighs on both
    groups alike, where off-then-on every round gives it to 'on'."""
    return [on for i in range(rounds)
            for on in ((False, True) if i % 2 == 0 else (True, False))]


def _fastest_overhead(off: List[float], on: List[float]) -> float:
    """The 'on' group's cost in % of the 'off' group's throughput, each
    group read by its fastest storm: on a shared host other load only
    ever slows a storm, so the fastest is the least disturbed, where the
    median of two rounds is their mean and one stalled storm (6.5x
    slower beside a parallel test run) carried it past any budget."""
    return round(100.0 * (1.0 - max(on) / max(off)), 2)


def measure_obs_overhead(*, storm_n: int = 3000, rounds: int = 6,
                         num_workers: int = 2) -> Dict[str, Dict[str, float]]:
    """`--config obs_overhead`: throughput cost of the unified
    observability plane on the task-storm hot path.

    Methodology — alternating in-cluster A/B, fastest storms compared: the
    storm benchmark's variance is large (cluster-to-cluster ±3-5%,
    storm-to-storm inside one cluster ±10% — an off-vs-off control
    shows a ±4% phantom 'overhead'), which no single comparison can
    resolve against a 3% budget.  One cluster boots with
    `RTT_METRICS_ENABLED=1` propagated to every process, so the batched
    reporting loops (driver/worker/daemon obs frames, store-gauge
    refresh) run for the WHOLE measurement as constant background;
    after two full-size warm storms, `rounds` alternating off/on
    storms run with the driver-side gate flipped between them — every
    per-task instrumented path (owner submit counter, completion
    counter + latency histogram, lease metrics, obs-frame assembly)
    lives in the driver, so the gate isolates exactly the per-task
    cost, alternation cancels drift, and comparing each group's FASTEST
    storm drops the stalled ones.  The 'on' phases self-validate
    that instrumentation actually fired (the completion counter grows
    by at least the storm size), so the number can never silently
    measure a disabled plane.  Structural shape tier-1-gated in
    `tests/test_perf_harness.py`; the measured <3% budget claim lives
    in PERF.md."""
    import statistics as _stats

    import ray_tpu_torch as rt
    from ray_tpu_torch.metrics import metric_defs as _md

    if rt.is_initialized():
        raise RuntimeError(
            "--config obs_overhead boots its own cluster: run with "
            "no runtime initialized"
        )

    def _completed() -> float:
        return sum(v for _, v in _md.metric(
            "rt_owner_tasks_completed_total")._samples())

    prior_env = os.environ.get("RTT_METRICS_ENABLED")
    _md.set_enabled(True)  # children inherit: reporting loops run
    rt.init(num_workers=num_workers,
            num_cpus=max(8, 2 * num_workers),
            _system_config={"metrics_enabled": True})
    off_tps: List[float] = []
    on_tps: List[float] = []
    instrumented = True
    try:
        # two FULL-SIZE warm storms: the first storms of a fresh
        # cluster run far from steady state (lease ramp, allocator)
        measure_task_storm(rt, n=storm_n)
        measure_task_storm(rt, n=storm_n)
        for on in _abba(rounds):
            _md.set_enabled(on)
            if not on:
                off_tps.append(
                    measure_task_storm(rt, n=storm_n)["tasks_per_s"])
                continue
            before = _completed()
            on_tps.append(measure_task_storm(rt, n=storm_n)["tasks_per_s"])
            instrumented &= (_completed() - before) >= storm_n
    finally:
        rt.shutdown()
        # restore BOTH halves of the gate: module flag to what the
        # caller's environment implies, then the env var itself (a
        # process started with the flag on must leave with it on)
        _md.set_enabled(prior_env in ("1", "true", "True"))
        if prior_env is not None:
            os.environ["RTT_METRICS_ENABLED"] = prior_env
    med_off = _stats.median(off_tps)
    med_on = _stats.median(on_tps)
    out: Dict[str, Dict[str, float]] = {
        "metrics_off": {
            "tasks_per_s": round(med_off, 1),
            "tasks_per_s_min": round(min(off_tps), 1),
            "tasks_per_s_max": round(max(off_tps), 1),
            "rounds": float(rounds), "storm_n": float(storm_n),
        },
        "metrics_on": {
            "tasks_per_s": round(med_on, 1),
            "tasks_per_s_min": round(min(on_tps), 1),
            "tasks_per_s_max": round(max(on_tps), 1),
            "rounds": float(rounds), "storm_n": float(storm_n),
            "instrumented": float(instrumented),
        },
        "obs_overhead": {
            "overhead_pct": _fastest_overhead(off_tps, on_tps),
            "metrics_off_tasks_per_s": round(max(off_tps), 1),
            "metrics_on_tasks_per_s": round(max(on_tps), 1),
            "instrumented": float(instrumented),
        },
    }
    for k in ("metrics_off", "metrics_on", "obs_overhead"):
        print(f"obs_overhead[{k}]: " + ", ".join(
            f"{kk}={vv}" for kk, vv in out[k].items()), flush=True)
    return out


def measure_serve_obs_overhead(*, requests: int = 24, n_new: int = 8,
                               rounds: int = 6, seed: int = 0,
                               device=None,
                               ) -> Dict[str, Dict[str, float]]:
    """The serve-path half of `--config obs_overhead`: throughput cost
    of the per-request ledger + phase histograms on the continuous-
    batching hot path (tiny model on `device`, None: the card;
    in-process engine, no cluster).

    Same alternating, fastest-storm methodology as the task-storm half: ONE
    engine serves every round, 'off' and 'on' storms alternate with the
    driver-side metrics gate flipped between them.  The driver loop is
    byte-identical in both phases — it always calls `start_request` and
    wraps the submit in `use_ledger` — so the gate alone decides the
    cost: gate down, `start_request` returns None and the engine's
    `engine_ticket()` returns None (the zero-allocation path the unit
    tests pin); gate up, every request carries a live ledger and the
    engine stamps admission/prefill/first-token/done onto its ticket,
    with phase histograms observed at finish.  The 'on' phases
    self-validate through the e2e histogram count (every storm request
    must land one observation — the row can never measure a disabled
    ledger).  Budget: <=2% on serve tok/s, recorded in PERF.md."""
    import statistics as _stats

    import torch

    from ray_tpu_torch.metrics import metric_defs as _md
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import request_ledger as _rl
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=256)
    params = llama.init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    prompts = [
        [int(x) for x in rng.integers(1, cfg.vocab_size, size=24)]
        for _ in range(requests)
    ]

    def _e2e_count() -> float:
        return sum(
            v for labels, v in
            _md.metric("rt_serve_e2e_seconds")._samples()
            if "__count__" in labels
        )

    def _storm(eng) -> float:
        futs = []
        ledgers = []
        t0 = time.perf_counter()
        for p in prompts:
            led = _rl.start_request("bench", "perf", "obs", replica="r0")
            with _rl.use_ledger(led):
                futs.append(eng.submit(list(p), n_new))
            ledgers.append(led)
        for f, led in zip(futs, ledgers):
            f.result(timeout=600)
            if led is not None:
                led.finish("ok")
        return requests * n_new / (time.perf_counter() - t0)

    prior_env = os.environ.get("RTT_METRICS_ENABLED")
    off_tps: List[float] = []
    on_tps: List[float] = []
    instrumented = True
    eng = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=8,
                      max_len=48, device=device)
    # on the CPU the tiny engine runs on one intra-op thread: its ops
    # gain nothing from a pool, and on a busy host the pool's barrier
    # waits, not the ledger, decided a storm's time (tokens/s swung 6x
    # between storms of one phase)
    threads = torch.get_num_threads()
    if eng.device.type == "cpu":
        torch.set_num_threads(1)
    try:
        _md.set_enabled(False)
        _storm(eng)  # warm compiles (both prefill routes stay warm)
        _storm(eng)
        for on in _abba(rounds):
            _md.set_enabled(on)
            if not on:
                off_tps.append(_storm(eng))
                continue
            before = _e2e_count()
            on_tps.append(_storm(eng))
            instrumented &= (_e2e_count() - before) >= requests
    finally:
        torch.set_num_threads(threads)
        eng.shutdown()
        _md.set_enabled(prior_env in ("1", "true", "True"))
        if prior_env is not None:
            os.environ["RTT_METRICS_ENABLED"] = prior_env
    med_off = _stats.median(off_tps)
    med_on = _stats.median(on_tps)
    out: Dict[str, Dict[str, float]] = {
        "serve_obs_off": {
            "tokens_per_sec": round(med_off, 1),
            "tokens_per_sec_min": round(min(off_tps), 1),
            "tokens_per_sec_max": round(max(off_tps), 1),
            "rounds": float(rounds), "requests": float(requests),
        },
        "serve_obs_on": {
            "tokens_per_sec": round(med_on, 1),
            "tokens_per_sec_min": round(min(on_tps), 1),
            "tokens_per_sec_max": round(max(on_tps), 1),
            "rounds": float(rounds), "requests": float(requests),
            "instrumented": float(instrumented),
        },
        "serve_obs_overhead": {
            "overhead_pct": _fastest_overhead(off_tps, on_tps),
            "ledger_off_tokens_per_sec": round(max(off_tps), 1),
            "ledger_on_tokens_per_sec": round(max(on_tps), 1),
            "instrumented": float(instrumented),
        },
    }
    for k in ("serve_obs_off", "serve_obs_on", "serve_obs_overhead"):
        print(f"obs_overhead[{k}]: " + ", ".join(
            f"{kk}={vv}" for kk, vv in out[k].items()), flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--filter", default=None, help="substring filter")
    p.add_argument("--json", default=None, help="write results to file")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--round-sec", type=float, default=1.0)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--storm", action="store_true",
                   help="also measure the 1k-task storm latency "
                        "distribution (scheduling throughput bound)")
    p.add_argument("--storm-n", type=int, default=1000)
    p.add_argument("--owner-shards", type=int, default=0,
                   help="driver-side owner shards (0 = config default; "
                        "N>1 runs N submission/completion loops keyed "
                        "by task id — docs/control_plane.md); storm and "
                        "envelope-queue rows report per-shard us/task")
    p.add_argument("--core-split", action="store_true",
                   help="task storm with per-plane CPU accounting + "
                        "multi-core pipeline projection")
    p.add_argument("--pin-cores", type=int, default=0,
                   help="pin driver/daemon/workers to dedicated cores "
                        "(needs a box with that many cores)")
    p.add_argument("--busbw", action="store_true",
                   help="also measure host ring-allreduce bus bandwidth")
    p.add_argument("--busbw-world", type=int, default=2)
    p.add_argument("--busbw-mb", type=int, default=16)
    p.add_argument("--engine-trace", action="store_true",
                   help="serve LLM engine tick-trace rows INSTEAD of "
                        "the matrix: paged-KV budget invariance, radix "
                        "prefix reuse, CB smoke (tiny model on --device; "
                        "no cluster)")
    p.add_argument("--engine-requests", type=int, default=24)
    p.add_argument("--overload", action="store_true",
                   help="overload-plane rows (no cluster): bounded-"
                        "queue storm accounting (offered vs admitted "
                        "vs rejected vs shed, block-pool leak check) "
                        "and TTFT p50/p99 under 2x overload")
    p.add_argument("--overload-overflow", type=int, default=12)
    p.add_argument("--elastic-recovery", action="store_true",
                   help="measure elastic-training MTTR: SIGKILL one "
                        "rank mid-step, report kill->detect and "
                        "kill->first-post-recovery-step latencies")
    p.add_argument("--elastic-workers", type=int, default=2)
    p.add_argument("--elastic-steps", type=int, default=12)
    p.add_argument("--config", default=None,
                   choices=["data_shuffle", "obs_overhead",
                            "storage_faults", "rllib_ppo", "dag_calls",
                            "decode_kernel"],
                   help="named measurement config (data_shuffle: "
                        "repartition+sort of a dataset ~2x the object "
                        "store, rows/s + spill bytes; obs_overhead: "
                        "task-storm throughput with the metrics plane "
                        "off vs on, overhead pct, plus the serve-path "
                        "A/B (request ledger + phase histograms on vs "
                        "off on the CB engine); storage_faults: the "
                        "same exchange under a seeded bit-flip + "
                        "ENOSPC + EIO disk-fault schedule, exact row "
                        "accounting + fault-counter evidence; "
                        "rllib_ppo: EnvRunner fleet -> learner gang "
                        "on --device with async overlap, env-steps/s + "
                        "updates/s + exactly-once ledger accounting; "
                        "dag_calls: compiled-DAG round trip vs the 1:1 "
                        "actor-call plane + tensor-channel MB/s; "
                        "decode_kernel: bare-decode fused paged-"
                        "attention kernel vs gather route at several "
                        "batch sizes + int8 vs bf16 pool occupancy)")
    p.add_argument("--decode-batches", default="16,32,64",
                   help="decode_kernel: comma-separated batch sizes")
    p.add_argument("--dag-calls-n", type=int, default=2000,
                   help="dag_calls: round trips per plane")
    p.add_argument("--dag-tensor-mb", type=float, default=4.0,
                   help="dag_calls: spill-path tensor size (MB)")
    p.add_argument("--rllib-runners", type=int, default=4)
    p.add_argument("--rllib-envs-per-runner", type=int, default=8)
    p.add_argument("--rllib-rollout-len", type=int, default=32)
    p.add_argument("--rllib-gang-devices", type=int, default=2)
    p.add_argument("--rllib-iters", type=int, default=3)
    p.add_argument("--shuffle-rows", type=int, default=3_200_000)
    p.add_argument("--shuffle-store-mb", type=int, default=12)
    p.add_argument("--shuffle-integrity", default="on",
                   choices=["on", "off", "both"],
                   help="object-plane checksums during data_shuffle; "
                        "'both' runs on-then-off for the overhead "
                        "comparison recorded in PERF.md")
    p.add_argument("--storage-faults-seed", type=int, default=1313,
                   help="replay seed for the storage_faults chaos "
                        "schedule (printed on every run)")
    p.add_argument("--storage-faults-rows", type=int, default=2_000_000)
    p.add_argument("--storage-faults-store-mb", type=int, default=8)
    p.add_argument("--obs-storm-n", type=int, default=3000)
    p.add_argument("--obs-rounds", type=int, default=6)
    p.add_argument("--obs-serve-requests", type=int, default=24,
                   help="obs_overhead: requests per serve-path A/B "
                        "storm (ledger+histograms on vs off on the "
                        "in-process CB engine)")
    p.add_argument("--envelope", action="store_true",
                   help="run the scalability-envelope rows INSTEAD of "
                        "the microbenchmark matrix (reference: "
                        "release/benchmarks/single_node)")
    p.add_argument("--envelope-rows", default="args,returns,get,queue,large",
                   help="comma list: args,returns,get,queue,large,broadcast")
    p.add_argument("--envelope-args-n", type=int, default=10_000)
    p.add_argument("--envelope-returns-n", type=int, default=3_000)
    p.add_argument("--envelope-get-n", type=int, default=10_000)
    p.add_argument("--envelope-queue-n", type=int, default=100_000)
    p.add_argument("--envelope-large-gb", type=float, default=50.0)
    p.add_argument("--envelope-bcast-nodes", type=int, default=4)
    p.add_argument("--envelope-bcast-gb", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="where the engine rows (--engine-trace, "
                        "--overload, decode_kernel, obs_overhead's serve "
                        "half) and rllib_ppo's learner run: 'cuda' "
                        "(default: the card, raising without one) or "
                        "'cpu'; the runtime rows use no device")
    args = p.parse_args(argv)

    # kill -USR1 <pid> dumps all thread stacks — the only way to see
    # where a wedged run is stuck on a box with no gdb/py-spy
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)

    if args.config == "data_shuffle":
        results = {}
        modes = (["on", "off"] if args.shuffle_integrity == "both"
                 else [args.shuffle_integrity])
        for mode in modes:
            results.update(measure_data_shuffle(
                rows=args.shuffle_rows, store_mb=args.shuffle_store_mb,
                integrity=mode,
            ))
        if len(modes) == 2:
            on = results["data_shuffle"]["rows_per_s"]
            off = results["data_shuffle_integrity_off"]["rows_per_s"]
            results["integrity_overhead"] = {
                "overhead_pct": round(100.0 * (1.0 - on / off), 2),
                "integrity_on_rows_per_s": on,
                "integrity_off_rows_per_s": off,
            }
            print("integrity_overhead: " + ", ".join(
                f"{k}={v}"
                for k, v in results["integrity_overhead"].items()
            ), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.config == "storage_faults":
        results = measure_storage_faults(
            rows=args.storage_faults_rows,
            store_mb=args.storage_faults_store_mb,
            seed=args.storage_faults_seed,
        )
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.config == "dag_calls":
        results = measure_dag_calls(
            n=args.dag_calls_n, tensor_mb=args.dag_tensor_mb,
            num_workers=args.num_workers,
        )
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.config == "rllib_ppo":
        from ray_tpu_torch.rllib.bench import measure_rllib_ppo

        results = measure_rllib_ppo(
            num_runners=args.rllib_runners,
            envs_per_runner=args.rllib_envs_per_runner,
            rollout_len=args.rllib_rollout_len,
            minibatch=max(
                64,
                args.rllib_envs_per_runner * args.rllib_rollout_len,
            ),
            gang_devices=args.rllib_gang_devices,
            iters=args.rllib_iters,
            compare_sync=False,
            device=args.device,
        )
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.config == "decode_kernel":
        # no cluster: engines are driven in-process on the local backend
        batches = tuple(
            int(x) for x in str(args.decode_batches).split(",") if x
        )
        results = measure_decode_kernel(batches=batches,
                                        device=args.device)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.config == "obs_overhead":
        results = measure_obs_overhead(
            storm_n=args.obs_storm_n, rounds=args.obs_rounds,
            num_workers=args.num_workers,
        )
        # serve-path half: runs after the cluster is down (in-process
        # engine, no runtime needed)
        results.update(measure_serve_obs_overhead(
            requests=args.obs_serve_requests, rounds=args.obs_rounds,
            device=args.device,
        ))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.engine_trace or args.overload:
        # no cluster: the engine is driven in-process on --device
        results = {}
        if args.engine_trace:
            results.update(measure_engine_trace(
                requests=args.engine_requests, device=args.device
            ))
        if args.overload:
            results.update(measure_overload(
                overflow=args.overload_overflow, device=args.device
            ))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    import ray_tpu_torch as rt

    sysconf = (
        {"owner_shards": args.owner_shards} if args.owner_shards else None
    )

    if args.elastic_recovery:
        owns = not rt.is_initialized()
        if owns:
            rt.init(num_workers=max(4, args.elastic_workers * 2),
                    num_cpus=max(8, args.elastic_workers * 2),
                    _system_config=sysconf)
        try:
            results = measure_elastic_recovery(
                num_workers=args.elastic_workers,
                num_steps=args.elastic_steps,
            )
        finally:
            if owns:
                rt.shutdown()
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    if args.envelope:
        rows = [r.strip() for r in args.envelope_rows.split(",") if r.strip()]
        results = {}
        single_rows = [r for r in rows if r != "broadcast"]
        if single_rows:
            store = None
            if "large" in rows:
                store = int((args.envelope_large_gb + 4) * (1 << 30))
            if rt.is_initialized():
                raise RuntimeError(
                    "--envelope sizes its own object store: run with "
                    "no runtime initialized"
                )
            rt.init(num_workers=args.num_workers,
                    num_cpus=max(16, args.num_workers * 2),
                    object_store_memory=store,
                    _system_config=sysconf)
            try:
                results.update(measure_envelope(
                    rt, rows=single_rows,
                    args_n=args.envelope_args_n,
                    returns_n=args.envelope_returns_n,
                    get_n=args.envelope_get_n,
                    queue_n=args.envelope_queue_n,
                    large_gb=args.envelope_large_gb,
                    num_workers=args.num_workers,
                ))
            finally:
                rt.shutdown()
        if "broadcast" in rows:
            results["broadcast"] = measure_envelope_broadcast(
                n_nodes=args.envelope_bcast_nodes,
                size_gb=args.envelope_bcast_gb,
            )
            print("envelope[broadcast]: " + ", ".join(
                f"{k}={v}" for k, v in results["broadcast"].items()),
                flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)
        print(json.dumps(results))
        return results

    owns = not rt.is_initialized()
    if owns:
        rt.init(num_workers=args.num_workers, num_cpus=max(
            16, args.num_workers * 2
        ), _system_config=sysconf)
    results: Dict[str, Dict[str, float]] = {}
    try:
        if args.pin_cores:
            # warm the worker pool BEFORE pinning: workers spawned
            # after pinning inherit the daemon's core
            measure_task_storm(rt, n=100)
            placement = apply_core_pinning(args.pin_cores)
            print(f"pinned planes to cores: {placement}", flush=True)
        if args.core_split:
            split = measure_core_split(rt, n=args.storm_n)
            print(
                f"core split ({args.storm_n} tasks): "
                + ", ".join(
                    f"{k.split('_')[0]} {split[k]}us"
                    for k in ("driver_us_per_task", "noded_us_per_task",
                              "worker_us_per_task", "other_us_per_task")
                )
                + f" | measured {split['measured_tasks_per_s']}/s, "
                f"pipelined-projection "
                f"{split['projected_pipelined_tasks_per_s']}/s "
                f"(bottleneck: {split['bottleneck']})",
                flush=True,
            )
            results["core_split"] = {
                k: v for k, v in split.items() if isinstance(v, float)
            }
            results["core_split"]["bottleneck"] = split["bottleneck"]  # type: ignore[assignment]
        for name, factory, mult in build_matrix(rt, args):
            if args.filter and args.filter not in name:
                continue
            body, cleanup = factory()
            try:
                n, mean, sd = timeit(name, body, mult, rounds=args.rounds,
                                     round_sec=args.round_sec)
            finally:
                cleanup()
            results[n] = {"ops_per_s": round(mean, 2), "sd": round(sd, 2)}
        if args.storm:
            shards_before = _shard_snapshot()
            dist = measure_task_storm(rt, n=args.storm_n)
            shard_rows = owner_shard_report(shards_before, _shard_snapshot())
            print(
                f"task storm ({args.storm_n} tasks): "
                f"submit {dist['submit_s']:.2f}s, drain "
                f"{dist['drain_s']:.2f}s, latency p50 {dist['p50_s']:.2f}s "
                f"p95 {dist['p95_s']:.2f}s p100 {dist['p100_s']:.2f}s",
                flush=True,
            )
            for row in shard_rows:
                print(
                    f"  owner shard {row['shard']}: "
                    f"{row['completed']} tasks, "
                    f"{row['cpu_s']:.2f}s CPU, "
                    f"{row['us_per_task']:.0f} us/task",
                    flush=True,
                )
            results["task_storm"] = {
                k: round(v, 3) for k, v in dist.items()
            }
            results["task_storm"]["owner_shards"] = shard_rows  # type: ignore[assignment]
        if args.busbw:
            bw = measure_allreduce_busbw(
                rt, world=args.busbw_world, size_mb=args.busbw_mb
            )
            print(f"allreduce busbw ({args.busbw_world} ranks, "
                  f"{args.busbw_mb} MB): {bw:.2f} GB/s", flush=True)
            results["allreduce_busbw_gbps"] = {"ops_per_s": round(bw, 3),
                                               "sd": 0.0}
    finally:
        if owns:
            rt.shutdown()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
