"""Fault-injection utilities for tests and chaos runs.

Reference: `python/ray/_private/test_utils.py` — `WorkerKillerActor`
(:1597), `RayletKiller` (:1536), `ResourceKillerActor` (:1433): actors
that kill cluster components on a cadence while a workload runs, the
substrate of the reference's chaos suites
(`release/nightly_tests/setup_chaos.py`).  Single-host clusters (the
`cluster_utils.Cluster` test shape) let killers deliver straight
SIGKILLs by pid.
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import List, Optional

import ray_tpu_torch as rt


def list_workers() -> List[dict]:
    """All pool workers on the local node (id, pid, kind, idle)."""
    from ray_tpu_torch.core.runtime import get_runtime

    return get_runtime().noded_call("list_workers") or []


def kill_random_worker(*, busy_only: bool = True,
                       exclude_actors: bool = True,
                       rng: Optional[random.Random] = None) -> Optional[int]:
    """SIGKILL one worker; returns the pid or None if no candidate.
    The runtime's worker-death path turns this into retriable task
    failures / actor restarts — the property chaos tests assert."""
    rng = rng or random
    candidates = [
        w for w in list_workers()
        if w["kind"] == "worker"
        and (not busy_only or not w["idle"])
        and (not exclude_actors or w["actor_id"] is None)
        and w["pid"] != os.getpid()
    ]
    if not candidates:
        return None
    victim = rng.choice(candidates)
    try:
        os.kill(victim["pid"], signal.SIGKILL)
    except ProcessLookupError:
        return None
    return victim["pid"]


@rt.remote(max_concurrency=2)  # stop() must interleave with run()
class WorkerKiller:
    """Resident killer: SIGKILLs a random busy task worker every
    `interval_s` until stopped (reference: WorkerKillerActor)."""

    def __init__(self, interval_s: float = 0.5, seed: int = 0):
        self.interval_s = interval_s
        self.rng = random.Random(seed)
        self.killed: List[int] = []
        self._stop = False

    def run(self, duration_s: float = 10.0) -> List[int]:
        deadline = time.time() + duration_s
        while not self._stop and time.time() < deadline:
            pid = kill_random_worker(rng=self.rng)
            if pid is not None:
                self.killed.append(pid)
            time.sleep(self.interval_s)
        return self.killed

    def stop(self) -> List[int]:
        self._stop = True
        return self.killed


# ----------------------------------------------------------------------
# environment capability probes (skip-guards for tier-1)
# ----------------------------------------------------------------------
_MULTIPROC_PROBE = r"""
import sys
import torch
import torch.distributed as dist

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
out = torch.ones(2) * (rank + 1)
dist.all_reduce(out)
assert float(out.sum()) == 6.0, out
dist.destroy_process_group()
"""

_multiproc_cpu_cache: Optional[tuple] = None


def torch_multiprocess_cpu_support() -> tuple:
    """(supported, reason): can this PyTorch run MULTI-PROCESS
    collectives on the CPU (2 OS processes forming one gloo group over
    TCP, the shape the port's `torch_distributed` train mode and its
    process-group tests miniaturize)?  A build without gloo, or a box
    whose loopback rendezvous hangs, is an environment limit, not a
    code path worth failing tier-1 over.  Probes once per process with
    a real 2-process allreduce."""
    global _multiproc_cpu_cache
    if _multiproc_cpu_cache is not None:
        return _multiproc_cpu_cache
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _MULTIPROC_PROBE, str(rank), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in (0, 1)
    ]
    ok, reason = True, ""
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            # one hung rendezvous means the pair is dead: kill BOTH
            # now so the second communicate() can't burn another 120 s
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            ok, reason = False, "probe timed out (rendezvous hung)"
            continue
        if p.returncode != 0:
            ok = False
            if not reason:  # keep the FIRST cause: a later process
                # killed after a timeout would clobber it with SIGKILL
                tail = [ln for ln in (out or "").splitlines()
                        if ln.strip()]
                reason = (tail[-1][-200:] if tail
                          else f"exit {p.returncode}")
    _multiproc_cpu_cache = (ok, reason)
    return _multiproc_cpu_cache


_kernel_cache: dict = {}
KERNEL_KINDS = ("attention", "xent", "paged")


def cuda_kernel_support(kind: str = "attention") -> tuple:
    """(supported, reason): can this machine build and launch the
    port's hand-written kernels of one family ("attention" | "xent" |
    "paged")?  Card tests skip-guard on this.  Without a card it
    returns (False, reason).  With one, it builds the family's library,
    launches its kernels on small f32 tensors and holds each result
    against its plain version: a failed build, launch or comparison
    RAISES there, since a machine with a card must run the kernels —
    it never returns False."""
    if kind not in KERNEL_KINDS:
        raise ValueError(f"unknown kernel probe kind: {kind}")
    if kind in _kernel_cache:
        return _kernel_cache[kind]
    import torch

    if not torch.cuda.is_available():
        result = (False, "no CUDA device: the kernels build and launch "
                         "only on a card")
        _kernel_cache[kind] = result
        return result
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.1

    if kind == "attention":
        from ray_tpu_torch.ops import attention as fa

        counters = (fa.flash_fwd, fa.flash_bwd_fused)
        before = [c.launches for c in counters]
        q, k, v = (randn(1, 64, 2, 64).requires_grad_(True)
                   for _ in range(3))
        out = fa.flash_attention(q, k, v, True, 64, 64)
        got = torch.autograd.grad(out.sum(), (q, k, v))
        want_out = fa.plain_attention(q, k, v, causal=True)
        want = torch.autograd.grad(want_out.sum(), (q, k, v))
        pairs = [(out, want_out), *zip(got, want)]
    elif kind == "xent":
        from ray_tpu_torch.ops import xent_pallas as xp

        counters = (xp.xent_fwd, xp.xent_dx, xp.xent_dw)
        before = [c.launches for c in counters]
        x = randn(64, 32).requires_grad_(True)
        w = randn(96, 32).requires_grad_(True)
        tg = torch.randint(0, 96, (64,), generator=gen, device=dev)
        loss = xp.pallas_cross_entropy(x, w, tg)
        got = torch.autograd.grad(loss, (x, w))
        want_loss = xp.reference_cross_entropy(x, w, tg)
        want = torch.autograd.grad(want_loss, (x, w))
        pairs = [(loss, want_loss), *zip(got, want)]
    else:
        from ray_tpu_torch.ops import paged_attention as pa

        counters = (pa.paged_kv_append, pa.paged_decode_attention)
        before = [c.launches for c in counters]
        # block tables over blocks 1-2 of 3 (block 0 is scratch), the
        # sixth row written, then attention over rows 0..5
        kp, vp = randn(1, 3, 4, 1, 16), randn(1, 3, 4, 1, 16)
        kp_ref, vp_ref = kp.clone(), vp.clone()
        tables = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        pos = torch.tensor([5], dtype=torch.int32, device=dev)
        k_new, v_new, q = randn(1, 1, 16), randn(1, 1, 16), randn(1, 2, 16)
        pa.paged_kv_append(kp, vp, k_new, v_new, tables, pos, 0)
        out = pa.paged_decode_attention(q, kp, vp, tables, pos, 0)
        pa.paged_kv_append_reference(kp_ref, vp_ref, k_new, v_new, tables,
                                     pos, 0)
        want = pa.paged_decode_attention_reference(q, kp_ref, vp_ref,
                                                   tables, pos, 0)
        pairs = [(kp, kp_ref), (vp, vp_ref), (out, want)]
    torch.cuda.synchronize()
    idle = [c.__name__ for c, b in zip(counters, before) if c.launches == b]
    if idle:
        raise RuntimeError(f"{kind} probe: {idle} launched no kernel")
    for got_, want_ in pairs:
        torch.testing.assert_close(got_, want_, rtol=1e-4, atol=1e-5)
    result = (True, "")
    _kernel_cache[kind] = result
    return result
