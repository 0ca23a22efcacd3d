"""A served Llama-style model under a closed loop of clients.

The system under test is the port's `serve.llm_engine.LlamaEngine`
with the model's weights made from the seed (`weights.py`).  One
client thread keeps `clients` requests in flight: each completion
submits that client's next request from the mix's sequence
(`traffic.requests`).  Every submit runs under a request ledger of the
serve plane (`serve.request_ledger`), so the engine's own ticket stamps
each request (submit, admission, prefill dispatched, the harvest that
carried the first token, the last); the ledger here keeps the stamps
whether or not metrics or tracing are on.

Set-up: the weights, the engine (which warms its decode chunk), then
warm traffic from the mix itself until every client has had a request
completed: the mix's first `block` requests hold every prompt length
it sends, so every prefill bucket and block write the window uses is
captured here, and the loop runs desynchronised when the window opens.

Window: `seconds` of the loop.  A request counts if it completes
inside it.  End to end: generated tokens of those requests over the
window, and the 95th percentiles of their time to first token and
time per output token ((done - first) / (tokens - 1)).

Check, once the window has closed and the engine's memory is freed: a
sample of the window's requests drawn from the seed, the longest among
them, each re-run whole (prompt and served tokens) through the plain
f32 reference; the widest gap by which a served token's reference
logit lies below the reference's best at its position.

Traced run: a sub-window of `trace_seconds` in the middle of the
window under `torch.profiler`, read by the serve cells' per-layer
readers through `data["launches"]`: every CUDA graph replay in it,
classed as a decode chunk (it ran the paged attention kernel), a
prefill (at least four kernels a layer) or a block write, each prefill
tied to its request by the ticket's stamps (admission to prefill
dispatched brackets its launch on the engine's thread).  Each chunk's
rows are counted from the tickets at its launch (`readers.chunk_work`).  The profiler starts and stops while the
engine is held still (`_holder`), and the ticket readers leave out the
requests that lived through a hold.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from port_bench import trace as tracemod
from port_bench import traffic, weights
from port_bench.drivers import Observed, check
from port_bench.reference import exact_f32, llama_ref

WARM_TIMEOUT_S = 600.0
DRAIN_TIMEOUT_S = 120.0
TRACE_SETTLE_S = 0.5


def llama_config(cfg: Dict, max_len: int):
    import torch
    from ray_tpu_torch.models import llama

    port = cfg["port"]
    return llama.LlamaConfig(
        vocab_size=cfg["vocab_size"], max_seq_len=max_len,
        dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        intermediate=cfg["intermediate_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=getattr(torch, cfg["torch_dtype"]),
        attention=port["attention"], remat=False)


def _ledger_class():
    from ray_tpu_torch.serve import request_ledger as rl

    class Ledger(rl.RequestLedger):
        """A request ledger that keeps the engine's phase spans whether
        or not a trace is on."""

        __slots__ = ("spans",)

        def __init__(self):
            super().__init__("port_bench", "port_bench", "engine")
            self.spans: Dict[str, tuple] = {}

        def add_span(self, name, start, end, **attrs):
            self.spans[name] = (start, end)

    return Ledger, rl.use_ledger


@dataclasses.dataclass
class Rec:
    client: int
    index: int
    prompt: List[int]
    max_new: int
    led: object
    fut: object
    tokens: Optional[List[int]] = None
    error: Optional[str] = None
    t_end: float = 0.0  # when the loop saw it end (time.time())

    def stamp(self, span: str, end: bool) -> Optional[float]:
        s = self.led.spans.get(span)
        return None if s is None else s[1 if end else 0]

    @property
    def t_submit(self):
        return self.stamp("serve.admission", False)

    @property
    def t_admit(self):
        return self.stamp("serve.admission", True)

    @property
    def t_prefill(self):
        return self.stamp("serve.prefill", True)

    @property
    def t_done(self):
        return self.stamp("serve.decode", True)

    def tokens_by(self, t: float) -> float:
        """Tokens handed over by time `t`: the first at its harvest, the
        rest spread evenly up to the last (TPOT's own assumption)."""
        n, t_done = len(self.tokens), self.t_done
        t_first = self.t_submit + self.ttft_s
        if t < t_first:
            return 0.0
        if t >= t_done or n == 1:
            return float(n)
        return 1.0 + (n - 1) * (t - t_first) / (t_done - t_first)

    @property
    def ttft_s(self):
        return self.led.notes.get("ttft_s")

    @property
    def tpot_s(self):
        return self.led.notes.get("tpot_s")


class ClosedLoop:
    """`clients` requests in flight, one thread submitting them all."""

    def __init__(self, engine, stream, clients: int):
        self.engine, self.stream, self.clients = engine, stream, clients
        self.Ledger, self.use_ledger = _ledger_class()
        self.submitted: List[Rec] = []
        self.done: List[Rec] = []
        self.warm = threading.Event()
        self._warm_seen = set()
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue[Optional[Rec]]" = queue.Queue()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, name="pb-clients",
                                        daemon=True)

    def start(self):
        self._thread.start()

    def _submit(self, client: int):
        req = next(self.stream)
        led = self.Ledger()
        with self.use_ledger(led):
            fut = self.engine.submit(req.prompt, req.max_new)
        rec = Rec(client, req.index, req.prompt, req.max_new, led, fut)
        self.submitted.append(rec)
        fut.add_done_callback(lambda f, rec=rec: self._q.put(rec))

    def _run(self):
        try:
            self._serve()
        except BaseException as e:  # the main thread raises it
            self.error = e
            self.warm.set()
            raise

    def _serve(self):
        for c in range(self.clients):
            self._submit(c)
        while True:
            rec = self._q.get()
            if rec is None:
                return
            rec.t_end = time.time()
            if rec.fut.cancelled():
                rec.error = "cancelled"
            elif rec.fut.exception() is not None:
                rec.error = repr(rec.fut.exception())
            else:
                rec.tokens = list(rec.fut.result())
            self.done.append(rec)
            if not self.warm.is_set():
                self._warm_seen.add(rec.client)
                if len(self._warm_seen) == self.clients:
                    self.warm.set()
            if not self._stopped.is_set():
                self._submit(rec.client)

    def stop_submitting(self):
        self._stopped.set()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=60)


def _holder(engine, pauses: List[tuple]):
    """A context under which the engine's thread makes no CUDA call: the
    engine's lock is taken (its thread stops at its next take of it,
    a few host calls after any launch) and the card drained.  Each hold
    is noted in `pauses` as (start, end) on `time.time()`."""
    import torch

    @contextlib.contextmanager
    def hold():
        t0 = time.time()
        with engine._lock:
            time.sleep(0.2)
            torch.cuda.synchronize()
            time.sleep(0.05)
            yield
        pauses.append((t0, time.time()))

    return hold


def _classify(tr, n_layers: int):
    """The trace's graph replays, each {"kind", "rt": its runtime call,
    "ops": the device operations it ran}."""
    out = []
    for rt, ops in tr.graph_launches():
        if any("decode_attention" in o.name for o in ops):
            kind = "chunk"
        elif len(ops) >= 4 * n_layers:
            kind = "prefill"
        else:
            kind = "write"
        out.append({"kind": kind, "rt": rt, "ops": ops})
    return out


def _tie_prefills(launches, tr, submitted: List[Rec]):
    """Each prefill launch to its request: the one whose admission and
    prefill-dispatched stamps bracket the launch; None where none does."""
    admitted = sorted((r for r in submitted if r.t_prefill is not None),
                      key=lambda r: r.t_admit)
    starts = [r.t_admit for r in admitted]
    for la in launches:
        la["request"] = None
        if la["kind"] != "prefill":
            continue
        t = tr.to_host(la["rt"].ts)
        i = int(np.searchsorted(starts, t)) - 1
        if i >= 0 and admitted[i].t_admit <= t <= admitted[i].t_prefill:
            la["request"] = admitted[i]


def run(cell, seed: int, seconds: float, trace: bool, device) -> Observed:
    import torch
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg, eng_spec, mix = cell.config, cell.spec["engine"], cell.mix
    lcfg = llama_config(cfg, eng_spec["max_len"])
    specs = weights.llama_specs(cfg)
    params = weights.make(specs, seed, device, lcfg.dtype)
    engine = LlamaEngine(
        lcfg, params, slots=eng_spec["slots"], max_len=eng_spec["max_len"],
        chunk=eng_spec["chunk"], block_size=eng_spec["block_size"],
        prefix_cache=eng_spec["prefix_cache"], kv_dtype=eng_spec["kv_dtype"],
        device=device)
    loop = ClosedLoop(engine, traffic.requests(mix, seed, cfg["vocab_size"]),
                      mix["clients"])
    loop.start()
    if not loop.warm.wait(WARM_TIMEOUT_S) or loop.error is not None:
        raise RuntimeError("warm traffic did not complete a request for "
                           "every client") from loop.error
    caches = ("chunk_cache_size", "prefill_cache_size", "suffix_cache_size",
              "write_cache_size", "chunk_cache_evictions")
    before = engine.stats()
    t_open = time.time()
    setup_s = time.perf_counter() - cell.t_start
    holder, pauses = None, []
    if trace:
        trace_s = min(float(cell.spec["trace_seconds"]), seconds)
        time.sleep(max(0.0, (seconds - trace_s) / 2))
        with tracemod.window(_holder(engine, pauses),
                             TRACE_SETTLE_S) as holder:
            time.sleep(trace_s)
        time.sleep(max(0.0, t_open + seconds - time.time()))
    else:
        time.sleep(seconds)
    t_close = time.time()
    loop.stop_submitting()
    after = engine.stats()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # every request in flight runs to its end (no new ones come): its
    # tokens inside the window count, and an answer that never comes
    # is a failure
    deadline = time.time() + DRAIN_TIMEOUT_S
    while time.time() < deadline and any(
            r.t_end == 0.0 for r in list(loop.submitted)):
        time.sleep(0.05)
    engine.shutdown()
    loop.close()
    loop.engine = None  # the requests' callbacks hold the loop
    window = [r for r in loop.done
              if r.t_end and t_open <= r.t_end <= t_close]
    ok = [r for r in window if r.error is None]
    failed = [r for r in window if r.error is not None]
    lost = sum(r.t_end == 0.0 or r.error == "cancelled"
               for r in loop.submitted)
    span = t_close - t_open
    e2e = {"setup_s": setup_s}
    if ok:
        e2e["output_tokens_per_s"] = sum(
            r.tokens_by(t_close) - r.tokens_by(t_open)
            for r in loop.done if r.error is None) / span
        e2e["ttft_p95_ms"] = float(np.percentile(
            [r.ttft_s * 1e3 for r in ok], 95))
        tpots = [r.tpot_s * 1e3 for r in ok if r.tpot_s is not None]
        if tpots:
            e2e["tpot_p95_ms"] = float(np.percentile(tpots, 95))
    info = {"requests_in_window": len(window), "never_answered": lost,
            "window_s": span,
            "window_captures": {k: after[k] - before[k] for k in caches},
            "prefill_tokens": after["prefill_tokens"] - before["prefill_tokens"],
            "prefix_hit_tokens": (after["prefix_hit_tokens"]
                                  - before["prefix_hit_tokens"])}
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, sample = judge(cell, seed, ok, device)
    info["checked_requests"] = len(sample)
    info["checked_tokens"] = sum(len(r.tokens) for r in sample)
    info["bad_lengths"] = sum(len(r.tokens) != r.max_new for r in ok)
    checks["token_count_errors"] = check(info["bad_lengths"], 0)
    obs = Observed(e2e, len(window) + lost, len(failed) + lost, checks,
                   peak, info)
    # the engine's stamps of a request that lived through a hold read
    # the hold: the ticket readers take the others
    obs.data.update(requests=[r for r in ok if not any(
                        a < r.t_end and r.t_submit < b for a, b in pauses)],
                    submitted=loop.submitted, cfg=cfg, engine=eng_spec)
    if holder is not None:
        tr = obs.trace = holder.parse()
        launches = _classify(tr, cfg["num_hidden_layers"])
        _tie_prefills(launches, tr, loop.submitted)
        obs.data["launches"] = launches
        inside = [la for la in launches if tr.inside(la["ops"])]
        info["traced_launches"] = {
            kind: sum(la["kind"] == kind for la in inside)
            for kind in ("chunk", "prefill", "write")}
        info["traced_launches"]["prefill_tied"] = sum(
            la["request"] is not None for la in inside)
        obs.data["prefix_hits_in_window"] = info["prefix_hit_tokens"]
    return obs


def judge(cell, seed: int, ok: List[Rec], device, mm=None):
    """(checks, sample): the served tokens of a seeded sample of `ok`,
    its longest request among them, against the f32 reference."""
    import torch

    limits = cell.spec["limits"]
    if not ok:
        return {"logit_gap_max": check(float("inf"),
                                       limits["logit_gap_max"])}, []
    rng = traffic.rng_for(seed, 3)
    longest = max(ok, key=lambda r: len(r.prompt) + len(r.tokens))
    rest = [r for r in ok if r is not longest]
    k = min(len(rest), int(cell.spec["check_requests"]) - 1)
    sample = [longest] + [rest[i] for i in
                          rng.choice(len(rest), size=k, replace=False)]
    gap = served_gap(cell, seed, sample, device, mm)
    return {"logit_gap_max": check(gap, limits["logit_gap_max"])}, sample


def served_gap(cell, seed, sample: List[Rec], device, mm=None) -> float:
    """The widest gap over the sample's served tokens, the reference in
    f32 (or, for a control, in `mm`'s precision: then the gap is that of
    the token the control puts first)."""
    import torch

    cfg = cell.config
    ref = weights.make(weights.llama_specs(cfg), seed, device,
                       getattr(torch, cfg["torch_dtype"]))
    seqs = [torch.as_tensor(r.prompt + r.tokens[:-1], device=device)
            for r in sample]
    starts = [len(r.prompt) - 1 for r in sample]
    worst = 0.0
    with exact_f32():
        exact = llama_ref.logits_at(cfg, ref, seqs, starts)
        if mm is None:
            picks = [torch.as_tensor(r.tokens, device=device) for r in sample]
        else:
            picks = [lg.argmax(dim=-1) for lg in
                     llama_ref.logits_at(cfg, ref, seqs, starts, mm)]
        for lg, tok in zip(exact, picks):
            worst = max(worst, float(llama_ref.gaps(lg, tok).max()))
    del ref, exact
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return worst
