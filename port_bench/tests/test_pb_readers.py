"""Each per-layer reader on a synthetic profiler event list: graph
replays classed, prefills tied to their requests, the decode work
counted from the tickets, and the metrics worked out by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from port_bench import counts, readers, run
from port_bench import trace as tracemod
from port_bench.drivers import Observed
from port_bench.drivers import serve_closed_loop as sc

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2,
       "num_key_value_heads": 1, "num_hidden_layers": 2, "vocab_size": 10}
ENGINE = {"chunk": 2, "block_size": 4, "max_len": 64}
HOST0 = 500.0  # time.time() at the sync mark


class Led:
    def __init__(self, spans, notes=None):
        self.spans, self.notes = spans, notes or {}


def host(ts):
    return HOST0 + (ts - 1001.0) / 1e6


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def serve_events(outside=False):
    ev = [x("user_annotation", "pb.sync", 1000, 2),
          x("user_annotation", "pb.window", 1000, 100_000)]
    corr, ts = 0, 2000

    def launch(kind):
        nonlocal corr, ts
        corr += 1
        ev.append(x("cuda_runtime", "cudaGraphLaunch", ts, 5, corr))
        k = ts + 100
        if kind == "prefill":  # 2 layers: K1 + 4 GEMMs each
            for _ in range(2):
                ev.append(x("kernel", "flash_fwd_wgmma<128>", k, 10, corr))
                for _ in range(4):
                    ev.append(x("kernel", "nvjet_gemm", k + 10, 5, corr))
                    k += 5
                k += 10
        elif kind == "write":
            ev.append(x("kernel", "index_put", k, 3, corr))
        else:  # chunk: 2 steps x 2 layers of paged attention + a GEMM
            for _ in range(4):
                ev.append(x("kernel", "decode_attention_kernel<bf16, true>",
                            k, 20, corr))
                ev.append(x("kernel", "nvjet_gemv", k + 20, 30, corr))
                k += 50
        ts += 1000
        return corr

    for kind in ("chunk", "prefill", "write", "chunk", "chunk", "prefill",
                 "write", "prefill", "write", "chunk"):
        launch(kind)
    if outside:  # after the sub-window
        ts = 200_000
        for kind in ("prefill", "chunk", "chunk"):
            launch(kind)
    return ev


def make_trace(events):
    tr = tracemod.Trace(events)
    tr.host_sync = HOST0
    return tr


A, B = host(1000), host(101_000)  # the sub-window on the host's clock
CHUNK_K = (11.1, 11.4, 11.5, 12.0)  # tokens handed at each chunk's launch


def decoding():
    """A request decoding all through the sub-window: its first token
    0.1 s before it, its 31st 0.1 s after (by the even spread, token 11
    at the sub-window's start, 21 at its end); prompt 10."""
    return sc.Rec(1, 3, list(range(10)), 31, Led({
        "serve.admission": (A - 0.2, A - 0.15),
        "serve.prefill": (A - 0.15, A - 0.12),
        "serve.decode": (A - 0.12, B + 0.1)}, {"ttft_s": 0.1}), None,
        tokens=list(range(31)))


def serve_obs(outside=False):
    tr = make_trace(serve_events(outside))
    # prefill launches at ts 3000, 7000, 9000: each bracketed by its
    # request's admission and prefill-dispatched stamps
    reqs = [sc.Rec(0, i, list(range(t)), 4, Led({
        "serve.admission": (host(a - 500), host(a - 50)),
        "serve.prefill": (host(a - 50), host(a + 500)),
        "serve.decode": (host(a + 500), host(a + 9000))},
        {"ttft_s": 0.1, "tpot_s": 0.01}), None)
        for i, (t, a) in enumerate(((20, 3000), (40, 7000), (9, 9000)))]
    launches = sc._classify(tr, CFG["num_hidden_layers"])
    submitted = reqs + [decoding()]
    sc._tie_prefills(launches, tr, submitted)
    obs = Observed({}, 3, 0, {}, 0, {}, tr)
    # the decoding request lived through a hold: the ticket readers
    # leave it out, the work counts take it
    obs.data.update(requests=reqs, submitted=submitted, cfg=CFG,
                    engine=ENGINE, launches=launches,
                    prefix_hits_in_window=0)
    return obs


def read(name, obs):
    return run.reader(name).read(obs)


@pytest.mark.parametrize("outside", [False, True])
def test_classes_and_prefill_ties(outside):
    obs = serve_obs(outside)
    la = obs.data["launches"]
    assert [x["kind"] for x in la[:10]] == [
        "chunk", "prefill", "write", "chunk", "chunk", "prefill", "write",
        "prefill", "write", "chunk"]
    assert [la[i]["request"].index for i in (1, 5, 7)] == [0, 1, 2]
    assert all(x["request"] is None for x in la if x["kind"] != "prefill")
    # chunks launch at 2000, 5000, 6000, 11000 us: the decoding request
    # has been handed 11 + (ts - 1000) / 1e4 tokens there, a row a step
    chunks = [x for x in la if x["kind"] == "chunk"][:4]
    for c, k in zip(chunks, CHUNK_K):
        assert readers.chunk_work(obs, c) == pytest.approx(
            (2, 2 * (10 + k) + 1))


def test_serve_readers():
    obs = serve_obs()
    assert read("engine.queue_wait_ms_p95", obs) == pytest.approx(0.45)
    assert read("engine.prefill_ms_p50", obs) == pytest.approx(0.55)
    # every prefill's kernels span 2 x (10 + 20) us
    assert read("prefill.device_ms_p50", obs) == pytest.approx(0.06)
    # chunks: 4 x 50 us over 2 steps each
    assert read("decode.step_device_ms", obs) == pytest.approx(0.1)
    # K1: prompts 20, 40, 9 -> buckets 32, 63 (capped: its K1 is still
    # counted at 63, as the launch ran K1 there), 16
    want = sum(2 * counts.flash_bound_s("k1", 2, t, 4) for t in (32, 63, 16))
    assert read("k1_roofline.serve", obs) == pytest.approx(
        100 * want / (3 * 2 * 10e-6))
    # decode: each chunk's 2 rows against its 4 paged-attention kernels
    # of 20 us
    cols = [2 * (10 + k) + 1 for k in CHUNK_K]
    bound = 0.0
    for c in cols:
        b, f = counts.k5k6_work(2, c, c / 4 + 2, 2, 1, 4)
        bound += 2 * counts.bound_s(b, f)[0]
    assert read("k5k6_roofline", obs) == pytest.approx(
        100 * bound / (16 * 20e-6))
    flops = sum(counts.prefill_flops(CFG, t) for t in (20, 40, 9)) + sum(
        counts.decode_flops(CFG, 2, c) for c in cols)
    assert read("mfu.serve", obs) == pytest.approx(
        100 * flops / (0.1 * counts.PEAK_BF16_FLOPS))
    busy = 3 * 60 + 3 * 3 + 4 * 200
    assert read("device.idle_share.serve", obs) == pytest.approx(
        100 * (100_000 - busy) / 100_000)


def test_readers_without_trace_return_nothing():
    obs = Observed({}, 0, 0, {}, 0, {})
    obs.data.update(requests=[], cfg=CFG, engine=ENGINE)
    for name in ("engine.queue_wait_ms_p95", "engine.prefill_ms_p50",
                 "prefill.device_ms_p50", "decode.step_device_ms",
                 "k5k6_roofline", "k1_roofline.serve", "mfu.serve",
                 "device.idle_share.serve"):
        assert read(name, obs) is None, name


def test_breakdown():
    ev = [x("user_annotation", "pb.sync", 1000, 2),
          x("user_annotation", "pb.window", 1000, 10_000),
          x("kernel", "nvjet_gemm", 2000, 300),
          x("kernel", "decode_attention_kernel", 2500, 100),
          x("kernel", "nvjet_gemm", 2700, 50),
          x("kernel", "nvjet_gemm", 20_000, 50)]  # after the window
    tr = make_trace(ev)
    assert tr.busy_s() == pytest.approx(450e-6)
    assert tr.top_ops(1) == [["nvjet_gemm", pytest.approx(350e-6)]]
    assert tr.idle_gaps(2)[0] == ["host: no CUDA call",
                                  pytest.approx(8250e-6)]


def test_readers_match_benchmark_json():
    bench = json.loads((Path(run.ROOT).parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = run.reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["source"], m["moves"]), m["name"]
