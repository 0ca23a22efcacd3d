"""Before the benchmark relies on the engine's time to first token: the
ticket's first-token stamp is taken at the harvest that hands the first
token over, and TTFT / TPOT reach the ledger's notes with metrics and
tracing both off."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import weights
from port_bench.drivers import serve_closed_loop as sc

CFG = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
       "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
       "rope_theta": 1e6, "torch_dtype": "float32", "vocab_size": 256,
       "port": {"attention": "dense"}}


def test_first_token_stamped_at_its_harvest(monkeypatch):
    from ray_tpu_torch.serve import request_ledger as rl
    from ray_tpu_torch.serve.llm_engine import LlamaEngine
    from ray_tpu_torch.util import tracing

    assert not rl.enabled() and not tracing.is_enabled()
    harvests = []  # (wall before, wall after, ledgers given a first token)
    orig = LlamaEngine._harvest

    def harvest(self, toks_host, seq):
        empty = [r for r in self._active.values() if not r["out"]]
        t0 = time.time()
        orig(self, toks_host, seq)
        t1 = time.time()
        firsts = {id(r["tk"].ledger) for r in empty if r["out"]}
        harvests.append((t0, t1, firsts, seq))

    monkeypatch.setattr(LlamaEngine, "_harvest", harvest)
    params = weights.make(weights.llama_specs(CFG), 1, "cpu", torch.float32)
    engine = LlamaEngine(sc.llama_config(CFG, 64), params, slots=2, chunk=4,
                         block_size=8, max_len=64, device="cpu")
    Ledger, use_ledger = sc._ledger_class()
    leds = []
    try:
        for n in (9, 1):  # a request of 9 tokens and one of a single token
            led = Ledger()
            with use_ledger(led):
                fut = engine.submit(list(range(5, 17)), n)
            leds.append((led, fut))
        for led, fut in leds:
            assert len(fut.result(timeout=60)) == (9 if led is leds[0][0]
                                                   else 1)
    finally:
        engine.shutdown()
    for led, _ in leds:
        assert {"ttft_s", "prefill_s", "n_tokens"} <= set(led.notes)
        t_submit = led.spans["serve.admission"][0]
        t_first = t_submit + led.notes["ttft_s"]
        # some harvest bracketed the stamp (its wall clock), and it was
        # the harvest at which the request first held a token
        hit = [h for h in harvests if h[0] <= t_first <= h[1]]
        assert len(hit) == 1 and id(led) in hit[0][2], (t_first, harvests)
        assert led.spans["serve.admission"][1] <= led.spans[
            "serve.prefill"][1] <= t_first <= led.spans["serve.decode"][1]
    led9 = leds[0][0]
    assert led9.notes["n_tokens"] == 9
    t_done = led9.spans["serve.decode"][1]
    t_first = led9.spans["serve.admission"][0] + led9.notes["ttft_s"]
    assert led9.notes["tpot_s"] == pytest.approx((t_done - t_first) / 8)
    assert "tpot_s" not in leds[1][0].notes  # one token: no TPOT
