"""The comparison that decides `correct`, shown to fail.

A tiny served cell runs on the CPU through `run.run_cell` (the harness
minus its look for a card), sound and then with the timed path broken
underneath, once for each fault the cell can have: a token altered
where it is produced, a decode step that leaves its state (the KV
cache) unchanged.  The exchange between chips has no fault here: every
cell runs on one chip.  Then the control: the reference put in the
program's place one precision below (float8 products) comes out not
correct through the harness's own comparison (`run.result`)."""

from __future__ import annotations

import time
from pathlib import Path

import torch

from port_bench import run
from port_bench.drivers import serve_closed_loop as sc
from port_bench.reference.lowp import fp8_mm

TINY = Path(__file__).resolve().parent / "tiny"
BENCH = {"workloads": [
    {"name": "serve.tiny-llama", "config": "tiny-llama",
     "traffic": "tiny_chat", "chips": 1}],
    "end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}


def cell(name):
    c = run.load_cell(BENCH, name, TINY)
    c.t_start = time.perf_counter()
    return c


def go(name, seed=4):
    return run.run_cell(BENCH, cell(name), seed, 0.5, False,
                        torch.device("cpu"))


def test_sound_run_is_correct():
    out = go("serve.tiny-llama")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def test_altered_token_is_caught(monkeypatch):
    from ray_tpu_torch.models import llama

    step = llama.decode_step_paged

    def altered(*a, **k):
        out = step(*a, **k)
        out[0][:, 7] += 1e3  # every decoded token becomes 7
        return out

    monkeypatch.setattr(llama, "decode_step_paged", altered)
    out = go("serve.tiny-llama")
    assert not out["correct"]
    assert out["checks"]["logit_gap_max"]["value"] > \
        out["checks"]["logit_gap_max"]["limit"]


def test_kv_left_unchanged_is_caught(monkeypatch):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import paged_attention as pa

    def no_append(q, k_pool, v_pool, k_new, v_new, tables, pos, layer, **kw):
        return pa.paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                         layer)

    monkeypatch.setattr(llama._pa, "paged_append_decode_attention", no_append)
    out = go("serve.tiny-llama")
    assert not out["correct"], out["checks"]


def test_serve_control_is_not_correct():
    c = cell("serve.tiny-llama")
    obs = sc.run(c, 5, 0.5, False, torch.device("cpu"))
    assert run.result(BENCH, c, obs, False, torch.device("cpu"))["correct"]
    checks, _ = sc.judge(c, 5, obs.data["requests"], torch.device("cpu"),
                         mm=fp8_mm)
    obs.checks.update(checks)
    out = run.result(BENCH, c, obs, False, torch.device("cpu"))
    assert not out["correct"], out["checks"]
