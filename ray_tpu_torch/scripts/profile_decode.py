"""Where a fused decode step's time goes, on the card.

    python -m ray_tpu_torch.scripts.profile_decode [--trace PATH]

Builds Llama-3-8B at full width (bf16, random weights from a seed),
prefills 8 prompts of 16-200 tokens into a shuffled paged pool (the
engine's main-path state), then runs one chunk (8 steps) of greedy
`decode_step_paged` under `torch.profiler` (CPU + CUDA).  Prints
one JSON line: host wall time per step, device busy time per step (the
sum of kernel durations in the trace), the device's idle share, and
device time by kernel name (top 12, with each one's launches).  The
Chrome trace is written to `--trace` (default
`profiles/decode_trace.json`).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama

STEPS = 8  # one engine chunk


def _state(cfg, params, device, lens, block_size=16, seed=0):
    rng = np.random.default_rng(seed)
    B, L = len(lens), cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    W = 1 << (-(-(max(lens) + 64) // block_size) - 1).bit_length()
    NB = 1 + B * W
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    k_pool = torch.zeros((L, NB, block_size, KV, hd), dtype=cfg.dtype,
                         device=device)
    v_pool = torch.zeros_like(k_pool)
    tok = torch.zeros(B, dtype=torch.int32, device=device)
    for b, T in enumerate(lens):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, T)),
                                 device=device)
        logits, (k1, v1) = llama.forward(cfg, params, prompt, return_kv=True)
        nb = -(-T // block_size)
        blk = torch.as_tensor(tables[b, :nb], device=device)
        kb = k1.new_zeros((L, nb * block_size, KV, hd))
        vb = v1.new_zeros((L, nb * block_size, KV, hd))
        kb[:, :T], vb[:, :T] = k1[:, 0], v1[:, 0]
        k_pool[:, blk] = kb.reshape(L, nb, block_size, KV, hd)
        v_pool[:, blk] = vb.reshape(L, nb, block_size, KV, hd)
        tok[b] = logits[0, -1].argmax()
    pos = torch.as_tensor(lens, dtype=torch.int32, device=device)
    tables = torch.as_tensor(tables, dtype=torch.int32, device=device)
    return k_pool, v_pool, tables, pos, tok


def _steps(cfg, params, state, n):
    k_pool, v_pool, tables, pos, tok = state
    for _ in range(n):
        logits = llama.decode_step_paged(cfg, params, tok, k_pool, v_pool,
                                         tables, pos)[0]
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    return tok


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="profiles/decode_trace.json")
    args = ap.parse_args()
    device = resolve_device()
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, 0, device=device, dtype=cfg.dtype)
    lens = [16, 40, 72, 96, 120, 150, 180, 200]
    with torch.no_grad():
        state = _state(cfg, params, device, lens)
        _steps(cfg, params, state, 2)  # warm-up: library handles, kernels
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _steps(cfg, params, state, STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    trace = Path(args.trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())
    events = events.get("traceEvents", events)
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            by_name[ev["name"]][0] += float(ev.get("dur", 0.0))
            by_name[ev["name"]][1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "phase": "decode_profile", "device": smi,
        "model": "llama3_8b", "n_layers": cfg.n_layers, "batch": len(lens),
        "prompt_lens": lens, "steps": STEPS,
        "host_ms_per_step": wall * 1e3 / STEPS,
        "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "kernel_launches_per_step": sum(v[1] for v in by_name.values())
        / STEPS,
        "top_kernels": [
            {"name": name[:90], "ms_per_step": us / 1e3 / STEPS,
             "launches_per_step": n / STEPS,
             "share": us / busy_us if busy_us else 0.0}
            for name, (us, n) in top
        ],
    }), flush=True)


if __name__ == "__main__":
    main()
