"""Where a fused decode chunk's time goes, on the card.

    python -m ray_tpu_torch.scripts.profile_decode [--graph] [--trace PATH]

Builds Llama-3-8B at full width (bf16, random weights from a seed) and
a `LlamaEngine` (slots 8, chunk 8, block 16, max_len 512), prefills 8
prompts of 16-200 tokens into shuffled blocks of its pool (the main
path's state), then runs one chunk (8 greedy steps of
`decode_step_paged`) as the engine does, under `torch.profiler` (CPU +
CUDA): by default the eager chunk (`_run_chunk`, every launch from
Python); with `--graph` the chunk's CUDA graph (`_chunk_step_for`,
captured after one eager run, then replayed).  Prints one JSON line:
host wall time per step (ending in a device sync), device busy time per
step (the sum of kernel durations in the trace), the device's idle
share, the chunk's time between CUDA events per step, kernels per step,
host launch calls per step (kernel and graph launches in the trace),
device time by kernel name (top 12), and for `--graph` the capture's
ms and reserved bytes.  The Chrome trace is written to `--trace`
(default `profiles/decode_trace.json`).  Needs one CUDA card.
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
from ray_tpu_torch.serve.llm_engine import LlamaEngine

STEPS = 8  # one engine chunk
LENS = [16, 40, 72, 96, 120, 150, 180, 200]
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def _state(engine: LlamaEngine, lens, seed=0) -> torch.Tensor:
    """Prefill one random prompt of each length into shuffled blocks of
    the engine's pool and set its tokens and positions; returns the
    block tables [len(lens), W]."""
    cfg, params, device = engine.cfg, engine.params, engine.device
    bs, L = engine.block_size, cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)
    B = len(lens)
    W = 1 << (-(-(max(lens) + 64) // bs) - 1).bit_length()
    tables = rng.permutation(np.arange(1, 1 + B * W)).reshape(B, W)
    for b, T in enumerate(lens):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, T)),
                                 device=device)
        logits, (k1, v1) = llama.forward(cfg, params, prompt, return_kv=True)
        nb = -(-T // bs)
        blk = torch.as_tensor(tables[b, :nb], device=device)
        kb = k1.new_zeros((L, nb * bs, KV, hd))
        vb = v1.new_zeros((L, nb * bs, KV, hd))
        kb[:, :T], vb[:, :T] = k1[:, 0], v1[:, 0]
        engine._k_pool[:, blk] = kb.reshape(L, nb, bs, KV, hd)
        engine._v_pool[:, blk] = vb.reshape(L, nb, bs, KV, hd)
        engine._tok[b] = logits[0, -1].argmax()
    engine._pos.copy_(torch.as_tensor(lens, dtype=torch.int32))
    return torch.as_tensor(tables, dtype=torch.int32, device=device)


def profile_chunk(engine: LlamaEngine, tables: torch.Tensor, graph: bool,
                  trace: str) -> dict:
    """One chunk on the route asked for, after two warm-up chunks (the
    graph route's first call runs eagerly and captures)."""
    run = (engine._chunk_step_for(tables.shape[1]) if graph
           else engine._run_chunk)
    for _ in range(2):  # warm-up: library handles, kernels, the capture
        run(tables)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        start.record()
        run(tables)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = Path(trace)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    by_name = defaultdict(lambda: [0.0, 0])
    calls = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") == "kernel":
            by_name[ev["name"]][0] += float(ev.get("dur", 0.0))
            by_name[ev["name"]][1] += 1
        elif ev.get("cat") == "cuda_runtime" and ev.get("name") in \
                _LAUNCH_CALLS:
            calls += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {
        "route": "graph" if graph else "eager",
        "host_ms_per_step": wall * 1e3 / STEPS,
        "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "event_ms_per_step": start.elapsed_time(end) / STEPS,
        "kernels_per_step": sum(v[1] for v in by_name.values()) / STEPS,
        "launch_calls_per_step": calls / STEPS,
        "top_kernels": [
            {"name": name[:90], "ms_per_step": us / 1e3 / STEPS,
             "launches_per_step": n / STEPS,
             "share": us / busy_us if busy_us else 0.0}
            for name, (us, n) in top
        ],
    }
    if graph:
        out["capture_ms"] = run.capture_ms
        out["graph_bytes"] = run.graph_bytes
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", action="store_true",
                    help="profile the chunk's CUDA graph replay")
    ap.add_argument("--trace", default="profiles/decode_trace.json")
    args = ap.parse_args()
    device = resolve_device()
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, 0, device=device, dtype=cfg.dtype)
    engine = LlamaEngine(cfg, params, slots=len(LENS), chunk=STEPS,
                         block_size=16, max_len=512, device=device)
    try:
        with torch.no_grad():
            tables = _state(engine, LENS)
            res = profile_chunk(engine, tables, args.graph, args.trace)
    finally:
        engine.shutdown()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "phase": "decode_profile", "device": smi,
        "model": "llama3_8b", "n_layers": cfg.n_layers, "batch": len(LENS),
        "prompt_lens": LENS, "steps": STEPS,
        "W": int(tables.shape[1]), **res,
    }), flush=True)


if __name__ == "__main__":
    main()
