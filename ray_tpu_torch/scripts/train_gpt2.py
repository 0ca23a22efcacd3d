"""GPT-2 124M training steps on the card: the counterpart of the JAX
bench's `bench_gpt2`.

    python -m ray_tpu_torch.scripts.train_gpt2 [--batch 32] [--seq 1024]
        [--steps 5] [--warmup 2] [--profile] [--trace PATH]

`GPT2Config(attention="flash", logits_dtype=bf16)` (bf16 compute, f32
master weights, full remat) with random weights and random tokens from
a seed, `default_optimizer(total_steps=1000)`, driven through
`make_train_step`.  Prints two JSON lines: once the model is on the
card, the card this process sees (`CUDA_VISIBLE_DEVICES`, the device
count and name); at the end, per-step wall ms (each step ends in a
device sync), tokens/s over the timed steps, MFU (6 * N FLOPs per token
over the H100's dense bf16 peak of 989 TFLOP/s, as the bench counts
it), the losses, peak device memory, and the K1-K4 launches and plain
dispatches of the warm-up and timed steps (read in this process).  `--profile` runs one more
step under `torch.profiler` (CPU + CUDA) and adds host ms, device
busy ms (the sum of kernel durations), the device's idle share and the
top kernels by device time; the Chrome trace goes to `--trace`
(default `profiles/train_trace.json`).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import attention

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense


def build(device=None, batch: int = 32, seq: int = 1024, seed: int = 0,
          cfg: gpt2.GPT2Config = None) -> Dict:
    """Params, optimizer state, the step function and one batch of
    random tokens [batch, seq + 1], all from `seed`."""
    device = resolve_device(device)
    cfg = cfg or gpt2.GPT2Config(attention="flash",
                                 logits_dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, seed, device=device)
    opt = gpt2.default_optimizer(total_steps=1000)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=device, dtype=torch.int32)
    return {"cfg": cfg, "params": params, "opt_state": opt.init(params),
            "step": gpt2.make_train_step(cfg, opt), "tokens": tokens,
            "device": device}


def run_steps(state: Dict, n: int) -> List[Dict[str, float]]:
    """n train steps; each one's wall ms (ending in a device sync), loss
    and pre-clip grad norm."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state["params"], state["opt_state"], m = state["step"](
            state["params"], state["opt_state"], state["tokens"])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if state["device"].type == "cuda":
            torch.cuda.synchronize(state["device"])
        out.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                    "grad_norm": gnorm})
    return out


def summarize(state: Dict, steps: List[Dict[str, float]]) -> Dict:
    """tokens/s and MFU over `steps`."""
    B, T1 = state["tokens"].shape
    tokens = B * (T1 - 1)
    wall_s = sum(s["ms"] for s in steps) / 1e3
    n_params = gpt2.num_params(state["params"])
    tps = tokens * len(steps) / wall_s
    return {"tokens_per_step": tokens, "n_params": n_params,
            "step_ms": [s["ms"] for s in steps],
            "losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "tokens_per_s": tps,
            "mfu": tps * 6 * n_params / PEAK_BF16_FLOPS}


def profile_step(state: Dict, trace: str, run=None) -> Dict:
    """One step under torch.profiler: host ms, device busy ms, idle
    share, kernel launches, top kernels by device time.  `run(state, n)`
    takes the steps (default `run_steps`)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        (run or run_steps)(state, 1)
        wall = time.perf_counter() - t0
    path = Path(trace)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            by_name[ev["name"]][0] += float(ev.get("dur", 0.0))
            by_name[ev["name"]][1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "host_ms_per_step": wall * 1e3,
        "device_busy_ms_per_step": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "kernel_launches_per_step": sum(v[1] for v in by_name.values()),
        "top_kernels": [
            {"name": name[:90], "ms": us / 1e3, "launches": n,
             "share": us / busy_us if busy_us else 0.0}
            for name, (us, n) in top
        ],
        "trace": str(path),
    }


def bench_gpt2(state: Dict, steps: int = 5, warmup: int = 2) -> Dict:
    """On `build`'s state: warm-up steps, then `steps` timed steps; the
    summary with the warm-up losses and the timed window's peak
    memory."""
    warm = run_steps(state, warmup)
    torch.cuda.reset_peak_memory_stats(state["device"])
    timed = run_steps(state, steps)
    return {**summarize(state, timed),
            "warmup_losses": [s["loss"] for s in warm],
            "peak_mem_gb": torch.cuda.max_memory_allocated(
                state["device"]) / 1e9}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", default="profiles/train_trace.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = build(None, args.batch, args.seq, args.seed)
    # what this process was given, before its first step: the card it
    # sees (a job's process inherits its supervisor worker's env)
    print(json.dumps({
        "phase": "train_gpt2_device",
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_count": torch.cuda.device_count(),
        "device": torch.cuda.get_device_name(state["device"]),
    }), flush=True)
    names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    for name in names:
        getattr(attention, name).launches = 0
    attention.flash_attention.plain_dispatches = 0
    res = bench_gpt2(state, args.steps, args.warmup)
    res["launches"] = {name: getattr(attention, name).launches
                       for name in names}
    res["plain_dispatches"] = attention.flash_attention.plain_dispatches
    if args.profile:
        res["profile"] = profile_step(state, args.trace)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = state["cfg"]
    print(json.dumps({
        "phase": "train_gpt2", "device": smi, "model": "gpt2_124m",
        "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
        "attention": cfg.attention, "remat_policy": cfg.remat_policy,
        "batch": args.batch, "seq": args.seq, **res,
    }), flush=True)


if __name__ == "__main__":
    main()
