"""Llama LoRA fine-tune steps on the card: the counterpart of the JAX
bench's `bench_llama_lora`.

    python -m ray_tpu_torch.scripts.train_llama_lora [--batch 8]
        [--seq 1024] [--steps 6] [--warmup 1] [--seed 0] [--profile]
        [--trace PATH]

The bench's 1.4B-class config: vocab 32,000, `max_seq_len` 1,024, dim
2,048, 22 layers, 16 heads and 16 kv heads (head width 128),
intermediate 5,632, `attention="flash"`, `remat=True`.  The base is
random (from a seed), cast to bf16 and frozen; rank-8 LoRA on `wq wk
wv wo` (A from the seed + 1); `optax.adamw(2e-4)` written as
`gpt2.AdamW(lambda c: 2e-4, max_norm=inf, b1=0.9, b2=0.999, eps=1e-8,
weight_decay=1e-4)`; random tokens [batch, seq + 1] (seed + 2), the
same batch every step; driven through `llama.make_lora_train_step`.
Prints one JSON line: per-step wall ms (each step ends in a device
sync), tokens/s over the timed steps, MFU (the bench's 4 * num_params
FLOPs a token over the H100's dense bf16 peak of 989 TFLOP/s), peak
device memory over the timed steps, the losses, the flash kernels'
launches over the timed steps (and the flash op's plain dispatches),
and the card's name and power limit.  `--profile` runs one more step
under `torch.profiler` (`train_gpt2.profile_step`: host ms, device busy
ms, idle share, top kernels; the Chrome trace to `--trace`, default
`profiles/lora_trace.json`).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.scripts import train_gpt2

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
FLASH = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


def lora_config(**overrides) -> llama.LlamaConfig:
    """The bench's config (`bench.py` `bench_llama_lora`, on a chip)."""
    kw = dict(vocab_size=32000, max_seq_len=1024, dim=2048, n_layers=22,
              n_heads=16, n_kv_heads=16, intermediate=5632,
              attention="flash")
    return llama.LlamaConfig(**{**kw, **overrides})


def adamw(lr: float = 2e-4) -> gpt2.AdamW:
    """`optax.adamw(lr)`: no clip, its defaults."""
    return gpt2.AdamW(lambda count: lr, max_norm=float("inf"), b1=0.9,
                      b2=0.999, eps=1e-8, weight_decay=1e-4)


def build(device=None, batch: int = 8, seq: int = 1024, seed: int = 0,
          cfg: llama.LlamaConfig = None) -> Dict:
    """The frozen bf16 base, the adapters, the optimizer state, the step
    and one batch of random tokens, all from `seed`."""
    device = resolve_device(device)
    cfg = cfg or lora_config()
    params = llama.init_params(cfg, seed, device=device,
                               dtype=torch.bfloat16)
    lora = llama.init_lora(cfg, seed + 1, rank=8, device=device)
    opt = adamw()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=device, dtype=torch.int32)
    return {"cfg": cfg, "params": params, "lora": lora,
            "opt_state": opt.init(lora),
            "step": llama.make_lora_train_step(cfg, opt), "tokens": tokens,
            "device": device}


def run_steps(state: Dict, n: int) -> List[Dict[str, float]]:
    """n LoRA steps; each one's wall ms (ending in a device sync) and
    loss."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state["lora"], state["opt_state"], m = state["step"](
            state["params"], state["lora"], state["opt_state"],
            state["tokens"])
        loss = float(m["loss"])
        if state["device"].type == "cuda":
            torch.cuda.synchronize(state["device"])
        out.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss})
    return out


def reset_flash_counts() -> None:
    for name in FLASH:
        getattr(fa, name).launches = 0
    fa.flash_attention.plain_dispatches = 0


def flash_counts() -> Dict[str, int]:
    return {**{name: getattr(fa, name).launches for name in FLASH},
            "plain_dispatches": fa.flash_attention.plain_dispatches}


def summarize(state: Dict, steps: List[Dict[str, float]]) -> Dict:
    """tokens/s and MFU over `steps` at the bench's 4 N FLOPs a token
    (forward 2 N, the activations' backward 2 N; no weight gradients of
    the frozen base)."""
    B, T1 = state["tokens"].shape
    tokens = B * (T1 - 1)
    wall_s = sum(s["ms"] for s in steps) / 1e3
    n_params = llama.num_params(state["params"])
    tps = tokens * len(steps) / wall_s
    return {"tokens_per_step": tokens, "n_params": n_params,
            "n_lora_params": llama.num_params(state["lora"]),
            "step_ms": [s["ms"] for s in steps],
            "losses": [s["loss"] for s in steps],
            "tokens_per_s": tps,
            "mfu": tps * 4 * n_params / PEAK_BF16_FLOPS}


def bench_llama_lora(device=None, batch: int = 8, seq: int = 1024,
                     steps: int = 6, warmup: int = 1, seed: int = 0,
                     cfg: llama.LlamaConfig = None) -> Dict:
    """Warm-up steps, then `steps` timed steps: the summary with the
    warm-up losses, the timed window's peak memory and flash launches."""
    state = build(device, batch, seq, seed, cfg)
    warm = run_steps(state, warmup)
    if state["device"].type == "cuda":
        torch.cuda.reset_peak_memory_stats(state["device"])
    reset_flash_counts()
    timed = run_steps(state, steps)
    counts = flash_counts()
    peak = (torch.cuda.max_memory_allocated(state["device"]) / 1e9
            if state["device"].type == "cuda" else None)
    return {**summarize(state, timed),
            "warmup_losses": [s["loss"] for s in warm],
            "peak_mem_gb": peak, "launches": counts, "state": state}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", default="profiles/lora_trace.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = bench_llama_lora(None, args.batch, args.seq, args.steps,
                           args.warmup, args.seed)
    state = res.pop("state")
    if args.profile:
        res["profile"] = train_gpt2.profile_step(state, args.trace,
                                                 run=run_steps)
    cfg = state["cfg"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "phase": "train_llama_lora", "device": smi, "model": "llama_1b4",
        "dim": cfg.dim, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
        "head_dim": cfg.head_dim, "attention": cfg.attention,
        "remat": cfg.remat, "lora_rank": 8, "batch": args.batch,
        "seq": args.seq, **res,
    }), flush=True)


if __name__ == "__main__":
    main()
