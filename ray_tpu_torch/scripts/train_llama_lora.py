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

`dp_train_loop` is the same step as a `CudaTrainer` worker's train loop
(`ingest_train_loop` the same again, fed by the trainer's dataset shard):
each worker takes its share of the global batch, and the adapters'
gradients are mean-allreduced over the workers (the collective group
through `cuda_utils.sync_gradients` in the "collective" mode, the
process group through `collectives.pmean` in the "torch_distributed"
mode) before every AdamW update, so every worker holds the same adapters
after every step.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.models.bridge import params_from_numpy, params_to_numpy
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
          cfg: llama.LlamaConfig = None, *, params=None, lora=None,
          tokens=None) -> Dict:
    """The frozen bf16 base, the adapters, the optimizer state, the step
    and one batch of random tokens, all from `seed`; `params`, `lora`
    and `tokens` (numpy trees) take the place of the drawn ones."""
    device = resolve_device(device)
    cfg = cfg or lora_config()
    if params is None:
        params = llama.init_params(cfg, seed, device=device,
                                   dtype=torch.bfloat16)
    else:
        params = params_from_numpy(params, device)
    if lora is None:
        lora = llama.init_lora(cfg, seed + 1, rank=8, device=device)
    else:
        lora = params_from_numpy(lora, device)
    opt = adamw()
    if tokens is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 2)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                               generator=gen, device=device,
                               dtype=torch.int32)
    else:
        tokens = torch.as_tensor(tokens, device=device)
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


def lora_grads(state: Dict, tokens: torch.Tensor):
    """The loss on `tokens` and the gradient of every adapter leaf (in
    `_leaves` order, as the optimizer takes them)."""
    leaves = gpt2._leaves(state["lora"])
    for p in leaves:
        p.requires_grad_(True)
    loss = llama.loss_fn(state["cfg"], state["params"], tokens,
                         lora=state["lora"])
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), list(grads)


def digest(tree: Dict) -> str:
    """sha256 of every leaf's bytes in `_leaves` order: equal trees,
    bit for bit, give equal digests."""
    return digest_arrays(t.detach().cpu().numpy() for t in gpt2._leaves(tree))


def digest_arrays(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _restore(state: Dict, saved: Dict) -> int:
    """The adapters and the optimizer state from a checkpoint's dict;
    returns the step to go on from."""
    for t, a in zip(gpt2._leaves(state["lora"]),
                    gpt2._leaves(saved["lora"])):
        t.copy_(torch.from_numpy(np.asarray(a)))
    for name in ("mu", "nu"):
        for t, a in zip(state["opt_state"][name], saved[name]):
            t.copy_(torch.from_numpy(np.asarray(a)))
    state["opt_state"]["count"] = int(saved["count"])
    return int(saved["step"])


def _process_group_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the world process group of each tensor: one f32
    all-reduce of them all flattened (`collectives.pmean`), cut back
    into each tensor's shape and dtype."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import collectives

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = collectives.pmean(flat, dist.group.WORLD)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def _synced(grads: List[torch.Tensor], loss: torch.Tensor, over_pg: bool):
    """The gradients mean-allreduced over the workers (the process group
    when `over_pg`, else the host collective group), the loss averaged
    over them, and the sync's phases in ms."""
    if over_pg:
        t_sync = time.perf_counter()
        synced = _process_group_mean(grads + [loss.reshape(1)])
        global_loss = float(synced.pop())
        return synced, global_loss, {
            "allreduce": (time.perf_counter() - t_sync) * 1e3}
    from ray_tpu_torch.train.cuda_utils import (
        LAST_SYNC_MS, sync_gradients, world_mean)

    synced = sync_gradients(grads)
    return synced, world_mean(float(loss)), dict(LAST_SYNC_MS)


def dp_train_loop(config: Dict) -> None:
    """A `CudaTrainer` worker's loop: the LoRA step on this worker's
    share of the global batch, the adapters' gradients mean-allreduced
    over the workers before each update: over the host collective group
    in the "collective" mode, over the process group in the
    "torch_distributed" mode.

    `config`: `device` (default the card), `batch` / `seq` / `seed` /
    `cfg` as `build` takes them (or numpy `params` / `lora` / `tokens`),
    `steps` (the step to stop before: a resumed run goes on from its
    checkpoint's step) and `out_dir` (each rank appends one JSON line a
    step to `rank{r}.jsonl`: loss, wall ms, the sync's phases, the flash
    launches, peak memory, the adapters' digest; a line at a resume,
    and one naming the mesh `get_mesh()` builds when the workers share
    a process group; rank 0 writes its first step's synced gradient to
    `grad0.npz`).  Rank 0 reports the adapters, the optimizer state and
    the step as a checkpoint every step."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    loop_entry = time.time()
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = resolve_device(config.get("device"))
    out_dir: Optional[str] = config.get("out_dir")

    def record(rec: Dict) -> None:
        if out_dir:
            with open(os.path.join(out_dir, f"rank{rank}.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")

    import torch.distributed as dist

    # the "torch_distributed" mode: no host collective group, the process
    # group carries the gradients
    over_pg = dist.is_initialized()
    if over_pg:
        mesh = ctx.get_mesh()
        record({"mesh": {"device_type": mesh.device_type,
                         "shape": list(mesh.mesh.shape),
                         "dims": list(mesh.mesh_dim_names),
                         "backend": str(dist.get_backend())}})
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    state = build(device, config.get("batch", 8), config.get("seq", 1024),
                  config.get("seed", 0), config.get("cfg"),
                  params=config.get("params"), lora=config.get("lora"),
                  tokens=config.get("tokens"))
    B = state["tokens"].shape[0]
    if B % world:
        raise ValueError(f"global batch {B} does not split over {world}")
    b = B // world
    tokens = state["tokens"][rank * b:(rank + 1) * b]
    start = 0
    resume = train.get_checkpoint()
    if resume is not None:
        start = _restore(state, resume.to_dict())
        record({"resumed_from": start,
                "digest_at_resume": digest(state["lora"])})
    opt = adamw()
    for step in range(start, config["steps"]):
        t_start = time.time()
        reset_flash_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        loss, grads = lora_grads(state, tokens)
        synced, global_loss, sync_ms = _synced(grads, loss, over_pg)
        state["opt_state"], _ = opt.update(synced, state["opt_state"],
                                           state["lora"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"rank": rank, "world": world, "step": step + 1,
               "loss": float(loss), "global_loss": global_loss,
               "ms": ms, "sync_ms": sync_ms,
               "launches": flash_counts(), "digest": digest(state["lora"]),
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
               "loop_entry": loop_entry, "t_start": t_start}
        if out_dir and step == start and rank == 0:
            np.savez(os.path.join(out_dir, "grad0.npz"),
                     *[g.float().cpu().numpy() for g in synced])
        record(rec)
        ck = None
        if rank == 0:
            ck = Checkpoint.from_dict({
                "lora": params_to_numpy(state["lora"]),
                "mu": [t.cpu().numpy() for t in state["opt_state"]["mu"]],
                "nu": [t.cpu().numpy() for t in state["opt_state"]["nu"]],
                "count": state["opt_state"]["count"], "step": step + 1})
        train.report({"step": step + 1, "loss": rec["loss"],
                      "global_loss": rec["global_loss"], "ms": ms},
                     checkpoint=ck)


def row_digest(tokens: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each row's `tokens @ w % (2**31 - 1)` in int64, as an elementwise
    product and a sum (no int64 matmul on the card)."""
    return (tokens.long() * w).sum(-1) % (2**31 - 1)


def ingest_train_loop(config: Dict) -> None:
    """A `CudaTrainer` worker's loop fed by its dataset shard: each step
    takes the next `batch` rows of `get_dataset_shard("train")` through
    `iter_cuda_batches` and runs the LoRA step on their `tokens`, the
    adapters' gradients synced over the workers as in `dp_train_loop`.

    `config`: `device`, `seed`, `cfg` (or numpy `params` / `lora`) as
    `build` takes them, `steps`, `batch` (rows a step a worker), `lr`
    (AdamW's, default 2e-4), `digest_w` (when given, each row's `digest`
    column is checked against `row_digest` of its tokens on the device,
    and recorded), `out_dir` (each rank appends one JSON line a step to
    `rank{r}.jsonl`; rank 0 writes its first step's synced gradient to
    `grad0.npz`).  Every step reports
    the same record: loss, lr, wall ms, the ingest wait (ms inside
    `next()`), the batch's `row_id` column (when it has one), its
    device, dtype and shape, the flash launches, peak memory and the
    adapters' digest."""
    import torch.distributed as dist

    from ray_tpu_torch import train

    loop_entry = time.time()
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = resolve_device(config.get("device"))
    out_dir: Optional[str] = config.get("out_dir")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    b = config.get("batch", 4)
    state = build(device, b, 1, config.get("seed", 0), config.get("cfg"),
                  params=config.get("params"), lora=config.get("lora"))
    w = config.get("digest_w")
    if w is not None:
        w = torch.as_tensor(np.asarray(w, np.int64), device=device)
    lr = config.get("lr", 2e-4)
    opt = adamw(lr)
    shard = train.get_dataset_shard("train")
    it = iter(shard.iter_cuda_batches(batch_size=b, device=device))
    over_pg = dist.is_initialized()
    for step in range(config["steps"]):
        t_start = time.time()
        reset_flash_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        batch = next(it, None)
        wait_ms = (time.perf_counter() - t0) * 1e3
        if batch is None:
            raise RuntimeError(f"rank {rank}: the dataset shard ran out "
                               f"at step {step + 1}")
        tokens = batch["tokens"]
        checks = {"device": str(tokens.device),
                  "dtype": str(tokens.dtype).replace("torch.", ""),
                  "shape": list(tokens.shape)}
        if w is not None:
            checks["digest_ok"] = bool(torch.equal(
                row_digest(tokens, w), batch["digest"].long()))
            checks["row_digests"] = batch["digest"].cpu().tolist()
        loss, grads = lora_grads(state, tokens)
        synced, global_loss, sync_ms = _synced(grads, loss, over_pg)
        state["opt_state"], _ = opt.update(synced, state["opt_state"],
                                           state["lora"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = time.time()
        rec = {"rank": rank, "world": world, "step": step + 1,
               "loss": float(loss), "global_loss": global_loss, "lr": lr,
               "ms": (time.perf_counter() - t0) * 1e3, "wait_ms": wait_ms,
               "sync_ms": sync_ms,
               "row_ids": (batch["row_id"].cpu().tolist()
                           if "row_id" in batch else None), **checks,
               "launches": flash_counts(), "digest": digest(state["lora"]),
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
               "loop_entry": loop_entry, "t_start": t_start, "t_end": t_end}
        if out_dir:
            with open(os.path.join(out_dir, f"rank{rank}.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
            if step == 0 and rank == 0:
                np.savez(os.path.join(out_dir, "grad0.npz"),
                         *[g.float().cpu().numpy() for g in synced])
        train.report(rec)


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
