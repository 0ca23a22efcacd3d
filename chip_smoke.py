#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels build for sm_90a) and `nvcc`.
Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit.
2. build: compile the port's CUDA sources with nvcc.
3. K5 (paged KV append) against its plain PyTorch version at the
   Llama-3-8B KV shape, bf16 / f32 / int8: pools bit-equal outside the
   scratch block.
4. K6 (paged decode attention) against its plain version at H=32,
   KV=8, hd=128, BS=16, B in {8, 32}, ragged positions up to 1024,
   shuffled tables; timed at B=32, bf16.
5. main path: Llama-3-8B at full width and depth (bf16, random weights
   from a seed) served by `LlamaEngine` to 8 concurrent requests, three
   of them sharing a 64-token prefix; the kernel launch counts of that
   run; decode_step_paged (kernels) against decode_step_vec (dense) at
   a mid-decode state; K5/K6 timed at the main path's shapes.
6. tiny parity: a tiny f32 engine on the card gives `generate`'s greedy
   tokens exactly.
7. K1-K4 (flash attention forward, fused backward, split dQ and dK/dV)
   against their plain versions at the training shape (BH 32*12, T
   1024, D 64) and at Llama's head width (BH 64, T 512, D 128), causal
   and full, f32 and bf16, plus a ragged T of 1000 (bf16, causal):
   element by element and by the relative norm of the difference.
8. training main path: GPT-2 124M at full width and depth (bf16 compute,
   f32 master weights, flash attention, full remat, bf16 logits),
   batch 32 x 1024, through `make_train_step`: 2 warm-up steps, then 5
   timed steps with the launch counts of exactly those steps (12 layers
   x (forward + remat replay) K1 and 12 K2 a step, no K3/K4, no plain
   dispatch); at full size, the step-0 loss and the gradients of the
   attention weights on the flash and dense routes.
9. split route: the flash op at the training shape with blocks of 256,
   forward and backward, so K3 + K4 run (their launch counts are this
   run's), against dense attention's autograd in f32.
10. route parity: tiny GPT-2 in f32, 3 train steps on the flash kernels
    against 3 on dense attention from the same params and tokens.
11. K1-K4 timed at the training shape (bf16, causal), beside their
    bounds, plain versions and `scaled_dot_product_attention`.
12. the kernels line, the `nvidia-smi` line, and the final result line.

Times are medians of CUDA-event timings of device work, with the 50 MB
L2 flushed (a 1 GiB write) before each launch.  Bounds use the H100 SXM's published 3.35 TB/s of
HBM and its dense peaks (989 TFLOP/s bf16, 67 TFLOP/s f32).
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.examples.serve_llm import _build_model
from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.parallel.ring_attention import plain_attention
from ray_tpu_torch.scripts import train_gpt2
from ray_tpu_torch.serve.llm_engine import LlamaEngine

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PAGED_SRC = "ray_tpu_torch/ops/csrc/paged_attention.cu"
FLASH_SRC = "ray_tpu_torch/ops/csrc/attention.cu"
SOURCES = {"paged_kv_append": PAGED_SRC, "paged_decode_attention": PAGED_SRC,
           "flash_fwd": FLASH_SRC, "flash_bwd_fused": FLASH_SRC,
           "flash_bwd_dq": FLASH_SRC, "flash_bwd_dkv": FLASH_SRC}
REPLACES = {"paged_kv_append": "ray_tpu/ops/paged_attention.py:93",
            "paged_decode_attention": "ray_tpu/ops/paged_attention.py:247",
            "flash_fwd": "ray_tpu/ops/attention.py:61",
            "flash_bwd_fused": "ray_tpu/ops/attention.py:202",
            "flash_bwd_dq": "ray_tpu/ops/attention.py:143",
            "flash_bwd_dkv": "ray_tpu/ops/attention.py:253"}
FLASH = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
# K6 tolerances: f32 to rounding; bf16 / int8 the reference's own
# (tests/test_paged_attention.py:78-79)
ATTN_TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
# K1-K4 against their plain versions, two measures per output: element
# by element, |kernel - plain| <= atol + rtol |plain| (as
# torch.testing.assert_close), and the norm of the difference over the
# plain version's norm, which a kernel wrong on a share of its rows
# cannot pass however small those rows' values are.  f32: tiled online
# softmax and tiled sums in another order, K2's dQ summed by f32 atomics
# in an order that changes from run to run.  bf16: P and dS rounded to
# bf16 at other running maxima, outputs rounded to bf16 (one ulp is
# 2^-8 of a value).  The relative-norm limits are about 3x the worst
# readings on an H100 (f32 7.5e-7, bf16 2.3e-3; PERF.md)
FLASH_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 3e-6},
             "bf16": {"rtol": 2e-2, "atol": 1e-2, "rel": 7e-3}}
# the split route in bf16 against dense attention in f32 on the same
# (bf16-valued) inputs: the bf16 route's own rounding against exact
# arithmetic.  Elements of dK and dV near zero are sums of up to 1024
# terms each rounded to bf16, so atol is twice the kernel checks'; the
# relative norm is about 3x the H100 reading of 3.0e-3
SPLIT_TOL = {"rtol": 2e-2, "atol": 2e-2, "rel": 1e-2}
# route parity (tiny GPT-2, f32, 3 AdamW steps, flash kernels vs dense):
# loss and grad norm rtol; params abs at lr / 10, because Adam divides
# each gradient by its own running magnitude, so a rounding difference
# in a small gradient moves its param by a fraction of lr.  The key
# bias's gradient is rounding noise around an exact zero (it adds the
# same q.b_k to every score of a row): that slice is held only to the
# most Adam can move a param, lr a step
ROUTE_LR = 1e-3
ROUTE_TOL = {"loss": 1e-4, "params": ROUTE_LR / 10, "key_bias": 3 * ROUTE_LR}
# full-size bf16 step 0, flash vs dense: the loss (bf16 rounding through
# 12 layers on a loss near ln 50257), and the relative norm of the
# difference of the attention weights' gradients.  The dense route
# rounds its scores and softmax to bf16, which the kernels keep in f32;
# the limit is about 3x the H100 reading of 1.08e-2 (PERF.md)
FULL_LOSS_TOL = 2e-2
FULL_GRAD_TOL = 3e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------------
# timing and bounds
# ----------------------------------------------------------------------
def time_ms(fn, iters: int = 25, cold: bool = True) -> float:
    """Median CUDA-event time of `fn` on the device, L2 flushed before
    each launch (the decode step streams ~0.5 GB of weights between two
    launches of a layer's kernel, so the real caller finds the cache
    cold).  The flush writes 1 GiB, ~0.3 ms of device time, so the host
    has enqueued `fn` and the closing event before the device reaches
    them: the events bracket device work, not the wrapper's host time.
    `cold=False` runs `fn` once more, untimed, after the flush, so the
    timed launch finds its inputs in L2."""
    flush = torch.empty(2 ** 30 // 4, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if not cold:
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def append_bound(case) -> tuple:
    """Bytes a call must move: each row inside the table's reach reads
    its new K and V (+ int8 scales) once and writes them once; plus
    pos and the one table entry per such row."""
    kp, k_new, tables, pos = (case["k_pool"], case["k_new"],
                              case["tables"], case["pos"])
    BS, KV, hd = kp.shape[2:]
    live = int(((pos >= 0) & (pos < tables.shape[1] * BS)).sum())
    row = KV * hd * k_new.element_size() + (
        KV * 4 if case["k_scale"] is not None else 0)
    n_bytes = 2 * 2 * live * row + 4 * pos.numel() + 4 * live
    return _bound(n_bytes, 0.0, torch.bfloat16)


def attention_bound(case) -> tuple:
    """Bytes: q read and o written once, each row's live K and V
    (pos + 1 columns, + int8 scales) read once, the table entries it
    walks, pos.  Operations: 4 * H * hd per live column (QK and PV)."""
    q, kp, tables, pos = case["q"], case["k_pool"], case["tables"], case["pos"]
    BS, KV, hd = kp.shape[2:]
    W = tables.shape[1]
    cols = (pos.long() + 1).clamp(min=0, max=W * BS)
    live = int(cols.sum())
    n_blocks = int(((cols + BS - 1) // BS).sum())
    per_col = 2 * KV * hd * kp.element_size() + (
        2 * KV * 4 if case["k_scale"] is not None else 0)
    n_bytes = (2 * q.numel() * q.element_size() + live * per_col
               + 4 * n_blocks + 4 * pos.numel())
    return _bound(n_bytes, 4.0 * q.shape[1] * hd * live, q.dtype)


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------
def _pool_like(shape, dtype, gen, device):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _scales(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device) * 0.05


def append_case(kind: str, device, *, L=32, B=8, W=16, BS=16, KV=8, hd=128,
                seed=0):
    """Pools with shuffled, non-contiguous tables; ragged positions, one
    row past the table's reach (dropped) and one idle row on scratch."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[kind]
    NB = 1 + B * W
    shape = (L, NB, BS, KV, hd)
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    pos = rng.integers(0, W * BS, size=B)
    pos[1] = W * BS + 3      # overshoots: writes nothing
    tables[2] = 0            # idle row: scratch block only
    pos[2] = 5
    case = {
        "k_pool": _pool_like(shape, dtype, gen, device),
        "v_pool": _pool_like(shape, dtype, gen, device),
        "k_new": _pool_like((B, KV, hd), dtype, gen, device),
        "v_new": _pool_like((B, KV, hd), dtype, gen, device),
        "tables": torch.as_tensor(tables, dtype=torch.int32, device=device),
        "pos": torch.as_tensor(pos, dtype=torch.int32, device=device),
        "layer": L - 1,
        "k_scale": None, "v_scale": None,
        "k_new_scale": None, "v_new_scale": None,
    }
    if kind == "int8":
        case["k_scale"] = _scales(shape[:-1], gen, device)
        case["v_scale"] = _scales(shape[:-1], gen, device)
        case["k_new_scale"] = _scales((B, KV), gen, device)
        case["v_new_scale"] = _scales((B, KV), gen, device)
    return case


def _run_append(fn, case, clone: bool):
    c = {k: (v.clone() if clone and torch.is_tensor(v) else v)
         for k, v in case.items()}
    out = fn(c["k_pool"], c["v_pool"], c["k_new"], c["v_new"], c["tables"],
             c["pos"], c["layer"], k_scale=c["k_scale"],
             v_scale=c["v_scale"], k_new_scale=c["k_new_scale"],
             v_new_scale=c["v_new_scale"])
    return out


def check_append(device) -> dict:
    """K5 against its plain version, bit-equal outside scratch block 0."""
    out = {}
    for kind in ("bf16", "f32", "int8"):
        case = append_case(kind, device, seed=len(out))
        got = _run_append(pa.paged_kv_append, case, clone=True)
        want = _run_append(pa.paged_kv_append_reference, case, clone=True)
        for g, w in zip(got, want):
            if not torch.equal(g[:, 1:], w[:, 1:]):
                raise AssertionError(f"K5 {kind}: pools differ outside "
                                     "the scratch block")
        changed = not torch.equal(got[0][:, 1:], case["k_pool"][:, 1:])
        if not changed:
            raise AssertionError(f"K5 {kind}: nothing was written")
        out[kind] = "bit-equal"
    return out


def attention_case(kind: str, device, *, B=8, max_pos=1024, L=4, H=32, KV=8,
                   hd=128, BS=16, seed=0):
    """Ragged positions up to max_pos (one row at max_pos) over shuffled
    block tables; q in bf16 for int8 pools."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    pool_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}[kind]
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    W = _cdiv(max_pos + 1, BS)
    NB = 1 + B * W
    shape = (L, NB, BS, KV, hd)
    pos = rng.integers(0, max_pos + 1, size=B)
    pos[0] = max_pos
    case = {
        "q": torch.randn((B, H, hd), generator=gen, device=device).to(q_dtype),
        "k_pool": _pool_like(shape, pool_dtype, gen, device),
        "v_pool": _pool_like(shape, pool_dtype, gen, device),
        "tables": torch.as_tensor(
            rng.permutation(np.arange(1, NB)).reshape(B, W),
            dtype=torch.int32, device=device),
        "pos": torch.as_tensor(pos, dtype=torch.int32, device=device),
        "layer": L - 1, "k_scale": None, "v_scale": None,
    }
    if kind == "int8":
        case["k_scale"] = _scales(shape[:-1], gen, device)
        case["v_scale"] = _scales(shape[:-1], gen, device)
    return case


def _run_attention(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["tables"],
              case["pos"], case["layer"], k_scale=case["k_scale"],
              v_scale=case["v_scale"])


def check_attention(case, kind: str) -> float:
    """K6 against its plain version at the stated tolerance; returns
    the max abs difference."""
    got = _run_attention(pa.paged_decode_attention, case).float()
    want = _run_attention(pa.paged_decode_attention_reference, case).float()
    tol = ATTN_TOL[kind]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return float((got - want).abs().max())


def dense_sdpa(case):
    """The yardstick: F.scaled_dot_product_attention over the same KV
    gathered dense (the gather is done here, outside the timed call)."""
    q, kp, vp, tables, pos = (case["q"], case["k_pool"], case["v_pool"],
                              case["tables"], case["pos"])
    B, H, hd = q.shape
    _, _, BS, KV, _ = kp.shape
    W = tables.shape[1]
    t = tables.long()
    k = kp[case["layer"]][t].reshape(B, W * BS, KV, hd)
    v = vp[case["layer"]][t].reshape(B, W * BS, KV, hd)
    if case["k_scale"] is not None:
        layer = case["layer"]
        k = pa.dequantize_int8(k, case["k_scale"][layer][t].reshape(
            B, W * BS, KV), q.dtype)
        v = pa.dequantize_int8(v, case["v_scale"][layer][t].reshape(
            B, W * BS, KV), q.dtype)
    k = k.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    cols = torch.arange(W * BS, device=q.device)
    mask = (cols[None, :] <= pos[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :].contiguous()
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def library_append(case):
    """The yardstick for K5: two `index_put_` calls (one per pool) on the
    rows the kernel writes."""
    kp, vp, tables, pos = (case["k_pool"], case["v_pool"], case["tables"],
                           case["pos"])
    BS = kp.shape[2]
    p = pos.long()
    ok = (p >= 0) & (p < tables.shape[1] * BS)
    rows = ok.nonzero()[:, 0]
    idx = (torch.full_like(rows, case["layer"]),
           tables[rows, p[rows] // BS].long(), p[rows] % BS)
    k_new, v_new = case["k_new"][rows], case["v_new"][rows]

    def run():
        kp.index_put_(idx, k_new)
        vp.index_put_(idx, v_new)
    return run


def time_kernels(app_case, attn_case) -> dict:
    """ms / plain_ms / bound_ms / library_ms of K5 and K6 on one case
    each (K5 rewrites the same rows each time: idempotent)."""
    a_bound, a_by = append_bound(app_case)
    k_bound, k_by = attention_bound(attn_case)
    return {
        "paged_kv_append": {
            "ms": time_ms(lambda: _run_append(pa.paged_kv_append, app_case,
                                              clone=False)),
            "plain_ms": time_ms(lambda: _run_append(
                pa.paged_kv_append_reference, app_case, clone=False)),
            "bound_ms": a_bound, "bound_by": a_by,
            "library_ms": time_ms(library_append(app_case)),
        },
        "paged_decode_attention": {
            "ms": time_ms(lambda: _run_attention(pa.paged_decode_attention,
                                                 attn_case)),
            "plain_ms": time_ms(lambda: _run_attention(
                pa.paged_decode_attention_reference, attn_case)),
            "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": time_ms(dense_sdpa(attn_case)),
        },
    }


# ----------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------
def main_path_prompts(vocab: int, seed: int = 0):
    """8 prompts of 16-200 tokens; prompts 2, 4 and 6 share a 64-token
    prefix, so the two later ones take the radix-hit suffix prefill."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, vocab, size=64)]
    prompts = []
    for i, n in enumerate((16, 40, 72, 96, 120, 150, 180, 200)):
        body = [int(t) for t in rng.integers(0, vocab, size=n)]
        prompts.append(prefix + body[:n - 64] if i in (2, 4, 6) else body)
    return prompts


def serve(engine: LlamaEngine, prompts, max_new_tokens: int) -> dict:
    """Submit every prompt at once and wait for all; a failed future
    raises.  Returns outputs, wall time, and the launch counts of the
    kernels taken over exactly this run."""
    d0 = engine.stats()["decode_kernel_dispatch_total"]
    reset_counts()
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens) for p in prompts]
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches = {"paged_kv_append": pa.paged_kv_append.launches,
                "paged_decode_attention": pa.paged_decode_attention.launches}
    stats = engine.stats()
    return {"outs": outs, "wall_s": wall, "launches": launches,
            "dispatches": stats["decode_kernel_dispatch_total"] - d0,
            "stats": stats}


def mid_decode_state(cfg, params, prompts, device, block_size=16, steps=3):
    """A decode state as the engine holds it: every prompt prefilled
    into shuffled pool blocks, then `steps` fused decode steps."""
    B, L = len(prompts), cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    need = _cdiv(max(len(p) for p in prompts) + steps + 1, block_size)
    W = 1 << (need - 1).bit_length()
    NB = 1 + B * W
    rng = np.random.default_rng(1)
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    k_pool = torch.zeros((L, NB, block_size, KV, hd), dtype=cfg.dtype,
                         device=device)
    v_pool = torch.zeros_like(k_pool)
    tok = torch.zeros(B, dtype=torch.int32, device=device)
    for b, p in enumerate(prompts):
        T = len(p)
        logits, (k1, v1) = llama.forward(
            cfg, params, torch.as_tensor([p], device=device), return_kv=True)
        nb = _cdiv(T, block_size)
        blk = torch.as_tensor(tables[b, :nb], device=device)
        kb = k1.new_zeros((L, nb * block_size, KV, hd))
        vb = v1.new_zeros((L, nb * block_size, KV, hd))
        kb[:, :T], vb[:, :T] = k1[:, 0], v1[:, 0]
        k_pool[:, blk] = kb.reshape(L, nb, block_size, KV, hd)
        v_pool[:, blk] = vb.reshape(L, nb, block_size, KV, hd)
        tok[b] = logits[0, -1].argmax()
    tables = torch.as_tensor(tables, dtype=torch.int32, device=device)
    pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    for _ in range(steps):
        logits = llama.decode_step_paged(cfg, params, tok, k_pool, v_pool,
                                         tables, pos)[0]
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    return {"k_pool": k_pool, "v_pool": v_pool, "tables": tables,
            "pos": pos, "tok": tok}


def compare_routes(cfg, params, state) -> dict:
    """decode_step_paged (kernels) against decode_step_vec (dense, over
    the same pool gathered): the max abs logit difference, and equal
    argmax on every row whose top-2 margin exceeds it."""
    kp, vp, tables = state["k_pool"], state["v_pool"], state["tables"]
    L, _, BS, KV, hd = kp.shape
    B, W = tables.shape
    t = tables.long()
    k_dense = kp[:, t].reshape(L, B, W * BS, KV, hd)
    v_dense = vp[:, t].reshape(L, B, W * BS, KV, hd)
    paged = llama.decode_step_paged(cfg, params, state["tok"], kp.clone(),
                                    vp.clone(), tables, state["pos"])[0]
    dense = llama.decode_step_vec(cfg, params, state["tok"],
                                  (k_dense, v_dense), state["pos"])[0]
    if not (torch.isfinite(paged).all() and paged.shape == dense.shape):
        raise AssertionError("paged logits not finite or misshapen")
    diff = float((paged - dense).abs().max())
    top = dense.topk(2, dim=-1).values
    decided = (top[:, 0] - top[:, 1]) > diff
    same = paged.argmax(-1) == dense.argmax(-1)
    if not bool(same[decided].all()):
        raise AssertionError("argmax differs on a row whose margin "
                             "exceeds the logit difference")
    return {"max_abs_logit_diff": diff,
            "max_abs_logit": float(dense.abs().max()), "rows": B,
            "rows_decided": int(decided.sum()),
            "argmax_equal_rows": int(same.sum())}


def run_main_path(cfg, params, device, *, slots=8, chunk=8, block_size=16,
                  max_len=512, max_new_tokens=32) -> dict:
    def make_engine():
        return LlamaEngine(cfg, params, slots=slots, chunk=chunk,
                           block_size=block_size, max_len=max_len,
                           decode_kernel="auto", device=device)

    # a throwaway engine takes the first-use costs (library handles,
    # kernel load), so the measured engine's TTFT window and counts
    # hold only the measured requests
    engine = make_engine()
    try:
        engine.submit(list(range(1, 9)), 4).result(timeout=900)
    finally:
        engine.shutdown()
    prompts = main_path_prompts(cfg.vocab_size)
    engine = make_engine()
    try:
        run = serve(engine, prompts, max_new_tokens)
    finally:
        engine.shutdown()
    st = run["stats"]
    need = cfg.n_layers * chunk * run["dispatches"]
    if st["decode_kernel"] != "kernel":
        raise AssertionError(f"decode_kernel resolved to "
                             f"{st['decode_kernel']!r}")
    if run["dispatches"] <= 0 or st["decode_fallback_dispatch_total"] != 0:
        raise AssertionError("the run did not take the kernel route only")
    for name, n in run["launches"].items():
        if n < need:
            raise AssertionError(f"{name}: {n} launches < L x chunk x "
                                 f"dispatches = {need}")
    for out in run["outs"]:
        if len(out) != max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in out):
            raise AssertionError("malformed engine output")
    n_tok = sum(len(o) for o in run["outs"])
    return {
        "prompts": prompts, "launches": run["launches"],
        "line": {
            "phase": "main_path",
            "model": "llama3_8b", "dim": cfg.dim, "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "intermediate": cfg.intermediate, "vocab": cfg.vocab_size,
            "dtype": str(cfg.dtype).replace("torch.", ""),
            "depth_cut": False,
            "requests": len(prompts), "max_new_tokens": max_new_tokens,
            "prompt_lens": [len(p) for p in prompts],
            "decode_kernel": st["decode_kernel"],
            "decode_kernel_dispatch_total": run["dispatches"],
            "decode_fallback_dispatch_total":
                st["decode_fallback_dispatch_total"],
            "launches": run["launches"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "wall_s": run["wall_s"],
            "tokens_per_s": n_tok / run["wall_s"],
            "ttft_p50_s": st["ttft_p50_s"],
            "ttft_p90_s": st["ttft_p90_s"],
        },
    }


def tiny_parity(device) -> dict:
    """A tiny f32 engine (kernel route) on the card against greedy
    `generate`: tokens equal, prefix cache on, more requests than
    slots."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32)
    params = llama.init_params(cfg, 0, device=device)
    rng = np.random.default_rng(42)
    shared = [int(t) for t in rng.integers(0, 128, size=16)]
    prompts = [[int(t) for t in rng.integers(0, 128, size=int(n))]
               for n in rng.integers(1, 24, size=7)]
    prompts[3] = shared + [5, 6]
    prompts[5] = shared + [7]
    engine = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=8,
                         max_len=64, device=device)
    try:
        outs = [f.result(timeout=300)
                for f in [engine.submit(p, 9) for p in prompts]]
    finally:
        engine.shutdown()
    want = [llama.generate(cfg, params, [p], 9, device=device)[0].tolist()
            for p in prompts]
    if outs != want:
        raise AssertionError(f"tiny f32 engine != generate: {outs} vs {want}")
    return {"phase": "tiny_parity", "requests": len(prompts),
            "tokens_equal_generate": True}


# ----------------------------------------------------------------------
# flash attention (K1-K4)
# ----------------------------------------------------------------------
def flash_case(BH, T, D, dtype, causal, device, seed=0) -> dict:
    """Seeded q, k, v, dO [BH, T, D] and the plain forward's O, LSE and
    delta: the inputs each backward kernel shares with its plain
    version."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn((BH, T, D), generator=gen,
                               device=device).to(dtype) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return {"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse,
            "delta": delta, "causal": causal, "scale": scale}


def run_flash(name: str, c: dict, plain: bool = False) -> tuple:
    fn = getattr(fa, name + "_reference" if plain else name)
    args = (c["q"], c["k"], c["v"])
    if name == "flash_bwd_fused":
        args += (c["do"], c["lse"], c["o"])
    elif name != "flash_fwd":
        args += (c["do"], c["lse"], c["delta"])
    out = fn(*args, c["causal"], c["scale"])
    return out if isinstance(out, tuple) else (out,)


def compare(got, want, tol: dict) -> tuple:
    """(max abs error, max |got - want| / (atol + rtol |want|), norm of
    the difference / norm of want), in f32; the second must stay <= 1
    and the third <= tol["rel"]."""
    g, w = got.detach().float(), want.detach().float()
    d = (g - w).abs()
    return (float(d.max()),
            float((d / (tol["atol"] + tol["rtol"] * w.abs())).max()),
            float(torch.linalg.vector_norm(g - w)
                  / torch.linalg.vector_norm(w)))


def within(errs, tol: dict) -> bool:
    return errs[1] <= 1.0 and errs[2] <= tol["rel"]


def check_flash(c: dict, kind: str) -> dict:
    """K1-K4 each against its plain version on the same inputs.  Returns
    {name: (max abs err, elementwise ratio, relative norm)}, each the
    worst over the kernel's outputs; raises beyond FLASH_TOL[kind]."""
    tol, out = FLASH_TOL[kind], {}
    for name in FLASH:
        got, want = run_flash(name, c), run_flash(name, c, plain=True)
        worst = (0.0, 0.0, 0.0)
        for g, w in zip(got, want):
            if (g.shape != w.shape or g.dtype != w.dtype
                    or not bool(torch.isfinite(g.float()).all())):
                raise AssertionError(f"{name}: misshapen or non-finite")
            worst = tuple(map(max, worst, compare(g, w, tol)))
        if not within(worst, tol):
            raise AssertionError(f"{name} {kind}: (max abs, elementwise "
                                 f"ratio, rel norm) {worst} beyond {tol}")
        out[name] = worst
    return out


def flash_bound(name: str, c: dict) -> tuple:
    """Operations: 2 * D per (q, k) pair per product, over the pairs
    this call needs (the lower triangle with the diagonal when causal);
    K1 does 2 products, K2 5, K3 3, K4 4.  Bytes: each input read once,
    each output written once."""
    BH, T, D = c["q"].shape
    pairs = BH * (T * (T + 1) // 2 if c["causal"] else T * T)
    mats = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4}[name]
    n = BH * T * D * c["q"].element_size()
    vec = BH * T * 4
    n_bytes = {"flash_fwd": 4 * n + vec, "flash_bwd_fused": 8 * n + vec,
               "flash_bwd_dq": 5 * n + 2 * vec,
               "flash_bwd_dkv": 6 * n + 2 * vec}[name]
    return _bound(n_bytes, 2.0 * D * pairs * mats, c["q"].dtype)


def sdpa_yardsticks(c: dict, H: int) -> tuple:
    """`scaled_dot_product_attention` on the same inputs as [B, H, T, D]:
    its forward ms, and its backward ms (forward + backward minus
    forward)."""
    BH, T, D = c["q"].shape
    shape = (BH // H, H, T, D)
    q, k, v, do = (c[n].view(shape) for n in ("q", "k", "v", "do"))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        F.scaled_dot_product_attention(q, k, v, is_causal=c["causal"])

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg,
                                             is_causal=c["causal"])
        torch.autograd.grad(out, (qg, kg, vg), do)

    f = time_ms(fwd)
    return f, time_ms(fwd_bwd) - f


def time_flash(c: dict, H: int) -> dict:
    """ms / plain_ms / bound_ms / library_ms of K1-K4 on one case.  The
    library call for K1 is SDPA's forward, for K2 its backward; no one
    call computes K3's or K4's function alone (SDPA's backward is the
    pair's yardstick, in the phase line)."""
    lib_fwd, lib_bwd = sdpa_yardsticks(c, H)
    out = {}
    for name in FLASH:
        bound, by = flash_bound(name, c)
        out[name] = {
            "ms": time_ms(lambda: run_flash(name, c)),
            "plain_ms": time_ms(lambda: run_flash(name, c, plain=True)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": {"flash_fwd": lib_fwd,
                           "flash_bwd_fused": lib_bwd}.get(name),
        }
    return out, lib_bwd


def reset_counts() -> None:
    for name in FLASH:
        getattr(fa, name).launches = 0
    fa.flash_attention.plain_dispatches = 0
    pa.paged_kv_append.launches = 0
    pa.paged_decode_attention.launches = 0


def read_counts() -> dict:
    return {name: getattr(fa, name).launches for name in FLASH}


# ----------------------------------------------------------------------
# the training main path
# ----------------------------------------------------------------------
def route_grads(cfg, params, tokens) -> tuple:
    """The loss and the gradients of the attention weights, qkv (which
    only the attention backward reaches) and out (fed by its forward)."""
    names = ("attn_qkv_w", "attn_out_w")
    ws = [params["blocks"][n].requires_grad_(True) for n in names]
    loss = gpt2.loss_fn(cfg, params, tokens)
    grads = torch.autograd.grad(loss, ws)
    return float(loss.detach()), dict(zip(names, grads))


def run_training(device, *, cfg=None, batch=32, seq=1024, warmup=2,
                 steps=5) -> dict:
    """GPT-2 (124M by default) through `make_train_step`: the step-0 loss
    and attention-weight gradients on the flash and dense routes from
    the initial params, `warmup` steps, then `steps` timed steps with
    the counts of exactly those steps."""
    state = train_gpt2.build(device, batch, seq, seed=0, cfg=cfg)
    cfg = state["cfg"]
    routes = {a: route_grads(dataclasses.replace(cfg, attention=a),
                             state["params"], state["tokens"])
              for a in ("flash", "dense")}
    (loss_flash, g_flash), (loss_dense, g_dense) = (routes["flash"],
                                                    routes["dense"])
    grad_err = {n: float(torch.linalg.vector_norm(g_flash[n] - g_dense[n])
                         / torch.linalg.vector_norm(g_dense[n]))
                for n in g_dense}
    del routes, g_flash, g_dense
    if (abs(loss_flash - loss_dense) > FULL_LOSS_TOL
            or max(grad_err.values()) > FULL_GRAD_TOL):
        raise AssertionError(f"step 0, flash vs dense: loss {loss_flash} "
                             f"vs {loss_dense}, grads {grad_err}")
    warm = train_gpt2.run_steps(state, warmup)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    timed = train_gpt2.run_steps(state, steps)
    launches = read_counts()
    plain = fa.flash_attention.plain_dispatches
    want = {"flash_fwd": steps * cfg.n_layer * 2,
            "flash_bwd_fused": steps * cfg.n_layer,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want or plain != 0:
        raise AssertionError(f"training launches {launches} (want {want}), "
                             f"plain dispatches {plain}")
    summary = train_gpt2.summarize(state, timed)
    losses = [s["loss"] for s in warm] + summary["losses"]
    if not all(math.isfinite(x) for x in losses + summary["grad_norms"]):
        raise AssertionError(f"non-finite training metrics: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]} far from "
                             f"ln V = {math.log(cfg.vocab_size)}")
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return {"launches": launches, "line": {
        "phase": "train_main_path", "model": "gpt2_124m",
        "n_layer": cfg.n_layer, "n_embd": cfg.n_embd, "n_head": cfg.n_head,
        "vocab": cfg.vocab_size, "dtype": str(cfg.dtype).replace(
            "torch.", ""), "master_dtype": "float32",
        "logits_dtype": str(cfg.logits_dtype).replace("torch.", ""),
        "attention": cfg.attention, "remat_policy": cfg.remat_policy,
        "depth_cut": False, "batch": batch, "seq": seq,
        "warmup_steps": warmup, "timed_steps": steps,
        "step0_loss": losses[0], "step0_loss_flash": loss_flash,
        "step0_loss_dense": loss_dense,
        "step0_grad_rel_err_flash_vs_dense": grad_err,
        "step0_tolerance": {"loss": FULL_LOSS_TOL, "grad": FULL_GRAD_TOL},
        "launches": launches, "launches_want": want,
        "plain_dispatches": plain, "peak_mem_gb": peak,
        **{k: summary[k] for k in ("tokens_per_step", "n_params", "step_ms",
                                   "losses", "grad_norms", "tokens_per_s",
                                   "mfu")},
    }}


def split_route(device, *, B=32, T=1024, H=12, D=64, block=256) -> dict:
    """The flash op with blocks of 256 at the training shape (bf16),
    forward and backward: K1, then K3 + K4 with delta from the wrapper.
    Held against dense attention's autograd in f32 on the same inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    q, k, v, w = (torch.randn((B, T, H, D), generator=gen, device=device)
                  for _ in range(4))
    xs = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    reset_counts()
    out = fa.flash_attention(*xs, True, block, block)
    grads = torch.autograd.grad(out, xs, w.to(torch.bfloat16))
    launches = read_counts()
    if (launches["flash_bwd_dq"] != 1 or launches["flash_bwd_dkv"] != 1
            or launches["flash_bwd_fused"] != 0
            or fa.flash_attention.plain_dispatches != 0):
        raise AssertionError(f"split route launches {launches}")
    ref = [t.detach().float().requires_grad_(True) for t in xs]
    dense = plain_attention(*ref, causal=True)
    want = (dense, *torch.autograd.grad(dense, ref, w))
    errs = {n: compare(g, r, SPLIT_TOL)
            for n, g, r in zip(("out", "dq", "dk", "dv"), (out, *grads), want)}
    if not all(within(e, SPLIT_TOL) for e in errs.values()):
        raise AssertionError(f"split route vs dense: {errs}")
    return {"launches": launches, "line": {
        "phase": "split_route", "B": B, "T": T, "H": H, "D": D,
        "block_q": block, "block_k": block, "dtype": "bfloat16",
        "launches": launches,
        "max_abs_elementwise_relnorm": errs, "tolerance": SPLIT_TOL}}


def route_parity(device, steps=3) -> dict:
    """Tiny GPT-2 in f32: `steps` AdamW steps on the flash kernels and on
    dense attention, from the same params and tokens."""
    base = dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, base.vocab_size, (4, 129)), dtype=torch.int32, device=device)
    runs = {}
    for attention in ("flash", "dense"):
        cfg = dataclasses.replace(base, attention=attention)
        params = gpt2.init_params(cfg, 0, device=device)
        opt = gpt2.default_optimizer(lr=ROUTE_LR, warmup_steps=1,
                                     total_steps=10)
        state, step = opt.init(params), gpt2.make_train_step(cfg, opt)
        metrics = []
        for _ in range(steps):
            params, state, m = step(params, state, tokens)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[attention] = (metrics, params)
    (mf, pf), (md, pd) = runs["flash"], runs["dense"]
    metric_err = max(abs(a - b) / abs(b) for x, y in zip(mf, md)
                     for a, b in zip(x, y))
    E = base.n_embd
    with torch.no_grad():
        kb_err = float((pf["blocks"]["attn_qkv_b"][:, E:2 * E]
                        - pd["blocks"]["attn_qkv_b"][:, E:2 * E]).abs().max())
        for p in (pf, pd):
            p["blocks"]["attn_qkv_b"][:, E:2 * E] = 0.0
        param_err = max(float((a - b).abs().max())
                        for a, b in zip(gpt2._leaves(pf), gpt2._leaves(pd)))
    if (metric_err > ROUTE_TOL["loss"] or param_err > ROUTE_TOL["params"]
            or kb_err > ROUTE_TOL["key_bias"]):
        raise AssertionError(f"flash vs dense: metrics {metric_err}, "
                             f"params {param_err}, key bias {kb_err}")
    return {"phase": "route_parity", "model": "gpt2_tiny_f32",
            "steps": steps, "losses_flash": [m[0] for m in mf],
            "losses_dense": [m[0] for m in md],
            "max_rel_err_loss_gnorm": metric_err,
            "max_abs_err_params": param_err,
            "max_abs_err_key_bias": kb_err, "tolerance": ROUTE_TOL}


# ----------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built})

    emit({"phase": "K5_vs_plain", "shape": "L=32 B=8 W=16 BS=16 KV=8 hd=128",
          **check_append(device)})

    for B in (8, 32):
        errs = {}
        for kind_ in ("f32", "bf16", "int8"):
            case = attention_case(kind_, device, B=B, seed=B)
            errs[kind_] = check_attention(case, kind_)
        line = {"phase": "K6_vs_plain", "B": B, "H": 32, "KV": 8, "hd": 128,
                "BS": 16, "max_pos": 1024, "max_abs_err": errs,
                "tolerance": ATTN_TOL}
        if B == 32:
            case = attention_case("bf16", device, B=B, seed=B)
            bound, by = attention_bound(case)
            line.update({
                "bf16_ms": time_ms(lambda: _run_attention(
                    pa.paged_decode_attention, case)),
                "bf16_plain_ms": time_ms(lambda: _run_attention(
                    pa.paged_decode_attention_reference, case)),
                "bf16_bound_ms": bound, "bf16_bound_by": by,
                "bf16_library_ms": time_ms(dense_sdpa(case)),
            })
        emit(line)
        del case
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params = _build_model("llama3_8b", seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    served = run_main_path(cfg, params, device)
    emit({**served["line"], "init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    with torch.no_grad():
        state = mid_decode_state(cfg, params, served["prompts"], device)
        routes = compare_routes(cfg, params, state)
        # K5 / K6 at the main path's shapes, on that state's layer-0 pool
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        B, KV, hd = state["tok"].shape[0], cfg.n_kv_heads, cfg.head_dim
        app_case = {
            "k_pool": state["k_pool"], "v_pool": state["v_pool"],
            "k_new": torch.randn((B, KV, hd), generator=gen,
                                 device=device).to(cfg.dtype),
            "v_new": torch.randn((B, KV, hd), generator=gen,
                                 device=device).to(cfg.dtype),
            "tables": state["tables"], "pos": state["pos"], "layer": 0,
            "k_scale": None, "v_scale": None, "k_new_scale": None,
            "v_new_scale": None,
        }
        attn_case = {
            "q": torch.randn((B, cfg.n_heads, hd), generator=gen,
                             device=device).to(cfg.dtype),
            "k_pool": state["k_pool"], "v_pool": state["v_pool"],
            "tables": state["tables"], "pos": state["pos"], "layer": 0,
            "k_scale": None, "v_scale": None,
        }
        attn_err = check_attention(attn_case, "bf16")
        timings = time_kernels(app_case, attn_case)
        # K6 with its live KV (~7.6 MB) warm in L2: separates memory
        # latency from the walk's per-step compute and barriers
        k6_warm = time_ms(lambda: _run_attention(pa.paged_decode_attention,
                                                 attn_case), cold=False)
    emit({"phase": "mid_decode_routes", **routes,
          "paged_decode_attention_warm_l2_ms": k6_warm,
          "kernel_shapes": {"B": B, "W": int(state["tables"].shape[1]),
                            "pos": state["pos"].tolist()}})
    del params, state
    torch.cuda.empty_cache()

    emit(tiny_parity(device))

    # K1-K4 against their plain versions
    flash_errs = {}
    for BH, T, D, kind_, causal in (
            [(32 * 12, 1024, 64, k, c) for k in ("f32", "bf16")
             for c in (True, False)]
            + [(64, 512, 128, k, c) for k in ("f32", "bf16")
               for c in (True, False)]
            + [(48, 1000, 64, "bf16", True)]):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind_]
        case = flash_case(BH, T, D, dt, causal, device, seed=T + D)
        errs_ = check_flash(case, kind_)
        emit({"phase": "K1-K4_vs_plain", "BH": BH, "T": T, "D": D,
              "dtype": kind_, "causal": causal, "ragged": T % 64 != 0,
              "max_abs_elementwise_relnorm": errs_,
              "tolerance": FLASH_TOL[kind_]})
        if (T, kind_, causal) == (1024, "bf16", True):
            flash_errs = {n: e[0] for n, e in errs_.items()}
        del case
    torch.cuda.empty_cache()

    # the training main path, then the split route (K3 + K4)
    t0 = time.perf_counter()
    trained = run_training(device)
    emit({**trained["line"], "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    split = split_route(device)
    emit(split["line"])
    emit(route_parity(device))
    torch.cuda.empty_cache()

    case = flash_case(32 * 12, 1024, 64, torch.bfloat16, True, device)
    flash_t, sdpa_bwd = time_flash(case, H=12)
    emit({"phase": "K1-K4_timed", "BH": 32 * 12, "T": 1024, "D": 64,
          "dtype": "bf16", "causal": True, **{
              name: flash_t[name] for name in FLASH},
          "k3_plus_k4_ms": flash_t["flash_bwd_dq"]["ms"]
          + flash_t["flash_bwd_dkv"]["ms"], "sdpa_bwd_ms": sdpa_bwd})
    del case
    timings.update(flash_t)
    launches = {**served["launches"], **trained["launches"],
                "flash_bwd_dq": split["launches"]["flash_bwd_dq"],
                "flash_bwd_dkv": split["launches"]["flash_bwd_dkv"]}

    errs = {"paged_kv_append": 0.0, "paged_decode_attention": attn_err,
            **flash_errs}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], **timings[name]}
        for name in ("paged_kv_append", "paged_decode_attention", *FLASH)
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
