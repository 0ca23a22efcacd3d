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
   shuffled tables; timed at B=32, bf16, beside its bound and SDPA over
   the same KV gathered dense, with K6's split plan; then at hd 1,032
   (the wide-head kernel) and at tables of 65,540 blocks (splits past
   the 1,024 staged table entries), f32 and bf16, the fused append +
   attention there too.  The decode step launches neither K5 nor K6 on
   its own, so their launch counts on the kernels line are these
   checks'.
5. main path: Llama-3-8B at full width and depth (bf16, random weights
   from a seed) served by `LlamaEngine` to 8 concurrent requests, three
   of them sharing a 64-token prefix; the kernel launch counts of that
   run (32 fused append + attention launches a decode step, no K5 or K6
   of their own); decode_step_paged (kernels) against decode_step_vec
   (dense) at a mid-decode state; K5/K6 timed at the main path's shapes
   (K6 with the L2 cold and warm, beside its bound and SDPA, with its
   split plan).  K5K6_fused_vs_pair: the fused op (K5 folded into K6's
   launch) against K5 then K6 on cloned pools, bit-equal (outputs, and
   pools outside the scratch block), and against its plain version, in
   f32, bf16 and int8 at the mid-decode state and at B 32 with rows to
   1,024; timed beside K5 then K6, K6 alone and an empty kernel.
6. tiny parity: a tiny f32 engine on the card gives `generate`'s greedy
   tokens exactly.
7. K1-K4 (flash attention forward, fused backward, split dQ and dK/dV)
   against their plain versions at the training shape (BH 32*12, T
   1024, D 64) and at Llama's head width (BH 64, T 512, D 128), causal
   and full, f32 and bf16, plus a ragged T of 1000 (bf16, causal, D 64
   and 128), and heads of 712 and 1,032 (f32 and bf16, BH 2, T 256: the
   first design cut into column slices): element by element and by the
   relative norm of the difference.
8. training main path: GPT-2 124M at full width and depth (bf16 compute,
   f32 master weights, flash attention, full remat, bf16 logits),
   batch 32 x 1024, through `make_train_step`: 2 warm-up steps, then 5
   timed steps with the launch counts of exactly those steps (12 layers
   x (forward + remat replay) K1 and 12 K2 a step, no K3/K4, no plain
   dispatch); at full size, the step-0 loss and the gradients of the
   attention weights on the flash and dense routes.
9. split route: the flash op at the training shape with blocks of 256,
   and at the reference's own split route (default blocks of 1,024 at T
   4,096, B 1, H 32, D 128: Llama-3-8B's head width), forward and
   backward, so K3 + K4 run once each per case (their launch counts are
   these runs', summed in the kernels line), against dense attention's
   autograd in f32.
10. route parity: tiny GPT-2 in f32, 3 train steps on the flash kernels
    against 3 on dense attention from the same params and tokens.
11. K1-K4 timed at the training shape (bf16, causal), and K3 and K4 at
    the second split shape (BH 32, T 4,096, D 128), beside their bounds,
    plain versions and `scaled_dot_product_attention`, with each
    kernel's achieved TFLOP/s, its time over its bound and over SDPA's
    (forward for K1, backward for K2-K4).
12. K7-K9 (the fused cross entropy's forward, dx and dw) against their
    plain versions at GPT-2 124M's head (N 32,768, E 768, V 50,257;
    bf16 x with the f32 master w, and all f32), at Llama-3-8B's head (N
    4,096, E 4,096, V 128,256, bf16), at a ragged N 200, E 128, V 300
    (f32 and bf16) and at N 130, E 1,032, V 515 (bf16: E wider than a
    K8 / K9 block holds, not a multiple of 64), targets at 0 and V - 1:
    element by element and by the relative norm of the difference;
    K7-K9 timed at Llama's head (E wider than a CTA holds) beside the
    one `torch.matmul` of each kernel's main product.
13. xent main path: `pallas_cross_entropy` forward and backward at
    GPT-2 124M's full head (x = the seeded model's final hidden states
    in bf16, w = the f32 master `wte`, targets = the shifted tokens),
    with the launch counts of exactly that call (K7, K8, K9 once each,
    no plain dispatch); loss, dx and dw against the materialising lse
    form under autograd, and so the row-chunked `fused_cross_entropy`
    (plain PyTorch, f32 products: a yardstick, not a kernel route); all
    three timed forward + backward, each with its peak memory.
14. K7-K9 timed at GPT-2's head (bf16), beside their bounds, plain
    versions and the one `torch.matmul` of each kernel's main product,
    with each kernel's achieved TFLOP/s.
15. the kernels line, the `nvidia-smi` line, and the final result line.

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
from ray_tpu_torch.ops import fused_cross_entropy, pallas_cross_entropy
from ray_tpu_torch.ops import xent_pallas as xp
from ray_tpu_torch.parallel.ring_attention import plain_attention
from ray_tpu_torch.scripts import train_gpt2
from ray_tpu_torch.serve.llm_engine import LlamaEngine

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PAGED_SRC = "ray_tpu_torch/ops/csrc/paged_attention.cu"
FLASH_SRC = "ray_tpu_torch/ops/csrc/attention.cu"
XENT_SRC = "ray_tpu_torch/ops/csrc/xent.cu"
SOURCES = {"paged_kv_append": PAGED_SRC, "paged_decode_attention": PAGED_SRC,
           "paged_append_decode_attention": PAGED_SRC,
           "flash_fwd": FLASH_SRC, "flash_bwd_fused": FLASH_SRC,
           "flash_bwd_dq": FLASH_SRC, "flash_bwd_dkv": FLASH_SRC,
           "xent_fwd": XENT_SRC, "xent_dx": XENT_SRC, "xent_dw": XENT_SRC}
REPLACES = {"paged_kv_append": "ray_tpu/ops/paged_attention.py:93",
            "paged_decode_attention": "ray_tpu/ops/paged_attention.py:247",
            "paged_append_decode_attention":
                "ray_tpu/ops/paged_attention.py:93 + "
                "ray_tpu/ops/paged_attention.py:247",
            "flash_fwd": "ray_tpu/ops/attention.py:61",
            "flash_bwd_fused": "ray_tpu/ops/attention.py:202",
            "flash_bwd_dq": "ray_tpu/ops/attention.py:143",
            "flash_bwd_dkv": "ray_tpu/ops/attention.py:253",
            "xent_fwd": "ray_tpu/ops/xent_pallas.py:51",
            "xent_dx": "ray_tpu/ops/xent_pallas.py:86",
            "xent_dw": "ray_tpu/ops/xent_pallas.py:114"}
PAGED = ("paged_kv_append", "paged_decode_attention",
         "paged_append_decode_attention")
FLASH = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
XENT = ("xent_fwd", "xent_dx", "xent_dw")
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
# readings on an H100 (PERF.md): f32 7.5e-7; bf16 per kernel, K1 2.2e-3
# (P rounded to bf16 at other running maxima), the backward kernels
# 1.5e-4 (P from the same LSE, so only dS's and the outputs' roundings)
FLASH_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 3e-6},
             "bf16": {"rtol": 2e-2, "atol": 1e-2, "rel": 7e-3}}
FLASH_REL_BF16 = {"flash_fwd": 7e-3, "flash_bwd_fused": 5e-4,
                  "flash_bwd_dq": 5e-4, "flash_bwd_dkv": 5e-4}
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
# K7-K9 against their plain versions, as K1-K4 are held, with atol taken
# relative to the output's largest magnitude (lse ~ ln V, dx ~ |w|, dw ~
# |x| times the rows a class is the target of).  f32: the same sums in
# another order (64-column vocab tiles with an online logsumexp, E in
# chunks).  bf16: dl rounded to bf16 from scores summed in another order,
# so a few of its elements land one bf16 step (2^-8 of |dl|) apart, and an
# output element near zero then misses by ~|dl| |w| / 256.  The
# relative-norm limits are about 3x the worst readings on an H100 (f32
# 3.5e-6, bf16 1.8e-4; PERF.md)
XENT_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 1e-5},
            "bf16": {"rtol": 2e-2, "atol": 5e-3, "rel": 6e-4}}
# the fused op against the materialising lse form at GPT-2's full head
# (bf16 x, f32 w): the lse form rounds its logits to bf16 before the
# logsumexp and its softmax gradient to bf16 before the products, the
# kernels keep scores in f32; loss absolute, dx / dw by relative norm of
# the difference, each about 3x its H100 reading (2.9e-6, 5.5e-4, 1.7e-3)
XENT_MAIN_TOL = {"loss": 1e-5, "dx": 2e-3, "dw": 5e-3}


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


def _attention_work(case) -> tuple:
    """(bytes, operations) of K6 on `case`.  Bytes: q read and o written
    once, each row's live K and V (pos + 1 columns, + int8 scales) read
    once, the table entries it walks, pos.  Operations: 4 * H * hd per
    live column (QK and PV)."""
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
    return n_bytes, 4.0 * q.shape[1] * hd * live


def attention_bound(case) -> tuple:
    return _bound(*_attention_work(case), case["q"].dtype)


def fused_bound(case) -> tuple:
    """The fused op: K6's work, with each written row's new K and V
    (the live column it reads, counted there as read from the pool)
    written once more into the pool."""
    n_bytes, flops = _attention_work(case)
    kp, pos = case["k_pool"], case["pos"]
    BS, KV, hd = kp.shape[2:]
    written = int(((pos >= 0) & (pos < case["tables"].shape[1] * BS)).sum())
    row = KV * hd * kp.element_size() + (
        KV * 4 if case["k_scale"] is not None else 0)
    return _bound(n_bytes + 2 * written * row, flops, case["q"].dtype)


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


def k6_splits(case) -> list:
    """[splits, blocks per split] of K6's plan for `case` on this card."""
    q, kp, tables = case["q"], case["k_pool"], case["tables"]
    return list(pa.split_plan(
        q.shape[0], q.shape[1], kp.shape[3], tables.shape[1], kp.shape[2],
        torch.cuda.get_device_properties(q.device).multi_processor_count))


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
# K5 folded into K6: the fused op against the pair
# ----------------------------------------------------------------------
_WRITTEN = ("k_pool", "v_pool", "k_scale", "v_scale")


def with_new_rows(case, kind: str, gen) -> dict:
    """An attention case with a decode step's new K / V rows (pool
    dtype, + int8 scales) for every row."""
    kp = case["k_pool"]
    B, (KV, hd) = case["q"].shape[0], kp.shape[3:]
    out = dict(case)
    out["k_new"] = _pool_like((B, KV, hd), kp.dtype, gen, kp.device)
    out["v_new"] = _pool_like((B, KV, hd), kp.dtype, gen, kp.device)
    quant = kind == "int8"
    out["k_new_scale"] = _scales((B, KV), gen, kp.device) if quant else None
    out["v_new_scale"] = _scales((B, KV), gen, kp.device) if quant else None
    return out


def _run_fused(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["k_new"],
              case["v_new"], case["tables"], case["pos"], case["layer"],
              k_scale=case["k_scale"], v_scale=case["v_scale"],
              k_new_scale=case["k_new_scale"],
              v_new_scale=case["v_new_scale"])


def _run_pair(case):
    _run_append(pa.paged_kv_append, case, clone=False)
    return _run_attention(pa.paged_decode_attention, case)


def _clone_written(case) -> dict:
    return {k: (v.clone() if k in _WRITTEN and v is not None else v)
            for k, v in case.items()}


def check_fused(case, kind: str) -> float:
    """The fused op against K5 then K6 on clones of the same pools:
    outputs bit-equal on every row (no row of these cases shares a
    block), pools and int8 scales bit-equal outside scratch block 0;
    then against its plain version at K6's tolerance.  Returns the max
    abs difference from the plain version."""
    # every row inside the table's reach, its destination slot, and a
    # check that the slot does not already hold the new row (else a fused
    # op that wrote nothing would pass)
    pos, BS = case["pos"].long(), case["k_pool"].shape[2]
    rows = ((pos >= 0) & (pos < case["tables"].shape[1] * BS)).nonzero()[:, 0]
    slot = (case["layer"], case["tables"][rows, pos[rows] // BS].long(),
            pos[rows] % BS)
    for pool, new in (("k_pool", "k_new"), ("v_pool", "v_new")):
        same = (case[pool][slot] == case[new][rows]).flatten(1).all(1)
        if bool(same.any()):
            raise AssertionError(f"fused {kind}: {pool} already holds a "
                                 "new row before the call")
    f, p, r = (_clone_written(case) for _ in range(3))
    got = _run_fused(pa.paged_append_decode_attention, f)
    want = _run_pair(p)
    plain = _run_fused(pa.paged_append_decode_attention_reference, r)
    if not torch.equal(got, want):
        raise AssertionError(f"fused {kind}: output differs from K5 then K6")
    for n in _WRITTEN:
        if f[n] is not None and not torch.equal(f[n][:, 1:], p[n][:, 1:]):
            raise AssertionError(f"fused {kind}: {n} differs from K5's "
                                 "outside the scratch block")
    # every row inside the table's reach holds its new K and V now
    if not (torch.equal(f["k_pool"][slot], case["k_new"][rows])
            and torch.equal(f["v_pool"][slot], case["v_new"][rows])):
        raise AssertionError(f"fused {kind}: a new row was not written")
    tol = ATTN_TOL[kind]
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    return float((got.float() - plain.float()).abs().max())


def time_fused(case) -> dict:
    """Device ms of the fused op, of K5 then K6, and of K6 alone on one
    case (each call rewrites the same rows with the same bytes)."""
    return {
        "fused_ms": time_ms(lambda: _run_fused(
            pa.paged_append_decode_attention, case)),
        "k5_then_k6_ms": time_ms(lambda: _run_pair(case)),
        "k6_ms": time_ms(lambda: _run_attention(pa.paged_decode_attention,
                                                case)),
    }


def launch_floor_ms(device) -> float:
    """An empty kernel's device time, timed as the kernels are: the
    floor of any launch of its own."""
    lib = pa._lib()

    def run():
        rc = lib.rt_empty_launch(torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
    return time_ms(run)


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
    launches = {name: getattr(pa, name).launches for name in PAGED}
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
    # one fused launch a layer a decode step, and no K5 or K6 of its own
    want = {"paged_kv_append": 0, "paged_decode_attention": 0,
            "paged_append_decode_attention": need}
    if run["launches"] != want:
        raise AssertionError(f"serve launches {run['launches']}, want "
                             f"{want} (L x chunk x dispatches = {need})")
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
            "decode_steps": chunk * run["dispatches"],
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


def flash_tol(name: str, kind: str) -> dict:
    """FLASH_TOL[kind], with the kernel's own norm limit in bf16."""
    if kind == "f32":
        return FLASH_TOL[kind]
    return {**FLASH_TOL[kind], "rel": FLASH_REL_BF16[name]}


def check_flash(c: dict, kind: str) -> dict:
    """K1-K4 each against its plain version on the same inputs.  Returns
    {name: (max abs err, elementwise ratio, relative norm)}, each the
    worst over the kernel's outputs; raises beyond flash_tol(name, kind)."""
    out = {}
    for name in FLASH:
        tol = flash_tol(name, kind)
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


def flash_flops(name: str, c: dict) -> float:
    """2 * D per (q, k) pair per product, over the pairs this call needs
    (the lower triangle with the diagonal when causal); K1 does 2
    products, K2 5, K3 3, K4 4."""
    BH, T, D = c["q"].shape
    pairs = BH * (T * (T + 1) // 2 if c["causal"] else T * T)
    mats = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4}[name]
    return 2.0 * D * pairs * mats


def flash_bound(name: str, c: dict) -> tuple:
    """Operations: `flash_flops`.  Bytes: each input read once, each
    output written once."""
    BH, T, D = c["q"].shape
    n = BH * T * D * c["q"].element_size()
    vec = BH * T * 4
    n_bytes = {"flash_fwd": 4 * n + vec, "flash_bwd_fused": 8 * n + vec,
               "flash_bwd_dq": 5 * n + 2 * vec,
               "flash_bwd_dkv": 6 * n + 2 * vec}[name]
    return _bound(n_bytes, flash_flops(name, c), c["q"].dtype)


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


def time_flash(c: dict, H: int, names=FLASH) -> dict:
    """ms / plain_ms / bound_ms / library_ms of the kernels `names` of
    K1-K4 on one case, with the achieved TFLOP/s, ms over the bound and
    ms over SDPA's.  The library call for K1 is SDPA's forward, for K2
    its backward; no one call computes K3's or K4's function alone, so
    they are set against SDPA's backward (the pair's yardstick, also in
    the phase line) and their library_ms stays null."""
    lib_fwd, lib_bwd = sdpa_yardsticks(c, H)
    out = {}
    for name in names:
        bound, by = flash_bound(name, c)
        ms = time_ms(lambda: run_flash(name, c))
        sdpa = lib_fwd if name == "flash_fwd" else lib_bwd
        out[name] = {
            "ms": ms,
            "plain_ms": time_ms(lambda: run_flash(name, c, plain=True)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": {"flash_fwd": lib_fwd,
                           "flash_bwd_fused": lib_bwd}.get(name),
            "tflops": flash_flops(name, c) / (ms * 1e-3) / 1e12,
            "x_bound": ms / bound,
            "x_sdpa": ms / sdpa,
        }
    return out, lib_bwd


def reset_counts() -> None:
    for name in FLASH:
        getattr(fa, name).launches = 0
    fa.flash_attention.plain_dispatches = 0
    for name in PAGED:
        getattr(pa, name).launches = 0
    for name in XENT:
        getattr(xp, name).launches = 0


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
    """The flash op with blocks of `block` (bf16, causal), forward and
    backward: K1, then K3 + K4 with delta from the wrapper.  Held against
    dense attention's autograd in f32 on the same inputs."""
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
# the fused cross entropy (K7-K9)
# ----------------------------------------------------------------------
def xent_case(N, E, V, x_dtype, w_dtype, device, seed=0) -> dict:
    """Seeded x [N, E] ~ N(0, 1), w [V, E] ~ N(0, 0.05^2), targets with 0
    and V - 1 among them, and the plain forward's lse: the inputs each
    kernel shares with its plain version."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((N, E), generator=gen, device=device).to(x_dtype)
    w = (torch.randn((V, E), generator=gen, device=device) * 0.05).to(
        w_dtype)
    targets = torch.randint(0, V, (N,), generator=gen, device=device,
                            dtype=torch.int32)
    targets[0], targets[-1] = 0, V - 1
    lse, _ = xp.xent_fwd_reference(x, w, targets)
    return {"x": x, "w": w, "targets": targets, "lse": lse}


def run_xent(name: str, c: dict, plain: bool = False) -> tuple:
    fn = getattr(xp, name + "_reference" if plain else name)
    args = (c["x"], c["w"], c["targets"])
    out = fn(*args) if name == "xent_fwd" else fn(*args, c["lse"])
    return out if isinstance(out, tuple) else (out,)


def _scaled(tol: dict, want) -> dict:
    """`tol` with atol taken relative to the largest |want|."""
    return dict(tol, atol=tol["atol"] * float(want.detach().abs().max()))


def check_xent(c: dict, kind: str) -> dict:
    """K7-K9 each against its plain version on the same inputs.  Returns
    {name: (max abs err, elementwise ratio, relative norm)}, each the
    worst over the kernel's outputs; raises beyond XENT_TOL[kind]."""
    tol, out = XENT_TOL[kind], {}
    for name in XENT:
        got, want = run_xent(name, c), run_xent(name, c, plain=True)
        worst = (0.0, 0.0, 0.0)
        for g, w in zip(got, want):
            if (g.shape != w.shape or g.dtype != w.dtype
                    or not bool(torch.isfinite(g).all())):
                raise AssertionError(f"{name}: misshapen or non-finite")
            worst = tuple(map(max, worst, compare(g, w, _scaled(tol, w))))
        del got, want
        if not within(worst, tol):
            raise AssertionError(f"{name} {kind}: (max abs, elementwise "
                                 f"ratio, rel norm) {worst} beyond {tol}")
        out[name] = worst
    return out


def xent_flops(name: str, c: dict) -> float:
    """2 N V E for the score product, plus 2 N V E for K8's and K9's
    second product."""
    (N, E), V = c["x"].shape, c["w"].shape[0]
    return 2.0 * N * V * E * (1 if name == "xent_fwd" else 2)


def xent_bound(name: str, c: dict) -> tuple:
    """Operations: `xent_flops` at x's dtype's peak.  Bytes: x, w (as
    the kernel reads it), targets and (K8, K9) lse read once; lse and
    target logit, dx or dw written once in f32."""
    x, w = c["x"], c["w"]
    N, E = x.shape
    V = w.shape[0]
    ins = x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * N
    n_bytes = {"xent_fwd": ins + 8 * N, "xent_dx": ins + 4 * N + 4 * N * E,
               "xent_dw": ins + 4 * N + 4 * V * E}[name]
    return _bound(n_bytes, xent_flops(name, c), x.dtype)


def xent_library(name: str, c: dict):
    """The one `torch.matmul` that does the kernel's main product in x's
    dtype: x w^T into [N, V] for K7; dl w for K8 and dl^T x for K9, from
    a precomputed dl in x's dtype."""
    x, w = c["x"], c["w"].to(c["x"].dtype)
    if name == "xent_fwd":
        return lambda: torch.matmul(x, w.T)
    dl = xp._dlogits(x, w, c["targets"], c["lse"]).to(x.dtype)
    if name == "xent_dx":
        return lambda: torch.matmul(dl, w)
    return lambda: torch.matmul(dl.T, x)


def time_wide_xent(c: dict) -> dict:
    """ms, bound_ms, library_ms and TFLOP/s of K7-K9 where E is wider
    than the 768 columns a CTA holds (K7 streams x beside w; each 32-row
    step of K8 / K9 streams the output block's A panels again), beside
    the one `torch.matmul` of each kernel's main product."""
    out = {}
    for name in XENT:
        ms = time_ms(lambda: run_xent(name, c), iters=3)
        lib = xent_library(name, c)
        out[name] = {"ms": ms, "bound_ms": xent_bound(name, c)[0],
                     "library_ms": time_ms(lib, iters=3),
                     "tflops": xent_flops(name, c) / (ms * 1e-3) / 1e12}
        del lib
        torch.cuda.empty_cache()
    return out


def time_xent(c: dict) -> dict:
    """ms / plain_ms / bound_ms / bound_by / library_ms of K7-K9 on one
    case, with the achieved TFLOP/s."""
    out = {}
    for name in XENT:
        bound, by = xent_bound(name, c)
        lib = xent_library(name, c)
        ms = time_ms(lambda: run_xent(name, c), iters=10)
        out[name] = {
            "ms": ms,
            "plain_ms": time_ms(lambda: run_xent(name, c, plain=True),
                                iters=5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lib, iters=10),
            "tflops": xent_flops(name, c) / (ms * 1e-3) / 1e12,
        }
        del lib
        torch.cuda.empty_cache()
    return out


class count_plain:
    """Counts calls of the K7-K9 plain versions while it is entered:
    the wrappers look them up in their module at each call, so a CUDA
    tensor that reached one would show here."""

    def __enter__(self):
        self.calls, self._saved = 0, {}
        for name in XENT:
            ref = name + "_reference"
            orig = self._saved[ref] = getattr(xp, ref)

            def counted(*a, _orig=orig, **k):
                self.calls += 1
                return _orig(*a, **k)
            setattr(xp, ref, counted)
        return self

    def __exit__(self, *exc):
        for ref, orig in self._saved.items():
            setattr(xp, ref, orig)
        return False


def _peak(fn, device) -> tuple:
    """(result, peak bytes above what was allocated before) of `fn()`."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device) - base


def xent_main_path(device, *, cfg=None, batch=32, seq=1024,
                   time_it=True) -> dict:
    """`pallas_cross_entropy` at GPT-2's lm-head: x = the backbone's
    final hidden states of the seeded model and tokens (bf16, detached
    into a leaf), w = the f32 master `wte`, targets = the shifted
    tokens.  Forward and backward with the launch counts of exactly
    that call, held against `reference_cross_entropy` under autograd,
    and so the row-chunked `fused_cross_entropy`; then all three timed
    forward + backward, each with its peak memory."""
    state = train_gpt2.build(device, batch, seq, seed=0, cfg=cfg)
    cfg, params, tokens = state["cfg"], state["params"], state["tokens"]
    with torch.no_grad():
        h = gpt2.backbone(cfg, params, tokens[:, :-1])
    x = h.reshape(-1, cfg.n_embd).detach().requires_grad_(True)
    w = params["wte"].detach().requires_grad_(True)
    targets = tokens[:, 1:].reshape(-1).contiguous()
    del h, state

    def fused():
        loss = pallas_cross_entropy(x, w, targets)
        return (loss, *torch.autograd.grad(loss, (x, w)))

    def lse_form():
        loss = xp.reference_cross_entropy(x, w, targets)
        return (loss, *torch.autograd.grad(loss, (x, w)))

    def chunked():
        loss = fused_cross_entropy(x, w, targets)
        return (loss, *torch.autograd.grad(loss, (x, w)))

    reset_counts()
    with count_plain() as plain:
        (loss, dx, dw), fused_peak = _peak(fused, device)
    launches = {name: getattr(xp, name).launches for name in XENT}
    if launches != {n: 1 for n in XENT} or plain.calls != 0:
        raise AssertionError(f"xent launches {launches}, plain "
                             f"dispatches {plain.calls}")
    (r_loss, r_dx, r_dw), lse_peak = _peak(lse_form, device)
    r_loss = r_loss.detach()

    def against_lse_form(what, loss, dx, dw) -> dict:
        if dx.dtype != x.dtype or dw.dtype != w.dtype or not all(
                bool(torch.isfinite(t.float()).all())
                for t in (loss, dx, dw)):
            raise AssertionError(f"{what} grads misshapen or non-finite")
        err = {"loss": abs(float(loss) - float(r_loss)),
               **{n: float(torch.linalg.vector_norm(g.float() - r.float())
                            / torch.linalg.vector_norm(r.float()))
                  for n, g, r in (("dx", dx, r_dx), ("dw", dw, r_dw))}}
        if any(err[k] > XENT_MAIN_TOL[k] for k in err):
            raise AssertionError(f"{what} vs lse form: {err} beyond "
                                 f"{XENT_MAIN_TOL}")
        return err

    loss = loss.detach()
    err = against_lse_form("fused", loss, dx, dw)
    del dx, dw
    (c_loss, c_dx, c_dw), chunked_peak = _peak(chunked, device)
    err_chunked = against_lse_form("chunked", c_loss.detach(), c_dx, c_dw)
    if abs(float(loss) - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"loss {float(loss)} far from ln V = "
                             f"{math.log(cfg.vocab_size)}")
    del r_dx, r_dw, c_dx, c_dw
    line = {"phase": "xent_main_path", "model": "gpt2_124m",
            "N": x.shape[0], "E": x.shape[1], "V": w.shape[0],
            "x_dtype": str(x.dtype).replace("torch.", ""),
            "w_dtype": str(w.dtype).replace("torch.", ""),
            "depth_cut": False, "loss": float(loss),
            "loss_lse_form": float(r_loss), "ln_V": math.log(w.shape[0]),
            "launches": launches, "plain_dispatches": plain.calls,
            "err_vs_lse_form": err,
            "chunked_err_vs_lse_form": err_chunked,
            "tolerance": XENT_MAIN_TOL}
    if time_it:
        line.update({
            "fused_fwd_bwd_ms": time_ms(fused, iters=10),
            "fused_peak_extra_gb": fused_peak / 1e9,
            "lse_form_fwd_bwd_ms": time_ms(lse_form, iters=10),
            "lse_form_peak_extra_gb": lse_peak / 1e9,
            "chunked_fwd_bwd_ms": time_ms(chunked, iters=5),
            "chunked_peak_extra_gb": chunked_peak / 1e9,
        })
    return {"launches": launches, "line": line}


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

    # K5 and K6 on their own: the decode step no longer launches them (the
    # fused op below does their work in one launch), so the kernels line
    # carries the serve run's 0 for both and this section's own launches
    # go on a line of their own
    reset_counts()
    emit({"phase": "K5_vs_plain", "shape": "L=32 B=8 W=16 BS=16 KV=8 hd=128",
          **check_append(device)})

    for B in (8, 32):
        errs = {}
        for kind_ in ("f32", "bf16", "int8"):
            case = attention_case(kind_, device, B=B, seed=B)
            errs[kind_] = check_attention(case, kind_)
        emit({"phase": "K6_vs_plain", "B": B, "H": 32, "KV": 8, "hd": 128,
              "BS": 16, "max_pos": 1024, "max_abs_err": errs,
              "tolerance": ATTN_TOL})
        del case
    # past the split walk's widths: hd 1,032 (the wide-head kernel) and
    # tables of 65,540 blocks (splits of more than the 1,024 staged
    # entries), each against the plain version; the fused op there too
    for what, kw in (("hd_1032", dict(B=4, max_pos=200, L=1, H=8, KV=2,
                                      hd=1032, BS=16)),
                     ("W_65540", dict(B=2, max_pos=65539, L=1, H=2, KV=1,
                                      hd=64, BS=1))):
        errs, fused_errs = {}, {}
        for kind_ in ("f32", "bf16"):
            case = attention_case(kind_, device, seed=7, **kw)
            errs[kind_] = check_attention(case, kind_)
            gen = torch.Generator(device=device)
            gen.manual_seed(7)
            fused_errs[kind_] = check_fused(with_new_rows(case, kind_, gen),
                                            kind_)
        emit({"phase": "K6_vs_plain_wide", "case": what, **kw,
              "W": int(case["tables"].shape[1]), "splits": k6_splits(case),
              "max_abs_err": errs, "fused_max_abs_err": fused_errs,
              "fused_bit_equal_to_k5_then_k6": True,
              "tolerance": ATTN_TOL})
        del case
    emit({"phase": "K5_K6_checks",
          "check_launches": {name: getattr(pa, name).launches
                             for name in PAGED}})
    case = attention_case("bf16", device, B=32, seed=32)
    bound, by = attention_bound(case)
    ms = time_ms(lambda: _run_attention(pa.paged_decode_attention, case))
    sdpa = time_ms(dense_sdpa(case))
    emit({"phase": "K6_timed", "B": 32, "H": 32, "KV": 8, "hd": 128,
          "BS": 16, "max_pos": 1024, "bf16_ms": ms,
          "bf16_plain_ms": time_ms(lambda: _run_attention(
              pa.paged_decode_attention_reference, case)),
          "bf16_bound_ms": bound, "bf16_bound_by": by,
          "bf16_library_ms": sdpa, "bf16_x_sdpa": ms / sdpa,
          "bf16_x_bound": ms / bound, "splits": k6_splits(case)})
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
        # K5 folded into K6, against K5 then K6 and its plain version,
        # at the mid-decode state (the real pools in bf16; f32 and int8
        # pools of the same shapes and positions) and at B 32 with rows to
        # 1,024; timed beside the pair, K6 alone and an empty launch
        # fresh new rows: time_kernels already appended app_case's rows
        # into these pools, where a fused op that wrote nothing would
        # still match the pair
        mid = with_new_rows(attn_case, "bf16", gen)
        fused_t = {"launch_floor_ms": launch_floor_ms(device)}
        fused_errs = {}
        for shape in ("mid_decode", "B32"):
            errs = fused_errs[shape] = {}
            ms_ = {}
            for kind_ in ("f32", "bf16", "int8"):
                if shape == "mid_decode" and kind_ == "bf16":
                    case = mid
                else:
                    if shape == "mid_decode":
                        case = attention_case(
                            kind_, device, B=B, seed=8,
                            max_pos=int(state["tables"].shape[1]) * 16 - 1)
                        case["pos"] = state["pos"].clone()
                    else:
                        case = attention_case(kind_, device, B=32, seed=32)
                    case = with_new_rows(case, kind_, gen)
                errs[kind_] = check_fused(case, kind_)
                ms_[kind_] = time_fused(case)
                if kind_ == "bf16":
                    bound = fused_bound(case)
            emit({"phase": "K5K6_fused_vs_pair", "shape": shape,
                  "B": int(case["q"].shape[0]),
                  "W": int(case["tables"].shape[1]), "H": cfg.n_heads,
                  "KV": KV, "hd": hd, "BS": 16,
                  "pos": case["pos"].tolist() if shape == "mid_decode"
                  else "0-1024", "splits": k6_splits(case),
                  "bit_equal_to_k5_then_k6": True,
                  "max_abs_err_vs_plain": errs, "tolerance": ATTN_TOL,
                  "ms": ms_, "bf16_bound_ms": bound[0],
                  "bf16_bound_by": bound[1],
                  "launch_floor_ms": fused_t["launch_floor_ms"]})
            fused_t[shape] = ms_
            del case
        f_bound, f_by = fused_bound(mid)
        timings["paged_append_decode_attention"] = {
            "ms": fused_t["mid_decode"]["bf16"]["fused_ms"],
            "plain_ms": time_ms(lambda: _run_fused(
                pa.paged_append_decode_attention_reference, mid)),
            "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
        }
    k6 = timings["paged_decode_attention"]
    emit({"phase": "mid_decode_routes", **routes,
          "paged_decode_attention_ms": k6["ms"],
          "paged_decode_attention_warm_l2_ms": k6_warm,
          "paged_decode_attention_x_sdpa": k6["ms"] / k6["library_ms"],
          "paged_decode_attention_x_bound": k6["ms"] / k6["bound_ms"],
          "paged_decode_attention_splits": k6_splits(attn_case),
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
            + [(48, 1000, 64, "bf16", True), (16, 1000, 128, "bf16", True)]
            + [(2, 256, D, k, True) for D in (712, 1032)
               for k in ("f32", "bf16")]):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind_]
        case = flash_case(BH, T, D, dt, causal, device, seed=T + D)
        errs_ = check_flash(case, kind_)
        emit({"phase": "K1-K4_vs_plain", "BH": BH, "T": T, "D": D,
              "dtype": kind_, "causal": causal, "ragged": T % 64 != 0,
              "column_slices": D > {"f32": 1024, "bf16": 704}[kind_],
              "max_abs_elementwise_relnorm": errs_,
              "tolerance": {n: flash_tol(n, kind_) for n in FLASH}})
        if (T, kind_, causal) == (1024, "bf16", True):
            flash_errs = {n: e[0] for n, e in errs_.items()}
        del case
    torch.cuda.empty_cache()

    # the training main path, then the split route (K3 + K4)
    t0 = time.perf_counter()
    trained = run_training(device)
    emit({**trained["line"], "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    # the split route at the training shape with blocks of 256, and at the
    # reference's own split route: default blocks (1,024) at T 4,096 with
    # Llama-3-8B's head width
    split = split_route(device)
    emit(split["line"])
    torch.cuda.empty_cache()
    split_llama = split_route(device, B=1, T=4096, H=32, D=128, block=1024)
    emit(split_llama["line"])
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
    torch.cuda.empty_cache()
    case = flash_case(32, 4096, 128, torch.bfloat16, True, device)
    split_t, sdpa_bwd = time_flash(case, H=32,
                                   names=("flash_bwd_dq", "flash_bwd_dkv"))
    emit({"phase": "K3_K4_timed", "BH": 32, "T": 4096, "D": 128,
          "dtype": "bf16", "causal": True, **split_t,
          "k3_plus_k4_ms": split_t["flash_bwd_dq"]["ms"]
          + split_t["flash_bwd_dkv"]["ms"], "sdpa_bwd_ms": sdpa_bwd})
    del case
    timings.update(flash_t)
    torch.cuda.empty_cache()

    # K7-K9 against their plain versions: the GPT-2 124M head (bf16 x with
    # the f32 master w, and all f32), the Llama-3-8B head, a ragged tiny
    xent_errs = {}
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    for N, E, V, x_kind, w_kind in ((32768, 768, 50257, "bf16", "f32"),
                                    (32768, 768, 50257, "f32", "f32"),
                                    (4096, 4096, 128256, "bf16", "bf16"),
                                    (200, 128, 300, "f32", "f32"),
                                    (200, 128, 300, "bf16", "bf16"),
                                    (130, 1032, 515, "bf16", "bf16")):
        case = xent_case(N, E, V, dts[x_kind], dts[w_kind], device,
                         seed=N + V)
        errs_ = check_xent(case, x_kind)
        line = {"phase": "K7-K9_vs_plain", "N": N, "E": E, "V": V,
                "x_dtype": x_kind, "w_dtype": w_kind,
                "max_abs_elementwise_relnorm": errs_,
                "tolerance": XENT_TOL[x_kind]}
        if E == 4096:  # Llama's head: K8 / K9 on the streamed path
            line["timed"] = time_wide_xent(case)
        emit(line)
        if (N, x_kind) == (32768, "bf16"):
            xent_errs = {n: e[0] for n, e in errs_.items()}
        del case
        torch.cuda.empty_cache()

    # the fused cross entropy's main path: GPT-2 124M's full head
    t0 = time.perf_counter()
    xent_run = xent_main_path(device)
    emit({**xent_run["line"], "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    case = xent_case(32768, 768, 50257, torch.bfloat16, torch.bfloat16,
                     device)
    xent_t = time_xent(case)
    emit({"phase": "K7-K9_timed", "N": 32768, "E": 768, "V": 50257,
          "dtype": "bf16", **xent_t})
    del case
    timings.update(xent_t)
    launches = {**served["launches"], **trained["launches"],
                **{n: split["launches"][n] + split_llama["launches"][n]
                   for n in ("flash_bwd_dq", "flash_bwd_dkv")},
                **xent_run["launches"]}

    errs = {"paged_kv_append": 0.0, "paged_decode_attention": attn_err,
            "paged_append_decode_attention": fused_errs["mid_decode"]["bf16"],
            **flash_errs, **xent_errs}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], **timings[name]}
        for name in (*PAGED, *FLASH, *XENT)
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
