#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving path on one CUDA card.

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
7. the kernels line, the `nvidia-smi` line, and the final result line.

Times are medians of CUDA-event timings of device work, with the 50 MB
L2 flushed (a 1 GiB write) before each launch.  Bounds use the H100 SXM's published 3.35 TB/s of
HBM and its dense peaks (989 TFLOP/s bf16, 67 TFLOP/s f32).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.examples.serve_llm import _build_model
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm_engine import LlamaEngine

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SOURCE = "ray_tpu_torch/ops/csrc/paged_attention.cu"
REPLACES = {"paged_kv_append": "ray_tpu/ops/paged_attention.py:93",
            "paged_decode_attention": "ray_tpu/ops/paged_attention.py:247"}
# K6 tolerances: f32 to rounding; bf16 / int8 the reference's own
# (tests/test_paged_attention.py:78-79)
ATTN_TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}


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
    pa.paged_kv_append.launches = 0
    pa.paged_decode_attention.launches = 0
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

    errs = {"paged_kv_append": 0.0, "paged_decode_attention": attn_err}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": served["launches"][name],
         "max_abs_err": errs[name], **timings[name]}
        for name in ("paged_kv_append", "paged_decode_attention")
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
