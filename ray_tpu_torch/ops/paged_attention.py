"""Paged decode attention on Hopper: the KV append (K5) and the decode
attention (K6) of the engine's fused decode route.

The port of the JAX package's `ops/paged_attention.py`.  Decode
attention reads the paged KV pool THROUGH the block tables instead of
gathering every sequence's blocks into a dense view (vLLM's
PagedAttention, Kwon et al. SOSP 2023, with the split-KV online
softmax of Flash-Decoding, Dao et al. 2023).  Both kernels take the
pool `[L, NB, BS, KV, hd]` whole with the layer index as a scalar, so
the per-layer loop never slices (= copies) the pool.

- `paged_kv_append`: writes each row's new K/V into its tail block, in
  place (CUDA source: `csrc/paged_attention.cu`, K5).
- `paged_decode_attention`: split-KV flash-decoding in one launch: each
  row's block table is cut into runs (`split_plan`, from shapes only),
  each run walked by its own CTA with an online softmax, the runs merged
  by the last CTA of each (row, kv head) to finish (same source, K6).
  Any table width and any head width the reference takes run on the
  card: heads wider than 1,024 on a simple kernel of their own, whole
  rows a CTA, the head's columns cut over CTAs of 1,024.
- `paged_append_decode_attention`: the two above on the same arguments
  as one op, the decode step's per-layer call: on the card one launch
  of K6 that does K5's writes in its prologue, so the append costs no
  launch and no dependent trip to memory of its own.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes
its plain PyTorch version (`*_reference`, same arguments, same
numerics, dense over a gather) only for tensors on the CPU.  Each
wrapper carries a plain integer `launches`, bumped once per kernel
launch and nowhere else, so a run can show that it went through the
kernels.

Int8 KV rides the same kernels: int8 pools carry a per-row, per-kv-head
f32 scale sidecar `[L, NB, BS, KV]`; the attention kernel dequantizes
in-kernel ((int8 -> f32) * scale -> q dtype) and the append kernel
writes the quantized row and its scale.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# K6's plan constants, mirrored from csrc/paged_attention.cu
_MAX_GROUP = 8      # query heads a CTA serves (kMaxG)
_MAX_SPLITS = 64    # kMaxSplits
_CTAS_PER_SM = 2    # the split count's target
# a split spans at least this many columns: below it a split's fixed cost
# (prologue, first round trip, merge) outweighs the columns it takes off
# the longest CTA
_MIN_SPLIT_TOKENS = 256
_P = ctypes.c_void_p
_I = ctypes.c_int


# ----------------------------------------------------------------------
# int8 helpers (shared with the engine's gather route + weight quant)
# ----------------------------------------------------------------------
def quantize_int8(x: torch.Tensor,
                  axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along `axis` in f32 math:
    scale = max|x| / 127 (the max element maps to exactly ±127, so a
    dequant -> requant round trip is idempotent), zero slices get scale
    0 and payload 0.  `torch.round` is round-half-to-even, as
    `jnp.round`.  Returns (q int8, scale f32 with `axis` removed)."""
    xf = x.float()
    scale = xf.abs().amax(dim=axis, keepdim=True) / 127.0
    q = torch.round(xf / torch.where(scale == 0.0, 1.0, scale))
    q = q.clamp(-127.0, 127.0).to(torch.int8)
    return q, scale.squeeze(axis)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype,
                    axis: int = -1) -> torch.Tensor:
    """Inverse of `quantize_int8`: f32 multiply, then cast to `dtype`."""
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


# ----------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ----------------------------------------------------------------------
def paged_kv_append_reference(k_pool, v_pool, k_new, v_new, tables, pos,
                              layer, *, k_scale=None, v_scale=None,
                              k_new_scale=None, v_new_scale=None):
    """`paged_kv_append` in plain PyTorch: one indexed write per pool.
    A position past the table's reach (pos >= W * BS) must write
    nothing; here it is sent to the scratch block instead, whose
    content is garbage by contract, so the write needs no host sync."""
    BS = k_pool.shape[2]
    W = tables.shape[1]
    rows = torch.arange(tables.shape[0], device=tables.device)
    p = pos.long()
    ok = (p >= 0) & (p < W * BS)
    w = torch.where(ok, p // BS, 0)
    blk = torch.where(ok, tables[rows, w].long(), 0)
    off = torch.where(ok, p % BS, 0)
    k_pool[layer, blk, off] = k_new
    v_pool[layer, blk, off] = v_new
    if k_scale is None:
        return k_pool, v_pool
    k_scale[layer, blk, off] = k_new_scale
    v_scale[layer, blk, off] = v_new_scale
    return k_pool, v_pool, k_scale, v_scale


def paged_decode_attention_reference(q, k_pool, v_pool, tables, pos, layer,
                                     *, k_scale=None, v_scale=None):
    """`paged_decode_attention` in plain PyTorch: gather each row's W
    blocks into a dense `[B, W*BS, KV, hd]` view, then
    `decode_step_vec`'s attention: f32 scores times hd**-0.5, columns
    > pos at -1e30, f32 softmax, weights cast to q's dtype, f32 P.V.
    A row with pos < 0 attends to nothing and returns zeros, as the
    Pallas kernel's (l == 0 -> 1) does."""
    _, _, BS, KV, HD = k_pool.shape
    B, W = tables.shape
    H = q.shape[1]
    t = tables.long()
    k = k_pool[layer][t].reshape(B, W * BS, KV, HD)
    v = v_pool[layer][t].reshape(B, W * BS, KV, HD)
    if k_scale is not None:
        k = dequantize_int8(k, k_scale[layer][t].reshape(B, W * BS, KV),
                            q.dtype)
        v = dequantize_int8(v, v_scale[layer][t].reshape(B, W * BS, KV),
                            q.dtype)
    qg = q.reshape(B, KV, H // KV, HD).float()
    s = torch.einsum("bkgd,bmkd->bkgm", qg, k.float()) * HD ** -0.5
    cols = torch.arange(W * BS, device=q.device)
    valid = (cols[None, :] <= pos[:, None].long())[:, None, None, :]
    s = torch.where(valid, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(pos[:, None, None, None] >= 0, p, 0.0)
    o = torch.einsum("bkgm,bmkd->bkgd", p.to(q.dtype).float(), v.float())
    return o.reshape(B, H, HD).to(q.dtype)


def paged_append_decode_attention_reference(q, k_pool, v_pool, k_new,
                                            v_new, tables, pos, layer, *,
                                            k_scale=None, v_scale=None,
                                            k_new_scale=None,
                                            v_new_scale=None):
    """`paged_append_decode_attention` in plain PyTorch: the two plain
    versions in turn, on the same arguments."""
    paged_kv_append_reference(k_pool, v_pool, k_new, v_new, tables, pos,
                              layer, k_scale=k_scale, v_scale=v_scale,
                              k_new_scale=k_new_scale,
                              v_new_scale=v_new_scale)
    return paged_decode_attention_reference(q, k_pool, v_pool, tables, pos,
                                            layer, k_scale=k_scale,
                                            v_scale=v_scale)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def split_plan(B: int, H: int, KV: int, W: int, BS: int,
               sms: int) -> Tuple[int, int]:
    """K6's cut of every row's block table: (splits, per), split s
    covering table columns [s * per, min((s + 1) * per, W)).

    A function of shapes and the card's SM count only, never of the
    positions: they live on the device, and reading them would sync the
    engine's tick; a grid fixed by shapes is also what a CUDA graph per
    width bucket can capture.  It aims at about `_CTAS_PER_SM` CTAs an
    SM over the B * KV * ceil((H / KV) / 8) (row, kv head) cells, gives
    each split at least `_MIN_SPLIT_TOKENS` columns' worth of blocks,
    never more than `_MAX_SPLITS` splits a cell, and leaves no split
    empty by construction (a split past a short row's last block is
    empty at run time and costs the kernel one predicate).  Past
    W = 65,536 a split holds more blocks than the 1,024 table entries
    the kernel stages at once (kMaxPer); it stages them in rounds."""
    cells = B * KV * -(-(H // KV) // _MAX_GROUP)
    want = min(max(1, -(-_CTAS_PER_SM * sms // cells)), _MAX_SPLITS, W)
    per = min(W, max(-(-W // want), -(-_MIN_SPLIT_TOKENS // BS)))
    return -(-W // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# device index -> (f32 workspace, int32 counters) of K6's split partials
_workspaces: dict = {}


def _workspace(device: torch.device, floats: int, cells: int):
    """K6's workspace and arrival counters on `device`, allocated once
    and grown when a call needs more.  The counters start at zero and
    every launch leaves them zero."""
    ws, counters = _workspaces.get(device.index, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < cells:
        counters = torch.zeros(cells, dtype=torch.int32, device=device)
    _workspaces[device.index] = (ws, counters)
    return ws, counters


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_rt_typed", False):
        lib.rt_paged_kv_append.argtypes = [_P] * 10 + [_I] * 8 + [_P]
        lib.rt_paged_kv_append.restype = _I
        lib.rt_paged_decode_attention.argtypes = (
            [_P] * 10 + [_I] * 10 + [ctypes.c_float, _I, _I, _P])
        lib.rt_paged_decode_attention.restype = _I
        lib.rt_paged_append_decode_attention.argtypes = (
            [_P] * 14 + [_I] * 10 + [ctypes.c_float, _I, _I, _I, _P])
        lib.rt_paged_append_decode_attention.restype = _I
        lib.rt_empty_launch.argtypes = [_P]
        lib.rt_empty_launch.restype = _I
        lib._rt_typed = True
    return lib


def _check_cuda(device: torch.device, **tensors) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"the paged kernels run on CUDA tensors (got {device}); "
            "CPU tensors take the plain version"
        )
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_scales(quantized: bool, pool_dtype, **scales) -> None:
    given = [s is not None for s in scales.values()]
    if quantized != (pool_dtype == torch.int8) or (any(given)
                                                    and not all(given)):
        raise ValueError(
            "int8 pools need every f32 scale tensor; model-dtype pools "
            "take none"
        )
    for name, s in scales.items():
        if s is not None and s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {s.dtype}")


def _check_index(tables, pos, B: int) -> None:
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("tables and pos must be int32")
    if tables.dim() != 2 or tuple(pos.shape) != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={B}")


def _vec_bytes(row_bytes: int, *tensors) -> int:
    """Widest copy unit dividing the row and every pointer."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0
                                      for t in tensors):
            return v
    return 1


def _check_new_rows(k_pool, k_new, v_new, k_new_scale, v_new_scale,
                    B: int) -> None:
    """The new rows' checks against a checked pool: device, dtype, shape
    and, for int8 pools, their per-row scales."""
    KV, HD = k_pool.shape[3:]
    _check_cuda(k_pool.device, k_new=k_new, v_new=v_new,
                k_new_scale=k_new_scale, v_new_scale=v_new_scale)
    if not k_new.dtype == v_new.dtype == k_pool.dtype:
        raise ValueError("k_pool, v_pool, k_new and v_new must share a dtype")
    if k_new.shape != (B, KV, HD) or v_new.shape != (B, KV, HD):
        raise ValueError("pool / new-row shapes disagree")
    _check_scales(k_new_scale is not None, k_pool.dtype,
                  k_new_scale=k_new_scale, v_new_scale=v_new_scale)
    if k_new_scale is not None and (k_new_scale.shape != (B, KV)
                                    or v_new_scale.shape != (B, KV)):
        raise ValueError("scale shapes disagree with the pool")


def _check_append(k_pool, v_pool, k_new, v_new, tables, pos, layer,
                  k_scale, v_scale, k_new_scale, v_new_scale) -> int:
    """`paged_kv_append`'s checks of CUDA operands; returns the layer."""
    L, NB, BS, KV, HD = k_pool.shape
    B = k_new.shape[0]
    _check_cuda(k_pool.device, k_pool=k_pool, v_pool=v_pool, tables=tables,
                pos=pos, k_scale=k_scale, v_scale=v_scale)
    if k_pool.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"pool dtype {k_pool.dtype} not supported")
    if v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool must share a dtype and shape")
    _check_scales(k_scale is not None, k_pool.dtype, k_scale=k_scale,
                  v_scale=v_scale)
    if k_scale is not None and (k_scale.shape != (L, NB, BS, KV)
                                or v_scale.shape != (L, NB, BS, KV)):
        raise ValueError("scale shapes disagree with the pool")
    _check_new_rows(k_pool, k_new, v_new, k_new_scale, v_new_scale, B)
    _check_index(tables, pos, B)
    return _check_layer(layer, L)


def _check_attention(q, k_pool, v_pool, tables, pos, layer, k_scale,
                     v_scale) -> int:
    """`paged_decode_attention`'s checks of CUDA operands; returns the
    layer."""
    L, NB, BS, KV, HD = k_pool.shape
    B, H = q.shape[0], q.shape[1]
    _check_cuda(k_pool.device, q=q, k_pool=k_pool, v_pool=v_pool,
                tables=tables, pos=pos, k_scale=k_scale, v_scale=v_scale)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported")
    if v_pool.dtype != k_pool.dtype or k_pool.dtype not in (q.dtype,
                                                            torch.int8):
        raise ValueError(f"pool dtype {k_pool.dtype} does not serve q "
                         f"dtype {q.dtype}")
    if (v_pool.shape != k_pool.shape or q.dim() != 3 or q.shape[2] != HD
            or H % KV):
        raise ValueError("q / pool shapes disagree")
    _check_scales(k_scale is not None, k_pool.dtype, k_scale=k_scale,
                  v_scale=v_scale)
    if k_scale is not None and (k_scale.shape != (L, NB, BS, KV)
                                or v_scale.shape != (L, NB, BS, KV)):
        raise ValueError("scale shapes disagree with the pool")
    _check_index(tables, pos, B)
    # the kernel moves pool rows as 16-byte vectors
    row_bytes = HD * k_pool.element_size()
    if (row_bytes % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16
            or q.data_ptr() % 4):
        raise ValueError(
            f"pool rows of {row_bytes} B (hd {HD}) are not 16-byte vectors "
            f"at 16-byte aligned addresses (q at 4-byte)"
        )
    return _check_layer(layer, L)


def _check_layer(layer, L: int) -> int:
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    return layer


def _attention_plan(q, k_pool, tables):
    """K6's launch arguments past the tensors: (splits, per, workspace,
    counters, out)."""
    HD = k_pool.shape[4]
    B, H = q.shape[0], q.shape[1]
    KV = k_pool.shape[3]
    splits, per = split_plan(B, H, KV, tables.shape[1], k_pool.shape[2],
                             _sm_count(q.device))
    cells = B * KV * -(-(H // KV) // _MAX_GROUP)
    ws, counters = _workspace(
        q.device, cells * splits * _MAX_GROUP * (2 + HD), cells)
    return splits, per, ws, counters, torch.empty_like(q)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_kv_append(k_pool, v_pool, k_new, v_new, tables, pos, layer, *,
                    k_scale=None, v_scale=None, k_new_scale=None,
                    v_new_scale=None):
    """Write each row's new KV into its tail pool block, IN PLACE.

    k_pool/v_pool [L, NB, BS, KV, hd]; k_new/v_new [B, KV, hd] (pool
    dtype); tables [B, W] int32; pos [B] int32 (the position being
    written; positions >= W*BS write nothing); layer: int.  With the
    int8 sidecar (`k_scale`/`v_scale` [L, NB, BS, KV] f32 + per-row
    `k_new_scale`/`v_new_scale` [B, KV]) returns (k_pool, v_pool,
    k_scale, v_scale), else (k_pool, v_pool): the same tensors, updated
    in place (the JAX version returns donated buffers instead)."""
    if k_pool.device.type == "cpu":
        return paged_kv_append_reference(
            k_pool, v_pool, k_new, v_new, tables, pos, layer,
            k_scale=k_scale, v_scale=v_scale, k_new_scale=k_new_scale,
            v_new_scale=v_new_scale,
        )
    layer = _check_append(k_pool, v_pool, k_new, v_new, tables, pos, layer,
                          k_scale, v_scale, k_new_scale, v_new_scale)
    _, NB, BS, KV, HD = k_pool.shape
    row_bytes = HD * k_pool.element_size()
    rc = _lib().rt_paged_kv_append(
        k_pool.data_ptr(), v_pool.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), _ptr(k_scale), _ptr(v_scale), _ptr(k_new_scale),
        _ptr(v_new_scale), tables.data_ptr(), pos.data_ptr(), layer, NB, BS,
        KV, row_bytes, k_new.shape[0], tables.shape[1],
        _vec_bytes(row_bytes, k_pool, v_pool, k_new, v_new),
        torch.cuda.current_stream(k_pool.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_kv_append kernel launch failed: "
                           f"CUDA error {rc}")
    paged_kv_append.launches += 1
    if k_scale is not None:
        return k_pool, v_pool, k_scale, v_scale
    return k_pool, v_pool


paged_kv_append.launches = 0


def paged_decode_attention(q, k_pool, v_pool, tables, pos, layer, *,
                           k_scale=None, v_scale=None):
    """One step of decode attention straight off the paged pool.

    q [B, H, hd] (post-RoPE, current positions); k_pool/v_pool
    [L, NB, BS, KV, hd]; tables [B, W] int32 block tables (pad with the
    scratch block); pos [B] int32 per-row positions — attention covers
    columns 0..pos[b] inclusive, so the current row must already be
    written (`paged_kv_append` first).  `layer` selects the pool layer.
    GQA: query head h attends through kv head h // (H // KV).  Returns
    o [B, H, hd] in q's dtype.

    On the card the split partials go through a workspace and arrival
    counters allocated once per device and shared by every call: two
    streams must not run this kernel at once on one device."""
    if k_pool.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, tables, pos, layer,
            k_scale=k_scale, v_scale=v_scale,
        )
    layer = _check_attention(q, k_pool, v_pool, tables, pos, layer, k_scale,
                             v_scale)
    _, NB, BS, KV, HD = k_pool.shape
    B, H = q.shape[0], q.shape[1]
    splits, per, ws, counters, out = _attention_plan(q, k_pool, tables)
    rc = _lib().rt_paged_decode_attention(
        out.data_ptr(), q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), tables.data_ptr(), pos.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), layer, NB, BS, KV, HD, H, B,
        tables.shape[1], per, splits, float(HD ** -0.5),
        _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_append_decode_attention(q, k_pool, v_pool, k_new, v_new, tables,
                                  pos, layer, *, k_scale=None, v_scale=None,
                                  k_new_scale=None, v_new_scale=None):
    """`paged_kv_append` then `paged_decode_attention` on the same
    arguments, as one op: the decode step's append and attention for
    one layer.  The pools (and, for int8 pools, the scale sidecars) are
    updated IN PLACE, as `paged_kv_append` updates them; returns the
    attention output [B, H, hd] in q's dtype.  Int8 `k_new` / `v_new`
    come quantized, with their per-row `k_new_scale` / `v_new_scale`.

    On the card it is one launch: K6 with K5's writes in its prologue
    (`csrc/paged_attention.cu`, `kAppend`).  Output and pools equal the
    pair's, bit for bit, on every row whose live blocks no other row of
    the call writes.  A row that reads a block another row of the same
    call appends into sees either content: rows parked on scratch block
    0 (idle slots) read garbage by contract, in both routes.  Shares
    K6's workspace: two streams must not run the K6 kernels at once on
    one device."""
    if k_pool.device.type == "cpu":
        return paged_append_decode_attention_reference(
            q, k_pool, v_pool, k_new, v_new, tables, pos, layer,
            k_scale=k_scale, v_scale=v_scale, k_new_scale=k_new_scale,
            v_new_scale=v_new_scale,
        )
    layer = _check_attention(q, k_pool, v_pool, tables, pos, layer, k_scale,
                             v_scale)
    _check_new_rows(k_pool, k_new, v_new, k_new_scale, v_new_scale,
                    q.shape[0])
    _, NB, BS, KV, HD = k_pool.shape
    B, H = q.shape[0], q.shape[1]
    splits, per, ws, counters, out = _attention_plan(q, k_pool, tables)
    row_bytes = HD * k_pool.element_size()
    rc = _lib().rt_paged_append_decode_attention(
        out.data_ptr(), q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), k_new.data_ptr(), v_new.data_ptr(),
        _ptr(k_new_scale), _ptr(v_new_scale), tables.data_ptr(),
        pos.data_ptr(), ws.data_ptr(), counters.data_ptr(), layer, NB, BS,
        KV, HD, H, B, tables.shape[1], per, splits, float(HD ** -0.5),
        _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[k_pool.dtype],
        _vec_bytes(row_bytes, k_pool, v_pool, k_new, v_new),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_append_decode_attention kernel launch "
                           f"failed: CUDA error {rc}")
    paged_append_decode_attention.launches += 1
    return out


paged_append_decode_attention.launches = 0
