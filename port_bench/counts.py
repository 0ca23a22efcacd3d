"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes each measured piece of work needs, from shapes.

Frozen with the benchmark: a later change to the program cannot move
the numbers its metrics are divided by.  The flash and paged-attention
counts follow `chip_smoke.py`'s (`flash_flops`, `flash_bound`,
`_attention_work`, `fused_bound`), with shapes passed in rather than
read off tensors.

Peaks: one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data
sheet): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take: (seconds, which bound)."""
    t_bytes = n_bytes / PEAK_HBM_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------------
# flash attention (K1 forward, K2 fused backward), causal or not
# ----------------------------------------------------------------------
_FLASH_MATS = {"k1": 2, "k2": 5}          # products a (q, k) pair
_FLASH_IO = {"k1": (4, 1), "k2": (8, 1)}  # (bf16 [BH, T, D] tensors, f32 rows)


def flash_flops(kernel: str, bh: int, t: int, d: int, causal: bool) -> float:
    """2 * D per (q, k) pair per product, over the pairs the call needs
    (the lower triangle with the diagonal when causal)."""
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    return 2.0 * d * pairs * _FLASH_MATS[kernel]


def flash_bytes(kernel: str, bh: int, t: int, d: int,
                elem: int = 2) -> float:
    """Each input read once and each output written once: K1 reads q, k,
    v and writes o (and the f32 lse); K2 reads q, k, v, o, do (and the
    lse) and writes dq, dk, dv."""
    tensors, rows = _FLASH_IO[kernel]
    return tensors * bh * t * d * elem + rows * bh * t * 4


def flash_bound_s(kernel: str, bh: int, t: int, d: int,
                  causal: bool = True) -> float:
    return bound_s(flash_bytes(kernel, bh, t, d),
                   flash_flops(kernel, bh, t, d, causal))[0]


# ----------------------------------------------------------------------
# fused K5 + K6 (paged append + decode attention), one layer's launch
# ----------------------------------------------------------------------
def k5k6_work(rows: int, live_cols: int, n_blocks: int, h: int, kv: int,
              hd: int, elem: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one fused launch over `rows` decoding rows
    whose attention reads `live_cols` KV columns in all (pos + 1 a row)
    over `n_blocks` table entries.  Bytes: q read and o written once,
    each live column's K and V read once, each row's new K and V
    written once more, the table entries and positions.  Operations:
    4 * H * hd a live column (QK and PV)."""
    q_o = 2 * rows * h * hd * elem
    kv_read = live_cols * 2 * kv * hd * elem
    kv_write = rows * 2 * kv * hd * elem
    return (q_o + kv_read + kv_write + 4 * n_blocks + 4 * rows,
            4.0 * h * hd * live_cols)


# ----------------------------------------------------------------------
# whole-model counts
# ----------------------------------------------------------------------
def head_dim(cfg: Dict) -> int:
    """The config's `head_dim`, else hidden size over heads."""
    return cfg.get("head_dim") or (cfg["hidden_size"]
                                    // cfg["num_attention_heads"])


def llama_matmul_params(cfg: Dict) -> Tuple[int, int]:
    """(matmul weights a token through the blocks, lm-head weights) of a
    Llama-style model given its published sizes."""
    e, i = cfg["hidden_size"], cfg["intermediate_size"]
    hd = head_dim(cfg)
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    per_layer = e * q + 2 * e * kv + q * e + 3 * e * i
    return cfg["num_hidden_layers"] * per_layer, e * cfg["vocab_size"]


def causal_attention_flops(cfg: Dict, t: int) -> float:
    """Forward attention of one causal sequence of `t` tokens through
    every layer: QK and PV over the lower triangle with the diagonal."""
    q = cfg["num_attention_heads"] * head_dim(cfg)
    return cfg["num_hidden_layers"] * 4.0 * q * t * (t + 1) / 2


def decode_attention_flops(cfg: Dict, live_cols: int) -> float:
    """Attention of decode steps whose rows read `live_cols` columns in
    all, through every layer."""
    q = cfg["num_attention_heads"] * head_dim(cfg)
    return cfg["num_hidden_layers"] * 4.0 * q * live_cols


def prefill_flops(cfg: Dict, t: int) -> float:
    """A prompt of `t` real tokens: every token through the blocks,
    causal attention over them, and the lm head once (the last row,
    which gives the first token); bucket padding is not counted."""
    blocks, head = llama_matmul_params(cfg)
    return 2.0 * blocks * t + 2.0 * head + causal_attention_flops(cfg, t)


def decode_flops(cfg: Dict, tokens: int, live_cols: int) -> float:
    """`tokens` decode rows that read `live_cols` columns in all."""
    blocks, head = llama_matmul_params(cfg)
    return 2.0 * (blocks + head) * tokens + decode_attention_flops(
        cfg, live_cols)
