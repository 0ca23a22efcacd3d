"""`counts.py` against operations and bytes worked out by hand at one
small shape."""

from __future__ import annotations

import pytest

from port_bench import counts

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2,
       "num_key_value_heads": 1, "num_hidden_layers": 3, "vocab_size": 10,
       "num_local_experts": 4, "num_experts_per_tok": 2}


def test_flash_counts():
    # BH 2, T 4, D 8, causal: 2 * 10 pairs; K1 two products of 2 * D
    assert counts.flash_flops("k1", 2, 4, 8, True) == 2 * 8 * 20 * 2
    assert counts.flash_flops("k2", 2, 4, 8, False) == 2 * 8 * 32 * 5
    # K1: q, k, v, o in bf16 (2 * 4 * 8 elements each) + f32 lse rows
    assert counts.flash_bytes("k1", 2, 4, 8) == 4 * 64 * 2 + 8 * 4
    assert counts.flash_bytes("k2", 2, 4, 8) == 8 * 64 * 2 + 8 * 4
    t, by = counts.bound_s(3.35e12, 989e12 / 2)
    assert t == pytest.approx(1.0) and by == "bytes"


def test_k5k6_work():
    # 3 rows, 10 live columns, 2 blocks, H 2, KV 1, hd 4, bf16
    n_bytes, flops = counts.k5k6_work(3, 10, 2, 2, 1, 4)
    assert n_bytes == 2 * 3 * 2 * 4 * 2 + 10 * 2 * 1 * 4 * 2 \
        + 3 * 2 * 1 * 4 * 2 + 4 * 2 + 4 * 3
    assert flops == 4 * 2 * 4 * 10


def test_model_counts():
    hd = 4
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    assert counts.head_dim(CFG) == hd
    assert counts.llama_matmul_params(CFG) == (3 * per_layer, 80)
    assert counts.causal_attention_flops(CFG, 4) == 3 * 4 * 8 * 10
    assert counts.prefill_flops(CFG, 4) == (2 * 3 * per_layer * 4 + 2 * 80
                                            + 3 * 4 * 8 * 10)
    assert counts.decode_flops(CFG, 2, 7) == (2 * (3 * per_layer + 80) * 2
                                              + 3 * 4 * 8 * 7)
