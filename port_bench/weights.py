"""Weights the benchmark makes itself, from the seed, on the device, in
the port's parameter layout (stacked `[L, ...]` blocks, `[in, out]`
matrices).  Each leaf comes from a generator of its own, seeded from
the run's seed and the leaf's name, in one call: the reference makes
the same leaf again, leaf by leaf, rather than take the program's.

Scales: matrices N(0, 0.02), the output projections 0.02 / sqrt(2 L),
norm gains 1 + N(0, 0.05) (not ones, so a dropped gain shows).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import torch

STD = 0.02
GAIN_STD = 0.05


def _gen(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + zlib.crc32(name.encode()))
                  % (1 << 63))
    return g


def leaf(seed: int, name: str, shape: Tuple[int, ...], std: float,
         gain: bool, device, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=_gen(seed, name, device), device=device,
                    dtype=dtype)
    x.mul_(std)
    if gain:
        x.add_(1.0)
    return x


def llama_specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float, bool]]:
    """(path, shape, std, is_gain) of every leaf of a Llama-style model
    given its published sizes; `path` is "/"-joined dict keys."""
    L, E = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or E // H
    I, V = cfg["intermediate_size"], cfg["vocab_size"]
    proj = STD / (2 * L) ** 0.5
    return [
        ("tok_emb", (V, E), STD, False),
        ("blocks/attn_norm", (L, E), GAIN_STD, True),
        ("blocks/wq", (L, E, H * hd), STD, False),
        ("blocks/wk", (L, E, KV * hd), STD, False),
        ("blocks/wv", (L, E, KV * hd), STD, False),
        ("blocks/wo", (L, H * hd, E), proj, False),
        ("blocks/mlp_norm", (L, E), GAIN_STD, True),
        ("blocks/w_gate", (L, E, I), STD, False),
        ("blocks/w_up", (L, E, I), STD, False),
        ("blocks/w_down", (L, I, E), proj, False),
        ("final_norm", (E,), GAIN_STD, True),
        ("lm_head", (E, V), STD, False),
    ]


def make(specs, seed: int, device, dtype) -> Dict:
    """The nested params dict of `specs`, every leaf in `dtype`."""
    out: Dict = {}
    for path, shape, std, gain in specs:
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf(seed, path, shape, std, gain, device, dtype)
    return out
