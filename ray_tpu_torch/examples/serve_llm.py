"""LLM serving example, model half: the size table and the model
constructor of the JAX package's `examples/serve_llm.py`.

The service classes (`LlamaService`, `ContinuousLlamaService`) ride
the serve plane, which is not ported yet (ROADMAP.md queue 1); until
then `serve.llm_engine.LlamaEngine` is the server:

    from ray_tpu_torch.examples.serve_llm import _build_model
    from ray_tpu_torch.serve.llm_engine import LlamaEngine
    cfg, params = _build_model("llama3_8b", seed=0)
    engine = LlamaEngine(cfg, params, slots=8)
    tokens = engine.submit([1, 2, 3], 16).result()
"""

from __future__ import annotations

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama

MODEL_SIZES = ("tiny", "llama1b4", "llama2_7b", "llama3_8b")


def _build_model(model_size: str, seed: int, device=None):
    """(cfg, params) for `model_size`, random weights from `seed` on
    `device` (default: the CUDA device).  Non-tiny models serve in
    bf16: decode is weight-read bound, and bf16 halves the bytes."""
    if model_size not in MODEL_SIZES:
        raise ValueError(f"model_size must be one of {MODEL_SIZES}")
    cfg = {
        "tiny": llama.LlamaConfig.tiny,
        # the 1.4B serving unit of the reference's size table
        "llama1b4": lambda: llama.LlamaConfig(
            vocab_size=32000, max_seq_len=1024, dim=2048, n_layers=22,
            n_heads=16, n_kv_heads=16, intermediate=5632,
        ),
        "llama2_7b": llama.LlamaConfig.llama2_7b,
        "llama3_8b": llama.LlamaConfig.llama3_8b,
    }[model_size]()
    device = resolve_device(device)
    if model_size == "tiny":
        # the reference keeps tiny's params in f32 (compute stays bf16)
        return cfg, llama.init_params(cfg, seed, device=device)
    return cfg, llama.init_params(cfg, seed, device=device,
                                  dtype=torch.bfloat16)
