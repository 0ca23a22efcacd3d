"""Weight bridge between the JAX package's params and the port's.

Both sides keep the same tree (nested dicts) and the same layouts
(stacked `[L, ...]` blocks, `[in, out]` weights), so the bridge is a
straight copy, leaf by leaf.  The caller turns the JAX tree into numpy
first (`jax.tree.map(np.asarray, params)`): the port never imports JAX.
bf16 arrives as `ml_dtypes.bfloat16` and crosses as its raw 16 bits,
so the copy is bit-exact in both directions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch import resolve_device


def _to_tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype: torch.dtype = None) -> Dict[str, Any]:
    """numpy tree -> the port's dict of tensors on `device` (default:
    the CUDA device).  `dtype` casts the floating leaves (int8 weight
    payloads and other integer leaves keep their type)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, device, dtype)

    return walk(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's dict of tensors -> numpy tree; bf16 leaves come back
    as `ml_dtypes.bfloat16` arrays, bit for bit."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(params)
