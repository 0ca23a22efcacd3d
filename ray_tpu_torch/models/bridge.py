"""Weight bridge between the JAX package's params and the port's.

Both sides keep the same tree (nested dicts, lists and tuples: rllib's
towers are lists of layer dicts) and the same layouts (stacked
`[L, ...]` blocks, `[in, out]` weights), so the bridge is a straight
copy, leaf by leaf.  The caller turns the JAX tree into numpy first
(`jax.tree.map(np.asarray, params)`): the port never imports JAX.
bf16 arrives as `ml_dtypes.bfloat16` and crosses as its raw 16 bits,
so the copy is bit-exact in both directions.  LoRA adapter trees
(`llama.init_lora`) cross the same way, their `scale` as a 0-d array.

Adam's state crosses too: optax's `ScaleByAdamState` (`count`, `mu`,
`nu`, handed over as numpy by the caller, `mu` and `nu` trees shaped
like the params) becomes the state of the port's `gpt2.AdamW` (the
count, and one moment tensor a leaf in `tree_leaves` order), and back.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch import resolve_device


def tree_map(fn: Callable, tree):
    """`fn` on every leaf of a tree of dicts, lists and tuples, the
    structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    """Leaves in the order `jax.tree.leaves` lists them: dict entries by
    sorted key, list and tuple entries in order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """`template`'s structure with `leaves` (in `tree_leaves` order) at
    its leaves."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [build(v) for v in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)

    return build(template)


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
    """numpy tree -> the port's tree of tensors on `device` (default:
    the CUDA device).  `dtype` casts the floating leaves (int8 weight
    payloads and other integer leaves keep their type)."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree of tensors -> numpy tree; bf16 leaves come back
    as `ml_dtypes.bfloat16` arrays, bit for bit.  A CPU leaf's array is
    a view of the tensor."""
    return tree_map(_to_numpy, params)


def adam_state_from_numpy(count, mu, nu, device=None) -> Dict[str, Any]:
    """optax's Adam state (its `count`, and `mu` / `nu` as numpy trees
    shaped like the params) -> `gpt2.AdamW`'s state on `device`: the
    count as an int, f32 moments a leaf in `tree_leaves` order."""
    device = resolve_device(device)

    def moments(tree):
        return [_to_tensor(a, device, torch.float32)
                for a in tree_leaves(tree)]

    return {"count": int(np.asarray(count)), "mu": moments(mu),
            "nu": moments(nu)}


def adam_state_to_numpy(state: Dict[str, Any], params) -> Dict[str, Any]:
    """`gpt2.AdamW`'s state -> optax's layout in numpy: `count` as an
    int32 scalar, `mu` and `nu` as trees shaped like `params`, each
    leaf a copy (the optimizer updates its moments in place)."""
    return {"count": np.asarray(state["count"], np.int32),
            "mu": tree_unflatten(params, [_to_numpy(t).copy()
                                          for t in state["mu"]]),
            "nu": tree_unflatten(params, [_to_numpy(t).copy()
                                          for t in state["nu"]])}
