"""Logical-axis sharding rules.

GSPMD-style: model code annotates parameters with *logical* axis names
("embed", "mlp", "heads", "vocab", ...), and a rule table maps logical
axes to mesh axes.  Changing the parallelism strategy is a rule-table
swap, not a model edit.  The port of the JAX package's
`parallel/sharding.py`: the same table, with a sharding spelled as
DTensor placements (one a mesh dimension, `Shard(dim)` or
`Replicate()`) where the reference spells a `PartitionSpec`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.parallel.mesh import dtensor, placements

# Default rules for a transformer sharded Megatron-style over tp with
# ZeRO-3-style param sharding over fsdp:
#   - embed dim is sharded over fsdp (params split for memory)
#   - mlp hidden + attention heads over tp (compute split)
#   - vocab over tp (output projection)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    None: None,
}


def spec_from_logical(
    logical: Tuple[Optional[str], ...], rules: Optional[Dict] = None,
    mesh=None,
) -> tuple:
    """Placements over the mesh's dimensions (AXES when no mesh is
    given) for a tensor whose dims carry the logical names `logical`."""
    rules = rules or DEFAULT_RULES
    return placements(mesh, [rules.get(ax) for ax in logical])


def sharding_from_logical(
    mesh, logical: Tuple[Optional[str], ...], rules: Optional[Dict] = None
) -> tuple:
    return spec_from_logical(logical, rules, mesh)


def _is_logical(x) -> bool:
    return isinstance(x, tuple)


def tree_paths(tree, is_leaf=None, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of a tree in `jax.tree_util` order: dict keys
    sorted, lists and tuples by position, None an empty subtree;
    `is_leaf` stops the walk at what it accepts."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in
                tree_paths(tree[k], is_leaf, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in
                tree_paths(t, is_leaf, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_rebuild(tree, leaves, is_leaf=None):
    """`tree`'s structure (its dicts' key order kept) holding `leaves`,
    given in `tree_paths` order."""
    it = iter(leaves)

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(t) for t in node)
        return None if node is None else next(it)

    return walk(tree)


def _tree_map(fn, tree, is_leaf=None):
    return tree_rebuild(tree, [fn(x) for _, x in tree_paths(tree, is_leaf)],
                        is_leaf)


def tree_shardings(mesh, logical_tree: Any, rules: Optional[Dict] = None
                   ) -> Any:
    """Map a tree of logical-axis tuples to placements."""
    return _tree_map(
        lambda logical: sharding_from_logical(mesh, tuple(logical), rules),
        logical_tree, _is_logical)


def shard_params(params: Any, mesh, logical_tree: Any,
                 rules: Optional[Dict] = None) -> Any:
    """`distribute_tensor` each parameter according to logical rules
    (every rank passes the same full tensors, as DTensor requires)."""
    shardings = tree_shardings(mesh, logical_tree, rules)
    places = [pl for _, pl in tree_paths(shardings, _is_logical)]
    return tree_rebuild(params, [
        dtensor().distribute_tensor(p, mesh, list(pl))
        for (_, p), pl in zip(tree_paths(params), places)])


def infer_logical_like(params: Any, fallback=()) -> Any:
    """Fully-replicated logical tree matching `params` (for opt state
    scalars and anything without an annotation)."""
    return _tree_map(lambda _: tuple(fallback), params)


def optimizer_shardings(mesh, opt, params: Any, param_shardings: Any) -> Any:
    """Placements for `opt.init(params)` state: a state leaf whose tree
    path ends with a parameter's path (optax-style state embedding the
    param tree) inherits that parameter's sharding, the longest
    matching suffix winning; a state list with one entry a parameter
    leaf (the port's `AdamW` keeps `mu` / `nu` in `_leaves` order)
    gives entry i the sharding of leaf i; scalars and anything
    unrecognised replicate.  The state's shapes come from `opt.init` on
    meta tensors: nothing is allocated."""
    import torch

    meta = _tree_map(lambda p: torch.empty_like(p, device="meta"), params)
    state = opt.init(meta)
    p_leaves = tree_paths(params)
    s_leaves = tree_paths(param_shardings, _is_logical)
    by_path = {
        tuple(pp): (tuple(pl.shape), sl)
        for (pp, pl), (_, sl) in zip(p_leaves, s_leaves)
    }
    by_index = [(tuple(pl.shape), sl)
                for (_, pl), (_, sl) in zip(p_leaves, s_leaves)]
    replicated_ = placements(mesh, ())

    def pick(path, leaf, aligned=None):
        # longest matching path suffix wins; then the leaf this entry
        # of a `_leaves`-aligned list stands for
        shape = tuple(getattr(leaf, "shape", ()))
        for i in range(len(path)):
            hit = by_path.get(tuple(path[i:]))
            if hit is not None and shape == hit[0]:
                return hit[1]
        if aligned is not None and shape == by_index[aligned][0]:
            return by_index[aligned][1]
        return replicated_

    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            aligned = len(tree) == len(by_index)
            return [walk(t, prefix + (i,)) if isinstance(t, (dict, list))
                    else pick(prefix + (i,), t, i if aligned else None)
                    for i, t in enumerate(tree)]
        return pick(prefix, tree)

    return walk(state)
