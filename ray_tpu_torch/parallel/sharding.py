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

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import (
    distribute, dtensor, placements,
)

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
    (every rank passes the same full tensors, as DTensor requires),
    onto `compute_mesh(mesh)`, where a training step's DTensors live."""
    return distribute_tree(params, mesh,
                           tree_shardings(mesh, logical_tree, rules))


def distribute_tree(tree: Any, mesh, shardings: Any) -> Any:
    """Each tensor leaf of `tree` a DTensor on `compute_mesh(mesh)`,
    split by the placements (over `mesh`'s dims) of the same leaf of
    `shardings` (`tree_shardings` or `optimizer_shardings` output);
    other leaves (a step count) stay as they are.  The counterpart of
    the reference's `jax.device_put(tree, shardings)`."""
    import torch

    places = [pl for _, pl in tree_paths(shardings, _is_logical)]
    leaves = tree_paths(tree)
    if len(places) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(places)} "
                         "shardings")
    out = []
    for (_, x), pl in zip(leaves, places):
        if isinstance(x, torch.Tensor):
            x = distribute(x, mesh, pl)
        out.append(x)
    return tree_rebuild(tree, out)


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


# ----------------------------------------------------------------------
# a sharded training step's local blocks
# ----------------------------------------------------------------------
# The step's DTensors are storage: the parameters, the optimizer state
# and the batch keep their placements (and go to a sharded checkpoint as
# they are).  The arithmetic runs on plain local tensors, as FSDP2 runs
# it: each parameter is all-gathered over the data axes that split it
# (ZeRO-3), its tp block kept, and the model splits its heads, MLP
# columns and vocabulary over tp Megatron-style (`enter` before a
# column-parallel product, `exit` after a row-parallel one, the
# vocabulary-parallel embedding and loss); over ep each rank keeps its
# experts and the MoE layer exchanges slots (`parallel/moe.py`).  Every
# collective goes through `collectives`, so each is counted by (op,
# backend, route) in `collectives.TRANSPORTS` and a CUDA tensor crosses a
# gloo group through the host explicitly.  DTensor's own propagation is
# not asked to carry the model: its strategies walk every mesh dim on
# every op, and its collectives would hand CUDA tensors to gloo itself
# (torch 2.11's gloo crashes on a CUDA `all_gather_into_tensor`:
# `scripts/gloo_cuda_probe`).

DATA_AXES = ("dp", "fsdp")
# sp is a data axis for the parameters (replicated over it, their
# gradients summed over it) and a sequence axis for the activations
# (each rank computes on its contiguous chunk of the sequence)
PARAM_DATA_AXES = DATA_AXES + ("sp",)
# ep splits the experts (a leaf on Shard over ep keeps its block) and,
# outside the MoE layer, the rows: a leaf replicated over ep has its
# gradient summed over it, as over a data axis
GRAD_SUM_AXES = PARAM_DATA_AXES + ("ep",)
STEP_AXES = GRAD_SUM_AXES + ("tp",)


def _autograd():
    import torch

    class Unshard(torch.autograd.Function):
        """A parameter's local block -> its block with the `gathers`
        (tensor dim, group) all-gathered, innermost mesh dim first.
        Backward: the gradient summed over every data rank and cut back
        to this rank's block (a reduce-scatter over each gathered group,
        a sum over each of `sums`).  The MoE layer gathers its
        activations so too (`LocalShards.moe_chunk`)."""

        @staticmethod
        def forward(ctx, x, gathers, sums):
            ctx.gathers, ctx.sums = gathers, sums
            for dim, group in gathers:
                x = collectives.all_gather(x, group, axis=dim)
            return x

        @staticmethod
        def backward(ctx, g):
            for dim, group in reversed(ctx.gathers):
                g = collectives.reduce_scatter(g, group,
                                               scatter_dimension=dim)
            for group in ctx.sums:
                g = collectives.psum(g, group)
            return g, None, None

    class Enter(torch.autograd.Function):
        """Identity; the gradient summed over tp (the input of a
        column-parallel product, replicated over tp)."""

        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return collectives.psum(g, ctx.group), None

    class Exit(torch.autograd.Function):
        """The sum over tp (a row-parallel product's partial sums); the
        gradient passes as it is."""

        @staticmethod
        def forward(ctx, x, group):
            return collectives.psum(x, group)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class DataMean(torch.autograd.Function):
        """The mean over the data ranks of a value each computed on its
        rows; the gradient of each rank's value is 1 / n of the mean's."""

        @staticmethod
        def forward(ctx, x, groups, n):
            ctx.n = n
            for group in groups:
                x = collectives.psum(x, group)
            return x / n

        @staticmethod
        def backward(ctx, g):
            return g / ctx.n, None, None

    return Unshard, Enter, Exit, DataMean


_FNS: list = []


def _fns():
    if not _FNS:
        _FNS.extend(_autograd())
    return _FNS


def _chunk_start(size: int, n: int, i: int) -> int:
    """Where block i of `size` split n ways starts (`torch.chunk`'s
    sizes, as DTensor's `Shard` splits)."""
    return min(i * -(-size // n), size)


class Unsharded:
    """The one-process step: no block to gather, nothing to sum."""

    tp = 1

    def enter(self, x):
        return x

    def exit(self, x):
        return x

    def seq_chunk(self, x):
        return x

    def seq_offset(self, n_local: int) -> int:
        return 0


UNSHARDED = Unsharded()


class LocalShards(Unsharded):
    """How a sharded step's DTensor leaves become each rank's compute
    blocks, and the tp collectives of the model around them.  Built from
    the mesh the leaves live on (`compute_mesh`), whose dims must be
    among dp, fsdp, ep, sp and tp.  Over sp each rank computes on its
    contiguous chunk of the sequence (`seq_chunk`), the attention
    crosses the chunks (`ring_attention.select_attention`), and the
    parameters, replicated over sp, have their gradients summed over
    it.

    Over ep the experts split (a leaf on Shard over ep keeps its
    block) and so do the rows: ep is the outermost split of the batch,
    so the ranks of one ep rank hold together chunk `ep_rank` of it, the
    chunk the reference's MoE layer routes there (`moe_chunk`); outside
    the MoE layer ep is one more data axis (the leaves replicated over
    it have their gradients summed over it, and the loss is a mean over
    it)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        names = list(mesh.mesh_dim_names)
        sizes = {n: int(mesh.size(i)) for i, n in enumerate(names)}
        other = [n for n in names if n not in STEP_AXES and sizes[n] > 1]
        if other:
            raise NotImplementedError(
                f"a sharded step splits over {STEP_AXES}; the mesh also "
                f"splits over {other}")
        self.mesh = mesh
        self.names = names
        self.groups = {n: mesh.get_group(n) for n in names}
        # the loss is a mean over rows and sequence chunks alike: every
        # rank holds rows and a sequence chunk of its own
        self.data = [n for n in names if n in GRAD_SUM_AXES]
        self.n_data = 1
        for n in self.data:
            self.n_data *= sizes[n]

        def size_group_rank(name):
            n = sizes.get(name, 1)
            group = self.groups.get(name)
            return n, group, dist.get_rank(group) if n > 1 else 0

        self.tp, self.tp_group, self.tp_rank = size_group_rank("tp")
        self.sp, self.sp_group, self.sp_rank = size_group_rank("sp")
        self.ep, self.ep_group, self.ep_rank = size_group_rank("ep")
        # the batch inside an ep chunk splits over dp and fsdp in mesh
        # order: this rank's block `row_index` of `n_rows`
        self.row_axes = [n for n in names if n in DATA_AXES
                         and sizes[n] > 1]
        self.n_rows, self.row_index = 1, 0
        for n in self.row_axes:
            self.n_rows *= sizes[n]
            self.row_index = (self.row_index * sizes[n]
                              + dist.get_rank(self.groups[n]))

    # -- leaves ---------------------------------------------------------
    def unshard(self, p, over_tp: bool = False):
        """The compute block of a DTensor parameter: gathered over the
        data dims that split it (and over tp too with `over_tp`), its
        other splits kept; differentiable (its gradient is summed over
        every data rank, as the step's gradient must be)."""
        if list(p.device_mesh.mesh_dim_names) != self.names:
            raise ValueError("every leaf of a sharded step lives on one "
                             "mesh")
        gathers, sums = [], []
        for i in reversed(range(len(self.names))):
            name, pl = self.names[i], p.placements[i]
            gather = name in PARAM_DATA_AXES or (over_tp and name == "tp")
            if pl.is_shard() and gather:
                n = self.mesh.size(i)
                if p.shape[pl.dim] % n:
                    raise ValueError(
                        f"dim {pl.dim} ({p.shape[pl.dim]}) of a "
                        f"{tuple(p.shape)} leaf does not gather evenly "
                        f"over {name} {n}")
                gathers.append((pl.dim, self.groups[name]))
            elif not pl.is_shard() and name in GRAD_SUM_AXES:
                sums.append(self.groups[name])
            # else a tp or ep block, kept
        return _fns()[0].apply(p.to_local(), gathers, sums)

    def rows(self, t):
        """This rank's rows of a batch placed by `prepare_batch` (the
        whole sequence: `seq_chunk` cuts it after the shift).  Over ep
        the rows of chunk `ep_rank` of the batch, block `row_index` of
        them: the batch (its block over dp / fsdp a rank) is gathered
        first, a few ints a row."""
        if not isinstance(t, dtensor().DTensor):
            raise TypeError("a sharded step takes its batch as a DTensor "
                            "(train.cuda_utils.prepare_batch)")
        if "sp" in self.names and t.placements[
                self.names.index("sp")].is_shard():
            raise ValueError("a sharded step takes its batch whole over "
                             "sp (prepare_batch's data_sharding); the "
                             "model cuts each rank's chunk")
        local = t.to_local()
        if self.ep == 1:
            return local
        whole = local
        for i in reversed(range(len(self.names))):
            pl = t.placements[i]
            if pl.is_shard():
                if pl.dim != 0:
                    raise ValueError("a sharded step's batch splits its "
                                     "rows alone")
                whole = collectives.all_gather(
                    whole, self.groups[self.names[i]], axis=0)
        n = self.ep * self.n_rows
        if whole.shape[0] % n:
            raise ValueError(f"a batch of {whole.shape[0]} rows does not "
                             f"split over ep {self.ep} x {self.n_rows} "
                             "data ranks")
        b = whole.shape[0] // n
        i = self.ep_rank * self.n_rows + self.row_index
        return whole[i * b:(i + 1) * b]

    # -- the MoE layer's chunk of the batch over ep ---------------------
    def moe_chunk(self, x):
        """This rank's activations [b, t, D] (its rows, its chunk of the
        sequence) -> chunk `ep_rank` of the batch, whole over the
        sequence [n_rows b, sp t, D]: gathered over sp and the data axes
        of the rows (differentiable: the backward is their
        reduce-scatter, each data rank's gradient being its own rows'
        part)."""
        gathers = [(1, self.sp_group)] if self.sp > 1 else []
        gathers += [(0, self.groups[n]) for n in reversed(self.row_axes)]
        return _fns()[0].apply(x, gathers, []) if gathers else x

    def moe_rows(self, y):
        """`moe_chunk`'s inverse: this rank's rows and sequence chunk of
        its ep chunk's [B / ep, T, D]."""
        b = y.shape[0] // self.n_rows
        return self.seq_chunk(y[self.row_index * b:(self.row_index + 1)
                                * b])

    # -- the sequence over sp -------------------------------------------
    def seq_chunk(self, x):
        """This rank's contiguous chunk of dim 1 (the sequence) of `x`,
        chunk `sp_rank` of `sp` equal ones."""
        if self.sp == 1:
            return x
        T = x.shape[1]
        if T % self.sp:
            raise ValueError(f"sequence length {T} does not split over "
                             f"sp {self.sp}")
        n = T // self.sp
        return x[:, self.sp_rank * n:(self.sp_rank + 1) * n]

    def seq_offset(self, n_local: int) -> int:
        """Where this rank's chunk of `n_local` positions starts in the
        whole sequence."""
        return self.sp_rank * n_local

    # -- tp around the model's products ---------------------------------
    def enter(self, x):
        return _fns()[1].apply(x, self.tp_group) if self.tp > 1 else x

    def exit(self, x):
        return _fns()[2].apply(x, self.tp_group) if self.tp > 1 else x

    def vocab_range(self, vocab: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a vocabulary split over tp."""
        return (_chunk_start(vocab, self.tp, self.tp_rank),
                _chunk_start(vocab, self.tp, self.tp_rank + 1))

    def data_mean(self, x):
        """The mean over the data ranks (ep's included) and the sequence
        chunks (all of one size) of a mean each rank took over its own:
        the global mean."""
        return _fns()[3].apply(x, [self.groups[n] for n in self.data],
                               self.n_data)


def local_shards(tree) -> Unsharded:
    """`LocalShards` for a tree whose tensor leaves are DTensors (the mesh
    of its first), `UNSHARDED` for plain tensors.  A mesh that splits ep
    takes a tree with experts (a leaf on Shard over ep): ep splits the
    experts and the rows between them, and a model without experts
    splits its rows over dp."""
    DTensor = dtensor().DTensor
    leaves = [leaf for _, leaf in tree_paths(tree)
              if isinstance(leaf, DTensor)]
    if not leaves:
        return UNSHARDED
    shards = LocalShards(leaves[0].device_mesh)
    if shards.ep > 1:
        i = shards.names.index("ep")
        if not any(leaf.placements[i].is_shard() for leaf in leaves):
            raise NotImplementedError(
                f"a sharded step splits over ep only a tree with experts; "
                f"no leaf of this one splits over ep {shards.ep} (split "
                f"its rows over dp)")
    return shards


def unshard_tree(shards: Unsharded, tree, over_tp=()):
    """`tree` with each DTensor leaf replaced by its compute block
    (`LocalShards.unshard`; over tp too for the top-level or block keys
    named in `over_tp`)."""
    DTensor = dtensor().DTensor
    return tree_rebuild(tree, [
        shards.unshard(x, over_tp=bool(set(path) & set(over_tp)))
        if isinstance(x, DTensor) else x for path, x in tree_paths(tree)])


def embed(shards: Unsharded, w, tokens, vocab: int):
    """`w[tokens]` for embedding rows `w` split over tp by the vocabulary:
    each rank looks up the tokens in its rows, the others read 0, and the
    rows are summed over tp."""
    if shards.tp == 1:
        return w[tokens]
    import torch

    lo, hi = shards.vocab_range(vocab)
    local = tokens - lo
    hit = (local >= 0) & (local < hi - lo)
    rows = w[local.clamp(0, max(hi - lo - 1, 0))]
    return shards.exit(torch.where(hit[..., None], rows,
                                   torch.zeros((), dtype=rows.dtype,
                                               device=rows.device)))


def lse_and_target(shards: Unsharded, logits, targets, vocab: int):
    """(logsumexp over the vocabulary in f32, the target's logit in f32)
    for logits [..., V] whose last dim is this rank's block of the
    vocabulary (the whole of it unsharded).  Over tp: each rank's
    logsumexp is gathered and reduced again; the target's logit is read
    where it lies and summed over tp."""
    import torch

    if shards.tp == 1:
        return (torch.logsumexp(logits.float(), dim=-1),
                logits.gather(-1, targets[..., None])[..., 0].float())
    from ray_tpu_torch.parallel.ring_attention import _Gather

    lse_local = torch.logsumexp(logits.float(), dim=-1)
    lse = torch.logsumexp(_Gather.apply(lse_local[None], shards.tp_group, 0),
                          dim=0)
    lo, hi = shards.vocab_range(vocab)
    local = targets - lo
    hit = (local >= 0) & (local < hi - lo)
    tgt = logits.gather(-1, local.clamp(0, max(hi - lo - 1, 0))[..., None]
                        )[..., 0].float()
    return lse, shards.exit(torch.where(hit, tgt, torch.zeros(
        (), dtype=tgt.dtype, device=tgt.device)))


def global_norm(tensors):
    """sqrt of the sum of squares of every element (f32).  DTensor leaves
    count each element once: each rank's block is summed, a block
    replicated over a mesh dim divided by that dim's size, and the sums
    added over every dim of the mesh."""
    import torch

    DTensor = dtensor().DTensor
    tensors = list(tensors)
    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    mesh = next(t for t in tensors if isinstance(t, DTensor)).device_mesh
    total = 0
    for t in tensors:
        if not isinstance(t, DTensor):
            raise ValueError("a norm over DTensors takes no plain tensor")
        s = t.to_local().float().square().sum()
        for i, pl in enumerate(t.placements):
            if not pl.is_shard():
                s = s / mesh.size(i)
        total = total + s
    for name in mesh.mesh_dim_names:
        if mesh.size(list(mesh.mesh_dim_names).index(name)) > 1:
            total = collectives.psum(total, mesh.get_group(name))
    return torch.sqrt(total)
