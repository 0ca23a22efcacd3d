"""Device mesh construction: the unit of compute placement.

The port of the JAX package's `parallel/mesh.py`.  The same named
parallelism axes, in the same order:

    dp    pure data parallelism (params replicated)
    fsdp  sharded data parallelism (params/opt-state sharded, ZeRO-3)
    tp    tensor (Megatron-style layer) parallelism
    sp    sequence/context parallelism (ring attention rides this axis)
    ep    expert parallelism (MoE all-to-all)
    pp    pipeline parallelism (stage dimension)

`MeshSpec`'s arithmetic (`resolve`, `fit_to`, `dcn_split`, the slice
grouping) is the reference's, so both give the same answers.  Where the
reference lays axes onto `jax.devices()`, `build` lays them onto the
ranks of the `torch.distributed` world: a `DeviceMesh` with
`mesh_dim_names=AXES`, one process a device.  Ranks take the place the
reference's CPU (topology-free) path gives devices, so rank r sits
where device r sits there; with `slices > 1`, contiguous blocks of
ranks stand in for slices and the data axes split slice-major, as
`_build_hybrid` groups them.  Shardings are DTensor placements, one a
mesh dimension.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AXES = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape.  -1 on at most one axis means "all
    remaining devices".

    ``slices > 1`` builds a HYBRID multi-slice mesh: ranks are grouped
    into `slices` contiguous blocks, and the slow hops between blocks
    are confined to the data axes — the `dp` axis is split slice-major
    first, overflowing into `fsdp` only when dp alone cannot cover the
    slice count; tp/sp/ep/pp always stay inside one block.
    """

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    slices: int = 1

    def sizes(self) -> Dict[str, int]:
        return {
            "dp": self.dp,
            "fsdp": self.fsdp,
            "pp": self.pp,
            "ep": self.ep,
            "sp": self.sp,
            "tp": self.tp,
        }

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh {sizes} needs {fixed} devices, have {n_devices}"
                )
        return MeshSpec(
            **{k: sizes[k] for k in ("dp", "fsdp", "tp", "sp", "ep", "pp")},
            slices=self.slices,
        )

    def fit_to(self, n_devices: int) -> "MeshSpec":
        """Elastic re-fit: the widest spec for `n_devices` that keeps
        every MODEL axis (tp/sp/ep/pp) intact and shrinks only the data
        axes — dp first (pure replication, cheapest to lose), then fsdp.
        Wildcards (-1) resolve against `n_devices` as in `resolve`.
        Raises when the model axes alone need more devices than
        remain."""
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        sizes = self.sizes()
        if any(v == -1 for v in sizes.values()):
            return self.resolve(n_devices)
        model = self.tp * self.sp * self.ep * self.pp
        if model > n_devices or n_devices % model != 0:
            raise ValueError(
                f"model axes tp*sp*ep*pp={model} cannot fit {n_devices} "
                f"device(s) without resharding a model dimension"
            )
        data = n_devices // model
        # shrink dp (pure replication) before fsdp: fsdp = the largest
        # divisor of the remaining data extent that does not exceed the
        # requested fsdp; dp covers the rest
        fsdp = 1
        for cand in range(min(self.fsdp, data), 0, -1):
            if data % cand == 0:
                fsdp = cand
                break
        dp = data // fsdp
        fitted = MeshSpec(dp=dp, fsdp=fsdp, tp=self.tp, sp=self.sp,
                          ep=self.ep, pp=self.pp, slices=self.slices)
        if fitted.slices > 1:
            try:
                fitted.dcn_split()
            except ValueError:
                # the surviving data extent no longer factors across
                # the slice count: the re-formed mesh is single-slice
                fitted = MeshSpec(dp=dp, fsdp=fsdp, tp=self.tp,
                                  sp=self.sp, ep=self.ep, pp=self.pp)
        return fitted

    def dcn_split(self) -> Tuple[int, int]:
        """(dcn_dp, dcn_fsdp): how the slice count factors across the
        data axes.  dp is split first; fsdp covers the remainder."""
        s = self.slices
        dcn_dp = math.gcd(self.dp, s)
        s //= dcn_dp
        dcn_fsdp = math.gcd(self.fsdp, s)
        s //= dcn_fsdp
        if s != 1:
            raise ValueError(
                f"slices={self.slices} does not divide dp*fsdp="
                f"{self.dp * self.fsdp} (tp/sp/ep/pp must stay inside "
                f"one ICI slice)"
            )
        return dcn_dp, dcn_fsdp

    def rank_array(self, ranks: Sequence[int]) -> np.ndarray:
        """The ranks laid out in the mesh's shape (AXES order): where
        the reference places device i, this places ranks[i]."""
        ranks = list(ranks)
        spec = self.resolve(len(ranks))
        shape = tuple(spec.sizes()[a] for a in AXES)
        if spec.slices <= 1:
            return np.array(ranks).reshape(shape)
        n = len(ranks)
        if n % spec.slices != 0:
            raise ValueError(
                f"{n} devices not divisible by slices={spec.slices}"
            )
        dcn_dp, dcn_fsdp = spec.dcn_split()
        ici = dict(spec.sizes())
        ici["dp"] //= dcn_dp
        ici["fsdp"] //= dcn_fsdp
        ici_shape = tuple(ici[a] for a in AXES)
        groups = spec.slice_device_groups(ranks)
        arrs = [np.array(g).reshape(ici_shape) for g in groups]
        # (dcn_dp, dcn_fsdp, ici_dp, ici_fsdp, pp, ep, sp, tp) ->
        # interleave so dp = dcn-major x ici, fsdp likewise
        stack = np.stack(arrs).reshape(dcn_dp, dcn_fsdp, *ici_shape)
        t = stack.transpose(0, 2, 1, 3, 4, 5, 6, 7)
        return t.reshape(shape)

    def build(self, devices: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda"):
        """A `DeviceMesh` over the world's ranks (or the ranks given),
        dimensions named AXES.  Every rank of the world calls it, as
        `DeviceMesh` requires.  `device_type` is "cuda" unless the
        caller asks for "cpu"."""
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        if devices is None:
            devices = range(_world_size())
        arr = self.rank_array(devices)
        return DeviceMesh(device_type, torch.from_numpy(arr.copy()),
                          mesh_dim_names=AXES)

    def slice_device_groups(self, devices: Optional[Sequence] = None) -> List[List]:
        """Per-slice rank (or device) lists — the grouping the runtime
        placement layer must reproduce (one STRICT_PACK placement group
        per group) so the mesh and runtime PGs agree.  Uses the items'
        `slice_index` when every one has it; contiguous blocks
        otherwise (ranks carry none)."""
        devices = list(devices if devices is not None
                       else range(_world_size()))
        by_slice: Dict[int, List] = {}
        if all(getattr(d, "slice_index", None) is not None for d in devices):
            for d in devices:
                by_slice.setdefault(d.slice_index, []).append(d)
            if len(by_slice) != self.slices:
                raise ValueError(
                    f"devices span {len(by_slice)} physical slices but "
                    f"spec.slices={self.slices}"
                )
            return [by_slice[k] for k in sorted(by_slice)]
        per = len(devices) // self.slices
        return [
            devices[i * per : (i + 1) * per] for i in range(self.slices)
        ]

    @staticmethod
    def data_parallel(n: int = -1) -> "MeshSpec":
        return MeshSpec(dp=n)

    @staticmethod
    def fsdp_only(n: int = -1) -> "MeshSpec":
        return MeshSpec(fsdp=n)


def dtensor():
    """`torch.distributed.tensor` (`._tensor` before torch 2.4)."""
    try:
        from torch.distributed import tensor
    except ImportError:  # pragma: no cover - older torch
        from torch.distributed import _tensor as tensor
    return tensor


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh spans a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


# ----------------------------------------------------------------------
# common shardings over a mesh (DTensor placements, one a mesh dim)
# ----------------------------------------------------------------------
def batch_axes() -> Tuple[str, ...]:
    """Axes over which the global batch is split."""
    return ("dp", "fsdp")


def axis_size(mesh, name: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(name)))


def placements(mesh, dims: Sequence) -> tuple:
    """Placements for a tensor whose dim i is split over the mesh axes
    `dims[i]` (an axis name, a tuple of names in AXES order, or None):
    `Shard(i)` on those mesh dims, `Replicate()` on the rest.  The
    counterpart of `NamedSharding(mesh, PartitionSpec(*dims))`."""
    Replicate, Shard = dtensor().Replicate, dtensor().Shard
    names = list(mesh.mesh_dim_names) if mesh is not None else list(AXES)
    out = [Replicate() for _ in names]
    used = set()
    for i, ax in enumerate(dims):
        group = () if ax is None else (ax,) if isinstance(ax, str) else ax
        pos = [names.index(a) for a in group]
        if pos != sorted(pos):
            raise ValueError(
                f"dim {i} splits over {group}: a DTensor splits one dim "
                f"over mesh axes in mesh order ({names})")
        for a, p in zip(group, pos):
            if a in used:
                raise ValueError(f"mesh axis {a!r} splits two dims: {dims}")
            used.add(a)
            out[p] = Shard(i)
    return tuple(out)


def compute_mesh(mesh):
    """The mesh a training step's DTensors live on: `mesh`'s dims of
    size > 1, by name and in its order (its first dim when all have size
    1).  DTensor's sharding propagation enumerates each op's strategies
    over every mesh dim, size-1 dims included, so on the six-dim mesh of
    `MeshSpec.build` a sharded forward's first ops take minutes; the
    submesh holds the same shards on the same ranks.  A mesh with no
    size-1 dim comes back as it is.  Every rank calls this together, as
    slicing a mesh may create its groups."""
    names = list(mesh.mesh_dim_names)
    keep = tuple(n for i, n in enumerate(names) if mesh.size(i) > 1)
    keep = keep or (names[0],)
    return mesh if keep == tuple(names) else mesh[keep]


def onto_compute_mesh(mesh, places: Sequence) -> tuple:
    """(`compute_mesh(mesh)`, `places` over it): placements given over
    `mesh`'s dims (as `placements` spells them), kept for the dims the
    compute mesh keeps, by name."""
    sub = compute_mesh(mesh)
    if sub is mesh:
        return mesh, tuple(places)
    names = list(mesh.mesh_dim_names)
    return sub, tuple(places[names.index(n)] for n in sub.mesh_dim_names)


def distribute(x, mesh, places: Sequence):
    """`x` (the same whole tensor on every rank) as a DTensor on
    `compute_mesh(mesh)`, split by `places` (over `mesh`'s dims): each
    rank cuts its own block, and nothing crosses the group."""
    import inspect

    sub, places = onto_compute_mesh(mesh, places)
    fn = dtensor().distribute_tensor
    kw = ({"src_data_rank": None}
          if "src_data_rank" in inspect.signature(fn).parameters else {})
    return fn(x, sub, list(places), **kw)


def data_sharding(mesh, *trailing) -> tuple:
    """Batch-dim sharded over (dp, fsdp); trailing dims as given."""
    return placements(mesh, (batch_axes(), *trailing))


def replicated(mesh) -> tuple:
    return placements(mesh, ())


def local_batch_size(mesh, global_batch: int) -> int:
    n = axis_size(mesh, "dp") * axis_size(mesh, "fsdp")
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n


def mesh_from_devices(n: Optional[int] = None, *, device_type: str = "cuda",
                      **axis_sizes):
    ranks = list(range(_world_size()))[: n or _world_size()]
    return MeshSpec(**axis_sizes).build(ranks, device_type=device_type)
