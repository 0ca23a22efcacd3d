"""Sharded (multi-process) checkpointing with reshard-on-restore.

The port of the JAX package's `train/sharded_checkpoint.py`, in its
on-disk format, so a directory either package writes (f32 leaves) loads
in the other:

- **save**: every rank writes ONLY its local shards of each DTensor leaf
  (no gather, no cross-process traffic) into its own piece file
  (`pieces_r{rank:05d}.npz` and `.json`: each piece's global `start`,
  `shape` and `crc32`), a replicated shard written once (by the rank at
  coordinate 0 of every mesh dim that does not split it).  Plain tensors
  are pieces of rank 0; other leaves (step counters, scalars, numpy
  arrays) go into rank 0's pickled aux file.  Rank 0 writes the manifest
  with `num_processes`.  Leaf keys are spelled as
  `jax.tree_util.keystr` spells them (`['blocks']['wq']`, `[0]`).
- **restore**: each target DTensor's local block is assembled from the
  saved pieces that overlap it, so a checkpoint written under mesh A
  loads under any mesh B with the same global shapes; stale rank files
  (beyond the manifest's `num_processes`) are ignored, missing ones and
  corrupted pieces raise.

bf16: numpy has no bf16, so the port writes a bf16 piece as its raw 16
bits (uint16) and reads a bf16 piece of either package (the JAX
package's ml_dtypes arrays load as 2-byte records) by viewing those bits
again; the JAX package would read the port's bf16 bits as integers, so
only f32 (and other numpy) leaves cross between the two packages.
"""

from __future__ import annotations

import json
import os
import pickle
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.parallel.sharding import tree_paths, tree_rebuild

_MANIFEST = "sharded_manifest.json"
_AUX = "sharded_aux.pkl"


def _key_str(k) -> str:
    return f"[{k!r}]"


def _leaf_key(path) -> str:
    return "".join(_key_str(k) for k in path)


def _is_tensor(x) -> bool:
    import torch

    return isinstance(x, torch.Tensor)


def _is_dtensor(x) -> bool:
    from ray_tpu_torch.parallel.mesh import dtensor

    return isinstance(x, dtensor().DTensor)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t) -> np.ndarray:
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str):
    import torch

    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _np_dtype(dtype_name: str):
    # the port's bf16 pieces (and the JAX package's, read as 2-byte
    # records) assemble as their raw bits
    return np.dtype(np.uint16) if dtype_name == "bfloat16" else np.dtype(
        dtype_name)


def _shard_region(shape, mesh, placements, coord) -> Optional[Tuple]:
    """(start, length) per dim of the block at mesh coordinate `coord`,
    splitting as DTensor does (`torch.chunk` sizes, nested in mesh-dim
    order); None when this coordinate holds a replica other than the
    first of a dim that does not split the tensor."""
    start = [0] * len(shape)
    length = list(shape)
    for i, pl in enumerate(placements):
        c = coord[i]
        if not pl.is_shard():
            if c != 0:
                return None
            continue
        d = pl.dim
        n = mesh.size(i)
        size = -(-length[d] // n)
        lo = min(c * size, length[d])
        start[d] += lo
        length[d] = max(0, min(size, length[d] - lo))
    return start, length


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_sharded(tree: Any, dir_: str, *, rank: Optional[int] = None,
                 num_processes: Optional[int] = None) -> None:
    """Write this rank's shards of every tensor leaf in `tree` under
    `dir_`.  `rank` / `num_processes` default to the process group's
    (0 / 1 without one).  Every participating rank must call this (each
    writes distinct files; no barrier is taken — the caller's
    report/collect cycle is the barrier)."""
    os.makedirs(dir_, exist_ok=True)
    pg_rank, pg_world = _world()
    pid = pg_rank if rank is None else rank
    world = pg_world if num_processes is None else num_processes
    pieces: Dict[str, np.ndarray] = {}
    index: List[Dict[str, Any]] = []
    manifest: Dict[str, Any] = {
        "version": 1, "leaves": {}, "num_processes": world,
    }
    aux: Dict[str, Any] = {}
    n = 0
    for path, leaf in tree_paths(tree):
        key = _leaf_key(path)
        if not _is_tensor(leaf):
            aux[key] = leaf
            continue
        manifest["leaves"][key] = {
            "shape": list(leaf.shape), "dtype": _dtype_name(leaf),
        }
        if _is_dtensor(leaf):
            mesh = leaf.device_mesh
            region = _shard_region(tuple(leaf.shape), mesh,
                                   leaf.placements, mesh.get_coordinate())
            if region is None:
                continue  # replicated copy: another rank writes it
            start = region[0]
            data = _to_numpy(leaf.to_local())
            assert list(data.shape) == region[1], (key, data.shape, region)
        elif pid == 0:
            start = [0] * leaf.dim()
            data = _to_numpy(leaf)
        else:
            continue
        piece_key = f"p{n}"
        n += 1
        pieces[piece_key] = data
        index.append({
            "key": piece_key,
            "leaf": key,
            "start": start,
            "shape": list(data.shape),
            # per-piece checksum over the raw buffer: restore verifies
            # it so a corrupted piece fails loud
            "crc32": zlib.crc32(np.ascontiguousarray(data).tobytes()),
        })
    if pieces:
        np.savez(os.path.join(dir_, f"pieces_r{pid:05d}.npz"), **pieces)
    with open(os.path.join(dir_, f"pieces_r{pid:05d}.json"), "w") as f:
        json.dump(index, f)
    if pid == 0:
        with open(os.path.join(dir_, _AUX), "wb") as f:
            pickle.dump(aux, f)
        with open(os.path.join(dir_, _MANIFEST), "w") as f:
            json.dump(manifest, f)


def _overlap(dst_sl: Tuple[slice, ...], start: List[int],
             shape: List[int]):
    """Intersection of a piece [start, start+shape) with a requested
    global region; returns (dst_local, src_local) slice tuples or None."""
    dst_local, src_local = [], []
    for d, (sl, p0, plen) in enumerate(zip(dst_sl, start, shape)):
        r0 = sl.start or 0
        r1 = sl.stop
        lo = max(r0, p0)
        hi = min(r1, p0 + plen)
        if lo >= hi:
            return None
        dst_local.append(slice(lo - r0, hi - r0))
        src_local.append(slice(lo - p0, hi - p0))
    return tuple(dst_local), tuple(src_local)


class _PieceReader:
    def __init__(self, dir_: str, num_processes: Optional[int] = None):
        self._dir = dir_
        self._npz: Dict[str, Any] = {}
        self._verified: set = set()
        # leaf key -> [(rank_file, piece_key, start, shape, crc32|None)]
        self.by_leaf: Dict[str, List] = {}
        self.ranks_seen: set = set()
        for fn in sorted(os.listdir(dir_)):
            if fn.startswith("pieces_r"):
                rank = int(fn[len("pieces_r"):].split(".")[0])
                if num_processes is not None and rank >= num_processes:
                    continue  # stale file from an earlier larger save
            if fn.startswith("pieces_r") and fn.endswith(".json"):
                self.ranks_seen.add(rank)
                with open(os.path.join(dir_, fn)) as f:
                    for ent in json.load(f):
                        self.by_leaf.setdefault(ent["leaf"], []).append(
                            (fn[:-5] + ".npz", ent["key"],
                             ent["start"], ent["shape"],
                             ent.get("crc32"))
                        )

    def read(self, npz_name: str, key: str,
             crc: Optional[int] = None) -> np.ndarray:
        z = self._npz.get(npz_name)
        if z is None:
            z = self._npz[npz_name] = np.load(
                os.path.join(self._dir, npz_name)
            )
        arr = z[key]
        if crc is not None and (npz_name, key) not in self._verified:
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != crc:
                raise ValueError(
                    f"checkpoint piece {npz_name}:{key} is corrupted "
                    f"(crc32 {got:#x} != recorded {crc:#x})"
                )
            self._verified.add((npz_name, key))
        return arr

    def assemble(self, leaf: str, region: Tuple[slice, ...],
                 shape, dtype) -> np.ndarray:
        """Build the requested global region of `leaf` from overlapping
        pieces (the reshard-on-restore core: pieces written by any
        N-process layout assemble into any M-process target layout)."""
        full = tuple(
            slice(sl.start or 0, sl.stop if sl.stop is not None else dim)
            for sl, dim in zip(region, shape)
        )
        out_shape = tuple(sl.stop - sl.start for sl in full)
        out = np.empty(out_shape, dtype=dtype)
        covered = 0
        for npz_name, key, start, pshape, crc in self.by_leaf.get(leaf, ()):
            ov = _overlap(full, start, pshape)
            if ov is None:
                continue
            dst, src = ov
            out[dst] = self.read(npz_name, key, crc)[src]
            covered += int(np.prod([s.stop - s.start for s in dst]))
        want = int(np.prod(out_shape))
        if covered < want:
            raise ValueError(
                f"checkpoint pieces cover {covered}/{want} elements of "
                f"{leaf}{full} — incomplete checkpoint directory?"
            )
        return out


def load_sharded(dir_: str, target: Any) -> Any:
    """Restore a tree saved by `save_sharded` (of either package) onto
    `target`'s layout.

    `target` is a tree matching the saved structure: a DTensor leaf
    gets this rank's block of its placements (resharding between save
    and load meshes is implicit), a plain tensor leaf the whole array on
    its device, any other leaf the saved aux value (or the whole array
    on the CPU when the leaf was saved as an array).  Each rank reads
    only the pieces overlapping its blocks."""
    import torch

    if not os.path.exists(os.path.join(dir_, _MANIFEST)):
        raise FileNotFoundError(f"no sharded checkpoint in {dir_}")
    with open(os.path.join(dir_, _MANIFEST)) as f:
        manifest = json.load(f)
    aux: Dict[str, Any] = {}
    if os.path.exists(os.path.join(dir_, _AUX)):
        from ray_tpu_torch.core import serialization

        with open(os.path.join(dir_, _AUX), "rb") as f:
            aux = serialization.loads(f.read())
    reader = _PieceReader(dir_, manifest.get("num_processes"))
    want_ranks = manifest.get("num_processes")
    if want_ranks is not None:
        missing = set(range(int(want_ranks))) - reader.ranks_seen
        if missing:
            # the save was made by N writers but the merged directory
            # lost some of them: refuse up front rather than failing on
            # partial coverage mid-assembly
            raise ValueError(
                f"incomplete sharded checkpoint {dir_}: missing piece "
                f"files for rank(s) {sorted(missing)} of {want_ranks}"
            )

    out = []
    for path, leaf in tree_paths(target):
        key = _leaf_key(path)
        meta = manifest["leaves"].get(key)
        if meta is None:
            if key in aux:
                out.append(aux[key])
                continue
            raise KeyError(f"{key} not present in checkpoint {dir_}")
        shape = tuple(meta["shape"])
        name = meta["dtype"]
        if tuple(getattr(leaf, "shape", shape)) != shape:
            raise ValueError(
                f"{key}: target shape {tuple(leaf.shape)} != saved {shape}"
            )
        if _is_dtensor(leaf):
            mesh = leaf.device_mesh
            # every replica reads the block (the first replica's region)
            coord = [c if p.is_shard() else 0 for c, p in
                     zip(mesh.get_coordinate(), leaf.placements)]
            start, length = _shard_region(shape, mesh, leaf.placements,
                                          coord)
            region = tuple(slice(s, s + n) for s, n in zip(start, length))
            local = _from_numpy(reader.assemble(key, region, shape,
                                                _np_dtype(name)), name)
            from ray_tpu_torch.parallel.mesh import dtensor

            out.append(dtensor().DTensor.from_local(
                local.to(leaf.to_local().device), mesh,
                list(leaf.placements), run_check=False,
                shape=torch.Size(shape), stride=leaf.stride()))
            continue
        full = _from_numpy(reader.assemble(
            key, tuple(slice(0, s) for s in shape), shape, _np_dtype(name)),
            name)
        out.append(full.to(leaf.device) if _is_tensor(leaf) else full)
    return tree_rebuild(target, out)
