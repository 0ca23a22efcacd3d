"""Train-loop helpers for the CUDA trainer (the JAX package's
`train/jax_utils.py`).

Reference analog: `train/torch/train_loop_utils.py` (prepare_model /
prepare_data_loader wrap DDP).  Here the cross-worker primitive is
`sync_gradients`: one host-level allreduce of a gradient tree over the
worker collective group, for workers that each run their own model (one
a card, or several sharing one card).  Within one worker, parallelism
runs over its process group's mesh (`get_mesh`).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

# the last sync's phases in ms: device-to-host, allreduce, host-to-device
LAST_SYNC_MS: Dict[str, float] = {}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sync_gradients(grads: Any, group_name: str = "train"):
    """Mean-allreduce a gradient tree (tensors on the card or the CPU,
    in dicts, lists or tuples) across the worker group.

    The leaves are flattened into ONE f32 vector on the host, so one
    rendezvous round carries the whole gradient (the ring path of the
    object plane once it reaches `_RING_MIN_BYTES`); the result is cut
    back into each leaf on its own device in its own dtype (numpy has no
    bf16: f32 carries it on the wire).  No-op when no collective group
    exists (single-worker runs work unchanged).  The phases' times land
    in `LAST_SYNC_MS`."""
    import torch

    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.sharding import tree_paths, tree_rebuild

    try:
        group = collectives.get_group(group_name)
    except KeyError:
        return grads
    leaves = [leaf for _, leaf in tree_paths(grads)]
    devices = {t.device for t in leaves}
    t0 = time.perf_counter()
    flat = (torch.cat([t.detach().reshape(-1).float() for t in leaves])
            if leaves else torch.zeros(0))
    vec = flat.cpu().numpy()
    for d in devices:
        _sync(d)
    t1 = time.perf_counter()
    reduced = group.allreduce(vec, op="mean")
    t2 = time.perf_counter()
    out, off = [], 0
    host = torch.from_numpy(np.ascontiguousarray(reduced, np.float32))
    for t in leaves:
        n = t.numel()
        out.append(host[off:off + n].reshape(t.shape).to(
            device=t.device, dtype=t.dtype))
        off += n
    for d in devices:
        _sync(d)
    t3 = time.perf_counter()
    LAST_SYNC_MS.clear()
    LAST_SYNC_MS.update({"d2h": (t1 - t0) * 1e3, "allreduce":
                         (t2 - t1) * 1e3, "h2d": (t3 - t2) * 1e3})
    return tree_rebuild(grads, out)


def world_mean(value: float, group_name: str = "train") -> float:
    from ray_tpu_torch.parallel import collectives

    try:
        group = collectives.get_group(group_name)
    except KeyError:
        return float(value)
    return float(group.allreduce(np.asarray([value], np.float64), op="mean")[0])


def prepare_batch(batch, mesh=None, sharding=None, device=None):
    """A host batch (numpy or tensor) on the worker's device; with a
    mesh, a DTensor split per `sharding` (the mesh's `data_sharding`
    by default), on the mesh's `compute_mesh` where a sharded step's
    DTensors live — every rank passes the same global batch."""
    import os

    import torch

    from ray_tpu_torch import resolve_device

    if device is None:
        device = (mesh.device_type if mesh is not None
                  else os.environ.get("RTT_TRAIN_DEVICE", "cuda"))
    x = torch.as_tensor(batch).to(resolve_device(device))
    if sharding is None and mesh is not None:
        from ray_tpu_torch.parallel import data_sharding

        sharding = data_sharding(mesh)
    if sharding is None:
        return x
    from ray_tpu_torch.parallel.mesh import distribute

    return distribute(x, mesh, sharding)
