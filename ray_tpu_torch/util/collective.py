"""ray_tpu_torch.util.collective — the reference's `ray.util.collective`
surface (`util/collective/collective.py:120,151,258-615`), re-exported
from the parallel layer where the implementation lives (SURVEY §5.8:
in-program `jax.lax` collectives are the TPU fast path; the host tier
rides the framework's own object plane instead of NCCL/Gloo).
"""

from ray_tpu_torch.parallel.collectives import (
    CollectiveGroup,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_group,
    init_collective_group,
    recv,
    reducescatter,
    send,
)

__all__ = [
    "CollectiveGroup",
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "destroy_collective_group",
    "get_group",
    "init_collective_group",
    "recv",
    "reducescatter",
    "send",
]
