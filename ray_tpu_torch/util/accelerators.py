"""User-facing accelerator helpers (reference: `python/ray/util/accelerators/`).

The JAX package's module of this name answers for a TPU slice; on a GPU
host the same four names answer for the node's cards.  Call them from
inside tasks and actors, e.g.::

    @rt.remote(num_gpus=1)
    def which_card():
        return rt.util.accelerators.get_current_process_visible_chip_ids()

A GPU node belongs to no pod or slice: the node daemon registers no
slice or gang resource, and a worker process is told no gang label
(`core/accelerators.py` says why), so the two pod helpers return what
the reference returns off a TPU host, `None`.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ray_tpu_torch.core import accelerators as _core


def get_current_pod_name() -> Optional[str]:
    """Name of the pod this node belongs to: always `None` on a GPU
    host, which is in no slice."""
    return None


def get_current_pod_worker_count() -> Optional[int]:
    """Number of member hosts of this node's pod: always `None` on a
    GPU host, which is in no slice."""
    return None


def get_num_tpu_chips_on_node() -> int:
    """The node's card count: `RTT_GPUS` when set, else NVML's count
    capped by this process's `CUDA_VISIBLE_DEVICES` (0 off a GPU host).
    The reference's name is kept so code written against it runs
    here."""
    return _core.detect_num_chips()


def get_current_process_visible_chip_ids() -> Optional[List[str]]:
    """Card ids this worker process was granted at lease time (its
    `CUDA_VISIBLE_DEVICES`, split), or None when unrestricted (every
    card of the host visible)."""
    raw = os.environ.get(_core.VISIBLE_CHIPS_ENV)
    if raw is None:
        return None
    return [c for c in raw.split(",") if c]
