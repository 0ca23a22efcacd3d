"""GPU accelerator detection and per-worker isolation.

The node daemon must know, without operator flags, how many GPUs it
has, and hand *disjoint* GPU subsets to concurrent workers on one host
(reference: Ray's `_private/accelerators/nvidia_gpu.py`).  The JAX
package's counterpart is all TPU (`/dev/accel*`, `TPU_VISIBLE_CHIPS`,
slice types, GCE metadata); slice and gang resources have no meaning on
a GPU host and have no counterpart here.

- detection never imports torch: the `RTT_GPUS` override, then the
  driver's own count through NVML (`libnvidia-ml.so.1` over ctypes, as
  `nvidia-smi` counts), then the `/dev/nvidia<N>` nodes where NVML is
  absent, capped by `CUDA_VISIBLE_DEVICES` when the daemon's own env
  restricts it.  Device nodes alone can overcount: a container that
  exposes one card may still hold another card's node beside it
  (`/dev/nvidia0` and `/dev/nvidia7`);
- the daemon assigns GPUs at *lease grant* time and pins them to the
  worker process for its lifetime through `CUDA_VISIBLE_DEVICES`, so
  two `num_gpus=1` actors on one 2-GPU host each see exactly one,
  different card (as index 0 of their own process).  A fractional grant
  (`num_gpus=0.5`) is pinned the same way to one card, shared only with
  other fractions: the JAX package's TPU fraction pins no chip, but a
  process that sees every card runs on `cuda:0`, whatever card its
  share was counted on.
"""

from __future__ import annotations

import ctypes
import glob
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# env override (tests / operators): forces the GPU count
NUM_CHIPS_ENV = "RTT_GPUS"
VISIBLE_CHIPS_ENV = "CUDA_VISIBLE_DEVICES"

_dev_node_re = re.compile(r"^/dev/nvidia\d+$")


def _parent_visible() -> Optional[List[str]]:
    """The daemon's own `CUDA_VISIBLE_DEVICES` entries, or None when it
    is unset (every card of the host is visible)."""
    raw = os.environ.get(VISIBLE_CHIPS_ENV)
    if raw is None:
        return None
    return [e.strip() for e in raw.split(",") if e.strip()]


def _nvml_count() -> Optional[int]:
    """The GPUs the NVIDIA driver exposes to this process, through NVML;
    None when the library is absent or fails to initialise."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    lib.nvmlInit_v2.restype = ctypes.c_int
    lib.nvmlInit_v2.argtypes = []
    lib.nvmlDeviceGetCount_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    lib.nvmlShutdown.restype = ctypes.c_int
    lib.nvmlShutdown.argtypes = []
    if lib.nvmlInit_v2() != 0:
        return None
    try:
        n = ctypes.c_uint(0)
        if lib.nvmlDeviceGetCount_v2(ctypes.byref(n)) != 0:
            return None
        return int(n.value)
    finally:
        lib.nvmlShutdown()


def detect_num_chips() -> int:
    """Count local GPUs: the `RTT_GPUS` override, else NVML's count,
    else the `/dev/nvidia<N>` nodes; never more than the daemon's
    `CUDA_VISIBLE_DEVICES` lets it see."""
    override = os.environ.get(NUM_CHIPS_ENV)
    if override:
        try:
            return max(0, int(override))
        except ValueError:
            logger.warning("bad %s=%r", NUM_CHIPS_ENV, override)
    n = _nvml_count()
    if n is None:
        n = len([p for p in glob.glob("/dev/nvidia*")
                 if _dev_node_re.match(p)])
    visible = _parent_visible()
    if visible is not None:
        n = min(n, len(visible))
    return n


def validate_chip_request(quantity: float) -> Optional[str]:
    """Whole-GPU requests must be integers; fractional shares below one
    GPU are allowed, as in Ray."""
    if quantity < 1:
        return None
    if quantity != int(quantity):
        return (
            f"num_gpus={quantity} is not a whole number of GPUs; "
            "use an integer or a fraction < 1"
        )
    return None


def chip_isolation_env(chip_ids: List[int],
                       total_chips: int) -> Dict[str, str]:
    """Env that restricts a worker process to the GPUs `chip_ids` (the
    daemon's indices, mapped through its own `CUDA_VISIBLE_DEVICES`
    when that is set).  Unlike the TPU counterpart, an all-GPU grant
    sets the list too: the worker then names its cards explicitly."""
    del total_chips  # every grant names its cards
    visible = _parent_visible()
    ids = [visible[c] if visible is not None and c < len(visible)
           else str(c) for c in chip_ids]
    return {VISIBLE_CHIPS_ENV: ",".join(ids)}


class ChipPool:
    """Daemon-side allocator mapping whole-GPU leases to disjoint GPU
    index sets, and fractional leases (0 < n < 1) to a share of one card
    that no whole-GPU lease holds, packed onto the card already most
    shared.  GPUs are pinned per worker process: once a worker has
    initialized CUDA against a subset, a different subset later would
    be silently ignored by the framework — so reuse prefers workers
    whose pinned set and share already match.
    """

    _EPS = 1e-9

    def __init__(self, num_chips: int):
        self.num_chips = num_chips
        self._free = set(range(num_chips))
        self._by_worker: Dict[str, Tuple[int, ...]] = {}
        self._share: Dict[str, float] = {}  # worker -> its fraction
        self._used: Dict[int, float] = {}  # shared card -> its fractions

    def assign(self, worker_id: str, n: float) -> Optional[Tuple[int, ...]]:
        held = self._by_worker.get(worker_id)
        if held is not None:
            return held if self.shape(worker_id) == n else None
        if 0 < n < 1:
            shared = [c for c, u in self._used.items()
                      if u + n <= 1 + self._EPS]
            if shared:
                card = max(shared, key=lambda c: (self._used[c], -c))
            elif self._free:
                card = min(self._free)
                self._free.discard(card)
            else:
                return None
            self._used[card] = self._used.get(card, 0.0) + n
            self._share[worker_id] = n
            self._by_worker[worker_id] = (card,)
            return (card,)
        n = int(n)
        if n > len(self._free):
            return None
        chips = tuple(sorted(self._free)[:n])
        self._free.difference_update(chips)
        self._by_worker[worker_id] = chips
        return chips

    def pinned(self, worker_id: str) -> Optional[Tuple[int, ...]]:
        return self._by_worker.get(worker_id)

    def shape(self, worker_id: str) -> Optional[float]:
        """The lease a pinned worker holds: its share of one card, else
        its card count; None when it is not pinned."""
        held = self._by_worker.get(worker_id)
        if held is None:
            return None
        return self._share.get(worker_id, len(held))

    def fits(self, n: float) -> bool:
        """Whether a worker not yet pinned could be given `n` now."""
        if 0 < n < 1:
            return bool(self._free) or any(
                u + n <= 1 + self._EPS for u in self._used.values())
        return n <= len(self._free)

    def release_worker(self, worker_id: str) -> None:
        chips = self._by_worker.pop(worker_id, None)
        share = self._share.pop(worker_id, None)
        if share is not None:
            left = self._used[chips[0]] - share
            if left > self._EPS:
                self._used[chips[0]] = left
            else:
                del self._used[chips[0]]
                self._free.add(chips[0])
        elif chips:
            self._free.update(chips)
