"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The package mirrors `ray_tpu`'s layout module by module: the runtime
(`core/`, `shm/`, `metrics/`, `util/`: tasks, actors, objects), the
serve plane (`serve/`), the operations plane (`job/`, `workflow/`,
`dashboard/`, `autoscaler/`, `util/state/`), and the compute half (`models/`, `ops/`,
`parallel/`, `serve/llm_engine.py`, `examples/`).  It keeps the JAX
package's function names, `(cfg, params, ...)` signatures and param
layouts (stacked `[L, ...]` blocks, `[in, out]` weights), so each port
sits next to its reference.  It imports `torch` and numpy only: never
JAX, and nothing of `ray_tpu`.

The runtime imports no torch: node daemons and workers pay for it only
when the code they run computes.  So this module imports torch only
inside `resolve_device`.

Compute entry points run on the card: `device=None` resolves to CUDA
and raises when no card is present.  Callers that want the CPU (the
parity tests) say so with `device="cpu"`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch.api import (
    ActorClass,
    ActorHandle,
    ObjectRefGenerator,
    RemoteFunction,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    is_started,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.object_ref import ObjectRef

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"


def timeline(filename=None, trace_id=None):
    """Chrome-tracing dump of recent task events merged with the
    cluster-collected trace spans (reference: `ray.timeline()`)."""
    from ray_tpu_torch.util.state import timeline as _tl

    return _tl(filename, trace_id=trace_id)


def slo_status():
    """Per-deployment serve SLO burn rates ({app: {deployment: row}});
    see `ray_tpu_torch.serve.slo`.  Requires a running serve
    controller."""
    from ray_tpu_torch.serve.api import slo_status as _slo

    return _slo()


def resolve_device(
        device: Optional[Union[str, "torch.device"]] = None
) -> "torch.device":
    """`None` -> the current CUDA device, raising when there is no card;
    an explicit device is honoured, and an explicit CUDA device without
    a card raises too.  Never falls back to the CPU silently.  CUDA
    devices come back with their index (`cuda:0`), as tensors report
    theirs, so devices compare equal."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "init",
    "is_initialized",
    "is_started",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "resolve_device",
    "shutdown",
    "slo_status",
    "timeline",
    "wait",
]
