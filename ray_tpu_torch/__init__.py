"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The package mirrors `ray_tpu`'s layout module by module (`models/`,
`ops/`, `parallel/`, `serve/`, `examples/`) and keeps the JAX
package's function names, `(cfg, params, ...)` signatures and param
layouts (stacked `[L, ...]` blocks, `[in, out]` weights), so each
port sits next to its reference.  It imports `torch` and numpy only:
never JAX, and nothing of `ray_tpu`.

Entry points run on the card: `device=None` resolves to CUDA and
raises when no card is present.  Callers that want the CPU (the
parity tests) say so with `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(
        device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` -> the current CUDA device, raising when there is no card;
    an explicit device is honoured, and an explicit CUDA device without
    a card raises too.  Never falls back to the CPU silently.  CUDA
    devices come back with their index (`cuda:0`), as tensors report
    theirs, so devices compare equal."""
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
