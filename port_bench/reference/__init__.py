"""Plain PyTorch references, in float32 with TF32 off, written from the
published equations.  They import nothing of the program and take only
inputs the benchmark made (weights from the seed, prompts, batches,
and, to judge them, the program's outputs)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the body (matmul and cuDNN), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
