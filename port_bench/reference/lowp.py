"""The control's lower precision: every matrix product an fp8 serving
recipe would run in float8, computed so in plain PyTorch.  Operands
are rounded to e4m3 with a scale a row of the left operand and a column
of the right; products accumulate in f32."""

from __future__ import annotations

import torch

FP8_MAX = {torch.float8_e4m3fn: 448.0}


def round_fp8(x: torch.Tensor, dim: int,
              fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to `fmt` with one scale per slice along `dim`."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX[fmt] / amax
    return (x.detach() * scale).to(fmt).to(x.dtype) / scale


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [K, N] or [..., K, N] with both operands
    rounded to float8 (e4m3): a scale a row of `a`, a column of `b`."""
    return round_fp8(a, -1) @ round_fp8(b, -2)


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b
