"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers."""

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.xent import fused_cross_entropy
from ray_tpu_torch.ops.xent_pallas import pallas_cross_entropy

__all__ = [
    "flash_attention",
    "fused_cross_entropy",
    "pallas_cross_entropy",
]
