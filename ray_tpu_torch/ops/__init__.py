"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers."""

from ray_tpu_torch.ops.attention import flash_attention

__all__ = ["flash_attention"]
