"""Model families, as plain functions over dicts of tensors.

- gpt2: pretraining flagship
- llama: fine-tune/serving flagship with LoRA and KV-cached decoding
- mixtral: sparse-MoE family exercising expert parallelism over the
  `ep` mesh axis
"""

from ray_tpu_torch.models import gpt2, llama, mixtral

__all__ = ["gpt2", "llama", "mixtral"]
