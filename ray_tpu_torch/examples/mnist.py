"""Fashion-MNIST-shaped distributed training example.

Reference: BASELINE config #1 — `ray.train.torch.TorchTrainer` MNIST
fashion (2 CPU workers, DDP) — re-expressed as a CudaTrainer
data-parallel run: each worker trains the same torch MLP on its data
shard and gradients mean-allreduce across the worker group every step.

The dataset is a deterministic synthetic stand-in with Fashion-MNIST's
shape (784 features, 10 classes): a fixed random teacher network labels
random inputs, so accuracy is a real learnability signal without
downloading data (this image has zero egress).

The workers compute on `device`: the card unless the caller asks for
the CPU (`run(device="cpu")`, as the tests do).  On the card the two
workers share it, `GPU` 0.5 each, as the train plane's workers do, and
each reports its peak device memory.  Without a card the default
raises before anything starts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch import train
from ray_tpu_torch.train import CudaConfig, CudaTrainer, RunConfig, ScalingConfig


def make_dataset(n: int = 4096, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """[n, 784] float32 features, [n] int labels from a fixed teacher."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 784)).astype(np.float32)
    w1 = np.random.default_rng(1234).normal(size=(784, 32)).astype(np.float32)
    w2 = np.random.default_rng(5678).normal(size=(32, 10)).astype(np.float32)
    y = np.argmax(np.tanh(x @ w1) @ w2, axis=1).astype(np.int32)
    return x, y


def train_func(config: Dict[str, Any]):
    import math
    import os

    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models.bridge import tree_leaves
    from ray_tpu_torch.models.gpt2 import AdamW
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.train import cuda_utils

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    epochs = config.get("epochs", 4)
    batch_size = config.get("batch_size", 128)
    hidden = config.get("hidden", 128)
    lr = config.get("lr", 1e-3)
    device = resolve_device(os.environ.get("RTT_TRAIN_DEVICE", "cuda"))

    x, y = make_dataset(config.get("n", 4096))
    # contiguous per-rank shard (reference: DistributedSampler)
    shard = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    x, y = x[shard], y[shard]
    xs = torch.from_numpy(x).to(device)
    ys = torch.from_numpy(y).long().to(device)

    def init(gen):
        return {
            "w1": torch.randn((784, hidden), generator=gen) * 0.05,
            "b1": torch.zeros((hidden,)),
            "w2": torch.randn((hidden, 10), generator=gen) * 0.05,
            "b2": torch.zeros((10,)),
        }

    def logits_fn(p, xb):
        h = torch.tanh(xb @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def loss_fn(p, xb, yb):
        logp = torch.log_softmax(logits_fn(p, xb), dim=1)
        return -torch.mean(torch.gather(logp, 1, yb[:, None]))

    # same seed: replicas identical
    params = {k: v.to(device).requires_grad_(True)
              for k, v in init(torch.Generator().manual_seed(0)).items()}
    # optax.adam(lr): no clip, no weight decay
    opt = AdamW(lambda _count: lr, max_norm=math.inf, b1=0.9, b2=0.999,
                eps=1e-8, weight_decay=0.0)
    opt_state = opt.init(params)

    steps = max(1, len(x) // batch_size)
    for epoch in range(epochs):
        perm = np.random.default_rng(epoch).permutation(len(x))
        total_loss = 0.0
        for s in range(steps):
            idx = torch.from_numpy(perm[s * batch_size:(s + 1) * batch_size]
                                   ).to(device)
            loss = loss_fn(params, xs[idx], ys[idx])
            grads = dict(zip(sorted(params), torch.autograd.grad(
                loss, [params[k] for k in sorted(params)])))
            # DDP step: host-level mean-allreduce across workers
            grads = cuda_utils.sync_gradients(grads)
            opt_state, _ = opt.update(tree_leaves(grads), opt_state, params)
            total_loss += float(loss)
        with torch.no_grad():
            preds = logits_fn(params, xs).argmax(dim=1).cpu().numpy()
        acc = cuda_utils.world_mean(float((preds == y).mean()))
        metrics = {
            "loss": total_loss / steps,
            "accuracy": acc,
            "epoch": epoch,
        }
        if device.type == "cuda":
            # each worker's peak device memory, in rank order
            peak = torch.cuda.max_memory_allocated(device) / 1e9
            metrics["peak_mem_gb"] = [float(v[0]) for v in
                                      collectives.allgather(
                                          np.asarray([peak]), "train")]
        train.report(metrics)


def run(num_workers: int = 2, epochs: int = 4, storage_path: Optional[str] = None,
        device=None):
    from ray_tpu_torch import resolve_device

    device = resolve_device(device)
    # on the card the workers share it (`GPU` 0.5 each at 2 workers)
    per_worker = ({"GPU": 1.0 / num_workers, "CPU": 1}
                  if device.type == "cuda" else None)
    trainer = CudaTrainer(
        train_func,
        train_loop_config={"epochs": epochs},
        scaling_config=ScalingConfig(num_workers=num_workers,
                                     resources_per_worker=per_worker),
        cuda_config=CudaConfig(distributed_mode="collective",
                               device=device.type),
        run_config=RunConfig(name="mnist_fashion", storage_path=storage_path),
    )
    return trainer.fit()


if __name__ == "__main__":
    import ray_tpu_torch as rt

    rt.init(num_workers=3, num_cpus=8, ignore_reinit_error=True)
    result = run()
    print("final:", result.metrics)
    rt.shutdown()
