"""Torch backend + TorchTrainer.

Reference: `python/ray/train/torch/` — `TorchConfig`
(`train/torch/config.py:66`: TCP-store rendezvous +
`torch.distributed.init_process_group`), `TorchTrainer`
(`torch_trainer.py`), and the `prepare_model`/`prepare_data_loader`
loop utilities (`train_loop_utils.py`).

Rank 0 opens the TCP store, every worker joins the process group (NCCL
when the workers see a card, gloo otherwise, unless `backend` says),
and the training loop uses standard torch DDP.  The flagship is
`CudaTrainer`; this backend exists so reference TorchTrainer code ports
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig, _coordinator_addr
from ray_tpu_torch.train.trainer import DataParallelTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class TorchConfig(BackendConfig):
    """Reference: `train/torch/config.py` TorchConfig.  `backend` None
    takes "nccl" on a worker that sees a card and "gloo" otherwise."""

    backend: Optional[str] = None
    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return _TorchBackend


def _init_torch_process_group(backend: str, init_method: str,
                              world_size: int, rank: int, timeout_s: float):
    import datetime

    import torch
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    # interface selection is the deployment's call (set
    # GLOO_SOCKET_IFNAME in runtime_env/env for multi-NIC hosts)
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _destroy_torch_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    """Reference: `train/torch/config.py:153` _TorchBackend."""

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config: TorchConfig):
        n = len(worker_group)
        if n <= 1:
            return
        import ray_tpu_torch as rt

        host, port = worker_group.execute_single(0, _coordinator_addr)
        init_method = f"tcp://{host}:{port}"
        # rank 0 hosts the TCP store: start it first, then the rest join
        rank0 = worker_group.workers[0].execute.remote(
            _init_torch_process_group, backend_config.backend, init_method,
            n, 0, backend_config.init_timeout_s,
        )
        rest = [
            w.execute.remote(
                _init_torch_process_group, backend_config.backend,
                init_method, n, i, backend_config.init_timeout_s,
            )
            for i, w in enumerate(worker_group.workers)
            if i > 0
        ]
        rt.get([rank0, *rest])

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: TorchConfig):
        try:
            worker_group.execute(_destroy_torch_process_group)
        except Exception:
            pass


class TorchTrainer(DataParallelTrainer):
    """Reference: `train/torch/torch_trainer.py` — the same
    train_loop_per_worker contract as the reference's TorchTrainer;
    inside the loop use `prepare_model` for DDP and the standard
    `train.report` session API."""

    def __init__(self, train_loop_per_worker, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        kwargs.setdefault("backend_config", torch_config or TorchConfig())
        super().__init__(train_loop_per_worker, **kwargs)


def prepare_model(model):
    """Wrap in DistributedDataParallel when a process group is up
    (reference: `train_loop_utils.py` prepare_model)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across workers with DistributedSampler
    (reference: `train_loop_utils.py` prepare_data_loader).  The user's
    loader configuration is preserved; only the sampler is swapped (a
    batch_sampler-configured loader is rejected — pass batch_size
    instead).  Call `loader.sampler.set_epoch(e)` per epoch for fresh
    shuffles, as with any DistributedSampler."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return loader
    if loader.batch_size is None:
        raise ValueError(
            "prepare_data_loader cannot re-shard a batch_sampler-based "
            "DataLoader; construct it with batch_size instead"
        )
    sampler = DistributedSampler(loader.dataset)
    return DataLoader(
        loader.dataset,
        batch_size=loader.batch_size,
        sampler=sampler,
        num_workers=loader.num_workers,
        collate_fn=loader.collate_fn,
        drop_last=loader.drop_last,
        pin_memory=loader.pin_memory,
        timeout=loader.timeout,
        worker_init_fn=loader.worker_init_fn,
        generator=loader.generator,
        prefetch_factor=(loader.prefetch_factor
                         if loader.num_workers > 0 else None),
        persistent_workers=loader.persistent_workers,
    )
