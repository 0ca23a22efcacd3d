"""Backend hooks: framework-specific worker-group setup.

Reference: `train/backend.py:32` Backend(on_start/on_training_start/
on_shutdown) + per-framework configs (`train/torch/config.py:66`).
The CUDA backend (the JAX package's `JaxBackend`) wires workers together
with either host-level collective groups (default: rides the
framework's own object plane) or `torch.distributed.init_process_group`
(NCCL on the card, gloo on the CPU; the counterpart of
`jax.distributed.initialize`).
"""

from __future__ import annotations

import logging
import socket
from dataclasses import dataclass, field
from typing import Dict

from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Subclass and override hooks; all run driver-side, issuing
    `worker_group.execute` RPCs for per-worker setup."""

    def on_start(self, worker_group: WorkerGroup, backend_config: BackendConfig):
        pass

    def on_training_start(
        self, worker_group: WorkerGroup, backend_config: BackendConfig
    ):
        pass

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: BackendConfig):
        pass


# ---------------------------------------------------------------------
# CUDA backend
# ---------------------------------------------------------------------
@dataclass
class CudaConfig(BackendConfig):
    """distributed_mode:
    - "collective": workers sync grads via host-level collective groups
      (`ray_tpu_torch.parallel.collectives`); each worker runs its own
      model on its visible card.  Right for one-process-per-card data
      parallelism, and for workers that share one card.
    - "torch_distributed": `torch.distributed.init_process_group` on
      every worker (NCCL when they compute on the card, gloo on the
      CPU), rendezvous at worker 0's address; `get_mesh()` then builds
      a `DeviceMesh` over the group.  The counterpart of the JAX
      package's "jax_distributed".
    - "none": no cross-worker setup.

    `device` is where the workers compute: "cuda" unless the caller
    asks for "cpu"."""

    distributed_mode: str = "collective"
    device: str = "cuda"
    env_vars: Dict[str, str] = field(default_factory=dict)
    collective_group_name: str = "train"

    @property
    def backend_cls(self):
        return CudaBackend

    @property
    def process_group_backend(self) -> str:
        return "nccl" if self.device == "cuda" else "gloo"


# how long a rank waits for the others to join the process group
_INIT_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _setup_worker_env(env_vars: Dict[str, str], device: str):
    import os

    os.environ.update(env_vars)
    os.environ["RTT_TRAIN_DEVICE"] = device


def _init_collective(world_size: int, rank: int, group_name: str):
    from ray_tpu_torch.parallel import collectives

    collectives.init_collective_group(world_size, rank, group_name)


def _init_torch_distributed(init_method: str, num_processes: int,
                            process_id: int, backend: str):
    import datetime

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        # NCCL binds each rank to its card before the first collective
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S),
    )


def _destroy_torch_distributed():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class CudaBackend(Backend):
    def on_start(self, worker_group: WorkerGroup, backend_config: CudaConfig):
        worker_group.execute(
            _setup_worker_env, backend_config.env_vars, backend_config.device
        )

    def on_training_start(
        self, worker_group: WorkerGroup, backend_config: CudaConfig
    ):
        n = len(worker_group)
        mode = backend_config.distributed_mode
        if mode == "none":
            return
        if mode == "collective":
            if n <= 1:
                return
            import ray_tpu_torch as rt

            # rank 0 first: it hosts the rendezvous actor others look up
            rt.get(worker_group.workers[0].execute.remote(
                _init_collective, n, 0, backend_config.collective_group_name
            ))
            rt.get([
                w.execute.remote(
                    _init_collective, n, i, backend_config.collective_group_name
                )
                for i, w in enumerate(worker_group.workers)
                if i > 0
            ])
        elif mode == "torch_distributed":
            # a one-worker group too: its loop may build a mesh over
            # the process group.  Pick host AND port on worker 0 — the
            # TCP store binds there, so a driver-side free port would
            # be wrong
            host, port = worker_group.execute_single(0, _coordinator_addr)
            init_method = f"tcp://{host}:{port}"
            import ray_tpu_torch as rt

            rt.get([
                w.execute.remote(
                    _init_torch_distributed, init_method, n, i,
                    backend_config.process_group_backend)
                for i, w in enumerate(worker_group.workers)
            ])
        else:
            raise ValueError(f"unknown distributed_mode: {mode}")

    def on_shutdown(self, worker_group: WorkerGroup, backend_config: CudaConfig):
        mode = backend_config.distributed_mode
        # Kill the rendezvous actor driver-side: worker 0 may already be
        # dead (FailureConfig restart path), and the named actor must not
        # survive into the next attempt or rank 0's re-registration
        # collides with the stale name.
        if len(worker_group) > 1 and mode == "collective":
            import ray_tpu_torch as rt

            name = f"__rt_collective__{backend_config.collective_group_name}"
            try:
                rt.kill(rt.get_actor(name))
            except Exception as e:
                # best-effort: the rendezvous actor may never have been
                # created (group died before on_training_start)
                logger.debug("rendezvous actor cleanup: %s", e)
        if mode == "torch_distributed":
            try:
                worker_group.execute(_destroy_torch_distributed)
            except Exception as e:
                # best-effort: a lost worker takes its group with it
                logger.debug("process group cleanup: %s", e)


def _coordinator_addr():
    try:
        host = socket.gethostbyname(socket.gethostname())
    except socket.gaierror:
        # a host whose own name does not resolve (a sealed machine):
        # its workers meet on the loopback address
        host = "127.0.0.1"
    return host, _free_port()
