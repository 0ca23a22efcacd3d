"""Learner: the training side of the RL stack, in eager PyTorch.

Reference: `rllib/core/learner/learner.py:117` (`compute_gradients:449`,
`apply_gradients:592`, `update_from_batch:954`) and `learner_group.py:80`.

The JAX package compiles one update (`jax.jit` with its params and
optimizer state donated); here the update is eager PyTorch on an
explicit `device` (the card unless the caller asks for the CPU): each
minibatch crosses from numpy with `torch.from_numpy(...).to(device)`
(the reference's per-minibatch `device_put`), the loss and its gradient
are taken with autograd, and the optimizer changes the parameters and
its moments in place (the donation).  The optimizer is optax's
`chain(clip_by_global_norm(grad_clip), adam(lr))` written out
(`gpt2.AdamW` with b2 0.999, no weight decay, a constant step and an
infinite norm limit when `grad_clip` is falsy): optax clips without an
epsilon and only when the norm reaches the limit, which
`clip_grad_norm_` does not.  The learner's forward and backward run
without TF32 (`_full_f32`): the reference computes in f32, and cuDNN's
convolutions default to TF32 in PyTorch.

`update_minibatch_device` keeps metrics on the device (no host sync
per minibatch): the driver thread returns to collecting sample
envelopes while the card executes, and `ppo._update_epochs` floats the
metrics once a pass.

The LEARNER GANG (`gang_devices >= 2`, or an explicit mesh) is one
program over a data mesh in the JAX package; PyTorch has no
one-process counterpart.  Here the mesh is a list of devices
(`make_data_mesh`), each minibatch is cut into equal row shards, one a
mesh device, each shard's gradient is taken there from a replica of the
params, and the shards' gradients are averaged onto the first device
before one optimizer step (the psum XLA inserts).  Every term of the
PPO loss is a row mean, so equal shards give the unsharded update.  A
loss with a whole-batch statistic (MARWIL's advantage normaliser, the
root mean square over the minibatch) carries a `batch_stats(module,
params, batch)` attribute: the gang computes it once over the whole
minibatch, without autograd, and hands it to every shard as batch
entries, as the reference's one program sees the whole batch.  A gang
wider than the cards visible deals its shards to them round-robin: on
one card a gang of 2 is two shards taken one after the other there.

DDP learners (`num_learners >= 1`) are the reference's CPU fleet: its
`_RemoteLearner` forces `JAX_PLATFORMS=cpu`, so the port's run with
`device="cpu"`.  Their gradients are flattened in `tree_leaves` order
and mean-allreduced over the host collective group, then cut back a
leaf each for the same optimizer.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.core.rl_module import RLModule, params_to_numpy

logger = logging.getLogger(__name__)


def make_data_mesh(num_devices: int, device=None) -> List[Any]:
    """The learner gang's devices: `num_devices` shards over the cards
    visible, dealt round-robin, so a gang wider than the cards puts
    several shards on a card (on one card, every shard) and stays that
    wide (default: the card).  On the CPU, `num_devices` entries of
    `cpu` stand in for XLA's forced host devices."""
    import torch

    from ray_tpu_torch import resolve_device

    kind = resolve_device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * num_devices
    visible = torch.cuda.device_count()
    return [torch.device(kind, i % visible) for i in range(num_devices)]


@contextlib.contextmanager
def _full_f32():
    """TF32 off for cuDNN and matmuls inside the block, restored after:
    scoped to the learner's own forward and backward, so the rest of
    the process keeps its setting."""
    import torch

    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _trainable(tree, device):
    from ray_tpu_torch.models.bridge import tree_map

    return tree_map(lambda t: t.detach().to(device).requires_grad_(True),
                    tree)


class Learner:
    """Owns params + optimizer state on `device`; one eager update a
    minibatch."""

    def __init__(self, module: RLModule, loss_fn: Callable,
                 lr: float = 3e-4, grad_clip: Optional[float] = 0.5,
                 seed: int = 0, mesh: Any = None, device=None):
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models.gpt2 import AdamW

        self.module = module
        self._loss_fn = loss_fn
        self._mesh = list(mesh) if mesh is not None else None
        self.device = resolve_device(self._mesh[0] if self._mesh
                                     else device)
        self.optimizer = AdamW(
            lambda _count: lr,
            max_norm=grad_clip if grad_clip else math.inf,
            b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
        )
        self.params = _trainable(
            module.init_params(torch.Generator().manual_seed(seed)),
            self.device,
        )
        self.opt_state = self.optimizer.init(self.params)

    # -- the update, in three parts ------------------------------------
    def _to_device(self, batch: Dict[str, np.ndarray], device
                   ) -> Dict[str, Any]:
        import torch

        return {k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in batch.items()}

    def _shard_grads(self, params, batch):
        import torch

        from ray_tpu_torch.models.bridge import tree_leaves

        loss, metrics = self._loss_fn(self.module, params, batch)
        # a leaf the loss does not reach (DQN's value tower) gets a zero
        # gradient, as `jax.grad` gives it
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        return metrics, list(grads)

    def _grads(self, batch: Dict[str, np.ndarray]):
        """(metrics, gradient a leaf) of one minibatch on the learner's
        device; on a gang, the mean over the mesh's equal row shards.
        TF32 is off throughout."""
        with _full_f32():
            if self._mesh is None:
                return self._shard_grads(
                    self.params, self._to_device(batch, self.device))
            import torch

            n = len(self._mesh)
            rows = batch["obs"].shape[0]
            if rows % n:
                raise ValueError(
                    f"minibatch of {rows} rows does not divide across the "
                    f"gang of {n} learner devices"
                )
            k = rows // n
            whole = {}
            stats = getattr(self._loss_fn, "batch_stats", None)
            if stats is not None:
                with torch.no_grad():
                    whole = stats(self.module, self.params,
                                  self._to_device(batch, self.device))
            parts = []
            for i, dev in enumerate(self._mesh):
                params = (self.params if dev == self.device
                          else _trainable(self.params, dev))
                shard = self._to_device(
                    {key: v[i * k:(i + 1) * k] for key, v in batch.items()},
                    dev)
                shard.update({key: v.to(dev) for key, v in whole.items()})
                parts.append(self._shard_grads(params, shard))
            metrics = {key: sum(m[key].to(self.device) for m, _ in parts) / n
                       for key in parts[0][0]}
            grads = [sum(g[j].to(self.device) for _, g in parts) / n
                     for j in range(len(parts[0][1]))]
            return metrics, grads

    def _apply(self, grads) -> None:
        self.opt_state, _norm = self.optimizer.update(
            grads, self.opt_state, self.params)

    def update_minibatch_device(self, batch: Dict[str, np.ndarray]
                                ) -> Dict[str, Any]:
        """One update WITHOUT the host sync: metrics stay 0-d tensors on
        the device (kernel launches are asynchronous — the caller
        overlaps the card's execution with its own work and floats the
        metrics once per pass)."""
        metrics, grads = self._grads(batch)
        self._apply(grads)
        return metrics

    def update_minibatch(self, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, float]:
        return {k: float(v)
                for k, v in self.update_minibatch_device(batch).items()}

    def get_weights_numpy(self):
        return params_to_numpy(self.params)

    def get_state(self) -> Dict[str, Any]:
        """numpy: the params, and the optimizer state in optax's layout
        (`count`, `mu` and `nu` shaped like the params)."""
        from ray_tpu_torch.models.bridge import adam_state_to_numpy

        return {
            "params": params_to_numpy(self.params),
            "opt_state": adam_state_to_numpy(self.opt_state, self.params),
        }

    def set_state(self, state: Dict[str, Any]):
        from ray_tpu_torch.models.bridge import (
            adam_state_from_numpy,
            params_from_numpy,
        )

        self.params = _trainable(
            params_from_numpy(state["params"], self.device), self.device)
        opt = state["opt_state"]
        self.opt_state = adam_state_from_numpy(
            opt["count"], opt["mu"], opt["nu"], self.device)


class _RemoteLearner:
    """Actor wrapper: one DDP rank (reference: LearnerGroup's remote
    learner actors), on the CPU as the reference's.  Gradient sync =
    host-collective allreduce over the flattened gradient vector."""

    def __init__(self, module: RLModule, loss_fn: Callable, lr: float,
                 grad_clip: Optional[float], seed: int, world_size: int,
                 rank: int, group_name: str):
        from ray_tpu_torch.parallel import collectives

        self._learner = Learner(module, loss_fn, lr, grad_clip, seed=seed,
                                device="cpu")
        self._world = world_size
        self._rank = rank
        self._group = collectives.init_collective_group(
            world_size, rank, group_name
        )

    def update_minibatch(self, batch) -> Dict[str, float]:
        import torch

        learner = self._learner
        metrics, grads = learner._grads(batch)
        flat = torch.cat([g.reshape(-1) for g in grads]).numpy()
        mean = torch.from_numpy(np.asarray(
            self._group.allreduce(flat, op="mean"), np.float32))
        cut, start = [], 0
        for g in grads:
            cut.append(mean[start:start + g.numel()].view_as(g))
            start += g.numel()
        learner._apply(cut)
        return {k: float(v) for k, v in metrics.items()}

    def get_weights_numpy(self):
        return self._learner.get_weights_numpy()

    def get_state(self):
        return self._learner.get_state()

    def set_state(self, state):
        self._learner.set_state(state)
        return True

    def ping(self):
        return True


class LearnerGroup:
    """Reference: `learner_group.py:80`.  num_learners=0 → local learner
    in the driver process (on `device`, the card by default; a gang of
    `gang_devices` mesh devices when >= 2); num_learners>=1 → remote
    DDP actors on the CPU."""

    def __init__(self, module: RLModule, loss_fn: Callable, *,
                 num_learners: int = 0, lr: float = 3e-4,
                 grad_clip: Optional[float] = 0.5, seed: int = 0,
                 mesh: Any = None, gang_devices: int = 0, device=None):
        self._num = num_learners
        if gang_devices >= 2:
            if num_learners:
                raise ValueError(
                    "gang_devices (mesh-sharded learner gang) and "
                    "num_learners (DDP actors) are alternative scaling "
                    "axes — set one"
                )
            if mesh is None:
                mesh = make_data_mesh(gang_devices, device)
        self._gang_devices = (
            len(mesh) if mesh is not None else (0 if num_learners else 1)
        )
        if num_learners == 0:
            self._local = Learner(module, loss_fn, lr, grad_clip, seed, mesh,
                                  device=device)
            self._actors: List = []
        else:
            self._local = None
            group = f"learner_ddp_{seed}_{id(self)}"
            self._actors = [
                rt.remote(_RemoteLearner).options(num_cpus=1).remote(
                    module, loss_fn, lr, grad_clip, seed, num_learners,
                    rank, group,
                )
                for rank in range(num_learners)
            ]
            rt.get([a.ping.remote() for a in self._actors])

    def update_minibatch_device(self, batch: Dict[str, np.ndarray]
                                ) -> Dict[str, Any]:
        """Sync-free update for the overlap pipeline (local/gang mode
        only; DDP actors already return host floats).  Duration metrics
        are the caller's job — launches are asynchronous, so wall time
        is only meaningful once the metrics are read back."""
        if self._local is not None:
            return self._local.update_minibatch_device(batch)
        return self.update_minibatch(batch)

    def update_minibatch(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update_minibatch(batch)
        # split the minibatch across ranks; every rank applies the same
        # allreduced gradient so params stay identical
        n = batch["obs"].shape[0]
        if n < self._num:
            raise ValueError(
                f"minibatch of {n} rows cannot be split across "
                f"{self._num} learners — an empty shard would produce "
                "NaN gradients; raise minibatch_size or lower num_learners"
            )
        shard = n // self._num
        refs = []
        for i, a in enumerate(self._actors):
            sl = slice(i * shard, (i + 1) * shard if i < self._num - 1 else n)
            refs.append(a.update_minibatch.remote(
                {k: v[sl] for k, v in batch.items()}
            ))
        all_metrics = rt.get(refs)
        return {
            k: float(np.mean([m[k] for m in all_metrics]))
            for k in all_metrics[0]
        }

    def get_weights_numpy(self):
        if self._local is not None:
            return self._local.get_weights_numpy()
        return rt.get(self._actors[0].get_weights_numpy.remote())

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        return rt.get(self._actors[0].get_state.remote())

    def set_state(self, state):
        if self._local is not None:
            self._local.set_state(state)
        else:
            rt.get([a.set_state.remote(state) for a in self._actors])

    @property
    def device(self):
        """Where the local learner's params live (the first device of a
        gang); the CPU for DDP learner actors.  Driver-side forwards of
        the params (DQN's and SAC's targets) run here."""
        import torch

        if self._local is not None:
            return self._local.device
        return torch.device("cpu")

    @property
    def num_gang_devices(self) -> int:
        """Width of the learner gang (1 = single local device,
        0 = DDP actors carry the parallelism instead)."""
        return self._gang_devices

    def stop(self):
        for a in self._actors:
            try:
                rt.kill(a)
            except Exception as e:
                logger.debug("learner actor kill on stop failed: %s", e)
