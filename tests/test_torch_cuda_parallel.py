"""Card tests of the parallel layer and the train plane's gradient sync
(torch only: they run where the card is, without JAX).  Marked `cuda`;
each skips here, where there is no card.

- `sync_gradients` carries CUDA tensors (f32 and bf16) through the host
  and back onto their own device in their own dtype;
- ring and Ulysses attention over two gloo ranks sharing the card, at
  small shapes, equal dense attention on the card, gradients included,
  with the collectives' bytes staged through the host (`TRANSPORTS`);
- a small GPT-2's sharded step over fsdp 2 x tp 2 on four gloo ranks
  sharing the card: K1 / K2 on each rank's local blocks against their
  plain versions on the same blocks (`chip_smoke.FLASH_TOL`), and the
  step's launches and collectives' routes.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.train import cuda_utils

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's card path has no CPU mode")
    return torch.device("cuda", 0)


class _Halving:
    """A stand-in collective group whose mean-allreduce halves its input
    (the mean of this rank's vector and a zero vector), in one call."""

    def __init__(self):
        self.calls = []

    def allreduce(self, array, op="sum"):
        self.calls.append((array.dtype, array.shape, op))
        return np.asarray(array) / 2


@pytest.mark.cuda
def test_sync_gradients_round_trips_cuda_tensors(card, monkeypatch):
    group = _Halving()
    monkeypatch.setitem(collectives._groups, "card_test", group)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    grads = {"a": torch.randn((3, 5), generator=gen, device=card),
             "b": [torch.randn((7,), generator=gen, device=card).bfloat16(),
                   torch.randn((2, 2), generator=gen, device=card)]}
    out = cuda_utils.sync_gradients(grads, "card_test")
    assert len(group.calls) == 1
    assert group.calls[0] == (np.float32, (3 * 5 + 7 + 4,), "mean")
    for got, want in ((out["a"], grads["a"]), (out["b"][0], grads["b"][0]),
                      (out["b"][1], grads["b"][1])):
        assert got.device == want.device and got.dtype == want.dtype
        # halving is exact in f32 and in bf16
        assert torch.equal(got, want / 2)
    assert set(cuda_utils.LAST_SYNC_MS) == {"d2h", "allreduce", "h2d"}


_RANK = r"""
import datetime, json, os, sys
sys.path.insert(0, sys.argv[4])
import torch
import torch.distributed as dist
from ray_tpu_torch.parallel import MeshSpec, collectives
from ray_tpu_torch.parallel.ring_attention import (
    plain_attention, ring_attention, ulysses_attention)

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
dev = torch.device("cuda", 0)
mesh = MeshSpec(sp=2).build(device_type="cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(3)
res = {}
for causal in (False, True):
    q, k, v = (torch.randn((2, 64, 4, 16), generator=gen, device=dev
                           ).requires_grad_(True) for _ in range(3))
    want = plain_attention(q, k, v, causal=causal)
    gw = torch.autograd.grad(want.sum(), (q, k, v))
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        got = fn(q, k, v, mesh, causal=causal)
        gg = torch.autograd.grad(got.sum(), (q, k, v))
        res[f"{name}{int(causal)}"] = {
            "device": str(got.device),
            "out": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)),
            "grad": all(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4))
                        for a, b in zip(gg, gw))}
res["transports"] = sorted("/".join(k) for k in collectives.TRANSPORTS)
with open(out, "w") as f:
    json.dump(res, f)
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)  # no interpreter teardown of gloo's threads
"""


@pytest.mark.cuda
def test_ring_and_ulysses_over_two_ranks_on_the_card(card, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    outs = [tmp_path / f"r{r}.json" for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), port,
         str(outs[r]), str(REPO)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for path in outs:
        res = json.loads(path.read_text())
        for case in ("ring0", "ring1", "ulysses0", "ulysses1"):
            assert res[case] == {"device": "cuda:0", "out": True,
                                 "grad": True}, (case, res[case])
        assert "ppermute/gloo/host" in res["transports"]
        assert "all_to_all/gloo/host" in res["transports"]
        assert os.path.getsize(path) > 0


_SHARD_RANK = r"""
import datetime, json, os, sys
sys.path.insert(0, sys.argv[4])
import torch
import torch.distributed as dist
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.parallel import MeshSpec, collectives, shard_params
from ray_tpu_torch.train.cuda_utils import prepare_batch

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
cfg = gpt2.GPT2Config(vocab_size=131, n_positions=128, n_embd=256,
                      n_layer=2, n_head=4, dtype=torch.float32,
                      attention="flash")
mesh = MeshSpec(fsdp=2, tp=2).build(device_type="cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(5)
tokens = torch.randint(0, 131, (8, 65), generator=gen, device=dev)
params = shard_params(gpt2.init_params(cfg, 0, device=dev), mesh,
                      gpt2.logical_axes(cfg))
leaves = gpt2._leaves(params)
for p in leaves:
    p.requires_grad_(True)


def loss_and_grads():
    loss = gpt2.loss_fn(cfg, params, prepare_batch(tokens, mesh))
    grads = torch.autograd.grad(loss, leaves)
    return loss, [g.to_local() for g in grads]


shapes = []
orig = {n: getattr(fa, n) for n in ("flash_fwd", "flash_bwd_fused")}


def recording(name):
    # the wrapper counts its launches on the module's name: this one
    def call(q, *args):
        shapes.append((name, tuple(q.shape)))
        return orig[name](q, *args)
    call.launches = 0
    return call


fa.flash_fwd, fa.flash_bwd_fused = (recording("flash_fwd"),
                                    recording("flash_bwd_fused"))
collectives.TRANSPORTS.clear()
kernel_loss, kernel_grads = loss_and_grads()
launches = {n: getattr(fa, n).launches for n in orig}
routes = sorted("/".join(k) for k in collectives.TRANSPORTS)
fa.flash_fwd = fa.flash_fwd_reference
fa.flash_bwd_fused = fa.flash_bwd_fused_reference
plain_loss, plain_grads = loss_and_grads()
tol = json.loads(sys.argv[5])
res = {"launches": launches, "plain_dispatches":
       fa.flash_attention.plain_dispatches,
       "shapes": sorted(set(shapes)), "routes": routes,
       "loss": [float(kernel_loss), float(plain_loss)],
       "loss_close": abs(float(kernel_loss) - float(plain_loss))
       <= tol["atol"] + tol["rtol"] * abs(float(plain_loss)),
       "grads_close": [bool(torch.allclose(a, b, rtol=tol["rtol"],
                                           atol=tol["atol"]))
                       for a, b in zip(kernel_grads, plain_grads)],
       "device": str(kernel_grads[0].device)}
with open(out, "w") as f:
    json.dump(res, f)
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)  # no interpreter teardown of gloo's threads
"""


@pytest.mark.cuda
def test_sharded_gpt2_step_runs_k1_k2_on_local_blocks(card, tmp_path):
    """GPT-2 (2 layers, D 64, f32, flash) on DTensor params over fsdp 2 x
    tp 2, four gloo ranks sharing the card: each rank launches 4 K1 (the
    forward and the remat replay) and 2 K2 on its [B/2 x H/2, T, D]
    blocks (no plain dispatch), every
    collective crosses the host, and the loss and every gradient block
    equal the plain versions' on the same blocks within `FLASH_TOL`."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import FLASH_TOL

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    outs = [tmp_path / f"r{r}.json" for r in range(4)]
    tol = json.dumps(FLASH_TOL["f32"])
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_SHARD_RANK), str(r), port,
         str(outs[r]), str(REPO), tol], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for path in outs:
        res = json.loads(path.read_text())
        assert res["launches"] == {"flash_fwd": 4, "flash_bwd_fused": 2}
        assert res["plain_dispatches"] == 0
        assert res["shapes"] == [["flash_bwd_fused", [8, 64, 64]],
                                 ["flash_fwd", [8, 64, 64]]]
        assert res["routes"] and all(r.endswith("/host")
                                     for r in res["routes"])
        assert res["loss_close"], res["loss"]
        assert all(res["grads_close"]), res["grads_close"]
        assert res["device"] == "cuda:0"
