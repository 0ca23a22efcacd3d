"""Card tests of the parallel layer and the train plane's gradient sync
(torch only: they run where the card is, without JAX).  Marked `cuda`;
each skips here, where there is no card.

- `sync_gradients` carries CUDA tensors (f32 and bf16) through the host
  and back onto their own device in their own dtype;
- ring and Ulysses attention over two gloo ranks sharing the card, at
  small shapes, equal dense attention on the card, gradients included,
  with the collectives' bytes staged through the host (`TRANSPORTS`).
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
