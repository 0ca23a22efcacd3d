"""The plain references against the port at tiny sizes on the CPU, in
f32: the same function.  (The test imports both; the references import
nothing of the program.)"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from port_bench import weights
from port_bench.drivers import serve_closed_loop as sc
from port_bench.reference import llama_ref
from port_bench.reference.lowp import fp8_mm, round_fp8

TINY = Path(__file__).resolve().parent / "tiny" / "configs"


def cfg(name):
    return json.loads((TINY / f"{name}.json").read_text())


def test_llama_reference_is_the_ports_forward():
    from ray_tpu_torch.models import llama

    c = cfg("tiny-llama")
    params = weights.make(weights.llama_specs(c), 5, "cpu", torch.float32)
    lcfg = sc.llama_config(c, 64)
    toks = torch.randint(0, c["vocab_size"], (2, 24),
                         generator=torch.Generator().manual_seed(0))
    want = llama.forward(lcfg, params, toks)
    got = llama_ref.logits_at(c, params, [toks[0], toks[1][:17]], [3, 0])
    torch.testing.assert_close(got[0], want[0, 3:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1, :17], rtol=1e-5, atol=1e-5)


def test_gaps():
    lg = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.0, 0.25]])
    assert llama_ref.gaps(lg, torch.tensor([2, 0])).tolist() == [1.0, 0.0]


def test_fp8_rounding():
    x = torch.tensor([[1.0, 0.3, -448.0], [2.0, 0.0, 1e-3]])
    r = round_fp8(x, -1)
    assert r[0, 2] == -448.0 and r[0, 0] == 1.0
    assert float((r - x).abs().max()) > 0
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    got = fp8_mm(a, b)
    assert torch.equal(got, round_fp8(a, -1) @ round_fp8(b, -2))
    assert 0 < float((got - a @ b).abs().max()) < 0.5
