"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA card (marker `cuda`) and skips without
one; the fixture decides, never the import.  The file imports torch
and the port only, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Shapes are small and ragged (positions past the table's reach, idle
rows on the scratch block, shuffled tables, GQA; T not a multiple of
the flash tiles).  Tolerances: K5 bit-equal outside the scratch block;
K6 f32 1e-5, bf16 and int8 2e-2 (the reference's own).  K1-K4 against
their plain versions element by element (`assert_close`) and by the
norm of the difference over the plain version's norm, with the limits
of `chip_smoke.py`: f32 rtol 1e-4, atol 1e-5, norm 3e-6 (tiled online
softmax and tiled sums in another order; K2's dQ summed by atomics in
an order that changes from run to run), bf16 rtol 2e-2, atol 1e-2,
norm 7e-3 (P and dS rounded to bf16 at other maxima, outputs in bf16).
All draws seeded (RT008).
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _rand(shape, dtype, gen):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen).to(dtype)


def _layout(B, W, BS, gen):
    """Shuffled tables over blocks 1..B*W (0 = scratch), ragged pos."""
    NB = 1 + B * W
    tables = (torch.randperm(NB - 1, generator=gen) + 1).reshape(B, W)
    pos = torch.randint(0, W * BS, (B,), generator=gen)
    pos[1] = W * BS + 3  # past the table's reach
    return NB, tables.to(torch.int32), pos.to(torch.int32)


def _to(case, device):
    return {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in case.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [16, 128])
def test_append_kernel_bit_equals_plain(cuda_device, kind, hd):
    gen = torch.Generator().manual_seed(hd)
    L, B, W, BS, KV = 3, 5, 4, 8, 2
    NB, tables, pos = _layout(B, W, BS, gen)
    tables[2] = 0  # idle row on the scratch block
    dt = DTYPES[kind]
    case = {"k_pool": _rand((L, NB, BS, KV, hd), dt, gen),
            "v_pool": _rand((L, NB, BS, KV, hd), dt, gen),
            "k_new": _rand((B, KV, hd), dt, gen),
            "v_new": _rand((B, KV, hd), dt, gen),
            "tables": tables, "pos": pos}
    scales = {}
    if kind == "int8":
        scales = {"k_scale": torch.rand((L, NB, BS, KV), generator=gen),
                  "v_scale": torch.rand((L, NB, BS, KV), generator=gen),
                  "k_new_scale": torch.rand((B, KV), generator=gen),
                  "v_new_scale": torch.rand((B, KV), generator=gen)}
    names = ("k_pool", "v_pool", "k_new", "v_new", "tables", "pos")
    want = pa.paged_kv_append_reference(
        *[case[n].clone() for n in names], 1,
        **{k: v.clone() for k, v in scales.items()})
    dev, dev_scales = _to(case, cuda_device), _to(scales, cuda_device)
    n0 = pa.paged_kv_append.launches
    got = pa.paged_kv_append(*[dev[n] for n in names], 1, **dev_scales)
    torch.cuda.synchronize()
    assert pa.paged_kv_append.launches == n0 + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu()[:, 1:], w[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2),
                                      ("int8", 2e-2)])
@pytest.mark.parametrize("hd,group", [(16, 2), (128, 4)])
def test_attention_kernel_matches_plain(cuda_device, kind, tol, hd, group):
    gen = torch.Generator().manual_seed(hd + group)
    L, B, W, BS, KV = 2, 6, 5, 16, 2
    NB, tables, pos = _layout(B, W, BS, gen)
    pos[0] = 0
    q_dt = torch.float32 if kind == "f32" else torch.bfloat16
    pool_dt = DTYPES[kind]
    case = {"q": torch.randn((B, KV * group, hd), generator=gen).to(q_dt),
            "k_pool": _rand((L, NB, BS, KV, hd), pool_dt, gen),
            "v_pool": _rand((L, NB, BS, KV, hd), pool_dt, gen),
            "tables": tables, "pos": pos}
    scales = {}
    if kind == "int8":
        scales = {"k_scale": torch.rand((L, NB, BS, KV), generator=gen) / 20,
                  "v_scale": torch.rand((L, NB, BS, KV), generator=gen) / 20}
    names = ("q", "k_pool", "v_pool", "tables", "pos")
    want = pa.paged_decode_attention_reference(
        *[case[n] for n in names], 1, **scales)
    dev, dev_scales = _to(case, cuda_device), _to(scales, cuda_device)
    n0 = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*[dev[n] for n in names], 1,
                                    **dev_scales)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 1
    assert got.dtype == q_dt and got.shape == want.shape
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    pool = torch.randn((1, 3, 4, 1, 8), generator=gen).to(torch.float16)
    tables = torch.ones((1, 1), dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    dev = [t.to(cuda_device) for t in (pool, tables, pos)]
    n0 = pa.paged_kv_append.launches
    with pytest.raises(ValueError, match="not supported"):
        pa.paged_kv_append(dev[0], dev[0], dev[0][0, 0, :1],
                           dev[0][0, 0, :1], dev[1], dev[2], 0)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_decode_attention(
            torch.zeros((1, 1, 8), device=cuda_device),
            dev[0].float(), dev[0].float(), dev[1].long(), dev[2], 0)
    assert pa.paged_kv_append.launches == n0


FLASH_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 3e-6},
             "bf16": {"rtol": 2e-2, "atol": 1e-2, "rel": 7e-3}}


def _assert_flash_close(got, want, tol, msg=""):
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=tol["atol"],
                               msg=msg or None)
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(
        want)
    assert float(rel) <= tol["rel"], (msg, float(rel))


def _flash_inputs(BH, T, D, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((BH, T, D), generator=gen).to(dtype)
                   for _ in range(4))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,D", [(128, 64), (100, 128), (72, 16)])
def test_flash_kernels_match_plain(cuda_device, kind, causal, T, D):
    """K1, K2, K3 and K4 each against its plain version on the same
    inputs (the backward ones on the plain forward's O and LSE)."""
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    q, k, v, do = _flash_inputs(6, T, D, dt, seed=T + D + causal)
    scale = D ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    want = {
        "fwd": (o, lse),
        "fused": fa.flash_bwd_fused_reference(q, k, v, do, lse, o, causal,
                                              scale),
        "dq": (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                         scale),),
        "dkv": fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                          scale),
    }
    dq_, dk_, dv_, ddo, dl, dd, do_ = (
        t.to(cuda_device) for t in (q, k, v, do, lse, delta, o))
    n0 = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_fused,
                               fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    got = {
        "fwd": fa.flash_fwd(dq_, dk_, dv_, causal, scale),
        "fused": fa.flash_bwd_fused(dq_, dk_, dv_, ddo, dl, do_, causal,
                                    scale),
        "dq": (fa.flash_bwd_dq(dq_, dk_, dv_, ddo, dl, dd, causal, scale),),
        "dkv": fa.flash_bwd_dkv(dq_, dk_, dv_, ddo, dl, dd, causal, scale),
    }
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_fwd, fa.flash_bwd_fused,
                                 fa.flash_bwd_dq, fa.flash_bwd_dkv)] == [
        n + 1 for n in n0]
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            _assert_flash_close(g, w, FLASH_TOL[kind], name)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(1024, 1024), (32, 32)])
def test_flash_attention_op_on_the_card(cuda_device, blocks):
    """The autograd op on CUDA tensors: forward and grads equal the CPU
    route's (the plain versions), through K2 for blocks covering T and
    K3 + K4 otherwise; no plain dispatch."""
    gen = torch.Generator().manual_seed(blocks[0])
    q, k, v, w = (torch.randn((2, 64, 3, 32), generator=gen)
                  for _ in range(4))

    def run(device):
        x = [t.to(device).requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*x, True, *blocks)
        grads = torch.autograd.grad((out * w.to(device)).sum(), x)
        return [t.detach().cpu() for t in (out, *grads)]

    want = run("cpu")
    n0 = (fa.flash_attention.plain_dispatches, fa.flash_bwd_fused.launches,
          fa.flash_bwd_dq.launches)
    got = run(cuda_device)
    fused = blocks[0] >= 64
    assert fa.flash_attention.plain_dispatches == n0[0]
    assert fa.flash_bwd_fused.launches == n0[1] + int(fused)
    assert fa.flash_bwd_dq.launches == n0[2] + int(not fused)
    for g, w_ in zip(got, want):
        _assert_flash_close(g, w_, FLASH_TOL["f32"])


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((2, 16, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_fwd(q, q, q, True, 0.3)
    wide = torch.zeros((2, 16, 256), device=cuda_device)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_fwd(wide, wide, wide, True, 0.1)
    q = torch.zeros((2, 16, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, q.transpose(0, 1).contiguous().transpose(0, 1), q,
                     True, 0.3)
