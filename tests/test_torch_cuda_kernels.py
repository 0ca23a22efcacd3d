"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA card (marker `cuda`) and skips without
one; the fixture decides, never the import.  The file imports torch
and the port only, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Shapes are small and ragged (positions past the table's reach, idle
rows on the scratch block, shuffled tables, GQA).  Tolerances: K5
bit-equal outside the scratch block; K6 f32 1e-5, bf16 and int8 2e-2
(the reference's own).  All draws seeded (RT008).
"""

import pytest
import torch

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
