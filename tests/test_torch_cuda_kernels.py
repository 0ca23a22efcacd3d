"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA card (marker `cuda`) and skips without
one; the fixture decides, never the import.  The file imports torch
and the port only, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Shapes are small and ragged (positions past the table's reach, idle
rows on the scratch block, shuffled tables, GQA; T not a multiple of
the flash tiles; N and V not multiples of the xent tiles, targets at 0,
V - 1 and out of range).  Tolerances: K5 bit-equal outside the
scratch block; K6 f32 1e-5, bf16 and int8 2e-2 (the reference's own).  K1-K4 against
their plain versions element by element (`assert_close`) and by the
norm of the difference over the plain version's norm, with the limits
of `chip_smoke.py`: f32 rtol 1e-4, atol 1e-5, norm 3e-6 (tiled online
softmax and tiled sums in another order; K2's dQ summed by atomics in
an order that changes from run to run), bf16 rtol 2e-2, atol 1e-2,
norm 7e-3 for K1 (P rounded to bf16 at other maxima, outputs in bf16)
and 5e-4 for K2-K4 (P from the same LSE; dS and the outputs rounded to
bf16; the bf16 K2 sums dQ by bulk reduce-adds in a run-dependent
order).
K7-K9 likewise, with atol relative to each output's largest magnitude
(`XENT_TOL`).  All draws seeded (RT008).
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
# bf16 norm limits per kernel (`chip_smoke.py`'s FLASH_REL_BF16)
FLASH_REL_BF16 = {"fwd": 7e-3, "fused": 5e-4, "dq": 5e-4, "dkv": 5e-4}


def _flash_tol(kind, name):
    if kind == "f32":
        return FLASH_TOL[kind]
    return {**FLASH_TOL[kind], "rel": FLASH_REL_BF16[name]}


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
@pytest.mark.parametrize("BH,T,D", [(6, 128, 64), (6, 100, 128), (6, 72, 16),
                                    (6, 1024, 64), (6, 48, 64), (3, 200, 64),
                                    (3, 200, 96)])
def test_flash_kernels_match_plain(cuda_device, kind, causal, BH, T, D):
    """K1, K2, K3 and K4 each against its plain version on the same
    inputs (the backward ones on the plain forward's O and LSE).  The
    shapes stress the bf16 kernels' tiles (128 q rows in K1, 128 kv rows
    and 64 q rows in K2): 8 full tiles (T 1024), T under one tile (48),
    ragged over two (200, 100, 72), head widths that run on the 64 and
    128 instantiations (16, 96)."""
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    q, k, v, do = _flash_inputs(BH, T, D, dt, seed=T + D + causal)
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
            _assert_flash_close(g, w, _flash_tol(kind, name), name)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_fused_repeats(cuda_device, D):
    """K2 twice on the same inputs: dK and dV bit-equal (each is summed in
    one CTA's registers, in a fixed order), dQ within K2's limit (its f32
    tiles are added into the scratch by bulk reduce-adds, in an order
    that changes from run to run)."""
    q, k, v, do = (t.to(cuda_device) for t in _flash_inputs(
        4, 320, D, torch.bfloat16, seed=D))
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    first = fa.flash_bwd_fused(q, k, v, do, lse, o, True, scale)
    second = fa.flash_bwd_fused(q, k, v, do, lse, o, True, scale)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    _assert_flash_close(second[0], first[0], _flash_tol("bf16", "fused"),
                        "dq")


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


# K7-K9 against their plain versions, with the limits of `chip_smoke.py`:
# element by element, |kernel - plain| <= atol * max |plain| + rtol |plain|
# (atol relative to the output's scale: lse ~ ln V, dx ~ |w|, dw ~ |x|), and
# by the relative norm of the difference.  f32: the same sums in another
# order (64-column vocab tiles with an online logsumexp, E in chunks).
# bf16: dl rounded to bf16 from scores summed in another order, so a few of
# its elements land one bf16 step apart.  Norm limits ~3x the worst H100
# readings of these shapes (f32 3.5e-6; bf16 4.2e-4, at E 4,096 and V 130,
# where few classes share the sum and one step weighs more than at the
# chip script's shapes).
XENT_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 1e-5},
            "bf16": {"rtol": 2e-2, "atol": 5e-3, "rel": 1.5e-3}}


def _xent_inputs(N, E, V, x_dtype, w_dtype, seed):
    """x [N, E], w [V, E] * 0.05, targets [N] with 0, V - 1 and an
    out-of-range -1 among them, and the plain forward's lse."""
    from ray_tpu_torch.ops import xent_pallas as xp

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((N, E), generator=gen).to(x_dtype)
    w = (torch.randn((V, E), generator=gen) * 0.05).to(w_dtype)
    tg = torch.randint(0, V, (N,), generator=gen, dtype=torch.int32)
    tg[0], tg[-1], tg[N // 2] = 0, V - 1, -1
    lse, _ = xp.xent_fwd_reference(x, w, tg)
    return x, w, tg, lse


def _assert_xent_close(got, want, tol, msg):
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    assert got.shape == want.shape, msg
    assert bool(torch.isfinite(got).all()), msg
    d = (got - want).abs()
    ratio = float((d / (tol["atol"] * float(want.abs().max())
                        + tol["rtol"] * want.abs())).max())
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    readings = (msg, float(d.max()), ratio, rel)
    assert ratio <= 1.0 and rel <= tol["rel"], readings


@pytest.mark.cuda
@pytest.mark.parametrize("kind,w_kind", [("f32", "f32"), ("bf16", "f32"),
                                         ("bf16", "bf16")])
@pytest.mark.parametrize("N,E,V", [(200, 128, 300), (77, 768, 1000),
                                   (70, 4096, 130)])
def test_xent_kernels_match_plain(cuda_device, kind, w_kind, N, E, V):
    """K7, K8 and K9 each against its plain version on the same inputs
    (K8 / K9 on the plain forward's lse); ragged N and V, E 128 to
    4,096."""
    from ray_tpu_torch.ops import xent_pallas as xp

    x, w, tg, lse = _xent_inputs(N, E, V, DTYPES[kind], DTYPES[w_kind],
                                 seed=N + E + V)
    want = {"fwd": xp.xent_fwd_reference(x, w, tg),
            "dx": (xp.xent_dx_reference(x, w, tg, lse),),
            "dw": (xp.xent_dw_reference(x, w, tg, lse),)}
    dev = [t.to(cuda_device) for t in (x, w, tg, lse)]
    fns = (xp.xent_fwd, xp.xent_dx, xp.xent_dw)
    n0 = [f.launches for f in fns]
    got = {"fwd": xp.xent_fwd(*dev[:3]), "dx": (xp.xent_dx(*dev),),
           "dw": (xp.xent_dw(*dev),)}
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in n0]
    for name in want:
        for g, w_ in zip(got[name], want[name]):
            assert g.dtype == torch.float32, name
            _assert_xent_close(g, w_, XENT_TOL[kind], name)


@pytest.mark.cuda
def test_pallas_cross_entropy_on_the_card(cuda_device):
    """The autograd op on CUDA tensors: loss and grads equal the CPU
    route's (the plain versions), through one launch of each kernel."""
    from ray_tpu_torch.ops import pallas_cross_entropy
    from ray_tpu_torch.ops import xent_pallas as xp

    x, w, tg, _ = _xent_inputs(130, 64, 200, torch.float32, torch.float32,
                               seed=9)

    def run(device):
        xs = [t.to(device).requires_grad_(True) for t in (x, w)]
        loss = pallas_cross_entropy(*xs, tg.to(device))
        return [t.detach().cpu() for t in (loss, *torch.autograd.grad(
            loss, xs))]

    want = run("cpu")
    fns = (xp.xent_fwd, xp.xent_dx, xp.xent_dw)
    n0 = [f.launches for f in fns]
    got = run(cuda_device)
    assert [f.launches for f in fns] == [n + 1 for n in n0]
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_xent_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from ray_tpu_torch.ops import xent_pallas as xp

    tg = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    x = torch.zeros((4, 16), device=cuda_device)
    n0 = xp.xent_fwd.launches
    with pytest.raises(ValueError, match="not supported"):
        xp.xent_fwd(x.half(), x.half(), tg)
    with pytest.raises(ValueError, match="w's dtype"):
        xp.xent_fwd(x, x.bfloat16(), tg)
    with pytest.raises(ValueError, match="E % 8"):
        xp.xent_fwd(x[:, :12].contiguous(), x[:, :12].contiguous(), tg)
    with pytest.raises(ValueError, match="contiguous"):
        xp.xent_fwd(x, torch.zeros((16, 8), device=cuda_device).T, tg[:4])
    flat = torch.zeros(4 * 16 + 2, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        xp.xent_fwd(flat[2:].view(4, 16), x.bfloat16(), tg)
    with pytest.raises(ValueError, match="targets"):
        xp.xent_fwd(x, x, tg.float())
    with pytest.raises(ValueError, match="lse"):
        xp.xent_dx(x, x, tg, torch.zeros((4,), device=cuda_device))
    assert xp.xent_fwd.launches == n0
