"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA card (marker `cuda`) and skips without
one; the fixture decides, never the import.  The file imports torch
and the port only, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Shapes are small and ragged (positions past the table's reach, idle
rows on the scratch block, shuffled tables, GQA, K6's table cut into
three or more splits, pool blocks of 16 to 128 tokens, K6 at hd 1,032
and at tables of 65,540 blocks; the fused append + attention against K5
then K6 at heads of 64 to 1,040, groups of 1 to 16, new tokens on a
later split's first column and past 1,024 staged table entries, new
rows 2 bytes off 16-byte alignment; T not a multiple of the flash tiles,
and heads of 136 to 512, past the bf16 Hopper tiles, and of 712 and
1,032, cut into column slices; N and V not multiples of the xent tiles, E past one
K8 / K9 block, targets at 0, V - 1 and out of range on both sides).  Tolerances: K5 bit-equal outside the
scratch block; K6 f32 1e-5, bf16 and int8 2e-2 (the reference's own);
the fused op bit-equal to K5 then K6 (outputs on live rows, pools
outside the scratch block) and within K6's tolerance of its plain
version.  K1-K4 against
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


def _split_case(kind, BS, hd, device_sms, *, B=8, KV=2, group=4, seed=0):
    """A pool and tables whose rows exercise K6's split plan: W not a
    multiple of the split count and at least three splits; rows at pos
    -1 (idle), 0, the last column of split 0, the first of split 1 and
    of the last split, past the table's reach, and two random."""
    H = KV * group
    for W in range(37, 80):
        splits, per = pa.split_plan(B, H, KV, W, BS, device_sms)
        if splits >= 3 and W % splits:
            break
    gen = torch.Generator().manual_seed(seed + BS + hd)
    NB, tables, pos = _layout(B, W, BS, gen)
    pos[:6] = torch.tensor([-1, 0, per * BS - 1, per * BS,
                            (splits - 1) * per * BS, W * BS + 5])
    q_dt = torch.float32 if kind == "f32" else torch.bfloat16
    case = {"q": torch.randn((B, H, hd), generator=gen).to(q_dt),
            "k_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "v_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "tables": tables, "pos": pos}
    if kind == "int8":
        case["k_scale"] = torch.rand((1, NB, BS, KV), generator=gen) / 20
        case["v_scale"] = torch.rand((1, NB, BS, KV), generator=gen) / 20
    return case, splits


def _run_k6(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["tables"],
              case["pos"], 0, k_scale=case.get("k_scale"),
              v_scale=case.get("v_scale"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2),
                                      ("int8", 2e-2)])
@pytest.mark.parametrize("BS", [16, 64, 128])
def test_attention_kernel_splits_match_plain(cuda_device, kind, tol, BS):
    """K6 at hd 128 with its table cut into three or more splits (W not
    a multiple of their count), rows idle, at 0, on a split's first and
    last columns, past the table's reach and long enough to use every
    split; pool blocks of 16, 64 and 128 tokens (the last 32 KB a tile
    in bf16, past the first design's 16 KB cap)."""
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    case, splits = _split_case(kind, BS, 128, sms)
    assert splits >= 3
    want = _run_k6(pa.paged_decode_attention_reference, case)
    assert bool((want[0] == 0).all())  # the idle row attends to nothing
    n0 = pa.paged_decode_attention.launches
    got = _run_k6(pa.paged_decode_attention, _to(case, cuda_device))
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_attention_kernel_repeats_bit_equal(cuda_device, kind):
    """K6 twice on the same inputs gives the same bits: the split plan
    is fixed by shapes and the last CTA merges the splits in split
    order, whichever CTA finishes last."""
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    case, _ = _split_case(kind, 16, 128, sms, seed=5)
    dev = _to(case, cuda_device)
    first = _run_k6(pa.paged_decode_attention, dev)
    for _ in range(3):
        again = _run_k6(pa.paged_decode_attention, dev)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_attention_kernel_wide_head_matches_plain(cuda_device, kind, tol):
    """K6 at hd 1,032, past the 1,024 the split walk holds (the reference
    takes any width): the wide-head kernel, its columns cut over two
    CTAs, against the plain version, GQA group 4, ragged rows, one idle
    and one past the table's reach."""
    B, KV, group, W, BS, hd = 4, 2, 4, 5, 16, 1032
    gen = torch.Generator().manual_seed(hd)
    NB, tables, pos = _layout(B, W, BS, gen)
    pos[0] = -1
    q_dt = torch.float32 if kind == "f32" else torch.bfloat16
    case = {"q": torch.randn((B, KV * group, hd), generator=gen).to(q_dt),
            "k_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "v_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "tables": tables, "pos": pos}
    want = _run_k6(pa.paged_decode_attention_reference, case)
    n0 = pa.paged_decode_attention.launches
    got = _run_k6(pa.paged_decode_attention, _to(case, cuda_device))
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_attention_kernel_long_table_matches_plain(cuda_device, kind, tol):
    """K6 at tables of 65,540 blocks a row, past the 64 splits of 1,024
    staged entries (blocks of one token, so the plain version's dense
    gather stays small): 64 splits of 1,025 blocks, each staging its
    table in two rounds; one row full, one ending on the second round's
    entry, the last column of split 3.  A repeat gives the same bits."""
    B, KV, group, W, BS, hd = 2, 1, 2, 65540, 1, 64
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    splits, per = pa.split_plan(B, KV * group, KV, W, BS, sms)
    assert per > 1024 and splits <= 64
    gen = torch.Generator().manual_seed(W)
    NB = 1 + B * W
    tables = (torch.randperm(NB - 1, generator=gen) + 1).reshape(B, W).to(
        torch.int32)
    pos = torch.tensor([W * BS - 1, (3 * per + 1024) * BS],
                       dtype=torch.int32)
    q_dt = torch.float32 if kind == "f32" else torch.bfloat16
    case = {"q": torch.randn((B, KV * group, hd), generator=gen).to(q_dt),
            "k_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "v_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "tables": tables, "pos": pos}
    want = _run_k6(pa.paged_decode_attention_reference, case)
    n0 = pa.paged_decode_attention.launches
    dev = _to(case, cuda_device)
    got = _run_k6(pa.paged_decode_attention, dev)
    again = _run_k6(pa.paged_decode_attention, dev)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """Dtypes, index types and pool rows that are not 16-byte vectors
    raise; a pool block of 128 tokens at hd 128 in bf16 (a 32 KB tile,
    which the first design's 16 KB cap refused) launches."""
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
    n0 = pa.paged_decode_attention.launches
    narrow = torch.zeros((1, 3, 4, 1, 4), dtype=torch.bfloat16,
                         device=cuda_device)  # 8-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_decode_attention(
            torch.zeros((1, 1, 4), dtype=torch.bfloat16, device=cuda_device),
            narrow, narrow, dev[1], dev[2], 0)
    assert pa.paged_decode_attention.launches == n0
    big = torch.randn((1, 2, 128, 1, 128), generator=gen).to(
        device=cuda_device, dtype=torch.bfloat16)
    q = torch.randn((1, 2, 128), generator=gen).to(device=cuda_device,
                                                    dtype=torch.bfloat16)
    pos = torch.full((1,), 100, dtype=torch.int32, device=cuda_device)
    got = pa.paged_decode_attention(q, big, big, dev[1], pos, 0)
    want = pa.paged_decode_attention_reference(q, big, big, dev[1], pos, 0)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ----------------------------------------------------------------------
# K5 folded into K6: paged_append_decode_attention
# ----------------------------------------------------------------------
def _new_rows(case, kind, gen):
    """The case's new K / V rows (and int8 scales) for every row."""
    B = case["q"].shape[0]
    KV, hd = case["k_pool"].shape[3:]
    case["k_new"] = _rand((B, KV, hd), DTYPES[kind], gen)
    case["v_new"] = _rand((B, KV, hd), DTYPES[kind], gen)
    if kind == "int8":
        case["k_new_scale"] = torch.rand((B, KV), generator=gen) / 20
        case["v_new_scale"] = torch.rand((B, KV), generator=gen) / 20
    return case


def _fused_vs_pair(case, device, layer=0):
    """The fused op and K5 then K6 on clones of the same pools: (fused
    out, pair out, fused pools, pair pools), pools = [k, v (, k_scale,
    v_scale)], all on the card."""
    written = ("k_pool", "v_pool", "k_scale", "v_scale")

    def fresh():  # the inputs on the card, the written ones cloned
        return {k: (v.to(device).clone() if k in written else
                    v.to(device) if torch.is_tensor(v) else v)
                for k, v in case.items()}

    f, p = fresh(), fresh()
    sc = {n: f.get(n) for n in ("k_scale", "v_scale", "k_new_scale",
                                "v_new_scale")}
    n0 = (pa.paged_append_decode_attention.launches,
          pa.paged_kv_append.launches, pa.paged_decode_attention.launches)
    out = pa.paged_append_decode_attention(
        f["q"], f["k_pool"], f["v_pool"], f["k_new"], f["v_new"],
        f["tables"], f["pos"], layer, **sc)
    pa.paged_kv_append(p["k_pool"], p["v_pool"], p["k_new"], p["v_new"],
                       p["tables"], p["pos"], layer,
                       **{n: p.get(n) for n in sc})
    want = pa.paged_decode_attention(
        p["q"], p["k_pool"], p["v_pool"], p["tables"], p["pos"], layer,
        k_scale=p.get("k_scale"), v_scale=p.get("v_scale"))
    torch.cuda.synchronize()
    assert (pa.paged_append_decode_attention.launches,
            pa.paged_kv_append.launches,
            pa.paged_decode_attention.launches) == (n0[0] + 1, n0[1] + 1,
                                                    n0[2] + 1)
    names = ["k_pool", "v_pool"] + (["k_scale", "v_scale"]
                                    if "k_scale" in case else [])
    return out, want, [f[n] for n in names], [p[n] for n in names]


def _assert_fused_equals_pair(case, device, live, layer=0):
    """Bit-equal outputs on the live rows, pools bit-equal outside
    scratch block 0, and the output within the plain version's
    tolerance on those rows."""
    out, want, pools, p_pools = _fused_vs_pair(case, device, layer)
    assert out.dtype == want.dtype and out.shape == want.shape
    assert torch.equal(out[live], want[live])
    for g, w in zip(pools, p_pools, strict=True):
        assert torch.equal(g[:, 1:], w[:, 1:])
    plain = {k: (v.detach().cpu().clone() if torch.is_tensor(v) else v)
             for k, v in case.items()}
    ref = pa.paged_append_decode_attention_reference(
        plain["q"], plain["k_pool"], plain["v_pool"], plain["k_new"],
        plain["v_new"], plain["tables"], plain["pos"], layer,
        **{n: plain.get(n) for n in ("k_scale", "v_scale", "k_new_scale",
                                     "v_new_scale")})
    tol = 1e-5 if case["q"].dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.cpu()[live].float(), ref[live].float(),
                               rtol=tol, atol=tol)
    return out, pools


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd,group,BS", [(64, 1, 16), (128, 4, 16),
                                         (128, 16, 128), (64, 16, 16),
                                         (128, 1, 128), (1040, 4, 16)])
def test_fused_append_attention_bit_equals_pair(cuda_device, kind, hd,
                                                group, BS):
    """The fused op against K5 then K6 on cloned pools: heads of 64, 128
    and 1,040 (the wide kernel, each column-part CTA writing the row;
    16-byte int8 rows, which K6 needs),
    GQA groups of 1, 4 and 16 (16: two group-chunk CTAs writing the same
    slot), pool blocks of 16 and 128 tokens; rows at pos -1, 0, a
    block's first column and past the table's reach, and two idle rows
    parked on scratch block 0, both writing it (their outputs are
    garbage by contract and not compared)."""
    gen = torch.Generator().manual_seed(hd + 7 * group + BS)
    L, B, W, KV = 2, 7, 3, 2
    NB, tables, pos = _layout(B, W, BS, gen)
    pos[:5] = torch.tensor([-1, W * BS + 3, 0, BS, W * BS - 1])
    tables[5:] = 0
    q_dt = torch.float32 if kind == "f32" else torch.bfloat16
    case = {"q": torch.randn((B, KV * group, hd), generator=gen).to(q_dt),
            "k_pool": _rand((L, NB, BS, KV, hd), DTYPES[kind], gen),
            "v_pool": _rand((L, NB, BS, KV, hd), DTYPES[kind], gen),
            "tables": tables, "pos": pos}
    if kind == "int8":
        case["k_scale"] = torch.rand((L, NB, BS, KV), generator=gen) / 20
        case["v_scale"] = torch.rand((L, NB, BS, KV), generator=gen) / 20
    _new_rows(case, kind, gen)
    _assert_fused_equals_pair(case, cuda_device, live=slice(0, 5), layer=1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_fused_append_on_a_later_split(cuda_device, kind):
    """K6's table cut into three or more splits: new tokens on the first
    column of split 1 and of the last split, on split 0's last column,
    at 0, -1 and past the table's reach; only the split that holds the
    column writes it, and the other splits' partials merge as K6's."""
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    case, splits = _split_case(kind, 16, 128, sms, seed=3)
    assert splits >= 3
    _new_rows(case, kind, torch.Generator().manual_seed(3))
    out, _ = _assert_fused_equals_pair(case, cuda_device,
                                       live=slice(None))
    assert bool((out[0] == 0).all())  # pos -1 attends to nothing


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_fused_append_long_table(cuda_device, kind):
    """Tables of 65,540 blocks of one token: 64 splits of 1,025 blocks,
    each staging 1,024 table entries.  One new token lands on the
    1,025th entry of split 3 (past the staged ones: its block id comes
    from the table in device memory), one on the table's last column."""
    B, KV, group, W, BS, hd = 2, 1, 2, 65540, 1, 64
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    splits, per = pa.split_plan(B, KV * group, KV, W, BS, sms)
    assert per > 1024 and splits <= 64
    gen = torch.Generator().manual_seed(W + 1)
    NB = 1 + B * W
    tables = (torch.randperm(NB - 1, generator=gen) + 1).reshape(B, W).to(
        torch.int32)
    pos = torch.tensor([W * BS - 1, (3 * per + 1024) * BS],
                       dtype=torch.int32)
    q_dt = torch.float32 if kind == "f32" else torch.bfloat16
    case = {"q": torch.randn((B, KV * group, hd), generator=gen).to(q_dt),
            "k_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "v_pool": _rand((1, NB, BS, KV, hd), DTYPES[kind], gen),
            "tables": tables, "pos": pos}
    _new_rows(case, kind, gen)
    _assert_fused_equals_pair(case, cuda_device, live=slice(None))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_fused_append_repeats_bit_equal(cuda_device, kind):
    """Two calls on the same inputs give the same bits: the second
    rewrites the bytes the first wrote and reads them back."""
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    case, _ = _split_case(kind, 16, 128, sms, seed=11)
    _new_rows(case, kind, torch.Generator().manual_seed(11))
    dev = _to(case, cuda_device)
    sc = {n: dev.get(n) for n in ("k_scale", "v_scale", "k_new_scale",
                                  "v_new_scale")}
    args = [dev[n] for n in ("q", "k_pool", "v_pool", "k_new", "v_new",
                             "tables", "pos")]
    first = pa.paged_append_decode_attention(*args, 0, **sc)
    pools = dev["k_pool"].clone()
    again = pa.paged_append_decode_attention(*args, 0, **sc)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(pools, dev["k_pool"])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 1032])
def test_fused_append_narrow_copy_unit(cuda_device, hd):
    """New rows at an address 2 bytes past 16-byte alignment: the copy
    unit narrows to 2 bytes (K5's rule) and the rows are copied after
    the barrier instead of held from the prologue; still bit-equal to
    the pair, on the split walk and on the wide kernel."""
    gen = torch.Generator().manual_seed(hd + 2)
    L, B, W, BS, KV, group = 1, 4, 3, 16, 2, 4
    NB, tables, pos = _layout(B, W, BS, gen)
    case = {"q": torch.randn((B, KV * group, hd), generator=gen).to(
                torch.bfloat16),
            "k_pool": _rand((L, NB, BS, KV, hd), torch.bfloat16, gen),
            "v_pool": _rand((L, NB, BS, KV, hd), torch.bfloat16, gen),
            "tables": tables, "pos": pos}
    _new_rows(case, "bf16", gen)
    for n in ("k_new", "v_new"):
        buf = torch.empty(case[n].numel() + 1, dtype=torch.bfloat16,
                          device=cuda_device)
        case[n] = buf[1:].view(case[n].shape).copy_(case[n])
        assert case[n].data_ptr() % 16 == 2 and case[n].is_contiguous()
    _assert_fused_equals_pair(case, cuda_device, live=slice(None))


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
                                    (3, 200, 96), (3, 200, 256),
                                    (2, 72, 136), (2, 72, 264),
                                    (2, 48, 512), (2, 130, 64),
                                    (2, 130, 128), (1, 40, 712),
                                    (1, 40, 1032)])
def test_flash_kernels_match_plain(cuda_device, kind, causal, BH, T, D):
    """K1, K2, K3 and K4 each against its plain version on the same
    inputs (the backward ones on the plain forward's O and LSE).  The
    shapes stress the bf16 kernels' tiles (128 q rows in K1 and K3, 128
    kv rows and 64 q rows in K2 and K4, 128 / 64 kv rows in K3 at D 64 /
    128): 8 full tiles (T 1024), T under one tile (48), ragged over two
    (200, 130, 100, 72), head widths that run on the 64 and 128
    instantiations (16, 96), past them (136 to 512: the first design,
    its rows halved until its shared-memory plan fits: 16 bf16 rows for
    K2 / K4 at 512), and past the widest slice that fits (712 in bf16,
    1,032 in both: two column slices)."""
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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_split_repeats(cuda_device, D, causal):
    """K3's dQ and K4's dK and dV twice on the same inputs: bit-equal,
    each summed in one CTA's registers in a fixed order and written
    once."""
    q, k, v, do = (t.to(cuda_device) for t in _flash_inputs(
        4, 320, D, torch.bfloat16, seed=D + 1))
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    first = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))
    second = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
              *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("D", [256, 512, 1032])
@pytest.mark.parametrize("blocks", [(1024, 1024), (16, 16)])
def test_flash_attention_wide_head_on_the_card(cuda_device, blocks, D):
    """D 256 to 1,032, wider than the bf16 Hopper tiles (the reference
    computes any width; 1,032 is cut into two column slices in f32): the
    op launches K1 and K2 (or K3 + K4), takes no plain branch, and its
    forward and grads equal the CPU route's (the plain versions).  bf16
    at these widths is held kernel by kernel in
    `test_flash_kernels_match_plain`."""
    gen = torch.Generator().manual_seed(D + blocks[0])
    q, k, v, w = (torch.randn((2, 32, 2, D), generator=gen)
                  for _ in range(4))

    def run(device):
        x = [t.to(device).requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*x, True, *blocks)
        grads = torch.autograd.grad((out * w.to(device)).sum(), x)
        return [t.detach().cpu() for t in (out, *grads)]

    want = run("cpu")
    n0 = (fa.flash_attention.plain_dispatches, fa.flash_fwd.launches,
          fa.flash_bwd_fused.launches, fa.flash_bwd_dq.launches)
    got = run(cuda_device)
    fused = blocks[0] >= 32
    assert (fa.flash_attention.plain_dispatches, fa.flash_fwd.launches,
            fa.flash_bwd_fused.launches, fa.flash_bwd_dq.launches) == (
        n0[0], n0[1] + 1, n0[2] + int(fused), n0[3] + int(not fused))
    for g, w_ in zip(got, want):
        _assert_flash_close(g, w_, FLASH_TOL["f32"])


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((2, 16, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_fwd(q, q, q, True, 0.3)
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
                                   (130, 1032, 515), (70, 4096, 130)])
def test_xent_kernels_match_plain(cuda_device, kind, w_kind, N, E, V):
    """K7, K8 and K9 each against its plain version on the same inputs
    (K8 / K9 on the plain forward's lse); ragged N and V, E 128 to
    4,096 (E 1,032: wider than a bf16 K8 / K9 block holds, in two
    column slices, and not a multiple of 64)."""
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
@pytest.mark.parametrize("E", [768, 1032])
def test_xent_grads_repeat(cuda_device, E):
    """The bf16 K8 and K9 twice on the same inputs: bit-equal, since every
    output element is summed in one CTA's registers in a fixed order
    (E 768: one column slice, A resident; E 1,032: two slices, A
    streamed)."""
    from ray_tpu_torch.ops import xent_pallas as xp

    dev = [t.to(cuda_device) for t in _xent_inputs(
        200, E, 700, torch.bfloat16, torch.bfloat16, seed=E)]
    for fn in (xp.xent_dx, xp.xent_dw):
        first, second = fn(*dev), fn(*dev)
        torch.cuda.synchronize()
        assert torch.equal(first, second), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("kind,w_kind", [("bf16", "f32"), ("bf16", "bf16"),
                                         ("f32", "f32")])
@pytest.mark.parametrize("N,E,V", [(200, 128, 300), (77, 768, 1000),
                                   (130, 1032, 515)])
def test_xent_fwd_kernel_targets(cuda_device, kind, w_kind, N, E, V):
    """K7 against its plain version with targets at 0 and V - 1 and
    outside [0, V) on both sides (-1, V, V + 7: they match no column, so
    their target logit is 0); ragged N and V, E resident (128, 768) and
    streamed (1,032) in the bf16 kernel."""
    from ray_tpu_torch.ops import xent_pallas as xp

    x, w, tg, _ = _xent_inputs(N, E, V, DTYPES[kind], DTYPES[w_kind],
                               seed=N + E)
    tg[1], tg[2], tg[3] = V, V + 7, V - 1
    want = xp.xent_fwd_reference(x, w, tg)
    assert not bool(want[1][[1, 2, N // 2]].any())
    n0 = xp.xent_fwd.launches
    got = xp.xent_fwd(*[t.to(cuda_device) for t in (x, w, tg)])
    torch.cuda.synchronize()
    assert xp.xent_fwd.launches == n0 + 1
    for g, w_, name in zip(got, want, ("lse", "tgt")):
        assert g.dtype == torch.float32 and g.shape == w_.shape, name
        _assert_xent_close(g, w_, XENT_TOL[kind], name)
    assert not bool(got[1][[1, 2, N // 2]].cpu().any())


@pytest.mark.cuda
@pytest.mark.parametrize("E", [768, 1032])
def test_xent_fwd_repeats(cuda_device, E):
    """The bf16 K7 twice on the same inputs: bit-equal, since each row's
    (m, l, t) is summed in a fixed order (E 768: x resident; E 1,032:
    streamed)."""
    from ray_tpu_torch.ops import xent_pallas as xp

    dev = [t.to(cuda_device) for t in _xent_inputs(
        200, E, 700, torch.bfloat16, torch.bfloat16, seed=E)[:3]]
    first = xp.xent_fwd(*dev)
    second = xp.xent_fwd(*dev)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
