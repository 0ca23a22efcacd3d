"""Port parity: `paged_append_decode_attention` (the decode step's append
and attention as one op) against the JAX package's `paged_kv_append`
followed by `paged_decode_attention`.

The JAX pair runs its Pallas kernels the way its own tests run them on
the CPU (interpret mode); the port's op takes its plain version for CPU
tensors.  Inputs are made with seeded numpy and handed to both (RT008).
Tolerances, as `tests/test_torch_paged_attention.py` holds each half:
pools (payloads and int8 scales) bit-equal outside scratch block 0;
the attention output f32 1e-5 (a blockwise against a dense softmax),
bf16 and int8 2e-2 (the reference's own, tests/test_paged_attention.py:
78-79).  The CUDA kernel is held bit-equal to K5 then K6 on the card by
`tests/test_torch_cuda_kernels.py` and by `chip_smoke.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
L, W, BS, KV, H, HD = 3, 3, 4, 2, 4, 16
# row 0 idle (pos -1, parked on the scratch block as the engine parks an
# idle slot), a block's first column, the table's last column, one past
# the table's reach (writes nothing), a mid-block column, column 0
POS = [-1, 4, W * BS - 1, W * BS, 6, 0]
NAMES = ("q", "k_pool", "v_pool", "k_new", "v_new", "tables", "pos")
SCALES = ("k_scale", "v_scale", "k_new_scale", "v_new_scale")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this file from crowding the timing-sensitive tests that other
    workers of a parallel run execute meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """numpy / JAX array -> CPU torch tensor, bit for bit (bf16 too)."""
    return params_from_numpy({"x": np.asarray(a)}, "cpu")["x"]


def _bits(a):
    """Raw bits of a torch tensor or an array, for bit-equality."""
    if torch.is_tensor(a):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _inputs(kind, seed=13, pos=POS):
    """Seeded pools behind a shuffled table, new rows, q (bf16 over int8
    pools); row 0's table is all scratch."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    NB = 1 + B * W
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W).astype(np.int32)
    tables[0] = 0
    q_dt = jnp.float32 if kind == "f32" else jnp.bfloat16

    def real(shape, dt):
        return np.asarray(jnp.asarray(
            rng.standard_normal(shape).astype(np.float32), dt))

    if kind == "int8":
        def payload(shape):
            return rng.integers(-127, 128, shape).astype(np.int8)
    else:
        def payload(shape):
            return real(shape, JDT[kind])
    arrs = {"q": real((B, H, HD), q_dt),
            "k_pool": payload((L, NB, BS, KV, HD)),
            "v_pool": payload((L, NB, BS, KV, HD)),
            "k_new": payload((B, KV, HD)), "v_new": payload((B, KV, HD)),
            "tables": tables, "pos": np.asarray(pos, np.int32)}
    if kind == "int8":
        for name, shape in (("k_scale", (L, NB, BS, KV)),
                            ("v_scale", (L, NB, BS, KV)),
                            ("k_new_scale", (B, KV)),
                            ("v_new_scale", (B, KV))):
            arrs[name] = (rng.random(shape) * 0.05).astype(np.float32)
    return arrs


def _torch_args(arrs):
    return ([_t(arrs[n]) for n in NAMES],
            {n: _t(arrs[n]) for n in SCALES if n in arrs})


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layer", [0, L - 1])
def test_fused_plain_matches_jax_pair(kind, layer):
    """The op's output against JAX's append then attention, and the
    pools (int8 scales too) it updated in place, bit-equal outside the
    scratch block."""
    arrs = _inputs(kind, seed=13 + layer)
    j = {n: jnp.asarray(a) for n, a in arrs.items()}
    jsc = {n: j[n] for n in SCALES if n in j}
    pools = jpa.paged_kv_append(j["k_pool"], j["v_pool"], j["k_new"],
                                j["v_new"], j["tables"], j["pos"], layer,
                                **jsc)
    want = jpa.paged_decode_attention(
        j["q"], pools[0], pools[1], j["tables"], j["pos"], layer,
        **({"k_scale": pools[2], "v_scale": pools[3]}
           if kind == "int8" else {}))
    args, kw = _torch_args(arrs)
    got = tpa.paged_append_decode_attention(*args, layer, **kw)
    assert got.shape == tuple(want.shape) == (len(POS), H, HD)
    assert got.dtype == (torch.float32 if kind == "f32" else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[kind], atol=TOL[kind])
    assert not got[0].any()  # the idle row attends to nothing
    updated = [args[1], args[2]] + ([kw["k_scale"], kw["v_scale"]]
                                    if kind == "int8" else [])
    for g, w in zip(updated, pools):
        np.testing.assert_array_equal(_bits(g)[:, 1:], _bits(w)[:, 1:])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_fused_plain_is_the_pair_and_guards_positions(kind):
    """Within the port: the op equals `paged_kv_append` then
    `paged_decode_attention` bit for bit (output and every pool), and
    a position below 0 or past the table's reach writes nothing, here
    on a row whose table holds real blocks."""
    arrs = _inputs(kind, seed=29)
    arrs["tables"][0] = arrs["tables"][3][::-1]  # pos -1 on real blocks
    args, kw = _torch_args(arrs)
    got = tpa.paged_append_decode_attention(*args, 1, **kw)
    p_args, p_kw = _torch_args(arrs)
    tpa.paged_kv_append(*p_args[1:], 1, **p_kw)
    want = tpa.paged_decode_attention(
        p_args[0], p_args[1], p_args[2], p_args[5], p_args[6], 1,
        k_scale=p_kw.get("k_scale"), v_scale=p_kw.get("v_scale"))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pools = [args[1], args[2]] + [kw[n] for n in ("k_scale", "v_scale")
                                  if n in kw]
    p_pools = [p_args[1], p_args[2]] + [p_kw[n] for n in ("k_scale",
                                                          "v_scale")
                                        if n in p_kw]
    for g, w in zip(pools, p_pools, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # rows 0 (pos -1) and 3 (pos W*BS) share blocks and wrote none of them
    for blk in arrs["tables"][3]:
        np.testing.assert_array_equal(_bits(args[1])[1, blk],
                                      _bits(arrs["k_pool"])[1, blk])
        np.testing.assert_array_equal(_bits(args[2])[1, blk],
                                      _bits(arrs["v_pool"])[1, blk])


def test_decode_step_paged_issues_one_op_a_layer(monkeypatch):
    """`decode_step_paged` calls the fused op once a layer and neither
    half on its own (the card then issues one kernel launch a layer for
    append and attention together); model-dtype and int8 pools alike."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=64),
                              dtype=torch.float32)
    params = tllama.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    B, BSz, Wd = 3, 4, 4
    NB = 1 + B * Wd
    shape = (cfg.n_layers, NB, BSz, cfg.n_kv_heads, cfg.head_dim)
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB)).reshape(
        B, Wd).astype(np.int32))
    pos = torch.tensor([3, 7, 0], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
    calls = []
    fused = tpa.paged_append_decode_attention

    def counting(*a, **k):
        calls.append(int(a[7]))
        return fused(*a, **k)

    def refuse(*_a, **_k):
        raise AssertionError("the decode step called a half on its own")

    monkeypatch.setattr(tpa, "paged_append_decode_attention", counting)
    monkeypatch.setattr(tpa, "paged_kv_append", refuse)
    monkeypatch.setattr(tpa, "paged_decode_attention", refuse)
    for int8 in (False, True):
        calls.clear()
        pool = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
        if int8:
            kq, ks = tpa.quantize_int8(pool)
            out = tllama.decode_step_paged(
                cfg, params, tok, kq, kq.clone(), tables, pos,
                kv_scales=(ks, ks.clone()))
        else:
            out = tllama.decode_step_paged(cfg, params, tok, pool,
                                           pool.clone(), tables, pos)
        assert calls == list(range(cfg.n_layers))
        assert out[0].shape == (B, cfg.vocab_size)
        assert bool(torch.isfinite(out[0]).all())
