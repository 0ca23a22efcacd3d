"""Port parity: `ray_tpu_torch.ops.paged_attention` against the JAX
package's `ray_tpu.ops.paged_attention`.

The JAX side runs its Pallas kernels the way its own tests run them on
the CPU (interpret mode, the default off-TPU); the port's wrappers
take their plain PyTorch versions for CPU tensors.  Inputs are made
with seeded numpy and handed to both (RT008).  Tolerances: int8
payloads and appended pools bit-equal; scales rtol 1e-6; attention
f32 1e-5 (float rounding of a blockwise vs a dense softmax), bf16 and
int8 2e-2 (the reference's own, tests/test_paged_attention.py:78-79).
The CUDA kernels themselves are held against the plain versions on the
card by `tests/test_torch_cuda_kernels.py` and by `chip_smoke.py`.
"""

import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


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


def _np(t):
    return t.detach().cpu().float().numpy()


def _bits(t):
    """Raw bits of a torch tensor for bit-equality checks."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ----------------------------------------------------------------------
# int8 helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_quantize_int8_matches_jax(axis):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    x[1, 2, :] = 0.0  # a zero slice along the last axis
    x[:, 3, 5] = 0.0  # ... and along the first
    qj, sj = jpa.quantize_int8(jnp.asarray(x), axis=axis)
    qt, st = tpa.quantize_int8(torch.from_numpy(x), axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6,
                               atol=0)
    dj = jpa.dequantize_int8(qj, sj, jnp.float32, axis=axis)
    dt = tpa.dequantize_int8(qt, st, torch.float32, axis=axis)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=0)
    # requantizing a dequantized payload is idempotent
    q2, s2 = tpa.quantize_int8(dt, axis=axis)
    np.testing.assert_array_equal(q2.numpy(), qt.numpy())
    np.testing.assert_allclose(s2.numpy(), st.numpy(), rtol=1e-6, atol=0)


def test_quantize_int8_rounds_half_to_even():
    # 127 * x / max|x| lands exactly on .5 for these values
    x = torch.tensor([[254.0, 1.0, 3.0, -5.0]])
    q, s = tpa.quantize_int8(x)
    qj, _ = jpa.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert q.tolist() == [[127, 0, 2, -2]] and float(s[0]) == 2.0


# ----------------------------------------------------------------------
# K5: paged KV append
# ----------------------------------------------------------------------
def _append_inputs(kind, seed=11):
    """Pools + a shuffled table; ragged positions, one row past the
    table's reach, one idle row parked on the scratch block."""
    rng = np.random.default_rng(seed)
    L, B, W, BS, KV, hd = 2, 5, 3, 4, 2, 8
    NB = 1 + B * W
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    tables = tables.astype(np.int32)
    pos = np.asarray([0, 5, W * BS + 2, 11, 3], np.int32)  # row 2 overshoots
    tables[4] = 0  # idle row
    if kind == "int8":
        def pool():
            return rng.integers(-127, 128, (L, NB, BS, KV, hd)).astype(
                np.int8)

        def rows():
            return rng.integers(-127, 128, (B, KV, hd)).astype(np.int8)
    else:
        def pool():
            return np.asarray(jnp.asarray(rng.standard_normal(
                (L, NB, BS, KV, hd)).astype(np.float32), JDT[kind]))

        def rows():
            return np.asarray(jnp.asarray(rng.standard_normal(
                (B, KV, hd)).astype(np.float32), JDT[kind]))
    arrs = {"k_pool": pool(), "v_pool": pool(), "k_new": rows(),
            "v_new": rows(), "tables": tables, "pos": pos}
    if kind == "int8":
        arrs.update(
            k_scale=rng.random((L, NB, BS, KV)).astype(np.float32),
            v_scale=rng.random((L, NB, BS, KV)).astype(np.float32),
            k_new_scale=rng.random((B, KV)).astype(np.float32),
            v_new_scale=rng.random((B, KV)).astype(np.float32),
        )
    return arrs


def _append_kwargs(arrs, conv):
    return {k: conv(arrs[k]) for k in ("k_scale", "v_scale", "k_new_scale",
                                       "v_new_scale") if k in arrs}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layer", [0, 1])
def test_append_plain_matches_jax_kernel(kind, layer):
    """Bit-equal pools (and scales) outside the scratch block; the
    overshooting row writes nothing."""
    arrs = _append_inputs(kind)
    names = ("k_pool", "v_pool", "k_new", "v_new", "tables", "pos")
    want = jpa.paged_kv_append(
        *[jnp.asarray(arrs[n]) for n in names], layer,
        **_append_kwargs(arrs, jnp.asarray),
    )
    got = tpa.paged_kv_append(*[_t(arrs[n]) for n in names], layer,
                              **_append_kwargs(arrs, _t))
    assert len(got) == len(want) == (4 if kind == "int8" else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g)[:, 1:], _jbits(w)[:, 1:])
    # the overshooting row (2) left every one of its blocks untouched
    for blk in arrs["tables"][2]:
        np.testing.assert_array_equal(_bits(got[0])[layer, blk],
                                      _jbits(arrs["k_pool"])[layer, blk])


# ----------------------------------------------------------------------
# K6: paged decode attention
# ----------------------------------------------------------------------
def _attention_inputs(kind, seed=7):
    """Ragged positions (partial last blocks, one row past the table's
    reach), shuffled non-contiguous tables, GQA (H=4 over KV=2)."""
    rng = np.random.default_rng(seed)
    L, B, W, BS, KV, H, hd = 2, 5, 3, 4, 2, 4, 16
    NB = 1 + B * W
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    pos = np.asarray([0, 3, 7, 10, W * BS + 5], np.int32)
    q_dt = jnp.float32 if kind == "f32" else jnp.bfloat16
    q = np.asarray(jnp.asarray(
        rng.standard_normal((B, H, hd)).astype(np.float32), q_dt))
    if kind == "int8":
        kp = rng.integers(-127, 128, (L, NB, BS, KV, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (L, NB, BS, KV, hd)).astype(np.int8)
        scales = {"k_scale": (rng.random((L, NB, BS, KV)) * 0.05).astype(
                      np.float32),
                  "v_scale": (rng.random((L, NB, BS, KV)) * 0.05).astype(
                      np.float32)}
    else:
        kp, vp = (np.asarray(jnp.asarray(rng.standard_normal(
            (L, NB, BS, KV, hd)).astype(np.float32), q_dt))
            for _ in range(2))
        scales = {}
    return q, kp, vp, tables.astype(np.int32), pos, scales


@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2),
                                      ("int8", 2e-2)])
@pytest.mark.parametrize("layer", [0, 1])
def test_attention_plain_matches_jax_kernel(kind, tol, layer):
    q, kp, vp, tables, pos, scales = _attention_inputs(kind)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), layer,
        **{k: jnp.asarray(v) for k, v in scales.items()},
    )
    got = tpa.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), layer,
        **{k: _t(v) for k, v in scales.items()},
    )
    assert got.shape == tuple(want.shape)
    assert got.dtype == (torch.float32 if kind == "f32" else torch.bfloat16)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2),
                                      ("int8", 2e-2)])
def test_attention_plain_matches_jax_kernel_on_idle_rows(kind, tol):
    """Rows with pos < 0 attend to nothing: the Pallas kernel skips every
    block and returns zeros (l == 0 -> 1), and so does the plain version
    (a softmax over an all-masked row would average V instead)."""
    q, kp, vp, tables, pos, scales = _attention_inputs(kind, seed=9)
    pos[[0, 3]] = [-1, -7]
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), 1,
        **{k: jnp.asarray(v) for k, v in scales.items()},
    )
    got = tpa.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), 1,
        **{k: _t(v) for k, v in scales.items()},
    )
    assert not np.asarray(want, np.float32)[[0, 3]].any()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sms", [132, 78, 1])
def test_split_plan_covers_every_block_once(sms):
    """K6's host-side cut of the block tables: for W 1 to 128 and B 1 to
    64, every block of a row falls in exactly one split, no split is
    empty by construction and the split count stays in [1,
    _MAX_SPLITS]; tables past 65,536 blocks (64 splits of the 1,024
    entries the kernel stages) too, with more blocks a split.  The plan
    takes shapes and the SM count only (no positions, which live on the
    device), so equal shapes give equal plans."""
    for B in (1, 2, 3, 8, 17, 32, 64):
        for W in [*range(1, 129), 65536, 65540, 200003]:
            for KV, H, BS in ((8, 32, 16), (2, 4, 128), (1, 24, 1)):
                splits, per = tpa.split_plan(B, H, KV, W, BS, sms)
                assert 1 <= splits <= tpa._MAX_SPLITS
                assert 1 <= per <= W
                owner = np.zeros(W, np.int64)
                for s in range(splits):
                    run = np.arange(s * per, min((s + 1) * per, W))
                    assert run.size > 0
                    owner[run] += 1
                assert (owner == 1).all(), (B, W, KV, H, BS, splits, per)
                assert tpa.split_plan(B, H, KV, W, BS, sms) == (splits, per)
    assert list(inspect.signature(tpa.split_plan).parameters) == [
        "B", "H", "KV", "W", "BS", "sms"]


# ----------------------------------------------------------------------
# the wrappers' routing and launch counters
# ----------------------------------------------------------------------
def test_wrappers_route_cpu_tensors_to_plain_and_count_no_launch():
    """CPU tensors take the plain version (same result as calling it),
    and the launch counters move only when a kernel launches."""
    arrs = _append_inputs("bf16")
    names = ("k_pool", "v_pool", "k_new", "v_new", "tables", "pos")
    n_app = tpa.paged_kv_append.launches
    n_att = tpa.paged_decode_attention.launches
    n_fused = tpa.paged_append_decode_attention.launches
    got = tpa.paged_kv_append(*[_t(arrs[n]) for n in names], 1)
    ref = tpa.paged_kv_append_reference(*[_t(arrs[n]) for n in names], 1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    q, kp, vp, tables, pos, _ = _attention_inputs("bf16")
    args = (_t(q), _t(kp), _t(vp), _t(tables), _t(pos), 0)
    assert torch.equal(tpa.paged_decode_attention(*args),
                       tpa.paged_decode_attention_reference(*args))
    # the fused op: output and pools as its plain version leaves them
    rng = np.random.default_rng(5)
    new = [_t(np.asarray(jnp.asarray(rng.standard_normal(
        (5, 2, 16)).astype(np.float32), jnp.bfloat16))) for _ in range(2)]
    fused = [_t(a) for a in (kp, vp)]
    plain = [_t(a) for a in (kp, vp)]
    out = tpa.paged_append_decode_attention(
        _t(q), *fused, *new, _t(tables), _t(pos), 0)
    want = tpa.paged_append_decode_attention_reference(
        _t(q), *plain, *new, _t(tables), _t(pos), 0)
    assert torch.equal(out, want)
    for f, p in zip(fused, plain):
        assert torch.equal(f, p)
    assert tpa.paged_kv_append.launches == n_app
    assert tpa.paged_decode_attention.launches == n_att
    assert tpa.paged_append_decode_attention.launches == n_fused


def test_non_cpu_tensors_never_fall_back_to_plain():
    """A tensor off the CPU goes to the kernel path, which raises for
    anything that is not a CUDA tensor — no silent plain fallback, and
    no launch counted."""
    n_app = tpa.paged_kv_append.launches
    n_att = tpa.paged_decode_attention.launches
    n_fused = tpa.paged_append_decode_attention.launches

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    pool = meta(2, 5, 4, 2, 8)
    tables = meta(2, 2, dtype=torch.int32)
    pos = meta(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_kv_append(pool, pool, meta(2, 2, 8), meta(2, 2, 8),
                            tables, pos, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(meta(2, 4, 8), pool, pool, tables, pos, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_append_decode_attention(meta(2, 4, 8), pool, pool,
                                          meta(2, 2, 8), meta(2, 2, 8),
                                          tables, pos, 0)
    assert tpa.paged_kv_append.launches == n_app
    assert tpa.paged_decode_attention.launches == n_att
    assert tpa.paged_append_decode_attention.launches == n_fused


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel library builds from source at first use; with no
    compiler reachable that is an error, never a fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os, "access", lambda *_a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention")
    assert not any(tmp_path.iterdir())


def test_library_path_tracks_sources_and_flags(monkeypatch):
    p0 = _build.library_path("paged_attention")
    assert p0.parent == _build.BUILD_DIR and p0.suffix == ".so"
    assert p0 == _build.library_path("paged_attention")  # stable
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("paged_attention") != p0
