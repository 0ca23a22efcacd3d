"""Port parity: `ray_tpu_torch.ops.attention` against the JAX package's
`ray_tpu.ops.attention` on the CPU.

Each plain version (`*_reference`, the function the port's CUDA kernel
computes) is held against the Pallas builder it replaces, run in
interpret mode as `tests/test_ops.py` runs the kernels: `_build_fwd`
(K1), `_build_bwd_fused` (K2), `_build_bwd_dq` (K3), `_build_bwd_dkv`
(K4), causal and full, at square and rectangular blocks.  Then the
port's `flash_attention` forward and `torch.autograd.grad` against the
JAX `flash_attention(..., force_pallas=True)` and `jax.grad` on both
backward routes.  Inputs are seeded numpy (RT008), B 2, T 32-64, H 4,
D 16.

Tolerances: f32 at rtol/atol 1e-5 (the Pallas kernels walk blocks with
an online softmax, the plain versions take whole rows: the same sums in
another order).  bf16 at 2e-2, the reference's own bf16 tolerance
(`test_ops.py::test_flash_attention_bf16`): P is rounded to bf16
relative to the running max in the kernel and to the row max here.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.testing import pallas_kernel_support  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.parallel.ring_attention import (  # noqa: E402
    plain_attention, select_attention,
)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, H, D = 2, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pallas():
    ok, why = pallas_kernel_support("attention")
    if not ok:
        pytest.skip(f"Pallas flash-attention kernels unavailable in this "
                    f"JAX/Pallas environment: {why}")


def _arrays(n, shape, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=jnp.float32).astype(dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _folded(T, seed):
    """q, k, v, dO folded [BH, T, D] f32 numpy."""
    return _arrays(4, (B * H, T, D), seed)


def _jax_fwd(q, k, v, causal, bq, bk, dtype=jnp.float32):
    T = q.shape[1]
    call = jattn._build_fwd(causal, 1.0 / D ** 0.5, bq, bk, T // bk, True,
                            dtype)
    return call(_j(q, dtype), _j(k, dtype), _j(v, dtype))


# ----------------------------------------------------------------------
# plain versions vs the Pallas builders (interpret mode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(16, 32), (32, 16), (64, 64)])
def test_fwd_plain_matches_pallas_builder(pallas, causal, bq, bk):
    q, k, v, _ = _folded(64, seed=bq + bk + causal)
    o, lse = _jax_fwd(q, k, v, causal, bq, bk)
    to, tlse = tattn.flash_fwd_reference(_t(q), _t(k), _t(v), causal,
                                         1.0 / D ** 0.5)
    assert tlse.shape == lse.shape == (B * H, 64, 1)
    _close(to, o)
    _close(tlse, lse)


def test_fwd_plain_matches_pallas_builder_bf16(pallas):
    q, k, v, _ = _folded(64, seed=5)
    o, lse = _jax_fwd(q, k, v, True, 32, 32, jnp.bfloat16)
    bf = torch.bfloat16
    to, tlse = tattn.flash_fwd_reference(_t(q, bf), _t(k, bf), _t(v, bf),
                                         True, 1.0 / D ** 0.5)
    assert to.dtype == bf and tlse.dtype == torch.float32
    _close(to, o, BF16_TOL)
    _close(tlse, lse, BF16_TOL)


def _saved(q, k, v, causal):
    """O and LSE from the JAX forward at whole-sequence blocks."""
    T = q.shape[1]
    o, lse = _jax_fwd(q, k, v, causal, T, T)
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_fused_plain_matches_pallas_builder(pallas, causal):
    T = 32
    q, k, v, do = _folded(T, seed=11 + causal)
    o, lse = _saved(q, k, v, causal)
    call = jattn._build_bwd_fused(causal, 1.0 / D ** 0.5, T, True,
                                  jnp.float32)
    want = call(*map(_j, (q, k, v, do, lse, o)))
    got = tattn.flash_bwd_fused_reference(*map(_t, (q, k, v, do, lse, o)),
                                          causal, 1.0 / D ** 0.5)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(16, 32), (32, 16)])
def test_bwd_split_plain_matches_pallas_builders(pallas, causal, bq, bk):
    T = 64
    q, k, v, do = _folded(T, seed=bq * 3 + bk + causal)
    o, lse = _saved(q, k, v, causal)
    delta = (do * o).sum(axis=-1, keepdims=True)
    scale = 1.0 / D ** 0.5
    dq_call = jattn._build_bwd_dq(causal, scale, bq, bk, T // bk, True,
                                  jnp.float32)
    dkv_call = jattn._build_bwd_dkv(causal, scale, bq, bk, T // bq, True,
                                    jnp.float32)
    args = (q, k, v, do, lse, delta)
    want_dq = dq_call(*map(_j, args))
    want_dk, want_dv = dkv_call(*map(_j, args))
    targs = [_t(a) for a in args]
    _close(tattn.flash_bwd_dq_reference(*targs, causal, scale), want_dq)
    dk, dv = tattn.flash_bwd_dkv_reference(*targs, causal, scale)
    _close(dk, want_dk)
    _close(dv, want_dv)


# ----------------------------------------------------------------------
# the op: forward and grads against JAX's custom_vjp, both routes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("route,blocks", [("fused", (64, 64)),
                                          ("split", (16, 32)),
                                          ("split", (32, 16))])
def test_flash_attention_and_grads_match_jax(pallas, causal, route, blocks):
    T = 64 if route == "split" else 32
    q, k, v, w = _arrays(4, (B, T, H, D), seed=T + causal + blocks[0])
    bq, bk = blocks

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal, bq, bk, True)
        return jnp.sum(out * _j(w)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    n0 = tattn.flash_attention.plain_dispatches
    out = tattn.flash_attention(tq, tk, tv, causal, bq, bk)
    grads = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    assert tattn.flash_attention.plain_dispatches == n0
    assert out.shape == (B, T, H, D)
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


def test_routes_pick_the_reference_kernels(monkeypatch):
    """Blocks covering T take K2; any other supported block shape takes
    K3 + K4; the route choice sees min(block, T)."""
    calls = []
    for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(tattn, name)
        monkeypatch.setattr(
            tattn, name,
            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    q, k, v = (_t(a).requires_grad_(True)
               for a in _arrays(3, (1, 32, 2, 8), seed=3))
    for blocks in ((1024, 1024), (32, 32), (16, 32)):
        out = tattn.flash_attention(q, k, v, True, *blocks)
        torch.autograd.grad(out.sum(), (q, k, v))
    assert calls == ["flash_bwd_fused", "flash_bwd_fused", "flash_bwd_dq",
                     "flash_bwd_dkv"]


def test_unsupported_shapes_dispatch_to_plain_attention():
    """T not divisible by the block or D % 8: plain attention, counted,
    equal to the JAX op's own fallback."""
    q, k, v = _arrays(3, (B, 60, H, 12), seed=7)
    n0 = tattn.flash_attention.plain_dispatches
    got = tattn.flash_attention(_t(q), _t(k), _t(v), True, 16, 16)
    assert tattn.flash_attention.plain_dispatches == n0 + 1
    want = jattn.flash_attention(_j(q), _j(k), _j(v), True, 16, 16)
    _close(got, want)
    _close(got, plain_attention(_t(q), _t(k), _t(v), causal=True))


@pytest.mark.parametrize("T,D,bq,bk", [(64, 128, 64, 64), (64, 256, 64, 64),
                                       (64, 264, 64, 64), (64, 12, 64, 64),
                                       (60, 64, 16, 16), (64, 712, 64, 64),
                                       (64, 1032, 64, 64)])
def test_supported_matches_the_reference(T, D, bq, bk):
    """The op refuses what the reference's `_supported` refuses, and no
    more: no bound on the head width (the card's kernels cut a wide head
    into column slices)."""
    assert tattn._supported(T, D, bq, bk) is jattn._supported(T, D, bq, bk)


def test_default_blocks_take_the_split_route_past_1024(monkeypatch):
    """At T 2,048 the default blocks (1,024) do not cover T: the op takes
    K3 + K4, as the reference's `_bwd` does, and no plain dispatch."""
    calls = []
    for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        real = getattr(tattn, name)
        monkeypatch.setattr(
            tattn, name,
            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    q, k, v = (_t(a).requires_grad_(True)
               for a in _arrays(3, (1, 2048, 1, 8), seed=13))
    n0 = tattn.flash_attention.plain_dispatches
    out = tattn.flash_attention(q, k, v)
    torch.autograd.grad(out.sum(), (q, k, v))
    assert tattn.flash_attention.plain_dispatches == n0
    assert calls == ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]


def test_default_blocks_split_route_matches_jax(pallas):
    """The op at T 2,048 with the default blocks (B 1, H 1, D 8, f32),
    forward and grads, against JAX's `flash_attention` on its split
    route (Pallas in interpret mode, blocks of 1,024)."""
    q, k, v, w = _arrays(4, (1, 2048, 1, 8), seed=17)

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, True, 1024, 1024, True)
        return jnp.sum(out * _j(w)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [712, 1032])
def test_kernel_checks_take_any_head_width(monkeypatch, dtype, D):
    """The CUDA wrappers' argument checks take heads past the first
    design's widest tile (704 in bf16, 1,024 in f32): the kernels cut
    them into column slices.  D % 8 != 0 is still refused there, and the
    op sends it to `plain_attention`, as the reference does.  (The meta
    device stands in for the card.)"""
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    q = torch.zeros((2, 16, D), device="meta", dtype=dtype)
    lse = torch.zeros((2, 16, 1), device="meta")
    assert tattn._check(q, k=q, v=q, dout=q, lse=lse, delta=lse) == (2, 16, D)
    with pytest.raises(ValueError, match="head width"):
        tattn._check(torch.zeros((2, 16, D + 4), device="meta", dtype=dtype))
    x = _t(_arrays(1, (1, 16, 1, D + 4), seed=D)[0], dtype)
    n0 = tattn.flash_attention.plain_dispatches
    got = tattn.flash_attention(x, x, x, True, 16, 16)
    assert tattn.flash_attention.plain_dispatches == n0 + 1
    _close(got, plain_attention(x, x, x, causal=True).float())


def test_select_attention_flash_is_the_op():
    q, k, v = (_t(a) for a in _arrays(3, (1, 16, 2, 8), seed=9))
    n0 = tattn.flash_attention.plain_dispatches
    got = select_attention("flash", q, k, v)
    assert tattn.flash_attention.plain_dispatches == n0
    _close(got, tattn.flash_attention(q, k, v, True))
    _close(got, plain_attention(q, k, v, causal=True))


def test_wrappers_refuse_cuda_work_they_cannot_do():
    """On a non-CPU, non-CUDA device the wrappers raise: no silent
    fallback to the plain version (the meta device stands in for a
    card here)."""
    q = torch.zeros((2, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_fwd(q, q, q, True, 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_bwd_dq(q, q, q, q, q[..., :1], q[..., :1], True, 0.3)
    assert tattn.flash_fwd.launches == 0
