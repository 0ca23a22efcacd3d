"""Port parity: `ray_tpu_torch.ops.xent_pallas` and `ops.xent` against the
JAX package's `ray_tpu.ops.xent_pallas` and `ray_tpu.ops.xent` on the
CPU.

Each plain version (`*_reference`, the function the port's CUDA kernel
computes) is held against the Pallas kernel it replaces, run in
interpret mode as `tests/test_xent_pallas.py` runs it: K7's against
`_lse_tgt`, K8's and K9's against the dx and dw of `_bwd`.  Then the
port's `pallas_cross_entropy` and `fused_cross_entropy` (loss and
`torch.autograd.grad` for x and w) against JAX's ops and
`reference_cross_entropy` under `jax.value_and_grad`.  Inputs are
seeded numpy (RT008) at the reference test's shapes: exact tiling, and
row and vocab padding.

Tolerances: f32 at rtol/atol 1e-5 (the Pallas kernels walk vocab
blocks with an online logsumexp and sum dx / dw block by block, the
plain versions take whole rows: the same sums in another order).  bf16
at 2e-2, the reference's own (`test_xent_pallas.py::test_bf16_inputs`).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import xent as jxent  # noqa: E402
from ray_tpu.ops import xent_pallas as jxp  # noqa: E402
from ray_tpu.testing import pallas_kernel_support  # noqa: E402
from ray_tpu_torch.ops import fused_cross_entropy, pallas_cross_entropy  # noqa: E402
from ray_tpu_torch.ops import xent as txent  # noqa: E402
from ray_tpu_torch.ops import xent_pallas as txp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SHAPES = [
    (256, 128, 384, 128, 128),     # exact tiling
    (200, 128, 300, 128, 128),     # row AND vocab padding
    (512, 256, 1000, 256, 256),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pallas():
    ok, why = pallas_kernel_support("xent")
    if not ok:
        pytest.skip(f"Pallas xent kernel unavailable in this JAX/Pallas "
                    f"environment: {why}")


def _inputs(n, e, v, seed):
    """x [n, e] * 0.5, w [v, e] * 0.1 (f32 numpy), targets [n] int32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, e)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((v, e)) * 0.1).astype(np.float32)
    tg = rng.integers(0, v, size=n).astype(np.int32)
    return x, w, tg


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _jax_lse_tgt(x, w, tg, bn, bv, dtype=jnp.float32):
    lse, tgt, _ = jxp._lse_tgt(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                               jnp.asarray(tg), bn, bv)
    return lse, tgt


# ----------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,e,v,bn,bv", SHAPES)
def test_fwd_plain_matches_pallas(pallas, n, e, v, bn, bv):
    """K7: lse and target logit of every real row."""
    x, w, tg = _inputs(n, e, v, seed=n + v)
    lse, tgt = _jax_lse_tgt(x, w, tg, bn, bv)
    got_lse, got_tgt = txp.xent_fwd(_t(x), _t(w), torch.from_numpy(tg))
    assert got_lse.shape == (n, 1) and got_tgt.shape == (n, 1)
    assert got_lse.dtype == torch.float32
    _close(got_lse, np.asarray(lse)[:n])
    _close(got_tgt, np.asarray(tgt)[:n])


@pytest.mark.parametrize("n,e,v,bn,bv", SHAPES)
def test_dx_dw_plain_match_pallas_bwd(pallas, n, e, v, bn, bv):
    """K8 / K9: the unscaled dx and dw, scaled by 1 / N, against `_bwd`'s
    outputs on the same saved lse."""
    x, w, tg = _inputs(n, e, v, seed=n + e)
    lse, _ = _jax_lse_tgt(x, w, tg, bn, bv)
    jdx, jdw, _ = jxp._bwd(bn, bv, (jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(tg), lse),
                           jnp.float32(1.0))
    lse_t = _t(np.asarray(lse)[:n])
    args = (_t(x), _t(w), torch.from_numpy(tg), lse_t)
    dx, dw = txp.xent_dx(*args), txp.xent_dw(*args)
    assert dx.shape == (n, e) and dw.shape == (v, e)
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx / n, jdx)
    _close(dw / n, jdw)


def test_plain_versions_take_out_of_range_targets_as_no_column():
    """A target outside [0, V) contributes a target logit of 0 and no
    one-hot, as the Pallas kernels' `cols == tg` on rows padded with
    -1; the rows' lse and softmax are untouched."""
    x, w, tg = _inputs(12, 16, 20, seed=3)
    bad = tg.copy()
    bad[[2, 7]] = (-1, 20)
    xt, wt = _t(x), _t(w)
    lse, tgt = txp.xent_fwd_reference(xt, wt, torch.from_numpy(bad))
    lse0, tgt0 = txp.xent_fwd_reference(xt, wt, torch.from_numpy(tg))
    _close(lse, lse0.numpy())
    assert float(tgt[2, 0]) == 0.0 and float(tgt[7, 0]) == 0.0
    keep = [i for i in range(12) if i not in (2, 7)]
    _close(tgt[keep], tgt0[keep].numpy())
    dx = txp.xent_dx_reference(xt, wt, torch.from_numpy(bad), lse)
    p = torch.softmax(xt @ wt.T, dim=-1)
    _close(dx[2], (p[2] @ wt).numpy())


# ----------------------------------------------------------------------
# the ops vs JAX
# ----------------------------------------------------------------------
def _torch_value_and_grad(fn, x, w, tg, dtype=torch.float32):
    xt = _t(x, dtype).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    loss = fn(xt, wt, torch.from_numpy(tg))
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    return loss, dx, dw


@pytest.mark.parametrize("n,e,v,bn,bv", SHAPES)
def test_pallas_cross_entropy_matches_jax(pallas, n, e, v, bn, bv):
    """Loss and grads of the port's op against JAX's op and its
    materialising oracle; the port's oracle against JAX's."""
    x, w, tg = _inputs(n, e, v, seed=v)
    jx, jw, jtg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(tg)
    j_loss, (j_dx, j_dw) = jax.value_and_grad(
        lambda a, b: jxp.pallas_cross_entropy(a, b, jtg, bn, bv),
        argnums=(0, 1))(jx, jw)
    r_loss, (r_dx, r_dw) = jax.value_and_grad(
        jxp.reference_cross_entropy, argnums=(0, 1))(jx, jw, jtg)
    loss, dx, dw = _torch_value_and_grad(
        lambda a, b, t: pallas_cross_entropy(a, b, t, bn, bv), x, w, tg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    for want_loss, want_dx, want_dw in ((j_loss, j_dx, j_dw),
                                        (r_loss, r_dx, r_dw)):
        _close(loss, want_loss)
        _close(dx, want_dx)
        _close(dw, want_dw)
    ref = _torch_value_and_grad(txp.reference_cross_entropy, x, w, tg)
    for got, want in zip(ref, (r_loss, r_dx, r_dw)):
        _close(got, want)


def test_pallas_cross_entropy_bf16_inputs(pallas):
    """bf16 x with the f32 master w: the loss at the reference's bf16
    tolerance, dx back in bf16 and dw in f32, both close to JAX's."""
    n, e, v = 256, 128, 512
    x, w, tg = _inputs(n, e, v, seed=1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw, jtg = jnp.asarray(w), jnp.asarray(tg)
    j_loss, (j_dx, j_dw) = jax.value_and_grad(
        lambda a, b: jxp.pallas_cross_entropy(a, b, jtg, 128, 128),
        argnums=(0, 1))(jx, jw)
    ref = jxp.reference_cross_entropy(jx, jw, jtg)
    loss, dx, dw = _torch_value_and_grad(
        lambda a, b, t: pallas_cross_entropy(a, b, t, 128, 128), x, w, tg,
        torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert bool(torch.isfinite(dx.float()).all())
    assert bool(torch.isfinite(dw).all())
    _close(loss, ref, BF16_TOL)
    _close(loss, j_loss, BF16_TOL)
    _close(dx, np.asarray(j_dx.astype(jnp.float32)), BF16_TOL)
    _close(dw, j_dw, BF16_TOL)
    # K7's plain version in bf16 against the Pallas kernel's
    lse, tgt = _jax_lse_tgt(x, w, tg, 128, 128, jnp.bfloat16)
    got_lse, got_tgt = txp.xent_fwd(_t(x, torch.bfloat16), _t(w),
                                    torch.from_numpy(tg))
    _close(got_lse, lse, BF16_TOL)
    _close(got_tgt, tgt, BF16_TOL)


@pytest.mark.parametrize("n,e,v,chunk", [(256, 128, 384, 16),
                                         (200, 128, 300, 13),
                                         (200, 128, 300, 2048)])
def test_fused_cross_entropy_matches_jax(n, e, v, chunk):
    """The row-chunked op, value and grads; chunk 13 does not divide
    N = 200 and falls back to the divisor 10, as `_pick_chunk` does."""
    x, w, tg = _inputs(n, e, v, seed=chunk)
    jtg = jnp.asarray(tg)
    j_loss, (j_dx, j_dw) = jax.value_and_grad(
        lambda a, b: jxent.fused_cross_entropy(a, b, jtg, chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    loss, dx, dw = _torch_value_and_grad(
        lambda a, b, t: fused_cross_entropy(a, b, t, chunk), x, w, tg)
    _close(loss, j_loss)
    _close(dx, j_dx)
    _close(dw, j_dw)


def test_fused_cross_entropy_bf16_matches_jax():
    n, e, v = 128, 64, 256
    x, w, tg = _inputs(n, e, v, seed=11)
    jtg = jnp.asarray(tg)
    j_loss, (j_dx, j_dw) = jax.value_and_grad(
        lambda a, b: jxent.fused_cross_entropy(a, b, jtg, 32),
        argnums=(0, 1))(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    loss, dx, dw = _torch_value_and_grad(
        lambda a, b, t: fused_cross_entropy(a, b, t, 32), x, w, tg,
        torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _close(loss, j_loss, BF16_TOL)
    _close(dx, np.asarray(j_dx.astype(jnp.float32)), BF16_TOL)
    _close(dw, j_dw, BF16_TOL)


@pytest.mark.parametrize("n,req", [(200, 13), (256, 16), (7, 2048),
                                   (97, 10)])
def test_pick_chunk_matches_jax(n, req):
    assert txent._pick_chunk(n, req) == jxent._pick_chunk(n, req)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the op runs without the kernel library and counts no
    launch."""
    x, w, tg = _inputs(16, 8, 24, seed=5)
    n0 = (txp.xent_fwd.launches, txp.xent_dx.launches, txp.xent_dw.launches)
    loss, dx, dw = _torch_value_and_grad(pallas_cross_entropy, x, w, tg)
    assert (txp.xent_fwd.launches, txp.xent_dx.launches,
            txp.xent_dw.launches) == n0
    want = _torch_value_and_grad(txp.reference_cross_entropy, x, w, tg)
    for got, ref in zip((loss, dx, dw), want):
        _close(got, ref.detach().numpy())
