"""Port parity: `ray_tpu_torch.models.gpt2` against the JAX package's
`ray_tpu.models.gpt2` on the tiny config in f32.

The JAX params cross to the port through the weight bridge, so both
sides hold the same weights; tokens come from seeded numpy (RT008).
`attention="flash"` runs `plain_attention` on the JAX side (its CPU
route) and the flash kernels' plain versions on the port's side.

Tolerances: forward, loss and grads at rtol/atol 1e-5 (f32 matmuls
summed in another order); the remat policies agree with no remat at the
reference's own tolerance (`tests/test_models.py`); the 3-step AdamW
trajectory at 1e-5 on loss and grad norm and rtol 1e-4 / atol 1e-5 on
params, because Adam's first steps divide each gradient by its own
magnitude (|update| ~ lr); the key bias, whose gradient is rounding
noise around an exact zero, at lr * 1e-2 (see the test).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models.bridge import (  # noqa: E402
    params_from_numpy, params_to_numpy,
)
from ray_tpu_torch.ops import attention as tattn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(attention="dense", **kw):
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32,
                               attention=attention, **kw)
    tcfg = dataclasses.replace(tgpt2.GPT2Config.tiny(),
                               dtype=torch.float32, attention=attention,
                               **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _configs()
    return jgpt2.init_params(jcfg, jax.random.PRNGKey(0))


def _tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(shape=(2, 33), seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _close_trees(got, want, tol=TOL):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_allclose(np.asarray(flat_g[path]), np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ----------------------------------------------------------------------
# config, init
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gpt2_124m", "tiny"])
def test_config_matches_jax(name):
    j = getattr(jgpt2.GPT2Config, name)()
    t = getattr(tgpt2.GPT2Config, name)()
    for f in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head",
              "dropout", "attention", "remat", "scan_unroll",
              "remat_policy", "remat_skip", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert t.logits_dtype == torch.float32 and j.logits_dtype == jnp.float32


@pytest.mark.parametrize("kw", [
    {"remat_policy": "selective"},
    {"remat_policy": "half", "n_layer": 3},
    {"scan_unroll": 0},
    {"remat_skip": 13},
    {"remat_skip": -1},
    {"remat_skip": 1, "remat_policy": "dots"},
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jgpt2.GPT2Config(**kw)
    with pytest.raises(ValueError) as terr:
        tgpt2.GPT2Config(**kw)
    assert str(terr.value) == str(jerr.value)


def test_init_layout_matches_jax_and_is_seeded(jparams):
    _, tcfg = _configs()
    a = tgpt2.init_params(tcfg, 3, device="cpu")
    b = tgpt2.init_params(tcfg, 3, device="cpu")
    c = tgpt2.init_params(tcfg, torch.Generator().manual_seed(4),
                          device="cpu")
    shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jparams)
    assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        params_to_numpy(a)) == shapes
    for x, y, z in zip(tgpt2._leaves(a), tgpt2._leaves(b),
                       tgpt2._leaves(c)):
        assert torch.equal(x, y)
    assert not torch.equal(a["wte"], c["wte"])
    # the reference's scales: std 0.02, wpe 0.01, residual projections
    # 0.02 / sqrt(2 L); norms one, biases zero
    assert abs(float(a["wte"].std()) - 0.02) < 2e-3
    assert abs(float(a["wpe"].std()) - 0.01) < 1e-3
    assert abs(float(a["blocks"]["attn_out_w"].std()) - 0.01) < 1e-3
    assert torch.equal(a["blocks"]["ln1_g"], torch.ones(2, 64))
    assert torch.equal(a["blocks"]["mlp_fc_b"], torch.zeros(2, 256))
    assert tgpt2.logical_axes(tcfg) == jgpt2.logical_axes(
        _configs()[0])
    assert tgpt2.num_params(a) == jgpt2.num_params(jparams)


# ----------------------------------------------------------------------
# forward, loss, grads
# ----------------------------------------------------------------------
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_and_loss_match_jax(jparams, attention):
    jcfg, tcfg = _configs(attention)
    tparams = _tparams(jparams)
    tokens = _tokens()
    n0 = tattn.flash_attention.plain_dispatches
    _close(tgpt2.forward(tcfg, tparams, torch.as_tensor(tokens[:, :-1])),
           jgpt2.forward(jcfg, jparams, jnp.asarray(tokens[:, :-1])))
    _close(tgpt2.loss_fn(tcfg, tparams, torch.as_tensor(tokens)),
           jgpt2.loss_fn(jcfg, jparams, jnp.asarray(tokens)))
    assert tattn.flash_attention.plain_dispatches == n0


def test_bf16_logits_loss_matches_jax(jparams):
    """logits_dtype=bf16: the logits round to bf16, the reductions stay
    f32 (loss to bf16 rounding of the logits: 1e-3)."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, logits_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, logits_dtype=torch.bfloat16)
    tokens = _tokens(seed=2)
    got = tgpt2.loss_fn(tcfg, _tparams(jparams), torch.as_tensor(tokens))
    assert got.dtype == torch.float32
    _close(got, jgpt2.loss_fn(jcfg, jparams, jnp.asarray(tokens)),
           dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_grads_of_every_leaf_match_jax(jparams, attention):
    """Every leaf, the tied wte included (its gradient sums the
    embedding lookup and the lm-head)."""
    jcfg, tcfg = _configs(attention)
    tparams = _tparams(jparams)
    tokens = _tokens(seed=3)
    jgrads = jax.grad(lambda p: jgpt2.loss_fn(jcfg, p, jnp.asarray(
        tokens)))(jparams)
    leaves = tgpt2._leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(
        tgpt2.loss_fn(tcfg, tparams, torch.as_tensor(tokens)), leaves)
    got = jax.tree.unflatten(jax.tree.structure(jgrads),
                             [g.numpy() for g in grads])
    _close_trees(got, jgrads)


REMAT = [
    {"remat_policy": "full"},
    {"remat_policy": "dots"},
    {"remat_policy": "names"},
    {"remat_policy": "half"},
    {"remat_policy": "full", "scan_unroll": 2},
    {"remat_skip": 1},
    {"remat_skip": 2},  # == n_layer: nothing remats
]


@pytest.mark.parametrize("kw", REMAT, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_remat_policies_agree(jparams, attention, kw):
    """Each remat policy gives no-remat's loss and grads: the mirror of
    tests/test_models.py::test_gpt2_remat_policies_agree."""
    tokens = torch.as_tensor(_tokens(seed=4))

    def run(**cfg_kw):
        _, tcfg = _configs(attention, **cfg_kw)
        tparams = _tparams(jparams)
        leaves = tgpt2._leaves(tparams)
        for p in leaves:
            p.requires_grad_(True)
        loss = tgpt2.loss_fn(tcfg, tparams, tokens)
        return loss, torch.autograd.grad(loss, leaves)

    ref_loss, ref_grads = run(remat=False)
    loss, grads = run(**kw)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-4
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4,
                                   atol=2e-5)


# ----------------------------------------------------------------------
# optimizer and train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (3, 10), (5, 5)])
def test_schedule_matches_optax(warmup, total):
    decay = max(total, warmup + 1)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    got = tgpt2.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    assert got(0) == 0.0
    for step in (0, 1, warmup - 1, warmup, warmup + 1, (warmup + decay) // 2,
                 decay, decay + 7):
        # optax evaluates in f32, the port in Python floats
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12, err_msg=str(step))


def test_train_step_trajectory_matches_jax(jparams):
    """3 steps of make_train_step(default_optimizer) from the same params
    and tokens: warm-up lr 0 at step 0, then a real update with the clip
    active, then the cosine phase."""
    jcfg, tcfg = _configs("flash")
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=10)
    jopt = jgpt2.default_optimizer(**kw)
    jstep = jax.jit(jgpt2.make_train_step(jcfg, jopt))
    topt = tgpt2.default_optimizer(**kw)
    tstep = tgpt2.make_train_step(tcfg, topt)
    jp, js = jparams, jopt.init(jparams)
    tp = _tparams(jparams)
    ts = topt.init(tp)
    ids = {k: id(v) for k, v in tp["blocks"].items()}
    clipped = []
    for i in range(3):
        tokens = _tokens(seed=10 + i)
        jp, js, jm = jstep(jp, js, jnp.asarray(tokens))
        tp2, ts, tm = tstep(tp, ts, torch.as_tensor(tokens))
        assert tp2 is tp
        _close(tm["loss"], jm["loss"])
        _close(tm["grad_norm"], jm["grad_norm"])
        clipped.append(float(jm["grad_norm"]) > 1.0)
        got = params_to_numpy(tp)
        # the key bias's gradient is zero in exact arithmetic (it adds
        # the same q.b_k to every score of a row), so both sides hold
        # rounding noise there, which Adam scales to lr * |g| / (|g| +
        # eps): that slice is held at lr * 1e-2, the rest at 1e-4 / 1e-5
        E = tcfg.n_embd
        kb = (slice(None), slice(E, 2 * E))
        np.testing.assert_allclose(got["blocks"]["attn_qkv_b"][kb],
                                   np.asarray(jp["blocks"]["attn_qkv_b"])[kb],
                                   rtol=0, atol=kw["lr"] * 1e-2)
        want = {**jp, "blocks": dict(jp["blocks"])}
        for tree in (got, want):
            b = np.array(tree["blocks"]["attn_qkv_b"])
            b[kb] = 0.0
            tree["blocks"]["attn_qkv_b"] = b
        _close_trees(got, want, dict(rtol=1e-4, atol=1e-5))
    assert ts["count"] == 3
    assert any(clipped)  # the clip's scaling branch was exercised
    assert {k: id(v) for k, v in tp["blocks"].items()} == ids  # in place
