"""Port parity: the training half of `ray_tpu_torch.models.llama` (LoRA,
the loss, gradients, the train steps, `merge_lora`) against the JAX
package's `ray_tpu.models.llama` on the tiny config in f32.

Params and adapters cross from JAX through the weight bridge, so both
sides hold the same weights; tokens and adapter perturbations come from
seeded numpy (RT008).  Losses, gradients and updated trees agree at
rtol/atol 1e-5 (f32 matmuls summed in another order).  The port's
optimizer is `gpt2.AdamW`, held against the optax chain the reference
bench uses: `optax.adamw(lr)` is `AdamW(lambda c: lr, max_norm=inf,
b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)`.
"""

import dataclasses
import inspect
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models.bridge import (  # noqa: E402
    params_from_numpy, params_to_numpy,
)

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    this file from crowding the timing-sensitive tests that other
    workers of a parallel run execute meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    return jcfg, jparams, tcfg


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _tokens(seed, shape=(2, 17)):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


def _lora(jcfg, b_seed=None, targets=jllama.LORA_TARGETS):
    """A JAX adapter tree; with `b_seed`, B drawn from seeded numpy so
    the low-rank delta is not zero."""
    lora = jllama.init_lora(jcfg, jax.random.PRNGKey(1), rank=4,
                            targets=targets)
    if b_seed is not None:
        rng = np.random.default_rng(b_seed)
        blocks = dict(lora["blocks"])
        for name, b in blocks.items():
            if name.endswith("_b"):
                blocks[name] = jnp.asarray(
                    rng.normal(0.0, 0.05, b.shape).astype(np.float32))
        lora = {"blocks": blocks, "scale": lora["scale"]}
    return lora


def _flat(tree):
    """(path, leaf) pairs of a nested dict in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend((f"{k}/{p}", x) for p, x in _flat(v))
        else:
            out.append((k, v))
    return out


def _close_trees(got, want, tol=TOL):
    got = _flat(params_to_numpy(got))
    want = _flat(jax.tree.map(np.asarray, want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=path, **tol)


def _adamw():
    return tgpt2.AdamW(lambda count: LR, max_norm=float("inf"), b1=0.9,
                       b2=0.999, eps=1e-8, weight_decay=1e-4)


# ----------------------------------------------------------------------
# config, signature, trees
# ----------------------------------------------------------------------
def test_config_remat_and_forward_signature_match_jax():
    assert tllama.LlamaConfig().remat is jllama.LlamaConfig().remat is True
    names = lambda f: list(inspect.signature(f).parameters)  # noqa: E731
    for fn in ("forward", "loss_fn", "make_train_step",
               "make_lora_train_step", "merge_lora", "lora_logical_axes",
               "logical_axes"):
        assert names(getattr(tllama, fn)) == names(getattr(jllama, fn)), fn
    assert tllama.LORA_TARGETS == jllama.LORA_TARGETS


def test_num_params_and_logical_axes_match_jax(model):
    jcfg, jparams, tcfg = model
    tparams = _port(jparams)
    assert tllama.num_params(tparams) == jllama.num_params(jparams)
    assert tllama.logical_axes(tcfg) == jllama.logical_axes(jcfg)
    for targets in (jllama.LORA_TARGETS, ("wq", "w_up", "w_down")):
        jl = _lora(jcfg, targets=targets)
        tl = tllama.init_lora(tcfg, 1, rank=4, targets=targets,
                              device="cpu")
        assert tllama.lora_logical_axes(tcfg, tl) == \
            jllama.lora_logical_axes(jcfg, jl)
        assert tllama.num_params(tl) == jllama.num_params(jl)


def test_init_lora_layout_matches_jax_and_is_seeded(model):
    jcfg, _, tcfg = model
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        _lora(jcfg))
    a = tllama.init_lora(tcfg, 3, rank=4, device="cpu")
    b = tllama.init_lora(tcfg, 3, rank=4, device="cpu")
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                       params_to_numpy(a))
    assert got == want
    assert a["scale"].dim() == 0 and float(a["scale"]) == 16.0 / 4
    for name, leaf in a["blocks"].items():
        assert torch.equal(leaf, b["blocks"][name])
        if name.endswith("_b"):
            assert not leaf.any()
    # A ~ N(0, 1/in): wq's input is dim 64, wo's is H * hd 64
    assert abs(float(a["blocks"]["wq_a"].std()) * math.sqrt(64) - 1) < 0.1


def test_bridge_carries_a_lora_tree_bit_exactly(model):
    jcfg, _, _ = model
    tree = jax.tree.map(np.asarray, _lora(jcfg, b_seed=5))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert back["scale"].shape == () and back["scale"].dtype == np.float32
    for (pa, x), (pb, y) in zip(_flat(tree), _flat(back)):
        assert pa == pb and x.tobytes() == y.tobytes()


# ----------------------------------------------------------------------
# loss and gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("adapters", ["none", "lora_at_init", "lora"])
def test_loss_matches_jax(model, adapters):
    jcfg, jparams, tcfg = model
    toks = _tokens(1)
    jl = {"none": None, "lora_at_init": _lora(jcfg),
          "lora": _lora(jcfg, b_seed=2)}[adapters]
    want = jllama.loss_fn(jcfg, jparams, jnp.asarray(toks), lora=jl)
    with torch.no_grad():
        got = tllama.loss_fn(tcfg, _port(jparams), torch.from_numpy(toks),
                             lora=None if jl is None else _port(jl))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert abs(float(got) - math.log(128)) < 0.5


def test_full_model_grads_match_jax(model):
    jcfg, jparams, tcfg = model
    toks = _tokens(3)
    jgrads = jax.grad(lambda p: jllama.loss_fn(jcfg, p, jnp.asarray(toks)))(
        jparams)
    tparams = _port(jparams)
    leaves = tgpt2._leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(tcfg, tparams, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves)
    want = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def _lora_grads(tcfg, tparams, tl, toks):
    leaves = tgpt2._leaves(tl)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(tcfg, tparams, torch.from_numpy(toks), lora=tl)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss, dict(zip([p for p, _ in _flat(tl)], grads))


def test_lora_grads_match_jax_at_init_and_after_a_step(model):
    """At init B = 0, so every A gradient is exactly zero in both
    packages and B's carry the signal; after one AdamW step B is not
    zero and A's gradients match too."""
    jcfg, jparams, tcfg = model
    toks = _tokens(4)
    jl = _lora(jcfg)
    opt = optax.adamw(LR)
    jstate = opt.init(jl)

    def jgrads_of(lora):
        return jax.grad(lambda lp: jllama.loss_fn(
            jcfg, jparams, jnp.asarray(toks), lora=lp))(lora)

    tparams, tl = _port(jparams), _port(jl)
    tstate = _adamw().init(tl)
    step = tllama.make_lora_train_step(tcfg, _adamw())
    for it in range(2):
        jg = {p: np.asarray(g) for p, g in _flat(jgrads_of(jl))}
        _, tg = _lora_grads(tcfg, tparams, tl, toks)
        assert list(tg) == list(jg)
        for path, g in tg.items():
            if it == 0 and path.endswith("_a"):
                assert not g.any() and not jg[path].any(), path
            else:
                np.testing.assert_allclose(g.numpy(), jg[path],
                                           err_msg=path, **TOL)
        assert any(np.abs(v).max() > 0 for p, v in jg.items()
                   if p.endswith("_b"))
        if it == 1:
            assert all(np.abs(v).max() > 0 for v in jg.values())
        updates, jstate = opt.update(jax.grad(lambda lp: jllama.loss_fn(
            jcfg, jparams, jnp.asarray(toks), lora=lp))(jl), jstate, jl)
        jl = optax.apply_updates(jl, updates)
        tl, tstate, _ = step(tparams, tl, tstate, torch.from_numpy(toks))


# ----------------------------------------------------------------------
# train steps against optax
# ----------------------------------------------------------------------
def test_lora_train_step_matches_optax(model):
    """Three `make_lora_train_step` steps on a frozen base against the
    JAX step with `optax.adamw`: losses and the adapter tree (its
    `scale` included) after each step; the base does not move."""
    jcfg, jparams, tcfg = model
    toks = _tokens(6)
    jl = _lora(jcfg)
    opt = optax.adamw(LR)
    jstate = opt.init(jl)
    jstep = jllama.make_lora_train_step(jcfg, opt)
    tparams, tl = _port(jparams), _port(jl)
    base = {p: x.clone() for p, x in _flat(tparams)}
    topt = _adamw()
    tstate = topt.init(tl)
    tstep = tllama.make_lora_train_step(tcfg, topt)
    for _ in range(3):
        jl, jstate, jm = jstep(jparams, jl, jstate, jnp.asarray(toks))
        tl, tstate, tm = tstep(tparams, tl, tstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
        _close_trees(tl, jl)
    for p, x in _flat(tparams):
        assert torch.equal(x, base[p]) and not x.requires_grad, p


def test_full_train_step_matches_optax(model):
    jcfg, jparams, tcfg = model
    toks = _tokens(7)
    opt = optax.adamw(1e-3)
    jstate = opt.init(jparams)
    jstep = jllama.make_train_step(jcfg, opt)
    tparams = _port(jparams)
    topt = tgpt2.AdamW(lambda count: 1e-3, max_norm=float("inf"), b1=0.9,
                       b2=0.999, eps=1e-8, weight_decay=1e-4)
    tstate = topt.init(tparams)
    tstep = tllama.make_train_step(tcfg, topt)
    for _ in range(2):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(toks))
        tparams, tstate, tm = tstep(tparams, tstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
        _close_trees(tparams, jparams)


def test_adamw_clips_nothing_at_inf():
    """`max_norm=inf` leaves every gradient as it is: one step equals
    the same optimizer with no clip reached (a huge finite bound)."""
    rng = np.random.default_rng(9)
    a = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))}
    b = {"w": a["w"].clone()}
    grads = [torch.from_numpy(rng.normal(0, 50, (4, 3)).astype(np.float32))]
    for params, bound in ((a, float("inf")), (b, 1e30)):
        opt = tgpt2.AdamW(lambda c: LR, max_norm=bound, b1=0.9, b2=0.999,
                          eps=1e-8, weight_decay=1e-4)
        state, norm = opt.update(grads, opt.init(params), params)
        assert math.isfinite(float(norm))
    assert torch.equal(a["w"], b["w"])


# ----------------------------------------------------------------------
# merge, remat, mesh
# ----------------------------------------------------------------------
def test_merge_lora_matches_jax_and_the_adapter_forward(model):
    jcfg, jparams, tcfg = model
    jl = _lora(jcfg, b_seed=11, targets=("wq", "wv", "w_up", "w_down"))
    tparams, tl = _port(jparams), _port(jl)
    merged = tllama.merge_lora(tcfg, tparams, tl)
    _close_trees(merged, jllama.merge_lora(jcfg, jparams, jl))
    assert merged["blocks"]["wk"] is tparams["blocks"]["wk"]
    assert not torch.equal(merged["blocks"]["wq"], tparams["blocks"]["wq"])
    toks = torch.from_numpy(_tokens(12))
    with torch.no_grad():
        np.testing.assert_allclose(
            tllama.forward(tcfg, merged, toks).numpy(),
            tllama.forward(tcfg, tparams, toks, lora=tl).numpy(), **TOL)


def test_remat_gives_the_same_loss_and_grads(model):
    """Checkpointed blocks recompute the same f32 arithmetic: loss and
    every adapter gradient equal bit for bit, with and without remat."""
    jcfg, jparams, tcfg = model
    toks = _tokens(13)
    tparams, jl = _port(jparams), _lora(jcfg, b_seed=14)
    runs = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs[remat] = _lora_grads(cfg, tparams, _port(jl), toks)
    assert torch.equal(runs[True][0], runs[False][0])
    for path, g in runs[True][1].items():
        assert torch.equal(g, runs[False][1][path]), path


def test_forward_with_a_mesh_raises(model):
    _, _, tcfg = model
    params = tllama.init_params(tcfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        tllama.forward(tcfg, params, torch.zeros((1, 4), dtype=torch.int32),
                       mesh=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        tllama.loss_fn(tcfg, params, torch.zeros((1, 5), dtype=torch.int32),
                       object())
