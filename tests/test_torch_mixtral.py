"""Port parity: `ray_tpu_torch.models.mixtral` against the JAX package's
`ray_tpu.models.mixtral` on the tiny config.

Params cross from JAX through the weight bridge (both ways), tokens come
from seeded numpy (RT008).  In f32: logits, the load-balance loss and
`loss_fn` at rtol / atol 1e-5, and three train steps of the port's
`gpt2.AdamW` against `optax.adamw` (`AdamW(lambda c: lr,
max_norm=inf, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)`), as the
Llama tests hold them.  Expert parallelism over 4 gloo ranks
(`test_torch_parallel.spawn`) against the local path at capacity 16,
where no token drops, at the reference's own atol 2e-2 (bf16 compute).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import mixtral as jmx  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models import mixtral as tmx  # noqa: E402
from ray_tpu_torch.models.bridge import (  # noqa: E402
    params_from_numpy, params_to_numpy,
)

from test_torch_parallel import spawn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 3e-3
# the most of a step's elements whose JAX gradient is nonzero and below
# 1e-6 (an exact zero, as an unused token's embedding row, is held
# strictly)
NOISY_SHARE = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jmx.MixtralConfig.tiny(vocab_size=64),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tmx.MixtralConfig.tiny(vocab_size=64),
                               dtype=torch.float32)
    return jcfg, jmx.init_params(jcfg, jax.random.PRNGKey(0)), tcfg


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jparams):
    return params_from_numpy(_numpy(jparams), device="cpu")


def _tokens(seed, shape=(2, 17), vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_config_matches_jax():
    for name in ("mixtral_8x7b", "tiny"):
        j, t = getattr(jmx.MixtralConfig, name)(), \
            getattr(tmx.MixtralConfig, name)()
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd.pop("dtype") == jnp.bfloat16
        assert td.pop("dtype") == torch.bfloat16
        assert jd == td, name
        assert (t.head_dim, t.moe.hidden, t.moe.num_experts, t.moe.top_k,
                t.moe.capacity_factor) == (
            j.head_dim, j.moe.hidden, j.moe.num_experts, j.moe.top_k,
            j.moe.capacity_factor)
    assert tmx.logical_axes(t) == jmx.logical_axes(j)


def test_tiny_params_cross_the_bridge(model):
    """The JAX tree crosses leaf by leaf, both ways, bit for bit: f32,
    and bf16 as its raw 16 bits."""
    _, jparams, _ = model
    want = _numpy(jparams)
    got = params_to_numpy(_port(jparams))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    back = params_to_numpy(params_from_numpy(bf, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(bf)):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))


def test_forward_aux_and_loss_match_jax(model):
    jcfg, jparams, tcfg = model
    toks = _tokens(1)
    tparams = _port(jparams)
    jl, jmet = jmx.forward(jcfg, jparams, jnp.asarray(toks[:, :-1]))
    with torch.no_grad():
        tl, tmet = tmx.forward(tcfg, tparams, torch.from_numpy(toks[:, :-1]))
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(tmet["load_balance_loss"]),
                               float(jmet["load_balance_loss"]), **TOL)
    jloss, jm = jmx.loss_fn(jcfg, jparams, jnp.asarray(toks))
    with torch.no_grad():
        tloss, tm = tmx.loss_fn(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for k in ("ce_loss", "load_balance_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    # a fresh router routes near-uniformly (the reference's own bound)
    assert 0.5 < float(tm["load_balance_loss"]) < 2.0


@pytest.mark.parametrize("remat", [True, False])
def test_grads_match_jax(model, remat):
    jcfg, jparams, tcfg = model
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    toks = _tokens(2)
    jg = jax.jit(jax.grad(lambda p: jmx.loss_fn(jcfg, p, jnp.asarray(toks))[0])
                 )(jparams)
    tparams = _port(jparams)
    leaves = tgpt2._leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tg = torch.autograd.grad(
        tmx.loss_fn(tcfg, tparams, torch.from_numpy(toks))[0], leaves)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _port_state(jstate):
    """optax.adamw's state as `gpt2.AdamW`'s: the step count and the
    moments, leaf by leaf in the same (sorted-key) order."""
    adam = jstate[0]
    return {"count": int(adam.count),
            "mu": [torch.from_numpy(np.array(m)) for m in
                   jax.tree.leaves(adam.mu)],
            "nu": [torch.from_numpy(np.array(v)) for v in
                   jax.tree.leaves(adam.nu)]}


def test_train_steps_match_optax(model):
    """3 steps of `make_train_step`, each from the JAX side's params and
    optax state, against `optax.adamw`: the loss and its parts at 1e-5,
    and the updated params at rtol 1e-4 / atol 1e-5 (the GPT-2 test's).
    Adam divides the gradient by its own running magnitude, so where a
    gradient is at f32 rounding level (0 < |g| < 1e-6; the two sides'
    gradients differ by ~5e-9) the update's sign is noise, and a free
    trajectory inherits that noise from step 1 on: the train step's
    update of those elements (at most `NOISY_SHARE` of all elements in
    a step) is held to move at most one step's worth (lr) from the
    reference.  The optimizer is held on every element, those included,
    on its own: `gpt2.AdamW.update` fed JAX's gradient and the optax
    state gives optax's update at rtol 1e-5 (atol 1e-5 lr) and optax's
    moments at rtol 1e-5 (atol 1e-5 of the leaf's largest)."""
    jcfg, jparams, tcfg = model
    toks = _tokens(3, (4, 17))
    opt = optax.adamw(LR)
    jstate = opt.init(jparams)
    jstep = jax.jit(jmx.make_train_step(jcfg, opt))
    jgrad = jax.jit(jax.grad(
        lambda p: jmx.loss_fn(jcfg, p, jnp.asarray(toks))[0]))
    topt = tgpt2.AdamW(lambda count: LR, max_norm=float("inf"), b1=0.9,
                       b2=0.999, eps=1e-8, weight_decay=1e-4)
    tstep = tmx.make_train_step(tcfg, topt)
    losses = []
    for _ in range(3):
        before = jax.tree.leaves(_numpy(jparams))
        jg = jgrad(jparams)
        noisy = [(np.abs(np.asarray(g)) < 1e-6) & (np.asarray(g) != 0)
                 for g in jax.tree.leaves(jg)]
        share = sum(int(n.sum()) for n in noisy) / sum(n.size for n in noisy)
        assert share < NOISY_SHARE, share
        # the optimizer alone, on JAX's gradient and optax's state
        upd, ostate = opt.update(jg, jstate, jparams)
        want = jax.tree.leaves(_numpy(optax.apply_updates(jparams, upd)))
        aparams, astate = _port(jparams), _port_state(jstate)
        topt.update([torch.from_numpy(np.array(g))
                     for g in jax.tree.leaves(jg)], astate, aparams)
        got = jax.tree.leaves(params_to_numpy(aparams))
        for g, w, p0 in zip(got, want, before):
            np.testing.assert_allclose(g - p0, w - p0, rtol=1e-5,
                                       atol=1e-5 * LR)
        for k in ("mu", "nu"):
            for g, w in zip(astate[k], jax.tree.leaves(getattr(ostate[0], k))):
                w = np.asarray(w)
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=k)
        # the train step, its own gradient included
        tparams, tstate = _port(jparams), _port_state(jstate)
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(toks))
        tparams, tstate, tm = tstep(tparams, tstate, torch.from_numpy(toks))
        assert tstate["count"] == int(jstate[0].count)
        for k in ("loss", "ce_loss", "load_balance_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=k)
        losses.append(float(tm["loss"]))
        got = jax.tree.leaves(params_to_numpy(tparams))
        for g, w, n in zip(got, jax.tree.leaves(_numpy(jparams)), noisy):
            np.testing.assert_allclose(g[~n], w[~n], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g[n], w[n], rtol=0, atol=LR)
    assert losses[-1] < losses[0]


def test_active_params_per_token_matches_jax(model):
    jcfg, jparams, tcfg = model
    tparams = _port(jparams)
    assert tmx.num_params(tparams) == jmx.num_params(jparams)
    assert tmx.active_params_per_token(tcfg, tparams) == \
        jmx.active_params_per_token(jcfg, jparams)
    assert tmx.active_params_per_token(tcfg, tparams) < \
        tmx.num_params(tparams)


def test_init_params_tree_matches_jax(model):
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes (the values differ: another generator)."""
    jcfg, jparams, tcfg = model
    tparams = tmx.init_params(tcfg, 0, device="cpu")
    want = _numpy(jparams)
    got = params_to_numpy(tparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = tmx.init_params(tcfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tgpt2._leaves(tparams),
                                                 tgpt2._leaves(again)))


_EP_TASK = """
import dataclasses
import numpy as np
import torch
from ray_tpu_torch.models import mixtral
from ray_tpu_torch.models.bridge import params_from_numpy
from ray_tpu_torch.parallel import MeshSpec

def run(rank, world, inp):
    torch.manual_seed(0)
    cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(),
                              capacity_factor=16.0)
    tree = {"blocks": {}}
    for k, v in inp.items():
        if k.startswith("blocks/"):
            tree["blocks"][k[7:]] = v
        elif k != "tokens":
            tree[k] = v
    params = params_from_numpy(tree, device="cpu")
    toks = torch.from_numpy(inp["tokens"])
    mesh = MeshSpec(ep=world).build(device_type="cpu")
    with torch.no_grad():
        local, la = mixtral.forward(cfg, params, toks)
        ep, ea = mixtral.forward(cfg, params, toks, mesh)
    return {"local": local.numpy(), "ep": ep.numpy(),
            "local_aux": la["load_balance_loss"].numpy(),
            "ep_aux": ea["load_balance_loss"].numpy()}
"""


def test_ep_over_four_ranks_matches_local(tmp_path):
    """Drop-free capacity (16): the expert-parallel forward equals the
    single-device path, as the reference's own test holds it."""
    jcfg = dataclasses.replace(jmx.MixtralConfig.tiny(),
                               capacity_factor=16.0)
    jparams = _numpy(jmx.init_params(jcfg, jax.random.PRNGKey(0)))
    inputs = {"tokens": _tokens(4, (4, 16), jcfg.vocab_size)}
    for k, v in jparams.items():
        if k == "blocks":
            inputs.update({f"blocks/{n}": a for n, a in v.items()})
        else:
            inputs[k] = v
    outs = spawn(_EP_TASK, 4, inputs, tmp_path)
    for r, o in enumerate(outs):
        assert np.isfinite(o["ep"]).all()
        np.testing.assert_allclose(o["ep"], o["local"], atol=2e-2,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(o["ep"], outs[0]["ep"])
