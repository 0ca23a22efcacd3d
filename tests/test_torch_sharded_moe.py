"""Port parity: Mixtral's expert-parallel step inside the sharded mesh.
`mixtral.make_train_step` on DTensor parameters (`shard_params` with
`mixtral.logical_axes`, the AdamW moments by `optimizer_shardings`, the
batch by `prepare_batch`) over meshes that split ep beside fsdp, tp and
sp, against the JAX package's step jitted over the same meshes on its 8
CPU devices, on the same bridged weights and seeded tokens (RT008).

The reference's MoE layer routes chunk k of the global batch (B / ep
contiguous rows, the whole sequence) on ep rank k with that chunk's
capacity, so its sharded loss differs from the unsharded one where
tokens drop (the default capacity factor 1.25, and the seed, make them
drop here).  The port's ranks are gloo processes spawned with a timeout
(`test_torch_parallel.spawn`), 4 and 8 of them, once a module.
Tolerances: f32 at rtol / atol 1e-5; each updated leaf at 1e-5, where an
entry whose JAX gradient is at rounding level (|g| < 1e-6) may differ by
up to 2 lr (`test_torch_sharded_train._hold`).
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import mixtral as jmx  # noqa: E402
from ray_tpu.parallel import MeshSpec as JMeshSpec  # noqa: E402
from ray_tpu.parallel import data_sharding, tree_shardings  # noqa: E402
from test_torch_parallel import spawn  # noqa: E402
from test_torch_sharded_train import (  # noqa: E402
    _flat, _hold, _jax_leaves, _leaves_of,
)

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3
VOCAB = 64
TESTS = Path(__file__).resolve().parent
# (tag, mesh, attention, ranks): the steps held against JAX's
MESHES = [
    ("ep2fsdp2", dict(ep=2, fsdp=2), "dense", 4),
    ("ep2tp2", dict(ep=2, tp=2), "dense", 4),
    ("ep2sp2", dict(ep=2, sp=2), "ring", 4),
    ("ep2fsdp2tp2", dict(ep=2, fsdp=2, tp=2), "dense", 8),
]

# ----------------------------------------------------------------------
# the ranks' task
# ----------------------------------------------------------------------
_TASK = """
import numpy as np
import torch

from ray_tpu_torch.models import gpt2, mixtral
from ray_tpu_torch.models.bridge import params_from_numpy
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.parallel import (MeshSpec, optimizer_shardings,
                                    shard_params, tree_shardings)
from ray_tpu_torch.parallel.sharding import (distribute_tree, global_norm,
                                             tree_paths)
from ray_tpu_torch.train.cuda_utils import prepare_batch


def tree(inp, prefix):
    out = {}
    for key, value in inp.items():
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
    return params_from_numpy(out, "cpu")


def whole(t):
    return t.detach().full_tensor().numpy()


def keep(tree_, prefix, out):
    for path, leaf in tree_paths(tree_):
        out[prefix + "/" + "/".join(map(str, path))] = whole(leaf)


def config(inp, attention):
    return mixtral.MixtralConfig(
        **{**mixtral.MixtralConfig.tiny(int(inp["vocab"])).__dict__,
           "dtype": torch.float32, "attention": attention})


def adamw(inp):
    # optax.adamw(lr)'s arithmetic
    return gpt2.AdamW(lambda count: float(inp["lr"]), max_norm=float("inf"),
                      b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def step(inp, tag, mesh_kw, attention, out):
    cfg = config(inp, attention)
    mesh = MeshSpec(**mesh_kw).build(device_type="cpu")
    params = tree(inp, "mixtral")
    opt = adamw(inp)
    logical = mixtral.logical_axes(cfg)
    sh = tree_shardings(mesh, logical)
    state = distribute_tree(opt.init(params), mesh,
                            optimizer_shardings(mesh, opt, params, sh))
    params = shard_params(params, mesh, logical)
    batch = prepare_batch(inp["tokens"], mesh)
    blocks = params["blocks"]
    out[tag + "_mesh_dims"] = np.asarray(
        blocks["moe_w_in"].device_mesh.mesh_dim_names)
    leaves = gpt2._leaves(params)
    for name in ("moe_w_in", "moe_w_out", "wq", "moe_router"):
        i = next(j for j, p in enumerate(leaves) if p is blocks[name])
        out[f"{tag}_placements_{name}"] = np.asarray(
            [str(p) for p in blocks[name].placements])
        for m in ("mu", "nu"):
            out[f"{tag}_placements_{name}_{m}"] = np.asarray(
                [str(p) for p in state[m][i].placements])
    out[tag + "_param_norm"] = np.asarray(float(global_norm(leaves)))
    # the gradient of the loss, gathered leaf by leaf
    fa.flash_attention.plain_dispatches = 0
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = mixtral.loss_fn(cfg, params, batch)
    for (path, _), g in zip(tree_paths(params),
                            torch.autograd.grad(loss, leaves)):
        out[tag + "_grad/" + "/".join(path)] = whole(g)
    params, state, m = mixtral.make_train_step(cfg, opt, mesh)(
        params, state, batch)
    out[tag + "_plain_dispatches"] = np.asarray(
        fa.flash_attention.plain_dispatches)
    for k in ("loss", "ce_loss", "load_balance_loss", "grad_norm"):
        out[f"{tag}_{k}"] = np.asarray(float(m[k]))
    keep(params, tag, out)


def refusal(inp, out):
    cfg = config(inp, "dense")
    mesh = MeshSpec(ep=2, pp=2).build(device_type="cpu")
    params = shard_params(tree(inp, "mixtral"), mesh,
                          mixtral.logical_axes(cfg))
    try:
        with torch.no_grad():
            mixtral.loss_fn(cfg, params, prepare_batch(inp["tokens"], mesh))
        out["refuse_pp"] = np.asarray("returned")
    except NotImplementedError as e:
        out["refuse_pp"] = np.asarray("NotImplementedError: " + str(e))


def run(rank, world, inp):
    out = {}
    for tag, mesh_kw, attention, n in inp["meshes"].tolist():
        if n == world:
            step(inp, tag, mesh_kw, attention, out)
    if world == 4:
        step(inp, "ep2tp2_flash", dict(ep=2, tp=2), "flash", out)
        refusal(inp, out)
    return out
"""


# ----------------------------------------------------------------------
# the JAX side, jitted over the same meshes on the 8 CPU devices
# ----------------------------------------------------------------------
def _cfg(attention="dense"):
    cfg = jmx.MixtralConfig.tiny(vocab_size=VOCAB)
    return jmx.MixtralConfig(**{**cfg.__dict__, "dtype": jnp.float32,
                                "attention": attention})


def _jax_step(params, tokens, mesh_kw, attention, n):
    cfg = _cfg(attention)
    mesh = JMeshSpec(**mesh_kw).build(jax.devices()[:n])
    params = jax.device_put(params, tree_shardings(
        mesh, jmx.logical_axes(cfg)))
    tokens = jax.device_put(tokens, data_sharding(mesh))
    opt = optax.adamw(LR)
    with mesh:
        grad = jax.jit(jax.grad(
            lambda p: jmx.loss_fn(cfg, p, tokens, mesh)[0]))(params)
        after, _, m = jax.jit(jmx.make_train_step(cfg, opt, mesh))(
            params, opt.init(params), tokens)
    return {**{k: float(m[k]) for k in ("loss", "ce_loss",
                                         "load_balance_loss")},
            "grad_norm": float(optax.global_norm(grad)),
            "params": after, "grad": grad}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tokens = np.random.default_rng(2).integers(0, VOCAB, (8, 17)).astype(
        np.int32)
    params = jmx.init_params(_cfg(), jax.random.PRNGKey(0))
    inputs = {"tests": str(TESTS), "vocab": VOCAB, "lr": LR,
              "tokens": tokens,
              "meshes": np.asarray(MESHES, dtype=object),
              **_flat(jax.tree.map(np.asarray, params), "mixtral")}
    ranks = {n: spawn(_TASK, n, inputs,
                      tmp_path_factory.mktemp(f"sharded_moe{n}"))
             for n in (4, 8)}
    jt = jnp.asarray(tokens)
    return {
        "ranks": ranks, "params": params,
        "jax": {tag: _jax_step(params, jt, kw, att, n)
                for tag, kw, att, n in MESHES},
        "unsharded_loss": float(jax.jit(
            lambda p: jmx.loss_fn(_cfg(), p, jt)[0])(params)),
    }


@pytest.mark.parametrize("tag", [t for t, _, _, _ in MESHES])
def test_sharded_mixtral_step_matches_jax(runs, tag):
    """One step of Mixtral tiny (f32, capacity 1.25) on DTensor params
    over a mesh that splits ep beside fsdp / tp / sp: the loss, its CE
    and load-balance parts and the pre-clip gradient norm on every rank,
    every gathered gradient leaf and every updated leaf equal JAX's step
    jitted over the same mesh.  The step's DTensors live on the mesh's
    axes of size > 1."""
    want = runs["jax"][tag]
    mesh_kw, n = next((kw, n) for t, kw, _, n in MESHES if t == tag)
    grads = _jax_leaves(want["grad"])
    for out in runs["ranks"][n]:
        for k in ("loss", "ce_loss", "load_balance_loss", "grad_norm"):
            np.testing.assert_allclose(out[f"{tag}_{k}"], want[k],
                                       err_msg=k, **TOL)
        assert [str(a) for a in out[tag + "_mesh_dims"]] == [
            a for a in ("fsdp", "ep", "sp", "tp") if a in mesh_kw]
    out = runs["ranks"][n][0]
    got = _leaves_of(out, tag + "_grad")
    assert sorted(got) == sorted(grads)
    for key, w in grads.items():
        np.testing.assert_allclose(got[key], w, err_msg=key, **TOL)
    _hold(_leaves_of(out, tag), _jax_leaves(want["params"]), [grads], LR)


def test_the_sharded_reference_drops_tokens(runs):
    """The case routes each ep chunk with its own capacity and tokens
    drop: JAX's sharded loss differs from its unsharded loss by more
    than 1e-4, and is the same on every mesh."""
    losses = [runs["jax"][t]["loss"] for t, _, _, _ in MESHES]
    assert abs(losses[0] - runs["unsharded_loss"]) > 1e-4, (
        losses[0], runs["unsharded_loss"])
    np.testing.assert_allclose(losses, losses[0], **TOL)


def test_flash_equals_dense_under_ep_tp(runs):
    """`attention="flash"` in the sharded step over ep 2 x tp 2 (on the
    CPU, K1 / K2's plain versions on each rank's local blocks: no
    dispatch to the plain attention) equals `"dense"` under the same
    mesh: the loss and its parts, the gradients and the updated
    leaves."""
    for out in runs["ranks"][4]:
        assert int(out["ep2tp2_flash_plain_dispatches"]) == 0
        for k in ("loss", "ce_loss", "load_balance_loss", "grad_norm"):
            np.testing.assert_allclose(out["ep2tp2_flash_" + k],
                                       out["ep2tp2_" + k], **TOL)
    out = runs["ranks"][4][0]
    got, want = (_leaves_of(out, t + "_grad") for t in ("ep2tp2_flash",
                                                        "ep2tp2"))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=key, **TOL)
    _hold(_leaves_of(out, "ep2tp2_flash"), _leaves_of(out, "ep2tp2"),
          [_jax_leaves(runs["jax"]["ep2tp2"]["grad"])], LR)


@pytest.mark.parametrize("tag,want", [
    ("ep2fsdp2", {"moe_w_in": ["S(2)", "S(1)"],
                  "moe_w_out": ["S(3)", "S(1)"],
                  "wq": ["S(1)", "R"],
                  "moe_router": ["S(1)", "R"]}),
    ("ep2tp2", {"moe_w_in": ["S(1)", "S(3)"],
                "moe_w_out": ["S(1)", "S(2)"],
                "wq": ["R", "S(2)"],
                "moe_router": ["R", "R"]}),
    ("ep2fsdp2tp2", {
        "moe_w_in": ["S(2)", "S(1)", "S(3)"],
        "moe_w_out": ["S(3)", "S(1)", "S(2)"],
        "wq": ["S(1)", "R", "S(2)"],
        "moe_router": ["S(1)", "R", "R"]}),
])
def test_expert_leaves_and_moments_placed_over_ep(runs, tag, want):
    """`shard_params` of `mixtral.logical_axes` puts the experts on
    Shard over ep on their expert dim (and over fsdp / tp as the rule
    table says; the mesh's dims in AXES order), and
    `optimizer_shardings` gives each AdamW moment its parameter's
    placements."""
    n = next(n for t, _, _, n in MESHES if t == tag)
    for out in runs["ranks"][n]:
        for name, places in want.items():
            got = [str(p) for p in out[f"{tag}_placements_{name}"]]
            assert got == places, (name, got)
            for m in ("mu", "nu"):
                assert list(out[f"{tag}_placements_{name}_{m}"]) == got


@pytest.mark.parametrize("tag", [t for t, _, _, _ in MESHES])
def test_global_norm_over_ep_equals_one_process(runs, tag):
    """`global_norm` of the sharded params, each element counted once
    (the experts split over ep, the rest replicated over it), equals the
    norm of the whole params on one process."""
    leaves = jax.tree.leaves(runs["params"])
    want = float(np.sqrt(sum(float(np.square(np.asarray(x, np.float64)).sum())
                             for x in leaves)))
    n = next(n for t, _, _, n in MESHES if t == tag)
    for out in runs["ranks"][n]:
        np.testing.assert_allclose(float(out[tag + "_param_norm"]), want,
                                   rtol=1e-6)


def test_a_pp_mesh_is_refused(runs):
    """A mesh that splits pp is refused, with a message that names it."""
    for out in runs["ranks"][4]:
        got = str(out["refuse_pp"])
        assert got.startswith("NotImplementedError: a sharded step splits "
                              "over"), got
        assert "'pp'" in got, got
