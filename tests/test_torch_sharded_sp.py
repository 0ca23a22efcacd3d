"""Port parity: sequence parallelism inside the sharded step.  GPT-2's
`make_train_step` on DTensor parameters over tp 2 x sp 2 (ring and
Ulysses), fsdp 2 x sp 2 and dp 2 x sp 2, Llama's loss and LoRA step over
dp 2 x sp 2 with ring attention, and Mixtral's step over ep 4 with
plain parameters (the multichip dry run's config), against the JAX
package's steps jitted over the same meshes on its 8 CPU devices, on the
same bridged weights and seeded tokens (RT008).

Over sp each rank computes on its contiguous chunk of the sequence
(`LocalShards.seq_chunk`, cut after the targets' shift), the positions
(GPT-2's `wpe`, Llama's RoPE) start at the chunk's offset, and ring /
Ulysses attention runs on the chunks over the sp group alone.  The
port's 4 ranks are gloo processes spawned with a timeout
(`test_torch_parallel.spawn`), once a module.  Tolerances: f32 at
rtol / atol 1e-5; each updated leaf at 1e-5, where an entry whose JAX
gradient is at rounding level (|g| < 1e-6) may differ by up to 2 lr
(`test_torch_sharded_train._hold`); bf16 ring against dense at the
reference test's 2e-2 (`tests/test_llama.py:121`).
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.models import mixtral as jmx  # noqa: E402
from ray_tpu.parallel import MeshSpec as JMeshSpec  # noqa: E402
from ray_tpu.parallel import data_sharding, tree_shardings  # noqa: E402
from ray_tpu_torch.parallel.mesh import AXES  # noqa: E402
from test_torch_parallel import spawn  # noqa: E402
from test_torch_sharded_train import (  # noqa: E402
    _flat, _hold, _jax_leaves, _leaves_of,
)

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3
LORA_LR = 1e-2
VOCAB = 256
TESTS = Path(__file__).resolve().parent
# (tag, mesh, attention): the GPT-2 steps held against JAX's
GPT2_MESHES = [
    ("tp2sp2_ring", dict(tp=2, sp=2), "ring"),
    ("tp2sp2_ulysses", dict(tp=2, sp=2), "ulysses"),
    ("fsdp2sp2_ring", dict(fsdp=2, sp=2), "ring"),
    ("dp2sp2_ring", dict(dp=2, sp=2), "ring"),
]

# ----------------------------------------------------------------------
# the ranks' task
# ----------------------------------------------------------------------
_TASK = """
import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama, mixtral
from ray_tpu_torch.models.bridge import params_from_numpy
from ray_tpu_torch.parallel import (MeshSpec, optimizer_shardings,
                                    shard_params, tree_shardings)
from ray_tpu_torch.parallel.sharding import distribute_tree, tree_paths
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
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).detach().numpy()


def keep(tree_, prefix, out):
    for path, leaf in tree_paths(tree_):
        out[prefix + "/" + "/".join(path)] = whole(leaf)


def adamw(lr, max_norm, b2, wd):
    return gpt2.AdamW(lambda count: lr, max_norm=max_norm, b1=0.9, b2=b2,
                      eps=1e-8, weight_decay=wd)


def gpt2_cfg(attention, dtype=torch.float32, n_head=4):
    return gpt2.GPT2Config(vocab_size=int(inp_["vocab"]), n_positions=64,
                           n_embd=64, n_layer=2, n_head=n_head, dtype=dtype,
                           attention=attention)


def gpt2_step(inp, tag, mesh_kw, attention, out):
    cfg = gpt2_cfg(attention)
    mesh = MeshSpec(**mesh_kw).build(device_type="cpu")
    params = tree(inp, "gpt2")
    opt = adamw(float(inp["lr"]), 1.0, 0.95, 0.1)
    sh = tree_shardings(mesh, gpt2.logical_axes(cfg))
    state = distribute_tree(opt.init(params), mesh,
                            optimizer_shardings(mesh, opt, params, sh))
    params = shard_params(params, mesh, gpt2.logical_axes(cfg))
    params, state, m = gpt2.make_train_step(cfg, opt, mesh)(
        params, state, prepare_batch(inp["gpt2_tokens"], mesh))
    out[tag + "_loss"] = np.asarray(float(m["loss"]))
    out[tag + "_grad_norm"] = np.asarray(float(m["grad_norm"]))
    out[tag + "_mesh_dims"] = np.asarray(
        params["wte"].device_mesh.mesh_dim_names)
    keep(params, tag, out)


def llama_cfg(attention, dtype=torch.float32):
    return llama.LlamaConfig(vocab_size=int(inp_["vocab"]), max_seq_len=128,
                             dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                             intermediate=128, dtype=dtype,
                             attention=attention)


def llama_steps(inp, out):
    mesh = MeshSpec(dp=2, sp=2).build(device_type="cpu")
    cfg = llama_cfg("ring")
    base = shard_params(tree(inp, "llama"), mesh, llama.logical_axes(cfg))
    batch = prepare_batch(inp["llama_tokens"], mesh)
    with torch.no_grad():
        out["llama_loss"] = np.asarray(float(llama.loss_fn(cfg, base,
                                                           batch)))
        bf = llama_cfg("ring", torch.bfloat16)
        out["llama_bf16_ring_loss"] = np.asarray(float(llama.loss_fn(
            bf, base, batch)))
        plain = tree(inp, "llama")
        tokens = torch.from_numpy(inp["llama_tokens"])
        out["llama_bf16_dense_loss"] = np.asarray(float(llama.loss_fn(
            llama_cfg("dense", torch.bfloat16), plain, tokens)))
        out["llama_dense_loss"] = np.asarray(float(llama.loss_fn(
            llama_cfg("dense"), plain, tokens)))
    lora = tree(inp, "lora")
    lora_axes = llama.lora_logical_axes(cfg, lora)
    opt = adamw(float(inp["lora_lr"]), float("inf"), 0.999, 1e-4)
    state = distribute_tree(opt.init(lora), mesh, optimizer_shardings(
        mesh, opt, lora, tree_shardings(mesh, lora_axes)))
    lora = shard_params(lora, mesh, lora_axes)
    lora, state, m = llama.make_lora_train_step(cfg, opt, mesh)(
        base, lora, state, batch)
    out["lora_loss"] = np.asarray(float(m["loss"]))
    keep(lora, "lora", out)


def mixtral_step(inp, out):
    cfg = mixtral.MixtralConfig(
        vocab_size=128, max_seq_len=32, dim=32, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=48, num_experts=4, top_k=1,
        dtype=torch.float32)
    mesh = MeshSpec(ep=4).build(device_type="cpu")
    params = tree(inp, "mixtral")
    opt = adamw(float(inp["lr"]), float("inf"), 0.999, 1e-4)
    params, _, m = mixtral.make_train_step(cfg, opt, mesh)(
        params, opt.init(params), torch.from_numpy(inp["mixtral_tokens"]))
    for k in ("loss", "ce_loss", "load_balance_loss"):
        out["mixtral_" + k] = np.asarray(float(m[k]))
    keep(params, "mixtral", out)


def refusals(inp, out):
    def raised(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__ + ": " + str(e)
        return "returned"

    tokens = inp["gpt2_tokens"]
    mesh = MeshSpec(tp=2, sp=2).build(device_type="cpu")

    def loss(cfg, mesh_, toks):
        params = shard_params(tree(inp, "gpt2") if cfg.n_head == 4 else
                              gpt2.init_params(cfg, 0, device="cpu"),
                              mesh_, gpt2.logical_axes(cfg))
        return gpt2.loss_fn(cfg, params, prepare_batch(toks, mesh_))

    with torch.no_grad():
        # T = 63 positions do not split over sp 2
        out["refuse_seq"] = np.asarray(raised(
            lambda: loss(gpt2_cfg("ring"), mesh, tokens[:, :64])))
        # 2 heads over tp 2 leave 1 a rank, which Ulysses cannot split
        # over sp 2
        out["refuse_heads"] = np.asarray(raised(
            lambda: loss(gpt2_cfg("ulysses", n_head=2), mesh, tokens)))
        # dense attention reads the whole sequence
        out["refuse_dense"] = np.asarray(raised(
            lambda: loss(gpt2_cfg("dense"), mesh, tokens)))
        for name, kw in (("ep", dict(dp=2, ep=2)), ("pp", dict(dp=2, pp=2))):
            out["refuse_" + name] = np.asarray(raised(lambda: loss(
                gpt2_cfg("dense"), MeshSpec(**kw).build(device_type="cpu"),
                tokens)))


def run(rank, world, inp):
    global inp_
    inp_ = inp
    out = {}
    for tag, mesh_kw, attention in inp["gpt2_meshes"].tolist():
        gpt2_step(inp, tag, mesh_kw, attention, out)
    llama_steps(inp, out)
    mixtral_step(inp, out)
    refusals(inp, out)
    return out
"""


# ----------------------------------------------------------------------
# the JAX side, jitted over the same meshes on 4 of the 8 CPU devices
# ----------------------------------------------------------------------
def _jmesh(**kw):
    return JMeshSpec(**kw).build(jax.devices()[:4])


def _gpt2_cfg(attention, dtype=jnp.float32):
    return jgpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_embd=64,
                            n_layer=2, n_head=4, dtype=dtype,
                            attention=attention)


def _gpt2_opt():
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1))


def _jax_gpt2(params, tokens, mesh_kw, attention):
    cfg = _gpt2_cfg(attention)
    mesh = _jmesh(**mesh_kw)
    params = jax.device_put(params, tree_shardings(
        mesh, jgpt2.logical_axes(cfg)))
    opt = _gpt2_opt()
    state = opt.init(params)
    tokens = jax.device_put(tokens, data_sharding(mesh))
    with mesh:
        params, _, m = jax.jit(jgpt2.make_train_step(cfg, opt, mesh))(
            params, state, tokens)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": params}


def _llama_cfg(attention, dtype=jnp.float32):
    return jllama.LlamaConfig(vocab_size=VOCAB, max_seq_len=128, dim=64,
                              n_layers=2, n_heads=4, n_kv_heads=2,
                              intermediate=128, dtype=dtype,
                              attention=attention)


def _jax_llama(base, lora, tokens):
    cfg = _llama_cfg("ring")
    mesh = _jmesh(dp=2, sp=2)
    base = jax.device_put(base, tree_shardings(
        mesh, jllama.logical_axes(cfg)))
    tokens = jax.device_put(tokens, data_sharding(mesh))
    opt = optax.adamw(LORA_LR)
    with mesh:
        loss = float(jax.jit(lambda b, t: jllama.loss_fn(cfg, b, t, mesh))(
            base, tokens))
        lora_after, _, m = jax.jit(jllama.make_lora_train_step(
            cfg, opt, mesh))(base, lora, opt.init(lora), tokens)
    grad = jax.jit(jax.grad(lambda lo: jllama.loss_fn(
        _llama_cfg("dense"), base, tokens, lora=lo)))(lora)
    return {"loss": loss, "lora_loss": float(m["loss"]),
            "lora": lora_after, "lora_grad": grad}


def _mixtral_cfg():
    return jmx.MixtralConfig(
        vocab_size=128, max_seq_len=32, dim=32, n_layers=2, n_heads=4,
        n_kv_heads=2, intermediate=48, num_experts=4, top_k=1,
        dtype=jnp.float32)


def _jax_mixtral(params, tokens):
    cfg = _mixtral_cfg()
    mesh = _jmesh(ep=4)
    opt = optax.adamw(LR)
    with mesh:
        after, _, m = jax.jit(jmx.make_train_step(cfg, opt, mesh))(
            params, opt.init(params), tokens)
        grad = jax.jit(jax.grad(
            lambda p: jmx.loss_fn(cfg, p, tokens, mesh)[0]))(params)
    return {**{k: float(m[k]) for k in ("loss", "ce_loss",
                                         "load_balance_loss")},
            "params": after, "grad": grad}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(23)
    gpt2_tokens = rng.integers(0, VOCAB, (4, 65)).astype(np.int32)
    llama_tokens = rng.integers(0, VOCAB, (4, 33)).astype(np.int32)
    mixtral_tokens = rng.integers(0, 128, (8, 17)).astype(np.int32)
    gp = jgpt2.init_params(_gpt2_cfg("dense"), jax.random.PRNGKey(0))
    base = jllama.init_params(_llama_cfg("dense"), jax.random.PRNGKey(0))
    lora = jllama.init_lora(_llama_cfg("dense"), jax.random.PRNGKey(1),
                            rank=4)
    # B away from its zero init, so every adapter leaf has a gradient
    lora = {**lora, "blocks": {
        k: v if k.endswith("_a") else jnp.asarray(
            rng.standard_normal(v.shape).astype(np.float32) * 0.02)
        for k, v in lora["blocks"].items()}}
    mx = jmx.init_params(_mixtral_cfg(), jax.random.PRNGKey(5))
    inputs = {"tests": str(TESTS), "vocab": VOCAB, "lr": LR,
              "lora_lr": LORA_LR, "gpt2_tokens": gpt2_tokens,
              "llama_tokens": llama_tokens,
              "mixtral_tokens": mixtral_tokens,
              "gpt2_meshes": np.asarray(GPT2_MESHES, dtype=object),
              **_flat(jax.tree.map(np.asarray, gp), "gpt2"),
              **_flat(jax.tree.map(np.asarray, base), "llama"),
              **_flat(jax.tree.map(np.asarray, lora), "lora"),
              **_flat(jax.tree.map(np.asarray, mx), "mixtral")}
    ranks = spawn(_TASK, 4, inputs, tmp_path_factory.mktemp("sharded_sp"))
    jt = jnp.asarray(gpt2_tokens)
    dense = jax.jit(lambda p: jgpt2.loss_fn(_gpt2_cfg("dense"), p, jt))(gp)
    return {
        "ranks": ranks,
        "gpt2": {tag: _jax_gpt2(gp, jt, kw, att)
                 for tag, kw, att in GPT2_MESHES},
        "gpt2_dense_loss": float(dense),
        "gpt2_grad": jax.jit(jax.grad(lambda p: jgpt2.loss_fn(
            _gpt2_cfg("dense"), p, jt)))(gp),
        "llama": _jax_llama(base, lora, jnp.asarray(llama_tokens)),
        "mixtral": _jax_mixtral(mx, jnp.asarray(mixtral_tokens)),
    }


@pytest.mark.parametrize("tag", [t for t, _, _ in GPT2_MESHES])
def test_sp_gpt2_step_matches_jax(runs, tag):
    """One step of GPT-2 (the dry run's tiny config, f32) on DTensor
    params over a mesh that splits sp: the loss, the pre-clip gradient
    norm and every updated leaf equal JAX's step jitted over the same
    mesh, on every rank, and the loss equals the dense loss on one
    device.  The step's DTensors live on the mesh's axes of size > 1."""
    want = runs["gpt2"][tag]
    mesh_kw = next(kw for t, kw, _ in GPT2_MESHES if t == tag)
    for out in runs["ranks"]:
        np.testing.assert_allclose(out[tag + "_loss"], want["loss"], **TOL)
        np.testing.assert_allclose(out[tag + "_loss"],
                                   runs["gpt2_dense_loss"], **TOL)
        np.testing.assert_allclose(out[tag + "_grad_norm"],
                                   want["grad_norm"], **TOL)
        assert [str(n) for n in out[tag + "_mesh_dims"]] == [
            n for n in AXES if n in mesh_kw]
    _hold(_leaves_of(runs["ranks"][0], tag), _jax_leaves(want["params"]),
          [_jax_leaves(runs["gpt2_grad"])], LR)


def test_sp_llama_loss_and_lora_step_match_jax(runs):
    """Llama tiny with its base and adapters sharded over dp 2 x sp 2
    and ring attention: the loss and one LoRA step (`optax.adamw`)
    equal JAX's over the same mesh at 1e-5; the ring loss equals dense
    attention's on one process at 2e-2 in bf16 (the reference test's
    limit) and at 1e-5 in f32."""
    want = runs["llama"]
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["llama_loss"], want["loss"], **TOL)
        np.testing.assert_allclose(out["llama_loss"],
                                   out["llama_dense_loss"], **TOL)
        np.testing.assert_allclose(out["llama_bf16_ring_loss"],
                                   out["llama_bf16_dense_loss"], rtol=2e-2)
        np.testing.assert_allclose(out["lora_loss"], want["lora_loss"],
                                   **TOL)
    _hold(_leaves_of(runs["ranks"][0], "lora"), _jax_leaves(want["lora"]),
          [_jax_leaves(want["lora_grad"])], LORA_LR)


def test_mixtral_ep_step_matches_jax(runs):
    """Mixtral's step over ep 4 with plain params (the dry run's config,
    f32, one expert a rank, top-1): the loss and its parts, and every
    param after the AdamW step, equal JAX's ep step on every rank (the
    router's gradient summed over ep, each expert's from its owner)."""
    want = runs["mixtral"]
    for out in runs["ranks"]:
        for k in ("loss", "ce_loss", "load_balance_loss"):
            np.testing.assert_allclose(out["mixtral_" + k], want[k], **TOL)
        _hold(_leaves_of(out, "mixtral"), _jax_leaves(want["params"]),
              [_jax_leaves(want["grad"])], LR)


@pytest.mark.parametrize("what,expect", [
    ("seq", "ValueError: sequence length 63 does not split over sp 2"),
    ("heads", "ValueError: Ulysses splits this rank's 1 heads over sp 2"),
    ("dense", "ValueError: attention 'dense' reads the whole sequence"),
    ("ep", "NotImplementedError: a sharded step splits over"),
    ("pp", "NotImplementedError: a sharded step splits over"),
])
def test_sp_step_refusals(runs, what, expect):
    """A sequence that sp does not divide, Ulysses over fewer local heads
    than sp, whole-sequence attention over a split sequence, and a mesh
    that also splits ep or pp: each refused with its reason."""
    for out in runs["ranks"]:
        assert str(out["refuse_" + what]).startswith(expect), \
            out["refuse_" + what]
