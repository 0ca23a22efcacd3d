"""Port parity: the sharded training step.  GPT-2's `make_train_step` and
Llama's `make_lora_train_step` on DTensor parameters (`shard_params`
over `MeshSpec.build()`'s mesh), with the AdamW state placed by
`optimizer_shardings` and the batch by `prepare_batch`, against the JAX
package's steps under `jax.jit` on one CPU device, on the same bridged
weights and seeded tokens (RT008).  Then the global-mesh trainer:
`CudaTrainer` in "torch_distributed" mode over a dp x fsdp mesh, a
sharded checkpoint every step, and a restart resharded onto another
layout (the counterparts of `tests/test_train_distributed.py`'s
`test_jax_distributed_global_mesh` and `..._restart_reshards`).

The port's ranks are gloo processes spawned with a timeout
(`test_torch_parallel.spawn`); each group runs once a module and returns
all its readings.  Tolerances: f32 loss and grad norm at rtol 1e-5; each
updated leaf at rtol / atol 1e-5, where an entry whose JAX gradient is
at rounding level (|g| < 1e-6) may differ by up to 2 lr: Adam turns the
sign of rounding noise into a whole step (`chip_smoke.py`'s
`RLLIB_TOL` / `RLLIB_NOISE` hold the same).
"""

import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    CudaConfig,
    CudaTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from test_torch_parallel import spawn  # noqa: E402
from test_torch_waits import bounded_fit  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NOISE = 1e-6  # |JAX gradient| below this: rounding level
GPT2_LR = 1e-3
LORA_LR = 1e-2
VOCAB = 131  # odd: the vocabulary splits unevenly over tp
STEPS = 3  # the default schedule's lr is 0 at step 0
TESTS = Path(__file__).resolve().parent

# ----------------------------------------------------------------------
# the ranks' task
# ----------------------------------------------------------------------
_TASK = """
import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.models.bridge import params_from_numpy
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.parallel import (MeshSpec, optimizer_shardings,
                                    shard_params, tree_shardings)
from ray_tpu_torch.parallel.ring_attention import plain_attention
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


def full(tree_, prefix, out):
    for path, leaf in sorted(flat(tree_).items()):
        out[prefix + "/" + path] = leaf.detach().full_tensor().numpy()


def grads(loss, tree_, prefix, out):
    # the gradient of loss() for each DTensor leaf of tree_, whole
    paths = tree_paths(tree_)
    leaves = [leaf.requires_grad_(True) for _, leaf in paths]
    for (path, _), g in zip(paths, torch.autograd.grad(loss(), leaves)):
        out[prefix + "/" + "/".join(path)] = g.full_tensor().numpy()


def flat(tree_, prefix=""):
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def gpt2_steps(inp, tag, mesh_kw, attention, out):
    cfg = gpt2.GPT2Config(vocab_size=int(inp["vocab"]), n_positions=128,
                          n_embd=64, n_layer=2, n_head=4,
                          dtype=torch.float32, attention=attention)
    mesh = MeshSpec(**mesh_kw).build(device_type="cpu")
    params = tree(inp, "gpt2")
    sh = tree_shardings(mesh, gpt2.logical_axes(cfg))
    opt = gpt2.default_optimizer(lr=float(inp["gpt2_lr"]), warmup_steps=1,
                                 total_steps=10)
    state = distribute_tree(opt.init(params), mesh,
                            optimizer_shardings(mesh, opt, params, sh))
    params = shard_params(params, mesh, gpt2.logical_axes(cfg))
    out[tag + "_mesh_dims"] = np.asarray(
        params["wte"].device_mesh.mesh_dim_names)
    out[tag + "_moment_placements_equal"] = np.asarray(all(
        m.placements == p.placements for m, p in
        zip(state["mu"], gpt2._leaves(params))))
    step = gpt2.make_train_step(cfg, opt, mesh)
    plain0 = fa.flash_attention.plain_dispatches
    t0 = time.perf_counter()
    losses, norms = [], []
    batch = prepare_batch(inp["gpt2_tokens"], mesh)
    grads(lambda: gpt2.loss_fn(cfg, params, batch), params, tag + "_grad",
          out)
    for _ in range(int(inp["steps"])):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[tag + "_seconds"] = np.asarray(time.perf_counter() - t0)
    out[tag + "_plain_dispatches"] = np.asarray(
        fa.flash_attention.plain_dispatches - plain0)
    out[tag + "_loss"] = np.asarray(losses)
    out[tag + "_grad_norm"] = np.asarray(norms)
    full(params, tag, out)


def lora_steps(inp, out):
    cfg = llama.LlamaConfig(vocab_size=int(inp["vocab"]), max_seq_len=128,
                            dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            intermediate=128, dtype=torch.float32)
    mesh = MeshSpec(fsdp=2, tp=2).build(device_type="cpu")
    base = shard_params(tree(inp, "llama"), mesh, llama.logical_axes(cfg))
    lora = tree(inp, "lora")
    lora_axes = llama.lora_logical_axes(cfg, lora)
    opt = gpt2.AdamW(lambda count: float(inp["lora_lr"]),
                     max_norm=float("inf"), b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=1e-4)
    state = distribute_tree(opt.init(lora), mesh, optimizer_shardings(
        mesh, opt, lora, tree_shardings(mesh, lora_axes)))
    lora = shard_params(lora, mesh, lora_axes)
    step = llama.make_lora_train_step(cfg, opt, mesh)
    losses = []
    batch = prepare_batch(inp["lora_tokens"], mesh)
    # the gradients where B is not zero: A's and the scale's too
    lora_b = shard_params(tree(inp, "lora_b"), mesh, lora_axes)
    grads(lambda: llama.loss_fn(cfg, base, batch, lora=lora_b), lora_b,
          "lora_grad", out)
    for _ in range(int(inp["steps"])):
        lora, state, m = step(base, lora, state, batch)
        losses.append(float(m["loss"]))
    out["lora_loss"] = np.asarray(losses)
    full(lora, "lora", out)


def attention_on_dtensors(inp, out):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = MeshSpec(fsdp=2, tp=2).build(device_type="cpu")
    sub = mesh["fsdp", "tp"]
    for fn in ("plain", "flash"):
        attend = plain_attention if fn == "plain" else fa.flash_attention
        # q split as the heads and the batch; k and v replicated
        qkv = [distribute_tensor(torch.from_numpy(inp["attn_" + n]), sub, pl)
               .requires_grad_(True) for n, pl in
               (("q", [Shard(0), Shard(2)]), ("k", [Replicate()] * 2),
                ("v", [Replicate()] * 2))]
        o = attend(qkv[0], qkv[1], qkv[2], causal=True)
        ct = distribute_tensor(torch.from_numpy(inp["attn_ct"]), sub,
                               [Replicate()] * 2)
        grads = torch.autograd.grad((o * ct).sum(), qkv)
        out[f"attn_{fn}_o"] = o.full_tensor().detach().numpy()
        out[f"attn_{fn}_placements"] = np.asarray(
            [str(p) for p in o.placements])
        for n, g in zip("qkv", grads):
            out[f"attn_{fn}_d{n}"] = g.full_tensor().numpy()


def run(rank, world, inp):
    sys.path.insert(0, str(inp["tests"]))
    from test_torch_waits import within

    out = {}
    if world == 8:
        gpt2_steps(inp, "dp2fsdp2tp2", dict(dp=2, fsdp=2, tp=2), "dense",
                   out)
        return out
    # a sharded forward on the six-dim mesh (its size-1 axes present)
    def forward():
        cfg = gpt2.GPT2Config(vocab_size=int(inp["vocab"]),
                              n_positions=128, n_embd=64, n_layer=2,
                              n_head=4, dtype=torch.float32)
        mesh = MeshSpec(fsdp=2, tp=2).build(device_type="cpu")
        params = shard_params(tree(inp, "gpt2"), mesh,
                              gpt2.logical_axes(cfg))
        t0 = time.perf_counter()
        loss = gpt2.loss_fn(cfg, params, prepare_batch(
            inp["gpt2_tokens"], mesh))
        # and DTensor's own ops on the placed leaves
        norm = (params["blocks"]["attn_qkv_w"] * 2).sum().full_tensor()
        return float(loss), float(norm), time.perf_counter() - t0
    loss, norm, seconds = within(float(inp["forward_limit"]), forward)
    out["forward_loss"], out["forward_seconds"] = (np.asarray(loss),
                                                   np.asarray(seconds))
    out["forward_qkv_sum"] = np.asarray(norm)
    gpt2_steps(inp, "fsdp2tp2", dict(fsdp=2, tp=2), "dense", out)
    gpt2_steps(inp, "dp2fsdp2", dict(dp=2, fsdp=2), "dense", out)
    gpt2_steps(inp, "fsdp2tp2_flash", dict(fsdp=2, tp=2), "flash", out)
    lora_steps(inp, out)
    attention_on_dtensors(inp, out)
    return out
"""


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _jax_gpt2(params, tokens):
    """The reference's step on one device: losses and grad norms, the
    params after each step and the gradients each step took."""
    cfg = dataclasses.replace(jgpt2.GPT2Config.tiny(vocab_size=VOCAB),
                              dtype=jnp.float32)
    opt = jgpt2.default_optimizer(lr=GPT2_LR, warmup_steps=1, total_steps=10)
    state = opt.init(params)
    step = jax.jit(jgpt2.make_train_step(cfg, opt))
    grad = jax.jit(jax.grad(lambda p: jgpt2.loss_fn(cfg, p, tokens)))
    losses, norms, grads = [], [], []
    for _ in range(STEPS):
        grads.append(grad(params))
        params, state, m = step(params, state, tokens)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "params": params,
            "grads": grads}


def _jax_lora(base, lora, lora_b, tokens):
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=VOCAB),
                              dtype=jnp.float32)
    opt = optax.adamw(LORA_LR)
    state = opt.init(lora)
    step = jax.jit(jllama.make_lora_train_step(cfg, opt))
    grad = jax.jit(jax.grad(
        lambda lo: jllama.loss_fn(cfg, base, tokens, lora=lo)))
    losses, grads = [], []
    for _ in range(STEPS):
        grads.append(grad(lora))
        lora, state, m = step(base, lora, state, tokens)
        losses.append(float(m["loss"]))
    return {"loss": losses, "params": lora, "grads": grads,
            "lora_b_grads": grad(lora_b)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps and each group of ranks' readings: 4 ranks (two
    GPT-2 meshes, flash, LoRA, attention on DTensors, the six-dim
    forward) and 8 (GPT-2 over dp 2 x fsdp 2 x tp 2)."""
    rng = np.random.default_rng(22)
    gpt2_tokens = rng.integers(0, VOCAB, (8, 33)).astype(np.int32)
    lora_tokens = rng.integers(0, VOCAB, (4, 33)).astype(np.int32)
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    gp = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    lcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    base = jllama.init_params(lcfg, jax.random.PRNGKey(0))
    lora = jllama.init_lora(lcfg, jax.random.PRNGKey(1), rank=4)
    # B away from its zero init, so every adapter leaf has a gradient
    lora_b = {**lora, "blocks": {
        k: v if k.endswith("_a") else jnp.asarray(
            rng.standard_normal(v.shape).astype(np.float32) * 0.02)
        for k, v in lora["blocks"].items()}}
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inputs = {"tests": str(TESTS), "vocab": VOCAB, "steps": STEPS,
              "gpt2_lr": GPT2_LR, "lora_lr": LORA_LR, "forward_limit": 60.0,
              "gpt2_tokens": gpt2_tokens, "lora_tokens": lora_tokens,
              "attn_q": f(4, 16, 4, 8), "attn_k": f(4, 16, 4, 8),
              "attn_v": f(4, 16, 4, 8), "attn_ct": f(4, 16, 4, 8),
              **_flat(jax.tree.map(np.asarray, gp), "gpt2"),
              **_flat(jax.tree.map(np.asarray, base), "llama"),
              **_flat(jax.tree.map(np.asarray, lora), "lora"),
              **_flat(jax.tree.map(np.asarray, lora_b), "lora_b")}
    ranks4 = spawn(_TASK, 4, inputs, tmp_path_factory.mktemp("sharded4"))
    ranks8 = spawn(_TASK, 8, inputs, tmp_path_factory.mktemp("sharded8"))
    return {"inputs": inputs, "ranks": {4: ranks4, 8: ranks8},
            "gpt2": _jax_gpt2(gp, jnp.asarray(gpt2_tokens)),
            "lora": _jax_lora(base, lora, lora_b,
                              jnp.asarray(lora_tokens))}


def _hold(got, want, grads, lr):
    """Each leaf (flat dicts by the same keys) at 1e-5, or within 2 lr
    where the JAX gradient of any step was at rounding level."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        quiet = np.zeros(w.shape, bool)
        for g in grads:
            quiet |= np.abs(g[key]) < NOISE
        diff = np.abs(got[key] - w)
        ok = np.isclose(got[key], w, **TOL) | (quiet & (diff <= 2 * lr))
        assert ok.all(), (key, diff[~ok].max(), (~ok).sum())


def _leaves_of(out, prefix):
    """The port's leaves under `prefix`, keyed without it."""
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


def _jax_leaves(tree):
    return _flat(jax.tree.map(np.asarray, tree), "")


def _hold_grads(out, prefix, want):
    """The gradient of each leaf against JAX's at 1e-5 (what the Adam
    step's sign can hide)."""
    got, want = _leaves_of(out, prefix), _jax_leaves(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, err_msg=key, **TOL)


def _hold_leaves(out, prefix, want, grads, lr):
    """Each leaf of the port's step against the JAX step's."""
    _hold(_leaves_of(out, prefix), _jax_leaves(want),
          [_jax_leaves(g) for g in grads], lr)


@pytest.mark.parametrize("tag,world", [
    ("fsdp2tp2", 4), ("dp2fsdp2", 4), ("dp2fsdp2tp2", 8)])
def test_sharded_gpt2_step_matches_jax(runs, tag, world):
    """GPT-2 tiny in f32 on DTensor params over fsdp / tp / dp (the
    reference test's own dp 2 x fsdp 2 x tp 2 on 8 ranks): three steps
    of the default optimizer equal the JAX step's on one device, on every
    rank, and so do the first step's gradients; the AdamW moments hold
    their parameter's placements."""
    want = runs["gpt2"]
    ranks = runs["ranks"][world]
    for out in ranks:
        np.testing.assert_allclose(out[tag + "_loss"], want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out[tag + "_grad_norm"],
                                   want["grad_norm"], rtol=1e-5)
        _hold_grads(out, tag + "_grad", want["grads"][0])
        assert bool(out[tag + "_moment_placements_equal"])
        # the step's DTensors live on the axes of size > 1
        assert [str(n) for n in out[tag + "_mesh_dims"]] == re.findall(
            r"([a-z]+)\d", tag)
    _hold_leaves(ranks[0], tag, want["params"], want["grads"], GPT2_LR)


def test_sharded_lora_step_matches_jax(runs):
    """Llama tiny's LoRA step with the frozen base and the adapters both
    sharded over fsdp 2 x tp 2 (`lora_logical_axes`) equals the JAX
    step with `optax.adamw` on one device: losses and adapters, and the
    gradient of every adapter leaf (A, B and the scale) where B is not
    zero."""
    want = runs["lora"]
    for out in runs["ranks"][4]:
        np.testing.assert_allclose(out["lora_loss"], want["loss"],
                                   rtol=1e-5)
        _hold_grads(out, "lora_grad", want["lora_b_grads"])
    _hold_leaves(runs["ranks"][4][0], "lora", want["params"],
                 want["grads"], LORA_LR)


def test_flash_under_the_mesh_equals_dense(runs):
    """`attention="flash"` in the sharded step (on the CPU, the K1 / K2
    plain versions on each rank's local blocks: no dispatch to the plain
    attention) equals `"dense"` under the same mesh."""
    for out in runs["ranks"][4]:
        assert int(out["fsdp2tp2_flash_plain_dispatches"]) == 0
        for what in ("loss", "grad_norm"):
            np.testing.assert_allclose(out["fsdp2tp2_flash_" + what],
                                       out["fsdp2tp2_" + what], **TOL)
    out = runs["ranks"][4][0]
    _hold(_leaves_of(out, "fsdp2tp2_flash"), _leaves_of(out, "fsdp2tp2"),
          [_jax_leaves(g) for g in runs["gpt2"]["grads"]], GPT2_LR)


def test_attention_takes_dtensors(runs):
    """`plain_attention` and `flash_attention` on DTensor q / k / v (q
    split by batch and heads, k / v replicated) run on each rank's local
    blocks and equal dense attention on the whole tensors, gradients
    included; the output is split by batch and heads."""
    inp = runs["inputs"]
    q, k, v = (torch.from_numpy(inp["attn_" + n]).requires_grad_(True)
               for n in "qkv")
    from ray_tpu_torch.parallel.ring_attention import plain_attention

    o = plain_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(
        (o * torch.from_numpy(inp["attn_ct"])).sum(), (q, k, v))
    for out in runs["ranks"][4]:
        for fn in ("plain", "flash"):
            assert [str(p) for p in out[f"attn_{fn}_placements"]] == [
                "S(0)", "S(2)"]
            np.testing.assert_allclose(out[f"attn_{fn}_o"],
                                       o.detach().numpy(), **TOL)
            for n, g in zip("qkv", grads):
                np.testing.assert_allclose(out[f"attn_{fn}_d{n}"],
                                           g.numpy(), **TOL)


def test_sharded_forward_on_the_six_dim_mesh_returns(runs):
    """A regression for the stall: GPT-2's loss on params sharded over
    `MeshSpec(fsdp=2, tp=2).build()` (all six named axes, four of size
    1) returns inside its limit, equal to the JAX loss, and DTensor's own
    ops on the placed leaves return too."""
    inp = runs["inputs"]
    want_sum = 2 * inp["gpt2/blocks/attn_qkv_w"].astype(np.float64).sum()
    for out in runs["ranks"][4]:
        assert float(out["forward_seconds"]) < inp["forward_limit"]
        np.testing.assert_allclose(float(out["forward_loss"]),
                                   runs["gpt2"]["loss"][0], rtol=1e-5)
        np.testing.assert_allclose(float(out["forward_qkv_sum"]), want_sum,
                                   rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# the global-mesh trainer
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rt.init(num_workers=4, num_cpus=8, ignore_reinit_error=True)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    yield rt
    rt.shutdown()


def _gpt2_spmd_loop(config):
    """Tiny GPT-2 on the global mesh (`get_mesh()`, dp 2 x fsdp 2), a
    sharded checkpoint every step; a resumed attempt re-lays the
    checkpoint onto dp 1 x fsdp 4; rank `fail_rank` may die at
    `fail_at_step` (the reference's `_gpt2_spmd_loop`)."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import (MeshSpec, optimizer_shardings,
                                        tree_shardings)
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.sharding import distribute_tree, global_norm
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.cuda_utils import prepare_batch
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    ctx = train.get_context()
    n = ctx.get_world_size()
    resume = train.get_checkpoint()
    mesh = (ctx.get_mesh() if resume is None
            else MeshSpec(dp=1, fsdp=n).build(device_type="cpu"))
    dp, fsdp = axis_size(mesh, "dp"), axis_size(mesh, "fsdp")
    cfg = gpt2.GPT2Config(vocab_size=128, n_positions=32, n_embd=32,
                          n_layer=2, n_head=4, dtype=torch.float32)
    params = gpt2.init_params(cfg, 0, device="cpu")
    param_sh = tree_shardings(mesh, gpt2.logical_axes(cfg))
    opt = gpt2.default_optimizer(lr=1e-3, warmup_steps=1, total_steps=16)
    opt_state = distribute_tree(opt.init(params), mesh, optimizer_shardings(
        mesh, opt, params, param_sh))
    params = distribute_tree(params, mesh, param_sh)
    start = 0
    if resume is not None:
        with resume.as_directory() as d:
            state = load_sharded(d, {"params": params, "opt_state": opt_state,
                                     "step": 0, "pnorm": 0.0})
        params, opt_state = state["params"], state["opt_state"]
        start = int(state["step"])
        assert start > 0
        # the norm under the new layout equals the one saved under the old
        restored = float(global_norm(gpt2._leaves(params)))
        assert abs(restored - state["pnorm"]) <= 1e-6 * state["pnorm"], (
            restored, state["pnorm"])
    step_fn = gpt2.make_train_step(cfg, opt, mesh)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2 * n, 17)).astype(np.int32)
    for step in range(start, config["num_steps"]):
        params, opt_state, m = step_fn(params, opt_state,
                                       prepare_batch(tokens, mesh))
        if (config.get("fail_rank") is not None and resume is None
                and step == config["fail_at_step"]
                and ctx.get_world_rank() == config["fail_rank"]):
            os._exit(1)
        d = tempfile.mkdtemp(prefix="rtt_shck_")
        save_sharded({"params": params, "opt_state": opt_state,
                      "step": step + 1,
                      "pnorm": float(global_norm(gpt2._leaves(params)))}, d)
        ck = Checkpoint(d)
        ck._temp_source = True
        train.report({"loss": float(m["loss"]), "step": step + 1,
                      "mesh": f"dp{dp}xfsdp{fsdp}", "world": n,
                      "backend": dist.get_backend()}, checkpoint=ck)


def _trainer(tmp_path, name, loop_config, **run_kw):
    return CudaTrainer(
        _gpt2_spmd_loop, train_loop_config=loop_config,
        cuda_config=CudaConfig(device="cpu",
                               distributed_mode="torch_distributed"),
        scaling_config=ScalingConfig(num_workers=4,
                                     mesh_shape={"dp": 2, "fsdp": 2}),
        run_config=RunConfig(name=name, storage_path=str(tmp_path),
                             **run_kw))


def test_global_mesh_trainer_trains_sharded(cluster, tmp_path):
    """Four workers in one gloo group train tiny GPT-2 under the global
    dp 2 x fsdp 2 mesh, a sharded checkpoint every step: three steps,
    the loss falling."""
    result = bounded_fit(_trainer(tmp_path, "sharded", {"num_steps": 3}))
    assert result.error is None, result.error
    m = result.metrics
    assert (m["world"], m["backend"], m["mesh"], m["step"]) == (
        4, "gloo", "dp2xfsdp2", 3)
    losses = [r["loss"] for r in result.metrics_history]
    assert losses[-1] < losses[0], losses


def test_global_mesh_trainer_restart_reshards(cluster, tmp_path):
    """Rank 1 dies at step 2; the restarted group resumes from the sharded
    checkpoint on dp 1 x fsdp 4 (its params' norm equal to the saved
    one) and ends at step 4, the count continued."""
    result = bounded_fit(_trainer(
        tmp_path, "sharded_ft",
        {"num_steps": 4, "fail_rank": 1, "fail_at_step": 2},
        failure_config=FailureConfig(max_failures=1)))
    assert result.error is None, result.error
    assert result.metrics["mesh"] == "dp1xfsdp4"
    assert result.metrics["step"] == 4
    losses = [r["loss"] for r in result.metrics_history]
    assert losses[-1] < losses[0], losses
