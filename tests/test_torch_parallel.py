"""Port parity: `ray_tpu_torch.parallel` (meshes, logical sharding,
collectives, ring and Ulysses attention) and `util/collective.py`
against the JAX package's `ray_tpu.parallel` on the CPU.

JAX runs on its 8-device CPU mesh (`tests/conftest.py`); the port runs
on 2 or 4 ranks of a gloo process group, each a subprocess spawned with
a timeout of its own (`spawn`), so a hung rank fails its test and does
not stall the run.  Each group of ranks runs once a module and returns
all its readings; the tests hold those against the JAX package on the
same seeded numpy inputs (RT008) at rtol / atol 1e-5 (f32), and the
collectives against numpy.  The host tier (`CollectiveGroup`) runs on
the port's runtime and on the JAX package's, with the same inputs.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.parallel import MeshSpec as JMeshSpec  # noqa: E402
from ray_tpu.parallel import collectives as jcoll  # noqa: E402
from ray_tpu.parallel import ring_attention as jra  # noqa: E402
from ray_tpu.parallel import sharding as jsharding  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel import MeshSpec, sharding  # noqa: E402
from ray_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from ray_tpu_torch.parallel.mesh import AXES  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)

# ----------------------------------------------------------------------
# gloo ranks in subprocesses
# ----------------------------------------------------------------------
_RANK_MAIN = r"""
import datetime, os, sys, time
import numpy as np
rank, world, work, repo = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
sys.path.insert(0, repo)
import torch
import torch.distributed as dist
torch.set_num_threads(1)
# rank 0's store takes a port from the OS and publishes it in the work
# dir: a port picked by the parent and released could be taken by another
# group's gloo sockets before rank 0 binds it (EADDRINUSE)
limit = datetime.timedelta(seconds=60)
published = os.path.join(work, "store_port")
if rank == 0:
    store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=limit,
                          wait_for_workers=False)
    with open(published + ".tmp", "w") as f:
        f.write(str(store.port))
    os.replace(published + ".tmp", published)
else:
    deadline = time.monotonic() + limit.total_seconds()
    while not os.path.exists(published):
        if time.monotonic() > deadline:
            raise TimeoutError("rank 0 published no store port")
        time.sleep(0.02)
    with open(published) as f:
        store = dist.TCPStore("127.0.0.1", int(f.read()), world, False,
                              timeout=limit)
dist.init_process_group("gloo", store=store, world_size=world, rank=rank,
                        timeout=limit)
ns = {}
with open(os.path.join(work, "task.py")) as f:
    exec(f.read(), ns)
inputs = dict(np.load(os.path.join(work, "inputs.npz"), allow_pickle=True))
out = ns["run"](rank, world, inputs)
np.savez(os.path.join(work, f"out_r{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
# skip the interpreter's teardown: gloo's threads torn down there can
# abort the process ("terminate called without an active exception")
# after its results are written
os._exit(0)
"""


def spawn(task: str, world: int, inputs: dict, work: Path,
          timeout: float = 150.0):
    """Run `run(rank, world, inputs) -> {name: array}` (defined in the
    source `task`) on `world` gloo ranks; returns each rank's dict.  A
    rank that outlives `timeout` is killed and the call fails."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "task.py").write_text(textwrap.dedent(task))
    (work / "store_port").unlink(missing_ok=True)
    np.savez(work / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, str(r), str(world), str(work),
         str(REPO)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a gloo rank outlived {timeout}s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(work / f"out_r{r}.npz")) for r in range(world)]


# ----------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------
SPECS = [
    dict(dp=8), dict(dp=-1, tp=2), dict(fsdp=2, tp=4), dict(dp=2, tp=2, sp=2),
    dict(sp=4, tp=2), dict(sp=4, dp=2), dict(dp=4, fsdp=2),
    dict(dp=2, fsdp=2, tp=2, slices=2), dict(dp=1, fsdp=4, tp=2, slices=2),
    dict(dp=4, tp=2, slices=2), dict(dp=2, ep=2, pp=2),
    dict(dp=3), dict(tp=8, slices=2), dict(dp=-1, tp=-1), dict(dp=16),
]


FIELDS = ("dp", "fsdp", "tp", "sp", "ep", "pp", "slices")


def _port_of(jspec):
    return MeshSpec(**{k: getattr(jspec, k) for k in FIELDS})


def _both(fn):
    """fn's result, or the exception type it raised."""
    try:
        return fn()
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_mesh_layout_matches_jax(kw):
    """`resolve`, `dcn_split`, the slice groups and where each rank sits
    (the DeviceMesh's rank array) equal the JAX package's answers and
    device layout on its 8 CPU devices, errors included."""
    devs = jax.devices()[:8]
    j, t = JMeshSpec(**kw), MeshSpec(**kw)
    assert _both(lambda: t.resolve(8)) == _both(
        lambda: _port_of(j.resolve(8)))
    assert _both(t.dcn_split) == _both(j.dcn_split)
    jb = _both(lambda: j.build(devs))
    tb = _both(lambda: t.rank_array(range(8)))
    if isinstance(jb, type):
        assert tb is jb
        return
    ids = np.vectorize(lambda d: d.id)(jb.devices)
    np.testing.assert_array_equal(tb, ids)
    assert tuple(jb.axis_names) == AXES
    assert [[d.id for d in g] for g in j.slice_device_groups(devs)] == \
        t.slice_device_groups(list(range(8)))


@pytest.mark.parametrize("kw,n", [
    (dict(dp=2, fsdp=2, tp=2), 4), (dict(dp=4, fsdp=2), 4),
    (dict(dp=1, fsdp=2), 8), (dict(tp=4), 2), (dict(tp=3), 4),
    (dict(dp=-1), 6), (dict(dp=2, fsdp=3, sp=2), 6),
    (dict(dp=4, tp=2, slices=2), 6), (dict(dp=2), 0),
])
def test_fit_to_matches_jax(kw, n):
    got = _both(lambda: MeshSpec(**kw).fit_to(n))
    want = _both(lambda: JMeshSpec(**kw).fit_to(n))
    if isinstance(want, type):
        assert got is want
    else:
        assert got == _port_of(want)


# ----------------------------------------------------------------------
# logical sharding
# ----------------------------------------------------------------------
def _logical_tuples():
    cfg = jllama.LlamaConfig.tiny(vocab_size=128)
    lora = jllama.init_lora(cfg, jax.random.PRNGKey(1), rank=4,
                            targets=("wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_down"))
    trees = [jllama.logical_axes(cfg), jllama.lora_logical_axes(cfg, lora)]
    leaves = [x for t in trees for x in jax.tree.leaves(
        t, is_leaf=lambda x: isinstance(x, tuple))]
    return sorted(set(leaves), key=repr) + [("batch", "seq", None)]


def _jax_placement(spec, ndim):
    """For each mesh axis in AXES order: the tensor dim it splits, or
    None — what a DTensor's placements say."""
    out = {a: None for a in AXES}
    for dim, ax in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            out[a] = dim
    return [out[a] for a in AXES]


@pytest.mark.parametrize("logical", _logical_tuples(), ids=repr)
def test_spec_from_logical_matches_jax(logical):
    want = _jax_placement(jsharding.spec_from_logical(logical), len(logical))
    got = [p.dim if p.is_shard() else None
           for p in sharding.spec_from_logical(logical)]
    assert got == want
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


def test_tree_and_optimizer_shardings_follow_the_params():
    """`tree_shardings` maps every logical leaf; `optimizer_shardings`
    gives AdamW's per-leaf moments their parameter's placements (the
    reference's longest-suffix rule, over the port's `_leaves`-aligned
    state) and replicates the step count."""
    from ray_tpu_torch.models import gpt2

    cfg = tllama.LlamaConfig.tiny(vocab_size=128)
    params = tllama.init_params(cfg, 0, device="cpu")
    sh = sharding.tree_shardings(None, tllama.logical_axes(cfg))
    assert sh["blocks"]["wq"] == sharding.spec_from_logical(
        (None, "embed", "heads"))
    opt = sharding.optimizer_shardings(None, gpt2.AdamW(lambda c: 1e-3),
                                       params, sh)
    leaves = [pl for _, pl in sharding.tree_paths(sh, sharding._is_logical)]
    assert opt["mu"] == leaves and opt["nu"] == leaves
    assert all(p.is_replicate() for p in opt["count"])

    class Optax:  # state embedding the param tree, as optax's does
        def init(self, p):
            return {"mu": p, "step": torch.zeros(())}

    opt = sharding.optimizer_shardings(None, Optax(), params, sh)
    assert opt["mu"] == sh
    assert all(p.is_replicate() for p in opt["step"])


# ----------------------------------------------------------------------
# in-program collectives and sequence-parallel attention on gloo ranks
# ----------------------------------------------------------------------
SHAPE = (2, 16, 4, 8)  # B, T, H, D

_PARALLEL_TASK = """
import numpy as np
import torch
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.ring_attention import (ring_attention,
                                                   ulysses_attention)

def _attn(fn, mesh, inp, causal, tag, out):
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    o = fn(q, k, v, mesh, causal=causal)
    gq, gk, gv = torch.autograd.grad(
        (o * torch.from_numpy(inp["ct"])).sum(), (q, k, v))
    out[tag] = o.detach().numpy()
    out[tag + "_dq"], out[tag + "_dk"], out[tag + "_dv"] = (
        gq.numpy(), gk.numpy(), gv.numpy())

def run(rank, world, inp):
    out = {}
    mesh = MeshSpec(sp=world).build(device_type="cpu")
    x = torch.from_numpy(inp["x"][rank])
    out["psum"] = C.psum(x, "sp", mesh=mesh).numpy()
    out["pmean"] = C.pmean(x, "sp", mesh=mesh).numpy()
    out["gather0"] = C.all_gather(x, "sp", axis=0, mesh=mesh).numpy()
    out["gather1_untiled"] = C.all_gather(x, "sp", axis=1, tiled=False,
                                          mesh=mesh).numpy()
    out["scatter"] = C.reduce_scatter(x, "sp", mesh=mesh).numpy()
    out["scatter_untiled"] = C.reduce_scatter(
        x[:world], "sp", tiled=False, mesh=mesh).numpy()
    out["ppermute"] = C.ppermute(x, "sp", [(0, 1), (1, 0)],
                                 mesh=mesh).numpy()
    out["a2a"] = C.all_to_all(x, "sp", 0, 1, mesh=mesh).numpy()
    out["a2a_untiled"] = C.all_to_all(x[:world], "sp", 0, 1, tiled=False,
                                      mesh=mesh).numpy()
    ring = [(j, (j + 1) % world) for j in range(world)]
    w = torch.from_numpy(inp["w"][rank])
    xg = x.clone().requires_grad_(True)
    (C.ppermute(xg, "sp", ring, mesh=mesh) * w).sum().backward()
    out["ppermute_grad"] = xg.grad.numpy()
    xg = x.clone().requires_grad_(True)
    (C.all_to_all(xg, "sp", 0, 1, mesh=mesh) * w.reshape(
        x.shape[0] // world, -1)).sum().backward()
    out["a2a_grad"] = xg.grad.numpy()
    for causal in (False, True):
        _attn(ring_attention, mesh, inp, causal, f"ring{int(causal)}", out)
        _attn(ulysses_attention, mesh, inp, causal, f"uly{int(causal)}", out)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import (local_batch_size, mesh_from_devices,
                                        shard_params)
    out["local_batch"] = np.asarray(local_batch_size(mesh, 8))
    out["from_devices"] = np.asarray(mesh_from_devices(
        device_type="cpu", sp=world).mesh.shape)
    if world == 4:
        mixed = MeshSpec(dp=2, sp=2).build(device_type="cpu")
        _attn(ring_attention, mixed, inp, True, "ring_dp2sp2", out)
        out["local_batch_dp2"] = np.asarray(local_batch_size(mixed, 8))
        zero = MeshSpec(fsdp=2, tp=2).build(device_type="cpu")
        cfg = llama.LlamaConfig.tiny(vocab_size=128)
        params = llama.init_params(cfg, 0, device="cpu")
        sharded = shard_params(params, zero, llama.logical_axes(cfg))
        for name in ("tok_emb", "final_norm"):
            out[name + "_local"] = sharded[name].to_local().numpy()
            out[name + "_full"] = sharded[name].full_tensor().numpy()
        out["wq_local"] = sharded["blocks"]["wq"].to_local().numpy()
        out["wq"] = params["blocks"]["wq"].numpy()
        out["tok_emb"] = params["tok_emb"].numpy()
    return out
"""


def _attention_inputs(world):
    rng = np.random.default_rng(100 + world)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(*SHAPE), "k": f(*SHAPE), "v": f(*SHAPE),
            "ct": f(*SHAPE), "x": f(world, 2 * world, 3),
            "w": f(world, 2 * world, 3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (inputs, each rank's readings), for 2 and 4 ranks."""
    out = {}
    for world in (2, 4):
        inputs = _attention_inputs(world)
        out[world] = (inputs, spawn(
            _PARALLEL_TASK, world, inputs,
            tmp_path_factory.mktemp(f"parallel{world}")))
    return out


@pytest.fixture(params=[2, 4], ids=["sp2", "sp4"])
def ranks(request, runs):
    return (request.param, *runs[request.param])


def _jax_attention(fn, world, inputs, causal, **axes):
    mesh = JMeshSpec(**(axes or {"sp": world})).build(jax.devices()[:world])
    q, k, v, ct = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "ct"))


    @jax.jit
    def f(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: fn(*a, mesh, causal=causal), q, k, v)
        return (out, *vjp(ct))

    with mesh:
        return [np.asarray(x) for x in f(q, k, v, ct)]


@pytest.mark.parametrize("kind", ["ring", "uly"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(ranks, kind, causal):
    """Every rank's gathered output and gradients (q, k, v, under one
    seeded cotangent) equal the JAX package's `ring_attention` /
    `ulysses_attention` over its sp mesh, and its dense attention."""
    world, inputs, outs = ranks
    fn = jra.ring_attention if kind == "ring" else jra.ulysses_attention
    want = _jax_attention(fn, world, inputs, causal)
    dense = np.asarray(jra.plain_attention(
        *(jnp.asarray(inputs[n]) for n in ("q", "k", "v")), causal=causal))
    tag = f"{kind}{int(causal)}"
    for out in outs:
        for suffix, w in zip(("", "_dq", "_dk", "_dv"), want):
            np.testing.assert_allclose(out[tag + suffix], w,
                                       err_msg=tag + suffix, **TOL)
        np.testing.assert_allclose(out[tag], dense, **TOL)


def test_ring_attention_over_a_mixed_mesh_matches_jax(runs):
    """dp 2 x sp 2 on 4 ranks: the batch splits over dp while the ring
    runs over sp; the output and gradients equal JAX's over the same
    mesh."""
    inputs, outs = runs[4]
    want = _jax_attention(jra.ring_attention, 4, inputs, True, dp=2, sp=2)
    for out in outs:
        for suffix, w in zip(("", "_dq", "_dk", "_dv"), want):
            np.testing.assert_allclose(out["ring_dp2sp2" + suffix], w,
                                       **TOL)


def test_mesh_helpers_and_shard_params_over_ranks(runs):
    """`local_batch_size` divides by dp x fsdp, `mesh_from_devices`
    builds over the world, and `shard_params` (fsdp 2 x tp 2) gives each
    rank its block of the logical rules' split while the DTensor still
    holds the whole parameter."""
    for world, (_, outs) in runs.items():
        for out in outs:
            assert int(out["local_batch"]) == 8
            assert out["from_devices"].tolist() == [1, 1, 1, 1, world, 1]
    _, outs = runs[4]
    for r, out in enumerate(outs):
        assert int(out["local_batch_dp2"]) == 4
        fsdp, tp = divmod(r, 2)
        # tok_emb ("vocab", "embed"): rows over tp, columns over fsdp
        V, E = out["tok_emb"].shape
        want = out["tok_emb"][tp * V // 2:(tp + 1) * V // 2,
                              fsdp * E // 2:(fsdp + 1) * E // 2]
        np.testing.assert_array_equal(out["tok_emb_local"], want)
        np.testing.assert_array_equal(out["tok_emb_full"], out["tok_emb"])
        # wq (None, "embed", "heads")
        L, E2, HD = out["wq"].shape
        np.testing.assert_array_equal(
            out["wq_local"], out["wq"][:, fsdp * E2 // 2:(fsdp + 1) * E2 // 2,
                                       tp * HD // 2:(tp + 1) * HD // 2])
        assert out["final_norm_local"].shape == (E // 2,)


def test_data_sharding_and_replicated_match_jax():
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel import (batch_axes, data_sharding,
                                        replicated)

    assert batch_axes() == jmesh.batch_axes()
    dims = lambda pl: [p.dim if p.is_shard() else None for p in pl]  # noqa: E731
    assert dims(data_sharding(None)) == _jax_placement(P(("dp", "fsdp")), 1)
    assert dims(data_sharding(None, "sp", "tp")) == _jax_placement(
        P(("dp", "fsdp"), "sp", "tp"), 3)
    assert dims(replicated(None)) == [None] * 6
    assert sharding.infer_logical_like({"a": torch.zeros(2), "b": [
        torch.zeros(1)]}, ("embed",)) == {"a": ("embed",), "b": [("embed",)]}
    with pytest.raises(ValueError, match="two dims"):
        sharding.spec_from_logical(("embed", "embed"))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.spec_from_logical(("x",), {"x": ("fsdp", "dp")})


def _np_collectives(world, x, w):
    """What each collective must give each rank, from numpy."""
    n2 = x.shape[1] // world
    total = x.sum(0)
    want = []
    for r in range(world):
        perm_src = {1: 0, 0: 1}
        pp = x[perm_src[r]] if r in perm_src else np.zeros_like(x[r])
        a2a = np.concatenate([x[s][r * n2:(r + 1) * n2]
                              for s in range(world)], axis=1)
        want.append({
            "psum": total, "pmean": total / world,
            "gather0": np.concatenate(list(x), 0),
            "gather1_untiled": np.stack(list(x), 1),
            "scatter": total[r * n2:(r + 1) * n2],
            "scatter_untiled": x[:, :world].sum(0)[r],
            "ppermute": pp, "a2a": a2a,
            "a2a_untiled": np.stack([x[s][r] for s in range(world)], 1),
            # the gradient of ppermute over the ring: what reached the
            # next rank is weighted by that rank's w
            "ppermute_grad": w[(r + 1) % world],
            # the inverse all-to-all of w (as laid out by the forward)
            "a2a_grad": np.concatenate(
                [w[d].reshape(n2, -1)[:, r * 3:(r + 1) * 3]
                 for d in range(world)], axis=0),
        })
    return want


@pytest.mark.parametrize("name", [
    "psum", "pmean", "gather0", "gather1_untiled", "scatter",
    "scatter_untiled", "ppermute", "a2a", "a2a_untiled", "ppermute_grad",
    "a2a_grad"])
def test_in_program_collectives_match_numpy(ranks, name):
    world, inputs, outs = ranks
    want = _np_collectives(world, inputs["x"], inputs["w"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[name], want[r][name], err_msg=name,
                                   **TOL)


def test_in_program_collectives_match_jax_lax(ranks):
    """The same collectives through `jax.lax` under `pmap` over
    `world` CPU devices give the same values (untiled shapes too)."""
    world, inputs, outs = ranks
    x = jnp.asarray(inputs["x"])
    f = lambda g: jax.pmap(g, axis_name="i", devices=jax.devices()[:world])  # noqa: E731
    got = {
        "gather1_untiled": f(lambda a: jcoll.all_gather(a, "i", axis=1,
                                                        tiled=False))(x),
        "scatter": f(lambda a: jcoll.reduce_scatter(a, "i"))(x),
        "ppermute": f(lambda a: jcoll.ppermute(a, "i", [(0, 1), (1, 0)]))(x),
        "a2a": f(lambda a: jcoll.all_to_all(a, "i", 0, 1))(x),
        "a2a_untiled": f(lambda a: jcoll.all_to_all(
            a[:world], "i", 0, 1, tiled=False))(x),
    }
    for name, arr in got.items():
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[name], np.asarray(arr[r]),
                                       err_msg=name, **TOL)


def test_collectives_refuse_bad_arguments():
    """A mesh axis name without a mesh, and a permutation that repeats
    a member or names one outside the axis, are refused."""
    with pytest.raises(ValueError, match="mesh="):
        tcoll.psum(torch.zeros(2), "sp")
    with pytest.raises(ValueError, match="repeats"):
        tcoll._check_perm([(0, 1), (0, 1)], 2)
    with pytest.raises(ValueError, match="outside"):
        tcoll._check_perm([(0, 2)], 2)


# ----------------------------------------------------------------------
# llama over the sp mesh
# ----------------------------------------------------------------------
_LLAMA_TASK = """
import dataclasses
import torch
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.bridge import params_from_numpy
from ray_tpu_torch.parallel import MeshSpec

def run(rank, world, inp):
    mesh = MeshSpec(sp=world).build(device_type="cpu")
    tree = inp["params"].item()
    params = params_from_numpy(tree, "cpu")
    out = {}
    for kind in ("ring", "ulysses"):
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                                  dtype=torch.float32, attention=kind)
        toks = torch.from_numpy(inp["tokens"])
        out[kind + "_loss"] = llama.loss_fn(cfg, params, toks,
                                            mesh).detach().numpy()
        out[kind + "_logits"] = llama.forward(
            cfg, params, toks[:, :-1], mesh).detach().numpy()
    return out
"""


def test_llama_loss_over_an_sp_mesh_matches_jax(tmp_path):
    """`llama.loss_fn` / `forward` with attention "ring" or "ulysses"
    over an sp 2 mesh on 2 gloo ranks equal the JAX package's over its
    sp 2 mesh, and its dense loss."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=128)
    import dataclasses

    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(7).integers(0, 128, (2, 17)).astype(
        np.int32)
    inputs = {"params": np.array(jax.tree.map(np.asarray, jparams),
                                 dtype=object), "tokens": tokens}
    outs = spawn(_LLAMA_TASK, 2, inputs, tmp_path / "llama")
    mesh = JMeshSpec(sp=2).build(jax.devices()[:2])
    dense = float(jllama.loss_fn(jcfg, jparams, jnp.asarray(tokens)))
    for kind in ("ring", "ulysses"):
        cfg = dataclasses.replace(jcfg, attention=kind)
        with mesh:
            loss = float(jax.jit(lambda p, t: jllama.loss_fn(
                cfg, p, t, mesh))(jparams, jnp.asarray(tokens)))
            logits = np.asarray(jax.jit(lambda p, t: jllama.forward(
                cfg, p, t, mesh))(jparams, jnp.asarray(tokens[:, :-1])))
        for out in outs:
            np.testing.assert_allclose(out[kind + "_loss"], loss, **TOL)
            np.testing.assert_allclose(out[kind + "_loss"], dense, **TOL)
            np.testing.assert_allclose(out[kind + "_logits"], logits, **TOL)


def test_util_collective_reexports_the_parallel_tier():
    from ray_tpu.util import collective as jre
    from ray_tpu_torch.util import collective as tre

    assert tre.__all__ == jre.__all__
    for name in tre.__all__:
        assert getattr(tre, name) is getattr(tcoll, name)
