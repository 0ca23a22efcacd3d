"""The port's train plane over a process group on the CPU, shaped as
the JAX package's `tests/test_train_distributed.py`: the
"torch_distributed" mode (gloo here; the counterpart of
"jax_distributed") with a mesh from `ScalingConfig.mesh_shape`, and the
sharded checkpoint resharded across mesh shapes and read and written in
the JAX package's on-disk format.  Process-group cases run on gloo
ranks spawned with their own timeout (`test_torch_parallel.spawn`);
inputs are seeded (RT008).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    CudaConfig,
    CudaTrainer,
    RunConfig,
    ScalingConfig,
)
from test_torch_parallel import spawn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cluster():
    # one intra-op thread a worker: tiny models gain nothing from more,
    # and the parallel test run's other files share the cores
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    yield rt
    rt.shutdown()


@pytest.fixture(scope="module")
def lora_model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jl = jllama.init_lora(jcfg, jax.random.PRNGKey(1), rank=8)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=128),
                               dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, 128, (4, 17)).astype(
        np.int32)
    return jcfg, jparams, jl, tcfg, tokens


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------
# torch_distributed over gloo: the mesh, and the sharded checkpoint
# ----------------------------------------------------------------------
def test_torch_distributed_builds_the_mesh_and_trains_over_it(
        cluster, lora_model, tmp_path):
    """`distributed_mode="torch_distributed"` joins both workers in one
    gloo group (the counterpart of "jax_distributed"); `get_mesh()`
    builds `ScalingConfig.mesh_shape` over it, and the LoRA loss with
    ring attention over its sp axis equals the dense loss; the group is
    destroyed at shutdown."""
    _, jparams, jl, tcfg, tokens = lora_model

    def loop(config):
        import torch.distributed as dist

        from ray_tpu_torch.models.bridge import params_from_numpy

        ctx = train.get_context()
        mesh = ctx.get_mesh()
        params = params_from_numpy(config["params"], "cpu")
        lora = params_from_numpy(config["lora"], "cpu")
        toks = torch.from_numpy(config["tokens"])
        ring = dataclasses.replace(config["cfg"], attention="ring")
        train.report({
            "world": dist.get_world_size(), "backend": dist.get_backend(),
            "shape": list(mesh.mesh.shape), "dims": list(mesh.mesh_dim_names),
            "device_type": mesh.device_type,
            "ring": float(tllama.loss_fn(ring, params, toks, mesh, lora)),
            "dense": float(tllama.loss_fn(config["cfg"], params, toks,
                                          lora=lora))})

    result = CudaTrainer(
        loop, cuda_config=CudaConfig(device="cpu",
                                     distributed_mode="torch_distributed"),
        train_loop_config={"cfg": tcfg, "params": _np_tree(jparams),
                           "lora": _np_tree(jl), "tokens": tokens},
        scaling_config=ScalingConfig(num_workers=2,
                                     mesh_shape={"sp": 2}),
        run_config=RunConfig(name="td", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert (m["world"], m["backend"], m["device_type"]) == (2, "gloo", "cpu")
    assert m["dims"] == ["dp", "fsdp", "pp", "ep", "sp", "tp"]
    assert m["shape"] == [1, 1, 1, 1, 2, 1]
    np.testing.assert_allclose(m["ring"], m["dense"], **TOL)


_SHARDED_TASK = """
import os
import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train.cuda_utils import prepare_batch
from ray_tpu_torch.train.sharded_checkpoint import load_sharded, save_sharded

def run(rank, world, inp):
    d = str(inp["dir"])
    ref = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    out = {}
    if str(inp["mode"]) == "save_fsdp":
        mesh = MeshSpec(fsdp=world).build(device_type="cpu")
        w = distribute_tensor(torch.from_numpy(ref), mesh,
                              [Replicate(), Shard(0)] + [Replicate()] * 4)
        b = distribute_tensor(torch.arange(8.0), mesh, [Replicate()] * 6)
        tree = {"w": w, "b": b, "step": 7, "plain": torch.ones(3)}
        if bool(inp["bf16"]):
            tree["h"] = distribute_tensor(
                torch.from_numpy(ref).bfloat16(), mesh,
                [Replicate(), Shard(1)] + [Replicate()] * 4)
        save_sharded(tree, d)
    else:
        mesh = MeshSpec(dp=2, fsdp=world // 2).build(device_type="cpu")
        tw = distribute_tensor(torch.zeros(16, 8), mesh,
                               [Shard(0), Shard(0)] + [Replicate()] * 4)
        tb = distribute_tensor(torch.zeros(8), mesh,
                               [Replicate(), Shard(0)] + [Replicate()] * 4)
        target = {"w": tw, "b": tb, "step": 0, "plain": torch.zeros(3)}
        if bool(inp["bf16"]):
            target["h"] = distribute_tensor(
                torch.zeros(16, 8).bfloat16(), mesh,
                [Shard(1), Replicate()] + [Replicate()] * 4)
        got = load_sharded(d, target)
        out["w"] = got["w"].full_tensor().numpy()
        out["b"] = got["b"].full_tensor().numpy()
        if bool(inp["bf16"]):
            out["h"] = got["h"].full_tensor().float().numpy()
        out["w_local"] = got["w"].to_local().numpy()
        out["batch_local"] = prepare_batch(ref, mesh).to_local().numpy()
        out["step"] = np.asarray(got["step"])
        out["plain"] = got["plain"].numpy()
    return out
"""


def test_sharded_checkpoint_reshards_across_mesh_shapes(tmp_path):
    """4 gloo ranks save under fsdp 4 (f32 rows split, a bf16 leaf split
    by columns, a replicated leaf written once, a plain tensor and a
    step from rank 0); 4 ranks load under dp 2 x fsdp 2: every leaf
    reassembles exactly, each rank holding its own block (the block
    `prepare_batch` gives it of the same rows)."""
    d = tmp_path / "ck"
    spawn(_SHARDED_TASK, 4, {"dir": str(d), "mode": "save_fsdp",
                             "bf16": True}, tmp_path / "save")
    names = sorted(os.listdir(d))
    assert "sharded_manifest.json" in names
    assert [n for n in names if n.startswith("pieces_r")] == [
        f"pieces_r{r:05d}.{e}" for r in range(4) for e in ("json", "npz")]
    manifest = json.load(open(d / "sharded_manifest.json"))
    assert manifest["num_processes"] == 4
    assert set(manifest["leaves"]) == {"['w']", "['b']", "['h']",
                                       "['plain']"}
    assert manifest["leaves"]["['h']"]["dtype"] == "bfloat16"
    pieces = [e for r in range(4)
              for e in json.load(open(d / f"pieces_r{r:05d}.json"))]
    assert sum(p["leaf"] == "['b']" for p in pieces) == 1  # replicated once
    outs = spawn(_SHARDED_TASK, 4, {"dir": str(d), "mode": "load",
                                    "bf16": True}, tmp_path / "load")
    ref = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["w"], ref)
        np.testing.assert_array_equal(out["w_local"], ref[4 * r:4 * r + 4])
        # prepare_batch splits the batch over (dp, fsdp), as the weight
        np.testing.assert_array_equal(out["batch_local"], out["w_local"])
        np.testing.assert_array_equal(out["b"], np.arange(8.0))
        np.testing.assert_array_equal(out["h"], ref)
        assert int(out["step"]) == 7
        np.testing.assert_array_equal(out["plain"], np.ones(3))


def test_sharded_checkpoint_format_crosses_both_packages(tmp_path):
    """A directory the JAX package's `save_sharded` writes on its 8 CPU
    devices (f32, rows split over fsdp) loads in the port at 2 ranks
    under another layout; the port's directory (2 ranks) loads in the
    JAX package onto its 8-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.train.sharded_checkpoint import (load_sharded as jload,
                                                  save_sharded as jsave)

    ref = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    mesh = JMeshSpec(fsdp=8).build(jax.devices()[:8])
    d = tmp_path / "from_jax"
    jsave({"w": jax.device_put(jnp.asarray(ref),
                               NamedSharding(mesh, P("fsdp", None))),
           "b": jax.device_put(jnp.arange(8.0), NamedSharding(mesh, P())),
           "plain": jnp.ones(3), "step": 7}, str(d))
    outs = spawn(_SHARDED_TASK, 2, {"dir": str(d), "mode": "load",
                                    "bf16": False}, tmp_path / "load")
    for out in outs:
        np.testing.assert_array_equal(out["w"], ref)
        np.testing.assert_array_equal(out["b"], np.arange(8.0))
        assert int(out["step"]) == 7
    back = tmp_path / "from_port"
    spawn(_SHARDED_TASK, 2, {"dir": str(back), "mode": "save_fsdp",
                             "bf16": False}, tmp_path / "save")
    jmesh = JMeshSpec(dp=2, fsdp=4).build(jax.devices()[:8])
    got = jload(str(back), {
        "w": jax.device_put(jnp.zeros((16, 8)),
                            NamedSharding(jmesh, P(("dp", "fsdp"), None))),
        "b": jax.device_put(jnp.zeros(8), NamedSharding(jmesh, P("fsdp"))),
        "plain": jnp.zeros(3), "step": 0})
    np.testing.assert_array_equal(np.asarray(got["w"]), ref)
    np.testing.assert_array_equal(np.asarray(got["b"]), np.arange(8.0))
    np.testing.assert_array_equal(np.asarray(got["plain"]), np.ones(3))
    assert int(got["step"]) == 7


def test_sharded_checkpoint_missing_leaf_and_shape_mismatch(tmp_path):
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    d = str(tmp_path / "ck")
    save_sharded({"w": torch.arange(6.0), "n": 3}, d)
    got = load_sharded(d, {"w": torch.zeros(6), "n": 0})
    assert torch.equal(got["w"], torch.arange(6.0)) and got["n"] == 3
    with pytest.raises(KeyError):
        load_sharded(d, {"w": torch.zeros(6), "missing": torch.zeros(2)})
    with pytest.raises(ValueError, match="target shape"):
        load_sharded(d, {"w": torch.zeros(7), "n": 0})
    with pytest.raises(FileNotFoundError):
        load_sharded(str(tmp_path / "nothing"), {})


def test_sharded_checkpoint_ignores_stale_rank_files(tmp_path):
    """A directory reused by a smaller world: the rank files beyond the
    manifest's `num_processes` are ignored."""
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    d, old = tmp_path / "ck", tmp_path / "old"
    save_sharded({"w": torch.full((4,), 9.0)}, str(old), num_processes=2)
    d.mkdir()
    for ext in ("json", "npz"):  # an earlier, larger save's rank 1
        shutil.copy(old / f"pieces_r00000.{ext}", d / f"pieces_r00001.{ext}")
    save_sharded({"w": torch.arange(4.0)}, str(d), rank=0, num_processes=1)
    got = load_sharded(str(d), {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0))

