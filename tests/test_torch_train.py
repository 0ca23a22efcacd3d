"""The port's train plane (`ray_tpu_torch.train`) on the CPU, shaped as
the JAX package's `tests/test_train.py` and `test_train_distributed.py`,
plus the data-parallel LoRA trainer held against the JAX package.

One module-scoped cluster of the port's runtime (its GPU count forced to
1 through `RTT_GPUS`, so fractional GPU workers can be placed) serves
every fit; `CudaConfig(device="cpu")` keeps the workers off the card.
The parity test trains a tiny f32 Llama LoRA on 2 workers with
half-batches and synced gradients and holds the adapters after 3 steps
to the JAX package's `make_lora_train_step` on the whole batch at rtol /
atol 1e-5 (seeded numpy inputs, RT008).  The process-group mode and the
sharded checkpoint are in `test_torch_train_distributed.py`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu_torch as rt  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.models import gpt2  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    Checkpoint,
    CheckpointConfig,
    CudaConfig,
    CudaTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    WorkerGroup,
)

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = CudaConfig(device="cpu")


@pytest.fixture(scope="module")
def cluster():
    # one intra-op thread a worker: tiny models gain nothing from more,
    # and the parallel test run's other files share the cores
    env = {"RTT_GPUS": "1", "OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield rt
    rt.shutdown()


# ----------------------------------------------------------------------
# the JAX package's tests/test_train.py, on the port
# ----------------------------------------------------------------------
def test_worker_group_execute(cluster):
    wg = WorkerGroup(num_workers=2)
    try:
        pids = wg.execute(os.getpid)
        assert len(pids) == 2 and pids[0] != pids[1]
        assert wg.execute_single(1, lambda: 41 + 1) == 42
    finally:
        wg.shutdown()


def test_trainer_basic_metrics(cluster, tmp_path):
    def loop(config):
        ctx = train.get_context()
        for i in range(3):
            train.report({"loss": 10.0 - i, "rank": ctx.get_world_rank()})

    result = CudaTrainer(
        loop, cuda_config=CPU,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="basic", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["loss"] == 8.0
    assert result.metrics["rank"] == 0
    assert len(result.metrics_history) == 3
    assert result.metrics_history[0]["training_iteration"] == 1


def test_trainer_checkpointing_top_k(cluster, tmp_path):
    def loop(config):
        ctx = train.get_context()
        for i in range(4):
            ck = None
            if ctx.get_world_rank() == 0:
                ck = Checkpoint.from_dict({"step": i})
            train.report({"score": float(i)}, checkpoint=ck)

    result = CudaTrainer(
        loop, cuda_config=CPU,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="ckpt", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score"),
        ),
    ).fit()
    assert result.error is None
    assert result.checkpoint.to_dict()["step"] == 3
    kept = [d for d in os.listdir(result.path) if d.startswith("checkpoint_")]
    assert len(kept) == 2


def test_trainer_failure_restart_resumes(cluster, tmp_path):
    marker = str(tmp_path / "failed_once")

    def loop(config):
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["step"] + 1
        for i in range(start, 4):
            if i == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected worker failure")
            train.report({"step": i},
                         checkpoint=Checkpoint.from_dict({"step": i}))

    result = CudaTrainer(
        loop, cuda_config=CPU, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="ft", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    assert os.path.exists(marker)


def test_trainer_failure_exhausts_budget(cluster, tmp_path):
    def loop(config):
        raise ValueError("always broken")

    result = CudaTrainer(
        loop, cuda_config=CPU, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="fail", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is not None
    assert "always broken" in str(result.error)


def test_collective_gradient_sync(cluster, tmp_path):
    """Two workers compute different grads; `sync_gradients` averages
    them in one exchange, and a bf16 leaf comes back bf16."""

    def loop(config):
        from ray_tpu_torch.train.cuda_utils import sync_gradients, world_mean

        rank = train.get_context().get_world_rank()
        grads = {"w": torch.full((4,), float(rank)),
                 "b": [torch.full((2,), 10.0 * rank, dtype=torch.bfloat16)]}
        synced = sync_gradients(grads)
        train.report({"w0": float(synced["w"][0]),
                      "b0": float(synced["b"][0][0]),
                      "b_dtype": str(synced["b"][0].dtype),
                      "mean": world_mean(float(rank))})

    result = CudaTrainer(
        loop, cuda_config=CudaConfig(device="cpu",
                                     distributed_mode="collective"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="sync", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["w0"] == pytest.approx(0.5)
    assert result.metrics["b0"] == pytest.approx(5.0)
    assert result.metrics["b_dtype"] == "torch.bfloat16"
    assert result.metrics["mean"] == pytest.approx(0.5)


def test_trainer_stop_criterion(cluster, tmp_path):
    def loop(config):
        for i in range(100):
            train.report({"acc": i * 0.1})

    result = CudaTrainer(
        loop, cuda_config=CPU, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="stop", storage_path=str(tmp_path),
                             stop={"training_iteration": 5}),
    ).fit()
    assert result.error is None
    assert len(result.metrics_history) <= 7


def test_torch_trainer_ddp(cluster, tmp_path):
    """TorchTrainer, 2 CPU workers, gloo DDP (the backend picked for
    workers without a card)."""
    from ray_tpu_torch.train import TorchTrainer

    def loop(config):
        import torch.distributed as dist
        from torch import nn
        from torch.utils.data import DataLoader, TensorDataset

        from ray_tpu_torch.train.torch import (prepare_data_loader,
                                               prepare_model)

        ctx = train.get_context()
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 2
        assert dist.get_rank() == ctx.get_world_rank()
        torch.manual_seed(0)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(512, 8)).astype(np.float32)
        y = x @ rng.normal(size=(8, 1)).astype(np.float32)
        loader = prepare_data_loader(DataLoader(TensorDataset(
            torch.from_numpy(x), torch.from_numpy(y)), batch_size=32))
        model = prepare_model(nn.Linear(8, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for epoch in range(4):
            total = 0.0
            for xb, yb in loader:
                opt.zero_grad()
                loss = nn.functional.mse_loss(model(xb), yb)
                loss.backward()
                opt.step()
                total += float(loss)
            train.report({"loss": total, "epoch": epoch})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="torch_ddp", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["loss"] < 1.0, result.metrics


# ----------------------------------------------------------------------
# what the port changes
# ----------------------------------------------------------------------
def test_config_names_the_gpu_and_as_trainable_wraps_for_tune():
    from ray_tpu.train import JaxConfig, ScalingConfig as JScaling

    s = ScalingConfig(num_workers=2, use_gpu=True)
    assert s._resources_per_worker_not_none() == {"CPU": 1.0, "GPU": 1.0}
    assert s.num_gpus_per_worker == 1.0
    assert ScalingConfig(resources_per_worker={"GPU": 0.5}
                         ).num_gpus_per_worker == 0.5
    j = JScaling(num_workers=2, use_tpu=True)
    assert j._resources_per_worker_not_none() == {"CPU": 1.0, "TPU": 1.0}
    assert not hasattr(s, "topology") and hasattr(j, "topology")
    c = CudaConfig()
    assert (c.distributed_mode, c.device, c.collective_group_name) == (
        JaxConfig().distributed_mode, "cuda", JaxConfig().collective_group_name)
    assert c.process_group_backend == "nccl"
    assert CPU.process_group_backend == "gloo"
    from ray_tpu_torch.tune import Tuner

    trainer = CudaTrainer(lambda c: None)
    trainable = trainer.as_trainable()
    assert callable(trainable) and trainable.__name__ == "CudaTrainer"
    # the trainable `Tuner` runs is the one `as_trainable` makes
    kind, run = Tuner(trainer)._trainable_def
    assert kind == "function" and run.__name__ == "CudaTrainer"
    assert run.__code__ is trainable.__code__


def test_fractional_gpu_workers_share_the_card(cluster, tmp_path):
    """`resources_per_worker={"GPU": 0.5}` places both workers of a
    2-worker group on the one GPU of the cluster at once, both pinned to
    that card (CUDA_VISIBLE_DEVICES "0"), and a whole-GPU worker after
    them is pinned to card "0" too."""
    def loop(config):
        ctx = train.get_context()
        with open(os.path.join(config["dir"],
                               f"r{ctx.get_world_rank()}.json"), "w") as f:
            json.dump({"cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                       "pid": os.getpid()}, f)
        train.report({"ok": 1})

    assert rt.cluster_resources().get("GPU") == 1.0
    result = CudaTrainer(
        loop, cuda_config=CPU, train_loop_config={"dir": str(tmp_path)},
        scaling_config=ScalingConfig(
            num_workers=2, use_gpu=True,
            resources_per_worker={"GPU": 0.5, "CPU": 1}),
        run_config=RunConfig(name="frac", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    seen = [json.load(open(tmp_path / f"r{r}.json")) for r in (0, 1)]
    assert seen[0]["pid"] != seen[1]["pid"]
    assert seen[0]["cvd"] == seen[1]["cvd"] == "0"
    whole = CudaTrainer(
        loop, cuda_config=CPU, train_loop_config={"dir": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="whole", storage_path=str(tmp_path)),
    ).fit()
    assert whole.error is None
    assert json.load(open(tmp_path / "r0.json"))["cvd"] == "0"


# ----------------------------------------------------------------------
# the data-parallel LoRA trainer against the JAX package
# ----------------------------------------------------------------------
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


def _dp_config(lora_model, out_dir, steps, **kw):
    _, jparams, jl, tcfg, tokens = lora_model
    return {"device": "cpu", "cfg": tcfg, "params": _np_tree(jparams),
            "lora": _np_tree(jl), "tokens": tokens, "steps": steps,
            "out_dir": str(out_dir), **kw}


def _records(out_dir):
    return {r: [json.loads(x) for x in open(out_dir / f"rank{r}.jsonl")]
            for r in (0, 1)}


def _jax_steps(lora_model, n):
    jcfg, jparams, jl, _, tokens = lora_model
    opt = optax.adamw(2e-4)
    state = opt.init(jl)
    step = jllama.make_lora_train_step(jcfg, opt)
    losses = []
    for _ in range(n):
        jl, state, m = step(jparams, jl, state, jnp.asarray(tokens))
        losses.append(float(m["loss"]))
    return jl, losses


def _flat(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else [(prefix + k, np.asarray(v))])
    return out


def _fit_dp_and_hold_to_jax(lora_model, tmp_path, cuda_config):
    """Three steps of `dp_train_loop` on 2 workers; holds both ranks'
    adapters bit-equal after every step, and the global losses and the
    last checkpoint's adapters to the JAX package's steps on the whole
    batch.  Returns each rank's step records."""
    from ray_tpu_torch.scripts import train_llama_lora

    result = CudaTrainer(
        train_llama_lora.dp_train_loop, cuda_config=cuda_config,
        train_loop_config=_dp_config(lora_model, tmp_path, 3),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dp", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    recs = {r: [x for x in lines if "step" in x]
            for r, lines in _records(tmp_path).items()}
    assert [x["step"] for x in recs[0]] == [1, 2, 3]
    for a, b in zip(recs[0], recs[1]):
        assert a["digest"] == b["digest"] and a["step"] == b["step"]
    want_lora, want_losses = _jax_steps(lora_model, 3)
    np.testing.assert_allclose([r["global_loss"] for r in recs[0]],
                               want_losses, **TOL)
    got = result.checkpoint.to_dict()
    assert got["step"] == 3 and got["count"] == 3
    got_flat, want_flat = _flat(got["lora"]), _flat(_np_tree(want_lora))
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (path, g), (_, w) in zip(got_flat, want_flat):
        np.testing.assert_allclose(g, w, err_msg=path, **TOL)
    return recs


def test_data_parallel_lora_matches_jax_on_the_whole_batch(
        cluster, lora_model, tmp_path):
    """2 workers, half the batch each, gradients synced every step: after
    each of 3 steps both workers hold the same adapters bit for bit, the
    mean of their losses is the whole batch's, and the adapters after 3
    steps equal the JAX package's `make_lora_train_step` on the whole
    batch (optax.adamw(2e-4)) at rtol / atol 1e-5."""
    recs = _fit_dp_and_hold_to_jax(lora_model, tmp_path, CPU)
    assert recs[0][0]["sync_ms"].keys() == {"d2h", "allreduce", "h2d"}


def test_data_parallel_lora_over_the_process_group_matches_jax(
        cluster, lora_model, tmp_path):
    """The same 2-worker run in the "torch_distributed" mode (a gloo
    process group, no host collective group): the gradients and the
    loss are averaged over the process group, so the ranks stay
    bit-equal and the adapters after 3 steps equal JAX's on the whole
    batch at rtol / atol 1e-5."""
    recs = _fit_dp_and_hold_to_jax(
        lora_model, tmp_path,
        CudaConfig(device="cpu", distributed_mode="torch_distributed"))
    assert recs[0][0]["sync_ms"].keys() == {"allreduce"}
    mesh = [x for x in _records(tmp_path)[0] if "mesh" in x][0]["mesh"]
    assert (mesh["backend"], mesh["device_type"]) == ("gloo", "cpu")


def test_data_parallel_lora_resumes_from_its_checkpoint(
        cluster, lora_model, tmp_path):
    """Two steps, then a second fit from the checkpoint for one more:
    the resumed workers start at step 2 with the checkpoint's adapters
    and optimizer state, and end where three straight steps end."""
    from ray_tpu_torch.scripts import train_llama_lora

    first = tmp_path / "a"
    first.mkdir()
    res1 = CudaTrainer(
        train_llama_lora.dp_train_loop, cuda_config=CPU,
        train_loop_config=_dp_config(lora_model, first, 2),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="r1", storage_path=str(tmp_path)),
    ).fit()
    assert res1.error is None, res1.error
    second = tmp_path / "b"
    second.mkdir()
    res2 = CudaTrainer(
        train_llama_lora.dp_train_loop, cuda_config=CPU,
        train_loop_config=_dp_config(lora_model, second, 3),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="r2", storage_path=str(tmp_path)),
        resume_from_checkpoint=res1.checkpoint,
    ).fit()
    assert res2.error is None, res2.error
    recs = _records(second)
    saved = res1.checkpoint.to_dict()
    for r in (0, 1):
        assert recs[r][0]["resumed_from"] == 2
        assert recs[r][0]["digest_at_resume"] == \
            train_llama_lora.digest_arrays(gpt2._leaves(saved["lora"]))
        assert [x["step"] for x in recs[r][1:]] == [3]
    want_lora, _ = _jax_steps(lora_model, 3)
    for (path, g), (_, w) in zip(_flat(res2.checkpoint.to_dict()["lora"]),
                                 _flat(_np_tree(want_lora))):
        np.testing.assert_allclose(g, w, err_msg=path, **TOL)
