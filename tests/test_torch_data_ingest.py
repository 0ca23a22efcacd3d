"""The port's feed onto the device (`iter_cuda_batches`) and a
`CudaTrainer` fed by a dataset, on the CPU, against the JAX package.

`iter_cuda_batches(device="cpu")` gives `iter_jax_batches`' values and
dtypes (JAX runs with 64-bit types off: int64 and float64 columns come
out 32-bit) on a `Dataset` and on a streaming split's `DataIterator`;
`sharding=` over a 1-rank gloo mesh gives the same batch whole; with no
card and no device it raises.  Then the slice's main path at a tiny
size: a shuffled token dataset streamed into two `CudaTrainer` workers
(`train_llama_lora.ingest_train_loop`), which cover it exactly once,
their first-step losses equal to the JAX package's `loss_fn` on the same
rows (params crossing through `models/bridge.py`) at 1e-5.

One module-scoped cluster of the port's runtime serves every case; the
parity cases also start the JAX package's runtime (`rt_start`).
"""

import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu.data as jrd  # noqa: E402
import ray_tpu_torch as rt  # noqa: E402
import ray_tpu_torch.data as rd  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from test_torch_waits import bounded_fit  # noqa: E402

VOCAB = 128
SEQ = 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    yield rt
    rt.shutdown()


def _write_corpus(d, files=2, rows=8, seed=0):
    """`files` .npz files of `rows` rows each: int32 `tokens` [rows, SEQ
    + 1], int64 `row_id`, float64 `weight`, uint8 `flag`."""
    rng = np.random.default_rng(seed)
    for f in range(files):
        ids = np.arange(f * rows, (f + 1) * rows, dtype=np.int64)
        np.savez(d / f"part{f:02d}.npz",
                 tokens=rng.integers(0, VOCAB, (rows, SEQ + 1)).astype(
                     np.int32),
                 row_id=ids, weight=rng.standard_normal(rows),
                 flag=(ids % 3).astype(np.uint8))
    return str(d / "*.npz")


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert isinstance(g[k], torch.Tensor), k
            assert g[k].device == torch.device("cpu")
            assert str(g[k].dtype).replace("torch.", "") == str(w[k].dtype), k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)


def test_iter_cuda_batches_equals_iter_jax_batches(cluster, rt_start,
                                                   tmp_path):
    """On a `Dataset`: the same batches, values and dtypes (int32 tokens
    stay int32, int64 `row_id` and float64 `weight` become 32-bit,
    uint8 stays), with `drop_last` as the reference's; and `dtype=`
    casting every column as `jnp.asarray(v, dtype=...)` does."""
    path = _write_corpus(tmp_path, rows=10)
    got = list(rd.read_numpy(path).iter_cuda_batches(batch_size=4,
                                                     device="cpu"))
    want = list(jrd.read_numpy(path).iter_jax_batches(batch_size=4))
    assert len(got) == 5  # 20 rows: the last partial batch dropped
    _same_batches(got, want)
    assert {k: str(v.dtype) for k, v in got[0].items()} == {
        "tokens": "torch.int32", "row_id": "torch.int32",
        "weight": "torch.float32", "flag": "torch.uint8"}
    got = list(rd.read_numpy(path).iter_cuda_batches(
        batch_size=3, drop_last=False, dtype=torch.float32, device="cpu"))
    want = list(jrd.read_numpy(path).iter_jax_batches(
        batch_size=3, drop_last=False, dtype=jnp.float32))
    assert len(got) == 7
    _same_batches(got, want)


def test_split_iter_cuda_batches_equals_iter_jax_batches(cluster, rt_start,
                                                         tmp_path):
    """On a streaming split's `DataIterator` (one consumer, so both
    packages hand it every block): the same rows, by `row_id`, in the
    same dtypes."""
    path = _write_corpus(tmp_path, files=3, rows=6)

    def rows(batches):
        out = {}
        for b in batches:
            for i, rid in enumerate(np.asarray(b["row_id"]).tolist()):
                out[rid] = {k: (str(v.dtype).replace("torch.", ""),
                                np.asarray(v[i]).tolist())
                            for k, v in b.items()}
        return out

    (it,) = rd.read_numpy(path).streaming_split(1)
    (jit,) = jrd.read_numpy(path).streaming_split(1)
    got = rows(it.iter_cuda_batches(batch_size=4, device="cpu"))
    want = rows(jit.iter_jax_batches(batch_size=4))
    assert len(got) == 16  # 18 rows, the last partial batch dropped
    assert got == want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_batches_equal_the_jax_batch(cluster, rt_start, tmp_path):
    """`sharding=(mesh, data_sharding(mesh))` over a 1-rank gloo mesh:
    DTensors whose `full_tensor()` is the JAX package's batch placed with
    its `data_sharding` on a 1-device mesh."""
    import torch.distributed as dist

    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu_torch.parallel import mesh as tmesh

    path = _write_corpus(tmp_path)
    jm = jmesh.MeshSpec(dp=1).build(jax.devices()[:1])
    want = list(jrd.read_numpy(path).iter_jax_batches(
        batch_size=4, sharding=jmesh.data_sharding(jm)))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        m = tmesh.MeshSpec(dp=1).build([0], device_type="cpu")
        got = list(rd.read_numpy(path).iter_cuda_batches(
            batch_size=4, sharding=(m, tmesh.data_sharding(m))))
        assert all(type(v).__name__ == "DTensor"
                   for b in got for v in b.values())
        _same_batches([{k: v.full_tensor() for k, v in b.items()}
                       for b in got], want)
    finally:
        dist.destroy_process_group()


def test_iter_cuda_batches_raises_without_a_card(cluster):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    ds = rd.from_items([{"x": 1}])
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.iter_cuda_batches()
    (it,) = ds.streaming_split(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        it.iter_cuda_batches(batch_size=1)


# ----------------------------------------------------------------------
# the slice's main path, tiny: a shuffled dataset into two workers
# ----------------------------------------------------------------------
def _digest_w():
    return np.random.default_rng(1).integers(1, 2048, SEQ + 1)


def _with_digest(w):
    def fn(b):
        t = np.ascontiguousarray(b["tokens"], dtype=np.int32)
        return {"tokens": t, "row_id": b["row_id"],
                "digest": t.astype(np.int64) @ w % (2**31 - 1)}

    return fn


def test_cuda_trainer_covers_a_shuffled_dataset_once(cluster, tmp_path):
    """`CudaTrainer(ingest_train_loop, datasets={"train": ds})` with 2
    workers at `LlamaConfig.tiny` f32: `read_numpy` -> `map_batches` (a
    per-row digest) -> `random_shuffle(seed=0)` -> `repartition(2)` (two
    equal halves, so both ranks take the same number of steps), batches
    of 2 through `iter_cuda_batches`.  Every row is trained on exactly
    once, each batch's digest checks on the device, the ranks stay
    bit-equal, and each rank's step-1 loss is the JAX package's
    `loss_fn` on the rows it got, at 1e-5."""
    from ray_tpu_torch.scripts import train_llama_lora
    from ray_tpu_torch.train import (CudaConfig, CudaTrainer, RunConfig,
                                     ScalingConfig)

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    out = tmp_path / "out"
    out.mkdir()
    path = _write_corpus(corpus)
    w = _digest_w()
    ds = (rd.read_numpy(path).map_batches(_with_digest(w), batch_size=256)
          .random_shuffle(seed=0).repartition(2))
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jl = jllama.init_lora(jcfg, jax.random.PRNGKey(1), rank=8)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=torch.float32)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    result = bounded_fit(CudaTrainer(
        train_llama_lora.ingest_train_loop,
        cuda_config=CudaConfig(device="cpu"),
        train_loop_config={"device": "cpu", "cfg": tcfg,
                           "params": np_tree(jparams), "lora": np_tree(jl),
                           "steps": 4, "batch": 2, "digest_w": w.tolist(),
                           "out_dir": str(out)},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": ds},
    ))
    assert result.error is None, result.error
    recs = {r: [json.loads(x) for x in open(out / f"rank{r}.jsonl")]
            for r in (0, 1)}
    seen = [rid for r in (0, 1) for x in recs[r] for rid in x["row_ids"]]
    assert sorted(seen) == list(range(16))
    for r in (0, 1):
        assert [x["step"] for x in recs[r]] == [1, 2, 3, 4]
        for x in recs[r]:
            assert (x["device"], x["dtype"], x["shape"]) == (
                "cpu", "int32", [2, SEQ + 1])
            assert x["digest_ok"] and x["lr"] == 2e-4
            assert x["wait_ms"] >= 0 and x["launches"]["plain_dispatches"] \
                == 0
    for a, b in zip(recs[0], recs[1]):
        assert a["digest"] == b["digest"]
    tokens = {}
    for f in sorted(corpus.glob("*.npz")):
        with np.load(f) as z:
            tokens.update(zip(z["row_id"].tolist(), z["tokens"]))
    for r in (0, 1):
        first = recs[r][0]
        rows = np.stack([tokens[i] for i in first["row_ids"]])
        want = float(jllama.loss_fn(jcfg, jparams, jnp.asarray(rows),
                                    lora=jl))
        np.testing.assert_allclose(first["loss"], want, **TOL)
    np.testing.assert_allclose(recs[0][0]["global_loss"],
                               (recs[0][0]["loss"] + recs[1][0]["loss"]) / 2,
                               **TOL)
    assert result.metrics["step"] == 4 and result.metrics["rank"] == 0
