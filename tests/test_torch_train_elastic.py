"""The port's elastic training path, shaped as the JAX package's
`tests/test_train_elastic.py`: the mesh re-fit, the atomic checkpoint
commit with its checksums, the sharded checkpoint's piece CRCs and rank
completeness, N -> M reshard-on-restore over gloo ranks, the health
monitor (SIGKILL, breaker trip), bounded finish, and elastic recovery
from a SIGKILLed rank without spending the failure budget.

Chaos conventions follow the JAX package's: seeded inputs, real
SIGKILLs.  Its host-preemption test needs `cluster_utils` (a second node
daemon), which the port does not have yet (ROADMAP.md queue 1 item 9).
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    CudaConfig,
    CudaTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    WorkerGroup,
    validate_checkpoint,
)
from test_torch_parallel import spawn

pytestmark = pytest.mark.chaos


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


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


# ----------------------------------------------------------------------
# mesh re-fit
# ----------------------------------------------------------------------
def test_mesh_fit_to_shrinks_data_axes_only():
    from ray_tpu_torch.parallel import MeshSpec

    spec = MeshSpec(dp=2, fsdp=2, tp=2)
    half = spec.fit_to(4)
    assert (half.tp, half.sp, half.ep, half.pp) == (2, 1, 1, 1)
    assert half.dp * half.fsdp == 2
    assert half.fsdp == 2  # fsdp preserved; dp absorbed the loss
    assert MeshSpec(dp=4, fsdp=2).fit_to(4).fsdp == 2
    grown = MeshSpec(dp=1, fsdp=2).fit_to(8)
    assert grown.dp * grown.fsdp == 8
    with pytest.raises(ValueError):
        MeshSpec(tp=4).fit_to(2)
    with pytest.raises(ValueError):
        MeshSpec(tp=3).fit_to(4)
    assert MeshSpec(dp=-1).fit_to(6).dp == 6


_MESH_TASK = """
import numpy as np
from ray_tpu_torch.train.session import TrainContext

def run(rank, world, inp):
    import os
    os.environ["RTT_TRAIN_DEVICE"] = "cpu"
    out = {}
    out["plain"] = np.asarray(TrainContext(
        mesh_shape={"dp": 2}).get_mesh().mesh.shape)
    try:
        TrainContext(mesh_shape={"dp": 4}).get_mesh()
        out["rigid_raised"] = np.asarray(False)
    except ValueError:
        out["rigid_raised"] = np.asarray(True)
    out["elastic"] = np.asarray(TrainContext(
        mesh_shape={"dp": 4, "sp": 1}, extra={"elastic": True}
    ).get_mesh().mesh.shape)
    out["sp"] = np.asarray(TrainContext(
        mesh_shape={"sp": 2}).get_mesh().mesh.shape)
    return out
"""


def test_train_context_get_mesh_refits_when_elastic(tmp_path):
    """`get_mesh()` over a 2-rank gloo group: the requested shape when
    it fits; a shape for more ranks raises unless the run is elastic,
    which re-fits the data axes to the ranks there are."""
    for out in spawn(_MESH_TASK, 2, {}, tmp_path):
        assert out["plain"].tolist() == [2, 1, 1, 1, 1, 1]
        assert bool(out["rigid_raised"])
        assert out["elastic"].tolist() == [2, 1, 1, 1, 1, 1]
        assert out["sp"].tolist() == [1, 1, 1, 1, 2, 1]


# ----------------------------------------------------------------------
# atomic checkpoint commit
# ----------------------------------------------------------------------
def test_atomic_commit_and_corruption_detection(tmp_path):
    from ray_tpu_torch.train.checkpoint_manager import (
        CheckpointManager,
        sweep_staging,
    )

    run_dir = str(tmp_path)
    mgr = CheckpointManager()
    c1 = mgr.commit([Checkpoint.from_dict({"step": 1})], run_dir, 1,
                    {"loss": 1.0})
    c2 = mgr.commit([Checkpoint.from_dict({"step": 2})], run_dir, 2,
                    {"loss": 0.5})
    assert validate_checkpoint(c1.path) == (True, "ok")
    assert validate_checkpoint(c2.path) == (True, "ok")
    assert mgr.latest_valid.path == c2.path
    assert c2.to_dict()["step"] == 2
    assert c2.get_metadata()["iteration"] == 2
    with open(os.path.join(c2.path, "state.pkl"), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    ok, why = validate_checkpoint(c2.path)
    assert not ok and "checksum mismatch" in why
    assert mgr.latest_valid.path == c1.path
    c3 = mgr.commit([Checkpoint.from_dict({"step": 3})], run_dir, 3,
                    {"loss": 0.4})
    with open(os.path.join(c3.path, "state.pkl"), "r+b") as f:
        f.truncate(4)
    ok, why = validate_checkpoint(c3.path)
    assert not ok and "size mismatch" in why
    c4 = mgr.commit([Checkpoint.from_dict({"step": 4})], run_dir, 4,
                    {"loss": 0.3})
    os.unlink(os.path.join(c4.path, "state.pkl"))
    ok, why = validate_checkpoint(c4.path)
    assert not ok and "missing file" in why
    assert mgr.latest_valid.path == c1.path
    os.makedirs(os.path.join(run_dir, ".tmp_checkpoint_000009_dead"))
    assert sweep_staging(run_dir) == 1
    assert not any(d.startswith(".tmp_checkpoint_")
                   for d in os.listdir(run_dir))


def test_commit_interrupted_staging_never_becomes_latest(tmp_path):
    from ray_tpu_torch.train.checkpoint_manager import CheckpointManager

    run_dir = str(tmp_path)
    mgr = CheckpointManager()
    committed = mgr.commit([Checkpoint.from_dict({"step": 1})], run_dir,
                           1, {})

    class _Boom(Exception):
        pass

    class _ExplodingCheckpoint(Checkpoint):
        def to_directory(self, path=None):
            super().to_directory(path)
            raise _Boom("preempted mid-merge")

    src = _ExplodingCheckpoint(Checkpoint.from_dict({"step": 2}).path)
    with pytest.raises(_Boom):
        mgr.commit([src], run_dir, 2, {})
    assert mgr.latest_valid.path == committed.path
    assert [d for d in os.listdir(run_dir)
            if d.startswith(".tmp_checkpoint_")] == []
    assert not os.path.exists(os.path.join(run_dir, "checkpoint_000002"))


# ----------------------------------------------------------------------
# sharded checkpoint: piece checksums + rank completeness
# ----------------------------------------------------------------------
def test_sharded_piece_crc_detects_corruption(tmp_path):
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    d = str(tmp_path / "ck")
    save_sharded({"w": torch.arange(8.0)}, d)
    stale = dict(np.load(os.path.join(d, "pieces_r00000.npz")))
    np.savez(os.path.join(d, "pieces_r00000.npz"),
             **{k: np.full_like(v, 99.0) for k, v in stale.items()})
    with pytest.raises(ValueError, match="corrupted"):
        load_sharded(d, {"w": torch.zeros(8)})


def test_sharded_missing_rank_files_rejected(tmp_path):
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    d = str(tmp_path / "ck")
    save_sharded({"w": torch.arange(8.0)}, d)
    mpath = os.path.join(d, "sharded_manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["num_processes"] = 2
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="missing piece files"):
        load_sharded(d, {"w": torch.zeros(8)})


# ----------------------------------------------------------------------
# reshard-on-restore, N writers -> M readers (gloo ranks)
# ----------------------------------------------------------------------
_RESHARD_TASK = """
import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train.sharded_checkpoint import load_sharded, save_sharded

def run(rank, world, inp):
    d = str(inp["dir"])
    ref = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    rest = [Replicate()] * 4
    if str(inp["mode"]) == "save":
        mesh = MeshSpec(fsdp=world).build(device_type="cpu")
        save_sharded({
            "w": distribute_tensor(torch.from_numpy(ref), mesh,
                                   [Replicate(), Shard(0)] + rest),
            "b": distribute_tensor(torch.arange(8.0), mesh,
                                   [Replicate(), Replicate()] + rest),
            "step": 7}, d)
        return {}
    mesh = MeshSpec(dp=world).build(device_type="cpu")
    out = load_sharded(d, {
        "w": distribute_tensor(torch.zeros(16, 8), mesh,
                               [Shard(1), Replicate()] + rest),
        "b": distribute_tensor(torch.zeros(8), mesh,
                               [Shard(0), Replicate()] + rest),
        "step": 0})
    return {"w": out["w"].full_tensor().numpy(),
            "b": out["b"].full_tensor().numpy(),
            "w_local": out["w"].to_local().numpy(),
            "step": np.asarray(out["step"])}
"""


@pytest.mark.parametrize("writers,readers", [(2, 1), (1, 2)])
def test_reshard_n_writers_m_readers(tmp_path, writers, readers):
    """save at N ranks (rows split over fsdp) -> load at M ranks (columns
    split over dp): bit-identical assembled arrays on every reader."""
    d = str(tmp_path / "ck")
    spawn(_RESHARD_TASK, writers, {"dir": d, "mode": "save"},
          tmp_path / "save")
    assert os.path.exists(os.path.join(d, "pieces_r00000.json"))
    assert os.path.exists(os.path.join(d, f"pieces_r{writers - 1:05d}.json"))
    outs = spawn(_RESHARD_TASK, readers, {"dir": d, "mode": "load"},
                 tmp_path / "load")
    ref = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    cols = 8 // readers
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["w"], ref)
        np.testing.assert_array_equal(out["w_local"],
                                      ref[:, r * cols:(r + 1) * cols])
        np.testing.assert_array_equal(out["b"], np.arange(8.0))
        assert int(out["step"]) == 7


# ----------------------------------------------------------------------
# detection: health monitor signals
# ----------------------------------------------------------------------
def test_monitor_detects_sigkilled_rank(cluster):
    wg = WorkerGroup(num_workers=2)
    try:
        lost_events = []
        wg.start_monitor(lambda rank, cause: lost_events.append((rank, cause)))
        infos = [wg.execute_single(i, os.getpid) for i in range(2)]
        os.kill(infos[1], signal.SIGKILL)
        _wait_for(lambda: 1 in wg.lost_ranks(), 15.0,
                  "SIGKILLed rank marked lost")
        assert lost_events and lost_events[0][0] == 1
        assert 0 not in wg.lost_ranks()
    finally:
        wg.shutdown()


def test_monitor_breaker_trip_marks_rank_lost(cluster):
    from ray_tpu_torch.core import rpc

    wg = WorkerGroup(num_workers=2)
    try:
        wg.execute(os.getpid)
        wg.start_monitor(lambda rank, cause: None)
        addrs = wg._worker_addresses()
        assert set(addrs) == {0, 1}
        node_id, worker_id = addrs[0]
        br = rpc.breaker_for(f"actor:{node_id}:{worker_id}")
        for _ in range(br.failure_threshold):
            br.record_failure()
        _wait_for(lambda: 0 in wg.lost_ranks(), 5.0,
                  "breaker-open rank marked lost")
        assert "breaker" in wg.lost_ranks()[0]
        assert 1 not in wg.lost_ranks()
    finally:
        wg.shutdown()
        rpc.reset_breakers()


# ----------------------------------------------------------------------
# WorkerGroup finish/shutdown hardening
# ----------------------------------------------------------------------
def test_finish_surfaces_first_worker_exception(cluster):
    from ray_tpu_torch.train.session import TrainContext

    wg = WorkerGroup(num_workers=2)
    try:
        def boom(config):
            raise RuntimeError("loop exploded")

        for rank, w in enumerate(wg.workers):
            rt.get(w.start_training.remote(
                boom, {}, TrainContext(world_size=2, world_rank=rank), None))
        time.sleep(0.5)
        with pytest.raises(rt.exceptions.RayTpuError, match="loop exploded"):
            wg.finish(timeout_s=10.0)
        statuses = wg.finish(timeout_s=10.0, raise_on_error=False)
        assert all("loop exploded" in s["error"] for s in statuses)
    finally:
        wg.shutdown()


def test_finish_bounded_join_with_wedged_loop(cluster):
    from ray_tpu_torch.train.session import TrainContext

    wg = WorkerGroup(num_workers=2)
    try:
        def loop(config):
            ctx = train.get_context()
            if ctx.get_world_rank() == 0:
                time.sleep(60)  # wedged: never reports
            else:
                for _ in range(1000):
                    train.report({"x": 1})

        for rank, w in enumerate(wg.workers):
            rt.get(w.start_training.remote(
                loop, {}, TrainContext(world_size=2, world_rank=rank), None))
        t0 = time.monotonic()
        statuses = wg.finish(timeout_s=3.0, raise_on_error=False)
        assert time.monotonic() - t0 < 15.0
        assert statuses[0]["clean"] is False
        assert statuses[1]["clean"] is True
    finally:
        wg.shutdown()


# ----------------------------------------------------------------------
# elastic recovery, single node (capacity returns instantly)
# ----------------------------------------------------------------------
def _elastic_loop(config):
    ctx = train.get_context()
    ck = train.get_checkpoint()
    start = ck.to_dict()["step"] + 1 if ck is not None else 0
    for step in range(start, config["num_steps"]):
        if (ck is None and step == config["kill_at"]
                and ctx.get_world_rank() == 1):
            os.kill(os.getpid(), signal.SIGKILL)
        c = (Checkpoint.from_dict({"step": step})
             if ctx.get_world_rank() == 0 else None)
        train.report({"step": step, "world": ctx.get_world_size()},
                     checkpoint=c)


def test_elastic_sigkill_recovers_without_consuming_failure_budget(
        cluster, tmp_path):
    """SIGKILL of rank 1 mid-run with max_failures=0: the elastic path
    re-forms the group and resumes from the latest atomic checkpoint at
    the same step."""
    trainer = CudaTrainer(
        _elastic_loop,
        train_loop_config={"num_steps": 6, "kill_at": 3},
        cuda_config=CudaConfig(distributed_mode="none", device="cpu"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            storage_path=str(tmp_path), name="elastic_one_node",
            failure_config=FailureConfig(
                elastic=True, min_workers=1, detect_poll_s=0.25,
                drain_timeout_s=3.0, reform_timeout_s=5.0),
        ),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == 5
    kinds = [e["kind"] for e in trainer._elastic_events]
    assert "shrink" in kinds and "reform" in kinds
    shrink = next(e for e in trainer._elastic_events if e["kind"] == "shrink")
    assert 1 in shrink["lost_ranks"]
    steps = [m["step"] for m in result.metrics_history]
    assert steps == sorted(steps)
    assert steps[-1] == 5 and 2 in steps and 3 in steps


def test_elastic_recovery_resyncs_the_collective_group(cluster, tmp_path):
    """A collective-mode run whose rank 1 is SIGKILLed: the re-formed
    group gets a fresh rendezvous (the dead one's actor is killed on
    shutdown), and the synced gradients after the recovery are again
    the mean over both ranks."""
    def loop(config):
        from ray_tpu_torch.train.cuda_utils import sync_gradients

        ctx = train.get_context()
        ck = train.get_checkpoint()
        start = ck.to_dict()["step"] + 1 if ck is not None else 0
        r = ctx.get_world_rank()
        for step in range(start, 4):
            if ck is None and step == 2 and r == 1:
                os.kill(os.getpid(), signal.SIGKILL)
            g = sync_gradients({"g": torch.full((3,), float(r + step))})
            train.report({"step": step, "g": float(g["g"][0]),
                          "world": ctx.get_world_size()},
                         checkpoint=(Checkpoint.from_dict({"step": step})
                                     if r == 0 else None))

    result = CudaTrainer(
        loop, cuda_config=CudaConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            storage_path=str(tmp_path), name="elastic_sync",
            failure_config=FailureConfig(
                elastic=True, min_workers=1, detect_poll_s=0.25,
                drain_timeout_s=3.0, reform_timeout_s=5.0)),
    ).fit()
    assert result.error is None, result.error
    last = result.metrics_history[-1]
    assert last["step"] == 3
    # the mean of (0 + 3) and (1 + 3) when both ranks are back
    want = 3.5 if last["world"] == 2 else 3.0
    assert last["g"] == pytest.approx(want)
