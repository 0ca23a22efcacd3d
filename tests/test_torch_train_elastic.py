"""The port's elastic training path, shaped as the JAX package's
`tests/test_train_elastic.py`: the mesh re-fit, the atomic checkpoint
commit with its checksums, the sharded checkpoint's piece CRCs and rank
completeness, N -> M reshard-on-restore over gloo ranks, the health
monitor (SIGKILL, breaker trip), bounded finish, and elastic recovery
from a SIGKILLed rank without spending the failure budget.

Chaos conventions follow the JAX package's: seeded inputs, real
SIGKILLs.  Its host-preemption case runs on the port's
`cluster_utils.Cluster` (two node daemons on one host): a rank and its
host SIGKILLed mid-run, the group shrunk onto the surviving host over a
smaller gloo group, the sharded checkpoint resharded from two writers
onto one reader, then re-grown when a replacement host joins.
"""

import json
import os
import signal
import threading
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


# ----------------------------------------------------------------------
# host preemption: a rank and its node daemon SIGKILLed (two hosts)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def multiproc_cpu():
    from ray_tpu_torch.testing import torch_multiprocess_cpu_support

    ok, why = torch_multiprocess_cpu_support()
    if not ok:
        pytest.skip(f"multi-process gloo unsupported here: {why}")


def test_host_preemption_shrink_reshard_resume_regrow(
        multiproc_cpu, tmp_path):
    """The JAX package's acceptance scenario on the port: SIGKILL one
    training rank AND its host daemon mid-step.  Without restarting
    fit(): the loss is detected through the health plane, the group
    re-forms on the surviving host over a SMALLER gloo group, restores
    the latest atomic checkpoint (2-writer pieces resharded onto the
    1-process layout) at the same global step, and — when a replacement
    node joins — re-grows to full width and finishes.  The post-shrink
    loss trajectory must match a never-killed run restored from the
    same checkpoint.

    The model is a least-squares weight [16, 8], data-parallel over the
    process group (each rank's gradient on the same seeded batch,
    mean-allreduced), checkpointed as a DTensor sharded by rows over
    the fsdp axis: its loss does not depend on the group's width."""
    from ray_tpu_torch.cluster_utils import Cluster

    def loop(config):
        import tempfile

        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import (
            Replicate,
            Shard,
            distribute_tensor,
        )

        from ray_tpu_torch import train as rtrain
        from ray_tpu_torch.parallel import MeshSpec
        from ray_tpu_torch.train.checkpoint import Checkpoint as Ck
        from ray_tpu_torch.train.sharded_checkpoint import (
            load_sharded,
            save_sharded,
        )

        ctx = rtrain.get_context()
        rank = ctx.get_world_rank()
        # deterministic chaos markers: the driver picks its victim by
        # the host (ppid == the node daemon) carrying the rank
        with open(os.path.join(config["marker_dir"],
                               f"rank{rank}_pid{os.getpid()}.json"),
                  "w") as f:
            json.dump({"rank": rank, "pid": os.getpid(),
                       "ppid": os.getppid(),
                       "world": ctx.get_world_size()}, f)

        world = dist.get_world_size()
        mesh = MeshSpec(fsdp=world).build(device_type="cpu")
        rows = [Replicate(), Shard(0)] + [Replicate()] * 4
        rng = np.random.default_rng(7)  # seeded: every attempt, same data
        x = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
        w = torch.from_numpy(np.random.default_rng(0).normal(
            size=(16, 8)).astype(np.float32) * 0.1)

        start_step = 0
        resume = rtrain.get_checkpoint()
        if resume is not None:
            with resume.as_directory() as d:
                state = load_sharded(d, {
                    "w": distribute_tensor(torch.zeros(16, 8), mesh, rows),
                    "step": 0, "pnorm": 0.0})
            w = state["w"].full_tensor()
            start_step = int(state["step"])
            # reshard-on-restore correctness: the norm computed under
            # the OLD layout must survive re-laying onto this mesh
            restored = float(w.norm())
            assert abs(restored - state["pnorm"]) < 1e-3 * state["pnorm"], (
                restored, state["pnorm"])

        for step in range(start_step, config["num_steps"]):
            time.sleep(config.get("step_sleep_s", 0.0))
            wt = w.clone().requires_grad_(True)
            loss = ((x @ wt - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, wt)
            dist.all_reduce(g)
            w = w - 0.1 * g / world
            d = tempfile.mkdtemp(prefix="rtt_elastic_ck_")
            save_sharded({"w": distribute_tensor(w, mesh, rows),
                          "step": step + 1, "pnorm": float(w.norm())}, d)
            ck = Ck(d)
            ck._temp_source = True
            rtrain.report(
                {"loss": float(loss), "step": step + 1,
                 "world": ctx.get_world_size(),
                 "global_devices": mesh.size(), "process_count": world},
                checkpoint=ck,
            )

    marker_dir = str(tmp_path / "markers")
    os.makedirs(marker_dir)
    num_steps = 12
    # one runtime a process: drop the module's local cluster, if any
    rt.shutdown()
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 1, "num_workers": 1})
    node_b = c.add_node(num_cpus=1, num_workers=1)
    c.connect()
    c.wait_for_nodes()
    try:
        history = []
        trainer = CudaTrainer(
            loop,
            train_loop_config={
                "num_steps": num_steps, "marker_dir": marker_dir,
                "step_sleep_s": 0.4,
            },
            cuda_config=CudaConfig(distributed_mode="torch_distributed",
                                   device="cpu",
                                   env_vars={"OMP_NUM_THREADS": "1"}),
            scaling_config=ScalingConfig(
                num_workers=2, placement_strategy="SPREAD"
            ),
            run_config=RunConfig(
                storage_path=str(tmp_path), name="elastic_preemption",
                failure_config=FailureConfig(
                    elastic=True, min_workers=1, detect_poll_s=0.25,
                    drain_timeout_s=4.0, reform_timeout_s=3.0,
                    regrow_interval_s=1.0,
                ),
            ),
        )
        trainer._result_callback = (
            lambda m, ck: history.append(dict(m))
        )
        box = {}

        def run():
            box["result"] = trainer.fit()

        t = threading.Thread(target=run, daemon=True)
        t.start()

        # let two full checkpoints commit before preempting
        _wait_for(lambda: len(history) >= 2, 180.0, "2 iterations")
        victim = None
        for fn in os.listdir(marker_dir):
            with open(os.path.join(marker_dir, fn)) as f:
                info = json.load(f)
            if info["ppid"] == node_b.proc.pid:
                victim = info
        assert victim is not None, "no rank found on the victim host"
        os.kill(victim["pid"], signal.SIGKILL)  # the rank, mid-step
        c.remove_node(node_b, graceful=False)   # ... and its host

        # shrunk-phase steps must flow before the replacement appears,
        # so the width-1 resume is actually exercised
        _wait_for(lambda: any(m.get("world") == 1 for m in history),
                  180.0, "post-shrink step on the smaller mesh")
        c.add_node(num_cpus=1, num_workers=1)  # replacement host joins
        _wait_for(lambda: not t.is_alive(), 240.0, "fit completion")
        t.join()
        result = box["result"]

        assert result.error is None, result.error
        # finished at FULL width on the re-grown group
        assert result.metrics["step"] == num_steps
        assert result.metrics["world"] == 2
        assert result.metrics["process_count"] == 2
        assert result.metrics["global_devices"] == 2

        # lifecycle: shrink -> reform(1) -> regrow -> reform(2)
        kinds = [e["kind"] for e in trainer._elastic_events]
        assert kinds.count("shrink") == 1, trainer._elastic_events
        assert "regrow" in kinds, trainer._elastic_events
        widths = [e["width"] for e in trainer._elastic_events
                  if e["kind"] == "reform"]
        assert widths[0] == 1 and widths[-1] == 2, trainer._elastic_events
        shrink = next(e for e in trainer._elastic_events
                      if e["kind"] == "shrink")
        assert shrink["lost_ranks"], shrink

        # step continuity: every resume landed exactly at the
        # checkpointed step — the metric stream is gapless and
        # duplicate-free across both membership changes
        steps = [m["step"] for m in result.metrics_history]
        assert steps == list(range(1, num_steps + 1)), steps
        shrunk = {m["step"]: m["loss"] for m in result.metrics_history
                  if m["world"] == 1}
        assert shrunk, "no steps ran on the shrunk mesh"
        # the shrunk phase ran on the smaller global mesh
        shrunk_devices = {m["global_devices"]
                          for m in result.metrics_history
                          if m["world"] == 1}
        assert shrunk_devices == {1}

        # loss continuity: a never-killed run restored from the SAME
        # atomic checkpoint (the one the shrink resumed from) must
        # produce the same losses over the shrunk segment
        first_shrunk = min(shrunk)
        resume_dir = os.path.join(
            result.path, f"checkpoint_{first_shrunk - 1:06d}"
        )
        ok, why = validate_checkpoint(resume_dir)
        assert ok, why
        control = CudaTrainer(
            loop,
            train_loop_config={
                "num_steps": max(shrunk), "marker_dir": marker_dir,
            },
            cuda_config=CudaConfig(distributed_mode="torch_distributed",
                                   device="cpu"),
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                storage_path=str(tmp_path), name="elastic_control",
            ),
            resume_from_checkpoint=Checkpoint(resume_dir),
        ).fit()
        assert control.error is None, control.error
        control_losses = {m["step"]: m["loss"]
                          for m in control.metrics_history}
        for step, loss in shrunk.items():
            assert control_losses[step] == pytest.approx(
                loss, rel=1e-5
            ), (step, loss, control_losses[step])
    finally:
        c.shutdown()
