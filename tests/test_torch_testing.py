"""The port's test harness: `ray_tpu_torch.testing` (worker listing,
SIGKILL injection, the resident `WorkerKiller`, the gloo and kernel
probes) and `ray_tpu_torch.cluster_utils` (several node daemons on one
host), shaped as the JAX package's uses of its own (`tests/test_chaos.py`,
`tests/test_cluster.py`).

`cuda_kernel_support` builds and launches kernels only where a card is:
here it must answer (False, reason); on the card it must answer True or
raise.  What workers run is defined inside the case.
"""

import os
import tempfile
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import testing
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import ActorDiedError, RayTpuError
from test_torch_waits import within


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=4, num_cpus=8, ignore_reinit_error=True)
    yield
    rt.shutdown()


# ----------------------------------------------------------------------
# testing.py: workers, kills, the resident killer
# ----------------------------------------------------------------------
def test_list_workers_names_actor_workers(cluster):
    @rt.remote
    class Probe:
        def pid(self):
            return os.getpid()

    a = Probe.remote()
    try:
        pid = rt.get(a.pid.remote(), timeout=60)
        workers = testing.list_workers()
        assert workers and all({"pid", "kind", "idle", "actor_id"} <= set(w)
                               for w in workers)
        mine = [w for w in workers if w["actor_id"] == a._actor_id.hex()]
        assert [w["pid"] for w in mine] == [pid]
        assert any(w["kind"] == "worker" for w in workers)
    finally:
        rt.kill(a)


def test_kill_random_worker_kills_a_busy_task_worker(cluster):
    """The victim is a busy task worker (never an actor's, never the
    driver); the retriable task it ran completes on another worker."""
    @rt.remote(max_retries=3)
    def slow(i):
        time.sleep(1.5)
        return i

    refs = [slow.remote(i) for i in range(2)]

    def victim():
        while True:
            pid = testing.kill_random_worker(rng=__import__("random")
                                             .Random(0))
            if pid is not None:
                return pid
            time.sleep(0.05)

    pid = within(30.0, victim)
    assert pid != os.getpid()
    assert rt.get(refs, timeout=60) == [0, 1]
    assert pid not in {w["pid"] for w in testing.list_workers()}


@pytest.mark.chaos
def test_task_storm_survives_worker_kills(cluster):
    """Retriable tasks all complete while a killer SIGKILLs busy
    workers underneath them."""
    from ray_tpu_torch.testing import WorkerKiller

    @rt.remote(max_retries=8)
    def work(i):
        time.sleep(0.05)
        return i * 3

    killer = WorkerKiller.options(num_cpus=0).remote(interval_s=0.3, seed=1)
    kill_run = killer.run.remote(duration_s=6.0)
    refs = [work.remote(i) for i in range(300)]
    results = rt.get(refs, timeout=120)
    assert results == [i * 3 for i in range(300)]
    killed = rt.get(kill_run, timeout=30)
    assert killed, "chaos run killed nothing — test proved nothing"
    rt.kill(killer)


def test_worker_killer_stop_interleaves_with_run(cluster):
    """`stop()` is served while `run()` is still looping (the actor
    takes two calls at once) and ends the run early."""
    killer = testing.WorkerKiller.options(num_cpus=0).remote(
        interval_s=0.1, seed=2)
    try:
        t0 = time.monotonic()
        run = killer.run.remote(duration_s=60.0)
        time.sleep(0.5)
        assert rt.get(killer.stop.remote(), timeout=30) == []
        assert rt.get(run, timeout=30) == []  # nothing busy to kill
        assert time.monotonic() - t0 < 30.0
    finally:
        rt.kill(killer)


# ----------------------------------------------------------------------
# testing.py: the probes
# ----------------------------------------------------------------------
def test_torch_multiprocess_cpu_support_probes_a_gloo_pair():
    """Two processes form a gloo group over TCP and allreduce; the
    answer is cached for the process."""
    ok, reason = testing.torch_multiprocess_cpu_support()
    assert ok, reason
    assert testing.torch_multiprocess_cpu_support() is \
        testing.torch_multiprocess_cpu_support()


@pytest.mark.parametrize("kind", testing.KERNEL_KINDS)
def test_cuda_kernel_support_answers_for_each_family(kind):
    ok, reason = testing.cuda_kernel_support(kind)
    if torch.cuda.is_available():
        assert (ok, reason) == (True, "")
    else:
        assert not ok and "CUDA" in reason
    with pytest.raises(ValueError, match="unknown kernel probe kind"):
        testing.cuda_kernel_support("pallas")


# ----------------------------------------------------------------------
# cluster_utils.py: node daemons on one host
# ----------------------------------------------------------------------
@pytest.fixture
def two_nodes():
    # one runtime a process: the module's local cluster goes first
    rt.shutdown()
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2, "num_workers": 2})
    c.connect()
    try:
        yield c
    finally:
        c.shutdown()


def test_cluster_lives_under_the_ports_temp_dir():
    c = Cluster()
    try:
        base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
        assert c._base.startswith(os.environ.get("RTT_TMPDIR", base))
        assert c.head_node is None and c.address is None
        with pytest.raises(RayTpuError, match="no live head"):
            c.connect()
    finally:
        c.shutdown()


def test_cluster_schedules_across_nodes_by_resource(two_nodes):
    two_nodes.add_node(num_cpus=2, resources={"special": 1},
                       num_workers=2)
    two_nodes.wait_for_nodes()
    assert len([n for n in rt.nodes() if n["alive"]]) == 2
    assert rt.cluster_resources()["CPU"] == 4.0

    @rt.remote
    def where():
        return os.environ.get("RTT_NODE_SOCKET", "")

    plain = rt.get(where.remote(), timeout=60)
    special = rt.get(where.options(resources={"special": 1}).remote(),
                     timeout=60)
    assert plain != special  # the custom resource forced the second node


def test_cluster_node_death_kills_its_actor_and_reaps_its_store(two_nodes):
    node = two_nodes.add_node(num_cpus=2, resources={"b": 1},
                              num_workers=1)
    two_nodes.wait_for_nodes()

    @rt.remote
    class Pinned:
        def ping(self):
            return "pong"

    a = Pinned.options(resources={"b": 1}, max_restarts=0).remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    shm = node.ready.get("shm_name")
    two_nodes.remove_node(node, graceful=False)  # SIGKILL: node failure
    assert not node.alive
    with pytest.raises((ActorDiedError, RayTpuError)):
        # the health-check period elapses before the death is seen
        deadline = time.time() + 60
        while time.time() < deadline:
            rt.get(a.ping.remote(), timeout=10)
            time.sleep(0.5)
        raise TimeoutError("actor never reported dead")
    if shm:
        assert not os.path.exists(os.path.join("/dev/shm", shm.lstrip("/")))
    assert [n for n in two_nodes._nodes if n is node] == []
