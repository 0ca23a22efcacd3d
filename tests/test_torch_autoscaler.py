"""The port's autoscaler (`ray_tpu_torch.autoscaler`) on the CPU: the
JAX package's `tests/test_autoscaler.py` (the v1 loop over real local
node daemons), `tests/test_autoscaler_v2.py` with the node types'
accelerator as `{"GPU": n}` (without `test_gcp_provider_slice_is_single_
api_call`, which waits for `gcp.py`), the v2 scheduler and instance
table against the JAX package's on the same demand sequences, the v2
loop scaling a GPU node up for a `num_gpus=1` task and down after it
idles, and `tests/test_gke_provider.py` with GKE's GPU pod shape.
"""

import json
import time
import types

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig,
    LocalNodeProvider,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig
from ray_tpu_torch.autoscaler.gke import GkeNodeProvider
from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.autoscaler.v2 import (
    QUEUED,
    REQUESTED,
    RUNNING,
    TERMINATED,
    TERMINATING,
    AutoscalerV2,
    AutoscalerV2Config,
    Instance,
    InstanceManager,
    NodeTypeConfigV2,
    ResourceDemandScheduler,
)
from ray_tpu_torch.cluster_utils import Cluster


# ----------------------------------------------------------------------
# the v1 loop over real local node daemons (tests/test_autoscaler.py)
# ----------------------------------------------------------------------
@pytest.fixture()
def cluster():
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2, "num_workers": 2,
                                "num_gpus": 0})
    c.connect()
    yield c
    c.shutdown()


@pytest.fixture()
def provider(cluster):
    p = LocalNodeProvider(cluster.head_node.ready["controller_addr"])
    yield p
    # terminate autoscaled nodes even when the test fails
    for pid in p.non_terminated_nodes():
        p.terminate_node(pid)


def test_scale_up_unblocks_demand_then_scales_down(cluster, provider):
    autoscaler = StandardAutoscaler(
        provider,
        AutoscalerConfig(
            node_types={
                "gpuish": NodeTypeConfig(
                    num_cpus=2, resources={"special": 2}, num_workers=2
                )
            },
            min_workers=0,
            max_workers=2,
            idle_timeout_s=3.0,
        ),
    )

    @rt.remote
    def special_task(x):
        return x * 10

    # no node has "special": the task parks as pending demand
    ref = special_task.options(resources={"special": 1}).remote(4)
    done, _ = rt.wait([ref], timeout=2.0)
    assert not done

    deadline = time.time() + 60
    value = None
    while time.time() < deadline:
        autoscaler.update()
        done, _ = rt.wait([ref], timeout=1.0)
        if done:
            value = rt.get(ref, timeout=30)
            break
    assert value == 40
    assert autoscaler.num_managed() == 1

    # idle: the node terminates after idle_timeout_s
    deadline = time.time() + 60
    while time.time() < deadline:
        autoscaler.update()
        if autoscaler.num_managed() == 0:
            break
        time.sleep(0.5)
    assert autoscaler.num_managed() == 0


def test_min_workers_floor(cluster, provider):
    autoscaler = StandardAutoscaler(
        provider,
        AutoscalerConfig(
            node_types={"basic": NodeTypeConfig(num_cpus=1, num_workers=1)},
            min_workers=2,
            max_workers=4,
        ),
    )
    autoscaler.update()
    assert autoscaler.num_managed() == 2
    deadline = time.time() + 30
    while time.time() < deadline:
        if len([n for n in rt.nodes() if n["alive"]]) >= 3:
            break
        time.sleep(0.2)
    assert len([n for n in rt.nodes() if n["alive"]]) >= 3


def test_v2_scales_a_gpu_node_up_for_a_gpu_task_and_down(cluster, provider):
    """The ops plane's path at CPU size: the head has no GPU, a
    `num_gpus=1` task parks as pending demand, `AutoscalerV2` over the
    local provider launches one `{"GPU": 1}` node that advertises
    exactly that, the task runs there, and the idle node is terminated
    with its daemon gone."""
    cfg = AutoscalerV2Config(
        node_types={"gpu_worker": NodeTypeConfigV2(
            num_cpus=2, resources={"GPU": 1}, num_workers=1,
            max_slices=1)},
        max_hosts=1, idle_timeout_s=2.0)
    a = AutoscalerV2(provider, cfg)

    @rt.remote(num_gpus=1)
    def where():
        from ray_tpu_torch.core.runtime import get_runtime

        return get_runtime().node_id

    ref = where.remote()
    done, _ = rt.wait([ref], timeout=1.0)
    assert not done
    deadline = time.time() + 90
    node_id = None
    while time.time() < deadline and node_id is None:
        a.update()
        done, _ = rt.wait([ref], timeout=0.5)
        if done:
            node_id = rt.get(ref, timeout=30)
    assert node_id is not None
    [pid] = provider.non_terminated_nodes()
    assert provider.runtime_node_id(pid) == node_id
    node = [n for n in rt.nodes() if n["node_id"] == node_id][0]
    assert node["resources"]["GPU"] == 1.0
    assert not any(n["resources"].get("GPU")
                   for n in rt.nodes() if n["node_id"] != node_id)
    proc = provider._nodes[pid]["proc"]

    deadline = time.time() + 60
    while time.time() < deadline and provider.non_terminated_nodes():
        a.update()
        time.sleep(0.3)
    assert provider.non_terminated_nodes() == []
    assert proc.poll() is not None
    assert [i.status for i in a.im.instances()] == [TERMINATING]
    a.update()
    assert [i.status for i in a.im.instances()] == [TERMINATED]


# ----------------------------------------------------------------------
# autoscaler v2 (tests/test_autoscaler_v2.py) with GPU node types
# ----------------------------------------------------------------------
class FakeProvider(NodeProvider):
    """In-memory provider with injectable per-host launch failures."""

    def __init__(self, fail_after: int = -1):
        self._live = {}
        self._next = 0
        self._created = 0
        self.fail_after = fail_after  # fail creations past this count
        self.terminated = []

    def create_node(self, node_config, count=1):
        out = []
        for _ in range(count):
            if 0 <= self.fail_after <= self._created:
                raise RuntimeError("provider quota exceeded")
            self._created += 1
            pid = f"fake-{self._next}"
            self._next += 1
            self._live[pid] = dict(node_config)
            out.append(pid)
        return out

    def terminate_node(self, provider_id):
        self._live.pop(provider_id, None)
        self.terminated.append(provider_id)

    def non_terminated_nodes(self):
        return list(self._live)

    def runtime_node_id(self, provider_id):
        # runtime node ids mirror provider ids once "registered"
        if self._live.get(provider_id, {}).get("__registered__"):
            return f"rt-{provider_id}"
        raise KeyError(provider_id)

    def register(self, provider_id):
        self._live[provider_id]["__registered__"] = True


def _config(hosts_per_slice=1, **kw):
    return AutoscalerV2Config(
        node_types={
            "gpu_host": NodeTypeConfigV2(
                num_cpus=4, resources={"GPU": 4},
                hosts_per_slice=hosts_per_slice,
            ),
        },
        **kw,
    )


def _state(demands=(), gangs=(), nodes=()):
    return {
        "pending_demands": list(demands),
        "pending_gangs": list(gangs),
        "nodes": list(nodes),
    }


def test_instance_state_machine():
    im = InstanceManager()
    inst = Instance(instance_id="i-1", node_type="gpu_host")
    im.add(inst)
    v0 = im.version
    im.update_status("i-1", REQUESTED)
    assert im.version > v0
    im.update_status("i-1", RUNNING)
    im.update_status("i-1", TERMINATING)
    im.update_status("i-1", TERMINATED)
    with pytest.raises(ValueError):  # TERMINATED is terminal
        im.update_status("i-1", RUNNING)
    im2 = InstanceManager()
    im2.add(Instance(instance_id="i-2", node_type="t"))
    with pytest.raises(ValueError):  # QUEUED cannot jump to RUNNING
        im2.update_status("i-2", RUNNING)


def test_scheduler_launches_for_demand_and_absorbs_inbound():
    sched = ResourceDemandScheduler(_config())
    im = InstanceManager()
    d = sched.schedule([{"GPU": 4}], [], im, time.time())
    assert len(d.launches) == 1 and d.launches[0].hosts == 1
    # once an instance is REQUESTED, the same demand is absorbed
    im.add(Instance(instance_id="i-1", node_type="gpu_host", status=QUEUED))
    im.update_status("i-1", REQUESTED)
    d = sched.schedule([{"GPU": 4}], [], im, time.time())
    assert d.launches == []


def test_scheduler_gang_demand_launches_whole_slice():
    sched = ResourceDemandScheduler(_config(hosts_per_slice=4))
    # a 16-GPU STRICT_PACK pg (4 bundles x 4 GPUs) -> ONE 4-host gang
    gang = {"pg_id": "ab", "strategy": "STRICT_PACK",
            "bundles": [{"GPU": 4}] * 4}
    d = sched.schedule([], [gang], InstanceManager(), time.time())
    assert len(d.launches) == 1
    assert d.launches[0].hosts == 4
    assert "gang" in d.launches[0].reason


def test_scheduler_gang_infeasible_bundle_not_launched():
    sched = ResourceDemandScheduler(_config(hosts_per_slice=4))
    # one bundle needs 8 GPUs on a single host: no type fits per host
    gang = {"pg_id": "cd", "strategy": "STRICT_PACK",
            "bundles": [{"GPU": 8}]}
    d = sched.schedule([], [gang], InstanceManager(), time.time())
    assert d.launches == []


def test_scheduler_respects_max_hosts_and_max_slices():
    sched = ResourceDemandScheduler(_config(hosts_per_slice=4, max_hosts=4))
    gang = {"pg_id": "x", "bundles": [{"GPU": 4}] * 4}
    d = sched.schedule([], [gang, dict(gang, pg_id="y")],
                       InstanceManager(), time.time())
    assert len(d.launches) == 1  # a second gang would exceed max_hosts


def test_scheduler_slice_granular_idle_scale_down():
    sched = ResourceDemandScheduler(
        _config(hosts_per_slice=2, idle_timeout_s=10.0))
    im = InstanceManager()
    now = time.time()
    for i, (busy_ago, slice_id) in enumerate(
        [(60, "s1"), (5, "s1"), (60, "s2"), (60, "s2")]
    ):
        im.add(Instance(
            instance_id=f"i-{i}", node_type="gpu_host", status=QUEUED,
            slice_id=slice_id, last_busy_at=now - busy_ago,
        ))
        im.update_status(f"i-{i}", REQUESTED)
        im.update_status(f"i-{i}", RUNNING)
    d = sched.schedule([], [], im, now)
    # s1 has one recently-busy host -> protected whole; s2 fully idle
    assert sorted(d.terminations) == ["i-2", "i-3"]
    # pending demand suppresses scale-down entirely
    d = sched.schedule([{"CPU": 1}], [], im, now)
    assert d.terminations == []


def test_atomic_slice_launch_and_promotion():
    provider = FakeProvider()
    state = _state(gangs=[{"pg_id": "g", "bundles": [{"GPU": 4}] * 4}])
    a = AutoscalerV2(provider, _config(hosts_per_slice=4),
                     cluster_state_fn=lambda: state)
    a.update()
    reqs = a.im.instances(REQUESTED)
    assert len(reqs) == 4
    assert len({i.slice_id for i in reqs}) == 1  # one gang
    # all hosts share the gang label for STRICT_PACK targeting
    assert all(
        provider._live[i.provider_id]["labels"]["tpu-slice"] == i.slice_id
        for i in reqs
    )
    for i in reqs:
        provider.register(i.provider_id)
    state = _state(nodes=[
        {"node_id": f"rt-{i.provider_id}", "alive": True, "busy": True}
        for i in reqs
    ])
    a._cluster_state_fn = lambda: state
    a.update()
    assert len(a.im.instances(RUNNING)) == 4


def test_partial_slice_creation_rolls_back():
    provider = FakeProvider(fail_after=2)  # the 3rd host creation fails
    state = _state(gangs=[{"pg_id": "g", "bundles": [{"GPU": 4}] * 4}])
    a = AutoscalerV2(provider, _config(hosts_per_slice=4),
                     cluster_state_fn=lambda: state)
    a.update()
    assert a.im.instances(REQUESTED, RUNNING) == []
    assert len(provider.terminated) == 2
    assert provider.non_terminated_nodes() == []


def test_stuck_slice_reaped_whole_after_timeout():
    provider = FakeProvider()
    state = _state(gangs=[{"pg_id": "g", "bundles": [{"GPU": 4}] * 2}])
    a = AutoscalerV2(provider,
                     _config(hosts_per_slice=2, slice_ready_timeout_s=0.0),
                     cluster_state_fn=lambda: state)
    a.update()
    time.sleep(0.01)
    a._cluster_state_fn = lambda: _state()
    a.update()
    assert a.im.instances(REQUESTED, RUNNING) == []
    assert len(provider.terminated) == 2  # both hosts torn down


def test_gang_absorbed_by_inbound_slice_no_relaunch():
    provider = FakeProvider()
    cfg = _config(hosts_per_slice=4, max_hosts=64)
    cfg.node_types["gpu_host"].max_slices = 16
    state = _state(gangs=[{"pg_id": "g", "bundles": [{"GPU": 4}] * 4}])
    a = AutoscalerV2(provider, cfg, cluster_state_fn=lambda: state)
    for _ in range(5):  # five ticks while the gang "boots"
        a.update()
    assert len(provider.non_terminated_nodes()) == 4  # one gang only


class FakeCloudProvider(NodeProvider):
    """Provider without runtime_node_id and with a Pending -> Ready
    phase per node."""

    def __init__(self):
        self._live = {}  # pid -> ready: bool
        self._next = 0
        self.terminated = []

    def create_node(self, node_config, count=1):
        out = []
        for _ in range(count):
            pid = f"pod-{self._next}"
            self._next += 1
            self._live[pid] = False
            out.append(pid)
        return out

    def terminate_node(self, provider_id):
        self._live.pop(provider_id, None)
        self.terminated.append(provider_id)

    def non_terminated_nodes(self):
        return list(self._live)

    def node_is_ready(self, provider_id):
        return self._live.get(provider_id, False)

    def mark_ready(self, provider_id):
        self._live[provider_id] = True


def test_pending_cloud_node_not_promoted_until_ready():
    provider = FakeCloudProvider()
    cfg = _config(hosts_per_slice=2, max_hosts=64)
    cfg.node_types["gpu_host"].max_slices = 16
    state = _state(gangs=[{"pg_id": "g", "bundles": [{"GPU": 4}] * 2}])
    a = AutoscalerV2(provider, cfg, cluster_state_fn=lambda: state)
    for _ in range(4):  # ticks while the pods sit Pending
        a.update()
    assert len(a.im.instances(REQUESTED)) == 2
    assert a.im.instances(RUNNING) == []
    assert len(provider.non_terminated_nodes()) == 2
    for pid in provider.non_terminated_nodes():
        provider.mark_ready(pid)
    a.update()
    assert len(a.im.instances(RUNNING)) == 2


def test_pending_cloud_slice_reaped_at_ready_timeout():
    provider = FakeCloudProvider()
    state = _state(gangs=[{"pg_id": "g", "bundles": [{"GPU": 4}] * 2}])
    a = AutoscalerV2(provider,
                     _config(hosts_per_slice=2, slice_ready_timeout_s=0.0),
                     cluster_state_fn=lambda: state)
    a.update()
    time.sleep(0.01)
    a._cluster_state_fn = lambda: _state()
    a.update()
    assert a.im.instances(REQUESTED, RUNNING) == []
    assert len(provider.terminated) == 2


def test_cloud_busy_folds_via_launch_label():
    provider = FakeCloudProvider()
    state = _state(demands=[{"GPU": 4}])
    a = AutoscalerV2(provider, _config(hosts_per_slice=1, idle_timeout_s=0.0),
                     cluster_state_fn=lambda: state)
    a.update()
    (inst,) = a.im.instances(REQUESTED)
    assert inst.launch_id is not None
    provider.mark_ready(inst.provider_id)
    busy_state = _state(nodes=[{
        "node_id": "n-1", "alive": True, "busy": True,
        "labels": {"rt-launch": inst.launch_id},
    }])
    a._cluster_state_fn = lambda: busy_state
    for _ in range(3):
        a.update()
        time.sleep(0.01)
    assert len(a.im.instances(RUNNING)) == 1  # busy: not idle-reaped
    idle_state = _state(nodes=[{
        "node_id": "n-1", "alive": True, "busy": False,
        "labels": {"rt-launch": inst.launch_id},
    }])
    a._cluster_state_fn = lambda: idle_state
    time.sleep(0.02)
    a.update()
    assert a.im.instances(RUNNING) == []


def test_pending_single_node_reaped_at_ready_timeout():
    provider = FakeCloudProvider()
    state = _state(demands=[{"GPU": 4}])
    a = AutoscalerV2(provider,
                     _config(hosts_per_slice=1, slice_ready_timeout_s=0.0),
                     cluster_state_fn=lambda: state)
    a.update()
    time.sleep(0.01)
    a._cluster_state_fn = lambda: _state()
    a.update()
    assert a.im.instances(REQUESTED, RUNNING) == []
    assert len(provider.terminated) == 1


def test_gang_launch_requires_real_bin_pack():
    cfg = AutoscalerV2Config(node_types={
        "t": NodeTypeConfigV2(num_cpus=4, hosts_per_slice=2),
    })
    sched = ResourceDemandScheduler(cfg)
    gang = {"pg_id": "z", "bundles": [{"CPU": 3}, {"CPU": 3}, {"CPU": 2}]}
    d = sched.schedule([], [gang], InstanceManager(), time.time())
    assert d.launches == []
    gang2 = {"pg_id": "y", "bundles": [{"CPU": 3}, {"CPU": 1},
                                       {"CPU": 3}, {"CPU": 1}]}
    d = sched.schedule([], [gang2], InstanceManager(), time.time())
    assert len(d.launches) == 1


# ----------------------------------------------------------------------
# the v2 scheduler and instance table against the JAX package's
# ----------------------------------------------------------------------
def _sequence(seed, acc):
    """Seeded reconcile inputs: per tick, task demands and gangs of the
    accelerator `acc`, which hosts register and which are busy."""
    rng = np.random.default_rng(seed)
    ticks = []
    for _ in range(12):
        demands = [{acc: float(rng.choice([1, 2, 4]))}
                   for _ in range(int(rng.integers(0, 3)))]
        if rng.uniform() < 0.3:
            demands.append({"CPU": float(rng.integers(1, 4))})
        gangs = [{"pg_id": f"g{int(rng.integers(0, 99))}",
                  "bundles": [{acc: 4.0}] * int(rng.choice([2, 4]))}
                 for _ in range(int(rng.uniform() < 0.3))]
        ticks.append({"demands": demands, "gangs": gangs,
                      "register": float(rng.uniform()),
                      "busy": float(rng.uniform()),
                      "fail": bool(rng.uniform() < 0.1)})
    # then the demand stops, every host registers and idles
    ticks += [{"demands": [], "gangs": [], "register": 1.0, "busy": 0.0,
               "fail": False}] * 6
    return ticks


def _drive(v2, acc, ticks):
    """The v2 loop over an in-memory provider on a fixed clock; a trace
    of each tick's plan and every instance's state after it."""

    class Provider(v2.NodeProvider):
        def __init__(self):
            self.live, self.n, self.fail_next = {}, 0, False

        def create_node(self, node_config, count=1):
            out = []
            for _ in range(count):
                if self.fail_next:
                    self.fail_next = False
                    raise RuntimeError("quota")
                pid = f"p{self.n}"
                self.n += 1
                self.live[pid] = {"cfg": node_config, "up": False}
                out.append(pid)
            return out

        def terminate_node(self, pid):
            self.live.pop(pid, None)

        def non_terminated_nodes(self):
            return list(self.live)

        def runtime_node_id(self, pid):
            if self.live.get(pid, {}).get("up"):
                return f"rt-{pid}"
            raise KeyError(pid)

    node_types = {
        "one": v2.NodeTypeConfigV2(num_cpus=4, resources={acc: 4},
                                   max_slices=3),
        "gang": v2.NodeTypeConfigV2(num_cpus=8, resources={acc: 4},
                                    hosts_per_slice=2, max_slices=2),
    }
    cfg = v2.AutoscalerV2Config(node_types=node_types, max_hosts=8,
                                idle_timeout_s=3.0,
                                slice_ready_timeout_s=5.0)
    provider = Provider()
    clock = [1000.0]
    state = {}
    a = v2.AutoscalerV2(provider, cfg, cluster_state_fn=lambda: state)
    trace = []
    # the module's clock only: `time` in v2's namespace, not the
    # process's time module
    real_time = v2.time
    v2.time = types.SimpleNamespace(time=lambda: clock[0])
    try:
        for t in ticks:
            pids = sorted(provider.live)
            for k, pid in enumerate(pids):
                if (k + 1) / (len(pids) + 1) < t["register"]:
                    provider.live[pid]["up"] = True
            state.clear()
            state.update({
                "pending_demands": t["demands"],
                "pending_gangs": t["gangs"],
                "nodes": [{"node_id": f"rt-{p}", "alive": True,
                           "busy": k % 2 == 0 and t["busy"] > 0.5}
                          for k, p in enumerate(pids)
                          if provider.live[p]["up"]],
            })
            provider.fail_next = t["fail"]
            plan = a.scheduler.schedule(t["demands"], t["gangs"], a.im,
                                        clock[0])
            a.update()
            trace.append({
                "launches": [(lz.node_type, lz.hosts, lz.reason)
                             for lz in plan.launches],
                "terminations": len(plan.terminations),
                "instances": sorted(
                    (i.provider_id, i.node_type, i.status, i.hosts,
                     i.slice_id is not None, i.version)
                    for i in a.im.instances()),
                "version": a.im.version,
                "live": sorted(provider.live),
            })
            clock[0] += 1.5
    finally:
        v2.time = real_time
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_v2_plans_and_transitions_match_the_jax_package(seed):
    """The same seeded demand, gang, registration and busy sequence
    through both packages' v2 loop (`"TPU"` in the JAX package, `"GPU"`
    in the port): equal launch plans, terminations, instance states and
    table versions, tick for tick."""
    from ray_tpu.autoscaler import v2 as jv2
    from ray_tpu_torch.autoscaler import v2 as tv2

    want = _drive(jv2, "TPU", _sequence(seed, "TPU"))
    got = _drive(tv2, "GPU", _sequence(seed, "GPU"))
    assert len(got) == len(want)
    for tick, (g, w) in enumerate(zip(got, want)):
        assert g == w, tick
    # the sequence exercised launches, both shapes, and scale-down
    kinds = {lz[0] for t in got for lz in t["launches"]}
    assert kinds == {"one", "gang"}, kinds
    assert any(t["terminations"] for t in got)


# ----------------------------------------------------------------------
# GKE with the GPU pod shape (tests/test_gke_provider.py)
# ----------------------------------------------------------------------
class FakeK8s:
    def __init__(self):
        self.pods = {}
        self.calls = []

    def __call__(self, method, url, body):
        self.calls.append((method, url, body))
        if method == "POST":
            name = body["metadata"]["name"]
            pod = dict(body)
            pod["status"] = {"phase": "Pending"}
            self.pods[name] = pod
            return pod
        if method == "DELETE":
            name = url.rsplit("/", 1)[1]
            self.pods.pop(name, None)
            return {}
        if method == "GET":
            if "labelSelector" in url:
                return {"items": list(self.pods.values())}
            name = url.rsplit("/", 1)[1].split("?")[0]
            return self.pods.get(name, {})
        raise AssertionError(method)

    def set_phase(self, name, phase):
        self.pods[name]["status"]["phase"] = phase


def _gke(k8s, **kw):
    return GkeNodeProvider(
        "c1", controller_addr=("10.0.0.1", 7000),
        gpu_accelerator="nvidia-h100-80gb", transport=k8s, **kw,
    )


def test_create_list_terminate_pods():
    k8s = FakeK8s()
    p = _gke(k8s)
    [pid] = p.create_node({"num_cpus": 2, "num_workers": 2}, 1)
    assert pid in p.non_terminated_nodes()
    pod = k8s.pods[pid]
    assert pod["metadata"]["labels"]["rt-cluster"] == "c1"
    args = pod["spec"]["containers"][0]["args"]
    assert args[:2] == ["-m", "ray_tpu_torch.core.noded"]
    assert "--controller" in args
    assert args[args.index("--controller") + 1] == "10.0.0.1:7000"
    # no GPU requested -> no accelerator selector or limit
    assert "nodeSelector" not in pod["spec"]
    assert "nvidia.com/gpu" not in pod["spec"]["containers"][0][
        "resources"]["limits"]
    p.terminate_node(pid)
    assert p.non_terminated_nodes() == []


def test_gpu_pod_shape():
    k8s = FakeK8s()
    p = _gke(k8s)
    [pid] = p.create_node({
        "num_cpus": 8, "resources": {"GPU": 4},
        "labels": {"tpu-slice": "s1"},
    }, 1)
    pod = k8s.pods[pid]
    limits = pod["spec"]["containers"][0]["resources"]["limits"]
    assert limits == {"cpu": "8", "nvidia.com/gpu": "4"}
    assert pod["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    # the gang label rides to the daemon and the pod labels
    args = pod["spec"]["containers"][0]["args"]
    assert json.loads(args[args.index("--labels") + 1]) == {
        "tpu-slice": "s1"
    }
    assert pod["metadata"]["labels"]["rt-tpu-slice"] == "s1"
    assert p.node_resources(pid) == {"CPU": 8.0, "GPU": 4.0}
    # without an accelerator name the pod still asks for its GPUs
    [pid2] = GkeNodeProvider("c1", transport=k8s).create_node(
        {"num_cpus": 1, "resources": {"GPU": 1}}, 1)
    assert "nodeSelector" not in k8s.pods[pid2]["spec"]
    assert k8s.pods[pid2]["spec"]["containers"][0]["resources"][
        "limits"]["nvidia.com/gpu"] == "1"


def test_slice_create_rolls_back_on_partial_failure():
    class Flaky(FakeK8s):
        def __call__(self, method, url, body):
            if method == "POST" and len(self.pods) >= 2:
                raise RuntimeError("quota")
            return super().__call__(method, url, body)

    k8s = Flaky()
    p = _gke(k8s)
    with pytest.raises(RuntimeError, match="quota"):
        p.create_slice({"num_cpus": 1, "resources": {"GPU": 1},
                        "labels": {"tpu-slice": "s"}}, 4)
    # the default create_slice rollback removed the partial pods
    assert p.non_terminated_nodes() == []


def test_succeeded_pods_are_not_alive():
    k8s = FakeK8s()
    p = _gke(k8s)
    [pid] = p.create_node({"num_cpus": 1}, 1)
    k8s.set_phase(pid, "Succeeded")
    assert p.non_terminated_nodes() == []
