"""The port's GCP GPU-VM node provider and cluster launcher
(`autoscaler/gcp.py`, `autoscaler/commands.py`, `rt up/down/exec/attach`
through `scripts/cli.py`): the JAX package's `tests/test_gcp_provider.py`
on Compute Engine's instance API, its
`test_autoscaler_v2.py::test_gcp_provider_slice_is_single_api_call` as
one `bulkInsert`, and the reference's `local` provider type.  All API
traffic rides a mock transport: nothing here touches the network.
"""

import json

import pytest

from ray_tpu_torch.autoscaler.commands import (
    _DryRunTransport,
    down,
    load_cluster_config,
    status,
    up,
)
from ray_tpu_torch.autoscaler.gcp import (
    GcpGpuNodeProvider,
    chips_for_accelerator_type,
    head_startup_script,
    worker_startup_script,
)

CFG = {
    "cluster_name": "testclu",
    "provider": {
        "type": "gcp_gpu",
        "project": "proj",
        "zone": "us-central1-a",
        "machine_type": "a3-highgpu-8g",
    },
    "head": {"controller_host": "10.0.0.2", "controller_port": 7777},
    "min_workers": 2,
    "worker": {"num_workers": 4},
}


def _provider(transport, **kw):
    kw.setdefault("machine_type", "a3-highgpu-8g")
    return GcpGpuNodeProvider(
        "proj", "us-central1-a", "testclu", transport=transport, **kw
    )


def _config(tmp_path, cfg=CFG):
    import yaml

    path = tmp_path / "cluster.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _metadata(body, key):
    return {i["key"]: i["value"] for i in body["metadata"]["items"]}[key]


def test_create_terminate_list_roundtrip():
    t = _DryRunTransport()
    p = _provider(t)
    ids = p.create_node({"node_type": "worker"}, 2)
    assert len(ids) == 2 and all(i.startswith("testclu-") for i in ids)
    assert sorted(p.non_terminated_nodes()) == sorted(ids)
    # one instances.insert a node, carrying the labels and machine type
    method, url, body = t.calls[0]
    assert method == "POST" and url == (
        "https://compute.googleapis.com/compute/v1/projects/proj/zones/"
        "us-central1-a/instances")
    assert body["name"] == ids[0]
    assert body["labels"]["rt-cluster"] == "testclu"
    assert body["machineType"] == (
        "zones/us-central1-a/machineTypes/a3-highgpu-8g")
    # GPU VMs do not live-migrate
    assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
    assert "guestAccelerators" not in body  # the type carries its cards
    assert json.loads(_metadata(body, "rt-labels")) == {}
    p.terminate_node(ids[0])
    assert t.calls[-1][0] == "DELETE" and t.calls[-1][1].endswith(
        f"/instances/{ids[0]}")
    assert p.non_terminated_nodes() == [ids[1]]
    assert p.node_resources(ids[1]) == {"GPU": 8.0}


def test_guest_accelerators_for_a_general_purpose_type():
    t = _DryRunTransport()
    p = _provider(t, machine_type="n1-standard-8",
                  accelerator="nvidia-tesla-t4:2")
    [nid] = p.create_node({"node_type": "worker"}, 1)
    body = t.calls[0][2]
    assert body["guestAccelerators"] == [
        {"acceleratorType": "nvidia-tesla-t4", "acceleratorCount": 2}]
    assert p.node_resources(nid) == {"GPU": 2.0}


def test_foreign_nodes_filtered():
    t = _DryRunTransport()
    t.nodes["other"] = {
        "name": "other",
        "status": "RUNNING",
        "labels": {"rt-cluster": "not-ours"},
    }
    p = _provider(t)
    assert p.non_terminated_nodes() == []


def test_live_and_ready_states():
    t = _DryRunTransport()
    p = _provider(t)
    ids = p.create_node({"node_type": "worker"}, 6)
    for nid, st in zip(ids, ("PROVISIONING", "STAGING", "RUNNING",
                             "REPAIRING", "STOPPING", "TERMINATED")):
        t.nodes[nid]["status"] = st
    assert sorted(p.non_terminated_nodes()) == sorted(ids[:4])
    assert [p.node_is_ready(i) for i in ids] == [
        False, False, True, False, False, False]


def test_chips_for_accelerator_type():
    assert chips_for_accelerator_type("a3-highgpu-1g") == 1
    assert chips_for_accelerator_type("a3-highgpu-8g") == 8
    assert chips_for_accelerator_type("a3-megagpu-8g") == 8
    assert chips_for_accelerator_type("a2-ultragpu-4g") == 4
    assert chips_for_accelerator_type("g2-standard-4") == 1
    assert chips_for_accelerator_type("g2-standard-24") == 2
    assert chips_for_accelerator_type("g2-standard-96") == 8
    assert chips_for_accelerator_type("n1-standard-8") == 0
    assert chips_for_accelerator_type("n1-standard-8",
                                      "nvidia-tesla-t4:2") == 2
    assert chips_for_accelerator_type("n1-standard-8", "nvidia-l4") == 1


def test_up_down_roundtrip(tmp_path):
    cfg = load_cluster_config(str(_config(tmp_path)))

    t = _DryRunTransport()
    summary = up(cfg, transport=t, _print=lambda *a: None)
    assert len(summary["created"]["head"]) == 1
    assert len(summary["created"]["worker"]) == 2
    st = status(cfg, transport=t)
    assert len(st) == 3
    assert all(n["resources"] == {"GPU": 8.0} for n in st)
    # the worker startup script joins the head's controller with the
    # machine type's cards
    worker_calls = [
        b for m, u, b in t.calls
        if m == "POST" and b and b["labels"]["rt-node-type"] == "worker"
    ]
    script = _metadata(worker_calls[0], "startup-script")
    assert "10.0.0.2:7777" in script and "--num-gpus 8" in script

    # idempotent up: nothing new created
    summary2 = up(cfg, transport=t, _print=lambda *a: None)
    assert summary2["created"] == {"head": [], "worker": []}

    ids = down(cfg, transport=t, _print=lambda *a: None)
    assert len(ids) == 3
    assert status(cfg, transport=t) == []


def test_roles_take_their_own_machine_type(tmp_path):
    cfg = dict(CFG, head={**CFG["head"], "machine_type": "g2-standard-4"},
               worker={**CFG["worker"], "machine_type": "a3-highgpu-1g"})
    cfg = load_cluster_config(str(_config(tmp_path, cfg)))
    t = _DryRunTransport()
    up(cfg, transport=t, _print=lambda *a: None)
    by_type = {b["labels"]["rt-node-type"]: b for m, u, b in t.calls
               if m == "POST"}
    assert by_type["head"]["machineType"].endswith("/g2-standard-4")
    assert by_type["worker"]["machineType"].endswith("/a3-highgpu-1g")
    assert "--num-gpus 1 " in _metadata(by_type["head"], "startup-script")
    assert "--num-gpus 1 " in _metadata(by_type["worker"], "startup-script")


def test_config_validation(tmp_path):
    import yaml

    bad = {"cluster_name": "x", "provider": {"type": "gcp_gpu"}}
    path = tmp_path / "bad.yaml"
    path.write_text(yaml.safe_dump(bad))
    with pytest.raises(ValueError):
        load_cluster_config(str(path))
    for ptype in ("nope", "gcp_tpu"):
        bad2 = {"cluster_name": "x", "provider": {"type": ptype}}
        path.write_text(yaml.safe_dump(bad2))
        with pytest.raises(ValueError, match="unknown provider type"):
            load_cluster_config(str(path))


def test_local_type_validates_but_up_needs_a_project(tmp_path):
    """The reference's behaviour, kept: `type: local` passes validation,
    and `up` then asks the GCP provider for `project`."""
    from ray_tpu.autoscaler.commands import (
        load_cluster_config as ref_load,
        up as ref_up,
    )

    local = {"cluster_name": "x", "provider": {"type": "local"}}
    path = _config(tmp_path, local)
    for load, run in ((load_cluster_config, up), (ref_load, ref_up)):
        cfg = load(str(path))
        assert cfg["provider"]["type"] == "local"
        with pytest.raises(KeyError, match="project"):
            run(cfg, transport=_DryRunTransport(), _print=lambda *a: None)


def test_cli_dry_run(tmp_path, capsys):
    from ray_tpu_torch.scripts.cli import main as cli_main

    rc = cli_main(["up", str(_config(tmp_path)), "--dry-run"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "DRY-RUN POST https://compute.googleapis.com/" in out
    assert "testclu" in out
    rc = cli_main(["cluster-status", str(_config(tmp_path)), "--dry-run"])
    assert rc == 0
    assert "DRY-RUN GET" in capsys.readouterr().out


def test_autoscaler_drives_gcp_provider(monkeypatch):
    """The StandardAutoscaler scale-up/down loop against the mocked GCP
    provider."""
    from ray_tpu_torch.autoscaler.autoscaler import (
        AutoscalerConfig,
        NodeTypeConfig,
        StandardAutoscaler,
    )

    t = _DryRunTransport()
    p = _provider(t)
    sa = StandardAutoscaler(p, AutoscalerConfig(
        node_types={"gpu_worker": NodeTypeConfig(
            num_cpus=0, resources={"GPU": 8}, max_count=4)},
        min_workers=0, max_workers=4, idle_timeout_s=0.0,
    ))
    state = {"pending_demands": [{"GPU": 8.0}], "nodes": []}
    monkeypatch.setattr(sa, "_cluster_state", lambda: state)
    sa.update()
    assert len(p.non_terminated_nodes()) == 1
    # demand cleared + idle timeout 0 -> scale back down
    state = {"pending_demands": [], "nodes": []}
    monkeypatch.setattr(sa, "_cluster_state", lambda: state)
    import time

    time.sleep(0.01)
    sa.update()
    assert p.non_terminated_nodes() == []


def test_worker_startup_script_shape():
    s = worker_startup_script("1.2.3.4", 9999, num_workers=2, num_gpus=8)
    assert "--controller 1.2.3.4:9999" in s
    assert "--num-workers 2" in s and "--num-gpus 8" in s
    assert "python3 -m ray_tpu_torch.core.noded" in s
    assert "export RTT_BIND_HOST=0.0.0.0" in s
    assert s.startswith("#!/bin/bash")
    # no count: the daemon counts the VM's cards itself
    assert "--num-gpus" not in worker_startup_script("1.2.3.4", 9999)


# ---------------------------------------------------------------------------
# attach / exec over the command-runner seam + head bootstrap
# ---------------------------------------------------------------------------
class MockRunner:
    """Records commands; the injection seam `rt attach/exec` tests use."""

    def __init__(self, ip):
        self.ip = ip
        self.commands = []

    def run(self, cmd, *, timeout=None):
        self.commands.append(cmd)
        return 0, f"ran on {self.ip}: {cmd}"

    def run_interactive(self, cmd="bash"):
        self.commands.append(("interactive", cmd))
        return 0

    def remote_shell_command(self, cmd=""):
        return ["ssh", f"ubuntu@{self.ip}", cmd]


def _dry_run_with_interfaces(t, nat=True):
    """Give the dry-run nodes network interfaces so node_ip works."""
    for node in t.nodes.values():
        nic = {"networkIP": "10.1.0.5"}
        if nat:
            nic["accessConfigs"] = [{"type": "ONE_TO_ONE_NAT",
                                     "natIP": "34.1.2.3"}]
        node["networkInterfaces"] = [nic]


def test_exec_and_attach_via_mock_runner(tmp_path):
    from ray_tpu_torch.autoscaler.commands import attach, exec_on_head

    cfg = load_cluster_config(str(_config(tmp_path)))
    t = _DryRunTransport()
    up(cfg, transport=t, _print=lambda *a: None)
    _dry_run_with_interfaces(t)

    runners = {}

    def factory(ip):
        runners[ip] = MockRunner(ip)
        return runners[ip]

    rc, out = exec_on_head(cfg, "hostname", transport=t,
                           runner_factory=factory)
    assert rc == 0
    # external IP preferred; the command round-tripped
    assert "34.1.2.3" in runners and out.endswith("hostname")
    assert runners["34.1.2.3"].commands == ["hostname"]

    rc = attach(cfg, transport=t, runner_factory=factory,
                _print=lambda *a: None)
    assert rc == 0
    assert ("interactive", "bash") in runners["34.1.2.3"].commands

    # without an external address, the internal one
    _dry_run_with_interfaces(t, nat=False)
    exec_on_head(cfg, "true", transport=t, runner_factory=factory)
    assert runners["10.1.0.5"].commands == ["true"]


def test_exec_without_head_errors(tmp_path):
    from ray_tpu_torch.autoscaler.commands import exec_on_head

    cfg = load_cluster_config(str(_config(tmp_path)))
    t = _DryRunTransport()  # no nodes created
    with pytest.raises(RuntimeError, match="no live head"):
        exec_on_head(cfg, "true", transport=t,
                     runner_factory=lambda ip: MockRunner(ip))


def test_ssh_and_docker_runner_command_shape():
    from ray_tpu_torch.autoscaler.command_runner import (
        DockerCommandRunner,
        SSHCommandRunner,
        runner_for,
    )

    r = SSHCommandRunner("1.2.3.4", ssh_user="gpu",
                         ssh_private_key="/k.pem")
    argv = r.remote_shell_command("echo hi")
    assert argv[0] == "ssh" and "-i" in argv and "gpu@1.2.3.4" in argv
    assert argv[-1] == "echo hi"

    d = DockerCommandRunner("1.2.3.4", container="rt")
    wrapped = d._wrap("echo hi")
    assert wrapped.startswith("docker exec") and "'echo hi'" in wrapped

    cfg = {"auth": {"ssh_user": "u"},
           "docker": {"container_name": "c1"}}
    assert isinstance(runner_for(cfg, "5.6.7.8"), DockerCommandRunner)
    assert isinstance(runner_for({"auth": {}}, "5.6.7.8"),
                      SSHCommandRunner)


def test_head_bootstrap_script_in_up(tmp_path):
    """`rt up` provisions the head WITH a bootstrap: the startup script
    starts the port's head daemon (controller bound on all interfaces
    at the pinned port, the machine type's cards)."""
    cfg = load_cluster_config(str(_config(tmp_path)))
    t = _DryRunTransport()
    up(cfg, transport=t, _print=lambda *a: None)
    head_calls = [
        b for m, u, b in t.calls
        if m == "POST" and b and b["labels"]["rt-node-type"] == "head"
    ]
    script = _metadata(head_calls[0], "startup-script")
    assert "--head" in script and "--num-gpus 8" in script
    assert "RTT_BIND_HOST=0.0.0.0" in script
    assert "RTT_CONTROLLER_PORT=7777" in script
    assert "ray_tpu_torch.core.noded" in script
    assert script == head_startup_script(7777, num_gpus=8)


def test_gang_is_a_single_bulk_insert():
    """The counterpart of the reference's one-call TPU slice: a gang of
    hosts is ONE `instances.bulkInsert` POST whose `minCount` equals its
    `count`, so Compute Engine creates all of it or none."""
    calls = []

    def transport(method, url, body):
        calls.append((method, url, body))
        return {}

    p = GcpGpuNodeProvider(
        "proj", "us-central1-a", "c1", machine_type="a3-highgpu-8g",
        transport=transport,
    )
    ids = p.create_slice({"labels": {"tpu-slice": "s", "rt-launch": "l"}},
                         hosts=4)
    posts = [c for c in calls if c[0] == "POST"]
    assert len(posts) == 1  # the whole gang in one atomic create
    _, url, body = posts[0]
    assert url.endswith("/projects/proj/zones/us-central1-a/instances/"
                        "bulkInsert")
    assert body["count"] == body["minCount"] == 4
    assert list(body["perInstanceProperties"]) == ids and len(ids) == 4
    props = body["instanceProperties"]
    assert props["machineType"] == "a3-highgpu-8g"
    assert props["labels"]["tpu-slice"] == "s"
    assert json.loads(_metadata(props, "rt-labels")) == {
        "tpu-slice": "s", "rt-launch": "l"}


def test_v2_autoscaler_launches_a_gang_through_bulk_insert():
    """AutoscalerV2 over the mocked provider: a two-host gang demand
    becomes one bulkInsert of two instances, tracked host by host."""
    from ray_tpu_torch.autoscaler.v2 import (
        AutoscalerV2,
        AutoscalerV2Config,
        NodeTypeConfigV2,
    )

    t = _DryRunTransport()
    p = _provider(t)
    state = {"pending_demands": [], "nodes": [],
             "pending_gangs": [{"pg_id": "g", "bundles": [{"GPU": 8}] * 2}]}
    a = AutoscalerV2(p, AutoscalerV2Config(
        node_types={"gang": NodeTypeConfigV2(
            num_cpus=8, resources={"GPU": 8}, hosts_per_slice=2)},
        max_hosts=2), cluster_state_fn=lambda: state)
    a.update()
    posts = [c for c in t.calls if c[0] == "POST"]
    assert len(posts) == 1 and posts[0][1].endswith("/bulkInsert")
    assert len(p.non_terminated_nodes()) == 2
