"""GCP GPU-VM node provider (reference:
`python/ray/autoscaler/_private/gcp/node_provider.py` — the Compute
Engine branch of the GCP provider — and the `compute/v1` instance REST
surface it drives).

Implements the `NodeProvider` contract against Compute Engine's
instance API (`compute.googleapis.com/compute/v1`): nodes are GPU VMs
tagged with cluster labels; worker nodes boot a startup script that
joins the head's controller.  The JAX package's module of this name
drives the Cloud TPU API instead; the contract, the injectable
transport and the one-call gang create are the same.  The HTTP
transport is injectable so the provider (and the autoscaler above it)
is fully exercisable against a mock — the same split the reference
gets from googleapiclient's mockable discovery layer.

Zero-egress environments: nothing here talks to the network unless a
real transport is used.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

API_ROOT = "https://compute.googleapis.com/compute/v1"

# states that count as alive (reference: the provider's non-terminated
# filter over instance status; Compute Engine's instance lifecycle)
_LIVE_STATES = ("PROVISIONING", "STAGING", "RUNNING", "REPAIRING")

# a VM with the NVIDIA driver and CUDA (a Deep Learning VM image family)
DEFAULT_SOURCE_IMAGE = ("projects/deeplearning-platform-release/global/"
                        "images/family/common-cu124-debian-11-py310")

Transport = Callable[[str, str, Optional[dict]], dict]


def default_transport(method: str, url: str, body: Optional[dict]) -> dict:
    """urllib-based transport; auth via the VM metadata token (running
    on GCP) — for laptops, plug in a transport that shells out to
    `gcloud auth print-access-token`."""
    import urllib.request

    tok_req = urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"},
    )
    with urllib.request.urlopen(tok_req, timeout=5) as r:
        token = json.loads(r.read())["access_token"]
    req = urllib.request.Request(
        url,
        method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/json",
        },
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        payload = r.read()
    return json.loads(payload) if payload else {}


# G2 machine types carry L4 cards by vCPU count (Compute Engine's
# accelerator-optimized machine table)
_G2_GPUS = {4: 1, 8: 1, 12: 1, 16: 1, 24: 2, 32: 1, 48: 4, 96: 8}
# A2 / A3 / A4 types end in their card count: a3-highgpu-8g, a2-ultragpu-4g
_GPU_SUFFIX = re.compile(r"^a\d+-\w+-(\d+)g$")


def chips_for_accelerator_type(machine_type: str,
                               accelerator: Optional[str] = None) -> int:
    """Per-HOST card count (the `GPU` resource one node daemon
    advertises): the count an accelerator-optimized machine type
    carries (`a3-highgpu-1g` -> 1, `a3-highgpu-8g` -> 8,
    `g2-standard-24` -> 2), else the count of the attached accelerator
    spec `"<type>:<count>"` (`n1-standard-8` with
    `"nvidia-tesla-t4:2"` -> 2), else 0."""
    if accelerator:
        _, _, count = accelerator.partition(":")
        return int(count or 1)
    m = _GPU_SUFFIX.match(machine_type)
    if m:
        return int(m.group(1))
    fam, _, rest = machine_type.partition("-standard-")
    if fam == "g2" and rest.isdigit():
        return _G2_GPUS.get(int(rest), 1)
    return 0


class GcpGpuNodeProvider(NodeProvider):
    """Creates/terminates GPU VMs labeled as members of one cluster."""

    def __init__(
        self,
        project: str,
        zone: str,
        cluster_name: str,
        *,
        machine_type: str = "a3-highgpu-1g",
        accelerator: Optional[str] = None,
        source_image: str = DEFAULT_SOURCE_IMAGE,
        startup_script: str = "",
        network: Optional[str] = None,
        transport: Optional[Transport] = None,
    ):
        self.project = project
        self.zone = zone
        self.cluster_name = cluster_name
        self.machine_type = machine_type
        self.accelerator = accelerator
        self.source_image = source_image
        self.startup_script = startup_script
        self.network = network
        self._transport = transport or default_transport
        self._parent = f"projects/{project}/zones/{zone}"
        self._node_states: Dict[str, str] = {}  # id -> last-seen status

    # -- REST helpers --------------------------------------------------
    def _url(self, path: str) -> str:
        return f"{API_ROOT}/{path}"

    def _node_body(self, node_config: Dict[str, Any]) -> Dict[str, Any]:
        """Instance properties (the body of `instances.insert` without
        its `name`, and `bulkInsert`'s `instanceProperties`)."""
        machine = node_config.get("machine_type", self.machine_type)
        accel = node_config.get("accelerator", self.accelerator)
        body: Dict[str, Any] = {
            "machineType": machine,
            "labels": {
                "rt-cluster": self.cluster_name,
                "rt-node-type": node_config.get("node_type", "worker"),
                # only the autoscaler-generated keys (values are safe
                # lowercase [a-z0-9-]) ride the instance labels — GCP
                # rejects arbitrary user label keys/values, and the busy
                # fold reads labels from noded registration (fed by the
                # rt-labels metadata below), not from here
                **{k: str(v)
                   for k, v in node_config.get("labels", {}).items()
                   if k in ("rt-launch", "tpu-slice")},
            },
            "metadata": {"items": [
                {"key": "startup-script",
                 "value": node_config.get("startup_script",
                                          self.startup_script)},
                # the default worker_startup_script reads this off the
                # metadata server and hands it to noded via --labels so
                # runtime registration carries the same identity
                {"key": "rt-labels",
                 "value": json.dumps(node_config.get("labels", {}))},
            ]},
            # GPU VMs cannot live-migrate: host maintenance stops them
            "scheduling": {"onHostMaintenance": "TERMINATE",
                           "automaticRestart": True},
            "disks": [{
                "boot": True,
                "autoDelete": True,
                "initializeParams": {
                    "sourceImage": node_config.get("source_image",
                                                   self.source_image),
                },
            }],
            "networkInterfaces": [{
                "network": self.network or "global/networks/default",
                "accessConfigs": [{"type": "ONE_TO_ONE_NAT",
                                   "name": "External NAT"}],
            }],
        }
        if accel:
            # general-purpose types take their cards as guest
            # accelerators; accelerator-optimized types carry them
            gpu_type, _, count = accel.partition(":")
            body["guestAccelerators"] = [{
                "acceleratorType": gpu_type,
                "acceleratorCount": int(count or 1),
            }]
        return body

    def _new_id(self) -> str:
        return f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"

    # -- NodeProvider contract -----------------------------------------
    def create_node(self, node_config: Dict[str, Any], count: int = 1) -> List[str]:
        ids = []
        for _ in range(count):
            node_id = self._new_id()
            body = self._node_body(node_config)
            body["machineType"] = (
                f"zones/{self.zone}/machineTypes/{body['machineType']}"
            )
            self._transport(
                "POST", self._url(f"{self._parent}/instances"),
                {"name": node_id, **body},
            )
            ids.append(node_id)
        return ids

    def create_slice(self, node_config: Dict[str, Any], hosts: int) -> List[str]:
        """Atomic multi-host scale-up: ONE `instances.bulkInsert` call
        for all `hosts` VMs with `minCount == count`, so Compute Engine
        creates the whole gang or none of it and no rollback
        choreography is needed (the counterpart of the TPU provider's
        one multi-host slice create; reference analog: pod-level
        `TPU-{pod}-head` gang resource, `_private/accelerators/tpu.py:381`)."""
        if hosts < 1:
            raise ValueError(f"hosts={hosts} must be >= 1")
        ids = [self._new_id() for _ in range(hosts)]
        self._transport(
            "POST",
            self._url(f"{self._parent}/instances/bulkInsert"),
            {
                "count": hosts,
                "minCount": hosts,
                "perInstanceProperties": {i: {} for i in ids},
                "instanceProperties": self._node_body(node_config),
            },
        )
        return ids

    def terminate_node(self, provider_id: str):
        self._transport(
            "DELETE", self._url(f"{self._parent}/instances/{provider_id}"),
            None,
        )

    def _list(self) -> List[Dict[str, Any]]:
        reply = self._transport(
            "GET",
            self._url(f"{self._parent}/instances"
                      f"?filter=labels.rt-cluster%3D{self.cluster_name}"),
            None,
        )
        out = []
        for n in reply.get("items", []):
            if n.get("labels", {}).get("rt-cluster") != self.cluster_name:
                continue
            out.append(n)
        return out

    def non_terminated_nodes(self) -> List[str]:
        return [n["id"] for n in self.list_cluster_nodes()]

    def node_is_ready(self, provider_id: str) -> bool:
        # states cached by the list_cluster_nodes() the reconcile tick
        # just made — no extra API call per node
        return self._node_states.get(provider_id) == "RUNNING"

    def node_ip(self, provider_id: str) -> Optional[str]:
        """Reachable IP of a node (the external NAT address when
        present, else `networkInterfaces[0].networkIP`) — what
        `rt attach/exec` ssh to."""
        for n in self._list():
            if n["name"] != provider_id:
                continue
            nics = n.get("networkInterfaces") or [{}]
            for ac in nics[0].get("accessConfigs") or []:
                if ac.get("natIP"):
                    return ac["natIP"]
            return nics[0].get("networkIP")
        return None

    def _gpus(self, n: Dict[str, Any]) -> int:
        accels = n.get("guestAccelerators")
        if accels:
            return sum(int(a.get("acceleratorCount", 0)) for a in accels)
        machine = n.get("machineType", self.machine_type).rsplit("/", 1)[-1]
        return chips_for_accelerator_type(machine)

    def list_cluster_nodes(self) -> List[Dict[str, Any]]:
        """Live cluster members from ONE list call: id, type label, and
        per-host resources (avoids the 1+N listing pattern a per-node
        `node_resources` loop would produce)."""
        out = []
        states: Dict[str, str] = {}
        for n in self._list():
            states[n["name"]] = n.get("status", "")
            if n.get("status") not in _LIVE_STATES:
                continue
            out.append({
                "id": n["name"],
                "node_type": n.get("labels", {}).get("rt-node-type",
                                                     "worker"),
                "resources": {"GPU": float(self._gpus(n))},
            })
        self._node_states = states
        return out

    def node_resources(self, provider_id: str) -> Dict[str, float]:
        for n in self.list_cluster_nodes():
            if n["id"] == provider_id:
                return dict(n["resources"])
        raise KeyError(provider_id)


def worker_startup_script(controller_host: str, controller_port: int,
                          *, num_workers: int = 0, num_gpus: int = 0,
                          pip_package: str = "ray_tpu_torch") -> str:
    """Startup script a GPU-VM worker runs to join the cluster: the
    reference's equivalent is the cluster YAML's worker_start_ray_
    commands rendered into the instance.  `num_gpus` 0 lets the daemon
    count the VM's cards itself (NVML)."""
    nw = f" --num-workers {num_workers}" if num_workers else ""
    ng = f" --num-gpus {num_gpus}" if num_gpus else ""
    return "\n".join([
        "#!/bin/bash",
        "set -e",
        f"python3 -m pip install -q {pip_package} || true",
        "mkdir -p /tmp/ray_tpu_torch/node",
        # node identity labels (rt-launch, tpu-slice) stamped by the
        # autoscaler into instance metadata; forwarding them to noded
        # lets the busy fold and STRICT_PACK placement see this node
        # -f: a 404 (attribute absent) must exit non-zero so the '{}'
        # fallback engages instead of capturing the error body
        "RTT_LABELS=$(curl -sf -H 'Metadata-Flavor: Google' "
        "'http://metadata.google.internal/computeMetadata/v1/instance/"
        "attributes/rt-labels' || echo '{}')",
        '[ -n "$RTT_LABELS" ] || RTT_LABELS=\'{}\'',
        # bind all interfaces + advertise the VM's routable IP: peers
        # on OTHER hosts dial the registered address for object
        # transfer / node routing — loopback would point them at
        # themselves
        "export RTT_BIND_HOST=0.0.0.0",
        "nohup python3 -m ray_tpu_torch.core.noded "
        "--session-dir /tmp/ray_tpu_torch/node "
        f"--controller {controller_host}:{controller_port}{nw}{ng} "
        '--labels "$RTT_LABELS" '
        ">> /tmp/ray_tpu_torch/node/noded.out 2>&1 &",
    ])


def head_startup_script(controller_port: int = 7777, *,
                        num_workers: int = 0, num_gpus: int = 0,
                        pip_package: str = "ray_tpu_torch") -> str:
    """Bootstrap a GPU-VM HEAD node: start the head daemon (controller
    + noded) bound on all interfaces at a pinned controller port so
    worker VMs can join (reference analog: the cluster YAML's
    head_start_ray_commands)."""
    nw = f" --num-workers {num_workers}" if num_workers else ""
    ng = f" --num-gpus {num_gpus}" if num_gpus else ""
    return "\n".join([
        "#!/bin/bash",
        "set -e",
        f"python3 -m pip install -q {pip_package} || true",
        "mkdir -p /tmp/ray_tpu_torch/node",
        # bind all interfaces + pin the controller port: worker VMs
        # join via the head's internal IP
        "export RTT_BIND_HOST=0.0.0.0",
        f"export RTT_CONTROLLER_PORT={controller_port}",
        "nohup python3 -m ray_tpu_torch.core.noded "
        "--session-dir /tmp/ray_tpu_torch/node "
        f"--head{nw}{ng} "
        ">> /tmp/ray_tpu_torch/node/noded.out 2>&1 &",
    ])
