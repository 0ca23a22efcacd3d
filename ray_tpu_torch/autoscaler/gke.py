"""Kubernetes/GKE node provider: cluster nodes as pods.

Reference: `python/ray/autoscaler/_private/kuberay/node_provider.py` —
the k8s-native provider where scale-up creates pods (there via the
KubeRay operator's scale request; here directly against the Kubernetes
API) and node identity is the pod name.  GKE GPU specifics follow the
documented pod shape: `nvidia.com/gpu` resource limits from a node
type's `"GPU"` resource, plus the `cloud.google.com/gke-accelerator`
node selector (for example `nvidia-h100-80gb`); a multi-host gang maps
to `hosts` pods sharing a `tpu-slice` label so STRICT_PACK placement
sees one domain.

The HTTP transport is injectable (same seam as `gcp.py`): in-cluster
it reads the service-account token; tests drive the provider against a
recorded transport with zero egress.
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

Transport = Callable[[str, str, Optional[dict]], dict]

_SA = "/var/run/secrets/kubernetes.io/serviceaccount"


def default_transport(method: str, url: str, body: Optional[dict]) -> dict:
    """In-cluster transport: k8s API over the pod's service account."""
    import ssl
    import urllib.request

    with open(f"{_SA}/token") as f:
        token = f.read()
    ctx = ssl.create_default_context(cafile=f"{_SA}/ca.crt")
    req = urllib.request.Request(
        url,
        method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/json",
        },
    )
    with urllib.request.urlopen(req, timeout=30, context=ctx) as r:
        payload = r.read()
    return json.loads(payload) if payload else {}


class GkeNodeProvider(NodeProvider):
    """Creates/terminates worker pods labeled as members of one
    cluster."""

    def __init__(
        self,
        cluster_name: str,
        *,
        namespace: str = "default",
        image: str = "python:3.11-slim",
        api_server: str = "https://kubernetes.default.svc",
        controller_addr: Optional[tuple] = None,
        gpu_accelerator: Optional[str] = None,  # e.g. "nvidia-h100-80gb"
        transport: Optional[Transport] = None,
    ):
        self.cluster_name = cluster_name
        self.namespace = namespace
        self.image = image
        self.api = api_server.rstrip("/")
        self.controller_addr = controller_addr
        self.gpu_accelerator = gpu_accelerator
        self._transport = transport or default_transport
        self._pod_phases: Dict[str, str] = {}  # pod name -> last phase

    # -- pod construction ---------------------------------------------
    def _pods_url(self, name: str = "") -> str:
        base = f"{self.api}/api/v1/namespaces/{self.namespace}/pods"
        return f"{base}/{name}" if name else base

    def _pod_body(self, name: str, node_config: Dict[str, Any]) -> dict:
        resources = dict(node_config.get("resources", {}))
        num_cpus = node_config.get("num_cpus", 4)
        labels = {
            "rt-cluster": self.cluster_name,
            "rt-node-type": node_config.get("node_type", "worker"),
            **{f"rt-{k}": str(v)
               for k, v in node_config.get("labels", {}).items()},
        }
        limits: Dict[str, Any] = {"cpu": str(num_cpus)}
        gpus = resources.get("GPU")
        if gpus:
            limits["nvidia.com/gpu"] = str(int(gpus))
        args = ["-m", "ray_tpu_torch.core.noded",
                "--session-dir", "/tmp/ray_tpu_torch/node",
                "--num-cpus", str(num_cpus)]
        if self.controller_addr:
            args += ["--controller",
                     f"{self.controller_addr[0]}:{self.controller_addr[1]}"]
        if node_config.get("num_workers"):
            args += ["--num-workers", str(node_config["num_workers"])]
        if node_config.get("labels"):
            args += ["--labels", json.dumps(node_config["labels"])]
        spec: Dict[str, Any] = {
            "restartPolicy": "Never",
            "containers": [{
                "name": "noded",
                "image": self.image,
                "command": ["python"],
                "args": args,
                "resources": {"limits": limits},
            }],
        }
        selector: Dict[str, str] = {}
        if gpus and self.gpu_accelerator:
            selector["cloud.google.com/gke-accelerator"] = (
                self.gpu_accelerator
            )
        if selector:
            spec["nodeSelector"] = selector
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": name, "labels": labels},
            "spec": spec,
        }

    # -- NodeProvider contract ----------------------------------------
    def create_node(self, node_config: Dict[str, Any], count: int = 1) -> List[str]:
        out = []
        for _ in range(count):
            name = f"rt-{self.cluster_name}-{uuid.uuid4().hex[:8]}"
            self._transport(
                "POST", self._pods_url(), self._pod_body(name, node_config)
            )
            out.append(name)
        return out

    def terminate_node(self, provider_id: str):
        self._transport("DELETE", self._pods_url(provider_id), None)

    def non_terminated_nodes(self) -> List[str]:
        reply = self._transport(
            "GET",
            self._pods_url()
            + f"?labelSelector=rt-cluster%3D{self.cluster_name}",
            None,
        )
        out = []
        phases: Dict[str, str] = {}
        for item in reply.get("items", []):
            phase = item.get("status", {}).get("phase", "Pending")
            phases[item["metadata"]["name"]] = phase
            if phase in ("Pending", "Running"):
                out.append(item["metadata"]["name"])
        self._pod_phases = phases
        return out

    def node_is_ready(self, provider_id: str) -> bool:
        # phases cached by the non_terminated_nodes() call the reconcile
        # tick just made — a Pending pod is NOT ready, so the autoscaler
        # keeps it REQUESTED (spare inbound capacity + reapable)
        return self._pod_phases.get(provider_id) == "Running"

    def node_resources(self, provider_id: str) -> Dict[str, float]:
        reply = self._transport("GET", self._pods_url(provider_id), None)
        limits = (
            reply.get("spec", {}).get("containers", [{}])[0]
            .get("resources", {}).get("limits", {})
        )
        out: Dict[str, float] = {}
        if "cpu" in limits:
            out["CPU"] = float(str(limits["cpu"]).rstrip("m")) / (
                1000.0 if str(limits["cpu"]).endswith("m") else 1.0
            )
        if "nvidia.com/gpu" in limits:
            out["GPU"] = float(limits["nvidia.com/gpu"])
        return out
